"""The port's predict surface against the JAX package's, on one JAX
checkpoint (base 8, one class), fp32 on the CPU: batched predict
(``iter_predicted_masks``: order, flushes, masks), the predict CLI with
``--batch-size``, ``--tta``, ``--tile`` and ``--viz`` and its refusals, the
server with ``--tile``/``--tta``, and ``evaluate --tta``.

Masks must be equal except at ties: fewer than 1e-3 of the pixels may
differ (the logits agree to ~1e-5, the threshold follows the same upscale).
Scores: 1e-6 absolute, as ``tests/test_torch_evaluate.py`` holds them.
"""

import sys
from unittest import mock

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

import tpu_unet.predict as j_predict
from tpu_unet.checkpoint import load_checkpoint as j_load, save_checkpoint as j_save
from tpu_unet.evaluate import eval_step as j_eval_step, eval_step_per_class as j_per_class
from tpu_unet.evaluate import main as j_evaluate_main
from tpu_unet.models import UNetConfig as JConfig, init_unet as j_init, unet_apply as j_apply
from tpu_unet.serve import BatchedPredictor as JPredictor
import tpu_unet_torch.predict as t_predict
import tpu_unet_torch.serve as t_serve
from tpu_unet_torch.checkpoint import load_checkpoint, tree_from_numpy
from tpu_unet_torch.data import make_synthetic_carvana
from tpu_unet_torch.evaluate import eval_step, eval_step_per_class, main as evaluate_main
from tpu_unet_torch.models import UNetConfig
from tpu_unet_torch.models.tta import TTA_MODES
from tpu_unet_torch.serve import BatchedPredictor, make_server

JCFG = JConfig(3, 1, bilinear=False, base_channels=8)
CFG = UNetConfig(*JCFG)
TIES = 1e-3
ATOL = 1e-6


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """A JAX checkpoint whose BN state holds the batch statistics of a random
    batch (recovered from one train-mode step's momentum-0.1 update) and
    whose head's bias puts that batch's median logit at 0, so the masks
    have both classes."""
    params, state = j_init(jax.random.PRNGKey(1), JCFG)
    x = jnp.asarray(np.random.default_rng(0).random((2, 32, 40, 3), dtype=np.float32))
    _, stepped = j_apply(params, state, x, config=JCFG, train=True)
    state = jax.tree.map(lambda new, old: (new - 0.9 * old) / 0.1, stepped, state)
    logits, _ = j_apply(params, state, x, config=JCFG)
    params["outc"]["b"] = params["outc"]["b"] - jnp.median(logits)
    path = tmp_path_factory.mktemp("ckpt") / "unet8.npz"
    j_save(path, params, state, mask_values=[0, 255], extra={"config": JCFG._asdict()})
    return path


def _img(seed, h, w):
    return Image.fromarray(np.random.default_rng(seed).integers(0, 255, (h, w, 3), np.uint8))


def _images(tmp_path, sizes):
    paths = []
    for k, (h, w) in enumerate(sizes):
        paths.append(tmp_path / f"in{k}.png")
        _img(10 + k, h, w).save(paths[-1])
    return [str(p) for p in paths]


def _agree(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape and got.dtype == ref.dtype
    assert (got != ref).mean() < TIES


A, B = (48, 64), (40, 56)


# A batch that fills, a shape change, a size change that keeps the shape
# (49x65 preprocesses to A's 24x32 at scale 0.5 but differs in size).
@pytest.mark.parametrize("sizes,batch,groups", [
    ([A, A, B, A, A], 3, [2, 1, 2]),
    ([A, A, A, A, B], 3, [3, 1, 1]),
    ([A, (49, 65), (49, 65), B], 4, [1, 2, 1]),
])
def test_iter_predicted_masks_groups_and_order_equal_jax(ckpt, tmp_path, monkeypatch, sizes,
                                                         batch, groups):
    files = _images(tmp_path, sizes)
    seen = {"port": [], "jax": []}
    for mod, tag in ((t_predict, "port"), (j_predict, "jax")):
        real = mod._forward_full

        def recording(params, state, x, *, _real=real, _tag=tag, **kw):
            seen[_tag].append(int(x.shape[0]))
            return _real(params, state, x, **kw)

        monkeypatch.setattr(mod, "_forward_full", recording)
    params, state, _, _ = load_checkpoint(ckpt, CFG)
    got = list(t_predict.iter_predicted_masks(params, state, CFG, files, batch_size=batch,
                                              tta=True, device="cpu"))
    jp, js = j_init(jax.random.PRNGKey(0), JCFG)
    jp, js, _, _ = j_load(ckpt, jp, js)
    ref = list(j_predict.iter_predicted_masks(jp, js, JCFG, files, batch_size=batch, tta=True))
    assert seen["port"] == seen["jax"] == groups
    assert [f for f, _, _ in got] == [f for f, _, _ in ref] == files
    for (_, img, mask), (_, _, jmask) in zip(got, ref):
        assert mask.shape == (img.height, img.width)
        _agree(mask, jmask)
    # Each batched mask is the one predict_img gives alone.
    solo = t_predict.predict_img(params, state, CFG, Image.open(files[-1]), tta=True,
                                 device="cpu")
    _agree(got[-1][2], solo)


@pytest.mark.parametrize("flags,sizes", [
    (["--batch-size", "3", "--tta"], [A, A, B, B, A]),
    (["--batch-size", "2", "--tta", "--tta-mode", "hflip"], [A, B, B, A, A]),
    (["--batch-size", "3"], [A, A, A, B, B]),
    (["--tile", "128", "--tta"], [(384, 400)]),
    (["--tile", "128"], [(384, 400), A]),
])
def test_predict_cli_equals_jax(ckpt, tmp_path, flags, sizes):
    files = _images(tmp_path, sizes)
    scale = ["-s", "1.0"] if "--tile" in flags else []
    for tag, run in (("jax", j_predict.main), ("port", t_predict.main)):
        outs = [str(tmp_path / f"{tag}{k}.png") for k in range(len(files))]
        run(["-m", str(ckpt), "-i", *files, "-o", *outs, *scale, *flags]
            + (["--device", "cpu"] if tag == "port" else []))
    for k in range(len(files)):
        ref = np.asarray(Image.open(tmp_path / f"jax{k}.png"))
        assert 0 < ref.mean() < 255
        _agree(np.asarray(Image.open(tmp_path / f"port{k}.png")), ref)


# (the port's flags, the message, JAX's flags where JAX refuses them too).
@pytest.mark.parametrize("flags,match,jax_flags", [
    (["--device-preprocess", "--tile", "128"], "--device-preprocess applies to the default",
     ["--device-preprocess", "--tile", "128"]),
    (["--tile-sharded", "--kernels", "torch"], "--tile-sharded does not compose with --kernels",
     None),
    (["-m", "x.pth", "--arch", "unetpp"], "pth import is reference-layout", None),
    (["--tta", "--kernels", "torch"], "--tta does not compose with --kernels",
     ["--tta", "--kernels", "xla"]),
    (["--tile", "128", "--kernels", "cuda"], "--tile does not compose with --kernels", None),
    (["--batch-size", "2", "--tile", "128"], "--batch-size composes with the default",
     ["--batch-size", "2", "--tile", "128"]),
    (["--batch-size", "2", "--kernels", "torch"], "--batch-size composes with the default",
     ["--batch-size", "2", "--kernels", "xla"]),
    (["--batch-size", "2", "--crf"], "--batch-size composes with the default",
     ["--batch-size", "2", "--crf"]),
])
def test_predict_cli_refusals(ckpt, tmp_path, flags, match, jax_flags):
    files = _images(tmp_path, [A])
    with pytest.raises(SystemExit, match=match) as port:
        t_predict.main(["-m", str(ckpt), "-i", *files, "-n", "--device", "cpu", *flags])
    if jax_flags is not None:  # the same message as JAX's
        with pytest.raises(SystemExit) as ref:
            j_predict.main(["-m", str(ckpt), "-i", *files, "-n", *jax_flags])
        assert str(port.value) == str(ref.value)


@pytest.mark.parametrize("flags", [[], ["--batch-size", "2"]])
def test_predict_cli_viz_plots_each_mask(ckpt, tmp_path, monkeypatch, flags):
    """``--viz`` plots image and mask through matplotlib, imported lazily
    (a stand-in module here)."""
    plt = mock.MagicMock()
    plt.subplots.side_effect = lambda rows, cols: (mock.MagicMock(),
                                                   [mock.MagicMock() for _ in range(cols)])
    monkeypatch.setitem(sys.modules, "matplotlib", mock.MagicMock(pyplot=plt))
    monkeypatch.setitem(sys.modules, "matplotlib.pyplot", plt)
    files = _images(tmp_path, [A, A, B])
    t_predict.main(["-m", str(ckpt), "-i", *files, "-n", "--viz", "--device", "cpu", *flags])
    assert plt.show.call_count == 3
    assert [c.args for c in plt.subplots.call_args_list] == [(1, 3)] * 3  # image + 2 classes


def _predictors(ckpt, **kw):
    params, state, mask_values, _ = load_checkpoint(ckpt, CFG)
    port = BatchedPredictor(params, state, CFG, mask_values, device="cpu", amp=False, scale=1.0,
                            max_batch=4, **kw)
    jp, js = j_init(jax.random.PRNGKey(0), JCFG)
    jp, js, mv, _ = j_load(ckpt, jp, js)
    # The host preprocess on both sides (JAX's --tile defaults to the device
    # resample, documented byte-equal to it).
    ref = JPredictor(jp, js, JCFG, mv, amp=False, scale=1.0, max_batch=4,
                     device_preprocess=False, **kw)
    return port, ref


@pytest.mark.parametrize("kw", [{"tile": 128}, {"tile": 128, "tta": True}, {"tta": True},
                                {"tta": True, "tta_mode": "hflip"}])
def test_serve_tile_and_tta_equal_jax(ckpt, monkeypatch, kw):
    """A 384x400 request fills a 384-px window (tile 128 + 2 halo 128): with
    ``tile`` it runs the tiled sweep; a small one runs the full-image
    forward. The masks equal JAX's server's."""
    tiled = []
    real = t_serve.tiled_forward_padded
    monkeypatch.setattr(t_serve, "tiled_forward_padded",
                        lambda *a, **k: tiled.append(a[2].shape) or real(*a, **k))
    port, ref = _predictors(ckpt, **kw)
    try:
        for seed, (h, w) in enumerate([(384, 400), (30, 41)]):
            img = _img(40 + seed, h, w)
            want = ref.predict_one(img)
            assert 0 < want.mean() < 1
            _agree(port.predict_one(img), want)
    finally:
        port.stop()
        ref.stop()
    views = len(TTA_MODES[kw.get("tta_mode", "flips")]) if kw.get("tta") else 1
    assert tiled == ([(views, 384, 400, 3)] if kw.get("tile") else [])


def test_serve_cli_flags_and_refusals(ckpt):
    server, pred = make_server(["-m", str(ckpt), "--port", "0", "--device", "cpu", "--no-amp",
                                "--tile", "256", "--halo", "128", "--tta", "--tta-mode",
                                "hflip", "--no-device-preprocess"])
    try:
        assert (pred.tile, pred.halo, pred.tta, pred.tta_mode) == (256, 128, True, "hflip")
    finally:
        server.server_close()
        pred.stop()
    # --device-preprocess is ported: on by default under --tile (JAX's
    # default), off without it, and on when asked for.
    for argv, want in ((["--tile", "256"], True), ([], False), (["--device-preprocess"], True)):
        server, pred = make_server(["-m", str(ckpt), "--port", "0", "--device", "cpu", *argv])
        try:
            assert pred.device_preprocess is want
        finally:
            server.server_close()
            pred.stop()
    params, state, mv, _ = load_checkpoint(ckpt, CFG)
    for kw, match in (({"tile": 100}, "multiples of 16"), ({"tile": 128, "halo": 120},
                                                           "multiples of 16"),
                      ({"tile": 128, "kernels": "torch"}, "--tile serving runs the eval"),
                      ({"tta": True, "kernels": "cuda"}, "--tta serving composes")):
        with pytest.raises(ValueError, match=match):
            BatchedPredictor(params, state, CFG, mv, device="cpu", **kw)


@pytest.mark.parametrize("n_classes,mode", [(1, "flips"), (3, "flips"), (3, "hflip")])
def test_eval_steps_tta_equal_jax(n_classes, mode):
    jcfg = JConfig(3, n_classes, False, base_channels=8)
    params, state = jax.device_get(j_init(jax.random.PRNGKey(n_classes), jcfg))
    rng = np.random.default_rng(n_classes)
    images = rng.random((2, 24, 20, 3), dtype=np.float32)
    masks = rng.integers(0, n_classes if n_classes > 1 else 2, (2, 24, 20))
    tp, ts = tree_from_numpy(params), tree_from_numpy(state)
    cfg = UNetConfig(*jcfg)
    for step, j_step in ((eval_step, j_eval_step), (eval_step_per_class, j_per_class)):
        got = step(tp, ts, torch.from_numpy(images), torch.from_numpy(masks), config=cfg,
                   tta=True, tta_mode=mode)
        ref = j_step(params, state, jnp.asarray(images), jnp.asarray(masks), config=jcfg,
                     tta=True, tta_mode=mode)
        for g, r in zip(got, ref):
            np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=ATOL)


@pytest.mark.parametrize("flags", [["--tta"], ["--tta", "--tta-mode", "hflip", "--per-class"]])
def test_evaluate_cli_tta_equals_jax(ckpt, tmp_path, capsys, flags):
    make_synthetic_carvana(tmp_path / "data", n=5, h=32, w=40, seed=1)
    argv = ["-m", str(ckpt), "--data-dir", str(tmp_path / "data"), "-s", "0.5", "-b", "2", *flags]
    got = evaluate_main(argv + ["--device", "cpu"])
    assert "Dice:" in capsys.readouterr().out
    np.testing.assert_allclose(got, j_evaluate_main(argv), atol=ATOL)
