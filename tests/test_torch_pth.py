"""The port's ``.pth`` import and export and checkpoint averaging
(``tpu_unet_torch/checkpoint.py``) against the JAX package's
``tpu_unet/checkpoint.py``, on the CPU.

- A ``.pth`` written from ``tests/torch_ref.py``'s ``RefUNet`` (the
  reference's tensor order) imports in both packages to bitwise equal
  arrays, and the port's forward of it matches ``RefUNet``'s.
- The port's ``export_pth`` loads ``strict=True`` into a torch U-Net with the
  upstream module names (``tests/test_checkpoint.py``'s; ``RefUNet`` renames
  its submodules), whose forward equals the port's; it re-imports bitwise in
  both packages.
- ``average_checkpoints`` writes JAX's arrays and metadata.
- ``predict``/``evaluate``/``serve -m x.pth`` and ``train_cli --load x.pth``
  run from the file.

Forward tolerance: ``atol=2e-3, rtol=1e-3``, JAX's own for the torch
oracle (NCHW cuDNN-free CPU convs against NHWC ones, base 8).
"""

import json

import numpy as np
import pytest
import torch
from PIL import Image

import jax

from tests.test_checkpoint import _upstream_named_unet
from tests.torch_ref import RefUNet
from tpu_unet.checkpoint import average_checkpoints as j_average
from tpu_unet.checkpoint import import_pth as j_import_pth
from tpu_unet.checkpoint import save_checkpoint as j_save
from tpu_unet.models import UNetConfig as JConfig, init_unet as j_init
from tpu_unet_torch import avg_checkpoints, train_cli
from tpu_unet_torch.checkpoint import (
    average_checkpoints,
    export_pth,
    flatten,
    import_pth,
    save_checkpoint,
    tree_from_numpy,
)
from tpu_unet_torch.data import make_synthetic_carvana
from tpu_unet_torch.evaluate import main as evaluate_main
from tpu_unet_torch.models import unet as t_unet
from tpu_unet_torch.models.unet import UNetConfig, init_unet, unet_apply
from tpu_unet_torch.predict import load_model, main as predict_main
from tpu_unet_torch.serve import make_server


def _ref_pth(tmp_path, bilinear, mask_values=(0, 255), n_classes=2):
    torch.manual_seed(0)
    model = RefUNet(3, n_classes, bilinear=bilinear, base=8).eval()
    with torch.no_grad():  # non-trivial running statistics
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.uniform_(-0.1, 0.1)
                m.running_var.uniform_(0.5, 1.5)
    sd = model.state_dict()
    sd["mask_values"] = list(mask_values)  # the reference's palette in the file
    path = tmp_path / "ref.pth"
    torch.save(sd, path)
    return model, path


def _calibrated(cfg, seed):
    """The port's init with the BN state set to a random batch's statistics
    (recovered from one train-mode step's momentum-0.1 update) and the
    head's bias moved to put the batch's median logit at 0, so the masks
    have both classes."""
    from tpu_unet_torch.models.unet import tree_map

    params, state = init_unet(cfg, np.random.default_rng(seed))
    x = torch.from_numpy(np.random.default_rng(9).random((2, 32, 40, 3), dtype=np.float32))
    with torch.no_grad():
        _, stepped = unet_apply(params, state, x, config=cfg, train=True)
        state = tree_map(lambda new, old: (new - 0.9 * old) / 0.1, stepped, state)
        logits, _ = unet_apply(params, state, x, config=cfg)
    params["outc"]["b"] -= logits.median()
    return params, state


def _nhwc_forward(model, x):
    with torch.no_grad():
        return model(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()


def _flat_np(params, state):
    return {k: np.asarray(v) for k, v in flatten(params, state).items()}


def _flat_jax(params, state):
    leaves = jax.tree_util.tree_flatten_with_path((params, state))[0]
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in leaves}


@pytest.mark.parametrize("bilinear", [False, True])
def test_ref_pth_imports_bitwise_in_both_packages(tmp_path, bilinear):
    model, path = _ref_pth(tmp_path, bilinear)
    cfg = UNetConfig(3, 2, bilinear=bilinear, base_channels=8)
    params, state, mv = import_pth(path, cfg)
    jp, js, jmv = j_import_pth(path, JConfig(*cfg))
    assert mv == jmv == [0, 255]
    ours = _flat_jax(tree_from_numpy(jax.device_get(jp)), tree_from_numpy(jax.device_get(js)))
    got = _flat_jax(params, state)
    assert got.keys() == ours.keys()
    for k in got:
        assert got[k].dtype == ours[k].dtype
        np.testing.assert_array_equal(got[k], ours[k], err_msg=k)
    x = np.random.default_rng(0).standard_normal((1, 32, 32, 3), dtype=np.float32)
    with torch.inference_mode():
        logits, _ = unet_apply(params, state, torch.from_numpy(x), config=cfg)
    np.testing.assert_allclose(logits.numpy(), _nhwc_forward(model, x), atol=2e-3, rtol=1e-3)


@pytest.mark.parametrize("bilinear", [False, True])
def test_export_pth_loads_strict_upstream_and_reimports(tmp_path, bilinear):
    cfg = UNetConfig(3, 2, bilinear=bilinear, base_channels=8)
    params, state = init_unet(cfg, np.random.default_rng(3))
    path = tmp_path / "ours.pth"
    export_pth(path, params, state, cfg, mask_values=[0, 128])
    sd = torch.load(path, map_location="cpu", weights_only=True)
    assert sd.pop("mask_values") == [0, 128]
    assert sd["inc.double_conv.1.num_batches_tracked"].dtype == torch.long
    model = _upstream_named_unet(3, 2, bilinear, 8)
    model.load_state_dict(sd, strict=True)  # raises on any key or shape drift
    model.eval()
    x = np.random.default_rng(1).standard_normal((1, 32, 32, 3), dtype=np.float32)
    with torch.inference_mode():
        logits, _ = unet_apply(params, state, torch.from_numpy(x), config=cfg)
    np.testing.assert_allclose(logits.numpy(), _nhwc_forward(model, x), atol=2e-3, rtol=1e-3)
    want = _flat_np(params, state)
    p2, s2, mv = import_pth(path, cfg)
    jp, js, jmv = j_import_pth(path, JConfig(*cfg))
    assert mv == jmv == [0, 128]
    for got in (_flat_np(p2, s2), _flat_np(tree_from_numpy(jax.device_get(jp)),
                                           tree_from_numpy(jax.device_get(js)))):
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_pth_with_rgb_palette_loads_weights_only(tmp_path):
    """The reference's multiclass files hold ``mask_values`` as a list of RGB
    lists: ``weights_only=True`` reads them."""
    palette = [[0, 0, 0], [255, 0, 0], [0, 255, 0]]
    _, path = _ref_pth(tmp_path, False, mask_values=palette, n_classes=3)
    _, _, mv = import_pth(path, UNetConfig(3, 3, bilinear=False, base_channels=8))
    assert mv == palette


def test_average_checkpoints_equals_jax(tmp_path):
    jcfg = JConfig(3, 1, bilinear=False, base_channels=8)
    paths = []
    for i in range(3):
        p, s = j_init(jax.random.PRNGKey(i), jcfg)
        paths.append(tmp_path / f"c{i}.npz")
        j_save(paths[-1], p, s, mask_values=[0, 10 * i], extra={"epoch": i,
                                                                 "config": jcfg._asdict()})
    average_checkpoints(paths, tmp_path / "t.npz")
    j_average(paths, tmp_path / "j.npz")
    with np.load(tmp_path / "t.npz") as t, np.load(tmp_path / "j.npz") as j:
        assert t.files == j.files
        for k in t.files:
            assert t[k].dtype == j[k].dtype
            np.testing.assert_array_equal(t[k], j[k], err_msg=k)
        meta = json.loads(bytes(t["__meta__"].tolist()).decode())
    assert meta["mask_values"] == [0, 20] and meta["extra"]["epoch"] == 2
    assert meta["extra"]["averaged_from"] == ["c0.npz", "c1.npz", "c2.npz"]
    assert meta["has_opt_state"] is False
    # A checkpoint averaged with itself is itself; the CLI writes the same file.
    avg_checkpoints.main([str(paths[0]), str(paths[0]), "-o", str(tmp_path / "self.npz")])
    with np.load(tmp_path / "self.npz") as a, np.load(paths[0]) as b:
        for k in b.files:
            if k != "__meta__":
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_average_checkpoints_refuses_mismatched_trees(tmp_path):
    save_checkpoint(tmp_path / "a.npz", *init_unet(UNetConfig(3, 1, base_channels=8),
                                                   np.random.default_rng(0)))
    save_checkpoint(tmp_path / "b.npz", *init_unet(UNetConfig(3, 1, base_channels=4),
                                                   np.random.default_rng(0)))
    save_checkpoint(tmp_path / "c.npz", *init_unet(UNetConfig(3, 1, bilinear=True,
                                                              base_channels=8),
                                                   np.random.default_rng(0)))
    with pytest.raises(ValueError, match="shape mismatch"):
        average_checkpoints([tmp_path / "a.npz", tmp_path / "b.npz"], tmp_path / "x.npz")
    with pytest.raises(ValueError, match="different parameter tree"):
        average_checkpoints([tmp_path / "a.npz", tmp_path / "c.npz"], tmp_path / "x.npz")
    with pytest.raises(ValueError, match="at least one"):
        average_checkpoints([], tmp_path / "x.npz")


def test_clis_take_a_pth(tmp_path):
    """predict, evaluate and serve read a .pth with the CLI's config, and
    their output equals that of the same weights as a .npz; .jaxexp is
    refused."""
    cfg = UNetConfig(3, 1, bilinear=False, base_channels=8)
    params, state = _calibrated(cfg, 4)
    pth, npz = tmp_path / "m.pth", tmp_path / "m.npz"
    export_pth(pth, params, state, cfg, mask_values=[0, 255])
    save_checkpoint(npz, params, state, [0, 255], {"config": cfg._asdict()})
    _, _, config, mv = load_model(pth, cfg, torch.device("cpu"))
    assert config == cfg and mv == [0, 255]
    with pytest.raises(SystemExit, match="needs jax; export a .pt2"):
        load_model(tmp_path / "m.jaxexp", cfg, torch.device("cpu"))
    img = tmp_path / "in.png"
    Image.fromarray(np.random.default_rng(5).integers(0, 255, (30, 40, 3), np.uint8)).save(img)
    flags = ["--device", "cpu", "-s", "1.0"]
    for name, model in (("pth", pth), ("npz", npz)):
        predict_main(["-m", str(model), "-i", str(img), "-o", str(tmp_path / f"{name}.png"),
                      *flags])
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "pth.png")),
                                  np.asarray(Image.open(tmp_path / "npz.png")))
    make_synthetic_carvana(tmp_path / "data", n=3, h=32, w=40, seed=1)
    dice = [evaluate_main(["-m", str(m), "--data-dir", str(tmp_path / "data"), *flags])
            for m in (pth, npz)]
    assert dice[0] == dice[1]
    server, pred = make_server(["-m", str(pth), "--port", "0", "--no-amp", *flags])
    try:
        assert pred.mask_values == [0, 255]
        mask = pred.predict_one(Image.open(img))
    finally:
        server.server_close()
        pred.stop()
    png = np.asarray(Image.open(tmp_path / "pth.png"))
    assert 0 < mask.mean() < 1
    np.testing.assert_array_equal(png, np.where(mask, 255, 0).astype(png.dtype))


def test_train_cli_loads_a_pth(tmp_path, monkeypatch):
    """``--load x.pth`` trains from the file's weights: the run equals the
    one from the same weights as a ``.npz``."""
    monkeypatch.setattr(t_unet, "UNetConfig", lambda **kw: UNetConfig(**kw, base_channels=8))
    cfg = UNetConfig(3, 1, bilinear=False, base_channels=8)
    params, state = init_unet(cfg, np.random.default_rng(6))
    export_pth(tmp_path / "w.pth", params, state, cfg)
    save_checkpoint(tmp_path / "w.npz", params, state)
    make_synthetic_carvana(tmp_path / "data", n=4, h=32, w=40, seed=2)
    runs = {}
    for name in ("pth", "npz"):
        runs[name] = train_cli.main(
            ["--device", "cpu", "-e", "1", "-b", "2", "-s", "1.0", "-v", "25",
             "--data-dir", str(tmp_path / "data"), "--load", str(tmp_path / f"w.{name}"),
             "--checkpoint-dir", str(tmp_path / name)])
    assert runs["pth"][2] == runs["npz"][2]  # the history: losses and val Dice
    for a, b in zip(flatten(*runs["pth"][:2]).values(), flatten(*runs["npz"][:2]).values()):
        np.testing.assert_array_equal(a, b)
