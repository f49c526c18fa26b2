"""The port's predictor, HTTP server and predict CLI against the JAX
package's, on one JAX checkpoint, fp32 on the CPU. Masks must be equal: the
logits agree to ~1e-5 and the threshold is applied after the same half-pixel
upscale."""

import http.client
import io
import json
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from tpu_unet.checkpoint import save_checkpoint as j_save
from tpu_unet.models import UNetConfig as JConfig
from tpu_unet.models import init_unet as j_init
from tpu_unet.models import unet_apply as j_apply
from tpu_unet.predict import main as j_predict_main
from tpu_unet.serve import BatchedPredictor as JPredictor
from tpu_unet_torch import kernels as K
from tpu_unet_torch.checkpoint import load_checkpoint
from tpu_unet_torch.models import UNetConfig
from tpu_unet_torch.predict import main as t_predict_main
from tpu_unet_torch.predict import predict_img_fused
from tpu_unet_torch.serve import BatchedPredictor, make_handler, make_server

REPO = Path(__file__).resolve().parents[1]
JCFG = JConfig(3, 1, bilinear=False, base_channels=8)


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """A JAX checkpoint whose BN state holds the batch statistics of a random
    batch (recovered from one train-mode step's momentum-0.1 update), so
    every layer normalises and the masks have both classes."""
    params, state = j_init(jax.random.PRNGKey(1), JCFG)
    x = jnp.asarray(np.random.default_rng(0).random((2, 32, 40, 3), dtype=np.float32))
    _, stepped = j_apply(params, state, x, config=JCFG, train=True)
    state = jax.tree.map(lambda new, old: (new - 0.9 * old) / 0.1, stepped, state)
    path = tmp_path_factory.mktemp("ckpt") / "unet8.npz"
    j_save(path, params, state, mask_values=[0, 1], extra={"config": JCFG._asdict()})
    return path


@pytest.fixture(scope="module")
def predictor(ckpt):
    params, state, mask_values, _ = load_checkpoint(ckpt, UNetConfig(*JCFG))
    p = BatchedPredictor(params, state, UNetConfig(*JCFG), mask_values, device="cpu",
                         kernels="torch", amp=False, scale=1.0, max_batch=4,
                         batch_window_ms=50.0)
    yield p
    p.stop()


def _img(seed, h=37, w=48):
    rng = np.random.default_rng(seed)
    return Image.fromarray(rng.integers(0, 255, (h, w, 3), dtype=np.uint8))


def test_masks_equal_jax_predictor(ckpt, predictor):
    from tpu_unet.checkpoint import load_checkpoint as j_load

    like_p, like_s = j_init(jax.random.PRNGKey(0), JCFG)
    jp, js, mv, _ = j_load(ckpt, like_p, like_s)
    jpred = JPredictor(jp, js, JCFG, mv, scale=1.0, amp=False, kernels="xla")
    try:
        for seed, (h, w) in enumerate([(37, 48), (32, 32), (29, 53)]):
            img = _img(seed, h, w)
            ref = jpred.predict_one(img)
            out = predictor.predict_one(img)
            assert out.shape == (h, w) and out.dtype == bool
            assert 0 < ref.mean() < 1  # a mask with both classes
            np.testing.assert_array_equal(out, ref)
    finally:
        jpred.stop()


def test_concurrent_requests_microbatch_match_solo(ckpt, predictor):
    imgs = [_img(10 + k) for k in range(4)]
    results = [None] * 4

    def call(k):
        results[k] = predictor.predict_one(imgs[k])

    before = predictor.metrics.snapshot().get("dispatches", 0)
    threads = [threading.Thread(target=call, args=(k,)) for k in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert predictor.metrics.snapshot()["dispatches"] - before < 4  # at least one batch of 2+
    params, state, _, _ = load_checkpoint(ckpt)
    for img, got in zip(imgs, results):
        solo = predict_img_fused(params, state, UNetConfig(*JCFG), img, backend="torch",
                                 scale_factor=1.0, device="cpu")
        np.testing.assert_array_equal(got, solo)


def test_http_endpoints(predictor):
    from http.server import ThreadingHTTPServer

    server = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(predictor))
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    try:
        conn = http.client.HTTPConnection("127.0.0.1", server.server_address[1], timeout=60)
        conn.request("GET", "/healthz")
        r = conn.getresponse()
        health = r.read()
        assert r.status == 200 and b'"ok"' in health and b'"kernels": "torch"' in health
        buf = io.BytesIO()
        _img(20).save(buf, format="PNG")
        conn.request("POST", "/predict", body=buf.getvalue())
        r = conn.getresponse()
        assert r.status == 200
        mask = np.asarray(Image.open(io.BytesIO(r.read())))
        assert mask.shape == (37, 48)
        np.testing.assert_array_equal(mask, predictor.predict_one(_img(20)))
        conn.request("GET", "/metrics")
        r = conn.getresponse()
        metrics = json.loads(r.read())
        assert r.status == 200 and metrics["requests"] >= 1 and "p50" in metrics["latency_ms"]
        conn.request("POST", "/predict", body=b"not an image")
        assert conn.getresponse().status == 500
        conn.request("GET", "/nope")
        assert conn.getresponse().status == 404
    finally:
        server.shutdown()
        server.server_close()


def test_make_server_from_cli_flags(ckpt):
    server, pred = make_server(["-m", str(ckpt), "--port", "0", "--device", "cpu",
                                "--kernels", "cuda", "--no-amp", "-s", "1.0",
                                "--warmup", "16x24"])
    try:
        assert pred.kernels == "cuda" and pred.device.type == "cpu"
        assert pred.metrics.snapshot()["requests"] == 0  # warmup not counted
        assert server.server_address[1] > 0
    finally:
        server.server_close()
        pred.stop()
    # Ported: --device-preprocess resizes each raw request on the device, here
    # before the folded forward; the masks equal the host path's and JAX's.
    from tpu_unet.checkpoint import load_checkpoint as j_load

    server, pred = make_server(["-m", str(ckpt), "--port", "0", "--device", "cpu",
                                "--kernels", "torch", "--no-amp", "-s", "0.5",
                                "--device-preprocess"])
    like_p, like_s = j_init(jax.random.PRNGKey(0), JCFG)
    jp, js, mv, _ = j_load(ckpt, like_p, like_s)
    jpred = JPredictor(jp, js, JCFG, mv, scale=0.5, amp=False, kernels="xla",
                       device_preprocess=True)
    params, state, _, _ = load_checkpoint(ckpt)
    try:
        assert pred.device_preprocess and not pred.tile
        for seed, (h, w) in enumerate([(74, 96), (64, 80)]):
            img = _img(50 + seed, h, w)
            got = pred.predict_one(img)
            np.testing.assert_array_equal(got, jpred.predict_one(img))
            np.testing.assert_array_equal(got, predict_img_fused(
                params, state, UNetConfig(*JCFG), img, backend="torch", scale_factor=0.5,
                device="cpu"))
    finally:
        jpred.stop()
        server.server_close()
        pred.stop()


def test_predict_cli_png_equals_jax(ckpt, tmp_path):
    img_path = tmp_path / "in.png"
    _img(30, 41, 50).save(img_path)
    j_out, t_out = tmp_path / "jax.png", tmp_path / "port.png"
    j_predict_main(["-m", str(ckpt), "-i", str(img_path), "-o", str(j_out), "-s", "1.0",
                    "--kernels", "xla"])
    K.reset_launch_counts()
    t_predict_main(["-m", str(ckpt), "-i", str(img_path), "-o", str(t_out), "-s", "1.0",
                    "--kernels", "cuda", "--device", "cpu"])
    assert all(n == 0 for n in K.launch_counts().values())  # CPU: plain versions
    ref, out = Image.open(j_out), Image.open(t_out)
    assert out.mode == ref.mode and out.size == ref.size
    assert 0 < np.asarray(ref).mean() < 1
    np.testing.assert_array_equal(np.asarray(out), np.asarray(ref))


class _Forwards:
    """Records which forward a predict or serve call runs: the eval-mode
    ``unet_apply`` or the folded ``unet_infer_apply``."""

    def __init__(self, monkeypatch, *modules):
        from tpu_unet_torch.models import infer, unet

        real = {"unet_apply": unet.unet_apply, "unet_infer_apply": infer.unet_infer_apply}
        self.calls = []
        for mod in modules:
            for name, fn in real.items():
                monkeypatch.setattr(mod, name, self._recording(name, fn), raising=False)

    def _recording(self, name, real):
        def call(*args, **kwargs):
            self.calls.append(name)
            return real(*args, **kwargs)
        return call


def test_predict_cli_default_is_the_eval_forward_and_equals_jax(ckpt, tmp_path, monkeypatch):
    """Without --kernels the port's predict runs the unfolded eval-mode
    forward, as the reference's predict_img does, and writes its PNG."""
    import tpu_unet_torch.predict as t_predict

    img_path = tmp_path / "in.png"
    _img(32, 43, 47).save(img_path)
    j_out, t_out = tmp_path / "jax.png", tmp_path / "port.png"
    j_predict_main(["-m", str(ckpt), "-i", str(img_path), "-o", str(j_out), "-s", "1.0"])
    seen = _Forwards(monkeypatch, t_predict)
    t_predict_main(["-m", str(ckpt), "-i", str(img_path), "-o", str(t_out), "-s", "1.0",
                    "--device", "cpu"])
    assert seen.calls == ["unet_apply"]
    ref, out = Image.open(j_out), Image.open(t_out)
    assert out.mode == ref.mode and out.size == ref.size
    assert 0 < np.asarray(ref).mean() < 1
    np.testing.assert_array_equal(np.asarray(out), np.asarray(ref))
    seen.calls.clear()
    t_predict_main(["-m", str(ckpt), "-i", str(img_path), "-o", str(t_out), "-s", "1.0",
                    "--device", "cpu", "--kernels", "torch"])
    assert seen.calls == ["unet_infer_apply"]


def test_serve_default_is_the_eval_forward_and_equals_jax(ckpt, monkeypatch):
    """Without --kernels the port's server runs the eval-mode forward, as the
    reference's does (its BatchedPredictor with kernels=None)."""
    import tpu_unet_torch.serve as t_serve
    from tpu_unet.checkpoint import load_checkpoint as j_load

    seen = _Forwards(monkeypatch, t_serve)
    server, pred = make_server(["-m", str(ckpt), "--port", "0", "--device", "cpu", "--no-amp",
                                "-s", "1.0"])
    like_p, like_s = j_init(jax.random.PRNGKey(0), JCFG)
    jp, js, mv, _ = j_load(ckpt, like_p, like_s)
    jpred = JPredictor(jp, js, JCFG, mv, scale=1.0, amp=False)
    try:
        assert pred.kernels is None
        for seed, (h, w) in enumerate([(37, 48), (30, 41)]):
            img = _img(40 + seed, h, w)
            ref = jpred.predict_one(img)
            assert 0 < ref.mean() < 1
            np.testing.assert_array_equal(pred.predict_one(img), ref)
        assert set(seen.calls) == {"unet_apply"}
    finally:
        jpred.stop()
        server.server_close()
        pred.stop()


def test_predict_cli_refuses_unported_flags_and_missing_gpu(ckpt, tmp_path):
    img_path = tmp_path / "in.png"
    _img(31).save(img_path)
    # Every family predicts; a family's .pth is refused, as in the JAX package.
    for flag, match in ((["--tile-sharded", "--batch-size", "2"],
                         "--batch-size composes with the default"),
                        (["-m", "x.pth", "--arch", "unetpp"], "pth import is reference-layout")):
        with pytest.raises(SystemExit, match=match):
            t_predict_main(["-m", str(ckpt), "-i", str(img_path), "--device", "cpu", *flag])
    # --device-preprocess is ported; JAX's refusals of it hold.
    for flag in (["--tile", "64"], ["--kernels", "cuda"]):
        with pytest.raises(SystemExit, match="--device-preprocess applies to the default"):
            t_predict_main(["-m", str(ckpt), "-i", str(img_path), "--device", "cpu",
                            "--device-preprocess", *flag])
    with pytest.raises(SystemExit, match="--tile does not compose with --kernels"):
        t_predict_main(["-m", str(ckpt), "-i", str(img_path), "--device", "cpu", "--tile", "64",
                        "--kernels", "cuda"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            t_predict_main(["-m", str(ckpt), "-i", str(img_path)])
        params, state, _, _ = load_checkpoint(ckpt)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            BatchedPredictor(params, state, UNetConfig(*JCFG), None)


def test_synthetic_data_and_preprocess_match_jax(tmp_path):
    from tpu_unet.data.loading import BasicDataset
    from tpu_unet.data.synthetic import make_synthetic_carvana as j_make
    from tpu_unet_torch.data import make_synthetic_carvana, preprocess

    j_imgs, j_masks = j_make(tmp_path / "jax", n=3, h=37, w=50, seed=4)
    t_imgs, t_masks = make_synthetic_carvana(tmp_path / "port", n=3, h=37, w=50, seed=4)
    for jd, td in ((j_imgs, t_imgs), (j_masks, t_masks)):
        names = sorted(p.name for p in jd.iterdir())
        assert names == sorted(p.name for p in td.iterdir()) and len(names) == 3
        for name in names:
            ja, ta = Image.open(jd / name), Image.open(td / name)
            np.testing.assert_array_equal(np.asarray(ta), np.asarray(ja))
    for scale in (0.5, 1.0, 0.37):
        img = Image.open(t_imgs / "car_0001.png")
        np.testing.assert_array_equal(preprocess(img, scale),
                                      BasicDataset.preprocess(None, img, scale, is_mask=False))


def test_port_imports_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import tpu_unet_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(tpu_unet_torch.__path__, 'tpu_unet_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'tpu_unet.'))"
        " or m == 'tpu_unet')\n"
        "assert not bad, bad\n"
        "assert len(mods) >= 15, mods\n"
        "new = {'export', 'submit', 'hub', 'hubconf', 'dryrun', 'tools.collect_arch_demos'}\n"
        "assert {'tpu_unet_torch.' + m for m in new} <= set(mods), mods\n"
        "print(len(mods))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
