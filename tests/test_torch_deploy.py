"""The port's deployment surface against the JAX package's, fp32 on the CPU:
multi-model serving (``serve.parse_model_specs``, the nested endpoints,
``--mask-values``), ``.pt2`` export (``export.py``) against JAX's
``.jaxexp``, and serving of the artifact. Two JAX checkpoints (base 8, one
class with a ConvTranspose decoder, two classes bilinear) whose BN state
holds a random batch's statistics carry the weights across."""

import http.client
import io
import json
import os
import re
import signal
import subprocess
import sys
import threading
from argparse import Namespace
from http.server import ThreadingHTTPServer
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
from tpu_unet_torch.checkpoint import load_checkpoint
from tpu_unet_torch.models import UNetConfig

REPO = Path(__file__).resolve().parents[1]
JCFG_A = JConfig(3, 1, bilinear=False, base_channels=8)
JCFG_B = JConfig(3, 2, bilinear=True, base_channels=8)
HW = (32, 48)  # the artifacts' static input
# Logits of the port's .pt2 against JAX's .jaxexp (the same folded fp32
# forward, XLA's convs against oneDNN's): max |diff| 1.1e-5 measured over
# both models, with and without TTA, at logits up to 2.3.
EXPORT_ATOL = 1e-4


def _calibrated_ckpt(path, cfg, seed):
    params, state = j_init(jax.random.PRNGKey(seed), cfg)
    x = jnp.asarray(np.random.default_rng(seed).random((2, 32, 40, 3), dtype=np.float32))
    _, stepped = j_apply(params, state, x, config=cfg, train=True)
    state = jax.tree.map(lambda new, old: (new - 0.9 * old) / 0.1, stepped, state)
    mask_values = [0, 1] if cfg.n_classes == 1 else [0, 128]
    j_save(path, params, state, mask_values=mask_values, extra={"config": cfg._asdict()})
    return path


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    d = tmp_path_factory.mktemp("deploy")
    return _calibrated_ckpt(d / "a.npz", JCFG_A, 1), _calibrated_ckpt(d / "b.npz", JCFG_B, 2)


@pytest.fixture(scope="module")
def artifacts(ckpts, tmp_path_factory):
    """One fp32 export of model a by each package's CLI: JAX's .jaxexp (CPU
    platform), the port's symbolic-batch .pt2 (with --check) and a pinned
    batch-2 one."""
    from tpu_unet.export import main as j_export
    from tpu_unet_torch.export import main as t_export

    d = tmp_path_factory.mktemp("artifacts")
    size = ["--height", str(HW[0]), "--width", str(HW[1]), "--no-amp"]
    j_export(["-m", str(ckpts[0]), "-o", str(d / "a.jaxexp"), *size, "--platforms", "cpu"])
    t_export(["-m", str(ckpts[0]), "-o", str(d / "a.pt2"), *size, "--device", "cpu", "--check"])
    t_export(["-m", str(ckpts[0]), "-o", str(d / "a_b2.pt2"), *size, "--batch", "2",
              "--device", "cpu"])
    return d


def _img(seed, h=37, w=48):
    return Image.fromarray(np.random.default_rng(seed).integers(0, 255, (h, w, 3), np.uint8))


def _png(img) -> bytes:
    buf = io.BytesIO()
    img.save(buf, format="PNG")
    return buf.getvalue()


class _Served:
    """A handler on a free localhost port, serving in a thread."""

    def __init__(self, server):
        self.server = server
        self.port = server.server_address[1]
        self.thread = threading.Thread(target=server.serve_forever, daemon=True)
        self.thread.start()

    def request(self, method, path, body=None):
        conn = http.client.HTTPConnection("127.0.0.1", self.port, timeout=120)
        try:
            conn.request(method, path, body=body)
            r = conn.getresponse()
            return r.status, r.read()
        finally:
            conn.close()

    def json(self, path):
        status, body = self.request("GET", path)
        assert status == 200
        return json.loads(body)

    def close(self):
        self.server.shutdown()
        self.server.server_close()
        self.thread.join(timeout=10)


def _jax_args(**kw):
    args = dict(classes=1, bilinear=False, arch="unet", tile=None, kernels=None, tta=False,
                tta_mode="flips", device_preprocess=None, mask_values=None, max_batch=4,
                scale=1.0, mask_threshold=0.5, amp=False, batch_window_ms=5.0,
                timeout_s=300.0, halo=128, warmup=None)
    args.update(kw)
    return Namespace(**args)


def _jax_server(specs, **kw):
    from tpu_unet.serve import build_predictor, make_handler

    preds = {name: build_predictor(str(path), _jax_args(**kw)) for name, path in specs}
    return _Served(ThreadingHTTPServer(("127.0.0.1", 0), make_handler(preds, default=specs[0][0]))
                   ), preds


def _port_server(argv):
    from tpu_unet_torch.serve import make_server

    server, served = make_server(["--port", "0", "--device", "cpu", "--no-amp", "-s", "1.0",
                                  "--max-batch", "4", *argv])
    return _Served(server), served


def _stop(*served):
    for s in served:
        for p in (s.values() if isinstance(s, dict) else [s]):
            p.stop()


SPEC_CASES = [
    (["ckpt.npz"], None),
    (["a=ckpt.npz", "b=other.pth"], None),
    (["dir/x=1.npz"], None),  # a separator on the left: a path
    (["x.npz=y.npz"], None),  # an extension on the left: a path
    (["m=model.pt2", "m2=model.jaxexp"], None),
    (["EXISTING"], None),  # an existing file whose name holds '='
    (["a=x.npz", "a=y.npz"], SystemExit),
    (["x.npz", "d/x.npz"], SystemExit),
]


@pytest.mark.parametrize("specs,raises", SPEC_CASES)
def test_parse_model_specs_match_jax(specs, raises, tmp_path):
    from tpu_unet.serve import parse_model_specs as j_parse
    from tpu_unet_torch.serve import parse_model_specs

    existing = tmp_path / "lr=1e-3" / "ckpt.npz"
    existing.parent.mkdir()
    existing.touch()
    specs = [str(existing) if s == "EXISTING" else s for s in specs]
    if raises:
        for parse in (j_parse, parse_model_specs):
            with pytest.raises(raises, match="duplicate model names"):
                parse(specs)
        return
    got = parse_model_specs(specs)
    assert got == j_parse(specs)
    if specs[0] == str(existing):
        assert got == [("ckpt", str(existing))]


@pytest.mark.parametrize("mask_values", [None, "0,255"])
def test_multi_model_server_matches_jax(ckpts, mask_values):
    """Two models behind one server: each /predict/<name> PNG is byte-equal
    to JAX's multi-model server's, bare /predict is the first model's, an
    unknown name is 404, and /healthz and /metrics nest as JAX's do."""
    specs = [("a", ckpts[0]), ("b", ckpts[1])]
    extra = ["--mask-values", mask_values] if mask_values else []
    port, t_preds = _port_server([arg for n, p in specs for arg in ("-m", f"{n}={p}")] + extra)
    jax_srv, j_preds = _jax_server(specs, mask_values=mask_values)
    try:
        assert set(t_preds) == {"a", "b"}
        for seed, (h, w) in enumerate([(37, 48), (30, 41)]):
            body = _png(_img(seed, h, w))
            for path in ("/predict/a", "/predict/b", "/predict"):
                status, got = port.request("POST", path, body)
                j_status, want = jax_srv.request("POST", path, body)
                assert status == j_status == 200
                assert got == want, path
            pixels = set(np.unique(np.asarray(Image.open(io.BytesIO(got)))).tolist())
            assert pixels <= ({0, 255} if mask_values else {0, 1})
        status, body = port.request("POST", "/predict/zzz", _png(_img(9)))
        assert status == 404 and b"unknown model 'zzz'" in body
        assert port.request("POST", "/nope", b"")[0] == 404
        assert port.request("POST", "/predict/b", b"not an image")[0] == 500
        health, j_health = port.json("/healthz"), jax_srv.json("/healthz")
        assert health.keys() == j_health.keys() == {"status", "default", "models"}
        assert health["default"] == j_health["default"] == "a"
        for name in ("a", "b"):
            mine, theirs = health["models"][name], j_health["models"][name]
            assert theirs.keys() <= mine.keys()
            assert {k: mine[k] for k in theirs} == theirs
        metrics, j_metrics = port.json("/metrics"), jax_srv.json("/metrics")
        assert metrics.keys() == j_metrics.keys() == {"a", "b"}
        assert metrics["a"]["requests"] == j_metrics["a"]["requests"] == 4
        assert metrics["b"]["requests"] == 3 and metrics["b"]["errors"] == 1
        assert j_metrics["a"].keys() <= metrics["a"].keys()
    finally:
        port.close()
        jax_srv.close()
        _stop(t_preds, j_preds)


def _check_against_jax(pt2: Path, j_call, n_classes: int) -> None:
    """The reloaded .pt2 against a JAX exported call at batch 1 and 3; the
    batch stays symbolic."""
    from tpu_unet_torch.export import load_exported, program_shapes

    loaded = load_exported(pt2, device="cpu")
    assert program_shapes(loaded) == (None, *HW, n_classes)
    assert len(loaded.constants) >= 64  # the folded weights, lifted
    fwd = loaded.module()
    rng = np.random.default_rng(7)
    for b in (1, 3):
        x = rng.random((b, *HW, 3), dtype=np.float32)
        with torch.inference_mode():
            got = fwd(torch.from_numpy(x)).numpy()
        want = np.asarray(j_call(jnp.asarray(x)))
        assert got.shape == want.shape == (b, *HW, n_classes)
        np.testing.assert_allclose(got, want, atol=EXPORT_ATOL, rtol=0)


def test_pt2_matches_jax_export(artifacts):
    """The CLI's fp32 .pt2 (symbolic batch), reloaded on the CPU, agrees
    with JAX's CLI .jaxexp on the same checkpoint."""
    from tpu_unet.export import load_exported as j_load_exported

    _check_against_jax(artifacts / "a.pt2", j_load_exported(artifacts / "a.jaxexp").call, 1)


def test_pt2_with_tta_matches_jax_export(ckpts, tmp_path):
    """``export_infer(tta=True)`` bakes the four flip views into the program
    as JAX's ``export_infer(tta=True, platforms=("cpu",))`` does (the
    two-class bilinear model)."""
    from tpu_unet.checkpoint import load_checkpoint as j_load
    from tpu_unet.export import export_infer as j_export_infer
    from tpu_unet_torch.export import export_infer, save_exported

    like_p, like_s = j_init(jax.random.PRNGKey(0), JCFG_B)
    jp, js, _, _ = j_load(ckpts[1], like_p, like_s)
    j_exp = j_export_infer(jp, js, JCFG_B, height=HW[0], width=HW[1], amp=False,
                           platforms=("cpu",), tta=True)
    params, state, _, _ = load_checkpoint(ckpts[1], UNetConfig(*JCFG_B))
    ep = export_infer(params, state, UNetConfig(*JCFG_B), height=HW[0], width=HW[1], amp=False,
                      tta=True, device="cpu")
    save_exported(ep, tmp_path / "b.pt2")
    _check_against_jax(tmp_path / "b.pt2", j_exp.call, 2)


def test_export_cli_sidecar_pinned_batch_and_refusals(ckpts, artifacts, tmp_path):
    """The CLI's sidecar equals JAX's; a pinned batch rejects another batch;
    ``-o .pth --check`` round-trips bitwise; .jaxexp, .savedmodel and
    --platforms are refused."""
    from tpu_unet_torch.checkpoint import flatten, import_pth
    from tpu_unet_torch.export import load_artifact_meta, load_exported, program_shapes
    from tpu_unet_torch.export import main as t_export

    meta = load_artifact_meta(artifacts / "a.pt2")
    assert meta == json.loads((artifacts / "a.jaxexp.meta.json").read_text())
    assert meta["mask_values"] == [0, 1] and meta["tta"] is False
    assert load_artifact_meta(tmp_path / "none.pt2") == {}
    pinned = load_exported(artifacts / "a_b2.pt2", device="cpu")
    assert program_shapes(pinned) == (2, *HW, 1)
    fwd = pinned.module()
    assert fwd(torch.zeros((2, *HW, 3))).shape == (2, *HW, 1)
    with pytest.raises(Exception, match="Guard failed|Expected input"):
        fwd(torch.zeros((3, *HW, 3)))

    t_export(["-m", str(ckpts[1]), "-o", str(tmp_path / "b.pth"), "--device", "cpu", "--check"])
    params, state, mv, _ = load_checkpoint(ckpts[1], UNetConfig(*JCFG_B))
    p2, s2, mv2 = import_pth(tmp_path / "b.pth", UNetConfig(*JCFG_B))
    want, got = flatten(params, state), flatten(p2, s2)
    assert want.keys() == got.keys() and mv2 == mv == [0, 128]
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    for out, flags, match in (("x.jaxexp", [], "only jax loads"),
                              ("x.savedmodel", [], "needs TensorFlow with jax2tf"),
                              ("x.pt2", ["--platforms", "cpu"], "placed at load"),
                              ("x.pt2", [], "--height/--width are required")):
        with pytest.raises(SystemExit, match=match):
            t_export(["-m", str(ckpts[0]), "-o", str(tmp_path / out), "--device", "cpu",
                      *flags])
    with pytest.raises(SystemExit, match="fold_bn/unet_infer_apply support"):
        r2u = _calibrated_ckpt(tmp_path / "r2u.npz", JConfig(3, 1, base_channels=8, arch="r2u",
                                                              bilinear=True), 3)
        t_export(["-m", str(r2u), "-o", str(tmp_path / "r2u.pt2"), "--device", "cpu",
                  "--height", "32", "--width", "32"])


def test_serve_pt2_matches_jax_jaxexp(ckpts, artifacts):
    """The port's server of the .pt2 returns the masks JAX's server of the
    .jaxexp returns (both resize each request to the static 32x48 and
    answer at its own size), beside a checkpoint: ``-m a=x.npz -m b=y.pt2
    --mask-values 0,255``. The artifact's sidecar config, its pinned batch
    and its refusals hold."""
    port, t_preds = _port_server(["-m", f"a={ckpts[0]}", "-m", f"b={artifacts / 'a.pt2'}",
                                  "--mask-values", "0,255"])
    jax_srv, j_preds = _jax_server([("a", ckpts[0]), ("b", artifacts / "a.jaxexp")],
                                   mask_values="0,255")
    try:
        art = t_preds["b"]
        assert art.static_hw == HW and art.fixed_batch is None and art.tta is False
        assert art.config == UNetConfig(*JCFG_A) and art.mask_values == [0, 255]
        assert art.metrics.snapshot()["requests"] == 0  # the warm-up is not counted
        for seed, (h, w) in enumerate([(37, 48), (64, 96), (32, 48)]):
            body = _png(_img(20 + seed, h, w))
            for path in ("/predict/a", "/predict/b"):
                status, got = port.request("POST", path, body)
                assert status == 200
                assert got == jax_srv.request("POST", path, body)[1], (path, h, w)
            mask = np.asarray(Image.open(io.BytesIO(got)))
            assert mask.shape == (h, w) and set(np.unique(mask).tolist()) <= {0, 255}
        assert port.json("/healthz")["models"]["b"]["n_classes"] == 1
    finally:
        port.close()
        jax_srv.close()
        _stop(t_preds, j_preds)

    from tpu_unet_torch.serve import make_server

    base = ["--port", "0", "--device", "cpu"]
    with pytest.raises(SystemExit, match="pinned to 2; pass --max-batch 2"):
        make_server(["-m", str(artifacts / "a_b2.pt2"), *base])
    server, pinned = make_server(["-m", str(artifacts / "a_b2.pt2"), "--max-batch", "2", *base])
    try:
        assert pinned.fixed_batch == 2
        assert pinned.predict_one(_img(5)).shape == (37, 48)
    finally:
        server.server_close()
        pinned.stop()
    for flag in (["--tile", "64"], ["--kernels", "torch"], ["--tta"], ["--device-preprocess"]):
        with pytest.raises(SystemExit, match="the artifact is the compiled program"):
            make_server(["-m", str(artifacts / "a.pt2"), *base, *flag])


def test_jaxexp_refused_in_predict_and_serve(artifacts, tmp_path):
    from tpu_unet_torch.predict import main as t_predict
    from tpu_unet_torch.serve import make_server

    img = tmp_path / "in.png"
    _img(3).save(img)
    jaxexp = str(artifacts / "a.jaxexp")
    with pytest.raises(SystemExit, match="needs jax; export a .pt2 with python -m "
                                         "tpu_unet_torch.export"):
        t_predict(["-m", jaxexp, "-i", str(img), "--device", "cpu"])
    with pytest.raises(SystemExit, match="needs jax; export a .pt2"):
        make_server(["-m", jaxexp, "--port", "0", "--device", "cpu"])


def test_serve_cli_routes_and_stops_on_sigterm(ckpts, artifacts):
    """``python -m tpu_unet_torch.serve -m a=x.npz -m b=y.pt2 --mask-values
    0,255 --device cpu`` starts, routes both names, and on SIGTERM stops
    every predictor and exits 0."""
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    proc = subprocess.Popen(
        [sys.executable, "-m", "tpu_unet_torch.serve", "-m", f"a={ckpts[0]}", "-m",
         f"b={artifacts / 'a.pt2'}", "--mask-values", "0,255", "--device", "cpu", "--port", "0",
         "-s", "1.0"], cwd=REPO, env=env, stderr=subprocess.PIPE, text=True)
    watchdog = threading.Timer(120, proc.kill)  # a server that never starts ends the read
    watchdog.start()
    try:
        lines = []
        for line in proc.stderr:
            lines.append(line)
            m = re.search(r"Serving .* on 127\.0\.0\.1:(\d+)", line)
            if m:
                break
        assert m, "".join(lines)
        client = _Served.__new__(_Served)
        client.port = int(m.group(1))
        for name in ("a", "b"):
            status, body = client.request("POST", f"/predict/{name}", _png(_img(4)))
            assert status == 200
            assert np.asarray(Image.open(io.BytesIO(body))).shape == (37, 48)
        proc.send_signal(signal.SIGTERM)
        rest = proc.stderr.read()
        assert proc.wait(timeout=60) == 0, rest
        assert "Server stopped" in rest
    finally:
        watchdog.cancel()
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)
