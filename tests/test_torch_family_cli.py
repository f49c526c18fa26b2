"""The model families through the port's CLIs, on CPU at base 8: one tiny
``train_cli --arch`` epoch (attention, r2u, r2attu, and unetpp with
``--deep-supervision``) on 6 synthetic 48x64 pairs, then ``predict``,
``evaluate`` and ``serve --arch`` on its checkpoint, each against the JAX
package's CLI on the same checkpoint (masks: at most 1e-3 of the pixels may
differ, a logit tie broken the other way; Dice 1e-6), and the r2u/r2attu
RMSprop warning at ``-l 3e-4`` and not at the default lr. What the JAX
package refuses for a family stays refused: ``--kernels`` where
``fold_bn`` does not fold, ``--kernels cuda``, and ``.pth``.
"""

import http.client
import io
import json
import logging
import threading

import numpy as np
import pytest
import torch
from PIL import Image

from tpu_unet.evaluate import main as j_evaluate_main
from tpu_unet.predict import main as j_predict_main
from tpu_unet_torch import train_cli
from tpu_unet_torch.checkpoint import load_checkpoint, read_checkpoint_meta
from tpu_unet_torch.data import make_synthetic_carvana
from tpu_unet_torch.evaluate import main as evaluate_main
from tpu_unet_torch.models import unet as t_unet
from tpu_unet_torch.models.unet import UNetConfig
from tpu_unet_torch.predict import main as predict_main
from tpu_unet_torch.serve import make_server

BASE = 8
TIES = 1e-3
ATOL = 1e-6
RUNS = {"attention": [], "r2u": [], "r2attu": ["-l", "3e-4"],
        "unetpp": ["--deep-supervision"]}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's torch work: the suite runs six
    workers on the machine's cores, and small CPU ops gain nothing from more
    threads while the workers' threads contend for them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("family_cli")
    make_synthetic_carvana(root / "data", n=6, h=48, w=64, seed=0)
    return root


@pytest.fixture(scope="module")
def trained(data):
    """One epoch of each family through train_cli (base 8): {arch: (checkpoint,
    history, log text)}."""
    mp = pytest.MonkeyPatch()
    mp.setattr(t_unet, "UNetConfig", lambda **kw: UNetConfig(**kw, base_channels=BASE))
    out = {}
    logger = logging.getLogger("tpu_unet_torch.train")
    level = logger.level
    logger.setLevel(logging.INFO)
    try:
        for arch, extra in RUNS.items():
            ck = data / f"ck_{arch}"
            records = []
            handler = logging.Handler()
            handler.emit = records.append
            logger.addHandler(handler)
            try:
                _, _, history = train_cli.main(
                    ["--device", "cpu", "--arch", arch, "-e", "1", "-b", "2", "-s", "1.0",
                     "-v", "34", "--val-per-epoch", "1", "--data-dir", str(data / "data"),
                     "--checkpoint-dir", str(ck), *extra])
            finally:
                logger.removeHandler(handler)
            out[arch] = (ck / "checkpoint_epoch1.npz", history,
                         "\n".join(r.getMessage() for r in records))
    finally:
        mp.undo()
        logger.setLevel(level)
    return out


@pytest.mark.parametrize("arch", list(RUNS))
def test_train_cli_trains_the_family(trained, arch):
    ckpt, history, _ = trained[arch]
    assert len(history["train_loss"]) == 2 and len(history["val_dice"]) == 1
    assert np.isfinite(history["train_loss"]).all()
    _, extra = read_checkpoint_meta(ckpt)
    cfg = UNetConfig(**extra["config"])
    assert (cfg.arch, cfg.base_channels, cfg.deep_supervision) == (arch, BASE, arch == "unetpp")
    assert cfg.recur_bn == "per_step" and cfg.recur_t == 2
    params, state, _, _ = load_checkpoint(ckpt, cfg)
    if arch in ("r2u", "r2attu"):
        assert set(state["inc"]["rec1"]) == {"bn0", "bn1", "bn2"}
    if arch == "unetpp":
        assert {"head1", "head4"} <= set(params) and "outc" not in params


@pytest.mark.parametrize("arch", ["r2u", "r2attu"])
def test_recurrent_rmsprop_warning_only_at_high_lr(trained, arch):
    """r2attu ran at -l 3e-4, r2u at the default 1e-5."""
    warned = "under RMSprop(momentum>=0.99) diverged" in trained[arch][2]
    assert warned == (arch == "r2attu")
    assert "Starting training: arch=" + arch in trained[arch][2]


def _images(root, n=2):
    paths = []
    for k in range(n):
        paths.append(root / f"in{k}.png")
        rng = np.random.default_rng(10 + k)
        Image.fromarray(rng.integers(0, 255, (48, 64, 3), np.uint8)).save(paths[-1])
    return [str(p) for p in paths]


def _agree(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape and got.dtype == ref.dtype
    assert (got != ref).mean() < TIES


@pytest.mark.parametrize("arch", list(RUNS))
def test_predict_evaluate_serve_the_family(trained, data, tmp_path, arch):
    ckpt = str(trained[arch][0])
    files = _images(tmp_path)
    outs = {tag: [str(tmp_path / f"{tag}{k}.png") for k in range(len(files))]
            for tag in ("port", "jax")}
    argv = ["-m", ckpt, "-i", *files, "-s", "1.0", "--arch", arch]
    predict_main(argv + ["-o", *outs["port"], "--device", "cpu"])
    j_predict_main(argv + ["-o", *outs["jax"]])
    masks = [np.asarray(Image.open(p)) for p in outs["port"]]
    for got, ref in zip(masks, outs["jax"]):
        _agree(got, np.asarray(Image.open(ref)))

    argv = ["-m", ckpt, "--data-dir", str(data / "data"), "-s", "1.0", "-b", "2",
            "--arch", arch]
    np.testing.assert_allclose(evaluate_main(argv + ["--device", "cpu"]), j_evaluate_main(argv),
                               atol=ATOL)

    server, pred = make_server(["-m", ckpt, "--port", "0", "--device", "cpu", "--no-amp",
                                "--arch", arch, "-s", "1.0"])
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    try:
        conn = http.client.HTTPConnection("127.0.0.1", server.server_address[1], timeout=60)
        conn.request("GET", "/healthz")
        assert json.loads(conn.getresponse().read())["arch"] == arch
        with open(files[0], "rb") as f:
            conn.request("POST", "/predict", body=f.read())
        r = conn.getresponse()
        assert r.status == 200
        np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(r.read()))), masks[0])
    finally:
        server.shutdown()
        server.server_close()
        pred.stop()


def test_attention_folded_predict_and_refusals(trained, tmp_path):
    """--kernels torch folds Attention U-Net (masks as the eval forward's);
    --kernels cuda stays the U-Net's, and the other families refuse
    --kernels, in predict and serve alike."""
    files = _images(tmp_path, 1)
    att = str(trained["attention"][0])
    for tag, flags in (("eval", []), ("fold", ["--kernels", "torch"])):
        predict_main(["-m", att, "-i", *files, "-s", "1.0", "-o", str(tmp_path / f"{tag}.png"),
                      "--device", "cpu", *flags])
    _agree(np.asarray(Image.open(tmp_path / "fold.png")),
           np.asarray(Image.open(tmp_path / "eval.png")))
    for arch, kernels, match in (("attention", "cuda", "CUDA fused-inference tier"),
                                 ("r2u", "torch", "support arch='unet'/'attention'"),
                                 ("unetpp", "cuda", "support arch='unet'/'attention'")):
        ckpt = str(trained[arch][0])
        with pytest.raises(SystemExit, match=match):
            predict_main(["-m", ckpt, "-i", *files, "-n", "--device", "cpu", "--kernels", kernels])
        with pytest.raises(SystemExit, match=match):
            make_server(["-m", ckpt, "--port", "0", "--device", "cpu", "--kernels", kernels])
    with pytest.raises(SystemExit, match="pth import is reference-layout"):
        predict_main(["-m", "x.pth", "--arch", "r2attu", "-i", *files, "--device", "cpu"])
