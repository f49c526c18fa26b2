"""The port's ``evaluate`` and ``evaluate_per_class`` against the JAX
package's, on the CPU in fp32 at base 8: one class and three classes, the
same weights (JAX's init, converted) and the same numpy batches; then the
evaluation CLI against JAX's on one checkpoint and a synthetic dataset.

Tolerance 1e-6 absolute: the scores are ratios of counts of thresholded
pixels, equal when no logit lies within fp32 rounding of the threshold (the
seeded inputs here have none), plus fp32 rounding of the ratios.
"""

import numpy as np
import pytest
import torch

import jax

from tpu_unet.checkpoint import save_checkpoint as j_save_checkpoint
from tpu_unet.evaluate import evaluate as j_evaluate, evaluate_per_class as j_per_class
from tpu_unet.evaluate import main as j_main
from tpu_unet.models import UNetConfig as JConfig, init_unet as j_init_unet
from tpu_unet_torch.checkpoint import tree_from_numpy
from tpu_unet_torch.data import make_synthetic_carvana
from tpu_unet_torch.evaluate import evaluate, evaluate_per_class, main
from tpu_unet_torch.models.unet import UNetConfig

ATOL = 1e-6


def _model(n_classes):
    jcfg = JConfig(3, n_classes, False, base_channels=8)
    params, state = j_init_unet(jax.random.PRNGKey(n_classes), jcfg)
    params, state = jax.device_get(params), jax.device_get(state)
    return (jcfg, UNetConfig(3, n_classes, False, 8), params, state)


def _batches(n_classes):
    rng = np.random.default_rng(n_classes)
    out = []
    for n in (2, 2, 1):  # a ragged last batch, as a loader gives one
        out.append({"image": rng.random((n, 24, 20, 3), dtype=np.float32),
                    "mask": rng.integers(0, n_classes if n_classes > 1 else 2, (n, 24, 20))
                    .astype(np.int32)})
    return out


@pytest.mark.parametrize("n_classes", [1, 3])
def test_evaluate_matches_jax(n_classes):
    jcfg, cfg, params, state = _model(n_classes)
    batches = _batches(n_classes)
    tp, ts = tree_from_numpy(params), tree_from_numpy(state)
    got = evaluate(tp, ts, batches, cfg)
    ref = j_evaluate(params, state, batches, jcfg)
    np.testing.assert_allclose(got, ref, atol=ATOL)
    dice_c, iou_c = evaluate_per_class(tp, ts, batches, cfg)
    jd, ji = j_per_class(params, state, batches, jcfg)
    assert dice_c.shape == (n_classes,)
    np.testing.assert_allclose(dice_c, jd, atol=ATOL)
    np.testing.assert_allclose(iou_c, ji, atol=ATOL)
    # Multiclass: the scalar is the mean over the foreground classes (the
    # background excluded); one class: the class itself.
    fg = slice(1, None) if n_classes > 1 else slice(None)
    np.testing.assert_allclose(dice_c[fg].mean(), got[0], atol=ATOL)
    # amp: the bf16 forward runs and gives a score in range.
    d16, _ = evaluate(tp, ts, batches, cfg, amp=True)
    assert 0.0 <= d16 <= 1.0


def test_evaluate_empty_loader():
    _, cfg, params, state = _model(3)
    tp, ts = tree_from_numpy(params), tree_from_numpy(state)
    assert evaluate(tp, ts, [], cfg) == (0.0, 0.0)
    d, i = evaluate_per_class(tp, ts, [], cfg)
    assert d.tolist() == [0.0, 0.0, 0.0] and i.tolist() == [0.0, 0.0, 0.0]


@pytest.mark.parametrize("per_class", [False, True])
def test_evaluate_cli_matches_jax(tmp_path, capsys, per_class):
    jcfg, _, params, state = _model(1)
    ckpt = tmp_path / "m.npz"
    j_save_checkpoint(ckpt, params, state, [0, 255], {"config": jcfg._asdict()})
    make_synthetic_carvana(tmp_path / "data", n=5, h=32, w=40, seed=1)
    argv = ["-m", str(ckpt), "--data-dir", str(tmp_path / "data"), "-s", "0.5", "-b", "2"]
    argv += ["--per-class"] if per_class else []
    got = main(argv + ["--device", "cpu"])
    out = capsys.readouterr().out
    ref = j_main(argv)
    assert "Dice:" in out and ("class 0:" in out) == per_class
    np.testing.assert_allclose(got, ref, atol=ATOL)


def test_evaluate_cli_refuses_and_needs_a_gpu(tmp_path):
    with pytest.raises(SystemExit, match="is not ported"):
        main(["-m", "x.npz", "--data-parallel", "--device", "cpu"])
    # The families evaluate (past the refusals to the missing file); a .pth
    # is the U-Net's layout only, as in the JAX package.
    for arch in ("unetpp", "r2u"):
        with pytest.raises(SystemExit, match=r"\.pth import is reference-layout"):
            main(["-m", "x.pth", "--arch", arch, "--device", "cpu"])
        with pytest.raises(FileNotFoundError):
            main(["-m", "x.npz", "--arch", arch, "--device", "cpu"])
    # --tta is ported: it gets past the refusals to the missing file.
    with pytest.raises(FileNotFoundError):
        main(["-m", "x.npz", "--tta", "--tta-mode", "hflip", "--device", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(["-m", "x.npz"])
