"""The port's W&B surface (``tpu_unet_torch/train_logging.py``) against a
stub ``wandb`` module, and against the JAX package's on the same weights.

The stub records each ``log`` call, histograms as (size, values) and
images as their shapes, as the JAX package's tests
(``tests/test_train_e2e.py``, ``tests/test_accum.py``) do. JAX and the port
train base 8 at 48x64 from one set of weights (JAX's init, carried by
``checkpoint.from_jax_arrays``); their logs must have the same keys, call
by call, and the same scalars within the loop tests' fp32 tolerances
(``tests/test_torch_train_loop.py``: per-step loss 1e-3 relative, Dice and
IoU 1e-4 absolute, learning rates exact).
"""

import logging
import sys
import types

import numpy as np
import pytest
import torch

import jax

import tpu_unet.train as j_train
from tpu_unet.checkpoint import _flatten_with_paths
from tpu_unet.data import CarvanaDataset as JCarvana
from tpu_unet.models import UNetConfig as JConfig, init_unet as j_init_unet
from tpu_unet.train_logging import _HIST_CAP as J_HIST_CAP, _subsample_leaf as j_subsample
import tpu_unet_torch.train_logging as t_logging
from tpu_unet_torch.checkpoint import from_jax_arrays
from tpu_unet_torch.data import CarvanaDataset, make_synthetic_carvana
from tpu_unet_torch.models.unet import UNetConfig, init_unet
from tpu_unet_torch.train import train_model
from tpu_unet_torch.train_logging import _HIST_CAP, LossDrain, _subsample_leaf, init_wandb


@pytest.fixture
def wandb_logs(monkeypatch):
    logs = []
    fake = types.ModuleType("wandb")

    class FakeExperiment:
        def __init__(self):
            self.config = types.SimpleNamespace(update=lambda *a, **k: None)

        def log(self, d):
            logs.append(d)

    fake.init = lambda **k: FakeExperiment()
    fake.Histogram = lambda v: ("hist", int(np.asarray(v).size), np.asarray(v))
    fake.Image = lambda v: ("img", np.asarray(v).shape)
    monkeypatch.setitem(sys.modules, "wandb", fake)
    return logs


def _dataset(root, n, h=32, w=32):
    make_synthetic_carvana(root, n=n, h=h, w=w)
    return CarvanaDataset(root / "imgs", root / "masks", scale=1.0, num_workers=0)


def _hist_sizes(logs):
    return [v[1] for d in logs for v in d.values() if isinstance(v, tuple) and v[0] == "hist"]


@pytest.mark.parametrize("size", [1, 100, 2 * _HIST_CAP - 1, 2 * _HIST_CAP, 3 * _HIST_CAP + 5])
def test_subsample_leaf_is_jaxs_and_capped(size):
    assert _HIST_CAP == J_HIST_CAP
    leaf = np.random.default_rng(size).standard_normal((size,)).astype(np.float32)
    got = _subsample_leaf(torch.from_numpy(leaf).reshape(-1, 1)).numpy()
    np.testing.assert_array_equal(got, np.asarray(j_subsample(jax.numpy.asarray(leaf))))
    assert 1 <= got.size <= 2 * _HIST_CAP


def test_init_wandb_is_optional_and_offline(monkeypatch, caplog, wandb_logs):
    monkeypatch.delenv("WANDB_MODE", raising=False)
    assert init_wandb(False, {}) is None
    assert init_wandb(True, {"epochs": 1}) is not None
    assert t_logging.os.environ["WANDB_MODE"] == "offline"
    monkeypatch.setitem(sys.modules, "wandb", None)  # import wandb raises ImportError
    with caplog.at_level(logging.WARNING):
        assert init_wandb(True, {}) is None
    assert "wandb unavailable" in caplog.text


def test_loss_drain_logs_each_step_in_one_fetch(wandb_logs):
    history = {"train_loss": []}
    exp = sys.modules["wandb"].init()
    drain = LossDrain(history, exp)
    for s in range(1, 4):
        drain.append(torch.tensor(float(s) / 2), s, 1)
    assert not wandb_logs
    drain.drain()
    assert history["train_loss"] == [0.5, 1.0, 1.5]
    assert wandb_logs == [{"train loss": s / 2, "step": s, "epoch": 1} for s in range(1, 4)]
    drain.drain()  # nothing pending: nothing logged again
    assert len(wandb_logs) == 3


def test_wandb_step_logs_histograms_and_sample_triplet(tmp_path, wandb_logs):
    ds = _dataset(tmp_path / "d", 16)
    config = UNetConfig(3, 1, bilinear=True, base_channels=8)
    params, state = init_unet(config, np.random.default_rng(0))
    train_model(params, state, config, dataset=ds, epochs=1, batch_size=2, learning_rate=1e-3,
                val_percent=0.25, save_checkpoint_flag=False, use_wandb=True, seed=0)
    step_logs = [d for d in wandb_logs if "train loss" in d]
    assert len(step_logs) == 6  # 12 train images at batch 2
    assert [d["step"] for d in step_logs] == list(range(1, 7))
    val_logs = [d for d in wandb_logs if "validation Dice" in d]
    assert len(val_logs) == 6  # division step 12 // (5 * 2) = 1
    names = {k for k, _ in t_logging._keyed_leaves(params)}
    for v in val_logs:
        assert {k[len("Weights/"):] for k in v if k.startswith("Weights/")} == names
        assert {k[len("Gradients/"):] for k in v if k.startswith("Gradients/")} == names
        assert set(v["masks"]) == {"true", "pred"}
        assert v["images"] == ("img", (32, 32, 3))  # HWC, as the JAX package logs it
        assert v["masks"]["true"] == v["masks"]["pred"] == ("img", (32, 32))
        assert {"learning rate", "validation IoU", "step", "epoch"} <= set(v)
    sizes = _hist_sizes(val_logs)
    assert sizes and all(s <= 2 * _HIST_CAP for s in sizes)


@pytest.mark.parametrize("n,batch,val_percent,accum,val_logs,hist_rows", [
    # 24 images, 1/12 held out: 22 train at batch 4 is 5 full batches and one
    # of 2, and a validation after every step, the partial one's included.
    (24, 4, 1 / 12, 1, 6, 4),
    # accum_steps 2 at batch 2: the histogram pass runs one microbatch.
    (16, 2, 0.25, 2, 6, 1),
])
def test_wandb_histograms_take_the_last_full_batch(tmp_path, wandb_logs, monkeypatch, n, batch,
                                                   val_percent, accum, val_logs, hist_rows):
    rows = []
    real = t_logging.WandbValidationPanel._hist_sample

    def hist_sample(self, params, bn_state, images, masks):
        rows.append(images.shape[0])
        return real(self, params, bn_state, images, masks)

    monkeypatch.setattr(t_logging.WandbValidationPanel, "_hist_sample", hist_sample)
    ds = _dataset(tmp_path / "d", n)
    config = UNetConfig(3, 1, bilinear=True, base_channels=8)
    params, state = init_unet(config, np.random.default_rng(0))
    train_model(params, state, config, dataset=ds, epochs=1, batch_size=batch, learning_rate=1e-3,
                val_percent=val_percent, save_checkpoint_flag=False, use_wandb=True, seed=0,
                accum_steps=accum)
    got = [d for d in wandb_logs if "validation Dice" in d]
    assert len(got) == val_logs == len(rows)
    assert rows == [hist_rows] * val_logs
    assert all(any(k.startswith("Gradients/") for k in v) for v in got)


def test_wandb_logs_match_jax(tmp_path_factory):
    """Both packages' train_model with use_wandb from one set of weights:
    the same log calls with the same keys, and the same scalars."""
    root = tmp_path_factory.mktemp("wandb_parity")
    make_synthetic_carvana(root / "data", n=10, h=48, w=64, seed=0)
    jcfg = JConfig(3, 1, False, base_channels=8)
    params, state = jax.device_get(j_init_unet(jax.random.PRNGKey(0), jcfg))
    flat = {"params/" + k: v for k, v in _flatten_with_paths(params).items()}
    flat.update({"state/" + k: v for k, v in _flatten_with_paths(state).items()})
    run = dict(epochs=1, batch_size=2, learning_rate=1e-4, val_percent=0.2, val_per_epoch=2,
               save_checkpoint_flag=False, use_wandb=True, seed=0)
    logs = {}
    for pkg in ("torch", "jax"):
        mp = pytest.MonkeyPatch()
        got = []
        fake = types.ModuleType("wandb")
        fake.init = lambda **k: types.SimpleNamespace(
            config=types.SimpleNamespace(update=lambda *a, **k: None), log=got.append)
        fake.Histogram = lambda v: ("hist", int(np.asarray(v).size))
        fake.Image = lambda v: ("img", np.asarray(v).shape)
        mp.setitem(sys.modules, "wandb", fake)
        try:
            if pkg == "torch":
                ds = CarvanaDataset(root / "data" / "imgs", root / "data" / "masks", 1.0)
                train_model(*from_jax_arrays(flat), UNetConfig(3, 1, False, 8), dataset=ds,
                            checkpoint_dir=root / "t", **run)
            else:
                jds = JCarvana(root / "data" / "imgs", root / "data" / "masks", 1.0)
                j_train.train_model(params, state, jcfg, dataset=jds, checkpoint_dir=root / "j",
                                    **run)
        finally:
            mp.undo()
        logs[pkg] = got
    t, j = logs["torch"], logs["jax"]
    assert len(t) == len(j) == 6  # 4 steps, 2 validations
    for a, b in zip(t, j):
        assert a.keys() == b.keys()
        if "train loss" in b:
            np.testing.assert_allclose(a["train loss"], b["train loss"], rtol=1e-3)
        else:
            assert a["masks"].keys() == b["masks"].keys()
            assert a["images"] == b["images"] and a["masks"] == b["masks"]
            assert a["learning rate"] == b["learning rate"]
            np.testing.assert_allclose([a["validation Dice"], a["validation IoU"]],
                                       [b["validation Dice"], b["validation IoU"]], atol=1e-4)
            assert {k: a[k] for k in a if "/" in k} == {k: b[k] for k in b if "/" in k}
        assert (a["step"], a["epoch"]) == (b["step"], b["epoch"])
