"""The recurrent blocks' span and counter (``models/r2u_unet.py``: a
``model.rrcnn`` span around each RRCNN block, ``model.recurrent_applications``
counting t + 1 a recurrent unit) in an r2u / r2attu train step on the CPU at
base 4 and 16x16 pixels: 9 spans a step, each a child of ``train.forward``,
2 · 9 · (t + 1) applications, nothing recorded without a profiler session,
and the step's outputs bitwise the same traced and untraced."""

import numpy as np
import pytest
import torch
from torch.profiler import profile

from tpu_unet_torch import tracing
from tpu_unet_torch.models.unet import UNetConfig, init_unet
from tpu_unet_torch.optim import rmsprop_init
from tpu_unet_torch.train import make_train_step


def _inputs(arch, t):
    cfg = UNetConfig(n_channels=3, n_classes=1, base_channels=4, arch=arch, recur_t=t)
    params, state = init_unet(cfg, np.random.default_rng(0))
    g = torch.Generator().manual_seed(0)
    images = torch.rand(2, 16, 16, 3, generator=g)
    masks = (torch.rand(2, 16, 16, generator=g) > 0.5).long()
    return cfg, (params, state, rmsprop_init(params), images, masks, 1e-3)


@pytest.mark.parametrize("arch,t", [("r2attu", 2), ("r2u", 2), ("r2attu", 1)])
def test_step_records_nine_blocks_and_their_applications(arch, t):
    cfg, args = _inputs(arch, t)
    step = make_train_step(cfg)
    off = step(*args)
    with profile():
        on = step(*args)
    leaves = torch.utils._pytree.tree_leaves
    assert all(torch.equal(a, b) for a, b in zip(leaves(off), leaves(on), strict=True))
    out = tracing.readout()
    forward = [s for s in out["spans"] if s["name"] == "train.forward"]
    blocks = [s for s in out["spans"] if s["name"] == "model.rrcnn"]
    assert len(forward) == 1 and len(blocks) == 9
    f = forward[0]
    for b in blocks:
        assert b["parent"] == f["id"]
        assert f["start_ns"] <= b["start_ns"] <= b["end_ns"] <= f["end_ns"]
    assert out["counters"]["model.recurrent_applications"] == 9 * 2 * (t + 1)


def test_untraced_step_records_nothing():
    cfg, args = _inputs("r2attu", 2)
    before = tracing.readout()
    make_train_step(cfg)(*args)
    assert tracing.readout() == before
