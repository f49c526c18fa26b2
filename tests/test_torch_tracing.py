"""The port's spans and counters (``tpu_unet_torch/tracing.py``) in its
train step, on the CPU at base 4 and 16x16 pixels: off without a profiler
session (the shared no-op object, no ``record_function``, nothing
recorded), on under one (``train.step`` and its children in order, with
parent links and times inside the caller's clock readings), a new session
starting empty, and the step's outputs bitwise the same either way."""

import time

import numpy as np
import pytest
import torch
from torch.profiler import profile

from tpu_unet_torch import tracing
from tpu_unet_torch.models.unet import UNetConfig, init_unet
from tpu_unet_torch.optim import rmsprop_init
from tpu_unet_torch.train import make_train_step

CHILDREN = ["train.forward", "train.loss", "train.backward", "train.clip", "train.optimizer"]


def _inputs(arch="unet"):
    cfg = UNetConfig(n_channels=3, n_classes=1, base_channels=4, arch=arch)
    params, state = init_unet(cfg, np.random.default_rng(0))
    g = torch.Generator().manual_seed(0)
    images = torch.rand(2, 16, 16, 3, generator=g)
    masks = (torch.rand(2, 16, 16, generator=g) > 0.5).long()
    return cfg, (params, state, rmsprop_init(params), images, masks, 1e-3)


def _leaves(out):
    return torch.utils._pytree.tree_leaves(out)


class _Entered:
    """Stands in for ``record_function``: records each span it enters."""

    def __init__(self):
        self.names = []

    def __call__(self, name):
        entered = self

        class _RF:
            def __enter__(self):
                entered.names.append(name)

            def __exit__(self, *exc):
                return False

        return _RF()


def test_off_is_the_shared_no_op_and_records_nothing(monkeypatch):
    entered = _Entered()
    monkeypatch.setattr(tracing, "record_function", entered)
    cfg, args = _inputs()
    before = tracing.readout()
    assert tracing.span("train.step") is tracing.span("x") is tracing.host_syncs("y")
    make_train_step(cfg)(*args)
    tracing.count("train.host_syncs")
    assert entered.names == [] and tracing.readout() == before
    with profile():  # the positive control: on, the same recorder sees the spans
        make_train_step(cfg)(*args)
    assert entered.names == ["train.step"] + CHILDREN


@pytest.mark.parametrize("arch", ["unet", "attention"])
def test_step_records_its_phases_in_order(arch):
    cfg, args = _inputs(arch)
    step = make_train_step(cfg)
    off = step(*args)
    with profile():
        t0 = time.perf_counter_ns()
        on = step(*args)
        t1 = time.perf_counter_ns()
    assert all(torch.equal(a, b) for a, b in zip(_leaves(off), _leaves(on), strict=True))
    out = tracing.readout()
    spans = out["spans"]
    assert [s["name"] for s in spans] == ["train.step"] + CHILDREN
    top = spans[0]
    assert top["parent"] is None and all(s["parent"] == top["id"] for s in spans[1:])
    assert t0 <= top["start_ns"] and top["end_ns"] <= t1
    for a, b in zip(spans[1:], spans[2:]):
        assert top["start_ns"] <= a["start_ns"] <= a["end_ns"] <= b["start_ns"]
    assert spans[-1]["end_ns"] <= top["end_ns"]
    assert all(s["device_ms"] is None for s in spans)  # no CUDA events on the CPU
    assert out["counters"] == {"train.host_syncs": 0}


def test_accumulation_records_a_triple_a_microbatch():
    cfg, args = _inputs()
    with profile():
        make_train_step(cfg, accum_steps=2)(*args)
    triple = ["train.forward", "train.loss", "train.backward"]
    names = [s["name"] for s in tracing.readout()["spans"]]
    assert names == ["train.step"] + triple * 2 + ["train.clip", "train.optimizer"]


def test_a_new_session_starts_empty():
    cfg, args = _inputs()
    step = make_train_step(cfg)
    with profile():
        step(*args)
        tracing.count("extra", 2)
    assert tracing.readout()["counters"] == {"train.host_syncs": 0, "extra": 2}
    with profile():
        assert tracing.readout() == {"spans": [], "counters": {}}
        t0 = time.perf_counter_ns()
        step(*args)
    spans = tracing.readout()["spans"]
    assert [s["name"] for s in spans].count("train.step") == 1
    assert all(s["start_ns"] >= t0 for s in spans)
