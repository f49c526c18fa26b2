"""The family cell (``generators/train_step_family.py``, ``families/r2attu.py``)
driven on the CPU at a small size through ``run.execute``: a sound run reads
correct, the faults a train cell can have (the state returned unchanged,
half of each batch left out) and the fp8 control read incorrect; and the
family's readers on planted readings.

The cell's own limits hold at this size too: in fp32 at base 8 the
program's first-step statistics (``bn1_gap``) read about 3e-7 of the
reference's, and half a batch 1.7e-2 or more; the first gradient's
direction (``grad1_dir_gap``) 8e-3, half a batch 0.78, the state left
unchanged 1; its median and worst change 1.8e-2 and 0.16 at most, under
the limits of 0.25 and 0.6 that the state left unchanged (1) fails.
"""

from __future__ import annotations

import pytest
import torch

from port_bench import families
from port_bench.families.calibrate_family import readings
from port_bench.manifest import Manifest
from port_bench.run import execute

from conftest import ROOT, TINY_CONFIG
from test_port_bench_correct import _broken_step

CELL = "r2attu_carvana.train_bf16_family"
SEED = 2**31 + 1234


def _run(man, trace=False):
    return execute(man, CELL, seed=SEED, seconds=0.3, trace=trace, device=torch.device("cpu"),
                   t_start=0.0, config_overrides=TINY_CONFIG, traffic_overrides={"amp": False})


@pytest.mark.parametrize("trace", [False, True])
def test_sound_run_reads_correct(trace):
    out = _run(Manifest(ROOT), trace)
    assert out["correct"] and out["failed"] == 0 and out["attempted"] >= 1, out["checked"]
    if trace:  # no device trace on the CPU: only the host-clock reader reads
        assert set(out["metrics"]) == {"mfu.train_family"}


@pytest.mark.parametrize("fault", ["unchanged", "half_batch"])
def test_fault_reads_incorrect(monkeypatch, fault):
    import tpu_unet_torch.train as train

    monkeypatch.setattr(train, "make_train_step", _broken_step(fault))
    out = _run(Manifest(ROOT))
    assert not out["correct"], out["checked"]


def test_control_fails_a_limit():
    limits = Manifest(ROOT).limits(CELL)
    ctl = readings(Manifest(ROOT), CELL, SEED, torch.device("cpu"), TINY_CONFIG)["control"]
    assert set(limits) <= set(ctl)
    assert any(ctl[k] > limits[k] for k in limits), (ctl, limits)


def test_witnesses_read_beside_the_program():
    """With ``amp`` off the cell's precision is fp32, so the program and its
    fp32 witness are one reading; the reference one ulp off reads its first
    forward alike (its loss and statistics) and its gradients close."""
    out = readings(Manifest(ROOT), CELL, SEED, torch.device("cpu"), TINY_CONFIG,
                   {"amp": False}, controls=False, program=True, witnesses=True)
    assert set(out) == {"program", "program_fp32", "ulp"}
    assert out["program"] == out["program_fp32"]
    ulp = out["ulp"]
    assert ulp["loss1_gap"] < 1e-6 and ulp["bn1_gap"] < 1e-6, ulp
    assert 0 < ulp["grad1_dir_gap"] < 0.05, ulp  # 3.6e-3 at this size


def test_grad_direction_gap_leaves_out_the_scale():
    g = torch.Generator().manual_seed(7)
    sq = {"a": torch.rand(64, generator=g), "b": torch.rand(3, 3, generator=g),
          "c": torch.rand(5, generator=g)}
    bn = {"x/mean": torch.ones(2)}
    ref = {"loss": [1.0], "bn1": bn, "sq1": sq}
    init = {"x/mean": torch.zeros(2)}
    scaled = {"loss": [1.0], "bn1": bn, "sq1": {k: 9.0 * v for k, v in sq.items()}}
    assert families.first_step_numbers(scaled, ref, init)["grad1_dir_gap"] < 1e-7
    silent = {**scaled, "sq1": {k: torch.zeros_like(v) for k, v in sq.items()}}
    assert families.first_step_numbers(silent, ref, init)["grad1_dir_gap"] == pytest.approx(1.0)


R2 = {"arch": "r2attu", "n_channels": 3, "n_classes": 1, "bilinear": False,
      "base_channels": 64, "recur_t": 2, "recur_bn": "per_step"}


def _readings(**kw) -> dict:
    r = {"kind": "train", "config": {"model": R2}, "height": 640, "width": 959, "images": 12,
         "steps": 3, "window_s": 1.0, "dtype": "bf16", "trace": None}
    return {**r, **kw}


@pytest.fixture(scope="module")
def read():
    man = Manifest(ROOT)
    return lambda name, r: man.metric_reader(name).read(r)


def test_mfu_counts_every_recurrent_application(read):
    fam = families.module("r2attu")
    want = 100.0 * fam.train_flops(R2, 640, 959) * 12 / 1e0 / 989e12
    assert read("mfu.train_family", _readings()) == pytest.approx(want)
    assert want == pytest.approx(100 * 7.6305e12 * 12 / 989e12, rel=1e-4)
    assert read("mfu.train_family", _readings(config={"model": {**R2, "arch": "unet"}})) is None
    assert read("mfu.train_family", {"kind": "serve"}) is None


def test_conv_roofline_over_conv_device_time(read):
    fam = families.module("r2attu")
    trace = {"ops": [("cudnn_conv_fwd", 0.4), ("elementwise_kernel", 5.0), ("sm90_gemm", 0.1)],
             "gaps": [], "busy_s": 5.5, "window_s": 6.0}
    want = 100.0 * fam.conv_bound_s(R2, 640, 959, "bf16", train=True) * 12 / 0.5
    assert read("conv_roofline.train_family", _readings(trace=trace)) == pytest.approx(want)
    assert read("conv_roofline.train_family", _readings()) is None  # untraced


def _planted(steps: int = 2, blocks: int = 9) -> dict:
    spans, ids = [], iter(range(1, 10_000))
    for k in range(steps):
        t = 1_000_000 * k
        top = {"name": "train.step", "id": next(ids), "parent": None, "thread": 1,
               "start_ns": t, "end_ns": t + 100_000, "device_ms": 300.0}
        fwd = {"name": "train.forward", "id": next(ids), "parent": top["id"], "thread": 1,
               "start_ns": t + 1_000, "end_ns": t + 50_000, "device_ms": 100.0}
        spans += [top, fwd]
        spans += [{"name": "model.rrcnn", "id": next(ids), "parent": fwd["id"], "thread": 1,
                   "start_ns": t + 2_000 + 1_000 * j, "end_ns": t + 2_500 + 1_000 * j,
                   "device_ms": 10.0} for j in range(blocks)]
        spans.append({"name": "train.grad_sync", "id": next(ids), "parent": top["id"],
                      "thread": 1, "start_ns": t + 60_000, "end_ns": t + 61_000,
                      "device_ms": 1.5})
    return {"spans": spans, "counters": {"model.recurrent_applications": 54 * steps}}


def test_span_and_counter_readers(monkeypatch, read):
    import tpu_unet_torch.tracing as tracing

    r = _readings(trace={"ops": [], "gaps": [], "busy_s": 0.0, "window_s": 1.0})
    monkeypatch.setattr(tracing, "readout", lambda: _planted())
    assert read("rrcnn_fwd_ms.train", r) == 90.0
    assert read("recurrent_applications.train", r) == 54.0
    assert read("grad_sync_ms.train", r) == 1.5
    # a program without the span and the counter (the parent of the change
    # that adds them) reads None, as does an untraced run
    old = [s for s in _planted()["spans"] if not s["name"].startswith(("model.", "train.g"))]
    monkeypatch.setattr(tracing, "readout", lambda: {"spans": old, "counters": {}})
    assert read("rrcnn_fwd_ms.train", r) is None
    assert read("recurrent_applications.train", r) is None
    assert read("grad_sync_ms.train", r) is None
    assert read("rrcnn_fwd_ms.train", _readings()) is None
