"""``correct`` comes out false when the timed path is broken underneath:
the harness's look for a chip is skipped and the rest of a run is driven on
the CPU at a small size, once for each fault a cell can have. A sound run
reads correct, and the control (the reference in a lower precision) fails
a limit."""

from __future__ import annotations

import pytest
import torch

from port_bench.calibrate import readings
from port_bench.manifest import Manifest
from port_bench.run import execute

from conftest import ROOT, SERVE_TRAFFIC, TINY_CONFIG, add_serve_cell

TRAIN_CELLS = ("unet_carvana.train_bf16", "attention_carvana.train_bf16",
               "unet_carvana.train_fp32")
SEED = 2**31 + 1234


def _run(man, cell, traffic=None):
    return execute(man, cell, seed=SEED, seconds=0.3, trace=False, device=torch.device("cpu"),
                   t_start=0.0, config_overrides=TINY_CONFIG,
                   traffic_overrides={"amp": False, **(traffic or {})})


def _broken_step(fault):
    import tpu_unet_torch.train as train

    real = train.make_train_step

    def make(*args, **kwargs):
        step = real(*args, **kwargs)

        def unchanged(params, bn, opt, images, masks, lr):
            out = step(params, bn, opt, images, masks, lr)
            return (params, bn, opt) + tuple(out[3:])

        def half_batch(params, bn, opt, images, masks, lr):
            n = images.shape[0] // 2
            return step(params, bn, opt, images[:n], masks[:n], lr)

        return {"unchanged": unchanged, "half_batch": half_batch}[fault]

    return make


def test_sound_train_run_reads_correct():
    out = _run(Manifest(ROOT), "unet_carvana.train_bf16")
    assert out["correct"], out["checked"]


@pytest.mark.parametrize("cell", TRAIN_CELLS)
@pytest.mark.parametrize("fault", ["unchanged", "half_batch"])
def test_train_fault_reads_incorrect(monkeypatch, cell, fault):
    import tpu_unet_torch.train as train

    monkeypatch.setattr(train, "make_train_step", _broken_step(fault))
    out = _run(Manifest(ROOT), cell)
    assert not out["correct"], out["checked"]


def _altered(real):
    def logits_to_mask(logits, n_classes, threshold):
        m = real(logits, n_classes, threshold)
        m[:16, :16] = ~m[:16, :16]  # an answer altered where it is produced
        return m

    return logits_to_mask


@pytest.mark.parametrize("fault", [False, True])
def test_serve_mask_altered_reads_incorrect(monkeypatch, bench_root, fault):
    import tpu_unet_torch.serve as serve

    add_serve_cell(bench_root)
    if fault:
        monkeypatch.setattr(serve, "logits_to_mask", _altered(serve.logits_to_mask))
    out = execute(bench_root.manifest(), "unet_carvana.serve_c16", seed=SEED, seconds=0.5,
                  trace=False, device=torch.device("cpu"), t_start=0.0,
                  config_overrides=TINY_CONFIG, traffic_overrides=SERVE_TRAFFIC)
    assert out["attempted"] > 0 and out["failed"] == 0
    assert out["correct"] is not fault, out["checked"]


@pytest.mark.parametrize("cell", TRAIN_CELLS[:2])
def test_control_fails_a_limit(cell):
    """The fp8 control of the bf16 cells; the fp32 cells' TF32 control runs
    only on the card (test_port_bench_card.py)."""
    man = Manifest(ROOT)
    limits = man.limits(cell)
    ctl = readings(man, cell, SEED, torch.device("cpu"), TINY_CONFIG)["control"]
    assert any(ctl[k] > limits[k] for k in limits), (ctl, limits)
