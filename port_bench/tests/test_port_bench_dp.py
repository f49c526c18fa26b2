"""The four-rank cell's generator (``generators/train_step_dp.py``) on the
CPU: four gloo ranks (rank 0 this process, three children) at a small size
through ``run.execute``, with the cell's own limits. A sound run reads
correct with every rank's params bitwise rank 0's; the state returned
unchanged and half of rank 0's rows left out read incorrect."""

from __future__ import annotations

import pytest
import torch

from port_bench.manifest import Manifest
from port_bench.run import execute

from conftest import ROOT
from test_port_bench_correct import _broken_step

CELL = "unet_carvana.train_dp4"
SMALL = {"image": {"height": 64, "width": 96}, "model": {"base_channels": 8}}


@pytest.fixture(autouse=True)
def few_threads(monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "2")  # four processes share the CPU


def _run():
    return execute(Manifest(ROOT), CELL, seed=2**31 + 4321, seconds=0.5, trace=False,
                   device=torch.device("cpu"), t_start=0.0, config_overrides=SMALL,
                   traffic_overrides={"amp": False, "batch": 8, "pool_batches": 3})


def test_four_gloo_ranks_read_correct():
    out = _run()
    assert out["correct"] and out["failed"] == 0, out["checked"]
    assert out["diagnostics"]["ranks"] == 4 and out["attempted"] >= 1
    assert out["metrics"]["train_img_s"]["value"] > 0


@pytest.mark.parametrize("fault", ["unchanged", "half_batch"])
def test_fault_on_rank_0_reads_incorrect(monkeypatch, fault):
    import tpu_unet_torch.train as train

    monkeypatch.setattr(train, "make_train_step", _broken_step(fault))
    out = _run()
    assert not out["correct"], out["checked"]
    if fault == "unchanged":  # rank 0 alone kept its state: it differs from the others
        assert out["failed"] > 0


def test_a_rank_holds_only_its_rows(monkeypatch):
    """A rank's pool is its own rows, not views into the global batches,
    which would count the whole pool in the cell's peak memory."""
    gen = Manifest(ROOT).generator("train_step_dp")
    held, leave = [], gen._Rank.leave

    def spy(self):
        held.extend(t.untyped_storage().nbytes() / t.nbytes for t in self.images + self.masks)
        leave(self)

    monkeypatch.setattr(gen._Rank, "leave", spy)
    monkeypatch.setattr(Manifest, "generator", lambda self, kind: gen)
    assert _run()["correct"]
    assert held and set(held) == {1.0}
