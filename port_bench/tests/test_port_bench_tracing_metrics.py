"""The readers of the program's spans and counters (``program_spans.py``,
``metrics/*_ms.train.py``, ``metrics/host_syncs.train.py``) on a planted
read-out and planted idle gaps: each phase's device ms a step, each gap
given to its innermost span and a gap outside every span to none, the
counter a step, and None where the program recorded no ``train.step`` or
has no spans at all."""

from __future__ import annotations

import sys

import pytest

from port_bench import program_spans
from port_bench.manifest import Manifest

from conftest import ROOT

READERS = ("forward_ms.train", "loss_ms.train", "backward_ms.train", "update_ms.train",
           "dispatch_idle_ms.train", "host_syncs.train")
PHASES = (("train.forward", 30.0), ("train.loss", 1.0), ("train.backward", 50.0),
          ("train.clip", 2.0), ("train.optimizer", 5.0))


def _planted(steps: int = 2) -> dict:
    """``steps`` steps of 100 us of host time each, 1 ms apart: the step
    from t to t + 100, its five phases 10 us each from t + 10."""
    spans, ids = [], iter(range(1, 1000))
    for k in range(steps):
        t = 1_000_000 * k
        top = {"name": "train.step", "id": next(ids), "parent": None, "thread": 1,
               "start_ns": t, "end_ns": t + 100_000, "device_ms": 90.0}
        spans.append(top)
        for j, (name, ms) in enumerate(PHASES):
            spans.append({"name": name, "id": next(ids), "parent": top["id"], "thread": 1,
                          "start_ns": t + 10_000 * (j + 1), "end_ns": t + 10_000 * (j + 2),
                          "device_ms": ms})
    return {"spans": spans, "counters": {"train.host_syncs": 3}}


def _readings(gaps=()) -> dict:
    return {"kind": "train", "steps": 2, "window_s": 0.002,
            "trace": {"gaps": list(gaps), "busy_s": 0.0, "window_s": 0.002, "ops": []}}


@pytest.fixture
def plant(monkeypatch):
    import tpu_unet_torch.tracing as tracing

    def put(out):
        monkeypatch.setattr(tracing, "readout", lambda: out)

    return put


@pytest.fixture(scope="module")
def readers():
    man = Manifest(ROOT)
    return {name: man.metric_reader(name).read for name in READERS}


def test_phase_readers_give_device_ms_a_step(plant, readers):
    plant(_planted())
    r = _readings()
    assert readers["forward_ms.train"](r) == 30.0
    assert readers["loss_ms.train"](r) == 1.0
    assert readers["backward_ms.train"](r) == 50.0
    assert readers["update_ms.train"](r) == 7.0
    assert readers["host_syncs.train"](r) == 1.5


def test_a_gap_goes_to_its_innermost_span(plant, readers):
    plant(_planted())
    gaps = [(15_000, 2_000_000),  # in step 0's forward
            (5_000, 1_000_000),  # in step 0, before its forward
            (1_035_000, 500_000),  # in step 1's backward
            (1_070_000, 4_000_000),  # in step 1, after its optimizer
            (500_000, 9_000_000),  # between the steps: in no span
            (2_000_000, 8_000_000)]  # after the last step
    spans = _planted()["spans"]
    assert program_spans.idle_by_span(spans, gaps) == {
        "train.forward": 2_000_000, "train.step": 5_000_000, "train.backward": 500_000}
    assert readers["dispatch_idle_ms.train"](_readings(gaps)) == 3.75


def test_a_gap_at_a_span_end_is_outside_it(plant):
    spans = _planted(1)["spans"]
    assert program_spans.idle_by_span(spans, [(20_000, 7), (100_000, 5)]) == {
        "train.loss": 7}


@pytest.mark.parametrize("reader", READERS)
def test_no_step_span_reads_none(plant, readers, reader):
    plant({"spans": [s for s in _planted()["spans"] if s["name"] != "train.step"],
           "counters": {"train.host_syncs": 0}})
    assert readers[reader](_readings([(15_000, 10)])) is None
    plant({"spans": [], "counters": {}})
    assert readers[reader](_readings()) is None


@pytest.mark.parametrize("reader", READERS)
def test_a_program_without_spans_reads_none(monkeypatch, readers, reader):
    import tpu_unet_torch

    monkeypatch.delattr(tpu_unet_torch, "tracing", raising=False)
    monkeypatch.setitem(sys.modules, "tpu_unet_torch.tracing", None)  # the import fails
    assert readers[reader](_readings([(15_000, 10)])) is None


@pytest.mark.parametrize("reader", READERS)
def test_untraced_or_serve_reads_none(plant, readers, reader):
    plant(_planted())
    assert readers[reader]({**_readings(), "trace": None}) is None
    assert readers[reader]({**_readings(), "kind": "serve"}) is None


def test_phases_without_device_events_read_none(plant, readers):
    out = _planted()
    for s in out["spans"]:
        s["device_ms"] = None
    plant(out)
    assert readers["forward_ms.train"](_readings()) is None
    assert readers["host_syncs.train"](_readings()) == 1.5
