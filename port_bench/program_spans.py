"""The program's own spans and counters in a traced train run, for the
``program_span`` and ``program_counter`` metrics.

The program (``tpu_unet_torch/tracing.py``) records them while a
``torch.profiler`` session is on, which in a run is the window's device
trace alone, and keeps them readable after it: ``readout()`` then gives the
window's spans. A span's ``device_ms`` is the device time between the CUDA
events it recorded at its start and end, its idle gaps included; its
``start_ns`` and ``end_ns`` are on the host clock of the device trace's
gaps (``devtrace.summarize``). A checkout whose program has no such module,
and a window in which the program recorded no ``train.step``, read None.
"""

from __future__ import annotations

STEP = "train.step"


def train_readout(r):
    """(read-out, number of ``train.step`` spans) of a traced train run,
    or None."""
    if r["kind"] != "train" or r["trace"] is None:
        return None
    try:
        from tpu_unet_torch import tracing
    except ImportError:  # a program without spans
        return None
    out = tracing.readout()
    steps = sum(1 for s in out["spans"] if s["name"] == STEP)
    return (out, steps) if steps else None


def device_ms_per_step(r, names) -> float | None:
    """Device milliseconds a step between the events of the spans named
    in ``names``; None without them or without CUDA events."""
    got = train_readout(r)
    if got is None:
        return None
    out, steps = got
    ms = [s["device_ms"] for s in out["spans"] if s["name"] in names]
    if not ms or any(m is None for m in ms):
        return None
    return sum(ms) / steps


def idle_by_span(spans, gaps) -> dict[str, int]:
    """Idle nanoseconds by span name: each gap (host ns at its start, ns)
    goes to the innermost span open at its start (the latest to start), a
    gap outside every span to none. The spans are one thread's, so they
    nest."""
    spans = sorted(spans, key=lambda s: (s["start_ns"], -s["end_ns"]))
    out: dict[str, int] = {}
    open_, i = [], 0
    for t, ns in sorted(gaps):
        while i < len(spans) and spans[i]["start_ns"] <= t:
            while open_ and open_[-1]["end_ns"] <= spans[i]["start_ns"]:
                open_.pop()
            open_.append(spans[i])
            i += 1
        while open_ and open_[-1]["end_ns"] <= t:
            open_.pop()
        if open_:
            name = open_[-1]["name"]
            out[name] = out.get(name, 0) + ns
    return out


def idle_ms_per_step(r, prefix: str = "train.") -> float | None:
    """Idle device milliseconds a step whose gap started inside a span
    named ``prefix``*."""
    got = train_readout(r)
    if got is None:
        return None
    out, steps = got
    spans = [s for s in out["spans"] if s["name"].startswith(prefix)]
    return sum(idle_by_span(spans, r["trace"]["gaps"]).values()) / 1e6 / steps


def counter_per_step(r, name: str) -> float | None:
    """The counter ``name`` over the number of steps; None when it was
    never counted."""
    got = train_readout(r)
    if got is None or name not in got[0]["counters"]:
        return None
    out, steps = got
    return out["counters"][name] / steps
