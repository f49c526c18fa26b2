"""Host spans and the device trace of a traced run (``--trace 1``).

``Spans`` records, in memory, the benchmark's own spans around each call
into a layer of the program (a step, a client's request, the warm-up), on
the host clock. ``DeviceTrace`` runs ``torch.profiler`` with CUDA activity
only over the measured window and reduces it to the device operations
(kernels, copies, fills), their union (busy time), the idle gaps between
them, and for each gap the span the host was in. Host and device clocks are
tied by an anchor: a short ``torch.cuda._sleep`` kernel launched on an idle
device at a known host time, the first operation of the trace.

The idle-share arithmetic is ``tpu_unet_torch/tools/profile_step.py``'s (1 −
device time / window), with the device time taken as the union of the
operations' intervals, so overlapping streams are not counted twice.
"""

from __future__ import annotations

import threading
import time


class Spans:
    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.done: list[tuple[str, int, int, int]] = []  # (name, thread, start ns, end ns)

    def span(self, name: str):
        return _Span(self, name) if self.enabled else _NULL

    def label_at(self, t_ns: int) -> str:
        """The innermost span open at host time ``t_ns`` (the latest to
        start), with the number of threads in a span of that name."""
        open_ = [s for s in self.done if s[2] <= t_ns < s[3]]
        if not open_:
            return "outside any span"
        name = max(open_, key=lambda s: s[2])[0]
        n = len({s[1] for s in open_ if s[0] == name})
        return name if n == 1 else f"{name} x{n}"


class _Span:
    def __init__(self, spans: Spans, name: str):
        self.spans, self.name = spans, name

    def __enter__(self):
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.spans.done.append((self.name, threading.get_ident(), self.t0,
                                time.perf_counter_ns()))
        return False


class _Null:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL = _Null()


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


class DeviceTrace:
    """``with DeviceTrace(enabled): window`` — on exit, ``summary`` holds
    the window's device operations; None when disabled."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.summary: dict | None = None

    def __enter__(self):
        if not self.enabled:
            return self
        import torch
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.__enter__()
        self.host0 = time.perf_counter_ns()
        torch.cuda._sleep(20000)  # the anchor, about 10 us
        return self

    def __exit__(self, *exc):
        if not self.enabled:
            return False
        import torch

        torch.cuda.synchronize()
        host1 = time.perf_counter_ns()
        self.prof.__exit__(*exc)
        if exc[0] is None:
            self.summary = self._reduce(host1)
        return False

    def _reduce(self, host1: int) -> dict:
        ops = []
        for ev in self.prof.profiler.kineto_results.events():
            if str(ev.device_type()).split(".")[-1] != "CUDA":
                continue
            start = ev.start_ns()
            ops.append((ev.name(), start, start + ev.duration_ns()))
        return summarize(ops, self.host0, host1)


def summarize(ops, host0: int, host1: int) -> dict:
    """The device operations [(name, start, end)] (ns, device clock) of a
    window [host0, host1] (ns, host clock): each operation's seconds inside
    the window, the busy seconds (their union), the window's seconds, and
    the idle gaps as (host ns at the gap's start, gap ns). The first
    operation whose name holds "spin" or "sleep" (else the first) is the
    anchor, launched at host0."""
    if not ops:
        raise RuntimeError("the profiler's trace holds no device operation")
    ops = sorted(ops, key=lambda o: o[1])
    anchor = next((o for o in ops if "spin" in o[0].lower() or "sleep" in o[0].lower()), ops[0])
    offset = anchor[1] - host0  # device clock minus host clock
    lo, hi = host0 + offset, host1 + offset
    clipped = [(n, max(s, lo), min(e, hi)) for n, s, e in ops if e > lo and s < hi]
    busy = _merge([(s, e) for _, s, e in clipped])
    gaps, prev = [], lo
    for s, e in busy:
        if s > prev:
            gaps.append((prev - offset, s - prev))
        prev = e
    if hi > prev:
        gaps.append((prev - offset, hi - prev))
    return {"ops": [(n, (e - s) / 1e9) for n, s, e in clipped],
            "busy_s": sum(e - s for s, e in busy) / 1e9,
            "window_s": (host1 - host0) / 1e9,
            "gaps": gaps}


def breakdown(summary: dict, spans: Spans, top: int = 10) -> dict:
    """The device operations that took the most time, and the longest idle
    gaps by the span the host was in, in seconds."""
    by_name: dict[str, float] = {}
    for n, s in summary["ops"]:
        by_name[n] = by_name.get(n, 0.0) + s
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    gaps = sorted(summary["gaps"], key=lambda g: -g[1])[:top]
    return {"device_ops": [[n[:160], s] for n, s in ops],
            "idle_gaps": [[spans.label_at(t), ns / 1e9] for t, ns in gaps]}
