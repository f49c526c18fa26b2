"""Spans and counters inside the program, on only while a ``torch.profiler``
session is active.

    with span("train.forward"):
        ...
    count("train.host_syncs", n)
    readout()  # {"spans": [...], "counters": {...}} of the current session

Off (no profiler session: the flag ``torch.autograd.profiler.
_is_profiler_enabled``, read at each call), ``span()`` returns one shared
no-op object: it allocates nothing, enters no ``record_function`` and
records no CUDA event, so an untraced step pays one attribute read a span.
On, a span records its name, id, parent id, thread and host start and end
from ``time.perf_counter_ns()`` (the clock a benchmark's device trace ties
its idle gaps to), enters a ``torch.profiler.record_function`` of the same
name (so the session's Chrome trace shows it), and, once CUDA is in use,
records a timing ``torch.cuda.Event`` on the current stream at enter and at
exit. The events are resolved to device milliseconds by ``readout()``,
never on the step's path.

``host_syncs(name)`` counts, under ``name``, the synchronising CUDA calls
made inside it: ``torch.cuda.set_sync_debug_mode`` detections (mode "warn"
only while on, the warnings counted and not printed) and the caching
allocator's ``cudaMalloc`` and ``cudaFree`` calls (``num_device_alloc`` and
``num_device_free`` of ``torch.cuda.memory_stats_as_nested_dict()``; a free
waits for the device).

A profiler session is process-wide, and so is the record: a new session
(``torch.autograd.profiler``'s start hook) drops the previous session's
spans and counters; after the session they stay readable until the next.
"""

from __future__ import annotations

import itertools
import threading
import time
import warnings

import torch
import torch.autograd.profiler as _profiler
from torch.profiler import record_function

SYNC_WARNING = "called a synchronizing CUDA operation"


class _Record:
    """The current session's spans and counters."""

    def __init__(self):
        self.lock = threading.Lock()
        self.reset()

    def reset(self):
        with self.lock:
            self.spans: list[_Span] = []
            self.counters: dict[str, int] = {}
            self.ids = itertools.count(1)
            self.open = threading.local()  # each thread's stack of open span ids

    def stack(self) -> list[int]:
        s = getattr(self.open, "ids", None)
        if s is None:
            s = self.open.ids = []
        return s


_RECORD = _Record()


class _Null:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL = _Null()


class _Span:
    __slots__ = ("name", "id", "parent", "thread", "start_ns", "end_ns", "events", "rf",
                 "device_ms")

    def __init__(self, name: str):
        self.name = name
        self.events = None
        self.device_ms = None

    def __enter__(self):
        self.start_ns = time.perf_counter_ns()
        stack = _RECORD.stack()
        self.parent = stack[-1] if stack else None
        self.id = next(_RECORD.ids)
        self.thread = threading.get_ident()
        stack.append(self.id)
        self.rf = record_function(self.name)
        self.rf.__enter__()
        if torch.cuda.is_initialized():
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
            self.events[0].record()
        return self

    def __exit__(self, *exc):
        if self.events is not None:
            self.events[1].record()
        self.rf.__exit__(*exc)
        stack = _RECORD.stack()
        if stack and stack[-1] == self.id:
            stack.pop()
        self.end_ns = time.perf_counter_ns()
        with _RECORD.lock:
            _RECORD.spans.append(self)
        return False


def span(name: str):
    """A context manager: a span named ``name`` while a profiler session
    is active, else the shared no-op object."""
    return _Span(name) if _profiler._is_profiler_enabled else _NULL


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` while a profiler session is
    active."""
    if _profiler._is_profiler_enabled:
        with _RECORD.lock:
            _RECORD.counters[name] = _RECORD.counters.get(name, 0) + n


class _HostSyncs:
    __slots__ = ("name", "mode", "caught", "log", "allocs")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.allocs = None
        if torch.cuda.is_initialized():
            self.mode = torch.cuda.get_sync_debug_mode()
            self.caught = warnings.catch_warnings(record=True)
            self.log = self.caught.__enter__()
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            self.allocs = _device_allocs()
        return self

    def __exit__(self, *exc):
        n = 0
        if self.allocs is not None:
            n = _device_allocs() - self.allocs
            torch.cuda.set_sync_debug_mode(self.mode)
            self.caught.__exit__(*exc)
            for w in self.log:
                if SYNC_WARNING in str(w.message):
                    n += 1
                else:  # another warning of the step: pass it on
                    warnings.warn_explicit(w.message, w.category, w.filename, w.lineno)
        count(self.name, n)
        return False


def _device_allocs() -> int:
    stats = torch.cuda.memory_stats_as_nested_dict()  # memory_stats() flattens it: 5x the cost
    return stats.get("num_device_alloc", 0) + stats.get("num_device_free", 0)


def host_syncs(name: str):
    """A context manager that counts, under ``name``, the synchronising
    CUDA calls made inside it while a profiler session is active (0 on
    the CPU); else the shared no-op object."""
    return _HostSyncs(name) if _profiler._is_profiler_enabled else _NULL


def readout() -> dict:
    """The current (or last) session's record: ``spans``, in the order
    they opened, each a dict of ``name``, ``id``, ``parent`` (None at the
    top), ``thread``, ``start_ns``, ``end_ns`` (host ``perf_counter_ns``)
    and ``device_ms`` (between its CUDA events; None without CUDA), and
    ``counters``. Resolving the events waits for each span's end event."""
    with _RECORD.lock:
        spans = sorted(_RECORD.spans, key=lambda s: s.id)
        counters = dict(_RECORD.counters)
    out = []
    for s in spans:
        if s.events is not None:
            s.events[1].synchronize()
            s.device_ms = s.events[0].elapsed_time(s.events[1])
            s.events = None
        out.append({"name": s.name, "id": s.id, "parent": s.parent, "thread": s.thread,
                    "start_ns": s.start_ns, "end_ns": s.end_ns, "device_ms": s.device_ms})
    return {"spans": out, "counters": counters}


def _on_profiler_start(start=_profiler._run_on_profiler_start):
    _RECORD.reset()
    start()


# Every profiler context (torch.profiler.profile, torch.autograd.profiler's)
# calls this module-level hook as it starts a session: a new session starts
# an empty record. A second copy of this module chains onto the first.
_profiler._run_on_profiler_start = _on_profiler_start
