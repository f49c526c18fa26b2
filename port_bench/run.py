"""The benchmark of ``tpu_unet_torch``, the PyTorch and CUDA port, on one
process and the GPUs it is given. From the root of a checkout:

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell (an entry of ``BENCHMARK.json``'s ``workloads``) names a
configuration and a traffic mix; ``manifest.py`` finds their files. One run
makes the weights and data on the card from ``--seed``, warms up the cell's
own shapes (set-up, ``setup_s``), measures for ``--seconds``, checks what
the timed path produced against the plain reference (``reference.py``,
``check.py``), and prints one JSON line last on standard output:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics; with ``--trace 1`` its per-layer ones, read from the device trace
and the spans by ``metrics/<name>.py``), ``device``, with ``--trace 1``
``breakdown``, and last ``checked``: each number compared beside its
limit, which also end standard error.

It exits non-zero and prints no result when there is no CUDA device or
fewer than the cell asks for, when the program is missing, and when
``jax``, ``jaxlib``, ``flax`` or the JAX package ``tpu_unet`` is loaded once
the window has closed. Build and kernel caches live in fixed directories of
the checkout: the port's own ``tpu_unet_torch/_build/`` and
``.port_bench_cache/``.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()  # before the heavy imports: set-up starts here

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if __name__ == "__main__":  # as a script: import packages from the checkout's root
    sys.path[0] = str(ROOT)

CACHE = ROOT / ".port_bench_cache"
FORBIDDEN = ("jax", "jaxlib", "flax", "tpu_unet")
GIB = float(1 << 30)


def set_environment() -> None:
    """Caches inside the checkout, at fixed paths; the port's own cuDNN
    engine rule (``ops/conv.py``) from the start, so that the reference's
    library convs, which may run first, take it too."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"), ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(CACHE / sub)
    os.environ.setdefault("TORCH_CUDNN_USE_HEURISTIC_MODE_B", "1")


def forbidden_modules() -> list[str]:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


class Window:
    """The measured window: ``t0`` and ``seconds`` on the host clock, the
    device's peak memory over it (``peak``), and with tracing the device
    trace's summary (``trace``, else None)."""

    t0: float
    seconds: float
    peak: int
    trace: dict | None


class Context:
    """What a generator is given: the cell's configuration and traffic, the
    seed and window length, the device, the spans, and ``window()``."""

    def __init__(self, manifest, cell: str, *, seed: int, seconds: float, trace: bool, device,
                 config_overrides: dict | None = None, traffic_overrides: dict | None = None):
        from port_bench.devtrace import Spans

        self.cell = manifest.cell(cell)
        self.config = merged(manifest.config(self.cell["config"]), config_overrides)
        self.traffic = merged(manifest.traffic(self.cell["traffic"]), traffic_overrides)
        self.seed, self.seconds, self.trace, self.device = seed, seconds, trace, device
        self.spans = Spans(trace)
        self.win: Window | None = None
        self.memory_peak = 0

    def kernels(self, part: str):
        return self.config["kernels"][part]

    @contextlib.contextmanager
    def window(self):
        import torch

        from port_bench.devtrace import DeviceTrace

        cuda = self.device.type == "cuda"
        if cuda:
            torch.cuda.synchronize()
            self.memory_peak = torch.cuda.max_memory_allocated()
            torch.cuda.reset_peak_memory_stats()
        win = self.win = Window()
        with DeviceTrace(self.trace and cuda) as tracer:
            win.t0 = time.perf_counter()
            yield win
            if cuda:
                torch.cuda.synchronize()
            win.seconds = time.perf_counter() - win.t0
        win.trace = tracer.summary
        win.peak = torch.cuda.max_memory_allocated() if cuda else 0
        self.memory_peak = max(self.memory_peak, win.peak)

    def free(self):
        import torch

        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def merged(base: dict, overrides: dict | None) -> dict:
    """``base`` with ``overrides`` laid over it, nested dicts key by key
    (the tests' small sizes)."""
    out = dict(base)
    for k, v in (overrides or {}).items():
        out[k] = merged(out.get(k, {}), v) if isinstance(v, dict) else v
    return out


def dtype_of(traffic: dict) -> str:
    return "bf16" if traffic.get("amp") else "fp32"


def execute(manifest, cell: str, *, seed: int, seconds: float, trace: bool, device,
            t_start: float, config_overrides: dict | None = None,
            traffic_overrides: dict | None = None) -> dict:
    """One run of ``cell``; returns the result line as a dict."""
    import torch

    from port_bench import check
    from port_bench.devtrace import breakdown

    ctx = Context(manifest, cell, seed=seed, seconds=seconds, trace=trace, device=device,
                  config_overrides=config_overrides, traffic_overrides=traffic_overrides)
    out = manifest.generator(ctx.traffic["kind"]).run(ctx)
    win = ctx.win
    e2e_values = {"setup_s": win.t0 - t_start, "peak_mem_gib": win.peak / GIB,
                  **out["end_to_end"]}
    ok, table = check.judge(out["numbers"], manifest.limits(cell))
    ok = ok and out["failed"] == 0
    metrics = {}
    if not trace:
        for m in manifest.end_to_end(cell):
            metrics[m["name"]] = {"value": e2e_values[m["name"]], "unit": m["unit"]}
    else:
        readings = {**out["readings"], "config": ctx.config, "traffic": ctx.traffic,
                    "dtype": dtype_of(ctx.traffic), "trace": win.trace}
        for m in manifest.per_layer(cell):
            v = manifest.metric_reader(m["name"]).read(readings)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    if device.type == "cuda":
        dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
               "count": ctx.cell["chips"], "memory_peak_bytes": ctx.memory_peak}
    else:
        dev = {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    result = {"correct": bool(ok), "attempted": out["attempted"], "failed": out["failed"],
              "metrics": metrics, "device": dev, "diagnostics": out.get("diagnostics", {})}
    if win.trace is not None:
        dev["busy_s"], dev["window_s"] = win.trace["busy_s"], win.trace["window_s"]
        result["breakdown"] = breakdown(win.trace, ctx.spans)
        result["diagnostics"]["kernel_classes"] = kernel_classes(win.trace["ops"])
    # A reading that is not finite (a NaN loss) fails its limit; JSON has
    # no number for it, so it is given as a string.
    result["checked"] = {k: {n: (x if math.isfinite(x) else str(x)) for n, x in v.items()}
                         for k, v in table.items()}
    return result


def kernel_classes(ops, top: int = 15) -> dict:
    """The operations that took most device time, by the yardstick's class,
    so that a reader can see what counts as conv and what as glue."""
    from port_bench.yardstick import is_conv_kernel

    by: dict[str, float] = {}
    for n, s in ops:
        by[n] = by.get(n, 0.0) + s
    out = {"conv": [], "glue": []}
    for n, s in sorted(by.items(), key=lambda kv: -kv[1]):
        cls = out["conv" if is_conv_kernel(n) else "glue"]
        if len(cls) < top:
            cls.append([n[:160], s])
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Benchmark of tpu_unet_torch on CUDA GPUs")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    set_environment()

    from port_bench.manifest import Manifest

    manifest = Manifest(ROOT)
    cell = manifest.cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"port_bench: {args.workload} needs {cell['chips']} CUDA device(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
              f"device_count() {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result = execute(manifest, args.workload, seed=args.seed, seconds=args.seconds,
                     trace=bool(args.trace), device=torch.device("cuda", 0), t_start=T_START)
    loaded = forbidden_modules()
    if loaded:
        print(f"port_bench: the run loaded {loaded}: the port must not import JAX or the "
              "JAX package", file=sys.stderr)
        return 3
    for name, v in result["checked"].items():
        print(f"checked {name} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
