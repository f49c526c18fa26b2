"""The flagship train step's device time by kernel (``tools/profile_step.py``).

Runs the bench-shape train step (572x572, batch 16, bf16 unless ``--fp32``)
of the full-width U-Net under ``torch.profiler`` after warm-up steps, and
prints the step's wall time, the device's idle share, the kernels' time by
group (``PROFILE_GROUPS``) and the top kernels by device time. ``--parse
DIR`` reads the newest Chrome trace that ``train_cli --profile DIR`` wrote
there and prints the same rollup over its CUDA kernels.

Run (on a GPU; ``--parse`` anywhere):
    python -m tpu_unet_torch.tools.profile_step [--kernels cuda|torch] [--fp32] \
        [--batch 16] [--size 572] [--warmup 2] [--top 8]
    python -m tpu_unet_torch.tools.profile_step --parse DIR [--top 8]
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np
import torch

# Kernel-name groups of the step profile, first match wins. The three
# tensor-core kernels of a bf16 step: dx is tc_conv_kernel with the DzLoad
# loader (a template argument in the profiler's name), the fwd the others.
# An fp32 step's: dx is tc_conv_kernel with the DzLoadF32 loader and the fwd
# the other tc_conv_kernel with the Tf32x3Op operands, each after its
# weight split; dw is tc_dw_f32_kernel. "dzloadf32" comes before "dzload",
# which it contains, and before "tf32x3op", which its name also holds.
PROFILE_GROUPS = (
    ("tc_conv_kernel<DzLoadF32> (conv3x3_dx fp32, 3xTF32)", "dzloadf32"),
    ("tc_conv_kernel<DzLoad> (conv3x3_dx, tensor cores)", "dzload"),
    ("tc_conv_kernel<Tf32x3Op> (conv3x3_fwd fp32, 3xTF32)", "tf32x3op"),
    ("split_dx_weights_kernel (conv3x3_dx fp32)", "split_dx_weights_kernel"),
    ("split_weights_kernel (conv3x3_fwd fp32)", "split_weights_kernel"),
    ("tc_dw_f32_kernel (conv3x3_dw fp32, 3xTF32)", "tc_dw_f32_kernel"),
    ("tc_dw_kernel (conv3x3_dw, tensor cores)", "tc_dw_kernel"),
    ("tc_conv_kernel (conv3x3_fwd, tensor cores)", "tc_conv_kernel"),
    ("reduce_rows", "reduce_rows"),
    ("cuDNN / cutlass (ConvTranspose, 1x1)", ("cudnn", "cutlass", "sm90_", "sm80_", "xmma")),
    ("reductions", "reduce"),
    ("elementwise / copies", ("elementwise", "vectorized", "copy", "fill")),
)


def log(msg: str) -> None:
    print(msg, flush=True)


def group_of(kernel: str) -> str:
    """The ``PROFILE_GROUPS`` group of a kernel name, else "other"."""
    name = kernel.lower()
    return next((g for g, pats in PROFILE_GROUPS
                 if any(pt.lower() in name for pt in ((pats,) if isinstance(pats, str) else pats))),
                "other")


def _rollup(kernels: list[tuple[float, str, int]]) -> dict[str, float]:
    """ms by group of [(device us, kernel name, count)]."""
    groups: dict[str, float] = {}
    for us, name, _ in kernels:
        g = group_of(name)
        groups[g] = groups.get(g, 0.0) + us / 1e3
    return groups


def _groups_text(groups: dict[str, float], busy: float) -> str:
    return "; ".join(f"{g} {ms:.2f} ms ({ms / busy:.1%})"
                     for g, ms in sorted(groups.items(), key=lambda t: -t[1]))


def _top_text(kernels: list[tuple[float, str, int]], top: int) -> str:
    return "; ".join(f"{k[:60]} x{n} {us / 1e3:.2f} ms"
                     for us, k, n in sorted(kernels, reverse=True)[:top])


def profile_step(step, trees, images, masks, dt: str = "bf16", kernels: str = "cuda",
                 top: int = 8) -> dict:
    """Device time of one step by kernel group (``torch.profiler``, after the
    caller's warm-ups), the step's wall time between synchronisations and
    the device's idle share of it (1 - summed kernel time / wall; streams
    other than the default one are not used by the step)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(*trees, images, masks, 1e-4)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    device = []
    for ev in prof.key_averages():
        if str(getattr(ev, "device_type", "")).split(".")[-1] != "CUDA":
            continue
        us = getattr(ev, "device_time_total", None)
        if us is None:
            us = ev.cuda_time_total
        device.append((us, ev.key, ev.count))
    groups = _rollup(device)
    busy = sum(groups.values())
    out = {"wall_ms": wall_ms, "kernel_ms": busy, "idle_share": 1 - busy / wall_ms,
           "groups_ms": groups}
    log(f"profile, one {list(images.shape)} {dt} kernels={kernels} step: wall {wall_ms:.2f} ms, "
        f"kernels {busy:.2f} ms, device idle {out['idle_share']:.1%}; "
        + _groups_text(groups, busy))
    log("profile, top kernels: " + _top_text(device, top))
    return out


def parse_trace(trace_dir: str | Path, top: int = 8) -> dict:
    """The CUDA kernels of the newest Chrome trace (``*.json``) in
    ``trace_dir``: device ms by group and the top kernels. Raises
    ``SystemExit`` when there is no trace or it holds no kernel."""
    files = sorted(Path(trace_dir).glob("*.json"), key=lambda p: p.stat().st_mtime)
    if not files:
        raise SystemExit(f"no Chrome trace (*.json) under {trace_dir}")
    events = json.loads(files[-1].read_text())
    events = events.get("traceEvents", []) if isinstance(events, dict) else events
    per_kernel: dict[str, list] = {}
    for ev in events:
        if ev.get("cat") == "kernel" and ev.get("ph") == "X":
            acc = per_kernel.setdefault(ev["name"], [0.0, 0])
            acc[0] += float(ev.get("dur", 0.0))
            acc[1] += 1
    if not per_kernel:
        raise SystemExit(f"{files[-1]} holds no CUDA kernel (a trace taken without a GPU)")
    kernels = [(us, name, n) for name, (us, n) in per_kernel.items()]
    groups = _rollup(kernels)
    busy = sum(groups.values())
    log(f"trace {files[-1].name}: {sum(n for *_, n in kernels)} kernel launches, kernels "
        f"{busy:.2f} ms; " + _groups_text(groups, busy))
    log("trace, top kernels: " + _top_text(kernels, top))
    return {"file": str(files[-1]), "kernel_ms": busy, "groups_ms": groups,
            "kernels": {name: us / 1e3 for us, name, _ in kernels}}


def run(kernels: str = "cuda", amp: bool = True, batch: int = 16, size: int = 572,
        warmup: int = 2, top: int = 8) -> dict:
    """Profile one full-width U-Net train step at [batch, size, size] after
    ``warmup`` steps, on the GPU."""
    from tpu_unet_torch.data import synth_batch
    from tpu_unet_torch.models import UNetConfig, init_unet
    from tpu_unet_torch.optim import rmsprop_init
    from tpu_unet_torch.train import make_train_step

    if not torch.cuda.is_available():
        raise SystemExit("profile_step: no CUDA device (torch.cuda.is_available() is false)")
    config = UNetConfig(n_channels=3, n_classes=1, bilinear=False)
    params, state = init_unet(config, np.random.default_rng(0), device="cuda")
    trees = (params, state, rmsprop_init(params))
    imgs, msks = synth_batch(np.random.default_rng(2), batch, size, size)
    images, masks = torch.from_numpy(imgs).cuda(), torch.from_numpy(msks).cuda()
    step = make_train_step(config, amp=amp, kernels=None if kernels == "torch" else kernels)
    for _ in range(warmup):
        step(*trees, images, masks, 1e-4)
    log(f"device: {torch.cuda.get_device_name(0)}")
    return profile_step(step, trees, images, masks, "bf16" if amp else "fp32", kernels, top)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--kernels", choices=("cuda", "torch"), default="cuda")
    ap.add_argument("--fp32", action="store_true", help="fp32 step (default: bf16)")
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--size", type=int, default=572)
    ap.add_argument("--warmup", type=int, default=2)
    ap.add_argument("--top", type=int, default=8)
    ap.add_argument("--parse", default=None, metavar="DIR",
                    help="Parse the newest trace in this directory only (no run)")
    args = ap.parse_args(argv)
    if args.parse:
        return parse_trace(args.parse, args.top)
    return run(args.kernels, not args.fp32, args.batch, args.size, args.warmup, args.top)


if __name__ == "__main__":
    main()
