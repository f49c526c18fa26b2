"""What cuDNN's workspace costs the port's library convs on the card, and
what bounds it (``tools/conv_workspace.py``).

For the fp32 convs that took the largest workspaces on the grid ranks (TF32
off, as ``ops.conv.full_fp32`` sets it), each way of running the conv is
measured on one call forward (``aten.convolution``) and one backward
(``aten.convolution_backward``, input and weight gradients): its transient
(the caching allocator's peak above what was allocated before the call, in
GiB), its time (CUDA events, median of ``REPS`` after a warm-up), the
kernels the profiler saw, and whether its outputs are bitwise those of
``default`` (else their largest absolute difference). The ways:

* ``default``: ``F.conv2d`` on the NHWC view that ``ops.conv`` hands it,
  without ``ops.conv``'s engine rule (torch's instant heuristic);
* ``nchw``: a contiguous NCHW copy;
* ``deterministic``: ``default`` under ``utils.determinism.Deterministic``;
* ``split_n``: one call an image; ``split_cout``: Cout in blocks of 32;
* ``rule``: ``ops.conv.conv2d`` as it stands (``cudnn_engine_rule``);
* environments (``ENVS``), each in a fresh process: ``wscap=M``, cuDNN's
  ``CUDNN_CONV_WSCAP_DBG`` at M MiB; ``wscap_late=M``, set after a first
  conv ran; ``heur_b``, torch's heuristic mode B; ``v7``, torch's cuDNN v7
  API, alone and with the cap.

``--steps`` times the plain (``kernels=None``) train steps under each
environment named, or under the rule (``rule``), each in a fresh process
and in turns (A, B, B, A): the 572x572 batch-16 U-Net step in bf16 and fp32
and the four families' fp32 steps at [4,640,959], CUDA events, median of
``STEP_REPS`` after two warm-ups, peak memory and the conv with the largest
transient. Outside ``rule``, ``ops.conv``'s rule is switched off.

Run (on a GPU):
    python -m tpu_unet_torch.tools.conv_workspace [--variants default rule heur_b ...] \
        [--steps env_default rule] [--out result.json]
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

# (name, x NCHW shape, Cout): up2's conv1 with Cout sharded 256 -> 128 on a
# 1x1x2 grid (U-Net, fp32), R2U-Net's on the same grid, and the bilinear
# U-Net's on a 1x2 spatial band.
SHAPES = (("unet up2.conv1 T=2", (4, 512, 160, 239), 128),
          ("r2u up2 T=2", (2, 256, 160, 239), 128),
          ("bilinear up2 S=2", (2, 256, 82, 239), 128))
REPS = 3
IN_PROCESS = ("default", "nchw", "deterministic", "split_n", "split_cout", "rule")
# The environments measured, each in a fresh process: cuDNN's workspace cap
# (MiB), torch's heuristic mode B, torch's cuDNN v7 API with and without it.
ENVS = {"env_default": {},
        "wscap=1024": {"CUDNN_CONV_WSCAP_DBG": "1024"},
        "wscap=256": {"CUDNN_CONV_WSCAP_DBG": "256"},
        "heur_b": {"TORCH_CUDNN_USE_HEURISTIC_MODE_B": "1"},
        "v7": {"TORCH_CUDNN_V8_API_DISABLED": "1"},
        "v7_wscap=1024": {"TORCH_CUDNN_V8_API_DISABLED": "1", "CUDNN_CONV_WSCAP_DBG": "1024"}}
STEP_REPS = 3
FAMILIES = ("attention", "unetpp", "r2u", "r2attu")


def _transient(fn):
    """(output, GiB above the memory allocated before ``fn``)."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    return out, (torch.cuda.max_memory_allocated() - base) / 2**30


def _ms(fn) -> float:
    fn()
    times = []
    for _ in range(REPS):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _kernels(fn, top: int = 3) -> list[str]:
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.device_time_total > 0]
    events.sort(key=lambda e: -e.device_time_total)
    return [f"{e.key[:90]} {e.device_time_total / 1e3:.3f} ms" for e in events[:top]]


def _ways(variant: str):
    """(forward, backward) of the variant: x NCHW (a view of NHWC), w OIHW,
    gy NCHW -> y; gy -> (gx, gw)."""
    import torch.nn.functional as F

    from tpu_unet_torch.ops import conv as C

    def fwd(x, w):
        return F.conv2d(x, w, padding=1)

    def bwd(gy, x, w):
        return torch.ops.aten.convolution_backward(
            gy, x, w, None, [1, 1], [1, 1], [1, 1], False, [0, 0], 1, [True, True, False])[:2]

    if variant == "nchw":
        return (lambda x, w: fwd(x.contiguous(), w),
                lambda gy, x, w: bwd(gy.contiguous(), x.contiguous(), w))
    if variant == "split_n":
        return (lambda x, w: torch.cat([fwd(x[i:i + 1], w) for i in range(x.shape[0])]),
                lambda gy, x, w: [torch.cat(t) if k == 0 else sum(t) for k, t in enumerate(
                    zip(*[bwd(gy[i:i + 1], x[i:i + 1], w) for i in range(x.shape[0])]))])
    if variant == "split_cout":
        b = 32
        return (lambda x, w: torch.cat([fwd(x, w[o:o + b]) for o in range(0, w.shape[0], b)], 1),
                lambda gy, x, w: [sum(t) if k == 0 else torch.cat(t) for k, t in enumerate(
                    zip(*[bwd(gy[:, o:o + b], x, w[o:o + b]) for o in range(0, w.shape[0], b)]))])
    if variant == "env":  # the default way, under the process's environment
        return fwd, bwd
    if variant == "rule":
        return (lambda x, w: C.conv2d(x.permute(0, 2, 3, 1), w.permute(2, 3, 1, 0),
                                      padding=1).permute(0, 3, 1, 2),
                lambda gy, x, w: _rule_bwd(gy, x, w))
    return fwd, bwd


def _rule_bwd(gy, x, w):
    from tpu_unet_torch.ops import conv as C

    xh = x.permute(0, 2, 3, 1).detach().requires_grad_(True)
    wh = w.permute(2, 3, 1, 0).detach().requires_grad_(True)
    y = C.conv2d(xh, wh, padding=1)
    gx, gw = torch.autograd.grad(y, (xh, wh), gy.permute(0, 2, 3, 1))
    return gx.permute(0, 3, 1, 2), gw.permute(3, 2, 0, 1)


def _inputs(shape, cout):
    n, cin, h, w = shape
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn((n, h, w, cin), generator=g, device="cuda").permute(0, 3, 1, 2)
    wt = torch.randn((cout, cin, 3, 3), generator=g, device="cuda") / (9 * cin) ** 0.5
    gy = torch.randn((n, h, w, cout), generator=g, device="cuda").permute(0, 3, 1, 2)
    return x, wt, gy


def _compare(got, ref_path: Path) -> dict:
    if not ref_path.exists():
        return {}
    ref = torch.load(ref_path)
    return {"bitwise": all(torch.equal(a, b.to(a.device)) for a, b in zip(got, ref)),
            "max_abs_diff": max((a - b.to(a.device)).abs().max().item()
                                for a, b in zip(got, ref))}


def measure(variant: str, ref_dir: Path, late_mib: int | None = None) -> dict:
    """Every shape of ``SHAPES`` the variant's way, in this process."""
    from tpu_unet_torch.ops import full_fp32
    from tpu_unet_torch.utils.determinism import Deterministic

    full_fp32()
    if late_mib is not None:
        x, w, _ = _inputs((1, 16, 32, 32), 16)
        torch.nn.functional.conv2d(x, w, padding=1)
        torch.cuda.synchronize()
        os.environ["CUDNN_CONV_WSCAP_DBG"] = str(late_mib)
    fwd, bwd = _ways(variant)
    out = {}
    for name, shape, cout in SHAPES:
        x, w, gy = _inputs(shape, cout)
        with Deterministic() if variant == "deterministic" else contextlib.nullcontext():
            y, t_fwd = _transient(lambda: fwd(x, w))
            (gx, gw), t_bwd = _transient(lambda: bwd(gy, x, w))
            rec = {"fwd_gib": t_fwd, "bwd_gib": t_bwd,
                   "fwd_ms": _ms(lambda: fwd(x, w)), "bwd_ms": _ms(lambda: bwd(gy, x, w)),
                   "fwd_kernels": _kernels(lambda: fwd(x, w)),
                   "bwd_kernels": _kernels(lambda: bwd(gy, x, w))}
        ref = ref_dir / f"{name.replace(' ', '_')}.pt"
        got = [t.contiguous() for t in (y, gx, gw)]
        if variant == "default" and late_mib is None:
            torch.save([t.cpu() for t in got], ref)
        else:
            rec.update(_compare(got, ref))
        out[name] = rec
        del x, w, gy, y, gx, gw, got
        torch.cuda.empty_cache()
    return out


def _step_trees(arch: str):
    from tpu_unet_torch.data import synth_batch
    from tpu_unet_torch.models import UNetConfig, init_unet
    from tpu_unet_torch.optim import rmsprop_init

    if arch == "unet":
        config, batch = UNetConfig(n_channels=3, n_classes=1, base_channels=64), (16, 572, 572)
    else:
        config = UNetConfig(n_channels=3, n_classes=1, base_channels=64, arch=arch,
                            deep_supervision=arch == "unetpp", recur_t=2, recur_bn="per_step")
        batch = (4, 640, 959)
    params, state = init_unet(config, np.random.default_rng(0), device="cuda")
    imgs, msks = synth_batch(np.random.default_rng(2), *batch)
    return config, (params, state, rmsprop_init(params),
                    torch.from_numpy(imgs).cuda(), torch.from_numpy(msks).cuda())


def _largest_conv(step, args) -> list:
    """The largest transient of a conv op in one step: [GiB, op, shapes]."""
    from torch.utils._python_dispatch import TorchDispatchMode

    convs = (torch.ops.aten.convolution, torch.ops.aten.convolution_backward)
    top = [0, "", []]

    class ConvPeaks(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, a=(), kwargs=None):
            if func.overloadpacket not in convs:
                return func(*a, **(kwargs or {}))
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            out = func(*a, **(kwargs or {}))
            high = torch.cuda.max_memory_allocated() - base
            if high > top[0]:
                top[:] = [high, str(func), [list(t.shape) for t in a[:2]]]
            return out

    with ConvPeaks():
        step(*args, 1e-5)
    torch.cuda.synchronize()
    return [top[0] / 2**30, *top[1:]]


def steps(rule: bool) -> dict:
    """The plain train steps (``--steps``) in this process, under the
    environment it was given and, with ``rule``, ``ops.conv``'s rule."""
    from tpu_unet_torch.ops import conv, full_fp32
    from tpu_unet_torch.train import make_train_step

    if not rule:
        conv.cudnn_engine_rule = lambda: None
    full_fp32()
    out = {}
    for arch, dts in (("unet", ("bf16", "fp32")), *((a, ("fp32",)) for a in FAMILIES)):
        config, args = _step_trees(arch)
        for dt in dts:
            step = make_train_step(config, amp=dt == "bf16")
            for _ in range(2):
                step(*args, 1e-5)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            times = []
            for _ in range(STEP_REPS):
                start, end = (torch.cuda.Event(enable_timing=True),
                              torch.cuda.Event(enable_timing=True))
                start.record()
                step(*args, 1e-5)
                end.record()
                end.synchronize()
                times.append(start.elapsed_time(end))
            out[f"{arch} {dt}"] = {"ms": statistics.median(times), "times_ms": times,
                                   "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                                   "largest_conv_gib": _largest_conv(step, args)}
            del step
            torch.cuda.empty_cache()
        del config, args
        torch.cuda.empty_cache()
    return out


def _child(args: list[str], env: dict) -> dict:
    """Run this tool in a fresh process; ``env``'s None values are unset."""
    full = {k: v for k, v in {**os.environ, **env}.items() if v is not None}
    proc = subprocess.run([sys.executable, "-m", "tpu_unet_torch.tools.conv_workspace", *args],
                          env=full, capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        return {"error": proc.stderr[-3000:]}
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--variants", nargs="*", default=[*IN_PROCESS, *ENVS, "wscap_late=1024"],
                    help="The ways to measure (default: all)")
    ap.add_argument("--steps", nargs="*", default=[], choices=[*ENVS, "rule"],
                    help="Time the plain train steps under each of these environments "
                         "(rule: ops.conv's), in turns (each twice)")
    ap.add_argument("--out", default=None)
    ap.add_argument("--variant", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--late-mib", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--ref-dir", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--child-steps", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--no-rule", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("conv_workspace: no CUDA device")
    if args.child_steps:
        print(json.dumps(steps(not args.no_rule)))
        return
    if args.variant:
        print(json.dumps(measure(args.variant, Path(args.ref_dir), args.late_mib)))
        return
    from tpu_unet_torch.tools.train_demo import card

    result: dict = {"card": card(torch.device("cuda")), "torch": torch.__version__,
                    "cuda": torch.version.cuda, "cudnn": torch.backends.cudnn.version(),
                    "variants": {}, "steps": {}}
    unset = {k: None for env in ENVS.values() for k in env}
    with tempfile.TemporaryDirectory() as ref:
        # "default" first: the reference outputs of the bitwise comparisons.
        for name in sorted(args.variants, key=lambda v: v != "default"):
            if name.startswith("wscap_late="):
                extra, env, variant = ["--late-mib", name.split("=")[1]], unset, "default"
            elif name in ENVS:
                extra, env, variant = [], {**unset, **ENVS[name]}, "env"
            else:
                extra, env, variant = [], unset, name
            rec = _child(["--variant", variant, "--ref-dir", ref, *extra], env)
            result["variants"][name] = rec
            print(json.dumps({name: rec}), flush=True)
    for k, name in enumerate([*args.steps, *reversed(args.steps)]):
        extra = [] if name == "rule" else ["--no-rule"]
        rec = _child(["--child-steps", *extra], {**unset, **ENVS.get(name, {})})
        result["steps"][f"{k} {name}"] = rec
        print(json.dumps({f"steps {k} {name}": rec}), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(result, indent=2))


if __name__ == "__main__":
    main()
