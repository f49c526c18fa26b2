#!/usr/bin/env python3
"""Drive the PyTorch port (``tpu_unet_torch``) once on an NVIDIA GPU.

Run from the repository root, on a machine with one CUDA card and nvcc:

    python3 chip_smoke.py

Phases, each of which exits non-zero on failure:

1. Print the card's name and power limit; build the CUDA kernels from
   ``tpu_unet_torch/csrc`` and print the build time.
2. Run each of the four serving kernels and its plain PyTorch version on the
   card at the serving path's own shapes, in bf16 and fp32 (TF32 off), and
   compare them: max abs and relative error and both times (CUDA events,
   median).
   2b. The same for the three train kernels (conv3x3_fwd with its stats,
   conv3x3_dx, conv3x3_dw) at the train step's shapes.
3. Build the full-width flagship U-Net (base 64, ConvTranspose decoder, one
   class, 31.0M parameters) from a seed, with a non-trivial BN state, save it
   as a checkpoint and start the port's HTTP server on it in this process
   with ``--kernels cuda`` at its bf16 default.
4. POST synthetic 1918x1280 Carvana-like images (scale 0.5 -> 959x640), some
   at once so a micro-batch forms, and check each PNG mask against the plain
   forward (``--kernels torch``) on the card; check that every kernel was
   launched by the served forwards; print ``/metrics``.
5. Train the same full-width model from seed 0 with the port's
   ``make_train_step``: one step at 959x640 batch 4, in fp32 and in bf16,
   with ``kernels="cuda"`` against ``kernels=None`` (library convs under
   autograd), comparing loss, gradients, grad norm and BN running stats;
   then time the 572x572 batch-16 bf16 step of both. Every ``"cuda"`` step
   must launch each train kernel as often as the network has convs for it,
   every plain step none.

The last two lines are the card (``nvidia-smi``) and the result JSON; the
line before them is the per-kernel JSON.
"""

from __future__ import annotations

import argparse
import io
import json
import shutil
import statistics
import subprocess
import sys
import threading
import time
from http.client import HTTPConnection
from pathlib import Path

import numpy as np
import torch
from PIL import Image

from tpu_unet_torch import kernels as K
from tpu_unet_torch.kernels import _build
from tpu_unet_torch.ops import full_fp32

ROOT = Path(__file__).resolve().parent

# Per-forward launches of each kernel in the flagship U-Net's --kernels path
# (tpu_unet_torch/models/infer.py): down3/down4 and the up blocks' conv2
# run the single conv, the up blocks' conv1 the concat conv, inc/down1/down2
# the double conv, and the four encoder pools the pool.
PER_FORWARD = {
    "fused_conv3x3_scale_relu": 8,
    "fused_conv3x3_concat_scale_relu": 4,
    "fused_double_conv": 3,
    "max_pool2x2": 4,
}
SOURCES = {
    "fused_conv3x3_scale_relu": ("tpu_unet_torch/csrc/fused_conv.cu",
                                 "tpu_unet/kernels/fused_conv.py:75"),
    "fused_conv3x3_concat_scale_relu": ("tpu_unet_torch/csrc/fused_conv.cu",
                                        "tpu_unet/kernels/fused_conv.py:192"),
    "fused_double_conv": ("tpu_unet_torch/csrc/fused_double_conv.cu",
                          "tpu_unet/kernels/fused_double_conv.py:94"),
    "max_pool2x2": ("tpu_unet_torch/csrc/pooling.cu", "tpu_unet/kernels/pooling.py:33"),
}
# Kernel vs plain tolerance, |kernel - plain| <= atol + rtol * |plain|.
# fp32: the two differ only in summation order over up to 9*1024 products.
# bf16: both sum exact products in fp32 and round once (twice for the double
# conv's mid), so an output may differ by about one bf16 ulp (2^-8 relative).
TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (2e-2, 2e-2)}
# Served bf16 masks vs the plain bf16 forward. The two differ only in the
# order of fp32 sums, but one-ulp bf16 roundings that this changes compound
# over the 23 convs of a random-weight network, whose logits crowd the
# threshold: measured 99.79-99.85% agreement on the H100. The fp32 forward
# is held to 1e-3 of the logit range, which is where the kernels are checked.
MASK_AGREEMENT = 0.995

TRAIN_SOURCES = {
    "conv3x3_fwd": ("tpu_unet_torch/csrc/train_conv.cu", "tpu_unet/kernels/train_conv.py:128"),
    "conv3x3_dx": ("tpu_unet_torch/csrc/train_conv.cu", "tpu_unet/kernels/train_conv.py:289"),
    "conv3x3_dw": ("tpu_unet_torch/csrc/train_conv.cu", "tpu_unet/kernels/train_conv.py:441"),
}
# Per-step wrapper calls of each train kernel with kernels="cuda": 9
# DoubleConvs of 2 convs each; inc's conv1 computes no dx (the image needs
# no gradient). conv3x3_fwd with stats and conv3x3_dw each make two kernel
# launches per call (the conv, then the fixed-order sum of its partials);
# the count is of calls.
PER_STEP = {"conv3x3_fwd": 18, "conv3x3_dx": 17, "conv3x3_dw": 18}
# Phase 2b cases: (label, x shape, Cout, prologue) at the 572x572 step's
# shapes (batch 4 instead of 16, to bound chip time) and one odd-width
# case of the 959x640 plan. The main case reported in the kernels line is
# MAIN_TRAIN_CASE, the step's largest-volume conv.
TRAIN_B = 4
TRAIN_CASES = (
    ("inc.conv1", (TRAIN_B, 572, 572, 3), 64, False),
    ("inc.conv2", (TRAIN_B, 572, 572, 64), 64, True),
    ("down4", (16, 35, 35, 512), 1024, True),
    ("down1.conv1@959x640", (4, 320, 479, 64), 128, False),
)
MAIN_TRAIN_CASE = "inc.conv2"
# Phase 5: the flagship at full width from seed 0, its parity batch (the
# Carvana production shape, 959x640) and its timing batch (572x572 b16).
TRAIN_CONFIG = {"n_channels": 3, "n_classes": 1, "bilinear": False, "base_channels": 64}
TRAIN_PARAMS = 31_037_633
PARITY_BATCH = (4, 640, 959)
TIMING_BATCH = (16, 572, 572)
# Train kernel vs plain. z and dx: TOL by output dtype (the kernels stage
# the same rounded values as the plain versions, so fp32 outputs differ
# only in summation order and bf16 ones by about one ulp). The (sum z,
# sum z^2) stats and dw are long sums over N*H*W: their max abs error is
# held to a fraction of the largest |plain| value.
STATS_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-3}
DW_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-3}
# Train step, kernels="cuda" vs kernels=None: loss and grad norm relative
# error and the largest per-tensor relative L2 error of the new BN running
# statistics (fp32: both paths sum in fp32 in another order; bf16: both
# round to bf16 at the same points, and one-ulp flips of rounded values
# propagate through 23 convs). Gradients are held against a float64 step
# (kernels=None): down4's gradients are ill-conditioned at the random init
# (norms ~5e-6 against a total of 5.6), so rounding alone moves them by
# 0.35% in fp32 and 25% in bf16 in BOTH paths (measured on an H100 80GB
# HBM3). Per tensor, the kernels' distance to float64 must be at most
# GRAD_RATIO times the library path's, plus the floor.
STEP_TOL = {
    "fp32": {"loss": 1e-5, "grad_norm": 1e-4, "bn_state": 1e-4, "grad_floor": 1e-4},
    "bf16": {"loss": 1e-3, "grad_norm": 5e-3, "bn_state": 5e-3, "grad_floor": 2e-2},
}
GRAD_RATIO = 2.0


def log(msg: str) -> None:
    print(msg, flush=True)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 10) -> float:
    """Median CUDA-event time of one call, after two warm-up calls."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _randn(gen, shape, scale=1.0):
    return torch.randn(shape, generator=gen, device=gen.device) * scale


def _conv_params(gen, cin, cout):
    w = _randn(gen, (3, 3, cin, cout), (9 * cin) ** -0.5)
    return w, 1.0 + 0.1 * _randn(gen, (cout,)), 0.1 * _randn(gen, (cout,))


def kernel_cases(gen):
    """(kernel name, shape label, kernel fn, plain fn, fp32 inputs) at the
    shapes the 959x640 forward gives each kernel."""
    from tpu_unet_torch.kernels.fused_conv import (
        fused_conv3x3_concat_scale_relu_plain,
        fused_conv3x3_scale_relu_plain,
    )
    from tpu_unet_torch.kernels.fused_double_conv import fused_double_conv_plain
    from tpu_unet_torch.kernels.pooling import max_pool2x2_plain

    cases = [("max_pool2x2", "[1,640,959,64]", K.max_pool2x2, max_pool2x2_plain,
              [_randn(gen, (1, 640, 959, 64))])]
    for shape, cmid in (((1, 640, 959, 3), 64), ((1, 160, 239, 128), 256)):
        w1, s1, b1 = _conv_params(gen, shape[-1], cmid)
        w2, s2, b2 = _conv_params(gen, cmid, cmid)
        cases.append(("fused_double_conv", f"{list(shape)}->{cmid}->{cmid}".replace(" ", ""),
                      K.fused_double_conv, fused_double_conv_plain,
                      [_randn(gen, shape), w1, s1, b1, w2, s2, b2]))
    for shape in ((1, 80, 119, 512), (1, 40, 59, 1024)):
        w, s, b = _conv_params(gen, shape[-1], shape[-1])
        cases.append(("fused_conv3x3_scale_relu", f"{list(shape)}->{shape[-1]}".replace(" ", ""),
                      K.fused_conv3x3_scale_relu, fused_conv3x3_scale_relu_plain,
                      [_randn(gen, shape), w, s, b]))
    shape = (1, 640, 959, 64)
    w, s, b = _conv_params(gen, 128, 64)
    cases.append(("fused_conv3x3_concat_scale_relu", "[1,640,959,64]+[1,640,959,64]->64",
                  K.fused_conv3x3_concat_scale_relu, fused_conv3x3_concat_scale_relu_plain,
                  [_randn(gen, shape), _randn(gen, shape), w, s, b]))
    return cases


def phase_kernels() -> dict[str, dict]:
    """Phase 2: every kernel vs its plain version at the main path's shapes."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    results: dict[str, dict] = {}
    failures = []
    for name, label, fn, plain, inputs in kernel_cases(gen):
        for dtype in (torch.bfloat16, torch.float32):
            args = [t.to(dtype) if t.ndim == 4 else t for t in inputs]
            got = fn(*args)
            torch.cuda.synchronize()
            ref = plain(*args)
            diff = (got.float() - ref.float()).abs()
            max_abs = diff.max().item()
            max_rel = max_abs / max(ref.float().abs().max().item(), 1e-30)
            atol, rtol = TOL[dtype]
            ok = bool((diff <= atol + rtol * ref.float().abs()).all().item())
            if name == "max_pool2x2":
                ok = max_abs == 0.0  # a max selects an input: exact
            ms = time_ms(lambda: fn(*args))
            plain_ms = time_ms(lambda: plain(*args))
            dt = "bf16" if dtype == torch.bfloat16 else "fp32"
            tol = "exact" if name == "max_pool2x2" else f"{atol:g}+{rtol:g}*|plain|"
            log(f"kernel {name} {label} {dt}: max_abs_err={max_abs:.3e} "
                f"max_rel_err={max_rel:.3e} (tol {tol}) ms={ms:.4f} plain_ms={plain_ms:.4f} "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                failures.append(f"{name} {label} {dt}")
            entry = results.setdefault(name, {"max_abs_err": 0.0, "cases": []})
            entry["max_abs_err"] = max(entry["max_abs_err"], max_abs)
            entry["cases"].append({"shape": label, "dtype": dt, "max_abs_err": max_abs,
                                   "max_rel_err": max_rel, "ms": ms, "plain_ms": plain_ms})
            del got, ref, diff
        torch.cuda.empty_cache()
    if failures:
        raise SystemExit(f"chip_smoke: kernels disagree with their plain versions: {failures}")
    return results


def _compare(got, ref, atol=0.0, rtol=0.0):
    """(max abs error, max abs error over max |ref|, all within atol +
    rtol * |ref|)."""
    diff = (got.float() - ref.float()).abs()
    max_abs = diff.max().item()
    ok = bool((diff <= atol + rtol * ref.float().abs()).all().item())
    return max_abs, max_abs / max(ref.float().abs().max().item(), 1e-30), ok


def phase_train_kernels() -> dict[str, dict]:
    """Phase 2b: each train kernel vs its plain version at the step's shapes.
    dx and dw read the plain forward's z; dx of a prologue conv comes out in
    fp32, as ``ConvStatsPro`` asks for it."""
    from tpu_unet_torch.kernels.train_conv import (
        conv3x3_dw_plain,
        conv3x3_dx_plain,
        conv3x3_fwd_plain,
    )

    gen = torch.Generator(device="cuda").manual_seed(1)
    results: dict[str, dict] = {}
    failures = []
    for label, shape, cout, prologue in TRAIN_CASES:
        cin = shape[-1]
        x32 = _randn(gen, shape)
        w32 = _randn(gen, (3, 3, cin, cout), (9 * cin) ** -0.5)
        g32 = _randn(gen, shape[:3] + (cout,))
        coef = torch.stack([torch.ones(cout, device="cuda"), 0.3 * _randn(gen, (cout,)),
                            0.2 * _randn(gen, (cout,))])
        pro = ()
        if prologue:
            c = 0.2 * _randn(gen, (cin,))
            c[0] = 0.7  # relu(c) > 0: the SAME padding must still read zeros
            pro = (1.0 + 0.2 * _randn(gen, (cin,)), c)
        for dtype in (torch.bfloat16, torch.float32):
            dt = "bf16" if dtype == torch.bfloat16 else "fp32"
            x, w, g = x32.to(dtype), w32.to(dtype), g32.to(dtype)
            z = conv3x3_fwd_plain(x, w, *pro)
            dx_dtype = torch.float32 if prologue else dtype
            calls = (
                ("conv3x3_fwd", lambda: K.conv3x3_fwd(x, w, *pro, stats=True),
                 lambda: conv3x3_fwd_plain(x, w, *pro, stats=True)),
                ("conv3x3_dx", lambda: K.conv3x3_dx(g, z, coef, w, out_dtype=dx_dtype),
                 lambda: conv3x3_dx_plain(g, z, coef, w, out_dtype=dx_dtype)),
                ("conv3x3_dw", lambda: K.conv3x3_dw(x, g, z, coef, *pro),
                 lambda: conv3x3_dw_plain(x, g, z, coef, *pro)),
            )
            for name, fn, plain in calls:
                got = fn()
                torch.cuda.synchronize()
                ref = plain()
                case = {"shape": f"{list(shape)}->{cout}".replace(" ", ""), "case": label,
                        "dtype": dt, "prologue": prologue}
                if name == "conv3x3_fwd":
                    atol, rtol = TOL[dtype]
                    max_abs, max_rel, ok = _compare(got[0], ref[0], atol, rtol)
                    s_abs, s_rel, _ = _compare(got[1], ref[1])
                    ok = ok and s_rel <= STATS_TOL[dtype]
                    case.update(stats_max_abs_err=s_abs, stats_err_over_max=s_rel)
                    tol = (f"z {atol:g}+{rtol:g}*|plain|, stats {STATS_TOL[dtype]:g}*max|plain| "
                           f"(stats err {s_abs:.3e}, {s_rel:.3e} of max)")
                elif name == "conv3x3_dx":
                    atol, rtol = TOL[dx_dtype]
                    max_abs, max_rel, ok = _compare(got, ref, atol, rtol)
                    tol = f"{atol:g}+{rtol:g}*|plain|, out {str(dx_dtype).split('.')[-1]}"
                else:
                    max_abs, max_rel, _ = _compare(got, ref)
                    ok = max_rel <= DW_TOL[dtype]
                    tol = f"{DW_TOL[dtype]:g}*max|plain|"
                del got, ref
                ms = time_ms(fn)
                plain_ms = time_ms(plain)
                log(f"kernel {name} {label} {case['shape']} {dt}: max_abs_err={max_abs:.3e} "
                    f"max_rel_err={max_rel:.3e} (tol {tol}) ms={ms:.4f} plain_ms={plain_ms:.4f} "
                    f"{'ok' if ok else 'FAIL'}")
                if not ok:
                    failures.append(f"{name} {label} {dt}")
                case.update(max_abs_err=max_abs, max_rel_err=max_rel, ms=ms, plain_ms=plain_ms)
                entry = results.setdefault(name, {"max_abs_err": 0.0, "cases": []})
                entry["max_abs_err"] = max(entry["max_abs_err"], max_abs)
                entry["cases"].append(case)
            del x, w, g, z
        del x32, w32, g32
        torch.cuda.empty_cache()
    if failures:
        raise SystemExit(f"chip_smoke: train kernels disagree with their plain versions: "
                         f"{failures}")
    return results


def _leaves(tree, prefix: str = "") -> dict[str, torch.Tensor]:
    """{key path: tensor} of a nested dict / NamedTuple tree."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, tuple):
        items = zip(tree._fields, tree)
    else:
        return {prefix: tree}
    out: dict[str, torch.Tensor] = {}
    for k, v in items:
        out.update(_leaves(v, f"{prefix}/{k}"))
    return out


def _rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    return ((a.float() - b.float()).norm() / b.float().norm().clamp_min(1e-30)).item()


def _worst(errs: dict[str, float], k: int = 3) -> str:
    return ", ".join(f"{n}={e:.2e}" for n, e in sorted(errs.items(), key=lambda t: -t[1])[:k])


def phase_train() -> tuple[dict[str, int], dict]:
    """Phase 5. Returns the train kernels' launches over the phase and the
    step timings."""
    from tpu_unet_torch.data import synth_batch
    from tpu_unet_torch.models import UNetConfig, init_unet, param_count
    from tpu_unet_torch.models.unet import tree_map
    from tpu_unet_torch.optim import rmsprop_init
    from tpu_unet_torch.train import make_train_step

    config = UNetConfig(**TRAIN_CONFIG)
    params, state = init_unet(config, np.random.default_rng(0), device="cuda")
    opt = rmsprop_init(params)
    failures = []
    n_params = param_count(params)
    log(f"train model: {n_params} parameters")
    if n_params != TRAIN_PARAMS:
        failures.append(f"{n_params} parameters, expected {TRAIN_PARAMS}")

    def run(step, kernels, images, masks, trees=(params, state, opt)):
        """One step from the seed's trees; (outputs, device ms). Checks the
        step's launches: PER_STEP with kernels="cuda", none without."""
        before = K.launch_counts()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = step(*trees, images, masks, 1e-4)
        end.record()
        end.synchronize()
        after = K.launch_counts()
        for name in after:
            want = PER_STEP.get(name, 0) if kernels == "cuda" else 0
            if after[name] - before[name] != want:
                failures.append(f"kernels={kernels}: {name} launched "
                                f"{after[name] - before[name]} times in a step, expected {want}")
        if not torch.isfinite(out[3]).item():
            failures.append(f"kernels={kernels}: loss {out[3].item()}")
        return out, start.elapsed_time(end)

    # The main path's run: every count from 0.
    K.reset_launch_counts()

    # Parity at the Carvana production shape, 959x640 batch 4, against the
    # float64 library step as the reference for the gradients.
    imgs, msks = synth_batch(np.random.default_rng(1), *PARITY_BATCH)
    shape = list(imgs.shape)
    images, masks = torch.from_numpy(imgs).cuda(), torch.from_numpy(msks).cuda()
    p64 = tree_map(lambda t: t.double(), params)
    ref, _ = run(make_train_step(config, return_grads=True), None, images.double(), masks,
                 trees=(p64, state, rmsprop_init(p64)))
    g64 = _leaves(ref[5])
    log(f"train step {shape} float64 kernels=None: loss {ref[3].item():.6f} "
        f"grad norm {ref[4].item():.6f}")
    del p64, ref
    for amp, dt in ((False, "fp32"), (True, "bf16")):
        outs = {}
        for kernels in ("cuda", None):
            step = make_train_step(config, amp=amp, kernels=kernels, return_grads=True)
            outs[kernels], ms = run(step, kernels, images, masks)
            log(f"train step {shape} {dt} kernels={kernels}: loss {outs[kernels][3].item():.6f} "
                f"grad norm {outs[kernels][4].item():.6f} ({ms:.1f} ms incl. first-call set-up)")
        c, p = outs["cuda"], outs[None]
        gc, gp = _leaves(c[5]), _leaves(p[5])
        bc, bp = _leaves(c[1]), _leaves(p[1])
        finite = all(bool(torch.isfinite(t).all().item()) for t in (*gc.values(), *bc.values()))
        tol = STEP_TOL[dt]
        errs = {
            "loss": abs(c[3].item() - p[3].item()) / abs(p[3].item()),
            "grad_norm": abs(c[4].item() - p[4].item()) / abs(p[4].item()),
            "bn_state": max(_rel_l2(bc[k], bp[k]) for k in bp),
        }
        e_cuda = {k: _rel_l2(gc[k], g64[k]) for k in g64}
        e_plain = {k: _rel_l2(gp[k], g64[k]) for k in g64}
        e_cross = {k: _rel_l2(gc[k], gp[k]) for k in gp}
        over = [k for k in g64 if not e_cuda[k] <= GRAD_RATIO * e_plain[k] + tol["grad_floor"]]
        log(f"train step parity {dt}, kernels=cuda vs None: loss rel err {errs['loss']:.3e} "
            f"(tol {tol['loss']:g}); grad norm rel err {errs['grad_norm']:.3e} "
            f"(tol {tol['grad_norm']:g}); BN running stats rel L2 err max "
            f"{errs['bn_state']:.3e} over {len(bp)} tensors (tol {tol['bn_state']:g}); "
            f"finite={finite}")
        log(f"train step gradients {dt}, rel L2 err to float64 over {len(g64)} tensors: "
            f"cuda max {max(e_cuda.values()):.3e} ({_worst(e_cuda)}), plain max "
            f"{max(e_plain.values()):.3e} ({_worst(e_plain)}); tol cuda <= {GRAD_RATIO:g} x plain "
            f"+ {tol['grad_floor']:g}, {len(over)} over; cuda vs plain max "
            f"{max(e_cross.values()):.3e} ({_worst(e_cross)})")
        if not finite:
            failures.append(f"{dt}: non-finite gradients or BN state")
        for key, err in errs.items():
            if not err <= tol[key]:
                failures.append(f"{dt} parity: {key} error {err:.3e} > {tol[key]:g}")
        failures += [f"{dt} gradient {k}: {e_cuda[k]:.3e} from float64 vs plain "
                     f"{e_plain[k]:.3e}" for k in over]
        del outs, c, p, gc, gp, bc, bp
        torch.cuda.empty_cache()
    del images, masks, g64

    # Timing at 572x572 batch 16 in bf16, in turns: plain, cuda, cuda, plain.
    imgs, msks = synth_batch(np.random.default_rng(2), *TIMING_BATCH)
    n, shape = imgs.shape[0], list(imgs.shape)
    images, masks = torch.from_numpy(imgs).cuda(), torch.from_numpy(msks).cuda()
    steps = {k: make_train_step(config, amp=True, kernels=k) for k in ("cuda", None)}
    timing: dict[str, list] = {"cuda": [], "plain": []}
    for kernels in (None, "cuda", "cuda", None):
        for _ in range(2):  # warm-up
            run(steps[kernels], kernels, images, masks)
        torch.cuda.reset_peak_memory_stats()
        times = [run(steps[kernels], kernels, images, masks)[1] for _ in range(3)]
        peak = torch.cuda.max_memory_allocated()
        ms = statistics.median(times)
        tag = "cuda" if kernels == "cuda" else "plain"
        timing[tag].append({"ms": ms, "img_s": n * 1e3 / ms, "peak_bytes": peak,
                            "times_ms": times})
        log(f"train step {shape} bf16 kernels={kernels}: {ms:.2f} ms/step (median of "
            f"{' '.join(f'{t:.2f}' for t in times)}), {n * 1e3 / ms:.2f} img/s, peak memory "
            f"{peak / 2**30:.3f} GiB")
    launches = K.launch_counts()
    log(f"launches in phase 5: {json.dumps(launches)}")
    if failures:
        raise SystemExit(f"chip_smoke: train checks failed: {failures}")
    return launches, timing


def calibrate_bn(params, state, config, x):
    """BN running statistics set to the batch statistics of ``x`` (NHWC fp32
    on the card), layer by layer in plain PyTorch, so that every BN of the
    random-weight model normalises as a trained one would and the logits
    vary over the image instead of collapsing to the head's bias."""
    from tpu_unet_torch.ops import BNState, conv2d, conv_transpose2d, max_pool2d, pad_to_match

    def dc(p, h):
        new = {}
        for i in ("1", "2"):
            z = conv2d(h, p[f"conv{i}"]["w"], padding=1)
            mean, var = z.mean((0, 1, 2)), z.var((0, 1, 2), unbiased=False)
            new[f"bn{i}"] = BNState(mean, var)
            bn = p[f"bn{i}"]
            h = torch.relu((z - mean) * torch.rsqrt(var + 1e-5) * bn["scale"] + bn["bias"])
        return h, new

    new_state = {}
    skips = []
    h = x
    for name in ("inc", "down1", "down2", "down3", "down4"):
        h, new_state[name] = dc(params[name], max_pool2d(h) if name != "inc" else h)
        skips.append(h)
    for i, skip in zip(range(1, 5), skips[-2::-1]):
        up = params[f"up{i}"]["up"]
        u = pad_to_match(conv_transpose2d(h, up["w"], stride=2) + up["b"], skip)
        h, conv_state = dc(params[f"up{i}"]["conv"], torch.cat([skip, u], dim=-1))
        new_state[f"up{i}"] = {"conv": conv_state}
    return new_state


def post(port: int, body: bytes, path: str = "/predict") -> tuple[int, bytes, float]:
    conn = HTTPConnection("127.0.0.1", port, timeout=600)
    t0 = time.perf_counter()
    try:
        conn.request("POST", path, body=body)
        r = conn.getresponse()
        return r.status, r.read(), time.perf_counter() - t0
    finally:
        conn.close()


def get_json(port: int, path: str) -> dict:
    conn = HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request("GET", path)
        return json.loads(conn.getresponse().read())
    finally:
        conn.close()


def phase_serve(workdir: Path) -> dict[str, int]:
    """Phases 3 and 4. Returns each kernel's launches during the served run."""
    from tpu_unet_torch import serve
    from tpu_unet_torch.checkpoint import save_checkpoint
    from tpu_unet_torch.data import make_synthetic_carvana, preprocess
    from tpu_unet_torch.models import UNetConfig, fold_bn, init_unet, param_count, unet_infer_apply
    from tpu_unet_torch.models.unet import tree_map
    from tpu_unet_torch.ops import resize_bilinear
    from tpu_unet_torch.predict import logits_to_mask, mask_to_image

    # Phase 3: the full-width model, checkpointed, served in this process.
    config = UNetConfig(n_channels=3, n_classes=1, bilinear=False, base_channels=64)
    params, state = init_unet(config, np.random.default_rng(0), device="cuda")
    img_dir, _ = make_synthetic_carvana(workdir / "data", n=4, h=1280, w=1918, seed=0)
    paths = sorted(img_dir.glob("*.png"))
    calib = torch.from_numpy(preprocess(Image.open(paths[0]), 0.5))[None].cuda()
    with torch.inference_mode():
        state = calibrate_bn(params, state, config, calib)
    ckpt = workdir / "unet_base64.npz"
    save_checkpoint(ckpt, params, state, [0, 1], {"config": config._asdict()})
    log(f"model: {param_count(params)} parameters, checkpoint {ckpt.stat().st_size} bytes")

    t0 = time.perf_counter()
    server, predictor = serve.make_server(
        ["-m", str(ckpt), "--port", "0", "--kernels", "cuda", "--warmup", "1280x1918"])
    log(f"server: loaded and warmed in {time.perf_counter() - t0:.1f} s "
        f"(kernels={predictor.kernels}, amp={predictor.amp}, device={predictor.device})")
    port = server.server_address[1]
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    bodies = [p.read_bytes() for p in paths]
    try:
        # Phase 4: the served run. Sequential requests at the default 5 ms
        # batch window, then all images at once with a window wide enough
        # that they form one micro-batch.
        K.reset_launch_counts()
        responses = []
        for body in bodies:
            responses.append(post(port, body))
        predictor.batch_window = 0.25
        burst: list = [None] * len(bodies)

        def call(k):
            burst[k] = post(port, bodies[k])

        threads = [threading.Thread(target=call, args=(k,)) for k in range(len(bodies))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        launches = K.launch_counts()
        metrics = get_json(port, "/metrics")
        health = get_json(port, "/healthz")
    finally:
        server.shutdown()
        server.server_close()
        predictor.stop()
        thread.join(timeout=10)
    log(f"healthz: {json.dumps(health)}")
    log(f"metrics: {json.dumps(metrics)}")
    log("sequential request latency ms (client): "
        + " ".join(f"{r[2] * 1e3:.1f}" for r in responses))
    log(f"launches in the served run: {json.dumps(launches)}")

    failures = []
    if any(r is None for r in burst):
        failures.append("a concurrent request did not finish")
    dispatches = metrics.get("dispatches", 0)
    if metrics.get("dispatch_batch_mean", 0) <= 1:
        failures.append("no micro-batch formed")
    for name, per in PER_FORWARD.items():
        if launches[name] != per * dispatches:
            failures.append(f"{name}: {launches[name]} launches, expected {per} x {dispatches}")

    # Each served mask vs the plain forward (--kernels torch, bf16) on the
    # card, with the largest plain |logit| among the pixels where they differ.
    folded_bf16 = tree_map(lambda t: t.cuda().to(torch.bfloat16), fold_bn(params, state, config))
    served = responses + [r for r in burst if r is not None]
    for k, (status, data, _) in enumerate(served):
        path = paths[k % len(paths)]
        if status != 200:
            failures.append(f"request {k}: HTTP {status}")
            continue
        mask_img = Image.open(io.BytesIO(data))
        mask = np.asarray(mask_img).astype(np.int64)
        img = Image.open(path)
        with torch.inference_mode():
            x = torch.from_numpy(preprocess(img, 0.5))[None].cuda()
            z = unet_infer_apply(folded_bf16, x, config=config, backend="torch",
                                 compute_dtype=torch.bfloat16)
            z = resize_bilinear(z, img.height, img.width, align_corners=False)[0]
            ref = logits_to_mask(z, 1, 0.5).astype(np.int64)
        z = z[..., 0].cpu().numpy()
        differ = mask != ref
        agree = 1.0 - float(differ.mean())
        margin = float(np.abs(z[differ]).max()) if differ.any() else 0.0
        log(f"request {k} ({path.name}): PNG {mask_img.size} mode {mask_img.mode}, "
            f"foreground {mask.mean():.4f}, agreement with --kernels torch {agree:.6f}, "
            f"largest plain |logit| where they differ {margin:.4f} (|logit| std {z.std():.4f})")
        if mask_img.size != (1918, 1280):
            failures.append(f"request {k}: mask size {mask_img.size}")
        if not set(np.unique(mask).tolist()) <= {0, 1}:
            failures.append(f"request {k}: values outside the palette [0, 1]")
        if agree < MASK_AGREEMENT:
            failures.append(f"request {k}: agreement {agree:.6f} < {MASK_AGREEMENT}")

    # Where one sequential request's time goes, by the host clock around
    # synchronised steps (the server does the same steps in this order).
    t = [time.perf_counter()]
    img = Image.open(io.BytesIO(bodies[0]))
    img.load()
    t.append(time.perf_counter())
    arr = preprocess(img, 0.5)
    t.append(time.perf_counter())
    with torch.inference_mode():
        x = torch.from_numpy(arr)[None].cuda()
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        logits = predictor.forward(x)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        lg = resize_bilinear(logits, img.height, img.width, align_corners=False)
        mask = logits_to_mask(lg[0], 1, 0.5)
    t.append(time.perf_counter())
    mask_to_image(mask, [0, 1]).save(io.BytesIO(), format="PNG")
    t.append(time.perf_counter())
    steps = ("png_decode", "resize_bicubic", "h2d", "forward", "upscale_threshold_d2h",
             "png_encode")
    log("request breakdown ms: " + " ".join(
        f"{name}={(t[i + 1] - t[i]) * 1e3:.2f}" for i, name in enumerate(steps))
        + f" total={(t[-1] - t[0]) * 1e3:.2f}")

    # The whole forward in fp32, kernels vs plain, and both forwards' times
    # (bf16 and fp32, in turns: torch, cuda, cuda, torch).
    x = torch.from_numpy(preprocess(Image.open(paths[1]), 0.5))[None].cuda()
    folded = tree_map(lambda t: t.cuda(), fold_bn(params, state, config))
    with torch.inference_mode():
        got = unet_infer_apply(folded, x, config=config, backend="cuda")
        ref = unet_infer_apply(folded, x, config=config, backend="torch")
        err = (got - ref).abs().max().item()
        scale = ref.abs().max().item()
        finite = bool(torch.isfinite(got).all().item())
        log(f"forward fp32 [1,640,959,3]: logits {tuple(got.shape)} finite={finite} "
            f"max_abs_err={err:.3e} (max |logit| {scale:.3e})")
        if not finite or err > 1e-3 * max(scale, 1.0):
            failures.append(f"fp32 forward: kernels vs plain max_abs_err {err:.3e}")
        fb = tree_map(lambda t: t.to(torch.bfloat16), folded)
        got = unet_infer_apply(fb, x, config=config, backend="cuda", compute_dtype=torch.bfloat16)
        ref = unet_infer_apply(fb, x, config=config, backend="torch", compute_dtype=torch.bfloat16)
        d = (got - ref).abs().flatten()
        log(f"forward bf16 [1,640,959,3]: |logit| std {ref.std().item():.4f}, kernels vs plain "
            f"|diff| mean {d.mean().item():.3e} p99.9 {d.quantile(0.999).item():.3e} "
            f"max {d.max().item():.3e}; sign agreement {((got > 0) == (ref > 0)).float().mean().item():.6f}")
        for dtype in (torch.bfloat16, torch.float32):
            fd = tree_map(lambda t, d=dtype: t.to(d), folded)
            runs = [(b, time_ms(lambda b=b, fd=fd, d=dtype: unet_infer_apply(
                fd, x, config=config, backend=b, compute_dtype=d), reps=5))
                for b in ("torch", "cuda", "cuda", "torch")]
            log(f"forward {str(dtype).split('.')[-1]} [1,640,959,3] ms (median of 5, in turns): "
                + " ".join(f"{b}={ms:.3f}" for b, ms in runs))
    if failures:
        raise SystemExit(f"chip_smoke: serving checks failed: {failures}")
    return launches


def main(argv=None) -> int:
    argparse.ArgumentParser(description=__doc__.split("\n")[0]).parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this script runs the port on a CUDA GPU")
    card = gpu_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    full_fp32()

    # Phase 1: build.
    t0 = time.perf_counter()
    _build.library()
    log(f"build: {time.perf_counter() - t0:.1f} s -> {_build.library_path().relative_to(ROOT)}")
    for line in _build.library_path().with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log(f"  ptxas: {line.strip()}")

    # Phase 2: kernels vs plain.
    results = phase_kernels()
    # Phase 2b: train kernels vs plain.
    results.update(phase_train_kernels())
    # Phases 3 and 4: serve the full-width model.
    workdir = ROOT / ".smoke"
    shutil.rmtree(workdir, ignore_errors=True)
    try:
        launches = phase_serve(workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    torch.cuda.empty_cache()
    # Phase 5: train the full-width model.
    train_launches, timing = phase_train()
    log(f"train step timing: {json.dumps(timing)}")

    report = []
    for name in (*PER_FORWARD, *PER_STEP):
        if name in PER_FORWARD:
            (src, replaces), count = SOURCES[name], launches[name]
            main_case = results[name]["cases"][0]
        else:
            (src, replaces), count = TRAIN_SOURCES[name], train_launches[name]
            main_case = next(c for c in results[name]["cases"]
                             if c["case"] == MAIN_TRAIN_CASE and c["dtype"] == "bf16")
        report.append({"name": name, "route": "cuda", "source": src, "replaces": replaces,
                       "launches": count, "max_abs_err": results[name]["max_abs_err"],
                       "ms": main_case["ms"], "plain_ms": main_case["plain_ms"],
                       "cases": results[name]["cases"]})
    print(json.dumps({"kernels": report}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                              "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
