#!/usr/bin/env python3
"""Compare the tensor-core convs (``tpu_unet_torch/csrc/tc_conv.cu``) of two
trees of this repository on one CUDA card: the split of the level-0
``conv3x3_fwd`` (``chip_smoke.fwd_split``), and the back-to-back and device
times of every phase-2b ``conv3x3_fwd``, ``conv3x3_dx`` and ``conv3x3_dw``
case in bf16 and in fp32 (3xTF32 where the tree has that route, the
CUDA-core kernels where it does not), every served
``fused_conv3x3_scale_relu`` and ``fused_conv3x3_concat_scale_relu`` shape
in bf16 and in fp32, the three served ``fused_double_conv`` shapes in bf16
(without the pooled output, which an older parent's wrapper may lack) and
in fp32 (with it, as the forward calls it), the two phase-2 ``max_pool2x2``
shapes in bf16 and fp32 beside ``F.max_pool2d`` on the same input, and the
two 572x572 ``im2col_conv3x3`` cases of phase 2c in bf16 and fp32.
Then the 572x572 batch-16 train step (``make_train_step``, ``kernels="cuda"``
and ``None``) in bf16 and fp32: CUDA-event ms, median of 3 after one
warm-up, and the peak device memory; and the served forward
(``unet_infer_apply``, full width, random weights from seed 0) at 959x640
in bf16 and fp32, ``backend="cuda"`` and ``"torch"``:
``chip_smoke.time_ms``, median of 5, and the device time of its kernels
(``chip_smoke.device_ms``, summed).

    python3 tools/tc_conv_ab.py PARENT_DIR [CHANGE_DIR]

PARENT_DIR holds the other tree, e.g. ``git archive HEAD`` unpacked into the
git-ignored ``.checkout/parent``; CHANGE_DIR defaults to this repository.
Both are built at once first; then each tree runs in a process of its own,
in the order parent, change, change, parent, so that drift of the card
shows. This repository's ``chip_smoke.py`` times every tree.
"""

from __future__ import annotations

import argparse
import importlib.util
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
BUILD = "from tpu_unet_torch.kernels import _build; _build.library()"


def time_steps(c, torch) -> None:
    """The 572x572 b16 train step of this tree, both dtypes and kernels."""
    import statistics

    import numpy as np

    from tpu_unet_torch.data import synth_batch
    from tpu_unet_torch.models import UNetConfig, init_unet
    from tpu_unet_torch.optim import rmsprop_init
    from tpu_unet_torch.train import make_train_step

    config = UNetConfig(**c.TRAIN_CONFIG)
    params, state = init_unet(config, np.random.default_rng(0), device="cuda")
    opt = rmsprop_init(params)
    imgs, msks = synth_batch(np.random.default_rng(2), *c.TIMING_BATCH)
    images, masks = torch.from_numpy(imgs).cuda(), torch.from_numpy(msks).cuda()
    for amp, dt in ((True, "bf16"), (False, "fp32")):
        for kernels in ("cuda", None):
            step = make_train_step(config, amp=amp, kernels=kernels)

            def one():
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                step(params, state, opt, images, masks, 1e-4)
                end.record()
                end.synchronize()
                return start.elapsed_time(end)

            one()
            torch.cuda.reset_peak_memory_stats()
            times = [one() for _ in range(3)]
            c.log(f"train step {list(imgs.shape)} {dt} kernels={kernels}: "
                  f"{statistics.median(times):.2f} ms (median of "
                  f"{' '.join(f'{t:.2f}' for t in times)}), peak "
                  f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
            del step
            torch.cuda.empty_cache()


def time_forward(c, torch) -> None:
    """The served forward of this tree at 959x640, bf16 and fp32, kernels
    and plain."""
    import numpy as np

    from tpu_unet_torch.models import UNetConfig, fold_bn, init_unet, unet_infer_apply
    from tpu_unet_torch.models.unet import tree_map

    config = UNetConfig(**c.TRAIN_CONFIG)
    params, state = init_unet(config, np.random.default_rng(0), device="cuda")
    folded = tree_map(lambda t: t.cuda(), fold_bn(params, state, config))
    x = torch.from_numpy(np.random.default_rng(1).random((1, 640, 959, 3), np.float32)).cuda()
    with torch.inference_mode():
        for dtype, dt in ((torch.bfloat16, "bf16"), (torch.float32, "fp32")):
            fd = tree_map(lambda t, d=dtype: t.to(d), folded)
            for backend in ("cuda", "torch"):
                def fwd(b=backend, fd=fd, d=dtype):
                    return unet_infer_apply(fd, x, config=config, backend=b, compute_dtype=d)

                ms = c.time_ms(fwd, reps=5)
                dev = c.device_ms(fwd)
                c.log(f"forward {dt} [1,640,959,3] backend={backend}: {ms:.3f} ms (median of "
                      f"5), device {sum(dev.values()):.3f} ms: "
                      + "; ".join(f"{k} {v:.4f}"
                                  for k, v in sorted(dev.items(), key=lambda t: -t[1])))


def measure(tree: Path) -> None:
    """Print one tree's numbers; its ``tpu_unet_torch`` is imported."""
    sys.path.insert(0, str(tree))
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    c = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(c)
    import torch

    K = c.K
    c.full_fp32()
    c.log(f"tree {tree}: {K.__file__}")

    def line(label, fn):
        dev = "; ".join(f"{k} {v:.4f}" for k, v in c.device_ms(fn).items())
        c.log(f"{label}: back to back {c.b2b_ms(fn):.4f} ms, device {dev}")

    gen = torch.Generator(device="cuda").manual_seed(1)
    for label, shape, cout, prologue in c.TRAIN_CASES:
        cin = shape[-1]
        x = c._randn(gen, shape).bfloat16()
        w = c._randn(gen, (3, 3, cin, cout), (9 * cin) ** -0.5).bfloat16()
        pro = ()
        if prologue:
            cc = 0.2 * c._randn(gen, (cin,))
            cc[0] = 0.7
            pro = (1.0 + 0.2 * c._randn(gen, (cin,)), cc)
        if label == c.MAIN_TRAIN_CASE:
            c.fwd_split(x, w, pro)
        tag = f"{label} {list(shape)}->{cout} bf16"
        line(f"conv3x3_fwd {tag} stats", lambda: K.conv3x3_fwd(x, w, *pro, stats=True))
        z = K.conv3x3_fwd(x, w, *pro)
        g = c._randn(gen, shape[:3] + (cout,)).bfloat16()
        coef = torch.stack([torch.ones(cout, device="cuda"), 0.3 * c._randn(gen, (cout,)),
                            0.2 * c._randn(gen, (cout,))])
        dx_dtype = torch.float32 if prologue else torch.bfloat16  # as phase 2b
        line(f"conv3x3_dx {tag}", lambda: K.conv3x3_dx(g, z, coef, w, out_dtype=dx_dtype))
        line(f"conv3x3_dw {tag}", lambda: K.conv3x3_dw(x, g, z, coef, *pro))
        x32, w32, g32, z32 = x.float(), w.float(), g.float(), z.float()
        tag = f"{label} {list(shape)}->{cout} fp32"
        line(f"conv3x3_fwd {tag} stats", lambda: K.conv3x3_fwd(x32, w32, *pro, stats=True))
        line(f"conv3x3_dx {tag}", lambda: K.conv3x3_dx(g32, z32, coef, w32))
        line(f"conv3x3_dw {tag}", lambda: K.conv3x3_dw(x32, g32, z32, coef, *pro))
        del x32, w32, g32, z32
    for name, label, fn, _, inputs, _, library in c.kernel_cases(gen):
        args = [t.bfloat16() if t.ndim == 4 else t for t in inputs]
        if name == "max_pool2x2":
            for dt, xs in (("bf16", args), ("fp32", inputs)):
                line(f"{name} {label} {dt}", lambda: fn(*xs))
                line(f"F.max_pool2d {label} {dt}", library(*xs))
        elif name in ("fused_conv3x3_scale_relu", "fused_conv3x3_concat_scale_relu"):
            line(f"{name} {label} bf16", lambda: fn(*args))
            line(f"{name} {label} fp32", lambda: fn(*inputs))
        elif name == "fused_double_conv":
            line(f"{name} {label} bf16", lambda: K.fused_double_conv(*args))
            line(f"{name} {label} fp32 pool", lambda: fn(*inputs))
    for label, shape, cout, relu in c.IM2COL_CASES:
        if shape[1] == 572 and shape[-1] >= 64:
            x32 = c._randn(gen, shape)
            w32, s, b = c._conv_params(gen, shape[-1], cout)
            for dt, x, w in (("bf16", x32.bfloat16(), w32.bfloat16()), ("fp32", x32, w32)):
                line(f"im2col_conv3x3 {label} {list(shape)}->{cout} {dt}",
                     lambda: K.im2col_conv3x3(x, w, s, b, apply_relu=relu))
    time_steps(c, torch)
    time_forward(c, torch)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("parent", type=Path)
    ap.add_argument("change", type=Path, nargs="?", default=ROOT)
    ap.add_argument("--measure", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.measure:
        measure(args.parent.resolve())
        return 0
    trees = [args.parent.resolve(), args.change.resolve()]
    builds = [subprocess.Popen([sys.executable, "-c", BUILD], cwd=t) for t in trees]
    if any(b.wait() != 0 for b in builds):
        raise SystemExit("tc_conv_ab: a build failed")
    for tree in (trees[0], trees[1], trees[1], trees[0]):
        subprocess.run([sys.executable, __file__, str(tree), "--measure"], check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
