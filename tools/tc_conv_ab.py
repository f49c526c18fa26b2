#!/usr/bin/env python3
"""Compare the bf16 tensor-core convs (``tpu_unet_torch/csrc/tc_conv.cu``) of
two trees of this repository on one CUDA card: the split of the level-0
``conv3x3_fwd`` (``chip_smoke.fwd_split``), and the back-to-back and device
times of every phase-2b ``conv3x3_fwd``, ``conv3x3_dx`` and ``conv3x3_dw``
case, every served ``fused_conv3x3_scale_relu`` and
``fused_conv3x3_concat_scale_relu`` shape, the three served
``fused_double_conv`` shapes (without the pooled output, which the parent's
wrapper may lack), and the two 572x572 ``im2col_conv3x3`` cases of phase 2c.

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
    for name, label, fn, _, inputs, _, _ in c.kernel_cases(gen):
        args = [t.bfloat16() if t.ndim == 4 else t for t in inputs]
        if name in ("fused_conv3x3_scale_relu", "fused_conv3x3_concat_scale_relu"):
            line(f"{name} {label} bf16", lambda: fn(*args))
        elif name == "fused_double_conv":
            line(f"{name} {label} bf16", lambda: K.fused_double_conv(*args))
    for label, shape, cout, relu in c.IM2COL_CASES:
        if shape[1] == 572 and shape[-1] >= 64:
            x = c._randn(gen, shape).bfloat16()
            w, s, b = c._conv_params(gen, shape[-1], cout)
            w = w.bfloat16()
            line(f"im2col_conv3x3 {label} {list(shape)}->{cout} bf16",
                 lambda: K.im2col_conv3x3(x, w, s, b, apply_relu=relu))


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
