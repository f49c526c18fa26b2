#!/usr/bin/env python3
"""Time the fp32 ``fused_double_conv`` at every tile its kernel takes, at
the three served shapes (inc, down1, down2 of the 959x640 forward, with the
pool, as the forward calls it), on one CUDA card: each even th x tw up to
16 x 64 whose fragments and shared memory fit (``kernels/tc_conv.py``
``dc_smem``, ``DC_MI_MAX_F32``), back to back (``chip_smoke.b2b_ms``),
beside the tile ``dc_plan`` picks. It checks ``dc_plan``'s fp32 cost
weights; it does not compare outputs (``chip_smoke.py`` phase 2 holds the
plan's tiles against the plain version).

    python3 tools/dc_tile_sweep.py [--json PATH]

Prints, per shape, the fastest tiles and the plan's; ``--json`` also writes
every timing to PATH.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

SHAPES = (((1, 640, 959, 3), 64), ((1, 320, 479, 64), 128), ((1, 160, 239, 128), 256))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--json", type=Path, help="write every timing here")
    args = ap.parse_args()
    import torch

    import chip_smoke as c
    from tpu_unet_torch import kernels as K
    from tpu_unet_torch.kernels import _build, tc_conv

    if not torch.cuda.is_available():
        raise SystemExit("dc_tile_sweep: no CUDA device")
    c.full_fp32()
    c.log(f"card: {c.gpu_line()}")
    _build.library()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device="cuda").manual_seed(0)
    plan_fn = tc_conv.dc_plan
    results = {}
    try:
        for shape, cmid in SHAPES:
            n, h, w, cin = shape
            w1, s1, b1 = c._conv_params(gen, cin, cmid)
            w2, s2, b2 = c._conv_params(gen, cmid, cmid)
            inputs = [c._randn(gen, shape), w1, s1, b1, w2, s2, b2]
            kc = tc_conv.KC_F32
            chosen = plan_fn(n, h, w, -(-cin // 8) * 8, -(-cmid // kc) * kc, cmid, sms, True)
            rows = []
            for th in range(2, 17, 2):
                for tw in range(2, 65, 2):
                    # warps over M: 4 a 64-column half of a 128-column pass
                    # (Cout = Cmid at these shapes)
                    warps = tc_conv.DC_WARPS // 2 if cmid > 64 else tc_conv.DC_WARPS
                    f1 = tc_conv._dc_frags((th + 2) * (tw + 2), warps)
                    f2 = tc_conv._dc_frags(th * tw, warps)
                    smem = tc_conv.dc_smem(th, tw, cmid, cmid, True)
                    if max(f1, f2) > tc_conv.DC_MI_MAX_F32 or smem > tc_conv.DC_MAX_SMEM:
                        continue
                    plan = tc_conv.DcPlan(th, tw, math.ceil(h / th), math.ceil(w / tw), n, smem)
                    tc_conv.dc_plan = lambda *a, plan=plan, **k: plan
                    ms = c.b2b_ms(lambda: K.fused_double_conv(*inputs, pool=True), reps=10)
                    rows.append({"ms": ms, "th": th, "tw": tw, "mi": [f1, f2],
                                 "tiles": plan.tiles})
            tc_conv.dc_plan = plan_fn
            rows.sort(key=lambda r: r["ms"])
            label = f"{list(shape)}->{cmid}->{cmid}".replace(" ", "")
            mine = next(r for r in rows if (r["th"], r["tw"]) == (chosen.th, chosen.tw))
            c.log(f"{label} fp32: plan {chosen.th}x{chosen.tw} {mine['ms']:.4f} ms, "
                  f"{mine['ms'] / rows[0]['ms'] - 1:+.2%} against the fastest of {len(rows)}")
            for r in rows[:8]:
                c.log(f"  {r['ms']:.4f} ms  {r['th']}x{r['tw']}  mi {r['mi']}  "
                      f"tiles {r['tiles']}")
            results[label] = {"plan": [chosen.th, chosen.tw], "tiles": rows}
    finally:
        tc_conv.dc_plan = plan_fn
    if args.json:
        args.json.write_text(json.dumps(results))
    return 0


if __name__ == "__main__":
    sys.exit(main())
