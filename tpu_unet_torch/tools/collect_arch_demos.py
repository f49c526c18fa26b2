"""Gather the port's per-family convergence demos into one file
(``tools/collect_arch_demos.py``).

``python -m tpu_unet_torch.tools.train_demo --preset arch --arch <fam>
--out demo_runs/torch_arch_<fam>.json`` writes one record per family; this
tool reads every ``torch_arch_*.json`` of ``--runs`` whose preset is
``arch``, keeps the JAX tool's fields, writes them by family to ``--out``
(``ARCH_DEMOS_TORCH.json``: ``ARCH_DEMOS.json`` is the JAX package's
record) and prints each family's suggested floors, the measured Dice less
``--margin``.

Run: ``python -m tpu_unet_torch.tools.collect_arch_demos [--runs demo_runs]
[--out ARCH_DEMOS_TORCH.json] [--margin 0.02]``
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

FIELDS = (
    "final_val_dice", "final_val_iou", "heldout_dice", "heldout_iou",
    "heldout_dice_tta", "heldout_dice_tta_hflip", "first_loss", "last_loss",
    "steps", "lr", "epochs", "heldout_n", "train_wall_s", "device",
    "dice_floor", "heldout_floor", "passed",
)


def collect(runs: Path) -> dict[str, dict]:
    """{arch: its record's FIELDS} of the ``torch_arch_*.json`` under ``runs``."""
    demos = {}
    for path in sorted(runs.glob("torch_arch_*.json")):
        rec = json.loads(path.read_text())
        if rec.get("preset") == "arch":
            demos[rec["arch"]] = {k: rec[k] for k in FIELDS if k in rec}
    return demos


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--runs", type=Path, default=Path("demo_runs"))
    ap.add_argument("--out", type=Path, default=Path("ARCH_DEMOS_TORCH.json"))
    ap.add_argument("--margin", type=float, default=0.02,
                    help="Floor suggestion = measured Dice - margin (headroom for "
                         "run-to-run noise)")
    args = ap.parse_args(argv)
    demos = collect(args.runs)
    if not demos:
        raise SystemExit(f"no torch_arch_*.json demos under {args.runs}")
    args.out.write_text(json.dumps(demos, indent=2) + "\n")
    print(f"wrote {args.out} ({len(demos)} families)")
    for arch, rec in demos.items():
        v = rec["final_val_dice"] - args.margin
        h = rec["heldout_dice"] - args.margin
        print(f"  {arch:10s} val {rec['final_val_dice']:.4f} "
              f"heldout {rec['heldout_dice']:.4f}  "
              f"-> suggested floors ({v:.3f}, {h:.3f})")


if __name__ == "__main__":
    main()
