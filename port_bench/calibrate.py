"""The readings that the correctness limits are set between (PERF.md gives
them with each limit). For each seed, at the cell's own sizes, with the
cell's own inputs, it reads the numbers of ``check.py`` for:

- the control: the reference put in the program's place, computed in the
  precision below the cell's (bf16 cells: fp8 convs, e4m3 forward and e5m2
  gradients; fp32 cells: TF32);
- training cells, the fault that leaves half of each batch out (the mean
  over the rest), planted in the reference. The fault that returns the
  state unchanged reads 1 on ``update_gap`` by the measure's definition and
  needs no run.

The program's own readings (the lower ones) are those its runs print.

    python3 port_bench/calibrate.py --workload <cell> --seeds 1,2,3
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if __name__ == "__main__":
    sys.path[0] = str(ROOT)


def _lower(traffic: dict):
    """(quant, tf32) of the precision below the traffic's."""
    from port_bench.reference import Quant

    return (Quant(), False) if traffic["amp"] else (None, True)


def train_readings(cfg: dict, traffic: dict, seed: int, device) -> dict:
    from port_bench import check, inputs, reference
    from port_bench.program import train_size

    h, w = train_size(cfg)
    g = inputs.generator(seed, device)
    weights = inputs.make_weights(cfg["model"], g, device)
    images, masks = inputs.train_pool(g, traffic["pool_batches"], traffic["batch"], h, w, device)
    batches = list(zip(images, masks))[: traffic["check_steps"]]
    del images, masks
    lr = cfg["recipe"]["lr"]

    def steps(**kw):
        tf32 = kw.pop("tf32", False)
        with reference.precision(tf32=tf32):
            return reference.train_steps(cfg["model"], weights,
                                         inputs.initial_bn_state(cfg["model"], device), batches,
                                         lr=lr, **kw)

    ref = steps()
    quant, tf32 = _lower(traffic)
    return {"control": check.train_numbers(steps(quant=quant, tf32=tf32), ref)["numbers"],
            "half_batch": check.train_numbers(steps(half_batch=True), ref)["numbers"]}


def serve_readings(cfg: dict, traffic: dict, seed: int, device) -> dict:
    """The control's widest gap over as many images as a run checks, drawn
    as a run draws its pool."""
    import torch
    from PIL import Image

    from port_bench import inputs, reference

    H, W, scale = cfg["image"]["height"], cfg["image"]["width"], cfg["image"]["scale"]
    h, w = int(scale * H), int(scale * W)
    g = inputs.generator(seed, device)
    weights = inputs.make_weights(cfg["model"], g, device)
    calib, _ = inputs.carvana_images(g, 2, h, w, device)
    with reference.precision(tf32=False):
        bn = reference.calibrated_bn_state(cfg["model"], weights, calib.float() / 255.0)
    u8, _ = inputs.carvana_images(g, traffic["pool_images"], H, W, device)
    images = [Image.fromarray(a, "RGB") for a in u8.cpu().numpy()]
    n = min(len(images), traffic["clients"] * traffic["sample_per_client"])
    quant, _ = _lower(traffic)
    gap = 0.0
    for s in range(0, n, 4):
        idx = list(range(s, min(n, s + 4)))
        z = reference.served_logits(cfg, weights, bn, images, idx, device, H, W, h, w)
        zc = reference.served_logits(cfg, weights, bn, images, idx, device, H, W, h, w, quant=quant)
        gap = max(gap, float(torch.where(zc > 0, torch.relu(-z), torch.relu(z)).max()))
    return {"control": {"mask_gap": gap}}


def readings(manifest, cell: str, seed: int, device, config_overrides=None,
             traffic_overrides=None) -> dict:
    from port_bench.run import merged

    c = manifest.cell(cell)
    cfg = merged(manifest.config(c["config"]), config_overrides)
    traffic = merged(manifest.traffic(c["traffic"]), traffic_overrides)
    fn = train_readings if traffic["kind"] == "train_step" else serve_readings
    return fn(cfg, traffic, seed, device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    args = ap.parse_args(argv)
    from port_bench.run import set_environment

    set_environment()
    import torch

    from port_bench.manifest import Manifest

    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    manifest = Manifest(ROOT)
    for seed in (int(s) for s in args.seeds.split(",")):
        out = readings(manifest, args.workload, seed, torch.device("cuda", 0))
        print(json.dumps({"workload": args.workload, "seed": seed, **out}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
