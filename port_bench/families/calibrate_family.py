"""``calibrate.py`` for the cells whose traffic ``calibrate.py`` does not
read: the readings that their correctness limits are set between
(PERF.md gives them with each limit). For each seed, at the cell's own
sizes and with its own inputs, it reads the numbers of ``check.py`` for the
control (the reference computed in the precision below the cell's: fp8
convs for bf16, TF32 for fp32) and for the fault that leaves half of each
batch out, both planted in the reference:

- ``train_step_family``: the family's reference (``families/<arch>.py``),
  its weights and BN statistics drawn by its layout, with the first step's
  numbers (``families.first_step_numbers``) beside ``check.py``'s; on
  request also the program's own check steps, and the witnesses of the
  round-off that the gradients carry without a fault (the program in fp32,
  the reference on inputs one ulp off);
- ``train_step_dp``: ``calibrate.train_readings`` at the global batch, the
  batch that the data-parallel step's check compares.

    python3 port_bench/families/calibrate_family.py --workload <cell> --seeds 1,2,3 \
        [--program] [--witnesses] [--no-controls]
"""

from __future__ import annotations

import argparse
import json
import math
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))


def family_readings(cfg: dict, traffic: dict, seed: int, device, *, controls: bool = True,
                    program: bool = False, witnesses: bool = False) -> dict:
    """{reading: numbers} against the reference: ``control`` and
    ``half_batch``; with ``program``, the program's check steps as the cell
    runs them; with ``witnesses``, also the program in fp32 (``amp`` off,
    ``program_fp32``), the reference on inputs one ulp above (``ulp``) and,
    for a bf16 cell, the reference with bf16 convs (``bf16``): the gaps
    that round-off gives without a fault."""
    import gc

    import torch

    from port_bench import calibrate, check, families, inputs, reference
    from port_bench.program import train_size

    fam = families.module(cfg["model"]["arch"])
    lr = cfg["recipe"]["lr"]
    progs = {}
    runs = [("program", traffic["amp"])] if program or witnesses else []
    for name, amp in runs + ([("program_fp32", False)] if witnesses else []):
        progs[name] = _program_readings(cfg, {**traffic, "amp": amp}, seed, device)
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
    h, w = train_size(cfg)
    g = inputs.generator(seed, device)
    weights = fam.make_weights(cfg["model"], g, device)
    images, masks = inputs.train_pool(g, traffic["pool_batches"], traffic["batch"], h, w, device)
    batches = list(zip(images, masks))[: traffic["check_steps"]]
    del images, masks

    def steps(batches=batches, **kw):
        tf32 = kw.pop("tf32", False)
        with reference.precision(tf32=tf32):
            out = fam.train_steps(cfg["model"], weights,
                                  fam.initial_bn_state(cfg["model"], device), batches, lr=lr,
                                  **kw)
        return {k: out[k] for k in ("loss", "grad", "change", "bn1", "sq1")}

    def numbers(other, ref):
        return {**check.train_numbers(other, ref)["numbers"],
                **families.first_step_numbers(other, ref, initial)}

    initial = fam.initial_bn_state(cfg["model"], device)
    ref = steps()
    out = {name: numbers(p, ref) for name, p in progs.items()}
    if controls:
        quant, tf32 = calibrate._lower(traffic)
        out["control"] = numbers(steps(quant=quant, tf32=tf32), ref)
        out["half_batch"] = numbers(steps(half_batch=True), ref)
    if witnesses:
        up = [(torch.nextafter(x, torch.full_like(x, math.inf)), m) for x, m in batches]
        out["ulp"] = numbers(steps(up), ref)
        if traffic["amp"]:
            out["bf16"] = numbers(steps(quant=families.Bf16()), ref)
    return out


def _program_readings(cfg: dict, traffic: dict, seed: int, device) -> dict:
    """The program's readings of the cell's check steps
    (``generators/train_step_family.py``), from the seed's weights and pool."""
    from port_bench.generators import train_step_family as gen

    weights, images, masks, step, trees = gen.setup(cfg, traffic, seed, device,
                                                    cfg["kernels"]["train"])
    lr = cfg["recipe"]["lr"]

    def one(i, trees):
        out = step(*trees, images[i], masks[i], lr)
        return out[:3], out[3]

    return gen.check_steps(one, trees, traffic["check_steps"], weights)[1]


def readings(manifest, cell: str, seed: int, device, config_overrides=None,
             traffic_overrides=None, **family) -> dict:
    from port_bench import calibrate
    from port_bench.run import merged

    c = manifest.cell(cell)
    cfg = merged(manifest.config(c["config"]), config_overrides)
    traffic = merged(manifest.traffic(c["traffic"]), traffic_overrides)
    if traffic["kind"] == "train_step_family":
        return family_readings(cfg, traffic, seed, device, **family)
    if traffic["kind"] == "train_step_dp":
        return calibrate.train_readings(cfg, traffic, seed, device)
    raise ValueError(f"calibrate_family: traffic kind {traffic['kind']!r}; calibrate.py "
                     "reads the others")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--program", action="store_true",
                    help="train_step_family: the program's check steps too")
    ap.add_argument("--witnesses", action="store_true",
                    help="train_step_family: the program in fp32 and the reference one ulp "
                         "off too")
    ap.add_argument("--no-controls", action="store_true",
                    help="train_step_family: leave out the control and the half batch")
    args = ap.parse_args(argv)
    from port_bench.run import set_environment

    set_environment()
    import torch

    from port_bench.manifest import Manifest

    if not torch.cuda.is_available():
        print("calibrate_family: no CUDA device", file=sys.stderr)
        return 2
    manifest = Manifest(ROOT)
    for seed in (int(s) for s in args.seeds.split(",")):
        family = ({"program": args.program, "witnesses": args.witnesses,
                   "controls": not args.no_controls}
                  if manifest.traffic(manifest.cell(args.workload)["traffic"])["kind"]
                  == "train_step_family" else {})
        out = readings(manifest, args.workload, seed, torch.device("cuda", 0), **family)
        print(json.dumps({"workload": args.workload, "seed": seed, **out}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
