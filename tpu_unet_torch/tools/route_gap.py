"""The held-out gap between the train routes, over id orders
(``tools/route_gap.py``).

Runs ``tools/train_demo.py::run`` (the quality gate's run: the preset's
data, seeded weights, deterministic algorithms) for each ``--id-seed``
order on each route asked for, writes each run's result as one JSON into
``--out-dir``, and a summary: for each route, its held-out and validation
Dice minus the ``kernels=None`` run's of the same order (over every run of
the preset that ``--out-dir`` holds), the mean of those paired gaps, their
standard error, the 95% interval (Student's t), and how many orders have the
route below.

The routes: ``torch`` (``kernels=None``, the library convs), ``cuda`` (the
hand-written train kernels), and ``cuda`` with one of the three train
kernels swapped for its plain PyTorch version (``--plain fwd|dx|dw``): the
swap goes in at the names ``ops/conv_stats.py`` imported, for that run only,
and names the kernel whose rounding moves the gap if it closes it.
``--determinism on off`` also runs each order without deterministic
algorithms (cuDNN's default algorithms), to measure their spread.

It is a tool: nothing on the main path reads its options.

Run (on a GPU; about 30 s a run at the arch preset, 150 s at carvana):
    python -m tpu_unet_torch.tools.route_gap --preset arch --orders 10 \
        [--kernels torch cuda] [--plain fwd dx dw] [--out-dir demo_runs/route_gap]
    python -m tpu_unet_torch.tools.route_gap --preset carvana --orders 3 --kernels torch \
        --determinism on off
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import statistics
import tempfile
from pathlib import Path

from tpu_unet_torch.tools import train_demo

PLAIN = {"fwd": "conv3x3_fwd", "dx": "conv3x3_dx", "dw": "conv3x3_dw"}
# Student's t at 0.975 for 1-30 degrees of freedom; 1.96 past them.
T975 = (12.706, 4.303, 3.182, 2.776, 2.571, 2.447, 2.365, 2.306, 2.262, 2.228, 2.201, 2.179,
        2.160, 2.145, 2.131, 2.120, 2.110, 2.101, 2.093, 2.086, 2.080, 2.074, 2.069, 2.064,
        2.060, 2.056, 2.052, 2.048, 2.045, 2.042)


@contextlib.contextmanager
def plain_kernel(which: str | None):
    """``ops/conv_stats.py``'s name of the train kernel ``which`` (a key of
    ``PLAIN``) bound to its plain version inside the block, and restored on
    exit; no swap for None."""
    if which is None:
        yield
        return
    from tpu_unet_torch.kernels import train_conv
    from tpu_unet_torch.ops import conv_stats

    name = PLAIN[which]
    kept = getattr(conv_stats, name)
    setattr(conv_stats, name, getattr(train_conv, f"{name}_plain"))
    try:
        yield
    finally:
        setattr(conv_stats, name, kept)


def route_name(kernels: str | None, plain: str | None, deterministic: bool) -> str:
    name = kernels or "torch"
    if plain:
        name += f"+plain_{plain}"
    return name if deterministic else f"{name}+nondeterministic"


def run_route(preset: str, id_seed: int, data_dir: Path, kernels: str | None = None,
              plain: str | None = None, deterministic: bool = True, device: str = "cuda",
              arch: str = "unet") -> dict:
    """One gate run on one route: ``train_demo.run``'s result with the route
    and the order added."""
    if plain is not None and kernels != "cuda":
        raise ValueError("--plain swaps a kernel of the cuda route")
    with plain_kernel(plain):
        result = train_demo.run(preset, data_dir=data_dir, arch=arch, kernels=kernels,
                                device=device, id_seed=id_seed, deterministic=deterministic)
    return {**result, "route": route_name(kernels, plain, deterministic), "id_seed": id_seed,
            "kernels": kernels, "plain_kernel": plain, "deterministic": deterministic}


def paired(runs: list[dict], key: str, base: str = "torch") -> dict[str, dict]:
    """Each route's ``key`` minus the ``base`` route's on the same order:
    the gaps by order, their mean, standard error, 95% interval and the
    count of orders below the base."""
    by = {}
    for r in runs:
        by.setdefault(r["route"], {})[r["id_seed"]] = r[key]
    out = {}
    for route, vals in by.items():
        if route == base:
            continue
        gaps = {s: v - by.get(base, {})[s] for s, v in vals.items() if s in by.get(base, {})}
        n = len(gaps)
        if not n:
            continue
        mean = statistics.fmean(gaps.values())
        se = statistics.stdev(gaps.values()) / math.sqrt(n) if n > 1 else math.nan
        t = T975[n - 2] if 2 <= n <= len(T975) + 1 else 1.96
        out[route] = {"n": n, "mean": mean, "se": se, "ci95": [mean - t * se, mean + t * se],
                      "below": sum(g < 0 for g in gaps.values()),
                      "gaps": {str(s): g for s, g in sorted(gaps.items())}}
    return out


def summarize(runs: list[dict]) -> dict:
    """The paired held-out and validation gaps against ``kernels=None``
    (deterministic), and each route's held-out Dice under its floor."""
    return {"heldout_dice": paired(runs, "heldout_dice"),
            "final_val_dice": paired(runs, "final_val_dice"),
            "below_floor": {route: sum(not r["passed"] for r in runs if r["route"] == route)
                            for route in sorted({r["route"] for r in runs})},
            "runs": len(runs)}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--preset", choices=list(train_demo.PRESETS), default="arch")
    ap.add_argument("--arch", choices=list(train_demo.ARCH_FLOORS), default="unet")
    ap.add_argument("--orders", type=int, default=10, help="Orders: id seeds first..first+N-1")
    ap.add_argument("--first", type=int, default=0, help="The first id seed")
    ap.add_argument("--kernels", nargs="*", choices=("torch", "cuda"), default=["torch", "cuda"])
    ap.add_argument("--plain", nargs="*", choices=list(PLAIN), default=[],
                    help="Also run the cuda route with this train kernel's plain version")
    ap.add_argument("--determinism", nargs="+", choices=("on", "off"), default=["on"],
                    help="off: also run without deterministic algorithms")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out-dir", default="demo_runs/route_gap")
    args = ap.parse_args(argv)
    out = Path(args.out_dir)
    out.mkdir(parents=True, exist_ok=True)
    routes = [(None if k == "torch" else k, None, d == "on")
              for k in args.kernels for d in args.determinism]
    routes += [("cuda", p, True) for p in args.plain]
    with tempfile.TemporaryDirectory() as tmp:
        for seed in range(args.first, args.first + args.orders):
            for kernels, plain, det in routes:
                r = run_route(args.preset, seed, Path(tmp), kernels, plain, det, args.device,
                              args.arch)
                (out / f"{args.preset}_{args.arch}_{r['route']}_id{seed}.json").write_text(
                    json.dumps(r, indent=2))
                print(json.dumps({k: r[k] for k in ("route", "id_seed", "final_val_dice",
                                                    "heldout_dice", "train_wall_s", "passed")}),
                      flush=True)
    summary = summarize([json.loads(f.read_text())
                         for f in sorted(out.glob(f"{args.preset}_{args.arch}_*_id*.json"))])
    (out / f"summary_{args.preset}_{args.arch}.json").write_text(json.dumps(summary, indent=2))
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
