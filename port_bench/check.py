"""The numbers that decide ``correct``, each against its limit
(``limits/<cell>.json``; PERF.md gives the readings each was set from).

Training (the first steps of the timed step, against ``reference.train_steps``):
- ``loss_gap``: the largest |program − reference| / |reference| of a step's
  loss;
- ``grad_gap``: of the first gradient as RMSprop takes it, read from its
  square average after step 1, by the worst leaf: |‖g‖ program − ‖g‖
  reference| over the larger of the reference leaf's norm and the median
  leaf's;
- ``update_gap``: the same of each leaf's change after the steps, over the
  leaves whose reference gradient is at least a thousandth of the median
  leaf's (smaller ones move under RMSprop by round-off alone);
- ``update_median_gap``: the median leaf's gap of the change, steady where
  one small ill-conditioned leaf sets the worst (the clip ties every
  leaf's gradient to the total norm, so a median of gradients is not).

A cell compares the numbers that its limits file names (PERF.md says why).

Serving: ``mask_gap``, the widest gap by which a served pixel's class lies
below the reference's best: the reference logit z of a pixel served as car
where z < 0 (|z|), or served as background where z > 0 (z).
"""

from __future__ import annotations

import math
import statistics

QUIET_GRAD = 1e-3  # a leaf whose gradient is under this share of the median's


def _worst(gaps: dict) -> tuple[float, str]:
    """The largest gap and its key; a gap that is not finite is infinite
    (``max`` would pass over a NaN)."""
    for k, v in gaps.items():
        if not math.isfinite(v):
            return math.inf, k
    worst = max(gaps, key=gaps.get)
    return gaps[worst], worst


def _leaf_gaps(prog: dict, ref: dict, leaves) -> dict:
    med = statistics.median(ref[k] for k in leaves)
    return {k: abs(prog[k] - ref[k]) / max(ref[k], med) for k in leaves}


def train_numbers(prog: dict, ref: dict) -> dict:
    """``prog`` and ``ref``: {"loss": [..], "grad": {leaf: norm}, "change":
    {leaf: norm}}, the same leaves on both sides."""
    if set(prog["grad"]) != set(ref["grad"]) or len(prog["loss"]) != len(ref["loss"]):
        raise ValueError("program and reference readings cover different leaves or steps")
    losses = {k: abs(a - b) / abs(b) for k, (a, b) in enumerate(zip(prog["loss"], ref["loss"]))}
    loss_gap, _ = _worst(losses)
    grads = _leaf_gaps(prog["grad"], ref["grad"], list(ref["grad"]))
    grad_gap, grad_leaf = _worst(grads)
    med = statistics.median(ref["grad"].values())
    moving = [k for k, v in ref["grad"].items() if v >= QUIET_GRAD * med]
    updates = _leaf_gaps(prog["change"], ref["change"], moving)
    update_gap, update_leaf = _worst(updates)
    numbers = {"loss_gap": loss_gap, "grad_gap": grad_gap, "update_gap": update_gap,
               "update_median_gap": _median(updates)}
    return {"numbers": numbers, "worst": {"grad_gap": grad_leaf, "update_gap": update_leaf},
            "quiet_leaves": sorted(set(ref["grad"]) - set(moving))}


def _median(gaps: dict) -> float:
    vals = list(gaps.values())
    return math.inf if not all(map(math.isfinite, vals)) else statistics.median(vals)


def mask_gap(served, z) -> float:
    """Widest gap of one served mask (bool [H, W], numpy or torch) against
    the reference logits z [H, W] (torch)."""
    import torch

    m = torch.as_tensor(served, device=z.device)
    return float(torch.where(m, torch.relu(-z), torch.relu(z)).max())


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(every number within its limit, {name: {"value", "limit"}})."""
    missing = set(limits) - set(numbers)
    if missing:
        raise ValueError(f"no reading for the limits {sorted(missing)}")
    table = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    return all(v["value"] <= v["limit"] for v in table.values()), table
