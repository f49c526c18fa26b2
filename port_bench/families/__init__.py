"""Model families beyond ``reference.py``'s U-Net and Attention U-Net, one
module a family (``families/<arch>.py``, named by the configuration's
``model.arch``), each with what the benchmark needs of it: the parameter
layout, the weights and BN statistics drawn from the seed, the plain
reference and its train steps, and the FLOP and byte counts. Here beside
them: the first check step's numbers that a family cell compares, and bf16
convs in the reference's ``Quant`` form, one of the calibration's witnesses.
Like the rest of the benchmark, nothing here imports the program or JAX.
"""

from __future__ import annotations

import importlib
import statistics

import torch


def module(arch: str):
    """``families/<arch>.py``; raises ModuleNotFoundError for a family the
    benchmark has no module for."""
    return importlib.import_module(f"{__name__}.{arch}")


def of_readings(r: dict):
    """The family module of a train run's readings, or None (another kind
    of run, or an arch without a module)."""
    if r.get("kind") != "train":
        return None
    try:
        return module(r["config"]["model"]["arch"])
    except ModuleNotFoundError:
        return None


def state_by_path(tree, prefix: str = "") -> dict:
    """{path: tensor} of a tree of dicts and NamedTuples (the program's BN
    state: ``inc/rec1/bn0/mean``)."""
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items()
                for k, v in state_by_path(sub, f"{prefix}{key}/").items()}
    if isinstance(tree, tuple):
        return {k: v for f, sub in zip(tree._fields, tree)
                for k, v in state_by_path(sub, f"{prefix}{f}/").items()}
    return {prefix[:-1]: tree}


def first_step_numbers(prog: dict, ref: dict, initial: dict) -> dict:
    """The numbers of the first check step alone, before RMSprop's first
    update turns rounding-level gradient differences into parameter moves
    of lr / sqrt(1 − α) (PERF.md says why the family cells need them):

    - ``loss1_gap``: |program − reference| / |reference| of the first loss;
    - ``bn1_gap``: the median, over every running mean and variance, of
      ‖Δ program − Δ reference‖ / ‖Δ reference‖, Δ the statistic's move
      from ``initial`` in the first step (momentum times the batch's
      statistic less the initial one).

    - ``grad1_dir_gap``: the median, over the leaves, of ‖â program − â
      reference‖, â the leaf's first gradient as RMSprop takes it, by
      element in magnitude (the square root of its square average), over
      its norm. The direction alone: the clip scales every leaf by the
      total norm, so that one leaf's gap moves every leaf's norm
      (``check.py``'s ``grad_gap`` reads norms), not their directions.

    ``prog`` and ``ref`` carry ``loss``, ``bn1`` ({path: tensor}, the
    statistics after the first step) and ``sq1`` ({path: tensor}, each
    leaf's square average after the first step)."""
    gaps = []
    for path, r in ref["bn1"].items():
        d_ref = r.float() - initial[path].float()
        d_prog = prog["bn1"][path].float() - initial[path].float()
        gaps.append((d_prog - d_ref).norm() / d_ref.norm().clamp_min(1e-30))
    dirs = [_direction(prog["sq1"][path]).sub_(_direction(r)).norm()
            for path, r in ref["sq1"].items()]
    return {"loss1_gap": abs(prog["loss"][0] - ref["loss"][0]) / abs(ref["loss"][0]),
            "bn1_gap": statistics.median(torch.stack(gaps).tolist()),
            "grad1_dir_gap": statistics.median(torch.stack(dirs).tolist())}


def _direction(square_avg: torch.Tensor) -> torch.Tensor:
    """|g| over its norm, in float64, from a leaf's square average (a leaf
    with no gradient: zero, so that against one with a gradient it reads 1)."""
    a = square_avg.double().sqrt()
    return a / a.norm().clamp_min(1e-300)


class _Bf16Round(torch.autograd.Function):
    """A value rounded to bf16 and back, and its gradient too."""

    @staticmethod
    def forward(ctx, x):
        return x.to(torch.bfloat16).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return g.to(torch.bfloat16).to(g.dtype)


class Bf16:
    """bf16 convs as autocast runs them, in the reference's ``Quant`` form:
    the input, the weight and the output each rounded to bf16, forward and
    backward (the products are exact in fp32, the sums fp32)."""

    def inputs(self, *ts):
        return [_Bf16Round.apply(t) for t in ts]

    def output(self, y):
        return _Bf16Round.apply(y)
