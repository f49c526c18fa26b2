"""BatchNorm over NHWC with explicit running statistics
(``tpu_unet/ops/batchnorm.py``).

Parity target: ``torch.nn.BatchNorm2d(C)`` with eps 1e-5 and momentum 0.1,
computed as the JAX package computes it. Train mode takes one-pass fp32
sums, mean = Σx/n and var = max(Σx²/n − mean², 0), normalizes by that
biased variance and puts the unbiased variance var·n/(n−1) into the running
buffer. ``F.batch_norm`` is not used: its variance is two-pass. The serving
path folds BN into the conv instead (``models/infer.py``).

``group`` (data parallelism, ``parallel/mesh.py``; JAX's ``axis_name``)
all-reduces the two sums inside autograd and counts every rank's elements:
the statistics of the global batch, the between-rank term included. A
``parallel.halo.Band`` (spatial parallelism) all-reduces them over every
rank of its grid and counts the level's true global elements from its row
layout (``Band.elements``), which ``n·W`` is not where a level splits
unevenly.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from tpu_unet_torch.parallel.mesh import group_size, psum


class BNState(NamedTuple):
    """Running statistics for one BatchNorm layer. The field names are the
    checkpoint's keys (``state/inc/bn1/mean``)."""

    mean: torch.Tensor  # [C] float32
    var: torch.Tensor  # [C] float32


def init_bn_params(c: int, device=None) -> dict:
    return {"scale": torch.ones(c, device=device), "bias": torch.zeros(c, device=device)}


def init_bn_state(c: int, device=None) -> BNState:
    return BNState(mean=torch.zeros(c, device=device), var=torch.ones(c, device=device))


def update_running(state: BNState, mean: torch.Tensor, var: torch.Tensor, n: int,
                   momentum: float) -> BNState:
    """The running buffers after one train-mode batch of ``n`` elements per
    channel: momentum-weighted mean and UNBIASED variance. No gradient."""
    mean, var = mean.detach(), var.detach()
    unbiased = var * (n / max(n - 1, 1))
    return BNState(mean=(1 - momentum) * state.mean + momentum * mean,
                   var=(1 - momentum) * state.var + momentum * unbiased)


def batch_norm(x: torch.Tensor, params: dict, state: BNState, *, train: bool,
               momentum: float = 0.1, eps: float = 1e-5, group=None
               ) -> tuple[torch.Tensor, BNState]:
    """x: [N,H,W,C] -> (y in x's dtype, new state). Train mode normalizes by
    the batch statistics (over every rank of ``group``) and updates the
    running ones; eval mode uses the running ones and returns ``state``
    unchanged."""
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    if train:
        n = x.shape[0] * x.shape[1] * x.shape[2]
        s1, s2 = xf.sum((0, 1, 2)), (xf * xf).sum((0, 1, 2))
        if group is not None:
            s1, s2 = psum(torch.stack([s1, s2]), group).unbind(0)
            n = group.elements(x) if hasattr(group, "elements") else n * group_size(group)
        mean = s1 / n
        var = torch.clamp(s2 / n - mean * mean, min=0.0)
        new_state = update_running(state, mean, var, n, momentum)
    else:
        mean, var = state.mean, state.var
        new_state = state
    inv = torch.rsqrt(var + eps) * params["scale"].to(xf.dtype)
    shift = params["bias"].to(xf.dtype) - mean * inv
    return (xf * inv + shift).to(x.dtype), new_state
