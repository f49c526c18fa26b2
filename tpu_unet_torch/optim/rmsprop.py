"""RMSprop and global-norm gradient clipping with torch's semantics
(``tpu_unet/optim/rmsprop.py``), as plain functions over the params dict.

The reference's ``RMSprop(lr, weight_decay=1e-8, momentum=0.999)`` with
alpha 0.99 and eps 1e-8, in torch's update order:

    g   = g + wd·p                     (weight decay folded into the grad)
    sq  = α·sq + (1−α)·g²
    buf = μ·buf + g / (sqrt(sq) + ε)   (ε outside the sqrt)
    p   = p − lr·buf

The learning rate is an argument of the update, not state. The state is
fp32 whatever the params' dtype.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch
import torch.distributed as dist

from tpu_unet_torch.models.unet import tree_leaves, tree_map


class RMSpropState(NamedTuple):
    square_avg: Any  # tree like params
    momentum_buf: Any  # tree like params


def rmsprop_init(params: Any) -> RMSpropState:
    def zeros(p):
        return torch.zeros_like(p, dtype=torch.float32)

    return RMSpropState(tree_map(zeros, params), tree_map(zeros, params))


def rmsprop_update(grads: Any, state: RMSpropState, params: Any, lr, *, alpha: float = 0.99,
                   eps: float = 1e-8, weight_decay: float = 1e-8,
                   momentum: float = 0.999) -> tuple[Any, RMSpropState]:
    """One RMSprop step. Returns (new_params, new_state); nothing is updated
    in place."""

    def leaf(p, g, sq, buf):
        g = g.float()
        pf = p.float()
        if weight_decay != 0:
            g = g + weight_decay * pf
        sq = alpha * sq + (1 - alpha) * (g * g)
        buf = momentum * buf + g / (torch.sqrt(sq) + eps)
        return (pf - lr * buf).to(p.dtype), sq, buf

    new = tree_map(leaf, params, grads, state.square_avg, state.momentum_buf)
    return pick(new, 0), RMSpropState(pick(new, 1), pick(new, 2))


def pick(tree, i):
    """The i-th element of each result tuple of a leaf function mapped over
    the params' dict tree."""
    return {k: pick(v, i) for k, v in tree.items()} if isinstance(tree, dict) else tree[i]


def clip_grad_norm(grads: Any, max_norm: float, *, sharded: list[bool] | None = None,
                   group=None) -> tuple[Any, torch.Tensor]:
    """``torch.nn.utils.clip_grad_norm_`` semantics: coef = max_norm /
    (total_norm + 1e-6), applied only when below 1. Returns (clipped grads,
    total norm).

    Under tensor parallelism ``grads`` are this rank's shards, ``sharded``
    says which leaves are (``tree_leaves`` order) and ``group`` is the model
    group: the squared sums of the sharded leaves are all-reduced over it
    and the replicated leaves' added once, so every rank holds the norm of
    the full gradient."""
    leaves = tree_leaves(grads)
    if group is None:
        total = torch.sqrt(sum((g.float() * g.float()).sum() for g in leaves))
    else:
        sq = [(g.float() * g.float()).sum() for g in leaves]
        zero = leaves[0].new_zeros((), dtype=torch.float32)
        mine = sum((q for q, f in zip(sq, sharded) if f), zero).reshape(1)
        dist.all_reduce(mine, group=group)
        total = torch.sqrt(sum((q for q, f in zip(sq, sharded) if not f), zero) + mine[0])
    return clip_to_norm(grads, total, max_norm), total


def clip_to_norm(grads: Any, total: torch.Tensor, max_norm: float) -> Any:
    """``grads`` scaled by coef = max_norm / (total + 1e-6) where that is
    below 1, ``total`` their global norm (``clip_grad_norm``'s rule, shared
    with the pipeline, which sums the norm over its stages)."""
    coef = torch.clamp(max_norm / (total + 1e-6), max=1.0)
    return tree_map(lambda g: (g.float() * coef).to(g.dtype), grads)
