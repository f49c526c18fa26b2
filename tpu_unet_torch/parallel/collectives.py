"""The model axis inside a block (``parallel/tensor.py`` shards the trees):
the mark ``unet_apply`` puts on each sharded block and the collectives the
block runs over the model group. It imports nothing of ``models``, so the
model files import it at the top.

PyTorch has no GSPMD, so the pairing JAX states as two weight shardings is
written as three ``torch.autograd.Function``s over the model group:

- ``copy_to_model``: identity forward; backward all-reduces the cotangent
  (each rank's column layer sees only its output channels);
- ``reduce_from_model``: all-reduce of the row layer's partial sums forward;
  identity backward;
- ``gather_from_model``: channel all-gather forward; backward returns this
  rank's slice of the cotangent summed over the group.

They run in fp32 (fp64 for fp64), which gloo carries for CUDA tensors too.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

_DC_KEYS = {"conv1", "bn1", "conv2", "bn2"}
_RRCNN_KEYS = {"proj", "rec1", "rec2"}


def is_double_conv(node) -> bool:
    return isinstance(node, dict) and _DC_KEYS <= set(node.keys())


def is_rrcnn(node) -> bool:
    return (isinstance(node, dict) and _RRCNN_KEYS <= set(node.keys())
            and isinstance(node.get("rec1"), dict) and "conv" in node["rec1"])


class ModelShard(dict):
    """A sharded block's params (a DoubleConv or an RRCNN block): the mark
    ``unet_apply`` puts on each, by which the block runs its collectives."""


def mark_shards(params, specs):
    """``params`` with every block that ``specs`` shards marked a
    ``ModelShard`` (the same tensors)."""

    def walk(node, spec):
        if is_double_conv(node) and spec["conv1"]["w"] is not None:
            return ModelShard(node)
        if is_rrcnn(node) and spec["rec1"]["conv"]["w"] is not None:
            return ModelShard(node)
        if isinstance(node, dict):
            return {k: walk(v, spec[k]) for k, v in node.items()}
        return node

    return walk(params, specs)


def model_axis_of(params, group):
    """``group`` (a grid, a ``Band`` or a ``ModelAxis``: its model group,
    size and rank) when ``params`` is a sharded block under a model axis;
    else None."""
    if isinstance(params, ModelShard) and getattr(group, "model_size", 1) > 1:
        return group
    return None


def _wide(t: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of ``t`` in fp32 (fp64 stays fp64), for a collective
    to write into: autograd may hand the same cotangent to another input."""
    return t.to(torch.promote_types(t.dtype, torch.float32), copy=True,
                memory_format=torch.contiguous_format)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        out = _wide(g)
        dist.all_reduce(out, group=ctx.group)
        return out.to(g.dtype), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        out = _wide(x)
        dist.all_reduce(out, group=group)
        return out.to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, size, rank):
        ctx.group, ctx.rank, ctx.c = group, rank, x.shape[-1]
        wide = _wide(x)
        parts = [torch.empty_like(wide) for _ in range(size)]
        dist.all_gather(parts, wide, group=group)
        return torch.cat(parts, -1).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        out = _wide(g)
        dist.all_reduce(out, group=ctx.group)
        return out.narrow(-1, ctx.rank * ctx.c, ctx.c).to(g.dtype), None, None, None


def copy_to_model(x: torch.Tensor, axis) -> torch.Tensor:
    """``x`` (replicated over the model group of ``axis``) entering column
    layers: identity; the cotangent is summed over the group."""
    return _CopyToModel.apply(x, axis.model_group)


def reduce_from_model(x: torch.Tensor, axis) -> torch.Tensor:
    """The sum over the model group of the row layers' partial outputs."""
    return _ReduceFromModel.apply(x, axis.model_group)


def gather_from_model(x: torch.Tensor, axis) -> torch.Tensor:
    """The full channels of a channel-sharded ``x`` [..., C/T], in rank
    order; the cotangent's slice of this rank, summed over the group."""
    return _GatherFromModel.apply(x, axis.model_group, axis.model_size, axis.model_rank)


def take_shard(x: torch.Tensor, axis) -> torch.Tensor:
    """This rank's channel slice of a replicated ``x`` [..., C]; its
    backward gathers every rank's slice of the cotangent."""
    c = x.shape[-1] // axis.model_size
    return copy_to_model(x, axis).narrow(-1, axis.model_rank * c, c)
