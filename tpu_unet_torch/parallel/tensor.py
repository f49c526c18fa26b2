"""Tensor (channel) parallelism: the ``'model'`` axis of the grid
(``tpu_unet/parallel/tensor.py``).

Every DoubleConv is sharded Megatron-style, a column layer then a row
layer: ``conv1.w`` [3,3,Cin,Cmid] on Cout (its BN1 γ/β and running
statistics with its channels), ``conv2.w`` [3,3,Cmid,Cout] on Cin, BN2
replicated. R2U-Net's and R2AttU-Net's RRCNN blocks map the pair onto their
two weight-shared recurrent units: ``rec1`` on Cout, ``rec2`` on Cin, in
either BN layout (``bn`` or ``bn0..bnt``). The ConvTranspose upsamplers, the
1x1 heads, the attention gates and RRCNN's ``proj`` stay replicated, and so
does any block whose Cmid the model size does not divide. Each rank of a
``parallel.mesh.Grid``'s model group holds its contiguous slice of every
sharded leaf, slice m of T on rank m, and the optimizer state mirrors the
params (Adam's scalar ``step`` replicated), so the update is shard-local.

JAX states the pairing as two weight shardings and GSPMD derives the
collectives; the port writes them as ``torch.autograd.Function``s
(``parallel/collectives.py``). A sharded DoubleConv runs copy → conv1 on
its Cout shard → BN1 on those channels → ReLU → conv2 on its Cin shard →
reduce → BN2 (``models/unet.py``): one all-reduce forward and one backward
a block. The recurrent units,
weight-shared over t+1 applications, take their collectives per application
(``models/r2u_unet.py``): ``rec1`` gathers ``h`` before each re-application
on ``x + h``; ``rec2`` adds its residual's slice of this rank's channels
(``take_shard``: a copy then the slice, whose backward gathers the slices)
and reduces once per application.

The loss is replicated over the model ranks, so each holds the full
gradient of every replicated leaf and the gradient of its own shards; the
gradients are then averaged over the replica group, the global norm counts
each sharded leaf once (``optim.rmsprop.clip_grad_norm``), and each rank
updates its own shards. Results match the one-process step to round-off:
the sharded contraction sums Cmid in another order.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.distributed as dist

from tpu_unet_torch.models.unet import UNetConfig, init_unet, tree_leaves, tree_map
from tpu_unet_torch.ops.batchnorm import BNState
from tpu_unet_torch.parallel.collectives import is_double_conv, is_rrcnn

def _replicated(tree):
    """A dims tree like ``tree`` with every leaf None (replicated)."""
    return tree_map(lambda _: None, tree)


def unet_param_specs(params, tp: int):
    """The dim each leaf of ``params`` (full shapes) shards on over the model
    axis, or None: a tree like ``params``, leaf for leaf JAX's
    ``PartitionSpec``s (module docstring). A block whose Cmid ``tp`` does
    not divide stays replicated."""

    def walk(node):
        if is_double_conv(node):
            specs = _replicated(node)
            if node["conv1"]["w"].shape[3] % tp == 0:
                specs["conv1"]["w"], specs["conv2"]["w"] = 3, 2
                specs["bn1"]["scale"] = specs["bn1"]["bias"] = 0
            return specs
        if is_rrcnn(node):
            specs = _replicated(node)
            if node["rec1"]["conv"]["w"].shape[3] % tp == 0:
                specs["rec1"]["conv"]["w"], specs["rec2"]["conv"]["w"] = 3, 2
                specs["rec1"]["bn"]["scale"] = specs["rec1"]["bn"]["bias"] = 0
            return specs
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        return None

    return walk(params)


def unet_state_specs(state, tp: int):
    """The dims of the BN running-statistics tree (full shapes): BN1 with its
    channels, every ``rec1`` statistics tree of an RRCNN block likewise, the
    rest replicated; per block, as ``unet_param_specs`` decides it."""

    def walk(node):
        if (isinstance(node, dict) and {"bn1", "bn2"} <= set(node.keys())
                and isinstance(node["bn1"], BNState)):
            specs = {k: walk(v) for k, v in node.items()}
            d = 0 if node["bn1"].mean.shape[0] % tp == 0 else None
            specs["bn1"], specs["bn2"] = BNState(d, d), BNState(None, None)
            return specs
        if (isinstance(node, dict) and {"rec1", "rec2"} <= set(node.keys())
                and isinstance(node["rec1"], dict)
                and any(isinstance(v, BNState) for v in node["rec1"].values())):
            specs = {k: walk(v) for k, v in node.items()}
            c = next(v for v in node["rec1"].values() if isinstance(v, BNState)).mean.shape[0]
            d = 0 if c % tp == 0 else None
            specs["rec1"] = {k: BNState(d, d) for k in node["rec1"]}
            specs["rec2"] = {k: BNState(None, None) for k in node["rec2"]}
            return specs
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        return _replicated(node)

    return walk(state)


@functools.lru_cache(maxsize=None)
def model_specs(config: UNetConfig, tp: int):
    """(param dims, state dims) of ``config``'s model at model size ``tp``,
    from its shapes alone (``init_unet`` on the meta device)."""
    params, state = init_unet(config, np.random.default_rng(0), device="meta")
    return unet_param_specs(params, tp), unet_state_specs(state, tp)


def _take(tree, dims, rank: int, size: int):
    def leaf(t, d):
        if d is None:
            return t
        n = t.shape[d] // size
        return t.narrow(d, rank * n, n).clone(memory_format=torch.contiguous_format)

    return tree_map(leaf, tree, dims)


def dims_in_order(tree, dims) -> list:
    """The dim of each leaf of ``tree`` in ``tree_leaves`` order, matched by
    key (a tree's keys may come in another order than ``dims``')."""
    out: list = []
    tree_map(lambda _, d: out.append(d), tree, dims)
    return out


def _gather(tree, dims, grid):
    """The full leaves of ``tree`` (this rank's shards): one all-gather of
    one flat bucket over the model group, each leaf concatenated along its
    dim in rank order; replicated leaves as they are."""
    leaves, ds = tree_leaves(tree), dims_in_order(tree, dims)
    sharded = [k for k, d in enumerate(ds) if d is not None]
    if not sharded:
        return tree
    dtype = torch.float32
    for k in sharded:
        dtype = torch.promote_types(dtype, leaves[k].dtype)
    flat = torch.cat([leaves[k].reshape(-1).to(dtype) for k in sharded])
    parts = [torch.empty_like(flat) for _ in range(grid.model_size)]
    dist.all_gather(parts, flat, group=grid.model_group)
    out, off = list(leaves), 0
    for k in sharded:
        t, n = leaves[k], leaves[k].numel()
        out[k] = torch.cat([p[off:off + n].view(t.shape) for p in parts], ds[k]).to(t.dtype)
        off += n
    it = iter(out)
    return tree_map(lambda _: next(it), tree)


def shard_model(grid, params, bn_state):
    """This rank's shards of the full (params, BN state) (JAX's
    ``shard_model``): the slice of its model coordinate of every sharded
    leaf, the replicated ones as they are."""
    tp = grid.model_size
    return (shard_params(grid, params),
            _take(bn_state, unet_state_specs(bn_state, tp), grid.model_rank, tp))


def shard_params(grid, params):
    """This rank's shards of a full params-shaped tree (the params, the
    EMA weights)."""
    tp = grid.model_size
    return _take(params, unet_param_specs(params, tp), grid.model_rank, tp)


def _field_dims(field, params_dims):
    """The dims of an optimizer-state field: the params' for a tree like
    the params (a dict, as JAX compares tree structures), else replicated
    (Adam's scalar ``step``)."""
    return params_dims if isinstance(field, dict) else _replicated(field)


def shard_opt_state(grid, opt_state, params):
    """This rank's shards of the full optimizer state (JAX's
    ``shard_opt_state``): a field that mirrors the full ``params`` is sliced
    like them, any other (Adam's scalar ``step``) replicated."""
    tp = grid.model_size
    dims = unet_param_specs(params, tp)
    return type(opt_state)(*(_take(f, _field_dims(f, dims), grid.model_rank, tp)
                             for f in opt_state))


def gather_model(grid, params, bn_state, config: UNetConfig, *more):
    """The full (params, BN state) on every rank of the model group (a
    collective over it) from this rank's shards, and after them the full
    leaves of each params-shaped tree of ``more`` (the EMA weights, the
    gradients; None stays None)."""
    pd, sd = model_specs(config, grid.model_size)
    return (_gather(params, pd, grid), _gather(bn_state, sd, grid),
            *(None if t is None else _gather(t, pd, grid) for t in more))


def gather_opt_state(grid, opt_state, config: UNetConfig):
    """The full optimizer state from this rank's shards (a collective): the
    fields shaped like the params gathered, the others as they are."""
    dims = model_specs(config, grid.model_size)[0]
    return type(opt_state)(*(_gather(f, _field_dims(f, dims), grid) for f in opt_state))
