"""ZeRO-1: the optimizer state sharded over the data-parallel ranks
(``tpu_unet/parallel/zero.py``).

Under plain data parallelism every rank holds the whole fp32 optimizer
state (RMSprop's two trees: 2 x 124 MB for the 31.0M U-Net). ZeRO-1 keeps
on each of W ranks only its 1/W slice of every state leaf; params and
gradients stay replicated, so the forward and backward are untouched.

JAX places the state sharded and lets GSPMD partition the update. The
port's optimizers are functional state trees (``optim/``), so the step
(``train.make_train_step(opt_shardings=)``) makes the collectives explicit:

  1. the gradients are averaged over the ranks and clipped over the full
     tree, as in the plain data-parallel step;
  2. each rank updates only its slice of the params and of the state;
  3. one all-gather of one flat bucket rebuilds the full params on every
     rank.

The update is elementwise and its inputs are the plain step's, so the ZeRO
step is bitwise the plain data-parallel step (JAX's GSPMD version matches
it to round-off: its reduce-scatter regroups the gradient sums).

Sharding rule per leaf (JAX's): the LAST dimension that W divides is cut
into W contiguous slices, rank r holding slice r; a leaf with no such
dimension (e.g. the head's ``[n_classes]`` bias) is replicated, each rank
updating all of it. A state field that mirrors the params tree is sliced
leaf by leaf; any other field (Adam's scalar ``step``) is replicated.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch
import torch.distributed as dist

from tpu_unet_torch.models.unet import tree_leaves, tree_map


def zero_state_specs(params, n: int):
    """A tree like ``params`` of each leaf's shard dimension: the last one
    that ``n`` divides, or None (replicated). JAX's ``zero_state_specs``,
    the dimension where JAX writes a ``PartitionSpec``."""

    def leaf(p):
        for d in reversed(range(p.ndim)):
            if p.shape[d] % n == 0:
                return d
        return None

    return _map_params(leaf, params)


def _map_params(fn, tree, *rest):
    """``tree_map`` that also maps a leaf to None (a replicated dim)."""
    if isinstance(tree, dict):
        return {k: _map_params(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


def _mirrors(tree, params) -> bool:
    """True when ``tree`` has the params tree's structure (dicts of the same
    keys down to the leaves)."""
    if isinstance(params, dict):
        return (isinstance(tree, dict) and tree.keys() == params.keys()
                and all(_mirrors(tree[k], params[k]) for k in params))
    return isinstance(tree, torch.Tensor) and tree.shape == params.shape


@dataclass(frozen=True)
class ZeroShardings:
    """The port's ``opt_shardings``: each param leaf's shard dimension
    (``dims``, a tree like the params), which state fields mirror the params
    (``fields``), and the group whose ranks hold the slices."""

    dims: Any
    fields: tuple[bool, ...]
    rank: int
    world_size: int
    group: Any

    def shard(self, tree):
        """This rank's slice of each leaf of a params-shaped tree (views)."""
        r, w = self.rank, self.world_size

        def leaf(t, d):
            if d is None:
                return t
            n = t.shape[d] // w
            return t.narrow(d, r * n, n)

        return _map_params(leaf, tree, self.dims)

    def gather(self, tree):
        """The full leaves of a params-shaped tree of this rank's slices, on
        every rank: one all-gather of one flat bucket (the widest float dtype
        of the leaves), each leaf rebuilt by concatenating the ranks' slices
        in rank order along its shard dimension. Replicated leaves are this
        rank's own."""
        leaves, dims = tree_leaves(tree), _dims_list(self.dims)
        sharded = [k for k, d in enumerate(dims) if d is not None]
        if not sharded:
            return tree
        dtype = torch.float32
        for k in sharded:
            dtype = torch.promote_types(dtype, leaves[k].dtype)
        flat = torch.cat([leaves[k].reshape(-1).to(dtype) for k in sharded])
        parts = [torch.empty_like(flat) for _ in range(self.world_size)]
        dist.all_gather(parts, flat, group=self.group)
        out = list(leaves)
        off = 0
        for k in sharded:
            t, n = leaves[k], leaves[k].numel()
            out[k] = torch.cat([p[off:off + n].view(t.shape) for p in parts],
                               dim=dims[k]).to(t.dtype)
            off += n
        it = iter(out)
        return tree_map(lambda _: next(it), tree)


def _dims_list(dims) -> list:
    if isinstance(dims, dict):
        return [d for v in dims.values() for d in _dims_list(v)]
    return [dims]


def zero_opt_shardings(dp, opt_state, params) -> ZeroShardings:
    """The ZeRO record of ``opt_state`` over the ranks of ``dp`` (a
    ``parallel.mesh.DataParallel``): the fields shaped like ``params`` are
    sliced, the others replicated."""
    return ZeroShardings(dims=zero_state_specs(params, dp.world_size),
                         fields=tuple(_mirrors(f, params) for f in opt_state),
                         rank=dp.rank, world_size=dp.world_size, group=dp.group)


def shard_opt_state_zero(dp, opt_state, params):
    """The state with this rank's slice (a contiguous copy: the other ranks'
    slices are freed) of each leaf of each params-shaped field; 1/W of the
    divisible leaves on each rank."""
    sh = zero_opt_shardings(dp, opt_state, params)
    return type(opt_state)(*(
        tree_map(lambda t: t.clone(memory_format=torch.contiguous_format), sh.shard(f)) if m
        else f for f, m in zip(opt_state, sh.fields)))


def gather_opt_state_zero(opt_state, shardings: ZeroShardings):
    """The full state on every rank (a collective: every rank calls it),
    e.g. for a checkpoint; it equals the replicated state."""
    return type(opt_state)(*(shardings.gather(f) if m else f
                             for f, m in zip(opt_state, shardings.fields)))


def state_bytes(opt_state) -> int:
    """The bytes of the optimizer state this rank holds."""
    return sum(t.numel() * t.element_size() for t in tree_leaves(opt_state))
