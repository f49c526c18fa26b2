"""Data parallelism over ``torch.distributed``: the 1-D part of
``tpu_unet/parallel/mesh.py`` (``make_mesh``, ``batch_sharding``,
``replicated``).

The JAX package's data parallelism is global-batch: a data-parallel step
equals the single-device step at the same global batch, BatchNorm's
statistics and the Dice ratio included (not torch-DDP's per-replica BN).
PyTorch has no GSPMD, so the port makes every collective explicit, as
JAX's ``shard_map`` route does: each BN's ``[2, C]`` sums and the Dice sums
are all-reduced inside autograd (``psum``; its backward is another
all-reduce, JAX's psum transpose), the CE mean is averaged over the ranks,
and the gradients of the replicated loss are averaged once a step
(``pmean``).

One process per GPU, launched by ``torchrun``. A ``DataParallel`` record
stands where JAX's ``('data',)`` mesh stands; its ``group`` is the port's
counterpart of JAX's ``axis_name`` wherever a function takes one (None:
no collective). Rank r holds the contiguous rows ``[r·B/W, (r+1)·B/W)`` of
a global batch of B (``rows``: JAX's ``P("data")``); the trees are
replicated by one broadcast from rank 0 (``broadcast_tree``).

A world may span hosts (``multihost``; ``parallel/multihost.py`` forms it
from explicit flags or torchrun's env). ``make_mesh_2d`` and
``image_sharding`` (spatial parallelism) are not ported yet.
"""

from __future__ import annotations

import logging
import os
from dataclasses import dataclass
from datetime import timedelta

import torch
import torch.distributed as dist

_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE")


class DataParallelRefused(RuntimeError):
    """A data-parallel launch with no rank to take (not under torchrun, and
    no explicit rendezvous). The CLIs exit with its message."""


@dataclass(frozen=True)
class DataParallel:
    """One rank's view of the data-parallel group: ``group`` carries the
    step's collectives on ``device``; ``host_group`` (gloo) carries the
    host's flags and barriers without waiting for the device. ``multihost``:
    the world spans more than one host (JAX's ``jax.process_count() > 1``),
    which selects the per-process loader, the scalars-only W&B panel and
    the refusals that key on it."""

    group: dist.ProcessGroup
    host_group: dist.ProcessGroup
    rank: int
    world_size: int
    device: torch.device
    multihost: bool = False

    @property
    def primary(self) -> bool:
        return self.rank == 0

    def rows(self, x):
        """This rank's contiguous rows of a global batch (a tensor or array
        whose leading dim the world size divides)."""
        n = x.shape[0]
        if n % self.world_size:
            raise ValueError(f"a global batch of {n} rows does not divide over "
                             f"{self.world_size} ranks")
        per = n // self.world_size
        return x[self.rank * per:(self.rank + 1) * per]

    def any(self, flag: bool) -> bool:
        """True on every rank when ``flag`` is true on any rank."""
        t = torch.tensor([int(flag)], dtype=torch.int32)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.host_group)
        return bool(t.item())

    def barrier(self) -> None:
        dist.barrier(group=self.host_group)


def _env_int(name: str) -> int | None:
    v = os.environ.get(name)
    return int(v) if v is not None else None


def init_data_parallel(backend: str | None = None, device=None, init_method: str | None = None,
                       *, rank: int | None = None, world_size: int | None = None,
                       timeout: timedelta | None = None) -> DataParallel:
    """Form the process group, or join the one this process has formed
    (``parallel.multihost.initialize``, or an earlier call), and return the
    rank's record.

    ``rank`` and ``world_size`` default to torchrun's ``RANK`` and
    ``WORLD_SIZE``, ``init_method`` to ``env://`` (torchrun's rendezvous).
    ``device`` None is ``cuda:LOCAL_RANK`` (raises without a GPU); the
    backend is NCCL on a CUDA device and gloo on the CPU unless ``backend``
    names one (gloo also carries CUDA tensors, e.g. two ranks on one card).
    A process with no rank to take raises ``DataParallelRefused``. Whether
    the world spans hosts is ``multihost.spans_hosts()``."""
    from tpu_unet_torch.parallel.multihost import spans_hosts  # it imports this module

    env = {k: _env_int(k) for k in _ENV}
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("data parallelism on cuda:LOCAL_RANK, but no CUDA device is "
                               "available (pass device='cpu' to run on the CPU)")
        device = f"cuda:{env['LOCAL_RANK'] or 0}"
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if not dist.is_initialized():
        rank = env["RANK"] if rank is None else rank
        world_size = env["WORLD_SIZE"] if world_size is None else world_size
        if rank is None or world_size is None:
            raise DataParallelRefused("data parallelism needs RANK and WORLD_SIZE: launch "
                                      "under torchrun (torchrun --nproc-per-node N -m ...)")
        kw = {"timeout": timeout} if timeout is not None else {}
        dist.init_process_group(backend or ("nccl" if device.type == "cuda" else "gloo"),
                                init_method=init_method or "env://", rank=rank,
                                world_size=world_size, **kw)
    group = dist.group.WORLD
    return DataParallel(group=group, host_group=dist.new_group(backend="gloo"),
                        rank=dist.get_rank(), world_size=dist.get_world_size(), device=device,
                        multihost=spans_hosts())


def cli_data_parallel(device: str, prog: str) -> tuple[DataParallel, bool]:
    """The CLIs' ``--data-parallel``: the rank's record (``device`` 'cuda' is
    ``cuda:LOCAL_RANK``) and whether this call formed the process group (the
    CLI then destroys it). A process with no rank to take exits with its
    refusal; ranks other than 0 log warnings only."""
    formed = not dist.is_initialized()
    try:
        dp = init_data_parallel(device=None if device == "cuda" else device)
    except DataParallelRefused as e:
        raise SystemExit(f"{prog}: {e}") from None
    if not dp.primary:
        logging.getLogger().setLevel(logging.WARNING)
    return dp, formed


def group_size(group) -> int:
    """The number of ranks of ``group``; 1 for None (no data parallelism)."""
    return 1 if group is None else dist.get_world_size(group)


class _PSum(torch.autograd.Function):
    """All-reduce (sum) whose backward all-reduces the cotangent."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        out = t.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        return g, None


def psum(t: torch.Tensor, group) -> torch.Tensor:
    """Σ over the ranks of ``group``, inside autograd (its backward sums the
    cotangents over the ranks: JAX's ``lax.psum`` and its transpose); ``t``
    itself when ``group`` is None."""
    return t if group is None else _PSum.apply(t, group)


def pmean(tensors: list[torch.Tensor], group) -> list[torch.Tensor]:
    """The mean over the ranks of each tensor (no autograd): one all-reduce
    of one flat bucket (fp32, or the widest float dtype of ``tensors``),
    divided by the world size. Returns new tensors in the inputs' shapes
    and dtypes."""
    dtype = torch.float32
    for t in tensors:
        dtype = torch.promote_types(dtype, t.dtype)
    flat = torch.cat([t.detach().reshape(-1).to(dtype) for t in tensors])
    dist.all_reduce(flat, group=group)
    flat /= group_size(group)
    return [c.view(t.shape).to(t.dtype)
            for c, t in zip(flat.split([t.numel() for t in tensors]), tensors)]


def broadcast_tree(tree, dp: DataParallel):
    """Rank 0's copy of every tensor of ``tree`` (params, BN state,
    optimizer state), on every rank: JAX's ``replicated`` placement."""
    from tpu_unet_torch.models.unet import tree_map  # models import this module's users

    def one(t: torch.Tensor) -> torch.Tensor:
        t = t.detach().clone().contiguous()
        dist.broadcast(t, src=0, group=dp.group)
        return t

    return tree_map(one, tree)
