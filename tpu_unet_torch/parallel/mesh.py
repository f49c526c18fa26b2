"""Data and spatial parallelism over ``torch.distributed``
(``tpu_unet/parallel/mesh.py``: ``make_mesh``, ``batch_sharding``,
``replicated``, ``make_mesh_2d``, ``image_sharding``).

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
from explicit flags or torchrun's env).

Spatial parallelism (``make_grid``, JAX's ``make_mesh_2d``): the W ranks
form a (W/S) x S grid, rank r at data coordinate d = r // S and spatial
coordinate s = r % S, as JAX reshapes its devices. A ``Grid`` record holds
the ``'data'`` group (the ranks of this s), the ``'spatial'`` group (the
ranks of this d) and the world; rank r takes rows ``[d·B/D, (d+1)·B/D)`` of
a global batch and the height band ``[s·H/S, (s+1)·H/S)`` of each image
(``bands``: JAX's ``image_sharding``, ``P("data", "spatial")``). A grid
threads where ``group`` threads; each level's ``parallel.halo.Band`` carries
its row layout, and the ops exchange halo rows over the spatial group
(``parallel/halo.py``). The BN, Dice and CE sums go over the world, so the
step is still the one-process step at the same global batch.

Tensor parallelism (``make_grid(dp, spatial, model)``, JAX's
``make_mesh_3d``) adds a third, innermost axis: rank r sits at d = r //
(S·T), s = (r // T) % S, m = r % T, as JAX reshapes its devices to
``(-1, spatial, model)``. The T ranks of one (d, s) (the ``'model'`` group)
hold the same rows and band and each a channel shard of every sharded block
(``parallel/tensor.py``). Every sum over the batch (BN, Dice, CE, the
gradients' mean, ``psum``'s backward) then goes over the *replica* group,
the ranks of this m, which hold each sample once; summed over the world,
each sample would count T times. ``world_of`` gives that group. At T = 1
the grid is the (data x spatial) one, the replica group the world.
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

    # The data axis: all the ranks here; a ``Grid`` narrows it.
    @property
    def data_rank(self) -> int:
        return self.rank

    @property
    def data_size(self) -> int:
        return self.world_size

    @property
    def data_group(self):
        return self.group

    @property
    def spatial_size(self) -> int:
        return 1

    @property
    def shard(self) -> tuple[int, int]:
        """(data rank, data size): the rows a loader gives this rank."""
        return self.data_rank, self.data_size

    @property
    def band(self) -> tuple[int, int] | None:
        """(spatial rank, spatial size) of the height band a loader cuts,
        None without a spatial axis."""
        return None

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


@dataclass(frozen=True)
class ModelAxis:
    """The model group alone, for a forward that needs no other axis (an
    evaluation batch that runs whole on its rows): the ``group`` a block
    takes, with no band and no sums."""

    model_group: dist.ProcessGroup
    model_size: int
    model_rank: int
    spatial_size: int = 1


@dataclass(frozen=True)
class Grid(DataParallel):
    """One rank's view of the (data x spatial x model) grid (module
    docstring): ``group`` is the world, ``data_grp`` the ranks of this
    (spatial, model) coordinate, ``spatial_grp`` those of this (data,
    model) one, ``model_grp`` those of this (data, spatial) one and
    ``replica_grp`` those of this model coordinate; ``spatial`` the spatial
    size S, ``model`` the model size T (the last two groups None at T =
    1)."""

    data_grp: dist.ProcessGroup | None = None
    spatial_grp: dist.ProcessGroup | None = None
    spatial: int = 1
    model: int = 1
    model_grp: dist.ProcessGroup | None = None
    replica_grp: dist.ProcessGroup | None = None

    @property
    def s(self) -> int:
        return (self.rank // self.model) % self.spatial

    @property
    def data_rank(self) -> int:
        return self.rank // (self.spatial * self.model)

    @property
    def data_size(self) -> int:
        return self.world_size // (self.spatial * self.model)

    @property
    def data_group(self):
        return self.data_grp

    @property
    def spatial_group(self):
        return self.spatial_grp

    @property
    def spatial_size(self) -> int:
        return self.spatial

    @property
    def world_group(self):
        """The ranks a sum over the batch goes over: the world, or with a
        model axis this model coordinate's replica group."""
        return self.group if self.model == 1 else self.replica_grp

    @property
    def model_group(self):
        return self.model_grp

    @property
    def model_size(self) -> int:
        return self.model

    @property
    def model_rank(self) -> int:
        return self.rank % self.model

    @property
    def model_axis(self) -> ModelAxis:
        return ModelAxis(self.model_grp, self.model, self.model_rank)

    @property
    def band(self) -> tuple[int, int]:
        return self.s, self.spatial

    def rows(self, x):
        """This rank's rows of a global batch: those of its data coordinate."""
        n, d = x.shape[0], self.data_size
        if n % d:
            raise ValueError(f"a global batch of {n} rows does not divide over "
                             f"{d} data-parallel ranks")
        return x[self.data_rank * n // d:(self.data_rank + 1) * n // d]

    def cut_band(self, x):
        """This rank's height band of each image of ``x`` [N, H, ...]."""
        return cut_band(x, self.band)

    def bands(self, x):
        """This rank's rows and height band of a global batch (JAX's
        ``image_sharding``)."""
        return self.cut_band(self.rows(x))


def cut_band(x, band: tuple[int, int] | None):
    """Band ``s`` of ``S`` = ``band`` of each image's height (dim 1) of
    ``x`` [N, H, ...], a tensor or array; ``x`` itself for None."""
    if band is None:
        return x
    s, n = band
    h = x.shape[1]
    if h % n:
        raise ValueError(f"image height {h} does not divide over {n} spatial ranks")
    return x[:, s * h // n:(s + 1) * h // n]


def make_grid(dp: DataParallel, spatial: int, model: int = 1) -> Grid:
    """The (W/(S·T)) x S x T grid over the ranks of ``dp`` (JAX's
    ``make_mesh_2d(spatial)``, and with ``model`` T > 1 its
    ``make_mesh_3d(model, spatial)``): every rank forms every group in the
    same order, the data groups, the spatial ones and, at T > 1, the model
    groups and the replica groups."""
    per = spatial * model
    if dp.world_size % per:
        raise ValueError(f"{dp.world_size} devices not divisible by spatial={spatial}"
                         if model == 1 else f"{dp.world_size} devices not divisible by "
                         f"spatial·model = {spatial}·{model}")
    n_data = dp.world_size // per

    def rank(d, s, m):
        return d * per + s * model + m

    data = {(s, m): dist.new_group([rank(d, s, m) for d in range(n_data)])
            for s in range(spatial) for m in range(model)}
    space = {(d, m): dist.new_group([rank(d, s, m) for s in range(spatial)])
             for d in range(n_data) for m in range(model)}
    d, s, m = dp.rank // per, (dp.rank // model) % spatial, dp.rank % model
    extra = {}
    if model > 1:
        shards = {(d_, s_): dist.new_group([rank(d_, s_, m_) for m_ in range(model)])
                  for d_ in range(n_data) for s_ in range(spatial)}
        replicas = [dist.new_group(list(range(m_, dp.world_size, model)))
                    for m_ in range(model)]
        extra = dict(model=model, model_grp=shards[(d, s)], replica_grp=replicas[m])
    return Grid(group=dp.group, host_group=dp.host_group, rank=dp.rank,
                world_size=dp.world_size, device=dp.device, multihost=dp.multihost,
                data_grp=data[(s, m)], spatial_grp=space[(d, m)], spatial=spatial, **extra)


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


def world_of(group):
    """The ``ProcessGroup`` a sum over the batch goes over for a ``Grid`` or
    a ``parallel.halo.Band``: the world, or with a model axis the replica
    group (module docstring); any other ``group`` as it is."""
    return getattr(group, "world_group", group)


def group_size(group) -> int:
    """The number of ranks of ``group`` (of ``world_of`` it for a grid or
    band); 1 for None (no data parallelism)."""
    return 1 if group is None else dist.get_world_size(world_of(group))


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
    """Σ over the ranks of ``group`` (over ``world_of`` a grid or band),
    inside autograd (its backward sums the cotangents over the ranks: JAX's
    ``lax.psum`` and its transpose); ``t`` itself when ``group`` is None."""
    return t if group is None else _PSum.apply(t, world_of(group))


def pmean(tensors: list[torch.Tensor], group) -> list[torch.Tensor]:
    """The mean over the ranks of each tensor (over ``world_of`` a grid;
    no autograd): one all-reduce
    of one flat bucket (fp32, or the widest float dtype of ``tensors``),
    divided by the world size. Returns new tensors in the inputs' shapes
    and dtypes."""
    dtype = torch.float32
    for t in tensors:
        dtype = torch.promote_types(dtype, t.dtype)
    flat = torch.cat([t.detach().reshape(-1).to(dtype) for t in tensors])
    dist.all_reduce(flat, group=world_of(group))
    flat /= group_size(group)
    return [c.view(t.shape).to(t.dtype)
            for c, t in zip(flat.split([t.numel() for t in tensors]), tensors)]


def broadcast_tree(tree, dp: DataParallel):
    """Rank 0's copy of every tensor of ``tree`` (params, BN state,
    optimizer state), on every rank: JAX's ``replicated`` placement. Under
    tensor parallelism the full trees are broadcast before any rank takes
    its shard (``parallel.tensor.shard_model``)."""
    from tpu_unet_torch.models.unet import tree_map  # models import this module's users

    def one(t: torch.Tensor) -> torch.Tensor:
        t = t.detach().clone().contiguous()
        dist.broadcast(t, src=0, group=dp.group)
        return t

    return tree_map(one, tree)
