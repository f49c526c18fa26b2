"""Spatial parallelism's collectives: each image's height split over the
ranks of a ``parallel.mesh.Grid``'s spatial axis, with every row a layer
reads from another rank brought to it inside autograd.

The JAX package has no counterpart: its spatial axis is a sharding
annotation (``P("data", "spatial")``) and GSPMD inserts the halo exchanges.
PyTorch has no GSPMD, so the port makes each one explicit:

- **Row layout.** ``Band`` is one depth of the network on one rank: the
  level's global height and every spatial rank's band ``[lo, hi)`` of it.
  Level 0 is the input's even split (its height divides over S); level
  k+1 keeps the output rows of the 2x2 pool whose first input row a rank
  owns, ``[ceil(lo/2), ceil(hi/2))`` clipped to ``H // 2``. Deep levels
  may split unevenly, or leave a rank no row at all (H = 40 over 4 ranks:
  level 4 has 2 rows); every op handles that.
- **Halo rows.** ``halo_rows(x, k, band)`` gives the k global rows above
  and the k below this rank's band (zeros past the global top and
  bottom). Each rank all-gathers its first and last k rows over the
  spatial group; any row within k of a band lies among its owner's first
  or last k rows, however short the bands between. Its backward all-reduces
  the rows' cotangents over the group and adds each rank's into its edge
  rows, so a row's gradient reaches its owner.
- **Ops.** ``fetch_rows`` (any rows within a few of the band: the pool's
  straddling pair, the upsample's neighbour rows, the skip's padding) and
  ``local`` (a 1x1 conv or the decoder's ConvTranspose on a band that may
  be empty); the 3x3 conv takes ``halo_rows(x, 1, band)`` and keeps no
  copy of its window (``ops/conv.py``).

Every rank runs the same ops in the same order, whatever its band's size:
autograd then runs the collectives of the backward in the same order on
every rank, and so does ``torch.utils.checkpoint``'s recomputation. A
decision that depends on the layout is taken from every rank's bands, so
that it is the same on all of them. The collectives are all-gathers and
all-reduces of rows in fp32 (fp64 for fp64), which gloo also carries for
CUDA tensors.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch
import torch.distributed as dist


@dataclass(frozen=True)
class Band:
    """One level of the network on one rank of ``grid``: the level's global
    ``height`` and each spatial rank's rows ``[lo, hi)`` (``bounds``, in
    spatial order). Where a function takes ``group``, a ``Band`` stands for
    the grid at that level."""

    grid: Any
    height: int
    bounds: tuple[tuple[int, int], ...]

    @property
    def lo(self) -> int:
        return self.bounds[self.grid.s][0]

    @property
    def hi(self) -> int:
        return self.bounds[self.grid.s][1]

    @property
    def any_empty(self) -> bool:
        """Whether some rank holds no row of this level."""
        return any(hi == lo for lo, hi in self.bounds)

    @property
    def world_group(self):
        return self.grid.world_group

    @property
    def spatial_group(self):
        return self.grid.spatial_group

    @property
    def model_group(self):
        return self.grid.model_group

    @property
    def model_size(self) -> int:
        return self.grid.model_size

    @property
    def model_rank(self) -> int:
        return self.grid.model_rank

    def elements(self, x: torch.Tensor) -> int:
        """The global element count per channel of the level whose band of
        this rank's rows is ``x`` [N, rows, W, C]: BatchNorm's n."""
        return x.shape[0] * self.grid.data_size * self.height * x.shape[2]

    def pooled(self) -> Band:
        """The next level (a 2x2 pool's output, floor mode)."""
        return Band(self.grid, *_pooled(self.height, self.bounds))

    def doubled(self) -> Band:
        """Twice this level's height, each rank twice its rows: the layout
        of a 2x upsample's output before the skip's padding."""
        return Band(self.grid, 2 * self.height,
                    tuple((2 * lo, 2 * hi) for lo, hi in self.bounds))


def _pooled(height: int, bounds) -> tuple[int, tuple]:
    h = height // 2
    return h, tuple((min(-(-lo // 2), h), min(-(-hi // 2), h)) for lo, hi in bounds)


def row_layout(height: int, spatial: int, depth: int = 5) -> list[tuple[int, tuple]]:
    """The per-level row layout: (global height, each spatial rank's ``(lo,
    hi)``) at each of ``depth`` levels, for an input of ``height`` rows
    split evenly over ``spatial`` ranks."""
    if height % spatial:
        raise ValueError(f"height {height} does not divide over {spatial} spatial ranks")
    rows = height // spatial
    bounds = tuple((q * rows, (q + 1) * rows) for q in range(spatial))
    out = []
    for _ in range(depth):
        out.append((height, bounds))
        height, bounds = _pooled(height, bounds)
    return out


def levels(group, x: torch.Tensor, depth: int = 5) -> list:
    """``group`` at each of ``depth`` levels: a grid's ``Band`` of each
    level for its input band ``x`` [N, rows, W, C]; anything else (None, a
    ``ProcessGroup``) as it is."""
    s = getattr(group, "spatial_size", 1)
    if s == 1:
        return [group] * depth
    return [Band(group, h, b) for h, b in row_layout(x.shape[1] * s, s, depth)]


def coarser(group):
    """The next level of a ``Band``; anything else as it is."""
    return group.pooled() if isinstance(group, Band) else group


def _edge_slots(band: Band, k: int) -> list[int]:
    """Where each of the 2k halo rows of this rank lies in the gathered
    edges: rank q's slots ``[2kq, 2kq + k)`` hold its first k rows and
    ``[2kq + k, 2k(q + 1))`` its last k (zero-filled where the band is
    shorter); slot ``2kS`` is a zero row (past the global edges)."""
    zero = 2 * k * len(band.bounds)
    slots = []
    for i in [*range(band.lo - k, band.lo), *range(band.hi, band.hi + k)]:
        if not 0 <= i < band.height:
            slots.append(zero)
            continue
        q = next(q for q, (lo, hi) in enumerate(band.bounds) if lo <= i < hi)
        lo, hi = band.bounds[q]
        slots.append(2 * k * q + (i - lo if i - lo < k else 2 * k + i - hi))
    return slots


class _HaloRows(torch.autograd.Function):
    """[N, 2k, W, C]: the k rows above and the k below the band (module
    docstring)."""

    @staticmethod
    def forward(ctx, x, band, k):
        n, rows = x.shape[0], x.shape[1]
        m = min(k, rows)
        edge = x.new_zeros((2 * k, n, *x.shape[2:]),
                           dtype=torch.promote_types(x.dtype, torch.float32))
        edge[:m] = x[:, :m].transpose(0, 1)
        edge[2 * k - m:] = x[:, rows - m:].transpose(0, 1)
        parts = [torch.empty_like(edge) for _ in band.bounds]
        dist.all_gather(parts, edge, group=band.spatial_group)
        table = torch.cat(parts + [edge.new_zeros((1, *edge.shape[1:]))])
        slots = torch.tensor(_edge_slots(band, k), device=x.device)
        ctx.band, ctx.k, ctx.m, ctx.rows, ctx.dtype = band, k, m, rows, x.dtype
        ctx.save_for_backward(slots)
        return table.index_select(0, slots).transpose(0, 1).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        slots, = ctx.saved_tensors
        band, k, m, rows = ctx.band, ctx.k, ctx.m, ctx.rows
        g = g.transpose(0, 1).to(torch.promote_types(g.dtype, torch.float32))
        buf = g.new_zeros((2 * k * len(band.bounds) + 1, *g.shape[1:]))
        buf.index_add_(0, slots, g)
        buf = buf[:-1].contiguous()
        dist.all_reduce(buf, group=band.spatial_group)
        s = band.grid.s
        mine = buf[2 * k * s:2 * k * (s + 1)].transpose(0, 1)
        gx = mine.new_zeros((mine.shape[0], rows, *mine.shape[2:]))
        gx[:, :m] += mine[:, :m]
        gx[:, rows - m:] += mine[:, 2 * k - m:]
        return gx.to(ctx.dtype), None, None


def halo_rows(x: torch.Tensor, k: int, band: Band) -> torch.Tensor:
    """The k global rows above this rank's band of ``x`` and the k below,
    [N, 2k, W, C] in x's dtype, zeros past the global top and bottom; a
    collective over the spatial group, inside autograd."""
    return _HaloRows.apply(x, band, k)


def exchange_rows(x: torch.Tensor, k: int, band: Band) -> torch.Tensor:
    """``[k rows of the rank above | x | k rows of the rank below]``, with
    zeros at the global top and bottom (``halo_rows``)."""
    h = halo_rows(x, k, band)
    return torch.cat([h[:, :k], x, h[:, k:]], 1)


def fetch_rows(x: torch.Tensor, band: Band, want) -> torch.Tensor:
    """Global rows ``[a, b)`` of the level whose band ``x`` is, ``want[q] =
    (a, b)`` for each spatial rank q (the same list on every rank); rows
    past the global edges are zeros. Takes rows from the other ranks
    through one ``halo_rows`` as wide as the farthest any rank reaches
    outside its band, or none when no rank does."""
    k = max(max(lo - a, b - hi, 0) for (lo, hi), (a, b) in zip(band.bounds, want))
    a, b = want[band.grid.s]
    if k == 0:
        return x.narrow(1, a - band.lo, b - a)
    return exchange_rows(x, k, band).narrow(1, a - band.lo + k, b - a)


def local(fn, x: torch.Tensor, band, scale: int = 1) -> torch.Tensor:
    """``fn`` (a row-local op whose output has ``scale`` rows an input row:
    a 1x1 conv, the 2x2 stride-2 ConvTranspose) on this rank's band. Where
    some rank of the level holds no row, every rank runs it on its band and
    one zero row (the ops refuse an empty input) and drops that row's
    output."""
    if not (isinstance(band, Band) and band.any_empty):
        return fn(x)
    pad = x.new_zeros((x.shape[0], 1, *x.shape[2:]))
    return fn(torch.cat([x, pad], 1)).narrow(1, 0, scale * x.shape[1])
