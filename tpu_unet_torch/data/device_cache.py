"""The device-resident dataset (``tpu_unet/data/device_cache.py``): the
whole preprocessed corpus staged to the device once, batches gathered there.

The host then sends only each batch's indices; batch assembly is a gather
on the device, with the /255 through a 256-entry table. Carvana at scale
0.5 (5088 images of 959x640) is about 9.4 GB of uint8 images and 3.1 GB of
masks: it fits an 80 GB card.

Parity: the samples are the dataset's own (``BasicDataset`` preprocess on
the host). Images stage as uint8 only when ``preprocessed * 255`` rounds
back exactly (true for every uint8 source image, where the /255 rule
fired); otherwise they stage as float32, with a log line. The table holds
numpy's float32 ``k / 255``, so a gathered batch is bitwise the host
``DataLoader``'s. Masks stage as uint8 class indices (fewer than 256
classes) and are served as int32, the host loader's mask dtype.

Under data parallelism (``dp``, one host or several) each rank stages only
its contiguous rows ``[r·P/W, (r+1)·P/W)`` of the corpus, P being n padded
to a multiple of W by repeating the corpus cyclically (pad rows are never
indexed): JAX's ``_local_row_range`` staging, about 1/W of the corpus a
card. A global batch is assembled by one collective: each rank writes the
samples it holds into a zeroed batch buffer and the buffers are summed over
the ranks (``all_reduce``; every sample has one owner, so the sum is exact
in uint8, and in float32 but for a -0.0 that comes back +0.0), then each
rank keeps its slot's rows (train) or the whole batch (validation, which
``evaluate`` splits). Every rank makes the same collectives in the same
order, since every rank iterates the same batches. The uint8 decision and
the class limit are agreed over the ranks before anything is staged; under
multi-host, float-typed sources are refused, as in the JAX package.
Without ``dp`` the whole corpus is staged, and ``batches(shard=)`` gathers
a rank's rows locally.
"""

from __future__ import annotations

import logging
from concurrent.futures import ThreadPoolExecutor
from typing import Sequence

import numpy as np
import torch
import torch.distributed as dist

from tpu_unet_torch.data.device_pipeline import u8_table
from tpu_unet_torch.data.prefetch import shard_batches

logger = logging.getLogger(__name__)


class _Batches:
    """A re-iterable view of gathered batches (validation iterates the val
    split at every validation)."""

    def __init__(self, parent: "DeviceResidentData", indices, batch_size, shuffle, seed,
                 drop_last, shard):
        self.parent = parent
        self.indices = np.asarray(indices, np.int64)
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.shard = shard
        self.epoch = 0

    def __len__(self):
        n = len(self.indices)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def __iter__(self):
        order = self.indices.copy()
        if self.shuffle:
            # The host DataLoader's per-epoch reseeding.
            np.random.default_rng(self.seed + self.epoch).shuffle(order)
            self.epoch += 1
        bs = self.batch_size
        batches = [order[i:i + bs] for i in range(0, len(order), bs)]
        if self.drop_last:
            batches = [b for b in batches if len(b) == bs]
        if self.parent.dp is None:
            for b in shard_batches(batches, self.shard):
                yield self.parent.gather(b)
            return
        shard_batches(batches, self.shard)  # every batch must divide over the ranks
        for b in batches:
            yield self.parent.gather_global(b, self.shard)


class DeviceResidentData:
    """Stage ``dataset`` (preprocessed samples: HWC float32 images, HW int
    masks) on ``device`` once, decoding on ``num_workers`` threads: the
    whole corpus, or with ``dp`` (a ``parallel.mesh.DataParallel``) this
    rank's rows of it."""

    def __init__(self, dataset, num_workers: int = 8, device: str | torch.device = "cuda",
                 dp=None):
        self.device = torch.device(device)
        self.dp = dp
        n = len(dataset)
        h, w, c = dataset[0]["image"].shape
        if dp is None:
            self.lo, self.hi = 0, n
        else:
            per = (n + (-n) % dp.world_size) // dp.world_size
            self.lo, self.hi = dp.rank * per, (dp.rank + 1) * per
        # Rows past n (the padding) repeat the corpus cyclically.
        src = [r if r < n else (r - n) % n for r in range(self.lo, self.hi)]
        imgs = np.empty((len(src), h, w, c), np.float32)
        masks = np.empty((len(src), h, w), np.int64)

        def fill(j):
            s = dataset[src[j]]
            imgs[j] = s["image"]
            masks[j] = s["mask"]

        with ThreadPoolExecutor(max_workers=num_workers) as pool:
            list(pool.map(fill, range(len(src))))
        # The uint8 round trip, checked in slabs of 64 samples: the whole
        # corpus at once would hold two more float copies of it on the host.
        u8 = np.empty(imgs.shape, np.uint8)
        exact = True
        for lo in range(0, len(src), 64):
            sl = imgs[lo:lo + 64]
            r = np.rint(sl * 255.0)
            if not np.array_equal(r / 255.0, sl):
                exact = False
                break
            u8[lo:lo + 64] = r.astype(np.uint8)
        # Each rank sees only its rows: agree on both decisions first, so that
        # every rank raises or stages alike.
        top, self.exact = int(masks.max()), exact
        if dp is not None:
            flags = torch.tensor([top, int(not exact)], dtype=torch.int64)
            dist.all_reduce(flags, op=dist.ReduceOp.MAX, group=dp.host_group)
            top, self.exact = int(flags[0]), not bool(flags[1])
        if top >= 256:
            raise ValueError("device-resident masks stage as uint8 (<256 classes); got max "
                             f"class index {top}")
        if dp is not None and dp.multihost and not self.exact:
            raise ValueError("multi-host --device-dataset requires the uint8 round-trip "
                             "(preprocessed values must be k/255): float-typed sources are "
                             "single-host only")
        self._images = torch.from_numpy(u8 if self.exact else imgs).to(self.device)
        del u8
        self._masks = torch.from_numpy(masks.astype(np.uint8)).to(self.device)
        self._table = u8_table(self.device)
        self.staged_bytes = (self._images.numel() * self._images.element_size()
                             + self._masks.numel())
        logger.info("Device-resident dataset: %d samples %dx%d, rows [%d, %d) staged to %s "
                    "(%.0f MB as %s)", n, h, w, self.lo, self.hi, self.device,
                    self.staged_bytes / 1e6, "uint8" if self.exact else "float32")

    def _serve(self, x: torch.Tensor, m: torch.Tensor) -> dict[str, torch.Tensor]:
        if self.exact:
            x = self._table[x.long()]
        return {"image": x, "mask": m.to(torch.int32)}

    def gather(self, idx) -> dict[str, torch.Tensor]:
        """The batch of these sample indices, all staged on this rank:
        float32 NHWC images, int32 NHW masks, on the device."""
        i = torch.from_numpy(np.asarray(idx, np.int64) - self.lo).to(self.device)
        return self._serve(self._images.index_select(0, i), self._masks.index_select(0, i))

    def gather_global(self, idx, shard: tuple[int, int] | None) -> dict[str, torch.Tensor]:
        """A global batch of a corpus staged over the ranks (a collective):
        ``shard`` (rank, W) gives the rank's contiguous rows of it, None the
        whole batch."""
        idx = np.asarray(idx, np.int64)
        own = (idx >= self.lo) & (idx < self.hi)
        at = torch.from_numpy(np.flatnonzero(own)).to(self.device)
        rows = torch.from_numpy(idx[own] - self.lo).to(self.device)
        x = self._images.new_zeros((len(idx), *self._images.shape[1:]))
        m = self._masks.new_zeros((len(idx), *self._masks.shape[1:]))
        x.index_copy_(0, at, self._images.index_select(0, rows))
        m.index_copy_(0, at, self._masks.index_select(0, rows))
        for t in (x, m):
            dist.all_reduce(t, group=self.dp.group)
        if shard is not None:
            r, w = shard
            per = len(idx) // w
            x, m = x[r * per:(r + 1) * per], m[r * per:(r + 1) * per]
        return self._serve(x, m)

    def batches(self, indices: Sequence[int], batch_size: int, *, shuffle: bool = False,
                seed: int = 0, drop_last: bool = False,
                shard: tuple[int, int] | None = None) -> _Batches:
        """The batches of ``indices``, shuffled per pass as the host
        ``DataLoader`` does; ``shard`` = (rank, world size) gives only the
        rank's rows of each (``shard_batches``), None whole batches."""
        return _Batches(self, indices, batch_size, shuffle, seed, drop_last, shard)
