"""Batching and device prefetch (``tpu_unet/data/prefetch.py``).

A thread pool decodes and collates on the host, two batches ahead of the
consumer; ``prefetch_to_device`` keeps ``buffer_size`` batches already copied
to the card, from pinned host memory with ``non_blocking=True``, so the copy
of batch k+1 overlaps the step on batch k.
"""

from __future__ import annotations

import collections
import concurrent.futures as cf
from typing import Iterable, Iterator, Sequence

import numpy as np
import torch

from tpu_unet_torch.parallel.mesh import cut_band


def collate(samples: Sequence[dict]) -> dict[str, np.ndarray]:
    """Stack sample dicts into batch arrays (images NHWC, masks NHW). uint8
    images stay uint8, others become float32; int64 masks become int32
    (class indices are small, and half the bytes cross to the card)."""
    imgs = np.stack([s["image"] for s in samples])
    if imgs.dtype != np.uint8:
        imgs = imgs.astype(np.float32)
    masks = np.stack([s["mask"] for s in samples])
    if masks.dtype == np.int64:
        masks = masks.astype(np.int32)
    return {"image": imgs, "mask": masks}


def shard_batches(batches: list, shard: tuple[int, int] | None) -> list:
    """Each batch of sample indices cut to rank r's contiguous rows
    ``[r·B/W, (r+1)·B/W)`` for ``shard`` = (r, W) (data parallelism: JAX's
    ``P("data")`` layout of a global batch); unchanged for None. Every
    batch must divide over the W ranks. On a (data x spatial) grid, W is
    the data axis and the loader then cuts each image's height band
    (``DataLoader(band=)``)."""
    if shard is None:
        return batches
    r, w = shard
    if any(len(b) % w for b in batches):
        raise ValueError(f"a batch does not divide over {w} data-parallel ranks "
                         f"(sizes {sorted({len(b) for b in batches})})")
    return [b[r * len(b) // w:(r + 1) * len(b) // w] for b in batches]


class DataLoader:
    """Epoch iterator over an indexable dataset. Each pass shuffles with
    ``numpy.random.default_rng(seed + epoch)``, ``epoch`` counting the
    loader's own passes from 0, and loads samples on ``num_workers``
    threads, two batches ahead. ``shard`` = (rank, world size) loads only
    the rank's rows of each batch (``shard_batches``); such a batch carries
    ``"shard"``, which ``evaluate`` reads as one rank's rows of a global
    batch. ``band`` = (s, S) then keeps band s of S of each image's height
    (spatial parallelism) and tags the batch ``"band"``."""

    def __init__(self, dataset, batch_size: int, *, shuffle: bool = False,
                 drop_last: bool = False, num_workers: int = 8, seed: int = 0,
                 indices: Sequence[int] | None = None, shard: tuple[int, int] | None = None,
                 band: tuple[int, int] | None = None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = num_workers
        self.seed = seed
        self.indices = list(indices) if indices is not None else list(range(len(dataset)))
        self.shard = shard
        self.band = band
        self.epoch = 0

    def __len__(self):
        n = len(self.indices)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def __iter__(self) -> Iterator[dict[str, np.ndarray]]:
        order = list(self.indices)
        if self.shuffle:
            np.random.default_rng(self.seed + self.epoch).shuffle(order)
        self.epoch += 1
        batches = [order[i:i + self.batch_size] for i in range(0, len(order), self.batch_size)]
        if self.drop_last:
            batches = [b for b in batches if len(b) == self.batch_size]
        batches = shard_batches(batches, self.shard)
        tag = {} if self.shard is None else {"shard": self.shard}
        if self.band is not None:
            tag["band"] = self.band

        def batch(samples):
            return {**{k: cut_band(v, self.band) for k, v in collate(samples).items()}, **tag}

        if self.num_workers <= 1:
            for b in batches:
                yield batch([self.dataset[i] for i in b])
            return
        with cf.ThreadPoolExecutor(max_workers=self.num_workers) as pool:
            pending: collections.deque = collections.deque()

            def submit(idx_batch):
                return [pool.submit(self.dataset.__getitem__, i) for i in idx_batch]

            for b in batches[:2]:
                pending.append(submit(b))
            for k in range(len(batches)):
                futures = pending.popleft()
                if k + 2 < len(batches):
                    pending.append(submit(batches[k + 2]))
                yield batch([f.result() for f in futures])


def to_device(batch: dict, device: torch.device) -> dict[str, torch.Tensor]:
    """A batch as tensors on ``device``. Host arrays go through pinned memory
    with a non-blocking copy on a CUDA device (the copy is ordered on the
    current stream before any later kernel), as they are on the CPU; tensors
    (a batch made on the device) are moved only if they lie elsewhere; other
    values (a sharded batch's ``"shard"``) pass as they are."""
    def one(v):
        if isinstance(v, torch.Tensor):
            return v.to(device)
        if not isinstance(v, np.ndarray):
            return v
        t = torch.from_numpy(v)
        return t.pin_memory().to(device, non_blocking=True) if device.type == "cuda" else t

    return {k: one(v) for k, v in batch.items()}


def prefetch_to_device(iterator: Iterable[dict], buffer_size: int = 2,
                       device: str | torch.device = "cuda") -> Iterator[dict]:
    """Keep ``buffer_size`` batches on ``device`` ahead of the consumer."""
    device = torch.device(device)
    queue: collections.deque = collections.deque()
    it = iter(iterator)
    for batch in it:
        queue.append(to_device(batch, device))
        if len(queue) >= buffer_size:
            break
    while queue:
        out = queue.popleft()
        nxt = next(it, None)
        if nxt is not None:
            queue.append(to_device(nxt, device))
        yield out
