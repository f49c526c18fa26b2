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

Under data parallelism each rank stages the whole corpus on its own card
and gathers only its rows of each global batch there, with no collective
(``batches(shard=)``): W times the JAX package's per-device share of memory
(its corpus is sharded over the mesh), the same batches. JAX's per-process
staging for more than one host (``_local_row_range``, ``_gather_u8``,
``_gather_f32``) is not ported.
"""

from __future__ import annotations

import logging
from concurrent.futures import ThreadPoolExecutor
from typing import Sequence

import numpy as np
import torch

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
        for b in shard_batches(batches, self.shard):
            yield self.parent.gather(b)


class DeviceResidentData:
    """Stage ``dataset`` (preprocessed samples: HWC float32 images, HW int
    masks) on ``device`` once, decoding on ``num_workers`` threads."""

    def __init__(self, dataset, num_workers: int = 8, device: str | torch.device = "cuda"):
        self.device = torch.device(device)
        n = len(dataset)
        h, w, c = dataset[0]["image"].shape
        imgs = np.empty((n, h, w, c), np.float32)
        masks = np.empty((n, h, w), np.int64)

        def fill(j):
            s = dataset[j]
            imgs[j] = s["image"]
            masks[j] = s["mask"]

        with ThreadPoolExecutor(max_workers=num_workers) as pool:
            list(pool.map(fill, range(n)))
        if masks.max() >= 256:
            raise ValueError("device-resident masks stage as uint8 (<256 classes); got max "
                             f"class index {int(masks.max())}")
        # The uint8 round trip, checked in slabs of 64 samples: the whole
        # corpus at once would hold two more float copies of it on the host.
        u8 = np.empty(imgs.shape, np.uint8)
        self.exact = True
        for lo in range(0, n, 64):
            sl = imgs[lo:lo + 64]
            r = np.rint(sl * 255.0)
            if not np.array_equal(r / 255.0, sl):
                self.exact = False
                break
            u8[lo:lo + 64] = r.astype(np.uint8)
        self._images = torch.from_numpy(u8 if self.exact else imgs).to(self.device)
        del u8
        self._masks = torch.from_numpy(masks.astype(np.uint8)).to(self.device)
        self._table = u8_table(self.device)
        self.staged_bytes = (self._images.numel() * self._images.element_size()
                             + self._masks.numel())
        logger.info("Device-resident dataset: %d samples %dx%d staged to %s (%.0f MB as %s)",
                    n, h, w, self.device, self.staged_bytes / 1e6,
                    "uint8" if self.exact else "float32")

    def gather(self, idx) -> dict[str, torch.Tensor]:
        """The batch of these sample indices: float32 NHWC images, int32 NHW
        masks, on the device."""
        i = torch.from_numpy(np.asarray(idx, np.int64)).to(self.device)
        x = self._images.index_select(0, i)
        if self.exact:
            x = self._table[x.long()]
        return {"image": x, "mask": self._masks.index_select(0, i).to(torch.int32)}

    def batches(self, indices: Sequence[int], batch_size: int, *, shuffle: bool = False,
                seed: int = 0, drop_last: bool = False,
                shard: tuple[int, int] | None = None) -> _Batches:
        """The batches of ``indices``, shuffled per pass as the host
        ``DataLoader`` does; ``shard`` = (rank, world size) gathers only
        the rank's rows of each (``shard_batches``)."""
        return _Batches(self, indices, batch_size, shuffle, seed, drop_last, shard)
