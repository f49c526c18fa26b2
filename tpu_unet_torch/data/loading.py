"""The dataset layer (``tpu_unet/data/loading.py``): image loading, the
reference's shared train/predict transform, the paired image/mask datasets
and the seeded train/val split.

Decode and resize go through the native C++ tier (``tpu_unet_torch.native``),
which is bit-exact with Pillow and falls back to PIL where it cannot serve an
image, so either route gives the same arrays. The layout is the JAX
package's, channels-last: images HWC float32, masks HW int64 class-index
maps. ``RawDataset`` decodes only (uint8), for the device-side preprocess
(``data/device_pipeline.py``).
"""

from __future__ import annotations

import logging
from concurrent.futures import ThreadPoolExecutor
from functools import partial
from os import listdir
from os.path import isfile, join, splitext
from pathlib import Path

import numpy as np
import torch
from PIL import Image

from tpu_unet_torch import native

logger = logging.getLogger(__name__)


def load_image(filename) -> Image.Image:
    """``.npy`` -> numpy, ``.pt``/``.pth`` -> a saved tensor, else PIL."""
    ext = splitext(str(filename))[1]
    if ext == ".npy":
        return Image.fromarray(np.load(filename))
    if ext in (".pt", ".pth"):
        return Image.fromarray(torch.load(filename, weights_only=True).numpy())
    return Image.open(filename)


def preprocess(pil_img: Image.Image, scale: float) -> np.ndarray:
    """Resize by ``scale`` with BICUBIC, to HWC float32, divided by 255 when
    any value exceeds 1 (the reference's transform, channels-last)."""
    img = _resized(pil_img, _scaled_size(pil_img, scale), Image.BICUBIC)
    if img.ndim == 2:
        img = img[..., None]
    img = img.astype(np.float32)
    if (img > 1).any():
        img = img / 255.0
    return img


def preprocess_mask(mask_values, pil_img: Image.Image, scale: float) -> np.ndarray:
    """Resize by ``scale`` with NEAREST and map each pixel to the index of
    its value in ``mask_values`` (grey values, or RGB triples for [H,W,3]
    masks): an HW int64 class-index map."""
    new_w, new_h = _scaled_size(pil_img, scale)
    img = _resized(pil_img, (new_w, new_h), Image.NEAREST)
    mask = np.zeros((new_h, new_w), dtype=np.int64)
    for i, v in enumerate(mask_values):
        if img.ndim == 2:
            mask[img == v] = i
        else:
            mask[(img == v).all(-1)] = i
    return mask


def _resized(pil_img: Image.Image, size: tuple[int, int], resample) -> np.ndarray:
    """``np.asarray(pil_img.resize(size, resample))``, natively where the
    tier serves the image."""
    img = native.pil_resize_native(pil_img, *size, resample)
    return np.asarray(pil_img.resize(size, resample=resample)) if img is None else img


def _scaled_size(pil_img: Image.Image, scale: float) -> tuple[int, int]:
    w, h = pil_img.size
    new_w, new_h = int(scale * w), int(scale * h)
    if new_w <= 0 or new_h <= 0:
        raise ValueError("Scale is too small, resized images would have no pixel")
    return new_w, new_h


def unique_mask_values(idx, mask_dir: Path, mask_suffix: str) -> np.ndarray:
    """The unique pixel values (or RGB triples) of one mask file."""
    mask_file = list(mask_dir.glob(idx + mask_suffix + ".*"))[0]
    mask = native.asarray_fast(load_image(mask_file))
    if mask.ndim == 2:
        return np.unique(mask)
    if mask.ndim == 3:
        return np.unique(mask.reshape(-1, mask.shape[-1]), axis=0)
    raise ValueError(f"Loaded masks should have 2 or 3 dimensions, found {mask.ndim}")


class BasicDataset:
    """Paired images and masks matched by id (the file name without its
    extension; dotfiles skipped). The sorted unique mask values over every
    mask, scanned in threads, are the class palette (``mask_values``).
    ``cache`` keeps each preprocessed sample in memory after its first
    decode (the JAX package's ``--cache-dataset``)."""

    def __init__(self, images_dir, mask_dir, scale: float = 1.0, mask_suffix: str = "",
                 num_workers: int | None = None, cache: bool = False):
        self.images_dir = Path(images_dir)
        self.mask_dir = Path(mask_dir)
        if not 0 < scale <= 1:
            raise ValueError("Scale must be between 0 and 1")
        self.scale = scale
        self.mask_suffix = mask_suffix
        # Dict writes are atomic under the interpreter lock: two loader
        # threads racing on one sample at worst decode it twice.
        self._cache: dict[int, dict] | None = {} if cache else None
        self.ids = [splitext(f)[0] for f in listdir(images_dir)
                    if isfile(join(images_dir, f)) and not f.startswith(".")]
        if not self.ids:
            raise RuntimeError(f"No input file found in {images_dir}, "
                               "make sure you put your images there")
        logger.info("Creating dataset with %d examples", len(self.ids))
        scan = partial(unique_mask_values, mask_dir=self.mask_dir, mask_suffix=self.mask_suffix)
        if num_workers == 0:
            unique = [scan(i) for i in self.ids]
        else:
            with ThreadPoolExecutor(max_workers=num_workers) as pool:
                unique = list(pool.map(scan, self.ids))
        self.mask_values = list(sorted(np.unique(np.concatenate(unique), axis=0).tolist()))
        logger.info("Unique mask values: %s", self.mask_values)

    def __len__(self):
        return len(self.ids)

    def __getitem__(self, idx):
        if self._cache is not None and idx in self._cache:
            return self._cache[idx]
        name = self.ids[idx]
        img_file, mask_file = self._files(name)
        mask = load_image(mask_file)
        img = load_image(img_file)
        if img.size != mask.size:
            raise ValueError(f"Image and mask {name} should be the same size, "
                             f"but are {img.size} and {mask.size}")
        sample = {"image": preprocess(img, self.scale),
                  "mask": preprocess_mask(self.mask_values, mask, self.scale)}
        if self._cache is not None:
            self._cache[idx] = sample
        return sample

    def _files(self, name: str) -> tuple[Path, Path]:
        """(image file, mask file) of one id; exactly one of each."""
        img_file = list(self.images_dir.glob(name + ".*"))
        mask_file = list(self.mask_dir.glob(name + self.mask_suffix + ".*"))
        if len(img_file) != 1:
            raise ValueError(f"Either no image or multiple images found for the ID {name}: "
                             f"{img_file}")
        if len(mask_file) != 1:
            raise ValueError(f"Either no mask or multiple masks found for the ID {name}: "
                             f"{mask_file}")
        return img_file[0], mask_file[0]


class CarvanaDataset(BasicDataset):
    """The Carvana layout: each image's mask has the ``_mask`` suffix."""

    def __init__(self, images_dir, mask_dir, scale: float = 1.0,
                 num_workers: int | None = None, cache: bool = False):
        super().__init__(images_dir, mask_dir, scale, mask_suffix="_mask",
                         num_workers=num_workers, cache=cache)


class RawDataset(BasicDataset):
    """Decode only, for the device-side preprocess (``DevicePipeline``):
    each sample is the raw uint8 image (HWC) and mask (HW, or HW3 for RGB
    masks), neither resized nor normalised. Every image must have the first
    image's size (``raw_h``, ``raw_w``), as Carvana's do."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.raw_w, self.raw_h = load_image(self._files(self.ids[0])[0]).size

    def __getitem__(self, idx):
        name = self.ids[idx]
        img_file, mask_file = self._files(name)
        img, mask = load_image(img_file), load_image(mask_file)
        if img.size != (self.raw_w, self.raw_h):
            raise ValueError(f"RawDataset requires uniform image sizes; {name} is {img.size}, "
                             f"expected {(self.raw_w, self.raw_h)}")
        img_arr = native.asarray_fast(img)
        if img_arr.ndim == 2:
            img_arr = img_arr[..., None]
        return {"image": img_arr.astype(np.uint8), "mask": native.asarray_fast(mask)}


class RawCarvanaDataset(RawDataset):
    """``RawDataset`` in the Carvana layout (``_mask`` suffix)."""

    def __init__(self, images_dir, mask_dir, scale: float = 1.0,
                 num_workers: int | None = None):
        super().__init__(images_dir, mask_dir, scale, mask_suffix="_mask",
                         num_workers=num_workers)


def random_split_indices(n: int, val_fraction: float, seed: int = 0):
    """(train, val) indices as ``torch.utils.data.random_split`` draws them:
    a ``randperm(n)`` from a generator seeded with ``seed``, the train span
    first, the val span (``int(n * val_fraction)`` items) last."""
    n_val = int(n * val_fraction)
    perm = torch.randperm(n, generator=torch.Generator().manual_seed(seed)).tolist()
    return perm[:n - n_val], perm[n - n_val:]
