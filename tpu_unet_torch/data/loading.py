"""Image preprocessing shared by predict and serve
(``tpu_unet/data/loading.py::BasicDataset.preprocess``, image branch).

Plain PIL: the JAX package's native resampler is bit-exact with Pillow, so
this gives the same arrays.
"""

from __future__ import annotations

import numpy as np
from PIL import Image


def preprocess(pil_img: Image.Image, scale: float) -> np.ndarray:
    """Resize by ``scale`` with BICUBIC, to HWC float32, divided by 255 when
    any value exceeds 1 (the reference's transform, channels-last)."""
    w, h = pil_img.size
    new_w, new_h = int(scale * w), int(scale * h)
    if new_w <= 0 or new_h <= 0:
        raise ValueError("Scale is too small, resized images would have no pixel")
    img = np.asarray(pil_img.resize((new_w, new_h), resample=Image.BICUBIC))
    if img.ndim == 2:
        img = img[..., None]
    img = img.astype(np.float32)
    if (img > 1).any():
        img = img / 255.0
    return img
