"""Synthetic Carvana-like images and masks (``tpu_unet/data/synthetic.py``).

The JAX package's numpy + PIL generator with its frozen training parameters
(``TRAIN_GEN``), copied so the port can make data without importing
``tpu_unet`` (which imports jax). The same seed gives the same files as the
JAX package's ``make_synthetic_carvana`` with its defaults.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
from PIL import Image

# The frozen v3 generator parameters of the JAX package.
TRAIN_GEN = dict(
    backdrop_base=0.78, backdrop_grad=0.08,
    shadow_dim=(0.55, 0.75), shadow_offset=0.85, shadow_ry=0.35, shadow_rx=1.05,
    car_lum=(0.05, 0.55), highlight=0.25,
)


def synth_sample(rng: np.random.Generator, h: int, w: int):
    """One (image, binary mask) pair emulating a Carvana studio shot: a
    bright smooth backdrop, a colored elliptical 'car' whose luminance never
    matches the backdrop, and a darkened floor shadow that is NOT in the
    mask. Draws from ``rng`` in the JAX generator's order."""
    g = TRAIN_GEN
    yy, xx = np.mgrid[0:h, 0:w]
    cy = rng.uniform(0.35 * h, 0.6 * h)
    cx = rng.uniform(0.35 * w, 0.65 * w)
    ry = rng.uniform(0.15 * h, 0.28 * h)
    rx = rng.uniform(0.2 * w, 0.4 * w)
    theta = rng.uniform(-0.3, 0.3)
    ys, xs = (yy - cy), (xx - cx)
    yr = ys * np.cos(theta) - xs * np.sin(theta)
    xr = ys * np.sin(theta) + xs * np.cos(theta)
    mask = ((yr / ry) ** 2 + (xr / rx) ** 2 <= 1.0).astype(np.uint8)

    # Studio backdrop: bright, smooth vertical gradient + faint banding.
    base = (g["backdrop_base"] + g["backdrop_grad"] * (yy / h)
            + 0.03 * np.sin(2 * np.pi * xx / w * rng.uniform(1, 2)))
    img = np.repeat(base[..., None], 3, axis=-1) + 0.02 * rng.standard_normal((h, w, 3))

    # Floor shadow under the car: darkens the backdrop, NOT in the mask.
    sy = cy + g["shadow_offset"] * ry
    s_ry = g["shadow_ry"] * ry
    s_rx = g["shadow_rx"] * rx
    shadow = (((yy - sy) / s_ry) ** 2 + ((xx - cx) / s_rx) ** 2) <= 1.0
    img = np.where(shadow[..., None], img * rng.uniform(*g["shadow_dim"]), img)

    # Car paint: any hue, luminance capped well below the backdrop, with
    # body noise and a specular highlight streak.
    color = rng.uniform(g["car_lum"][0], g["car_lum"][1], size=3)
    paint = color + 0.04 * rng.standard_normal((h, w, 3))
    highlight = np.exp(-((yr + 0.4 * ry) / (0.25 * ry)) ** 2) * g["highlight"]
    paint = paint + highlight[..., None]
    img = np.where(mask[..., None] > 0, paint, img)
    img = np.clip(img, 0, 1)
    return (img * 255).astype(np.uint8), mask * 255


def make_synthetic_carvana(root: str | Path, n: int = 8, h: int = 64, w: int = 96,
                           seed: int = 0) -> tuple[Path, Path]:
    """Write a Carvana-layout dataset of PNGs (imgs/, masks/ with the _mask
    suffix); return the two directories."""
    root = Path(root)
    img_dir, mask_dir = root / "imgs", root / "masks"
    img_dir.mkdir(parents=True, exist_ok=True)
    mask_dir.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    for i in range(n):
        img, mask = synth_sample(rng, h, w)
        Image.fromarray(img).save(img_dir / f"car_{i:04d}.png")
        Image.fromarray(mask).save(mask_dir / f"car_{i:04d}_mask.png")
    return img_dir, mask_dir


def synth_batch(rng: np.random.Generator, n: int, h: int, w: int):
    """In-memory batch: NHWC float32 images in [0, 1] and NHW int64 binary
    masks, no files. The same draws as the JAX package's ``synth_batch``, so
    one seed gives both packages one batch."""
    imgs, masks = [], []
    for _ in range(n):
        img, mask = synth_sample(rng, h, w)
        imgs.append(img.astype(np.float32) / 255.0)
        masks.append((mask > 0).astype(np.int64))
    return np.stack(imgs), np.stack(masks)
