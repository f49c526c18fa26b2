"""Synthetic Carvana-like images and masks (``tpu_unet/data/synthetic.py``).

The JAX package's numpy + PIL generator, copied so the port can make data
without importing ``tpu_unet`` (which imports jax): the frozen training
parameters (``TRAIN_GEN``), the held-out ones (``HELDOUT_GEN``), the
flip-symmetric overhead variants, the multi-class VOC-style set and the
in-memory batch. Every generator draws from its ``numpy`` generator in the
JAX package's order, so one seed gives both packages the same bytes: the
draw order is part of the frozen quality gates (``tools/train_demo.py``).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
from PIL import Image


# The FROZEN v3 generator parameters (BENCH_NOTES.md r2 — do not retune
# these against the quality gate; VERDICT r2 weak #1). HELDOUT_GEN draws
# from ranges the training generator never produces — darker/more varied
# backdrops, stronger and displaced shadows, a wider car-luminance band,
# and a specular glare distractor ON THE BACKDROP (not in the mask) — so
# the gate measures generalization, not memorization of generator quirks.
TRAIN_GEN = dict(
    backdrop_base=(0.78, 0.78), backdrop_grad=0.08,
    shadow_dim=(0.55, 0.75), shadow_offset=0.85,
    car_lum=(0.05, 0.55), highlight=0.25, bg_glare=0.0,
)
HELDOUT_GEN = dict(
    backdrop_base=(0.68, 0.88), backdrop_grad=0.12,
    shadow_dim=(0.40, 0.65), shadow_offset=0.70,
    car_lum=(0.08, 0.62), highlight=0.35, bg_glare=0.18,
)

# Flip-symmetric "overhead" variant (VERDICT r3 next #4): a top-down drone
# shot with ACHIRAL lighting — no vertical backdrop gradient, the shadow an
# ambient-occlusion halo centered on the car instead of a gravity-axis floor
# ellipse, no directional specular streak, no diagonal glare. Per-sample
# appearance statistics are then invariant under h/v flips BY CONSTRUCTION,
# which is exactly the precondition flip-TTA and hflip-augmentation need
# (BENCH_NOTES r3 measured both HURTING on the gravity-axis studio scenes:
# vertical-flip views put the shadow above the car = out-of-distribution).
_OVERHEAD_DELTA = dict(
    backdrop_grad=0.0, shadow_offset=0.0, shadow_ry=1.35, shadow_rx=1.25,
    highlight=0.0, bg_glare=0.0,
)
OVERHEAD_GEN = {**TRAIN_GEN, **_OVERHEAD_DELTA}
OVERHEAD_HELDOUT_GEN = {**HELDOUT_GEN, **_OVERHEAD_DELTA}


def synth_sample(rng: np.random.Generator, h: int, w: int, gen: dict | None = None):
    """One (image, binary mask) pair emulating a Carvana studio shot.

    Carvana photographs cars on a uniform light-gray studio backdrop with a
    floor shadow — the car is always chromatically distinct from the scene,
    and the classic failure mode is including the SHADOW in the mask. The
    generator reproduces exactly that structure: smooth bright backdrop, a
    clearly-colored elliptical 'car' (any hue, capped luminance so it never
    matches the backdrop), and a darkened shadow ellipse under the car that
    is NOT part of the ground-truth mask. (An earlier variant drew car
    colors uniform over [0.1,0.9] on a mid-gray scene; color collisions
    made many samples genuinely ambiguous — unfaithful to Carvana and it
    capped reachable val Dice at ~0.93, BENCH_NOTES.md r2.)

    ``gen`` selects a parameter set (default: the frozen TRAIN_GEN — its
    default path draws randoms in the exact v3 order, so default outputs
    are bit-identical to round 2). HELDOUT_GEN exists so the quality gate
    can evaluate on configurations never used during tuning.
    """
    g = {**TRAIN_GEN, **(gen or {})}
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
    b_lo, b_hi = g["backdrop_base"]
    b0 = b_lo if b_lo == b_hi else rng.uniform(b_lo, b_hi)
    base = (b0 + g["backdrop_grad"] * (yy / h)
            + 0.03 * np.sin(2 * np.pi * xx / w * rng.uniform(1, 2)))
    img = np.repeat(base[..., None], 3, axis=-1) + 0.02 * rng.standard_normal((h, w, 3))

    # Floor shadow under the car: darkens the backdrop, NOT in the mask.
    # shadow_ry/shadow_rx default to the frozen v3 shape (0.35, 1.05); the
    # overhead variant widens both past the car so a CENTERED (offset 0)
    # shadow reads as an ambient-occlusion halo around it.
    sy = cy + g["shadow_offset"] * ry
    s_ry = g.get("shadow_ry", 0.35) * ry
    s_rx = g.get("shadow_rx", 1.05) * rx
    shadow = (((yy - sy) / s_ry) ** 2 + ((xx - cx) / s_rx) ** 2) <= 1.0
    img = np.where(shadow[..., None], img * rng.uniform(*g["shadow_dim"]), img)

    if g["bg_glare"]:
        # Backdrop glare distractor (held-out only): a bright diagonal
        # streak across the scene, NOT in the mask — punishes models that
        # learned "bright anomaly = not car, dark anomaly = car" shortcuts.
        gy = rng.uniform(0.1 * h, 0.9 * h)
        glare = np.exp(-(((yy - gy) - 0.3 * (xx - w / 2)) / (0.06 * h)) ** 2)
        img = np.clip(img + g["bg_glare"] * glare[..., None], 0, 1.2)

    # Car paint: any hue, luminance capped well below the backdrop, with
    # body noise and a specular highlight streak.
    color = rng.uniform(g["car_lum"][0], g["car_lum"][1], size=3)
    paint = color + 0.04 * rng.standard_normal((h, w, 3))
    highlight = np.exp(-((yr + 0.4 * ry) / (0.25 * ry)) ** 2) * g["highlight"]
    paint = paint + highlight[..., None]
    img = np.where(mask[..., None] > 0, paint, img)
    img = np.clip(img, 0, 1)
    return (img * 255).astype(np.uint8), mask * 255


def make_synthetic_carvana(
    root: str | Path, n: int = 8, h: int = 64, w: int = 96, seed: int = 0,
    gen: dict | None = None, img_format: str = "png",
    mask_format: str = "png",
) -> tuple[Path, Path]:
    """Write a Carvana-layout dataset (imgs/, masks/ with _mask suffix).

    ``gen=HELDOUT_GEN`` (with an unseen ``seed``) produces the held-out
    evaluation distribution the quality gate scores against.

    ``img_format="jpg", mask_format="gif"`` mirrors the REAL upstream
    dataset's file formats (train_hq.zip ships .jpg images, train_masks
    .gif palette masks; reference: utils/data_loading.py glob id.*,
    UNVERIFIED mount, SURVEY.md §2 #10/#21) — the loader is
    extension-agnostic, so this exercises the exact decode paths a real
    Carvana download would.
    """
    root = Path(root)
    img_dir, mask_dir = root / "imgs", root / "masks"
    img_dir.mkdir(parents=True, exist_ok=True)
    mask_dir.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    for i in range(n):
        img, mask = synth_sample(rng, h, w, gen=gen)
        img_kw = {"quality": 95} if img_format in ("jpg", "jpeg") else {}
        Image.fromarray(img).save(
            img_dir / f"car_{i:04d}.{img_format}", **img_kw)
        Image.fromarray(mask).save(mask_dir / f"car_{i:04d}_mask.{mask_format}")
    return img_dir, mask_dir


def make_synthetic_voc(
    root: str | Path, n: int = 8, h: int = 64, w: int = 96,
    n_classes: int = 21, seed: int = 0,
) -> tuple[Path, Path]:
    """Multi-class (VOC-style) synthetic dataset: up to 3 class blobs per
    image on a background of class 0; mask pixel value = class index
    (north-star config #3)."""
    root = Path(root)
    img_dir, mask_dir = root / "imgs", root / "masks"
    img_dir.mkdir(parents=True, exist_ok=True)
    mask_dir.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    for i in range(n):
        img = np.clip(
            0.5 + 0.2 * rng.standard_normal((h, w, 3)), 0, 1
        )
        mask = np.zeros((h, w), np.uint8)
        yy, xx = np.mgrid[0:h, 0:w]
        for _ in range(rng.integers(1, 4)):
            cls = int(rng.integers(1, n_classes))
            cy, cx = rng.uniform(0, h), rng.uniform(0, w)
            ry, rx = rng.uniform(h / 8, h / 3), rng.uniform(w / 8, w / 3)
            blob = ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 <= 1.0
            mask[blob] = cls
            img[blob] = rng.uniform(0.1, 0.9, 3)
        Image.fromarray((img * 255).astype(np.uint8)).save(img_dir / f"im_{i:04d}.png")
        Image.fromarray(mask).save(mask_dir / f"im_{i:04d}_mask.png")
    return img_dir, mask_dir


def synth_batch(rng: np.random.Generator, n: int, h: int, w: int):
    """In-memory NHWC float batch + NHW int mask batch (no files)."""
    imgs, masks = [], []
    for _ in range(n):
        img, mask = synth_sample(rng, h, w)
        imgs.append(img.astype(np.float32) / 255.0)
        masks.append((mask > 0).astype(np.int64))
    return np.stack(imgs), np.stack(masks)
