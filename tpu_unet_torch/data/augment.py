"""Device-side augmentation (``tpu_unet/data/augment.py``), on the batch
already on the device, before the train step.

Per sample: a smooth random warp (rotation, isotropic scale and shift about
the centre, plus an elastic field: a coarse grid of random displacements
upsampled bilinearly, the original U-Net paper's augmentation), images
sampled bilinearly and masks at the nearest pixel (class indices are never
interpolated); horizontal and vertical flips and a 180° rotation, image and
mask together; brightness and contrast jitter on the image, then a clip to
[0, 1].

It is two steps, so that each can be held to the JAX package's on its own:
``draw_augment`` makes every random number of a batch from a
``torch.Generator`` on the batch's device (``augment_generator(seed,
step)``, the counterpart of ``fold_in(PRNGKey(seed), step)``), and
``apply_augment`` is a pure function of those draws. The draws cannot equal
``jax.random``'s; their distributions do.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class AugmentConfig:
    hflip: bool = True          # random horizontal flip, p=0.5 per sample
    vflip: bool = False         # random vertical flip, p=0.5 per sample
    rot180: bool = False        # random 180° rotation, p=0.5 per sample
    brightness: float = 0.0     # additive jitter amplitude in [0,1] units
    contrast: float = 0.0       # multiplicative jitter amplitude
    # Elastic deformation: alpha = displacement magnitude in pixels; grid =
    # control-grid spacing in pixels (larger = smoother). 0 disables.
    elastic_alpha: float = 0.0
    elastic_grid: int = 64
    # Affine jitter in the same warp: rotation ~ U(±rot_deg) degrees about
    # the centre, scale ~ U(1 ± scale_jitter), shift ~ U(±shift_px) per axis.
    rot_deg: float = 0.0
    scale_jitter: float = 0.0
    shift_px: float = 0.0

    @property
    def warps(self) -> bool:
        return (self.elastic_alpha > 0 or self.rot_deg > 0 or self.scale_jitter > 0
                or self.shift_px > 0)


@dataclasses.dataclass
class AugmentDraws:
    """The random numbers of one batch of ``n``, each as JAX draws it (None
    where the config does not use it): ``rot_deg`` [n] degrees,
    ``scale_jitter`` [n] (the scale is 1 + it), ``shift`` [n, 2] pixels (y,
    x), ``field`` [n, gh, gw, 2] in [-1, 1), flips [n] bool, ``brightness``
    [n] and ``contrast`` [n] (the factor is 1 + it)."""

    rot_deg: torch.Tensor | None = None
    scale_jitter: torch.Tensor | None = None
    shift: torch.Tensor | None = None
    field: torch.Tensor | None = None
    hflip: torch.Tensor | None = None
    vflip: torch.Tensor | None = None
    rot180: torch.Tensor | None = None
    brightness: torch.Tensor | None = None
    contrast: torch.Tensor | None = None


def augment_generator(seed: int, step: int, device: str | torch.device) -> torch.Generator:
    """A generator on ``device`` seeded from (seed, step): each step's draw
    is reproducible from the run's seed, whatever the host's timing."""
    state = np.random.SeedSequence([seed, step]).generate_state(1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(state))


def elastic_grid_shape(h: int, w: int, grid: int) -> tuple[int, int]:
    return max(2, h // grid + 1), max(2, w // grid + 1)


def draw_augment(config: AugmentConfig, n: int, h: int, w: int,
                 generator: torch.Generator) -> AugmentDraws:
    """Every random number ``apply_augment`` needs for a batch of ``n``
    images of h x w, on the generator's device."""
    dev = generator.device

    def uniform(shape, lo, hi):
        return torch.rand(shape, generator=generator, device=dev) * (hi - lo) + lo

    d = AugmentDraws()
    if config.warps:
        d.rot_deg = uniform((n,), -config.rot_deg, config.rot_deg)
        d.scale_jitter = uniform((n,), -config.scale_jitter, config.scale_jitter)
        d.shift = uniform((n, 2), -config.shift_px, config.shift_px)
        if config.elastic_alpha > 0:
            d.field = uniform((n, *elastic_grid_shape(h, w, config.elastic_grid), 2), -1.0, 1.0)
    for name in ("hflip", "vflip", "rot180"):
        if getattr(config, name):
            setattr(d, name, torch.rand((n,), generator=generator, device=dev) < 0.5)
    if config.brightness > 0:
        d.brightness = uniform((n,), -config.brightness, config.brightness)
    if config.contrast > 0:
        d.contrast = uniform((n,), -config.contrast, config.contrast)
    return d


def _warp(d: AugmentDraws, images: torch.Tensor, masks: torch.Tensor, config: AugmentConfig):
    """Each sample through its inverse affine map (source = c + R(-θ)·(dst -
    c - t)/s) plus the elastic field, in one gather: bilinear for images,
    nearest (round half to even) for masks."""
    n, h, w, _ = images.shape
    dev = images.device
    yy = torch.arange(h, dtype=torch.float32, device=dev)[None, :, None]
    xx = torch.arange(w, dtype=torch.float32, device=dev)[None, None, :]
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    theta = torch.deg2rad(d.rot_deg).view(n, 1, 1)
    scale = (1.0 + d.scale_jitter).view(n, 1, 1)
    shift = d.shift.view(n, 2, 1, 1)
    dy = (yy - cy - shift[:, 0]) / scale
    dx = (xx - cx - shift[:, 1]) / scale
    cos, sin = torch.cos(theta), torch.sin(theta)
    sy = cy + cos * dy - sin * dx
    sx = cx + sin * dy + cos * dx
    if d.field is not None:
        # Bilinear upsampling with half-pixel centres; both it and
        # jax.image.resize keep the edge value past the outer centres.
        field = F.interpolate(d.field.permute(0, 3, 1, 2), size=(h, w), mode="bilinear",
                              align_corners=False).permute(0, 2, 3, 1) * config.elastic_alpha
        sy = sy + field[..., 0]
        sx = sx + field[..., 1]
    sy = sy.clamp(0.0, h - 1.0)
    sx = sx.clamp(0.0, w - 1.0)
    y0f, x0f = torch.floor(sy), torch.floor(sx)
    wy, wx = (sy - y0f)[..., None], (sx - x0f)[..., None]
    y0, x0 = y0f.long(), x0f.long()
    y1, x1 = (y0 + 1).clamp(max=h - 1), (x0 + 1).clamp(max=w - 1)
    b = torch.arange(n, device=dev)[:, None, None]
    top = (1 - wx) * images[b, y0, x0] + wx * images[b, y0, x1]
    bot = (1 - wx) * images[b, y1, x0] + wx * images[b, y1, x1]
    images = (1 - wy) * top + wy * bot
    masks = masks[b, torch.round(sy).long(), torch.round(sx).long()]
    return images, masks


def _where_rows(do: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.where(do.view((-1,) + (1,) * (a.ndim - 1)), a, b)


def apply_augment(d: AugmentDraws, images: torch.Tensor, masks: torch.Tensor,
                  config: AugmentConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """Images [N,H,W,C] float in [0, 1] and masks [N,H,W] through the
    configured augmentations with these draws, in the JAX package's order:
    warp, h-flip, v-flip, 180°, brightness, contrast, clip."""
    if config.warps:
        images, masks = _warp(d, images, masks, config)
    for do, dims in ((d.hflip, (2,)), (d.vflip, (1,)), (d.rot180, (1, 2))):
        if do is not None:
            images = _where_rows(do, torch.flip(images, dims), images)
            masks = _where_rows(do, torch.flip(masks, dims), masks)
    if d.brightness is not None:
        images = images + d.brightness.view(-1, 1, 1, 1)
    if d.contrast is not None:
        factor = 1.0 + d.contrast.view(-1, 1, 1, 1)
        mean = images.mean(dim=(1, 2, 3), keepdim=True)
        images = (images - mean) * factor + mean
    if d.brightness is not None or d.contrast is not None:
        images = images.clamp(0.0, 1.0)
    return images, masks


def augment_batch(images: torch.Tensor, masks: torch.Tensor, *, config: AugmentConfig,
                  seed: int, step: int, shard: tuple[int, int] | None = None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """The batch augmented with the draws of (seed, step), on its device.
    ``shard`` = (rank, world size): the batch is the rank's contiguous rows
    of a global batch world size times as large (data parallelism), and
    gets those rows' draws, as the global batch would."""
    n, h, w, _ = images.shape
    rank, world = shard or (0, 1)
    draws = draw_augment(config, n * world, h, w, augment_generator(seed, step, images.device))
    if world > 1:
        draws = AugmentDraws(**{f.name: None if getattr(draws, f.name) is None
                                else getattr(draws, f.name)[rank * n:(rank + 1) * n]
                                for f in dataclasses.fields(draws)})
    return apply_augment(draws, images, masks, config)
