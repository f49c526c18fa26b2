"""Tiled sliding-window inference with overlap-halo stitching, on one device
(``tpu_unet/parallel/tiling.py``).

A large image is run as fixed-size windows whose cores stitch back to the
full-image logits:

  * every window is tile+2·halo square, at ``clip(core_start - halo, 0,
    H - (tile+2·halo))``: an interior core sits >= halo from its window's
    edge, so with halo >= the one-sided receptive field (110 px for the
    4-level U-Net; 128 leaves a margin) the window's border cannot reach
    it, and a clamped window ends at the image's edge, where its conv
    zero-padding is the full image's;
  * window starts stay multiples of 16, so the four pooling grids align with
    the full image's; H and W must be multiples of 16 (pad-and-crop for
    other sizes, ``tiled_forward_padded``).

The sweep stays on the device: windows are slices of the input tensor,
``window_batch`` of them go through one forward, and their cores are written
into one preallocated logits tensor. Nothing is fetched to the host inside
the loop.

``make_halo_sharded_forward`` spreads one image over the ranks of a
``parallel.mesh.DataParallel`` group in horizontal bands instead: rank i
holds rows ``[iB, (i+1)B)``, takes 2·halo rows on each side from its
neighbours, runs the window ``clip(iB - halo, 0, H - win)`` of B + 2·halo
rows and keeps its band's core; the cores are gathered into the logits.
"""

from __future__ import annotations

import logging

import numpy as np
import torch
import torch.nn.functional as F
from PIL import Image

import torch.distributed as dist

from tpu_unet_torch.data.loading import preprocess
from tpu_unet_torch.models.tta import tta_merge, tta_views
from tpu_unet_torch.models.unet import UNetConfig, tree_map, unet_apply
from tpu_unet_torch.ops import resize_bilinear
from tpu_unet_torch.predict import logits_to_mask, resolve_device

logger = logging.getLogger(__name__)

# One-sided receptive field of the 4-level U-Net: 110 px, measured by
# input-gradient support; 128 leaves an 18 px margin.
DEFAULT_HALO = 128


def min_halo(config: UNetConfig) -> int:
    """Smallest halo for which tiling is exact for ``config``. R2U-Net's
    blocks apply 2·(t+1) 3x3 convs a level, so its receptive field, and the
    halo, grow with ``recur_t``."""
    if config.arch in ("r2u", "r2attu"):
        rf = 110 * (config.recur_t + 1)
        return (rf + 18 + 15) // 16 * 16  # the same 18 px margin, 16-aligned
    return DEFAULT_HALO


def _check_alignment(h: int, w: int, tile: int, halo: int) -> None:
    for name, v in (("H", h), ("W", w), ("tile", tile), ("halo", halo)):
        if v % 16 != 0:
            raise ValueError(f"{name}={v} must be a multiple of 16 for exact tiling")
    if tile + 2 * halo > min(h, w):
        raise ValueError(f"window {tile}+2·{halo} exceeds image {h}×{w}; use a larger tile "
                         "or full-image inference")


def window_coords(h: int, w: int, tile: int, halo: int) -> list[tuple[int, int, int, int]]:
    """(window_y, window_x, core_y, core_x) of each window, row by row. A last
    core that would run past the image's edge is moved back to end at it
    (the JAX package's clamped ``dynamic_slice``/``dynamic_update_slice``
    do the same)."""
    win = tile + 2 * halo
    coords = []
    for ay in range(0, h, tile):
        sy = min(max(ay - halo, 0), h - win)
        for ax in range(0, w, tile):
            sx = min(max(ax - halo, 0), w - win)
            coords.append((sy, sx, min(ay, h - tile), min(ax, w - tile)))
    return coords


def tiled_forward(params, state, x: torch.Tensor, *, config: UNetConfig, tile: int = 512,
                  halo: int = DEFAULT_HALO, amp: bool = False,
                  window_batch: int = 4) -> torch.Tensor:
    """Exact tiled eval forward. x: [N,H,W,C] -> fp32 logits [N,H,W,classes],
    on x's device. Activations peak at ``window_batch`` windows, not the
    image."""
    n, h, w, _ = x.shape
    _check_alignment(h, w, tile, halo)
    need = min_halo(config)
    if halo < need:
        raise ValueError(f"halo={halo} is below the exactness requirement for "
                         f"arch={config.arch!r} (receptive field needs >= {need}); "
                         "raise --halo or use full-image inference")
    win = tile + 2 * halo
    coords = window_coords(h, w, tile, halo)
    wb = min(window_batch, len(coords))
    # Pad the list to whole groups by repeating the last window: its core is
    # written again with the same values.
    coords += [coords[-1]] * (-len(coords) % wb)
    out = torch.zeros((n, h, w, config.n_classes), dtype=torch.float32, device=x.device)
    for g in range(0, len(coords), wb):
        group = coords[g:g + wb]
        windows = torch.cat([x[:, sy:sy + win, sx:sx + win] for sy, sx, _, _ in group])
        logits, _ = unet_apply(params, state, windows, config=config, train=False,
                               compute_dtype=torch.bfloat16 if amp else None)
        for k, (sy, sx, ay, ax) in enumerate(group):
            out[:, ay:ay + tile, ax:ax + tile] = logits[
                k * n:(k + 1) * n, ay - sy:ay - sy + tile, ax - sx:ax - sx + tile]
    return out


def padded_hw(h: int, w: int) -> tuple[int, int]:
    """The (H, W) the pad-to-16 sweep runs at."""
    return h + (-h) % 16, w + (-w) % 16


def tiled_forward_padded(params, state, x: torch.Tensor, *, config: UNetConfig,
                         tile: int = 512, halo: int = DEFAULT_HALO, amp: bool = False,
                         window_batch: int = 4) -> torch.Tensor:
    """``tiled_forward`` for any H, W: zero-pad right and bottom to multiples
    of 16, sweep, crop the logits back. Exact against a full-image forward of
    the padded image; near the padded border the crop can differ slightly
    from a forward of the unpadded one."""
    n, h, w, _ = x.shape
    ph, pw = padded_hw(h, w)
    if (ph, pw) == (h, w):
        return tiled_forward(params, state, x, config=config, tile=tile, halo=halo, amp=amp,
                             window_batch=window_batch)
    logger.warning("tiled inference: padding %dx%d -> %dx%d for the 16-aligned sweep "
                   "(logits cropped back; values near the padded right/bottom border "
                   "may differ slightly from full-image inference)", h, w, ph, pw)
    xp = F.pad(x, (0, 0, 0, pw - w, 0, ph - h))  # NHWC: C, then W, then H
    logits = tiled_forward(params, state, xp, config=config, tile=tile, halo=halo, amp=amp,
                           window_batch=window_batch)
    return logits[:, :h, :w]


def predict_img_tiled(params, state, config: UNetConfig, full_img: Image.Image, *,
                      tile: int = 512, halo: int = DEFAULT_HALO, scale_factor: float = 0.5,
                      out_threshold: float = 0.5, amp: bool = False, tta: bool = False,
                      tta_mode: str = "flips",
                      device: str | torch.device = "cuda") -> np.ndarray:
    """The tiled ``predict_img``: preprocess -> tiled forward -> upscale the
    logits to the original size -> threshold or argmax. ``tta``'s flip views
    are batch rows of the same sweep. An image too small for one window
    even after padding runs the full-image forward, with a warning."""
    device = resolve_device(device)
    need = min_halo(config)
    if halo < need:
        logger.warning("tiled predict: halo %d is below arch=%r's receptive-field "
                       "requirement — using halo=%d", halo, config.arch, need)
        halo = need
    with torch.inference_mode():
        params, state = (tree_map(lambda t: t.to(device), tree) for tree in (params, state))
        x = torch.from_numpy(preprocess(full_img, scale_factor))[None].to(device)
        if tta:
            x = tta_views(x, tta_mode)
        h, w = x.shape[1], x.shape[2]
        ph, pw = padded_hw(h, w)
        if tile + 2 * halo > min(ph, pw):
            logger.warning("tiled predict: window %d (tile %d + 2*halo %d) exceeds image "
                           "%dx%d — falling back to full-image inference (pass a smaller "
                           "--tile/--halo for real tiling)", tile + 2 * halo, tile, halo, h, w)
            logits, _ = unet_apply(params, state, x, config=config, train=False,
                                   compute_dtype=torch.bfloat16 if amp else None)
        else:
            logits = tiled_forward_padded(params, state, x, config=config, tile=tile,
                                          halo=halo, amp=amp)
        if tta:
            logits = tta_merge(logits, 1, tta_mode)
        full_w, full_h = full_img.size
        logits = resize_bilinear(logits, full_h, full_w, align_corners=False)
        return logits_to_mask(logits[0], config.n_classes, out_threshold)


def make_halo_sharded_forward(dp, config: UNetConfig, *, halo: int = DEFAULT_HALO,
                              amp: bool = False):
    """The multi-rank eval forward (JAX's ``make_halo_sharded_forward`` over a
    'spatial' mesh axis, here the ranks of ``dp``). Returns
    ``fn(params, state, xb) -> logits``: ``xb`` [N, B, W, C] is this rank's
    band, rows ``[iB, (i+1)B)`` of an image of H = B·W_ranks rows; the
    result is the whole image's fp32 logits [N, H, W, classes] on every rank.

    The halo rows travel in one all-gather of each rank's first and last
    2·halo rows (every rank takes its neighbours'); rank 0 has no rows
    before it and the last rank none after, where JAX's ring wraps rows
    round that its window then clips away, so the windows are JAX's. The
    cores travel in a second all-gather."""
    d, i = dp.world_size, dp.rank
    compute_dtype = torch.bfloat16 if amp else None

    def fn(params, state, xb: torch.Tensor) -> torch.Tensor:
        n, b, w, c = xb.shape
        h, win = b * d, b + 2 * halo
        for name, v in (("band", b), ("halo", halo), ("W", w)):
            if v % 16 != 0:
                raise ValueError(f"{name}={v} must be a multiple of 16 for exact tiling")
        if win > h:
            raise ValueError(f"window {win} exceeds image height {h}")
        if 2 * halo > b:
            raise ValueError(f"band {b} must be >= 2*halo={2 * halo} (each rank exchanges "
                             "2*halo rows with each neighbour); use fewer ranks or a taller "
                             "image")
        edges = torch.cat([xb[:, :2 * halo], xb[:, -2 * halo:]], dim=1).contiguous()
        got = [torch.empty_like(edges) for _ in range(d)]
        dist.all_gather(got, edges, group=dp.group)
        zeros = xb.new_zeros((n, 2 * halo, w, c))
        prev = got[i - 1][:, 2 * halo:] if i > 0 else zeros  # rows [iB - 2h, iB)
        nxt = got[i + 1][:, :2 * halo] if i < d - 1 else zeros  # rows [(i+1)B, (i+1)B + 2h)
        ext = torch.cat([prev, xb, nxt], dim=1)  # rows [iB - 2h, (i+1)B + 2h)
        band_start = i * b
        win_start = min(max(band_start - halo, 0), h - win)
        offset = win_start - (band_start - 2 * halo)
        logits, _ = unet_apply(params, state, ext[:, offset:offset + win], config=config,
                               train=False, compute_dtype=compute_dtype)
        core = logits[:, band_start - win_start:band_start - win_start + b].float().contiguous()
        cores = [torch.empty_like(core) for _ in range(d)]
        dist.all_gather(cores, core, group=dp.group)
        return torch.cat(cores, dim=1)

    return fn
