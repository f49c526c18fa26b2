"""Bilinear resize on NHWC with the JAX package's two conventions
(``tpu_unet/ops/resize.py``):

1. align_corners=True, the decoder's 2x upsample (``upsample2x_align_corners``);
2. half-pixel (align_corners=False) with the source coordinate clipped to
   [0, in - 1], the logit upscale of predict and serve.

Both are two separable 1-D gathers and lerps with indices and weights
computed on the host in float64, exactly as the JAX version computes them,
so the two agree to fp32 rounding.

``upsample2x_align_corners(group=)`` with a ``parallel.halo.Band`` upsamples
this rank's rows of each image: output row i of the global 2H reads source
rows ``floor(i·(H−1)/(2H−1))`` and the next, so a band takes a row from each
neighbour (``fetch_rows``) and clamps only at the global edges. Its rows
are the unsharded upsample's, value for value.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_unet_torch.parallel.halo import Band, fetch_rows


def _axis_indices_weights(in_size: int, out_size: int, align_corners: bool):
    """(lo, hi, w_hi) numpy arrays for 1-D linear interpolation."""
    if out_size == 1:
        src = np.zeros((1,), np.float64)
    elif align_corners:
        src = np.arange(out_size, dtype=np.float64) * (in_size - 1) / (out_size - 1)
    else:
        src = (np.arange(out_size, dtype=np.float64) + 0.5) * (in_size / out_size) - 0.5
        src = np.clip(src, 0.0, in_size - 1)
    lo = np.clip(np.floor(src).astype(np.int64), 0, in_size - 1)
    hi = np.minimum(lo + 1, in_size - 1)
    return lo, hi, (src - lo).astype(np.float32)


def _lerp_axis(x: torch.Tensor, dim: int, out_size: int, align_corners: bool) -> torch.Tensor:
    lo, hi, w_hi = _axis_indices_weights(x.shape[dim], out_size, align_corners)
    lo_t = torch.from_numpy(lo).to(x.device)
    hi_t = torch.from_numpy(hi).to(x.device)
    shape = [1] * x.ndim
    shape[dim] = out_size
    wt = torch.from_numpy(w_hi).to(x.device).view(shape)
    a = x.index_select(dim, lo_t)
    b = x.index_select(dim, hi_t)
    return a + (b - a) * wt


def resize_bilinear(x: torch.Tensor, out_h: int, out_w: int, *,
                    align_corners: bool) -> torch.Tensor:
    """Resize an NHWC (or HWC) tensor to (out_h, out_w); computed in fp32 and
    returned in the input dtype."""
    squeeze = x.ndim == 3
    if squeeze:
        x = x[None]
    xf = x.float()
    if xf.shape[1] != out_h:
        xf = _lerp_axis(xf, 1, out_h, align_corners)
    if xf.shape[2] != out_w:
        xf = _lerp_axis(xf, 2, out_w, align_corners)
    out = xf.to(x.dtype)
    return out[0] if squeeze else out


def upsample2x_align_corners(x: torch.Tensor, group=None) -> torch.Tensor:
    """2x bilinear upsample, align_corners=True: the bilinear decoder's Up.
    With a ``Band`` ``group``: this rank's rows ``group.doubled()`` of the
    output (module docstring)."""
    if not isinstance(group, Band):
        return resize_bilinear(x, 2 * x.shape[-3], 2 * x.shape[-2], align_corners=True)
    out = group.doubled()
    lo, hi, w_hi = _axis_indices_weights(group.height, out.height, True)
    want = [(int(lo[a]), int(hi[b - 1]) + 1) if b > a else src
            for (a, b), src in zip(out.bounds, group.bounds)]
    xf = fetch_rows(x, group, want).float()
    a, b = out.lo, out.hi
    start = want[group.grid.s][0]
    top = xf.index_select(1, torch.from_numpy(lo[a:b] - start).to(x.device))
    bottom = xf.index_select(1, torch.from_numpy(hi[a:b] - start).to(x.device))
    wt = torch.from_numpy(w_hi[a:b]).to(x.device).view(1, -1, 1, 1)
    y = top + (bottom - top) * wt
    return _lerp_axis(y, 2, 2 * x.shape[2], True).to(x.dtype)
