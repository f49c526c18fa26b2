"""Skip-connection alignment (``tpu_unet/ops/padding.py``)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from tpu_unet_torch.parallel.halo import Band, fetch_rows


def pad_to_match(x1: torch.Tensor, x2: torch.Tensor, group=None) -> torch.Tensor:
    """Zero-pad NHWC ``x1`` so its H, W match ``x2``'s, floor half before and
    ceil half after, as the reference's ``Up.forward`` does.

    With ``group`` the skip x2's ``parallel.halo.Band``, x1 is the upsampled
    next level (``group.pooled().doubled()``): the H padding goes on the
    global top and bottom only, each rank taking the rows of its skip band
    (``fetch_rows``); the W padding stays local."""
    diff_x = x2.shape[-2] - x1.shape[-2]
    if isinstance(group, Band):
        src = group.pooled().doubled()
        top = (group.height - src.height) // 2
        x1 = fetch_rows(x1, src, [(lo - top, hi - top) for lo, hi in group.bounds])
        return F.pad(x1, (0, 0, diff_x // 2, diff_x - diff_x // 2)) if diff_x else x1
    diff_y = x2.shape[-3] - x1.shape[-3]
    if diff_y == 0 and diff_x == 0:
        return x1
    # F.pad lists the last dim first: (C, C, W, W, H, H).
    return F.pad(x1, (0, 0, diff_x // 2, diff_x - diff_x // 2,
                      diff_y // 2, diff_y - diff_y // 2))
