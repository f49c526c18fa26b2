"""Skip-connection alignment (``tpu_unet/ops/padding.py``)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def pad_to_match(x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """Zero-pad NHWC ``x1`` so its H, W match ``x2``'s, floor half before and
    ceil half after, as the reference's ``Up.forward`` does."""
    diff_y = x2.shape[-3] - x1.shape[-3]
    diff_x = x2.shape[-2] - x1.shape[-2]
    if diff_y == 0 and diff_x == 0:
        return x1
    # F.pad lists the last dim first: (C, C, W, W, H, H).
    return F.pad(x1, (0, 0, diff_x // 2, diff_x - diff_x // 2,
                      diff_y // 2, diff_y - diff_y // 2))
