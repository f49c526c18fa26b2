"""Max pooling on NHWC (``tpu_unet/ops/pooling.py``): torch's
``MaxPool2d(window)``, floor mode (a trailing odd row or column is dropped)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def max_pool2d(x: torch.Tensor, window: int = 2, stride: int | None = None) -> torch.Tensor:
    """x: [N,H,W,C] -> [N,H//window,W//window,C] (stride defaults to window)."""
    y = F.max_pool2d(x.permute(0, 3, 1, 2), window, stride or window)
    return y.permute(0, 2, 3, 1).contiguous()
