"""Max pooling on NHWC (``tpu_unet/ops/pooling.py``): torch's
``MaxPool2d(window)``, floor mode (a trailing odd row or column is dropped).

``group`` a ``parallel.halo.Band`` pools this rank's rows of each image into
the next level's band (``Band.pooled``): local while the band starts on an
even row with an even count; otherwise the straddling row comes from the
rank below (``fetch_rows``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from tpu_unet_torch.parallel.halo import Band, fetch_rows


def max_pool2d(x: torch.Tensor, window: int = 2, stride: int | None = None,
               group=None) -> torch.Tensor:
    """x: [N,H,W,C] -> [N,H//window,W//window,C] (stride defaults to window)."""
    if isinstance(group, Band):
        if not (window == 2 and stride in (None, 2)):
            raise ValueError("max_pool2d on a spatial band is the 2x2 pool")
        out = group.pooled()
        x = fetch_rows(x, group, [(2 * lo, 2 * hi) for lo, hi in out.bounds])
        if not out.any_empty:
            return max_pool2d(x)
        # A rank with no output row pools two zero rows too, and drops them.
        rows = x.shape[1] // 2
        return max_pool2d(torch.cat([x, x.new_zeros((x.shape[0], 2, *x.shape[2:]))], 1)
                          ).narrow(1, 0, rows)
    y = F.max_pool2d(x.permute(0, 3, 1, 2), window, stride or window)
    return y.permute(0, 2, 3, 1).contiguous()
