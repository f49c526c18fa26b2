"""BatchNorm running statistics (``tpu_unet/ops/batchnorm.py``).

The serving path folds BN into the conv that precedes it, so only the frozen
``(mean, var)`` state is needed here. The train-mode BN waits for the
training slice of the port.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class BNState(NamedTuple):
    """Running statistics for one BatchNorm layer. The field names are the
    checkpoint's keys (``state/inc/bn1/mean``)."""

    mean: torch.Tensor  # [C] float32
    var: torch.Tensor  # [C] float32


def init_bn_params(c: int, device=None) -> dict:
    return {"scale": torch.ones(c, device=device), "bias": torch.zeros(c, device=device)}


def init_bn_state(c: int, device=None) -> BNState:
    return BNState(mean=torch.zeros(c, device=device), var=torch.ones(c, device=device))
