"""Dice coefficient and loss, and IoU (``tpu_unet/losses/dice.py``).

The reference's semantics: inter = 2·Σ(x·y); sets_sum = Σx + Σy, replaced by
inter where it is 0 (two empty masks score 1); dice = (inter + ε) /
(sets_sum + ε) with ε = 1e-6, averaged; multiclass folds N and C together;
dice_loss = 1 − dice with the batch reduced first. Binary masks are [N,H,W]
(or [H,W]), multiclass one-hots [N,H,W,C] (channels last).

``group`` (data parallelism, ``parallel/mesh.py``; JAX's ``axis_name``)
gives the global batch's value: with the batch reduced first the sums are
all-reduced before the division (one global ratio); per image, the ranks'
means are averaged (equal shards). ``iou_coeff`` is per image, so the
sharded evaluation averages its rank values (``evaluate.py``).

A ``parallel.mesh.Grid`` (spatial parallelism: each rank holds a height
band of its rows) sums each image's sums over the spatial group before its
ratio; with the batch reduced first, the sums go over the whole grid; per
image, the means over the data group.
"""

from __future__ import annotations

import torch

from tpu_unet_torch.parallel.mesh import group_size, psum


def dice_coeff(input: torch.Tensor, target: torch.Tensor, reduce_batch_first: bool = False,
               epsilon: float = 1e-6, group=None) -> torch.Tensor:
    """Mean Dice over the batch, or over one joint sum with
    ``reduce_batch_first``; over every rank of ``group``. input/target:
    [H,W] or [N,H,W]."""
    if input.shape != target.shape:
        raise ValueError(f"dice_coeff: shapes differ, {tuple(input.shape)} vs {tuple(target.shape)}")
    if reduce_batch_first and input.ndim != 3:
        raise ValueError("dice_coeff: reduce_batch_first needs [N,H,W] inputs")
    dims = (-1, -2) if input.ndim == 2 or not reduce_batch_first else (-1, -2, -3)
    inter = 2 * (input * target).sum(dims)
    sets_sum = input.sum(dims) + target.sum(dims)
    if group is not None and reduce_batch_first:
        inter, sets_sum = psum(torch.stack([inter, sets_sum]), group).unbind(0)
    elif hasattr(group, "spatial_group"):  # an image's sums over its bands
        inter, sets_sum = psum(torch.stack([inter, sets_sum]), group.spatial_group).unbind(0)
    sets_sum = torch.where(sets_sum == 0, inter, sets_sum)
    dice = ((inter + epsilon) / (sets_sum + epsilon)).mean()
    if group is not None and not reduce_batch_first:
        data = getattr(group, "data_group", group)
        dice = psum(dice, data) / group_size(data)
    return dice


def _fold_classes(t: torch.Tensor) -> torch.Tensor:
    """[N,H,W,C] -> [N*C,H,W], the reference's NCHW flatten(0, 1)."""
    n, h, w, c = t.shape
    return t.movedim(-1, 1).reshape(n * c, h, w)


def multiclass_dice_coeff(input: torch.Tensor, target: torch.Tensor,
                          reduce_batch_first: bool = False,
                          epsilon: float = 1e-6, group=None) -> torch.Tensor:
    """Mean Dice over all classes. input/target: [N,H,W,C] one-hot."""
    return dice_coeff(_fold_classes(input), _fold_classes(target), reduce_batch_first, epsilon,
                      group)


def dice_loss(input: torch.Tensor, target: torch.Tensor, multiclass: bool = False,
              group=None) -> torch.Tensor:
    """1 − Dice, with the batch reduced first (over every rank of ``group``)."""
    fn = multiclass_dice_coeff if multiclass else dice_coeff
    return 1 - fn(input, target, reduce_batch_first=True, group=group)


def iou_coeff(input: torch.Tensor, target: torch.Tensor, epsilon: float = 1e-6,
              group=None) -> torch.Tensor:
    """Mean IoU over the batch (binary [N,H,W] or one-hot [N,H,W,C]); IoU 1
    when both masks are empty. A grid's ``group`` sums each image's sums
    over its bands first; the mean is this rank's rows'."""
    if input.ndim == 4:
        input, target = _fold_classes(input), _fold_classes(target)
    inter = (input * target).sum((-1, -2))
    sums = input.sum((-1, -2)) + target.sum((-1, -2))
    if hasattr(group, "spatial_group"):
        inter, sums = psum(torch.stack([inter, sums]), group.spatial_group).unbind(0)
    union = sums - inter
    union = torch.where(union == 0, inter, union)
    return ((inter + epsilon) / (union + epsilon)).mean()
