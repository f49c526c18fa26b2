"""The training criterion's losses and the Dice/IoU metrics."""

from tpu_unet_torch.losses.classification import bce_with_logits, cross_entropy
from tpu_unet_torch.losses.dice import dice_coeff, dice_loss, iou_coeff, multiclass_dice_coeff

__all__ = [
    "bce_with_logits",
    "cross_entropy",
    "dice_coeff",
    "dice_loss",
    "iou_coeff",
    "multiclass_dice_coeff",
]
