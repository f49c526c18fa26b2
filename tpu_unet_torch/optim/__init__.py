"""The optimizers (RMSprop, the reference's, and SGD/Adam/AdamW), gradient
clipping and the LR schedules."""

from tpu_unet_torch.optim.optimizers import (
    OPTIMIZERS,
    AdamState,
    SGDState,
    adam_init,
    adam_update,
    get_optimizer,
    sgd_init,
    sgd_update,
)
from tpu_unet_torch.optim.plateau import ReduceLROnPlateau
from tpu_unet_torch.optim.rmsprop import (
    RMSpropState,
    clip_grad_norm,
    clip_to_norm,
    rmsprop_init,
    rmsprop_update,
)
from tpu_unet_torch.optim.schedulers import (
    SCHEDULERS,
    ConstantLR,
    CosineAnnealingLR,
    StepLR,
    get_scheduler,
)

__all__ = [
    "OPTIMIZERS",
    "SCHEDULERS",
    "AdamState",
    "ConstantLR",
    "CosineAnnealingLR",
    "RMSpropState",
    "ReduceLROnPlateau",
    "SGDState",
    "StepLR",
    "adam_init",
    "adam_update",
    "clip_grad_norm",
    "clip_to_norm",
    "get_optimizer",
    "get_scheduler",
    "rmsprop_init",
    "rmsprop_update",
    "sgd_init",
    "sgd_update",
]
