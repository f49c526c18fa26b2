"""The reference's optimizer (RMSprop) and gradient clipping."""

from tpu_unet_torch.optim.rmsprop import (
    RMSpropState,
    clip_grad_norm,
    rmsprop_init,
    rmsprop_update,
)

__all__ = ["RMSpropState", "clip_grad_norm", "rmsprop_init", "rmsprop_update"]
