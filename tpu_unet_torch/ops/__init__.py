"""NHWC tensor ops, the PyTorch counterparts of ``tpu_unet/ops``."""

from tpu_unet_torch.ops.batchnorm import BNState, batch_norm, init_bn_params, init_bn_state
from tpu_unet_torch.ops.conv import conv2d, conv_transpose2d, full_fp32
from tpu_unet_torch.ops.padding import pad_to_match
from tpu_unet_torch.ops.pooling import max_pool2d
from tpu_unet_torch.ops.resize import resize_bilinear, upsample2x_align_corners

__all__ = [
    "BNState",
    "batch_norm",
    "conv2d",
    "conv_transpose2d",
    "full_fp32",
    "init_bn_params",
    "init_bn_state",
    "max_pool2d",
    "pad_to_match",
    "resize_bilinear",
    "upsample2x_align_corners",
]
