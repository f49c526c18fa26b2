"""Hand-written CUDA kernels for the H100, one module per TPU kernel of
``tpu_unet/kernels``, each with its plain PyTorch version beside it: the
serving kernels (``fused_conv``, ``fused_double_conv``, ``pooling``), the
train kernels (``train_conv``) and ``im2col_conv``, an entry point of its
own that no model path calls (as in the JAX package); and
``multi_tensor``, the train step's gradient clip and RMSprop update over
every leaf in one launch, which replaces no TPU kernel.

The sources are ``tpu_unet_torch/csrc/*.cu``; ``_build`` compiles them with
``nvcc`` at the first launch. Importing these modules builds nothing.
"""

from tpu_unet_torch.kernels.fused_conv import (
    fused_conv3x3_concat_scale_relu,
    fused_conv3x3_scale_relu,
)
from tpu_unet_torch.kernels.fused_double_conv import FUSED_DC_MAX_CHANNELS, fused_double_conv
from tpu_unet_torch.kernels.im2col_conv import im2col_conv3x3
from tpu_unet_torch.kernels.multi_tensor import grad_sumsq, rmsprop_step, scale_to_norm
from tpu_unet_torch.kernels.pooling import max_pool2x2
from tpu_unet_torch.kernels.train_conv import conv3x3_dw, conv3x3_dx, conv3x3_fwd

# Every kernel wrapper, serving path, train path, then the stand-alone
# im2col conv, then the train step's clip and update; each carries a
# ``launches`` count.
WRAPPERS = (
    fused_conv3x3_scale_relu,
    fused_conv3x3_concat_scale_relu,
    fused_double_conv,
    max_pool2x2,
    conv3x3_fwd,
    conv3x3_dx,
    conv3x3_dw,
    im2col_conv3x3,
    grad_sumsq,
    scale_to_norm,
    rmsprop_step,
)


# The wrappers with a tensor-core route (bf16 and fp32, in 3xTF32); each
# also carries a ``tc_launches`` count.
TC_WRAPPERS = (
    fused_conv3x3_scale_relu,
    fused_conv3x3_concat_scale_relu,
    fused_double_conv,
    conv3x3_fwd,
    conv3x3_dx,
    conv3x3_dw,
    im2col_conv3x3,
)


def reset_launch_counts() -> None:
    for fn in WRAPPERS:
        fn.launches = 0
    for fn in TC_WRAPPERS:
        fn.tc_launches = 0
    fused_double_conv.pool_launches = 0


def launch_counts() -> dict[str, int]:
    """Launches per wrapper, under ``<wrapper>.tc`` those of the tensor-core
    route (included in the wrapper's own count), and under
    ``fused_double_conv.pool`` the double-conv launches that also wrote the
    2x2 max pool of their output (not counted under ``max_pool2x2``)."""
    counts = {fn.__name__: fn.launches for fn in WRAPPERS}
    counts.update({f"{fn.__name__}.tc": fn.tc_launches for fn in TC_WRAPPERS})
    counts["fused_double_conv.pool"] = fused_double_conv.pool_launches
    return counts


__all__ = [
    "FUSED_DC_MAX_CHANNELS",
    "WRAPPERS",
    "conv3x3_dw",
    "conv3x3_dx",
    "conv3x3_fwd",
    "fused_conv3x3_concat_scale_relu",
    "fused_conv3x3_scale_relu",
    "fused_double_conv",
    "grad_sumsq",
    "im2col_conv3x3",
    "launch_counts",
    "max_pool2x2",
    "reset_launch_counts",
    "rmsprop_step",
    "scale_to_norm",
]
