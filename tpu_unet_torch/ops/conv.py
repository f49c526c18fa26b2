"""Convolutions on NHWC activations and HWIO weights (the JAX package's
layouts, ``tpu_unet/ops/conv.py``), over ``F.conv2d`` and
``F.conv_transpose2d``.

These serve what the JAX package leaves to XLA outside its Pallas kernels:
the decoder's ConvTranspose k2 s2, the 1x1 ``outc`` head, and the plain
versions of the kernels. The dtype rule is the JAX one: fp32 in, fp32 out;
bf16 in, bf16 out (fp32 accumulation inside).

A float32 convolution on the GPU defaults to TF32 in cuDNN
(``torch.backends.cudnn.allow_tf32``), which keeps about three decimal
digits. The port's fp32 means fp32 on every device, so :func:`full_fp32`
turns TF32 off; the predictor, the predict CLI and ``chip_smoke.py`` call it
before running on the card.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def full_fp32() -> None:
    """Make float32 convolutions and matmuls on the GPU full fp32, not TF32."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(y: torch.Tensor) -> torch.Tensor:
    return y.permute(0, 2, 3, 1).contiguous()


def conv2d(x: torch.Tensor, w: torch.Tensor, *, stride: int = 1, padding: int = 0) -> torch.Tensor:
    """x: [N,H,W,Cin], w: [kH,kW,Cin,Cout] -> [N,H',W',Cout]; bias-free,
    zero padding, cross-correlation (``F.conv2d``)."""
    return _nhwc(F.conv2d(_nchw(x), w.permute(3, 2, 0, 1), stride=stride, padding=padding))


def conv_transpose2d(x: torch.Tensor, w: torch.Tensor, *, stride: int = 2,
                     padding: int = 0) -> torch.Tensor:
    """x: [N,H,W,Cin], w: [kH,kW,Cin,Cout] -> transposed conv, bias-free.

    Matches ``torch.nn.ConvTranspose2d(Cin, Cout, k, stride)`` whose weight
    (Cin, Cout, kH, kW) is ``w.permute(2, 3, 0, 1)``.
    """
    return _nhwc(F.conv_transpose2d(_nchw(x), w.permute(2, 3, 0, 1), stride=stride,
                                    padding=padding))
