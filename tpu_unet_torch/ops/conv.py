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

``group`` a ``parallel.halo.Band`` (spatial parallelism: this rank's rows
of each image) runs the conv on the band: a 3x3 conv with padding 1 takes
one halo row from each neighbour and pads only W; a 1x1 conv and the 2x2
stride-2 ConvTranspose are row-local. Any other ``group`` is ignored.

Every library conv of the port, forward and backward, runs under one rule
for cuDNN's engine choice (:func:`cudnn_engine_rule`, ``CUDNN_ENGINE_RULE``).
"""

from __future__ import annotations

import os

import torch
import torch.nn.functional as F

from tpu_unet_torch.parallel.halo import Band, halo_rows, local


def full_fp32() -> None:
    """Make float32 convolutions and matmuls on the GPU full fp32, not TF32."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


# torch's cuDNN convs take the first engine of cuDNN's heuristic that runs:
# its "instant" mode unless this variable is 1, which asks for mode B. On
# the H100 (torch 2.11, cuDNN 9.22, TF32 off) the instant mode gives fp32
# forward convs with Cout = 128 at about 160 x 239 an FFT engine with a
# workspace of Cin·Cout·0.53 MiB (33.7 GiB for [4,512,160,239] x
# [128,512,3,3]) that runs 60-90x slower than the implicit GEMM mode B
# picks (0.44 GiB, 4.95 ms against 399 ms); the plain fp32 train steps run
# 5-15% faster under mode B and the bf16 one as fast (PERF.md §6, PR 21,
# ``tools/conv_workspace.py``). cuDNN's own cap, ``CUDNN_CONV_WSCAP_DBG``,
# leaves that forward engine in place on this path (measured at 256, 1024
# and 4096 MiB), and the v7 API that honours a cap runs the steps 4-14x
# slower, so the rule is the engine choice.
CUDNN_ENGINE_RULE = ("TORCH_CUDNN_USE_HEURISTIC_MODE_B", "1")


def cudnn_engine_rule() -> None:
    """Put ``CUDNN_ENGINE_RULE`` in the process's environment, where torch
    reads it once, at the process's first cuDNN conv; it then holds for
    every conv after, forward and backward, autograd's included. Every
    library conv of the port calls this before it runs (``conv2d``,
    ``conv_transpose2d``, the halo conv's forward and backward, the CRF's
    blurs), so in the port's processes it is set before the first one;
    ``chip_smoke.py`` calls it first, as it times library calls of its own.
    Raises where the rule cannot hold: the variable set to another value,
    or torch's cuDNN v8 API (which reads it) disabled. A no-op while a
    graph is traced (``torch.export``): the process sets it when it runs."""
    if torch.compiler.is_compiling():
        return
    name, value = CUDNN_ENGINE_RULE
    have = os.environ.setdefault(name, value)
    if have != value:
        raise RuntimeError(f"the port's cuDNN engine rule needs {name}={value}, and the "
                           f"environment sets {name}={have!r}")
    if os.environ.get("TORCH_CUDNN_V8_API_DISABLED", "0").upper() not in ("", "0", "OFF", "NO",
                                                                        "FALSE", "N"):
        raise RuntimeError(f"the port's cuDNN engine rule ({name}={value}) needs torch's "
                           "cuDNN v8 API, and TORCH_CUDNN_V8_API_DISABLED turns it off")


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(y: torch.Tensor) -> torch.Tensor:
    return y.permute(0, 2, 3, 1).contiguous()


class _HaloConv3x3(torch.autograd.Function):
    """conv3x3(window, padding (0, 1)), window = [halo top | x | halo
    bottom] (one row each): the window is rebuilt in the backward, not kept,
    so a rank holds only its band. A band of no rows gives none."""

    @staticmethod
    def forward(ctx, x, halo, w):
        cudnn_engine_rule()
        ctx.save_for_backward(x, halo, w)
        if x.shape[1] == 0:
            return x.new_zeros((x.shape[0], 0, x.shape[2], w.shape[3]))
        win = torch.cat([halo[:, :1], x, halo[:, 1:]], 1)
        return _nhwc(F.conv2d(_nchw(win), w.permute(3, 2, 0, 1), padding=(0, 1)))

    @staticmethod
    def backward(ctx, gy):
        cudnn_engine_rule()
        x, halo, w = ctx.saved_tensors
        if x.shape[1] == 0:
            return torch.zeros_like(x), torch.zeros_like(halo), torch.zeros_like(w)
        win = torch.cat([halo[:, :1], x, halo[:, 1:]], 1)
        need_in = ctx.needs_input_grad[0] or ctx.needs_input_grad[1]
        gin, gw, _ = torch.ops.aten.convolution_backward(
            _nchw(gy.contiguous()), _nchw(win), w.permute(3, 2, 0, 1), None, [1, 1], [0, 1],
            [1, 1], False, [0, 0], 1, [need_in, ctx.needs_input_grad[2], False])
        gx = ghalo = None
        if need_in:
            gin = _nhwc(gin)
            gx, ghalo = gin[:, 1:-1], torch.cat([gin[:, :1], gin[:, -1:]], 1)
        return gx, ghalo, None if gw is None else gw.permute(2, 3, 1, 0)


def conv2d(x: torch.Tensor, w: torch.Tensor, *, stride: int = 1, padding: int = 0,
           group=None) -> torch.Tensor:
    """x: [N,H,W,Cin], w: [kH,kW,Cin,Cout] -> [N,H',W',Cout]; bias-free,
    zero padding, cross-correlation (``F.conv2d``); on a ``Band``'s rows
    with ``group`` (module docstring)."""
    cudnn_engine_rule()
    if isinstance(group, Band):
        if tuple(w.shape[:2]) == (3, 3) and stride == 1 and padding == 1:
            return _HaloConv3x3.apply(x, halo_rows(x, 1, group), w)
        if tuple(w.shape[:2]) == (1, 1) and stride == 1 and padding == 0:
            return local(lambda t: conv2d(t, w), x, group)
        raise ValueError(f"conv2d on a spatial band: a {tuple(w.shape[:2])} kernel at stride "
                         f"{stride}, padding {padding} is not a layer of the models")
    return _nhwc(F.conv2d(_nchw(x), w.permute(3, 2, 0, 1), stride=stride, padding=padding))


def conv_transpose2d(x: torch.Tensor, w: torch.Tensor, *, stride: int = 2,
                     padding: int = 0, group=None) -> torch.Tensor:
    """x: [N,H,W,Cin], w: [kH,kW,Cin,Cout] -> transposed conv, bias-free.

    Matches ``torch.nn.ConvTranspose2d(Cin, Cout, k, stride)`` whose weight
    (Cin, Cout, kH, kW) is ``w.permute(2, 3, 0, 1)``. With a ``Band``
    ``group``, the kernel k = stride without padding makes it row-local:
    the band's rows give rows ``[stride·lo, stride·hi)`` of the output.
    """
    cudnn_engine_rule()
    if isinstance(group, Band):
        if not (w.shape[0] == stride and padding == 0):
            raise ValueError("conv_transpose2d on a spatial band needs kernel = stride, "
                             "padding 0")
        return local(lambda t: conv_transpose2d(t, w, stride=stride), x, group, scale=stride)
    return _nhwc(F.conv_transpose2d(_nchw(x), w.permute(2, 3, 0, 1), stride=stride,
                                    padding=padding))
