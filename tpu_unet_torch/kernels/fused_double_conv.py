"""A whole folded-BN DoubleConv in one kernel: the port of
``tpu_unet/kernels/fused_double_conv.py::fused_double_conv`` as hand-written
CUDA kernel. It runs on the tensor cores in bf16 and in fp32 (3xTF32)
(``csrc/tc_double_conv.cu``, through ``kernels/tc_conv.py``: conv1 over the
tile plus its halo into a mid tile kept in shared memory, then conv2 from
it, the 2x2 max pool optionally folded into the epilogue). The source's
header says what bounds it on the H100 and how the design answers.

``fused_double_conv`` launches the kernel for CUDA tensors and runs
``fused_double_conv_plain`` for CPU tensors. It never falls back: a failed
build or launch raises. ``fused_double_conv.launches`` counts the launches,
``.tc_launches`` those on the tensor cores (all of them) and
``.pool_launches`` those that also wrote the pooled output.

With ``pool=True`` it returns ``(y, max_pool2x2(y))``: on a CUDA device the
kernel's epilogue computes the pool from the output tile it holds
(bit-identical: a max selects an input); on the CPU, both plain versions.

Numerics, as in the Pallas kernel: fp32 accumulation and epilogues, the mid
activation rounded to the input dtype (it is held in shared memory in that
dtype), the output in the input dtype.
"""

from __future__ import annotations

import threading

from tpu_unet_torch.kernels import _build, tc_conv
from tpu_unet_torch.kernels.fused_conv import fused_conv3x3_scale_relu_plain
from tpu_unet_torch.kernels.pooling import max_pool2x2_plain

# Channel ceiling of the fused path, as in the JAX package: unet_infer_apply
# routes a DoubleConv here when max(Cin, Cmid) <= this. On the H100 the bound
# is shared memory: at Cmid = 256 the mid tile and the rings of one block
# fill 225 KB (bf16, 6 x 30 tiles) and 220 KB (fp32, 8 x 10 tiles) of the
# 227 KB a block may use (kernels/tc_conv.py dc_smem).
FUSED_DC_MAX_CHANNELS = 256

_count_lock = threading.Lock()


def fused_double_conv_plain(x, w1, scale1, bias1, w2, scale2, bias2, *, pool: bool = False):
    """relu(conv2(relu(conv1(x)·s1+b1))·s2+b2) in plain PyTorch, mid rounded
    to x's dtype between the convs; with ``pool`` also ``max_pool2x2_plain``
    of it."""
    mid = fused_conv3x3_scale_relu_plain(x, w1, scale1, bias1)
    y = fused_conv3x3_scale_relu_plain(mid, w2, scale2, bias2)
    return (y, max_pool2x2_plain(y)) if pool else y


def _count(pool: bool) -> None:
    with _count_lock:
        fused_double_conv.launches += 1
        fused_double_conv.tc_launches += 1
        fused_double_conv.pool_launches += pool


def fused_double_conv(x, w1, scale1, bias1, w2, scale2, bias2, *, pool: bool = False):
    """x: [N,H,W,Cin], w1: [3,3,Cin,Cmid], w2: [3,3,Cmid,Cout] ->
    [N,H,W,Cout] in x's dtype; both convs 3x3 SAME with folded BN + ReLU.
    With ``pool``: (y, its 2x2 / stride-2 max pool [N,H//2,W//2,Cout])."""
    if x.device.type == "cpu":
        return fused_double_conv_plain(x, w1, scale1, bias1, w2, scale2, bias2, pool=pool)
    name = "fused_double_conv"
    _build.validate(name, x, w1, w2)
    if x.ndim != 4:
        raise ValueError(f"{name}: expected [N,H,W,Cin], got {tuple(x.shape)}")
    cin = x.shape[3]
    if w1.ndim != 4 or tuple(w1.shape[:3]) != (3, 3, cin):
        raise ValueError(f"{name}: w1 must be [3,3,{cin},Cmid], got {tuple(w1.shape)}")
    cmid = w1.shape[3]
    if w2.ndim != 4 or tuple(w2.shape[:3]) != (3, 3, cmid):
        raise ValueError(f"{name}: w2 must be [3,3,{cmid},Cout], got {tuple(w2.shape)}")
    cout = w2.shape[3]
    s1 = _build.f32_vector(scale1, cmid, x, name)
    b1 = _build.f32_vector(bias1, cmid, x, name)
    s2 = _build.f32_vector(scale2, cout, x, name)
    b2 = _build.f32_vector(bias2, cout, x, name)
    out, pooled = tc_conv.double_conv(x, w1, s1, b1, w2, s2, b2, pool)
    _count(pool=pool)
    return (out, pooled) if pool else out


fused_double_conv.launches = 0
fused_double_conv.tc_launches = 0
fused_double_conv.pool_launches = 0
