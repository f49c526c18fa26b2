"""A whole folded-BN DoubleConv in one kernel: the port of
``tpu_unet/kernels/fused_double_conv.py::fused_double_conv`` as a
hand-written CUDA kernel, ``tpu_unet_torch/csrc/fused_double_conv.cu``. Its
header says what bounds it on the H100 and how the design answers.

``fused_double_conv`` launches the kernel for CUDA tensors and runs
``fused_double_conv_plain`` for CPU tensors. It never falls back: a failed
build or launch raises. ``fused_double_conv.launches`` counts the launches.

Numerics, as in the Pallas kernel: fp32 accumulation and epilogues, the mid
activation rounded to the input dtype (it is held in shared memory in that
dtype), the output in the input dtype.
"""

from __future__ import annotations

import threading

import torch

from tpu_unet_torch.kernels import _build
from tpu_unet_torch.kernels.fused_conv import fused_conv3x3_scale_relu_plain

# Channel ceiling of the fused path, as in the JAX package: unet_infer_apply
# routes a DoubleConv here when max(Cin, Cmid) <= this. On the H100 the bound
# is shared memory: the mid tile [Cmid, 10, 18] in fp32 at Cmid = 256 takes
# 180 KB of the 227 KB a block may use.
FUSED_DC_MAX_CHANNELS = 256

_count_lock = threading.Lock()


def fused_double_conv_plain(x, w1, scale1, bias1, w2, scale2, bias2):
    """relu(conv2(relu(conv1(x)·s1+b1))·s2+b2) in plain PyTorch, mid rounded
    to x's dtype between the convs."""
    mid = fused_conv3x3_scale_relu_plain(x, w1, scale1, bias1)
    return fused_conv3x3_scale_relu_plain(mid, w2, scale2, bias2)


def fused_double_conv(x, w1, scale1, bias1, w2, scale2, bias2):
    """x: [N,H,W,Cin], w1: [3,3,Cin,Cmid], w2: [3,3,Cmid,Cout] ->
    [N,H,W,Cout] in x's dtype; both convs 3x3 SAME with folded BN + ReLU."""
    if x.device.type == "cpu":
        return fused_double_conv_plain(x, w1, scale1, bias1, w2, scale2, bias2)
    name = "fused_double_conv"
    dtype = _build.validate(name, x, w1, w2)
    if x.ndim != 4:
        raise ValueError(f"{name}: expected [N,H,W,Cin], got {tuple(x.shape)}")
    n, h, wd, cin = x.shape
    if w1.ndim != 4 or tuple(w1.shape[:3]) != (3, 3, cin):
        raise ValueError(f"{name}: w1 must be [3,3,{cin},Cmid], got {tuple(w1.shape)}")
    cmid = w1.shape[3]
    if w2.ndim != 4 or tuple(w2.shape[:3]) != (3, 3, cmid):
        raise ValueError(f"{name}: w2 must be [3,3,{cmid},Cout], got {tuple(w2.shape)}")
    cout = w2.shape[3]
    lib = _build.library()
    smem = lib.tuk_double_conv_smem(cmid, dtype)
    limit = getattr(torch.cuda.get_device_properties(x.device),
                    "shared_memory_per_block_optin", None)
    if limit is not None and smem > limit:
        raise ValueError(f"{name}: Cmid={cmid} needs {smem} bytes of shared memory per "
                         f"block; this device allows {limit}")
    s1 = _build.f32_vector(scale1, cmid, x, name)
    b1 = _build.f32_vector(bias1, cmid, x, name)
    s2 = _build.f32_vector(scale2, cout, x, name)
    b2 = _build.f32_vector(bias2, cout, x, name)
    out = torch.empty((n, h, wd, cout), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        err = lib.tuk_double_conv(x.data_ptr(), cin, w1.data_ptr(), s1.data_ptr(), b1.data_ptr(),
                                  cmid, w2.data_ptr(), s2.data_ptr(), b2.data_ptr(), cout,
                                  out.data_ptr(), n, h, wd, dtype, _build.stream(x))
    _build.check(err, name)
    with _count_lock:
        fused_double_conv.launches += 1
    return out


fused_double_conv.launches = 0
