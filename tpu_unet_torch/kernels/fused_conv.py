"""Fused 3x3 SAME conv + folded-BN scale/bias + ReLU on NHWC: the port of
``tpu_unet/kernels/fused_conv.py`` (``fused_conv3x3_scale_relu`` and
``fused_conv3x3_concat_scale_relu``) as hand-written CUDA kernels. Both run
on the tensor cores in bf16 and in fp32 (``csrc/tc_conv.cu``, through
``kernels/tc_conv.py``; the concat's K chunks come from the skip, then from
the upsampled tensor; fp32 in 3xTF32: each operand split into a TF32 high
part and the TF32 rounding of the rest, three products summed in fp32, so
fp32 accuracy is kept). The source's header says what bounds them on the
H100 and how the design answers.

Each wrapper launches a kernel for CUDA tensors and runs its plain PyTorch
version (``*_plain``) for CPU tensors. It never falls back: a failed build or
launch raises. ``<wrapper>.launches`` counts the kernel launches, and
``<wrapper>.tc_launches`` those on the tensor cores (all of them).

Numerics, as in the Pallas kernels: inputs and weights in the input dtype
(fp32 or bf16), fp32 accumulation, scale and bias upcast to fp32, the
epilogue in fp32, one rounding to the output dtype (the input's).
"""

from __future__ import annotations

import threading

import torch

from tpu_unet_torch.kernels import _build, tc_conv
from tpu_unet_torch.ops.conv import conv2d

_count_lock = threading.Lock()


def fused_conv3x3_scale_relu_plain(x, w, scale, bias, *, apply_relu: bool = True):
    """relu(conv3x3_same(x, w) * scale + bias) in plain PyTorch, computed in
    fp32 from the given (possibly bf16) values and rounded once at the end."""
    y = conv2d(x.float(), w.float(), stride=1, padding=1)
    y = y * scale.float() + bias.float()
    if apply_relu:
        y = torch.relu(y)
    return y.to(x.dtype)


def fused_conv3x3_concat_scale_relu_plain(a, b, w, scale, bias, *, apply_relu: bool = True):
    """The concat variant in plain PyTorch: it does build the concat."""
    return fused_conv3x3_scale_relu_plain(torch.cat([a, b], dim=-1), w, scale, bias,
                                          apply_relu=apply_relu)


def _count(wrapper) -> None:
    with _count_lock:
        wrapper.launches += 1
        wrapper.tc_launches += 1


def _launch(wrapper, a, b, w, scale, bias, apply_relu):
    """Launch the tensor-core kernel of ``wrapper`` and count the launch."""
    name = wrapper.__name__
    tensors = (a, w) if b is None else (a, b, w)
    _build.validate(name, *tensors)
    if a.ndim != 4 or (b is not None and (b.ndim != 4 or b.shape[:3] != a.shape[:3])):
        raise ValueError(f"{name}: inputs must be [N,H,W,C] with equal N,H,W")
    ca = a.shape[3]
    cb = 0 if b is None else b.shape[3]
    if w.ndim != 4 or tuple(w.shape[:3]) != (3, 3, ca + cb):
        raise ValueError(f"{name}: weight must be [3,3,{ca + cb},Cout], got {tuple(w.shape)}")
    cout = w.shape[3]
    s = _build.f32_vector(scale, cout, a, name)
    t = _build.f32_vector(bias, cout, a, name)
    if b is None:
        out = tc_conv.fused_conv3x3(a, w, s, t, apply_relu)
    else:
        out = tc_conv.fused_conv3x3_concat(a, b, w, s, t, apply_relu)
    _count(wrapper)
    return out


def fused_conv3x3_scale_relu(x, w, scale, bias, *, apply_relu: bool = True):
    """y = [relu](conv3x3_same(x, w) * scale + bias). x: [N,H,W,Cin],
    w: [3,3,Cin,Cout] -> [N,H,W,Cout] in x's dtype."""
    if x.device.type == "cpu":
        return fused_conv3x3_scale_relu_plain(x, w, scale, bias, apply_relu=apply_relu)
    return _launch(fused_conv3x3_scale_relu, x, None, w, scale, bias, apply_relu)


def fused_conv3x3_concat_scale_relu(a, b, w, scale, bias, *, apply_relu: bool = True):
    """[relu](conv3x3_same(concat([a, b], -1), w) * scale + bias) without
    building the concat. a: [N,H,W,Ca] (skip), b: [N,H,W,Cb] (upsampled),
    w: [3,3,Ca+Cb,Cout]."""
    if a.device.type == "cpu":
        return fused_conv3x3_concat_scale_relu_plain(a, b, w, scale, bias, apply_relu=apply_relu)
    return _launch(fused_conv3x3_concat_scale_relu, a, b, w, scale, bias, apply_relu)


fused_conv3x3_scale_relu.launches = 0
fused_conv3x3_scale_relu.tc_launches = 0
fused_conv3x3_concat_scale_relu.launches = 0
fused_conv3x3_concat_scale_relu.tc_launches = 0
