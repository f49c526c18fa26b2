"""The train-mode 3x3 conv kernels: the port of
``tpu_unet/kernels/train_conv.py`` (``conv3x3_fwd``, ``conv3x3_dx``,
``conv3x3_dw``, replacing the Pallas kernels at ``:128``, ``:289`` and
``:441``) as hand-written CUDA kernels. All three run on the tensor cores
(``csrc/tc_conv.cu``, through ``kernels/tc_conv.py``: dx with the forward's
mainloop and a dz loader, dw with a 9-tap GEMM over pixels), in bf16 and in
fp32. fp32 runs in 3xTF32: each fp32 operand is split into a TF32 high part
and the TF32 rounding of the rest, and lo*hi + hi*lo + hi*hi are summed in
fp32, about 2^-21 relative per product, so the fp32 results keep fp32
accuracy (one TF32 pass, about 2^-11, would not). All are bounded by their
2*9*Cin*Cout operations a pixel, not by bytes, except at level 0 where the
two about match. Each source's header says how the design answers and what
was tried and dropped.

Each wrapper launches its kernel for CUDA tensors and runs its plain PyTorch
version (``*_plain``) for CPU tensors. It never falls back: a failed build or
launch raises, and a CUDA tensor goes to the tensor-core launcher or
nowhere. ``<wrapper>.launches`` counts the wrapper's calls that launched,
and ``<wrapper>.tc_launches`` those on the tensor cores (counted after the
launcher returns); one call may make several kernel launches (fp32
``conv3x3_fwd`` and ``conv3x3_dx`` first split their weights;
``conv3x3_fwd`` with ``stats`` and ``conv3x3_dw`` end with the fixed-order
sum of their fp32 partials).

Numerics, as in the Pallas kernels: fp32 accumulation; the prologue
relu(x*a + c) computed in fp32 and rounded to x's dtype; the cotangent
dz = alpha*g + beta*z + gamma computed in fp32 and rounded to g's dtype; both
zero outside the image after the affine; the batch statistics taken from z
after its rounding to the output dtype. The plain versions compute in fp32
(float64 for float64 inputs, for ``gradcheck``) and round at the same points.
"""

from __future__ import annotations

import threading

import torch
import torch.nn.functional as F

from tpu_unet_torch.kernels import _build, tc_conv
from tpu_unet_torch.ops.conv import conv2d

_count_lock = threading.Lock()


def _acc(t: torch.Tensor) -> torch.Tensor:
    """``t`` in the accumulation dtype: fp32, or float64 for float64."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


def _prologue_plain(x, a, c):
    """relu(x*a + c) in the accumulation dtype, rounded to x's dtype."""
    return torch.relu(_acc(x) * _acc(a) + _acc(c)).to(x.dtype)


def _dz_plain(g, z, coef):
    """alpha*g + beta*z + gamma per channel, rounded to g's dtype."""
    coef = _acc(coef)
    return (coef[0] * _acc(g) + coef[1] * _acc(z) + coef[2]).to(g.dtype)


def conv3x3_fwd_plain(x, w, a=None, c=None, *, stats: bool = False):
    """z = conv3x3_same(relu(x*a + c) or x, w) in x's dtype; with ``stats``
    also (sum z, sum z^2) per channel as [2, Cout] in the accumulation dtype.
    conv2d's zero padding pads the prologue's output, as SAME padding must."""
    h = x if a is None else _prologue_plain(x, a, c)
    z = conv2d(_acc(h), _acc(w), stride=1, padding=1).to(x.dtype)
    if not stats:
        return z
    zf = _acc(z)
    return z, torch.stack([zf.sum((0, 1, 2)), (zf * zf).sum((0, 1, 2))])


def conv3x3_dx_plain(g, z, coef, w, *, out_dtype=None):
    """dx = conv3x3_same(dz, flip(w)^T), dz = alpha*g + beta*z + gamma, in
    ``out_dtype`` (g's by default)."""
    dz = _dz_plain(g, z, coef)
    wt = w.flip(0, 1).transpose(2, 3)
    return conv2d(_acc(dz), _acc(wt), stride=1, padding=1).to(out_dtype or g.dtype)


def conv3x3_dw_plain(x, g, z, coef, a=None, c=None):
    """dw[ky,kx,ci,co] = sum over N,H,W of prologue(x)[., y+ky-1, x+kx-1, ci]
    * dz[., y, x, co], [3,3,Cin,Cout] in the accumulation dtype."""
    _, h, wd, _ = x.shape
    hp = F.pad(_acc(x if a is None else _prologue_plain(x, a, c)), (0, 0, 1, 1, 1, 1))
    dz = _acc(_dz_plain(g, z, coef))
    taps = [torch.einsum("nhwi,nhwo->io", hp[:, ky:ky + h, kx:kx + wd], dz)
            for ky in range(3) for kx in range(3)]
    return torch.stack(taps).reshape(3, 3, x.shape[3], g.shape[3])


def _check_nhwc(name, *tensors):
    for t in tensors:
        if t.ndim != 4:
            raise ValueError(f"{name}: expected [N,H,W,C] tensors, got {tuple(t.shape)}")


def _count(wrapper, tc: bool = False) -> None:
    with _count_lock:
        wrapper.launches += 1
        if tc:
            wrapper.tc_launches += 1


def conv3x3_fwd(x, w, a=None, c=None, *, stats: bool = False):
    """z = conv3x3_same(relu(x*a + c), w) (no prologue when ``a`` is None).
    x: [N,H,W,Cin], w: [3,3,Cin,Cout] -> z [N,H,W,Cout] in x's dtype, and
    with ``stats`` the fp32 [2, Cout] (sum z, sum z^2) of the rounded z."""
    if x.device.type == "cpu":
        return conv3x3_fwd_plain(x, w, a, c, stats=stats)
    name = "conv3x3_fwd"
    _build.validate(name, x, w)
    _check_nhwc(name, x)
    cin = x.shape[3]
    if w.ndim != 4 or tuple(w.shape[:3]) != (3, 3, cin):
        raise ValueError(f"{name}: weight must be [3,3,{cin},Cout], got {tuple(w.shape)}")
    if (a is None) != (c is None):
        raise ValueError(f"{name}: the prologue needs both a and c")
    av = None if a is None else _build.f32_vector(a, cin, x, name)
    cv = None if c is None else _build.f32_vector(c, cin, x, name)
    out = tc_conv.conv3x3_fwd(x, w, av, cv, stats)
    _count(conv3x3_fwd, tc=True)
    return out


def conv3x3_dx(g, z, coef, w, *, out_dtype=None):
    """dx = conv3x3_same(dz, flip(w)^T) with dz = coef[0]*g + coef[1]*z +
    coef[2] built while staging. g, z: [N,H,W,C]; coef: [3, C]; w: the
    FORWARD weights [3,3,Cin,C] -> [N,H,W,Cin] in ``out_dtype`` (g's by
    default; fp32 from bf16 is allowed)."""
    if g.device.type == "cpu":
        return conv3x3_dx_plain(g, z, coef, w, out_dtype=out_dtype)
    name = "conv3x3_dx"
    out_dtype = out_dtype or g.dtype
    _build.validate(name, g, z, w)
    _check_nhwc(name, g, z)
    if z.shape != g.shape:
        raise ValueError(f"{name}: g and z must have one shape, {tuple(g.shape)} vs {tuple(z.shape)}")
    ch = g.shape[3]
    if w.ndim != 4 or w.shape[:2] != (3, 3) or w.shape[3] != ch:
        raise ValueError(f"{name}: weight must be [3,3,Cin,{ch}], got {tuple(w.shape)}")
    if out_dtype not in (torch.float32, g.dtype):
        raise ValueError(f"{name}: out_dtype must be float32 or g's dtype, got {out_dtype}")
    if coef.shape != (3, ch):
        raise ValueError(f"{name}: coef must be [3,{ch}], got {tuple(coef.shape)}")
    cf = coef.to(device=g.device, dtype=torch.float32).contiguous()
    out = tc_conv.conv3x3_dx(g, z, cf, w, out_dtype)
    _count(conv3x3_dx, tc=True)
    return out


def conv3x3_dw(x, g, z, coef, a=None, c=None):
    """dw [3,3,Cin,Cout] fp32: sum over N,H,W of prologue(x) patches times
    dz = coef[0]*g + coef[1]*z + coef[2] (both built while staging).
    x: [N,H,W,Cin]; g, z: [N,H,W,Cout]; a, c: [Cin] or None."""
    if x.device.type == "cpu":
        return conv3x3_dw_plain(x, g, z, coef, a, c)
    name = "conv3x3_dw"
    _build.validate(name, x, g, z)
    _check_nhwc(name, x, g, z)
    cin = x.shape[3]
    if g.shape[:3] != x.shape[:3] or z.shape != g.shape:
        raise ValueError(f"{name}: x, g, z must share N,H,W and g, z their shape")
    if (a is None) != (c is None):
        raise ValueError(f"{name}: the prologue needs both a and c")
    cout = g.shape[3]
    if coef.shape != (3, cout):
        raise ValueError(f"{name}: coef must be [3,{cout}], got {tuple(coef.shape)}")
    cf = coef.to(device=x.device, dtype=torch.float32).contiguous()
    av = None if a is None else _build.f32_vector(a, cin, x, name)
    cv = None if c is None else _build.f32_vector(c, cin, x, name)
    dw = tc_conv.conv3x3_dw(x, g, z, cf, av, cv)
    _count(conv3x3_dw, tc=True)
    return dw


conv3x3_fwd.launches = 0
conv3x3_fwd.tc_launches = 0
conv3x3_dx.launches = 0
conv3x3_dx.tc_launches = 0
conv3x3_dw.launches = 0
conv3x3_dw.tc_launches = 0
