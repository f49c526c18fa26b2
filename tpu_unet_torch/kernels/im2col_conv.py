"""3x3 SAME conv + scale/bias + optional ReLU as one K = 9·Cin contraction:
the port of ``tpu_unet/kernels/im2col_conv.py::im2col_conv3x3`` as a
hand-written CUDA kernel on the tensor cores (``csrc/tc_conv.cu``, through
``kernels/tc_conv.py``): the contraction is the implicit GEMM of the
folded-BN conv, its patch matrix never built, in bf16 or, for fp32 ``x``,
in 3xTF32 (fp32 accuracy). The output is stored in ``out_dtype`` from
either input dtype: fp32 from the accumulators, bf16 rounded once. The
source's header says what bounds it on the H100 and how the design answers.

Like the JAX kernel, it is an entry point of its own that no model path
calls. The wrapper launches the kernel for CUDA tensors and runs the plain
PyTorch version (``im2col_conv3x3_plain``) for CPU tensors; a failed build or
launch raises. ``im2col_conv3x3.launches`` counts the kernel launches, and
``im2col_conv3x3.tc_launches`` those on the tensor cores (all of them).

The JAX function's ``tile_h`` (rows of a VMEM slab) and ``merged`` (one
matmul per slab or one per row) choose a TPU layout and do not change the
result, so the port's signature leaves them out.

Numerics, as in the Pallas kernel: x and the flattened weights in x's dtype,
fp32 accumulation, scale and bias upcast to fp32, ``acc * scale + bias`` in
fp32, then ReLU, then one rounding to ``out_dtype`` (x's by default). The
kernel sums the same exact products (bf16; fp32 to about 2^-21 each in
3xTF32) in another order (32-channel chunks, 16 in fp32, the 9 taps inside
each, against the Pallas kernel's tap-major K).
"""

from __future__ import annotations

import threading

import torch
import torch.nn.functional as F

from tpu_unet_torch.kernels import _build, tc_conv

_count_lock = threading.Lock()


def _flat_weights(w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """HWIO [3,3,Cin,Cout] -> [9·Cin, Cout] in ``dtype``: row (3·dy+dx)·Cin + c."""
    if w.ndim != 4 or tuple(w.shape[:2]) != (3, 3):
        raise ValueError(f"im2col_conv3x3: weight must be [3,3,Cin,Cout], got {tuple(w.shape)}")
    return w.reshape(9 * w.shape[2], w.shape[3]).to(dtype)


def im2col_conv3x3_plain(x, w, scale, bias, *, apply_relu: bool = False, out_dtype=None):
    """The same function in plain PyTorch: the patch tensor is built (zero
    pad, nine shifted slices concatenated on the channel axis in (dy, dx)
    order) and one [N·H·W, 9·Cin] @ [9·Cin, Cout] product taken in fp32."""
    n, h, wd, cin = x.shape
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    patches = torch.cat([xp[:, dy:dy + h, dx:dx + wd] for dy in range(3) for dx in range(3)],
                        dim=-1)
    wflat = _flat_weights(w, x.dtype)
    acc = patches.reshape(n * h * wd, 9 * cin).float() @ wflat.float()
    y = acc * scale.float() + bias.float()
    if apply_relu:
        y = torch.relu(y)
    return y.reshape(n, h, wd, -1).to(out_dtype or x.dtype)


def im2col_conv3x3(x, w, scale, bias, *, apply_relu: bool = False, out_dtype=None):
    """y = [relu](conv3x3_same(x, w) * scale + bias). x: [N,H,W,Cin] fp32 or
    bf16; w: [3,3,Cin,Cout]; scale, bias: [Cout] -> [N,H,W,Cout] in
    ``out_dtype`` (fp32 or bf16; x's by default)."""
    if x.device.type == "cpu":
        return im2col_conv3x3_plain(x, w, scale, bias, apply_relu=apply_relu,
                                    out_dtype=out_dtype)
    name = "im2col_conv3x3"
    out_dtype = out_dtype or x.dtype
    wflat = _flat_weights(w, x.dtype).contiguous()
    if x.ndim != 4:
        raise ValueError(f"{name}: expected [N,H,W,Cin], got {tuple(x.shape)}")
    cin, cout = x.shape[3], w.shape[3]
    if w.shape[2] != cin:
        raise ValueError(f"{name}: weight must be [3,3,{cin},Cout], got {tuple(w.shape)}")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{name}: out_dtype must be float32 or bfloat16, got {out_dtype}")
    s = _build.f32_vector(scale, cout, x, name)
    t = _build.f32_vector(bias, cout, x, name)
    out = tc_conv.im2col_conv3x3(x, wflat.view(3, 3, cin, cout), s, t, apply_relu, out_dtype)
    _count()
    return out


def _count() -> None:
    with _count_lock:
        im2col_conv3x3.launches += 1
        im2col_conv3x3.tc_launches += 1


im2col_conv3x3.launches = 0
im2col_conv3x3.tc_launches = 0
