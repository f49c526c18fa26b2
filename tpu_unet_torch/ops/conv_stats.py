"""The train-path conv unit over the three train kernels
(``tpu_unet/ops/conv_stats.py``).

    z, (Σz, Σz²) = conv_stats(x, w[, a, c])
      = z = conv3x3_same(relu(x·a + c), w); sums over N, H, W

The previous BatchNorm's normalize + ReLU rides this conv's input staging
(the prologue) and this conv's batch statistics ride its epilogue
(``kernels/train_conv.py``). The op exposes the RAW sums; mean and variance
are finalized in plain differentiable torch outside it, so the sum
cotangents (gΣ, gΣ²) reach the backward, where they collapse into the
per-channel affine dz = gz + 2·gΣ²·z + gΣ that the backward kernels build
while staging: dz never exists in device memory.

``double_conv_train_fused`` assembles the reference DoubleConv (conv → BN
(train) → ReLU, twice) from two of these ops.
"""

from __future__ import annotations

import torch

from tpu_unet_torch.kernels.train_conv import conv3x3_dw, conv3x3_dx, conv3x3_fwd
from tpu_unet_torch.ops.batchnorm import update_running
from tpu_unet_torch.parallel.mesh import group_size, psum

BN_EPS = 1e-5


def _dz_coef(gs: torch.Tensor | None, z: torch.Tensor) -> torch.Tensor:
    """[3, C] (α, β, γ) of dz = α·gz + β·z + γ from the sum cotangents
    gs = (gΣ, gΣ²): α = 1, β = 2·gΣ², γ = gΣ. A None gs is a zero one."""
    acc = torch.promote_types(z.dtype, torch.float32)
    if gs is None:
        gs = torch.zeros((2, z.shape[-1]), dtype=acc, device=z.device)
    gs = gs.to(acc)
    return torch.stack([torch.ones_like(gs[1]), 2.0 * gs[1], gs[0]])


def _cotangent(gz: torch.Tensor | None, z: torch.Tensor) -> torch.Tensor:
    return torch.zeros_like(z) if gz is None else gz.to(z.dtype).contiguous()


class ConvStatsRaw(torch.autograd.Function):
    """(z, [2, Cout] (Σz, Σz²)) = conv3x3_fwd(x, w, stats=True), no prologue
    (encoder inputs, decoder concats). ``compute_dx=False`` skips the
    transposed conv for an input that needs no gradient (the image)."""

    @staticmethod
    def forward(ctx, x, w, compute_dx: bool = True):
        z, s = conv3x3_fwd(x, w, stats=True)
        ctx.save_for_backward(x, w, z)
        ctx.compute_dx = compute_dx
        return z, s

    @staticmethod
    def backward(ctx, gz, gs):
        x, w, z = ctx.saved_tensors
        gz = _cotangent(gz, z)
        coef = _dz_coef(gs, z)
        dw = conv3x3_dw(x, gz, z, coef).to(w.dtype)
        dx = conv3x3_dx(gz, z, coef, w, out_dtype=x.dtype) if ctx.compute_dx else None
        return dx, dw, None


class ConvStatsPro(torch.autograd.Function):
    """(z, (Σz, Σz²)) = conv3x3_fwd(x, w, a, c, stats=True): x is a raw conv
    output and (a, c) its BN normalize affine, applied with the ReLU while
    staging. The prologue's backward (its ReLU mask, dx = dh·a and the
    channel sums da, dc) is plain torch, as the JAX package leaves it to XLA."""

    @staticmethod
    def forward(ctx, x, w, a, c):
        z, s = conv3x3_fwd(x, w, a, c, stats=True)
        ctx.save_for_backward(x, w, a, c, z)
        return z, s

    @staticmethod
    def backward(ctx, gz, gs):
        x, w, a, c, z = ctx.saved_tensors
        gz = _cotangent(gz, z)
        coef = _dz_coef(gs, z)
        acc = torch.promote_types(x.dtype, torch.float32)
        # Cotangent of h = relu(x·a + c), in the accumulation dtype.
        dh = conv3x3_dx(gz, z, coef, w, out_dtype=acc)
        dw = conv3x3_dw(x, gz, z, coef, a, c).to(w.dtype)
        xf, af = x.to(acc), a.to(acc)
        dhm = torch.where(xf * af + c.to(acc) > 0, dh, 0.0)
        dx = (dhm * af).to(x.dtype)
        da = (dhm * xf).sum((0, 1, 2)).to(a.dtype)
        dc = dhm.sum((0, 1, 2)).to(c.dtype)
        return dx, dw, da, dc


def double_conv_train_fused(params, state, x: torch.Tensor, *, input_needs_grad: bool = True,
                            momentum: float = 0.1, eps: float = BN_EPS,
                            group=None):
    """(conv3x3 → BN(train) → ReLU) × 2 on the train kernels. Returns
    (y in x's dtype, {"bn1": BNState, "bn2": BNState}).

    The same function as ``models/unet.py::_double_conv_apply(train=True)``:
    the biased batch variance (one-pass, clamped at 0) normalizes, the
    unbiased one goes into the running buffers. ``input_needs_grad=False``
    computes no dx for the first conv. ``group`` (data parallelism, JAX's
    ``axis_name``) all-reduces each conv's ``[2, C]`` sums outside the
    kernels and inside autograd, and counts every rank's elements: global
    batch statistics, and global sum cotangents into ``_dz_coef``. The
    kernels are the same."""
    m = x.shape[0] * x.shape[1] * x.shape[2] * group_size(group)

    def finalize(s):
        s = psum(s, group)
        mean = s[0] / m
        return mean, torch.clamp(s[1] / m - mean * mean, min=0.0)

    def affine(bn, mean, var):
        inv = bn["scale"].float() * torch.rsqrt(var + eps)
        return inv, bn["bias"].float() - mean * inv

    z1, s1 = ConvStatsRaw.apply(x, params["conv1"]["w"], input_needs_grad)
    mu1, var1 = finalize(s1)
    a1, c1 = affine(params["bn1"], mu1, var1)
    z2, s2 = ConvStatsPro.apply(z1, params["conv2"]["w"], a1, c1)
    mu2, var2 = finalize(s2)
    a2, c2 = affine(params["bn2"], mu2, var2)
    y = torch.relu(z2.float() * a2 + c2).to(x.dtype)
    new_state = {"bn1": update_running(state["bn1"], mu1, var1, m, momentum),
                 "bn2": update_running(state["bn2"], mu2, var2, m, momentum)}
    return y, new_state
