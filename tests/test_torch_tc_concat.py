"""The bf16 tensor-core routes of ``fused_conv3x3_concat_scale_relu`` and
``im2col_conv3x3`` (their fp32 routes: ``tests/test_torch_tc_fp32_dx_concat.py``
and ``tests/test_torch_tc_im2col_pool.py``) (``tpu_unet_torch/kernels/tc_conv.py``, kernel
``tc_conv_kernel`` in ``tpu_unet_torch/csrc/tc_conv.cu``) on the CPU, where
the kernel cannot run:

- the emulation of ``tests/test_torch_tc_conv.py`` read over two sources
  (the skip's 32-channel chunks, then the upsampled tensor's, whose chunk j
  meets the weight rows Ca + 32 j) equals the plain versions and the JAX
  Pallas kernels, with Ca of 8, 40 and 64 so that the skip's last chunk is
  partial (its zeros meet the upsampled tensor's first weight rows);
- the same emulation with im2col's epilogue, bf16 or fp32 output, equals
  ``im2col_conv3x3_plain`` and the Pallas im2col kernel (which sums the K =
  9·Cin products tap-major, the kernel chunk-major);
- the wrapper's channel padding to 8 per source keeps the function;
- the launchers refuse CPU tensors and tensors of any type but bf16 and
  fp32 (fp32 runs in 3xTF32). Their C interface, their
  routing and their ``.tc`` counts are checked with the other tensor-core
  routes' in ``tests/test_torch_tc_conv.py``.

Tolerances, |emulation - reference| <= atol + rtol * |reference|, as in
``tests/test_torch_tc_conv.py``: fp32 outputs 1e-4 + 1e-4 (the same exact
products summed in another order), bf16 outputs 2e-2 + 2e-2 (one bf16 ulp,
2^-8 relative, where a sum lands near a rounding boundary).
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from tests.test_torch_tc_conv import _close, _emulate
from tpu_unet.kernels.fused_conv import fused_conv3x3_concat_scale_relu as j_concat
from tpu_unet.kernels.im2col_conv import im2col_conv3x3 as j_im2col
from tpu_unet_torch.kernels import _build, tc_conv
from tpu_unet_torch.kernels.fused_conv import fused_conv3x3_concat_scale_relu_plain
from tpu_unet_torch.kernels.im2col_conv import im2col_conv3x3_plain

BF = torch.bfloat16


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)


def _concat_inputs(rng, n, h, w, ca, cb, cout, dtype):
    a = _t(rng.standard_normal((n, h, w, ca)), dtype)
    b = _t(rng.standard_normal((n, h, w, cb)), dtype)
    wt = _t(rng.standard_normal((3, 3, ca + cb, cout)) * (9 * (ca + cb)) ** -0.5, dtype)
    scale = _t(1.0 + 0.1 * rng.standard_normal(cout))
    bias = _t(0.1 * rng.standard_normal(cout))
    return a, b, wt, scale, bias


def _jnp(t):
    arr = jnp.asarray(t.float().numpy())
    return arr.astype(jnp.bfloat16) if t.dtype == BF else arr


def _np(j):
    return torch.from_numpy(np.array(j, np.float32))


# (Ca, Cb, Cout): Ca 8 and 40 leave the skip's last chunk partial; Cout <= 64
# and > 64 take the two block configurations.
CONCAT_WIDTHS = [(8, 16, 16), (40, 24, 72), (64, 64, 64)]


@pytest.mark.parametrize("dtype", [torch.float32, BF], ids=["fp32", "bf16"])
@pytest.mark.parametrize("relu", [False, True], ids=["linear", "relu"])
@pytest.mark.parametrize("ca,cb,cout", CONCAT_WIDTHS)
def test_emulated_concat_conv_matches_the_plain_version(rng, ca, cb, cout, relu, dtype):
    a, b, w, scale, bias = _concat_inputs(rng, 2, 11, 17, ca, cb, cout, dtype)
    got = _emulate(a, w, scale=scale, bias=bias, relu=relu, x2=b)
    assert got.dtype == dtype and got.shape == (2, 11, 17, cout)
    ref = fused_conv3x3_concat_scale_relu_plain(a, b, w, scale, bias, apply_relu=relu)
    _close(got, ref, dtype)


@pytest.mark.parametrize("n,h,w,ca,cb,cout", [(1, 13, 21, 8, 8, 16), (2, 9, 12, 40, 24, 72),
                                              (1, 35, 35, 16, 16, 128)])
def test_emulated_concat_conv_matches_pallas(rng, n, h, w, ca, cb, cout):
    """bf16, against the Pallas kernel in interpret mode (its two sources'
    partial sums per tap row, against the kernel's chunk order)."""
    a, b, wt, scale, bias = _concat_inputs(rng, n, h, w, ca, cb, cout, BF)
    with pltpu.force_tpu_interpret_mode():
        ref = j_concat(_jnp(a), _jnp(b), _jnp(wt), _jnp(scale), _jnp(bias))
    _close(_emulate(a, wt, scale=scale, bias=bias, relu=True, x2=b), _np(ref), BF)


@pytest.mark.parametrize("ca,cb", [(3, 5), (8, 13), (40, 24)])
def test_padded_sources_keep_the_function(rng, ca, cb):
    """The wrapper pads each source to 8 channels and w's rows to match; the
    padded concat conv is the unpadded one."""
    a, b, w, scale, bias = _concat_inputs(rng, 1, 6, 7, ca, cb, 12, torch.float32)
    (ap, bp), wp = tc_conv._padded_sources([a, b], w, 16)
    assert ap.shape[3] % 8 == bp.shape[3] % 8 == 0 and wp.shape == (3, 3, ap.shape[3]
                                                                      + bp.shape[3], 16)
    got = fused_conv3x3_concat_scale_relu_plain(ap, bp, wp, F.pad(scale, (0, 4)),
                                                F.pad(bias, (0, 4)))[..., :12]
    ref = fused_conv3x3_concat_scale_relu_plain(a, b, w, scale, bias)
    _close(got, ref, torch.float32)
    assert torch.equal(_emulate(ap, wp[..., :12], scale=scale, bias=bias, relu=True, x2=bp),
                       _emulate(a, w, scale=scale, bias=bias, relu=True, x2=b))


def _im2col_inputs(rng, shape, cout, dtype):
    cin = shape[-1]
    x = _t(rng.standard_normal(shape), dtype)
    w = _t(rng.standard_normal((3, 3, cin, cout)) * (9 * cin) ** -0.5, dtype)
    return x, w, _t(rng.standard_normal(cout)), _t(rng.standard_normal(cout))


@pytest.mark.parametrize("dtype,out_dtype", [(BF, BF), (BF, torch.float32),
                                             (torch.float32, torch.float32)],
                         ids=["bf16", "bf16-fp32out", "fp32"])
@pytest.mark.parametrize("relu", [False, True], ids=["linear", "relu"])
@pytest.mark.parametrize("shape,cout", [((2, 13, 20, 16), 8), ((2, 9, 11, 3), 64),
                                        ((1, 12, 14, 64), 72)])
def test_emulated_im2col_matches_the_plain_version(rng, shape, cout, relu, dtype, out_dtype):
    x, w, s, b = _im2col_inputs(rng, shape, cout, dtype)
    got = _emulate(x, w, scale=s, bias=b, relu=relu, out_dtype=out_dtype)
    assert got.dtype == out_dtype
    ref = im2col_conv3x3_plain(x, w, s, b, apply_relu=relu, out_dtype=out_dtype)
    _close(got, ref, out_dtype)


@pytest.mark.parametrize("out_dtype", [BF, torch.float32], ids=["bf16", "fp32out"])
@pytest.mark.parametrize("shape,cout", [((1, 16, 24, 8), 16), ((2, 13, 20, 16), 8)])
def test_emulated_im2col_matches_pallas(rng, shape, cout, out_dtype):
    """bf16 x against the Pallas kernel in interpret mode, both ``merged``
    settings, in both output dtypes."""
    x, w, s, b = _im2col_inputs(rng, shape, cout, BF)
    got = _emulate(x, w, scale=s, bias=b, relu=True, out_dtype=out_dtype)
    jdt = jnp.bfloat16 if out_dtype == BF else jnp.float32
    with pltpu.force_tpu_interpret_mode():
        for merged in (False, True):
            ref = j_im2col(_jnp(x), _jnp(w), _jnp(s), _jnp(b), apply_relu=True,
                           out_dtype=jdt, merged=merged)
            _close(got, _np(ref), out_dtype)


def test_tc_concat_and_im2col_launchers_refuse_cpu_and_fp32_tensors(monkeypatch):
    a = torch.zeros(1, 4, 4, 8, dtype=BF)
    w = torch.zeros(3, 3, 16, 8, dtype=BF)
    one, zero = torch.ones(8), torch.zeros(8)
    with pytest.raises(ValueError, match="CUDA device"):
        tc_conv.fused_conv3x3_concat(a, a, w, one, zero, True)
    with pytest.raises(ValueError, match="CUDA device"):
        tc_conv.im2col_conv3x3(a, w[:, :, :8], one, zero, False, BF)
    monkeypatch.setattr(_build, "validate", lambda kernel, *tensors: _build.DTYPE_F32)
    monkeypatch.setattr(_build, "library", lambda: pytest.fail("built a library"))
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        tc_conv.fused_conv3x3_concat(a.half(), a.half(), w.half(), one, zero, True)
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        tc_conv.im2col_conv3x3(a.half(), w[:, :, :8].half(), one, zero, False, torch.float32)
