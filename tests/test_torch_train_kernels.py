"""The port's train-conv wrappers (``tpu_unet_torch/kernels/train_conv.py``)
on CPU tensors, i.e. their plain PyTorch versions, against the JAX Pallas
kernels (``tpu_unet/kernels/train_conv.py``) in interpret mode, on the same
numpy inputs.

Tolerances, |port - jax| <= atol + rtol * |jax|:
- fp32 conv outputs (z, dx): 1e-4 + 1e-4 (fp32 sums in another order over at
  most 9 * 16 products);
- fp32 stats (sum z, sum z^2 over at most 480 pixels): 1e-3 + 1e-4;
- dw (a sum over N*H*W): max |port - jax| <= 1e-4 * max |jax|;
- bf16 cases check that the plain versions round where the Pallas kernels
  round (prologue output, staged dz, z before its stats, fp32 dx output):
  z and dx 2e-2 + 2e-2 (about two bf16 ulps), stats and dw within 1e-2 of
  their largest magnitude (a one-ulp flip of a few rounded values moves a
  sum by far less).
The CUDA kernels themselves run only on a GPU; chip_smoke.py holds them
against these plain versions there.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from tpu_unet.kernels.train_conv import (
    conv3x3_dw as j_dw,
    conv3x3_dx as j_dx,
    conv3x3_fwd as j_fwd,
)
from tpu_unet_torch import kernels as K
from tpu_unet_torch.kernels import _build
from tpu_unet_torch.kernels.train_conv import conv3x3_dw_plain, conv3x3_fwd_plain


def _np(a):
    return np.asarray(jnp.asarray(a, jnp.float32))


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)


def _j(a, dtype=jnp.float32):
    return jnp.asarray(np.asarray(a, np.float32)).astype(dtype)


def _inputs(rng, n, h, w, cin, cout, *, prologue):
    x = rng.standard_normal((n, h, w, cin), dtype=np.float32)
    wt = rng.standard_normal((3, 3, cin, cout), dtype=np.float32) * (9 * cin) ** -0.5
    if not prologue:
        return x, wt, None, None
    a = (0.5 + rng.random(cin)).astype(np.float32)
    c = (0.5 * rng.standard_normal(cin)).astype(np.float32)
    c[0] = 0.7  # relu(c) > 0: SAME padding must still read zeros
    return x, wt, a, c


def _coef(rng, c):
    return np.stack([np.ones(c, np.float32),
                     0.3 * rng.standard_normal(c, dtype=np.float32),
                     0.2 * rng.standard_normal(c, dtype=np.float32)])


def _close(got, ref, atol, rtol):
    np.testing.assert_allclose(np.asarray(got, np.float32), _np(ref), atol=atol, rtol=rtol)


def _close_to_scale(got, ref, frac):
    ref = _np(ref)
    err = np.abs(np.asarray(got, np.float32) - ref).max()
    assert err <= frac * np.abs(ref).max(), (err, np.abs(ref).max())


@pytest.fixture(autouse=True)
def _counts_stay_zero():
    """On CPU tensors the wrappers run their plain versions: no launch."""
    K.reset_launch_counts()
    yield
    assert all(n == 0 for n in K.launch_counts().values()), K.launch_counts()


@pytest.mark.parametrize("n,h,w,cin,cout,prologue", [
    (2, 12, 20, 8, 16, False),
    (2, 11, 17, 3, 8, False),   # inc's Cin = 3, odd H and W
    (2, 9, 14, 8, 16, True),
    (1, 13, 9, 16, 8, True),    # odd sizes, ragged 8 x 16 tiles
])
def test_conv3x3_fwd_with_stats_matches_pallas(rng, n, h, w, cin, cout, prologue):
    x, wt, a, c = _inputs(rng, n, h, w, cin, cout, prologue=prologue)
    with pltpu.force_tpu_interpret_mode():
        jz, js = j_fwd(*(_j(v) if v is not None else None for v in (x, wt, a, c)), stats=True)
    z, s = K.conv3x3_fwd(*(_t(v) if v is not None else None for v in (x, wt, a, c)), stats=True)
    assert z.shape == (n, h, w, cout) and s.shape == (2, cout) and s.dtype == torch.float32
    _close(z.numpy(), jz, 1e-4, 1e-4)
    _close(s.numpy(), js, 1e-3, 1e-4)


def test_conv3x3_fwd_without_stats_matches_pallas(rng):
    x, wt, a, c = _inputs(rng, 1, 8, 16, 8, 8, prologue=True)
    with pltpu.force_tpu_interpret_mode():
        jz = j_fwd(_j(x), _j(wt), _j(a), _j(c))
    z = K.conv3x3_fwd(_t(x), _t(wt), _t(a), _t(c))
    _close(z.numpy(), jz, 1e-4, 1e-4)


@pytest.mark.parametrize("out_dtype", [None, torch.float32])
def test_conv3x3_dx_matches_pallas(rng, out_dtype):
    n, h, w, cin, cout = 2, 9, 14, 8, 16
    wt = rng.standard_normal((3, 3, cin, cout), dtype=np.float32) * 0.1
    g = rng.standard_normal((n, h, w, cout), dtype=np.float32)
    z = rng.standard_normal((n, h, w, cout), dtype=np.float32)
    coef = _coef(rng, cout)
    with pltpu.force_tpu_interpret_mode():
        ref = j_dx(_j(g), _j(z), _j(coef), _j(wt))
    out = K.conv3x3_dx(_t(g), _t(z), _t(coef), _t(wt), out_dtype=out_dtype)
    assert out.shape == (n, h, w, cin) and out.dtype == torch.float32
    _close(out.numpy(), ref, 1e-4, 1e-4)


@pytest.mark.parametrize("n,h,w,cin,cout,prologue", [
    (2, 9, 14, 8, 16, False),
    (2, 9, 14, 8, 16, True),
    (2, 11, 17, 3, 8, False),   # Cin = 3: cropped back from the padded 8
    (1, 13, 9, 16, 8, True),
])
def test_conv3x3_dw_matches_pallas(rng, n, h, w, cin, cout, prologue):
    x, _, a, c = _inputs(rng, n, h, w, cin, cout, prologue=prologue)
    g = rng.standard_normal((n, h, w, cout), dtype=np.float32)
    z = rng.standard_normal((n, h, w, cout), dtype=np.float32)
    coef = _coef(rng, cout)
    pro = () if a is None else (a, c)
    with pltpu.force_tpu_interpret_mode():
        ref = j_dw(_j(x), _j(g), _j(z), _j(coef), *(_j(v) for v in pro))
    dw = K.conv3x3_dw(_t(x), _t(g), _t(z), _t(coef), *(_t(v) for v in pro))
    assert dw.shape == (3, 3, cin, cout) and dw.dtype == torch.float32
    _close_to_scale(dw.numpy(), ref, 1e-4)


def test_bf16_rounding_points_match_pallas(rng):
    """bf16 in: the prologue output, staged dz and z before its stats are
    rounded to bf16; the prologue variant's dx comes out in fp32."""
    n, h, w, cin, cout = 2, 9, 14, 8, 16
    x, wt, a, c = _inputs(rng, n, h, w, cin, cout, prologue=True)
    g = rng.standard_normal((n, h, w, cout), dtype=np.float32)
    z = rng.standard_normal((n, h, w, cout), dtype=np.float32)
    coef = _coef(rng, cout)
    bf, jbf = torch.bfloat16, jnp.bfloat16
    with pltpu.force_tpu_interpret_mode():
        jz, js = j_fwd(_j(x, jbf), _j(wt, jbf), _j(a), _j(c), stats=True)
        jdx = j_dx(_j(g, jbf), _j(z, jbf), _j(coef), _j(wt, jbf), out_dtype=jnp.float32)
        jdw = j_dw(_j(x, jbf), _j(g, jbf), _j(z, jbf), _j(coef), _j(a), _j(c))
    tz, ts = K.conv3x3_fwd(_t(x, bf), _t(wt, bf), _t(a), _t(c), stats=True)
    tdx = K.conv3x3_dx(_t(g, bf), _t(z, bf), _t(coef), _t(wt, bf), out_dtype=torch.float32)
    tdw = K.conv3x3_dw(_t(x, bf), _t(g, bf), _t(z, bf), _t(coef), _t(a), _t(c))
    assert tz.dtype == bf and jz.dtype == jbf and tdx.dtype == torch.float32
    _close(tz.float().numpy(), jz, 2e-2, 2e-2)
    _close_to_scale(ts.numpy(), js, 1e-2)
    _close(tdx.numpy(), jdx, 2e-2, 2e-2)
    _close_to_scale(tdw.numpy(), jdw, 1e-2)
    # The stats are those of the ROUNDED z: recomputing them from tz is exact
    # up to fp32 summation order, while the unrounded fp32 z's differ.
    zf = tz.float()
    torch.testing.assert_close(ts[1], (zf * zf).sum((0, 1, 2)), atol=1e-3, rtol=1e-5)


def test_prologue_zeroes_the_padding_after_the_affine():
    """relu(0*a + c) = relu(c) != 0 outside the image must not leak into the
    SAME padding, in fwd and dw: a zero input with c = 1 gives relu(c) = 1
    inside, so the border pixels see fewer ones than the interior."""
    x = torch.zeros(1, 4, 5, 1)
    w = torch.ones(3, 3, 1, 1)
    a, c = torch.ones(1), torch.ones(1)
    z = conv3x3_fwd_plain(x, w, a, c)[0, :, :, 0]
    assert z[1, 1] == 9 and z[0, 0] == 4 and z[0, 2] == 6
    g = torch.ones(1, 4, 5, 1)
    coef = torch.tensor([[1.0], [0.0], [0.0]])
    dw = conv3x3_dw_plain(x, g, torch.zeros_like(g), coef, a, c)[:, :, 0, 0]
    # tap (1, 1) sees all 20 pixels; a corner tap misses one row and column
    assert dw[1, 1] == 20 and dw[0, 0] == 12


def test_plain_versions_run_in_float64():
    """gradcheck needs the plain versions to keep float64."""
    x = torch.randn(1, 5, 6, 3, dtype=torch.float64)
    w = torch.randn(3, 3, 3, 4, dtype=torch.float64)
    z, s = K.conv3x3_fwd(x, w, stats=True)
    coef = torch.randn(3, 4, dtype=torch.float64)
    assert z.dtype == s.dtype == torch.float64
    assert K.conv3x3_dx(z, z, coef, w).dtype == torch.float64
    assert K.conv3x3_dw(x, z, z, coef).dtype == torch.float64


# The train kernels' fp32 exported C functions, by source: fwd, dx and dw
# on the tensor cores (3xTF32), whose CUDA-core exports are gone.
TRAIN_EXPORTS = [("tc_conv.cu", "tuk_tc_conv3x3_dx_f32"), ("tc_conv.cu", "tuk_tc_conv3x3_fwd_f32"),
                 ("tc_conv.cu", "tuk_tc_conv3x3_dw_f32")]
REMOVED_EXPORTS = ("tuk_conv3x3_fwd", "tuk_conv3x3_fwd_rows", "tuk_conv3x3_dw",
                   "tuk_conv3x3_dw_splits", "tuk_conv3x3_dx")


@pytest.mark.parametrize("source,name", TRAIN_EXPORTS)
def test_train_kernel_c_interface_matches_the_ctypes_signatures(source, name):
    """No compiler here: check that each exported C function of the train
    kernels takes as many parameters as its ctypes signature lists, that the
    removed CUDA-core fwd and dw exports are gone from both, and that the
    CUDA path's checks raise before any build."""
    x = torch.zeros(1, 4, 4, 3)
    with pytest.raises(ValueError, match="CUDA device"):
        _build.validate("conv3x3_fwd", x)
    assert {"train_conv.cu", source} <= {p.name for p in _build.sources()}
    assert name in _build._SIGNATURES
    src = (_build.CSRC_DIR / source).read_text()
    head = f'extern "C" int {name}('
    assert head in src, name
    params = src.split(head, 1)[1].split(")", 1)[0]
    assert params.count(",") + 1 == len(_build._SIGNATURES[name][0]), name
    train_src = (_build.CSRC_DIR / "train_conv.cu").read_text()
    for gone in REMOVED_EXPORTS:
        assert gone not in _build._SIGNATURES and f"int {gone}(" not in train_src, gone
