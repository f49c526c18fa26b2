"""The port's kernel wrappers on CPU tensors (their plain PyTorch versions)
against the JAX Pallas kernels in interpret mode, on the same numpy inputs.

Tolerances: pool exact (a max selects an input); single convs 1e-4; double
conv 1e-3 (two stacked convs, fp32 sums in another order). bf16 cases check
that the plain versions round where the Pallas kernels round (fp32 sums,
scale/bias upcast to fp32, one rounding per conv): 2e-2, about two bf16 ulps.
The CUDA kernels themselves run only on a GPU; chip_smoke.py holds them
against these plain versions there.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from tpu_unet.kernels.fused_conv import (
    fused_conv3x3_concat_scale_relu as j_concat_conv,
    fused_conv3x3_scale_relu as j_conv,
)
from tpu_unet.kernels.fused_double_conv import fused_double_conv as j_double_conv
from tpu_unet.kernels.pooling import max_pool2x2 as j_pool
from tpu_unet_torch import kernels as K
from tpu_unet_torch.kernels import _build


def _np(a):
    return np.asarray(jnp.asarray(a, jnp.float32))


def _conv_args(rng, cin, cout):
    w = rng.standard_normal((3, 3, cin, cout), dtype=np.float32) * (9 * cin) ** -0.5
    s = 1.0 + 0.2 * rng.standard_normal(cout, dtype=np.float32)
    b = 0.2 * rng.standard_normal(cout, dtype=np.float32)
    return w, s, b


def _bf16(arrays):
    """The same values as bf16 arrays for JAX and bf16 tensors for the port."""
    return ([jnp.asarray(a).astype(jnp.bfloat16) for a in arrays],
            [torch.from_numpy(a).bfloat16() for a in arrays])


@pytest.fixture(autouse=True)
def _counts_stay_zero():
    """On CPU tensors the wrappers run their plain versions: no launch."""
    K.reset_launch_counts()
    yield
    assert all(n == 0 for n in K.launch_counts().values()), K.launch_counts()


@pytest.mark.parametrize("shape", [(1, 16, 24, 8), (2, 17, 25, 4), (1, 13, 21, 3)])
def test_max_pool2x2_matches_pallas(rng, shape):
    x = rng.standard_normal(shape, dtype=np.float32)
    with pltpu.force_tpu_interpret_mode():
        ref = j_pool(jnp.asarray(x))
    out = K.max_pool2x2(torch.from_numpy(x))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


@pytest.mark.parametrize("shape,cout,relu", [
    ((1, 13, 21, 3), 8, True),
    ((1, 16, 60, 8), 16, True),
    ((2, 9, 12, 8), 8, False),
])
def test_fused_conv_matches_pallas(rng, shape, cout, relu):
    x = rng.standard_normal(shape, dtype=np.float32)
    w, s, b = _conv_args(rng, shape[-1], cout)
    with pltpu.force_tpu_interpret_mode():
        ref = j_conv(*(jnp.asarray(a) for a in (x, w, s, b)), apply_relu=relu)
    out = K.fused_conv3x3_scale_relu(*(torch.from_numpy(a) for a in (x, w, s, b)),
                                     apply_relu=relu)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("hw,ca,cb,cout", [((13, 21), 4, 6, 8), ((16, 24), 8, 8, 16)])
def test_fused_concat_conv_matches_pallas(rng, hw, ca, cb, cout):
    a = rng.standard_normal((2, *hw, ca), dtype=np.float32)
    bb = rng.standard_normal((2, *hw, cb), dtype=np.float32)
    w, s, b = _conv_args(rng, ca + cb, cout)
    with pltpu.force_tpu_interpret_mode():
        ref = j_concat_conv(*(jnp.asarray(v) for v in (a, bb, w, s, b)))
    out = K.fused_conv3x3_concat_scale_relu(*(torch.from_numpy(v) for v in (a, bb, w, s, b)))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("shape,cmid,cout", [
    ((1, 13, 21, 3), 8, 8),
    ((1, 16, 60, 8), 16, 16),
    ((2, 12, 20, 8), 16, 8),
])
def test_fused_double_conv_matches_pallas(rng, shape, cmid, cout):
    x = rng.standard_normal(shape, dtype=np.float32)
    w1, s1, b1 = _conv_args(rng, shape[-1], cmid)
    w2, s2, b2 = _conv_args(rng, cmid, cout)
    args = (x, w1, s1, b1, w2, s2, b2)
    with pltpu.force_tpu_interpret_mode():
        ref = j_double_conv(*(jnp.asarray(a) for a in args))
    out = K.fused_double_conv(*(torch.from_numpy(a) for a in args))
    assert out.shape == (*shape[:3], cout)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-3, rtol=1e-3)


@pytest.mark.parametrize("kernel", ["conv", "concat", "double"])
def test_bf16_rounding_matches_pallas(rng, kernel):
    x = rng.standard_normal((1, 9, 14, 8), dtype=np.float32)
    w1, s1, b1 = _conv_args(rng, 8, 16)
    w2, s2, b2 = _conv_args(rng, 16, 8)
    wc, sc, bc = _conv_args(rng, 16, 8)
    (jx, jw1, js1, jb1, jw2, js2, jb2, jwc, jsc, jbc), \
        (tx, tw1, ts1, tb1, tw2, ts2, tb2, twc, tsc, tbc) = _bf16(
            [x, w1, s1, b1, w2, s2, b2, wc, sc, bc])
    with pltpu.force_tpu_interpret_mode():
        if kernel == "conv":
            ref = j_conv(jx, jw1, js1, jb1)
        elif kernel == "concat":
            ref = j_concat_conv(jx, jx, jwc, jsc, jbc)
        else:
            ref = j_double_conv(jx, jw1, js1, jb1, jw2, js2, jb2)
    if kernel == "conv":
        out = K.fused_conv3x3_scale_relu(tx, tw1, ts1, tb1)
    elif kernel == "concat":
        out = K.fused_conv3x3_concat_scale_relu(tx, tx, twc, tsc, tbc)
    else:
        out = K.fused_double_conv(tx, tw1, ts1, tb1, tw2, ts2, tb2)
    assert out.dtype == torch.bfloat16 and ref.dtype == jnp.bfloat16
    np.testing.assert_allclose(out.float().numpy(), _np(ref), atol=2e-2, rtol=2e-2)


def test_plain_versions_are_the_wrappers_on_cpu(rng):
    from tpu_unet_torch.kernels.fused_double_conv import fused_double_conv_plain

    x = torch.from_numpy(rng.standard_normal((1, 7, 9, 3), dtype=np.float32))
    w1, s1, b1 = (torch.from_numpy(a) for a in _conv_args(rng, 3, 8))
    w2, s2, b2 = (torch.from_numpy(a) for a in _conv_args(rng, 8, 8))
    torch.testing.assert_close(K.fused_double_conv(x, w1, s1, b1, w2, s2, b2),
                               fused_double_conv_plain(x, w1, s1, b1, w2, s2, b2),
                               atol=0, rtol=0)


def test_build_module_imports_without_compiling(monkeypatch, tmp_path):
    """Importing the kernels builds nothing; a build with no nvcc raises a
    clear error instead of falling back."""
    names = {p.name for p in _build.sources()}
    assert {"pooling.cu", "tc_common.cuh", "tc_conv.cu", "tc_double_conv.cu"} <= names
    assert _build.library_path().name == f"libtuk_{_build.source_hash()}.so"
    assert _build.library_path().parent == _build.PACKAGE_DIR / "_build"
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.delenv("CUDA_PATH", raising=False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.find_nvcc()


def test_wrappers_refuse_what_the_kernels_do_not_take():
    x = torch.zeros(1, 4, 4, 3)
    with pytest.raises(ValueError, match="CUDA device"):
        _build.validate("k", x)
    with pytest.raises(ValueError, match=r"expected a \[8\] vector"):
        _build.f32_vector(torch.zeros(4), 8, x, "k")
