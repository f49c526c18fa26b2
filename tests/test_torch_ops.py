"""PyTorch port ops (tpu_unet_torch.ops) against the JAX ops (tpu_unet.ops),
fp32 on the CPU, same numpy inputs. Tolerance 1e-5: the same math, summed in
another order by another library."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpu_unet import ops as jops
from tpu_unet_torch import ops as tops

TOL = dict(atol=1e-5, rtol=1e-5)


def _both(a: np.ndarray):
    return jnp.asarray(a), torch.from_numpy(a)


@pytest.mark.parametrize("shape,k,cout,padding", [
    ((1, 13, 21, 3), 3, 8, 1),
    ((2, 16, 9, 8), 3, 4, 1),
    ((1, 7, 11, 16), 1, 2, 0),
])
def test_conv2d_matches_jax(rng, shape, k, cout, padding):
    x = rng.standard_normal(shape, dtype=np.float32)
    w = rng.standard_normal((k, k, shape[-1], cout), dtype=np.float32) * 0.2
    ref = jops.conv2d(jnp.asarray(x), jnp.asarray(w), stride=1, padding=padding)
    out = tops.conv2d(torch.from_numpy(x), torch.from_numpy(w), stride=1, padding=padding)
    assert out.dtype == torch.float32 and out.is_contiguous()
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("shape,cout", [((1, 5, 7, 8), 4), ((2, 3, 4, 6), 3)])
def test_conv_transpose2d_matches_jax(rng, shape, cout):
    x = rng.standard_normal(shape, dtype=np.float32)
    w = rng.standard_normal((2, 2, shape[-1], cout), dtype=np.float32) * 0.3
    ref = jops.conv_transpose2d(jnp.asarray(x), jnp.asarray(w), stride=2)
    out = tops.conv_transpose2d(torch.from_numpy(x), torch.from_numpy(w), stride=2)
    assert out.shape == (shape[0], 2 * shape[1], 2 * shape[2], cout)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_conv_keeps_bf16(rng):
    """The JAX dtype rule: a bf16 conv returns bf16."""
    x = torch.from_numpy(rng.standard_normal((1, 6, 5, 4), dtype=np.float32)).bfloat16()
    w = torch.from_numpy(rng.standard_normal((3, 3, 4, 8), dtype=np.float32)).bfloat16()
    assert tops.conv2d(x, w, padding=1).dtype == torch.bfloat16
    wt = torch.from_numpy(rng.standard_normal((2, 2, 4, 2), dtype=np.float32)).bfloat16()
    assert tops.conv_transpose2d(x, wt, stride=2).dtype == torch.bfloat16


@pytest.mark.parametrize("shape", [(1, 16, 24, 8), (2, 17, 25, 4), (1, 13, 21, 3)])
def test_max_pool2d_matches_jax(rng, shape):
    x = rng.standard_normal(shape, dtype=np.float32)
    ref = jops.max_pool2d(jnp.asarray(x))
    out = tops.max_pool2d(torch.from_numpy(x))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


@pytest.mark.parametrize("src,dst", [((4, 6), (5, 7)), ((3, 3), (6, 3)), ((5, 8), (5, 8)),
                                     ((2, 2), (3, 5))])
def test_pad_to_match_matches_jax(rng, src, dst):
    x1 = rng.standard_normal((1, *src, 3), dtype=np.float32)
    x2 = np.zeros((1, *dst, 3), np.float32)
    ref = jops.pad_to_match(jnp.asarray(x1), jnp.asarray(x2))
    out = tops.pad_to_match(torch.from_numpy(x1), torch.from_numpy(x2))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


@pytest.mark.parametrize("align_corners", [False, True])
@pytest.mark.parametrize("src,dst", [((13, 21), (37, 50)), ((40, 30), (17, 11)),
                                     ((8, 8), (8, 19)), ((5, 7), (1, 1))])
def test_resize_bilinear_matches_jax(rng, src, dst, align_corners):
    x = rng.standard_normal((2, *src, 3), dtype=np.float32)
    ref = jops.resize_bilinear(jnp.asarray(x), *dst, align_corners=align_corners)
    out = tops.resize_bilinear(torch.from_numpy(x), *dst, align_corners=align_corners)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_resize_bilinear_hwc_and_dtype(rng):
    x = rng.standard_normal((9, 7, 2), dtype=np.float32)
    ref = jops.resize_bilinear(jnp.asarray(x), 18, 15, align_corners=False)
    out = tops.resize_bilinear(torch.from_numpy(x), 18, 15, align_corners=False)
    assert out.shape == (18, 15, 2)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    assert tops.resize_bilinear(torch.from_numpy(x).bfloat16(), 4, 4,
                                align_corners=True).dtype == torch.bfloat16


@pytest.mark.parametrize("shape", [(1, 5, 7, 4), (2, 6, 3, 2)])
def test_upsample2x_align_corners_matches_jax(rng, shape):
    x = rng.standard_normal(shape, dtype=np.float32)
    ref = jops.upsample2x_align_corners(jnp.asarray(x))
    out = tops.upsample2x_align_corners(torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
