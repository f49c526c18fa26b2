"""The port's ``im2col_conv3x3`` against the JAX package's Pallas kernel in
interpret mode, on the CPU, where the wrapper runs its plain version
(``im2col_conv3x3_plain``): both ``merged`` settings of the JAX kernel, with
and without ReLU, at the shapes of ``tests/test_kernels.py``'s
``test_im2col_conv_matches_xla`` (odd H/W slab remainders) plus Cin = 3.

Tolerance 1e-4 absolute + 1e-4 relative in fp32: the two sum the same
9·Cin products in fp32 in different orders. A bf16 output (``out_dtype``) is
held to one bf16 ulp of the fp32 value (at most 2^-7 relative) plus
1e-4: a sum that lands near a rounding boundary may round either way.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from tpu_unet.kernels.im2col_conv import im2col_conv3x3 as j_im2col
from tpu_unet_torch import kernels as K
from tpu_unet_torch.kernels.im2col_conv import im2col_conv3x3, im2col_conv3x3_plain

ATOL = RTOL = 1e-4


def _inputs(shape, cout, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape, dtype=np.float32)
    w = rng.standard_normal((3, 3, shape[-1], cout), dtype=np.float32) * 0.1
    s = rng.standard_normal(cout, dtype=np.float32)
    b = rng.standard_normal(cout, dtype=np.float32)
    return x, w, s, b


@pytest.mark.parametrize("shape,cout", [((1, 16, 24, 8), 16), ((2, 13, 20, 16), 8),
                                        ((2, 9, 11, 3), 64)])
@pytest.mark.parametrize("relu", [False, True])
def test_im2col_matches_jax(shape, cout, relu):
    x, w, s, b = _inputs(shape, cout)
    got = im2col_conv3x3(*(torch.from_numpy(a) for a in (x, w, s, b)), apply_relu=relu)
    assert got.shape == shape[:3] + (cout,) and got.dtype == torch.float32
    with pltpu.force_tpu_interpret_mode():
        for merged in (False, True):
            ref = j_im2col(*(jnp.asarray(a) for a in (x, w, s, b)), apply_relu=relu,
                           merged=merged)
            np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL, rtol=RTOL,
                                       err_msg=f"merged={merged}")


def test_im2col_out_dtype_bf16():
    x, w, s, b = _inputs((2, 13, 20, 16), 8, seed=1)
    tx = [torch.from_numpy(a) for a in (x, w, s, b)]
    got = im2col_conv3x3(*tx, apply_relu=True, out_dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    with pltpu.force_tpu_interpret_mode():
        ref = j_im2col(*(jnp.asarray(a) for a in (x, w, s, b)), apply_relu=True,
                       out_dtype=jnp.bfloat16)
    ref32 = np.asarray(ref.astype(jnp.float32))
    np.testing.assert_allclose(got.float().numpy(), ref32, atol=ATOL, rtol=2.0 ** -7)
    # The rounding is the last step: the bf16 output is the fp32 one, rounded.
    full = im2col_conv3x3(*tx, apply_relu=True)
    assert torch.equal(got, full.to(torch.bfloat16))


def test_im2col_plain_is_the_conv():
    """The plain version's patch order is the flattened weights' order: it
    equals a library conv with the scale folded in."""
    x, w, s, b = _inputs((1, 7, 5, 4), 6, seed=2)
    tx, tw, ts, tb = (torch.from_numpy(a) for a in (x, w, s, b))
    got = im2col_conv3x3_plain(tx, tw, ts, tb)
    ref = torch.nn.functional.conv2d(tx.permute(0, 3, 1, 2), (tw * ts).permute(3, 2, 0, 1),
                                     tb, padding=1).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=ATOL, rtol=RTOL)


def test_im2col_wrapper_counts_only_kernel_launches():
    x, w, s, b = (torch.from_numpy(a) for a in _inputs((1, 4, 4, 3), 2))
    K.reset_launch_counts()
    im2col_conv3x3(x, w, s, b)
    assert K.launch_counts()["im2col_conv3x3"] == 0  # CPU: the plain version
    assert im2col_conv3x3 in K.WRAPPERS
