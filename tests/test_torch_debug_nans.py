"""``--debug-nans`` in the port (``tpu_unet_torch/utils/debug_nans.py``)
against JAX's ``jax_debug_nans``: a NaN-poisoned image raises
``FloatingPointError`` in both train steps (base 8); a clean step is bitwise
the same with the mode on and off and raises nothing; buffers made by
``torch.empty*`` (the hand kernels' outputs, written through ctypes where
the mode cannot see) raise no false alarm, while a NaN written into one is
caught at its first aten consumer."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import tpu_unet.train as j_train
from tpu_unet.checkpoint import _flatten_with_paths
from tpu_unet.models import UNetConfig as JConfig, init_unet as j_init_unet
from tpu_unet.optim import rmsprop_init as j_rms_init
from tpu_unet_torch.checkpoint import from_jax_arrays
from tpu_unet_torch.data import synth_batch
from tpu_unet_torch.models.unet import UNetConfig, tree_leaves
from tpu_unet_torch.optim import rmsprop_init
from tpu_unet_torch.train import make_train_step
from tpu_unet_torch.utils.debug_nans import DebugNans

NAN = float("nan")


@pytest.fixture(scope="module")
def world():
    jcfg = JConfig(3, 1, False, base_channels=8)
    params, state = jax.device_get(j_init_unet(jax.random.PRNGKey(0), jcfg))
    flat = {"params/" + k: v for k, v in _flatten_with_paths(params).items()}
    flat.update({"state/" + k: v for k, v in _flatten_with_paths(state).items()})
    images, masks = synth_batch(np.random.default_rng(0), 2, 24, 32)
    poisoned = images.copy()
    poisoned[1, 5, 7, 2] = np.nan
    return dict(jcfg=jcfg, cfg=UNetConfig(3, 1, False, 8), jparams=params, jstate=state,
                flat=flat, images=images, poisoned=poisoned, masks=masks)


def _port_step(world, images, kernels, amp=False):
    params, state = from_jax_arrays(world["flat"])
    step = make_train_step(world["cfg"], kernels=kernels, amp=amp, return_grads=True)
    return step(params, state, rmsprop_init(params), torch.from_numpy(images),
                torch.from_numpy(world["masks"]), 1e-4)


def _jax_step(world, images):
    step = j_train.make_train_step(world["jcfg"])
    out = step(world["jparams"], world["jstate"], j_rms_init(world["jparams"]),
               jnp.asarray(images), jnp.asarray(world["masks"]), jnp.float32(1e-4))
    return jax.block_until_ready(out)


@pytest.mark.parametrize("kernels,amp", [(None, False), ("cuda", False), ("cuda", True)])
def test_poisoned_image_raises_like_jax(world, kernels, amp):
    with pytest.raises(FloatingPointError, match=r"invalid value \(nan\)"):
        with DebugNans():
            _port_step(world, world["poisoned"], kernels, amp)
    # Off, the same step runs through and its loss is NaN.
    assert torch.isnan(_port_step(world, world["poisoned"], kernels, amp)[3])


def test_poisoned_image_raises_in_jax(world):
    jax.config.update("jax_debug_nans", True)
    try:
        with pytest.raises(FloatingPointError):
            _jax_step(world, world["poisoned"])
        _jax_step(world, world["images"])  # a clean step raises nothing
    finally:
        jax.config.update("jax_debug_nans", False)


@pytest.mark.parametrize("kernels", [None, "cuda"])
def test_clean_step_is_bitwise_with_the_mode_on(world, kernels):
    off = _port_step(world, world["images"], kernels)
    mode = DebugNans()
    with mode:
        on = _port_step(world, world["images"], kernels)
    for a, b in zip(tree_leaves(off), tree_leaves(on)):
        assert torch.equal(a, b)
    assert float(on[3]) == pytest.approx(float(_jax_step(world, world["images"])[3]), rel=1e-5)
    # Every op was checked, those of the autograd backward too.
    assert sum(mode.checked.values()) > 100
    assert any("backward" in name for name in mode.checked)


def test_empty_buffers_raise_no_false_alarm():
    mode = DebugNans()
    with mode:
        buf = torch.empty(6)
    buf.fill_(NAN)  # uninitialised memory, written where the mode cannot see
    with mode:
        torch.empty_like(buf), torch.empty_strided((2, 3), (3, 1)), buf.new_empty(3)
        buf.view(2, 3)[:, 1:]  # views compute nothing
        torch.add(torch.ones(6), 1.0, out=buf)  # an out= argument is not an input
        assert torch.equal(buf, torch.full((6,), 2.0))
        garbage = torch.empty(4)
    garbage.fill_(NAN)
    with mode:
        garbage.copy_(torch.zeros(4))  # the self of an in-place op is not an input
        garbage.mul_(3.0)
        assert not torch.isnan(garbage).any()
    assert mode.checked["aten.add.out"] == 1 and "aten.empty_like.default" not in mode.checked


def test_a_nan_written_behind_the_mode_is_caught_at_its_first_consumer():
    mode = DebugNans()
    with mode:
        out = torch.empty(2, 3)
    out.fill_(1.0)
    out[1, 2] = NAN  # as a kernel's ctypes write would leave it
    with mode:
        view = out[1]  # a view: not checked
        with pytest.raises(FloatingPointError, match=r"input 'self' of aten\.mul\.Tensor"):
            view * 2
        with pytest.raises(FloatingPointError, match=r"encountered in aten\.div\.Tensor"):
            torch.zeros(2) / torch.zeros(2)
