"""The port's train-mode conv unit (``tpu_unet_torch/ops/conv_stats.py``)
and ``ops.batch_norm`` against the JAX package.

- ``gradcheck`` in float64 (finite differences, eps 1e-6, atol 1e-5, rtol
  1e-3: torch's defaults) on ``ConvStatsRaw`` and ``ConvStatsPro`` checks
  the hand-derived backward on its own, with both outputs' cotangents.
- ``double_conv_train_fused`` against JAX's (Pallas kernels in interpret
  mode) in fp32: output and new BN state 1e-4 + 1e-4; ``jax.vjp`` gradients
  of params and input 1e-4 + 1e-3 of each tensor's largest magnitude (the
  backward chains two BN backwards through sums over N*H*W).
- ``batch_norm`` against JAX's, fp32: outputs and running stats 1e-5 + 1e-5.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from tpu_unet.ops.batchnorm import BNState as JBNState, batch_norm as j_batch_norm
from tpu_unet.ops.conv_stats import double_conv_train_fused as j_double_conv
from tpu_unet_torch import kernels as K
from tpu_unet_torch.checkpoint import tree_from_numpy
from tpu_unet_torch.models.unet import tree_leaves
from tpu_unet_torch.ops import BNState, batch_norm
from tpu_unet_torch.ops.conv_stats import ConvStatsPro, ConvStatsRaw, double_conv_train_fused


def _f64(rng, *shape, scale=1.0):
    return torch.from_numpy(rng.standard_normal(shape) * scale).requires_grad_(True)


def test_gradcheck_conv_stats_raw(rng):
    x = _f64(rng, 1, 5, 6, 3)
    w = _f64(rng, 3, 3, 3, 4, scale=0.3)
    assert torch.autograd.gradcheck(lambda x, w: ConvStatsRaw.apply(x, w, True), (x, w))


def test_gradcheck_conv_stats_raw_without_dx(rng):
    x = torch.from_numpy(rng.standard_normal((2, 4, 5, 3)))
    w = _f64(rng, 3, 3, 3, 2, scale=0.3)
    assert torch.autograd.gradcheck(lambda w: ConvStatsRaw.apply(x, w, False), (w,))
    z, s = ConvStatsRaw.apply(x.requires_grad_(True), w, False)
    (z.sum() + s.sum()).backward()
    assert x.grad is None  # no transposed conv for an input that needs none


def test_gradcheck_conv_stats_pro(rng):
    x = _f64(rng, 1, 5, 6, 4)
    w = _f64(rng, 3, 3, 4, 3, scale=0.3)
    a = torch.from_numpy(0.5 + rng.random(4)).requires_grad_(True)
    c = _f64(rng, 4, scale=0.5)
    assert torch.autograd.gradcheck(ConvStatsPro.apply, (x, w, a, c))


def test_conv_stats_backward_takes_one_unused_output(rng):
    """A graph that uses only z (or only the sums) gives the other output a
    zero cotangent; the backward must take it."""
    x = _f64(rng, 1, 4, 5, 3)
    w = _f64(rng, 3, 3, 3, 2)
    z, _ = ConvStatsRaw.apply(x, w, True)
    gx, gw = torch.autograd.grad(z.sum(), (x, w))
    _, s = ConvStatsRaw.apply(x, w, True)
    gx2, gw2 = torch.autograd.grad(s.sum(), (x, w))
    assert torch.isfinite(gx).all() and torch.isfinite(gw2).all() and gx2.abs().sum() > 0


def _block(rng, cin, cmid, cout):
    def bn(c):
        return {"scale": (1 + 0.2 * rng.standard_normal(c)).astype(np.float32),
                "bias": (0.2 * rng.standard_normal(c)).astype(np.float32)}

    params = {
        "conv1": {"w": (rng.standard_normal((3, 3, cin, cmid)) * 0.3).astype(np.float32)},
        "bn1": bn(cmid),
        "conv2": {"w": (rng.standard_normal((3, 3, cmid, cout)) * 0.2).astype(np.float32)},
        "bn2": bn(cout),
    }
    state = {"bn1": JBNState(np.zeros(cmid, np.float32), np.ones(cmid, np.float32)),
             "bn2": JBNState(np.full(cout, 0.1, np.float32), np.full(cout, 2.0, np.float32))}
    return params, state


@pytest.mark.parametrize("cin,cmid,cout,first", [(3, 8, 8, True), (8, 16, 8, False)])
def test_double_conv_train_fused_matches_jax(rng, cin, cmid, cout, first):
    params, state = _block(rng, cin, cmid, cout)
    x = rng.standard_normal((2, 9, 14, cin)).astype(np.float32)
    cot = rng.standard_normal((2, 9, 14, cout)).astype(np.float32)

    jp = jax.tree.map(jnp.asarray, params)
    js = jax.tree.map(jnp.asarray, state)

    def jfn(p, xx):
        return j_double_conv(p, js, xx, input_needs_grad=not first)

    with pltpu.force_tpu_interpret_mode():
        jy, vjp, jnew = jax.vjp(jfn, jp, jnp.asarray(x), has_aux=True)
        jgp, jgx = vjp(jnp.asarray(cot))

    tp = tree_from_numpy(params)
    for t in tree_leaves(tp):
        t.requires_grad_(True)
    tx = torch.from_numpy(x).requires_grad_(not first)
    K.reset_launch_counts()
    y, new = double_conv_train_fused(tp, tree_from_numpy(state), tx, input_needs_grad=not first)
    y.backward(torch.from_numpy(cot))
    assert all(n == 0 for n in K.launch_counts().values())

    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), atol=1e-4, rtol=1e-4)
    for name in ("bn1", "bn2"):
        assert isinstance(new[name], BNState) and not new[name].mean.requires_grad
        for got, ref in zip(new[name], jnew[name]):
            np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4, rtol=1e-4)
    pairs = [(tp["conv1"]["w"], jgp["conv1"]["w"]), (tp["conv2"]["w"], jgp["conv2"]["w"])]
    pairs += [(tp[b][k], jgp[b][k]) for b in ("bn1", "bn2") for k in ("scale", "bias")]
    if not first:
        pairs.append((tx, jgx))
    else:
        assert tx.grad is None
    for t, ref in pairs:
        ref = np.asarray(ref)
        np.testing.assert_allclose(t.grad.numpy(), ref, atol=1e-4 + 1e-3 * np.abs(ref).max(),
                                   rtol=0)


def test_double_conv_train_fused_refuses_axis_name():
    # JAX's axis_name is the port's group (a ProcessGroup, tested in
    # tests/test_torch_data_parallel.py): a name is refused.
    params, state = _block(np.random.default_rng(1), 3, 8, 8)
    with pytest.raises(TypeError, match="axis_name"):
        double_conv_train_fused(tree_from_numpy(params), tree_from_numpy(state),
                                torch.zeros(1, 4, 4, 3), axis_name="data")


@pytest.mark.parametrize("train", [True, False])
def test_batch_norm_matches_jax(rng, train):
    x = (rng.standard_normal((2, 7, 9, 5)) * 2 + 0.5).astype(np.float32)
    params = {"scale": (1 + 0.3 * rng.standard_normal(5)).astype(np.float32),
              "bias": rng.standard_normal(5).astype(np.float32)}
    state = JBNState((0.2 * rng.standard_normal(5)).astype(np.float32),
                     (1 + rng.random(5)).astype(np.float32))
    jy, js = j_batch_norm(jnp.asarray(x), jax.tree.map(jnp.asarray, params),
                          JBNState(*map(jnp.asarray, state)), train=train)
    ty, ts = batch_norm(torch.from_numpy(x), tree_from_numpy(params), tree_from_numpy(state),
                        train=train)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-5, rtol=1e-5)
    for got, ref in zip(ts, js):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)


def test_batch_norm_clamps_a_negative_one_pass_variance():
    """A constant channel far from 0: Σx²/n − mean² cancels below 0 in fp32
    (at 1367, in both packages' summation orders) and is clamped to 0, as in
    JAX, so rsqrt stays finite and the running variance gets 0 from it. The output of that channel is
    (x − mean)·rsqrt(eps), an fp32 rounding of the mean times 316, so only
    its finiteness is compared; the other channel is compared in full."""
    x = np.full((2, 3, 3, 2), 1367.0, np.float32)
    x[..., 1] = np.linspace(-1, 1, 18, dtype=np.float32).reshape(2, 3, 3)
    params = {"scale": np.ones(2, np.float32), "bias": np.zeros(2, np.float32)}
    state = JBNState(np.zeros(2, np.float32), np.ones(2, np.float32))
    jy, js = j_batch_norm(jnp.asarray(x), jax.tree.map(jnp.asarray, params),
                          JBNState(*map(jnp.asarray, state)), train=True)
    ty, ts = batch_norm(torch.from_numpy(x), tree_from_numpy(params), tree_from_numpy(state),
                        train=True)
    assert torch.isfinite(ty).all() and np.isfinite(np.asarray(jy)).all()
    np.testing.assert_allclose(ty[..., 1].numpy(), np.asarray(jy)[..., 1], atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(ts.var.numpy(), np.asarray(js.var), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(ts.var[0].item(), 0.9, rtol=1e-6)  # 0.9 * 1 + 0.1 * 0
