"""``ops/conv.py``'s cuDNN engine rule (``cudnn_engine_rule``) on the CPU:
it holds at every library conv op that runs, forward and backward
(autograd's included), for ``conv2d``, ``conv_transpose2d`` and the halo
conv, and raises where it cannot hold; the ops' outputs and gradients are
bitwise the plain calls they were before the rule, and agree with JAX's
``ops/conv.py`` on the same numpy inputs at fp32 tolerance, on a spatial
``Band`` and without one. The rule's effect on the card (the workspaces,
the step times) is ``chip_smoke.py``'s phases 13-14 and
``tools/conv_workspace.py``."""

import os
from datetime import timedelta

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.utils._python_dispatch import TorchDispatchMode

from tpu_unet.ops import conv as jconv
from tpu_unet_torch.ops import conv as tconv
from tpu_unet_torch.parallel.halo import Band
from tpu_unet_torch.parallel.mesh import init_data_parallel, make_grid

NAME, VALUE = tconv.CUDNN_ENGINE_RULE
TOL = dict(atol=1e-5, rtol=1e-5)
CONVS = (torch.ops.aten.convolution, torch.ops.aten.convolution_backward)


class _RuleAtConvs(TorchDispatchMode):
    """Records, at each conv op that runs, its name and the rule's variable."""

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.overloadpacket in CONVS:
            self.seen.append((func.overloadpacket.__name__, os.environ.get(NAME)))
        return func(*args, **(kwargs or {}))


@pytest.fixture
def no_rule(monkeypatch):
    """The process without the rule's variable (restored after)."""
    monkeypatch.setenv(NAME, VALUE)
    monkeypatch.delenv(NAME)
    monkeypatch.delenv("TORCH_CUDNN_V8_API_DISABLED", raising=False)


def _data(seed, x_shape, w_shape):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(x_shape, dtype=np.float32),
            rng.standard_normal(w_shape, dtype=np.float32) * 0.2)


def _halo_conv(x, w):
    """The 3x3 conv of [N,H,W,C] ``x`` as two bands of rows through the halo
    conv, each with its neighbour's edge row as its halo."""
    h1 = x.shape[1] // 2
    zero = torch.zeros_like(x[:, :1])
    top = tconv._HaloConv3x3.apply(x[:, :h1], torch.cat([zero, x[:, h1:h1 + 1]], 1), w)
    bot = tconv._HaloConv3x3.apply(x[:, h1:], torch.cat([x[:, h1 - 1:h1], zero], 1), w)
    return torch.cat([top, bot], 1)


# name: (x shape, w shape, the op on torch tensors, JAX's op)
CASES = {
    "conv2d 3x3": ((2, 9, 7, 5), (3, 3, 5, 4), lambda x, w: tconv.conv2d(x, w, padding=1),
                   lambda x, w: jconv.conv2d(x, w, padding=1)),
    "conv2d 1x1": ((1, 6, 5, 8), (1, 1, 8, 3), lambda x, w: tconv.conv2d(x, w),
                   lambda x, w: jconv.conv2d(x, w)),
    "conv_transpose2d": ((2, 4, 5, 6), (2, 2, 6, 3),
                         lambda x, w: tconv.conv_transpose2d(x, w, stride=2),
                         lambda x, w: jconv.conv_transpose2d(x, w, stride=2)),
    "halo conv": ((2, 8, 6, 4), (3, 3, 4, 5), _halo_conv,
                  lambda x, w: jconv.conv2d(x, w, padding=1)),
}


def _torch_vjp(fn, x, w, g):
    xt, wt = (torch.from_numpy(a).requires_grad_(True) for a in (x, w))
    y = fn(xt, wt)
    gx, gw = torch.autograd.grad(y, (xt, wt), torch.from_numpy(g))
    return y.detach().numpy(), gx.numpy(), gw.numpy()


@pytest.mark.parametrize("case", list(CASES))
def test_rule_holds_at_every_conv_forward_and_backward(no_rule, case):
    x_shape, w_shape, fn, _ = CASES[case]
    x, w = _data(0, x_shape, w_shape)
    with _RuleAtConvs() as mode:
        xt, wt = (torch.from_numpy(a).requires_grad_(True) for a in (x, w))
        y = fn(xt, wt)
        y.square().sum().backward()
    kinds = {k for k, _ in mode.seen}
    assert kinds == {"convolution", "convolution_backward"}, mode.seen
    assert all(v == VALUE for _, v in mode.seen), mode.seen


@pytest.mark.parametrize("env", [{NAME: "0"}, {"TORCH_CUDNN_V8_API_DISABLED": "1"}])
def test_rule_raises_where_it_cannot_hold(no_rule, monkeypatch, env):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    x, w = _data(1, (1, 4, 4, 2), (3, 3, 2, 2))
    with pytest.raises(RuntimeError, match="cuDNN engine rule"):
        tconv.conv2d(torch.from_numpy(x), torch.from_numpy(w), padding=1)


def test_outputs_and_gradients_are_bitwise_the_plain_calls(no_rule):
    """Each op's output and gradients against the calls it made before the
    rule: ``F.conv2d``/``F.conv_transpose2d`` on the NCHW views under
    autograd, and the halo conv's window conv and its
    ``convolution_backward``."""
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal((2, 9, 7, 5), dtype=np.float32))
    w = torch.from_numpy(rng.standard_normal((3, 3, 5, 4), dtype=np.float32))
    wt = torch.from_numpy(rng.standard_normal((2, 2, 5, 3), dtype=np.float32))
    plain = {
        "conv2d": (lambda x, w: tconv.conv2d(x, w, padding=1), w,
                   lambda x, w: F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
                                         padding=1).permute(0, 2, 3, 1)),
        "conv_transpose2d": (lambda x, w: tconv.conv_transpose2d(x, w, stride=2), wt,
                             lambda x, w: F.conv_transpose2d(
                                 x.permute(0, 3, 1, 2), w.permute(2, 3, 0, 1),
                                 stride=2).permute(0, 2, 3, 1)),
    }
    for name, (fn, wgt, ref) in plain.items():
        outs = []
        for f in (fn, ref):
            xi, wi = x.clone().requires_grad_(True), wgt.clone().requires_grad_(True)
            y = f(xi, wi)
            g = torch.from_numpy(np.random.default_rng(3).standard_normal(
                tuple(y.shape), dtype=np.float32))
            outs.append((y.detach(), *torch.autograd.grad(y, (xi, wi), g)))
        for a, b in zip(*outs):
            assert torch.equal(a, b), name
    halo = torch.from_numpy(rng.standard_normal((2, 2, 7, 5), dtype=np.float32))
    xi, hi, wi = (t.clone().requires_grad_(True) for t in (x, halo, w))
    y = tconv._HaloConv3x3.apply(xi, hi, wi)
    g = torch.from_numpy(rng.standard_normal(y.shape, dtype=np.float32))
    gx, gh, gw = torch.autograd.grad(y, (xi, hi, wi), g)
    win = torch.cat([halo[:, :1], x, halo[:, 1:]], 1)
    nchw = (lambda t: t.permute(0, 3, 1, 2))
    y_ref = F.conv2d(nchw(win), w.permute(3, 2, 0, 1), padding=(0, 1)).permute(0, 2, 3, 1)
    gin, gw_ref, _ = torch.ops.aten.convolution_backward(
        nchw(g), nchw(win), w.permute(3, 2, 0, 1), None, [1, 1], [0, 1], [1, 1], False,
        [0, 0], 1, [True, True, False])
    gin = gin.permute(0, 2, 3, 1)
    assert torch.equal(y, y_ref)
    assert torch.equal(gx, gin[:, 1:-1])
    assert torch.equal(gh, torch.cat([gin[:, :1], gin[:, -1:]], 1))
    assert torch.equal(gw, gw_ref.permute(2, 3, 1, 0))


@pytest.mark.parametrize("case", list(CASES))
def test_outputs_and_gradients_match_jax(no_rule, case):
    x_shape, w_shape, fn, jfn = CASES[case]
    x, w = _data(4, x_shape, w_shape)
    out = fn(torch.from_numpy(x), torch.from_numpy(w))
    g = np.random.default_rng(5).standard_normal(tuple(out.shape), dtype=np.float32)
    y, gx, gw = _torch_vjp(fn, x, w, g)
    jy, vjp = jax.vjp(jfn, jnp.asarray(x), jnp.asarray(w))
    jgx, jgw = vjp(jnp.asarray(g))
    for a, b in ((y, jy), (gx, jgx), (gw, jgw)):
        np.testing.assert_allclose(a, np.asarray(b), **TOL)


def test_band_convs_match_jax_on_a_one_rank_grid(no_rule, tmp_path):
    """``conv2d`` (3x3 through the halo conv, 1x1 row-local) and
    ``conv_transpose2d`` with a ``Band`` of a gloo grid: outputs and
    gradients against JAX's, the rule set at every conv op."""
    dp = init_data_parallel(backend="gloo", device="cpu", init_method=f"file://{tmp_path}/rdzv",
                            rank=0, world_size=1, timeout=timedelta(seconds=60))
    try:
        grid = make_grid(dp, 1)
        for i, (x_shape, w_shape, fn, jfn) in enumerate((
                ((2, 8, 6, 4), (3, 3, 4, 5), tconv.conv2d, jconv.conv2d),
                ((2, 8, 6, 4), (1, 1, 4, 3), tconv.conv2d, jconv.conv2d),
                ((2, 4, 5, 6), (2, 2, 6, 3), tconv.conv_transpose2d,
                 jconv.conv_transpose2d))):
            x, w = _data(6 + i, x_shape, w_shape)
            band = Band(grid, x_shape[1], ((0, x_shape[1]),))
            kw = ({"stride": 2} if fn is tconv.conv_transpose2d else
                  {"padding": w_shape[0] // 2})
            g = np.random.default_rng(9).standard_normal(
                tuple(fn(torch.from_numpy(x), torch.from_numpy(w), **kw).shape),
                dtype=np.float32)
            with _RuleAtConvs() as mode:
                y, gx, gw = _torch_vjp(lambda a, b: fn(a, b, group=band, **kw), x, w, g)
            assert {k for k, _ in mode.seen} == {"convolution", "convolution_backward"}
            assert all(v == VALUE for _, v in mode.seen)
            jy, vjp = jax.vjp(lambda a, b: jfn(a, b, **kw), jnp.asarray(x), jnp.asarray(w))
            for a, b in zip((y, gx, gw), (jy, *vjp(jnp.asarray(g)))):
                np.testing.assert_allclose(a, np.asarray(b), **TOL)
    finally:
        torch.distributed.destroy_process_group()
