"""Independent ``nn.Module`` oracles for the families' building blocks, held
against the port's and the JAX package's functions in both recurrent-BN
layouts.

The oracles are written from the papers: the recurrent unit and RRCNN
block of Alom et al. (arXiv:1802.06955), with per-application BN
statistics after Cooijmans et al. (arXiv:1603.09025), and the additive
attention gate of Oktay et al. (arXiv:1804.03999). The per-step recurrent
unit is t+1 ``nn.BatchNorm2d`` modules that share one weight and one bias
``Parameter``, application i normalising with module i, so each keeps its
own running statistics; the shared unit is one ``nn.BatchNorm2d`` stepped
t+1 times. Weights go from the modules to both packages' trees (OIHW ->
HWIO); the train-mode output, every application's updated running mean and
variance and the eval-mode output on those statistics must agree to 1e-5,
and the gradients of the weights (γ and β summed over the applications) to
1e-5 of their largest magnitude + 1e-4 relative.
"""

from __future__ import annotations

import functools

import numpy as np
import pytest
import torch
import torch.nn as nn

import jax
import jax.numpy as jnp

from tpu_unet.models.attention_unet import _gate_apply as j_gate_apply
from tpu_unet.models.r2u_unet import _rec_unit_apply as j_rec_unit_apply
from tpu_unet.models.r2u_unet import _rrcnn_apply as j_rrcnn_apply
from tpu_unet.ops.batchnorm import BNState as JBNState
from tpu_unet_torch.models.attention_unet import _gate_apply
from tpu_unet_torch.models.r2u_unet import _rec_unit_apply, _rrcnn_apply
from tpu_unet_torch.ops import BNState

T = 2
TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's torch work: the suite runs six
    workers on the machine's cores, and small CPU ops gain nothing from more
    threads while the workers' threads contend for them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class RecUnit(nn.Module):
    """h = unit(x); t times h = unit(x + h), unit = ReLU(BN_i(conv3x3(.))) with
    one conv. ``per_step``: BN_i is module i of t+1 that share γ and β;
    otherwise BN_i is one module for every application."""

    def __init__(self, ch: int, t: int, per_step: bool):
        super().__init__()
        self.t = t
        self.conv = nn.Conv2d(ch, ch, 3, padding=1, bias=False)
        self.bns = nn.ModuleList([nn.BatchNorm2d(ch) for _ in range(t + 1 if per_step else 1)])
        for bn in self.bns[1:]:
            bn.weight, bn.bias = self.bns[0].weight, self.bns[0].bias

    def bn(self, i: int) -> nn.BatchNorm2d:
        return self.bns[i if len(self.bns) > 1 else 0]

    def forward(self, x):
        h = torch.relu(self.bn(0)(self.conv(x)))
        for i in range(1, self.t + 1):
            h = torch.relu(self.bn(i)(self.conv(x + h)))
        return h


class RRCNN(nn.Module):
    """x' = proj_1x1(x) (with bias); out = x' + rec2(rec1(x'))."""

    def __init__(self, cin: int, cout: int, t: int, per_step: bool):
        super().__init__()
        self.proj = nn.Conv2d(cin, cout, 1, bias=True)
        self.rec1 = RecUnit(cout, t, per_step)
        self.rec2 = RecUnit(cout, t, per_step)

    def forward(self, x):
        x = self.proj(x)
        return x + self.rec2(self.rec1(x))


class AttentionGate(nn.Module):
    """x * sigmoid(BN(psi(relu(BN(W_g g) + BN(W_x x))))), 1x1 convs without
    bias, F_int = x_ch // 2."""

    def __init__(self, g_ch: int, x_ch: int):
        super().__init__()
        f = max(1, x_ch // 2)
        self.wg, self.bn_g = nn.Conv2d(g_ch, f, 1, bias=False), nn.BatchNorm2d(f)
        self.wx, self.bn_x = nn.Conv2d(x_ch, f, 1, bias=False), nn.BatchNorm2d(f)
        self.psi, self.bn_psi = nn.Conv2d(f, 1, 1, bias=False), nn.BatchNorm2d(1)

    def forward(self, g, x):
        a = torch.relu(self.bn_g(self.wg(g)) + self.bn_x(self.wx(x)))
        return x * torch.sigmoid(self.bn_psi(self.psi(a)))


def _randomise(mod: nn.Module, seed: int) -> None:
    """Non-trivial γ, β and running statistics, so that eval mode differs
    from train mode and from an identity BN."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in mod.modules():
            if isinstance(m, nn.BatchNorm2d):
                m.weight.uniform_(0.5, 1.5, generator=gen)
                m.bias.uniform_(-0.3, 0.3, generator=gen)
                m.running_mean.uniform_(-0.2, 0.2, generator=gen)
                m.running_var.uniform_(0.5, 1.5, generator=gen)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().numpy().copy()


def _conv(mod: nn.Conv2d) -> dict:
    p = {"w": _np(mod.weight).transpose(2, 3, 1, 0)}
    if mod.bias is not None:
        p["b"] = _np(mod.bias)
    return p


def _bn(mod: nn.BatchNorm2d) -> tuple[dict, tuple]:
    return ({"scale": _np(mod.weight), "bias": _np(mod.bias)},
            (_np(mod.running_mean), _np(mod.running_var)))


def _rec_tree(mod: RecUnit) -> tuple[dict, dict]:
    """The unit's (params, state) in the packages' layout, numpy leaves: one
    ``bn`` state for the shared unit, ``bn0..bnT`` for the per-step one."""
    keys = ["bn"] if len(mod.bns) == 1 else [f"bn{i}" for i in range(len(mod.bns))]
    return ({"conv": _conv(mod.conv), "bn": _bn(mod.bns[0])[0]},
            {k: _bn(bn)[1] for k, bn in zip(keys, mod.bns)})


def _rrcnn_tree(mod: RRCNN) -> tuple[dict, dict]:
    params, state = {"proj": _conv(mod.proj)}, {}
    params["rec1"], state["rec1"] = _rec_tree(mod.rec1)
    params["rec2"], state["rec2"] = _rec_tree(mod.rec2)
    return params, state


def _gate_tree(mod: AttentionGate) -> tuple[dict, dict]:
    params = {k: _conv(getattr(mod, k)) for k in ("wg", "wx", "psi")}
    state = {}
    for k in ("bn_g", "bn_x", "bn_psi"):
        params[k], state[k] = _bn(getattr(mod, k))
    return params, state


def _is_stats(v) -> bool:
    return isinstance(v, tuple) and len(v) == 2 and isinstance(v[0], np.ndarray)


def _tree(tree, impl: str):
    """numpy tree -> the package's: tensors and BNState for the port, jnp
    arrays and its BNState for JAX."""
    if isinstance(tree, dict):
        return {k: _tree(v, impl) for k, v in tree.items()}
    if _is_stats(tree):
        return (BNState(*map(torch.from_numpy, tree)) if impl == "port"
                else JBNState(*map(jnp.asarray, tree)))
    return torch.from_numpy(tree) if impl == "port" else jnp.asarray(tree)


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return _np(t).transpose(0, 2, 3, 1)


def _run(impl: str, fn_port, fn_jax, params, state, xs, *, train: bool, weights):
    """(output NHWC, new state, grads of sum(out * weights) w.r.t. params)."""
    if impl == "port":
        p = _tree(params, "port")
        leaves = {}

        def track(tree, path=""):
            if isinstance(tree, dict):
                return {k: track(v, f"{path}/{k}") for k, v in tree.items()}
            leaves[path] = tree.requires_grad_(True)
            return tree

        p = track(p)
        out, new = fn_port(p, _tree(state, "port"), *(torch.from_numpy(x) for x in xs),
                           train=train)
        grads = torch.autograd.grad((out * torch.from_numpy(weights)).sum(), list(leaves.values()),
                                    allow_unused=True)
        return _np(out), new, {k: None if g is None else _np(g) for k, g in zip(leaves, grads)}

    def f(p):
        out, new = fn_jax(p, _tree(state, "jax"), *(jnp.asarray(x) for x in xs), train=train)
        return (out * jnp.asarray(weights)).sum(), (out, new)

    grads, (out, new) = jax.grad(f, has_aux=True)(_tree(params, "jax"))
    flat = {}

    def walk(tree, path=""):
        if isinstance(tree, dict):
            for k, v in tree.items():
                walk(v, f"{path}/{k}")
        else:
            flat[path] = np.asarray(tree)

    walk(grads)
    return np.asarray(out), new, flat


def _stats_of(new, key: str):
    s = new[key]
    return np.asarray(s.mean), np.asarray(s.var)


def _grads_of(mod: nn.Module, names: dict[str, str]) -> dict[str, np.ndarray]:
    """The oracle's gradients under the packages' keypaths (OIHW -> HWIO)."""
    out = {}
    for path, attr in names.items():
        obj = mod
        for a in attr.split("."):
            obj = getattr(obj, a)
        g = _np(obj.grad)
        out[path] = g.transpose(2, 3, 1, 0) if g.ndim == 4 else g
    return out


def _rec_names(prefix: str, attr: str) -> dict[str, str]:
    return {f"{prefix}/conv/w": f"{attr}conv.weight", f"{prefix}/bn/scale": f"{attr}bns.0.weight",
            f"{prefix}/bn/bias": f"{attr}bns.0.bias"}


def _check_block(impl, block, layout, seed):
    per_step = layout == "per_step"
    torch.manual_seed(seed)
    if block == "rec_unit":
        mod = RecUnit(9, T, per_step)
        x = torch.randn(2, 9, 14, 11)
        fn_port, fn_jax = (functools.partial(f, t=T) for f in (_rec_unit_apply, j_rec_unit_apply))
        units = {"": mod}
        names = _rec_names("", "")
    else:
        mod = RRCNN(5, 8, T, per_step)
        x = torch.randn(2, 5, 12, 10)
        fn_port, fn_jax = (functools.partial(f, t=T) for f in (_rrcnn_apply, j_rrcnn_apply))
        units = {"rec1": mod.rec1, "rec2": mod.rec2}
        names = {"/proj/w": "proj.weight", "/proj/b": "proj.bias",
                 **_rec_names("/rec1", "rec1."), **_rec_names("/rec2", "rec2.")}
    _randomise(mod, seed)
    params, state = _rec_tree(mod) if block == "rec_unit" else _rrcnn_tree(mod)
    xs = [_nhwc(x)]
    mod.train()
    ref = mod(x)
    weights = np.random.default_rng(seed).standard_normal(_nhwc(ref).shape).astype(np.float32)
    (ref * torch.from_numpy(weights.transpose(0, 3, 1, 2))).sum().backward()
    out, new, grads = _run(impl, fn_port, fn_jax, params, state, xs, train=True, weights=weights)
    np.testing.assert_allclose(out, _nhwc(ref), **TOL)
    ref_grads = _grads_of(mod, names)
    assert sorted(grads) == sorted(ref_grads)
    for k, g in ref_grads.items():
        np.testing.assert_allclose(grads[k], g, atol=1e-5 * max(1.0, np.abs(g).max()),
                                   rtol=1e-4, err_msg=k)
    # every application's running statistics (per-step: module i's)
    for name, unit in units.items():
        sub = new[name] if name else new
        keys = [f"bn{i}" for i in range(T + 1)] if per_step else ["bn"]
        assert sorted(sub) == sorted(keys)
        for i, key in enumerate(keys):
            mean, var = _stats_of(sub, key)
            np.testing.assert_allclose(mean, _np(unit.bns[i].running_mean), atol=1e-6, rtol=1e-5)
            np.testing.assert_allclose(var, _np(unit.bns[i].running_var), atol=1e-6, rtol=1e-5)
        if per_step:  # the applications saw different inputs: their stats differ
            assert not np.allclose(_stats_of(sub, "bn0")[0], _stats_of(sub, f"bn{T}")[0])

    mod.eval()
    with torch.no_grad():
        ref_eval = mod(x)
    new_np = _state_np(new)
    out_eval, _, _ = _run(impl, fn_port, fn_jax, params, new_np, xs, train=False,
                          weights=weights)
    np.testing.assert_allclose(out_eval, _nhwc(ref_eval), **TOL)


def _state_np(tree):
    if isinstance(tree, dict):
        return {k: _state_np(v) for k, v in tree.items()}
    return tuple(np.asarray(v.detach() if isinstance(v, torch.Tensor) else v).copy()
                 for v in tree)


@pytest.mark.parametrize("impl", ["port", "jax"])
@pytest.mark.parametrize("layout", ["per_step", "shared"])
@pytest.mark.parametrize("block", ["rec_unit", "rrcnn"])
def test_recurrent_block_matches_oracle(impl, block, layout):
    _check_block(impl, block, layout, seed={"rec_unit": 1, "rrcnn": 2}[block])


def test_per_step_oracle_shares_gamma_and_beta():
    """The oracle itself: t+1 modules, one γ and one β Parameter."""
    mod = RecUnit(4, T, per_step=True)
    assert len(mod.bns) == T + 1
    assert all(bn.weight is mod.bns[0].weight and bn.bias is mod.bns[0].bias for bn in mod.bns)
    assert len(list(mod.parameters())) == 3  # conv, γ, β
    assert len({id(bn.running_mean) for bn in mod.bns}) == T + 1


@pytest.mark.parametrize("impl", ["port", "jax"])
def test_attention_gate_matches_oracle(impl):
    torch.manual_seed(0)
    mod = AttentionGate(12, 10)
    _randomise(mod, 0)
    params, state = _gate_tree(mod)
    g, x = torch.randn(2, 12, 16, 12), torch.randn(2, 10, 16, 12)
    fn_port, fn_jax = _gate_apply, j_gate_apply
    weights = np.random.default_rng(0).standard_normal((2, 16, 12, 10)).astype(np.float32)
    mod.train()
    ref = mod(g, x)
    out, new, _ = _run(impl, fn_port, fn_jax, params, state, [_nhwc(g), _nhwc(x)], train=True,
                       weights=weights)
    np.testing.assert_allclose(out, _nhwc(ref), **TOL)
    for k in ("bn_g", "bn_x", "bn_psi"):
        mean, var = _stats_of(new, k)
        np.testing.assert_allclose(mean, _np(getattr(mod, k).running_mean), atol=1e-6, rtol=1e-5)
        np.testing.assert_allclose(var, _np(getattr(mod, k).running_var), atol=1e-6, rtol=1e-5)
    mod.eval()
    with torch.no_grad():
        ref_eval = mod(g, x)
    out_eval, _, _ = _run(impl, fn_port, fn_jax, params, _state_np(new),
                          [_nhwc(g), _nhwc(x)], train=False, weights=weights)
    np.testing.assert_allclose(out_eval, _nhwc(ref_eval), **TOL)
