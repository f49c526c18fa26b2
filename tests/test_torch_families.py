"""The port's model families (Attention U-Net, UNet++, R2U-Net, R2AttU-Net)
against the JAX package on CPU, fp32, base 8 at 48x64 with batch 2. Every
case starts from JAX's ``init_unet`` weights carried across by
``from_jax_arrays``.

Tolerances:
- init: the port's own ``init_unet`` gives JAX's keys and shapes, and at
  base 64 JAX's parameter count;
- ``unet_apply`` in eval mode, and the new BN state in train mode: 1e-4 +
  1e-4 relative (``tests/test_torch_train.py``);
- one ``make_train_step`` step: ``test_torch_train.py``'s tolerances (loss
  1e-5 relative, BN stats 1e-4 + 1e-4, params 2e-2 directly; each gradient
  within 1e-3 of its largest magnitude + 1e-6, grad norm 1e-4 relative,
  RMSprop square_avg 1e-3 relative + 1e-9), the last three and the
  train-mode logits (1e-4 + 1e-4) widened by twice the largest distance of
  JAX's own fp32 result in that tree from JAX's float64 evaluation of the
  same step (``_jax_float64``). The recurrent families chain 12 train-mode
  BNs a block at batch 2, and there fp32 alone moves results past the
  U-Net's tolerances: at this size JAX's fp32 gradients lie up to 1.6% of
  the largest gradient from its float64 ones, its grad norm 0.33%. That
  distance is held under ``FP32_FLOOR`` of the tree's largest float64
  value, and the witness is the reference's, so a fault in the port cannot
  widen its own bound;
- the same step with the port and JAX both in float64, where that chain
  amplifies no fp32 rounding: loss 1e-6 relative, grad norm 1e-5 relative,
  each gradient and square_avg leaf within 1e-3 of its own largest
  magnitude, BN stats within 1e-5 of theirs, params 2e-2 directly. (The
  port casts the logits to fp32 whatever the compute dtype, so its float64
  step is not exact: at this size it lies within 2e-4 of each leaf's
  magnitude);
- ``remat``: bitwise equal to the step without it;
- bf16 ``compute_dtype``: eval-mode logits within 2e-2 of the logits' range
  of JAX's bf16 forward (``tests/test_torch_infer.py``'s bar: bf16
  roundings in two frameworks drift apart);
- Attention U-Net's folded forward (``backend="torch"``): 1e-4 + 1e-4 of
  JAX's ``backend="xla"`` and of the port's eval forward, with a
  non-trivial BN state;
- checkpoints: arrays bitwise equal across the packages, both ways.
"""

import contextlib
import functools
import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.test_torch_train import _assert_trees, _copy, _flat, _numpy
from tpu_unet.checkpoint import _flatten_with_paths
from tpu_unet.checkpoint import load_checkpoint as j_load
from tpu_unet.checkpoint import save_checkpoint as j_save
from tpu_unet.data.synthetic import synth_batch as j_synth_batch
from tpu_unet.models import UNetConfig as JConfig, init_unet as j_init, unet_apply as j_apply
from tpu_unet.models.infer import fold_bn as j_fold, unet_infer_apply as j_infer
from tpu_unet.optim import rmsprop_init as j_rms_init
from tpu_unet.train import make_train_step as j_make_step
from tpu_unet_torch.checkpoint import (
    export_pth,
    flatten,
    from_jax_arrays,
    import_pth,
    load_checkpoint,
    save_checkpoint,
    tree_from_numpy,
)
from tpu_unet_torch.models import fold_bn, unet_infer_apply
from tpu_unet_torch.models.unet import (
    UNetConfig,
    init_unet,
    param_count,
    tree_map,
    unet_apply,
)
from tpu_unet_torch.ops import BNState
from tpu_unet_torch.train import make_train_step

H, W, B, BASE, LR = 48, 64, 2, 8, 1e-3
FP32_FLOOR = {"logits": 2e-3, "grads": 5e-2, "square_avg": 0.1, "other": 1e-2}

# (arch, bilinear, recur_bn, deep_supervision): each family with both
# decoders (UNet++ always upsamples: once, with and without deep
# supervision), the recurrent ones in both BN layouts.
CASES = [("attention", False, "per_step", False), ("attention", True, "per_step", False),
         ("unetpp", False, "per_step", False), ("unetpp", False, "per_step", True)]
CASES += [(arch, bilinear, layout, False) for arch in ("r2u", "r2attu")
          for bilinear in (False, True) for layout in ("per_step", "shared")]
STEP_CASES = [("attention", False, "per_step", False), ("unetpp", False, "per_step", True),
              ("r2u", False, "per_step", False), ("r2attu", False, "per_step", False)]
FULL_WIDTH_PARAMS = {"attention": 31_388_201, "unetpp": 36_622_337, "r2u": 35_601_985,
                     "r2attu": 35_952_553}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's torch work: the suite runs six
    workers on the machine's cores, and small CPU ops gain nothing from more
    threads while the workers' threads contend for them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _id(case):
    arch, bilinear, layout, ds = case
    return "-".join([arch, "bilinear" if bilinear else "convt"]
                    + ([layout] if arch in ("r2u", "r2attu") else [])
                    + (["deep"] if ds else []))


def _jcfg(case, base=BASE):
    arch, bilinear, layout, ds = case
    return JConfig(3, 1, bilinear, base, arch=arch, deep_supervision=ds, recur_bn=layout)


def _carried(params, state):
    """JAX (params, state) as the port's trees, through ``from_jax_arrays``."""
    flat = {"params/" + k: v for k, v in _flatten_with_paths(params).items()}
    flat.update({"state/" + k: v for k, v in _flatten_with_paths(state).items()})
    return from_jax_arrays(flat)


@functools.lru_cache(maxsize=None)
def _world(case):
    """(JAX config, port config, JAX params and state as numpy). Read-only."""
    jcfg = _jcfg(case)
    params, state = j_init(jax.random.PRNGKey(0), jcfg)
    return jcfg, UNetConfig(*jcfg), _numpy(params), _numpy(state)


def _cast(tree, dtype):
    return tree_map(lambda t: t.to(dtype) if t.is_floating_point() else t, tree)


class _Float64Numpy:
    """``jax.numpy`` with ``float32`` standing for ``float64``."""

    float32 = jnp.float64

    def __getattr__(self, name):
        return getattr(jnp, name)


# The JAX modules on the forward and step that cast to fp32 by name.
_FP32_CASTS = ("tpu_unet.ops.batchnorm", "tpu_unet.ops.resize", "tpu_unet.losses.classification",
               "tpu_unet.optim.rmsprop", "tpu_unet.optim.optimizers", "tpu_unet.train",
               "tpu_unet.models.unet", "tpu_unet.models.attention_unet", "tpu_unet.models.unetpp",
               "tpu_unet.models.r2u_unet", "tpu_unet.models.r2attu_unet")


@contextlib.contextmanager
def _jax_float64():
    """JAX in float64: x64 on, and ``jnp.float32`` read as float64 in the
    modules that cast to it by name (BN statistics, the loss, RMSprop, the
    logits), so no part of the trace falls back to fp32. The JAX files are
    untouched; the patch lasts the block."""
    with pytest.MonkeyPatch.context() as mp, jax.enable_x64(True):
        for name in _FP32_CASTS:
            mp.setattr(importlib.import_module(name), "jnp", _Float64Numpy())
        yield


def _f64(tree):
    """A numpy tree's float leaves as float64 JAX arrays (inside ``_jax_float64``)."""
    return jax.tree.map(lambda a: jnp.asarray(a, jnp.float64) if a.dtype.kind == "f"
                        else jnp.asarray(a), tree)


def _close(got, ref, ref64, *, atol=0.0, rtol=0.0, scale=0.0, floor="other"):
    """Per leaf: |got - ref| <= atol + rtol·|ref| + scale·max|ref| + 2·err, err the
    largest |ref - ref64| of the tree (JAX's own fp32 error against its
    float64 evaluation), itself held under FP32_FLOOR[floor] of the tree's
    largest |ref64|."""
    g, r, r64 = _flat(got), _flat(ref), _flat(ref64)
    assert sorted(g) == sorted(r) == sorted(r64)
    big = max(float(np.abs(v).max()) for v in r64.values())
    err = max(float(np.abs(r[k] - r64[k]).max()) for k in r)
    assert err <= FP32_FLOOR[floor] * big, (err, big)
    for k in r:
        bound = atol + scale * np.abs(r[k]).max() + 2 * err
        np.testing.assert_allclose(g[k], r[k], atol=bound, rtol=rtol, err_msg=k)


def _shapes(prefix, tree):
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {prefix + "/".join(str(getattr(p, "key", getattr(p, "name", p))) for p in path):
            tuple(leaf.shape) for path, leaf in flat}


def test_family_param_counts_at_full_width():
    """Base 64, one class, ConvT decoder, t = 2 per-step: the sizes chip_smoke
    trains, keys and shapes as JAX's."""
    for arch, n in FULL_WIDTH_PARAMS.items():
        jcfg = JConfig(3, 1, False, 64, arch=arch)
        jp, js = jax.eval_shape(lambda c=jcfg: j_init(jax.random.PRNGKey(0), c))
        tp, ts = init_unet(UNetConfig(*jcfg), np.random.default_rng(0))
        assert {k: v.shape for k, v in flatten(tp, ts).items()} == {
            **_shapes("params/", jp), **_shapes("state/", js)}
        assert param_count(tp) == sum(int(np.prod(v.shape)) for v in jax.tree.leaves(jp)) == n


@pytest.mark.parametrize("case", CASES, ids=_id)
def test_family_init_layout_matches_jax(case):
    jcfg, cfg, params, state = _world(case)
    tp, ts = init_unet(cfg, np.random.default_rng(0))
    assert {k: v.shape for k, v in _flat(tp).items()} == {
        k: v.shape for k, v in _flat(params).items()}
    assert {k: v.shape for k, v in _flat(ts).items()} == {
        k: v.shape for k, v in _flat(state).items()}
    # every {mean, var} node carried across is a BNState: bn0..bnt included
    cp, cs = _carried(params, state)
    if case[2] == "per_step" and case[0] in ("r2u", "r2attu"):
        assert [isinstance(cs["inc"]["rec1"][f"bn{i}"], BNState) for i in range(3)] == [True] * 3
    _assert_trees(cp, params)
    _assert_trees(cs, state)


@pytest.mark.parametrize("case", CASES, ids=_id)
def test_family_apply_matches_jax(case):
    jcfg, cfg, params, state = _world(case)
    x, _ = j_synth_batch(np.random.default_rng(3), B, H, W)
    tp, ts = _carried(params, state)
    for train in (True, False):
        jy, jnew = j_apply(_copy(params), _copy(state), jnp.asarray(x), config=jcfg, train=train)
        ty, tnew = unet_apply(tp, ts, torch.from_numpy(x), config=cfg, train=train)
        assert ty.shape == (B, H, W, 1) and ty.dtype == torch.float32
        _assert_trees(tnew, jnew, atol=1e-4, rtol=1e-4)
        if train:
            with _jax_float64():
                y64 = np.asarray(j_apply(_f64(params), _f64(state), _f64(x), config=jcfg,
                                         train=True)[0])
            _close(ty, np.asarray(jy), y64, atol=1e-4, rtol=1e-4, floor="logits")
        else:
            np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-4, rtol=1e-4)
            _assert_trees(tnew, state)


@functools.lru_cache(maxsize=None)
def _jax_step(case, float64=False):
    """JAX's outputs of one step (numpy), and its inputs; with ``float64``,
    the step in float64 (``_jax_float64``) from the same inputs."""
    jcfg, _, params, state = _world(case)
    x, m = j_synth_batch(np.random.default_rng(5), B, H, W)
    trees = (params, state, _numpy(j_rms_init(params)))
    if float64:
        with _jax_float64():
            out = j_make_step(jcfg, return_grads=True)(*map(_f64, trees), _f64(x),
                                                       jnp.asarray(m), jnp.float64(LR))
            return trees, x, m, tuple(_numpy(t) for t in out)
    out = j_make_step(jcfg, return_grads=True)(*(_copy(t) for t in trees), jnp.asarray(x),
                                               jnp.asarray(m), jnp.float32(LR))
    return trees, x, m, tuple(_numpy(t) for t in out)


def _port_step(case, dtype=torch.float32, **kw):
    """The port's step from the same inputs, its trees and batch in ``dtype``."""
    trees, x, m, _ = _jax_step(case)
    params, state = (_cast(t, dtype) for t in _carried(*trees[:2]))
    step = make_train_step(_world(case)[1], return_grads=True, **kw)
    return step(params, state, _cast(tree_from_numpy(trees[2]), dtype),
                torch.from_numpy(x).to(dtype), torch.from_numpy(m), LR)


@pytest.mark.parametrize("case", STEP_CASES, ids=_id)
def test_family_train_step_matches_jax(case):
    jo, j64 = _jax_step(case)[3], _jax_step(case, float64=True)[3]
    to = _port_step(case)
    np.testing.assert_allclose(float(to[3]), float(jo[3]), rtol=1e-5)
    _close(to[4], np.asarray(jo[4]), np.asarray(j64[4]), rtol=1e-4)           # grad norm
    _close(to[5], jo[5], j64[5], atol=1e-6, scale=1e-3, floor="grads")      # clipped gradients
    _assert_trees(to[1], jo[1], atol=1e-4, rtol=1e-4)                       # BN running stats
    _close(to[2].square_avg, jo[2].square_avg, j64[2].square_avg, atol=1e-9, rtol=1e-3,
           floor="square_avg")
    _assert_trees(to[0], jo[0], atol=2e-2)                                  # params after RMSprop


@pytest.mark.parametrize("case", STEP_CASES, ids=_id)
def test_family_train_step_matches_jax_in_float64(case):
    j64 = _jax_step(case, float64=True)[3]
    t64 = _port_step(case, torch.float64)
    assert {g.dtype for g in jax.tree.leaves(t64[5])} == {torch.float64}
    np.testing.assert_allclose(float(t64[3]), float(j64[3]), rtol=1e-6)
    np.testing.assert_allclose(float(t64[4]), float(j64[4]), rtol=1e-5)
    _assert_trees(t64[5], j64[5], scale=1e-3)
    _assert_trees(t64[2].square_avg, j64[2].square_avg, scale=1e-3)
    _assert_trees(t64[1], j64[1], scale=1e-5)
    _assert_trees(t64[0], j64[0], atol=2e-2)


@pytest.mark.parametrize("case", STEP_CASES, ids=_id)
def test_family_remat_is_bitwise(case):
    plain, remat = _port_step(case), _port_step(case, remat=True)
    assert plain[3].item() == remat[3].item()
    for got, ref in ((remat[5], plain[5]), (remat[1], plain[1]), (remat[0], plain[0])):
        _assert_trees(got, ref)


def _warm_state(case):
    """JAX's state moved off its init (a train-mode forward's running stats,
    then a spread), so eval mode is not the identity BN."""
    jcfg, _, params, state = _world(case)
    x, _ = j_synth_batch(np.random.default_rng(7), B, H, W)
    _, state = j_apply(_copy(params), _copy(state), jnp.asarray(x), config=jcfg, train=True)
    return _numpy(jax.tree.map(
        lambda a: a + 0.05 * jnp.arange(a.size, dtype=a.dtype) / a.size, state))


@pytest.mark.parametrize("case", STEP_CASES, ids=_id)
def test_family_bf16_close_to_jax_bf16(case):
    jcfg, cfg, params, _ = _world(case)
    state = _warm_state(case)
    x, _ = j_synth_batch(np.random.default_rng(3), B, H, W)
    ref = np.asarray(j_apply(_copy(params), _copy(state), jnp.asarray(x), config=jcfg,
                             compute_dtype=jnp.bfloat16)[0])
    tp, ts = _carried(params, state)
    out = unet_apply(tp, ts, torch.from_numpy(x), config=cfg, compute_dtype=torch.bfloat16)[0]
    assert out.dtype == torch.float32
    assert np.abs(out.numpy() - ref).max() <= 2e-2 * max(np.abs(ref).max(), 1.0)


@pytest.mark.parametrize("bilinear", [False, True])
def test_attention_folded_forward_matches_jax_and_eval(bilinear):
    case = ("attention", bilinear, "per_step", False)
    jcfg, cfg, params, _ = _world(case)
    state = _warm_state(case)
    x, _ = j_synth_batch(np.random.default_rng(4), B, H, W)
    ref = np.asarray(j_infer(j_fold(_copy(params), _copy(state), jcfg), jnp.asarray(x),
                             config=jcfg, backend="xla"))
    tp, ts = _carried(params, state)
    folded = fold_bn(tp, ts, cfg)
    assert set(folded["up1"]["att"]) == {"wg", "wx", "psi"}
    out = unet_infer_apply(folded, torch.from_numpy(x), config=cfg, backend="torch")
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-4, rtol=1e-4)
    eval_fwd = unet_apply(tp, ts, torch.from_numpy(x), config=cfg)[0]
    np.testing.assert_allclose(out.numpy(), eval_fwd.numpy(), atol=1e-4, rtol=1e-4)
    with pytest.raises(ValueError, match="wired for the flagship U-Net only"):
        unet_infer_apply(folded, torch.from_numpy(x), config=cfg, backend="cuda")


LAYOUT_CASES = [c for c in CASES if not c[1]]  # ConvT: every family, both layouts


@pytest.mark.parametrize("case", LAYOUT_CASES, ids=_id)
def test_family_npz_crosses_packages(case, tmp_path):
    """A JAX-written family checkpoint loads in the port with its stored
    config, and a port-written one in JAX, both bitwise."""
    jcfg, cfg, params, state = _world(case)
    j_save(tmp_path / "jax.npz", params, state, [0, 1], {"config": jcfg._asdict()})
    tp, ts, mv, extra = load_checkpoint(tmp_path / "jax.npz", cfg)
    assert mv == [0, 1] and extra["config"]["arch"] == case[0]
    _assert_trees(tp, params)
    _assert_trees(ts, state)
    save_checkpoint(tmp_path / "port.npz", tp, ts, [0, 1], {"config": cfg._asdict()})
    like = j_init(jax.random.PRNGKey(1), jcfg)
    jp, js, _, jextra = j_load(tmp_path / "port.npz", *like)
    assert JConfig(**jextra["config"]) == jcfg
    _assert_trees(jp, params)
    _assert_trees(js, state)
    # .pth is the reference U-Net's layout only, both ways
    with pytest.raises(ValueError, match=r"\.pth export is reference-layout"):
        export_pth(tmp_path / "x.pth", tp, ts, cfg)
    with pytest.raises(ValueError, match="pth import is reference-layout"):
        import_pth(tmp_path / "x.pth", cfg)


@pytest.mark.parametrize("arch", ["r2u", "r2attu"])
@pytest.mark.parametrize("written", ["per_step", "shared"])
def test_recurrent_layout_mismatch_hints(arch, written, tmp_path):
    """A template of the other recur_bn layout is refused with the JAX
    package's hint, in the port and in JAX alike."""
    case = (arch, False, written, False)
    jcfg, cfg, params, state = _world(case)
    other = "shared" if written == "per_step" else "per_step"
    hint = "cannot load a shared-layout" if written == "shared" else "cannot load a per-step"
    j_save(tmp_path / "jax.npz", params, state)
    with pytest.raises(KeyError, match=hint):
        load_checkpoint(tmp_path / "jax.npz", cfg._replace(recur_bn=other))
    save_checkpoint(tmp_path / "port.npz", *_carried(params, state))
    with pytest.raises(KeyError, match=hint):
        j_load(tmp_path / "port.npz", *j_init(jax.random.PRNGKey(0),
                                               jcfg._replace(recur_bn=other)))
    # the matching layout loads in both
    tp, ts, _, _ = load_checkpoint(tmp_path / "jax.npz", cfg)
    _assert_trees(ts, state)
