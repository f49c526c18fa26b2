"""The port's tensor parallelism (``tpu_unet_torch/parallel/tensor.py``, the
model axis of ``parallel/mesh.py::Grid``) on the CPU, against the JAX
package's (``tpu_unet/parallel/tensor.py``, its 8 CPU devices) and its
single-device step, by ``tests/test_tensor_parallel.py``'s tolerances.

- The shard dims equal JAX's ``unet_param_specs`` and ``unet_state_specs``
  leaf for leaf, for every family and both ``recur_bn`` layouts, and a
  block whose Cmid the model size does not divide stays replicated (pure
  functions of the shapes; no ranks).
- In one 4-rank gloo world spawned for the module (workers in
  ``tests/torch_dp_workers.py``), with JAX's weights through
  ``checkpoint.from_jax_arrays`` (base 8, bilinear, 8x32x32, lr 1e-3):
  the flagship's 3 fp32 steps on the 2 x 1 x 2, 1 x 1 x 4 and 1 x 2 x 2
  (data x spatial x model) grids against JAX's ``make_mesh_3d`` steps and
  JAX's single-device steps (losses 5e-4 relative, params' largest
  difference < 0.08 with at most 0.05% of a leaf's elements past 2e-2, one
  step's < 2·10·lr, BN state 2e-2); one step of attention, UNet++, R2U-Net,
  R2AttU-Net and of Adam against JAX's single-device step (loss 5e-4). The
  first step's grad norm is held against JAX's (1e-3, or by the float64
  one-process step) and its clipped gradients against the port's
  one-process step: fp32 within 1e-6 + 1e-3 relative, and for the families
  and the 1 x 2 x 2 grid a float64 step on the grid within 1e-8 of the
  float64 one-process step (RMSprop and Adam normalise each element, so
  only the gradients show a shard summed over the wrong ranks). Their eval
  forward
  on the shards against the one-process forward (1e-4); a rank's params and
  state about 1/T of the sharded blocks', the replicated leaves bitwise
  equal on the model ranks; the T = 1 grid bitwise the (data x spatial)
  grid of ``make_grid(dp, S)``.
- ``evaluate`` over the 2 x 1 x 2 and 1 x 2 x 2 grids (with and without
  TTA) within 1e-6 of the one-process evaluation; ``train_model`` with
  ``tensor_parallel=4`` against the data-parallel run (losses 1e-3
  relative, val Dice 1e-3), both resumed from its checkpoint, which holds
  the whole model and state as the data-parallel run's does, and which the
  JAX package's loader reads; the W&B panel logs the whole model.
- JAX's refusals, in its words.
"""

import functools
import multiprocessing as mp
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from tests.test_torch_train import _flat, _numpy
from tests.torch_dp_workers import _numpy_tree, float64_step, jobs_worker, start_ranks
from tpu_unet.checkpoint import load_checkpoint as j_load
from tpu_unet.data.synthetic import synth_batch as j_synth_batch
from tpu_unet.models import UNetConfig as JConfig, init_unet as j_init
from tpu_unet.ops import BNState as JBNState
from tpu_unet.optim import get_optimizer as j_get_optimizer
from tpu_unet.parallel.mesh import image_sharding
from tpu_unet.parallel.tensor import make_mesh_3d
from tpu_unet.parallel.tensor import shard_model as j_shard_model
from tpu_unet.parallel.tensor import shard_opt_state as j_shard_opt_state
from tpu_unet.parallel.tensor import unet_param_specs as j_param_specs
from tpu_unet.parallel.tensor import unet_state_specs as j_state_specs
from tpu_unet.train import make_train_step as j_make_step
from tpu_unet_torch import train_cli
from tpu_unet_torch.checkpoint import (
    flatten,
    from_jax_arrays,
    load_checkpoint,
    tree_from_numpy,
)
from tpu_unet_torch.data import make_synthetic_carvana, synth_batch
from tpu_unet_torch.evaluate import evaluate, evaluate_per_class
from tpu_unet_torch.models.unet import Refused, UNetConfig, init_unet, unet_apply
from tpu_unet_torch.optim import get_optimizer
from tpu_unet_torch.parallel.mesh import DataParallel, make_grid
from tpu_unet_torch.parallel.tensor import unet_param_specs, unet_state_specs
from tpu_unet_torch.train import _build_mesh, _check_train_flags, check_grid, make_train_step

WORLD, LR, STEPS = 4, 1e-3, 3
BASE = dict(n_channels=3, n_classes=1, bilinear=True, base_channels=8)
FAMILIES = ("attention", "unetpp", "r2u", "r2attu")
GRIDS = ((1, 2), (1, 4), (2, 2))  # (S, T); 4 ranks: 2x1x2, 1x1x4, 1x2x2
EVAL_CFG = dict(n_channels=3, n_classes=2, bilinear=True, base_channels=8)


def _fields(name):
    if name == "eval":
        return EVAL_CFG
    if name in FAMILIES:
        return BASE | {"arch": name}
    if name == "odd":  # 6 % 4: inc's Cmid does not divide over 4 model ranks
        return BASE | {"base_channels": 6}
    return BASE


def _tree(name):
    """The weights of a case: its family's, or the flagship's."""
    return name if name in (*FAMILIES, "odd", "eval") else "unet"


def _grid(s, t):
    return f"S{s}xT{t}"


def _cases():
    cases = [(_grid(s, t), _fields("unet"), (s, t), STEPS, {"float64": s > 1})
             for s, t in GRIDS]
    cases.append(("t1", _fields("unet"), (2, 1), 1, {"pr18": True}))
    cases += [(n, _fields(n), (1, 2), 1, {"float64": True}) for n in FAMILIES]
    cases.append(("adam", _fields("unet"), (1, 2), 1, {"optimizer": "adam"}))
    cases.append(("odd", _fields("odd"), (1, 4), 1, {}))
    return cases


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@functools.lru_cache(maxsize=None)
def _weights(name):
    """The weights of ``name``'s model, drawn from a numpy seed, as the
    checkpoint's keypath -> array map (JAX's keypaths)."""
    return flatten(*init_unet(UNetConfig(**_fields(name)), np.random.default_rng(0)))


def _fill(tree, prefix, flat):
    """JAX's tree of shapes ``tree`` with its leaves from ``flat``."""
    if isinstance(tree, dict):
        return {k: _fill(v, f"{prefix}/{k}", flat) for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        return type(tree)(*(_fill(v, f"{prefix}/{f}", flat) for f, v in zip(tree._fields, tree)))
    assert flat[prefix].shape == tree.shape, prefix
    return flat[prefix]


@functools.lru_cache(maxsize=None)
def _jax_world(name):
    """JAX's config and (params, state) as numpy, with ``_weights``."""
    cfg = JConfig(**_fields(name))
    params, state = jax.eval_shape(lambda k: j_init(k, cfg), jax.random.PRNGKey(0))
    flat = _weights(name)
    return cfg, _fill(params, "params", flat), _fill(state, "state", flat)


def _batch():
    return j_synth_batch(np.random.default_rng(0), 8, 32, 32)


@functools.lru_cache(maxsize=None)
def _carried(name):
    """The port's trees of the same weights, through ``from_jax_arrays``, as
    numpy."""
    return tuple(_numpy_tree(t) for t in from_jax_arrays(_weights(name)))


def _jax_steps(name, steps, mesh_shape=None, optimizer="rmsprop"):
    """JAX's ``steps`` steps from its init: on one device, or sharded on
    ``make_mesh_3d(model=T, spatial=S)`` for ``mesh_shape`` (S, T). Returns
    (losses, params, state, optimizer state, grad norms, the first step's
    clipped gradients) as numpy."""
    cfg, params, state = _jax_world(name)
    imgs, masks = _batch()
    p, s = jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, state)
    o = j_get_optimizer(optimizer)[0](p)
    im, mk = jnp.asarray(imgs), jnp.asarray(masks)
    if mesh_shape is not None:
        mesh = make_mesh_3d(model=mesh_shape[1], spatial=mesh_shape[0])
        o = j_shard_opt_state(mesh, o, p)
        p, s = j_shard_model(mesh, p, s)
        im, mk = (jax.device_put(a, image_sharding(mesh)) for a in (im, mk))
    step = j_make_step(cfg, optimizer=optimizer, return_grads=True)
    losses, norms, grads = [], [], None
    for _ in range(steps):
        p, s, o, loss, gnorm, g = step(p, s, o, im, mk, jnp.float32(LR))
        losses.append(float(loss))
        norms.append(float(gnorm))
        grads = _numpy(g) if grads is None else grads
    return losses, _numpy(p), _numpy(s), _numpy(o), norms, grads


def _jax_refs(jobs):
    """``{key: _jax_steps(*args)}`` for (key, args) in ``jobs``, in a
    process of its own beside the module's others."""
    jax.config.update("jax_platforms", "cpu")
    return {key: _jax_steps(*args) for key, args in jobs}


FAST_COMPILE = " --xla_backend_optimization_level=0 --xla_llvm_disable_expensive_passes=true"
# JAX's references, one list a process: each compiles its steps.
JAX_JOBS = ([("single", ("unet", 1)), ("adam", ("unet", 1, None, "adam")),
             (GRIDS[2], ("unet", 1, GRIDS[2]))],
            [(g, ("unet", 1, g)) for g in GRIDS[:2]],
            [(n, (n, 1)) for n in ("attention", "r2u")],
            [(n, (n, 1)) for n in ("unetpp", "r2attu")])


def _eval_batches():
    rng = np.random.default_rng(3)
    out = []
    for bs in (4, 4, 3):
        imgs, masks = synth_batch(rng, bs, 32, 32)
        out.append({"image": imgs, "mask": masks})
    return out


@pytest.fixture(scope="module")
def tp_runs(tmp_path_factory):
    """Every rank's results, in one group of 4 for the module, and JAX's
    steps, computed beside them in this process and three more."""
    root = tmp_path_factory.mktemp("tensor")
    make_synthetic_carvana(root / "d", n=16, h=64, w=64)
    names = {_tree(n) for n, *_ in _cases()} | {"odd"}
    trees = {n: _carried(n) for n in names}
    imgs, masks = _batch()
    ep, es = (tree_from_numpy(t) for t in _carried("eval"))
    jobs = [("tp_step_worker", (_cases(), {n: trees[_tree(n)] for n, *_ in _cases()},
                                imgs, masks, LR)),
            ("tp_eval_worker", (*(_numpy_tree(t) for t in (ep, es)), _eval_batches(),
                                EVAL_CFG, imgs)),
            ("tp_train_worker", (str(root / "d"), *trees["unet"], BASE, str(root / "ck")))]
    join = start_ranks(jobs_worker, WORLD, root, jobs, timeout=300)
    with pytest.MonkeyPatch.context() as env:
        # The helpers' LLVM at its cheapest: XLA's HLO passes, which fix the
        # numerics, run as they do here.
        env.setenv("XLA_FLAGS", os.environ.get("XLA_FLAGS", "") + FAST_COMPILE)
        pool = mp.get_context("spawn").Pool(len(JAX_JOBS) - 1)
    try:
        others = [pool.apply_async(_jax_refs, (j,)) for j in JAX_JOBS[1:]]
        jax_refs = _jax_refs(JAX_JOBS[0])
        for r in others:
            jax_refs.update(r.get(timeout=300))
    finally:
        pool.close()
        ranks = join()
        pool.join()
    return {"step": {n: [r[0][i] for r in ranks] for i, (n, *_) in enumerate(_cases())},
            "eval": [r[1] for r in ranks], "train": [r[2] for r in ranks], "jax": jax_refs,
            "root": root}


# -- the shard dims ------------------------------------------------------------------


def _spec_dims(tree, prefix=""):
    """{keypath: the dim on the model axis, or None} of a JAX spec tree."""
    if isinstance(tree, P):
        return {prefix: next((i for i, a in enumerate(tree) if a == "model"), None)}
    if isinstance(tree, dict):
        return {k2: v for k, t in tree.items() for k2, v in _spec_dims(t, f"{prefix}/{k}").items()}
    if hasattr(tree, "_fields"):
        return {k2: v for k, t in zip(tree._fields, tree)
                for k2, v in _spec_dims(t, f"{prefix}/{k}").items()}
    raise TypeError(type(tree))


def _port_dims(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v for k, t in tree.items() for k2, v in _port_dims(t, f"{prefix}/{k}").items()}
    if isinstance(tree, tuple):
        return {k2: v for k, t in zip(tree._fields, tree)
                for k2, v in _port_dims(t, f"{prefix}/{k}").items()}
    return {prefix: tree}


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("arch,layout,base", [
    ("unet", "per_step", 8), ("unet", "per_step", 6), ("attention", "per_step", 8),
    ("unetpp", "per_step", 8), ("r2u", "per_step", 8), ("r2u", "shared", 8),
    ("r2attu", "per_step", 8), ("r2attu", "shared", 8)])
def test_shard_dims_equal_jax_specs(arch, layout, base, tp):
    fields = dict(n_channels=3, n_classes=1, bilinear=True, base_channels=base, arch=arch,
                  recur_bn=layout)
    jp, js = jax.eval_shape(lambda k: j_init(k, JConfig(**fields)), jax.random.PRNGKey(0))
    tp_, ts = init_unet(UNetConfig(**fields), np.random.default_rng(0), device="meta")
    got = _port_dims(unet_param_specs(tp_, tp)) | _port_dims(unet_state_specs(ts, tp))
    want = _spec_dims(j_param_specs(jp, tp)) | _spec_dims(j_state_specs(js, tp))
    assert got == want
    assert any(d is not None for d in got.values())
    if base == 6 and tp == 4:  # 6 % 4: inc stays replicated, down1 (12) shards
        assert got["/inc/conv1/w"] is None and got["/down1/conv1/w"] == 3


# -- the train step --------------------------------------------------------------------


# One step's ceiling: RMSprop's first step moves a param by at most 10·lr,
# so a gradient element whose sign flipped leaves it 2·10·lr apart (JAX's
# 0.08 is three steps' ceiling, which one step cannot reach).
ONE_STEP = 2 * 10 * LR


def _params_rule(got, want, ceiling=0.08, worst=5e-4):
    """``test_tp_train_steps_match_single_device``'s params rule: no
    element off by ``ceiling``, at most ``worst`` of a leaf's past 2e-2."""
    g, w = _flat(got), _flat(want)
    assert sorted(g) == sorted(w)
    for k in w:
        diff = np.abs(g[k].astype(np.float64) - w[k].astype(np.float64))
        assert diff.max() < ceiling, (k, diff.max())
        assert np.mean(diff > 2e-2) <= worst, (k, np.mean(diff > 2e-2))


def _grads_rule(got, want, gnorm, want_gnorm):
    """The first step's grad norm within 1e-4 relative and each clipped
    gradient element within 1e-6 + 1e-3 relative, JAX's fp32 gradient
    tolerances (``tests/test_pipeline.py``). RMSprop and Adam normalise
    each element, so the params rule alone would pass a sharded gradient
    scaled by any factor; this rule does not."""
    assert abs(gnorm - want_gnorm) <= 1e-4 * abs(want_gnorm), (gnorm, want_gnorm)
    g, w = _flat(got), _flat(want)
    assert sorted(g) == sorted(w)
    for k in w:
        np.testing.assert_allclose(g[k], w[k], rtol=1e-3, atol=1e-6, err_msg=k)


def _grads64_rule(r, grads32, gnorm64, grads64):
    """The grid's float64 step (``r["grads64"]``) against the one-process
    float64 step: the grad norm within 1e-12 relative, every element within
    1e-8 of the largest (round-off, seven orders below a doubled or zeroed
    shard). Then the grid's fp32 gradients against the float64 ones: each
    element within 1e-6 + 1e-3 relative plus twice the one-process fp32
    step's largest distance from them (``grads32``), where BN over a few
    rows amplifies fp32 round-off past an element rule (R2U-Net, UNet++)."""
    assert abs(r["gnorm64"] - gnorm64) <= 1e-12 * gnorm64, (r["gnorm64"], gnorm64)
    g, w, g32, one = _flat(r["grads64"]), _flat(grads64), _flat(r["grads1"]), _flat(grads32)
    assert sorted(g) == sorted(w) == sorted(g32) == sorted(one)
    big = max(float(np.abs(v).max()) for v in w.values())
    err = max(float(np.abs(one[k] - w[k]).max()) for k in w)
    for k in w:
        np.testing.assert_allclose(g[k], w[k], rtol=0, atol=1e-8 * big, err_msg=k)
        np.testing.assert_allclose(g32[k], w[k], rtol=1e-3, atol=1e-6 + 2 * err, err_msg=k)


def _gnorm_rule(gnorm, want, gnorm64):
    """PR 18's grad-norm rule against JAX: within 1e-3 relative, or at most
    twice as far from the float64 one-process step's as JAX's is."""
    if abs(gnorm - want) > 1e-3 * want:
        assert abs(gnorm - gnorm64) <= 2 * abs(want - gnorm64) + 1e-6 * gnorm64, (
            gnorm, want, gnorm64)


def _bn_rule(got, want, atol=2e-2):
    g, w = _flat(got), _flat(want)
    assert sorted(g) == sorted(w)
    for k in w:
        np.testing.assert_allclose(g[k], w[k], atol=atol, err_msg=k)


@functools.lru_cache(maxsize=None)
def _port_steps(name, steps):
    """The port's one-process steps from the same trees: (losses, params,
    BN state, grad norms, the first step's clipped gradients) as numpy."""
    cfg = UNetConfig(**_fields(name))
    p, s = (tree_from_numpy(t) for t in _carried(_tree(name)))
    o = get_optimizer("rmsprop")[0](p)
    imgs, masks = (torch.from_numpy(a) for a in _batch())
    step, losses, norms, grads = make_train_step(cfg, return_grads=True), [], [], None
    for _ in range(steps):
        p, s, o, loss, gnorm, g = step(p, s, o, imgs, masks, LR)
        losses.append(float(loss))
        norms.append(float(gnorm))
        grads = _numpy_tree(g) if grads is None else grads
    return losses, _numpy_tree(p), _numpy_tree(s), norms, grads


@functools.lru_cache(maxsize=None)
def _port_step64(name):
    """The port's one-process first step in float64: (grad norm, clipped
    gradients as numpy)."""
    p, s = (tree_from_numpy(t) for t in _carried(_tree(name)))
    imgs, masks = (torch.from_numpy(a) for a in _batch())
    return float64_step(UNetConfig(**_fields(name)), None, p, s, imgs, masks, LR)


@pytest.mark.parametrize("grid", GRIDS, ids=lambda g: f"S{g[0]}xT{g[1]}")
def test_flagship_steps_match_jax_mesh_and_single_device(tp_runs, grid):
    """The first step against JAX's tp step on its 3-D mesh and its
    single-device step; the trajectory of 3 steps against the port's
    one-process steps (two implementations' RMSprop sign flips drift apart
    after the first step, as a step's flips do in JAX's own test).

    The first step's gradients are held against the port's one-process
    step (and on the 1 x 2 x 2 grid, in float64 too), the grad norm against
    JAX's. The BN running statistics and the grad norm are held against
    JAX's single-device step: JAX's 1 x 2 x 2 mesh step returns the running
    means of inc's, down1's and up4's channel-sharded BN1 doubled, and its
    gradients there about 1 (relative L2) off its single-device step's (its
    (1, 2), (2, 1) and (4, 1) meshes and its single-device step agree with
    the port there)."""
    ranks = tp_runs["step"][_grid(*grid)]
    r = ranks[0]
    gnorm64, grads64 = _port_step64("unet")
    for ref in (tp_runs["jax"]["single"], tp_runs["jax"][grid]):
        losses, params, state, _, norms, grads = ref
        np.testing.assert_allclose(r["loss"][:1], losses, rtol=5e-4, atol=1e-5)
        _params_rule(r["params1"], params, ceiling=ONE_STEP)
    _bn_rule(r["bn1"], tp_runs["jax"]["single"][2])
    _gnorm_rule(r["gnorm"][0], tp_runs["jax"]["single"][4][0], gnorm64)
    if grid[0] == 1:
        _bn_rule(r["bn1"], tp_runs["jax"][grid][2])
        _gnorm_rule(r["gnorm"][0], tp_runs["jax"][grid][4][0], gnorm64)
    losses, params, state, norms, grads = _port_steps("unet", STEPS)
    _grads_rule(r["grads1"], grads, r["gnorm"][0], norms[0])
    if grid[0] > 1:
        _grads64_rule(r, grads, gnorm64, grads64)
    np.testing.assert_allclose(r["loss"], losses, rtol=5e-4, atol=1e-5)
    _params_rule(r["params"], params)
    _bn_rule(r["bn"], state)
    # The model ranks of a (data, spatial) coordinate hold the same
    # replicated leaves, bitwise; every rank the same losses.
    assert len({rk["digest"] for rk in ranks}) == 1
    assert all(rk["loss"] == r["loss"] for rk in ranks)


def test_shards_hold_one_tth_of_the_sharded_blocks(tp_runs):
    for (s, t) in GRIDS:
        r = tp_runs["step"][_grid(s, t)][0]
        assert r["down2_conv1"] == [3, 3, 16, 32 // t]  # JAX: [3,3,16,32] over T ranks
        # Every DoubleConv shards at base 8: a little more than 1/T a rank
        # (BN2, the upsamplers' absence and the head stay whole).
        assert r["bytes"] < (1 / t + 0.05) * r["full_bytes"]
    one = tp_runs["step"]["t1"][0]
    assert one["bytes"] == one["full_bytes"]


@pytest.mark.parametrize("name", [*FAMILIES, "adam"])
def test_families_and_adam_step_match_jax_single_device(tp_runs, name):
    ranks = tp_runs["step"][name]
    r = ranks[0]
    losses, params, state, opt, norms, grads = tp_runs["jax"][name]
    np.testing.assert_allclose(r["loss"], losses, rtol=5e-4)
    gnorm64, grads64 = _port_step64(_tree(name))
    _gnorm_rule(r["gnorm"][0], norms[0], gnorm64)
    if name in FAMILIES:
        _grads64_rule(r, _port_steps(name, 1)[4], gnorm64, grads64)
    else:  # Adam's step: the flagship's gradients
        one = _port_steps("unet", STEPS)
        _grads_rule(r["grads1"], one[4], r["gnorm"][0], one[3][0])
    _bn_rule(r["bn"], state)
    _params_rule(r["params"], params, ceiling=ONE_STEP)
    # The eval forward on the shards: the one-process forward's logits.
    cfg = UNetConfig(**_fields(name))
    p, s = (tree_from_numpy(t) for t in _carried(_tree(name)))
    imgs = torch.from_numpy(_batch()[0])
    with torch.no_grad():
        want = unet_apply(p, s, imgs, config=cfg, train=False)[0].numpy()
    for k, rk in enumerate(ranks):
        d = k // 2  # 2 x 1 x 2: rank r at data coordinate r // 2
        np.testing.assert_allclose(rk["y"], want[4 * d:4 * (d + 1)], atol=1e-4)
    assert len({rk["digest"] for rk in ranks[:2]}) == 1
    if name == "adam":
        # Adam's scalar step is replicated; its moments gathered whole.
        assert int(r["opt"].step) == 1 == int(opt.step)
        for a, b in zip((r["opt"].exp_avg, r["opt"].exp_avg_sq), (opt.exp_avg, opt.exp_avg_sq)):
            ga, gb = _flat(a), _flat(b)
            for k in gb:
                # A quantile-shaped rule at the leaf's scale: at most 0.1%
                # of a moment's elements (or 3) off by 1% of its largest,
                # none by 10%.
                diff, top = np.abs(ga[k] - gb[k]), np.abs(gb[k]).max()
                assert (diff > 1e-2 * top).sum() <= max(3, 1e-3 * diff.size), k
                assert diff.max() <= 0.1 * top, k


def test_indivisible_block_stays_replicated_and_matches_one_process(tp_runs):
    r = tp_runs["step"]["odd"][0]
    losses, params, state, norms, grads = _port_steps("odd", 1)
    np.testing.assert_allclose(r["loss"], losses, rtol=5e-4)
    _grads_rule(r["grads1"], grads, r["gnorm"][0], norms[0])
    _params_rule(r["params"], params, ceiling=ONE_STEP)
    _bn_rule(r["bn"], state)
    assert len({rk["digest"] for rk in tp_runs["step"]["odd"]}) == 1


def test_model_axis_of_one_is_the_data_spatial_grid(tp_runs):
    for r in tp_runs["step"]["t1"]:
        assert r["pr18_bitwise"]
        old, new = r["pr18_coords"]
        assert old == new and new[4] == 1 and new[5]  # T = 1: the sums over the world


# -- evaluation and the trainer ----------------------------------------------------------


def test_eval_forward_and_evaluate_match_one_process(tp_runs):
    p, s = (tree_from_numpy(t) for t in _carried("eval"))
    cfg = UNetConfig(**EVAL_CFG)
    batches = _eval_batches()
    want = evaluate(p, s, batches, cfg)
    want_c = evaluate_per_class(p, s, batches, cfg)
    want_tta = evaluate(p, s, batches, cfg, tta=True)
    with torch.no_grad():
        y = unet_apply(p, s, torch.from_numpy(_batch()[0]), config=cfg, train=False)[0].numpy()
    for k, rk in enumerate(tp_runs["eval"]):
        np.testing.assert_allclose(rk[1]["y"], y[4 * (k // 2):4 * (k // 2 + 1)],
                                   rtol=1e-4, atol=1e-5)
        for rec in rk.values():
            np.testing.assert_allclose(rec["scalar"], want, atol=1e-6)
        np.testing.assert_allclose(rk[1]["tta"], want_tta, atol=1e-6)
        for a, b in zip(rk[1]["per_class"], want_c):
            np.testing.assert_allclose(a, b, atol=1e-6)


def test_train_model_tp_matches_data_parallel_and_resumes(tp_runs):
    r = tp_runs["train"][0]
    dp, tp = r["dp"]["history"], r["tp"]["history"]
    assert len(tp["train_loss"]) == len(dp["train_loss"]) == 2 and len(tp["val_dice"]) == 2
    np.testing.assert_allclose(tp["train_loss"], dp["train_loss"], rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(tp["val_dice"], dp["val_dice"], atol=1e-3)
    np.testing.assert_allclose(tp["val_dice_ema"], dp["val_dice_ema"], atol=1e-3)
    a, b = r["dp_resumed"]["history"], r["tp_resumed"]["history"]
    assert len(a["train_loss"]) == len(b["train_loss"]) == 1
    np.testing.assert_allclose(b["train_loss"], a["train_loss"], rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(b["val_dice"], a["val_dice"], atol=1e-3)
    files = ["checkpoint_epoch1.npz", "checkpoint_epoch1_ema.npz", "checkpoint_epoch2.npz",
             "checkpoint_epoch2_ema.npz"]
    assert r["dp"]["files"] == r["tp"]["files"] == files
    assert r["tp_resumed"]["files"] == ["checkpoint_epoch3.npz", "checkpoint_epoch3_ema.npz"]
    # The W&B panel: every leaf of the whole model, as the data-parallel run's.
    for pa, pb in zip(r["dp"]["panel"], r["tp"]["panel"]):
        assert pa == pb and any(k.startswith("Gradients/") for k in pa)


def test_train_cli_tp_trains_checkpoints_validates_and_resumes(tp_runs):
    for r in tp_runs["train"]:
        first, resumed = r["cli"]
        assert len(first["train_loss"]) == len(resumed["train_loss"]) == 1
        assert len(first["val_dice"]) == len(resumed["val_dice"]) == 1
        assert np.isfinite(first["train_loss"] + resumed["train_loss"]).all()
        assert resumed == tp_runs["train"][0]["cli"][1]  # every rank the same history
    assert tp_runs["train"][0]["cli_files"] == ["checkpoint_epoch1.npz", "checkpoint_epoch2.npz"]


def test_tp_checkpoint_is_the_whole_model(tp_runs):
    root = tp_runs["root"] / "ck"
    for name in ("checkpoint_epoch2.npz", "checkpoint_epoch2_ema.npz"):
        with np.load(root / "tp" / name) as a, np.load(root / "dp" / name) as b:
            assert sorted(a.files) == sorted(b.files)
            for k in b.files:
                assert a[k].shape == b[k].shape and a[k].dtype == b[k].dtype, k
            # Two steps apart by sign-flip jitter (the optimizer's buffers
            # amplify it, so they are held by shape alone).
            params = [k for k in b.files if k.split("/")[0] in ("params", "state")]
            assert params
            _params_rule({k: a[k] for k in params}, {k: b[k] for k in params})
    # The port's one-process loader and the JAX package's read it whole.
    cfg = UNetConfig(**BASE)
    path = root / "tp" / "checkpoint_epoch2.npz"
    p, s, _, extra = load_checkpoint(path, cfg, opt_like=get_optimizer("rmsprop")[0](
        init_unet(cfg, np.random.default_rng(0))[0]))
    assert p["down2"]["conv1"]["w"].shape == (3, 3, 16, 32) and "opt_state" in extra
    jcfg, jp, js = _jax_world("unet")
    params, state, _, jextra = j_load(path, jp, js, j_get_optimizer("rmsprop")[0](jp))
    assert params["down2"]["conv1"]["w"].shape == (3, 3, 16, 32) and "opt_state" in jextra
    assert isinstance(state["down2"]["bn1"], JBNState)


# -- refusals --------------------------------------------------------------------------


def test_refusals_are_jax_words():
    flags = dict(accum_steps=1, batch_size=4, early_stopping=None, kernels=None)
    with pytest.raises(ValueError, match=r"--tensor-parallel requires --data-parallel \(the data "
                                         r"axis may still end up size 1\)"):
        _check_train_flags(**flags, tensor_parallel=2)
    with pytest.raises(ValueError, match="--zero is redundant with --tensor-parallel"):
        _check_train_flags(**flags, tensor_parallel=2, zero=True, data_parallel=True)
    with pytest.raises(ValueError, match=r"--kernels cuda data parallelism is 1-D \(shard_map\); "
                                         "--tensor-parallel requires the XLA backend"):
        check_grid(4, 1, "cuda", 2)
    with pytest.raises(ValueError, match="6 devices not divisible by spatial·model = 2·2"):
        check_grid(6, 2, None, 2)
    record = DataParallel(group=None, host_group=None, rank=0, world_size=4,
                          device=torch.device("cpu"))
    with pytest.raises(ValueError, match="4 devices not divisible by spatial·model = 1·3"):
        make_grid(record, 1, 3)
    with pytest.raises(ValueError, match="4 devices not divisible by spatial·model = 1·3"):
        _build_mesh({}, {}, data_parallel=record, tensor_parallel=3)
    # One rank, or T = 1: no grid and no refusal (JAX builds no mesh there).
    assert not check_grid(1, 1, "cuda", 2) and not check_grid(4, 1, "cuda", 1)
    cfg = UNetConfig(**BASE)
    grid = type("G", (), {"model_size": 2, "model_group": None})()
    with pytest.raises(ValueError, match="--tensor-parallel requires the XLA backend"):
        make_train_step(cfg, mesh=grid, kernels="cuda")
    from tpu_unet_torch.models.unet import _double_conv_apply

    with pytest.raises(Refused, match="--tensor-parallel requires the XLA backend"):
        _double_conv_apply({}, {}, torch.zeros(1, 4, 4, 3), train=True, kernels="cuda",
                           group=grid)


@pytest.mark.parametrize("argv,env,match", [
    (["--tensor-parallel", "2"], None, "--tensor-parallel requires --data-parallel"),
    (["--data-parallel", "--tensor-parallel", "2", "--kernels", "cuda"], "4",
     r"--kernels cuda data parallelism is 1-D \(shard_map\); --tensor-parallel requires"),
    (["--data-parallel", "--tensor-parallel", "4", "--spatial-parallel", "2"], "4",
     "4 devices not divisible by spatial·model = 2·4"),
    (["--data-parallel", "--tensor-parallel", "2", "--zero"], "4",
     "--zero is redundant with --tensor-parallel"),
])
def test_train_cli_refuses_before_the_rendezvous(monkeypatch, argv, env, match):
    if env is None:
        monkeypatch.delenv("WORLD_SIZE", raising=False)
    else:
        monkeypatch.setenv("WORLD_SIZE", env)
    with pytest.raises(SystemExit, match=match):
        train_cli.main(["--device", "cpu", *argv])
    assert not torch.distributed.is_initialized()
