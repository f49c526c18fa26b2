"""The port's data parallelism (``tpu_unet_torch/parallel/mesh.py``) on the
CPU: 2 and 4 gloo ranks, each a spawned process (``tests/torch_dp_workers.py``),
against the JAX package's full-batch functions and its mesh step
(``make_mesh(n_devices=W)``, JAX's 8-device virtual CPU mesh), fp32, as
``tests/test_parallel.py`` holds JAX's own data parallelism:

- ``batch_norm(group=)`` and ``double_conv_train_fused(group=)`` (its
  kernels' plain versions) with rank k's rows centred at 10·k, against
  ``tpu_unet/ops/batchnorm.py`` and JAX's DoubleConv (``train=True``, the
  function the fused unit computes) on the full batch, as
  ``test_synced_bn_axis_name_matches_full_batch`` does: y and the x
  gradient 1e-5 + 1e-5 relative, the running stats 1e-6 + 1e-5 relative,
  the parameter gradients 1e-5 of their largest magnitude;
- the U-Net train step (base 8, 32x32, global batch 8) on both kernel
  routes against JAX's mesh step (``make_train_step(mesh=)``: shard_map,
  ``kernels="pallas"`` in interpret mode at 2 ranks) by the single-process
  parity of ``tests/test_torch_families.py``: ``test_torch_train.py``'s
  tolerances, the gradients, grad norm and square_avg widened by twice
  JAX's own fp32 distance from its float64 step (at this size JAX's fp32
  gradients lie up to 4.6% of a leaf's largest magnitude from its float64
  ones, at down3; the port's single-process step within 2e-6);
- the same step against the port's own single-process full-batch step and
  JAX's float64 full-batch step: loss 1e-6 relative and BN running stats
  1e-6 + 1e-6 relative of the single-process step's. The gradients, the
  grad norm and the updated params differ from it only by the order of the
  sums across ranks, which train-mode BN amplifies, so they are held by
  their distance from JAX's float64 step: the largest per-tensor relative
  L2 distance of the tree (``chip_smoke.py`` phase 5's measure) at most 2x
  the single-process step's (+1e-7), the grad norm's at most 2x its (+1e-6
  relative);
- the ranks' params after two steps bitwise equal; the world-size-1 step
  bitwise equal to the plain step; ``accum_steps=2`` (against JAX's float64
  step: loss 1e-5 relative, BN running stats 1e-4 + 1e-4, and the rules
  above). The families' step is in ``tests/test_torch_dp_cli.py``.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.test_torch_families import _close, _f64, _jax_float64
from tests.test_torch_train import _assert_trees, _copy, _flat, _numpy
from tests.torch_dp_workers import jobs_worker, port_numpy, run_ranks
from tpu_unet.data.synthetic import synth_batch as j_synth_batch
from tpu_unet.models import UNetConfig as JConfig, init_unet as j_init
from tpu_unet.ops.batchnorm import BNState as JBNState, batch_norm as j_batch_norm
from tpu_unet.models.unet import _double_conv_apply as j_double_conv
from tpu_unet.optim import rmsprop_init as j_rms_init
from tpu_unet.parallel.mesh import batch_sharding, make_mesh, replicated
from tpu_unet.train import make_train_step as j_make_step
from tpu_unet_torch.checkpoint import tree_from_numpy
from tpu_unet_torch.models.unet import UNetConfig
from tpu_unet_torch.optim import rmsprop_init
from tpu_unet_torch.parallel.mesh import init_data_parallel
from tpu_unet_torch.train import _check_train_flags, make_train_step

B, HW, BASE, LR = 8, 32, 8, 1e-3
UNET = dict(n_channels=3, n_classes=1, bilinear=False, base_channels=BASE)
# (world size, arch, step kwargs): the steps run in each spawned group.
CASES = {
    2: [("unet", {}), ("unet", {"kernels": "cuda"}), ("unet", {"accum_steps": 2})],
    4: [("unet", {}), ("unet", {"kernels": "cuda"})],
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@functools.lru_cache(maxsize=None)
def _world(arch):
    """(JAX config, JAX params, state as numpy) of one family, base 8."""
    jcfg = JConfig(3, 1, False, BASE, arch=arch)
    # Jitted: one compile, where the eager init compiles each op alone.
    params, state = jax.jit(j_init, static_argnums=1)(jax.random.PRNGKey(0), jcfg)
    return jcfg, _numpy(params), _numpy(state)


@functools.lru_cache(maxsize=None)
def _batch():
    return j_synth_batch(np.random.default_rng(5), B, HW, HW)


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    return tmp_path_factory.mktemp("dp")


_RUNS: dict = {}


@functools.lru_cache(maxsize=None)
def _ops_data(world):
    """Inputs of the BN and DoubleConv checks: rank k's rows centred at 10·k
    (the between-rank variance dominates), BN params and state, the loss
    weights, and down1's block (8 -> 16 channels)."""
    rng = np.random.default_rng(1)
    c = 8
    x = rng.standard_normal((8, 4, 4, c)).astype(np.float32)
    x += 10.0 * np.repeat(np.arange(world, dtype=np.float32), 8 // world)[:, None, None, None]
    bn_p = {"scale": (1 + 0.3 * rng.standard_normal(c)).astype(np.float32),
            "bias": rng.standard_normal(c).astype(np.float32)}
    bn_s = JBNState((0.2 * rng.standard_normal(c)).astype(np.float32),
                    (1 + rng.random(c)).astype(np.float32))
    wy = rng.standard_normal(x.shape).astype(np.float32)
    wz = rng.standard_normal((8, 4, 4, 16)).astype(np.float32)
    _, params, state = _world("unet")
    return x, bn_p, bn_s, wy, params["down1"], state["down1"], wz


def _dp_run(world, workdir):
    """One group of ``world`` ranks for the module: the BN and DoubleConv
    checks, then each case's two steps. Every rank's results."""
    if world not in _RUNS:
        cases = [(UNET | {"arch": arch}, kw) for arch, kw in CASES[world]]
        x, bn_p, bn_s, wy, block_p, block_s, wz = _ops_data(world)
        ix, im = _batch()
        _, params, state = _world("unet")
        jobs = [("ops_worker", ((x, bn_p, tuple(bn_s), wy),
                                (x, port_numpy(block_p), port_numpy(block_s), wz))),
                ("step_worker", (cases, {"unet": port_numpy(params)},
                                 {"unet": port_numpy(state)}, ix, im, LR))]
        _RUNS[world] = run_ranks(jobs_worker, world, workdir, jobs, timeout=240)
    return _RUNS[world]


def _case(world, workdir, arch, kw):
    """(rank 0's result, every rank's) of one case."""
    i = CASES[world].index((arch, kw))
    ranks = [r[1] for r in _dp_run(world, workdir)]
    return ranks[0][i], [r[i] for r in ranks]


@functools.lru_cache(maxsize=None)
def _port_single(arch, kernels=None, accum_steps=1):
    """The port's single-process full-batch step (numpy trees)."""
    _, params, state = _world(arch)
    cfg = UNetConfig(**UNET | {"arch": arch})
    tp, ts = tree_from_numpy(params), tree_from_numpy(state)
    x, m = _batch()
    o = make_train_step(cfg, return_grads=True, kernels=kernels, accum_steps=accum_steps)(
        tp, ts, rmsprop_init(tp), torch.from_numpy(x), torch.from_numpy(m), LR)
    return _flat(o[0]), _flat(o[1]), _flat(o[2]), float(o[3]), float(o[4]), _flat(o[5])


@functools.lru_cache(maxsize=None)
def _jax_single(arch, jkernels=None, accum_steps=1, float64=False):
    jcfg, params, state = _world(arch)
    x, m = _batch()
    trees = (params, state, _numpy(j_rms_init(params)))
    if float64:
        with _jax_float64():
            out = j_make_step(jcfg, return_grads=True, accum_steps=accum_steps)(
                *map(_f64, trees), _f64(x), jnp.asarray(m), jnp.float64(LR))
            return tuple(_numpy(t) for t in out)
    out = j_make_step(jcfg, return_grads=True, kernels=jkernels, accum_steps=accum_steps)(
        *(_copy(t) for t in trees), jnp.asarray(x), jnp.asarray(m), jnp.float32(LR))
    return tuple(_numpy(t) for t in out)


@functools.lru_cache(maxsize=None)
def _jax_mesh(world, jkernels=None):
    """JAX's data-parallel step over a ``world``-device mesh (shard_map)."""
    jcfg, params, state = _world("unet")
    x, m = _batch()
    mesh = make_mesh(n_devices=world)
    rep, shard = replicated(mesh), batch_sharding(mesh)
    trees = (params, state, _numpy(j_rms_init(params)))
    step = j_make_step(jcfg, return_grads=True, kernels=jkernels, mesh=mesh)
    out = step(*(jax.device_put(_copy(t), rep) for t in trees), jax.device_put(x, shard),
               jax.device_put(m, shard), jnp.float32(LR))
    return tuple(_numpy(t) for t in out)


def _check_jax(r, jo, j64):
    """A DP step (r) against a JAX step (jo) and JAX's float64 step (j64):
    ``test_family_train_step_matches_jax``'s rules."""
    np.testing.assert_allclose(r["loss"], float(jo[3]), rtol=1e-5)
    _close(np.float32(r["gnorm"]), np.asarray(jo[4]), np.asarray(j64[4]), rtol=1e-4)
    _close(r["grads"], jo[5], j64[5], atol=1e-6, scale=1e-3, floor="grads")
    _assert_trees(r["bn"], jo[1], atol=1e-4, rtol=1e-4)
    _close(r["square_avg"], jo[2].square_avg, j64[2].square_avg, atol=1e-9, rtol=1e-3,
           floor="square_avg")
    _assert_trees(r["params"], jo[0], atol=2e-2)


def _rel_l2(a, b) -> float:
    return float(np.linalg.norm((a - b).ravel()) / max(np.linalg.norm(b.ravel()), 1e-30))


def _check_against_single(r, single, ref64):
    """DP (r) against the port's single-process step (``single``), the
    gradients, grad norm and params through their distance from JAX's
    float64 step (``ref64``)."""
    np.testing.assert_allclose(r["loss"], single[3], rtol=1e-6)
    g64 = float(ref64[4])
    assert abs(r["gnorm"] - g64) <= 2 * abs(single[4] - g64) + 1e-6 * g64, \
        (r["gnorm"], single[4], g64)
    got_bn, sp_bn = _flat(r["bn"]), single[1]
    for k in sp_bn:
        np.testing.assert_allclose(got_bn[k], sp_bn[k], atol=1e-6, rtol=1e-6, err_msg=k)
    for name, got, sp, ref in (("grads", r["grads"], single[5], ref64[5]),
                               ("params", r["params"], single[0], ref64[0])):
        got, ref = _flat(got), _flat(ref)
        e_dp = max(_rel_l2(got[k], ref[k]) for k in ref)
        e_sp = max(_rel_l2(sp[k], ref[k]) for k in ref)
        assert e_dp <= 2 * e_sp + 1e-7, (name, e_dp, e_sp)


@pytest.mark.parametrize("world", [2, 4])
def test_synced_bn_and_fused_unit_match_full_batch(world, workdir):
    x, bn_p, bn_s, wy, block_p, block_s, wz = _ops_data(world)
    ranks = [r[0] for r in _dp_run(world, workdir)]

    @jax.jit
    def bn_ref(xx, p):
        def loss(xx, p):
            y, new = j_batch_norm(xx, p, bn_s, train=True)
            return jnp.sum(y * wy), (y, new)
        return jax.grad(loss, argnums=(0, 1), has_aux=True)(xx, p)

    @jax.jit
    def fused_ref(xx, p):
        def loss(xx, p):
            y, new = j_double_conv(p, block_s, xx, train=True)
            return jnp.sum(y * wz), (y, new)
        return jax.grad(loss, argnums=(0, 1), has_aux=True)(xx, p)

    (gx, gp), (ref_y, ref_state) = bn_ref(jnp.asarray(x), bn_p)
    (fgx, fgp), (fy, fstate) = fused_ref(jnp.asarray(x), block_p)
    per = 8 // world
    for k, r in enumerate(ranks):
        rows = slice(k * per, (k + 1) * per)
        bn, fu = r["bn"], r["fused"]
        np.testing.assert_allclose(bn["y"], np.asarray(ref_y)[rows], atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(bn["gx"], np.asarray(gx)[rows], atol=1e-5, rtol=1e-5)
        for got, ref in zip(bn["state"], ref_state):
            np.testing.assert_allclose(got, np.asarray(ref), atol=1e-6, rtol=1e-5)
        for key in ("scale", "bias"):
            ref = np.asarray(gp[key])
            np.testing.assert_allclose(bn[f"g{key}"], ref, atol=1e-5 * np.abs(ref).max())
        np.testing.assert_allclose(fu["y"], np.asarray(fy)[rows], atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(fu["gx"], np.asarray(fgx)[rows], atol=1e-5, rtol=1e-5)
        got_s, ref_s = _flat(fu["state"]), _flat(_numpy(fstate))
        for key in ref_s:
            np.testing.assert_allclose(got_s[key], ref_s[key], atol=1e-6, rtol=1e-5,
                                       err_msg=key)
        for got, ref in zip(fu["gw"], jax.tree.leaves(fgp)):
            ref = np.asarray(ref)
            np.testing.assert_allclose(got, ref, atol=1e-5 * np.abs(ref).max())


# Against JAX's mesh step on the matching route; JAX's Pallas step runs
# interpreted on the CPU, once (at 2 ranks).
@pytest.mark.parametrize("world,kernels,jkernels", [
    (2, None, None), (2, "cuda", "pallas"), (4, None, None), (4, "cuda", None)])
def test_dp_step_matches_jax_and_single_process(world, kernels, jkernels, workdir):
    kw = {"kernels": kernels} if kernels else {}
    r, ranks = _case(world, workdir, "unet", kw)
    j64 = _jax_single("unet", float64=True)
    _check_jax(r, _jax_mesh(world, jkernels), j64)
    _check_against_single(r, _port_single("unet", kernels), j64)
    for other in ranks[1:]:
        assert other["loss"] == r["loss"] and other["loss2"] == r["loss2"]
        assert np.array_equal(other["params2"], r["params2"])  # bitwise, after two steps


def test_dp_accum_steps_matches_jax_and_single_process(workdir):
    """accum_steps=2 at 2 ranks: each rank's rows j::2 are the global rows
    j::2 (2 divides the 4 rows of a rank)."""
    r, ranks = _case(2, workdir, "unet", {"accum_steps": 2})
    j64 = _jax_single("unet", accum_steps=2, float64=True)
    np.testing.assert_allclose(r["loss"], float(j64[3]), rtol=1e-5)
    _assert_trees(r["bn"], j64[1], atol=1e-4, rtol=1e-4)
    _check_against_single(r, _port_single("unet", accum_steps=2), j64)
    assert np.array_equal(ranks[1]["params2"], r["params2"])
    # 4 ranks of 2 rows: microbatches of 4 are not the ranks' rows j::4.
    with pytest.raises(ValueError, match="must divide each rank's 2 rows"):
        _check_train_flags(accum_steps=4, batch_size=8, early_stopping=None, kernels=None,
                           world_size=4)


def test_world_size_one_step_is_bitwise_the_plain_step(tmp_path):
    """--data-parallel on one rank: the group is formed and every collective
    runs, and the step's outputs equal the plain step's bit for bit."""
    from datetime import timedelta

    _, params, state = _world("unet")
    x, m = _batch()
    cfg = UNetConfig(**UNET)
    dp = init_data_parallel(backend="gloo", device="cpu", init_method=f"file://{tmp_path}/rdzv",
                            rank=0, world_size=1, timeout=timedelta(seconds=60))
    try:
        for kernels in (None, "cuda"):
            outs = []
            for mesh in (None, dp):
                tp = tree_from_numpy(params)
                step = make_train_step(cfg, return_grads=True, kernels=kernels, mesh=mesh)
                o = step(tp, tree_from_numpy(state), rmsprop_init(tp), torch.from_numpy(x),
                         torch.from_numpy(m), LR)
                outs.append(_flat(dict(zip(("params", "bn", "opt", "loss", "gnorm", "grads"),
                                           o))))
            plain, one = outs
            assert sorted(plain) == sorted(one)
            for k in plain:
                assert np.array_equal(plain[k], one[k]), (kernels, k)
    finally:
        torch.distributed.destroy_process_group()
