"""The port's ZeRO-1 (``tpu_unet_torch/parallel/zero.py``, ``--zero``) on the
CPU: 2 gloo ranks, spawned once for the module (``tests/torch_dp_workers.py``),
against the port's plain data-parallel step and JAX's ZeRO step
(``tests/test_parallel.py::test_zero_sharded_opt_state_matches_plain_dp``:
base 8, bilinear, 32x32, a global batch of 8, lr 1e-3, three steps):

- each leaf's shard dimension is JAX's ``zero_state_specs``' on the base-8
  and base-64 trees for 2 and 8 ranks;
- three RMSprop and three Adam steps: params, BN state, losses and grad
  norms bitwise the plain data-parallel steps'; each rank holds half of
  every leaf with a dimension 2 divides, the rest whole; Adam's ``step``
  replicated; the gathered state bitwise the plain state;
- the RMSprop run against JAX's ZeRO step on its 8-device CPU mesh: the
  loss within JAX's own 1e-6 relative there; params and the gathered state
  by ``tests/test_torch_data_parallel.py``'s rule, their largest per-tensor
  relative L2 distance from JAX's float64 ZeRO run at most 2x JAX's fp32
  run's (+1e-7). JAX's element tolerances there (params 1e-3 relative +
  1e-4) bound its ZeRO against its own plain step, the same program but for
  the reduction grouping; across the two packages RMSprop's first updates
  are ``10·lr·sign(g)`` whatever ``|g|``, so a gradient element near zero
  whose sign the rounding sets moves its param by up to 1e-2 in three
  steps (here 0.3% of the params fall outside that element tolerance, by
  up to 9.6e-3; JAX's own fp32 run lies up to 3e-3 from its float64 one);
- ``train_cli --data-parallel --zero --save-optimizer`` writes the file the
  plain run writes, array for array, and ``--resume`` from it runs the next
  epoch as the plain run's resume does (history and checkpoint equal); a
  stop signal on rank 1 ends both ranks, and the ``INTERRUPTED.npz`` rank
  0 writes under ZeRO (every rank gathering the state first) is the plain
  run's;
- the five refusals of ``tpu_unet/train.py::_check_train_flags`` and the
  CLI's.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.test_torch_data_parallel import _rel_l2
from tests.test_torch_families import _f64, _jax_float64
from tests.test_torch_train import _flat, _numpy
from tests.torch_dp_workers import jobs_worker, port_numpy, run_ranks
from tpu_unet.data.synthetic import synth_batch as j_synth_batch
from tpu_unet.models import UNetConfig as JConfig, init_unet as j_init
from tpu_unet.optim import rmsprop_init as j_rms_init
from tpu_unet.parallel.mesh import batch_sharding, make_mesh, replicated
from tpu_unet.parallel.zero import (
    shard_opt_state_zero as j_shard,
    zero_opt_shardings as j_shardings,
    zero_state_specs as j_specs,
)
from tpu_unet.train import make_train_step as j_make_step
from tpu_unet_torch import train_cli
from tpu_unet_torch.data import make_synthetic_carvana
from tpu_unet_torch.models.unet import UNetConfig, init_unet
from tpu_unet_torch.optim import adam_init
from tpu_unet_torch.parallel.zero import zero_opt_shardings, zero_state_specs
from tpu_unet_torch.train import _check_train_flags, make_train_step

LR, STEPS = 1e-3, 3
JCFG = JConfig(3, 1, bilinear=True, base_channels=8)
CLI = ["--device", "cpu", "-e", "1", "-b", "4", "-s", "1.0", "-l", "1e-3", "--validation", "20",
       "--val-per-epoch", "1", "--seed", "0", "--save-optimizer"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@functools.lru_cache(maxsize=None)
def _inputs():
    params, state = jax.jit(j_init, static_argnums=1)(jax.random.PRNGKey(0), JCFG)
    images, masks = j_synth_batch(np.random.default_rng(0), 8, 32, 32)
    return _numpy(params), _numpy(state), images, masks


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Every rank's results: the steps, then the CLI runs (plain and --zero,
    one epoch, then --resume into a second)."""
    tmp = tmp_path_factory.mktemp("zero")
    make_synthetic_carvana(tmp / "data", n=10, h=32, w=32)
    params, state, images, masks = _inputs()
    common = [*CLI, "--data-dir", str(tmp / "data"), "--data-parallel"]
    jobs = [("zero_step_worker", (port_numpy(params), port_numpy(state), images, masks, LR,
                                  STEPS))]
    for tag, extra in (("plain", []), ("zero", ["--zero"])):
        ck = tmp / tag
        jobs.append(("train_cli_worker", (common + extra + ["--checkpoint-dir", str(ck)], 8)))
        jobs.append(("train_cli_worker", (
            common + extra + ["-e", "2", "--checkpoint-dir", str(ck / "resumed"), "--resume",
                              str(ck / "checkpoint_epoch1.npz")], 8)))
    for zero in (False, True):  # SIGTERM on rank 1 after its first step
        kw = dict(epochs=1, batch_size=4, learning_rate=1e-3, val_percent=0.2, seed=0,
                  checkpoint_dir=str(tmp / f"interrupted_{zero}"), zero=zero)
        jobs.append(("train_model_worker", (str(tmp / "data"), kw, 1, 1)))
    return tmp, run_ranks(jobs_worker, 2, tmp, jobs, timeout=150.0)


@pytest.mark.parametrize("base", [8, 64])
@pytest.mark.parametrize("n", [2, 8])
def test_shard_dims_match_jax(base, n):
    jcfg = JConfig(3, 1, bilinear=False, base_channels=base)
    shapes = jax.eval_shape(lambda k: j_init(k, jcfg), jax.random.PRNGKey(0))[0]
    ref = {k: (spec.index("data") if "data" in spec else None)
           for k, spec in _flat_specs(j_specs(shapes, n)).items()}
    params, _ = init_unet(UNetConfig(*jcfg), np.random.default_rng(0), device="meta")
    got = _flat_dims(zero_state_specs(params, n))
    assert got == ref and any(d is None for d in got.values())
    # The state fields that mirror the params are sliced; Adam's step is not.
    sh = zero_opt_shardings(_Record(n), adam_init(params), params)
    assert sh.fields == (True, True, False)


class _Record:
    """The fields of a DataParallel record that the shardings read."""

    def __init__(self, n):
        self.rank, self.world_size, self.group = 0, n, None


def _flat_specs(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat_specs(v, f"{prefix}/{k}"))
        return out
    return {prefix: tuple(tree)}


def _flat_dims(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat_dims(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def _equal(a, b):
    fa, fb = _flat(a), _flat(b)
    assert sorted(fa) == sorted(fb)
    for k in fa:
        np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)


def test_zero_steps_bitwise_plain(world):
    _, ranks = world
    steps = [r[0] for r in ranks]
    params, _, _, _ = _inputs()
    full = _flat(params)
    for rank, out in enumerate(steps):
        for opt, runs in out.items():
            plain, zero = runs["plain"], runs["zero"]
            _equal(zero["params"], plain["params"])
            _equal(zero["bn"], plain["bn"])
            assert zero["loss"] == plain["loss"] and zero["gnorm"] == plain["gnorm"]
            _equal(zero["opt_full"], plain["opt"])
            # The rank holds half of each divisible leaf of the moment trees.
            held = _flat(zero["opt"])
            for k, v in held.items():
                if k.endswith("/step"):
                    assert v.shape == () and v == STEPS, (opt, k)  # replicated
                    continue
                leaf = full["/" + k.split("/", 2)[2]]
                cut = [d for d in reversed(range(leaf.ndim)) if leaf.shape[d] % 2 == 0]
                want = list(leaf.shape)
                if cut:
                    want[cut[0]] //= 2
                assert list(v.shape) == want, (opt, k)
            if rank == 1:  # the ranks' params are the same
                _equal(zero["params"], steps[0][opt]["zero"]["params"])


def _jax_zero_run(params, state, images, masks, cast):
    """JAX's ZeRO step (``tests/test_parallel.py``), ``STEPS`` times on its
    8-device mesh from ``cast`` of the numpy trees: (params, state, loss)."""
    mesh = make_mesh()
    rep, shard = replicated(mesh), batch_sharding(mesh)
    p, s = (jax.device_put(cast(t), rep) for t in (params, state))
    o = j_shard(mesh, j_rms_init(p), params)
    step = j_make_step(JCFG, opt_shardings=j_shardings(mesh, o, params))
    args = (jax.device_put(cast(images), shard), jax.device_put(jnp.asarray(masks), shard),
            cast(np.float32(LR)))
    for _ in range(STEPS):
        p, s, o, loss, _ = step(p, s, o, *args)
    return _numpy(p), _numpy(o), float(loss)


def test_zero_step_matches_jax_zero_step(world):
    _, ranks = world
    got = ranks[0][0]["rmsprop"]["zero"]
    params, state, images, masks = _inputs()
    ref = _jax_zero_run(params, state, images, masks, lambda t: jax.tree.map(jnp.asarray, t))
    with _jax_float64():
        ref64 = _jax_zero_run(params, state, images, masks, _f64)
    np.testing.assert_allclose(got["loss"][-1], ref[2], rtol=1e-6)
    for name, port, jax32, jax64 in (("params", got["params"], ref[0], ref64[0]),
                                     ("state", got["opt_full"], ref[1], ref64[1])):
        port, jax32, jax64 = _flat(port), _flat(jax32), _flat(jax64)
        assert sorted(port) == sorted(jax64)
        e_port = max(_rel_l2(port[k], jax64[k]) for k in jax64)
        e_jax = max(_rel_l2(jax32[k], jax64[k]) for k in jax64)
        assert e_port <= 2 * e_jax + 1e-7, (name, e_port, e_jax)


def test_zero_checkpoint_equals_plain_and_resumes(world):
    tmp, ranks = world
    hist = [r[1:5] for r in ranks]  # plain, plain resumed, zero, zero resumed
    for rank_hist in hist:
        assert rank_hist[2] == rank_hist[0] and rank_hist[3] == rank_hist[1]
    assert hist[0] == hist[1]
    assert len(hist[0][1]["train_loss"]) == 2  # the resumed run trained epoch 2 only
    for name in ("checkpoint_epoch1.npz", "resumed/checkpoint_epoch2.npz"):
        with np.load(tmp / "plain" / name) as a, np.load(tmp / "zero" / name) as b:
            assert sorted(a.files) == sorted(b.files)
            assert any(k.startswith("opt") for k in a.files)
            for k in a.files:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_zero_interrupt_save_holds_the_whole_state(world):
    tmp, ranks = world
    for rank in ranks:
        plain, zero = rank[5:7]
        assert len(plain["history"]["train_loss"]) == len(zero["history"]["train_loss"]) == 1
        np.testing.assert_array_equal(zero["params"], plain["params"])
    with (np.load(tmp / "interrupted_False" / "INTERRUPTED.npz") as a,
          np.load(tmp / "interrupted_True" / "INTERRUPTED.npz") as b):
        assert sorted(a.files) == sorted(b.files)
        assert any(k.startswith("opt") for k in a.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("kw,match", [
    ({}, "--zero requires --data-parallel"),
    ({"data_parallel": True, "kernels": "cuda"}, "--zero requires the library route"),
    ({"data_parallel": True, "multihost": True}, "--zero is single-host for now"),
    ({"data_parallel": True, "tensor_parallel": 2}, "redundant with --tensor-parallel"),
    ({"data_parallel": True, "pipeline_parallel": 2}, "does not compose with --pipeline"),
])
def test_zero_refusals(kw, match):
    flags = dict(accum_steps=1, batch_size=4, early_stopping=None, kernels=None, zero=True)
    with pytest.raises(ValueError, match=match):
        _check_train_flags(**{**flags, **kw})
    cli = {"data_parallel": ["--data-parallel"], "kernels": ["--kernels", "cuda"],
           "multihost": ["--multihost", "--num-processes", "2"],
           "tensor_parallel": ["--tensor-parallel", "2"],
           "pipeline_parallel": ["--pipeline-parallel", "2"]}
    if set(kw) <= set(cli):  # the CLI refuses them before any rendezvous
        argv = ["--device", "cpu", "--zero"] + [a for k in kw for a in cli[k]]
        with pytest.raises(SystemExit, match=match):
            train_cli.main(argv)
    assert not torch.distributed.is_initialized()


def test_make_train_step_zero_needs_a_mesh():
    cfg = UNetConfig(3, 1, True, 8)
    with pytest.raises(ValueError, match="pass mesh"):
        make_train_step(cfg, opt_shardings=zero_opt_shardings(
            _Record(2), adam_init(init_unet(cfg, np.random.default_rng(0))[0]),
            init_unet(cfg, np.random.default_rng(0))[0]))
