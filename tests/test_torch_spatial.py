"""The port's spatial parallelism (``tpu_unet_torch/parallel/halo.py``,
``parallel/mesh.py::Grid``) on the CPU: 4 gloo ranks, spawned once for the
module (``tests/torch_dp_workers.py``), as 2 x 2 and 1 x 4 (data x
spatial) grids, against the unsharded ops, the port's one-process step and
the JAX package's 2-D mesh step (``make_mesh_2d``, its 8 CPU devices):

- each op (``conv2d``, ``max_pool2d``, ``upsample2x_align_corners``,
  ``pad_to_match``, ``conv_transpose2d``, ``batch_norm``, the Dice) on the
  rank's rows and height band at every level of two layouts whose deep
  levels split unevenly (H = 48 over S = 2: level 3's 6 rows 3 and 3;
  H = 40 over S = 4: level 4's 2 rows leave two ranks none), forward and
  backward, against the op on the whole input, in float64 (the split
  reorders the sums, whose fp32 rounding would hide a wrong row): outputs,
  input gradients and summed parameter gradients within 1e-12 of the
  largest magnitude, the upsample (fp32 inside) within fp32's 1e-6;
- the 2 x 2 step on ``tests/test_parallel.py``'s
  ``test_2d_dp_spatial_step_matches_single_device`` configuration (base 8,
  bilinear, 2 classes, 4x64x64, lr 1e-3, JAX's weights through the
  converter) against JAX's ``make_mesh_2d(spatial=4)`` step and JAX's
  single-device step, by that test's tolerances: loss 1e-5 relative, grad
  norm 1e-3, BN state 1e-3, params' median difference < 1e-5, at most 1%
  of a leaf's elements (or 3) off by more than 1e-3, none by 0.1; the
  ranks' params bitwise equal after two steps;
- one 2 x 2 step of each family (ConvT U-Net, attention, UNet++ with deep
  supervision, R2U-Net, R2AttU-Net) and of the U-Net with ``remat``
  against the port's one-process step by the same tolerances, a grad norm
  past 1e-3 held by PR 17's float64-distance rule instead (R2U-Net's
  one-process fp32 grad norm lies 2.7e-3 from its float64 one); ZeRO on the
  grid bitwise the plain grid step, with the state sliced over the data
  axis only (1/D a rank);
- the corpus staged per data coordinate gives the host loader's rows and
  bands bitwise; ``evaluate`` over the grid (batches 4, 4 and a trailing 3
  that does not split, run whole) within 1e-6 of the one-process
  evaluation, with and without TTA;
- JAX's refusals: ``kernels="cuda"`` on a grid, and W not divisible by S.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.test_torch_train import _flat, _numpy
from tests.torch_dp_workers import jobs_worker, port_numpy, run_ranks, spatial_inputs
from tpu_unet.data.synthetic import synth_batch as j_synth_batch
from tpu_unet.models import UNetConfig as JConfig, init_unet as j_init
from tpu_unet.optim import rmsprop_init as j_rms_init
from tpu_unet.parallel.mesh import image_sharding, make_mesh_2d, replicated
from tpu_unet.train import make_train_step as j_make_step
from tpu_unet_torch import ops
from tpu_unet_torch.checkpoint import tree_from_numpy
from tpu_unet_torch.data import make_synthetic_carvana, synth_batch
from tpu_unet_torch.evaluate import evaluate, evaluate_per_class
from tpu_unet_torch.losses import dice_coeff, dice_loss
from tpu_unet_torch.models.unet import Refused, UNetConfig, init_unet
from tpu_unet_torch.ops.batchnorm import BNState
from tpu_unet_torch.optim import rmsprop_init
from tpu_unet_torch.parallel.halo import row_layout
from tpu_unet_torch.parallel.mesh import DataParallel, make_grid
from tpu_unet_torch.train import _build_mesh, check_grid, make_train_step

WORLD, LR = 4, 1e-3
JCFG = JConfig(3, 2, bilinear=True, base_channels=8)
OPS = {2: (48, 24, 4, 1), 4: (40, 24, 2, 2)}  # S: (H, W, N, seed)
FAMILIES = {
    "unet": dict(bilinear=False), "attention": dict(arch="attention"),
    "unetpp": dict(arch="unetpp", deep_supervision=True), "r2u": dict(arch="r2u"),
    "r2attu": dict(arch="r2attu"),
}
# Float64: the split changes only the order of the sums. The upsample
# computes in fp32 whatever its input (ops/resize.py): fp32's 1e-6 there.
OP_TOL = {"upsample2x_align_corners": 1e-6}
EVAL_CFG = dict(n_channels=3, n_classes=2, bilinear=True, base_channels=8)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@functools.lru_cache(maxsize=None)
def _jax_world():
    params, state = jax.jit(j_init, static_argnums=1)(jax.random.PRNGKey(0), JCFG)
    imgs, masks = j_synth_batch(np.random.default_rng(0), 4, 64, 64)
    return _numpy(params), _numpy(state), imgs, masks


@functools.lru_cache(maxsize=None)
def _port_trees(name):
    """(params, state) as numpy trees: JAX's weights for the 2 x 2 check
    ("jax"), the port's init for a family (base 8, 2 classes, bilinear)."""
    if name == "jax":
        params, state = _jax_world()[:2]
        return port_numpy(params), port_numpy(state)
    fields = _fields(name)
    p, s = init_unet(UNetConfig(**fields), np.random.default_rng(0))
    to_np = functools.partial(_map, lambda t: t.numpy().copy())
    return to_np(p), to_np(s)


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return type(tree)(*(_map(fn, v) for v in tree))
    return fn(tree)


def _fields(name):
    base = dict(n_channels=3, n_classes=2, bilinear=True, base_channels=8)
    if name in ("jax", "zero", "remat"):
        return base
    return base | FAMILIES[name]


def _cases():
    cases = [("jax", {}), *((n, {}) for n in FAMILIES), ("remat", {"remat": True}),
             ("zero", {"zero": True})]
    return [(n, _fields(n), kw) for n, kw in cases]


def _eval_batches():
    rng = np.random.default_rng(3)
    out = []
    for bs in (4, 4, 3):
        imgs, masks = synth_batch(rng, bs, 32, 32)
        out.append({"image": imgs, "mask": masks})
    return out


@pytest.fixture(scope="module")
def grid_runs(tmp_path_factory):
    """Every rank's results, in one group of 4 for the module."""
    root = tmp_path_factory.mktemp("spatial")
    make_synthetic_carvana(root / "d", n=20, h=32, w=32)
    imgs, masks = _jax_world()[2:]
    names = [c[0] for c in _cases()]
    trees = {n: _port_trees("jax" if n in ("zero", "remat") else n) for n in names}
    ep, es = _port_trees("jax")
    jobs = [("spatial_ops_worker", (s, *OPS[s])) for s in sorted(OPS)]
    jobs.append(("spatial_step_worker", (2, _cases(), {n: t[0] for n, t in trees.items()},
                                         {n: t[1] for n, t in trees.items()}, imgs, masks, LR)))
    jobs.append(("spatial_data_worker", (2, str(root / "d"), ep, es, _eval_batches(),
                                         EVAL_CFG)))
    ranks = run_ranks(jobs_worker, WORLD, root, jobs, timeout=300)
    return {"ops": {s: [r[i] for r in ranks] for i, s in enumerate(sorted(OPS))},
            "step": [r[len(OPS)] for r in ranks], "data": [r[len(OPS) + 1] for r in ranks]}


def test_row_layout_splits_deep_levels_unevenly():
    assert row_layout(48, 2) == [(48, ((0, 24), (24, 48))), (24, ((0, 12), (12, 24))),
                                 (12, ((0, 6), (6, 12))), (6, ((0, 3), (3, 6))),
                                 (3, ((0, 2), (2, 3)))]
    h4, b4 = row_layout(40, 4)[4]
    assert h4 == 2 and b4 == ((0, 1), (1, 2), (2, 2), (2, 2))  # two ranks hold no row
    with pytest.raises(ValueError, match="does not divide over 4"):
        row_layout(42, 4)


# -- the ops -------------------------------------------------------------------


def _ref_ops(spatial):
    """The unsharded ops on the whole inputs, by the worker's names: (y,
    input grads, parameter grads) of Σ(y·wy)."""
    height, width, n, seed = OPS[spatial]
    data = spatial_inputs(height, spatial, width, n, seed, np.float64)
    out = {}

    def run(name, fn, ins, params, wy):
        ins = [torch.from_numpy(a).requires_grad_(True) for a in ins]
        ps = [torch.from_numpy(p).requires_grad_(True) for p in params]
        y = fn(*ins, *ps)
        g = torch.autograd.grad((y * torch.from_numpy(wy)).sum(), ins + ps, materialize_grads=True)
        out[name] = (y.detach().numpy(), [t.numpy() for t in g[:len(ins)]],
                     [t.numpy() for t in g[len(ins):]])

    for k, d in enumerate(data):
        state = BNState(*map(torch.from_numpy, d["bn_state"]))
        run(f"conv2d/{k}", lambda x, w: ops.conv2d(x, w, padding=1), [d["x"]], [d["w3"]],
            d["wy"])
        run(f"batch_norm/{k}", lambda x, g, b, st=state: ops.batch_norm(
            x, {"scale": g, "bias": b}, st, train=True)[0], [d["x"]], [d["gamma"], d["beta"]],
            d["wy4"])
        out[f"bn_state/{k}"] = [t.numpy() for t in ops.batch_norm(
            torch.from_numpy(d["x"]), {"scale": torch.from_numpy(d["gamma"]),
                                       "bias": torch.from_numpy(d["beta"])}, state,
            train=True)[1]]
        if k + 1 < len(data):
            e = data[k + 1]
            run(f"max_pool2d/{k}", ops.max_pool2d, [d["x"]], [], e["wy4"])
            run(f"upsample2x_align_corners/{k + 1}", ops.upsample2x_align_corners, [e["x"]],
                [], d["wy_up"])
            run(f"conv_transpose2d/{k + 1}", lambda x, w: ops.conv_transpose2d(x, w, stride=2),
                [e["x"]], [d["wt"]], d["wy_up"])
            run(f"pad_to_match/{k}", ops.pad_to_match, [d["x1"], d["x"]], [], d["wy4"])
    d = data[0]
    one = np.ones((1, 1, 1))
    run("dice_loss", lambda p, t: dice_loss(torch.sigmoid(p), t).expand(1, 1, 1),
        [d["x"][..., 0], d["mask"]], [], one)
    run("dice_coeff", lambda p, t: dice_coeff(torch.sigmoid(p), t).expand(1, 1, 1),
        [d["x"][..., 0], d["mask"]], [], one)
    return out, data


def _band_of(spatial, rank, level, a):
    """Rank ``rank``'s rows and band of the full level array ``a`` (level
    an int, ("up", k) for the upsampled level k + 1, or None: whole)."""
    if level is None:
        return a
    height = OPS[spatial][0]
    layout = row_layout(height, spatial)
    if isinstance(level, tuple):
        h, bounds = layout[level[1] + 1]
        lo, hi = (2 * b for b in bounds[rank % spatial])
    else:
        lo, hi = layout[level][1][rank % spatial]
    d, n_data = rank // spatial, WORLD // spatial
    per = a.shape[0] // n_data
    return a[d * per:(d + 1) * per, lo:hi]


def _close(got, ref, what, tol=1e-12):
    scale = max(float(np.abs(ref).max(initial=0.0)), 1e-30)
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol * scale, err_msg=what)


# (op, the level of each input, the output's level) for the level-k ops.
_LEVELS = {
    "conv2d": lambda k: ([k], k), "batch_norm": lambda k: ([k], k),
    "max_pool2d": lambda k: ([k], k + 1),
    "upsample2x_align_corners": lambda k: ([k], ("up", k - 1)),
    "conv_transpose2d": lambda k: ([k], ("up", k - 1)),
    "pad_to_match": lambda k: ([("up", k), k], k),
}


@pytest.mark.parametrize("op", ["conv2d", "max_pool2d", "upsample2x_align_corners",
                                "pad_to_match", "conv_transpose2d", "batch_norm", "dice"])
@pytest.mark.parametrize("spatial", sorted(OPS))
def test_op_on_bands_matches_unsharded(grid_runs, op, spatial):
    ref, _ = _ref_ops(spatial)
    names = [n for n in ref if n.split("/")[0] == op or (op == "dice" and
                                                        n.startswith("dice"))]
    assert names
    close = functools.partial(_close, tol=OP_TOL.get(op, 1e-12))
    for rank, res in enumerate(grid_runs["ops"][spatial]):
        for name in names:
            y, gin, gp = ref[name]
            got = res[name]
            if name.startswith("dice"):
                ins, out = [0, 0], None
            else:
                ins, out = _LEVELS[op](int(name.split("/")[1]))
            close(got["y"], _band_of(spatial, rank, out, y), f"{name} y, rank {rank}")
            # The Dice is a replicated loss: a band's gradient is W times its share.
            times = WORLD if name.startswith("dice") else 1
            for i, (g, lv) in enumerate(zip(gin, ins)):
                close(got["gin"][i], times * _band_of(spatial, rank, lv, g),
                      f"{name} input {i} grad, rank {rank}")
            for i, g in enumerate(gp):
                close(got["gp"][i], g, f"{name} param {i} grad, rank {rank}")
        if op == "batch_norm":
            for k in range(5):
                for a, b in zip(res[f"bn_state/{k}"], ref[f"bn_state/{k}"]):
                    np.testing.assert_allclose(a, b, atol=1e-6, rtol=1e-6)


# -- the train step --------------------------------------------------------------


def _jax_rule(params, ref):
    """``test_2d_dp_spatial_step_matches_single_device``'s params rule."""
    got, want = _flat(params), _flat(ref)
    assert sorted(got) == sorted(want)
    for k in want:
        diff = np.abs(got[k] - want[k])
        assert np.median(diff) < 1e-5, k
        n_off = int((diff > 1e-3).sum())
        assert n_off <= max(3, 0.01 * diff.size), f"{k}: {n_off}/{diff.size} elements off"
        assert diff.max() < 0.1, k


def _check_step(r, loss, gnorm, bn, params, gnorm64=None):
    """JAX's tolerances; with ``gnorm64`` (the one-process step's grad norm
    in float64), a grad norm past 1e-3 passes when it lies at most twice as
    far from float64 as the one-process fp32 step's (PR 17's rule)."""
    np.testing.assert_allclose(r["loss"], float(loss), rtol=1e-5)
    gnorm = float(gnorm)
    if abs(r["gnorm"] - gnorm) > 1e-3 * gnorm:
        assert gnorm64 is not None, (r["gnorm"], gnorm)
        assert abs(r["gnorm"] - gnorm64) <= 2 * abs(gnorm - gnorm64) + 1e-6 * gnorm64, (
            r["gnorm"], gnorm, gnorm64)
    got, want = _flat(r["bn"]), _flat(bn)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-3, err_msg=k)
    _jax_rule(r["params"], params)


@functools.lru_cache(maxsize=None)
def _jax_steps():
    """JAX's single-device step and its 2 x 4 (data x spatial) mesh step."""
    params, state, imgs, masks = _jax_world()
    step = j_make_step(JCFG)
    trees = (params, state, _numpy(j_rms_init(params)))
    lr = jnp.float32(LR)
    single = step(*(jax.tree.map(jnp.array, t) for t in trees), jnp.asarray(imgs),
                  jnp.asarray(masks), lr)
    mesh = make_mesh_2d(spatial=4)
    assert mesh.shape == {"data": 2, "spatial": 4}
    xsh, rep = image_sharding(mesh), replicated(mesh)
    two_d = step(*(jax.device_put(jax.tree.map(jnp.array, t), rep) for t in trees),
                 jax.device_put(jnp.asarray(imgs), xsh), jax.device_put(jnp.asarray(masks), xsh),
                 lr)
    return tuple(_numpy(o) for o in single), tuple(_numpy(o) for o in two_d)


@functools.lru_cache(maxsize=None)
def _port_single(name, float64=False):
    """The port's one-process step (params, BN state, loss, grad norm); in
    float64 with ``.float()`` keeping float64 tensors as they are (the
    logits and the loss cast to fp32 by name)."""
    p, s = (tree_from_numpy(t) for t in _port_trees("jax" if name in ("zero", "remat")
                                                    else name))
    imgs, masks = _jax_world()[2:]
    x = torch.from_numpy(imgs)
    kw = {"remat": True} if name == "remat" else {}
    with pytest.MonkeyPatch.context() as mp:
        if float64:
            fp32 = torch.Tensor.float
            mp.setattr(torch.Tensor, "float",
                       lambda t: t if t.dtype == torch.float64 else fp32(t))
            p, s, x = _map(torch.Tensor.double, p), _map(torch.Tensor.double, s), x.double()
        o = make_train_step(UNetConfig(**_fields(name)), **kw)(
            p, s, rmsprop_init(p), x, torch.from_numpy(masks), LR)
    return o[0], o[1], float(o[3]), float(o[4])


def _step(grid_runs, name):
    i = [c[0] for c in _cases()].index(name)
    return [r[i] for r in grid_runs["step"]]


def test_grid_step_matches_jax_2d_mesh_and_single_device(grid_runs):
    ranks = _step(grid_runs, "jax")
    r = ranks[0]
    single, two_d = _jax_steps()
    for p, s, _, loss, gnorm in (single, two_d):
        _check_step(r, loss, gnorm, s, p)
    for other in ranks[1:]:
        assert other["loss"] == r["loss"] and other["loss2"] == r["loss2"]
        assert np.array_equal(other["params2"], r["params2"])  # bitwise, after two steps


@pytest.mark.parametrize("name", [*FAMILIES, "remat"])
def test_family_grid_step_matches_one_process(grid_runs, name):
    ranks = _step(grid_runs, name)
    params, bn, loss, gnorm = _port_single(name)
    _check_step(ranks[0], loss, gnorm, bn, params, _port_single(name, float64=True)[3])
    for other in ranks[1:]:
        assert np.array_equal(other["params2"], ranks[0]["params2"])


def test_zero_on_grid_is_bitwise_and_sliced_over_data(grid_runs):
    for plain, zero in zip(_step(grid_runs, "jax"), _step(grid_runs, "zero")):
        assert zero["loss"] == plain["loss"] and zero["gnorm"] == plain["gnorm"]
        for key in ("params", "bn", "opt"):
            a, b = _flat(zero[key]), _flat(plain[key])
            assert all(np.array_equal(a[k], b[k]) for k in b), key
        assert np.array_equal(zero["params2"], plain["params2"])
        # 2 data ranks: about half the state a rank (the [2] head bias whole).
        assert plain["bytes"] == plain["full_bytes"]
        assert zero["bytes"] < 0.51 * plain["bytes"]
    # The two ranks of a data coordinate hold the same slice.
    ranks = _step(grid_runs, "zero")
    assert ranks[0]["bytes"] == ranks[1]["bytes"] == ranks[2]["bytes"]


# -- the feeds and evaluate ------------------------------------------------------


def test_staged_corpus_serves_rows_and_bands_bitwise(grid_runs):
    ranks = grid_runs["data"]
    for r in ranks:
        assert r["batches_equal"] == [True, True]
    # Rows staged per data coordinate: the spatial ranks of one hold the same.
    assert ranks[0]["rows"] == ranks[1]["rows"] != ranks[2]["rows"] == ranks[3]["rows"]
    assert ranks[0]["staged"] == ranks[2]["staged"]


def test_grid_evaluate_matches_one_process(grid_runs):
    params, state = (tree_from_numpy(t) for t in _port_trees("jax"))
    cfg = UNetConfig(**EVAL_CFG)
    batches = _eval_batches()
    want = evaluate(params, state, batches, cfg)
    want_c = evaluate_per_class(params, state, batches, cfg)
    want_tta = evaluate(params, state, batches, cfg, tta=True)
    for r in grid_runs["data"]:
        np.testing.assert_allclose(r["scalar"], want, atol=1e-6)
        np.testing.assert_allclose(r["tta"], want_tta, atol=1e-6)
        for a, b in zip(r["per_class"], want_c):
            np.testing.assert_allclose(a, b, atol=1e-6)
        assert r["scalar"] == grid_runs["data"][0]["scalar"]


# -- refusals ----------------------------------------------------------------------


def test_grid_refusals_are_jax_words():
    with pytest.raises(ValueError, match=r"--kernels cuda data parallelism is 1-D \(shard_map\); "
                                         "--spatial-parallel requires the XLA backend"):
        check_grid(4, 2, "cuda")
    with pytest.raises(ValueError, match="6 devices not divisible by spatial=4"):
        check_grid(6, 4, None)
    record = DataParallel(group=None, host_group=None, rank=0, world_size=4,
                          device=torch.device("cpu"))
    with pytest.raises(ValueError, match="4 devices not divisible by spatial=3"):
        make_grid(record, 3)
    with pytest.raises(ValueError, match="4 devices not divisible by spatial=3"):
        _build_mesh({}, {}, data_parallel=record, spatial_parallel=3)
    # One rank, or S = 1: no grid and no refusal (JAX builds no mesh there).
    assert not check_grid(1, 2, "cuda") and not check_grid(4, 1, "cuda")
    # A spatial band refuses the kernel route at the block too.
    from tpu_unet_torch.models.unet import _double_conv_apply
    from tpu_unet_torch.parallel.halo import Band

    band = Band(None, 8, ((0, 4), (4, 8)))
    with pytest.raises(Refused, match="--spatial-parallel requires the XLA backend"):
        _double_conv_apply({}, {}, torch.zeros(1, 4, 4, 3), train=True, kernels="cuda",
                           group=band)


@pytest.mark.parametrize("argv,env,match", [
    (["--spatial-parallel", "2", "--kernels", "cuda"], "4",
     r"--kernels cuda data parallelism is 1-D \(shard_map\); --spatial-parallel requires"),
    (["--spatial-parallel", "4"], "6", "6 devices not divisible by spatial=4"),
])
def test_train_cli_refuses_a_grid_before_the_rendezvous(monkeypatch, argv, env, match):
    from tpu_unet_torch import train_cli

    monkeypatch.setenv("WORLD_SIZE", env)
    with pytest.raises(SystemExit, match=match):
        train_cli.main(["--device", "cpu", "--data-parallel", *argv])
    assert not torch.distributed.is_initialized()
