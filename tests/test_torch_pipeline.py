"""The port's pipeline parallelism (``tpu_unet_torch/parallel/pipeline.py``,
GPipe over stage devices, here the CPU S times) against the JAX package's
``make_train_step(accum_steps=M)``, by ``tests/test_pipeline.py``'s
tolerances: one pipeline step with M microbatches is the accumulated step.

- ``split_stages`` equals JAX's for every n in 2..10, with the same
  segments and JAX's weights.
- 2 stages (bilinear) and 4 (ConvTranspose) at M = 4, one step: loss 1e-5
  relative, grad norm 1e-4, the clipped gradients 1e-6 + 1e-3 relative, BN
  state 1e-5 + 1e-3, params 1e-4; multiclass amp over 3 steps at 3 stages,
  M = 2 (loss 2e-2, gradients and params 5e-2, BN 5e-3 + 5e-2); a batch M
  does not divide runs as one microbatch (loss 1e-4, gradients 1e-5,
  params 3e-4). Weights from a numpy seed, base 8, 8x32x32, lr 1e-3. Where
  two implementations' steps part (the params after RMSprop's first
  update, and what follows from them), the runner is also held against the
  port's own ``make_train_step(accum_steps=M)`` by JAX's tolerances.
- ``gather`` is the runner's trees, bitwise, in the U-Net's key order.
- The guards and ``train_model``'s refusals, in JAX's words.
- ``train_model(pipeline_parallel=4)`` against ``accum_steps=4`` (losses
  1e-3 relative, val Dice 1e-3), and ``train_cli --pipeline-parallel 2``
  training, checkpointing, validating and resuming as the ``--accum-steps
  2`` run does.
"""

import functools
import logging

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.test_torch_train import _flat, _numpy
from tests.torch_dp_workers import _numpy_tree
from tpu_unet.data.synthetic import synth_batch as j_synth_batch
from tpu_unet.models import UNetConfig as JConfig, init_unet as j_init
from tpu_unet.optim import rmsprop_init as j_rms_init
from tpu_unet.parallel import pipeline as j_pipeline
from tpu_unet.train import make_train_step as j_make_step
import tpu_unet_torch.models.unet as t_unet
from tpu_unet_torch import train_cli
from tpu_unet_torch.checkpoint import flatten, from_jax_arrays, save_checkpoint
from tpu_unet_torch.data import CarvanaDataset, make_synthetic_carvana
from tpu_unet_torch.models.unet import UNetConfig, init_unet, tree_leaves
from tpu_unet_torch.optim import rmsprop_init
from tpu_unet_torch.parallel import pipeline
from tpu_unet_torch.parallel.mesh import DataParallel
from tpu_unet_torch.parallel.pipeline import PipelineRunner, split_stages
from tpu_unet_torch.train import _check_train_flags, make_train_step, train_model

LR = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_split_stages_equal_jax():
    assert pipeline.SEGMENT_NAMES == j_pipeline.SEGMENT_NAMES
    assert pipeline._SEGMENT_WEIGHT == j_pipeline._SEGMENT_WEIGHT
    for n in range(2, 11):
        assert split_stages(n) == j_pipeline.split_stages(n)
        assert [s for st in split_stages(n) for s in st] == pipeline.SEGMENT_NAMES
    for n in (1, 11):
        with pytest.raises(ValueError, match=rf"n_stages must be in \[2, 10\], got {n}"):
            split_stages(n)


# -- the step -------------------------------------------------------------------------


def _fill(tree, prefix, flat):
    """JAX's tree of shapes ``tree`` with its leaves from ``flat``."""
    if isinstance(tree, dict):
        return {k: _fill(v, f"{prefix}/{k}", flat) for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        return type(tree)(*(_fill(v, f"{prefix}/{f}", flat) for f, v in zip(tree._fields, tree)))
    return flat[prefix]


@functools.lru_cache(maxsize=None)
def _world(n_classes, bilinear):
    """Numpy-seeded weights as JAX's trees (numpy) and the port's (through
    ``from_jax_arrays``)."""
    fields = dict(n_channels=3, n_classes=n_classes, bilinear=bilinear, base_channels=8)
    flat = flatten(*init_unet(UNetConfig(**fields), np.random.default_rng(0)))
    jcfg = JConfig(**fields)
    jp, js = jax.eval_shape(lambda k: j_init(k, jcfg), jax.random.PRNGKey(0))
    return jcfg, UNetConfig(**fields), _fill(jp, "params", flat), _fill(js, "state", flat), flat


@functools.lru_cache(maxsize=None)
def _jax_step(n_classes, bilinear, m, amp):
    return j_make_step(_world(n_classes, bilinear)[0], amp=amp, accum_steps=m,
                       return_grads=True)


def _run_pair(n_classes, bilinear, n_stages, m, *, amp=False, batches):
    """The batches through the port's runner and JAX's accumulated step from
    the same weights: ((grads, params, state, loss, gnorm) of each, the
    runner, the port's accumulated step's params)."""
    _, cfg, jp, js, flat = _world(n_classes, bilinear)
    params, state = from_jax_arrays(flat)
    runner = PipelineRunner(params, state, cfg, n_stages=n_stages, microbatches=m, amp=amp,
                            devices=["cpu"] * n_stages)
    runner.keep_grads = True
    acc = make_train_step(cfg, amp=amp, accum_steps=m, return_grads=True)
    trees = (params, state, rmsprop_init(params))
    for imgs, masks in batches:
        x, y = torch.from_numpy(imgs), torch.from_numpy(masks)
        loss, gnorm = runner.step(x, y, LR)
        o = acc(*trees, x, y, LR)
        trees = o[:3]
    p, s, _ = runner.gather()
    port = (runner.gather_grads(), p, s, float(loss), float(gnorm))
    accumulated = (_numpy_tree(o[5]), _numpy_tree(o[0]), _numpy_tree(o[1]), float(o[3]),
                   float(o[4]))
    step = _jax_step(n_classes, bilinear, m, amp)
    trees = tuple(jax.tree.map(jnp.asarray, t) for t in (jp, js, j_rms_init(jp)))
    for imgs, masks in batches:
        out = step(*trees, jnp.asarray(imgs), jnp.asarray(masks), jnp.float32(LR))
        trees = out[:3]
    ref = (_numpy(out[5]), _numpy(out[0]), _numpy(out[1]), float(out[3]), float(out[4]))
    return port, ref, accumulated, runner


def _close(got, want, **kw):
    g, w = _flat(got), _flat(want)
    assert sorted(g) == sorted(w)
    for k in w:
        np.testing.assert_allclose(g[k], w[k], err_msg=k, **kw)


def _flip(steps, momentum=0.999):
    """The most one flipped gradient sign moves a param over ``steps``
    RMSprop steps: each step's g/sqrt(sq) is at most 10 (sq starts at 0),
    summed into the momentum buffer, 2·lr·Σ_i Σ_{j<i} 10·μ^j."""
    return 2 * LR * sum(10 * (1 - momentum ** i) / (1 - momentum) for i in range(1, steps + 1))


def _params(got, want, atol, steps=1):
    """The params after RMSprop (``tests/test_pipeline.py``'s rule): its
    first update is about 10·lr·sign(g), a discontinuity at 0, so a
    near-zero gradient element that another sum order moves across it
    moves its param by up to ``_flip``: no element past that (or
    ``atol``), at most 0.05% of a leaf's (or 3) past ``atol``."""
    g, w = _flat(got), _flat(want)
    assert sorted(g) == sorted(w)
    for k in w:
        diff = np.abs(g[k].astype(np.float64) - w[k])
        assert diff.max() <= max(atol, _flip(steps)), (k, diff.max())
        assert (diff > atol).sum() <= max(3, 5e-4 * diff.size), (k, (diff > atol).sum())


@pytest.mark.parametrize("n_stages,bilinear", [(2, True), (4, False)])
def test_pipeline_step_matches_jax_accum(n_stages, bilinear):
    batch = j_synth_batch(np.random.default_rng(0), 8, 32, 32)
    (pg, pp, ps, pl, pn), (ag, ap, as_, al, an), acc, _ = _run_pair(1, bilinear, n_stages, 4,
                                                                    batches=[batch])
    np.testing.assert_allclose(pl, al, rtol=1e-5)
    np.testing.assert_allclose(pn, an, rtol=1e-4)
    _close(pg, ag, atol=1e-6, rtol=1e-3)
    _close(ps, as_, atol=1e-5, rtol=1e-3)
    for ref in (ap, acc[1]):
        _params(pp, ref, 1e-4)


def test_pipeline_multiclass_amp_over_three_steps():
    """The loss against JAX's accumulated steps; the gradients, BN state and
    params against the port's (bf16 quantizes the two implementations'
    convs differently, and three steps compound it)."""
    rng = np.random.default_rng(0)
    batches = [j_synth_batch(rng, 8, 32, 32) for _ in range(3)]
    (pg, pp, ps, pl, _), (_, _, _, al, _), acc, _ = _run_pair(2, True, 3, 2, amp=True,
                                                              batches=batches)
    np.testing.assert_allclose(pl, al, rtol=2e-2)
    np.testing.assert_allclose(pl, acc[3], rtol=2e-2)
    _close(pg, acc[0], atol=5e-2)
    _close(ps, acc[2], atol=5e-3, rtol=5e-2)
    _close(pp, acc[1], atol=5e-2)


def test_pipeline_partial_batch_runs_one_microbatch():
    rng = np.random.default_rng(1)
    batches = [j_synth_batch(rng, 8, 32, 32), j_synth_batch(rng, 5, 32, 32)]
    (pg, pp, _, pl, _), (_, ap, _, al, _), acc, runner = _run_pair(1, True, 2, 4,
                                                                    batches=batches)
    # The second step starts from the first's sign flips: its loss and
    # gradients against the port's accumulated step by JAX's tolerances, its
    # loss against JAX's by its tp test's trajectory tolerance
    # (tests/test_tensor_parallel.py).
    np.testing.assert_allclose(pl, acc[3], rtol=1e-4)
    np.testing.assert_allclose(pl, al, rtol=5e-4)
    _close(pg, acc[0], atol=1e-5)
    _params(pp, acc[1], 3e-4, steps=2)
    _params(pp, ap, _flip(2))  # two implementations: the flips' ceiling alone
    # gather() is the runner's own trees, bitwise, in the U-Net's key order.
    p, s, o = runner.gather()
    assert list(p) == list(init_unet(UNetConfig(3, 1, True, 8), np.random.default_rng(0))[0])
    held = [t for tree in runner.params for t in tree_leaves(tree)]
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(p), held))
    held = [t for tree in runner.state for t in tree_leaves(tree)]
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(s), held))
    held = [t for st in runner.opt for t in tree_leaves(st.square_avg)]
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(o.square_avg), held))


# -- the guards --------------------------------------------------------------------------


def test_runner_guards():
    cfg = UNetConfig(3, 1, True, 8)
    params, state = init_unet(cfg, np.random.default_rng(0))
    cpu = ["cpu"] * 4
    with pytest.raises(ValueError, match="pipeline parallelism is wired for the flagship "
                                         "U-Net's block chain only, not arch='unetpp'"):
        PipelineRunner(params, state, cfg._replace(arch="unetpp"), n_stages=2, microbatches=2,
                       devices=cpu)
    with pytest.raises(ValueError, match="does not support the s2d_level0 experiment path"):
        PipelineRunner(params, state, cfg._replace(s2d_level0=True), n_stages=2,
                       microbatches=2, devices=cpu)
    with pytest.raises(ValueError, match="microbatches must be >= 1, got 0"):
        PipelineRunner(params, state, cfg, n_stages=2, microbatches=0, devices=cpu)
    with pytest.raises(ValueError, match="pipeline needs 4 devices, have 2"):
        PipelineRunner(params, state, cfg, n_stages=4, microbatches=2, devices=cpu[:2])
    # The default devices are this host's cards: none on this CPU.
    with pytest.raises(ValueError, match="pipeline needs 2 devices, have 0"):
        PipelineRunner(params, state, cfg, n_stages=2, microbatches=2)
    with pytest.raises(ValueError, match="unexpected param keys for pipeline"):
        PipelineRunner({**params, "extra": params["outc"]}, state, cfg, n_stages=2,
                       microbatches=2, devices=cpu)


@pytest.mark.parametrize("kw,match", [
    ({"optimizer": "adam"}, "--pipeline-parallel supports the reference RMSprop only"),
    ({"data_parallel": True}, "--pipeline-parallel does not compose with --data-parallel/"),
    ({"spatial_parallel": 2}, "--pipeline-parallel does not compose with"),
    ({"tensor_parallel": 2, "data_parallel": True}, "--pipeline-parallel does not compose with"),
    ({"kernels": "cuda"}, r"--pipeline-parallel requires the XLA backend \(--kernels torch\)"),
    ({"ema_decay": 0.99}, "--ema-decay is not supported with --pipeline-parallel"),
    ({"multihost": True}, r"--pipeline-parallel is single-host \(stage-placed devices\)"),
])
def test_train_refusals_are_jax_words(kw, match):
    flags = dict(accum_steps=1, batch_size=4, early_stopping=None, kernels=None)
    with pytest.raises(ValueError, match=match):
        _check_train_flags(**{**flags, **kw}, pipeline_parallel=2)
    if "multihost" not in kw and "data_parallel" not in kw:
        with pytest.raises(ValueError, match=match):
            train_model({}, {}, UNetConfig(), dataset=[], pipeline_parallel=2, **kw)
    cli = {"optimizer": ["--optimizer", "adam"], "data_parallel": ["--data-parallel"],
           "spatial_parallel": ["--spatial-parallel", "2"], "kernels": ["--kernels", "cuda"],
           "ema_decay": ["--ema-decay", "0.99"]}
    if set(kw) <= set(cli):  # the CLI refuses them before the rendezvous and the data
        argv = ["--device", "cpu", "--pipeline-parallel", "2"] + [a for k in kw for a in cli[k]]
        with pytest.raises(SystemExit, match=match):
            train_cli.main(argv)
    assert not torch.distributed.is_initialized()


def test_train_cli_refuses_fewer_cards_than_stages():
    # --device cuda (the default) puts stage s on cuda:s: this CPU has none.
    with pytest.raises(SystemExit, match="pipeline needs 2 devices, have 0"):
        train_cli.main(["--pipeline-parallel", "2"])


def test_remat_is_logged_redundant(caplog):
    flags = dict(accum_steps=1, batch_size=4, early_stopping=None, kernels=None)
    with caplog.at_level(logging.INFO, logger="tpu_unet_torch.train"):
        _check_train_flags(**flags, pipeline_parallel=2, remat=True)
    assert "remat flag is redundant and ignored" in caplog.text


# -- the trainer and the CLI ----------------------------------------------------------------


def test_train_model_pipeline_matches_accum(tmp_path):
    make_synthetic_carvana(tmp_path / "d", n=16, h=64, w=64)
    ds = CarvanaDataset(tmp_path / "d" / "imgs", tmp_path / "d" / "masks", scale=1.0)
    cfg = UNetConfig(3, 1, True, 8)
    params, state = init_unet(cfg, np.random.default_rng(0))
    common = dict(dataset=ds, epochs=2, batch_size=8, learning_rate=LR, val_percent=0.25,
                  seed=0, accum_steps=4, val_per_epoch=1)
    _, _, h_acc = train_model(params, state, cfg, save_checkpoint_flag=False, **common)
    fp, fs, h_pp = train_model(params, state, cfg, pipeline_parallel=4,
                               checkpoint_dir=tmp_path / "ck", **common)
    # 12 train images, batch 8, no drop_last: 2 batches an epoch, the second partial.
    assert len(h_pp["train_loss"]) == len(h_acc["train_loss"]) == 4
    np.testing.assert_allclose(h_pp["train_loss"], h_acc["train_loss"], rtol=1e-3, atol=1e-4)
    assert len(h_pp["val_dice"]) == len(h_acc["val_dice"]) == 4  # after every step
    np.testing.assert_allclose(h_pp["val_dice"], h_acc["val_dice"], atol=1e-3)
    assert list(fp) == list(params) and (tmp_path / "ck" / "checkpoint_epoch2.npz").exists()


def test_train_cli_pipeline_trains_checkpoints_and_resumes(tmp_path, monkeypatch):
    monkeypatch.setattr(t_unet, "UNetConfig", lambda **kw: UNetConfig(**kw, base_channels=8))
    make_synthetic_carvana(tmp_path / "data", n=10, h=32, w=48, seed=0)
    save_checkpoint(tmp_path / "init.npz", *init_unet(UNetConfig(3, 1, False, 8),
                                                      np.random.default_rng(0)))
    argv = ["--device", "cpu", "-b", "2", "-l", "1e-4", "-s", "1.0", "-v", "20",
            "--val-per-epoch", "2", "--data-dir", str(tmp_path / "data"), "--load",
            str(tmp_path / "init.npz"), "--save-optimizer"]
    runs = {}
    for tag, flags in (("pp", ["--pipeline-parallel", "2"]), ("acc", ["--accum-steps", "2"])):
        ck = tmp_path / tag
        first = train_cli.main([*argv, *flags, "-e", "1", "--checkpoint-dir", str(ck)])[2]
        resumed = train_cli.main([*argv, *flags, "-e", "2", "--checkpoint-dir", str(ck),
                                  "--resume", str(ck / "checkpoint_epoch1.npz")])[2]
        runs[tag] = (first, resumed, sorted(f.name for f in ck.glob("*.npz")))
    for a, b in zip(runs["pp"][:2], runs["acc"][:2]):  # JAX's e2e tolerances
        assert len(a["train_loss"]) == 4 and len(a["val_dice"]) == 2
        np.testing.assert_allclose(a["train_loss"], b["train_loss"], rtol=1e-3, atol=1e-4)
        np.testing.assert_allclose(a["val_dice"], b["val_dice"], atol=1e-3)
    assert runs["pp"][2] == runs["acc"][2] == ["checkpoint_epoch1.npz", "checkpoint_epoch2.npz"]


def test_pipeline_refuses_a_world():
    record = DataParallel(group=None, host_group=None, rank=0, world_size=2,
                          device=torch.device("cpu"))
    with pytest.raises(ValueError, match="--pipeline-parallel does not compose with"):
        train_model({}, {}, UNetConfig(), dataset=[], pipeline_parallel=2, data_parallel=record)
