"""The port's train loop against the JAX package's, on the CPU in fp32:
``train_model`` from the same weights (JAX's init, converted) on the same
synthetic Carvana set (base 8, 48x64, 10 images, 2 epochs, batch 2,
validation twice an epoch), then resume, early stopping, EMA and the
``INTERRUPTED`` save, ``remat``, checkpoints with optimizer state across the
two packages, and the train CLI (history, the out-of-memory retry, the
refused flags).

Tolerances (measured gaps are 10-100x below them):
- per-step train loss 1e-3 relative: both sum in fp32 in other orders, and
  RMSprop's first steps divide a gradient by about 0.1·|g|, so a near-zero
  gradient whose last bits differ moves its weight by ±10·lr either way
  (``tests/test_torch_train.py``); over 8 steps at lr 1e-4 that drift
  reaches 2.4e-4 of the loss (the first step agrees to 1e-6);
- validation Dice 1e-4 absolute: a ratio of thresholded pixel counts (one
  pixel of the 2·48·64 would be 1.6e-4 of a score, and none flips here);
- learning rates exact; final params, which RMSprop moves by up to 0.03
  (300·lr) in 8 steps: the full-resolution blocks (inc, up4, outc) within
  1e-3 absolute (measured <= 8.3e-4), every tensor within 2e-2 (measured
  1.33e-2 on down4's convs, whose gradients are ill-conditioned at the
  random init; the loss history is the tight check of the trajectory); the
  BN running stats, which follow the params, to the same bounds but 5e-2 in
  the deep blocks (measured 2.7e-2 on down4's means, of order 0.5);
- the same checkpoint files with the same ``extra`` and palette.
"""

import json
import os
import signal

import numpy as np
import pytest
import torch

import jax

import tpu_unet.models as j_models
import tpu_unet.train as j_train
from tpu_unet.checkpoint import (
    load_checkpoint as j_load_checkpoint,
    read_checkpoint_meta as j_read_meta,
    save_checkpoint as j_save_checkpoint,
)
from tpu_unet.data import CarvanaDataset as JCarvana
from tpu_unet.models import UNetConfig as JConfig, init_unet as j_init_unet
from tpu_unet.optim import adam_init as j_adam_init, rmsprop_init as j_rms_init
from tpu_unet.train_cli import main as j_cli_main
import tpu_unet_torch.models.unet as t_unet
import tpu_unet_torch.train as t_train
from tpu_unet_torch import train_cli
from tpu_unet_torch.checkpoint import (
    AsyncCheckpointer,
    load_checkpoint,
    read_checkpoint_meta,
    save_checkpoint,
    tree_from_numpy,
)
from tpu_unet_torch.data import CarvanaDataset, make_synthetic_carvana, synth_batch
from tpu_unet_torch.models.unet import UNetConfig
from tpu_unet_torch.optim import adam_init, rmsprop_init
from tpu_unet_torch.train import make_train_step, train_model

BASE, LR = 8, 1e-4
RUN = dict(epochs=2, batch_size=2, learning_rate=LR, val_percent=0.2, val_per_epoch=2,
           save_optimizer=True, save_best=True)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items() for k2, v2 in _flat(v, f"{prefix}/{k}").items()}
    if isinstance(tree, tuple):
        return {k2: v2 for k, v in zip(tree._fields, tree)
                for k2, v2 in _flat(v, f"{prefix}/{k}").items()}
    if isinstance(tree, torch.Tensor):
        tree = tree.detach()
    return {prefix: np.asarray(tree, np.float64)}


def _assert_trees(got, ref, **tol):
    g, r = _flat(got), _flat(ref)
    assert sorted(g) == sorted(r)
    for k in r:
        np.testing.assert_allclose(g[k], r[k], err_msg=k, **tol)


def _assert_params(got, ref, deep=2e-2):
    g, r = _flat(got), _flat(jax.device_get(ref))
    assert sorted(g) == sorted(r)
    for k in r:
        shallow = k.split("/")[1] in ("inc", "up4", "outc")
        np.testing.assert_allclose(g[k], r[k], atol=1e-3 if shallow else deep, err_msg=k)


def _assert_history(got, ref, val_atol=1e-4):
    assert sorted(got) == sorted(ref)
    assert len(got["train_loss"]) == len(ref["train_loss"])
    np.testing.assert_allclose(got["train_loss"], ref["train_loss"], rtol=1e-3)
    np.testing.assert_allclose(got["val_dice"], ref["val_dice"], atol=val_atol)
    assert got["lr"] == ref["lr"]
    if "val_dice_ema" in ref:
        np.testing.assert_allclose(got["val_dice_ema"], ref["val_dice_ema"], atol=val_atol)


def _assert_same_files(tdir, jdir, arrays=True):
    names = sorted(p.name for p in jdir.iterdir())
    assert sorted(p.name for p in tdir.iterdir()) == names
    for name in names:
        (tm, te), (jm, je) = read_checkpoint_meta(tdir / name), j_read_meta(jdir / name)
        assert tm == jm
        assert te.keys() == je.keys()
        for k in je:
            if k in ("val_dice", "early_stop"):
                assert json.dumps(te[k]) and np.allclose(
                    np.asarray(te[k]["best"] if k == "early_stop" else te[k], float),
                    np.asarray(je[k]["best"] if k == "early_stop" else je[k], float), atol=1e-4)
            elif k == "scheduler":
                assert te[k].keys() == je[k].keys()
                np.testing.assert_allclose(te[k]["lr"], je[k]["lr"], rtol=1e-12)
            else:
                assert te[k] == je[k], (name, k)
        if arrays:
            with np.load(tdir / name) as t, np.load(jdir / name) as j:
                assert sorted(t.files) == sorted(j.files)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The dataset, both packages' views of it, and the initial weights."""
    root = tmp_path_factory.mktemp("loop")
    make_synthetic_carvana(root / "data", n=10, h=48, w=64, seed=0)
    jcfg = JConfig(3, 1, False, base_channels=BASE)
    params, state = jax.device_get(j_init_unet(jax.random.PRNGKey(0), jcfg))
    ds = CarvanaDataset(root / "data" / "imgs", root / "data" / "masks", 1.0)
    jds = JCarvana(root / "data" / "imgs", root / "data" / "masks", 1.0)
    return dict(root=root, jcfg=jcfg, cfg=UNetConfig(3, 1, False, BASE), params=params,
                state=state, ds=ds, jds=jds)


def _run_both(world, tag, **kw):
    """train_model in both packages; (port result, JAX result, port dir,
    JAX dir)."""
    tdir, jdir = world["root"] / f"{tag}_torch", world["root"] / f"{tag}_jax"
    kw = {**RUN, **kw}
    tout = train_model(tree_from_numpy(world["params"]), tree_from_numpy(world["state"]),
                       world["cfg"], dataset=world["ds"], checkpoint_dir=tdir, **kw)
    jout = j_train.train_model(world["params"], world["state"], world["jcfg"],
                               dataset=world["jds"], checkpoint_dir=jdir, **kw)
    return tout, jout, tdir, jdir


@pytest.fixture(scope="module")
def base_runs(world):
    return _run_both(world, "base")


def test_train_model_matches_jax(base_runs):
    (tp, ts, th), (jp, js, jh), tdir, jdir = base_runs
    assert len(th["train_loss"]) == 8 and len(th["val_dice"]) == 4
    _assert_history(th, jh)
    _assert_params(tp, jp)
    _assert_params(ts, js, deep=5e-2)
    assert {p.name for p in tdir.iterdir()} == {"checkpoint_epoch1.npz", "checkpoint_epoch2.npz",
                                                "checkpoint_best.npz"}
    _assert_same_files(tdir, jdir)
    assert read_checkpoint_meta(tdir / "checkpoint_epoch2.npz")[0] == [0, 255]


def test_resume_from_either_package(world, base_runs):
    """--resume from the JAX-written epoch-1 checkpoint in both packages: the
    second epoch alone, from the saved optimizer and schedule state. The
    port also resumes from its own file."""
    *_, tdir, jdir = base_runs
    kw = dict(RUN, save_best=False, resume=str(jdir / "checkpoint_epoch1.npz"))
    tout, jout, rt, rj = _run_both(world, "resume", **kw)
    assert len(tout[2]["train_loss"]) == 4  # epoch 2 only
    _assert_history(tout[2], jout[2])
    _assert_params(tout[0], jout[0])
    _assert_same_files(rt, rj)
    own = train_model(tree_from_numpy(world["params"]), tree_from_numpy(world["state"]),
                      world["cfg"], dataset=world["ds"], checkpoint_dir=world["root"] / "own",
                      **dict(kw, resume=str(tdir / "checkpoint_epoch1.npz")))
    _assert_history(own[2], jout[2])


def test_early_stopping_and_ema_match_jax(world):
    """early_stopping=1 at a learning rate too small to move the val Dice:
    the second validation stops the run inside epoch 1, whose checkpoint
    carries the early-stop state; EMA validates and saves beside it."""
    tout, jout, tdir, jdir = _run_both(world, "es", learning_rate=1e-9, early_stopping=1,
                                       ema_decay=0.5, save_best=False)
    assert len(tout[2]["val_dice"]) == 2 and len(tout[2]["train_loss"]) == 4
    _assert_history(tout[2], jout[2])
    _assert_same_files(tdir, jdir)
    assert {p.name for p in tdir.iterdir()} == {"checkpoint_epoch1.npz",
                                                "checkpoint_epoch1_ema.npz"}
    assert read_checkpoint_meta(tdir / "checkpoint_epoch1.npz")[1]["early_stop"]["bad"] == 1
    ema, _, _, _ = load_checkpoint(tdir / "checkpoint_epoch1_ema.npz", world["cfg"])
    jema = j_load_checkpoint(jdir / "checkpoint_epoch1_ema.npz", world["params"],
                             world["state"])[0]
    _assert_trees(ema, jax.device_get(jema), atol=1e-6)


def test_interrupt_saves_resumable_state_like_jax(world, monkeypatch):
    """SIGTERM during the first validation: the loop stops at the next batch
    boundary and writes INTERRUPTED.npz (epoch 0, optimizer included) in
    both packages; --resume from it runs epoch 1 again."""
    for mod in (t_train, j_train):
        real = mod.evaluate
        calls = {"n": 0}

        def eval_and_kill(*a, _real=real, _calls=calls, **k):
            _calls["n"] += 1
            if _calls["n"] == 1:
                os.kill(os.getpid(), signal.SIGTERM)
            return _real(*a, **k)

        monkeypatch.setattr(mod, "evaluate", eval_and_kill)
    before = signal.getsignal(signal.SIGTERM)
    tout, jout, tdir, jdir = _run_both(world, "intr", save_best=False)
    assert signal.getsignal(signal.SIGTERM) is before
    assert [p.name for p in tdir.iterdir()] == ["INTERRUPTED.npz"]
    _assert_history(tout[2], jout[2])
    _assert_same_files(tdir, jdir)
    meta = read_checkpoint_meta(tdir / "INTERRUPTED.npz")[1]
    assert meta["epoch"] == 0 and meta["interrupted"] and meta["step"] == 2
    monkeypatch.undo()
    res = train_model(tree_from_numpy(world["params"]), tree_from_numpy(world["state"]),
                      world["cfg"], dataset=world["ds"], checkpoint_dir=tdir,
                      **dict(RUN, epochs=1, resume=str(tdir / "INTERRUPTED.npz")))
    assert len(res[2]["train_loss"]) == 4 and (tdir / "checkpoint_epoch1.npz").exists()


@pytest.mark.parametrize("kernels", [None, "cuda"])
def test_remat_equals_no_remat(world, kernels):
    """remat recomputes the same operations: loss, gradients and BN state
    equal bit for bit (``"cuda"`` runs the kernels' plain versions here)."""
    x, m = synth_batch(np.random.default_rng(7), 2, 33, 20)
    trees = (tree_from_numpy(world["params"]), tree_from_numpy(world["state"]))
    outs = []
    for remat in (False, True):
        step = make_train_step(world["cfg"], remat=remat, kernels=kernels, return_grads=True)
        outs.append(step(*trees, rmsprop_init(trees[0]), torch.from_numpy(x),
                         torch.from_numpy(m), LR))
    a, b = outs
    assert torch.equal(a[3], b[3]) and torch.equal(a[4], b[4])
    for got, ref in ((b[5], a[5]), (b[1], a[1]), (b[0], a[0])):
        g, r = _flat(got), _flat(ref)
        assert all(np.array_equal(g[k], r[k]) for k in r)


@pytest.mark.parametrize("opt", ["rmsprop", "adam"])
def test_checkpoint_with_opt_state_crosses_packages(world, tmp_path, opt):
    """A JAX-written checkpoint with optimizer state loads in the port (the
    ``opt/...`` keypaths of the NamedTuple fields) and the reverse; the
    async writer writes the same file as the direct one."""
    rng = np.random.default_rng(3)
    j_init, t_init = (j_rms_init, rmsprop_init) if opt == "rmsprop" else (j_adam_init, adam_init)
    jopt = jax.tree.map(lambda a: np.asarray(a) + rng.random(np.shape(a)).astype(np.asarray(a).dtype)
                        if np.asarray(a).dtype == np.float32 else np.asarray(a) + 3,
                        jax.device_get(j_init(world["params"])))
    j_save_checkpoint(tmp_path / "j.npz", world["params"], world["state"], [0, 255],
                      {"optimizer": opt}, opt_state=jopt)
    tp = tree_from_numpy(world["params"])
    params, state, mv, extra = load_checkpoint(tmp_path / "j.npz", world["cfg"],
                                               opt_like=t_init(tp))
    assert mv == [0, 255] and extra["optimizer"] == opt
    _assert_trees(extra["opt_state"], jopt, atol=0, rtol=0)
    assert load_checkpoint(tmp_path / "j.npz", world["cfg"])[3].get("opt_state") is None
    writer = AsyncCheckpointer()
    writer.save(tmp_path / "t.npz", params, state, [0, 255], {"optimizer": opt},
                opt_state=extra["opt_state"])
    writer.wait()
    save_checkpoint(tmp_path / "t2.npz", params, state, [0, 255], {"optimizer": opt},
                    opt_state=extra["opt_state"])
    for name in ("t.npz", "t2.npz"):
        jp, js, jmv, jextra = j_load_checkpoint(tmp_path / name, world["params"], world["state"],
                                                opt_like=j_init(world["params"]))
        _assert_trees(jextra["opt_state"], jopt, atol=0, rtol=0)
        _assert_trees(jp, world["params"], atol=0, rtol=0)


def _cli_world(world, tmp_path, monkeypatch):
    """Base-8 configs in both CLIs (which build the reference's base 64) and
    one checkpoint for both to --load, so they start from equal weights."""
    monkeypatch.setattr(t_unet, "UNetConfig",
                        lambda **kw: UNetConfig(**kw, base_channels=BASE))
    monkeypatch.setattr(j_models, "UNetConfig", lambda **kw: JConfig(**kw, base_channels=BASE))
    ckpt = tmp_path / "init.npz"
    j_save_checkpoint(ckpt, world["params"], world["state"])
    return ["-e", "2", "-b", "2", "-l", str(LR), "-s", "1.0", "-v", "20", "--val-per-epoch", "2",
            "--data-dir", str(world["root"] / "data"), "--load", str(ckpt), "--save-optimizer"]


def test_train_cli_matches_jax(world, tmp_path, monkeypatch):
    argv = _cli_world(world, tmp_path, monkeypatch)
    train_cli.main(argv + ["--device", "cpu", "--kernels", "cuda",
                           "--checkpoint-dir", str(tmp_path / "t"),
                           "--history-out", str(tmp_path / "t.json")])
    j_cli_main(argv + ["--checkpoint-dir", str(tmp_path / "j"),
                       "--history-out", str(tmp_path / "j.json")])
    _assert_history(json.loads((tmp_path / "t.json").read_text()),
                    json.loads((tmp_path / "j.json").read_text()))
    _assert_same_files(tmp_path / "t", tmp_path / "j")


def test_train_cli_oom_retries_with_remat_from_the_initial_weights(world, tmp_path,
                                                                    monkeypatch):
    argv = _cli_world(world, tmp_path, monkeypatch)
    calls = []

    def fake_train_model(params, bn_state, config, **kw):
        calls.append((kw["remat"], params))
        if len(calls) == 1:
            params["inc"]["conv1"]["w"].add_(1.0)  # a first attempt that changed its trees
            raise torch.cuda.OutOfMemoryError("CUDA out of memory")
        return params, bn_state, {"train_loss": [], "val_dice": [], "lr": []}

    monkeypatch.setattr(t_train, "train_model", fake_train_model)
    train_cli.main(argv + ["--device", "cpu"])
    assert [r for r, _ in calls] == [False, True]
    _assert_trees(calls[1][1], world["params"], atol=0, rtol=0)
    monkeypatch.setattr(t_train, "train_model",
                        lambda *a, **k: (_ for _ in ()).throw(ValueError("not an OOM")))
    with pytest.raises(ValueError, match="not an OOM"):
        train_cli.main(argv + ["--device", "cpu"])


@pytest.mark.parametrize("flag", [
    ["--data-parallel", "--zero", "--kernels", "cuda"], ["--multihost", "--num-processes", "2"],
    ["--coordinator", "h:1"],
    ["--num-processes", "2"], ["--process-id", "0"], ["--spatial-parallel", "2"],
    ["--tensor-parallel", "2"], ["--pipeline-parallel", "2"], ["--zero"],
    ["--wandb", "--data-parallel", "--multihost"],
    ["--profile", "p", "--zero"], ["--debug-nans", "--multihost"],
    ["--arch", "unetpp", "--kernels", "cuda"],
    ["--arch", "unetpp", "--deep-supervision", "--load", "x.pth"],
    ["--arch", "r2u", "--kernels", "cuda"],
])
def test_train_cli_refuses_unported_flags(flag):
    # The families train; what the JAX package refuses for them stays
    # refused: the kernel route (kernels="pallas" there) and a .pth. The
    # observability flags, --zero and --multihost are ported: beside a
    # refused flag, or where JAX refuses their composition, the refusal
    # stands; --multihost outside torchrun and without --coordinator has no
    # world to form.
    match = ("kernels='cuda' is not implemented for arch=" if "--arch" in flag and "--kernels"
             in flag else r"\.pth import is reference-layout" if "--load" in flag
             else "--zero requires the library route" if "--kernels" in flag
             else "--zero requires --data-parallel" if "--zero" in flag
             else "multi-host training requires --data-parallel" if "--num-processes" in flag
             and "--multihost" in flag
             else "applies with --multihost" if flag[0] in ("--coordinator", "--num-processes",
                                                           "--process-id")
             else "needs torchrun's RANK" if "--multihost" in flag else "is not ported")
    with pytest.raises(SystemExit, match=match):
        train_cli.main(["--device", "cpu", *flag])


def _jax_augment(images, masks, *, config, seed, step):
    """The port's apply step on JAX's draws for (seed, step), the key
    ``fold_in(PRNGKey(seed), step)`` that JAX's loop makes."""
    from tests.test_torch_augment import jax_draws
    from tpu_unet_torch.data.augment import apply_augment

    n, h, w, _ = images.shape
    key = jax.random.fold_in(jax.random.PRNGKey(seed), step)
    return apply_augment(jax_draws(key, config, n, h, w), images, masks, config)


# The data flags (once refused, now ported), each run by both CLIs from one
# checkpoint: the device paths at scale 0.5 give the host path's batches, the
# augmented runs take JAX's draws, so the histories agree as the plain run's.
@pytest.mark.parametrize("flag", [
    ["--device-dataset", "-s", "0.5"], ["--device-preprocess", "-s", "0.5"], ["--augment"],
    ["--augment-elastic", "3"], ["--augment-rot", "5"], ["--augment-scale", "0.1"],
    ["--augment-shift", "2"],
])
def test_train_cli_data_flags_match_jax(world, tmp_path, monkeypatch, flag):
    argv = _cli_world(world, tmp_path, monkeypatch) + ["-e", "1", *flag]
    seen = []
    if flag[0].startswith("--augment"):
        def augment(images, masks, **kw):
            seen.append(kw["step"])
            return _jax_augment(images, masks, **kw)

        monkeypatch.setattr(t_train, "augment_batch", augment)
    train_cli.main(argv + ["--device", "cpu", "--checkpoint-dir", str(tmp_path / "t"),
                           "--history-out", str(tmp_path / "t.json")])
    j_cli_main(argv + ["--checkpoint-dir", str(tmp_path / "j"),
                       "--history-out", str(tmp_path / "j.json")])
    got = json.loads((tmp_path / "t.json").read_text())
    _assert_history(got, json.loads((tmp_path / "j.json").read_text()))
    assert len(got["train_loss"]) == 4 and len(got["val_dice"]) == 2
    assert seen == ([0, 1, 2, 3] if flag[0].startswith("--augment") else [])
    _assert_same_files(tmp_path / "t", tmp_path / "j", arrays=False)


def test_train_cli_data_flag_refusals_are_jaxs(world, tmp_path, monkeypatch):
    argv = _cli_world(world, tmp_path, monkeypatch) + ["--device-dataset",
                                                       "--device-preprocess"]
    with pytest.raises(ValueError, match="mutually exclusive") as port:
        train_cli.main(argv + ["--device", "cpu"])
    with pytest.raises(ValueError) as ref:
        j_cli_main(argv)
    assert str(port.value) == str(ref.value)


def test_train_cli_drops_vmem_limit_and_needs_a_gpu(world):
    with pytest.raises(SystemExit):  # not a flag of the port: argparse rejects it
        train_cli.get_args(["--vmem-limit-mb", "64"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train_cli.main(["--data-dir", str(world["root"] / "data")])


@pytest.mark.parametrize("kwargs", [{"kernels": "pallas"}, {"accum_steps": 3},
                                    {"early_stopping": 0}])
def test_train_model_refuses(world, kwargs):
    with pytest.raises(ValueError):
        train_model({"w": torch.zeros(1)}, {}, world["cfg"], dataset=world["ds"], batch_size=2,
                    **kwargs)
