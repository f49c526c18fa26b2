"""The port's data parallelism through its entry points, on the CPU: 2 gloo
ranks, each a spawned process (``tests/torch_dp_workers.py``), all in one
group for the module:

- one step of each model family (``--arch``; ``kernels=None``) against the
  port's single-process step and JAX's float64 step, by
  ``tests/test_torch_data_parallel.py``'s rules (loss 1e-6 relative and BN
  running stats 1e-6 + 1e-6 relative of the single-process step's; the
  gradients', grad norm's and params' distance from float64 at most 2x the
  single-process step's; loss 1e-5 relative and BN stats 1e-4 + 1e-4 of
  JAX's), the ranks' params bitwise equal after two steps;
- ``evaluate`` and ``evaluate_per_class`` with and without ``--tta`` over
  batches of 8, 8 and 3 (the 3 does not split over 2 ranks and runs whole on
  each), against the port's single-process evaluation (1e-6) and JAX's
  (1e-5 relative, ``tests/test_parallel.py``'s bar); every rank the same;
- ``train_model(data_parallel=)`` with ``--device-dataset`` and a val split
  whose last batch does not split (JAX's
  ``test_dp_device_dataset_with_odd_val_split``), and a stop signal on one
  rank ending both ranks at the same batch;
- ``train_cli --data-parallel`` writing its checkpoint from rank 0 alone,
  its params and BN state within ``tests/test_torch_train.py``'s step
  tolerances of the one-process run's (params 2e-2 at lr 1e-3, BN stats
  1e-4 + 1e-4, losses 1e-5 relative), and ``evaluate --data-parallel`` on
  that checkpoint within 1e-6 of the one-process CLI;
- ``augment_batch(shard=)``: a rank's rows get the draws the global batch
  gives them, bit for bit;
- the launches the port does not run exit with their named refusal.
"""

import functools

import numpy as np
import pytest
import torch

import jax

import tpu_unet_torch.models.unet as t_unet
from tests.test_torch_data_parallel import (
    LR,
    UNET,
    _assert_trees,
    _batch,
    _check_against_single,
    _jax_single,
    _port_single,
    _world,
)
from tests.test_torch_train import _flat
from tests.torch_dp_workers import jobs_worker, port_numpy, run_ranks
from tpu_unet.data.synthetic import synth_batch as j_synth_batch
from tpu_unet.evaluate import evaluate as j_evaluate
from tpu_unet_torch import evaluate as t_evaluate, train_cli
from tpu_unet_torch.checkpoint import load_checkpoint, tree_from_numpy
from tpu_unet_torch.data import make_synthetic_carvana
from tpu_unet_torch.evaluate import evaluate, evaluate_per_class
from tpu_unet_torch.models.unet import UNetConfig

FAMILIES = ("attention", "unetpp", "r2u", "r2attu")
CLI_ARGS = ["--device", "cpu", "-e", "1", "-b", "4", "-s", "1.0", "-l", "1e-3",
            "--validation", "20", "--val-per-epoch", "1", "--seed", "0"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@functools.lru_cache(maxsize=None)
def _eval_batches():
    rng = np.random.default_rng(3)
    out = []
    for n in (8, 8, 3):  # the 3 does not split over 2 ranks
        x, m = j_synth_batch(rng, n, 32, 32)
        out.append({"image": x, "mask": m})
    return out


@pytest.fixture(scope="module")
def dp(tmp_path_factory):
    """Every job of the module in one 2-rank group; each rank's results by
    job name, and the data dirs."""
    root = tmp_path_factory.mktemp("dpcli")
    for name, n in (("odd", 55), ("stop", 20), ("cli", 10)):
        make_synthetic_carvana(root / name, n=n, h=32, w=32, seed=1)
    archs = FAMILIES
    x, m = _batch()
    _, params, state = _world("unet")
    common = dict(epochs=1, batch_size=8, learning_rate=1e-3, seed=0)
    jobs = {
        "families": ("step_worker", ([(UNET | {"arch": a}, {}) for a in archs],
                                     {a: port_numpy(_world(a)[1]) for a in archs},
                                     {a: port_numpy(_world(a)[2]) for a in archs}, x, m, LR)),
        "eval": ("eval_worker", (port_numpy(params), port_numpy(state), _eval_batches(), UNET,
                                 False)),
        "eval_tta": ("eval_worker", (port_numpy(params), port_numpy(state), _eval_batches(),
                                     UNET, True)),
        # 55 images, 20% val: 44 train (5 steps of 8, the last 4 dropped) and
        # 11 val (batches of 8 and 3); a validation every step.
        "odd_val": ("train_model_worker", (str(root / "odd"), dict(
            common, val_percent=0.2, device_dataset=True, save_checkpoint_flag=False))),
        # 20 images: 16 train, 4 steps of 4; rank 1 is signalled after step 2.
        "stop": ("train_model_worker", (str(root / "stop"), dict(
            common, batch_size=4, val_percent=0.2, checkpoint_dir=str(root / "stop_ck")),
            1, 2)),
        "cli": ("cli_worker", (CLI_ARGS + ["--data-dir", str(root / "cli"), "--data-parallel"],
                               "train", 8, str(root / "cli_ck"))),
        "cli_eval": ("cli_worker", (["--device", "cpu", "-m",
                                     str(root / "cli_ck" / "rank0" / "checkpoint_epoch1.npz"),
                                     "--data-dir", str(root / "cli"), "-s", "1.0", "-b", "4",
                                     "--data-parallel"], "eval", 8)),
    }
    ranks = run_ranks(jobs_worker, 2, root, list(jobs.values()), timeout=300)
    return root, [dict(zip(jobs, r)) for r in ranks]


@pytest.mark.parametrize("arch", FAMILIES)
def test_dp_family_step_matches_jax_and_single_process(arch, dp):
    _, ranks = dp
    i = FAMILIES.index(arch)
    r = ranks[0]["families"][i]
    j64 = _jax_single(arch, float64=True)
    np.testing.assert_allclose(r["loss"], float(j64[3]), rtol=1e-5)
    _assert_trees(r["bn"], j64[1], atol=1e-4, rtol=1e-4)
    _check_against_single(r, _port_single(arch), j64)
    assert np.array_equal(ranks[1]["families"][i]["params2"], r["params2"])


@pytest.mark.parametrize("tta", [False, True])
def test_sharded_evaluate_matches_whole(tta, dp):
    _, ranks = dp
    key = "eval_tta" if tta else "eval"
    _, params, state = _world("unet")
    cfg = UNetConfig(**UNET)
    tp, ts = tree_from_numpy(params), tree_from_numpy(state)
    whole = evaluate(tp, ts, _eval_batches(), cfg, tta=tta)
    whole_c = evaluate_per_class(tp, ts, _eval_batches(), cfg, tta=tta)
    jcfg = _world("unet")[0]
    ref = j_evaluate(jax.tree.map(np.asarray, params), state, _eval_batches(), jcfg, tta=tta)
    for r in ranks:
        np.testing.assert_allclose(r[key]["scalar"], whole, atol=1e-6)
        np.testing.assert_allclose(r[key]["scalar"], ref, rtol=1e-5)
        for got, want in zip(r[key]["per_class"], whole_c):
            np.testing.assert_allclose(got, want, atol=1e-6)
    assert ranks[1][key]["scalar"] == ranks[0][key]["scalar"]


def test_dp_device_dataset_with_odd_val_split(dp):
    _, ranks = dp
    hists = [r["odd_val"]["history"] for r in ranks]
    assert len(hists[0]["train_loss"]) == 5  # 44 // 8, whole batches only
    assert len(hists[0]["val_dice"]) == 5 and all(np.isfinite(hists[0]["val_dice"]))
    assert hists[0] == hists[1]
    assert np.array_equal(ranks[0]["odd_val"]["params"], ranks[1]["odd_val"]["params"])


def test_stop_on_one_rank_stops_both(dp):
    root, ranks = dp
    for r in ranks:
        assert len(r["stop"]["history"]["train_loss"]) == 2  # rank 1 signalled after step 2
    assert ranks[0]["stop"]["history"] == ranks[1]["stop"]["history"]
    assert ranks[0]["stop"]["files"] == ranks[1]["stop"]["files"] == ["INTERRUPTED.npz"]
    assert np.array_equal(ranks[0]["stop"]["params"], ranks[1]["stop"]["params"])


def test_train_and_evaluate_cli_two_ranks_match_one_process(dp, tmp_path, monkeypatch, capsys):
    root, ranks = dp
    monkeypatch.setattr(t_unet, "UNetConfig", lambda **kw: UNetConfig(**kw, base_channels=8))
    ck = tmp_path / "one"
    hist = train_cli.main(CLI_ARGS + ["--data-dir", str(root / "cli"),
                                      "--checkpoint-dir", str(ck)])[2]
    dp_hist = ranks[0]["cli"]
    assert ranks[1]["cli"] == dp_hist and len(dp_hist["train_loss"]) == 2
    np.testing.assert_allclose(dp_hist["train_loss"], hist["train_loss"], rtol=1e-5)
    # Rank 0 alone writes.
    assert sorted(p.name for p in (root / "cli_ck" / "rank0").iterdir()) == \
        ["checkpoint_epoch1.npz"]
    assert not (root / "cli_ck" / "rank1").exists()
    cfg = UNetConfig(**UNET)
    p1, s1, _, _ = load_checkpoint(ck / "checkpoint_epoch1.npz", cfg)
    p2, s2, _, _ = load_checkpoint(root / "cli_ck" / "rank0" / "checkpoint_epoch1.npz", cfg)
    _assert_trees(p2, p1, atol=2e-2)
    _assert_trees(s2, s1, atol=1e-4, rtol=1e-4)
    one = t_evaluate.main(["--device", "cpu", "-m",
                           str(root / "cli_ck" / "rank0" / "checkpoint_epoch1.npz"),
                           "--data-dir", str(root / "cli"), "-s", "1.0", "-b", "4"])
    assert ranks[0]["cli_eval"] == ranks[1]["cli_eval"]
    np.testing.assert_allclose(ranks[0]["cli_eval"], one, atol=1e-6)


def test_augment_draws_follow_the_global_rows():
    """Under data parallelism each rank augments its rows with the draws
    the global batch gives those rows (the step's rows are the global
    batch's)."""
    from tpu_unet_torch.data.augment import AugmentConfig, augment_batch

    x, m = j_synth_batch(np.random.default_rng(4), 8, 32, 32)
    x, m = torch.from_numpy(x), torch.from_numpy(m)
    cfg = AugmentConfig(hflip=True, brightness=0.1, contrast=0.1, elastic_alpha=8.0, rot_deg=10)
    whole = augment_batch(x, m, config=cfg, seed=3, step=5)
    for rank in range(4):
        rows = slice(2 * rank, 2 * rank + 2)
        part = augment_batch(x[rows], m[rows], config=cfg, seed=3, step=5, shard=(rank, 4))
        for got, want in zip(part, whole):
            assert torch.equal(got, want[rows])


def test_multi_host_and_bare_launches_are_refused(monkeypatch):
    # A world over hosts is ported (tests/test_torch_multihost.py): a process
    # of one with no rank to take is refused, and --zero across hosts is, as
    # JAX refuses it.
    monkeypatch.setenv("WORLD_SIZE", "4")
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    monkeypatch.delenv("RANK", raising=False)
    for main, argv in ((train_cli.main, []), (t_evaluate.main, ["-m", "x.npz"])):
        with pytest.raises(SystemExit, match="needs RANK and WORLD_SIZE"):
            main(argv + ["--data-parallel", "--device", "cpu"])
    with pytest.raises(SystemExit, match="--zero is single-host for now"):
        train_cli.main(["--data-parallel", "--zero", "--multihost", "--device", "cpu"])
    for name in ("WORLD_SIZE", "LOCAL_WORLD_SIZE", "RANK"):
        monkeypatch.delenv(name, raising=False)
    with pytest.raises(SystemExit, match="launch under torchrun"):
        train_cli.main(["--data-parallel", "--device", "cpu"])
    assert not torch.distributed.is_initialized()


# --multihost and --zero are ported: beside them the unported flags stay refused.
@pytest.mark.parametrize("flag", [["--multihost", "--spatial-parallel", "2"],
                                  ["--zero", "--tensor-parallel", "2"],
                                  ["--spatial-parallel", "2"], ["--tensor-parallel", "2"],
                                  ["--pipeline-parallel", "2"]])
def test_other_parallel_flags_stay_refused_beside_data_parallel(flag):
    refused = next(f for f in flag if f.endswith("-parallel"))
    with pytest.raises(SystemExit, match=f"{refused} is not ported to tpu_unet_torch"):
        train_cli.main(["--device", "cpu", "--data-parallel", *flag])
