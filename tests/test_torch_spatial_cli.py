"""The port's spatial parallelism through its entry points on the CPU
(``train_model(spatial_parallel=)``, ``train_cli --data-parallel
--spatial-parallel S``): gloo ranks spawned once per fixture
(``tests/torch_dp_workers.py``), against the port's 1-D data-parallel runs
and the JAX package's own 2-D (data x spatial) run:

- ``train_model`` after JAX's ``test_spatial_parallel_train_model_e2e``
  (16 images of 64x64, b8, 2 epochs, val 0.25, base 8, bilinear, JAX's
  weights; here one validation a step, so that the Dice is compared too)
  on a 2 x 2 grid of 4 ranks: its history within JAX's rtol 1e-3 / atol
  1e-4 (val Dice atol 1e-3) of the port's 1-D run over the same 4 ranks
  and of JAX's ``spatial_parallel=4`` run on its 8 CPU devices; with
  ``--device-dataset`` and with ``--zero`` bitwise the host-feed grid run;
  ``remat``, ``accum_steps=2``, ``ema_decay`` and W&B (a stub ``wandb``)
  together within the same tolerances of the 1-D run with those flags,
  the logged sample image whole (its bands gathered);
- two emulated hosts (``--multihost``, each process a host) as a 1 x 2
  grid: the host feed (val batches of each rank's rows and band) and the
  staged corpus each bitwise the same grid on one host;
- ``train_cli --data-parallel --spatial-parallel 2`` writing
  ``checkpoint_epoch1.npz`` from rank 0 alone, within
  ``tests/test_torch_train.py``'s step tolerances of the 1-D CLI run's
  (params 2e-2 at lr 1e-3, BN stats 1e-4 + 1e-4, losses 1e-5 relative).
"""

import functools

import numpy as np
import pytest
import torch

import jax

from tests.test_torch_train import _numpy
from tests.torch_dp_workers import jobs_worker, port_numpy, run_ranks
from tpu_unet.data import CarvanaDataset as JCarvana
from tpu_unet.models import UNetConfig as JConfig, init_unet as j_init
from tpu_unet.train import train_model as j_train_model
from tpu_unet_torch.data import make_synthetic_carvana

JCFG = JConfig(3, 1, bilinear=True, base_channels=8)
FIELDS = dict(n_channels=3, n_classes=1, bilinear=True, base_channels=8)
RUN = dict(epochs=2, batch_size=8, learning_rate=1e-3, val_percent=0.25, seed=0,
           val_per_epoch=1)
EXTRA = dict(remat=True, accum_steps=2, ema_decay=0.9, use_wandb=True)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = tmp_path_factory.mktemp("sp_cli") / "d"
    make_synthetic_carvana(d, n=16, h=64, w=64)
    return d


@functools.lru_cache(maxsize=None)
def _init():
    params, state = jax.jit(j_init, static_argnums=1)(jax.random.PRNGKey(0), JCFG)
    return _numpy(params), _numpy(state)


@pytest.fixture(scope="module")
def four(data):
    """The 4-rank runs: train_model 1-D and on the 2 x 2 grid (host feed,
    staged corpus, ZeRO, the extra flags), then the train CLI both ways."""
    params, state = (port_numpy(t) for t in _init())
    runs = [{"tag": "1d", **RUN}, {"tag": "grid", **RUN, "spatial_parallel": 2},
            {"tag": "grid_dd", **RUN, "spatial_parallel": 2, "device_dataset": True},
            {"tag": "grid_zero", **RUN, "spatial_parallel": 2, "zero": True},
            {"tag": "1d_extra", **RUN, **EXTRA},
            {"tag": "grid_extra", **RUN, **EXTRA, "spatial_parallel": 2}]
    ck = data.parent / "ck"
    cli = ["--device", "cpu", "-e", "1", "-b", "8", "-s", "1.0", "-l", "1e-3", "--validation",
           "25", "--val-per-epoch", "1", "--seed", "0", "--data-dir", str(data),
           "--data-parallel"]
    jobs = [("spatial_train_worker", (str(data), params, state, FIELDS, runs)),
            ("train_cli_worker", (cli + ["--checkpoint-dir", str(ck / "1d" / "rank{rank}")], 8)),
            ("train_cli_worker", (cli + ["--spatial-parallel", "2", "--checkpoint-dir",
                                         str(ck / "grid" / "rank{rank}")], 8))]
    return ck, run_ranks(jobs_worker, 4, data.parent, jobs, timeout=300)


@functools.lru_cache(maxsize=None)
def _jax_history(data):
    """JAX's ``train_model`` on its 2 x 4 (data x spatial) mesh."""
    ds = JCarvana(data / "imgs", data / "masks", scale=1.0, num_workers=0)
    params, state = _init()
    return j_train_model(jax.tree.map(jax.numpy.asarray, params),
                         jax.tree.map(jax.numpy.asarray, state), JCFG, dataset=ds,
                         save_checkpoint_flag=False, data_parallel=True, spatial_parallel=4,
                         **RUN)[2]


def _close_history(got, ref):
    assert len(got["train_loss"]) == len(ref["train_loss"]) == 2
    np.testing.assert_allclose(got["train_loss"], ref["train_loss"], rtol=1e-3, atol=1e-4)
    assert len(got["val_dice"]) == len(ref["val_dice"]) == 2
    np.testing.assert_allclose(got["val_dice"], ref["val_dice"], atol=1e-3)


def test_grid_train_model_matches_1d_and_jax_2d(four, data):
    _, ranks = four
    runs = [r[0] for r in ranks]
    grid = runs[0]["grid"]["history"]
    _close_history(grid, runs[0]["1d"]["history"])
    _close_history(grid, _jax_history(data))
    for other in runs[1:]:  # every rank the same run
        assert other["grid"]["history"] == grid
        assert np.array_equal(other["grid"]["params"], runs[0]["grid"]["params"])


@pytest.mark.parametrize("tag", ["grid_dd", "grid_zero"])
def test_grid_staged_corpus_and_zero_are_bitwise_the_host_feed(four, tag):
    for rank in four[1]:
        run = rank[0]
        assert run[tag]["history"] == run["grid"]["history"]
        assert np.array_equal(run[tag]["params"], run["grid"]["params"])


def test_grid_composes_with_remat_accum_ema_and_wandb(four):
    runs = four[1][0][0]
    got, ref = runs["grid_extra"]["history"], runs["1d_extra"]["history"]
    _close_history(got, ref)
    np.testing.assert_allclose(got["val_dice_ema"], ref["val_dice_ema"], atol=1e-3)
    # Rank 0 logs the whole first image (64x64), not its band.
    assert runs["grid_extra"]["images"] == [("img", (64, 64, 3))] * 2
    assert runs["1d_extra"]["images"] == runs["grid_extra"]["images"]
    assert all(r[0]["grid_extra"]["images"] == [] for r in four[1][1:])


def test_grid_train_cli_writes_the_1d_checkpoint(four):
    from tests.test_torch_train import _assert_trees
    from tpu_unet_torch.checkpoint import load_checkpoint
    from tpu_unet_torch.models.unet import UNetConfig

    ck, ranks = four
    h1d, hgrid = ranks[0][1], ranks[0][2]
    np.testing.assert_allclose(hgrid["train_loss"], h1d["train_loss"], rtol=1e-5)
    np.testing.assert_allclose(hgrid["val_dice"], h1d["val_dice"], atol=1e-3)
    for r in range(1, 4):
        assert not (ck / "grid" / f"rank{r}").exists()
    cfg = UNetConfig(3, 1, base_channels=8)
    p1, s1, _, _ = load_checkpoint(ck / "1d" / "rank0" / "checkpoint_epoch1.npz", cfg)
    p2, s2, _, _ = load_checkpoint(ck / "grid" / "rank0" / "checkpoint_epoch1.npz", cfg)
    _assert_trees(p2, p1, atol=2e-2)
    _assert_trees(s2, s1, atol=1e-4, rtol=1e-4)


@pytest.fixture(scope="module")
def two_hosts(data):
    params, state = (port_numpy(t) for t in _init())
    grid = {**RUN, "epochs": 1, "spatial_parallel": 2}
    runs = [{"tag": "host", **grid}, {"tag": "dd", **grid, "device_dataset": True},
            {"tag": "one_host", **grid, "multihost": False}]
    return run_ranks(jobs_worker, 2, data.parent, [
        ("spatial_train_worker", (str(data), params, state, FIELDS, runs))],
        timeout=150.0, multihost=True)


@pytest.mark.parametrize("tag", ["host", "dd"])
def test_two_hosts_grid_is_bitwise_one_host(two_hosts, tag):
    for rank in two_hosts:
        run = rank[0]
        assert run[tag]["history"] == run["one_host"]["history"]
        assert len(run[tag]["history"]["val_dice"]) == 1
        assert np.array_equal(run[tag]["params"], run["one_host"]["params"])
