"""The port's multi-host training (``tpu_unet_torch/parallel/multihost.py``,
``--multihost``) on the CPU: two "hosts", each one gloo process that sees
``LOCAL_WORLD_SIZE=1`` and ``WORLD_SIZE=2`` and joins an explicit TCP
rendezvous on 127.0.0.1 (``multihost.initialize``), spawned once for the
module (``tests/torch_dp_workers.py``), in JAX's ``tests/test_multihost.py``
configuration: 50 images of 32x32, base 8, bilinear, a global batch of 8,
val 20%, 2 epochs, lr 1e-3, seed 0 (40 train images: 5 steps an epoch and
a validation after each; 10 val images, of which the multi-host loader
keeps one batch of 8):

- the train losses as JAX's test holds its two processes to its one (1e-5
  relative on the first two steps, 1e-2 on all), against JAX's
  single-process ``train_model`` run in float64 (``tests/
  test_torch_families.py::_jax_float64``, the loader's images as float64),
  a witness independent of both fp32 runs: after one RMSprop step the
  fp32 params differ wherever a gradient near zero took the other sign
  (each such element moves by 10·lr, ``tests/test_torch_zero.py``), and at
  lr 1e-3 JAX's fp32 losses lie 4.8e-4 relative from its float64 ones at
  the second step, and the port's one-process losses 4.2e-7. The first loss
  (the same trees) is held to JAX's fp32 run at 1e-5, and the two hosts to
  the port's single-process ``train_model`` at JAX's tolerances as well;
  both ranks' histories equal; only rank 0 writes;
- the same with ``device_dataset=True``, and ``train_cli --multihost
  --coordinator ... --data-parallel`` in the formed world; each rank stages
  half the corpus and its batches are bitwise the host loader's;
- the val-batch rule, the tiny-val refusal, the ``--device-preprocess`` and
  ``--data-parallel`` refusals, the W&B panel's scalars only;
- the global batch order of the port's sharded ``DataLoader`` (the multi-host
  feed) against JAX's ``MultiHostBatches`` at one process.
"""

import functools
import sys
import types

import numpy as np
import pytest
import torch

import jax

from tests.test_torch_families import _f64, _jax_float64
from tests.test_torch_train import _numpy
from tests.torch_dp_workers import jobs_worker, port_numpy, run_ranks
import tpu_unet.data.prefetch as j_prefetch
from tpu_unet.data import CarvanaDataset as JCarvana
from tpu_unet.models import UNetConfig as JConfig, init_unet as j_init
from tpu_unet.parallel.mesh import batch_sharding, make_mesh
from tpu_unet.parallel.multihost import MultiHostBatches as JMultiHostBatches
from tpu_unet.train import train_model as j_train_model
from tpu_unet_torch import train_cli
from tpu_unet_torch.data import CarvanaDataset, DataLoader, make_synthetic_carvana
from tpu_unet_torch.checkpoint import tree_from_numpy
from tpu_unet_torch.models.unet import UNetConfig
from tpu_unet_torch.parallel.mesh import DataParallel
from tpu_unet_torch.parallel.multihost import is_primary, spans_hosts
from tpu_unet_torch.train import _build_loaders, _check_train_flags, train_model
from tpu_unet_torch.train_logging import WandbValidationPanel

JCFG = JConfig(3, 1, bilinear=True, base_channels=8)
RUN = dict(epochs=2, batch_size=8, learning_rate=1e-3, val_percent=0.2, seed=0)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = tmp_path_factory.mktemp("mh") / "d"
    make_synthetic_carvana(d, n=50, h=32, w=32)
    return d


@functools.lru_cache(maxsize=None)
def _init():
    params, state = jax.jit(j_init, static_argnums=1)(jax.random.PRNGKey(0), JCFG)
    return _numpy(params), _numpy(state)


@pytest.fixture(scope="module")
def world(data):
    """Both ranks' results: the trainer with the host loader and with the
    corpus on the device, the CLI, then the staged corpus's batches."""
    params, state = _init()
    ck = data.parent / "ck"
    runs = [{"tag": "host", **RUN}, {"tag": "dd", **RUN, "device_dataset": True}]
    cli = ["--device", "cpu", "-e", "1", "-b", "8", "-s", "1.0", "-l", "1e-3", "--validation",
           "20", "--seed", "0", "--data-dir", str(data), "--multihost", "--coordinator",
           "127.0.0.1:1", "--num-processes", "2", "--process-id", "{rank}", "--data-parallel",
           "--checkpoint-dir", str(ck / "cli" / "rank{rank}")]
    jobs = [("multihost_worker", (port_numpy(params), port_numpy(state), str(data), str(ck),
                                  runs)),
            ("train_cli_worker", (cli, 8))]
    return ck, run_ranks(jobs_worker, 2, data.parent, jobs, timeout=150.0, multihost=True)


class _Float64Numpy:
    """``numpy`` with ``float32`` standing for ``float64`` (the JAX loader's
    collate casts images to ``np.float32``)."""

    float32 = np.float64

    def __getattr__(self, name):
        return getattr(np, name)


@functools.lru_cache(maxsize=None)
def _jax_history(data, float64=False):
    """JAX's single-process ``train_model`` history, in fp32 or float64."""
    ds = JCarvana(data / "imgs", data / "masks", scale=1.0, num_workers=0)
    params, state = _init()
    if not float64:
        return j_train_model(jax.tree.map(jax.numpy.asarray, params),
                             jax.tree.map(jax.numpy.asarray, state), JCFG, dataset=ds,
                             save_checkpoint_flag=False, **RUN)[2]
    with _jax_float64(), pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_prefetch, "np", _Float64Numpy())
        out = j_train_model(_f64(params), _f64(state), JCFG, dataset=ds,
                            save_checkpoint_flag=False, **RUN)
    assert jax.tree.leaves(out[0])[0].dtype == np.float64
    return out[2]


@functools.lru_cache(maxsize=None)
def _port_history(data):
    ds = CarvanaDataset(data / "imgs", data / "masks", scale=1.0)
    params, state = (tree_from_numpy(t) for t in _init())
    return train_model(params, state, UNetConfig(*JCFG), dataset=ds, save_checkpoint_flag=False,
                       **RUN)[2]


def test_two_hosts_train_as_jax_single_process(world, data):
    ck, ranks = world
    ref, ref64, single = (np.asarray(h["train_loss"]) for h in (
        _jax_history(data), _jax_history(data, float64=True), _port_history(data)))
    assert len(ref) == len(ref64) == len(single) == 10
    np.testing.assert_allclose(single[0], ref[0], rtol=1e-5)
    for r, (out, _) in enumerate(ranks):
        assert out["multihost"]
        for run, run0 in zip(out["runs"], ranks[0][0]["runs"]):
            hist = run["history"]
            assert hist == run0["history"]
            assert len(hist["train_loss"]) == 10 and len(hist["val_dice"]) == 10
            np.testing.assert_allclose(hist["train_loss"][:2], single[:2], rtol=1e-5)
            np.testing.assert_allclose(hist["train_loss"], single, rtol=1e-2)
            got = np.asarray(hist["train_loss"])
            np.testing.assert_allclose(got[0], ref[0], rtol=1e-5)
            np.testing.assert_allclose(got[:2], ref64[:2], rtol=1e-5)
            np.testing.assert_allclose(got, ref64, rtol=1e-2)
            # Only rank 0 writes.
            assert (run["files"] is not None) == (r == 0)
    assert "checkpoint_epoch2.npz" in ranks[0][0]["runs"][0]["files"]
    # The CLI with the explicit rendezvous flags, in the formed world.
    assert ranks[0][1] == ranks[1][1] and len(ranks[0][1]["train_loss"]) == 5
    assert (ck / "cli" / "rank0" / "checkpoint_epoch1.npz").exists()
    assert not (ck / "cli" / "rank1").exists()


def test_staged_corpus_is_per_rank_and_bitwise(world):
    _, ranks = world
    for r, (out, _) in enumerate(ranks):
        assert out["rows"] == (25 * r, 25 * (r + 1))
        assert out["staged"] * 2 == out["whole"]
        assert out["batches_equal"] == [True] * 4


def _record(world_size, multihost=True):
    return DataParallel(group=None, host_group=None, rank=0, world_size=world_size,
                        device=torch.device("cpu"), multihost=multihost)


def test_val_batch_rule_and_refusals(data):
    ds = CarvanaDataset(data / "imgs", data / "masks", scale=1.0)
    kw = dict(seed=0, device=torch.device("cpu"), device_dataset=False, device_preprocess=False)
    train, val = _build_loaders(ds, list(range(40)), list(range(40, 50)), batch_size=8,
                                dp=_record(2), **kw)
    assert isinstance(train, DataLoader) and isinstance(val, DataLoader)
    assert (val.batch_size, len(val), len(train)) == (8, 1, 5)
    assert train.shard == val.shard == (0, 2) and train.drop_last and val.drop_last
    (b,) = list(val)
    assert b["image"].shape[0] == 4 and b["shard"] == (0, 2)
    _, val = _build_loaders(ds, list(range(45)), list(range(45, 50)), batch_size=8,
                            dp=_record(2), **kw)
    assert (val.batch_size, len(val)) == (4, 1)  # min(8, (5 // 2) * 2)
    with pytest.raises(ValueError, match="smaller than the process count"):
        _build_loaders(ds, list(range(49)), [49], batch_size=8, dp=_record(8), **kw)
    flags = dict(accum_steps=1, batch_size=8, early_stopping=None, kernels=None)
    with pytest.raises(ValueError, match="multi-host training requires --data-parallel"):
        _check_train_flags(**flags, multihost=True)
    with pytest.raises(ValueError, match="--device-preprocess is not supported under multi-host"):
        _check_train_flags(**flags, multihost=True, data_parallel=True, device_preprocess=True)
    for argv, match in ((["--multihost", "--num-processes", "2"], "requires --data-parallel"),
                        (["--multihost", "--num-processes", "2", "--data-parallel",
                          "--device-preprocess"], "--device-preprocess is not supported"),
                        (["--coordinator", "h:1"], "--coordinator applies with --multihost"),
                        (["--multihost", "--data-parallel"], "needs torchrun's RANK")):
        with pytest.raises(SystemExit, match=match):
            train_cli.main(["--device", "cpu", "--data-dir", str(data), *argv])
    assert not torch.distributed.is_initialized() and is_primary()


def test_spans_hosts_reads_torchrun_env(monkeypatch):
    for k in ("WORLD_SIZE", "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    assert not spans_hosts() and spans_hosts(2) and not spans_hosts(1)
    monkeypatch.setenv("WORLD_SIZE", "16")
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "8")
    assert spans_hosts()
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "16")
    assert not spans_hosts()


def test_wandb_panel_logs_scalars_only_across_hosts(monkeypatch):
    logged = []
    monkeypatch.setitem(sys.modules, "wandb", types.SimpleNamespace())  # no histograms built
    panel = WandbValidationPanel(types.SimpleNamespace(log=logged.append),
                                 config=UNetConfig(*JCFG), amp=False, remat=False,
                                 dice_weight=1.0, accum_steps=1, group=object(), multihost=True)
    # No gradient pass: params and batches are never read.
    panel.log(lr_now=1e-3, val_dice=0.5, val_iou=0.4, step=3, epoch=1, params=None,
              bn_state=None, images=None, masks=None, hist_batch=None)
    assert logged == [{"learning rate": 1e-3, "validation Dice": 0.5, "validation IoU": 0.4,
                       "step": 3, "epoch": 1}]


def test_batch_order_matches_jax_multihost_batches(data):
    jds = JCarvana(data / "imgs", data / "masks", scale=1.0, num_workers=0)
    ds = CarvanaDataset(data / "imgs", data / "masks", scale=1.0)
    idx = list(range(3, 46))
    ref = JMultiHostBatches(jds, idx, 8, batch_sharding(make_mesh(n_devices=1)), shuffle=True,
                            seed=4)
    one, *halves = (DataLoader(ds, 8, shuffle=True, drop_last=True, seed=4, indices=idx,
                               shard=shard) for shard in ((0, 1), (0, 2), (1, 2)))
    assert len(one) == len(ref) == 5
    for _ in range(2):  # the second pass reshuffles
        got = list(one)
        parts = [list(h) for h in halves]
        for k, b in enumerate(ref):
            for key in ("image", "mask"):
                np.testing.assert_array_equal(got[k][key], np.asarray(b[key]))
                np.testing.assert_array_equal(
                    np.concatenate([parts[0][k][key], parts[1][k][key]]), got[k][key])
