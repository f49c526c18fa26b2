"""Multi-process data parallelism for the port's CPU tests
(``tests/test_torch_data_parallel.py``, ``tests/test_torch_dp_cli.py``).

``run_ranks`` spawns one process per rank, forms a gloo group through a
rendezvous file (no port to race for), runs a worker function of this
module in each and returns each rank's result. A rank that fails, or a
group that does not finish within its time limit, fails the test; nothing
waits longer than the limit. The workers import torch and the port only.
``run_ranks(multihost=True)`` forms the group as two hosts would instead:
each process sees ``LOCAL_WORLD_SIZE=1`` and joins an explicit TCP
rendezvous on a free localhost port (``parallel.multihost.initialize``).
"""

from __future__ import annotations

import multiprocessing as mp
import os
import signal
import socket
import sys
import time
import traceback
from datetime import timedelta
from pathlib import Path

import numpy as np
import torch

GROUP_TIMEOUT_S = 60


def _child(fn, rank: int, world: int, rdzv: str, out: str, args: tuple,
           coordinator: str | None = None) -> None:
    torch.set_num_threads(1)  # ranks share the machine's cores with other tests
    from tpu_unet_torch.parallel import multihost
    from tpu_unet_torch.parallel.mesh import init_data_parallel

    try:
        timeout = timedelta(seconds=GROUP_TIMEOUT_S)
        if coordinator is not None:
            # One process a "host": torchrun's env as two nodes would set it.
            os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK="0",
                              LOCAL_WORLD_SIZE="1")
            multihost.initialize(coordinator, world, rank, backend="gloo", device="cpu",
                                 timeout=timeout)
            dp = init_data_parallel(device="cpu")
        else:
            dp = init_data_parallel(backend="gloo", device="cpu", init_method=f"file://{rdzv}",
                                    rank=rank, world_size=world, timeout=timeout)
        result = fn(dp, *args)
        if "jax" in sys.modules or "tpu_unet" in sys.modules:
            raise RuntimeError("a data-parallel worker imported the JAX package; pass it the "
                               "port's trees (port_numpy)")
        torch.save(result, f"{out}.rank{rank}.pt")
    except BaseException:
        Path(f"{out}.rank{rank}.err").write_text(traceback.format_exc())
        raise
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(fn, world: int, workdir: Path, *args, timeout: float = 120.0,
              multihost: bool = False) -> list:
    """``fn(dp, *args)`` on ``world`` gloo ranks on the CPU; the ranks'
    results, in rank order. ``multihost``: one process a host, over an
    explicit TCP rendezvous (retried once on a fresh port if the first was
    taken between its choice and the bind)."""
    try:
        return _run_ranks(fn, world, workdir, args, timeout, multihost)
    except AssertionError as e:
        if not (multihost and "ddress already in use" in str(e)):
            raise
    return _run_ranks(fn, world, workdir, args, timeout, multihost)


def _run_ranks(fn, world, workdir, args, timeout, multihost) -> list:
    workdir = Path(workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    tag = f"{fn.__name__}{world}_{time.monotonic_ns()}"
    rdzv, out = workdir / f"{tag}.rdzv", workdir / tag
    coordinator = f"127.0.0.1:{_free_port()}" if multihost else None
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_child,
                         args=(fn, r, world, str(rdzv), str(out), args, coordinator))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(10)
    errors = {r: Path(f"{out}.rank{r}.err").read_text() for r in range(world)
              if Path(f"{out}.rank{r}.err").exists()}
    assert not hung, f"ranks {hung} of {fn.__name__} still running after {timeout} s; {errors}"
    codes = [p.exitcode for p in procs]
    assert codes == [0] * world, f"{fn.__name__} exit codes {codes}: {errors}"
    return [torch.load(f"{out}.rank{r}.pt", weights_only=False) for r in range(world)]


def port_numpy(tree):
    """A JAX numpy tree as the port's tree with numpy leaves (the port's
    NamedTuples), so that a worker unpickles it without the JAX package."""
    from tpu_unet_torch.checkpoint import tree_from_numpy

    return _numpy_tree(tree_from_numpy(tree))


def _numpy_tree(tree):
    from tpu_unet_torch.models.unet import tree_map

    return tree_map(lambda t: t.detach().numpy().copy() if isinstance(t, torch.Tensor) else t,
                    tree)


# -- workers ------------------------------------------------------------------


def jobs_worker(dp, jobs):
    """Several workers of this module in one group, in order: ``jobs`` is a
    list of (worker name, args); returns their results, in order."""
    return [globals()[name](dp, *args) for name, args in jobs]


def ops_worker(dp, bn_args, fused_args):
    """``bn_worker`` and ``fused_worker`` in one group."""
    return {"bn": bn_worker(dp, *bn_args), "fused": fused_worker(dp, *fused_args)}


def bn_worker(dp, x, params, state, wy):
    """``batch_norm(group=)`` on the rank's rows: y, the new state, and the
    gradients of Σ(y·wy) (wy the same rows' weights) for x, γ and β; the
    parameter gradients summed over the ranks (the loss is a sum of the
    ranks' parts)."""
    from tpu_unet_torch.ops.batchnorm import BNState, batch_norm
    from tpu_unet_torch.parallel.mesh import pmean

    xs = torch.from_numpy(dp.rows(x)).requires_grad_(True)
    p = {k: torch.from_numpy(v).requires_grad_(True) for k, v in params.items()}
    y, new = batch_norm(xs, p, BNState(*map(torch.from_numpy, state)), train=True,
                        group=dp.group)
    (y * torch.from_numpy(dp.rows(wy))).sum().backward()
    gp = [g * dp.world_size for g in pmean([p["scale"].grad, p["bias"].grad], dp.group)]
    return {"y": y.detach().numpy(), "state": [t.numpy() for t in new],
            "gx": xs.grad.numpy(), "gscale": gp[0].numpy(), "gbias": gp[1].numpy()}


def fused_worker(dp, x, params, state, wy):
    """``double_conv_train_fused(group=)`` (its kernels' plain versions on
    the CPU) on the rank's rows: y, the new state, the x gradient of Σ(y·wy)
    and the summed weight gradients."""
    from tpu_unet_torch.checkpoint import tree_from_numpy
    from tpu_unet_torch.models.unet import tree_leaves
    from tpu_unet_torch.ops.conv_stats import double_conv_train_fused
    from tpu_unet_torch.parallel.mesh import pmean

    xs = torch.from_numpy(dp.rows(x)).requires_grad_(True)
    p = tree_from_numpy(params)
    leaves = tree_leaves(p)
    for t in leaves:
        t.requires_grad_(True)
    y, new = double_conv_train_fused(p, tree_from_numpy(state), xs, group=dp.group)
    (y * torch.from_numpy(dp.rows(wy))).sum().backward()
    gw = [g * dp.world_size for g in pmean([t.grad for t in leaves], dp.group)]
    return {"y": y.detach().numpy(), "state": _numpy_tree(new), "gx": xs.grad.numpy(),
            "gw": [g.numpy() for g in gw]}


def step_worker(dp, cases, params, state, images, masks, lr):
    """For each (config fields, step kwargs) case: one data-parallel step on
    the rank's rows from the given trees (all its outputs, the clipped
    gradients included), then a second step from the first's trees; the
    second step's params as one flat array, to compare across ranks."""
    from tpu_unet_torch.checkpoint import tree_from_numpy
    from tpu_unet_torch.models.unet import UNetConfig, tree_leaves
    from tpu_unet_torch.optim import get_optimizer
    from tpu_unet_torch.train import make_train_step

    out = []
    xs, ms = (torch.from_numpy(dp.rows(a)) for a in (images, masks))
    for fields, kw in cases:
        cfg = UNetConfig(**fields)
        p, s = tree_from_numpy(params[cfg.arch]), tree_from_numpy(state[cfg.arch])
        opt = get_optimizer(kw.get("optimizer", "rmsprop"))[0](p)
        step = make_train_step(cfg, mesh=dp, return_grads=True, **kw)
        o1 = step(p, s, opt, xs, ms, lr)
        o2 = step(*o1[:3], xs, ms, lr)
        flat = torch.cat([t.reshape(-1) for t in tree_leaves(o2[0])]).numpy()
        out.append({"params": _numpy_tree(o1[0]), "bn": _numpy_tree(o1[1]),
                    "square_avg": _numpy_tree(o1[2].square_avg), "loss": float(o1[3]),
                    "gnorm": float(o1[4]), "grads": _numpy_tree(o1[5]), "params2": flat,
                    "loss2": float(o2[3])})
    return out


def eval_worker(dp, params, state, batches, config_fields, tta):
    """``evaluate`` and ``evaluate_per_class`` over the global batches,
    split over the ranks where they divide."""
    from tpu_unet_torch.checkpoint import tree_from_numpy
    from tpu_unet_torch.evaluate import evaluate, evaluate_per_class
    from tpu_unet_torch.models.unet import UNetConfig

    cfg = UNetConfig(**config_fields)
    p, s = tree_from_numpy(params), tree_from_numpy(state)
    return {"scalar": evaluate(p, s, batches, cfg, tta=tta, mesh=dp),
            "per_class": evaluate_per_class(p, s, batches, cfg, tta=tta, mesh=dp)}


def train_model_worker(dp, data_dir, kwargs, stop_rank=None, stop_after=None):
    """``train_model(data_parallel=dp)`` on the CarvanaDataset in
    ``data_dir``; with ``stop_rank``, that rank sends itself SIGTERM after
    its ``stop_after``-th step (``StopSignal``). Returns the history, the
    final params as one flat array and the files of the checkpoint dir."""
    import tpu_unet_torch.train as train_mod
    from tpu_unet_torch.data import CarvanaDataset
    from tpu_unet_torch.models.unet import UNetConfig, init_unet, tree_leaves

    ds = CarvanaDataset(Path(data_dir) / "imgs", Path(data_dir) / "masks", scale=1.0)
    cfg = UNetConfig(3, 1, bilinear=True, base_channels=8)
    params, state = init_unet(cfg, np.random.default_rng(dp.rank))  # rank 0's win
    make = train_mod.make_train_step
    if stop_rank == dp.rank:

        def make_signalling(*a, **k):
            step, calls = make(*a, **k), [0]

            def wrapped(*sa):
                out = step(*sa)
                calls[0] += 1
                if calls[0] == stop_after:
                    os.kill(os.getpid(), signal.SIGTERM)
                return out
            return wrapped

        train_mod.make_train_step = make_signalling
    try:
        p, _, hist = train_mod.train_model(params, state, cfg, dataset=ds, data_parallel=dp,
                                           **kwargs)
    finally:
        train_mod.make_train_step = make  # a later job in this process steps unsignalled
    ck = Path(kwargs.get("checkpoint_dir", "."))
    return {"history": hist, "params": torch.cat([t.reshape(-1) for t in tree_leaves(p)]).numpy(),
            "files": sorted(f.name for f in ck.glob("*.npz")) if ck.exists() else []}


def cli_worker(dp, argv, prog, base_channels, rank_dir=None):
    """A CLI's ``main(argv)`` in a rank whose group is formed (the CLI joins
    it), at ``base_channels``; ``rank_dir`` appends ``--checkpoint-dir
    rank_dir/rank<r>``. Returns the train history or the Dice."""
    import tpu_unet_torch.models.unet as unet_mod

    cfg = unet_mod.UNetConfig
    unet_mod.UNetConfig = lambda *a, **kw: cfg(*a, **kw, base_channels=base_channels)
    try:
        if prog == "train":
            from tpu_unet_torch.train_cli import main
        else:
            from tpu_unet_torch.evaluate import main
        if rank_dir is not None:
            argv = [*argv, "--checkpoint-dir", f"{rank_dir}/rank{dp.rank}"]
        out = main(argv)
    finally:
        unet_mod.UNetConfig = cfg
    return out[2] if prog == "train" else out



def zero_step_worker(dp, params, state, images, masks, lr, steps):
    """For RMSprop and Adam: ``steps`` data-parallel steps on the rank's rows
    from the given trees, plain and with ZeRO (``opt_shardings``). Returns,
    per optimizer, each run's params, BN state, losses and grad norms, the
    ZeRO state as this rank holds it and gathered, and the plain state."""
    from tpu_unet_torch.checkpoint import tree_from_numpy
    from tpu_unet_torch.models.unet import UNetConfig
    from tpu_unet_torch.optim import get_optimizer
    from tpu_unet_torch.parallel.zero import gather_opt_state_zero
    from tpu_unet_torch.train import _place_opt_state, make_train_step

    cfg = UNetConfig(3, 1, bilinear=True, base_channels=8)
    xs, ms = (torch.from_numpy(dp.rows(a)) for a in (images, masks))
    out = {}
    for opt in ("rmsprop", "adam"):
        runs = {}
        for zero in (False, True):
            p, s = tree_from_numpy(params), tree_from_numpy(state)
            o, sh = _place_opt_state(get_optimizer(opt)[0](p), p, dp, zero=zero)
            step = make_train_step(cfg, mesh=dp, optimizer=opt, opt_shardings=sh)
            losses, norms = [], []
            for _ in range(steps):
                p, s, o, loss, gnorm = step(p, s, o, xs, ms, lr)
                losses.append(loss.item())
                norms.append(gnorm.item())
            rec = {"params": _numpy_tree(p), "bn": _numpy_tree(s), "loss": losses,
                   "gnorm": norms, "opt": _numpy_tree(o)}
            if zero:
                rec["opt_full"] = _numpy_tree(gather_opt_state_zero(o, sh))
            runs["zero" if zero else "plain"] = rec
        out[opt] = runs
    return out


def train_cli_worker(dp, argv, base_channels, env=None):
    """``train_cli.main(argv)`` in the rank's formed group at
    ``base_channels`` (``cli_worker``), "{rank}" in ``argv`` replaced by the
    rank, with ``env`` set for the call. Returns the history."""
    old = {k: os.environ.get(k) for k in (env or {})}
    os.environ.update(env or {})
    try:
        return cli_worker(dp, [a.format(rank=dp.rank) for a in argv], "train", base_channels)
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def multihost_worker(dp, params, state, data_dir, ck_dir, kwargs_list):
    """The multi-host trainer on the CarvanaDataset in ``data_dir`` (JAX's
    ``tests/test_multihost.py`` configuration), once per kwargs in
    ``kwargs_list``: the histories and the files each rank wrote
    (``ck_dir/rank<r>``). Then the device-resident corpus staged over the
    ranks: its staged bytes beside the whole corpus's, and its train (the
    rank's rows) and val (whole) batches beside the host loader's, bitwise."""
    import dataclasses

    import tpu_unet_torch.train as train_mod
    from tpu_unet_torch.checkpoint import tree_from_numpy
    from tpu_unet_torch.data import CarvanaDataset, DataLoader, random_split_indices
    from tpu_unet_torch.data.device_cache import DeviceResidentData
    from tpu_unet_torch.models.unet import UNetConfig

    ds = CarvanaDataset(Path(data_dir) / "imgs", Path(data_dir) / "masks", scale=1.0)
    cfg = UNetConfig(3, 1, bilinear=True, base_channels=8)
    out = {"multihost": dp.multihost, "runs": []}
    for kw in kwargs_list:
        kw = dict(kw)
        rank_dir = Path(ck_dir) / kw.pop("tag") / f"rank{dp.rank}"
        record = dataclasses.replace(dp, multihost=kw.pop("multihost", dp.multihost))
        _, _, hist = train_mod.train_model(tree_from_numpy(params), tree_from_numpy(state), cfg,
                                           dataset=ds, data_parallel=record,
                                           checkpoint_dir=rank_dir, **kw)
        out["runs"].append({"history": hist, "files": sorted(
            str(f.relative_to(rank_dir)) for f in rank_dir.rglob("*")) if rank_dir.exists()
            else None})
    train_idx, val_idx = random_split_indices(len(ds), 0.2, seed=0)
    dd = DeviceResidentData(ds, device="cpu", dp=dp, num_workers=2)
    whole = DeviceResidentData(ds, device="cpu", num_workers=2)
    shard = (dp.rank, dp.world_size)
    same = []
    for got, ref in ((dd.batches(train_idx, 8, shuffle=True, seed=0, drop_last=True,
                                 shard=shard),
                      DataLoader(ds, 8, shuffle=True, indices=train_idx, seed=0,
                                 drop_last=True, shard=shard, num_workers=1)),
                     (dd.batches(val_idx, 8), DataLoader(ds, 8, indices=val_idx,
                                                         num_workers=1))):
        for _ in range(2):  # two passes: the second shuffles anew
            pairs = list(zip(got, ref))
            same.append(len(pairs) == len(ref) and all(
                np.array_equal(a["image"].numpy(), b["image"])
                and np.array_equal(a["mask"].numpy(), b["mask"]) for a, b in pairs))
    out.update(staged=dd.staged_bytes, whole=whole.staged_bytes, rows=(dd.lo, dd.hi),
               batches_equal=same)
    return out


def tile_worker(dp, params, state, xs, ckpt, images, out_dir):
    """``make_halo_sharded_forward`` on the rank's band of each of ``xs`` (the
    whole logits, every rank), the fallbacks of ``predict_img_halo_sharded`` with
    their warnings beside ``predict_img``, its flip-ensembled mask of the
    first image (``tta=True``), and ``predict --tile-sharded``
    (as under torchrun) writing ``out_dir/rank<r>_k.png`` for each image."""
    import logging

    from PIL import Image

    from tpu_unet_torch.checkpoint import tree_from_numpy
    from tpu_unet_torch.models.unet import UNetConfig
    from tpu_unet_torch.parallel.tiling import make_halo_sharded_forward
    from tpu_unet_torch.predict import main, predict_img, predict_img_halo_sharded

    cfg = UNetConfig(3, 1, bilinear=False, base_channels=8)
    p, s = tree_from_numpy(params), tree_from_numpy(state)
    fwd = make_halo_sharded_forward(dp, cfg, halo=128)
    logits = []
    with torch.inference_mode():
        for x in xs:
            band = x.shape[1] // dp.world_size
            logits.append(fwd(p, s, torch.from_numpy(x[:, dp.rank * band:(dp.rank + 1) * band]))
                          .numpy())
    warned = []

    class Grab(logging.Handler):
        def emit(self, record):
            warned.append(record.getMessage())

    grab = Grab(level=logging.WARNING)
    logging.getLogger("tpu_unet_torch.predict").addHandler(grab)
    fallbacks = []
    rng = np.random.default_rng(3)
    for hw in ((48, 64), (528, 64), (320, 64)):  # too small; H not 32-aligned; band < 256
        img = Image.fromarray(rng.integers(0, 255, (*hw, 3), np.uint8))
        n = len(warned)
        got = predict_img_halo_sharded(p, s, cfg, img, dp=dp, scale_factor=1.0, device="cpu")
        fallbacks.append({"hw": hw, "equal": bool(np.array_equal(
            got, predict_img(p, s, cfg, img, scale_factor=1.0, device="cpu"))),
            "warned": any("halo-sharded constraints not met" in m for m in warned[n:])})
    logging.getLogger("tpu_unet_torch.predict").removeHandler(grab)
    tta = predict_img_halo_sharded(p, s, cfg, Image.open(images[0]), dp=dp, scale_factor=1.0,
                                   tta=True, device="cpu")
    outs = [str(Path(out_dir) / f"rank{dp.rank}_{k}.png") for k in range(len(images))]
    os.environ.update(WORLD_SIZE=str(dp.world_size), RANK=str(dp.rank))
    main(["-m", ckpt, "-i", *images, "-o", *outs, "-s", "1.0", "--tile-sharded",
          "--device", "cpu"])
    return {"logits": logits, "fallbacks": fallbacks, "tta": tta,
            "written": [Path(o).exists() for o in outs]}
