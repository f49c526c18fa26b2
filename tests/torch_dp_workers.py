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

import contextlib
import multiprocessing as mp
import os
import pickle
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


def _child(fn, rank: int, world: int, rdzv: str, out: str, coordinator: str | None = None
           ) -> None:
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
        with open(f"{out}.args", "rb") as f:
            args = pickle.load(f)
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
    return _start_ranks(fn, world, workdir, args, timeout, multihost)()


def start_ranks(fn, world: int, workdir: Path, *args, timeout: float = 120.0):
    """``run_ranks`` without waiting: the ranks start, and the returned
    function waits for them (within ``timeout`` of the start) and returns
    their results, so that the caller works beside them meanwhile."""
    return _start_ranks(fn, world, workdir, args, timeout, False)


def _start_ranks(fn, world, workdir, args, timeout, multihost):
    workdir = Path(workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    tag = f"{fn.__name__}{world}_{time.monotonic_ns()}"
    rdzv, out = workdir / f"{tag}.rdzv", workdir / tag
    coordinator = f"127.0.0.1:{_free_port()}" if multihost else None
    # The arguments go through a file: a start() whose pickle outgrows the
    # pipe's buffer waits for the child to import torch, one rank after
    # another.
    with open(f"{out}.args", "wb") as f:
        pickle.dump(args, f)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_child,
                         args=(fn, r, world, str(rdzv), str(out), coordinator))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout

    def join() -> list:
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

    return join


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


# -- spatial parallelism (tests/test_torch_spatial.py, test_torch_spatial_cli.py) --


def spatial_ops_worker(dp, spatial, height, width, n, seed):
    """Each spatial op on this rank's rows and height band of seeded float64
    inputs, at every level of ``parallel.halo.row_layout(height,
    spatial)``, on the grid of ``spatial`` over the ranks: the band's
    outputs and input gradients of Σ(y·wy), and the parameter gradients
    summed over the world. The Dice is the same on every rank (a
    replicated loss), so its input gradients are W times the band's share.
    ``spatial_inputs`` makes the same inputs in the test."""
    from tpu_unet_torch.ops import (
        batch_norm,
        conv2d,
        conv_transpose2d,
        max_pool2d,
        pad_to_match,
        upsample2x_align_corners,
    )
    from tpu_unet_torch.ops.batchnorm import BNState
    from tpu_unet_torch.losses import dice_coeff, dice_loss
    from tpu_unet_torch.parallel.halo import Band, row_layout
    from tpu_unet_torch.parallel.mesh import make_grid, pmean

    grid = make_grid(dp, spatial)
    layout = row_layout(height, spatial)
    out = {}

    def band(k):
        """Level k's band; ("up", k): the upsampled level k + 1's."""
        if isinstance(k, tuple):
            return band(k[1] + 1).doubled()
        return Band(grid, *layout[k])

    def cut(a, k):  # this rank's rows and band of a full level-k array
        if k is None:
            return torch.from_numpy(a)
        b = band(k)
        return torch.from_numpy(np.ascontiguousarray(grid.rows(a)[:, b.lo:b.hi]))

    def summed(grads):
        if not grads:
            return []
        return [g * dp.world_size for g in pmean(list(grads), dp.group)]

    def run(name, fn, ins, params, wy, k_out):
        ins = [cut(a, k).requires_grad_(True) for a, k in ins]
        ps = [torch.from_numpy(p).requires_grad_(True) for p in params]
        y = fn(*ins, *ps)
        grads = torch.autograd.grad((y * cut(wy, k_out)).sum(), ins + ps, materialize_grads=True)
        out[name] = {"y": y.detach().numpy(), "gin": [g.numpy() for g in grads[:len(ins)]],
                     "gp": [g.numpy() for g in summed(grads[len(ins):])]}

    data = spatial_inputs(height, spatial, width, n, seed, np.float64)
    for k in range(len(layout)):
        d = data[k]
        run(f"conv2d/{k}", lambda x, w, k=k: conv2d(x, w, padding=1, group=band(k)),
            [(d["x"], k)], [d["w3"]], d["wy"], k)
        run(f"batch_norm/{k}", lambda x, g, b, k=k: batch_norm(
            x, {"scale": g, "bias": b}, BNState(*map(torch.from_numpy, d["bn_state"])),
            train=True, group=band(k))[0], [(d["x"], k)], [d["gamma"], d["beta"]], d["wy4"], k)
        bn_state = batch_norm(cut(d["x"], k), {"scale": torch.from_numpy(d["gamma"]),
                                                "bias": torch.from_numpy(d["beta"])},
                              BNState(*map(torch.from_numpy, d["bn_state"])), train=True,
                              group=band(k))[1]
        out[f"bn_state/{k}"] = [t.numpy() for t in bn_state]
        if k + 1 < len(layout):
            e = data[k + 1]
            run(f"max_pool2d/{k}", lambda x, k=k: max_pool2d(x, group=band(k)),
                [(d["x"], k)], [], e["wy4"], k + 1)
            run(f"upsample2x_align_corners/{k + 1}",
                lambda x, k=k: upsample2x_align_corners(x, group=band(k + 1)),
                [(e["x"], k + 1)], [], d["wy_up"], ("up", k))
            run(f"conv_transpose2d/{k + 1}",
                lambda x, w, k=k: conv_transpose2d(x, w, stride=2, group=band(k + 1)),
                [(e["x"], k + 1)], [d["wt"]], d["wy_up"], ("up", k))
            run(f"pad_to_match/{k}",
                lambda x1, x2, k=k: pad_to_match(x1, x2, group=band(k)),
                [(d["x1"], ("up", k)), (d["x"], k)], [], d["wy4"], k)
    # The Dice at level 0: the loss (the batch reduced first, over the
    # world) and the per-image coefficient (over each image's bands).
    d = data[0]
    one = np.ones((1, 1, 1))
    run("dice_loss", lambda p, t: dice_loss(torch.sigmoid(p), t, group=grid).expand(1, 1, 1),
        [(d["x"][..., 0], 0), (d["mask"], 0)], [], one, None)
    run("dice_coeff", lambda p, t: dice_coeff(torch.sigmoid(p), t, group=grid).expand(1, 1, 1),
        [(d["x"][..., 0], 0), (d["mask"], 0)], [], one, None)
    return out


def spatial_inputs(height, spatial, width, n, seed, dtype=np.float32):
    """The seeded inputs of ``spatial_ops_worker`` at each level: x
    [n, H_k, W_k, 4], the weights, and the loss weights of each output."""
    from tpu_unet_torch.parallel.halo import row_layout

    rng = np.random.default_rng(seed)
    out = []
    for k, (h, _) in enumerate(row_layout(height, spatial)):
        w = max(1, width >> k)
        f = lambda *s: rng.standard_normal(s).astype(dtype)  # noqa: E731
        out.append({"x": f(n, h, w, 4), "w3": f(3, 3, 4, 5) * 0.3, "wy": f(n, h, w, 5),
                    "wy4": f(n, h, w, 4),
                    "gamma": 1 + 0.3 * f(4), "beta": f(4),
                    "bn_state": (0.2 * f(4), 1 + rng.random(4).astype(dtype)),
                    "wt": f(2, 2, 4, 4) * 0.3, "mask": (rng.random((n, h, w)) > 0.5)
                    .astype(dtype)})
    for k in range(len(out) - 1):
        n_, h, w, _ = out[k]["x"].shape
        h1, w1 = 2 * out[k + 1]["x"].shape[1], 2 * out[k + 1]["x"].shape[2]
        out[k]["x1"] = rng.standard_normal((n_, h1, w1, 4)).astype(dtype)
        out[k]["wy_up"] = rng.standard_normal((n_, h1, w1, 4)).astype(dtype)
    return out


def spatial_step_worker(dp, spatial, cases, params, state, images, masks, lr):
    """For each (name, config fields, step kwargs) case, from the trees
    ``params[name]``, ``state[name]``: one step on the grid of
    ``spatial`` (this rank's rows and bands), all its outputs, then a
    second step; the second step's params as one flat array,
    to compare across ranks. ``zero`` in the kwargs: ZeRO over the data axis,
    with the state bytes this rank holds beside the plain state's."""
    from tpu_unet_torch.checkpoint import tree_from_numpy
    from tpu_unet_torch.models.unet import UNetConfig, tree_leaves
    from tpu_unet_torch.optim import get_optimizer
    from tpu_unet_torch.parallel.mesh import make_grid
    from tpu_unet_torch.parallel.zero import gather_opt_state_zero, state_bytes
    from tpu_unet_torch.train import _place_opt_state, make_train_step

    grid = make_grid(dp, spatial)
    xs, ms = (torch.from_numpy(np.ascontiguousarray(grid.bands(a))) for a in (images, masks))
    out = []
    for name, fields, kw in cases:
        kw = dict(kw)
        zero = kw.pop("zero", False)
        cfg = UNetConfig(**fields)
        p, s = tree_from_numpy(params[name]), tree_from_numpy(state[name])
        opt = get_optimizer(kw.get("optimizer", "rmsprop"))[0](p)
        full_bytes = state_bytes(opt)
        opt, sh = _place_opt_state(opt, p, grid, zero=zero)
        step = make_train_step(cfg, mesh=grid, return_grads=True, opt_shardings=sh, **kw)
        o1 = step(p, s, opt, xs, ms, lr)
        o2 = step(*o1[:3], xs, ms, lr)
        flat = torch.cat([t.reshape(-1) for t in tree_leaves(o2[0])]).numpy()
        rec = {"params": _numpy_tree(o1[0]), "bn": _numpy_tree(o1[1]),
               "loss": float(o1[3]), "gnorm": float(o1[4]), "grads": _numpy_tree(o1[5]),
               "params2": flat, "loss2": float(o2[3]), "bytes": state_bytes(o1[2]),
               "full_bytes": full_bytes}
        rec["opt"] = _numpy_tree(gather_opt_state_zero(o1[2], sh) if zero else o1[2])
        out.append(rec)
    return out


def spatial_data_worker(dp, spatial, data_dir, params, state, batches, config_fields):
    """On the grid of ``spatial``: the staged corpus's train and val batches
    (``DeviceResidentData(dp=grid)``, rows per data coordinate) against the
    host loader's with the same ``shard`` and ``band``, bitwise, and the
    staged bytes; then ``evaluate`` and ``evaluate_per_class`` over the
    global ``batches``, without and with ``tta``."""
    from tpu_unet_torch.checkpoint import tree_from_numpy
    from tpu_unet_torch.data import CarvanaDataset, DataLoader, random_split_indices
    from tpu_unet_torch.data.device_cache import DeviceResidentData
    from tpu_unet_torch.evaluate import evaluate, evaluate_per_class
    from tpu_unet_torch.models.unet import UNetConfig
    from tpu_unet_torch.parallel.mesh import make_grid

    grid = make_grid(dp, spatial)
    ds = CarvanaDataset(Path(data_dir) / "imgs", Path(data_dir) / "masks", scale=1.0)
    train_idx, _ = random_split_indices(len(ds), 0.2, seed=0)
    dd = DeviceResidentData(ds, device="cpu", dp=grid, num_workers=2)
    same = []
    got = dd.batches(train_idx, 4, shuffle=True, seed=0, drop_last=True, shard=grid.shard,
                     band=grid.band)
    ref = DataLoader(ds, 4, shuffle=True, indices=train_idx, seed=0, drop_last=True,
                     shard=grid.shard, band=grid.band, num_workers=1)
    for _ in range(2):
        pairs = list(zip(got, ref))
        same.append(len(pairs) == len(ref) and all(
            np.array_equal(a["image"].numpy(), b["image"])
            and np.array_equal(a["mask"].numpy(), b["mask"]) for a, b in pairs))
    cfg = UNetConfig(**config_fields)
    p, s = tree_from_numpy(params), tree_from_numpy(state)
    return {"batches_equal": same, "rows": (dd.lo, dd.hi), "staged": dd.staged_bytes,
            "scalar": evaluate(p, s, batches, cfg, mesh=grid),
            "per_class": evaluate_per_class(p, s, batches, cfg, mesh=grid),
            "tta": evaluate(p, s, batches, cfg, tta=True, mesh=grid)}


class _StubRun:
    """A ``wandb.init`` run that keeps what it is given."""

    def __init__(self):
        import types

        self.logs = []
        self.config = types.SimpleNamespace(update=lambda *a, **k: None)

    def log(self, d):
        self.logs.append(d)


def spatial_train_worker(dp, data_dir, params, state, config_fields, runs):
    """``train_model`` on the CarvanaDataset in ``data_dir`` once per kwargs
    of ``runs`` (a ``"tag"``; ``"multihost"`` overrides the record's; with
    ``use_wandb`` a stub ``wandb`` records the logs): each run's history,
    final params as one flat array, and for W&B the shapes of the logged
    sample triplet."""
    import dataclasses
    import sys
    import types

    import tpu_unet_torch.train as train_mod
    from tpu_unet_torch.checkpoint import tree_from_numpy
    from tpu_unet_torch.data import CarvanaDataset
    from tpu_unet_torch.models.unet import UNetConfig, tree_leaves

    ds = CarvanaDataset(Path(data_dir) / "imgs", Path(data_dir) / "masks", scale=1.0)
    cfg = UNetConfig(**config_fields)
    out = {}
    run_ = _StubRun()
    fake = types.ModuleType("wandb")
    fake.init = lambda **k: run_
    fake.Histogram = lambda v: ("hist", int(np.asarray(v).size))
    fake.Image = lambda v: ("img", np.asarray(v).shape)
    sys.modules["wandb"] = fake
    for kw in runs:
        kw = dict(kw)
        tag = kw.pop("tag")
        record = dataclasses.replace(dp, multihost=kw.pop("multihost", dp.multihost))
        run_.logs.clear()
        p, _, hist = train_mod.train_model(tree_from_numpy(params), tree_from_numpy(state), cfg,
                                           dataset=ds, data_parallel=record,
                                           save_checkpoint_flag=False, **kw)
        images = [d["images"] for d in run_.logs if "images" in d]
        out[tag] = {"history": hist, "images": images,
                    "params": torch.cat([t.reshape(-1) for t in tree_leaves(p)]).numpy()}
    del sys.modules["wandb"]
    return out


# -- tensor parallelism (tests/test_torch_tensor_parallel.py) -----------------------


@contextlib.contextmanager
def float64_steps():
    """``Tensor.float`` keeping float64 tensors as they are, for the block:
    the train step casts its BN statistics, loss and clip to fp32 by name,
    and a float64 step keeps every part of it in float64."""
    fp32 = torch.Tensor.float
    torch.Tensor.float = lambda t: t if t.dtype == torch.float64 else fp32(t)
    try:
        yield
    finally:
        torch.Tensor.float = fp32


def float64_step(cfg, grid, params, state, images, masks, lr, **kw):
    """One step in float64 on ``grid`` from the full trees ``params`` and
    ``state`` (each rank its rows and band ``images``, ``masks``): (grad
    norm, the whole clipped gradients as numpy)."""
    from tpu_unet_torch.models.unet import tree_map
    from tpu_unet_torch.optim import get_optimizer
    from tpu_unet_torch.parallel.tensor import gather_model, shard_model, shard_opt_state
    from tpu_unet_torch.train import make_train_step

    with float64_steps():
        p, s = (tree_map(torch.Tensor.double, t) for t in (params, state))
        opt = get_optimizer(kw.get("optimizer", "rmsprop"))[0](p)
        if getattr(grid, "model_size", 1) > 1:
            p, s, opt = (*shard_model(grid, p, s), shard_opt_state(grid, opt, p))
        o = make_train_step(cfg, mesh=grid, return_grads=True, **kw)(
            p, s, opt, images.double(), masks, lr)
        grads = (gather_model(grid, o[0], o[1], cfg, o[5])[2]
                 if getattr(grid, "model_size", 1) > 1 else o[5])
    return float(o[4]), _numpy_tree(grads)


def _replicated_digest(tree, dims) -> str:
    """A digest of the leaves of ``tree`` that ``dims`` replicates, to hold the
    model ranks' copies bitwise equal."""
    import hashlib

    from tpu_unet_torch.models.unet import tree_leaves
    from tpu_unet_torch.parallel.tensor import dims_in_order

    flat = [t.detach().reshape(-1).double() for t, d in zip(tree_leaves(tree),
                                                             dims_in_order(tree, dims))
            if d is None]
    return hashlib.sha256(torch.cat(flat).numpy().tobytes()).hexdigest()


def tp_step_worker(dp, cases, trees, images, masks, lr):
    """For each (name, config fields, (S, T), steps, step kwargs) case, on the
    (W/(S·T)) x S x T grid, from the full trees ``trees[name]``: this rank's
    shard shapes and state bytes, the eval forward on its shards (S = 1:
    its rows' logits), then ``steps`` steps on its rows and band; the
    losses and grad norms, the gathered params, BN state and clipped
    gradients after the first step, the params and BN state after the last,
    the optimizer state after the last, and the digest of
    its replicated leaves. ``"pr18"`` in the
    kwargs: also the step on ``make_grid(dp, S)`` and whether it is
    bitwise this one, and the two records' coordinates; ``"float64"``: also
    the first step in float64 (``float64_step``)."""
    from tpu_unet_torch.checkpoint import tree_from_numpy
    from tpu_unet_torch.models.unet import UNetConfig, unet_apply
    from tpu_unet_torch.optim import get_optimizer
    from tpu_unet_torch.parallel.mesh import make_grid, world_of
    from tpu_unet_torch.parallel.tensor import (
        gather_model,
        gather_opt_state,
        model_specs,
        shard_model,
        shard_opt_state,
    )
    from tpu_unet_torch.parallel.zero import state_bytes
    from tpu_unet_torch.train import make_train_step

    out, grids = [], {}
    for name, fields, (spatial, model), steps, kw in cases:
        kw = dict(kw)
        pr18 = kw.pop("pr18", False)
        f64 = kw.pop("float64", False)
        if (spatial, model) not in grids:  # each grid's groups formed once
            grids[spatial, model] = make_grid(dp, spatial, model)
        grid = grids[spatial, model]
        cfg = UNetConfig(**fields)
        p, s = tree_from_numpy(trees[name][0]), tree_from_numpy(trees[name][1])
        opt = get_optimizer(kw.get("optimizer", "rmsprop"))[0](p)
        full_bytes = state_bytes(p) + state_bytes(opt)
        if model > 1:
            sp, ss = shard_model(grid, p, s)
            so = shard_opt_state(grid, opt, p)
        else:
            sp, ss, so = p, s, opt
        xs, ms = (torch.from_numpy(np.ascontiguousarray(grid.bands(a))) for a in (images, masks))
        rec = {"bytes": state_bytes(sp) + state_bytes(so), "full_bytes": full_bytes,
               "band": list(xs.shape)}
        if "conv1" in sp.get("down2", {}):
            rec["down2_conv1"] = list(sp["down2"]["conv1"]["w"].shape)
        if spatial == 1:
            with torch.no_grad():
                rec["y"] = unet_apply(sp, ss, xs, config=cfg, train=False,
                                      group=grid)[0].numpy()
        step = make_train_step(cfg, mesh=grid, return_grads=True, **kw)
        trees_ = (sp, ss, so)
        rec["loss"], rec["gnorm"] = [], []
        for k in range(steps):
            o = step(*trees_, xs, ms, lr)
            trees_ = o[:3]
            rec["loss"].append(float(o[3]))
            rec["gnorm"].append(float(o[4]))
            if k in (0, steps - 1):
                fp, fs, fg = (gather_model(grid, trees_[0], trees_[1], cfg, o[5]) if model > 1
                              else (*trees_[:2], o[5]))
                if k == 0:
                    rec.update(params1=_numpy_tree(fp), bn1=_numpy_tree(fs),
                               grads1=_numpy_tree(fg))
                    first = o
        fo = gather_opt_state(grid, trees_[2], cfg) if model > 1 else trees_[2]
        if model > 1:
            rec["digest"] = _replicated_digest(trees_[0], model_specs(cfg, model)[0])
        rec.update(params=_numpy_tree(fp), bn=_numpy_tree(fs), opt=_numpy_tree(fo))
        if f64:
            rec["gnorm64"], rec["grads64"] = float64_step(cfg, grid, p, s, xs, ms, lr, **kw)
        if pr18:
            old = make_grid(dp, spatial)
            o18 = make_train_step(cfg, mesh=old, return_grads=True, **kw)(p, s, opt, xs, ms, lr)
            rec["pr18_bitwise"] = all(
                torch.equal(a, b) for a, b in zip(_flat_leaves((*o18[:3], o18[5])),
                                                  _flat_leaves((*first[:3], first[5])))
            ) and float(o18[3]) == float(first[3]) and float(o18[4]) == float(first[4])
            rec["pr18_coords"] = [(g.data_rank, g.data_size, g.s, g.band, g.model_size,
                                   world_of(g) is g.group) for g in (old, grid)]
        out.append(rec)
    return out


def _flat_leaves(trees) -> list:
    from tpu_unet_torch.models.unet import tree_leaves

    return [t for tree in trees for t in tree_leaves(tree)]


def tp_eval_worker(dp, params, state, batches, config_fields, images):
    """On the 2 x 1 x 2 and 1 x 2 x 2 grids, the trees sharded: ``evaluate``
    over the global ``batches`` on each; on the first, ``evaluate`` with
    TTA, ``evaluate_per_class`` and the eval forward's logits of this
    rank's rows."""
    from tpu_unet_torch.checkpoint import tree_from_numpy
    from tpu_unet_torch.evaluate import evaluate, evaluate_per_class
    from tpu_unet_torch.models.unet import UNetConfig, unet_apply
    from tpu_unet_torch.parallel.mesh import make_grid
    from tpu_unet_torch.parallel.tensor import shard_model

    cfg = UNetConfig(**config_fields)
    out = {}
    for spatial in (1, 2):
        grid = make_grid(dp, spatial, 2)
        p, s = shard_model(grid, tree_from_numpy(params), tree_from_numpy(state))
        rec = {"scalar": evaluate(p, s, batches, cfg, mesh=grid)}
        if spatial == 1:  # TTA and the per-class sweep run whole rows on either grid
            rec.update(per_class=evaluate_per_class(p, s, batches, cfg, mesh=grid),
                       tta=evaluate(p, s, batches, cfg, tta=True, mesh=grid))
            with torch.no_grad():
                rec["y"] = unet_apply(p, s, torch.from_numpy(grid.rows(images)), config=cfg,
                                      train=False, group=grid)[0].numpy()
        out[spatial] = rec
    return out


def tp_train_worker(dp, data_dir, params, state, config_fields, root):
    """``train_model`` on the CarvanaDataset in ``data_dir``: the
    data-parallel run and the ``tensor_parallel=4`` run (2 epochs, a
    validation each, the optimizer state and EMA weights saved, a stub
    ``wandb``), then each resumed from the tensor-parallel run's epoch 2 for
    a third; then ``train_cli --data-parallel --tensor-parallel 4`` for an
    epoch and resumed for a second. Returns each run's history and written
    files, and the W&B panel's histogram keys and sizes and sample shape of
    the first two."""
    import types

    import tpu_unet_torch.train as train_mod
    from tpu_unet_torch.checkpoint import tree_from_numpy
    from tpu_unet_torch.data import CarvanaDataset
    from tpu_unet_torch.models.unet import UNetConfig

    ds = CarvanaDataset(Path(data_dir) / "imgs", Path(data_dir) / "masks", scale=1.0)
    cfg = UNetConfig(**config_fields)
    run_ = _StubRun()
    fake = types.ModuleType("wandb")
    fake.init = lambda **k: run_
    fake.Histogram = lambda v: ("hist", int(np.asarray(v).size))
    fake.Image = lambda v: ("img", np.asarray(v).shape)
    sys.modules["wandb"] = fake
    out = {}
    common = dict(dataset=ds, batch_size=8, learning_rate=1e-3, val_percent=0.25, seed=0,
                  val_per_epoch=1, save_optimizer=True, ema_decay=0.5, data_parallel=dp)
    runs = [("dp", dict(epochs=2, use_wandb=True)), ("tp", dict(epochs=2, use_wandb=True,
                                                                tensor_parallel=4)),
            ("dp_resumed", dict(epochs=3, resume="tp")),
            ("tp_resumed", dict(epochs=3, resume="tp", tensor_parallel=4))]
    try:
        for tag, kw in runs:
            ck = Path(root) / tag
            if "resume" in kw:
                kw["resume"] = str(Path(root) / kw["resume"] / "checkpoint_epoch2.npz")
            run_.logs.clear()
            _, _, hist = train_mod.train_model(tree_from_numpy(params), tree_from_numpy(state),
                                               cfg, checkpoint_dir=ck, **common, **kw)
            panel = [{k: v for k, v in d.items() if isinstance(v, tuple)}
                     for d in run_.logs if "validation Dice" in d]
            out[tag] = {"history": hist, "panel": panel,
                        "files": sorted(f.name for f in ck.glob("*.npz")) if ck.exists() else []}
    finally:
        del sys.modules["wandb"]
    # The CLI on the grid, an epoch and then a resumed second one.
    ck = Path(root) / "cli"
    argv = ["--device", "cpu", "--data-parallel", "--tensor-parallel", "4", "-b", "8", "-s",
            "1.0", "-v", "25", "--val-per-epoch", "1", "--data-dir", str(data_dir),
            "--checkpoint-dir", str(ck), "--save-optimizer"]
    out["cli"] = [cli_worker(dp, [*argv, *more], "train", config_fields["base_channels"])
                  for more in (["-e", "1"], ["-e", "2", "--resume",
                                             str(ck / "checkpoint_epoch1.npz")])]
    out["cli_files"] = sorted(f.name for f in ck.glob("*.npz"))
    return out
