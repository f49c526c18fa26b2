"""Multi-process data parallelism for the port's CPU tests
(``tests/test_torch_data_parallel.py``, ``tests/test_torch_dp_cli.py``).

``run_ranks`` spawns one process per rank, forms a gloo group through a
rendezvous file (no port to race for), runs a worker function of this
module in each and returns each rank's result. A rank that fails, or a
group that does not finish within its time limit, fails the test; nothing
waits longer than the limit. The workers import torch and the port only.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import signal
import sys
import time
import traceback
from datetime import timedelta
from pathlib import Path

import numpy as np
import torch

GROUP_TIMEOUT_S = 60


def _child(fn, rank: int, world: int, rdzv: str, out: str, args: tuple) -> None:
    torch.set_num_threads(1)  # ranks share the machine's cores with other tests
    from tpu_unet_torch.parallel.mesh import init_data_parallel

    try:
        dp = init_data_parallel(backend="gloo", device="cpu", init_method=f"file://{rdzv}",
                                rank=rank, world_size=world,
                                timeout=timedelta(seconds=GROUP_TIMEOUT_S))
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


def run_ranks(fn, world: int, workdir: Path, *args, timeout: float = 120.0) -> list:
    """``fn(dp, *args)`` on ``world`` gloo ranks on the CPU; the ranks'
    results, in rank order."""
    workdir = Path(workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    tag = f"{fn.__name__}{world}_{time.monotonic_ns()}"
    rdzv, out = workdir / f"{tag}.rdzv", workdir / tag
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_child, args=(fn, r, world, str(rdzv), str(out), args))
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
    if stop_rank == dp.rank:
        make = train_mod.make_train_step

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
    p, _, hist = train_mod.train_model(params, state, cfg, dataset=ds, data_parallel=dp,
                                       **kwargs)
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

