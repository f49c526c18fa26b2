"""Traffic kind ``train_step_dp``: the port's data-parallel train step
(``make_train_step(mesh=...)`` over ``parallel/mesh.py::init_data_parallel``,
as ``train_cli --data-parallel`` under ``torchrun --nproc-per-node R``
trains), one rank a device, steps back to back.

Rank 0 is the run's own process, on ``cuda:0``: the window, the device trace
and the program's spans are its own, as in every other cell. Ranks 1..R-1
are child processes of this file run as a script, one on each further
device; every rank joins one NCCL group (gloo on the CPU) at a
``tcp://localhost`` rendezvous. Each rank draws the same weights and
batches from the seed and steps on its contiguous rows of each global batch
(``DataParallel.rows``).

Set-up: ``check_steps`` steps (rank 0 reads its losses, first gradients and
changes for the check; the initial weights and the check's global batches
then wait on the host, as a rank of the program holds neither), then
every rank compares its params and BN statistics with rank 0's, bit for
bit (a rank that differs counts as failed), then ``warmup_steps`` more. Rank 0 sets the window's step count
from the warm-up's step time and sends it once, so that no flag crosses
ranks inside the window; the window opens on a barrier and closes on each
rank's ``synchronize()`` and a barrier. After it the ranks leave the group
and rank 0 checks its check steps against ``reference.train_steps`` at the
global batch, on its own device.

Traffic parameters: ``amp``, ``ranks``, ``batch`` (the global batch),
``pool_batches``, ``check_steps``, ``warmup_steps``. ``train_img_s`` counts
the global batch; the readings' ``steps`` and ``images`` are rank 0's, so
the per-card readers (``mfu.train``, ``conv_roofline.train``) stay per card.
"""

from __future__ import annotations

import json
import math
import os
import socket
import subprocess
import sys
import threading
import time
from datetime import timedelta
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if __name__ == "__main__":  # a rank > 0: import packages from the checkout's root
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from port_bench import check, inputs, reference  # noqa: E402
from port_bench.program import leaves_by_path, model_config, train_size, trees_for  # noqa: E402

TIMEOUT_S = 600  # a collective that waits longer than this fails the run


def _device(rank: int, cuda: bool) -> torch.device:
    return torch.device("cuda", rank) if cuda else torch.device("cpu")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


class _Rank:
    """One rank's step, trees and batches (its rows of each global batch)."""

    def __init__(self, spec: dict):
        import torch.distributed as dist

        from tpu_unet_torch.ops.conv import full_fp32
        from tpu_unet_torch.optim import rmsprop_init
        from tpu_unet_torch.parallel.mesh import init_data_parallel
        from tpu_unet_torch.train import make_train_step

        self.dist = dist
        cfg, tr = spec["config"], spec["traffic"]
        self.rank, self.tr, self.lr = spec["rank"], tr, cfg["recipe"]["lr"]
        self.dev = dev = _device(self.rank, spec["cuda"])
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
            full_fp32()  # the train CLI's device set-up: fp32 means fp32, no TF32
        self.dp = init_data_parallel(device=dev, init_method=spec["addr"], rank=self.rank,
                                     world_size=tr["ranks"],
                                     timeout=timedelta(seconds=TIMEOUT_S))
        h, w = train_size(cfg)
        g = inputs.generator(spec["seed"], dev)
        self.weights = inputs.make_weights(cfg["model"], g, dev)
        bn0 = inputs.initial_bn_state(cfg["model"], dev)
        images, masks = inputs.train_pool(g, tr["pool_batches"], tr["batch"], h, w, dev)
        # rank 0 keeps the check steps' global batches for the reference, on
        # the host: a rank of the program holds only its rows
        self.batches = ([(x.cpu(), m.cpu()) for x, m in zip(images, masks)][: tr["check_steps"]]
                        if self.rank == 0 else [])
        # copies: a slice of the leading dim is a view, which would keep the
        # whole global batch on the device
        self.images = [self.dp.rows(x).clone() for x in images]
        self.masks = [self.dp.rows(x).clone() for x in masks]
        del images, masks
        mcfg = model_config(cfg)
        params, state = trees_for(mcfg, self.weights, bn0)
        rec = cfg["recipe"]
        self.step = make_train_step(mcfg, amp=tr["amp"], kernels=spec["kernels"], mesh=self.dp,
                                    weight_decay=rec["weight_decay"], momentum=rec["momentum"],
                                    grad_clip=rec["grad_clip"])
        self.trees = (params, state, rmsprop_init(params))
        self.i = 0

    def one(self):
        """One step on the next batch of the pool; its loss."""
        k = self.i % len(self.images)
        out = self.step(*self.trees, self.images[k], self.masks[k], self.lr)
        self.trees, self.i = out[:3], self.i + 1
        return out[3]

    def sync(self):
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    def check_steps(self) -> dict:
        """The check steps; rank 0's readings of them (None elsewhere). The
        initial weights then leave the device (rank 0's for the reference,
        on the host)."""
        losses, grad = [], None
        for i in range(self.tr["check_steps"]):
            losses.append(self.one())
            if i == 0 and self.rank == 0:
                sq = leaves_by_path(self.trees[2].square_avg)
                grad = dict(zip(sq, reference.grad_norms(sq.values())))
        if self.rank != 0:
            self.weights = None
            return None
        p_now = leaves_by_path(self.trees[0])
        change = dict(zip(p_now, reference.norms([p_now[k] - self.weights[k] for k in p_now])))
        self.weights = {k: v.cpu() for k, v in self.weights.items()}
        return {"loss": [float(x) for x in losses], "grad": grad, "change": change}

    def ranks_differing(self) -> int:
        """The number of ranks whose params or BN statistics differ from rank
        0's in any bit (the same on every rank)."""
        differs = 0
        from tpu_unet_torch.models.unet import tree_leaves

        for leaf in tree_leaves(self.trees[:2]):
            theirs = leaf.detach().clone().contiguous()
            self.dist.broadcast(theirs, src=0, group=self.dp.group)
            differs |= not torch.equal(theirs, leaf)
        n = torch.tensor([int(differs)], dtype=torch.int64)
        self.dist.all_reduce(n, group=self.dp.host_group)
        return int(n.item())

    def warmup_s(self) -> float:
        """Seconds a step over the warm-up steps."""
        self.sync()
        t0 = time.perf_counter()
        for _ in range(self.tr["warmup_steps"]):
            self.one()
        self.sync()
        return (time.perf_counter() - t0) / max(1, self.tr["warmup_steps"])

    def agree_steps(self, n: int) -> int:
        """Rank 0's window step count, on every rank."""
        t = torch.tensor([n], dtype=torch.int64)
        self.dist.broadcast(t, src=0, group=self.dp.host_group)
        return int(t.item())

    def window_steps(self, n: int, span=None) -> None:
        """The window's part of a rank: a barrier, ``n`` steps, its device
        drained, a barrier."""
        self.dp.barrier()
        for _ in range(n):
            if span is None:
                self.one()
            else:
                with span("train.step"):
                    self.one()
        self.sync()
        self.dp.barrier()

    def leave(self):
        self.trees = self.step = self.images = self.masks = None
        self.dist.destroy_process_group()


def _child(spec: dict) -> int:
    """Rank ``spec["rank"]`` > 0, to the end of the window."""
    r = _Rank(spec)
    r.check_steps()
    r.ranks_differing()
    r.warmup_s()
    r.window_steps(r.agree_steps(0))
    r.leave()
    return 0


def run(ctx) -> dict:
    cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
    world, cuda = tr["ranks"], dev.type == "cuda"
    if tr["batch"] % world:
        raise ValueError(f"a global batch of {tr['batch']} does not divide over {world} ranks")
    if cuda:
        if dev.index not in (None, 0) or torch.cuda.device_count() < world:
            raise RuntimeError(f"train_step_dp: {world} ranks need cuda:0..{world - 1}; "
                               f"{torch.cuda.device_count()} device(s)")
        from tpu_unet_torch.kernels import _build

        _build.build()  # once, before the ranks load it
    spec = {"config": cfg, "traffic": tr, "seed": ctx.seed, "kernels": ctx.kernels("train"),
            "cuda": cuda, "addr": f"tcp://localhost:{_free_port()}"}
    # the children write to standard error: a run's result is the last line
    # of standard output
    children = [subprocess.Popen([sys.executable, str(Path(__file__).resolve()),
                                  json.dumps({**spec, "rank": r})], cwd=ROOT, stdout=2)
                for r in range(1, world)]
    done = threading.Event()
    threading.Thread(target=_watch, args=(children, done), daemon=True).start()
    try:
        out = _rank0(ctx, {**spec, "rank": 0})
    except BaseException:
        for c in children:
            c.kill()
        raise
    finally:
        done.set()
    for c in children:
        try:
            rc = c.wait(timeout=TIMEOUT_S)
        except subprocess.TimeoutExpired:
            c.kill()
            rc = "timeout"
        if rc != 0:
            raise RuntimeError(f"train_step_dp: a rank > 0 ended with {rc}")
    return out


def _watch(children, done) -> None:
    """End the run at once when a rank > 0 fails before rank 0 is done:
    rank 0 would otherwise wait in a collective until ``TIMEOUT_S``."""
    while not done.wait(1.0):
        for c in children:
            rc = c.poll()
            if rc not in (None, 0):
                print(f"train_step_dp: a rank > 0 ended with {rc}", file=sys.stderr, flush=True)
                os._exit(3)


def _rank0(ctx, spec: dict) -> dict:
    tr = ctx.traffic
    with ctx.spans.span("setup.ranks"):
        r = _Rank(spec)
    with ctx.spans.span("setup.check_steps"):
        prog = r.check_steps()
        differing = r.ranks_differing()
    with ctx.spans.span("setup.warmup_steps"):
        step_s = r.warmup_s()
    steps = r.agree_steps(max(1, math.ceil(ctx.seconds / step_s)))
    with ctx.window() as win:
        r.window_steps(steps, span=ctx.spans.span)
    weights, batches = r.weights, r.batches
    r.leave()
    del r
    ctx.free()

    cfg, dev = ctx.config, ctx.device
    t_ref = time.perf_counter()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    with reference.precision(tf32=False):
        ref = reference.train_steps(cfg["model"], {k: v.to(dev) for k, v in weights.items()},
                                    inputs.initial_bn_state(cfg["model"], dev),
                                    [(x.to(dev), m.to(dev)) for x, m in batches],
                                    lr=cfg["recipe"]["lr"])
    ref_peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
    judged = check.train_numbers(prog, ref)
    per_rank = tr["batch"] // tr["ranks"]
    return {
        "attempted": steps, "failed": differing,
        "end_to_end": {"train_img_s": steps * tr["batch"] / win.seconds},
        "numbers": judged["numbers"],
        "diagnostics": {"numbers": judged["numbers"], "worst_leaf": judged["worst"],
                        "quiet_leaves": judged["quiet_leaves"], "ranks": tr["ranks"],
                        "ranks_differing": differing, "warmup_step_s": step_s,
                        "reference_s": time.perf_counter() - t_ref,
                        "reference_step_s": ref["step_s"],
                        "reference_peak_gib": ref_peak / float(1 << 30)},
        "readings": {"kind": "train", "steps": steps, "images": steps * per_rank,
                     "window_s": win.seconds, "height": train_size(cfg)[0],
                     "width": train_size(cfg)[1]},
    }


if __name__ == "__main__":
    sys.exit(_child(json.loads(sys.argv[1])))
