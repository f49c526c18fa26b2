"""Entry points for a single-device forward check and a multi-rank dry run
of the PyTorch port (``__graft_entry__.py``).

``entry()`` returns ``(fn, (params, state, x))``: the eval forward of the
flagship model (the Carvana U-Net, 31M parameters, ConvTranspose decoder,
two classes) on the card, with a ``[1, 64, 64, 3]`` input drawn from
``np.random.default_rng(0)``; ``fn(params, state, x)`` gives logits
``[1, 64, 64, 2]``.

``dryrun_multichip(n)`` runs the port's multi-rank programs on ``n`` ranks,
each a process of its own: NCCL, one rank per GPU, when ``n`` GPUs exist;
otherwise ``n`` gloo ranks on the CPU, the counterpart of the JAX package's
re-exec onto a virtual CPU mesh. Tiered against a wall-clock budget
(``TPU_UNET_DRYRUN_BUDGET_S``, default 120 s), as JAX's ``_SectionRunner``:

- core tier (base 8, 32x32): ``dp-train``, ``zero1`` and
  ``halo-inference`` (n >= 2). A core section that would start past the
  budget plus ``CORE_GRACE_S`` fails at the section boundary, by name;
- extended tier, while the next section's estimate fits the budget:
  ``accum``, ``device-dataset``, ``dp-sp-2d`` and its three families and
  ``device-dataset-sp`` (n >= 4, even), ``cuda-kernels-dp`` (GPUs only: the
  CUDA train kernels under data parallelism, in JAX's ``pallas-shard-map``
  place), ``tp-3d`` (n a multiple of 8) and ``pipeline`` (n >= 4).

Rank 0 decides every run-or-skip and every over-budget check and
broadcasts it, so the ranks run the same collectives. Each section's wall
time is printed. Nothing is spawned at import.

Run: ``python -m tpu_unet_torch.dryrun [N]`` (``entry()`` on the card, then
``dryrun_multichip(N)``, default 8).
"""

from __future__ import annotations

import multiprocessing as mp
import os
import socket
import sys
import time
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

from tpu_unet_torch.models import UNetConfig, init_unet
from tpu_unet_torch.models.unet import unet_apply
from tpu_unet_torch.predict import resolve_device

FLAGSHIP = UNetConfig(n_channels=3, n_classes=2, bilinear=False)
DRYRUN_CONFIG = UNetConfig(n_channels=3, n_classes=2, bilinear=False, base_channels=8)
DEFAULT_BUDGET_S = 120.0
# Extra wall time the core tier may take past the budget before a core
# section that has not started is refused (a budget of 0 means "no extended
# tier", not "no core").
CORE_GRACE_S = 150.0
# The parent's bound on the ranks beyond the budget: a backstop, not the
# mechanism that bounds the run.
BACKSTOP_S = 300.0
LR = 1e-5


def entry(device="cuda"):
    """(fn, (params, state, x)): the flagship's eval forward on ``device``."""
    device = resolve_device(device)
    params, state = init_unet(FLAGSHIP, np.random.default_rng(0), device=device)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((1, 64, 64, 3),
                                                                  dtype=np.float32)).to(device)

    def fn(params, state, x):
        with torch.inference_mode():
            logits, _ = unet_apply(params, state, x, config=FLAGSHIP, train=False)
        return logits

    return fn, (params, state, x)


def budget_s() -> float:
    return float(os.environ.get("TPU_UNET_DRYRUN_BUDGET_S", DEFAULT_BUDGET_S))


class SectionRunner:
    """Runs named sections against a wall-clock budget (JAX's
    ``_SectionRunner``). Core sections always run unless the budget plus
    ``CORE_GRACE_S`` is already spent, which raises; an extended section runs
    only if the elapsed time plus 1.25x the longest section so far fits the
    budget. ``agree(flag)`` returns the flag every rank acts on (rank 0's);
    ``say`` prints (rank 0 only)."""

    def __init__(self, budget_s: float, agree=lambda flag: flag, say=print):
        self.t0 = time.monotonic()
        self.budget_s = budget_s
        self.max_section_s = 20.0  # the estimate before any measurement
        self.ran: list[str] = []
        self.skipped: list[str] = []
        self.agree, self.say = agree, say

    def elapsed(self) -> float:
        return time.monotonic() - self.t0

    def run(self, name: str, fn, core: bool = False) -> bool:
        if core:
            limit = self.budget_s + CORE_GRACE_S
            if self.agree(self.elapsed() > limit):
                self.say(f"[dryrun] FAIL {name} (core): {self.elapsed():.0f}s elapsed already "
                         f"exceeds the {limit:.0f}s core limit (budget {self.budget_s:.0f}s + "
                         f"grace {CORE_GRACE_S:.0f}s); completed {self.ran}")
                raise RuntimeError(f"dryrun core tier over budget before section {name!r}: "
                                   f"{self.elapsed():.0f}s > {limit:.0f}s (completed: "
                                   f"{self.ran})")
        else:
            est = 1.25 * self.max_section_s
            if self.agree(self.elapsed() + est > self.budget_s):
                self.skipped.append(name)
                self.say(f"[dryrun] SKIP {name}: {self.elapsed():.0f}s elapsed + ~{est:.0f}s "
                         f"est > {self.budget_s:.0f}s budget")
                return False
        t = time.monotonic()
        fn()
        dt = time.monotonic() - t
        self.max_section_s = max(self.max_section_s, dt)
        self.ran.append(name)
        self.say(f"[dryrun] ok {name} ({'core' if core else 'ext'}) {dt:.1f}s  "
                 f"total {self.elapsed():.0f}s")
        return True

    def skip(self, name: str, reason: str) -> None:
        self.skipped.append(name)
        self.say(f"[dryrun] SKIP {name}: {reason}")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def dryrun_multichip(n_devices: int) -> None:
    """The dry run on ``n_devices`` ranks (module docstring); raises if a
    rank fails or the ranks outlast the budget plus ``BACKSTOP_S``."""
    cuda = torch.cuda.is_available() and torch.cuda.device_count() >= n_devices
    print(f"[dryrun] {n_devices} ranks: " + ("nccl, one rank per GPU" if cuda else
          f"gloo on the CPU ({torch.cuda.device_count()} GPUs < {n_devices})"), flush=True)
    budget = budget_s()
    port = _free_port()
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, args=(r, n_devices, port, cuda, budget))
             for r in range(n_devices)]
    for p in procs:
        p.start()
    backstop = budget + BACKSTOP_S
    deadline = time.monotonic() + backstop
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(10)
    if hung:
        raise RuntimeError(f"dryrun_multichip({n_devices}): ranks {hung} hit the {backstop:.0f}s "
                           "backstop; the '[dryrun]' lines above name the last section reached")
    codes = [p.exitcode for p in procs]
    if codes != [0] * n_devices:
        raise RuntimeError(f"dryrun_multichip({n_devices}) failed (exit codes {codes}); see "
                           "the '[dryrun]' log and the ranks' tracebacks above")


def _rank_main(rank: int, world: int, port: int, cuda: bool, budget: float) -> None:
    from tpu_unet_torch.parallel.mesh import init_data_parallel

    if not cuda:
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    device = torch.device(f"cuda:{rank}" if cuda else "cpu")
    dp = init_data_parallel(backend="nccl" if cuda else "gloo", device=device,
                            init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=world, timeout=timedelta(seconds=budget + BACKSTOP_S))
    try:
        _dryrun_local(dp, budget, cuda)
    finally:
        dist.destroy_process_group()


def _agree(dp):
    """Rank 0's flag on every rank, over the host (gloo) group."""
    def agree(flag: bool) -> bool:
        t = torch.tensor([int(flag)])
        dist.broadcast(t, src=0, group=dp.host_group)
        return bool(t.item())
    return agree


def _finite(loss: torch.Tensor, what: str) -> None:
    if not torch.isfinite(loss).item():
        raise RuntimeError(f"{what} produced a non-finite loss")


class _TinyDataset:
    """Preprocessed samples of 32x32, made from their index."""

    def __init__(self, n: int):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        r = np.random.default_rng(i)
        return {"image": r.integers(0, 256, (32, 32, 3)).astype(np.float32) / 255.0,
                "mask": r.integers(0, 2, (32, 32)).astype(np.int64)}


def _dryrun_local(dp, budget: float, cuda: bool) -> None:
    """The sections, on this rank of ``dp``."""
    from tpu_unet_torch.data.device_cache import DeviceResidentData
    from tpu_unet_torch.optim import rmsprop_init
    from tpu_unet_torch.parallel.mesh import broadcast_tree, make_grid
    from tpu_unet_torch.parallel.zero import shard_opt_state_zero, zero_opt_shardings
    from tpu_unet_torch.train import make_train_step

    n, dev, config = dp.world_size, dp.device, DRYRUN_CONFIG
    def say(msg: str) -> None:
        if dp.primary:
            print(msg, flush=True)

    runner = SectionRunner(budget, agree=_agree(dp), say=say)
    rng = np.random.default_rng(0)  # the same draws on every rank: one global batch
    ns: dict = {}

    def batch(rows: int, hw: int = 32):
        x = torch.from_numpy(rng.standard_normal((rows, hw, hw, 3), dtype=np.float32))
        m = torch.from_numpy(rng.integers(0, 2, (rows, hw, hw)))
        return x.to(dev), m.to(dev)

    def init(cfg, seed: int):
        p, s = init_unet(cfg, np.random.default_rng(seed), device=dev)
        return broadcast_tree(p, dp), broadcast_tree(s, dp)

    # ------------------------------------------------------------------ core
    def core_dp_train():
        # The data-parallel step: trees replicated, the global batch's rows.
        params, state = init(config, 0)
        x, m = batch(n)
        step = make_train_step(config, mesh=dp)
        params, state, opt, loss, _ = step(params, state, rmsprop_init(params), dp.rows(x),
                                           dp.rows(m), LR)
        _finite(loss, "the data-parallel train step")
        ns.update(params=params, state=state, opt=opt, step=step)

    def core_zero1():
        # The same step with ZeRO-1: each rank keeps 1/n of the RMSprop state.
        pz, sz = init(config, 6)
        full = rmsprop_init(pz)
        zstep = make_train_step(config, mesh=dp,
                                opt_shardings=zero_opt_shardings(dp, full, pz))
        x, m = batch(n)
        loss = zstep(pz, sz, shard_opt_state_zero(dp, full, pz), dp.rows(x), dp.rows(m), LR)[3]
        _finite(loss, "the ZeRO-1 data-parallel step")

    def core_halo_inference():
        # The halo-exchange forward over the ranks; one rank has no neighbour.
        if n < 2:
            return
        from tpu_unet_torch.parallel.tiling import make_halo_sharded_forward

        band, halo = 32, 16  # a dry-run halo; production takes min_halo (128)
        x = torch.from_numpy(rng.standard_normal((1, band * n, 32, 3), dtype=np.float32))
        fwd = make_halo_sharded_forward(dp, config, halo=halo)
        with torch.inference_mode():
            out = fwd(ns["params"], ns["state"],
                      x[:, dp.rank * band:(dp.rank + 1) * band].to(dev))
        if tuple(out.shape) != (1, band * n, 32, config.n_classes):
            raise RuntimeError(f"halo-sharded forward gave {tuple(out.shape)}")

    runner.run("dp-train", core_dp_train, core=True)
    runner.run("zero1", core_zero1, core=True)
    runner.run("halo-inference", core_halo_inference, core=True)

    # -------------------------------------------------------------- extended
    def ext_accum():
        # Two microbatches of each rank's rows (train --accum-steps 2).
        p, s = init(config, 3)
        x, m = batch(2 * n)
        astep = make_train_step(config, mesh=dp, accum_steps=2)
        _finite(astep(p, s, rmsprop_init(p), dp.rows(x), dp.rows(m), LR)[3],
                "the accumulating data-parallel step")

    def ext_device_dataset():
        # The corpus staged over the ranks, each batch gathered globally
        # (train --device-dataset --data-parallel).
        dd = DeviceResidentData(_TinyDataset(2 * n), num_workers=2, device=dev, dp=dp)
        (db,) = list(dd.batches(list(range(n)), n, shuffle=True, shard=dp.shard))
        p, s, o, loss, _ = ns["step"](ns["params"], ns["state"], ns["opt"], db["image"],
                                      db["mask"], LR)
        _finite(loss, "the device-resident data-parallel step")
        ns.update(params=p, state=s, opt=o)

    def ext_dp_sp_2d():
        # The (data x spatial) grid: batch over 2 data ranks, height over n/2
        # (train --spatial-parallel).
        grid = make_grid(dp, n // 2)
        x, m = batch(2, 64)
        step2 = make_train_step(config, mesh=grid)
        p2, s2, o2, loss, _ = step2(ns["params"], ns["state"], ns["opt"], grid.bands(x),
                                    grid.bands(m), LR)
        _finite(loss, "the data x spatial step")
        ns.update(grid=grid, x3=x, m3=m, params2=p2, state2=s2, opt2=o2, step2=step2)

    def ext_arch_dp_sp(arch: str, seed: int):
        # Each family's grid step: UNet++'s dense skips, the attention gates,
        # R2AttU-Net's recurrent units with gates.
        cfg = UNetConfig(3, 2, bilinear=True, base_channels=8, arch=arch)
        p, s = init(cfg, seed)
        grid = ns["grid"]
        loss = make_train_step(cfg, mesh=grid)(p, s, rmsprop_init(p), grid.bands(ns["x3"]),
                                               grid.bands(ns["m3"]), LR)[3]
        _finite(loss, f"the {arch} data x spatial step")

    def ext_device_dataset_sp():
        # The staged corpus serving rows and bands of the grid.
        grid = ns["grid"]
        dd = DeviceResidentData(_TinyDataset(4), num_workers=2, device=dev, dp=grid)
        (db,) = list(dd.batches(list(range(2)), 2, shuffle=True, shard=grid.shard,
                                band=grid.band))
        loss = ns["step2"](ns.pop("params2"), ns.pop("state2"), ns.pop("opt2"), db["image"],
                           db["mask"], LR)[3]
        _finite(loss, "the device-dataset data x spatial step")

    def ext_cuda_kernels_dp():
        # The hand-written CUDA train kernels under data parallelism.
        p, s = init(config, 7)
        x, m = batch(n)
        kstep = make_train_step(config, mesh=dp, kernels="cuda")
        _finite(kstep(p, s, rmsprop_init(p), dp.rows(x), dp.rows(m), LR)[3],
                "the kernels='cuda' data-parallel step")

    def ext_tp_3d():
        # The (data x spatial x model) grid: DoubleConv channels over 2 model
        # ranks (train --tensor-parallel).
        from tpu_unet_torch.parallel.tensor import shard_model, shard_opt_state

        grid3 = make_grid(dp, 2, 2)
        p3, s3 = init(config, 2)
        o3 = shard_opt_state(grid3, rmsprop_init(p3), p3)
        p3, s3 = shard_model(grid3, p3, s3)
        x, m = batch(grid3.data_size, 64)
        loss = make_train_step(config, mesh=grid3)(p3, s3, o3, grid3.bands(x), grid3.bands(m),
                                                   LR)[3]
        _finite(loss, "the data x spatial x model step")

    def ext_pipeline():
        # GPipe over 4 stages (train --pipeline-parallel 4): rank 0 places
        # them on 4 GPUs, or on the CPU 4 times; the others wait.
        from tpu_unet_torch.parallel.pipeline import PipelineRunner

        x, m = batch(4)
        if dp.primary:
            p4, s4 = init_unet(config, np.random.default_rng(5), device=dev)
            devices = [f"cuda:{i}" for i in range(4)] if cuda else ["cpu"] * 4
            pipe = PipelineRunner(p4, s4, config, n_stages=4, microbatches=2, devices=devices)
            loss, _ = pipe.step(x, m, LR)
            _finite(loss, "the pipeline step")
            if set(pipe.gather()[0]) != set(p4):
                raise RuntimeError("the pipeline's gather lost param keys")
        dp.barrier()

    runner.run("accum", ext_accum)
    runner.run("device-dataset", ext_device_dataset)
    if n >= 4 and n % 2 == 0:
        if runner.run("dp-sp-2d", ext_dp_sp_2d):
            runner.run("dp-sp-unetpp", lambda: ext_arch_dp_sp("unetpp", 1))
            runner.run("dp-sp-attention", lambda: ext_arch_dp_sp("attention", 4))
            runner.run("dp-sp-r2attu", lambda: ext_arch_dp_sp("r2attu", 5))
            runner.run("device-dataset-sp", ext_device_dataset_sp)
    if cuda:
        runner.run("cuda-kernels-dp", ext_cuda_kernels_dp)
    else:
        runner.skip("cuda-kernels-dp", "the CUDA kernels need GPU ranks (gloo ranks on the CPU)")
    if n >= 8 and n % 8 == 0:
        runner.run("tp-3d", ext_tp_3d)
    if n >= 4:
        runner.run("pipeline", ext_pipeline)
    runner.say(f"[dryrun] done in {runner.elapsed():.0f}s (budget {runner.budget_s:.0f}s): "
               f"ran {len(runner.ran)} sections {runner.ran}; skipped "
               f"{runner.skipped or 'none'}")


if __name__ == "__main__":
    n_ranks = int(sys.argv[1]) if len(sys.argv) > 1 else 8
    fn, args = entry()
    print("entry ok:", tuple(fn(*args).shape))
    dryrun_multichip(n_ranks)
    print(f"dryrun_multichip({n_ranks}) ok")
