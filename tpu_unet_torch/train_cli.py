"""The train CLI (``tpu_unet/train_cli.py``): the reference's flags and the
JAX package's additions, over ``train.train_model``.

Run:
    python -m tpu_unet_torch.train_cli -e 5 -b 4 -s 0.5 --amp --kernels cuda \
        --data-dir data [--device cuda|cpu] [--history-out history.json]
    python -m tpu_unet_torch.train_cli --arch unetpp|attention|r2u|r2attu \
        [--deep-supervision] [--recur-t T] -e 5 -b 4 -s 0.5 --amp --data-dir data

``--kernels cuda`` runs the train step's convs on the hand-written kernels,
``torch`` (the default) on library convs under autograd. ``--arch`` picks
the model family; the families other than ``unet`` train on library convs
only, and ``--kernels cuda`` with one exits, as the JAX package refuses
``kernels="pallas"`` for them.
``--device-preprocess`` decodes on the host and resizes on the device (a
``RawDataset``); ``--device-dataset`` stages the preprocessed corpus on the
device (the two exclude each other); ``--augment`` (flips and photometric
jitter) and ``--augment-elastic/-rot/-scale/-shift`` (one warp) augment each
batch on the device. The device is ``cuda`` unless ``--device`` says
otherwise; with no GPU it raises. On an out-of-memory error the run starts
again once with ``remat`` (activation recomputation) from the initial
weights, as the reference falls back to checkpointing.

``--wandb`` logs to W&B (offline by default; without the ``wandb`` module
the run warns and trains on): each step's loss and, at each validation,
the scalars, a sample triplet and weight and gradient histograms.
``--profile DIR`` traces the whole run, the out-of-memory retry included,
with ``torch.profiler`` (CPU and, on a GPU, CUDA activities) and writes a
Chrome trace into ``DIR`` (``python -m tpu_unet_torch.tools.profile_step
--parse DIR`` sums it by kernel). ``--debug-nans`` raises
``FloatingPointError`` at the first op that meets a NaN
(``utils/debug_nans.py``), as JAX's ``jax_debug_nans``.

``--data-parallel`` trains over the ranks that torchrun launches, one
process per GPU on one host, with the global batch ``-b`` split over them
and the JAX package's global-batch semantics (``parallel/mesh.py``,
``train.py``): NCCL on ``cuda:LOCAL_RANK``, gloo with ``--device cpu``.
At world size 1 the group is still formed and the step is the data-parallel
one, with the plain step's numbers. Rank 0 alone writes checkpoints,
``--history-out`` and W&B. An out-of-memory error under ``--data-parallel``
is raised, not retried with ``remat``: a rank that retried alone would
leave the others waiting in the step's collectives, and torchrun stops
every rank when one fails.

    torchrun --nproc-per-node 2 -m tpu_unet_torch.train_cli --data-parallel \
        -b 8 --data-dir data [--device cpu]

``--zero`` (with ``--data-parallel``, the library route) is ZeRO-1: each
rank keeps 1/W of the optimizer state (``parallel/zero.py``); the steps
and checkpoints are the plain ``--data-parallel`` run's.

``--multihost`` trains over a world that spans hosts, one process a GPU
(``parallel/multihost.py``): torchrun across nodes, or explicit flags with
one process a host. The rendezvous comes before anything touches a
device; each process loads only its rows of each global batch.

    torchrun --nnodes 2 --node-rank R --nproc-per-node 8 --rdzv-endpoint H:P \
        -m tpu_unet_torch.train_cli --multihost --data-parallel -b 64 ...
    python -m tpu_unet_torch.train_cli --multihost --coordinator H:P \
        --num-processes 2 --process-id R --data-parallel -b 8 ...

``--deterministic`` runs with cuDNN's and torch's deterministic algorithms
(``utils/determinism.py``), so a seeded run repeats bit for bit, and logs
the ops that have no deterministic form.

The JAX flags this port does not run yet are refused with an error, never
ignored: spatial, tensor and pipeline parallelism.
``--load`` takes a ``.npz`` checkpoint or, for ``--arch unet``, the
reference's torch ``.pth`` state dict.
``--vmem-limit-mb`` (a TPU compiler option) is not a flag here.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import logging
from pathlib import Path

import numpy as np
import torch

import tpu_unet_torch.train as train_mod
from tpu_unet_torch.models.unet import ARCHS, check_kernels
from tpu_unet_torch.predict import exit_on_refusal
from tpu_unet_torch.utils.debug_nans import DebugNans
from tpu_unet_torch.utils.determinism import Deterministic

logger = logging.getLogger(__name__)

KERNELS = {"torch": None, "cuda": "cuda"}


def get_args(argv=None):
    p = argparse.ArgumentParser(description="Train the UNet on images and target masks "
                                            "(PyTorch port)")
    p.add_argument("--epochs", "-e", metavar="E", type=int, default=5, help="Number of epochs")
    p.add_argument("--batch-size", "-b", dest="batch_size", metavar="B", type=int, default=1,
                   help="Batch size")
    p.add_argument("--learning-rate", "-l", metavar="LR", type=float, default=1e-5, dest="lr",
                   help="Learning rate")
    p.add_argument("--load", "-f", type=str, default=False,
                   help="Load weights from a .npz checkpoint (either package's) or a torch "
                        ".pth state dict")
    p.add_argument("--scale", "-s", type=float, default=0.5,
                   help="Downscaling factor of the images")
    p.add_argument("--validation", "-v", dest="val", type=float, default=10.0,
                   help="Percent of the data that is used as validation (0-100)")
    p.add_argument("--amp", action="store_true", default=False,
                   help="Mixed precision (bf16 compute)")
    p.add_argument("--bilinear", action="store_true", default=False,
                   help="Use bilinear upsampling")
    p.add_argument("--classes", "-c", type=int, default=1, help="Number of classes")
    p.add_argument("--optimizer", choices=["rmsprop", "sgd", "adam", "adamw"], default="rmsprop",
                   help="Update rule: the reference's RMSprop, the legacy reference's "
                        "SGD(momentum=0.9), or Adam/AdamW")
    p.add_argument("--nesterov", action="store_true", default=False,
                   help="Nesterov momentum (--optimizer sgd only)")
    p.add_argument("--momentum", type=float, default=None,
                   help="Momentum (default 0.999 for rmsprop, 0.9 for sgd; adam/adamw "
                        "ignore it)")
    p.add_argument("--weight-decay", type=float, default=1e-8, help="Weight decay")
    p.add_argument("--dice-weight", type=float, default=1.0,
                   help="Weight of the Dice term in the loss; 0 trains on plain BCE/CE")
    p.add_argument("--lr-scheduler", choices=["plateau", "cosine", "step", "constant"],
                   default="plateau",
                   help="LR schedule: ReduceLROnPlateau on val Dice (the reference's), cosine "
                        "annealing over the run, StepLR, or constant")
    p.add_argument("--lr-step-size", type=int, default=10, metavar="E",
                   help="StepLR period in epochs")
    p.add_argument("--lr-gamma", type=float, default=0.1, help="StepLR decay factor")
    p.add_argument("--lr-min", type=float, default=0.0, help="Cosine annealing floor")
    p.add_argument("--arch", choices=ARCHS, default="unet",
                   help="Model family: unet (the reference), unetpp (nested dense skips), "
                        "attention (gated skips), r2u (recurrent residual blocks), r2attu "
                        "(both)")
    p.add_argument("--deep-supervision", action="store_true", default=False,
                   help="unetpp: average the per-column heads (the paper's accurate mode)")
    p.add_argument("--recur-t", type=int, default=2, metavar="T",
                   help="r2u/r2attu recurrence depth of each shared conv unit")
    p.add_argument("--ema-decay", type=float, default=None,
                   help="Keep an exponential moving average of the weights (e.g. 0.999), "
                        "validated beside them and saved as checkpoint_epochN_ema.npz")
    p.add_argument("--accum-steps", type=int, default=1,
                   help="Run each batch as this many microbatches with one optimizer update "
                        "(gradient accumulation); must divide --batch-size")
    p.add_argument("--checkpoint-dir", type=str, default=str(train_mod.dir_checkpoint))
    p.add_argument("--data-dir", type=str, default="./data")
    p.add_argument("--early-stopping", type=int, default=None, metavar="N",
                   help="Stop after N validations without a val Dice improvement")
    p.add_argument("--val-per-epoch", type=int, default=5, metavar="N",
                   help="Validations per epoch (the reference's 5)")
    p.add_argument("--kernels", choices=sorted(KERNELS), default="torch",
                   help="cuda: the train step's convs on the hand-written kernels (their "
                        "plain versions for CPU tensors); torch: library convs")
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cuda' raises when no GPU is present")
    p.add_argument("--cache-dataset", action="store_true", default=False,
                   help="Keep preprocessed samples in memory after their first decode")
    p.add_argument("--device-preprocess", action="store_true", default=False,
                   help="Decode on the host, resize and normalise on the device "
                        "(Pillow-bit-exact int32 resample: the host path's tensors)")
    p.add_argument("--device-dataset", action="store_true", default=False,
                   help="Stage the whole preprocessed corpus on the device as uint8 and "
                        "gather batches there (Carvana at scale 0.5 is about 12.5 GB)")
    p.add_argument("--augment", action="store_true", default=False,
                   help="Augmentation on the device: random h-flip and brightness/contrast "
                        "jitter")
    p.add_argument("--augment-elastic", type=float, default=0.0, metavar="ALPHA",
                   help="Random elastic deformation of this magnitude in pixels (images "
                        "bilinear, masks nearest); implies augmentation")
    p.add_argument("--augment-rot", type=float, default=0.0, metavar="DEG",
                   help="Random rotation up to ±DEG degrees (the same warp)")
    p.add_argument("--augment-scale", type=float, default=0.0, metavar="J",
                   help="Random isotropic scale in [1-J, 1+J]")
    p.add_argument("--augment-shift", type=float, default=0.0, metavar="PX",
                   help="Random translation up to ±PX pixels per axis")
    p.add_argument("--keep-checkpoints", type=int, default=None, metavar="N",
                   help="Keep only the newest N per-epoch checkpoints")
    p.add_argument("--save-best", action="store_true", default=False,
                   help="Also keep checkpoint_best.npz, updated whenever val Dice improves")
    p.add_argument("--history-out", type=str, default=None, metavar="PATH",
                   help="Write the training history (per-step loss, per-validation Dice/lr) "
                        "as JSON on exit")
    p.add_argument("--save-optimizer", action="store_true", default=False,
                   help="Include optimizer state in checkpoints (enables full --resume)")
    p.add_argument("--resume", type=str, default=None,
                   help="Full-state resume from a checkpoint (params, BN, optimizer, epoch)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--wandb", action="store_true", default=False,
                   help="Enable W&B logging (offline by default)")
    p.add_argument("--profile", type=str, default=None, metavar="DIR",
                   help="Write a torch.profiler Chrome trace of the whole run to this directory")
    p.add_argument("--debug-nans", action="store_true", default=False,
                   help="Raise FloatingPointError at the first op that meets a NaN")
    p.add_argument("--deterministic", action="store_true", default=False,
                   help="cuDNN's and torch's deterministic algorithms, so a seeded run "
                        "repeats bit for bit")
    p.add_argument("--data-parallel", action="store_true", default=False,
                   help="Shard the batch across the ranks that torchrun launches (one "
                        "process per GPU)")
    p.add_argument("--multihost", action="store_true", default=False,
                   help="Multi-host data parallelism: form the world before any device use "
                        "(torchrun's env across nodes, or --coordinator/--num-processes/"
                        "--process-id); one process per GPU, each loading only its rows of "
                        "every global batch; requires --data-parallel")
    p.add_argument("--coordinator", type=str, default=None, metavar="HOST:PORT",
                   help="With --multihost: the rendezvous address of rank 0's host")
    p.add_argument("--num-processes", type=int, default=None,
                   help="With --coordinator: the world size")
    p.add_argument("--process-id", type=int, default=None,
                   help="With --coordinator: this process's rank")
    p.add_argument("--zero", action="store_true", default=False,
                   help="With --data-parallel: ZeRO-1, each rank keeps 1/N of the fp32 "
                        "optimizer state instead of all of it (about 248 MB at 31M params "
                        "for RMSprop); one all-gather of the updated params a step, the same "
                        "steps and checkpoints")
    # The JAX package's flags that the port refuses (refuse_unported).
    for flag in ("--spatial-parallel", "--tensor-parallel", "--pipeline-parallel"):
        p.add_argument(flag, type=int, default=1, help=argparse.SUPPRESS)
    return p.parse_args(argv)


def refuse_unported(args: argparse.Namespace) -> None:
    """Exit with a clear message when a flag the port lacks was given."""
    asked = {
        "--spatial-parallel": args.spatial_parallel > 1,
        "--tensor-parallel": args.tensor_parallel > 1,
        "--pipeline-parallel": args.pipeline_parallel > 1,
    }
    for flag, given in asked.items():
        if given:
            raise SystemExit(f"tpu_unet_torch.train_cli: {flag} is not ported to tpu_unet_torch "
                             "yet; use the JAX package (tpu_unet) for it")


def check_flags(args: argparse.Namespace) -> None:
    """The flag compositions that ``train_model`` refuses, refused before the
    rendezvous and the dataset (a ``SystemExit`` with the same message), and
    the rendezvous flags without ``--multihost``."""
    from tpu_unet_torch.parallel.multihost import spans_hosts

    given = [f for f, v in (("--coordinator", args.coordinator),
                            ("--num-processes", args.num_processes),
                            ("--process-id", args.process_id)) if v is not None]
    if given and not args.multihost:
        raise SystemExit(f"tpu_unet_torch.train_cli: {given[0]} applies with --multihost")
    try:
        train_mod._check_train_flags(
            accum_steps=args.accum_steps, batch_size=args.batch_size,
            early_stopping=args.early_stopping, kernels=KERNELS[args.kernels], zero=args.zero,
            data_parallel=args.data_parallel,
            multihost=args.multihost and spans_hosts(args.num_processes),
            device_preprocess=args.device_preprocess)
    except ValueError as e:
        raise SystemExit(f"tpu_unet_torch.train_cli: {e}") from None


def _profiler(trace_dir: str):
    """``torch.profiler`` over CPU ops and, with a GPU, CUDA kernels; on
    exit it writes a Chrome trace (``<host>_<pid>.<time>.pt.trace.json``)
    into ``trace_dir``."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    return profile(activities=activities, on_trace_ready=tensorboard_trace_handler(trace_dir))


def _build_augment(args: argparse.Namespace):
    """The ``AugmentConfig`` of the flags (the JAX CLI's): ``--augment``
    turns on the h-flip and 0.1 brightness and contrast jitter; any warp
    flag alone augments too. None when no flag asks for it."""
    from tpu_unet_torch.data.augment import AugmentConfig

    if not (args.augment or args.augment_elastic or args.augment_rot or args.augment_scale
            or args.augment_shift):
        return None
    jitter = 0.1 if args.augment else 0.0
    return AugmentConfig(hflip=args.augment, brightness=jitter, contrast=jitter,
                         elastic_alpha=args.augment_elastic, rot_deg=args.augment_rot,
                         scale_jitter=args.augment_scale, shift_px=args.augment_shift)


@exit_on_refusal("tpu_unet_torch.train_cli")
def main(argv=None):
    from tpu_unet_torch.parallel import multihost
    from tpu_unet_torch.parallel.mesh import DataParallelRefused, cli_data_parallel

    args = get_args(argv)
    refuse_unported(args)
    check_flags(args)
    logging.basicConfig(level=logging.INFO, format="%(levelname)s: %(message)s")
    formed = False
    if args.multihost and not torch.distributed.is_initialized():
        # The rendezvous, before anything touches a device.
        try:
            multihost.initialize(args.coordinator, args.num_processes, args.process_id,
                                 device=None if args.device == "cuda" else args.device)
        except DataParallelRefused as e:
            raise SystemExit(f"tpu_unet_torch.train_cli: {e}") from None
        formed = True
    dp = None
    try:
        if args.data_parallel:
            dp, formed_here = cli_data_parallel(args.device, "tpu_unet_torch.train_cli")
            formed = formed or formed_here
        return _train(args, dp)
    finally:
        if formed:
            torch.distributed.destroy_process_group()


def _train(args: argparse.Namespace, dp):
    from tpu_unet_torch.checkpoint import import_pth, load_checkpoint
    from tpu_unet_torch.data import BasicDataset, CarvanaDataset, RawCarvanaDataset, RawDataset
    from tpu_unet_torch.models.unet import UNetConfig, init_unet, param_count, tree_map
    from tpu_unet_torch.predict import resolve_device

    device = resolve_device(args.device if dp is None else dp.device)
    config = UNetConfig(n_channels=3, n_classes=args.classes, bilinear=args.bilinear,
                        arch=args.arch, deep_supervision=args.deep_supervision,
                        recur_t=args.recur_t)
    check_kernels(config, KERNELS[args.kernels])
    logger.info("Network:\n\t%d input channels\n\t%d output channels (classes)\n\t%s upscaling",
                config.n_channels, config.n_classes,
                "Bilinear" if config.bilinear else "Transposed conv")
    params, bn_state = init_unet(config, np.random.default_rng(args.seed))
    logger.info("Model parameters: %.1fM", param_count(params) / 1e6)
    if args.load:
        if str(args.load).endswith(".pth"):
            params, bn_state, _ = import_pth(args.load, config)
        else:
            params, bn_state, _, _ = load_checkpoint(args.load, config)
        logger.info("Model loaded from %s", args.load)

    data_dir = Path(args.data_dir)
    if args.device_preprocess:  # decode only: the device resizes
        kinds, kw = (RawCarvanaDataset, RawDataset), {}
    else:
        kinds, kw = (CarvanaDataset, BasicDataset), {"cache": args.cache_dataset}
    try:
        dataset = kinds[0](data_dir / "imgs", data_dir / "masks", args.scale, **kw)
    except (RuntimeError, IndexError):
        dataset = kinds[1](data_dir / "imgs", data_dir / "masks", args.scale, **kw)

    def run(remat: bool):
        # Fresh device trees from the host copies: a retry starts from the
        # initial weights. train_model is looked up on its module at call
        # time, so a test can replace it there.
        return train_mod.train_model(
            tree_map(lambda t: t.to(device, copy=True), params),
            tree_map(lambda t: t.to(device, copy=True), bn_state), config,
            dataset=dataset, epochs=args.epochs, batch_size=args.batch_size,
            learning_rate=args.lr, val_percent=args.val / 100, amp=args.amp,
            optimizer=args.optimizer, nesterov=args.nesterov, momentum=args.momentum,
            weight_decay=args.weight_decay, dice_weight=args.dice_weight,
            lr_scheduler=args.lr_scheduler, lr_step_size=args.lr_step_size,
            lr_gamma=args.lr_gamma, lr_min=args.lr_min, remat=remat,
            checkpoint_dir=Path(args.checkpoint_dir), seed=args.seed,
            save_optimizer=args.save_optimizer, resume=args.resume,
            kernels=KERNELS[args.kernels], accum_steps=args.accum_steps,
            ema_decay=args.ema_decay, val_per_epoch=args.val_per_epoch,
            early_stopping=args.early_stopping, keep_checkpoints=args.keep_checkpoints,
            save_best=args.save_best, device_preprocess=args.device_preprocess,
            device_dataset=args.device_dataset, augment=_build_augment(args),
            use_wandb=args.wandb, data_parallel=dp, zero=args.zero)

    with contextlib.ExitStack() as stack:
        if args.profile:
            stack.enter_context(_profiler(args.profile))
        if args.debug_nans:
            stack.enter_context(DebugNans())
        det = stack.enter_context(Deterministic()) if args.deterministic else None
        try:
            result = run(remat=False)
        except torch.cuda.OutOfMemoryError:
            if dp is not None:
                logger.error("Out of memory under --data-parallel: not retried with remat "
                             "(the other ranks wait in the step's collectives). Reduce "
                             "--batch-size or --scale.")
                raise
            logger.error("Detected OOM! Enabling activation checkpointing (remat) and retrying. "
                         "Consider reducing --batch-size or --scale.")
            if torch.cuda.is_available():
                torch.cuda.empty_cache()
            result = run(remat=True)
    if det is not None:
        logger.info("Deterministic algorithms; ops without a deterministic form: %s",
                    det.reasons or "none")
    if args.profile:
        logger.info("Profiler trace written to %s", args.profile)
    if args.history_out and (dp is None or dp.primary):
        Path(args.history_out).write_text(json.dumps(result[2]))
        logger.info("Training history written to %s", args.history_out)
    return result


if __name__ == "__main__":
    main()
