"""The train CLI (``tpu_unet/train_cli.py``): the reference's flags and the
JAX package's additions, over ``train.train_model``.

Run:
    python -m tpu_unet_torch.train_cli -e 5 -b 4 -s 0.5 --amp --kernels cuda \
        --data-dir data [--device cuda|cpu] [--history-out history.json]

``--kernels cuda`` runs the train step's convs on the hand-written kernels,
``torch`` (the default) on library convs under autograd.
``--device-preprocess`` decodes on the host and resizes on the device (a
``RawDataset``); ``--device-dataset`` stages the preprocessed corpus on the
device (the two exclude each other); ``--augment`` (flips and photometric
jitter) and ``--augment-elastic/-rot/-scale/-shift`` (one warp) augment each
batch on the device. The device is ``cuda`` unless ``--device`` says
otherwise; with no GPU it raises. On an out-of-memory error the run starts
again once with ``remat`` (activation recomputation) from the initial
weights, as the reference falls back to checkpointing.

The JAX flags this port does not run yet are refused with an error, never
ignored: data parallelism and multi-host, ZeRO, W&B, the profiler,
``--debug-nans``, and the other model families and deep supervision.
``--load`` takes a ``.npz`` checkpoint or the reference's torch ``.pth``
state dict.
``--vmem-limit-mb`` (a TPU compiler option) is not a flag here.
"""

from __future__ import annotations

import argparse
import json
import logging
from pathlib import Path

import numpy as np
import torch

import tpu_unet_torch.train as train_mod

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
    p.add_argument("--arch", choices=["unet", "unetpp", "attention", "r2u", "r2attu"],
                   default="unet", help="Model family (the port runs unet)")
    p.add_argument("--recur-t", type=int, default=2, metavar="T",
                   help="r2u/r2attu recurrence depth (carried in the config)")
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
    # The JAX package's flags that the port refuses (refuse_unported).
    for flag in ("--data-parallel", "--multihost", "--zero", "--wandb", "--debug-nans",
                 "--deep-supervision"):
        p.add_argument(flag, action="store_true", default=False, help=argparse.SUPPRESS)
    for flag in ("--coordinator", "--profile"):
        p.add_argument(flag, type=str, default=None, help=argparse.SUPPRESS)
    for flag in ("--num-processes", "--process-id"):
        p.add_argument(flag, type=int, default=None, help=argparse.SUPPRESS)
    for flag in ("--spatial-parallel", "--tensor-parallel", "--pipeline-parallel"):
        p.add_argument(flag, type=int, default=1, help=argparse.SUPPRESS)
    return p.parse_args(argv)


def refuse_unported(args: argparse.Namespace) -> None:
    """Exit with a clear message when a flag the port lacks was given."""
    asked = {
        "--data-parallel": args.data_parallel, "--multihost": args.multihost,
        "--coordinator": args.coordinator is not None,
        "--num-processes": args.num_processes is not None,
        "--process-id": args.process_id is not None,
        "--spatial-parallel": args.spatial_parallel > 1,
        "--tensor-parallel": args.tensor_parallel > 1,
        "--pipeline-parallel": args.pipeline_parallel > 1, "--zero": args.zero,
        "--wandb": args.wandb,
        "--profile": args.profile is not None, "--debug-nans": args.debug_nans,
        f"--arch {args.arch}": args.arch != "unet", "--deep-supervision": args.deep_supervision,
    }
    for flag, given in asked.items():
        if given:
            raise SystemExit(f"tpu_unet_torch.train_cli: {flag} is not ported to tpu_unet_torch "
                             "yet; use the JAX package (tpu_unet) for it")


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


def main(argv=None):
    from tpu_unet_torch.checkpoint import import_pth, load_checkpoint
    from tpu_unet_torch.data import BasicDataset, CarvanaDataset, RawCarvanaDataset, RawDataset
    from tpu_unet_torch.models.unet import UNetConfig, init_unet, param_count, tree_map
    from tpu_unet_torch.predict import resolve_device

    args = get_args(argv)
    refuse_unported(args)
    logging.basicConfig(level=logging.INFO, format="%(levelname)s: %(message)s")
    device = resolve_device(args.device)
    config = UNetConfig(n_channels=3, n_classes=args.classes, bilinear=args.bilinear,
                        arch=args.arch, recur_t=args.recur_t)
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
            device_dataset=args.device_dataset, augment=_build_augment(args))

    try:
        result = run(remat=False)
    except torch.cuda.OutOfMemoryError:
        logger.error("Detected OOM! Enabling activation checkpointing (remat) and retrying. "
                     "Consider reducing --batch-size or --scale.")
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
        result = run(remat=True)
    if args.history_out:
        Path(args.history_out).write_text(json.dumps(result[2]))
        logger.info("Training history written to %s", args.history_out)
    return result


if __name__ == "__main__":
    main()
