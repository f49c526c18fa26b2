"""Validation with the reference's metric (``tpu_unet/evaluate.py``).

Binary (one class): (sigmoid(logit) > 0.5) against the float mask, Dice per
image averaged over the batch. Multiclass: one_hot(argmax) against
one_hot(mask), both without the background channel 0. The score is the mean
over the loader's batches (0 for an empty loader). The forward is
``unet_apply(train=False)`` without kernels, as JAX's ``eval_step`` runs
it; ``tta`` ensembles the flip views one view at a time
(``tta_logits(batched=False)``), so an evaluation batch's activations are
not multiplied by the views. The per-batch sums stay on the device; the
host fetches them once.

Every model family evaluates through the same forward (``--arch``, or the
family a ``.npz`` stores in its config).

Data parallelism (``mesh``, a ``parallel.mesh.DataParallel`` record; JAX's
``sharding``): a batch that the world size divides is split over the ranks
(each its contiguous rows) and its (Dice, IoU) averaged over them, which is
the global batch's value: both are means of per-image ratios over equal
shards (``iou_coeff`` is per image, not one batch-wide ratio). A batch the
world size does not divide runs whole on every rank. A batch that carries
``"shard"`` (a sharded ``data.prefetch.DataLoader``'s, as multi-host
validation feeds) holds this rank's rows of a global batch already, and is
averaged as a split one. Every rank
returns the same numbers.

Run:
    python -m tpu_unet_torch.evaluate -m ckpt.npz|model.pth --data-dir data -s 0.5 \
        [--arch unetpp|attention|r2u|r2attu] [--per-class] [--tta [--tta-mode hflip]] \
        [--amp] [--device cuda|cpu]
    torchrun --nproc-per-node N -m tpu_unet_torch.evaluate --data-parallel -m ckpt.npz ...
"""

from __future__ import annotations

import argparse
import logging
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from tpu_unet_torch.data.prefetch import to_device
from tpu_unet_torch.losses import dice_coeff, iou_coeff, multiclass_dice_coeff
from tpu_unet_torch.models.tta import TTA_MODES, tta_logits
from tpu_unet_torch.predict import exit_on_refusal
from tpu_unet_torch.models.unet import UNetConfig, tree_leaves, unet_apply
from tpu_unet_torch.parallel.mesh import DataParallel, pmean

logger = logging.getLogger(__name__)


def _logits(params, state, images, config, amp, tta, tta_mode):
    compute_dtype = torch.bfloat16 if amp else None
    with torch.no_grad():
        if tta:
            return tta_logits(params, state, images, config=config,
                              compute_dtype=compute_dtype, mode=tta_mode, batched=False)
        logits, _ = unet_apply(params, state, images, config=config, train=False,
                               compute_dtype=compute_dtype)
    return logits


def eval_step(params, state, images, masks, *, config: UNetConfig, amp: bool = False,
              tta: bool = False, tta_mode: str = "flips"):
    """(Dice, IoU) of one batch as device scalars. images NHWC, masks NHW."""
    logits = _logits(params, state, images, config, amp, tta, tta_mode)
    if config.n_classes == 1:
        pred = (torch.sigmoid(logits[..., 0]) > 0.5).float()
        tgt = masks.float()
        return dice_coeff(pred, tgt, reduce_batch_first=False), iou_coeff(pred, tgt)
    pred_oh = F.one_hot(logits.argmax(dim=-1), config.n_classes).float()[..., 1:]
    mask_oh = F.one_hot(masks.long(), config.n_classes).float()[..., 1:]
    return (multiclass_dice_coeff(pred_oh, mask_oh, reduce_batch_first=False),
            iou_coeff(pred_oh, mask_oh))


def eval_step_per_class(params, state, images, masks, *, config: UNetConfig,
                        amp: bool = False, tta: bool = False, tta_mode: str = "flips"):
    """Per-class (Dice [C], IoU [C]) of one batch, each the batch mean of the
    per-image ratio; the mean over classes 1.. of Dice is ``eval_step``'s."""
    logits = _logits(params, state, images, config, amp, tta, tta_mode)
    if config.n_classes == 1:
        pred_oh = (torch.sigmoid(logits[..., :1]) > 0.5).float()
        mask_oh = masks.float()[..., None]
    else:
        pred_oh = F.one_hot(logits.argmax(dim=-1), config.n_classes).float()
        mask_oh = F.one_hot(masks.long(), config.n_classes).float()
    eps = 1e-6
    inter = (pred_oh * mask_oh).sum((1, 2))  # [N, C]
    s_pred = pred_oh.sum((1, 2))
    s_mask = mask_oh.sum((1, 2))
    sets = s_pred + s_mask
    sets = torch.where(sets == 0, 2 * inter, sets)  # two empty masks score 1
    dice_c = ((2 * inter + eps) / (sets + eps)).mean(0)
    union = s_pred + s_mask - inter
    union = torch.where(union == 0, inter, union)
    iou_c = ((inter + eps) / (union + eps)).mean(0)
    return dice_c, iou_c


def _shardable(mesh: DataParallel | None, batch) -> bool:
    """True when the batch splits evenly over the data-parallel ranks (JAX's
    ``_shardable`` on a 1-D mesh)."""
    return mesh is not None and batch["image"].shape[0] % mesh.world_size == 0


def _accumulate(step, params, state, dataloader, config, amp, tta, tta_mode, mesh):
    """(sum of stack(step outputs) over the batches, batch count)."""
    device = tree_leaves(params)[0].device
    total, n = None, 0
    for batch in dataloader:
        split = batch.get("shard") is not None
        if split and mesh is None:
            raise ValueError("a batch of one rank's rows (\"shard\") needs the mesh its "
                             "ranks form")
        if not split and _shardable(mesh, batch):
            split = True
            batch = {k: mesh.rows(batch[k]) for k in ("image", "mask")}
        b = to_device(batch, device)
        pair = torch.stack(step(params, state, b["image"], b["mask"], config=config, amp=amp,
                                tta=tta, tta_mode=tta_mode))
        if split:
            pair, = pmean([pair], mesh.group)
        total = pair if total is None else total + pair
        n += 1
    return total, n


def evaluate(params, state, dataloader, config: UNetConfig, amp: bool = False,
             tta: bool = False, tta_mode: str = "flips",
             mesh: DataParallel | None = None) -> tuple[float, float]:
    """Mean (Dice, IoU) over the loader's batches, on the params' device;
    each batch split over the ranks of ``mesh`` where it divides."""
    total, n = _accumulate(eval_step, params, state, dataloader, config, amp, tta, tta_mode,
                           mesh)
    if total is None:
        return 0.0, 0.0
    dice, iou = total.cpu().tolist()
    return dice / n, iou / n


def evaluate_per_class(params, state, dataloader, config: UNetConfig, amp: bool = False,
                       tta: bool = False, tta_mode: str = "flips",
                       mesh: DataParallel | None = None) -> tuple[np.ndarray, np.ndarray]:
    """Per-class mean (Dice [C], IoU [C]) over the loader's batches (split
    over the ranks of ``mesh`` as ``evaluate`` splits them)."""
    total, n = _accumulate(eval_step_per_class, params, state, dataloader, config, amp, tta,
                           tta_mode, mesh)
    if total is None:
        z = np.zeros(config.n_classes)
        return z, z
    dice_c, iou_c = total.cpu().double().numpy()
    return dice_c / n, iou_c / n


@exit_on_refusal("tpu_unet_torch.evaluate")
def main(argv=None) -> float:
    """The evaluation CLI: Dice and IoU of a checkpoint on a dataset."""
    from tpu_unet_torch.models.unet import ARCHS
    from tpu_unet_torch.parallel.mesh import cli_data_parallel
    from tpu_unet_torch.predict import resolve_device

    p = argparse.ArgumentParser(description="Evaluate a checkpoint on a dataset (PyTorch port)")
    p.add_argument("--model", "-m", required=True)
    p.add_argument("--data-dir", type=str, default="./data")
    p.add_argument("--scale", "-s", type=float, default=0.5)
    p.add_argument("--batch-size", "-b", type=int, default=4)
    p.add_argument("--classes", "-c", type=int, default=1)
    p.add_argument("--bilinear", action="store_true")
    p.add_argument("--arch", choices=ARCHS, default="unet",
                   help="Model family of the checkpoint (a .npz's stored config wins)")
    p.add_argument("--amp", action="store_true")
    p.add_argument("--per-class", action="store_true", default=False,
                   help="Also report per-class Dice/IoU (multiclass: class 0 is background, "
                        "excluded from the mean)")
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cuda' raises when no GPU is present")
    p.add_argument("--tta", action="store_true", default=False,
                   help="Flip-ensemble test-time augmentation (one view at a time)")
    p.add_argument("--tta-mode", choices=tuple(TTA_MODES), default="flips",
                   help="TTA views: all four flips, or identity + left-right only")
    p.add_argument("--data-parallel", action="store_true", default=False,
                   help="Split each eval batch over the ranks that torchrun launches (one "
                        "process per GPU; batches that don't divide run whole on each)")
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(levelname)s: %(message)s")
    mesh, formed = None, False
    if args.data_parallel:
        mesh, formed = cli_data_parallel(args.device, "tpu_unet_torch.evaluate")
    device = resolve_device(args.device if mesh is None else mesh.device)
    try:
        return _evaluate_cli(args, device, mesh)
    finally:
        if formed:
            torch.distributed.destroy_process_group()


def _evaluate_cli(args, device, mesh) -> float:
    from tpu_unet_torch.data import BasicDataset, CarvanaDataset, DataLoader
    from tpu_unet_torch.predict import load_model

    config = UNetConfig(3, args.classes, bilinear=args.bilinear, arch=args.arch)
    params, state, config, _ = load_model(args.model, config, device)
    data_dir = Path(args.data_dir)
    try:
        ds = CarvanaDataset(data_dir / "imgs", data_dir / "masks", args.scale)
    except (RuntimeError, IndexError):
        ds = BasicDataset(data_dir / "imgs", data_dir / "masks", args.scale)
    loader = DataLoader(ds, args.batch_size)
    show = mesh is None or mesh.primary
    if args.per_class:
        # One sweep: the scalars are the background-excluded means of the
        # per-class vectors.
        dice_c, iou_c = evaluate_per_class(params, state, loader, config, amp=args.amp,
                                           tta=args.tta, tta_mode=args.tta_mode, mesh=mesh)
        fg = slice(1, None) if config.n_classes > 1 else slice(None)
        dice = float(dice_c[fg].mean()) if len(dice_c) else 0.0
        iou = float(iou_c[fg].mean()) if len(iou_c) else 0.0
        if show:
            print(f"Dice: {dice:.6f}  IoU: {iou:.6f}  (n={len(ds)})")
            for c in range(config.n_classes):
                tag = " (background)" if config.n_classes > 1 and c == 0 else ""
                print(f"  class {c}: Dice {dice_c[c]:.6f}  IoU {iou_c[c]:.6f}{tag}")
    else:
        dice, iou = evaluate(params, state, loader, config, amp=args.amp, tta=args.tta,
                             tta_mode=args.tta_mode, mesh=mesh)
        if show:
            print(f"Dice: {dice:.6f}  IoU: {iou:.6f}  (n={len(ds)})")
    return dice


if __name__ == "__main__":
    main()
