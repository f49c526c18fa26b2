"""Validation with the reference's metric (``tpu_unet/evaluate.py``).

Binary (one class): (sigmoid(logit) > 0.5) against the float mask, Dice per
image averaged over the batch. Multiclass: one_hot(argmax) against
one_hot(mask), both without the background channel 0. The score is the mean
over the loader's batches (0 for an empty loader). The forward is
``unet_apply(train=False)`` without kernels, as JAX's ``eval_step`` runs
it. The per-batch sums stay on the device; the host fetches them once.

Run:
    python -m tpu_unet_torch.evaluate -m ckpt.npz --data-dir data -s 0.5 \
        [--per-class] [--amp] [--device cuda|cpu]
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
from tpu_unet_torch.models.unet import UNetConfig, tree_leaves, unet_apply

logger = logging.getLogger(__name__)


def _logits(params, state, images, config, amp):
    with torch.no_grad():
        logits, _ = unet_apply(params, state, images, config=config, train=False,
                               compute_dtype=torch.bfloat16 if amp else None)
    return logits


def eval_step(params, state, images, masks, *, config: UNetConfig, amp: bool = False):
    """(Dice, IoU) of one batch as device scalars. images NHWC, masks NHW."""
    logits = _logits(params, state, images, config, amp)
    if config.n_classes == 1:
        pred = (torch.sigmoid(logits[..., 0]) > 0.5).float()
        tgt = masks.float()
        return dice_coeff(pred, tgt, reduce_batch_first=False), iou_coeff(pred, tgt)
    pred_oh = F.one_hot(logits.argmax(dim=-1), config.n_classes).float()[..., 1:]
    mask_oh = F.one_hot(masks.long(), config.n_classes).float()[..., 1:]
    return (multiclass_dice_coeff(pred_oh, mask_oh, reduce_batch_first=False),
            iou_coeff(pred_oh, mask_oh))


def eval_step_per_class(params, state, images, masks, *, config: UNetConfig, amp: bool = False):
    """Per-class (Dice [C], IoU [C]) of one batch, each the batch mean of the
    per-image ratio; the mean over classes 1.. of Dice is ``eval_step``'s."""
    logits = _logits(params, state, images, config, amp)
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


def _accumulate(step, params, state, dataloader, config, amp):
    """(sum of stack(step outputs) over the batches, batch count)."""
    device = tree_leaves(params)[0].device
    total, n = None, 0
    for batch in dataloader:
        b = to_device(batch, device)
        pair = torch.stack(step(params, state, b["image"], b["mask"], config=config, amp=amp))
        total = pair if total is None else total + pair
        n += 1
    return total, n


def evaluate(params, state, dataloader, config: UNetConfig,
             amp: bool = False) -> tuple[float, float]:
    """Mean (Dice, IoU) over the loader's batches, on the params' device."""
    total, n = _accumulate(eval_step, params, state, dataloader, config, amp)
    if total is None:
        return 0.0, 0.0
    dice, iou = total.cpu().tolist()
    return dice / n, iou / n


def evaluate_per_class(params, state, dataloader, config: UNetConfig,
                       amp: bool = False) -> tuple[np.ndarray, np.ndarray]:
    """Per-class mean (Dice [C], IoU [C]) over the loader's batches."""
    total, n = _accumulate(eval_step_per_class, params, state, dataloader, config, amp)
    if total is None:
        z = np.zeros(config.n_classes)
        return z, z
    dice_c, iou_c = total.cpu().double().numpy()
    return dice_c / n, iou_c / n


def main(argv=None) -> float:
    """The evaluation CLI: Dice and IoU of a checkpoint on a dataset."""
    from tpu_unet_torch.data import BasicDataset, CarvanaDataset, DataLoader
    from tpu_unet_torch.predict import load_model, resolve_device

    p = argparse.ArgumentParser(description="Evaluate a checkpoint on a dataset (PyTorch port)")
    p.add_argument("--model", "-m", required=True)
    p.add_argument("--data-dir", type=str, default="./data")
    p.add_argument("--scale", "-s", type=float, default=0.5)
    p.add_argument("--batch-size", "-b", type=int, default=4)
    p.add_argument("--classes", "-c", type=int, default=1)
    p.add_argument("--bilinear", action="store_true")
    p.add_argument("--arch", choices=["unet", "unetpp", "attention", "r2u", "r2attu"],
                   default="unet")
    p.add_argument("--amp", action="store_true")
    p.add_argument("--per-class", action="store_true", default=False,
                   help="Also report per-class Dice/IoU (multiclass: class 0 is background, "
                        "excluded from the mean)")
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cuda' raises when no GPU is present")
    p.add_argument("--data-parallel", action="store_true", help=argparse.SUPPRESS)
    p.add_argument("--tta", action="store_true", help=argparse.SUPPRESS)
    p.add_argument("--tta-mode", default=None, help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    for flag, given in (("--data-parallel", args.data_parallel), ("--tta", args.tta),
                        ("--tta-mode", args.tta_mode is not None),
                        (f"--arch {args.arch}", args.arch != "unet")):
        if given:
            raise SystemExit(f"tpu_unet_torch.evaluate: {flag} is not ported to tpu_unet_torch "
                             "yet; use the JAX package (tpu_unet) for it")
    logging.basicConfig(level=logging.INFO, format="%(levelname)s: %(message)s")
    device = resolve_device(args.device)
    config = UNetConfig(3, args.classes, bilinear=args.bilinear)
    params, state, config, _ = load_model(args.model, config, device)
    data_dir = Path(args.data_dir)
    try:
        ds = CarvanaDataset(data_dir / "imgs", data_dir / "masks", args.scale)
    except (RuntimeError, IndexError):
        ds = BasicDataset(data_dir / "imgs", data_dir / "masks", args.scale)
    loader = DataLoader(ds, args.batch_size)
    if args.per_class:
        # One sweep: the scalars are the background-excluded means of the
        # per-class vectors.
        dice_c, iou_c = evaluate_per_class(params, state, loader, config, amp=args.amp)
        fg = slice(1, None) if config.n_classes > 1 else slice(None)
        dice = float(dice_c[fg].mean()) if len(dice_c) else 0.0
        iou = float(iou_c[fg].mean()) if len(iou_c) else 0.0
        print(f"Dice: {dice:.6f}  IoU: {iou:.6f}  (n={len(ds)})")
        for c in range(config.n_classes):
            tag = " (background)" if config.n_classes > 1 and c == 0 else ""
            print(f"  class {c}: Dice {dice_c[c]:.6f}  IoU {iou_c[c]:.6f}{tag}")
    else:
        dice, iou = evaluate(params, state, loader, config, amp=args.amp)
        print(f"Dice: {dice:.6f}  IoU: {iou:.6f}  (n={len(ds)})")
    return dice


if __name__ == "__main__":
    main()
