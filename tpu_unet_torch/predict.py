"""Predict masks (``tpu_unet/predict.py``): by default through the unfolded
eval-mode forward (``predict_img``, the reference's path without
``--kernels``), with ``--kernels cuda|torch`` through the folded-BN forward
(``predict_img_fused``).

The reference order is kept: preprocess -> forward -> bilinear (half-pixel)
upscale of the LOGITS to the original resolution -> threshold (sigmoid >
t) or argmax -> the checkpoint's ``mask_values`` palette.

Run:
    python -m tpu_unet_torch.predict -m ckpt.npz -i img.png -o mask.png \
        [--kernels cuda|torch] [--device cuda|cpu] [--amp]
"""

from __future__ import annotations

import argparse
import logging
import os
from pathlib import Path

import numpy as np
import torch
from PIL import Image

from tpu_unet_torch.data.loading import preprocess
from tpu_unet_torch.models import UNetConfig, fold_bn, unet_infer_apply
from tpu_unet_torch.models.infer import BACKENDS
from tpu_unet_torch.models.unet import tree_map, unet_apply
from tpu_unet_torch.ops import full_fp32, resize_bilinear

logger = logging.getLogger(__name__)

# Flags of the JAX CLIs that this port does not run yet.
UNPORTED_FLAGS = ("tile", "tta", "crf", "batch_size", "device_preprocess")


def resolve_device(name: str | torch.device) -> torch.device:
    """The requested device; a CUDA device must exist (no CPU fallback). On a
    CUDA device float32 convolutions are made full fp32 (no TF32)."""
    device = torch.device(name)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device} requested but no CUDA device is available "
                               "(pass --device cpu to run on the CPU)")
        full_fp32()
    return device


def refuse_unported(args: argparse.Namespace, prog: str) -> None:
    """Exit with a clear message when a flag the port lacks was given."""
    for name in UNPORTED_FLAGS:
        if getattr(args, name, None):
            flag = "--" + name.replace("_", "-")
            raise SystemExit(f"{prog}: {flag} is not ported to tpu_unet_torch yet; "
                             f"use the JAX package (tpu_unet) for it")


def logits_to_mask(logits: torch.Tensor, n_classes: int, threshold: float) -> np.ndarray:
    """[..., H, W, C] fp32 logits (already upscaled) -> class-index mask."""
    if n_classes > 1:
        return logits.argmax(dim=-1).cpu().numpy()
    return (torch.sigmoid(logits[..., 0]) > threshold).cpu().numpy()


def predict_img(params, state, config: UNetConfig, full_img: Image.Image, *,
                scale_factor: float = 0.5, out_threshold: float = 0.5, amp: bool = False,
                device: str | torch.device = "cuda") -> np.ndarray:
    """The mask of one PIL image at its original resolution, through the
    unfolded eval-mode forward (``unet_apply(train=False)``, library convs
    and BN): ``tpu_unet/predict.py:68 predict_img`` without its CRF, TTA and
    device-preprocess options. ``params``/``state`` may live on any device;
    they are moved to ``device``."""
    device = resolve_device(device)
    x = torch.from_numpy(preprocess(full_img, scale_factor))[None].to(device)
    full_w, full_h = full_img.size
    with torch.inference_mode():
        params, state = (tree_map(lambda t: t.to(device), tree) for tree in (params, state))
        logits, _ = unet_apply(params, state, x, config=config, train=False,
                               compute_dtype=torch.bfloat16 if amp else None)
        logits = resize_bilinear(logits, full_h, full_w, align_corners=False)
        return logits_to_mask(logits[0], config.n_classes, out_threshold)


def predict_img_fused(params, state, config: UNetConfig, full_img: Image.Image, *,
                      backend: str = "cuda", scale_factor: float = 0.5,
                      out_threshold: float = 0.5, amp: bool = False,
                      device: str | torch.device = "cuda") -> np.ndarray:
    """The mask of one PIL image at its original resolution, through the
    folded-BN forward (``models/infer.py``). ``params``/``state`` may live
    on any device; they are moved to ``device``."""
    device = resolve_device(device)
    x = torch.from_numpy(preprocess(full_img, scale_factor))[None].to(device)
    folded = fold_bn(params, state, config)
    full_w, full_h = full_img.size
    with torch.inference_mode():
        folded = tree_map(lambda t: t.to(device), folded)
        logits = unet_infer_apply(folded, x, config=config, backend=backend,
                                  compute_dtype=torch.bfloat16 if amp else None)
        logits = resize_bilinear(logits, full_h, full_w, align_corners=False)
        return logits_to_mask(logits[0], config.n_classes, out_threshold)


def mask_to_image(mask: np.ndarray, mask_values) -> Image.Image:
    """Map class indices back through the stored palette (reference parity)."""
    if isinstance(mask_values[0], list):
        out = np.zeros((mask.shape[-2], mask.shape[-1], len(mask_values[0])), dtype=np.uint8)
    elif mask_values == [0, 1]:
        out = np.zeros((mask.shape[-2], mask.shape[-1]), dtype=bool)
    else:
        out = np.zeros((mask.shape[-2], mask.shape[-1]), dtype=np.uint8)
    if mask.ndim == 3:  # one-hot [C,H,W] -> indices
        mask = np.argmax(mask, axis=0)
    for i, v in enumerate(mask_values):
        out[mask == i] = v
    return Image.fromarray(out)


def load_model(path: str | Path, config: UNetConfig, device: torch.device):
    """(params, state, config, mask_values) from a ``.npz`` checkpoint; its
    stored config, when present, wins over ``config``. A stored config
    without ``recur_bn`` predates the per-step layout, so its arrays are in
    the shared layout: it loads as ``recur_bn="shared"``."""
    from tpu_unet_torch.checkpoint import load_checkpoint, read_checkpoint_meta

    if not str(path).endswith(".npz"):
        raise SystemExit(f"{path}: tpu_unet_torch loads .npz checkpoints only "
                         "(.pth import and .jaxexp artifacts are not ported yet)")
    _, extra = read_checkpoint_meta(path)
    if "config" in extra:
        config = UNetConfig(**{"recur_bn": "shared", **extra["config"]})
    params, state, mask_values, _ = load_checkpoint(path, config, device)
    if mask_values is None:
        mask_values = [0, 1] if config.n_classes == 1 else list(range(config.n_classes))
    return params, state, config, mask_values


def get_args(argv=None):
    p = argparse.ArgumentParser(description="Predict masks from input images (PyTorch port)")
    p.add_argument("--model", "-m", default="MODEL.npz", metavar="FILE",
                   help="The .npz checkpoint (the JAX package's format)")
    p.add_argument("--input", "-i", metavar="INPUT", nargs="+", required=True,
                   help="Filenames of input images")
    p.add_argument("--output", "-o", metavar="OUTPUT", nargs="+",
                   help="Filenames of output images")
    p.add_argument("--no-save", "-n", action="store_true", help="Do not save the output masks")
    p.add_argument("--mask-threshold", "-t", type=float, default=0.5,
                   help="Minimum probability value to consider a mask pixel white")
    p.add_argument("--scale", "-s", type=float, default=0.5,
                   help="Scale factor for the input images")
    p.add_argument("--bilinear", action="store_true", default=False,
                   help="Use bilinear upsampling")
    p.add_argument("--classes", "-c", type=int, default=1, help="Number of classes")
    p.add_argument("--amp", action="store_true", default=False, help="bf16 inference")
    p.add_argument("--kernels", choices=BACKENDS, default=None,
                   help="the folded-BN forward on cuda: the hand-written kernels (plain "
                        "versions for CPU tensors), or torch: their plain PyTorch versions; "
                        "without it, the unfolded eval-mode forward")
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cuda' raises when no GPU is present")
    for name in UNPORTED_FLAGS:
        p.add_argument("--" + name.replace("_", "-"), nargs="?", const=True, default=None,
                       help=argparse.SUPPRESS)
    return p.parse_args(argv)


def main(argv=None):
    args = get_args(argv)
    refuse_unported(args, "tpu_unet_torch.predict")
    logging.basicConfig(level=logging.INFO, format="%(levelname)s: %(message)s")
    device = resolve_device(args.device)
    out_files = args.output or [f"{os.path.splitext(f)[0]}_OUT.png" for f in args.input]
    config = UNetConfig(n_channels=3, n_classes=args.classes, bilinear=args.bilinear)
    logger.info("Loading model %s", args.model)
    params, state, config, mask_values = load_model(args.model, config, device)
    for i, filename in enumerate(args.input):
        logger.info("Predicting image %s ...", filename)
        img = Image.open(filename)
        common = dict(scale_factor=args.scale, out_threshold=args.mask_threshold, amp=args.amp,
                      device=device)
        if args.kernels:
            mask = predict_img_fused(params, state, config, img, backend=args.kernels, **common)
        else:
            mask = predict_img(params, state, config, img, **common)
        if not args.no_save:
            mask_to_image(mask, mask_values).save(out_files[i])
            logger.info("Mask saved to %s", out_files[i])


if __name__ == "__main__":
    main()
