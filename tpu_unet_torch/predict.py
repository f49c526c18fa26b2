"""Predict masks (``tpu_unet/predict.py``): by default through the unfolded
eval-mode forward (``predict_img``, the reference's path without
``--kernels``), with ``--kernels cuda|torch`` through the folded-BN forward
(``predict_img_fused``), with ``--tile`` through the tiled sweep
(``parallel/tiling.py``), and with ``--batch-size N`` through
``iter_predicted_masks``, which runs up to N same-sized inputs as one batch.
``--device-preprocess`` (default path only) decodes on the host and resizes
and normalises on the device (``data/device_pipeline.py``), bitwise the host
preprocess; images of another mode than L or RGB fall back to the host.

The reference order is kept: preprocess -> forward (``--tta``: the flip
ensemble's merged logits) -> bilinear (half-pixel) upscale of the LOGITS to
the original resolution -> (``--crf``: mean-field refinement of the
probabilities) -> threshold (sigmoid > t) or argmax -> the checkpoint's
``mask_values`` palette. Models load from the JAX package's ``.npz`` or the
reference's torch ``.pth``.

Run:
    python -m tpu_unet_torch.predict -m ckpt.npz|model.pth -i a.png b.png \
        [--batch-size N] [--tta [--tta-mode hflip]] [--tile 512] [--crf] [--viz] \
        [--kernels cuda|torch] [--device-preprocess] [--device cuda|cpu] [--amp]
"""

from __future__ import annotations

import argparse
import logging
import os
from pathlib import Path

import numpy as np
import torch
from PIL import Image

from tpu_unet_torch.data.device_pipeline import device_preprocess_images, raw_u8_for_device
from tpu_unet_torch.data.loading import preprocess
from tpu_unet_torch.models import UNetConfig, fold_bn, unet_infer_apply
from tpu_unet_torch.models.infer import BACKENDS
from tpu_unet_torch.models.tta import TTA_MODES, tta_logits
from tpu_unet_torch.models.unet import tree_map, unet_apply
from tpu_unet_torch.ops import full_fp32, resize_bilinear

logger = logging.getLogger(__name__)

# Flags of the JAX CLIs that this port does not run yet.
UNPORTED_FLAGS = ("tile_sharded",)
ARCHS = ("unet", "unetpp", "attention", "r2u", "r2attu")


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


def refuse_unported(args: argparse.Namespace, prog: str, flags=UNPORTED_FLAGS) -> None:
    """Exit with a clear message when a flag the port lacks was given, or a
    model family other than ``unet``."""
    asked = ["--" + name.replace("_", "-") for name in flags if getattr(args, name, None)]
    arch = getattr(args, "arch", "unet")
    if arch != "unet":
        asked.append(f"--arch {arch}")
    if asked:
        raise SystemExit(f"{prog}: {asked[0]} is not ported to tpu_unet_torch yet; "
                         f"use the JAX package (tpu_unet) for it")


def logits_to_mask(logits: torch.Tensor, n_classes: int, threshold: float) -> np.ndarray:
    """[..., H, W, C] fp32 logits (already upscaled) -> class-index mask, one
    fetch to the host; per batch row, JAX's ``_threshold_batch``."""
    if n_classes > 1:
        return logits.argmax(dim=-1).cpu().numpy()
    return (torch.sigmoid(logits[..., 0]) > threshold).cpu().numpy()


def _forward_full(params, state, x: torch.Tensor, *, config: UNetConfig, full_h: int,
                  full_w: int, amp: bool, tta: bool, tta_mode: str) -> torch.Tensor:
    """Eval forward (``tta``: the flip views as one batch, merged), then the
    logits upscaled to the original size."""
    compute_dtype = torch.bfloat16 if amp else None
    if tta:
        logits = tta_logits(params, state, x, config=config, compute_dtype=compute_dtype,
                            mode=tta_mode)
    else:
        logits, _ = unet_apply(params, state, x, config=config, train=False,
                               compute_dtype=compute_dtype)
    return resize_bilinear(logits, full_h, full_w, align_corners=False)


def _on(device: torch.device, *trees):
    return tuple(tree_map(lambda t: t.to(device), tree) for tree in trees)


def _device_resized(raw: torch.Tensor, scale_factor: float) -> torch.Tensor:
    """Raw uint8 NHWC on the device -> the preprocessed float32 batch."""
    new_h, new_w = int(scale_factor * raw.shape[1]), int(scale_factor * raw.shape[2])
    if new_h <= 0 or new_w <= 0:
        raise ValueError("Scale is too small, resized images would have no pixel")
    return device_preprocess_images(raw, out_h=new_h, out_w=new_w)


def _raw_or_warn(img: Image.Image, what: str) -> np.ndarray | None:
    """``raw_u8_for_device(img)``, with a warning when the image must take
    the host path instead."""
    arr = raw_u8_for_device(img)
    if arr is None:
        logger.warning("%s not device-preprocessable (mode %s): falling back to host "
                       "preprocess", what, getattr(img, "mode", "?"))
    return arr


def predict_img(params, state, config: UNetConfig, full_img: Image.Image, *,
                scale_factor: float = 0.5, out_threshold: float = 0.5, amp: bool = False,
                use_crf: bool = False, tta: bool = False, tta_mode: str = "flips",
                device_preprocess: bool = False,
                device: str | torch.device = "cuda") -> np.ndarray:
    """The mask of one PIL image at its original resolution, through the
    unfolded eval-mode forward (``unet_apply(train=False)``, library convs
    and BN). ``tta`` averages the logits of the flip views; ``use_crf``
    refines the probabilities at the original resolution, against the image
    itself, before the threshold. ``device_preprocess`` resizes and
    normalises on the device (the same mask; L and RGB images only, others
    fall back to the host with a warning). ``params``/``state`` may live on
    any device; they are moved to ``device``."""
    device = resolve_device(device)
    full_w, full_h = full_img.size
    raw = _raw_or_warn(full_img, "image") if device_preprocess else None
    with torch.inference_mode():
        params, state = _on(device, params, state)
        if raw is not None:
            x = _device_resized(torch.from_numpy(raw[None].copy()).to(device), scale_factor)
        else:
            x = torch.from_numpy(preprocess(full_img, scale_factor))[None].to(device)
        logits = _forward_full(params, state, x, config=config, full_h=full_h, full_w=full_w,
                               amp=amp, tta=tta, tta_mode=tta_mode)
        if not use_crf:
            return logits_to_mask(logits[0], config.n_classes, out_threshold)
        from tpu_unet_torch.postprocess import crf_refine, crf_refine_binary

        rgb = torch.from_numpy(preprocess(full_img, 1.0))[None].to(device)
        if config.n_classes > 1:
            probs = crf_refine(rgb, torch.softmax(logits, dim=-1))
            return probs.argmax(dim=-1)[0].cpu().numpy()
        probs = crf_refine_binary(rgb, torch.sigmoid(logits[..., 0]))
        return (probs[0] > out_threshold).cpu().numpy()


def iter_predicted_masks(params, state, config: UNetConfig, filenames, *,
                         scale_factor: float = 0.5, out_threshold: float = 0.5,
                         amp: bool = False, tta: bool = False, tta_mode: str = "flips",
                         batch_size: int = 1, device_preprocess: bool = False,
                         device: str | torch.device = "cuda"):
    """Yield ``(filename, PIL image, mask)`` in input order, running up to
    ``batch_size`` consecutive inputs of one kind (raw uint8 for the device
    preprocess, or preprocessed on the host), one array shape AND one
    original size as one batch. A change of any, or a full batch, flushes
    the group, so memory stays bounded at ``batch_size`` images. Each group
    is stacked on the host: one copy to the device, one forward, one fetch
    of its masks. The threshold follows the batched upscale, so each mask is
    the one ``predict_img`` gives."""
    device = resolve_device(device)
    params, state = _on(device, params, state)
    pending: list[tuple[str, Image.Image, np.ndarray]] = []
    key = None  # (raw uint8, array shape, original PIL size)

    def flush():
        nonlocal pending, key
        if not pending:
            return
        full_w, full_h = pending[0][1].size
        with torch.inference_mode():
            x = torch.from_numpy(np.stack([arr for _, _, arr in pending])).to(device)
            if key[0]:
                x = _device_resized(x, scale_factor)
            logits = _forward_full(params, state, x, config=config, full_h=full_h,
                                   full_w=full_w, amp=amp, tta=tta, tta_mode=tta_mode)
            masks = logits_to_mask(logits, config.n_classes, out_threshold)
        done, pending, key = pending, [], None
        for (fname, img, _), mask in zip(done, masks):
            yield fname, img, mask

    for filename in filenames:
        img = Image.open(filename)
        arr = _raw_or_warn(img, f"image {filename}") if device_preprocess else None
        raw = arr is not None
        if not raw:
            arr = preprocess(img, scale_factor)
        k = (raw, arr.shape, img.size)
        if key is not None and k != key:
            yield from flush()
        key = k
        pending.append((filename, img, arr))
        if len(pending) >= batch_size:
            yield from flush()
    yield from flush()


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
    """(params, state, config, mask_values) from a ``.npz`` checkpoint or a
    torch ``.pth`` state dict. A ``.npz``'s stored config, when present,
    wins over ``config``; a stored config without ``recur_bn`` predates the
    per-step layout, so its arrays are in the shared layout: it loads as
    ``recur_bn="shared"``. A ``.pth`` is read with ``config`` (its classes
    and decoder), as the JAX package reads one."""
    from tpu_unet_torch.checkpoint import import_pth, load_checkpoint, read_checkpoint_meta

    if str(path).endswith(".jaxexp"):
        raise SystemExit(f"{path}: .jaxexp artifacts are not ported to tpu_unet_torch yet; "
                         "load a .npz or .pth checkpoint")
    if str(path).endswith(".pth"):
        params, state, mask_values = import_pth(path, config, device)
    else:
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
                   help="The model: a .npz checkpoint or a torch .pth state dict")
    p.add_argument("--input", "-i", metavar="INPUT", nargs="+", required=True,
                   help="Filenames of input images")
    p.add_argument("--output", "-o", metavar="OUTPUT", nargs="+",
                   help="Filenames of output images")
    p.add_argument("--viz", "-v", action="store_true",
                   help="Visualize the images as they are processed (needs matplotlib)")
    p.add_argument("--no-save", "-n", action="store_true", help="Do not save the output masks")
    p.add_argument("--mask-threshold", "-t", type=float, default=0.5,
                   help="Minimum probability value to consider a mask pixel white")
    p.add_argument("--scale", "-s", type=float, default=0.5,
                   help="Scale factor for the input images")
    p.add_argument("--bilinear", action="store_true", default=False,
                   help="Use bilinear upsampling")
    p.add_argument("--classes", "-c", type=int, default=1, help="Number of classes")
    p.add_argument("--amp", action="store_true", default=False, help="bf16 inference")
    p.add_argument("--tile", type=int, default=None,
                   help="Tiled sliding-window inference with this tile size (large images)")
    p.add_argument("--arch", choices=ARCHS, default="unet",
                   help="Model family of the checkpoint (the port runs unet)")
    p.add_argument("--crf", action="store_true", default=False,
                   help="Mean-field CRF refinement of the probabilities")
    p.add_argument("--batch-size", type=int, default=1, metavar="N",
                   help="Run up to N consecutive same-sized inputs as one batch "
                        "(output order and masks unchanged)")
    p.add_argument("--tta", action="store_true", default=False,
                   help="Test-time augmentation: average the logits of flip views "
                        "(one batched forward) before thresholding")
    p.add_argument("--tta-mode", choices=tuple(TTA_MODES), default="flips",
                   help="TTA views: all four flips, or identity + left-right only")
    p.add_argument("--kernels", choices=BACKENDS, default=None,
                   help="the folded-BN forward on cuda: the hand-written kernels (plain "
                        "versions for CPU tensors), or torch: their plain PyTorch versions; "
                        "without it, the unfolded eval-mode forward")
    p.add_argument("--device-preprocess", action="store_true", default=False,
                   help="Resize and normalise on the device (Pillow-bit-exact int32 "
                        "resample, the same mask; the host keeps only the decode)")
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cuda' raises when no GPU is present")
    for name in UNPORTED_FLAGS:
        p.add_argument("--" + name.replace("_", "-"), nargs="?", const=True, default=None,
                       help=argparse.SUPPRESS)
    return p.parse_args(argv)


def get_output_filenames(args) -> list[str]:
    return args.output or [f"{os.path.splitext(f)[0]}_OUT.png" for f in args.input]


def main(argv=None):
    args = get_args(argv)
    refuse_unported(args, "tpu_unet_torch.predict")
    if args.tta and args.kernels:
        raise SystemExit("--tta does not compose with --kernels")
    if args.tile and args.kernels:
        # The JAX CLI runs the tiler and ignores --kernels here; its server
        # refuses the pair. The port refuses it in both.
        raise SystemExit("--tile does not compose with --kernels (the tiled sweep runs "
                         "the eval forward)")
    if args.device_preprocess and (args.tile or args.tile_sharded or args.kernels):
        raise SystemExit("--device-preprocess applies to the default predict path "
                         "(not --tile/--tile-sharded/--kernels)")
    if args.batch_size > 1 and (args.tile or args.kernels or args.crf):
        raise SystemExit("--batch-size composes with the default predict path only "
                         "(not --tile/--tile-sharded/--kernels/--crf)")
    logging.basicConfig(level=logging.INFO, format="%(levelname)s: %(message)s")
    device = resolve_device(args.device)
    out_files = get_output_filenames(args)
    config = UNetConfig(n_channels=3, n_classes=args.classes, bilinear=args.bilinear)
    logger.info("Loading model %s", args.model)
    params, state, config, mask_values = load_model(args.model, config, device)
    common = dict(scale_factor=args.scale, out_threshold=args.mask_threshold, amp=args.amp,
                  device=device)
    views = dict(tta=args.tta, tta_mode=args.tta_mode)

    def one_at_a_time():
        from tpu_unet_torch.parallel.tiling import predict_img_tiled

        for filename in args.input:
            logger.info("Predicting image %s ...", filename)
            img = Image.open(filename)
            if args.tile:
                mask = predict_img_tiled(params, state, config, img, tile=args.tile,
                                         **views, **common)
            elif args.kernels:
                mask = predict_img_fused(params, state, config, img, backend=args.kernels,
                                         **common)
            else:
                mask = predict_img(params, state, config, img, use_crf=args.crf,
                                   device_preprocess=args.device_preprocess, **views, **common)
            yield filename, img, mask

    if args.batch_size > 1:
        produced = iter_predicted_masks(params, state, config, args.input,
                                        batch_size=args.batch_size,
                                        device_preprocess=args.device_preprocess, **views,
                                        **common)
    else:
        produced = one_at_a_time()
    for i, (filename, img, mask) in enumerate(produced):
        if not args.no_save:
            mask_to_image(mask, mask_values).save(out_files[i])
            logger.info("Mask saved to %s", out_files[i])
        if args.viz:
            from tpu_unet_torch.utils.viz import plot_img_and_mask

            logger.info("Visualizing results for image %s, close to continue...", filename)
            plot_img_and_mask(img, mask)


if __name__ == "__main__":
    main()
