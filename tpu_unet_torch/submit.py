"""Carvana RLE submission writer (``tpu_unet/submit.py``).

Predict every image of a directory and write a Kaggle Carvana
run-length-encoded submission CSV (``img,rle_mask`` rows in file order).
RLE per the Carvana challenge: column-major (Fortran) flattening, 1-indexed
start positions, "start length" pairs.

Images are batched by their raw size and flushed at ``batch_size``; a
trailing group is zero-padded to ``batch_size``, so one batch shape runs per
image size. Each row of a batch is the mask ``predict_img`` gives: the fp32
eval forward (``predict._forward_full``, ``tta``: the flip ensemble), the
logits upscaled to the image's size, then thresholded.

Run: ``python -m tpu_unet_torch.submit -m ckpt.npz|model.pth -i test_dir -o SUBMISSION.csv
[--tta [--tta-mode hflip]] [-b 8] [--device cuda|cpu]``
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
from tpu_unet_torch.models import UNetConfig
from tpu_unet_torch.models.tta import TTA_MODES
from tpu_unet_torch.predict import (
    _forward_full,
    exit_on_refusal,
    load_model,
    logits_to_mask,
    resolve_device,
)

logger = logging.getLogger(__name__)


def rle_encode(mask: np.ndarray) -> str:
    """Binary HW mask -> Carvana RLE string (column-major, 1-indexed)."""
    pixels = np.asarray(mask, dtype=np.uint8).flatten(order="F")
    padded = np.concatenate([[0], pixels, [0]])
    changes = np.where(padded[1:] != padded[:-1])[0] + 1
    starts, ends = changes[::2], changes[1::2]
    return " ".join(f"{s} {e - s}" for s, e in zip(starts, ends))


def rle_decode(rle: str, shape: tuple[int, int]) -> np.ndarray:
    """Inverse of ``rle_encode``: an HW uint8 mask of 0 and 1."""
    out = np.zeros(shape[0] * shape[1], dtype=np.uint8)
    tokens = list(map(int, rle.split()))
    for start, length in zip(tokens[::2], tokens[1::2]):
        out[start - 1:start - 1 + length] = 1
    return out.reshape(shape, order="F")


def submit(model_path, in_dir, out_csv, scale: float = 0.5, threshold: float = 0.5,
           bilinear: bool = False, tta: bool = False, batch_size: int = 8,
           tta_mode: str = "flips", device="cuda") -> None:
    """Predict every image of ``in_dir`` (sorted, hidden files skipped) on
    ``device`` and write the RLE CSV to ``out_csv``. A ``.npz``'s stored
    config wins; a ``.pth`` is read as the binary U-Net (``bilinear``). A
    model of more than one class is refused: Carvana masks are binary."""
    device = resolve_device(device)
    params, state, config, _ = load_model(model_path, UNetConfig(3, 1, bilinear=bilinear),
                                          device)
    if config.n_classes != 1:
        raise ValueError("Carvana RLE submissions are binary; checkpoint has "
                         f"{config.n_classes} classes")
    files = sorted(f for f in os.listdir(in_dir) if not f.startswith("."))
    rows: dict[str, str] = {}
    groups: dict[tuple[int, int], list] = {}  # raw (W, H) -> [(name, preprocessed)]

    def flush(size, items):
        full_w, full_h = size
        x = np.stack([arr for _, arr in items])
        if len(items) < batch_size:  # one batch shape per image size
            x = np.concatenate([x, np.zeros((batch_size - len(items),) + x.shape[1:], x.dtype)])
        with torch.inference_mode():
            logits = _forward_full(params, state, torch.from_numpy(x).to(device), config=config,
                                   full_h=full_h, full_w=full_w, amp=False, tta=tta,
                                   tta_mode=tta_mode)
            masks = logits_to_mask(logits, 1, threshold)
        for (name, _), mask in zip(items, masks):
            rows[name] = rle_encode(mask)
            logger.info("encoded %s", name)

    for name in files:
        img = Image.open(Path(in_dir) / name)
        groups.setdefault(img.size, []).append((name, preprocess(img, scale)))
        if len(groups[img.size]) == batch_size:
            flush(img.size, groups.pop(img.size))
    for size, items in groups.items():
        flush(size, items)

    with open(out_csv, "w") as f:
        f.write("img,rle_mask\n")
        for name in files:
            f.write(f"{name},{rows[name]}\n")
    logger.info("Wrote %d rows to %s", len(files), out_csv)


@exit_on_refusal("tpu_unet_torch.submit")
def main(argv=None):
    p = argparse.ArgumentParser(description="Write a Carvana RLE submission CSV (PyTorch port)")
    p.add_argument("--model", "-m", required=True)
    p.add_argument("--input-dir", "-i", required=True)
    p.add_argument("--output", "-o", default="SUBMISSION.csv")
    p.add_argument("--scale", "-s", type=float, default=0.5)
    p.add_argument("--mask-threshold", "-t", type=float, default=0.5)
    p.add_argument("--bilinear", action="store_true")
    p.add_argument("--tta", action="store_true", default=False,
                   help="Flip-ensemble test-time augmentation")
    p.add_argument("--tta-mode", choices=tuple(TTA_MODES), default="flips",
                   help="TTA views: all four flips, or identity + left-right only (studio "
                        "shots with a gravity axis)")
    p.add_argument("--batch-size", "-b", type=int, default=8,
                   help="Images per batched forward (grouped by size; a partial group is "
                        "zero-padded)")
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cuda' raises when no GPU is present")
    a = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(levelname)s: %(message)s")
    submit(a.model, a.input_dir, a.output, a.scale, a.mask_threshold, a.bilinear, tta=a.tta,
           batch_size=a.batch_size, tta_mode=a.tta_mode, device=a.device)


if __name__ == "__main__":
    main()
