"""Test-time augmentation: flip-ensembled logits (``tpu_unet/models/tta.py``).

A segmentation mask is equivariant under the flips {identity, hflip, vflip,
rot180}, so the logits of each flipped view are flipped back and averaged.
Logits are averaged, not probabilities, so the reference's order (upscale
the logits, then threshold) applies to the merged logits unchanged.
"""

from __future__ import annotations

import torch

from tpu_unet_torch.models.unet import UNetConfig, unet_apply

# (flip_h, flip_w) for each view; identity first. "hflip" is identity +
# left-right only, for scenes with a gravity axis (cars on the ground).
TTA_MODES = {
    "flips": ((False, False), (False, True), (True, False), (True, True)),
    "hflip": ((False, False), (False, True)),
}
TTA_FLIPS = TTA_MODES["flips"]


def flip(x: torch.Tensor, flip_h: bool, flip_w: bool) -> torch.Tensor:
    """Flip a [N,H,W,C] batch on H and/or W (its own inverse)."""
    dims = [d for d, f in ((1, flip_h), (2, flip_w)) if f]
    return torch.flip(x, dims) if dims else x


def tta_views(x: torch.Tensor, mode: str = "flips") -> torch.Tensor:
    """[N,H,W,C] -> [kN,H,W,C]: the mode's flip views, batch-concatenated."""
    return torch.cat([flip(x, fh, fw) for fh, fw in TTA_MODES[mode]], dim=0)


def _mean(parts: list[torch.Tensor]) -> torch.Tensor:
    """(parts[0] + parts[1] + ...) / k, in the JAX package's order."""
    total = parts[0]
    for p in parts[1:]:
        total = total + p
    return total / len(parts)


def tta_merge(view_logits: torch.Tensor, n: int, mode: str = "flips") -> torch.Tensor:
    """Invert each view's flip and average: [kN,H,W,C] logits -> [N,H,W,C]."""
    return _mean([flip(view_logits[i * n:(i + 1) * n], fh, fw)
                  for i, (fh, fw) in enumerate(TTA_MODES[mode])])


def tta_logits(params, state, x: torch.Tensor, *, config: UNetConfig,
               compute_dtype: torch.dtype | None = None, mode: str = "flips",
               batched: bool = True) -> torch.Tensor:
    """Flip-ensembled eval-mode logits of a batch.

    ``batched=True`` runs the k views as one k·N forward (predict and serve,
    at batch 1). ``batched=False`` runs one view at a time, so one forward's
    activations are alive at once (evaluate, at its batch sizes): JAX's
    ``lax.scan`` over the views. Both sum the un-flipped views in the same
    order."""
    if batched:
        logits, _ = unet_apply(params, state, tta_views(x, mode), config=config, train=False,
                               compute_dtype=compute_dtype)
        return tta_merge(logits, x.shape[0], mode)
    parts = []
    for fh, fw in TTA_MODES[mode]:
        logits, _ = unet_apply(params, state, flip(x, fh, fw), config=config, train=False,
                               compute_dtype=compute_dtype)
        parts.append(flip(logits, fh, fw))
    return _mean(parts)
