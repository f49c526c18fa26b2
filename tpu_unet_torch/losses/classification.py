"""Pixel classification losses with torch-parity mean reductions
(``tpu_unet/losses/classification.py``), in their numerically stable forms."""

from __future__ import annotations

import torch


def bce_with_logits(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Binary cross-entropy on logits, mean over every element:
    max(x, 0) - x*z + log(1 + exp(-|x|)), in fp32."""
    logits = logits.float()
    targets = targets.float()
    loss = torch.clamp(logits, min=0) - logits * targets + torch.log1p(torch.exp(-logits.abs()))
    return loss.mean()


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Softmax cross-entropy, mean over all pixels. logits: [N,H,W,C]
    (channels last), labels: [N,H,W] int."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -logp.gather(-1, labels[..., None].long()).mean()
