"""The train loop's loss history (``tpu_unet/train_logging.py``,
``LossDrain``).

Per-step losses stay on the device and cross to the host in one fetch at
each validation and epoch end: a ``float(loss)`` per step would wait for
the card every step. The JAX package's W&B panel is not ported (``--wandb``
is refused).
"""

from __future__ import annotations

import torch


class LossDrain:
    """Per-step device losses, fetched to ``history["train_loss"]`` in one
    copy by ``drain()``."""

    def __init__(self, history: dict):
        self.history = history
        self._losses: list[torch.Tensor] = []

    def append(self, loss: torch.Tensor) -> None:
        self._losses.append(loss.detach())

    def drain(self) -> None:
        if not self._losses:
            return
        self.history["train_loss"].extend(torch.stack(self._losses).float().cpu().tolist())
        self._losses.clear()
