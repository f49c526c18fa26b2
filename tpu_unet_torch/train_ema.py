"""EMA shadow weights for the train loop (``tpu_unet/train_ema.py``):
ema <- d·ema + (1 − d)·params after every optimizer step, in fp32 with d
and 1 − d rounded to fp32 as the JAX package computes them. The checkpoint
policy writes the shadow tree beside each epoch's checkpoint
(``checkpoint_epochN_ema.npz``), so ``--resume`` continues the average.
"""

from __future__ import annotations

import logging
from pathlib import Path

import torch

from tpu_unet_torch.models.unet import tree_leaves, tree_map

logger = logging.getLogger(__name__)


class EmaTracker:
    """The shadow tree and its update; made by :func:`maybe_create`."""

    def __init__(self, decay: float, params):
        self.decay = decay
        self.params = tree_map(torch.clone, params)
        device = tree_leaves(params)[0].device
        self._d = torch.tensor(decay, dtype=torch.float32, device=device)
        self._one_minus = 1.0 - self._d

    def update(self, params) -> None:
        self.params = tree_map(lambda e, p: e * self._d + p * self._one_minus,
                               self.params, params)

    def resume_from_sibling(self, resume_path: str, live_params, place=None) -> None:
        """Continue the average from the ``_ema.npz`` beside the resumed
        checkpoint when it exists; else it restarts from the restored
        params (already its seed). ``place`` maps the file's whole tree to
        this rank's (its shards under tensor parallelism)."""
        from tpu_unet_torch.checkpoint import load_checkpoint

        rp = Path(resume_path)
        ema_path = rp.with_name(rp.name.replace(".npz", "_ema.npz"))
        if ema_path.exists():
            loaded = load_checkpoint(ema_path)[0]
            if place is not None:
                loaded = place(loaded)
            self.params = tree_map(lambda e, p: e.to(device=p.device, dtype=p.dtype),
                                   loaded, live_params)
            logger.info("Resumed EMA weights from %s", ema_path)


def maybe_create(ema_decay: float | None, params, *, total_steps: int) -> EmaTracker | None:
    """Validate the decay, warn when the initial weights would dominate the
    average, build the tracker (None without a decay)."""
    if ema_decay is None:
        return None
    if not 0.0 < ema_decay < 1.0:
        raise ValueError(f"--ema-decay must be in (0, 1), got {ema_decay}")
    # The shadow tree starts at the initial params, and d^T of that mass
    # survives a T-step run: warn when more than 10% would remain.
    init_mass = ema_decay ** max(0, total_steps)
    if total_steps > 0 and init_mass > 0.1:
        logger.warning(
            "--ema-decay %g keeps %.0f%% of the INITIAL weights after this run's ~%d steps: "
            "the EMA checkpoint will trail far behind training. Use a decay with horizon "
            "1/(1-d) well below the step count (e.g. %.3g).",
            ema_decay, 100 * init_mass, total_steps, max(0.5, 1.0 - 10.0 / total_steps))
    return EmaTracker(ema_decay, params)
