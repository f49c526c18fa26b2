"""The train loop's checkpoint policy (``tpu_unet/train_checkpoints.py``):
per-epoch files carrying ``mask_values`` (the reference's contract: predict
needs the palette), retention (``--keep-checkpoints``), best-model tracking
(``--save-best``), EMA siblings and the resumable ``INTERRUPTED.npz``. The
file names and ``extra`` fields are the JAX package's, so either package
resumes from the other's files. Under data parallelism only the primary
rank (rank 0) writes; the others keep the same bookkeeping. Under ZeRO
(``full_opt``) a file holds the whole optimizer state: every rank gathers
it (a collective) before rank 0 writes, at every save that carries it, so
the decision to save is the same on every rank (``agree`` for the best
model, whose bar each rank reads from its own directory).
"""

from __future__ import annotations

import logging
from pathlib import Path

from tpu_unet_torch.checkpoint import AsyncCheckpointer, read_checkpoint_meta

logger = logging.getLogger(__name__)


def prune_checkpoints(checkpoint_dir: Path, epoch: int, keep: int) -> None:
    """Delete per-epoch checkpoints (and their EMA siblings) older than the
    newest ``keep``."""
    for old in sorted(Path(checkpoint_dir).glob("checkpoint_epoch*.npz")):
        try:
            ep = int(old.stem.removeprefix("checkpoint_epoch").removesuffix("_ema"))
        except ValueError:
            continue  # not one of ours
        if ep <= epoch - keep:
            old.unlink(missing_ok=True)
            logger.info("Pruned %s (keep-checkpoints=%d)", old.name, keep)


class CheckpointPolicy:
    """Owns the async writer and every file the trainer writes. A save
    copies the trees to the host at once and writes on a thread while
    training goes on. ``full_opt`` maps this rank's optimizer state to the
    whole one (ZeRO's gather, called on every rank); ``agree`` makes a flag
    true on every rank when it is on any (``DataParallel.any``)."""

    def __init__(self, checkpoint_dir: Path, *, enabled: bool, keep: int | None,
                 save_best: bool, save_optimizer: bool, optimizer: str, lr_scheduler: str,
                 config, dataset, ema_decay: float | None, primary: bool = True,
                 full_opt=None, agree=None):
        self.dir = Path(checkpoint_dir)
        self.enabled = enabled
        self.primary = primary
        self.full_opt = full_opt
        self.agree = agree
        self.keep = keep
        self.save_best = save_best
        self.save_optimizer = save_optimizer
        self.optimizer = optimizer
        self.lr_scheduler = lr_scheduler
        self.config = config
        self.mask_values = getattr(dataset, "mask_values", None)
        self.ema_decay = ema_decay
        self.checkpointer = AsyncCheckpointer()
        self.best_dice = float("-inf")
        best_path = self.dir / "checkpoint_best.npz"
        if save_best and best_path.exists():
            # A resumed run must not overwrite a better model with its first
            # validation.
            try:
                self.best_dice = float(read_checkpoint_meta(best_path)[1].get("val_dice",
                                                                               self.best_dice))
                logger.info("Existing checkpoint_best.npz at val Dice %.4f: only better "
                            "models will overwrite it", self.best_dice)
            except (OSError, ValueError, KeyError) as e:  # unreadable: as if absent
                logger.warning("Could not read %s (%s); starting best tracking fresh",
                               best_path, e)

    @staticmethod
    def _es_extra(es_best: float, es_bad: int) -> dict:
        return {"early_stop": {"best": es_best, "bad": es_bad}} if es_best != -float("inf") else {}

    def _save(self, name: str, params, bn_state, extra: dict, opt_state=None) -> None:
        if not self.primary:
            return
        self.dir.mkdir(parents=True, exist_ok=True)
        self.checkpointer.save(self.dir / name, params, bn_state, mask_values=self.mask_values,
                               extra={**extra, "config": self.config._asdict()},
                               opt_state=opt_state)

    def _opt(self, opt_state):
        """The whole optimizer state; every rank calls it at the same saves."""
        return opt_state if self.full_opt is None else self.full_opt(opt_state)

    def _schedule_extra(self, scheduler) -> dict:
        return {"lr": scheduler.lr,
                "scheduler": {"name": self.lr_scheduler, **scheduler.state_dict()},
                "optimizer": self.optimizer}

    def maybe_save_best(self, val_dice: float, *, epoch: int, step: int, lr: float, params,
                        bn_state, opt_state) -> bool:
        """Write ``checkpoint_best.npz`` when ``val_dice`` beats the best so
        far (never pruned). Returns whether it wrote."""
        better = self.save_best and val_dice > self.best_dice
        if self.save_best and self.save_optimizer and self.full_opt is not None:
            if self.agree(better):
                opt_state = self._opt(opt_state)
        if not better:
            return False
        self.best_dice = val_dice
        self._save("checkpoint_best.npz", params, bn_state,
                   {"epoch": epoch, "step": step, "val_dice": val_dice, "lr": lr,
                    "optimizer": self.optimizer},
                   opt_state if self.save_optimizer else None)
        if self.primary:
            logger.info("New best val Dice %.4f: checkpoint_best.npz updated", val_dice)
        return True

    def save_epoch(self, epoch: int, *, params, bn_state, opt_state, scheduler, es_best: float,
                   es_bad: int, ema_params=None) -> None:
        if self.enabled and self.save_optimizer:
            opt_state = self._opt(opt_state)
        if not (self.enabled and self.primary):
            return
        self._save(f"checkpoint_epoch{epoch}.npz", params, bn_state,
                   {"epoch": epoch, **self._schedule_extra(scheduler),
                    **self._es_extra(es_best, es_bad)},
                   opt_state if self.save_optimizer else None)
        logger.info("Checkpoint %d saved!", epoch)
        if ema_params is not None:
            self._save(f"checkpoint_epoch{epoch}_ema.npz", ema_params, bn_state,
                       {"epoch": epoch, "ema_decay": self.ema_decay})
        if self.keep:
            # Only strictly older files go, so this epoch's write in flight
            # is never raced.
            prune_checkpoints(self.dir, epoch, self.keep)

    def save_interrupted(self, *, epoch: int, step: int, scheduler, es_best: float,
                         es_bad: int, params, bn_state, opt_state, ema_params=None
                         ) -> Path | None:
        """``INTERRUPTED.npz`` with the whole resumable state, optimizer
        included. It records epoch − 1: the interrupted epoch is incomplete,
        so ``--resume`` runs it again from its start. Returns its path (None
        on a rank that does not write)."""
        opt_state = self._opt(opt_state)
        if not self.primary:
            return None
        self._save("INTERRUPTED.npz", params, bn_state,
                   {"epoch": epoch - 1, "step": step, "interrupted": True,
                    **self._schedule_extra(scheduler), **self._es_extra(es_best, es_bad)},
                   opt_state)
        if ema_params is not None:
            self._save("INTERRUPTED_ema.npz", ema_params, bn_state,
                       {"epoch": epoch - 1, "ema_decay": self.ema_decay})
        return self.dir / "INTERRUPTED.npz"

    def finish(self, last_epoch: int, start_epoch: int, epochs: int) -> None:
        """Wait for the write in flight, then prune once more: an epoch whose
        write was still queued when its prune ran lands afterwards."""
        self.checkpointer.wait()
        if self.enabled and self.primary and self.keep and epochs >= start_epoch:
            prune_checkpoints(self.dir, last_epoch, self.keep)
