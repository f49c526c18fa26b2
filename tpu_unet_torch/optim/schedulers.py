"""The LR schedules beside ReduceLROnPlateau (``tpu_unet/optim/schedulers.py``):
cosine annealing, StepLR and a constant rate, with
``torch.optim.lr_scheduler``'s closed forms.

One interface for all, so ``train_model`` treats them alike: ``.lr`` the
current rate; ``.step(metric)`` at each validation (only plateau reacts);
``.epoch_end()`` once per epoch (only the epoch schedules react, torch's
``scheduler.step()`` call point); ``state_dict()`` / ``load_state_dict()``
ride the checkpoint for ``--resume``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

from tpu_unet_torch.optim.plateau import ReduceLROnPlateau

SCHEDULERS = ("plateau", "cosine", "step", "constant")


class _EpochSchedule:
    """What the epoch schedules share: no reaction to validations, and a
    state dict restored field by field."""

    lr: float

    def step(self, metric: float | None = None) -> float:
        return self.lr

    def load_state_dict(self, d: dict) -> None:
        for k, v in d.items():
            setattr(self, k, v)


@dataclass
class CosineAnnealingLR(_EpochSchedule):
    """lr_k = eta_min + (base − eta_min)·(1 + cos(π·k/T_max))/2, stepped per
    epoch."""

    lr: float
    t_max: int
    eta_min: float = 0.0
    epoch: int = 0

    def __post_init__(self):
        self.base_lr = self.lr

    def epoch_end(self) -> float:
        self.epoch += 1
        self.lr = self.eta_min + (self.base_lr - self.eta_min) * (
            1 + math.cos(math.pi * self.epoch / self.t_max)) / 2
        return self.lr

    def state_dict(self) -> dict:
        # t_max and eta_min ride along: a resumed run continues the saved
        # curve whatever its own --epochs and --lr-min.
        return {"lr": self.lr, "base_lr": self.base_lr, "epoch": self.epoch,
                "t_max": self.t_max, "eta_min": self.eta_min}


@dataclass
class StepLR(_EpochSchedule):
    """lr = base·gamma^(epoch // step_size)."""

    lr: float
    step_size: int
    gamma: float = 0.1
    epoch: int = 0

    def __post_init__(self):
        self.base_lr = self.lr

    def epoch_end(self) -> float:
        self.epoch += 1
        self.lr = self.base_lr * self.gamma ** (self.epoch // self.step_size)
        return self.lr

    def state_dict(self) -> dict:
        return {"lr": self.lr, "base_lr": self.base_lr, "epoch": self.epoch,
                "step_size": self.step_size, "gamma": self.gamma}


@dataclass
class ConstantLR(_EpochSchedule):
    lr: float

    def epoch_end(self) -> float:
        return self.lr

    def state_dict(self) -> dict:
        return {"lr": self.lr}


def get_scheduler(name: str, lr: float, *, epochs: int = 5, patience: int = 5,
                  step_size: int = 10, gamma: float = 0.1, eta_min: float = 0.0):
    """A schedule by name: ``plateau`` is the reference's configuration;
    ``cosine`` anneals over the whole run (T_max = epochs)."""
    if name == "plateau":
        return ReduceLROnPlateau(lr=lr, mode="max", patience=patience)
    if name == "cosine":
        return CosineAnnealingLR(lr=lr, t_max=max(epochs, 1), eta_min=eta_min)
    if name == "step":
        return StepLR(lr=lr, step_size=step_size, gamma=gamma)
    if name == "constant":
        return ConstantLR(lr=lr)
    raise ValueError(f"unknown lr scheduler {name!r} (choose from {SCHEDULERS})")
