"""ReduceLROnPlateau with torch's bookkeeping (``tpu_unet/optim/plateau.py``).

The reference's schedule, ``ReduceLROnPlateau(optimizer, 'max',
patience=5)``, as a host-side state machine stepped on each validation
score; the train step takes the current ``lr`` as an argument.

torch's semantics: mode 'max' with a relative threshold is better ⇔
a > best·(1 + threshold), with no sign branch (for a negative best the
threshold works backwards, as in torch); num_bad_epochs > patience ->
lr = max(lr·factor, min_lr), the counter reset, cooldown entered.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field


@dataclass
class ReduceLROnPlateau:
    lr: float
    mode: str = "max"
    factor: float = 0.1
    patience: int = 5
    threshold: float = 1e-4
    threshold_mode: str = "rel"
    cooldown: int = 0
    min_lr: float = 0.0
    best: float = field(default=None)  # type: ignore[assignment]
    num_bad_epochs: int = 0
    cooldown_counter: int = 0

    def __post_init__(self):
        if self.best is None:
            self.best = -math.inf if self.mode == "max" else math.inf

    def _is_better(self, a: float) -> bool:
        if self.mode == "max":
            if self.threshold_mode == "rel":
                return a > self.best * (1 + self.threshold)
            return a > self.best + self.threshold
        if self.threshold_mode == "rel":
            return a < self.best * (1 - self.threshold)
        return a < self.best - self.threshold

    def step(self, metric: float) -> float:
        """Record a validation metric; return the (possibly reduced) lr."""
        if self._is_better(metric):
            self.best = metric
            self.num_bad_epochs = 0
        else:
            self.num_bad_epochs += 1
        if self.cooldown_counter > 0:
            self.cooldown_counter -= 1
            self.num_bad_epochs = 0
        if self.num_bad_epochs > self.patience:
            self.lr = max(self.lr * self.factor, self.min_lr)
            self.cooldown_counter = self.cooldown
            self.num_bad_epochs = 0
        return self.lr

    def epoch_end(self) -> float:
        """The schedulers' epoch hook: plateau reacts to validations only."""
        return self.lr

    def state_dict(self) -> dict:
        return {"lr": self.lr, "best": self.best, "num_bad_epochs": self.num_bad_epochs,
                "cooldown_counter": self.cooldown_counter}

    def load_state_dict(self, d: dict) -> None:
        for k, v in d.items():
            setattr(self, k, v)
