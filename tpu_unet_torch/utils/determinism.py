"""Deterministic algorithms for a block of work, so that a seeded run on the
card repeats bit for bit (``tools/train_demo.py``, ``chip_smoke.py``)."""

from __future__ import annotations

import warnings

import torch


class Deterministic:
    """cuDNN deterministic (no benchmark search) and torch's deterministic
    algorithms in warn-only mode; the warnings of ops without a
    deterministic form are recorded in ``reasons``. Restores every setting
    on exit."""

    def __enter__(self):
        self._prev = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark,
                      torch.are_deterministic_algorithms_enabled(),
                      torch.is_deterministic_algorithms_warn_only_enabled())
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
        torch.use_deterministic_algorithms(True, warn_only=True)
        self._catch = warnings.catch_warnings(record=True)
        self._caught = self._catch.__enter__()
        warnings.simplefilter("always")
        return self

    @property
    def reasons(self) -> list[str]:
        return sorted({str(w.message).split("\n")[0][:160] for w in self._caught})

    def __exit__(self, *exc):
        self._catch.__exit__(*exc)
        det, bench, algos, warn_only = self._prev
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = det, bench
        torch.use_deterministic_algorithms(algos, warn_only=warn_only)
        return False
