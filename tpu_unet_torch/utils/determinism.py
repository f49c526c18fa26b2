"""Deterministic algorithms for a block of work, so that a seeded run on the
card repeats bit for bit (``tools/train_demo.py``, ``chip_smoke.py``,
``train_cli --deterministic``)."""

from __future__ import annotations

import warnings

import torch

# The text of torch's warning for an op without a deterministic form, under
# ``use_deterministic_algorithms(True, warn_only=True)``.
_NONDETERMINISTIC = "does not have a deterministic implementation"


class Deterministic:
    """cuDNN deterministic (no benchmark search) and torch's deterministic
    algorithms in warn-only mode. The warnings of ops without a
    deterministic form are recorded in ``reasons``; every other warning
    raised in the block is warned again on exit, at its own place, through
    the caller's filters. Restores every setting on exit."""

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
        return sorted({str(w.message).split("\n")[0][:160] for w in self._caught
                       if _NONDETERMINISTIC in str(w.message)})

    def __exit__(self, *exc):
        self._catch.__exit__(*exc)
        det, bench, algos, warn_only = self._prev
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = det, bench
        torch.use_deterministic_algorithms(algos, warn_only=warn_only)
        for w in self._caught:
            if _NONDETERMINISTIC not in str(w.message):
                warnings.warn_explicit(w.message, w.category, w.filename, w.lineno,
                                       source=w.source)
        return False
