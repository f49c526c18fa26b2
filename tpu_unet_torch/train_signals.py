"""Soft stop on SIGTERM and Ctrl-C for the train loop
(``tpu_unet/train_signals.py``).

Either signal sets a flag that ``train_model`` reads at the next batch
boundary; it then saves a resumable ``INTERRUPTED.npz`` and returns
normally. A second Ctrl-C aborts at once.
"""

from __future__ import annotations

import logging
import signal
import threading

logger = logging.getLogger(__name__)


class StopSignal:
    """Context manager trapping SIGTERM and SIGINT into ``requested``.

    The handlers install only on the main thread (``signal.signal`` raises
    elsewhere) and are always restored on exit: a leaked handler would make
    the process ignore SIGTERM afterwards.
    """

    def __init__(self):
        self.requested = False
        self._prev: dict = {}

    def __enter__(self):
        if threading.current_thread() is threading.main_thread():
            for sig in (signal.SIGTERM, signal.SIGINT):
                self._prev[sig] = signal.signal(sig, self._on_signal)
        return self

    def __exit__(self, *exc):
        for sig, handler in self._prev.items():
            signal.signal(sig, handler)
        return False

    def _on_signal(self, signum, frame):
        if self.requested and signum == signal.SIGINT:
            raise KeyboardInterrupt  # the second Ctrl-C: abort now
        self.requested = True
        logger.info("%s received: will save a resumable checkpoint and stop at the next "
                    "batch boundary", signal.Signals(signum).name)
