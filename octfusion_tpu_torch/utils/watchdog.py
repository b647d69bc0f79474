"""Stall watchdog: fail loudly when training stops making progress
(copy of ``octfusion_tpu/utils/watchdog.py``).

A hung device call or collective leaves the training process blocked
forever instead of crashing, and a driving shell script never advances.
``StallWatchdog`` is a daemon thread that terminates the process (exit
code 3) if ``poke()`` is not called within ``timeout_s``; the train loop
pokes it at every print-frequency step, whose loss read on the host is
the observable proof of end-to-end progress.

The default budget covers the slowest legitimate gap between pokes (a
display-frequency evaluation samples a whole cascade): 1800 s.  Override
with ``OCTFUSION_STALL_TIMEOUT`` (seconds, ``0`` disables).
"""

from __future__ import annotations

import os
import sys
import threading
import time
from typing import Callable, Optional


class StallWatchdog:
    def __init__(self, timeout_s: Optional[float] = None,
                 on_stall: Optional[Callable[[], None]] = None,
                 poll_s: float = 10.0):
        env = os.environ.get("OCTFUSION_STALL_TIMEOUT")
        if timeout_s is None:
            timeout_s = float(env) if env else 1800.0
        self.timeout_s = timeout_s
        self._last = time.monotonic()
        self._stop = threading.Event()
        self._poll_s = poll_s
        self._on_stall = on_stall or self._default_stall
        self._thread: Optional[threading.Thread] = None
        if self.timeout_s > 0:
            self._thread = threading.Thread(
                target=self._run, name="stall-watchdog", daemon=True
            )
            self._thread.start()

    def poke(self) -> None:
        self._last = time.monotonic()

    def stop(self) -> None:
        self._stop.set()

    # ------------------------------------------------------------------
    def _run(self) -> None:
        while not self._stop.wait(min(self._poll_s, self.timeout_s)):
            if time.monotonic() - self._last > self.timeout_s:
                self._on_stall()
                return

    def _default_stall(self) -> None:
        sys.stderr.write(
            f"[watchdog] no training progress for {self.timeout_s:.0f}s: "
            "a device call or collective is likely hung.  Exiting 3 so the "
            "launcher can restart and auto-resume from the latest "
            "checkpoint.\n"
        )
        sys.stderr.flush()
        os._exit(3)
