"""Background progress reporting (reference: ohmutil/ProgressMonitor.h).

A thread displays progress and processing rate while the main thread
populates the map; increments are lock-free (plain int adds under the GIL).
"""

from __future__ import annotations

import sys
import threading
import time


class ProgressMonitor:
    def __init__(self, interval: float = 0.5, out=None, label: str = ""):
        self.interval = interval
        self.out = out if out is not None else sys.stderr
        self.label = label
        self._progress = 0
        self._target = 0
        self._thread = None
        self._quit = threading.Event()
        self._paused = threading.Event()
        self._start_time = None

    def set_target(self, target: int):
        self._target = int(target)

    def increment(self, amount: int = 1):
        self._progress += amount

    @property
    def progress(self) -> int:
        return self._progress

    def start_thread(self):
        if self._thread is not None:
            return
        self._start_time = time.monotonic()
        self._quit.clear()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def pause(self):
        self._paused.set()

    def unpause(self):
        self._paused.clear()

    def join(self, display_final: bool = True):
        if self._thread is None:
            return
        self._quit.set()
        self._thread.join()
        self._thread = None
        if display_final:
            self._display(final=True)

    def _display(self, final: bool = False):
        elapsed = max(time.monotonic() - (self._start_time or time.monotonic()), 1e-9)
        rate = self._progress / elapsed
        msg = f"\r{self.label}{self._progress}"
        if self._target:
            msg += f" / {self._target} ({100.0 * self._progress / max(self._target, 1):.1f}%)"
        msg += f" @ {rate:,.0f}/s"
        self.out.write(msg + ("\n" if final else ""))
        self.out.flush()

    def _run(self):
        while not self._quit.wait(self.interval):
            if not self._paused.is_set():
                self._display()
