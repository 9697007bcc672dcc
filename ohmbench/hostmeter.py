"""What the host did during a window, second by second.

The program is held back by its host (the card is idle most of a window),
so a run that reads slow may be slow because the host was: the process got
less of a core, faulted in fresh pages, was switched out or grew.
``HostMeter.tick`` is called by the client between batches; at each whole
second of the window it reads, from ``getrusage`` and ``/proc/self``, what
that second cost, and ``HostMeter.seconds`` lists it for the run's
``# info`` line.  (The machine-wide idle and steal times are left out: the
card's machine reports neither.)  Each reading is two system calls and one
small file read a second.
"""

from __future__ import annotations

import os
import resource
import time

_PAGE = os.sysconf("SC_PAGE_SIZE") if hasattr(os, "sysconf") else 4096


def _rss_bytes() -> int:
    try:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * _PAGE
    except (OSError, ValueError, IndexError):
        return 0


class HostMeter:
    """Per-second readings of the host over a window that starts now."""

    def __init__(self):
        self.t0 = time.perf_counter()
        self.rows = []
        self._mark = self._read()
        self._next = 1.0
        self._batches = 0

    @staticmethod
    def _read() -> dict:
        ru = resource.getrusage(resource.RUSAGE_SELF)
        return {"cpu_s": ru.ru_utime + ru.ru_stime, "minflt": ru.ru_minflt,
                "nivcsw": ru.ru_nivcsw}

    def tick(self, now: float) -> None:
        """One more batch submitted at host time ``now``; close each whole
        second that has passed."""
        self._batches += 1
        while now - self.t0 >= self._next:
            self._close()

    def _close(self) -> None:
        cur = self._read()
        was = self._mark
        self.rows.append({
            "batches": self._batches,
            "process_cpu_s": round(cur["cpu_s"] - was["cpu_s"], 3),
            "minor_faults": cur["minflt"] - was["minflt"],
            "involuntary_switches": cur["nivcsw"] - was["nivcsw"],
            "rss_mb": round(_rss_bytes() / 2**20, 1),
        })
        self._mark = cur
        self._batches = 0
        self._next += 1.0

    def seconds(self) -> dict:
        """Column by column, one entry a whole second of the window."""
        keys = self.rows[0].keys() if self.rows else ()
        return {k: [r[k] for r in self.rows] for k in keys}


def speed_probe(repeats: int = 5) -> float:
    """Milliseconds the host takes for a fixed piece of pure-Python work,
    the fastest of ``repeats``: how fast one core of this host ran, to set
    beside a run's rate."""
    best = float("inf")
    for _ in range(repeats):
        t = time.perf_counter()
        acc = 0
        for i in range(200_000):
            acc += i * i & 0xFF
        best = min(best, time.perf_counter() - t)
    return best * 1e3
