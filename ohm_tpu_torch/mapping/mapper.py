"""Mapper: round-robin scheduler of post-population mapping processes.

Reference parity: ohm/Mapper.{h,cpp} + ohm/MappingProcess.h — time-sliced
execution of processes (e.g. ClearanceProcess) against dirty regions,
interleaved with map population.
"""

from __future__ import annotations

import time


class MappingProcess:
    """Base process interface (reference: ohm/MappingProcess.h:33-58)."""

    PAUSED = 0
    CONTINUE = 1
    COMPLETE = 2

    def update(self, map_obj, time_slice: float) -> int:  # pragma: no cover - interface
        raise NotImplementedError

    def reset(self):
        pass


class ClearanceMappingProcess(MappingProcess):
    """Wraps query.ClearanceProcess as a schedulable process."""

    def __init__(self, clearance_process, regions_per_slice: int = 8):
        self.process = clearance_process
        self.regions_per_slice = regions_per_slice

    def update(self, map_obj, time_slice: float) -> int:
        dirty = [k for k, c in map_obj.chunks.items()
                 if self.process._processed_stamps.get(k, -1) < c.dirty_stamp]
        if not dirty:
            return self.COMPLETE
        deadline = time.monotonic() + time_slice if time_slice > 0 else None
        for i in range(0, len(dirty), self.regions_per_slice):
            self.process.update(dirty[i:i + self.regions_per_slice], force=True)
            if deadline is not None and time.monotonic() > deadline:
                return self.CONTINUE
        return self.CONTINUE


class Mapper:
    """Round-robin process scheduler (reference: ohm/Mapper.h:19-41)."""

    def __init__(self, map_obj=None):
        self.map = map_obj
        self.processes: list[MappingProcess] = []
        self._next = 0

    def add_process(self, process: MappingProcess):
        self.processes.append(process)

    def update(self, time_slice: float = 0.01) -> int:
        """Run up to one time slice of pending processes."""
        if not self.processes or self.map is None:
            return MappingProcess.COMPLETE
        n = len(self.processes)
        status = MappingProcess.COMPLETE
        deadline = time.monotonic() + time_slice if time_slice > 0 else None
        for _ in range(n):
            process = self.processes[self._next % n]
            self._next += 1
            result = process.update(self.map, time_slice / n if time_slice > 0 else 0)
            if result != MappingProcess.COMPLETE:
                status = MappingProcess.CONTINUE
            if deadline is not None and time.monotonic() > deadline:
                return MappingProcess.CONTINUE
        return status
