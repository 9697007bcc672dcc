"""Asynchronous query execution (reference: ohm/Query.h:93-154).

The reference Query base exposes execute() / executeAsync() / wait() /
reset(hard).  Here AsyncQueryMixin adds the async trio to any query class
with an ``execute()`` method: executeAsync() runs execute() on a worker
thread (the XLA dispatch inside releases the GIL during device work, so the
host thread genuinely overlaps), wait() joins with an optional timeout, and
reset() discards results — hard reset aborts an in-flight execution's
results (the thread still drains, as the reference's GPU query does).
"""

from __future__ import annotations

import threading


class AsyncQueryMixin:
    """Adds executeAsync/wait/reset to a query with an execute() method."""

    _thread: threading.Thread | None = None
    _async_result = None
    _async_error: BaseException | None = None
    _aborted: bool = False

    def execute_async(self) -> bool:
        """Begin asynchronous execution.  Returns False if one is in flight
        (reference: Query::executeAsync returns false when busy)."""
        if self._thread is not None and self._thread.is_alive():
            return False
        self._async_result = None
        self._async_error = None
        self._aborted = False

        def run():
            try:
                self._async_result = self.execute()
            except BaseException as exc:  # noqa: BLE001 - surfaced via wait()
                self._async_error = exc

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()
        return True

    def wait(self, timeout: float | None = None) -> bool:
        """Block until the async execution completes.  Returns completion
        state; re-raises any execution error (unless the query was reset)."""
        t = self._thread
        if t is None:
            return True
        t.join(timeout)
        if t.is_alive():
            return False
        self._thread = None
        if self._async_error is not None and not self._aborted:
            err = self._async_error
            self._async_error = None
            raise err
        return True

    @property
    def is_pending(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def reset(self, hard: bool = True) -> None:
        """Discard results.  A hard reset also abandons an in-flight
        execution's outcome (reference: Query::reset(bool))."""
        if hard:
            self._aborted = True
            self._async_error = None
        self._async_result = None
        for name in ("ranges", "unobserved_volumes", "terminal_states",
                     "intersected_voxels", "result_keys", "result_counts",
                     "results", "clearances"):
            if hasattr(self, name):
                setattr(self, name, None)
