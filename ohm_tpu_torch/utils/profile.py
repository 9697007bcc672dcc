"""Hierarchical scoped profiling (reference: ohmutil/Profile.h:24-91), and
the program's span recorder.

A scope marker (``ProfileMarker``, or ``Profile.span``) records a span: its
name, its thread, its start and end on ``time.perf_counter_ns()``, its parent
(the span open on the same thread when it began), the batch it belongs to
and the number of batches it covers.  ``report()`` is ohmutil's end-of-run
report, summed from the spans; ``spans(since_ns, until_ns)`` and
``counters()`` (named integer counters, ``count``) return the records.
Spans are kept in memory, at most ``span_limit``; the ones past it are
dropped and counted in the ``spans_dropped`` counter.

A ``Profile()`` that a caller builds records from the start, as ohmutil's
does.  The process-wide one, ``Profile.instance()``, which the mapper's
worker and the integrate ops mark, records while a torch.profiler session
is active on the thread that hands the mapper its batches (the mapper
samples that at each batch it takes, through ``refresh``), or from
``record(True)`` on; otherwise a span boundary costs one flag test.
``to_epoch_ns`` maps a ``perf_counter_ns`` reading onto the Unix-epoch
nanoseconds that torch.profiler stamps its events with.  Under
``forbid_syncs`` (a CUDA graph capture, which cannot wait on the device) a
``sync`` scope raises ``SyncForbidden`` on the calling thread instead.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
from typing import NamedTuple

import torch


class Span(NamedTuple):
    """One recorded scope; times are ``time.perf_counter_ns()`` readings."""
    name: str
    thread: int
    start_ns: int
    end_ns: int
    #: ``id`` of the span open on the same thread when this one began.
    parent: int | None
    #: The batch the span belongs to (a group's: its first batch).
    batch: int | None
    #: The batches the span covers.
    count: int
    id: int


def clock_anchor(samples: int = 5) -> int:
    """``time.time_ns() - time.perf_counter_ns()``, from the tightest of
    ``samples`` readings of the wall clock bracketed by two of the counter."""
    best = None
    for _ in range(samples):
        a = time.perf_counter_ns()
        wall = time.time_ns()
        b = time.perf_counter_ns()
        if best is None or b - a < best[0]:
            best = (b - a, wall - (a + b) // 2)
    return best[1]


class SyncForbidden(RuntimeError):
    """A blocking device read was asked for under ``Profile.forbid_syncs``."""


class _Off:
    """The marker of a recorder that is off: enters and exits, nothing else."""
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Open:
    """The marker of a span being recorded."""
    __slots__ = ("_profile", "_name", "_batch", "_count", "_counter", "_id", "_parent",
                 "_start")

    def __init__(self, profile, name, batch, count, counter):
        self._profile = profile
        self._name = name
        self._batch = batch
        self._count = count
        self._counter = counter

    def __enter__(self):
        tls = self._profile._tls
        stack = tls.__dict__.get("stack")
        if stack is None:
            stack = tls.stack = []
        self._parent = stack[-1]._id if stack else None
        if self._batch is None:
            self._batch = tls.__dict__.get("batch")
        self._id = next(self._profile._ids)
        stack.append(self)
        self._start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        p = self._profile
        p._tls.stack.pop()
        if self._counter is not None:
            p._add(self._counter, self._count)
        if len(p._spans) < p.span_limit:
            p._spans.append(Span(self._name, threading.get_ident(), self._start, end,
                                 self._parent, self._batch, self._count, self._id))
        else:
            p._add("spans_dropped", 1)
        return False


class Profile:
    """Scope and span store (one process-wide, ``instance()``, or a
    caller's own)."""

    _instance = None
    #: Spans kept at most; each later one is counted in ``spans_dropped``.
    span_limit = 1 << 20

    def __init__(self):
        self._tls = threading.local()
        self._spans = []
        self._thread_counters = []
        self._ids = itertools.count()
        self._anchor = None
        self._forced = False
        self._follows_profiler = False
        #: Whether spans and counters are recorded.
        self.enabled = True

    @classmethod
    def instance(cls) -> "Profile":
        """The process-wide recorder the program marks; off until
        ``refresh`` finds torch.profiler running or ``record(True)``."""
        if cls._instance is None:
            p = cls()
            p.enabled = False
            p._follows_profiler = True
            cls._instance = p
        return cls._instance

    def record(self, on: bool = True) -> None:
        """Turn recording on whether or not torch.profiler runs (True), or
        back to following it (False)."""
        self._forced = bool(on)
        self._follows_profiler = True
        self.refresh()

    def refresh(self) -> bool:
        """Set ``enabled`` from the switch, as the calling thread sees
        torch.profiler (its state is per thread), and return it; the clock
        anchor is sampled as recording turns on.  A caller's own Profile
        keeps its ``enabled``."""
        if self._follows_profiler:
            on = self._forced or torch.autograd._profiler_enabled()
            if on and not self.enabled:
                self._anchor = clock_anchor()
            self.enabled = on
        return self.enabled

    def span(self, name: str, batch: int | None = None, count: int = 1,
             counter: str | None = None):
        """Context manager recording one span; ``batch`` None takes the
        thread's current batch (``set_batch``); ``counter`` adds ``count``
        to that counter as the span ends."""
        if not self.enabled:
            return _OFF
        return _Open(self, name, batch, count, counter)

    def sync(self):
        """Context manager around one blocking device read or copy: a span
        named "sync", counted in ``host_syncs``.  Under ``forbid_syncs`` it
        raises SyncForbidden before the read."""
        if self._tls.__dict__.get("forbid_syncs"):
            raise SyncForbidden("a blocking device read inside a CUDA graph capture")
        if not self.enabled:
            return _OFF
        return _Open(self, "sync", None, 1, "host_syncs")

    @contextlib.contextmanager
    def forbid_syncs(self):
        """While open, ``sync`` raises SyncForbidden on the calling thread."""
        self._tls.forbid_syncs = True
        try:
            yield
        finally:
            self._tls.forbid_syncs = False

    def set_batch(self, batch: int | None) -> None:
        """The batch the calling thread's next spans belong to."""
        if self.enabled:
            self._tls.batch = batch

    def count(self, name: str, n: int = 1) -> None:
        if self.enabled:
            self._add(name, n)

    def _add(self, name: str, n: int) -> None:
        # One dict a thread: an increment is never lost to another thread's.
        counters = self._tls.__dict__.get("counters")
        if counters is None:
            counters = self._tls.counters = {}
            self._thread_counters.append(counters)
        counters[name] = counters.get(name, 0) + n

    def counters(self) -> dict:
        """Every counter, summed over threads."""
        out = {}
        for counters in list(self._thread_counters):
            for name, n in list(counters.items()):
                out[name] = out.get(name, 0) + n
        return out

    def spans(self, since_ns: int | None = None, until_ns: int | None = None) -> list:
        """The recorded spans that overlap [since_ns, until_ns]
        (``perf_counter_ns``; None: unbounded), in the order they ended."""
        lo = -1 << 63 if since_ns is None else since_ns
        hi = 1 << 63 if until_ns is None else until_ns
        return [s for s in list(self._spans) if s.end_ns >= lo and s.start_ns <= hi]

    def to_epoch_ns(self, perf_ns: int) -> int:
        """A ``time.perf_counter_ns()`` reading as Unix-epoch nanoseconds,
        torch.profiler's event clock, by the anchor sampled when recording
        last turned on."""
        if self._anchor is None:
            self._anchor = clock_anchor()
        return int(perf_ns) + self._anchor

    def report(self) -> str:
        """ohmutil's report: each scope path's total ms and calls, the
        longest first, children indented under their parent."""
        spans = list(self._spans)
        by_id = {s.id: s for s in spans}
        paths = {}

        def path(s):
            p = paths.get(s.id)
            if p is None:
                parent = by_id.get(s.parent)
                p = paths[s.id] = (path(parent) if parent is not None else ()) + (s.name,)
            return p

        roots = {}
        for s in spans:
            scopes = roots
            for name in path(s)[:-1]:
                scopes = scopes.setdefault(name, [0, 0, {}])[2]
            scope = scopes.setdefault(s.name, [0, 0, {}])
            scope[0] += s.end_ns - s.start_ns
            scope[1] += 1
        lines = []

        def emit(scopes, depth):
            for name, (total, calls, children) in sorted(scopes.items(), key=lambda kv: -kv[1][0]):
                lines.append(f"{'  ' * depth}{name}: {total / 1e6:.2f} ms ({calls} calls)")
                emit(children, depth + 1)

        emit(roots, 0)
        return "\n".join(lines)

    def reset(self) -> None:
        """Forget every span and counter."""
        self._spans.clear()
        for counters in list(self._thread_counters):
            counters.clear()


def ProfileMarker(name: str, profile: Profile | None = None):
    """Scoped timer (reference: ohmutil ProfileMarker RAII): a span of
    ``profile`` (default: the process-wide recorder)."""
    return (profile or Profile.instance()).span(name)


profile_marker = ProfileMarker
