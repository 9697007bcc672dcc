"""The program's worker spans over a traced window, and their join with the
device trace.

The program records its spans (``ohm_tpu_torch.utils.profile``: the
process-wide ``Profile.instance()``) on ``time.perf_counter_ns()`` while a
torch.profiler session runs, as it does over a traced window.  The window
(``run.drive_window``) is on ``time.perf_counter()`` seconds, the device
trace (``devicetrace.WindowTrace``) on torch.profiler's Unix-epoch
nanoseconds; the recorder's ``to_epoch_ns`` maps the first onto the second.

That mapping holds for the host's events, but the device's timestamps drift
against the host's clock within a traced window, by up to tens of ms on the
card (PERF.md, §6).  So the join puts the device operations on the host's
clock by the worker's own copies: each group's wires go up in one pinned
copy, issued inside a ``worker.copy`` span, so the n-th pinned host-to-device
copy of the trace is the n-th ``worker.copy`` span's.  Where the device was
idle when the copy was issued, the copy starts as its span ends (to the tens
of microseconds the device takes to start it), and it anchors the two
clocks.  A copy that starts within ``QUEUED_NS`` of the end of the device's
work before it may have waited behind that work, so its start says nothing
of when it was issued: it anchors nothing.  Between two anchors the
correction is interpolated, outside them held.

A batch that the worker integrates synchronously (the segmented wire) goes
up in a pageable copy instead, inside a ``sync`` span within its
``worker.upload``: the host waits there until the device has finished the
copy, so the copy ends as its span ends (to the microseconds the host takes
to wake), and each such copy anchors the clocks by its end, whatever it
waited behind.  The dispatch that follows makes pageable copies of its
own, of a few bytes; so the copies taken are those that last at least
``WAITED_SHARE`` of the median such wait, and the n-th of them is the n-th
such span's.  A trace may drop one (seen in a process's second traced
window: 1-2 of ~90-160); then the two are paired by the gaps between
their ends instead, which agree on the two clocks, a dropped copy shifting
a gap by a whole batch (``pair_by_gaps``).  An anchor that reads far off
its neighbours' is left out (``_waited_anchors``).  Where neither kind of
copy pairs with its spans, or no copy anchors, the device joins read
nothing.

``probe`` snapshots the window's spans once for every reader
(``ctx["probes"]["worker_spans"]``); where the program has no recorder,
or it recorded nothing in the window, the snapshot is None and the readers
read nothing.
"""

from __future__ import annotations

import bisect
import statistics
from dataclasses import dataclass, field

#: The spans whose time the device-idle attribution takes, in the order in
#: which it gives an instant that two of them cover (on two threads).
ATTRIBUTED = ("worker.dispatch", "worker.upload", "worker.prep", "worker.wait")
#: K1's kernel: each batch's first launch on the rayflow wire.
K1 = "expand_keys_kernel"
#: How far a device operation may seem to start before the host issued it
#: (ns) before the clock check calls the two clocks apart.
CLOCK_SLACK_NS = 20_000
#: A copy that starts less than this (ns) after the end of the device's work
#: before it may have queued behind that work: it anchors nothing.
QUEUED_NS = 20_000
#: A pageable copy that an upload's ``sync`` span waited for lasts at least
#: this share of the median such wait (the host's staging and the copy
#: overlap); the few-byte copies a dispatch makes last a hundredth of it.
WAITED_SHARE = 0.1
#: Two waits' ends lie as far apart on the host's clock as their copies'
#: ends on the trace's, to this much (ns): the host's wake-up after each
#: copy and the trace's drift between them.  A batch takes 15 ms or more.
GAP_SLACK_NS = 500_000
#: A chain of such pairs starts within this (ns) of the error where the
#: chain before it ended, or of none: a batch's gap (15 ms or more) is
#: thrice that, so batches that come evenly spaced cannot start it a
#: batch off.
START_SLACK_NS = 5_000_000


def recorder():
    """The program's process-wide span recorder, or None where the program
    has none."""
    try:
        from ohm_tpu_torch.utils.profile import Profile
    except ImportError:
        return None
    rec = Profile.instance()
    if not all(callable(getattr(rec, m, None)) for m in ("spans", "counters", "to_epoch_ns")):
        return None
    return rec


def union(intervals) -> list:
    """Sorted disjoint (start, end) pairs covering ``intervals``."""
    out = []
    for a, b in sorted(i for i in intervals if i[1] > i[0]):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1][1] = b
        else:
            out.append([a, b])
    return [tuple(i) for i in out]


def length(intervals) -> int:
    return sum(b - a for a, b in intervals)


def intersect(xs, ys) -> list:
    """The overlap of two sorted disjoint interval lists."""
    out, i, j = [], 0, 0
    while i < len(xs) and j < len(ys):
        a, b = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        if a < b:
            out.append((a, b))
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return out


def subtract(xs, ys) -> list:
    """``xs`` less ``ys`` (both sorted and disjoint)."""
    out, j = [], 0
    for a, b in xs:
        while j < len(ys) and ys[j][1] <= a:
            j += 1
        k = j
        while k < len(ys) and ys[k][0] < b:
            if ys[k][0] > a:
                out.append((a, ys[k][0]))
            a = max(a, ys[k][1])
            k += 1
        if a < b:
            out.append((a, b))
    return out


def _pinned_copies(ops) -> list:
    """The trace's pinned host-to-device copies (the worker's uploads), by
    start."""
    return sorted((o for o in ops if o.kind == "gpu_memcpy" and "HtoD" in o.name
                   and "Pinned" in o.name), key=lambda o: o.start_ns)


def _pageable_copies(ops) -> list:
    """The trace's pageable host-to-device copies (the synchronous path's
    uploads), by end."""
    return sorted((o for o in ops if o.kind == "gpu_memcpy" and "HtoD" in o.name
                   and "Pageable" in o.name), key=lambda o: o.end_ns)


def _queued(ops) -> set:
    """``id`` of each operation that starts less than ``QUEUED_NS`` after
    the latest end of the operations that started before it."""
    out, busy = set(), None
    for o in sorted(ops, key=lambda o: (o.start_ns, o.end_ns)):
        if busy is not None and o.start_ns - busy < QUEUED_NS:
            out.add(id(o))
        busy = o.end_ns if busy is None else max(busy, o.end_ns)
    return out


def pair_by_gaps(host, trace, run: int = 3) -> list:
    """(i, j): ``host[i]`` paired with ``trace[j]`` (two sorted lists of
    times, the second on the trace's clock less the host's offset), where
    the gap from a neighbouring pair agrees on both clocks to
    ``GAP_SLACK_NS``.  A chain starts where ``run`` gaps in a row agree,
    within ``START_SLACK_NS`` of the error the chain before it ended at (of
    0 for the first) and nearest it, runs both ways from there passing over
    one time of either list that has no partner, and where it breaks the
    next chain is sought after it."""
    def agree(i, j, k, l):
        return abs((host[k] - host[i]) - (trace[l] - trace[j])) <= GAP_SLACK_NS

    def chain(i, j, step, lo_i, lo_j):
        out = []
        while True:
            nxt = next(((k, l) for k in (i + step, i + 2 * step) for l in (j + step, j + 2 * step)
                        if lo_i <= k < len(host) and lo_j <= l < len(trace)
                        and agree(i, j, k, l)), None)
            if nxt is None:
                return out
            i, j = nxt
            out.append(nxt)

    pairs = []
    while True:
        lo_i, lo_j = (pairs[-1][0] + 1, pairs[-1][1] + 1) if pairs else (0, 0)
        err = trace[pairs[-1][1]] - host[pairs[-1][0]] if pairs else 0
        start = None
        for i in range(lo_i, len(host) - run):
            js = [j for j in range(lo_j, len(trace) - run)
                  if abs(trace[j] - host[i] - err) <= START_SLACK_NS
                  and all(agree(i + k, j + k, i + k + 1, j + k + 1) for k in range(run))]
            if js:
                start = (i, min(js, key=lambda j: abs(trace[j] - host[i] - err)))
                break
        if start is None:
            return pairs
        pairs += chain(*start, -1, lo_i, lo_j)[::-1] + [start] + chain(*start, 1, 0, 0)


@dataclass
class WindowSpans:
    """The spans that overlap a window [lo, hi] (``perf_counter_ns``), and
    ``offset``: what ``to_epoch_ns`` adds to put them on the trace's clock."""
    spans: list = field(default_factory=list)
    lo: int = 0
    hi: int = 0
    offset: int = 0

    def intervals(self, name: str, thread=None) -> list:
        """The union of the spans called ``name`` (on ``thread``), cut to
        the window."""
        return union((max(s.start_ns, self.lo), min(s.end_ns, self.hi)) for s in self.spans
                     if s.name == name and (thread is None or s.thread == thread))

    def seconds(self, name: str, less: str | None = None) -> float:
        """Seconds inside spans called ``name`` in the window, less those
        inside spans called ``less`` on the same thread (their children)."""
        total = 0
        for thread in {s.thread for s in self.spans if s.name == name}:
            own = self.intervals(name, thread)
            if less is not None:
                own = subtract(own, self.intervals(less, thread))
            total += length(own)
        return total / 1e9

    def count(self, name: str) -> int:
        """Spans called ``name`` that start in the window."""
        return sum(1 for s in self.spans if s.name == name and self.lo <= s.start_ns <= self.hi)

    def _starts(self, name: str) -> list:
        """(start, count) of the spans called ``name`` that start in the
        window, in order."""
        return sorted((s.start_ns, s.count) for s in self.spans
                      if s.name == name and self.lo <= s.start_ns <= self.hi)

    def _paired_copies(self, ops) -> list:
        """(pinned copy, end of the ``worker.copy`` span that issued it) in
        order, where the copies and the spans pair; else []."""
        copies = _pinned_copies(ops)
        ends = sorted(s.end_ns for s in self.spans
                      if s.name == "worker.copy" and self.lo <= s.start_ns <= self.hi)
        if not copies or len(copies) != len(ends):
            return []
        return list(zip(copies, ends))

    def _paired_syncs(self, ops) -> list:
        """(pageable copy, the ``sync`` span inside a ``worker.upload`` that
        waited for it) in order, where the two pair; else []."""
        uploads = {s.id for s in self.spans if s.name == "worker.upload"}
        waits = sorted((s for s in self.spans if s.name == "sync" and s.parent in uploads
                        and self.lo <= s.start_ns <= self.hi), key=lambda s: s.end_ns)
        if not waits:
            return []
        least = WAITED_SHARE * statistics.median(w.end_ns - w.start_ns for w in waits)
        copies = [o for o in _pageable_copies(ops) if o.end_ns - o.start_ns >= least]
        if len(copies) == len(waits):
            return list(zip(copies, waits))
        return [(copies[j], waits[i]) for i, j in
                pair_by_gaps([w.end_ns for w in waits], [o.end_ns - self.offset for o in copies])]

    def _pinned_anchors(self, ops) -> list:
        queued = _queued(ops)
        return [(o.start_ns, o.start_ns - self.offset - end)
                for o, end in self._paired_copies(ops) if id(o) not in queued]

    def _waited_anchors(self, ops) -> list:
        """The waited-for copies' anchors, less those whose error lies more
        than ``GAP_SLACK_NS`` from the median of its own and its ten
        neighbours' (the trace drifts 0.2 ms a batch at most; a host that
        waits for the interpreter's lock after the copy, or a copy's odd
        record, reads ms off)."""
        paired = [(o.end_ns, o.end_ns - self.offset - s.end_ns) for o, s in self._paired_syncs(ops)]
        return [(t, e) for n, (t, e) in enumerate(paired)
                if abs(e - statistics.median(x for _, x in paired[max(0, n - 5):n + 6]))
                <= GAP_SLACK_NS]

    def anchors(self, ops) -> list:
        """(a trace time, the trace's error there: that time on the host's
        clock less the host's own reading of it), by trace time: a paired
        pinned copy's start against the end of the ``worker.copy`` span that
        issued it, where the copy did not queue behind the device's work
        (``QUEUED_NS``), and a paired pageable copy's end against the end of
        the ``sync`` span that waited for it; [] where neither pairs."""
        return sorted(self._pinned_anchors(ops) + self._waited_anchors(ops))

    def on_host_clock(self, ops, anchors=None) -> list:
        """(start, end, op) of each device operation on the host's clock
        (``perf_counter_ns``): the trace's time less ``offset`` and less the
        copies' error, interpolated between them."""
        anchors = self.anchors(ops) if anchors is None else anchors
        at = [a for a, _ in anchors]
        out = []
        for o in ops:
            err = 0
            if anchors:
                i = bisect.bisect_right(at, o.start_ns)
                if i == 0:
                    err = anchors[0][1]
                elif i == len(anchors):
                    err = anchors[-1][1]
                else:
                    (a0, e0), (a1, e1) = anchors[i - 1], anchors[i]
                    err = e0 + (e1 - e0) * (o.start_ns - a0) // max(a1 - a0, 1)
            shift = self.offset + err
            out.append((o.start_ns - shift, o.end_ns - shift, o))
        return out

    def idle_split(self, ops, anchors=None) -> dict:
        """The window's device-idle seconds (the complement of the union of
        the device operations ``ops``, on the host's clock), split by the
        span in ``ATTRIBUTED`` that covers them, the first listed where two
        do; "unattributed" is idle time under none, "idle" the whole."""
        busy = union((max(a, self.lo), min(b, self.hi))
                     for a, b, _ in self.on_host_clock(ops, anchors))
        idle = subtract([(self.lo, self.hi)], busy)
        out = {"idle": length(idle) / 1e9}
        left = idle
        for name in ATTRIBUTED:
            inside = intersect(left, self.intervals(name))
            out[name] = length(inside) / 1e9
            left = subtract(left, inside)
        out["unattributed"] = length(left) / 1e9
        return out

    def clock_margins(self, ops) -> dict:
        """The clock check: each pinned host-to-device copy against the
        ``worker.upload`` span that issued it, and each batch's first K1
        launch against its ``worker.dispatch`` span, paired in order (a
        group's upload is one copy; a span over ``count`` batches launches
        K1 ``count`` times).  The least margins (ns, device start less span
        start) on the trace's own clock (``raw_``) and on the host's clock
        as the join aligns it; None where the counts do not pair.  Aligned,
        an anchored copy starts as its ``worker.copy`` span ends, inside its
        upload span, by construction: only the K1 margin and the copies that
        queued test the alignment there.  On the synchronous path, each
        batch's first device operation after its waited-for pageable copy
        against the next ``worker.dispatch`` span on that thread
        (``dispatch_margin_ns``): the copy anchors by its end, so only that
        margin tests the alignment there.  The anchors' errors, as the
        alignment takes them out, give the trace's drift."""
        pinned, waited = self._pinned_anchors(ops), self._waited_anchors(ops)
        anchors = sorted(pinned + waited)
        aligned = {id(o): a for a, _, o in self.on_host_clock(ops, anchors)}
        copies = _pinned_copies(ops)
        k1 = sorted((o for o in ops if o.kind == "kernel" and K1 in o.name),
                    key=lambda o: o.start_ns)
        uploads, dispatches = self._starts("worker.upload"), self._starts("worker.dispatch")
        paired = len(self._paired_copies(ops))
        out = {"copies": len(copies), "uploads": len(uploads), "k1": len(k1),
               "dispatched_batches": sum(c for _, c in dispatches), "anchors": len(pinned),
               "queued_copies": paired - len(pinned), "pageable_copies": len(_pageable_copies(ops)),
               "waited_pairs": len(self._paired_syncs(ops)), "waited_anchors": len(waited),
               "drift_ns": ([min(e for _, e in anchors), max(e for _, e in anchors)]
                            if anchors else None)}
        by_start = sorted(ops, key=lambda o: o.start_ns)
        starts = [o.start_ns for o in by_start]
        dispatch_starts = sorted((s.thread, s.start_ns) for s in self.spans
                                 if s.name == "worker.dispatch")
        after = []  # (the first operation after a waited copy, its dispatch's start)
        for copy, wait in self._paired_syncs(ops):
            i = bisect.bisect_left(starts, copy.end_ns)
            j = bisect.bisect_left(dispatch_starts, (wait.thread, wait.end_ns))
            if (i < len(by_start) and j < len(dispatch_starts)
                    and dispatch_starts[j][0] == wait.thread):
                after.append((by_start[i], dispatch_starts[j][1]))
        for clock, start in (("raw_", lambda o: o.start_ns - self.offset),
                             ("", lambda o: aligned[id(o)])):
            out[clock + "copy_margin_ns"] = (
                min(start(o) - u for o, (u, _) in zip(copies, uploads))
                if copies and len(copies) == len(uploads) else None)
            firsts, i = [], 0
            if k1 and len(k1) == out["dispatched_batches"]:
                for u, n in dispatches:
                    firsts.append(start(k1[i]) - u)
                    i += n
            out[clock + "k1_margin_ns"] = min(firsts) if firsts else None
            out[clock + "dispatch_margin_ns"] = (min(start(o) - d for o, d in after)
                                                 if after else None)
        return out


def probe(ctx) -> None:
    """Snapshot the window's spans into ``ctx["probes"]["worker_spans"]``
    (once for every reader)."""
    if "worker_spans" in ctx["probes"]:
        return
    rec, window = recorder(), ctx["window"]
    snap = None
    if rec is not None:
        lo, hi = int(window["start"] * 1e9), int(window["end"] * 1e9)
        spans = rec.spans(lo, hi)
        if spans:
            snap = WindowSpans(spans=spans, lo=lo, hi=hi, offset=rec.to_epoch_ns(0))
    ctx["probes"]["worker_spans"] = snap


def per_batch(ctx):
    """(the window's spans, its batch count), or None where there is
    nothing to read."""
    snap, batches = ctx["probes"].get("worker_spans"), len(ctx["window"]["batches"])
    return (snap, batches) if snap is not None and batches else None


def idle_shares(ctx):
    """The window's device-idle split as shares of the window (%), or None
    without device operations or spans, or where no copy anchors the
    trace's clock to the host's (``WindowSpans.anchors``)."""
    snap, trace = ctx["probes"].get("worker_spans"), ctx["trace"]
    if snap is None or trace is None or not trace.ops or trace.window_s <= 0:
        return None
    if "idle_split" not in ctx["probes"]:
        anchors = snap.anchors(trace.ops)
        ctx["probes"]["idle_split"] = snap.idle_split(trace.ops, anchors) if anchors else None
    split = ctx["probes"]["idle_split"]
    return None if split is None else {k: 100.0 * v / trace.window_s for k, v in split.items()}
