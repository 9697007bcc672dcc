"""The readers of the program's worker spans (``ohmbench/spans.py`` and the
seven metrics that read it), on hand-made spans and device operations whose
shares are worked out by hand, on the worker's pinned copies and on the
synchronous path's pageable ones; a CPU run in which the span and counter
readers find their spans; and, on the card, the clock check."""

import json
import os
import subprocess
import sys

import pytest

from ohm_tpu_torch.utils.profile import Span
from ohmbench import run, spans
from ohmbench.devicetrace import DeviceOp, WindowTrace
from conftest import ROOT, SMALL

#: The window [LO, HI] on perf_counter_ns, and the offset onto the trace's
#: clock.
LO, HI, OFFSET = 1_000_000, 1_010_000, 500
T = 1  # the worker's thread


def _span(name, start, end, sid, parent=None, batch=0, count=1):
    return Span(name, T, start, end, parent, batch, count, sid)


#: One batch: the worker waits, then prepares, uploads (issuing the copy at
#: the end of its worker.copy span) and dispatches it in one group; the
#: dispatch waits once on a read.  The group's last 1000 ns and the
#: window's last 1000 ns lie under no attributed span.
SPANS = [
    _span("worker.wait", 1_000_000, 1_001_000, 0, batch=None),
    _span("worker.prep", 1_001_000, 1_004_000, 2, parent=1),
    _span("worker.copy", 1_004_100, 1_004_300, 6, parent=3),
    _span("worker.upload", 1_004_000, 1_004_500, 3, parent=1),
    _span("sync", 1_006_000, 1_007_000, 5, parent=4),
    _span("worker.dispatch", 1_004_500, 1_008_000, 4, parent=1),
    _span("worker.group", 1_001_000, 1_009_000, 1),
]


def _op(start, end, name="k", kind="kernel"):
    return DeviceOp(name, kind, start + OFFSET, end + OFFSET)


PINNED = "Memcpy HtoD (Pinned -> Device)"
#: The copy, from its worker.copy span's end across the end of the upload
#: into the dispatch; a kernel inside the sync, one more kernel where no
#: span is.
OPS = [_op(1_004_300, 1_005_000, PINNED, "gpu_memcpy"),
       _op(1_006_500, 1_007_500), _op(1_009_200, 1_009_400)]

#: Worked out by hand (ns of the window's 10,000): busy 700 + 1000 + 200,
#: idle 8100 = wait 1000 + prep 3000 + upload 300 (500 less the copy's 200)
#: + dispatch 2000 (3500 less the copy's 500 and the kernel inside its
#: sync) + unattributed 1800 (2000 less 200).
IDLE_NS = {"worker.wait": 1000, "worker.prep": 3000, "worker.upload": 300,
           "worker.dispatch": 2000, "unattributed": 1800, "idle": 8100}


def _ctx(ops=OPS, span_list=SPANS, batches=1):
    window_s = (HI - LO) / 1e9
    snap = spans.WindowSpans(spans=list(span_list), lo=LO, hi=HI, offset=OFFSET)
    return {"window": {"start": LO / 1e9, "end": HI / 1e9, "seconds": window_s,
                       "batches": list(range(batches))},
            "trace": WindowTrace(ops=list(ops), window_s=window_s),
            "probes": {"worker_spans": snap}}


def test_interval_algebra():
    assert spans.union([(5, 7), (1, 3), (2, 4), (7, 8), (9, 9)]) == [(1, 4), (5, 8)]
    assert spans.intersect([(0, 4), (6, 10)], [(2, 7), (9, 12)]) == [(2, 4), (6, 7), (9, 10)]
    assert spans.subtract([(0, 10)], [(2, 3), (5, 6), (9, 12)]) == [(0, 2), (3, 5), (6, 9)]
    assert spans.subtract([(0, 2), (4, 6)], [(1, 5)]) == [(0, 1), (5, 6)]
    assert spans.length([(0, 2), (4, 7)]) == 5


def test_idle_split_by_hand():
    split = _ctx()["probes"]["worker_spans"].idle_split(OPS)
    assert split == pytest.approx({k: v / 1e9 for k, v in IDLE_NS.items()})
    assert sum(v for k, v in split.items() if k != "idle") == pytest.approx(split["idle"])


@pytest.mark.parametrize("name,value", [
    ("worker_prep_ms_per_batch.stream", 3000 / 1e6),
    ("worker_dispatch_ms_per_batch.stream", 2500 / 1e6),
    ("host_syncs_per_batch.stream", 1.0),
    ("worker_wait_share.stream", 10.0),
    ("device_idle_in_prep_share.stream", 30.0),
    ("device_idle_in_dispatch_share.stream", 20.0),
    ("device_idle_unattributed_share.stream", 18.0),
])
def test_reader_by_hand(name, value):
    assert run.load_metric(name).read(_ctx()) == pytest.approx(value)


def test_idle_shares_add_up_to_the_idle_share():
    ctx = _ctx()
    shares = spans.idle_shares(ctx)
    idle = run.load_metric("device_idle_share.stream").read(ctx)
    parts = sum(shares[k] for k in spans.ATTRIBUTED) + shares["unattributed"]
    assert parts == pytest.approx(idle) == pytest.approx(81.0)


def test_per_batch_readers_divide_by_the_windows_batches():
    ctx = _ctx(batches=4)
    assert run.load_metric("worker_prep_ms_per_batch.stream").read(ctx) == pytest.approx(
        3000 / 1e6 / 4)
    assert run.load_metric("host_syncs_per_batch.stream").read(ctx) == pytest.approx(0.25)


def test_spans_outside_the_window_are_cut_or_left_out():
    outside = [_span("worker.prep", LO - 5000, LO - 1000, 10),
               _span("worker.prep", HI - 500, HI + 4000, 11), _span("sync", HI + 10, HI + 20, 12)]
    ctx = _ctx(span_list=SPANS + outside)
    assert run.load_metric("worker_prep_ms_per_batch.stream").read(ctx) == pytest.approx(
        3500 / 1e6)
    assert run.load_metric("host_syncs_per_batch.stream").read(ctx) == 1.0


#: Two groups, each uploaded in one pinned copy issued inside a worker.copy
#: span; on the host's clock each copy starts as its span ends and K1 30 us
#: into each dispatch.  A third group's copy queues behind the second
#: group's last kernel.  (Times in units of U ns, from LO.)
U = 100
DRIFT_HI = LO + 20_000 * U


def _at(t):
    return LO + t * U


DRIFT_SPANS = [
    _span("worker.prep", _at(0), _at(1_000), 30),
    _span("worker.copy", _at(1_200), _at(1_300), 32, parent=31),
    _span("worker.upload", _at(1_000), _at(1_500), 31),
    _span("worker.dispatch", _at(1_500), _at(3_000), 33),
    _span("worker.prep", _at(3_000), _at(5_000), 34, batch=1),
    _span("worker.copy", _at(5_200), _at(5_300), 36, parent=35, batch=1),
    _span("worker.upload", _at(5_000), _at(5_500), 35, batch=1),
    _span("worker.dispatch", _at(5_500), _at(7_000), 37, batch=1),
    _span("worker.prep", _at(7_000), _at(7_020), 38, batch=2),
    _span("worker.copy", _at(7_030), _at(7_040), 40, parent=39, batch=2),
    _span("worker.upload", _at(7_020), _at(7_050), 39, batch=2),
    _span("worker.dispatch", _at(7_050), _at(8_100), 41, batch=2),
]
K1_NAME = "void expand_keys_kernel<1>(int*)"
TRUE_OPS = [(_at(1_300), _at(1_350), PINNED, "gpu_memcpy"),
            (_at(1_800), _at(2_000), K1_NAME, "kernel"),
            (_at(5_300), _at(5_350), PINNED, "gpu_memcpy"),
            (_at(5_800), _at(6_000), K1_NAME, "kernel"),
            (_at(6_500), _at(7_800), "k", "kernel"),
            (_at(7_800), _at(7_850), PINNED, "gpu_memcpy"),
            (_at(7_900), _at(8_000), K1_NAME, "kernel")]


def _drifted(t):
    """The trace's drift: none up to the first copy, then 2,000 U lost
    linearly by the second, held after it."""
    return -2000 * (min(max(t, _at(1_300)), _at(5_300)) - _at(1_300)) // 4000


def test_the_join_takes_the_traces_drift_out_on_the_copies():
    true_ops = [_op(a, b, name, kind) for a, b, name, kind in TRUE_OPS]
    drifted = [_op(a + _drifted(a), b + _drifted(a), name, kind) for a, b, name, kind in TRUE_OPS]
    snap = spans.WindowSpans(spans=DRIFT_SPANS, lo=LO, hi=DRIFT_HI, offset=OFFSET)
    # The third copy started as the kernel before it ended: it anchors
    # nothing, though the host issued it 760 U before.
    assert [e for _, e in snap.anchors(drifted)] == [0, -2000 * U]
    aligned = [(a, b) for a, b, _ in snap.on_host_clock(drifted)]
    assert aligned == [(a, b) for a, b, _, _ in TRUE_OPS]
    # The true trace pairs too, with no error: the same split.
    assert snap.idle_split(drifted) == pytest.approx(snap.idle_split(true_ops))
    got = snap.clock_margins(drifted)
    assert got["copies"] == got["uploads"] == 3
    assert (got["anchors"], got["queued_copies"]) == (2, 1)
    assert got["k1"] == got["dispatched_batches"] == 3
    assert got["drift_ns"] == [-2000 * U, 0]
    # On the trace's own clock the second copy and K1 seem to start 1,700 U
    # before the host issued them; aligned, 300 U after.
    assert (got["raw_copy_margin_ns"], got["raw_k1_margin_ns"]) == (-1700 * U, -1700 * U)
    assert (got["copy_margin_ns"], got["k1_margin_ns"]) == (300 * U, 300 * U)


def test_a_copy_that_queued_anchors_nothing():
    """Taken as an anchor, the third copy (queued 760 U behind its issue)
    would shift the trace by up to 760 U after the second copy."""
    true_ops = [_op(a, b, name, kind) for a, b, name, kind in TRUE_OPS]
    snap = spans.WindowSpans(spans=DRIFT_SPANS, lo=LO, hi=DRIFT_HI, offset=OFFSET)
    queued = spans._queued(true_ops)
    assert [o.start_ns - OFFSET for o in true_ops
            if id(o) in queued and o.kind == "gpu_memcpy"] == [_at(7_800)]
    assert [e for _, e in snap.anchors(true_ops)] == [0, 0]
    assert [a for a, _, _ in snap.on_host_clock(true_ops)] == [a for a, _, _, _ in TRUE_OPS]


def test_clock_margins_pair_a_chain_and_refuse_unpaired_counts():
    chained = SPANS + [_span("worker.dispatch", 1_008_200, 1_008_900, 21, batch=1, count=2)]
    k1 = [_op(s, s + 100, K1_NAME) for s in (1_004_700, 1_008_300, 1_008_500)]
    got = spans.WindowSpans(spans=chained, lo=LO, hi=HI, offset=OFFSET).clock_margins(OPS + k1)
    # The one copy starts as its worker.copy span ends: no error.
    assert (got["anchors"], got["queued_copies"], got["drift_ns"]) == (1, 0, [0, 0])
    assert got["k1"] == got["dispatched_batches"] == 3
    assert got["k1_margin_ns"] == got["raw_k1_margin_ns"] == 100
    assert got["copy_margin_ns"] == got["raw_copy_margin_ns"] == 300
    unpaired = spans.WindowSpans(spans=SPANS, lo=LO, hi=HI, offset=OFFSET).clock_margins(OPS + k1)
    assert unpaired["k1_margin_ns"] is None


PAGEABLE = "Memcpy HtoD (Pageable -> Device)"
#: Two batches on the synchronous path (times in U ns from LO): each goes up
#: in a pageable copy that a ``sync`` span inside its ``worker.upload``
#: waits for, so the copy ends as that span ends, and the second copy
#: starts as the kernel before it ends.  Each dispatch first makes a
#: pageable copy of a few bytes of its own (10 U, then 20 U into its span),
#: which no span waits for; the second dispatch waits once on a read.
SYNC_SPANS = [
    _span("worker.prep", _at(0), _at(1_000), 50),
    _span("worker.upload", _at(1_000), _at(1_500), 51),
    _span("sync", _at(1_010), _at(1_500), 52, parent=51),
    _span("worker.dispatch", _at(1_500), _at(3_000), 53),
    _span("worker.prep", _at(3_000), _at(5_000), 54, batch=1),
    _span("worker.upload", _at(5_000), _at(5_400), 55, batch=1),
    _span("sync", _at(5_010), _at(5_400), 56, parent=55, batch=1),
    _span("worker.dispatch", _at(5_400), _at(7_000), 57, batch=1),
    _span("sync", _at(6_000), _at(6_100), 58, parent=57, batch=1),
]
SYNC_TRUE_OPS = [(_at(1_100), _at(1_500), PAGEABLE, "gpu_memcpy"),
                 (_at(1_510), _at(1_511), PAGEABLE, "gpu_memcpy"),
                 (_at(1_530), _at(1_800), "k", "kernel"),
                 (_at(4_200), _at(4_700), "k", "kernel"),
                 (_at(4_700), _at(5_400), PAGEABLE, "gpu_memcpy"),
                 (_at(5_420), _at(5_421), PAGEABLE, "gpu_memcpy"),
                 (_at(5_450), _at(5_600), "k", "kernel")]


@pytest.mark.parametrize("error", [-700 * U, 0, 900 * U])
def test_the_synchronous_paths_copies_anchor_by_their_end(error):
    """The trace off the host's clock by ``error``: each waited-for copy
    anchors it, the one that queued too, the dispatches' own few-byte
    copies none, and the join puts every operation back where the host saw
    it."""
    true_ops = [_op(a, b, name, kind) for a, b, name, kind in SYNC_TRUE_OPS]
    off = [_op(a + error, b + error, name, kind) for a, b, name, kind in SYNC_TRUE_OPS]
    snap = spans.WindowSpans(spans=SYNC_SPANS, lo=LO, hi=DRIFT_HI, offset=OFFSET)
    assert [e for _, e in snap.anchors(off)] == [error, error]
    assert [(a, b) for a, b, _ in snap.on_host_clock(off)] == [
        (a, b) for a, b, _, _ in SYNC_TRUE_OPS]
    assert snap.idle_split(off) == pytest.approx(snap.idle_split(true_ops))
    got = snap.clock_margins(off)
    assert (got["copies"], got["anchors"], got["pageable_copies"], got["waited_anchors"]) == (
        0, 0, 4, 2)
    assert got["drift_ns"] == [error, error]
    assert got["raw_dispatch_margin_ns"] == 10 * U + error
    assert got["dispatch_margin_ns"] == 10 * U


def test_the_synchronous_paths_copies_pair_or_anchor_nothing():
    """One upload's ``sync`` span left out: the copies no longer pair with
    the spans, so none anchors and the device joins read nothing."""
    ops = [_op(a, b, name, kind) for a, b, name, kind in SYNC_TRUE_OPS]
    snap = spans.WindowSpans(spans=[s for s in SYNC_SPANS if s.id != 56], lo=LO,
                             hi=DRIFT_HI, offset=OFFSET)
    assert snap.anchors(ops) == []
    assert snap.clock_margins(ops)["dispatch_margin_ns"] is None
    ctx = _ctx(ops=ops, span_list=[s for s in SYNC_SPANS if s.id != 56])
    assert spans.idle_shares(ctx) is None


#: Ends of twelve uploads' waits (ms on the host's clock), a batch every
#: 15-40 ms, as the survey's synchronous path spaces them.
WAIT_ENDS_MS = [14.6, 46.8, 68.1, 95.7, 112.0, 140.3, 158.9, 190.2, 206.5, 238.8, 255.1, 290.0]


@pytest.mark.parametrize("dropped,unpaired", [
    ((), ()), ((0,), ()), ((0, 5), ()), ((3, 6), ()), ((11,), ()),
    # Two in a row break the chain; the three before them make no chain of
    # three gaps, so they stay unpaired.
    ((3, 4), (0, 1, 2)),
])
def test_pair_by_gaps_passes_over_the_copies_a_trace_dropped(dropped, unpaired):
    """The copies' ends on the trace's clock, 20 us late and drifting 2 ms
    over the window, less the ``dropped`` ones; and the same with the
    batches evenly spaced, where only the error tells a batch from the
    next: every copy paired is paired with its own wait, whatever the two
    counts."""
    for ends in (WAIT_ENDS_MS, [14.6 + 25.0 * n for n in range(len(WAIT_ENDS_MS))]):
        host = [int(t * 1e6) for t in ends]
        kept = [i for i in range(len(host)) if i not in dropped]
        trace = [host[i] + 20_000 + 2_000_000 * host[i] // host[-1] for i in kept]
        assert spans.pair_by_gaps(host, trace) == [
            (i, j) for j, i in enumerate(kept) if i not in unpaired]


def test_a_dropped_upload_copy_leaves_the_others_anchored():
    """Twelve batches on the synchronous path, the trace missing the first
    upload's copy: the other eleven anchor it, each with its own error."""
    waits, ops, sid = [], [], 100
    for n, end_ms in enumerate(WAIT_ENDS_MS):
        end = LO + int(end_ms * 1e6)
        waits += [_span("worker.upload", end - 500_000, end, sid, batch=n),
                  _span("sync", end - 400_000, end, sid + 1, parent=sid, batch=n),
                  _span("worker.dispatch", end, end + 300_000, sid + 2, batch=n)]
        sid += 3
        ops.append(_op(end - 300_000, end, PAGEABLE, "gpu_memcpy"))
        ops.append(_op(end + 400_000, end + 400_800, PAGEABLE, "gpu_memcpy"))
    every, ops = ops, ops[1:]
    snap = spans.WindowSpans(spans=waits, lo=LO, hi=LO + 300_000_000, offset=OFFSET)
    anchors = snap.anchors(ops)
    assert [a - OFFSET for a, _ in anchors] == [LO + int(t * 1e6) for t in WAIT_ENDS_MS[1:]]
    assert all(e == 0 for _, e in anchors)
    # Every copy in the trace, and the seventh upload's span ending 5 ms
    # late (its host waited for the interpreter's lock): that anchor reads
    # 5 ms off its neighbours' and is left out; the others stand.
    late = [w._replace(end_ns=w.end_ns + 5_000_000) if w.id in (118, 119) else w for w in waits]
    snap = spans.WindowSpans(spans=late, lo=LO, hi=LO + 300_000_000, offset=OFFSET)
    assert [a - OFFSET for a, _ in snap.anchors(every)] == [
        LO + int(t * 1e6) for n, t in enumerate(WAIT_ENDS_MS) if n != 6]


def test_device_joins_read_nothing_without_an_anchor():
    """Device operations and spans, but no copy to put the trace's clock on
    the host's: the copies do not pair with the worker.copy spans, or the
    only copy queued."""
    unpaired = _ctx(span_list=[s for s in SPANS if s.name != "worker.copy"])
    queued = _ctx(ops=[_op(1_004_000, 1_004_300), _op(1_004_300, 1_005_000, PINNED,
                                                      "gpu_memcpy")])
    for ctx in (unpaired, queued):
        assert spans.idle_shares(ctx) is None
        for name in NEW[4:]:
            assert run.load_metric(name).read(ctx) is None


def test_readers_read_nothing_without_spans_or_device_operations(monkeypatch):
    cpu = _ctx(ops=[])
    for name in ("device_idle_in_prep_share.stream", "device_idle_in_dispatch_share.stream",
                 "device_idle_unattributed_share.stream"):
        assert run.load_metric(name).read(cpu) is None
    # A program without the recorder (an older one): the probe leaves None
    # and no reader raises.
    monkeypatch.setattr(spans, "recorder", lambda: None)
    ctx = {"window": {"start": 0.0, "end": 1.0, "seconds": 1.0, "batches": [0]},
           "trace": WindowTrace(ops=OPS, window_s=1.0), "probes": {}}
    for mt in run.load_bench()["per_layer"]:
        if mt["name"] in NEW:
            reader = run.load_metric(mt["name"])
            reader.probe(ctx, None)
            assert reader.read(ctx) is None


NEW = ("worker_prep_ms_per_batch.stream", "worker_dispatch_ms_per_batch.stream",
       "host_syncs_per_batch.stream", "worker_wait_share.stream",
       "device_idle_in_prep_share.stream", "device_idle_in_dispatch_share.stream",
       "device_idle_unattributed_share.stream")


@pytest.mark.parametrize("workload", list(SMALL))
def test_cpu_traced_run_reads_the_worker_spans(workload):
    out = run.run_cell(workload, 47, 1.0, True, device="cpu", overrides=SMALL[workload])
    got = out["metrics"]
    for name in NEW[:4]:
        assert got[name]["value"] >= 0, name
    assert got["worker_prep_ms_per_batch.stream"]["value"] > 0
    assert got["worker_dispatch_ms_per_batch.stream"]["value"] > 0
    # No device on the CPU: the device joins find nothing to read.
    assert not set(NEW[4:]) & set(got)


def test_card_clock_check(card):
    """On the card, at the cell's own size: the trace aligns on the worker's
    copies (some copy anchors it), and aligned, each batch's first K1
    launch starts no earlier than the dispatch span that issued it, less
    the slack."""
    from ohmbench import spancheck

    workload = run.load_bench()["workloads"][0]["name"]
    mapper, pool, sync = spancheck.prepare(workload, 49, card)
    got = spancheck.traced(mapper, pool, 2.0, sync)
    clock = got["clock"]
    assert clock["copies"] == clock["uploads"] > 0, clock
    assert clock["anchors"] > 0 and clock["anchors"] + clock["queued_copies"] == clock["copies"], clock
    assert clock["k1_margin_ns"] is not None, clock
    assert clock["k1_margin_ns"] >= -spans.CLOCK_SLACK_NS, clock


test_card_clock_check = pytest.mark.cuda(test_card_clock_check)


def test_card_clock_check_on_the_synchronous_path(card, tmp_path):
    """On the card, in the survey cell (the segmented wire, integrated
    synchronously on the worker), in a process whose one traced window it
    is, as in every benchmark run (a process's later traced windows drop
    copies and read the trace's clock ms off): the uploads' waited-for
    pageable copies anchor the trace, and aligned, each dispatch's first
    device operation starts no earlier than its span, less the slack."""
    out = tmp_path / "spancheck.json"
    subprocess.run([sys.executable, os.path.join(ROOT, "ohmbench", "spancheck.py"),
                    "--workload", "occ-survey-stream", "--seed", "51", "--cost-seconds", "0",
                    "--out", str(out)], check=True, timeout=900, stdout=subprocess.DEVNULL)
    got = json.loads(out.read_text())["traced"]
    clock = got["clock"]
    uploads = got["spans"]["worker.upload"]
    assert uploads > 0 and clock["waited_anchors"] >= 0.9 * uploads, clock
    assert clock["dispatch_margin_ns"] is not None, clock
    assert clock["dispatch_margin_ns"] >= -spans.CLOCK_SLACK_NS, clock
    assert got["idle_split_share"] is not None, got


test_card_clock_check_on_the_synchronous_path = pytest.mark.cuda(
    test_card_clock_check_on_the_synchronous_path)
