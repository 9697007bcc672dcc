"""The span recorder inside ohm_tpu_torch (utils/profile.py) and the
worker's spans and host-sync counters, on the CPU.

  switch      with no profiler running the worker leaves no span and no
              counter; under torch.profiler, or after ``record(True)``, it
              records
  batches     each batch has exactly one ``worker.prep`` span and lies in
              exactly one ``worker.dispatch`` span (a chain's covers its
              group), under the number the mapper gave it
  nesting     each child span lies inside its parent, on its thread
  syncs       ``host_syncs`` counts the ``sync`` spans
  bound       the buffer keeps ``span_limit`` spans and counts the drops
  clock       ``to_epoch_ns`` puts a ``perf_counter_ns`` reading within 1 ms
              of ``time.time_ns()``"""

import sys
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from ohm_tpu_torch import TorchNdtMap, TorchRayMapper
from ohm_tpu_torch.core.map import MapFlag, OccupancyMap
from ohm_tpu_torch.utils.profile import Profile

def _batches(n, rays=128, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        b = np.zeros((2 * rays, 3))
        b[1::2] = rng.uniform(-2, 2, (rays, 3))
        out.append(b)
    return out


def _mapper(cls=TorchRayMapper, flags=MapFlag.NONE, **kw):
    # 1.6 m regions: the scene's ~30 regions stay resident (no eviction).
    return cls(OccupancyMap(resolution=0.1, region_voxel_dims=16, flags=flags),
               capacity=256, device="cpu", **kw)


@pytest.fixture
def recorder():
    rec = Profile.instance()
    rec.record(False)
    rec.reset()
    yield rec
    rec.record(False)
    rec.reset()


def _profiled(mapper, batches, synchronous=0):
    """Integrate ``batches`` through the worker (the last ``synchronous``
    by ``integrate_rays``) under torch.profiler; returns the batch numbers
    the mapper gave them."""
    first = mapper._batches_taken
    with profile(activities=[ProfilerActivity.CPU]):
        for b in batches[:len(batches) - synchronous]:
            mapper.integrate_rays_async(b)
        mapper.flush()
        for b in batches[len(batches) - synchronous:]:
            mapper.integrate_rays(b)
    mapper.flush()
    return list(range(first, mapper._batches_taken))


def test_without_a_profiler_the_worker_records_nothing(recorder):
    mapper = _mapper(rayflow=True)
    for b in _batches(6):
        mapper.integrate_rays_async(b)
    mapper.integrate_rays(_batches(1, seed=1)[0])
    mapper.sync_voxels()
    assert not recorder.enabled
    assert recorder.spans() == [] and recorder.counters() == {}


CASES = {
    "rayflow": dict(rayflow=True),
    "segmented": dict(rayflow=False),
    "rayflow_traversal": dict(rayflow=True, flags=MapFlag.TRAVERSAL),
    "ndt": dict(cls=TorchNdtMap, rayflow=True),
}


@pytest.mark.parametrize("case", list(CASES))
def test_each_batch_has_one_prep_and_one_dispatch_under_its_number(recorder, case):
    mapper = _mapper(**CASES[case])
    warm = _batches(4, seed=2)
    for b in warm:  # sizes the windows; recorded by nobody
        mapper.integrate_rays(b)
    numbers = _profiled(mapper, _batches(10), synchronous=2)
    assert numbers == list(range(4, 14))
    spans = recorder.spans()
    assert {s.name for s in spans} >= {"worker.group", "worker.prep", "worker.upload",
                                       "worker.dispatch"}
    preps = sorted(s.batch for s in spans if s.name == "worker.prep")
    assert preps == numbers
    covered = sorted(b for s in spans if s.name == "worker.dispatch"
                     for b in range(s.batch, s.batch + s.count))
    assert covered == numbers
    groups = [s for s in spans if s.name == "worker.group"]
    assert sum(s.count for s in groups) == 8  # the synchronous calls form no group
    worker = {s.thread for s in spans if s.name == "worker.group"}
    assert worker and threading.get_ident() not in worker


def test_a_group_keeps_each_items_own_number(recorder):
    """A group whose queued numbers have gaps (another caller took numbers
    between them) labels each batch with its own."""
    mapper = _mapper(rayflow=True)
    numbers = [3, 5, 9]
    recorder.record(True)
    mapper._integrate_group([(b, None, None, 0, n) for b, n in zip(_batches(3), numbers)])
    spans = recorder.spans()
    assert sorted(s.batch for s in spans if s.name == "worker.prep") == numbers
    # Three of OHM_COALESCE's four: no chain, one dispatch span a batch.
    assert sorted(s.batch for s in spans if s.name == "worker.dispatch") == numbers
    assert [(s.batch, s.count) for s in spans if s.name == "worker.group"] == [(3, 3)]


def test_draining_the_stats_is_one_sync(recorder):
    mapper = _mapper(rayflow=True)
    for b in _batches(3):
        mapper.integrate_rays(b)
    recorder.record(True)
    mapper.stats
    mapper.stats  # nothing left to read: no sync
    assert [s.name for s in recorder.spans()] == ["sync"]
    assert recorder.counters() == {"host_syncs": 1}


@pytest.mark.parametrize("case", list(CASES))
def test_child_spans_lie_inside_their_parents_on_one_thread(recorder, case):
    mapper = _mapper(**CASES[case])
    _profiled(mapper, _batches(9), synchronous=1)
    spans = recorder.spans()
    by_id = {s.id: s for s in spans}
    children = [s for s in spans if s.parent is not None]
    assert children
    for s in children:
        parent = by_id[s.parent]
        assert parent.thread == s.thread
        assert parent.start_ns <= s.start_ns <= s.end_ns <= parent.end_ns
    for s in spans:
        if s.name in ("worker.prep", "worker.upload") and s.parent is not None:
            assert by_id[s.parent].name == "worker.group"


@pytest.mark.parametrize("case", ["rayflow_traversal", "segmented"])
def test_host_syncs_counts_the_sync_spans(recorder, case):
    """The traversal layer's split apply compacts its voxel-lasts with a
    nonzero (a read back each batch); the synchronous path's uploads are
    blocking copies."""
    mapper = _mapper(**CASES[case])
    _profiled(mapper, _batches(6), synchronous=2)
    syncs = [s for s in recorder.spans() if s.name == "sync"]
    assert syncs
    assert recorder.counters()["host_syncs"] == len(syncs)
    assert all(s.parent is not None for s in syncs)


def test_record_turns_recording_on_without_a_profiler(recorder):
    mapper = _mapper(rayflow=True)
    recorder.record(True)
    for b in _batches(3):
        mapper.integrate_rays_async(b)
    mapper.flush()
    assert recorder.enabled
    assert sum(s.name == "worker.prep" for s in recorder.spans()) == 3
    recorder.record(False)
    off = time.perf_counter_ns()
    for b in _batches(3):
        mapper.integrate_rays_async(b)
    mapper.flush()
    # A span opened while recording was on (the worker's wait) still closes.
    assert not recorder.enabled and recorder.spans(since_ns=off + 1) == [
        s for s in recorder.spans() if s.name == "worker.wait" and s.start_ns < off < s.end_ns]


def test_an_off_recorder_hands_out_one_shared_marker():
    rec = Profile()
    rec.enabled = False
    assert rec.span("a") is rec.span("b") is rec.sync()
    with rec.span("a"):
        rec.count("n")
    assert rec.spans() == [] and rec.counters() == {}


def test_the_buffer_keeps_its_bound_and_counts_drops():
    rec = Profile()
    rec.span_limit = 4
    with rec.span("outer", batch=7, count=2):
        for _ in range(9):
            with rec.span("inner"):
                rec.count("inner_calls")
    spans = rec.spans()
    assert len(spans) == 4 and all(s.name == "inner" and s.batch is None for s in spans)
    assert rec.counters() == {"inner_calls": 9, "spans_dropped": 6}


def test_spans_carry_their_batch_count_parent_and_window():
    rec = Profile()
    rec.set_batch(3)
    t0 = time.perf_counter_ns()
    with rec.span("group", batch=5, count=4):
        with rec.span("step"):
            pass
    t1 = time.perf_counter_ns()
    with rec.span("later"):
        pass
    step, group, later = rec.spans()
    assert (group.batch, group.count, group.parent) == (5, 4, None)
    assert (step.batch, step.count, step.parent) == (3, 1, group.id)
    assert t0 <= group.start_ns <= step.start_ns <= step.end_ns <= group.end_ns <= t1
    assert rec.spans(t0, t1) == [step, group]
    assert rec.spans(later.start_ns) == [later]


def test_counters_and_spans_hold_under_many_threads():
    """More threads than cores, switching every microsecond: no count is
    lost and every thread's spans nest on that thread."""
    rec = Profile()
    n_threads, n = 32, 500

    def work():
        for _ in range(n):
            with rec.span("outer"):
                rec.count("n")
                with rec.span("inner"):
                    rec.count("n", 2)

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in threads)
    assert rec.counters() == {"n": 3 * n * n_threads}
    spans = rec.spans()
    assert len(spans) == 2 * n * n_threads
    by_id = {s.id: s for s in spans}
    for s in spans:
        if s.name == "inner":
            parent = by_id[s.parent]
            assert parent.name == "outer" and parent.thread == s.thread
            assert parent.start_ns <= s.start_ns <= s.end_ns <= parent.end_ns
        else:
            assert s.parent is None


def test_the_clock_maps_onto_the_unix_epoch():
    rec = Profile.instance()
    for _ in range(5):
        assert abs(rec.to_epoch_ns(time.perf_counter_ns()) - time.time_ns()) < 1_000_000


def test_the_clock_matches_the_profilers_cpu_events(recorder):
    """A span and the profiler's event of the operator it wraps, on one
    clock: the event lies inside the span, to within 1 ms."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        recorder.refresh()
        with recorder.span("add"):
            torch.ones(4096).add_(1)
    recorder.refresh()
    span = next(s for s in recorder.spans() if s.name == "add")
    ev = next(e for e in prof.profiler.kineto_results.events() if e.name() == "aten::add_")
    lo, hi = recorder.to_epoch_ns(span.start_ns), recorder.to_epoch_ns(span.end_ns)
    assert lo - 1_000_000 <= ev.start_ns() <= hi + 1_000_000


def test_report_sums_the_spans_by_path():
    rec = Profile()
    for _ in range(3):
        with rec.span("outer"):
            with rec.span("inner"):
                pass
    lines = rec.report().splitlines()
    assert [line.split(":")[0] for line in lines] == ["outer", "  inner"]
    assert all(line.endswith("(3 calls)") for line in lines)
