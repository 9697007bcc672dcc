"""``graph_replay_share.stream``: the batches the program's ``graph.replay``
spans cover over the window's batches, on hand-made spans; nothing from a
program without the graph cache; 0 in a CPU run, where no graph engages."""

from ohm_tpu_torch.utils.profile import Span
from ohmbench import run, spans
from conftest import SMALL

NAME = "graph_replay_share.stream"
LO, HI = 1_000_000, 1_010_000


def _ctx(span_list, batches, has_graphs=True):
    snap = spans.WindowSpans(spans=span_list, lo=LO, hi=HI, offset=0)
    return {"window": {"start": LO / 1e9, "end": HI / 1e9, "seconds": (HI - LO) / 1e9,
                       "batches": list(range(batches))},
            "trace": None, "probes": {"worker_spans": snap, "has_graphs": has_graphs}}


def _replay(start, count, sid):
    return Span("graph.replay", 1, start, start + 100, None, 0, count, sid)


def test_share_of_the_windows_batches_by_hand():
    # Two chains of four replayed, one before the window (left out); ten
    # batches submitted in the window.
    got = [_replay(1_001_000, 4, 0), _replay(1_005_000, 4, 1), _replay(900_000, 4, 2)]
    assert run.load_metric(NAME).read(_ctx(got, 10)) == 80.0
    assert run.load_metric(NAME).read(_ctx([], 10)) == 0.0


def test_reads_nothing_without_the_graph_cache():
    reader = run.load_metric(NAME)
    assert reader.read(_ctx([_replay(1_001_000, 4, 0)], 4, has_graphs=False)) is None
    ctx = {"window": {"start": 0.0, "end": 1.0, "seconds": 1.0, "batches": [0]},
           "trace": None, "probes": {}}
    reader.probe(ctx, object())  # a mapper of a program without graphs
    assert ctx["probes"]["has_graphs"] is False and reader.read(ctx) is None


def test_cpu_traced_run_reads_no_replay():
    out = run.run_cell("occ-box-stream", 47, 1.0, True, device="cpu",
                       overrides=SMALL["occ-box-stream"])
    assert out["metrics"][NAME]["value"] == 0.0
