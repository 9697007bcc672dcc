"""Share of the traced window's batches that the program integrated by
replaying a captured CUDA graph: the batches its ``graph.replay`` spans
cover (each span counted in its ``graph_replays`` counter), over the
window's batches.  The rest were issued kernel by kernel from Python.  A
program whose mapper has no graph cache (``graphs``) reads nothing."""

from ohmbench import spans

UNIT = "%"
LAYER = "dispatch (ops/)"
MOVES = "rays_per_s"
SOURCE = "program_counter"


def probe(ctx, mapper):
    spans.probe(ctx)
    ctx["probes"]["has_graphs"] = hasattr(mapper, "graphs")


def read(ctx):
    got = spans.per_batch(ctx)
    if got is None or not ctx["probes"].get("has_graphs"):
        return None
    snap, batches = got
    replayed = sum(s.count for s in snap.spans
                   if s.name == "graph.replay" and snap.lo <= s.start_ns <= snap.hi)
    return 100.0 * replayed / batches
