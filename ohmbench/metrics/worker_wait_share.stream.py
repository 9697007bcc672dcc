"""Share of the traced window in which the program's worker thread waited
for work: its ``worker.wait`` spans (blocked on an empty queue), cut to the
window, over the window's host seconds.  Near 0 where the worker sets the
pace."""

from ohmbench import spans

UNIT = "%"
LAYER = "asynchronous worker"
MOVES = "rays_per_s"
SOURCE = "host_clock"


def probe(ctx, mapper):
    spans.probe(ctx)


def read(ctx):
    snap, window_s = ctx["probes"].get("worker_spans"), ctx["window"]["seconds"]
    if snap is None or window_s <= 0:
        return None
    return 100.0 * snap.seconds("worker.wait") / window_s
