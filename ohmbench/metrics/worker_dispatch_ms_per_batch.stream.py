"""Python dispatch of a batch: the time inside the program's
``worker.dispatch`` spans in the traced window (decode to the last launch
of a batch or chained group, the auto-sizing included), less the time
inside their ``sync`` children (blocking reads, which wait on the device),
over the window's batches."""

from ohmbench import spans

UNIT = "ms"
LAYER = "dispatch (ops/)"
MOVES = "rays_per_s"
SOURCE = "host_clock"


def probe(ctx, mapper):
    spans.probe(ctx)


def read(ctx):
    got = spans.per_batch(ctx)
    if got is None:
        return None
    snap, batches = got
    return snap.seconds("worker.dispatch", less="sync") / batches * 1e3
