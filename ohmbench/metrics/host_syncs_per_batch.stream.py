"""Blocking device reads and copies a batch: the program's ``sync`` spans
that start in the traced window (each one counted in its ``host_syncs``
counter), over the window's batches.  Each one stops the host until the
device has caught up."""

from ohmbench import spans

UNIT = "syncs"
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
    return snap.count("sync") / batches
