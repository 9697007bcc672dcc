"""Host preparation of a batch in place: the time inside the program's
``worker.prep`` spans in the traced window (each batch's host half: the
native rayflow or segmented pass, the region allocation, the wire), over
the window's batches.  Unlike ``host_prep_ms_per_batch.stream`` it is the
prep as the worker runs it, on one thread with the dispatch of the batches
before it."""

from ohmbench import spans

UNIT = "ms"
LAYER = "host prep (mapping/batch, native/)"
MOVES = "rays_per_s"
SOURCE = "host_clock"


def probe(ctx, mapper):
    spans.probe(ctx)


def read(ctx):
    got = spans.per_batch(ctx)
    if got is None:
        return None
    snap, batches = got
    return snap.seconds("worker.prep") / batches * 1e3
