"""Host preparation of a batch, alone: the mapper's host half of a batch
(the rayflow set-up, or the segmented one where the rayflow wire declines
the batch) on the window's first batches, after the window, the map
already resident, timed by the benchmark on the host clock with the cyclic
collector off.  Nothing else runs beside it, so it is what a batch costs
the host when the worker does not overlap it.

The mapper's host half has no public entry point of its own: this reader
calls the two methods the worker calls (``_rayflow_setup_host``, then
``_segmented_setup_host`` where the first declines), and raises, naming
them, where the mapper no longer has them, so that the traced run fails
rather than leave the metric out unseen."""

import gc
import time

UNIT = "ms"
LAYER = "host prep (mapping/batch, native/)"
MOVES = "rays_per_s"
SOURCE = "host_clock"
#: Batches timed: enough to span 250 ms of host clock at a few ms each.
BATCHES = 96


#: The mapper's methods that make a batch's host half, in the order tried.
HOOKS = ("_rayflow_setup_host", "_segmented_setup_host")


def probe(ctx, mapper):
    missing = [h for h in HOOKS if not callable(getattr(mapper, h, None))]
    if missing:
        raise AttributeError(
            f"{type(mapper).__name__} has no {', '.join(missing)}: host_prep_ms_per_batch.stream "
            "times the mapper's host half through them; point its reader at what replaced them")
    rayflow, segmented = (getattr(mapper, h) for h in HOOKS)
    batches = ctx["window"]["batches"][:BATCHES]
    if not batches:
        return
    pool = ctx["pool"]
    gc.collect()
    gc.disable()
    try:
        t0 = time.perf_counter()
        for i in batches:
            if rayflow(pool[i], None, None, 0) is None:
                segmented(pool[i], None, None, 0)
        ctx["probes"]["host_prep_ms"] = (time.perf_counter() - t0) / len(batches) * 1e3
    finally:
        gc.enable()


def read(ctx):
    return ctx["probes"].get("host_prep_ms")
