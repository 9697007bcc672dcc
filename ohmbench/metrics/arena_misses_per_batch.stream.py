"""Regions the arena allocated in the traced window, a batch: the arena's
``misses`` counter (``mapping/arena.py``: a batch's region not yet resident)
over the window, read before and after it, over the window's batches.  A
map held resident from the warm-up reads 0; a survey that drives into new
ground allocates as it goes."""

UNIT = "regions"
LAYER = "arena (mapping/arena)"
MOVES = "rays_per_s"
SOURCE = "program_counter"


def read(ctx):
    before, after = ctx["arena"]["before"], ctx["arena"]["after"]
    batches = len(ctx["window"]["batches"])
    if "misses" not in after or not batches:
        return None
    return (after["misses"] - before["misses"]) / batches
