"""Device operations (kernels, copies, memsets) the traced window ran, a
batch: the program's dispatch cost in launches."""

UNIT = "ops"
LAYER = "dispatch (ops/)"
MOVES = "rays_per_s"
SOURCE = "device_trace"


def read(ctx):
    trace, batches = ctx["trace"], len(ctx["window"]["batches"])
    if trace is None or not trace.ops or not batches:
        return None
    return len(trace.ops) / batches
