"""K1 (csrc/expand.cu, the rayflow wire's walk) as a share of its roofline
in the traced window.

The work is what the traffic needs, counted by the reference's walk, not
from the kernel's arguments: each ray's inputs read once (its origin and
sample, 2 x 3 float32 = 24 bytes) and one 4-byte key written for each
voxel the ray passes through before its sample voxel (the walk's steps,
``BatchCounts.misses_total``; K1 emits no key for the sample voxel, whose
record the expand phase adds itself).  Operations: one multiply and one add
a step (the crossing time ``t0 + k * dt``).  The share is the least time
the card needs for that work over K1's device time.
"""

from ohmbench.peaks import peaks_of, roofline_share

UNIT = "%"
LAYER = "kernels (csrc/)"
MOVES = "rays_per_s"
SOURCE = "device_trace"
KERNELS = ("expand_keys_kernel",)


def work(counts) -> tuple:
    """(bytes, operations) of K1 over the BatchCounts ``counts``."""
    rays = sum(c.rays for c in counts)
    steps = sum(c.misses_total for c in counts)
    return 24 * rays + 4 * steps, 2 * steps


def read(ctx):
    trace = ctx["trace"]
    if trace is None:
        return None
    n_bytes, flops = work([ctx["counts"][i] for i in ctx["window"]["batches"]])
    return roofline_share(n_bytes, flops, trace.seconds_of(KERNELS), peaks_of(ctx["device_kind"]))
