"""K2 (csrc/deposit.cu ``run_deposit_kernel``, the occupancy deposit and
sweep) as a share of its roofline in the traced window.

The work is what the traffic needs, counted by the reference's walk: each
visit's 4-byte key read once (every step of every ray and each ray's sample
voxel: ``misses_total + rays``), and each voxel a batch touches read and
written once (4 + 4 bytes; ``len(BatchCounts.ids)``).  Operations: the
update's two multiplies and two adds a touched voxel.  The share is the
least time the card needs for that work over K2's device time.
"""

from ohmbench.peaks import peaks_of, roofline_share

UNIT = "%"
LAYER = "kernels (csrc/)"
MOVES = "rays_per_s"
SOURCE = "device_trace"
KERNELS = ("run_deposit_kernel",)


def work(counts) -> tuple:
    """(bytes, operations) of K2 over the BatchCounts ``counts``."""
    visits = sum(c.misses_total + c.rays for c in counts)
    touched = sum(int(c.ids.shape[0]) for c in counts)
    return 4 * visits + 8 * touched, 4 * touched


def read(ctx):
    trace = ctx["trace"]
    if trace is None:
        return None
    n_bytes, flops = work([ctx["counts"][i] for i in ctx["window"]["batches"]])
    return roofline_share(n_bytes, flops, trace.seconds_of(KERNELS), peaks_of(ctx["device_kind"]))
