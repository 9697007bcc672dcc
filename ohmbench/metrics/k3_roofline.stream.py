"""K3 (csrc/deposit.cu ``end_table_kernel`` and ``ndt_run_deposit_kernel``,
NDT-OM's deposit and sweep with the miss delta) as a share of its roofline
in the traced window.

The work is what the traffic needs, counted by the reference: each visit's
4-byte key read once (every step of every ray and each ray's sample voxel:
``misses_total + rays``); each voxel a batch touches read and written once
(4 + 4 bytes); and each voxel that took NDT misses in the batch one 4-byte
key and one f32 delta read (``NdtReference.gauss_voxels``, known only as the
map is replayed).  Operations: the update's three multiply-adds and the
clamp, four a touched voxel.  The share is the least time the card needs
for that work over K3's device time.
"""

from ohmbench.peaks import peaks_of, roofline_share

UNIT = "%"
LAYER = "kernels (csrc/)"
MOVES = "rays_per_s"
SOURCE = "device_trace"
KERNELS = ("end_table_kernel", "ndt_run_deposit_kernel")


def work(counts, gauss_voxels: int) -> tuple:
    """(bytes, operations) of K3 over the BatchCounts ``counts`` with
    ``gauss_voxels`` voxel-batches of NDT misses."""
    visits = sum(c.misses_total + c.rays for c in counts)
    touched = sum(int(c.ids.shape[0]) for c in counts)
    return 4 * visits + 8 * touched + 8 * gauss_voxels, 4 * touched


def read(ctx):
    trace, batches = ctx["trace"], ctx["window"]["batches"]
    gauss = ctx.get("gauss_voxels")
    if trace is None or gauss is None or not batches:
        return None
    n_bytes, flops = work([ctx["counts"][i] for i in batches], sum(gauss[-len(batches):]))
    return roofline_share(n_bytes, flops, trace.seconds_of(KERNELS), peaks_of(ctx["device_kind"]))
