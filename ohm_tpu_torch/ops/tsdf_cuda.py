"""K5+K6 fused: the TSDF path's per-visit update in one call.

Replaces the per-visit chain of ``ohm_tpu/ops/integrate_tsdf.py``
(``:300-404``): K5's seed gather (``deposit_pallas.gather_planes_f32``),
``blocked.segment_sums`` of the visit weights, the visit maps,
``blocked.segment_compose_affine_clamp``, the composed map applied at each
voxel's last record, and K6's pair deposit (``deposit_pallas.tsdf_set_deposit``).
The kernel is in ``csrc/tsdf.cu``; the plain PyTorch version is
``tsdf_visits_reference``: K5's and K6's plain versions around
``ops.segments``, in the reference's order.  The wrapper runs the plain
version for tensors on the CPU and launches the kernel for tensors on a
CUDA device.
"""

from __future__ import annotations

import torch

from ohm_tpu_torch.ops import _build, deposit_cuda, gather_cuda, segments
from ohm_tpu_torch.ops.ddawalk import f32

#: A visit whose new weight is below this is skipped, and a voxel whose
#: running weight stays below it keeps its pair (the reference's near-zero
#: test, ohm/VoxelTsdfCompute.h:127).
NEAR_ZERO = f32(1e-5)
_BIG = f32(3.0e38)
#: The blocked scans' row width (ohm_tpu/ops/blocked.py), the kernel's rows.
ROW = 1024


def _scratch_words(n: int) -> int:
    """The kernel's scratch for ``n`` records, in 4-byte words (csrc/tsdf.cu):
    the row counter and two ready counts a 1024-record row, then each row's
    two columns of the carry table (7 words a level)."""
    rows = -(-n // ROW)
    levels = 1 + max(0, (rows - 1).bit_length())
    return 4 + 4 * -(-rows // 2) + 7 * rows * levels


def tsdf_visit_deposits(w0_s, d0_s, ids_s, w_s, wsdf_s, trunc: float, max_weight: float,
                        sentinel: int):
    """The chain between K5 and K6: from the batch-start pair gathered at
    every record (``w0_s``, ``d0_s``, K5's output), the (w, d) pair each
    record deposits: at each voxel's last record whose running weight
    reaches NEAR_ZERO, the clamped weight and the visits' composed map
    applied to the stored distance; +0.0 elsewhere.  Other arguments as
    ``tsdf_visits``."""
    if w_s is None:
        w_s = (ids_s != sentinel).to(torch.float32)
    first, last = segments._first_last(ids_s)
    w_run = w0_s + segments.segment_sums(w_s, first)
    # Running clamped weight before each visit: min(min(x, W) + u, W) ==
    # min(x + u, W) for u >= 0, so it telescopes to one min.
    wc_prev = torch.clamp(w_run - w_s, max=max_weight)
    new_w_vis = wc_prev + w_s
    alive_vis = new_w_vis >= NEAR_ZERO  # a skipped visit is the identity
    denom = torch.where(alive_vis, new_w_vis, torch.ones_like(new_w_vis))
    a_map = torch.where(alive_vis, wc_prev / denom, torch.ones_like(denom))
    b_map = torch.where(alive_vis, wsdf_s / denom, torch.zeros_like(denom))
    lo_map = torch.where(alive_vis, torch.full_like(denom, -trunc), torch.full_like(denom, -_BIG))
    hi_map = torch.where(alive_vis, torch.full_like(denom, trunc), torch.full_like(denom, _BIG))
    A, Bm, LO, HI = segments.segment_compose_affine_clamp(a_map, b_map, lo_map, hi_map, first)
    d_k = torch.minimum(torch.maximum(A * d0_s + Bm, LO), HI)
    w_k = torch.clamp(w_run, max=max_weight)
    upd = last & (w_run >= NEAR_ZERO) & (ids_s != sentinel)
    zero = torch.zeros((), dtype=torch.float32, device=ids_s.device)
    return torch.where(upd, w_k, zero), torch.where(upd, d_k, zero)


def tsdf_visits_reference(weight, distance, ids_s, w_s, wsdf_s, trunc: float,
                          max_weight: float, sentinel: int):
    """Plain PyTorch K5+K6 fused, in place: K5's plain gather,
    ``tsdf_visit_deposits``, K6's plain deposit.  Returns (weight, distance)."""
    w0_s, d0_s = gather_cuda.gather_planes_f32_reference((weight, distance), ids_s, sentinel)
    w, d = tsdf_visit_deposits(w0_s, d0_s, ids_s, w_s, wsdf_s, trunc, max_weight, sentinel)
    return deposit_cuda.tsdf_set_deposit_reference(weight, distance, ids_s, w, d, sentinel)


def _dense(t, dtype, device) -> bool:
    return t.dtype is dtype and t.dim() == 1 and t.is_contiguous() and t.device == device


def tsdf_visits(weight, distance, ids_s, w_s, wsdf_s, trunc: float, max_weight: float,
                sentinel: int):
    """Apply every visit of a sorted record stream to the TSDF planes
    ``weight`` and ``distance`` (f32[>= sentinel], updated in place).

    ``ids_s`` (i32[N]) ascends, its sentinel records last; ``w_s`` (f32[N])
    are the visit weights, or None for the uniform weighting (1.0 where the
    id is not the sentinel); ``wsdf_s`` (f32[N]) are weight * sdf.  Each
    voxel's visits apply in stream order, from its batch-start pair;
    ``trunc`` and ``max_weight`` are f32 values.  Returns (weight, distance)."""
    if ids_s.device.type == "cpu":
        return tsdf_visits_reference(weight, distance, ids_s, w_s, wsdf_s, trunc, max_weight,
                                     sentinel)
    dev = ids_s.device
    n = ids_s.shape[0]
    if not (all(_dense(p, torch.float32, dev) and p.shape[0] >= sentinel
                for p in (weight, distance))
            and _dense(ids_s, torch.int32, dev) and _dense(wsdf_s, torch.float32, dev)
            and wsdf_s.shape[0] == n
            and (w_s is None or (_dense(w_s, torch.float32, dev) and w_s.shape[0] == n))):
        raise ValueError("tsdf_visits takes contiguous f32[>= sentinel] planes and "
                         "contiguous i32 ids with f32 w (or None) and wsdf of their length, "
                         "on one CUDA device")
    if n == 0:
        return weight, distance
    scratch = torch.empty(_scratch_words(n), dtype=torch.int32, device=dev)
    rc = _build.entry("ohm_tsdf_visits")(
        weight.data_ptr(), distance.data_ptr(), ids_s.data_ptr(),
        None if w_s is None else w_s.data_ptr(), wsdf_s.data_ptr(), n, sentinel,
        trunc, max_weight, NEAR_ZERO, scratch.data_ptr(), _build.stream_of(ids_s))
    if rc:
        _build.check(rc, "tsdf_visits")
    tsdf_visits.launches += 1
    return weight, distance


#: Kernel launches since the count was last set to 0.
tsdf_visits.launches = 0
