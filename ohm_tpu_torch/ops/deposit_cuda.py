"""K2 and K3, the deposit-and-sweep kernels: per-voxel hit/miss counts,
then the occupancy update in place.  K2 serves the occupancy mapper, K3
(``deposit_and_sweep_ndt``) the NDT mapper.

Replaces ``ohm_tpu/ops/deposit_pallas.py`` ``deposit_and_sweep``
(``_deposit_core`` with ``_sweep_block``).  The CUDA kernels are in
``csrc/deposit.cu``; the plain PyTorch version is
``deposit_and_sweep_reference`` (int32 ``index_add_`` counts + ``sweep``).

The kernel reads a key stream sorted ascending, as the TPU kernel's
``key_sorted`` is: a voxel's counts are then the lengths of two adjacent
runs, which the record that ends the run reads off positions, with no count
plane and no atomic.  It updates each touched voxel in the reference's f32
op order (deposit_pallas.py:57-95 = integrate.py:625-663) against its
batch-start value; voxels without records are neither read nor written.
Unobserved voxels hold -0.0.

K3 replaces ``deposit_pallas.py`` ``deposit_and_sweep_ndt`` (``_deposit_core``
with ``key2_sorted`` and ``delta_stream``, ``_ndt_sweep_block``); its plain
version is ``deposit_and_sweep_ndt_reference``.  The kernel reads the
walk stream's runs as K2 reads its stream (with the reference's bounds
stream, the walk unmasked), counts the end keys into a small table, and
a per-voxel f32 miss delta joins the total; the update (``ndt_sweep``)
marks unobserved as +inf and has no exclude flags.

K6 (``tsdf_set_deposit``) replaces ``deposit_pallas.py`` ``tsdf_set_deposit``;
its plain version is ``tsdf_set_deposit_reference``.  It sets the TSDF
(weight, distance) pair of each voxel in place from the one record per voxel
that carries a weight > 0; every other voxel keeps its stored pair.
"""

from __future__ import annotations

import torch

from ohm_tpu_torch.core.rayflags import RayFlag
from ohm_tpu_torch.ops import _build
from ohm_tpu_torch.ops.config import IntegrateConfig

#: Counts saturate here before the multiply (the reference packs each count
#: into 16 bits).
COUNT_CAP = 65535.0


def sweep(initial, hit_cnt, miss_cnt, cfg: IntegrateConfig):
    """Occupancy update of a span of voxels from its int32 counts, in the
    reference's f32 op order (each op separately rounded)."""
    flags = cfg.ray_flags
    n_hit = torch.clamp(hit_cnt.to(torch.float32), max=COUNT_CAP)
    n_miss = torch.clamp(miss_cnt.to(torch.float32), max=COUNT_CAP)
    unobs = (initial == 0) & torch.signbit(initial)
    zero = torch.zeros_like(initial)
    hit_eff = torch.full_like(initial, cfg.hit_value)
    miss_eff = torch.full_like(initial, cfg.miss_value)
    if flags & RayFlag.EXCLUDE_FREE:
        free = ~unobs & (initial < cfg.occupancy_threshold)
        hit_eff = torch.where(free, zero, hit_eff)
        miss_eff = torch.where(free, zero, miss_eff)
    if flags & RayFlag.EXCLUDE_OCCUPIED:
        occd = ~unobs & (initial >= cfg.occupancy_threshold)
        hit_eff = torch.where(occd, zero, hit_eff)
        miss_eff = torch.where(occd, zero, miss_eff)
    total = n_hit * hit_eff + n_miss * miss_eff
    value = torch.where(unobs, zero, initial) + total
    # One-sided clamp by the sign of the net adjustment.
    value = torch.where(total > 0, torch.clamp(value, max=cfg.max_value), value)
    value = torch.where(total < 0, torch.clamp(value, min=cfg.min_value), value)
    touched = (hit_cnt + miss_cnt) > 0
    saturated = ~unobs & ((initial <= cfg.saturation_min)
                          | (initial >= cfg.saturation_max))
    keep = ~touched | saturated
    if flags & RayFlag.EXCLUDE_UNOBSERVED:
        keep = keep | unobs
    return torch.where(keep, initial, value)


def deposit_and_sweep_reference(occupancy, key_sorted, cfg: IntegrateConfig):
    """Plain PyTorch K2 on ``occupancy[:sentinel]`` (updated in place).
    Returns (occupancy, touched i32 0-dim: distinct voxels with records)."""
    n = cfg.sentinel
    flat = key_sorted >> 1
    live = (flat >= 0) & (flat < n)
    is_hit = (key_sorted & 1) == 1
    counts = []
    for sel in (live & is_hit, live & ~is_hit):
        idx = flat[sel].long()
        plane = torch.zeros(n, dtype=torch.int32, device=occupancy.device)
        counts.append(plane.index_add_(0, idx, torch.ones_like(idx, dtype=torch.int32)))
    hit_cnt, miss_cnt = counts
    occupancy[:n] = sweep(occupancy[:n], hit_cnt, miss_cnt, cfg)
    touched = ((hit_cnt + miss_cnt) > 0).sum().to(torch.int32)
    return occupancy, touched


def deposit_and_sweep(occupancy, key_sorted, cfg: IntegrateConfig):
    """Deposit the (flat << 1 | hit) key stream and sweep ``occupancy``
    (f32[>= sentinel + 1], updated in place; the sentinel element and
    anything beyond are never written).  The keys must be sorted ascending
    (the kernel reads each voxel's counts off its run; the plain version
    takes any order).  Keys whose flat lies outside [0, sentinel) are
    skipped.

    Returns (occupancy, touched i32 0-dim)."""
    if occupancy.device.type == "cpu":
        return deposit_and_sweep_reference(occupancy, key_sorted, cfg)
    if not (occupancy.dtype == torch.float32 and occupancy.dim() == 1
            and occupancy.is_contiguous() and occupancy.shape[0] > cfg.sentinel):
        raise ValueError("occupancy must be a contiguous f32[> sentinel] tensor")
    if not (key_sorted.dtype == torch.int32 and key_sorted.dim() == 1
            and key_sorted.is_contiguous() and key_sorted.device == occupancy.device):
        raise ValueError("keys must be a contiguous i32[N] tensor on the arena's device")
    touched = torch.empty(1, dtype=torch.int32, device=occupancy.device)
    rc = _build.load().ohm_deposit_and_sweep(
        occupancy.data_ptr(), key_sorted.data_ptr(), key_sorted.shape[0],
        cfg.sentinel, int(cfg.ray_flags),
        cfg.hit_value, cfg.miss_value, cfg.occupancy_threshold,
        cfg.min_value, cfg.max_value, cfg.saturation_min, cfg.saturation_max,
        touched.data_ptr(), _build.stream_of(occupancy))
    _build.check(rc, "deposit_and_sweep")
    deposit_and_sweep.launches += 1
    return occupancy, touched[0]


#: Kernel launches since the count was last set to 0.
deposit_and_sweep.launches = 0


def ndt_sweep(initial, hit_cnt, miss_cnt, delta, cfg: IntegrateConfig):
    """NDT occupancy update of a span of voxels (deposit_pallas.py:98-119):
    +inf unobserved, total = (n_hit * hit + n_miss * miss) + delta rounded
    three times, the one-sided clamp, saturated voxels kept."""
    n_hit = torch.clamp(hit_cnt.to(torch.float32), max=COUNT_CAP)
    n_miss = torch.clamp(miss_cnt.to(torch.float32), max=COUNT_CAP)
    unobs = torch.isposinf(initial)
    total = n_hit * cfg.hit_value
    total = total + n_miss * cfg.miss_value
    total = total + delta
    value = torch.where(unobs, torch.zeros_like(initial), initial) + total
    value = torch.where(total > 0, torch.clamp(value, max=cfg.max_value), value)
    value = torch.where(total < 0, torch.clamp(value, min=cfg.min_value), value)
    touched = ((hit_cnt + miss_cnt) > 0) | (delta != 0)
    saturated = ~unobs & ((initial <= cfg.saturation_min)
                          | (initial >= cfg.saturation_max))
    return torch.where(~touched | saturated, initial, value)


def _count_planes(n: int, streams, device):
    """int32 hit and miss count planes [n] of (flat << 1 | hit) streams."""
    hit = torch.zeros(n, dtype=torch.int32, device=device)
    miss = torch.zeros(n, dtype=torch.int32, device=device)
    for keys in streams:
        flat = keys >> 1
        live = (flat >= 0) & (flat < n)
        is_hit = (keys & 1) == 1
        for plane, sel in ((hit, live & is_hit), (miss, live & ~is_hit)):
            idx = flat[sel].long()
            plane.index_add_(0, idx, torch.ones_like(idx, dtype=torch.int32))
    return hit, miss


def sparse_delta_plane(delta_stream, n: int, device):
    """The f32 delta plane [n] of a sparse (keys = flat << 1, vals) stream:
    the value of each voxel's record with nonzero bits (at most one)."""
    keys, vals = delta_stream
    flat = keys >> 1
    sel = (flat >= 0) & (flat < n) & (vals.view(torch.int32) != 0)
    plane = torch.zeros(n, dtype=torch.float32, device=device)
    plane[flat[sel].long()] = vals[sel]
    return plane


def deposit_and_sweep_ndt_reference(occupancy, walk_keys, end_keys, delta,
                                    cfg: IntegrateConfig):
    """Plain PyTorch K3 on ``occupancy[:sentinel]`` (updated in place).
    Returns (occupancy, touched i32 0-dim: voxels with counts)."""
    n = cfg.sentinel
    dev = occupancy.device
    hit, miss = _count_planes(n, (walk_keys, end_keys), dev)
    plane = (sparse_delta_plane(delta, n, dev) if isinstance(delta, tuple)
             else delta[:n])
    occupancy[:n] = ndt_sweep(occupancy[:n], hit, miss, plane, cfg)
    return occupancy, ((hit + miss) > 0).sum().to(torch.int32)


def _check_stream(keys, dev, what):
    if not (keys.dtype == torch.int32 and keys.dim() == 1 and keys.is_contiguous()
            and keys.device == dev):
        raise ValueError(f"{what} must be a contiguous i32[N] tensor on the arena's device")


def deposit_and_sweep_ndt(occupancy, walk_keys, end_keys, delta, cfg: IntegrateConfig,
                          bounds_key=None):
    """Deposit the walk and end/sample (flat << 1 | hit) key streams (flat
    outside [0, sentinel) skipped) and sweep ``occupancy`` (f32[>= sentinel
    + 1], +inf unobserved, updated in place) with the miss delta: either a
    sparse (keys i32[Nd] = flat << 1, vals f32[Nd]) stream sorted by id,
    with at most one value with nonzero bits per voxel, at the voxel's last
    record (the reference's contract, and the mappers'), or a dense
    f32[>= sentinel] plane (no mapper passes one).

    The end keys may come in any order.  The walk keys may too, unless
    ``bounds_key`` is given: the walk stream unmasked, sorted ascending,
    where ``walk_keys`` is the same stream with some records masked to
    the sentinel key, and within each voxel's run those masked records
    come first (the NDT miss phase masks the first records of a flagged
    voxel, ops.integrate_ndt).  Without it the wrapper sorts the walk keys
    (an unstable sort: the keys carry no payload; masked records go to the
    back).  The plain version reads the walk keys alone.

    Returns (occupancy, touched i32 0-dim: voxels with counts)."""
    if occupancy.device.type == "cpu":
        return deposit_and_sweep_ndt_reference(occupancy, walk_keys, end_keys, delta, cfg)
    if not (occupancy.dtype == torch.float32 and occupancy.dim() == 1
            and occupancy.is_contiguous() and occupancy.shape[0] > cfg.sentinel):
        raise ValueError("occupancy must be a contiguous f32[> sentinel] tensor")
    dev = occupancy.device
    _check_stream(walk_keys, dev, "walk keys")
    _check_stream(end_keys, dev, "end keys")
    if bounds_key is None:
        walk_keys = bounds_key = torch.sort(walk_keys).values
    _check_stream(bounds_key, dev, "bounds keys")
    if bounds_key.shape != walk_keys.shape:
        raise ValueError("the bounds stream must be as long as the walk stream")
    n_vox = cfg.sentinel
    if isinstance(delta, tuple):
        dkeys, dvals = delta
        _check_stream(dkeys, dev, "delta keys")
        if not (dvals.dtype == torch.float32 and dvals.shape == dkeys.shape
                and dvals.is_contiguous() and dvals.device == dev):
            raise ValueError("delta values must be a contiguous f32 tensor like its keys")
        dk, dv, n_delta, dense = dkeys.data_ptr(), dvals.data_ptr(), dkeys.shape[0], 0
    else:
        if not (delta.dtype == torch.float32 and delta.dim() == 1
                and delta.is_contiguous() and delta.shape[0] >= n_vox
                and delta.device == dev):
            raise ValueError("the delta plane must be a contiguous f32[>= sentinel] tensor")
        dk, dv, n_delta, dense = None, delta.data_ptr(), 0, 1
    # The end keys' table: at least two slots a key, a power of two; the
    # touched count in front of it.
    log2_slots = max(1, (2 * end_keys.shape[0] - 1).bit_length())
    scratch = torch.empty(1 + 3 * (1 << log2_slots), dtype=torch.int32, device=dev)
    rc = _build.load().ohm_deposit_and_sweep_ndt(
        occupancy.data_ptr(), walk_keys.data_ptr(), bounds_key.data_ptr(), walk_keys.shape[0],
        end_keys.data_ptr(), end_keys.shape[0], scratch.data_ptr(), log2_slots,
        dk, dv, n_delta, dense, n_vox, cfg.hit_value, cfg.miss_value, cfg.min_value,
        cfg.max_value, cfg.saturation_min, cfg.saturation_max, _build.stream_of(occupancy))
    _build.check(rc, "deposit_and_sweep_ndt")
    deposit_and_sweep_ndt.launches += 1
    return occupancy, scratch[0]


#: Kernel launches since the count was last set to 0.
deposit_and_sweep_ndt.launches = 0


def tsdf_set_deposit_reference(weight, distance, ids, w, d, sentinel: int):
    """Plain PyTorch K6, in place: ``weight[id], distance[id] = w, d`` at
    every record with an id below the sentinel and ``w > 0``, as 32-bit
    patterns (-0.0, infinities and NaN payloads survive).  Raises when two
    such records share a voxel: the kernel's stores would race there, and the
    TSDF path gives each voxel at most one (its segment-last record)."""
    dep = (ids >= 0) & (ids < sentinel) & (w > 0)
    idx = ids[dep].long()
    if torch.unique(idx).numel() != idx.numel():
        raise ValueError("tsdf_set_deposit: more than one record with w > 0 for a voxel")
    weight.view(torch.int32).index_put_((idx,), w.view(torch.int32)[dep])
    distance.view(torch.int32).index_put_((idx,), d.view(torch.int32)[dep])
    return weight, distance


def tsdf_set_deposit(weight, distance, ids, w, d, sentinel: int):
    """Store each depositing record's (w, d) pair into the planes ``weight``
    and ``distance`` (f32[>= sentinel], updated in place) at its id (i32[N];
    any order).  At most one record per voxel may carry ``w > 0``.
    Returns (weight, distance)."""
    if weight.device.type == "cpu":
        return tsdf_set_deposit_reference(weight, distance, ids, w, d, sentinel)
    dev = weight.device
    for plane in (weight, distance):
        if not (plane.dtype == torch.float32 and plane.dim() == 1 and plane.is_contiguous()
                and plane.shape[0] >= sentinel and plane.device == dev):
            raise ValueError("the planes must be contiguous f32[>= sentinel] tensors "
                             "on one device")
    _check_stream(ids, dev, "ids")
    for vals in (w, d):
        if not (vals.dtype == torch.float32 and vals.shape == ids.shape
                and vals.is_contiguous() and vals.device == dev):
            raise ValueError("w and d must be contiguous f32 tensors like the ids")
    rc = _build.load().ohm_tsdf_set_deposit(
        weight.data_ptr(), distance.data_ptr(), ids.data_ptr(), w.data_ptr(), d.data_ptr(),
        ids.shape[0], sentinel, _build.stream_of(weight))
    _build.check(rc, "tsdf_set_deposit")
    tsdf_set_deposit.launches += 1
    return weight, distance


#: Kernel launches since the count was last set to 0.
tsdf_set_deposit.launches = 0
