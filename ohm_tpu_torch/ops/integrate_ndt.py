"""NDT-OM / NDT-TM integration of one rayflow batch.

Counterpart of the kernel path of ``integrate_ndt`` in
``ohm_tpu/ops/integrate_ndt.py`` (the branch the JAX package takes on a TPU,
with its expand and deposit kernels):

  expand     K1 with voxel planes (ops.expand_cuda); end records; group
             compaction carrying each record's position as a payload
  miss phase one stable sort of the compacted ids; K4 (ops.gather_cuda)
             gathers the Gaussian flag plane; the first ``miss_k`` flagged
             records in sorted-stream order run the NDT miss math, the rest
             of the flagged ones fall back to standard misses (counted in
             ``ndt_overflow``); per-voxel delta sums over the K stream
  hit phase  a stable sort on (voxel << 16 | ray_order) and the closed-form
             batch covariance merge; for NDT-TM the consistency tallies, the
             exact intensity recursion and the hit/miss counters
  deposit    K3 (ops.deposit_cuda.deposit_and_sweep_ndt): the standard
             counts of both streams and the miss delta, swept in place

The arena is a dict of layer tensors (mapping.arena.VoxelArena.layers),
updated in place; the hit phase reads the batch-start occupancy, so K3 runs
last.  Every float sum follows the reference's order (ops.segments), and
every scatter writes unique targets (segment lasts; other records write
the clear value to the sentinel element), so a batch gives the same bits on
every run.  The stats stay on the device.
"""

from __future__ import annotations

import torch

from ohm_tpu.core.rayflags import RayFlag
from ohm_tpu_torch.ops import deposit_cuda, expand_cuda, gather_cuda, ndt as ndtops
from ohm_tpu_torch.ops.config import NdtConfig
from ohm_tpu_torch.ops.ddawalk import f32
from ohm_tpu_torch.ops.integrate import group_rows, resolve_slots
from ohm_tpu_torch.ops.segments import cumsum, segment_reduce, segment_sums
from ohm_tpu_torch.ops.subvoxel import sub_voxel_coord, sub_voxel_to_local_coord


def _u32_as_f32(x: torch.Tensor) -> torch.Tensor:
    """An int32-stored u32 layer's values as f32."""
    return (x.to(torch.int64) & 0xFFFFFFFF).to(torch.float32)


def _f32_as_u32(x: torch.Tensor) -> torch.Tensor:
    """Non-negative integral f32 values as int32-stored u32."""
    return x.to(torch.int64).to(torch.int32)


def _store(layer: torch.Tensor, ids: torch.Tensor, write: torch.Tensor,
           values: torch.Tensor, sentinel: int) -> None:
    """layer[ids] = values where ``write`` (unique ids there); every other
    record writes the layer's clear value 0 to the sentinel element."""
    idx = torch.where(write, ids, torch.full_like(ids, sentinel))
    mask = write if values.dim() == 1 else write[:, None]
    layer.index_put_((idx,), torch.where(mask, values, torch.zeros_like(values)))


def _miss_phase(arena: dict, b: dict, ids_c, pos_c, walk_vox, S: int, cfg: NdtConfig):
    """Sorted-stream miss phase (integrate_ndt.py:186-292).  Returns the
    sorted ids, the applied-NDT mask, the K stream's ids and per-voxel
    running sums, and the stats."""
    base = cfg.base
    sentinel = base.sentinel
    M = ids_c.shape[0]
    K = min(cfg.miss_k, M)
    sids, order = torch.sort(ids_c, stable=True)
    spos = pos_c[order]
    mc = arena["mean_count"]  # u32 as int32: negative means >= 2^31
    gauss8 = (~torch.isposinf(arena["occupancy"])
              & ((mc >= cfg.sample_threshold) | (mc < 0))).to(torch.int8)
    is_ndt = gather_cuda.gather_plane(gauss8, sids, sentinel) > 0

    # Flagged records first, then the rest, each in sorted-stream order: a
    # rank from a cumsum and one write per record into a permutation.
    flag = is_ndt.to(torch.int32)
    rank_f = cumsum(flag) - flag
    n_flag = flag.sum()
    seq = torch.arange(M, dtype=torch.int32, device=ids_c.device)
    target = torch.where(is_ndt, rank_f, n_flag + (seq - rank_f))
    sel_k = torch.empty_like(seq).scatter_(0, target.long(), seq)[:K]
    active_k = torch.arange(K, dtype=torch.int32, device=ids_c.device) < n_flag
    ndt_applied = is_ndt & (rank_f < K)
    overflow_ndt = torch.clamp(n_flag - K, min=0)
    ids_k = torch.where(active_k, sids[sel_k], torch.full_like(sel_k, sentinel))
    pos_k = spos[sel_k]
    ray_k = pos_k // S
    vox_k = walk_vox[ray_k, pos_k - ray_k * S]

    res = f32(base.resolution)
    sensor_k = b["start_frac"][ray_k] + (b["start_abs"][ray_k] - vox_k).to(torch.float32) * res
    sample_k = b["end_frac"][ray_k] + (b["end_abs"][ray_k] - vox_k).to(torch.float32) * res
    cov_k = arena["cov"][ids_k]
    mean_k = sub_voxel_to_local_coord(arena["mean_coord"][ids_k], base.resolution)
    delta_k, is_miss_k = ndtops.ndt_miss_delta(
        cov_k, sensor_k, sample_k, mean_k, cfg.adaptation_rate, cfg.sensor_noise)
    delta_k = torch.where(active_k, delta_k, torch.zeros_like(delta_k))
    is_miss_k = is_miss_k & active_k
    # ids_k is ascending already (selection keeps the sorted order, inactive
    # records are sentinels at the back), so the reference's stable sort of
    # the K stream is the identity and is skipped.
    k_last, k_red = segment_reduce(
        ids_k, torch.stack([delta_k, is_miss_k.to(torch.float32)], dim=1))
    return sids, ndt_applied, ids_k, k_last, k_red, {
        "ndt_overflow": overflow_ndt, "ndt_flagged": n_flag}


def integrate_ndt(arena: dict, b: dict, cfg: NdtConfig) -> dict:
    """Integrate one unpacked rayflow batch (ops.wire.unpack_batch, with the
    intensity block for NDT-TM) into ``arena`` (layer name -> tensor:
    occupancy (+inf unobserved), mean_coord, mean_count, cov [N,6], and for
    NDT-TM intensity [N,2], hit_count, miss_count), in place.

    Returns the stats as 0-dim tensors: missed_updates, overflow, touched,
    ndt_overflow, ndt_flagged, compaction_dropped."""
    base = cfg.base
    flags = base.ray_flags
    sentinel = base.sentinel
    dev = b["start_abs"].device
    ray_valid = b["valid"]

    walk_flat, aux = expand_cuda.expand_keys(
        b, base, exclude_origin=bool(flags & RayFlag.EXCLUDE_ORIGIN), with_vox=True)
    walk_missed_n = aux["missed_n"]
    if flags & RayFlag.EXCLUDE_RAY:
        walk_flat = torch.full_like(walk_flat, sentinel)
        walk_missed_n = torch.zeros_like(walk_missed_n)
    B, S = walk_flat.shape
    overflow_n = (aux["overflow"] & ray_valid).sum()

    end_flat, end_missed = resolve_slots(b["end_abs"], base, b["tcand"], b["gmeta"])
    # NDT ignores EXCLUDE_SAMPLE and the state exclusions (ohm/RayMapperNdt.cpp).
    end_is_hit = b["is_sample"] & ray_valid
    end_is_miss = b["end_as_miss"] & ray_valid
    if flags & RayFlag.EXCLUDE_RAY:
        end_is_miss = torch.zeros_like(end_is_miss)
    end_any = end_is_hit | end_is_miss

    # Group compaction; the record position rides along (stable row sort).
    flat_ids = walk_flat.reshape(-1)
    pos = torch.arange(B * S, dtype=torch.int32, device=dev)
    compaction_dropped = torch.zeros((), dtype=torch.int64, device=dev)
    G = base.group_size
    if base.group_cap and B % G == 0 and base.group_cap < G * S:
        rows = group_rows(flat_ids, B, S, G)
        n_valid = (rows < sentinel).sum()
        rows, order = torch.sort(rows, dim=1, stable=True)
        rows = rows[:, :base.group_cap]
        pos_rows = torch.gather(group_rows(pos, B, S, G), 1, order[:, :base.group_cap])
        compaction_dropped = n_valid - (rows < sentinel).sum()
        ids_c, pos_c = rows.reshape(-1), pos_rows.reshape(-1)
    else:
        ids_c, pos_c = flat_ids, pos

    sids, ndt_applied, ids_k, k_last, k_red, stats = _miss_phase(
        arena, b, ids_c, pos_c, aux["vox"], S, cfg)
    k_write = k_last & (ids_k != sentinel)
    if cfg.ndt_tm:
        n = arena["occupancy"].shape[0]
        pending_delta = torch.zeros(n, dtype=torch.float32, device=dev)
        _store(pending_delta, ids_k, k_write, k_red[:, 0], sentinel)
        pending_tm_miss = torch.zeros(n, dtype=torch.float32, device=dev)
        _store(pending_tm_miss, ids_k, k_write, k_red[:, 1], sentinel)
    else:
        # Sparse delta stream: one nonzero value per voxel, at its last record.
        pending_delta = (ids_k << 1,
                         torch.where(k_write, k_red[:, 0], torch.zeros_like(k_red[:, 0])))

    _hit_phase(arena, b, end_flat, end_is_hit, cfg)
    if cfg.ndt_tm:
        arena["miss_count"] += _f32_as_u32(pending_tm_miss)

    # Standard misses (walk records the NDT math did not take) and the
    # end/sample records deposit with the miss delta; the sweep runs last
    # because the hit phase reads batch-start occupancy.
    std_miss = (sids != sentinel) & ~ndt_applied
    walk_keys = torch.where(std_miss, sids << 1, torch.full_like(sids, sentinel << 1))
    end_keys = ((torch.where(end_any, end_flat, torch.full_like(end_flat, sentinel)) << 1)
                | end_is_hit.to(torch.int32))
    _, touched = deposit_cuda.deposit_and_sweep_ndt(
        arena["occupancy"], walk_keys, end_keys, pending_delta, base)

    stats.update({
        "missed_updates": walk_missed_n + (end_any & end_missed).sum(),
        "overflow": overflow_n,
        "touched": touched,
        "compaction_dropped": compaction_dropped,
    })
    return stats


def _hit_phase(arena: dict, b: dict, end_flat, end_is_hit, cfg: NdtConfig) -> None:
    """Batch covariance merge per sample voxel, and for NDT-TM the
    consistency tallies, intensity and hit/miss counters
    (integrate_ndt.py:417-573), written in place at segment lasts."""
    base = cfg.base
    sentinel = base.sentinel
    res = f32(base.resolution)
    occ = arena["occupancy"]
    s_ids = torch.where(end_is_hit, end_flat, torch.full_like(end_flat, sentinel))
    end_frac = b["end_frac"]
    cols = [torch.ones_like(end_frac[:, :1]), end_frac, ndtops._outer6(end_frac)]
    if cfg.ndt_tm:
        # Consistency against batch-start state, at each sample's voxel.
        cov_s = arena["cov"][s_ids]
        mean_s = sub_voxel_to_local_coord(arena["mean_coord"][s_ids], base.resolution)
        sensor_local = b["start_frac"] + (b["start_abs"] - b["end_abs"]).to(torch.float32) * res
        _, inc_hit, inc_miss = ndtops.tm_hit_consistency(
            cov_s, sensor_local, end_frac, mean_s, arena["mean_count"][s_ids], occ[s_ids],
            {"reinit_threshold": cfg.reinit_threshold, "reinit_count": cfg.reinit_count,
             "sensor_noise": cfg.sensor_noise, "adaptation_rate": cfg.adaptation_rate,
             "sample_threshold": cfg.sample_threshold})
        cols += [inc_hit.to(torch.float32)[:, None], inc_miss.to(torch.float32)[:, None],
                 b["intensity"][:, None]]
    # Columns: k, z[3], zz[6] (+ TM: inc_hit, inc_miss, intensity); +0.0
    # where the ray's end is not a sample hit.
    payload = torch.cat(cols, dim=1)
    payload = torch.where(end_is_hit[:, None], payload, torch.zeros_like(payload))

    # Same-voxel samples in original ray order (the wire may be permuted).
    order = torch.sort((s_ids.to(torch.int64) << 16) | b["ray_order"].to(torch.int64),
                       stable=True).indices
    s_sorted = s_ids[order]
    p_sorted = payload[order]
    s_last, s_red = segment_reduce(s_sorted, p_sorted)
    k = s_red[:, 0]
    active = s_last & (s_sorted != sentinel) & (k > 0)

    count_old = arena["mean_count"][s_sorted]
    cov_new, mean_new, count_new, reset = ndtops.merge_covariance_batch(
        arena["cov"][s_sorted],
        sub_voxel_to_local_coord(arena["mean_coord"][s_sorted], base.resolution),
        count_old, occ[s_sorted], k, s_red[:, 1:4], s_red[:, 4:10],
        base.resolution, cfg.reinit_threshold, cfg.reinit_count)

    if cfg.ndt_tm:
        # Exact intensity recursion, telescoped over segment-local prefix
        # sums (integrate_ndt.py:513-557); read before any layer is written.
        hit_sorted = p_sorted[:, 0]
        int_sorted = p_sorted[:, 12]
        im_old = arena["intensity"][s_sorted, 0]
        ic_old = arena["intensity"][s_sorted, 1]
        zero = torch.zeros_like(k)
        n0 = torch.where(reset, zero, _u32_as_f32(count_old))
        im0 = torch.where(reset, zero, im_old)
        s_first = torch.cat([torch.ones(1, dtype=torch.bool, device=k.device),
                             s_sorted[1:] != s_sorted[:-1]])
        j_incl = segment_sums(hit_sorted, s_first)
        prefix_incl = segment_sums(int_sorted, s_first)
        n_j = n0 + j_incl
        prev_cnt = n_j - 1.0
        mean_prev = (n0 * im0 + (prefix_incl - int_sorted)) / torch.clamp(prev_cnt, min=1.0)
        d = mean_prev - int_sorted
        term = torch.where((hit_sorted > 0) & (prev_cnt > 0),
                           d * d / torch.clamp(n_j, min=1.0), zero)
        q_inc = segment_sums(term, s_first)
        n_new = n0 + torch.clamp(k, min=1.0)
        q_base = torch.where(n0 > 0, n0 * ic_old,
                             torch.full_like(k, f32(cfg.initial_intensity_covariance)))
        im_new = (n0 * im0 + s_red[:, 12]) / n_new
        ic_new = (q_base + q_inc) / n_new
        old_hit = _u32_as_f32(arena["hit_count"][s_sorted])
        old_miss = _u32_as_f32(arena["miss_count"][s_sorted])
        new_hit = torch.where(reset, s_red[:, 10], old_hit + s_red[:, 10])
        new_miss = torch.where(reset, s_red[:, 11], old_miss + s_red[:, 11])
        _store(arena["intensity"], s_sorted, active, torch.stack([im_new, ic_new], dim=1),
               sentinel)
        _store(arena["hit_count"], s_sorted, active, _f32_as_u32(new_hit), sentinel)
        _store(arena["miss_count"], s_sorted, active, _f32_as_u32(new_miss), sentinel)

    _store(arena["cov"], s_sorted, active, cov_new, sentinel)
    _store(arena["mean_coord"], s_sorted, active,
           sub_voxel_coord(mean_new, base.resolution), sentinel)
    _store(arena["mean_count"], s_sorted, active, _f32_as_u32(count_new), sentinel)
