"""NDT-OM / NDT-TM integration of one batch (rayflow or segmented wire),
with the side layers voxel mean (always), traversal, touch time and
incident normal.

Counterpart of ``integrate_ndt`` in ``ohm_tpu/ops/integrate_ndt.py``: the
branch the JAX package takes on a TPU (its expand and deposit kernels), and
with the traversal layer the branch it takes then (its deposit kernel off,
integrate_ndt.py:183-184), whose semantics differ in two places:

  expand     the walk front end with voxel planes (ops.integrate.expand_walk:
             K1 on the rayflow wire, the plain walk and the corner-slot
             resolve on the segmented one), with each record's traversal
             when the map has that layer; end records; group compaction
             carrying each record's position (and traversal) as payloads
  miss phase one stable sort of the compacted ids; the fused flag gather
             (ops.gather_cuda.gather_ndt_flags, K4's kernel reading occupancy
             and mean_count) flags the Gaussian records; the first
             ``miss_k`` flagged records run the NDT miss math and the rest
             of the flagged ones fall back to standard misses (counted in
             ``ndt_overflow``): first in sorted-stream order, or, with
             traversal, in compacted-stream order (the reference's second
             drop order); per-voxel delta (and traversal) sums over the K
             stream, whose traversal is deposited first
  hit phase  a stable sort on (voxel << 32 | ray_order) and the closed-form
             batch covariance merge; for NDT-TM the consistency tallies, the
             exact intensity recursion and the hit/miss counters; the touch
             time (a u32 maximum) and the incident normal
  deposit    K3 (ops.deposit_cuda.deposit_and_sweep_ndt): the standard
             counts of both streams (the walk with its unmasked bounds)
             and the sparse miss delta, swept in place; with traversal, the
             standard and end records' traversal sums

The arena is a dict of layer tensors (mapping.arena.VoxelArena.layers),
updated in place; the hit phase reads the batch-start occupancy, so K3 runs
last.  Every float sum follows the reference's order (ops.segments), and
every scatter writes unique targets (segment lasts; other records write
the clear value to the sentinel element), so a batch gives the same bits on
every run.  The stats stay on the device.
"""

from __future__ import annotations

import torch

from ohm_tpu_torch.core.rayflags import RayFlag
from ohm_tpu_torch.ops import deposit_cuda, gather_cuda, ndt as ndtops
from ohm_tpu_torch.ops.config import NdtConfig
from ohm_tpu_torch.ops.ddawalk import f32
from ohm_tpu_torch.ops.integrate import (_count_planes_at, _fused_merge, _fused_row_partials,
                                         _pad_targets, _row_lasts_max, expand_walk, group_rows,
                                         merge_incident, resolve_voxels)
from ohm_tpu_torch.ops.segments import (_first_last, cumsum, segment_reduce, segment_sums,
                                        segment_u32_max)
from ohm_tpu_torch.ops.subvoxel import flush_denormals
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


def _miss_phase(arena: dict, b: dict, ids_c, pos_c, trav_c, walk_vox, S: int,
                cfg: NdtConfig):
    """The miss phase (integrate_ndt.py:186-292).  ``trav_c`` is the
    compacted stream's traversal, or None without the layer.  Returns the
    sorted ids and their stable sort's order, the applied-NDT mask in
    sorted order, the K stream's ids, lasts and per-voxel running sums
    (delta, miss tally, and with traversal the traversal), and the stats."""
    base = cfg.base
    sentinel = base.sentinel
    M = ids_c.shape[0]
    K = min(cfg.miss_k, M)
    sids, order = torch.sort(ids_c, stable=True)
    spos = pos_c[order]
    # The Gaussian flag (observed, mean_count >= sample_threshold) at each
    # sorted id, read from the arena's layers: no arena-wide flag plane.
    flag = gather_cuda.gather_ndt_flags(arena["occupancy"], arena["mean_count"], sids,
                                        cfg.sample_threshold, sentinel)
    is_ndt = flag > 0
    n_flag = flag.sum()
    if trav_c is None:
        # The first K flagged records in sorted-stream order take the math.
        rank_f = cumsum(flag) - flag
        applied = is_ndt & (rank_f < K)
        take, rank_t, n_take = is_ndt, rank_f, n_flag
    else:
        # The first K in compacted-stream order (integrate_ndt.py:217-238):
        # the rank counts in that order (the flags taken back through the
        # sort's inverse), and the K stream is the records it admits, in
        # sorted order.  The stable sort keeps compacted order within a
        # voxel's run and the flag is the voxel's, so they are still a
        # prefix of each run, as K3's bounds contract needs.
        flag_c = torch.empty_like(flag)
        flag_c[order] = flag
        applied = is_ndt & ((cumsum(flag_c) - flag_c)[order] < K)
        take = applied
        a = applied.to(torch.int32)
        rank_t = cumsum(a) - a
        n_take = a.sum()

    # Taken records first, then the rest, each in sorted-stream order: a
    # rank from a cumsum and one write per record into a permutation.
    seq = torch.arange(M, dtype=torch.int32, device=ids_c.device)
    target = torch.where(take, rank_t, n_take + (seq - rank_t))
    sel_k = torch.empty_like(seq).scatter_(0, target.long(), seq)[:K]
    active_k = torch.arange(K, dtype=torch.int32, device=ids_c.device) < n_take
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
    cols = [delta_k, is_miss_k.to(torch.float32)]
    if trav_c is not None:
        trav_k = trav_c[order[sel_k]]
        cols.append(torch.where(active_k, trav_k, torch.zeros_like(trav_k)))
    # ids_k is ascending already (selection keeps the sorted order, inactive
    # records are sentinels at the back), so the reference's stable sort of
    # the K stream is the identity and is skipped.
    k_last, k_red = segment_reduce(ids_k, torch.stack(cols, dim=1))
    return sids, order, applied, ids_k, k_last, k_red, {
        "ndt_overflow": overflow_ndt, "ndt_flagged": n_flag}


def integrate_ndt(arena: dict, b: dict, cfg: NdtConfig) -> dict:
    """Integrate one decoded batch (ops.wire.decode, with the intensities
    for NDT-TM) into ``arena`` (layer name -> tensor:
    occupancy (+inf unobserved), mean_coord, mean_count, cov [N,6], for
    NDT-TM intensity [N,2], hit_count, miss_count, and any of traversal,
    touch_time and incident), in place.

    Returns the stats as 0-dim tensors: missed_updates, overflow, touched,
    ndt_overflow, ndt_flagged, compaction_dropped, dropped_updates (the
    fused deposit's), row_lasts_max (-1 without compaction); and ``route``,
    the deposit taken: "fused" (with traversal and ``base.row_cap`` set on
    compacted rows) or "k3"."""
    base = cfg.base
    flags = base.ray_flags
    sentinel = base.sentinel
    dev = b["start_abs"].device
    ray_valid = b["valid"]
    with_trav = base.with_traversal

    walk_flat, aux = expand_walk(
        b, base, exclude_origin=bool(flags & RayFlag.EXCLUDE_ORIGIN), with_vox=True,
        with_trav=with_trav)
    walk_missed_n = aux["missed_n"]
    walk_trav = aux.get("trav")
    if flags & RayFlag.EXCLUDE_RAY:
        walk_flat = torch.full_like(walk_flat, sentinel)
        walk_missed_n = torch.zeros_like(walk_missed_n)
        if with_trav:
            walk_trav = torch.zeros_like(walk_trav)
    B, S = walk_flat.shape
    overflow_n = (aux["overflow"] & ray_valid).sum() + aux["truncated"]

    end_flat, end_missed = resolve_voxels(b["end_abs"], base, b)
    # NDT ignores EXCLUDE_SAMPLE and the state exclusions (ohm/RayMapperNdt.cpp).
    end_is_hit = b["is_sample"] & ray_valid
    end_is_miss = b["end_as_miss"] & ray_valid
    if flags & RayFlag.EXCLUDE_RAY:
        end_is_miss = torch.zeros_like(end_is_miss)
    end_any = end_is_hit | end_is_miss

    # Group compaction; the record position (and traversal) rides along
    # (stable row sort).
    flat_ids = walk_flat.reshape(-1)
    pos = torch.arange(B * S, dtype=torch.int32, device=dev)
    trav_c = walk_trav.reshape(-1) if with_trav else None
    compaction_dropped = torch.zeros((), dtype=torch.int64, device=dev)
    row_lasts_max = None
    G = base.group_size
    compacted = bool(base.group_cap) and B % G == 0 and base.group_cap < G * S
    if compacted:
        rows = group_rows(flat_ids, B, S, G)
        n_valid = (rows < sentinel).sum()
        rows, order = torch.sort(rows, dim=1, stable=True)
        rows = rows[:, :base.group_cap]
        order = order[:, :base.group_cap]
        pos_c = torch.gather(group_rows(pos, B, S, G), 1, order).reshape(-1)
        if with_trav:
            trav_c = torch.gather(group_rows(trav_c, B, S, G), 1, order).reshape(-1)
        compaction_dropped = n_valid - (rows < sentinel).sum()
        row_lasts_max = _row_lasts_max(rows, sentinel)
        ids_c = rows.reshape(-1)
    else:
        ids_c, pos_c = flat_ids, pos

    sids, order, ndt_applied, ids_k, k_last, k_red, stats = _miss_phase(
        arena, b, ids_c, pos_c, trav_c, aux["vox"], S, cfg)
    k_write = k_last & (ids_k != sentinel)
    # Sparse delta stream (NDT-OM and NDT-TM): id-sorted, one nonzero value
    # per voxel, at its last record.
    pending_delta = (ids_k << 1,
                     torch.where(k_write, k_red[:, 0], torch.zeros_like(k_red[:, 0])))
    if cfg.ndt_tm:
        pending_tm_miss = torch.zeros(arena["occupancy"].shape[0], dtype=torch.float32,
                                      device=dev)
        _store(pending_tm_miss, ids_k, k_write, k_red[:, 1], sentinel)
    if with_trav:
        # The traversal of the records the NDT math took goes in first
        # (integrate_ndt.py:305-309).
        traversal = arena["traversal"]
        _store(traversal, ids_k, k_write, traversal[ids_k] + k_red[:, 2], sentinel)

    _hit_phase(arena, b, end_flat, end_is_hit, cfg)
    if cfg.ndt_tm:
        arena["miss_count"] += _f32_as_u32(pending_tm_miss)

    # Standard misses (walk records the NDT math did not take) and the
    # end/sample records deposit with the miss delta; the sweep runs last
    # because the hit phase reads batch-start occupancy.
    end_trav = (torch.where(end_any, b["length"] - aux["end_enter"], torch.zeros_like(b["length"]))
                if with_trav else None)
    dropped = torch.zeros((), dtype=torch.int64, device=dev)
    if with_trav and base.row_cap > 0 and compacted:
        route = "fused"
        touched, dropped = _fused_deposit(arena, ids_c, order, ndt_applied, trav_c, end_flat,
                                          end_is_hit, end_is_miss, end_trav, ids_k, k_write,
                                          k_red[:, 0], base)
    else:
        # K3.  The walk stream goes with its unmasked bounds: within a
        # voxel's run of ``sids`` the records the NDT math took come first
        # (_miss_phase), so the masked records form a prefix, as K3 needs.
        route = "k3"
        std_miss = (sids != sentinel) & ~ndt_applied
        bounds = sids << 1
        walk_keys = torch.where(std_miss, bounds, torch.full_like(sids, sentinel << 1))
        end_keys = ((torch.where(end_any, end_flat, torch.full_like(end_flat, sentinel)) << 1)
                    | end_is_hit.to(torch.int32))
        _, touched = deposit_cuda.deposit_and_sweep_ndt(
            arena["occupancy"], walk_keys, end_keys, pending_delta, base, bounds_key=bounds)
        if with_trav:
            _standard_traversal(arena["traversal"], walk_keys, order, trav_c, end_keys,
                                end_trav, sentinel)

    stats.update({
        "missed_updates": walk_missed_n + (end_any & end_missed).sum(),
        "overflow": overflow_n,
        "touched": touched,
        "compaction_dropped": compaction_dropped,
        "dropped_updates": dropped,
        "row_lasts_max": (torch.full((), -1, dtype=torch.int64, device=dev)
                          if row_lasts_max is None else row_lasts_max),
        "route": route,
    })
    return stats


def _fused_deposit(arena: dict, ids_c, order, ndt_applied, trav_c, end_flat, end_is_hit,
                   end_is_miss, end_trav, ids_k, k_write, k_delta, base) -> tuple:
    """The standard counts through the fused row-local deposit
    (integrate_ndt.py:328-359), in place: per-row partial counts of the
    standard misses (weights mask out the records the NDT math took) and
    their traversal over the compaction rows, merged with the end records;
    then the traversal sums add at each voxel, and the NDT sweep runs over
    the arena with the count planes and the miss delta plane
    (deposit_cuda.ndt_sweep, the reference's dense apply).  Returns
    (touched, dropped) as 0-dim tensors."""
    sentinel = base.sentinel
    applied_c = torch.empty_like(ndt_applied)
    applied_c[order] = ndt_applied  # sorted-stream order back to compacted order
    std_miss = (ids_c != sentinel) & ~applied_c
    cap_r = base.group_cap
    M, B = ids_c.shape[0], end_flat.shape[0]
    # The merge stream must fit scatter_pad: an escalated row_cap narrows.
    cap2 = min(base.row_cap, cap_r, max(1, (base.scatter_pad - B) // max(1, M // cap_r)))
    kc, pc, tc, dropped = _fused_row_partials(
        ids_c.reshape(-1, cap_r), std_miss.to(torch.float32),
        torch.where(std_miss, trav_c, torch.zeros_like(trav_c)), cap2, base)
    end_any = end_is_hit | end_is_miss
    ids_e = torch.where(end_any, end_flat, torch.full_like(end_flat, sentinel))
    packed_e = torch.where(end_any, (end_is_hit.to(torch.int32) << 16)
                           | end_is_miss.to(torch.int32), 0)
    idx, n_hit, n_miss, real_last, trav_tot = _fused_merge(
        kc, pc, tc, ids_e, packed_e, torch.where(end_any, end_trav, torch.zeros_like(end_trav)),
        base)
    arena["traversal"].index_add_(0, idx, torch.where(real_last, trav_tot, -0.0))
    hit, miss = _count_planes_at(sentinel, idx, n_hit, n_miss)
    delta = torch.zeros(sentinel, dtype=torch.float32, device=ids_c.device)
    delta.index_add_(0, _pad_targets(k_write, ids_k, sentinel),
                     torch.where(k_write, k_delta, -0.0))
    occ = arena["occupancy"]
    occ[:sentinel] = deposit_cuda.ndt_sweep(occ[:sentinel], hit, miss, delta, base)
    return real_last.sum(), dropped


def _standard_traversal(traversal, walk_keys, order, trav_c, end_keys, end_trav,
                        sentinel: int) -> None:
    """Add each voxel's standard-miss and end records' traversal, summed
    over the key-sorted concatenation of the walk (in compacted order) and
    end records (integrate_ndt.py:361-387), at its last record."""
    walk_c = torch.empty_like(walk_keys)
    walk_c[order] = walk_keys  # the masked walk keys back in compacted order
    key_s, by_key = torch.sort(torch.cat([walk_c, end_keys]), stable=True)
    ids_s = key_s >> 1
    first, last = _first_last(ids_s)
    sums = segment_sums(torch.cat([trav_c, end_trav])[by_key], first)
    _store(traversal, ids_s, last & (ids_s != sentinel), traversal[ids_s] + sums, sentinel)


def _hit_phase(arena: dict, b: dict, end_flat, end_is_hit, cfg: NdtConfig) -> None:
    """Batch covariance merge per sample voxel, for NDT-TM the consistency
    tallies, intensity and hit/miss counters, and the touch time and
    incident normal (integrate_ndt.py:417-598), written in place at segment
    lasts."""
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
    if base.with_incident:
        # The reference's first sum reads a denormal component as zero.
        cols.append(flush_denormals(-b["direction"]))
    # Columns: k, z[3], zz[6] (+ TM: inc_hit, inc_miss, intensity; +
    # incident: the negated direction[3]); +0.0 where the ray's end is not
    # a sample hit.
    payload = torch.cat(cols, dim=1)
    payload = torch.where(end_is_hit[:, None], payload, torch.zeros_like(payload))

    # Same-voxel samples in original ray order: the rayflow wire may be
    # permuted (its source ray index rides in ray_order); the segmented
    # wire's rows are in batch order.
    row_order = b.get("ray_order")
    if row_order is None:
        row_order = torch.arange(s_ids.shape[0], dtype=torch.int32, device=s_ids.device)
    order = torch.sort((s_ids.to(torch.int64) << 32) | row_order.to(torch.int64),
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

    if base.with_touch_time:
        # A u32 maximum written where the voxel is active (not max(old, .)).
        touch = torch.where(end_is_hit, b["touch_enc"], torch.zeros_like(b["touch_enc"]))
        _store(arena["touch_time"], s_sorted, active,
               segment_u32_max(s_sorted, touch[order]), sentinel)
    if base.with_incident:
        # The old normal weighs in with the batch-start mean count, by 0
        # where the merge reset the voxel.
        prior = torch.where(reset, torch.zeros_like(k), _u32_as_f32(count_old))
        _store(arena["incident"], s_sorted, active,
               merge_incident(arena["incident"][s_sorted], prior, s_red[:, -3:]), sentinel)
    _store(arena["cov"], s_sorted, active, cov_new, sentinel)
    _store(arena["mean_coord"], s_sorted, active,
           sub_voxel_coord(mean_new, base.resolution), sentinel)
    _store(arena["mean_count"], s_sorted, active, _f32_as_u32(count_new), sentinel)
