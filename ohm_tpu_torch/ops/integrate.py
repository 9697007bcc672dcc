"""Occupancy integration of one batch: expand, sort, deposit.

Counterpart of ``ohm_tpu/ops/integrate.py``: its split-phase path
(``expand_records`` + ``apply_records`` + ``_apply_sample_layers``) on the
rayflow and segmented wires, and its monolith (``integrate_occupancy``),
which the segmented wire takes under STOP_ON_FIRST_OCCUPIED:

  expand  the walk front end (``expand_walk``): K1 (ops.expand_cuda) on the
          rayflow wire under group compaction, else the plain walk
          (ops.ddawalk, the rank walk or the ordered one) with the slot
          resolve (the rayflow candidates or the segmented wire's corner
          slots); one key per walk record, and with the traversal layer each
          record's traversal length; the end records resolve here; group
          compaction cuts the sentinel padding
  sort    one torch.sort of the (flat << 1 | hit) key stream
  apply   K2 (ops.deposit_cuda) deposits exact hit/miss counts per voxel and
          sweeps the occupancy update in place against batch-start values;
          the traversal sums add in at each voxel's last record
  samples the mean, touch-time and incident-normal layers from the batch's
          end-voxel hits (apply_sample_layers)

The monolith walks in time order and masks each ray's records after its
first voxel that was occupied at batch start (across the ray's segments);
its occupancy goes through K2 with the masked records' keys set to the
sentinel.

Two more applies take K1's records where the mapper routes a batch to
them, as the reference's does: the fused row-local apply
(``apply_records_fused``: row sorts of the compaction rows, one small merge
sort, exact integer count sums, a fresh count plane and the sweep over the
arena) and the delta path (``apply_delta``: counts off positions, the
voxel-lasts' int64 (voxel, delta) keys cut to a window, an ``index_add_``
and a clamp over the arena).  ``integrate_chain`` runs the rows of one
stacked upload through the expand and the split or fused apply in order.

Every sort that carries a payload is stable (torch.sort is not on CUDA
otherwise), and every float sum runs in a fixed order (ops.segments), so
two runs give the same bits.  The updates are in place; a scatter writes
each touched voxel once, at indices compacted from the sorted stream (one
``nonzero`` each, which waits for the device), and never the sentinel.
"""

from __future__ import annotations

import torch

from ohm_tpu_torch.core.rayflags import RayFlag
from ohm_tpu_torch.ops import deposit_cuda, expand_cuda, segments, subvoxel
from ohm_tpu_torch.ops.config import IntegrateConfig
from ohm_tpu_torch.ops.ddawalk import walk_rays, walk_rays_unordered
from ohm_tpu_torch.ops.wire import decode
from ohm_tpu_torch.utils.profile import Profile

_PROFILE = Profile.instance()


def resolve_slots(voxels, cfg: IntegrateConfig, tcand, gmeta):
    """Voxel abs coords (i32[B,S,3] or [B,3]) -> (flat arena ids, missed).

    Each voxel's bbox-relative region, packed 6 bits per axis, is matched
    against its ray's K candidates (tcand i32[B,K] = (slot+1) << 18 |
    packed region); later candidates win.  Unmatched voxels map to the
    sentinel.  The local index x + y*dim + z*dim^2 is the reference's
    linearisation (ohm/MapChunk.h:33-38)."""
    shift = cfg.region_shift
    region = voxels >> shift
    local = voxels & ((1 << shift) - 1)
    rel = region - gmeta[0:3]
    packed = rel[..., 0] | (rel[..., 1] << 6) | (rel[..., 2] << 12)
    in_box = torch.all((rel >= 0) & (rel < 64), dim=-1)
    packed = torch.where(in_box, packed, torch.full_like(packed, -1))
    expand = (slice(None),) + (None,) * (voxels.dim() - 2)
    slot = torch.full_like(packed, -1)
    for k in range(tcand.shape[1]):
        cand = tcand[:, k][expand]
        cand_slot = (cand >> 18) - 1
        match = ((cand & 0x3FFFF) == packed) & (cand_slot >= 0)
        slot = torch.where(match, cand_slot, slot)
    missed = slot < 0
    local_idx = local[..., 0] + (local[..., 1] << shift) + (local[..., 2] << (2 * shift))
    flat = slot * cfg.voxels_per_region + local_idx
    return torch.where(missed, torch.full_like(flat, cfg.sentinel), flat), missed


def resolve_corner_slots(voxels, cfg: IntegrateConfig, rmin, corner_slots):
    """Voxel abs coords (i32[B,S,3] or [B,3]) -> (flat arena ids, missed) on
    the segmented wire: a segment spans at most two regions an axis, so a
    voxel's region is one of the eight corners of the box at its segment's
    ``rmin``, whose slots (i32[B,8], -1 unallocated) the host resolved
    (corner index dx + 2 dy + 4 dz).  Voxels outside the box or in an
    unallocated corner map to the sentinel."""
    shift = cfg.region_shift
    B = voxels.shape[0]
    region = voxels >> shift
    local = voxels & ((1 << shift) - 1)
    expand = (slice(None),) + (None,) * (voxels.dim() - 2)
    d = region - rmin[expand]
    in_box = torch.all((d >= 0) & (d <= 1), dim=-1)
    dc = torch.clamp(d, 0, 1)
    cidx = dc[..., 0] + 2 * dc[..., 1] + 4 * dc[..., 2]
    slot = torch.gather(corner_slots, 1, cidx.reshape(B, -1).long()).reshape(cidx.shape)
    missed = ~in_box | (slot < 0)
    local_idx = local[..., 0] + (local[..., 1] << shift) + (local[..., 2] << (2 * shift))
    flat = slot * cfg.voxels_per_region + local_idx
    return torch.where(missed, torch.full_like(flat, cfg.sentinel), flat), missed


def resolve_voxels(voxels, cfg: IntegrateConfig, b: dict):
    """resolve_slots on a rayflow batch, resolve_corner_slots on a segmented
    one (ops.wire.decode)."""
    if "tcand" in b:
        return resolve_slots(voxels, cfg, b["tcand"], b["gmeta"])
    return resolve_corner_slots(voxels, cfg, b["rmin"], b["corner_slots"])


def expand_walk(b: dict, cfg: IntegrateConfig, exclude_origin: bool = False,
                with_vox: bool = False, with_trav: bool = False):
    """The walk front end: K1's contract on either wire.

    Returns (flat i32[B,W], aux) with aux = {missed_n, overflow bool[B],
    end_enter f32[B], truncated (0-dim)}, and ``vox`` i32[B,W,3] /
    ``trav`` f32[B,W] when asked, as ops.expand_cuda.expand_keys gives them.
    K1 runs where the reference runs its expand kernel (the rayflow wire,
    the rank walk, group compaction: expand_pallas.expand_eligible);
    otherwise the walk runs as PyTorch ops on the batch's device, the rank
    walk under group compaction and the ordered walk without it, then the
    slot resolve and the validity and EXCLUDE_ORIGIN masking
    (integrate.py:923-949)."""
    rank = cfg.unordered_walk and cfg.group_cap
    if rank and cfg.table_k and "tcand" in b:
        flat, aux = expand_cuda.expand_keys(b, cfg, exclude_origin=exclude_origin,
                                            with_trav=with_trav, with_vox=with_vox)
        aux["truncated"] = torch.zeros((), dtype=torch.int64, device=flat.device)
        return flat, aux
    args = (b["start_abs"], b["end_abs"], b["start_frac"], b["direction"], b["length"],
            cfg.resolution, cfg.max_steps)
    walk = walk_rays_unordered(*args) if rank else walk_rays(
        *args, total_cap=cfg.walk_cap or None)
    rec_valid = walk["valid"] & b["valid"][:, None]
    if exclude_origin:
        if rank:
            first = walk["first"]
        else:  # the ordered walk's origin voxel is its first record
            first = torch.zeros_like(rec_valid)
            first[:, 0] = True
        rec_valid = rec_valid & ~(first & b["exclude_start"][:, None])
    flat, missed = resolve_voxels(walk["voxels"], cfg, b)
    flat = torch.where(rec_valid, flat, torch.full_like(flat, cfg.sentinel))
    aux = {"missed_n": (rec_valid & missed).sum().to(torch.int32),
           "overflow": walk["overflow"], "end_enter": walk["end_enter"],
           "truncated": walk.get("truncated", torch.zeros((), dtype=torch.int64,
                                                          device=flat.device))}
    if with_vox:
        aux["vox"] = walk["voxels"]
    if with_trav:
        trav = walk["exits"] - walk["enters"]
        aux["trav"] = torch.where(rec_valid, trav, torch.zeros_like(trav))
    return flat, aux


def group_rows(flat, B: int, S: int, G: int):
    """[B*S] record stream -> [B//G, G*S] compaction rows, STRIDED: row r
    holds rays r, r+R, r+2R, ...  The host's group cap is computed for
    exactly this assignment (mapping.torch_map._rayflow_group_cap)."""
    R = B // G
    return flat.reshape(G, R, S).transpose(0, 1).reshape(R, G * S)


def expand_records(b: dict, cfg: IntegrateConfig):
    """Phase 1: walk keys (expand_walk) + end records + group compaction.

    Returns (records, stats).  records: 'key' i32[N] with key = flat << 1 |
    hit, 'end_flat' i32[B] and 'end_is_hit' bool[B] (the sample layers'
    input), and with the traversal layer 'trav' f32[N] beside 'key'.  stats
    holds 0-dim tensors 'missed_updates', 'applied_updates' (active records
    whose slot resolved: with 'missed_updates', every active record),
    'overflow', 'compaction_dropped'."""
    flags = cfg.ray_flags
    sentinel = cfg.sentinel
    with_trav = cfg.with_traversal
    walk_flat, aux = expand_walk(
        b, cfg, exclude_origin=bool(flags & RayFlag.EXCLUDE_ORIGIN), with_trav=with_trav)
    walk_missed_n = aux["missed_n"]
    walk_trav = aux.get("trav")
    if flags & RayFlag.EXCLUDE_RAY:
        walk_flat = torch.full_like(walk_flat, sentinel)
        walk_missed_n = torch.zeros_like(walk_missed_n)
        if with_trav:
            walk_trav = torch.zeros_like(walk_trav)
    B, S = walk_flat.shape

    ray_valid = b["valid"]
    end_flat, end_missed = resolve_voxels(b["end_abs"], cfg, b)
    end_is_hit = b["is_sample"] & ray_valid
    end_is_miss = b["end_as_miss"] & ray_valid
    if flags & RayFlag.EXCLUDE_SAMPLE:
        end_is_hit = torch.zeros_like(end_is_hit)
    if flags & RayFlag.EXCLUDE_RAY:
        end_is_miss = torch.zeros_like(end_is_miss)
    end_active = end_is_hit | end_is_miss

    walk_keys = walk_flat.reshape(-1) << 1
    limit = sentinel << 1
    # Active walk records whose slot resolved, the keys below the
    # sentinel's, counted before the compaction.
    n_valid = (walk_keys < limit).sum()
    if with_trav:
        walk_trav = walk_trav.reshape(-1)
    compaction_dropped = torch.zeros((), dtype=torch.int64, device=walk_keys.device)
    row_lasts_max = None
    G = cfg.group_size
    if cfg.group_cap and B % G == 0 and cfg.group_cap < G * S:
        # Sentinel keys sort to the back of each row, so cutting at group_cap
        # drops only padding when the host's cap covers the row.
        rows = group_rows(walk_keys, B, S, G)
        if with_trav:
            # Equal keys carry different traversal payloads: a stable sort
            # keeps them in the reference's order (torch.sort on CUDA is
            # not stable unless asked).
            rows, order = torch.sort(rows, dim=1, stable=True)
            tr = torch.gather(group_rows(walk_trav, B, S, G), 1, order)
            walk_trav = tr[:, :cfg.group_cap].reshape(-1)
        else:
            # No payload rides with the keys: equal keys are
            # interchangeable, so the unstable sort gives the same result.
            rows = torch.sort(rows, dim=1).values
        rows = rows[:, :cfg.group_cap]
        compaction_dropped = n_valid - (rows < limit).sum()
        walk_keys = rows.reshape(-1)
        row_lasts_max = _row_lasts_max(rows, limit)

    end_keys = torch.where(end_active, end_flat, torch.full_like(end_flat, sentinel))
    key = torch.cat([walk_keys, (end_keys << 1) | end_is_hit.to(torch.int32)])
    records = {"key": key, "end_flat": end_flat, "end_is_hit": end_is_hit}
    if with_trav:
        end_trav = b["length"] - aux["end_enter"]
        end_trav = torch.where(end_active, end_trav, torch.zeros_like(end_trav))
        records["trav"] = torch.cat([walk_trav, end_trav])
    stats = {
        "missed_updates": walk_missed_n + (end_active & end_missed).sum(),
        "applied_updates": n_valid + (end_keys != sentinel).sum(),
        "overflow": (aux["overflow"] & ray_valid).sum() + aux["truncated"],
        "compaction_dropped": compaction_dropped,
        "row_lasts_max": (torch.full((), -1, dtype=torch.int64, device=key.device)
                          if row_lasts_max is None else row_lasts_max),
    }
    return records, stats


def _row_lasts_max(rows, limit: int):
    """The largest count of distinct live keys (below ``limit``) in one row
    of row-sorted keys [R, W]: the fused apply's row budget is sized from it
    (integrate.py:985-993).  7 device operations."""
    lasts = ((rows[:, 1:] != rows[:, :-1]) & (rows[:, :-1] < limit)).sum(dim=1)
    return (lasts + (rows[:, -1] < limit)).max()


def _compact_lasts(ids_s: torch.Tensor, last: torch.Tensor, sentinel: int) -> torch.Tensor:
    """Positions (int64) of the voxel-last records of a sorted id stream,
    the sentinel's left out: each touched voxel once."""
    with _PROFILE.sync():  # nonzero reads the count back
        return torch.nonzero(last & (ids_s != sentinel)).squeeze(1)


def apply_records(occupancy, records: dict, cfg: IntegrateConfig, traversal=None):
    """Phase 2: sort the key stream, then deposit + sweep (K2) in place; with
    the traversal layer (``traversal``, updated in place) each voxel's sum of
    its records' traversal is added at its last record.  Returns the count
    of distinct touched voxels (0-dim tensor)."""
    if not cfg.with_traversal:
        # One unstable sort is enough: the stream carries no payload.
        key_s = torch.sort(records["key"]).values
        _, touched = deposit_cuda.deposit_and_sweep(occupancy, key_s, cfg)
        return touched
    key_s, order = torch.sort(records["key"], stable=True)
    trav_s = records["trav"][order]
    # K2 reads only the keys: the counts are integers, so the occupancy bits
    # do not depend on how equal keys were ordered.
    _, touched = deposit_cuda.deposit_and_sweep(occupancy, key_s, cfg)
    ids_s = key_s >> 1
    first, last = segments._first_last(ids_s)
    sums = segments.segment_sums(trav_s, first)
    at = _compact_lasts(ids_s, last, cfg.sentinel)
    ids = ids_s[at].long()
    traversal[ids] = traversal[ids] + sums[at]
    return touched


def sorted_hit_miss_counts(key_s):
    """Per-voxel hit and miss counts of a SORTED (flat << 1 | hit) key
    stream, read off positions (integrate.py:1019-1046): a voxel's records
    order [misses, hits], so the starts of its voxel run and of its key run,
    carried to each position by a cumulative maximum, give both counts at
    its last record.  Returns (ids, first, last, n_hit, n_miss); the counts
    are int32 (the reference's f32 holds the same integers) and meaningful
    at voxel-last positions."""
    ids_s = key_s >> 1
    first, last = segments._first_last(ids_s)
    run_first = segments._first_last(key_s)[0]
    pos = torch.arange(key_s.shape[0], dtype=torch.int32, device=key_s.device)
    neg = -(1 << 30)
    p_vox = segments.cummax(torch.where(first, pos, neg), neg)
    p_run = segments.cummax(torch.where(run_first, pos, neg), neg)
    is_hit = (key_s & 1) == 1
    n_hit = torch.where(is_hit, pos - p_run + 1, 0)
    n_miss = torch.where(is_hit, p_run - p_vox, pos - p_vox + 1)
    return ids_s, first, last, n_hit, n_miss


def sorted_nonneg_sums(vals_s, first):
    """Segment sums of a sorted non-negative f32 stream, valid at segment
    lasts, in blocked.segment_sums's order (integrate.py:1049-1058)."""
    return segments.segment_sums(vals_s, first)


def _segment_hit_miss_sums(hits, misses, first):
    """Exact per-segment sums of non-negative int32 hit and miss counts at
    every position of a sorted stream (``first`` marks starts): one int64
    prefix sum of hits << 32 | misses (a segment's misses stay below 2^32,
    so the difference of two prefixes holds both sums), less its value
    before the segment's first record.  Returns (hit sums, miss sums)."""
    packed = (hits.to(torch.int64) << 32) | misses.to(torch.int64)
    cs = torch.cumsum(packed, dim=0)
    pos = torch.arange(packed.shape[0], dtype=torch.int64, device=packed.device)
    start = segments.cummax(torch.where(first, pos, 0), 0)
    tot = cs - (cs - packed)[start]
    return tot >> 32, tot & 0xFFFFFFFF


def _fused_row_partials(ids2, weight_f, trav_f, cap2: int, cfg: IntegrateConfig):
    """The fused apply's level 1 (integrate.py:1244-1299): per-row partial
    miss counts (and traversal sums) at each row's voxel-lasts, compacted
    into [R, cap2] by one row sort.  ``ids2`` [R, cap] is row-sorted (the
    expand compaction's sort); ``weight_f`` [R*cap] f32 weighs each record
    (0 masks one out; None counts every record, by run lengths), ``trav_f``
    [R*cap] the records' traversal or None.  Returns (kc i32[R, cap2],
    pc i32[R, cap2] miss counts, tc f32[R, cap2] or None, dropped): the
    lasts past cap2 in a row drop (its highest ids), and ``dropped`` counts
    them."""
    R, cap = ids2.shape
    if cap >= 1 << 16:
        # The merge packs a row's counts into 16 bits.
        raise ValueError("fused row width must fit 16-bit per-row run counts")
    sent = cfg.sentinel
    neq = ids2[:, 1:] != ids2[:, :-1]
    edge = torch.ones((R, 1), dtype=torch.bool, device=ids2.device)
    first_f = torch.cat([edge, neq], dim=1).reshape(-1)
    real_last2 = torch.cat([neq, edge], dim=1) & (ids2 != sent)
    if weight_f is None:
        pos = torch.arange(R * cap, dtype=torch.int32, device=ids2.device)
        neg = -(1 << 30)
        cnt = pos - segments.cummax(torch.where(first_f, pos, neg), neg) + 1
    else:
        # Integer-valued f32 sums below 2^16: exact.
        cnt = segments.segment_sums(weight_f, first_f).to(torch.int32)
    packed_w = torch.where(real_last2, cnt.reshape(R, cap), 0)
    key2 = torch.where(real_last2, ids2, sent)
    # Equal keys in a row are sentinels with zero payloads (a voxel's last
    # is unique in its row): any order of them gives the same rows.
    key2, order = torch.sort(key2, dim=1)
    kc = key2[:, :cap2]
    order = order[:, :cap2]
    realc = kc != sent
    pc = torch.where(realc, torch.gather(packed_w, 1, order), 0)
    tc = None
    if trav_f is not None:
        trav2 = sorted_nonneg_sums(trav_f, first_f).reshape(R, cap)
        tc = torch.where(realc, torch.gather(trav2, 1, order), 0.0)
    dropped = real_last2.sum() - realc.sum()
    return kc, pc, tc, dropped


def _pad_targets(real, ids, n_vox: int):
    """Scatter targets of a stream [M]: ``ids`` (int64) where ``real``, and
    elsewhere the entry's position modulo ``n_vox``, so that pad entries,
    which add the identity (0, or -0.0 to f32), spread over the arena.  The
    reference sends them to a scratch tail of unique targets
    (integrate.py:1335-1338); sent to the one sentinel element they
    serialise on the card (~1M writes to one address: the fused apply took
    139-157 ms a batch that way on an H100)."""
    spread = torch.arange(real.shape[0], dtype=torch.int64, device=real.device) % n_vox
    return torch.where(real, ids.to(torch.int64), spread)


def _fused_merge(kc, pc, tc, ids_e, packed_e, trav_e, cfg: IntegrateConfig):
    """The fused apply's level 2 (integrate.py:1302-1340): one small stable
    sort of the row partials and the end entries (packed hit << 16 | miss,
    int32 bits), exact integer sums of each voxel's hits and misses and f32
    sums of its traversal, at its last entry.  Returns (idx i64[M]: the
    voxel at each voxel-last entry, a pad target elsewhere (_pad_targets),
    its hit and miss counts there (0 elsewhere), real_last, the traversal
    sums or None)."""
    sent = cfg.sentinel
    ids_m = torch.cat([kc.reshape(-1), ids_e])
    M = ids_m.shape[0]
    if M > cfg.scatter_pad:
        raise ValueError(f"fused merge stream {M} exceeds scatter_pad {cfg.scatter_pad}")
    ids_s, order = torch.sort(ids_m, stable=True)
    packed_s = torch.cat([pc.reshape(-1), packed_e])[order]
    first_s, last_s = segments._first_last(ids_s)
    n_hit, n_miss = _segment_hit_miss_sums((packed_s >> 16) & 0xFFFF, packed_s & 0xFFFF,
                                           first_s)
    real_last = last_s & (ids_s != sent)
    idx = _pad_targets(real_last, ids_s, sent)
    trav_tot = None
    if tc is not None:
        trav_tot = sorted_nonneg_sums(torch.cat([tc.reshape(-1), trav_e])[order], first_s)
    return idx, torch.where(real_last, n_hit, 0), torch.where(real_last, n_miss, 0), \
        real_last, trav_tot


def _count_planes_at(n: int, idx, n_hit, n_miss):
    """int32 hit and miss planes [n] holding each voxel-last entry's counts
    (``idx`` from _pad_targets: unique at those entries; the pads add 0, so
    the integer sums are exact in any order): the reference's fresh packed
    pending plane."""
    planes = torch.zeros((n, 2), dtype=torch.int32, device=idx.device)
    planes.index_add_(0, idx, torch.stack([n_hit, n_miss], dim=1).to(torch.int32))
    return planes[:, 0], planes[:, 1]


def apply_records_fused(occupancy, records: dict, cfg: IntegrateConfig, traversal=None):
    """Phase 2, the two-level row-local apply (integrate.py:1116-1192): no
    sort of the whole key stream.  The expand phase's compaction rows
    [R, group_cap] are sorted already; level 1 reduces each row to its
    voxels' partial miss counts (and traversal sums), compacted to
    ``row_cap`` entries a row by one row sort (_fused_row_partials); level 2
    merges those with the end records (one count each) in one small sort
    and sums each voxel's counts exactly (_fused_merge).  The counts
    scatter into a fresh plane and the occupancy sweep runs over the arena
    against batch-start values (deposit_cuda.sweep, the reference's dense
    sweep): the counts are integers, so occupancy is bit-identical to
    apply_records'; traversal differs by f32 reassociation only.  The row
    window is clamped so the merge stream fits ``scatter_pad``, as the
    reference's scratch tail bounds it.  Updates ``occupancy`` (and
    ``traversal``) in place; returns (touched, dropped) as 0-dim tensors:
    the voxels written, and the voxel-lasts that the row window dropped."""
    key = records["key"]
    n_end = records["end_flat"].shape[0]
    n_walk = key.shape[0] - n_end
    cap, cap2 = cfg.group_cap, cfg.row_cap
    if cap <= 0 or cap2 <= 0 or n_walk % cap:
        raise ValueError("fused apply requires group-compacted rows and row_cap > 0")
    if cap >= 1 << 16:
        raise ValueError("group_cap must fit 16-bit per-row run counts")
    R = n_walk // cap
    cap2 = min(cap2, cap, max(1, (cfg.scatter_pad - n_end) // R))
    sent = cfg.sentinel
    trav_w = records["trav"][:n_walk] if cfg.with_traversal else None
    kc, pc, tc, dropped = _fused_row_partials(key[:n_walk].reshape(R, cap) >> 1, None, trav_w,
                                              cap2, cfg)
    ek = key[n_walk:]
    ids_e = ek >> 1
    hit_e = ek & 1
    real_e = ids_e != sent
    packed_e = torch.where(real_e, (hit_e << 16) | (1 - hit_e), 0)
    trav_e = None
    if cfg.with_traversal:
        trav_e = torch.where(real_e, records["trav"][n_walk:], 0.0)
    idx, n_hit, n_miss, real_last, trav_tot = _fused_merge(kc, pc, tc, ids_e, packed_e, trav_e,
                                                           cfg)
    hit_plane, miss_plane = _count_planes_at(sent, idx, n_hit, n_miss)
    occupancy[:sent] = deposit_cuda.sweep(occupancy[:sent], hit_plane, miss_plane, cfg)
    if cfg.with_traversal:
        # Each voxel's sum added once; a pad adds -0.0, which leaves any
        # value as it is, so the order of the atomic adds does not matter.
        traversal.index_add_(0, idx, torch.where(real_last, trav_tot, -0.0))
    return real_last.sum(), dropped


def apply_decoded(layers: dict, records: dict, b: dict, cfg: IntegrateConfig) -> dict:
    """Phase 2 and the sample layers: the fused apply where ``cfg.row_cap``
    is set, else the split one (apply_records).  Returns {touched,
    dropped_updates} as 0-dim tensors."""
    if cfg.row_cap > 0:
        touched, dropped = apply_records_fused(layers["occupancy"], records, cfg,
                                               traversal=layers.get("traversal"))
    else:
        touched = apply_records(layers["occupancy"], records, cfg,
                                traversal=layers.get("traversal"))
        dropped = torch.zeros((), dtype=torch.int64, device=touched.device)
    if cfg.with_mean or cfg.with_touch_time or cfg.with_incident:
        apply_sample_layers(layers, records, b, cfg)
    return {"touched": touched, "dropped_updates": dropped}


def delta_path_ok(cfg: IntegrateConfig) -> bool:
    """True when the delta path keeps the reference's semantics
    (integrate.py:1525-1544): a window is set, no state-dependent ray flag,
    no traversal, saturation off, min_value < 0 < max_value.  The port's
    occupancy arena always holds unobserved as -0.0."""
    state_flags = (RayFlag.EXCLUDE_FREE | RayFlag.EXCLUDE_OCCUPIED
                   | RayFlag.EXCLUDE_UNOBSERVED | RayFlag.STOP_ON_FIRST_OCCUPIED)
    f32 = torch.finfo(torch.float32)
    sat_off = cfg.saturation_min <= f32.min and cfg.saturation_max >= f32.max
    return (cfg.scatter_cap > 0 and not (cfg.ray_flags & state_flags)
            and not cfg.with_traversal and sat_off and cfg.min_value < 0.0 < cfg.max_value)


def apply_delta(occupancy, key, cfg: IntegrateConfig) -> dict:
    """The delta path's apply (integrate.py:1457-1517), in place: sort the
    keys, read each voxel's counts off positions (sorted_hit_miss_counts),
    its delta n_hit * hit + n_miss * miss (separate ops: no FMA), then the
    (voxel << 32 | delta bits) int64 keys of the voxel-lasts sorted to the
    front and cut to the ``scatter_cap`` window; the window's deltas are
    added at their unique voxels (``index_add_``; pad entries add -0.0,
    which leaves any value as it is, _pad_targets), then the whole arena is clamped to
    [min_value, max_value].  Unobserved is -0.0, so -0.0 + x is x and a
    +0.0 delta marks a voxel observed.  Returns {touched, dropped_updates}
    (the voxel-lasts past the window) as 0-dim tensors."""
    n = key.shape[0]
    ids, _, last, n_hit, n_miss = sorted_hit_miss_counts(torch.sort(key).values)
    vox_last = last & (ids < cfg.sentinel)
    delta = (n_hit.to(torch.float32) * cfg.hit_value
             + n_miss.to(torch.float32) * cfg.miss_value)
    i64max = 1 << 62
    bits = delta.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    k2 = torch.where(vox_last, (ids.to(torch.int64) << 32) | bits, i64max)
    cap = cfg.scatter_cap if 0 < cfg.scatter_cap < n else n
    if cap > cfg.scatter_pad:
        raise ValueError(f"delta path needs scatter_pad >= scatter window ({cap}); "
                         f"have {cfg.scatter_pad}")
    s2c = torch.sort(k2).values[:cap]
    real = s2c != i64max
    idx = _pad_targets(real, s2c >> 32, cfg.sentinel)
    val = torch.where(real, (s2c & 0xFFFFFFFF).to(torch.int32).view(torch.float32), -0.0)
    occupancy.index_add_(0, idx, val)
    torch.clamp(occupancy, min=cfg.min_value, max=cfg.max_value, out=occupancy)
    touched = vox_last.sum()
    return {"touched": touched, "dropped_updates": touched - real.sum()}


def _ray_stops(occupied, exclude_start):
    """STOP_ON_FIRST_OCCUPIED's masks (integrate.py:715-738): a record stops
    after its segment's first occupied record, and every record of a later
    segment of the same ray (segments of one ray are contiguous, the first
    marked ``exclude_start``) stops once an earlier one saw an occupied
    voxel.  Returns (stop_mask bool[B,W], ray_stopped bool[B]: the ray
    stopped in this segment or before)."""
    occ_i = occupied.to(torch.int32)
    seen_before = torch.cumsum(occ_i, dim=1, dtype=torch.int32) - occ_i
    # The segmented OR scan over the segment axis: a segment is stopped
    # when its ray's latest occupied segment (up to it) is at or after the
    # ray's first segment.
    pos = torch.arange(occupied.shape[0], dtype=torch.int64, device=occupied.device)
    run_start = torch.cummax(torch.where(exclude_start, pos, torch.zeros_like(pos)), 0).values
    last_occ = torch.cummax(torch.where(occupied.any(dim=1), pos, torch.full_like(pos, -1)),
                            0).values
    stopped_inc = last_occ >= run_start
    prev = torch.cat([torch.zeros_like(stopped_inc[:1]), stopped_inc[:-1]]) & ~exclude_start
    return (seen_before > 0) | prev[:, None], stopped_inc


def integrate_occupancy(layers: dict, b: dict, cfg: IntegrateConfig) -> dict:
    """The monolith (integrate.py:666-883), which the segmented wire takes
    under STOP_ON_FIRST_OCCUPIED: the ordered walk, whose records after a
    ray's first voxel occupied at batch start make no occupancy update (the
    occupied voxel's own miss still applies), nor does the stopped ray's
    end record.  The occupancy goes through K2 with the stopped records'
    keys set to the sentinel: its counts are integers, so a voxel whose
    records all stopped keeps its value, as the reference's zero counts
    leave it.  Traversal sums every valid walk record, stopped ones too, in
    the reference's scan order; the sample layers take the unstopped hits.
    Updates ``layers`` (the arena's) in place; returns the stats."""
    flags = cfg.ray_flags
    sentinel = cfg.sentinel
    ray_valid = b["valid"]
    walk = walk_rays(b["start_abs"], b["end_abs"], b["start_frac"], b["direction"],
                     b["length"], cfg.resolution, cfg.max_steps,
                     total_cap=cfg.walk_cap or None)
    rec_valid = walk["valid"] & ray_valid[:, None]
    if flags & RayFlag.EXCLUDE_ORIGIN:
        rec_valid[:, 0] &= ~b["exclude_start"]
    if flags & RayFlag.EXCLUDE_RAY:
        rec_valid = torch.zeros_like(rec_valid)
    walk_flat, walk_missed = resolve_voxels(walk["voxels"], cfg, b)
    walk_flat = torch.where(rec_valid, walk_flat, torch.full_like(walk_flat, sentinel))
    walk_is_miss = rec_valid
    ray_stopped = torch.zeros_like(ray_valid)
    if flags & RayFlag.STOP_ON_FIRST_OCCUPIED:
        occ_at = layers["occupancy"][walk_flat.long()]  # batch start
        unobs = (occ_at == 0) & torch.signbit(occ_at)
        occupied = ~unobs & (occ_at >= cfg.occupancy_threshold) & rec_valid
        stop_mask, ray_stopped = _ray_stops(occupied, b["exclude_start"])
        walk_is_miss = rec_valid & ~stop_mask

    end_flat, end_missed = resolve_voxels(b["end_abs"], cfg, b)
    end_is_hit = b["is_sample"] & ray_valid & ~ray_stopped
    end_is_miss = b["end_as_miss"] & ray_valid & ~ray_stopped
    if flags & RayFlag.EXCLUDE_SAMPLE:
        end_is_hit = torch.zeros_like(end_is_hit)
    if flags & RayFlag.EXCLUDE_RAY:
        end_is_miss = torch.zeros_like(end_is_miss)
    end_active = end_is_hit | end_is_miss
    end_ids = torch.where(end_active, end_flat, torch.full_like(end_flat, sentinel))

    # Traversal reads the unmasked stream; K2 reads the masked keys.
    traversal = layers.get("traversal")
    if cfg.with_traversal:
        walk_trav = walk["exits"] - walk["enters"]
        walk_trav = torch.where(rec_valid, walk_trav, torch.zeros_like(walk_trav))
        end_trav = b["length"] - walk["end_enter"]
        end_trav = torch.where(end_active, end_trav, torch.zeros_like(end_trav))
        ids_s, order = torch.sort(torch.cat([walk_flat.reshape(-1), end_ids]), stable=True)
        last, sums = segments.segment_reduce(
            ids_s, torch.cat([walk_trav.reshape(-1), end_trav])[order], "sum")
        at = _compact_lasts(ids_s, last, sentinel)
        ids = ids_s[at].long()
        traversal[ids] = traversal[ids] + sums[at]
    miss_ids = torch.where(walk_is_miss, walk_flat, torch.full_like(walk_flat, sentinel))
    key = torch.cat([miss_ids.reshape(-1) << 1, (end_ids << 1) | end_is_hit.to(torch.int32)])
    # No payload rides with the keys: the unstable sort gives the same stream.
    _, touched = deposit_cuda.deposit_and_sweep(layers["occupancy"], torch.sort(key).values,
                                                cfg)
    if cfg.with_mean or cfg.with_touch_time or cfg.with_incident:
        apply_sample_layers(layers, {"end_flat": end_flat, "end_is_hit": end_is_hit}, b, cfg)
    return {
        "missed_updates": (rec_valid & walk_missed).sum() + (end_active & end_missed).sum(),
        "applied_updates": ((rec_valid & ~walk_missed).sum()
                            + (end_active & ~end_missed).sum()),
        "overflow": (walk["overflow"] & ray_valid).sum() + walk["truncated"],
        "compaction_dropped": torch.zeros((), dtype=torch.int64, device=key.device),
        "touched": touched,
        "dropped_updates": torch.zeros((), dtype=torch.int64, device=key.device),
    }


def integrate_decoded(layers: dict, b: dict, cfg: IntegrateConfig,
                      expand=expand_records) -> dict:
    """One decoded batch (ops.wire.decode) into the occupancy arena
    ``layers`` (layer name -> tensor), in place: ``expand`` (expand_records;
    a caller may pass a wrapper of it) + apply_decoded (the fused apply
    where ``cfg.row_cap`` is set, else the split one) and the sample layers,
    or the monolith under STOP_ON_FIRST_OCCUPIED.  Returns the stats as
    0-dim tensors: missed_updates, applied_updates, overflow,
    compaction_dropped, touched, dropped_updates (and row_lasts_max after
    the expand).  Each shard of ohm_tpu_torch.parallel calls it."""
    if cfg.ray_flags & RayFlag.STOP_ON_FIRST_OCCUPIED:
        return integrate_occupancy(layers, b, cfg)
    records, stats = expand(b, cfg)
    stats.update(apply_decoded(layers, records, b, cfg))
    return stats


def integrate_delta(layers: dict, b: dict, cfg: IntegrateConfig,
                    expand=expand_records) -> dict:
    """One decoded batch through the delta path (tpu_map.py:592-606):
    ``expand``, apply_delta on the occupancy, then the sample layers.
    Returns the expand's stats with touched and dropped_updates."""
    records, stats = expand(b, cfg)
    stats.update(apply_delta(layers["occupancy"], records["key"], cfg))
    if cfg.with_mean or cfg.with_touch_time or cfg.with_incident:
        apply_sample_layers(layers, records, b, cfg)
    return stats


def integrate_chain(layers: dict, stacked, cfg: IntegrateConfig, k: int,
                    expand=expand_records) -> dict:
    """Run ``k`` rows of one stacked rayflow upload (u8[k, L], every row
    under ``cfg``) through decode, ``expand`` and apply_decoded, in order,
    in place (integrate.py:1199-1237): the same stages as k separate
    batches.  Returns the stats summed over the rows, with the maximum of
    row_lasts_max and touched."""
    acc = None
    for i in range(k):
        b = decode(stacked[i], cfg)
        records, st = expand(b, cfg)
        st.update(apply_decoded(layers, records, b, cfg))
        if acc is None:
            acc = st
        else:
            acc = {name: (torch.maximum(acc[name], v) if name in ("row_lasts_max", "touched")
                          else acc[name] + v) for name, v in st.items()}
    return acc


def _u32_to_f32(x: torch.Tensor) -> torch.Tensor:
    """uint32 values held as int32 bit patterns -> f32 (as XLA converts)."""
    return (x.long() & 0xFFFFFFFF).to(torch.float32)


def apply_sample_layers(layers: dict, records: dict, b: dict, cfg: IntegrateConfig) -> None:
    """Mean, touch-time and incident-normal updates from the batch's
    end-voxel hits, in place on the arena ``layers`` (reference:
    ``_apply_sample_layers``, ohm/RayMapperOccupancy.cpp:283-325).

    The hits sort stably by voxel with their payloads; per voxel the sample
    count, the mean and incident sums and the touch maximum reduce in the
    reference's scan order (ops.segments.segment_reduce); then the mean
    updates, then touch, then incident, which reads the mean count the mean
    update has just stored.  Only voxels with a hit are written."""
    sentinel = cfg.sentinel
    end_is_hit = records["end_is_hit"]
    s_ids = torch.where(end_is_hit, records["end_flat"],
                        torch.full_like(records["end_flat"], sentinel))
    hit = end_is_hit[:, None]
    cols = [end_is_hit.to(torch.float32)[:, None]]
    if cfg.with_mean:
        cols.append(torch.where(hit, b["end_frac"], torch.zeros_like(b["end_frac"])))
    if cfg.with_incident:
        # The reference's first sum reads a denormal component as zero.
        inc = subvoxel.flush_denormals(-b["direction"])
        cols.append(torch.where(hit, inc, torch.zeros_like(inc)))
    s_sorted, order = torch.sort(s_ids, stable=True)
    s_last, sums = segments.segment_reduce(s_sorted, torch.cat(cols, dim=1)[order], "sum")
    at = _compact_lasts(s_sorted, s_last, sentinel)
    ids = s_sorted[at].long()
    sums = sums[at]
    k = sums[:, 0]  # hits per voxel, at least 1 at every id
    j = 1
    if cfg.with_mean:
        local_sums = sums[:, j:j + 3]
        j += 3
        old_coord = layers["mean_coord"][ids]
        old_count_bits = layers["mean_count"][ids]
        old_count = _u32_to_f32(old_count_bits)
        old_mean = subvoxel.sub_voxel_to_local_coord(old_coord, cfg.resolution)
        denom = torch.clamp(old_count + k, min=1.0)
        new_mean = (old_mean * old_count[:, None] + local_sums) / denom[:, None]
        layers["mean_coord"][ids] = subvoxel.sub_voxel_coord(new_mean, cfg.resolution)
        # u32 add on int32 bit patterns: the same bits, wrapping alike.
        layers["mean_count"][ids] = old_count_bits + k.to(torch.int32)
    if cfg.with_touch_time:
        touch = torch.where(end_is_hit, b["touch_enc"], torch.zeros_like(b["touch_enc"]))
        layers["touch_time"][ids] = segments.segment_u32_max(s_sorted, touch[order])[at]
    if cfg.with_incident:
        if cfg.with_mean:
            # The count stored by the mean update above, as the reference
            # reads it after its scatter.
            prior = torch.clamp(_u32_to_f32(layers["mean_count"][ids]) - k, min=0.0)
        else:
            prior = torch.zeros_like(k)
        layers["incident"][ids] = merge_incident(layers["incident"][ids], prior,
                                                 sums[:, j:j + 3])


def merge_incident(old_packed, prior, inc_sums):
    """New packed normals (int32 patterns) of voxels whose old pattern is
    ``old_packed``: the old normal weighted by ``prior`` (by 0 where it is
    unset) plus the batch's sum of the hits' negated directions, normalised
    (the reference's incident update, ohm/VoxelIncidentCompute.h)."""
    old_normal = subvoxel.decode_normal(old_packed)
    has_old = torch.any(old_normal != 0, dim=-1)
    w = torch.where(has_old, prior, torch.zeros_like(prior))
    merged = old_normal * w[:, None] + inc_sums
    sq = merged * merged
    norm = subvoxel.sqrt_f32(sq[:, 0] + sq[:, 1] + sq[:, 2])
    unit = merged / torch.clamp(norm, min=1e-12)[:, None]
    unit = torch.where((norm > 1e-6)[:, None], unit, torch.zeros_like(unit))
    # A denormal quotient is written as zero there too, so it sets neither
    # the sign bit nor the set bit.
    return subvoxel.encode_normal(subvoxel.flush_denormals(unit))
