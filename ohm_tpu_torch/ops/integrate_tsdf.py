"""TSDF integration of one batch (rayflow or segmented wire).

Counterpart of the kernel branch of ``integrate_tsdf`` in
``ohm_tpu/ops/integrate_tsdf.py`` (the branch the JAX package takes on a TPU,
with its expand, seed-gather and pair-deposit kernels):

  expand     the walk front end with voxel planes (ops.integrate.expand_walk:
             K1 on the rayflow wire, the plain walk and the corner-slot
             resolve on the segmented one), no origin exclusion; the end
             record of every ray (on the segmented wire of every final
             segment: a non-final segment's boundary voxel belongs to the
             next segment) through ops.integrate.resolve_voxels (the
             reference's walk includes the sample voxel)
  sdf        per record, voxel-local in f32: (full_length - t0) + (q . dir)
             with q = start_frac + (start_abs - voxel) * resolution
  compaction the group row sort cut at the host's cap, the payloads (visit
             key, weight, w*sdf) riding along
  per visit  one stable sort on (voxel << 32 | visit order: the source ray
             on the rayflow wire, the segment on the segmented one); then one call
             (ops.tsdf_cuda.tsdf_visits, K5+K6 fused) reads the batch-start
             (weight, distance) at every record; the clamped weight
             telescopes to min(w0 + prefix, max_weight), and every visit is
             the monotone map d -> clamp((d*wc + sdf*u) / (wc + u), -trunc,
             trunc), whose composition over a segment is one affine+clamp
             map, in ops.segments' blocked order; each voxel's last (w, d)
             is stored in place
  per batch  (``per_visit=False``) per-voxel sums of w and w*sdf, the
             ``scatter_cap`` window, a unique scatter, one blend and
             truncation per voxel over the arena

The arena is a dict of layer tensors (mapping.arena.VoxelArena.layers); the
two TSDF planes update in place: the per-visit call reads every voxel's
pair before it stores that voxel.  Every sort is
stable and every float sum goes through ops.segments, so a batch gives the
same bits on every run.  On the ``per_visit=False`` route the reference's
``scatter_cap`` window applies (integrate_tsdf.py:231-270): where
0 < cap < the record count, only the first ``cap`` voxel-lasts in key order
deposit and the rest are counted in ``dropped_updates``.  The per-visit
route has no window, as the reference's kernel route has none (its
deposit_ok branch: nothing seed-drops), so there ``dropped_updates`` is 0;
the reference's CPU-only capped seed fetch (integrate_tsdf.py:303-358) is
not ported.  The stats stay on the device.
"""

from __future__ import annotations

import numpy as np
import torch

from ohm_tpu_torch.ops import tsdf_cuda
from ohm_tpu_torch.ops.config import TsdfConfig
from ohm_tpu_torch.ops.ddawalk import f32
from ohm_tpu_torch.ops.integrate import expand_walk, group_rows, resolve_voxels
from ohm_tpu_torch.ops.segments import segment_sums
from ohm_tpu_torch.ops.tsdf_cuda import NEAR_ZERO


def _dot3(q: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """sum(q * d, axis=-1) over 3 lanes, each product and sum rounded."""
    return q[..., 0] * d[..., 0] + q[..., 1] * d[..., 1] + q[..., 2] * d[..., 2]


def _weight_of(sdf: torch.Tensor, cfg: TsdfConfig) -> torch.Tensor:
    """The update weight of a record (integrate_tsdf.py:131-138)."""
    trunc = f32(cfg.default_truncation_distance)
    w = torch.ones_like(sdf)
    if cfg.dropoff_epsilon > 0:
        w = w * (trunc + sdf) / float(np.float32(trunc) - np.float32(cfg.dropoff_epsilon))
    w = torch.clamp(w, min=0.0)
    if cfg.sparsity_compensation_factor > 0:
        w = torch.where(sdf.abs() < trunc, w * f32(cfg.sparsity_compensation_factor), w)
    return w


def integrate_tsdf(arena: dict, b: dict, cfg: TsdfConfig) -> dict:
    """Integrate one decoded batch (ops.wire.decode) into the
    ``tsdf_weight`` and ``tsdf_distance`` layers of ``arena``, in place.

    Returns the stats as 0-dim tensors: missed_updates, overflow, touched,
    compaction_dropped, dropped_updates."""
    base = cfg.base
    sentinel = base.sentinel
    dev = b["start_abs"].device
    res = f32(base.resolution)
    trunc = f32(cfg.default_truncation_distance)
    max_weight = f32(cfg.max_weight)
    ray_valid = b["valid"]

    walk_flat, aux = expand_walk(b, base, exclude_origin=False, with_vox=True)
    B, S = walk_flat.shape
    rec_mask = walk_flat != sentinel
    end_flat, end_missed = resolve_voxels(b["end_abs"], base, b)
    end_active = (b["is_sample"] | b["end_as_miss"]) & ray_valid
    end_ids = torch.where(end_active, end_flat, torch.full_like(end_flat, sentinel))

    # sdf = full_len - dot(c - sensor, dir) = full_len - t0 + dot(p0 - c, dir),
    # p0 - c voxel-local.  K1 leaves the voxel of a sentinel lane unspecified:
    # such records carry weight 0 into the sentinel segment, which nothing reads.
    span = b["full_length"] - b["t0"]
    q_w = b["start_frac"][:, None, :] + (b["start_abs"][:, None, :] - aux["vox"]).to(
        torch.float32) * res
    sdf_w = span[:, None] + _dot3(q_w, b["direction"][:, None, :])
    q_e = b["start_frac"] + (b["start_abs"] - b["end_abs"]).to(torch.float32) * res
    sdf_e = span + _dot3(q_e, b["direction"])

    # With the reference's default weighting every live record weighs 1.0,
    # so the weight is (id != sentinel) after any reorder.
    uniform_w = (cfg.dropoff_epsilon <= 0.0
                 and cfg.sparsity_compensation_factor in (0.0, 1.0))
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    if uniform_w:
        w_w = rec_mask.to(torch.float32)
        w_e = end_active.to(torch.float32)
    else:
        w_w = torch.where(rec_mask, _weight_of(sdf_w, cfg), zero)
        w_e = torch.where(end_active, _weight_of(sdf_e, cfg), zero)

    walk_ids = walk_flat.reshape(-1)
    walk_w = w_w.reshape(-1)
    walk_wsdf = (w_w * sdf_w).reshape(-1)
    # The visit order: on the rayflow wire the ORIGINAL ray index (the
    # wire's rows may be snake-permuted), on the segmented wire the segment
    # index (segments are emitted ray-major); each ray or segment visits a
    # voxel at most once.
    row_order = b.get("ray_order")
    if row_order is None:
        row_order = torch.arange(B, dtype=torch.int32, device=dev)
    ridx = row_order[:, None].expand(B, S).reshape(-1)
    compaction_dropped = torch.zeros((), dtype=torch.int64, device=dev)
    G = base.group_size
    if base.group_cap and B % G == 0 and base.group_cap < G * S:
        # Sentinel ids sort to the back of each row; the host's cap covers
        # every live record (compaction_dropped counts violations).  The
        # stable sort keeps same-voxel records in row order, as the
        # reference's sort does on the CPU.
        rows, order = torch.sort(group_rows(walk_ids, B, S, G), dim=1, stable=True)
        cap = base.group_cap
        n_valid = (walk_ids < sentinel).sum()
        rows = rows[:, :cap]
        compaction_dropped = n_valid - (rows < sentinel).sum()
        order = order[:, :cap]

        def take(x):
            return torch.gather(group_rows(x, B, S, G), 1, order).reshape(-1)

        walk_ids = rows.reshape(-1)
        if cfg.per_visit:
            ridx = take(ridx)
        walk_w = (walk_ids != sentinel).to(torch.float32) if uniform_w else take(walk_w)
        walk_wsdf = take(walk_wsdf)

    ids = torch.cat([walk_ids, end_ids])
    w_all = torch.cat([walk_w, w_e])
    wsdf_all = torch.cat([walk_wsdf, w_e * sdf_e])
    if cfg.per_visit:
        key = (ids.to(torch.int64) << 32) | torch.cat([ridx, row_order]).to(torch.int64)
        order = torch.sort(key, stable=True).indices
    else:
        order = torch.sort(ids, stable=True).indices
    ids_s = ids[order]
    wsdf_s = wsdf_all[order]
    w_s = None if uniform_w else w_all[order]
    neq = ids_s[1:] != ids_s[:-1]
    one = torch.ones(1, dtype=torch.bool, device=dev)
    first = torch.cat([one, neq])
    last = torch.cat([neq, one])
    real_seg = ids_s != sentinel
    weight, distance = arena["tsdf_weight"], arena["tsdf_distance"]

    voxel_last = last & real_seg
    dropped = torch.zeros((), dtype=torch.int64, device=dev)
    if cfg.per_visit:
        tsdf_cuda.tsdf_visits(weight, distance, ids_s, w_s, wsdf_s, trunc, max_weight,
                              sentinel)
    else:
        if w_s is None:
            w_s = real_seg.to(torch.float32)
        write, dropped = scatter_window(voxel_last, base.scatter_cap)
        _blend_batch(weight, distance, ids_s, write, w_s, wsdf_s, first,
                     trunc, max_weight, sentinel)

    return {
        "missed_updates": aux["missed_n"] + (end_active & end_missed).sum(),
        "overflow": (aux["overflow"] & ray_valid).sum() + aux["truncated"],
        "touched": voxel_last.sum(),
        "compaction_dropped": compaction_dropped,
        "dropped_updates": dropped,
    }


def scatter_window(mask: torch.Tensor, scatter_cap: int) -> tuple:
    """The reference's deposit window over a key-sorted stream
    (integrate_tsdf.py:231-270): where 0 < scatter_cap < the stream length,
    only the first ``scatter_cap`` rows of ``mask`` (in stream order, which
    is key order) stay set.  Returns (the windowed mask, the count of rows
    it dropped, a 0-dim int64 tensor)."""
    if not 0 < scatter_cap < mask.shape[0]:
        return mask, torch.zeros((), dtype=torch.int64, device=mask.device)
    kept = mask & (torch.cumsum(mask, 0, dtype=torch.int32) <= scatter_cap)
    return kept, mask.sum() - kept.sum()


def _blend_batch(weight, distance, ids_s, write, w_s, wsdf_s, first, trunc: float,
                 max_weight: float, sentinel: int) -> None:
    """The ``per_visit=False`` update (integrate_tsdf.py:409-425): per-voxel
    sums of w and w*sdf (w*sdf split by sign, as segment_sums needs
    non-negative values), a unique scatter of the segment lasts, then one
    blend and truncation per voxel over the whole arena, in place."""
    w_sum = segment_sums(w_s, first)
    wsdf_sum = (segment_sums(torch.clamp(wsdf_s, min=0.0), first)
                - segment_sums(torch.clamp(-wsdf_s, min=0.0), first))
    # Records that do not write send +0.0 to the sentinel element of the
    # pending planes, which nothing reads.
    idx = torch.where(write, ids_s, torch.full_like(ids_s, sentinel)).long()
    pending = []
    for vals in (w_sum, wsdf_sum):
        plane = torch.zeros_like(weight)
        plane.index_put_((idx,), torch.where(write, vals, torch.zeros_like(vals)))
        pending.append(plane)
    pending_w, pending_wsdf = pending
    w0, d0 = weight, distance
    new_w = w0 + pending_w
    near_zero = new_w.abs() < NEAR_ZERO
    new_d = torch.where(near_zero, d0, (pending_wsdf + d0 * w0)
                        / torch.where(near_zero, torch.ones_like(new_w), new_w))
    new_d = torch.where(new_d > 0, torch.clamp(new_d, max=trunc), torch.clamp(new_d, min=-trunc))
    keep = (pending_w == 0) | near_zero
    new_w = torch.where(keep, w0, torch.clamp(new_w, max=max_weight))
    new_d = torch.where(keep, d0, new_d)
    weight.copy_(new_w)
    distance.copy_(new_d)
