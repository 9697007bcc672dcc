"""Spatially sharded region arenas over a ShardMesh.

Counterpart of ``ohm_tpu/parallel/sharded.py``.  The region set is
partitioned across shards by region-key ownership (``region_owner``: a hash
of the super-region, mod n_shards).  Each shard keeps its own arena and
region table holding only the regions it owns, on its mesh device, and runs
the unchanged single-device core (ops.integrate.integrate_decoded) against
them, so records in regions it does not own resolve to the sentinel and
drop out: each voxel record is applied on exactly one shard.

Two batch schemes, as the reference's: replicated (``make_sharded_batch``:
every shard gets every segment, corner slots resolved against its own
table) and routed (``make_routed_batch``: a segment ships only to the
owners of its 2x2x2 corner-region box).  A step updates each shard's layers
in place (the reference donates them) and returns the per-shard stats
stacked on a leading shard axis.
"""

from __future__ import annotations

import numpy as np
import torch

from ohm_tpu_torch.mapping.arena import VoxelArena
from ohm_tpu_torch.mapping.batch import fill_corner_slots
from ohm_tpu_torch.ops.config import IntegrateConfig
from ohm_tpu_torch.ops.integrate import integrate_decoded
from ohm_tpu_torch.ops.wire import unpack_segmented
from ohm_tpu_torch.parallel.mesh import ShardMesh


def region_owner(region_keys: np.ndarray, n_shards: int, super_shift: int = 2) -> np.ndarray:
    """Shard ownership by SUPER-REGION hash (host-side, numpy).

    Regions are grouped into super-regions of 2^super_shift per axis before
    hashing, so a segment's 2x2x2 corner-region box usually lands on one
    owner: with 4-region super-blocks ~42% of segments have a single owner
    and the mean owner count is ~1.6 (vs 8 for per-region hashing at 8
    shards).  Hashing the super-region key (rather than tiling shards in
    space) keeps load statistically balanced across many frames.

    Arithmetic is uint32 wraparound so the DEVICE can reproduce ownership
    bit-exactly in int32 (parallel.a2a in-jit routing) — no i64 needed.
    """
    r = (np.asarray(region_keys, dtype=np.int64) >> super_shift).astype(np.uint32)
    with np.errstate(over="ignore"):
        h = ((r[..., 0] * np.uint32(73856093))
             ^ (r[..., 1] * np.uint32(19349669))
             ^ (r[..., 2] * np.uint32(83492791)))
    return (h % np.uint32(n_shards)).astype(np.int64)


_U32 = 0xFFFFFFFF


def region_owner_torch(region_keys: torch.Tensor, n_shards: int,
                       super_shift: int = 2) -> torch.Tensor:
    """Device twin of region_owner (``region_owner_jnp``): the same uint32
    hash, bit for bit, as int32 owners.  PyTorch has few uint32 ops on CUDA
    and an int32 product overflows, so the hash runs in int64 with each
    product masked to 32 bits."""
    r = (region_keys.to(torch.int64) >> super_shift) & _U32
    h = (((r[..., 0] * 73856093) & _U32) ^ ((r[..., 1] * 19349669) & _U32)
         ^ ((r[..., 2] * 83492791) & _U32))
    return (h % n_shards).to(torch.int32)


#: The stats a sharded occupancy step returns (ops.integrate.integrate_decoded).
STATS_KEYS = ("missed_updates", "applied_updates", "overflow", "touched")


class ShardedArena:
    """One port VoxelArena per shard, each on its mesh device, holding the
    regions its shard owns ("zero" occupancy encoding, as TorchRayMapper's)."""

    def __init__(self, n_shards: int, capacity: int, region_shift: int, layer_names,
                 mesh: ShardMesh):
        if mesh.n_shards != n_shards:
            raise ValueError(f"{n_shards} shards on a mesh of {mesh.n_shards}")
        self.n_shards = n_shards
        self.mesh = mesh
        self.shards = [VoxelArena(capacity, region_shift, dev, layer_names,
                                  occupancy_encoding="zero") for dev in mesh.devices]
        self.capacity = capacity
        self.region_shift = region_shift

    def ensure_regions(self, region_keys: np.ndarray, host_map=None):
        owners = region_owner(region_keys, self.n_shards)
        for s, arena in enumerate(self.shards):
            mine = region_keys[owners == s]
            if len(mine):
                arena.ensure_regions(mine, host_map)

    def device_state(self) -> list:
        """Each shard's layer dict (the tensors a step updates in place)."""
        return [a.layers for a in self.shards]

    def sync_to_host(self, host_map, stamp=None):
        for arena in self.shards:
            arena.sync_to_host(host_map, stamp=stamp)


def _upload(mesh: ShardMesh, s: int, arrays: dict) -> dict:
    """A segmented batch's numpy blocks as tensors on shard s's device (the
    u32 touch times as int32 bit patterns, as ops.wire.unpack_segmented
    reads them), copied: the caller may reuse the arrays."""
    out = {}
    for k, v in arrays.items():
        if k == "touch":
            v = np.ascontiguousarray(v).view(np.int32)
        out[k] = torch.from_numpy(np.array(v)).to(mesh.devices[s])
    return out


def build_routed_step(mesh: ShardMesh, cfg, core_fn, stats_keys):
    """The step over per-shard segmented batches: ``step(states, batches)``
    decodes ``batches[s]`` (ops.wire.unpack_segmented) and runs ``core_fn``,
    one of the single-device cores (ops.integrate.integrate_decoded,
    integrate_ndt, integrate_tsdf), unchanged against ``states[s]`` (shard
    s's layers) in place, on shard s's device; returns the stats
    ``stats_keys`` stacked [n_shards]."""
    base = cfg if isinstance(cfg, IntegrateConfig) else cfg.base

    def local(s, state, batch):
        return core_fn(state, unpack_segmented(batch, base), cfg)

    def step(states, batches):
        return mesh.gather_stats(mesh.run(local, list(zip(states, batches))), stats_keys)

    return step


def make_routed_batch(prepared, sharded_arena, mesh: ShardMesh, with_intensity: bool = False):
    """Route segments to the shards owning their corner regions.

    The replicated scheme (make_sharded_batch) ships every segment to every
    shard; here a segment is sent only to the DISTINCT owners of its 2x2x2
    corner-region box, cutting per-shard walk and sort work ~n-fold.  Every
    voxel record still reaches exactly one shard (its region's owner is by
    construction among the segment's corner owners).

    Returns (per-shard batch dicts of ints/floats/flags/touch [B_max, ...]
    (and intensity) on each shard's device, per-shard active segment
    counts)."""
    n_shards = sharded_arena.n_shards
    total = prepared.n_segments
    owners = region_owner(prepared.corner_regions[:total].reshape(-1, 3), n_shards)
    owners = owners.reshape(total, 8)

    # Per-shard segment index lists (a segment may appear on several shards).
    sel = [np.flatnonzero((owners == s).any(axis=1)) for s in range(n_shards)]
    counts = [len(ix) for ix in sel]
    b_max = _next_pow2(max(max(counts), 1))

    arrays = prepared.arrays
    batches = []
    for sidx, ix in enumerate(sel):
        k = len(ix)
        # Resolve corner slots against THIS shard's region table: non-owned
        # corners resolve to -1 and their records drop on the device.
        sub = _subset_prepared(prepared, ix)
        fill_corner_slots(sub, sharded_arena.shards[sidx].table)
        ints = np.zeros((b_max, arrays["ints"].shape[1]), arrays["ints"].dtype)
        ints[:, 9:17] = -1
        out = {"ints": ints,
               "floats": np.zeros((b_max, arrays["floats"].shape[1]), arrays["floats"].dtype),
               "flags": np.zeros((b_max, arrays["flags"].shape[1]), arrays["flags"].dtype),
               "touch": np.zeros(b_max, arrays["touch"].dtype)}
        for name in out:
            out[name][:k] = sub.arrays[name][:k]
        if with_intensity:
            out["intensity"] = np.zeros(b_max, np.float32)
            if prepared.intensities is not None:
                out["intensity"][:k] = prepared.intensities[ix]
        batches.append(_upload(mesh, sidx, out))
    return batches, np.asarray(counts)


def _next_pow2(n: int) -> int:
    size = 256
    while size < n:
        size *= 2
    return size


def _subset_prepared(prepared, ix):
    """A PreparedBatch view holding only segments ``ix`` (host-side copy)."""
    import dataclasses as _dc

    arrays = {k: v[ix].copy() if v.ndim else v for k, v in prepared.arrays.items()}
    # keep fixed widths; sizes re-derived from ix
    return _dc.replace(prepared, size=len(ix), n_segments=len(ix),
                       arrays=arrays, corner_regions=prepared.corner_regions[ix])


def sharded_integrate_routed(mesh: ShardMesh, cfg: IntegrateConfig):
    """The multi-shard occupancy step over per-shard batches: each shard
    integrates the segments it was given (make_routed_batch: those routed
    to it; make_sharded_batch: all of them) against its own arena."""
    return build_routed_step(mesh, cfg, integrate_decoded, STATS_KEYS)


#: The replicated scheme's step is the same per-shard step.
sharded_integrate = sharded_integrate_routed


def check_routed_coverage(stats, total_records: int) -> None:
    """Routed invariant: every record applies on exactly one shard, so the
    per-shard applied counts must sum to the SINGLE-DEVICE active record
    count (which the caller computes from an unrouted reference run)."""
    applied = int(stats["applied_updates"].sum())
    if applied != total_records:
        raise AssertionError(
            f"routed coverage broken: {applied} records applied across shards, "
            f"expected {total_records}")


def make_sharded_batch(prepared, sharded_arena, mesh: ShardMesh):
    """Per-shard batches: the corner slots resolved against each shard's own
    table, the rest of the batch the same on every shard."""
    batches = []
    for s, arena in enumerate(sharded_arena.shards):
        fill_corner_slots(prepared, arena.table)
        batches.append(_upload(mesh, s, {k: prepared.arrays[k] for k in
                                         ("ints", "floats", "flags", "touch")}))
    return batches


def check_sharded_coverage(stats) -> None:
    """Validate the multi-shard write-once invariant.

    Single-device 'missed_updates == 0' is meaningless here: records touching
    regions owned by other shards intentionally resolve to the sentinel and
    count as missed on every non-owner.  The sharded invariant is instead
    that each active record is applied on exactly ONE shard:
    sum_over_shards(applied) == active, where active = applied + missed on
    any single shard (ray geometry is replicated, so active counts are
    shard-invariant).
    """
    applied = stats["applied_updates"].reshape(-1).cpu()
    missed = stats["missed_updates"].reshape(-1).cpu()
    active = int(applied[0] + missed[0])
    total_applied = int(applied.sum())
    if total_applied != active:
        raise AssertionError(
            f"sharded coverage broken: {total_applied} records applied across "
            f"shards but {active} active (each record must apply exactly once)")
