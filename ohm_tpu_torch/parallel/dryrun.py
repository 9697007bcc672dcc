"""dryrun_multichip: every sharded scheme once, each held to the port's
single-device mapper.

Counterpart of ``dryrun_multichip`` in ``__graft_entry__.py``, on a
ShardMesh of ``n_devices`` shards (one a card where there are as many, else
all on one device):

  replicated  ShardedArena + make_sharded_batch + sharded_integrate; each
              record applied on exactly one shard (check_sharded_coverage)
  routed      make_routed_batch + sharded_integrate_routed: fewer segment
              copies than replication, the same applied records
  resident    ShardedRayMapper over 8 batches alternating two single-region
              clusters owned by one shard, at capacity 1: every batch evicts,
              spills and reloads
  a2a         make_source_batch + sharded_integrate_a2a: no routing drop
  rayflow     ShardedRayFlowMapper, occupancy, NDT and TSDF, two batches

Occupancy must be bit-identical to TorchRayMapper on the same wire (the
segmented one for the first four), NDT and TSDF within 1e-5 of TorchNdtMap
and TorchTsdfMap.  Raises AssertionError on any difference.
"""

from __future__ import annotations

import numpy as np

from ohm_tpu_torch.core.map import MapFlag, OccupancyMap
from ohm_tpu_torch.mapping.batch import prepare_ray_batch
from ohm_tpu_torch.mapping.ndt_map import TorchNdtMap
from ohm_tpu_torch.mapping.torch_map import TorchRayMapper
from ohm_tpu_torch.mapping.tsdf_map import TorchTsdfMap
from ohm_tpu_torch.parallel.a2a import make_source_batch, sharded_integrate_a2a
from ohm_tpu_torch.parallel.mapper import ResidentShardedArena, ShardedRayMapper
from ohm_tpu_torch.parallel.mesh import ShardMesh
from ohm_tpu_torch.parallel.rayflow import ShardedRayFlowMapper
from ohm_tpu_torch.parallel.sharded import (ShardedArena, check_routed_coverage,
                                            check_sharded_coverage, make_routed_batch,
                                            make_sharded_batch, region_owner, sharded_integrate,
                                            sharded_integrate_routed)

RESOLUTION = 0.25
#: The tolerance of NDT and TSDF floats against the single-device mappers:
#: shards sum a voxel's records in another grouping (ops.segments).
FLOAT_TOL = 1e-5
#: Each kind's layers compared: (layer, members).
KIND_LAYERS = {"occupancy": [("occupancy", ("occupancy",))],
               "ndt": [("occupancy", ("occupancy",)),
                       ("covariance", ("P00", "P01", "P11", "P02", "P12", "P22"))],
               "tsdf": [("tsdf", ("weight", "distance"))]}


def map_members(m, kind: str = "occupancy") -> dict:
    """(region key, layer, member) -> the member's array, for every chunk."""
    out = {}
    for layer, members in KIND_LAYERS[kind]:
        li = m.layer_index(layer)
        for key, chunk in m.chunks.items():
            for member in members:
                out[(key, layer, member)] = np.array(chunk.layers[li][member])
    return out


def compare_maps(a, b, kind: str = "occupancy") -> float:
    """The worst difference between two maps' layers of ``kind``; raises
    unless they hold the same chunks and the same non-finite values.
    Occupancy must be bit-identical."""
    va, vb = map_members(a, kind), map_members(b, kind)
    if va.keys() != vb.keys():
        raise AssertionError(f"{kind}: chunk sets differ ({len(va)} vs {len(vb)} members)")
    worst = 0.0
    for k, x in va.items():
        y = vb[k]
        if kind == "occupancy":
            if not np.array_equal(x.view(np.uint32), y.view(np.uint32)):
                raise AssertionError(f"occupancy bits differ in region {k[0]}")
            continue
        fin = np.isfinite(x)
        if not (np.array_equal(fin, np.isfinite(y))
                and np.array_equal(x[~fin].view(np.uint32), y[~fin].view(np.uint32))):
            raise AssertionError(f"{kind}: non-finite values differ at {k}")
        if fin.any():
            worst = max(worst, float(np.abs(x[fin].astype(np.float64) - y[fin]).max()))
    if worst > FLOAT_TOL:
        raise AssertionError(f"{kind} differs from the single-device mapper by {worst}")
    return worst


def _scene(rng, n_rays: int, spread: float, origin_scale: float) -> np.ndarray:
    rays = rng.uniform(-spread, spread, (2 * n_rays, 3))
    rays[0::2] *= origin_scale
    return rays


def _single(kind: str, device, rayflow: bool, batches, capacity: int = 512):
    m = OccupancyMap(resolution=RESOLUTION, flags=MapFlag.NONE)
    cls = {"occupancy": TorchRayMapper, "ndt": TorchNdtMap, "tsdf": TorchTsdfMap}[kind]
    mapper = cls(m, capacity=capacity, validate=True, device=device, rayflow=rayflow)
    for rays in batches:
        mapper.integrate_rays(rays)
    mapper.sync_voxels()
    return m


def _synced(arena) -> OccupancyMap:
    m = OccupancyMap(resolution=RESOLUTION, flags=MapFlag.NONE)
    arena.sync_to_host(m)
    return m


def dryrun_multichip(n_devices: int, device="cuda") -> dict:
    """Run every sharded scheme on ``n_devices`` shards against the
    single-device mappers; returns what it measured (worst differences,
    routed copies, evictions, the rayflow mapper's balance) and prints it."""
    mesh = ShardMesh.over_cards(n_devices, device)
    dev = mesh.devices[0]
    out = {"n_shards": mesh.n_shards, "devices": [str(d) for d in mesh.devices]}

    rng = np.random.default_rng(3)
    rays = _scene(rng, 64, 4.0, 0.1)
    m = OccupancyMap(resolution=RESOLUTION, flags=MapFlag.NONE)
    mapper = TorchRayMapper(m, capacity=16, device=dev, rayflow=False)
    cfg = mapper._config(0)
    prepared = prepare_ray_batch(m, rays, segment_length=mapper.segment_length)
    single = _single("occupancy", dev, False, [rays], capacity=64)

    # Replicated: every shard walks every segment.
    arena = ShardedArena(n_devices, 16, mapper.region_shift, ["occupancy"], mesh)
    arena.ensure_regions(prepared.region_keys)
    stats = sharded_integrate(mesh, cfg)(arena.device_state(),
                                         make_sharded_batch(prepared, arena, mesh))
    check_sharded_coverage(stats)
    applied = int(stats["applied_updates"].sum())
    compare_maps(_synced(arena), single)
    out["replicated_applied"] = applied

    # Routed: a segment ships to the owners of its corner regions only.
    arena_r = ShardedArena(n_devices, 16, mapper.region_shift, ["occupancy"], mesh)
    arena_r.ensure_regions(prepared.region_keys)
    batches, counts = make_routed_batch(prepared, arena_r, mesh)
    stats_r = sharded_integrate_routed(mesh, cfg)(arena_r.device_state(), batches)
    check_routed_coverage(stats_r, applied)
    if n_devices > 1 and counts.sum() >= n_devices * prepared.n_segments:
        raise AssertionError("routing did not ship fewer segment copies than replication")
    compare_maps(_synced(arena_r), single)
    out["routed_segments"] = int(counts.sum())
    out["replicated_segments"] = n_devices * prepared.n_segments

    # Resident mapper: two single-region clusters owned by one shard at
    # capacity 1, alternated, so every batch evicts, spills and reloads.
    cand = np.array([[i, 0, 0] for i in range(48)])
    owners = region_owner(cand, n_devices)
    hot = next(s for s in range(n_devices) if (owners == s).sum() >= 2)
    r_a, r_b = cand[owners == hot][:2]
    rng2 = np.random.default_rng(11)
    edge = 32 * RESOLUTION

    def cluster(region, n=64):
        return _scene(rng2, n, 1.5, 0.05) + np.asarray(region, dtype=float) * edge

    batches8 = [cluster(r_a) if i % 2 == 0 else cluster(r_b) for i in range(8)]
    m_sh = OccupancyMap(resolution=RESOLUTION, flags=MapFlag.NONE)
    sh = ShardedRayMapper(m_sh, mesh, capacity=1, validate=True)
    for b in batches8:
        sh.integrate_rays(b)
    sh.sync_voxels()
    if not sh.arena.stats["evictions"]:
        raise AssertionError("the resident scene forced no eviction")
    compare_maps(m_sh, _single("occupancy", dev, False, batches8))
    st = sh.stats
    if n_devices > 1 and st["routed_records"] >= n_devices * st["segments"]:
        raise AssertionError("resident routing shipped no fewer copies than replication")
    out["resident_evictions"] = sh.arena.stats["evictions"]
    out["resident_owners_per_segment"] = st["routed_records"] / max(st["segments"], 1)

    # On-device all-to-all routing of a source-sharded batch.
    arena_a = ResidentShardedArena(mesh, 16, mapper.region_shift, ["occupancy"])
    arena_a.ensure_regions(prepared.region_keys)
    batch_a, max_pairs = make_source_batch(prepared, arena_a, mesh)
    cap_a = max(64, 1 << (max_pairs - 1).bit_length())
    stats_a = sharded_integrate_a2a(mesh, cfg, cap_a, mapper.region_shift)(arena_a.layers,
                                                                          batch_a)
    if int(stats_a["routing_dropped"].sum()):
        raise AssertionError("a2a dropped routed segments")
    compare_maps(_synced(arena_a), single)
    out["a2a_applied"] = int(stats_a["applied_updates"].sum())

    # The rayflow wire, routed on the devices, every kind.
    rng3 = np.random.default_rng(23)
    rays3 = _scene(rng3, 128, 6.0, 0.05)
    out["rayflow_worst"] = {}
    for kind in ("occupancy", "ndt", "tsdf"):
        m_f = OccupancyMap(resolution=RESOLUTION, flags=MapFlag.NONE)
        fm = ShardedRayFlowMapper(m_f, mesh, kind=kind, capacity=16, validate=True)
        for _ in range(2):
            fm.integrate_rays(rays3)
        fm.sync_voxels()
        out["rayflow_worst"][kind] = compare_maps(m_f, _single(kind, dev, True, [rays3] * 2),
                                                  kind)
        if kind == "occupancy":
            st = fm.stats
            out["rayflow_balance"] = fm.last_balance
            out["rayflow_routed_copies_per_ray"] = st["routed_rays"] / max(st["rays"], 1)
            out["rayflow_wire_bytes_per_ray"] = st["wire_bytes"] / max(st["rays"], 1)
    print(f"dryrun_multichip OK on {out['n_shards']} shards ({', '.join(out['devices'])}): "
          f"replicated and routed ({out['routed_segments']} of "
          f"{out['replicated_segments']} segment copies) bit-identical; resident mapper "
          f"{out['resident_evictions']} evictions, bit-identical; a2a 0 drops, "
          f"bit-identical; rayflow occupancy/ndt/tsdf worst "
          f"{out['rayflow_worst']['occupancy']:.1e}/{out['rayflow_worst']['ndt']:.1e}/"
          f"{out['rayflow_worst']['tsdf']:.1e}, balance {out['rayflow_balance']}, "
          f"{out['rayflow_routed_copies_per_ray']:.3f} routed copies a ray", flush=True)
    return out
