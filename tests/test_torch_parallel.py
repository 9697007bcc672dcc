"""ohm_tpu_torch.parallel on the CPU (the kernels' plain versions) against the
port's single-device mappers, one case for each of tests/test_sharded.py's
and tests/test_sharded_rayflow.py's: replicated and routed steps, the
routed applied count, the resident mapper over several batches, eviction
with spill and reload, NDT (covariance included), TSDF, on-device a2a
routing, and ShardedRayFlowMapper for each kind and under eviction.

Occupancy must be bit-identical to TorchRayMapper on the same wire (the
counts are integers, complete on the owner shard), the arena's -0.0
unobserved bit included after a spill; NDT and TSDF floats within 1e-5 (the
JAX tests' tolerance: a shard sums a voxel's records in another grouping);
no routed ray dropped; routing ships fewer copies than replication.  Also
ShardMesh.all_to_all on a shared device and on distinct ones, the
applied + missed = active invariant of one single-device batch, and
dryrun_multichip(4, device="cpu")."""

import numpy as np
import pytest
import torch

from ohm_tpu_torch import TorchNdtMap, TorchRayMapper, TorchTsdfMap
from ohm_tpu_torch.core.map import MapFlag, OccupancyMap
from ohm_tpu_torch.core.rayflags import RayFlag
from ohm_tpu_torch.mapping.batch import prepare_ray_batch
from ohm_tpu_torch.ops.ddawalk import walk_rays, walk_rays_unordered
from ohm_tpu_torch.ops.integrate import (expand_records, integrate_decoded, integrate_occupancy)
from ohm_tpu_torch.ops.wire import decode, unpack_batch
from ohm_tpu_torch.parallel import (ResidentShardedArena, ShardedArena, ShardedRayFlowMapper,
                                    ShardedRayMapper, ShardMesh, check_routed_coverage,
                                    check_sharded_coverage, dryrun_multichip, make_routed_batch,
                                    make_sharded_batch, make_source_batch, region_owner,
                                    sharded_integrate, sharded_integrate_a2a,
                                    sharded_integrate_routed)

N_DEV = 8
RES = 0.25
#: NDT and TSDF floats against the single-device mappers (the JAX tests').
TOL = 1e-5
#: NDT-OM's miss-record budget: the sharded mapper's (NdtConfig's default,
#: as the reference's sharded mapper builds it); TorchNdtMap keeps its
#: default for the first four batches, and these runs take two.
MISS_K = 1 << 16


@pytest.fixture(scope="module")
def mesh():
    return ShardMesh.repeat("cpu", N_DEV)


def _scene(n_rays=256, seed=3):
    rng = np.random.default_rng(seed)
    rays = rng.uniform(-6, 6, (2 * n_rays, 3))
    rays[0::2] *= 0.05
    return rays


def _single(batches, kind="occupancy", rayflow=False):
    """The single-device mapper over ``batches``: (its map, the mapper)."""
    m = OccupancyMap(resolution=RES, flags=MapFlag.NONE)
    if kind == "ndt":
        mapper = TorchNdtMap(m, capacity=512, miss_k=MISS_K, device="cpu", rayflow=rayflow)
    elif kind == "tsdf":
        mapper = TorchTsdfMap(m, capacity=512, device="cpu", rayflow=rayflow)
    else:
        mapper = TorchRayMapper(m, capacity=512, device="cpu", rayflow=rayflow)
    for rays in batches:
        mapper.integrate_rays(rays)
    mapper.sync_voxels()
    return m, mapper


def _occ_bits(m):
    li = m.layer_index("occupancy")
    return {key: chunk.layers[li]["occupancy"].view(np.uint32).copy()
            for key, chunk in m.chunks.items()}


def _assert_occupancy_bits_equal(a, b):
    va, vb = _occ_bits(a), _occ_bits(b)
    assert va.keys() == vb.keys() and va
    for key in va:
        assert np.array_equal(va[key], vb[key]), key


def _members(m, layer, member):
    li = m.layer_index(layer)
    vals = {}
    for key, chunk in m.chunks.items():
        a = chunk.layers[li][member]
        for i in np.flatnonzero(np.isfinite(a) & (a != 0)):
            vals[(key, int(i))] = float(a[i])
    return vals


def _assert_members_close(a, b, layer, member):
    va, vb = _members(a, layer, member), _members(b, layer, member)
    assert set(va) == set(vb) and va, (layer, member)
    worst = max(abs(va[k] - vb[k]) for k in vb)
    assert worst < TOL, (layer, member, worst)


def _synced(arena):
    m = OccupancyMap(resolution=RES, flags=MapFlag.NONE)
    arena.sync_to_host(m)
    return m


def _prepared(rays, capacity):
    m = OccupancyMap(resolution=RES, flags=MapFlag.NONE)
    mapper = TorchRayMapper(m, capacity=capacity, device="cpu", rayflow=False)
    return mapper, prepare_ray_batch(m, rays, segment_length=mapper.segment_length)


def test_replicated_matches_single_device(mesh):
    rays = _scene()
    mapper, prepared = _prepared(rays, 16)
    arena = ShardedArena(N_DEV, capacity=16, region_shift=mapper.region_shift,
                         layer_names=["occupancy"], mesh=mesh)
    arena.ensure_regions(prepared.region_keys)
    stats = sharded_integrate(mesh, mapper._config(0))(
        arena.device_state(), make_sharded_batch(prepared, arena, mesh))
    check_sharded_coverage(stats)
    assert stats["applied_updates"].shape == (N_DEV,)
    _assert_occupancy_bits_equal(_synced(arena), _single([rays])[0])


def test_routed_matches_single_device_with_fewer_segments(mesh):
    rays = _scene(n_rays=512, seed=11)
    mapper, prepared = _prepared(rays, 32)
    arena = ShardedArena(N_DEV, capacity=32, region_shift=mapper.region_shift,
                         layer_names=["occupancy"], mesh=mesh)
    arena.ensure_regions(prepared.region_keys)
    batches, counts = make_routed_batch(prepared, arena, mesh)
    sharded_integrate_routed(mesh, mapper._config(0))(arena.device_state(), batches)
    # Routing invariant: duplication well below full replication.
    assert counts.sum() < N_DEV * prepared.n_segments * 0.6
    assert counts.max() <= batches[0]["ints"].shape[0]
    _assert_occupancy_bits_equal(_synced(arena), _single([rays])[0])


def test_routed_applied_equals_single_device_applied(mesh):
    """Every record applies on exactly one shard: the per-shard applied
    counts sum to the single-device batch's."""
    rays = _scene(n_rays=128, seed=5)
    ref = TorchRayMapper(OccupancyMap(resolution=RES, flags=MapFlag.NONE), capacity=64,
                         device="cpu", rayflow=False)
    upload, cfg, _, _ = ref._segmented_setup_host(rays, None, None, 0)
    b = decode({k: torch.from_numpy(v) for k, v in upload.items()}, cfg)
    expected = int(integrate_decoded(ref.arena.layers, b, cfg)["applied_updates"])

    mapper, prepared = _prepared(rays, 16)
    arena = ShardedArena(N_DEV, capacity=16, region_shift=mapper.region_shift,
                         layer_names=["occupancy"], mesh=mesh)
    arena.ensure_regions(prepared.region_keys)
    batches, _ = make_routed_batch(prepared, arena, mesh)
    stats = sharded_integrate_routed(mesh, mapper._config(0))(arena.device_state(), batches)
    assert expected > 0
    check_routed_coverage(stats, expected)


def test_resident_mapper_multibatch_matches_single_device(mesh):
    rng = np.random.default_rng(11)
    batches = []
    for _ in range(6):
        rays = rng.uniform(-6, 6, (2 * 128, 3))
        rays[0::2] *= 0.05
        batches.append(rays)
    m_sh = OccupancyMap(resolution=RES, flags=MapFlag.NONE)
    sh = ShardedRayMapper(m_sh, mesh, capacity=64, validate=True)
    for rays in batches:
        sh.integrate_rays(rays)
    sh.sync_voxels()
    _assert_occupancy_bits_equal(m_sh, _single(batches)[0])
    st = sh.stats
    assert st["routed_records"] < N_DEV * st["segments"]


def _colliding_clusters(rng, n):
    """Single-region clusters whose regions the ownership hash gives to one
    shard, alternated: at capacity 1 that shard evicts, spills and reloads
    every batch."""
    cand = np.array([[i, 0, 0] for i in range(48)])
    owners = region_owner(cand, N_DEV)
    shard = next(s for s in range(N_DEV) if (owners == s).sum() >= 2)
    r_a, r_b = cand[owners == shard][:2]

    def cluster(region):
        rays = rng.uniform(-1.5, 1.5, (2 * n, 3))
        rays[0::2] *= 0.05
        return rays + np.asarray(region, dtype=float) * 8.0  # region edge 8 m

    return [cluster(r_a), cluster(r_b), cluster(r_a), cluster(r_b), cluster(r_a)]


@pytest.mark.parametrize("cls", [ShardedRayMapper, ShardedRayFlowMapper],
                         ids=["segmented", "rayflow"])
def test_eviction_spill_and_reload_keeps_every_bit(mesh, cls):
    """Capacity 1 a shard: regions spill to the host map on eviction and
    reload when revisited.  The map matches the single-device mapper bit for
    bit, and so does every resident region's arena block, the -0.0 of its
    unobserved voxels included."""
    batches = _colliding_clusters(np.random.default_rng(13), 64 if cls is ShardedRayMapper
                                  else 96)
    m_sh = OccupancyMap(resolution=RES, flags=MapFlag.NONE)
    sh = cls(m_sh, mesh, capacity=1, validate=True)
    rayflow = cls is ShardedRayFlowMapper
    m_ref = OccupancyMap(resolution=RES, flags=MapFlag.NONE)
    ref = TorchRayMapper(m_ref, capacity=512, device="cpu", rayflow=rayflow)
    for rays in batches:
        sh.integrate_rays(rays)
        ref.integrate_rays(rays)
    assert sh.arena.stats["evictions"] >= len(batches) - 1
    V = sh.arena.voxels_per_region
    unobserved = 0
    for shard in sh.arena.shards:
        occ = shard.layers["occupancy"].view(torch.int32)
        for key, slot in shard.slot_of.items():
            ref_slot = ref.arena.slot_of[key]
            block = occ[slot * V:(slot + 1) * V]
            ref_block = ref.arena.occupancy.view(torch.int32)[ref_slot * V:(ref_slot + 1) * V]
            assert torch.equal(block, ref_block), key
            unobserved += int((block == -2**31).sum())  # the bits of -0.0
    assert unobserved > 0
    sh.sync_voxels()
    ref.sync_voxels()
    _assert_occupancy_bits_equal(m_sh, m_ref)


@pytest.mark.parametrize("cls", [ShardedRayMapper, ShardedRayFlowMapper],
                         ids=["segmented", "rayflow"])
def test_ndt_matches_single_device(mesh, cls):
    rays = _scene(96, seed=17 if cls is ShardedRayMapper else 37)
    m_sh = OccupancyMap(resolution=RES, flags=MapFlag.NONE)
    sh = cls(m_sh, mesh, kind="ndt", capacity=64, validate=True)
    for _ in range(2):
        sh.integrate_rays(rays)
    sh.sync_voxels()
    m_ref, _ = _single([rays] * 2, "ndt", rayflow=cls is ShardedRayFlowMapper)
    _assert_members_close(m_sh, m_ref, "occupancy", "occupancy")
    for member in ("P00", "P11", "P22", "P01"):
        _assert_members_close(m_sh, m_ref, "covariance", member)
    if cls is ShardedRayFlowMapper:
        assert sh.stats["routing_dropped"] == 0


@pytest.mark.parametrize("cls", [ShardedRayMapper, ShardedRayFlowMapper],
                         ids=["segmented", "rayflow"])
def test_tsdf_matches_single_device(mesh, cls):
    rays = _scene(96, seed=19 if cls is ShardedRayMapper else 41)
    m_sh = OccupancyMap(resolution=RES, flags=MapFlag.NONE)
    sh = cls(m_sh, mesh, kind="tsdf", capacity=64, validate=True)
    sh.integrate_rays(rays)
    sh.sync_voxels()
    m_ref, _ = _single([rays], "tsdf", rayflow=cls is ShardedRayFlowMapper)
    for member in ("weight", "distance"):
        _assert_members_close(m_sh, m_ref, "tsdf", member)


def test_a2a_routing_matches_single_device(mesh):
    """Source-sharded batch, on-device corner ownership, all_to_all,
    destination-side foreign-corner masking: bit-identical to the
    single-device mapper with no routing drop (host-sized capacity)."""
    rays = _scene(192, seed=23)
    mapper, prepared = _prepared(rays, 16)
    arena = ResidentShardedArena(mesh, capacity=16, region_shift=mapper.region_shift,
                                 layer_names=["occupancy"])
    arena.ensure_regions(prepared.region_keys)
    batches, max_pairs = make_source_batch(prepared, arena, mesh)
    cap = max(64, 1 << (max_pairs - 1).bit_length())
    step = sharded_integrate_a2a(mesh, mapper._config(0), capacity=cap,
                                 region_dim_shift=mapper.region_shift)
    stats = step(arena.layers, batches)
    assert int(stats["routing_dropped"].sum()) == 0
    assert int(stats["applied_updates"].sum()) > 0
    _assert_occupancy_bits_equal(_synced(arena), _single([rays])[0])


def test_rayflow_occupancy_bit_identical(mesh):
    rng = np.random.default_rng(29)
    batches = []
    for _ in range(4):
        rays = rng.uniform(-6, 6, (2 * 192, 3))
        rays[0::2] *= 0.05
        batches.append(rays)
    m_sh = OccupancyMap(resolution=RES, flags=MapFlag.NONE)
    sh = ShardedRayFlowMapper(m_sh, mesh, capacity=64, validate=True)
    for rays in batches:
        sh.integrate_rays(rays)
    sh.sync_voxels()
    _assert_occupancy_bits_equal(m_sh, _single(batches, rayflow=True)[0])
    st = sh.stats
    assert st["routing_dropped"] == 0 and st["compaction_dropped"] == 0
    assert st["rays"] <= st["routed_rays"] < N_DEV * st["rays"]
    assert len(sh.last_balance) == N_DEV and sum(sh.last_balance) > 0


def test_rayflow_mapper_refuses_what_the_reference_refuses(mesh):
    m = OccupancyMap(resolution=RES, flags=MapFlag.NONE)
    sh = ShardedRayFlowMapper(m, mesh, capacity=64)
    far = np.array([[0.0, 0.0, 0.0], [600.0, 0.0, 0.0]] * 16)  # a ray over 32 regions
    with pytest.raises(ValueError, match="envelope"):
        sh.integrate_rays(far)
    rays = _scene(256 * N_DEV + 4, seed=2)  # sources of 257 and 256 rays
    with pytest.raises(ValueError, match="uneven"):
        sh.integrate_rays(rays)


@pytest.mark.parametrize("devices", [["cpu"] * 3, ["cpu", "cpu:0", "cpu"]],
                         ids=["one_device", "per_device_copies"])
def test_all_to_all_swaps_blocks(devices):
    mesh = ShardMesh(devices)
    send = [torch.arange(3 * 2 * 5, dtype=torch.int32).reshape(3, 2, 5) + 100 * s
            for s in range(3)]
    recv = mesh.all_to_all(send)
    for d in range(3):
        assert recv[d].shape == (3, 2, 5) and recv[d].device.type == mesh.devices[d].type
        for s in range(3):
            assert torch.equal(recv[d][s], send[s][d])


@pytest.mark.parametrize("path", ["split", "monolith"])
def test_applied_plus_missed_is_every_active_record(path):
    """One single-device batch, some of whose records miss (candidates
    dropped on the rayflow wire; corner slots dropped on the segmented one,
    under STOP_ON_FIRST_OCCUPIED's monolith): applied_updates +
    missed_updates = the active walk and end records."""
    rng = np.random.default_rng(7)
    rays = np.zeros((2 * 256, 3))
    rays[1::2] = rng.uniform(-5, 5, (256, 3))
    m = OccupancyMap(resolution=0.1, flags=MapFlag.NONE)
    mapper = TorchRayMapper(m, capacity=256, device="cpu", rayflow=True)
    if path == "split":
        wire, cfg, _ = mapper._rayflow_setup_host(rays, None, None, 0)
        b = unpack_batch(torch.from_numpy(wire), cfg)
        b["tcand"][::3] = 0  # every third ray resolves nothing
        walk = walk_rays_unordered(b["start_abs"], b["end_abs"], b["start_frac"],
                                   b["direction"], b["length"], cfg.resolution, cfg.max_steps)
        _, stats = expand_records(b, cfg)
    else:
        upload, cfg, _, _ = mapper._segmented_setup_host(rays, None, None, 0)
        cfg = type(cfg)(**{**cfg.__dict__, "ray_flags": int(RayFlag.STOP_ON_FIRST_OCCUPIED),
                           "group_cap": 0, "unordered_walk": False})
        upload = {k: torch.from_numpy(v) for k, v in upload.items()}
        b = decode(upload, cfg)
        b["corner_slots"] = b["corner_slots"].clone()
        b["corner_slots"][::3] = -1
        walk = walk_rays(b["start_abs"], b["end_abs"], b["start_frac"], b["direction"],
                         b["length"], cfg.resolution, cfg.max_steps)
        stats = integrate_occupancy(mapper.arena.layers, b, cfg)
    valid = b["valid"]
    active = int((walk["valid"] & valid[:, None]).sum()
                 + ((b["is_sample"] | b["end_as_miss"]) & valid).sum())
    applied, missed = int(stats["applied_updates"]), int(stats["missed_updates"])
    assert applied > 0 and missed > 0
    assert applied + missed == active


def test_dryrun_multichip_on_cpu(capsys):
    out = dryrun_multichip(4, device="cpu")
    assert out["n_shards"] == 4 and out["resident_evictions"] > 0
    assert out["routed_segments"] < out["replicated_segments"]
    assert max(out["rayflow_worst"].values()) <= TOL
    assert "dryrun_multichip OK on 4 shards" in capsys.readouterr().out
