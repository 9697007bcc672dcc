"""ohm_tpu_torch.parallel against the JAX package's ohm_tpu.parallel, on the
CPU: the JAX mappers on 4 of the conftest's 8 virtual CPU devices, the port
on ShardMesh.repeat("cpu", 4), the same rays (tests/test_sharded.py's
_scene(96) at 0.25 m).

  ShardedRayMapper       per-shard slot directories (slots, free lists, LRU
                         stamps) and arena stats equal; per-shard occupancy
                         bits equal (the reference's rows read through its
                         addressable shards, so -0.0 survives)
  ShardedRayFlowMapper   the same, and the routed ray copies
  a2a                    one reference step carried across by
                         mapping.arena.sharded_arena_from_reference, then one
                         a2a step of each package from that state: the same
                         directories, pair counts, per-shard applied counts
                         and occupancy bits
  region_owner_torch     bit-identical to the port's region_owner, the
                         reference's region_owner and region_owner_jnp on
                         negative keys, keys at +-2^31, super_shift 0-3 and
                         1-8 shards

Each JAX step compiles a shard_map program: a few seconds a test on the
CPU."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from ohm_tpu.core.map import MapFlag as RefFlag
from ohm_tpu.core.map import OccupancyMap as RefMap
from ohm_tpu.mapping.batch import prepare_ray_batch as ref_prepare
from ohm_tpu.mapping.tpu_map import TpuRayMapper
from ohm_tpu.parallel.a2a import make_source_batch as ref_source_batch
from ohm_tpu.parallel.a2a import sharded_integrate_a2a as ref_a2a
from ohm_tpu.parallel.mapper import ShardedRayMapper as RefShardedRayMapper
from ohm_tpu.parallel.rayflow import ShardedRayFlowMapper as RefShardedRayFlowMapper
from ohm_tpu.parallel.sharded import region_owner as ref_region_owner
from ohm_tpu.parallel.sharded import region_owner_jnp
from ohm_tpu_torch import TorchRayMapper
from ohm_tpu_torch.core.map import MapFlag, OccupancyMap
from ohm_tpu_torch.mapping.arena import sharded_arena_from_reference
from ohm_tpu_torch.mapping.batch import prepare_ray_batch
from ohm_tpu_torch.parallel import (ShardedRayFlowMapper, ShardedRayMapper, ShardMesh,
                                    make_source_batch, region_owner, region_owner_torch,
                                    sharded_integrate_a2a)

N = 4
RES = 0.25
PAD = 1 << 16  # the reference arenas' scatter tail


@pytest.fixture(scope="module")
def meshes():
    return Mesh(np.array(jax.devices()[:N]), axis_names=("shard",)), ShardMesh.repeat("cpu", N)


def _scene(n_rays=96, seed=3):
    rng = np.random.default_rng(seed)
    rays = rng.uniform(-6, 6, (2 * n_rays, 3))
    rays[0::2] *= 0.05
    return rays


def _ref_rows(ref_arena, n_vox: int) -> list:
    """Each shard's first ``n_vox`` occupancy bits of a reference arena."""
    return [ref_arena._read_shard_slice("occupancy", s, slice(0, n_vox)).view(np.uint32)
            for s in range(N)]


def _jax_rows(arr, n_vox: int) -> list:
    """Each shard's row of a [N, ...] array sharded on its first axis, read
    shard by shard (a cross-shard slice would turn -0.0 into +0.0)."""
    rows = [None] * N
    for shard in arr.addressable_shards:
        rows[shard.index[0].start or 0] = np.asarray(shard.data)[0, :n_vox].view(np.uint32)
    return rows


def _port_rows(arena, n_vox: int) -> list:
    return [a.layers["occupancy"][:n_vox].view(torch.int32).numpy().view(np.uint32)
            for a in arena.shards]


def _assert_same_directories(ref_arena, port_arena):
    assert ref_arena.batch_counter == port_arena.batch_counter
    for d_ref, d_port in zip(ref_arena.shards, port_arena.shards):
        assert d_ref.slot_of == d_port.slot_of
        assert d_ref.region_of == d_port.region_of
        assert d_ref.free_slots == d_port.free_slots
        assert np.array_equal(d_ref.last_used, d_port.last_used)


def _assert_same_bits(ref_rows, port_rows):
    observed = 0
    for r, p in zip(ref_rows, port_rows):
        assert np.array_equal(r, p)
        observed += int((r != 0x80000000).sum())  # voxels not at -0.0
    assert observed > 0


@pytest.mark.parametrize("kind", ["segmented", "rayflow"])
def test_sharded_mappers_match_the_reference(meshes, kind):
    jmesh, pmesh = meshes
    ref_cls, port_cls = ((RefShardedRayMapper, ShardedRayMapper) if kind == "segmented"
                         else (RefShardedRayFlowMapper, ShardedRayFlowMapper))
    ref = ref_cls(RefMap(resolution=RES, flags=RefFlag.NONE), jmesh, capacity=64,
                  scatter_pad=PAD)
    port = port_cls(OccupancyMap(resolution=RES, flags=MapFlag.NONE), pmesh, capacity=64,
                    validate=True)
    for seed in (3, 4):
        rays = _scene(seed=seed)
        ref.integrate_rays(rays)
        port.integrate_rays(rays)
    _assert_same_directories(ref.arena, port.arena)
    assert ref.arena.stats == port.arena.stats
    n_vox = 64 * port.arena.voxels_per_region
    _assert_same_bits(_ref_rows(ref.arena, n_vox), _port_rows(port.arena, n_vox))
    if kind == "rayflow":
        assert ref.stats["routed_rays"] == port.stats["routed_rays"]
        assert port.stats["routing_dropped"] == 0 == ref.stats["routing_dropped"]
    else:
        assert ref.stats["routed_records"] == port.stats["routed_records"]


def test_a2a_step_from_a_carried_state_matches_the_reference(meshes):
    jmesh, pmesh = meshes
    ref = RefShardedRayMapper(RefMap(resolution=RES, flags=RefFlag.NONE), jmesh,
                              capacity=64, scatter_pad=PAD)
    ref.integrate_rays(_scene(seed=3))
    state = {"occupancy": np.stack([ref.arena._read_shard_slice("occupancy", s, slice(None))
                                    for s in range(N)])}
    arena = sharded_arena_from_reference(state, ref.arena.shards, ref.region_shift, pmesh)
    _assert_same_directories(ref.arena, arena)
    n_vox = 64 * arena.voxels_per_region
    _assert_same_bits(_ref_rows(ref.arena, n_vox), _port_rows(arena, n_vox))

    rays = _scene(192, seed=23)
    ref_mapper = TpuRayMapper(RefMap(resolution=RES, flags=RefFlag.NONE), capacity=64)
    prepared_j = ref_prepare(ref_mapper.map, rays, segment_length=ref_mapper.segment_length)
    ref.arena.ensure_regions(prepared_j.region_keys)
    batch_j, pairs_j = ref_source_batch(prepared_j, ref.arena, jmesh)
    port_mapper = TorchRayMapper(OccupancyMap(resolution=RES, flags=MapFlag.NONE),
                                 capacity=64, device="cpu", rayflow=True)
    prepared_p = prepare_ray_batch(port_mapper.map, rays,
                                   segment_length=port_mapper.segment_length)
    arena.ensure_regions(prepared_p.region_keys)
    batch_p, pairs_p = make_source_batch(prepared_p, arena, pmesh)
    _assert_same_directories(ref.arena, arena)
    assert pairs_j == pairs_p
    cap = max(64, 1 << (pairs_p - 1).bit_length())

    cfg_j = dataclasses.replace(ref_mapper._config(0), scatter_pad=PAD)
    state_j, stats_j = ref_a2a(jmesh, cfg_j, capacity=cap, region_dim_shift=ref.region_shift)(
        {"occupancy": ref.arena.state["occupancy"]}, batch_j)
    stats_p = sharded_integrate_a2a(pmesh, port_mapper._config(0), capacity=cap,
                                    region_dim_shift=arena.region_shift)(arena.layers, batch_p)
    assert int(np.asarray(stats_j["routing_dropped"]).sum()) == 0
    assert int(stats_p["routing_dropped"].sum()) == 0
    assert np.array_equal(np.asarray(stats_j["applied_updates"]).reshape(-1),
                          stats_p["applied_updates"].numpy())
    _assert_same_bits(_jax_rows(state_j["occupancy"], n_vox), _port_rows(arena, n_vox))


def _owner_keys():
    rng = np.random.default_rng(0)
    keys = rng.integers(-2**31, 2**31, (4096, 3), dtype=np.int64)
    edges = np.array([0, -1, 1, 2**31 - 1, -2**31, 2**31 - 4, -2**31 + 3, 4095, -4096])
    grid = np.stack(np.meshgrid(edges, edges, edges, indexing="ij"), -1).reshape(-1, 3)
    small = rng.integers(-70, 70, (2048, 3), dtype=np.int64)
    return np.concatenate([keys, grid, small]).astype(np.int32)


@pytest.mark.parametrize("super_shift", [0, 1, 2, 3])
def test_region_owner_torch_is_bit_identical(super_shift):
    keys = _owner_keys()
    for n_shards in range(1, 9):
        want = ref_region_owner(keys, n_shards, super_shift)
        assert np.array_equal(region_owner(keys, n_shards, super_shift), want)
        jnp_owner = np.asarray(region_owner_jnp(jnp.asarray(keys), n_shards, super_shift))
        assert np.array_equal(jnp_owner, want)
        got = region_owner_torch(torch.from_numpy(keys), n_shards, super_shift)
        assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
        # The int64 keys the host routing passes give the same owners.
        got64 = region_owner_torch(torch.from_numpy(keys.astype(np.int64)), n_shards,
                                   super_shift)
        assert np.array_equal(got64.numpy(), want)
