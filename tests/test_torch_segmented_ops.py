"""The segmented wire's device half in the PyTorch port against the JAX
package, op by op: the ordered walk (ops.ddawalk.walk_rays: the z, y, x
plane order, the axis id in the low bits of the time key, the total_cap
cut and its truncated count, the sentinel test in the key domain) on
ohm_tpu_torch.testing.edge_rays' rays and on exact-corner rays, bit for
bit; and the expand phase (the walk front end with the corner-slot resolve,
the end records and group compaction) on segmented batches that the two
packages' mappers prepare alike, under the rank walk and the ordered walk,
with and without traversal: the whole key stream and every stat bit for
bit, the traversal payload within tests/test_expand_pallas.py's bounds
(XLA's CPU backend contracts the jitted walk's times into FMAs: per
record where a key is alone, and per key summed, rtol 2e-6 / atol 1e-6)."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ohm_tpu.core.map import MapFlag, OccupancyMap
from ohm_tpu.core.rayflags import RayFlag
from ohm_tpu.mapping import batch as ref_batch
from ohm_tpu.mapping.tpu_map import TpuRayMapper
from ohm_tpu.ops import ddawalk as ref_ddawalk
from ohm_tpu.ops.integrate import expand_records_jit
from ohm_tpu_torch import TorchRayMapper
from ohm_tpu_torch.core.map import OccupancyMap as PortMap
from ohm_tpu_torch.ops import ddawalk
from ohm_tpu_torch.ops.config import IntegrateConfig
from ohm_tpu_torch.ops.integrate import expand_records
from ohm_tpu_torch.ops.wire import decode, unpack_batch
from ohm_tpu_torch.testing import edge_rays

STATS = ("missed_updates", "overflow", "compaction_dropped")


def _scene(n=192, seed=7, spread=5.0):
    """Random rays, 8 exact-corner diagonals from the origin (a tie at every
    step) and 4 axis-aligned rays (tests/test_expand_pallas.py's scene)."""
    rng = np.random.default_rng(seed)
    dirs = rng.normal(size=(n, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    lengths = rng.uniform(0.25, spread, n)
    origins = rng.uniform(-0.8, 0.8, (n, 3))
    dirs[:8] = np.array([1.0, 1.0, 1.0]) / np.sqrt(3.0)
    origins[:8] = 0.0
    dirs[8:12] = np.eye(3)[[0, 1, 2, 0]]
    rays = np.zeros((2 * n, 3))
    rays[0::2] = origins
    rays[1::2] = origins + dirs * lengths[:, None]
    return rays


@pytest.fixture(scope="module")
def edge_batch():
    """A decoded rayflow batch whose first 48 rays reach the walk's edge
    cases (testing.edge_rays), as numpy arrays, with its config."""
    rays = _scene()
    mapper = TorchRayMapper(PortMap(resolution=0.1, flags=MapFlag.NONE), capacity=64,
                            device="cpu", rayflow=True)
    mapper.prime_caps([rays])
    wire, cfg, _ = mapper._rayflow_setup_host(rays, None, None, 0)
    b = unpack_batch(torch.from_numpy(wire), cfg)
    edge_rays(b, cfg)
    names = ("start_abs", "end_abs", "start_frac", "direction", "length")
    return {k: b[k].numpy().copy() for k in names}, cfg


@pytest.mark.parametrize("cap", ["default", "walk_cap", "cut"])
def test_walk_rays_bit_identical(edge_batch, cap):
    """Every output of the ordered walk against the reference's, bit for bit;
    "cut" caps the record axis below the longest ray's crossings, so the
    truncated count is positive."""
    arrays, cfg = edge_batch
    total_cap = {"default": None, "walk_cap": cfg.walk_cap, "cut": 9}[cap]
    args = [arrays[k] for k in ("start_abs", "end_abs", "start_frac", "direction", "length")]
    ref = ref_ddawalk.walk_rays(*[jnp.asarray(a) for a in args], cfg.resolution,
                                cfg.max_steps, total_cap=total_cap)
    port = ddawalk.walk_rays(*[torch.from_numpy(a) for a in args], cfg.resolution,
                             cfg.max_steps, total_cap=total_cap)
    assert set(ref) == set(port)
    for name, val in ref.items():
        a, b = np.asarray(val), port[name].numpy()
        if a.dtype == np.float32:
            a, b = a.view(np.uint32), b.view(np.uint32)
        assert a.shape == b.shape, name
        assert np.array_equal(a, b.astype(a.dtype)), (name, np.argwhere(a != b)[:5])
    W = port["valid"].shape[1]
    assert W == {"default": ddawalk.walk_total_cap(cfg.max_steps),
                 "walk_cap": min(cfg.walk_cap, 3 * cfg.max_steps), "cut": 9}[cap]
    n_real = np.minimum(np.abs(arrays["end_abs"] - arrays["start_abs"]), cfg.max_steps).sum(1)
    assert int(port["truncated"]) == int(np.maximum(n_real - W, 0).sum())
    if cap == "cut":
        assert int(port["truncated"]) > 1000
    assert port["overflow"].numpy()[40:48].all()  # edge_rays: more than S crossings
    # The corner diagonals tie on every step: higher axes first.
    axes = np.diff(port["voxels"].numpy()[:8], axis=1).nonzero()[2].reshape(8, -1)[:, :3]
    assert (axes == [2, 1, 0]).all()


def _segmented_pair(rays, flags, map_flags=MapFlag.NONE, dims=16):
    """One segmented batch prepared by each package's mapper on its own host
    map; returns ((ref wire, ref cfg), (port upload, port cfg))."""
    ref = TpuRayMapper(OccupancyMap(resolution=0.1, region_voxel_dims=dims, flags=map_flags),
                       capacity=128, rayflow=False)
    prepared = ref_batch.prepare_ray_batch(ref.map, rays, ray_update_flags=flags,
                                           segment_length=ref.segment_length)
    ref.arena.ensure_regions(prepared.region_keys, host_map=ref.map)
    ref_batch.fill_corner_slots(prepared, ref.arena.table)
    stop = flags & RayFlag.STOP_ON_FIRST_OCCUPIED
    ref_cfg = ref._config(flags, group_cap=0 if stop else ref._group_cap(prepared))
    wire = ref_batch.build_wire(prepared, dims, with_mean=ref.with_mean, with_tsdf=False,
                                with_touch=ref.with_touch)
    port = TorchRayMapper(PortMap(resolution=0.1, region_voxel_dims=dims, flags=map_flags),
                          capacity=128, rayflow=False, device="cpu")
    upload, cfg, _, n_seg = port._segmented_setup_host(rays, None, None, flags)
    assert n_seg == prepared.n_segments
    assert np.array_equal(upload["wire"], wire)
    names = [f.name for f in dataclasses.fields(IntegrateConfig)]
    assert {k: getattr(ref_cfg, k) for k in names} == dataclasses.asdict(cfg)
    return (wire, ref_cfg), (upload, cfg)


CASES = [(0, "rank"), (int(RayFlag.EXCLUDE_ORIGIN), "rank"), (int(RayFlag.EXCLUDE_SAMPLE), "rank"),
         (0, "ordered"), (int(RayFlag.EXCLUDE_ORIGIN), "ordered"),
         (int(RayFlag.EXCLUDE_RAY), "ordered")]


@pytest.mark.parametrize("flags,walk", CASES)
@pytest.mark.parametrize("traversal", [False, True])
def test_segmented_expand_records_bit_identical(flags, walk, traversal):
    """expand_records on the segmented wire: the rank walk under the host's
    group cap, or the ordered walk without compaction (group_cap 0, as a
    batch whose cap would not cut the stream takes it)."""
    map_flags = MapFlag.TRAVERSAL if traversal else MapFlag.NONE
    (wire, ref_cfg), (upload, cfg) = _segmented_pair(_scene(seed=9), flags, map_flags)
    if walk == "ordered":
        ref_cfg = dataclasses.replace(ref_cfg, group_cap=0, unordered_walk=False)
        cfg = dataclasses.replace(cfg, group_cap=0, unordered_walk=False)
    assert ref_cfg.unordered_walk == (walk == "rank")
    ref_out, ref_stats = expand_records_jit({"wire": jnp.asarray(wire)}, ref_cfg)
    b = decode({k: torch.from_numpy(v) for k, v in upload.items()}, cfg)
    out, stats = expand_records(b, cfg)
    for name in ("key", "end_flat", "end_is_hit"):
        a, p = np.asarray(ref_out[name]), out[name].numpy()
        assert np.array_equal(a, p), (name, np.flatnonzero(a != p)[:10])
    if traversal:
        keys, a, p = np.asarray(ref_out["key"]), np.asarray(ref_out["trav"]), out["trav"].numpy()
        _, first_idx, counts = np.unique(keys, return_index=True, return_counts=True)
        solo = first_idx[counts == 1]
        np.testing.assert_allclose(p[solo], a[solo], rtol=2e-6, atol=1e-6)
        order = np.argsort(keys, kind="stable")
        bounds = np.flatnonzero(np.concatenate([[True], keys[order][1:] != keys[order][:-1]]))
        np.testing.assert_allclose(np.add.reduceat(p[order].astype(np.float64), bounds),
                                   np.add.reduceat(a[order].astype(np.float64), bounds),
                                   rtol=2e-6, atol=1e-6)
        assert np.all(p[(keys >> 1) == cfg.sentinel] == 0)
    for k in STATS:
        assert int(ref_stats[k]) == int(stats[k]), k
    live = (out["key"] >> 1) < cfg.sentinel
    assert int(live.sum()) > (0 if flags & RayFlag.EXCLUDE_RAY else 3000)
