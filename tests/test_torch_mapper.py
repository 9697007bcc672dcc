"""TorchRayMapper on the CPU against TpuRayMapper on the rayflow wire, each
on its own package's host map: the
same ray sequence must leave bit-identical host-map occupancy and equal
stats, through several batches, LRU eviction with host spill, and the
CacheFull split; and the port must match the f64 oracle under bench.py's
gate.  Each scenario runs once per module for both mappers."""

import numpy as np
import pytest

from ohm_tpu.core.layout import OCCUPANCY_LAYER
from ohm_tpu.core.map import MapFlag, OccupancyMap
from ohm_tpu.core.rayflags import RayFlag
from ohm_tpu.mapping.tpu_map import TpuRayMapper
from ohm_tpu.oracle.occupancy import RayMapperOccupancy
from ohm_tpu_torch import TorchRayMapper
from ohm_tpu_torch.core.map import OccupancyMap as PortMap


def _box_rays(n, rng, half=(4.0, 4.0, 2.0)):
    """bench.py's box scene, smaller: a sensor at the centre of a room."""
    dirs = rng.normal(size=(n, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    t = np.min(np.asarray(half) / np.abs(dirs), axis=1)
    rays = np.zeros((2 * n, 3))
    rays[1::2] = dirs * t[:, None]
    return rays


CENTRES = ((0.0, 0.0, 0.0), (20.0, 0.0, 0.0), (0.0, 20.0, 0.0))


def _cluster_rays(n, rng, centre, radius=2.5):
    """Rays from a centre to points around it: about 8 regions each."""
    rays = np.empty((2 * n, 3))
    rays[0::2] = centre
    rays[1::2] = np.asarray(centre) + rng.uniform(-radius, radius, (n, 3))
    return rays


DENORMALS = np.array([1e-40, -1e-40, 2.0**-149, -2.0**-149])


def _denormal_rays(rng):
    """Rays whose host f32 direction holds denormal components (+-1e-40,
    +-2^-149), which the reference reads as zero: 24 along +-x from the
    plane y = 0 (a wall), each in its own z lane (a few with a small normal
    z slope), with a denormal y component; and 12 outwards along x, y or z
    from the line where the other two coordinates are 0, with denormals on
    both.  No voxel takes a hit and a miss in one batch (the jitted
    reference sweep contracts those into an FMA, tests/test_torch_deposit.py)."""
    start, end = np.zeros((36, 3)), np.zeros((36, 3))
    for k in range(24):
        out = 1.0 if k % 2 == 0 else -1.0
        length = rng.uniform(1.0, 2.5)
        lane = (0.15 + 0.1 * (k // 4)) * (1.0 if k % 4 < 2 else -1.0)
        start[k] = (out * rng.uniform(0.5, 1.0), 0.0, lane)
        end[k] = start[k] + (out * length, DENORMALS[k % 4] * length,
                             0.01 * length if k % 3 == 0 else 0.0)
    for k in range(12):
        axis, out = k % 3, 1.0 if k % 6 < 3 else -1.0
        length = rng.uniform(1.0, 1.5)
        start[24 + k, axis] = out * rng.uniform(0.3, 0.5)
        end[24 + k] = start[24 + k]
        end[24 + k, axis] += out * length
        others = [a for a in range(3) if a != axis]
        end[24 + k, others] = DENORMALS[[k % 4, (k + 1) % 4]] * length
    rays = np.empty((72, 3))
    rays[0::2], rays[1::2] = start, end
    return rays


def _scenarios():
    rng = np.random.default_rng(29)
    return {
        # Several batches, flags that the wire and the deposit both read.
        "batches": dict(capacity=64, flags=(0, int(RayFlag.EXCLUDE_ORIGIN), 0),
                        batches=[_box_rays(160, rng) for _ in range(3)]),
        # Three disjoint clusters in turn through a 12-slot arena: every
        # batch evicts the regions of an earlier one to the host map and
        # brings them back later.
        "eviction": dict(capacity=12, flags=(0,) * 6,
                         batches=[_cluster_rays(48, rng, CENTRES[i % 3]) for i in range(6)]),
        # One batch over all three clusters needs more regions than the
        # arena holds: CacheFull, then split halves.
        "cache_full": dict(capacity=12, flags=(0, 0),
                           batches=[_cluster_rays(48, rng, CENTRES[0]),
                                    np.concatenate([_cluster_rays(32, rng, c)
                                                    for c in CENTRES])]),
        # Rays with denormal direction components after a box scan.
        "denormal": dict(capacity=64, flags=(0, 0, int(RayFlag.EXCLUDE_ORIGIN)),
                         batches=[_box_rays(160, rng), _denormal_rays(rng),
                                  _denormal_rays(rng)]),
    }


def _run(mapper_cls, map_cls, spec, **kw):
    m = map_cls(resolution=0.1, flags=int(MapFlag.NONE))
    mapper = mapper_cls(m, capacity=spec["capacity"], validate=True, **kw)
    mapper.prime_caps(spec["batches"])
    for rays, flags in zip(spec["batches"], spec["flags"]):
        mapper.integrate_rays(rays, ray_update_flags=flags)
    mapper.sync_voxels()
    oi = m.layer_index(OCCUPANCY_LAYER)
    occ = {k: c.layers[oi][OCCUPANCY_LAYER].copy() for k, c in m.chunks.items()}
    return occ, mapper.stats, dict(mapper.arena.stats)


@pytest.fixture(scope="module")
def runs():
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        # The reference's split-phase apply; its fused apply is bit-identical
        # by design and would only add a compile.
        mp.setenv("OHM_FUSED", "0")
        for name, spec in _scenarios().items():
            out[name] = {
                "spec": spec,
                "ref": _run(TpuRayMapper, OccupancyMap, spec, rayflow=True, scatter_cap=0),
                "port": _run(TorchRayMapper, PortMap, spec, device="cpu", rayflow=True),
            }
    return out


SCENARIOS = ("batches", "eviction", "cache_full", "denormal")


@pytest.mark.parametrize("name", SCENARIOS)
def test_host_map_bit_identical(runs, name):
    ref, port = runs[name]["ref"][0], runs[name]["port"][0]
    assert ref.keys() == port.keys()
    for key in ref:
        a, b = ref[key].view(np.uint32), port[key].view(np.uint32)
        assert np.array_equal(a, b), (key, np.flatnonzero(a != b)[:10])
    assert sum(int(np.isfinite(v).sum()) for v in port.values()) > 1000


@pytest.mark.parametrize("name", SCENARIOS)
def test_stats_equal(runs, name):
    ref_stats, port_stats = runs[name]["ref"][1], runs[name]["port"][1]
    assert ref_stats == port_stats
    for k in ("missed_updates", "overflow", "dropped_updates", "compaction_dropped"):
        assert port_stats[k] == 0, k
    assert runs[name]["ref"][2] == runs[name]["port"][2]  # arena hits/misses/evictions


def test_eviction_spilled_and_reloaded(runs):
    assert runs["eviction"]["port"][2]["evictions"] >= 8


def test_cache_full_split_the_batch(runs):
    spec = runs["cache_full"]["spec"]
    assert runs["cache_full"]["port"][1]["batches"] > len(spec["batches"])
    assert runs["cache_full"]["port"][1]["rays"] == sum(len(b) // 2 for b in spec["batches"])


def test_matches_oracle_under_bench_gate(runs):
    """bench.py's hardware_check gate (tol 1e-4, mismatch ratio <= 1e-4,
    worst <= 2e-3) against the sequential f64 oracle."""
    spec = runs["batches"]["spec"]
    m = OccupancyMap(resolution=0.1, flags=MapFlag.NONE)
    oracle = RayMapperOccupancy(m)
    for rays, flags in zip(spec["batches"], spec["flags"]):
        oracle.integrate_rays(rays, ray_update_flags=flags)
    oi = m.layer_index(OCCUPANCY_LAYER)
    ref = {k: c.layers[oi][OCCUPANCY_LAYER] for k, c in m.chunks.items()}
    port = runs["batches"]["port"][0]
    full = np.full(int(np.prod(m.region_voxel_dims)), np.inf, np.float32)
    worst, failures, compared = 0.0, 0, 0
    for key in set(ref) | set(port):
        a, b = ref.get(key, full), port.get(key, full)
        inf_a, inf_b = np.isinf(a), np.isinf(b)
        compared += int((~inf_a | ~inf_b).sum())
        failures += int((inf_a != inf_b).sum())
        both = ~inf_a & ~inf_b
        if both.any():
            diff = np.abs(a[both] - b[both])
            worst = max(worst, float(diff.max()))
            failures += int((diff > 1e-4).sum())
    assert compared > 1000
    assert failures <= 1e-4 * compared, (failures, compared)
    assert worst <= 2e-3
