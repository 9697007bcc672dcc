"""The delta path (ops.integrate.apply_delta, routed by TorchRayMapper with
``delta_path=True``) and the cumulative maximum it reads counts with
(ops.segments.cummax), on the CPU: tests/test_delta_path.py's delta,
oracle and auto-sizing cases on the port, each against the port's split
apply and against TpuRayMapper with the same arguments.

The delta path computes n_hit * hit + n_miss * miss with separate ops, so
on the port it equals the split apply bit for bit.  The jitted reference
contracts that sum into an FMA on the CPU (ROADMAP §3, "Not port faults"),
so ``apply_delta`` is held to ``apply_delta_jit`` bit for bit on voxels with
hits or misses only, and to the reference run op by op
(``jax.disable_jit``) on every voxel; the mappers' maps are compared bit
for bit on scenes whose voxels take hits or misses in a batch, and within
one f32 rounding of a mixed voxel's total elsewhere.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ohm_tpu.core.layout import OCCUPANCY_LAYER
from ohm_tpu.core.map import MapFlag, OccupancyMap
from ohm_tpu.core.rayflags import RayFlag
from ohm_tpu.mapping.tpu_map import TpuRayMapper
from ohm_tpu.ops import blocked
from ohm_tpu.ops import integrate as ref_integrate
from ohm_tpu_torch import TorchRayMapper
from ohm_tpu_torch.core.map import OccupancyMap as PortMap
from ohm_tpu_torch.ops import integrate, segments
from ohm_tpu_torch.ops.config import IntegrateConfig
from ohm_tpu_torch.oracle.occupancy import RayMapperOccupancy

from test_tpu_integrate import box_room_rays, compare_occupancy


def occupancy_dict(m):
    i = m.layer_index(OCCUPANCY_LAYER)
    return {key: np.array(c.layers[i][OCCUPANCY_LAYER]) for key, c in m.chunks.items()}


def integrate_port(rays, scatter_cap, repeats=1, setup=None, validate=True, capacity=128):
    """tests/test_delta_path.py's ``integrate`` on the port (its map, its
    mapper on the CPU): the delta path wherever the window is pinned."""
    m = PortMap(resolution=0.25, flags=MapFlag.NONE)
    if setup is not None:
        setup(m)
    mapper = TorchRayMapper(m, capacity=capacity, validate=validate, device="cpu",
                            scatter_cap=scatter_cap,
                            delta_path=scatter_cap not in (0, "auto"), rayflow=True)
    for _ in range(repeats):
        mapper.integrate_rays(rays)
    mapper.sync_voxels()
    return m, mapper


def integrate_ref(rays, scatter_cap, repeats=1, setup=None, validate=True, capacity=128):
    m = OccupancyMap(resolution=0.25, flags=MapFlag.NONE)
    if setup is not None:
        setup(m)
    mapper = TpuRayMapper(m, capacity=capacity, validate=validate, scatter_cap=scatter_cap,
                          delta_path=scatter_cap not in (0, "auto"))
    for _ in range(repeats):
        mapper.integrate_rays(rays)
    mapper.sync_voxels()
    return m, mapper


def assert_same_maps(a, b):
    da, db = occupancy_dict(a), occupancy_dict(b)
    assert set(da) == set(db)
    for key in da:
        np.testing.assert_array_equal(da[key].view(np.uint32), db[key].view(np.uint32))


def assert_within_one_rounding(a, b, hit, miss):
    """Equal bits, or (a voxel both hit and missed in a batch, where the
    reference's sum is one FMA) within one rounding of the total."""
    da, db = occupancy_dict(a), occupancy_dict(b)
    assert set(da) == set(db)
    ulp = float(np.spacing(np.float32(max(abs(hit), abs(miss)) * 64)))
    for key in da:
        assert np.array_equal(np.isinf(da[key]), np.isinf(db[key]))
        fin = np.isfinite(da[key])
        assert np.abs(da[key][fin] - db[key][fin]).max(initial=0.0) <= ulp


@pytest.fixture(scope="module")
def box_room():
    return box_room_rays(256, np.random.default_rng(7))


def test_delta_matches_split_phase_box_room(box_room):
    m_delta, mapper = integrate_port(box_room, scatter_cap=1 << 18)
    m_split, _ = integrate_port(box_room, scatter_cap=0)
    assert mapper.last_route == "delta"
    assert mapper.stats["dropped_updates"] == 0
    assert_same_maps(m_delta, m_split)
    m_ref, ref = integrate_ref(box_room, scatter_cap=1 << 18)
    assert ref.stats["dropped_updates"] == 0
    assert_within_one_rounding(m_delta, m_ref, m_ref.hit_value, m_ref.miss_value)


def test_delta_matches_oracle():
    rays = box_room_rays(200, np.random.default_rng(11))
    m_delta, _ = integrate_port(rays, scatter_cap=1 << 18)
    cpu = PortMap(resolution=0.25, flags=MapFlag.NONE)
    RayMapperOccupancy(cpu).integrate_rays(rays)
    compare_occupancy(cpu, m_delta)


COLLINEAR = np.array([
    [0.0, 0.1, 0.1], [1.05, 0.1, 0.1],   # sample voxel at x = 1.05
    [0.0, 0.1, 0.1], [2.05, 0.1, 0.1],   # passes through it as a miss
])


def test_delta_hit_and_miss_same_voxel():
    """One voxel takes a hit and a miss in one batch."""
    m_delta, _ = integrate_port(COLLINEAR, scatter_cap=1 << 12)
    m_split, _ = integrate_port(COLLINEAR, scatter_cap=0)
    assert_same_maps(m_delta, m_split)
    v = m_delta.voxel_value(point=[1.05, 0.1, 0.1])
    expect = np.float32(m_delta.hit_value) + np.float32(m_delta.miss_value)
    assert v == pytest.approx(float(expect), abs=1e-6)
    m_ref, _ = integrate_ref(COLLINEAR, scatter_cap=1 << 12)
    assert_within_one_rounding(m_delta, m_ref, m_ref.hit_value, m_ref.miss_value)


def test_delta_zero_net_delta_marks_observed():
    """Symmetric hit and miss values net an exactly 0.0 delta, which must
    mark the voxel observed with value 0 (-0.0 + +0.0 == +0.0)."""
    def setup(m):
        m.hit_value = 0.5
        m.miss_value = -0.5

    m_delta, _ = integrate_port(COLLINEAR, scatter_cap=1 << 12, setup=setup)
    m_split, _ = integrate_port(COLLINEAR, scatter_cap=0, setup=setup)
    assert np.float32(m_delta.hit_value) == -np.float32(m_delta.miss_value)
    v = m_delta.voxel_value(point=[1.05, 0.1, 0.1])
    assert v == 0.0 and not np.isinf(v)
    assert_same_maps(m_delta, m_split)
    m_ref, _ = integrate_ref(COLLINEAR, scatter_cap=1 << 12, setup=setup)
    assert_same_maps(m_delta, m_ref)  # 0.5 and -0.5: every product and sum exact


def test_delta_clamp_engages():
    """Repeated hits pass max_value and repeated misses min_value: the
    whole-arena clamp agrees with the split apply's one-sided clamp."""
    rays = np.array([[0.0, 0.1, 0.1], [3.05, 0.1, 0.1]])
    m_delta, _ = integrate_port(rays, scatter_cap=1 << 12, repeats=12)
    m_split, _ = integrate_port(rays, scatter_cap=0, repeats=12)
    assert_same_maps(m_delta, m_split)
    assert m_delta.voxel_value(point=[3.05, 0.1, 0.1]) == pytest.approx(m_delta.max_voxel_value)
    assert m_delta.voxel_value(point=[1.05, 0.1, 0.1]) == pytest.approx(m_delta.min_voxel_value)
    m_ref, _ = integrate_ref(rays, scatter_cap=1 << 12, repeats=12)
    assert_same_maps(m_delta, m_ref)  # one ray: no voxel both hit and missed


def test_delta_over_cap_surfaces_dropped_updates():
    rays = box_room_rays(128, np.random.default_rng(13))
    _, mapper = integrate_port(rays, scatter_cap=64, validate=False)
    _, ref = integrate_ref(rays, scatter_cap=64, validate=False)
    assert mapper.stats["dropped_updates"] > 0
    assert mapper.stats["dropped_updates"] == ref.stats["dropped_updates"]
    with pytest.raises(RuntimeError, match="scatter_cap"):
        integrate_port(rays, scatter_cap=64, validate=True)


def test_auto_scatter_cap_sizes_from_fourth_batch(box_room):
    """The window sizes from the fourth batch's touched count (the first
    batches run the split apply), as the reference's; once sized, a
    ``delta_path`` mapper routes to the delta path and stays exact."""
    m = PortMap(resolution=0.25, flags=MapFlag.NONE)
    mapper = TorchRayMapper(m, capacity=128, validate=True, device="cpu", delta_path=True,
                            rayflow=True)
    ref = TpuRayMapper(OccupancyMap(resolution=0.25, flags=MapFlag.NONE), capacity=128,
                       delta_path=True)
    m_u = PortMap(resolution=0.25, flags=MapFlag.NONE)
    mp_u = TorchRayMapper(m_u, capacity=128, device="cpu", scatter_cap=0, rayflow=True)
    routes = []
    for i in range(5):
        mapper.integrate_rays(box_room)
        ref.integrate_rays(box_room)
        mp_u.integrate_rays(box_room)
        routes.append(mapper.last_route)
        assert mapper.scatter_cap == ref.scatter_cap
        if i < 3:
            assert mapper.scatter_cap == 0
    assert mapper.scatter_cap > 0
    # The fourth batch also sizes the fused apply's row_cap (OHM_FUSED=1).
    assert routes[:3] == ["split"] * 3 and routes[3] in ("split", "fused")
    assert routes[4] == "delta"
    mapper.sync_voxels()
    mp_u.sync_voxels()
    assert mapper.stats["dropped_updates"] == 0
    assert_same_maps(m, m_u)


def _delta_case(seed, n=6000, n_vox=2048):
    """Sorted-or-not (flat << 1 | hit) keys over a small arena: runs of
    misses, of hits, and mixed voxels, and sentinel records."""
    rng = np.random.default_rng(seed)
    cfg = IntegrateConfig(resolution=0.1, region_shift=3, capacity=n_vox // 512,
                          max_steps=8, hit_value=0.85, miss_value=-0.4,
                          min_value=-2.0, max_value=3.5,
                          saturation_min=float(np.finfo(np.float32).min),
                          saturation_max=float(np.finfo(np.float32).max),
                          scatter_cap=700)
    ids = rng.integers(0, n_vox + 1, n).astype(np.int32)  # n_vox is the sentinel
    hits = (rng.random(n) < 0.3).astype(np.int32)
    keys = (ids << 1) | np.where(ids == n_vox, 0, hits)
    occ = np.where(rng.random(n_vox + 1) < 0.5, np.float32(-0.0),
                   rng.uniform(-1.9, 3.4, n_vox + 1).astype(np.float32)).astype(np.float32)
    occ[n_vox] = -0.0
    return cfg, keys, occ


def _ref_cfg(cfg):
    return ref_integrate.IntegrateConfig(
        resolution=cfg.resolution, region_shift=cfg.region_shift, capacity=cfg.capacity,
        max_steps=cfg.max_steps, hit_value=cfg.hit_value, miss_value=cfg.miss_value,
        min_value=cfg.min_value, max_value=cfg.max_value,
        saturation_min=cfg.saturation_min, saturation_max=cfg.saturation_max,
        zero_unobserved=True, scatter_cap=cfg.scatter_cap, scatter_pad=1 << 14)


@pytest.mark.parametrize("seed", [1, 2])
def test_apply_delta_matches_reference(seed):
    """The port's apply_delta against apply_delta_jit (x64) on the same keys:
    touched and dropped equal; occupancy bit for bit on voxels with hits or
    misses only; on every voxel against the reference run op by op."""
    cfg, keys, occ = _delta_case(seed)
    rcfg = _ref_cfg(cfg)
    n = cfg.sentinel
    port = torch.from_numpy(occ.copy())
    stats = integrate.apply_delta(port, torch.from_numpy(keys), cfg)
    port = port.numpy()
    ref_occ = np.concatenate([occ, np.full(rcfg.scatter_pad, -0.0, np.float32)])
    with jax.enable_x64(True):
        jitted, jstats = ref_integrate.apply_delta_jit(jnp.asarray(ref_occ), jnp.asarray(keys),
                                                       rcfg)
        with jax.disable_jit():
            eager, _ = ref_integrate.apply_delta(jnp.asarray(ref_occ), jnp.asarray(keys), rcfg)
    jitted, eager = np.asarray(jitted)[:n], np.asarray(eager)[:n]
    assert int(stats["touched"]) == int(jstats["touched"])
    assert int(stats["dropped_updates"]) == int(jstats["dropped_updates"]) > 0
    ids, hit = keys >> 1, keys & 1
    live = ids < n
    mixed = np.zeros(n, bool)
    mixed[np.intersect1d(ids[live & (hit == 1)], ids[live & (hit == 0)])] = True
    assert mixed.any() and (~mixed).any()
    np.testing.assert_array_equal(port[:n][~mixed].view(np.uint32),
                                  jitted[~mixed].view(np.uint32))
    np.testing.assert_array_equal(port[:n].view(np.uint32), eager.view(np.uint32))
    assert port[n].view(np.uint32) == np.float32(-0.0).view(np.uint32)  # the sentinel kept


def test_delta_path_ok_matches_reference():
    cfg = _delta_case(1)[0]
    rcfg = _ref_cfg(cfg)
    assert integrate.delta_path_ok(cfg) and ref_integrate.delta_path_ok(rcfg)
    for change in (dict(scatter_cap=0), dict(ray_flags=int(RayFlag.EXCLUDE_FREE)),
                   dict(ray_flags=int(RayFlag.STOP_ON_FIRST_OCCUPIED)), dict(with_traversal=True),
                   dict(saturation_max=3.0), dict(min_value=0.5)):
        assert not integrate.delta_path_ok(dataclasses.replace(cfg, **change))
        assert not ref_integrate.delta_path_ok(dataclasses.replace(rcfg, **change))


@pytest.mark.parametrize("n", [1, 1000, 1024, 1025, 5000])
@pytest.mark.parametrize("dtype", [np.int32, np.int64])
def test_cummax_matches_numpy_and_blocked(n, dtype):
    rng = np.random.default_rng(n)
    lowest = -(1 << 30)
    x = np.where(rng.random(n) < 0.1, rng.integers(-1000, 10**6, n), lowest).astype(dtype)
    got = segments.cummax(torch.from_numpy(x), lowest).numpy()
    np.testing.assert_array_equal(got, np.maximum.accumulate(x))
    if dtype is np.int32:
        np.testing.assert_array_equal(got, np.asarray(blocked.cummax(jnp.asarray(x),
                                                                     lowest=lowest)))
