"""TorchRayMapper with the side layers (voxel mean, traversal, touch time,
incident normal) on the CPU against TpuRayMapper on the rayflow wire
(split-phase apply: OHM_FUSED=0, scatter_cap=0), once with its Pallas
expand and deposit kernels in interpret mode (OHM_EXPAND=2, OHM_PALLAS=2;
the deposit kernel steps aside for traversal, as on a TPU) and once
without (OHM_EXPAND=0, OHM_PALLAS=0); against the port's f64 oracle; and
the asynchronous worker against the synchronous path.  Each package's
mapper runs on its own host map.

The sequence (region dims 8, so V = 512 as the reference's deposit kernel
needs; 0.1 m voxels; a 32-slot arena) visits three clusters of repeated
targets in turn, so every visit evicts regions to the host map and brings
them back; one batch spans all three and splits on CacheFull; the last
batch repeats its rays with touch times above 2^31 ms first and below
after, so each voxel's touch time is an unsigned maximum, not the last
write.  Each layer runs alone, under one of the reference's expand paths, and all
four together under both.

Against TpuRayMapper: the wire bytes, the key stream, occupancy bits, mean
counts, touch times, stats and arena hits/misses/evictions are equal; the
expand stream's traversal agrees per record and per voxel at
tests/test_expand_pallas.py's bounds and the traversal layer within
atol = rtol = 1e-5 (XLA's CPU backend contracts products and sums of the
jitted reference into FMAs; the port rounds each op); mean and incident
codes are identical on >= 99.9% of written voxels and within one quantum
per axis elsewhere."""

import sys

import numpy as np
import pytest
import torch

import ohm_tpu.mapping.tpu_map as ref_tpu_map
import ohm_tpu_torch.mapping.torch_map as port_torch_map
from ohm_tpu.core.map import MapFlag, OccupancyMap
from ohm_tpu.core.rayflags import RayFlag
from ohm_tpu.mapping.tpu_map import TpuRayMapper
from ohm_tpu_torch import TorchRayMapper
from ohm_tpu_torch.core import subvoxel as port_subvoxel
from ohm_tpu_torch.core.map import MapFlag as PortMapFlag
from ohm_tpu_torch.core.map import OccupancyMap as PortMap
from ohm_tpu_torch.mapping.arena import CacheFull
from ohm_tpu_torch.oracle.occupancy import RayMapperOccupancy

LAYER_SETS = {
    "mean": ("VOXEL_MEAN",),
    "traversal": ("TRAVERSAL",),
    "touch": ("TOUCH_TIME",),
    "incident": ("INCIDENT_NORMAL",),
    "all": ("VOXEL_MEAN", "TRAVERSAL", "TOUCH_TIME", "INCIDENT_NORMAL"),
}
MODES = {"interpret": ("2", "2"), "xla": ("0", "0")}  # (OHM_EXPAND, OHM_PALLAS)
CENTRES = ((0.0, 0.0, 0.0), (6.0, 0.0, 0.0), (0.0, 6.0, 0.0))
#: Host-map layer -> its members, each compared as below.
MEMBERS = {"occupancy": ("occupancy",), "mean": ("coord", "count"),
           "traversal": ("traversal",), "touch_time": ("touch",),
           "incident_normal": ("packed_normal",)}


def _flags(names, flag_cls):
    out = flag_cls.NONE
    for name in names:
        out |= getattr(flag_cls, name)
    return out


def _cluster(n, rng, centre, targets):
    """Rays from a centre to jittered copies of fixed targets around it:
    several samples land in each target voxel, within a batch and across."""
    ends = targets[rng.integers(0, len(targets), n)] + rng.normal(0, 0.01, (n, 3))
    rays = np.empty((2 * n, 3))
    rays[0::2] = centre
    rays[1::2] = np.asarray(centre) + ends
    return rays


def _sequence():
    """(batches, ray flags, timestamps) of the scenario described above."""
    rng = np.random.default_rng(31)
    targets = rng.uniform(-0.7, 0.7, (40, 3))
    visits = [0, 0, 1, 0, 2]
    batches = [_cluster(48, rng, CENTRES[c], targets) for c in visits]
    batches.append(np.concatenate([_cluster(32, rng, c, targets) for c in CENTRES]))
    last = _cluster(40, rng, CENTRES[1], targets)
    batches.append(np.concatenate([last, last]))
    flags = [0, int(RayFlag.EXCLUDE_ORIGIN), 0, int(RayFlag.END_POINT_AS_FREE), 0, 0, 0]
    stamps = [100.0 + i + np.arange(len(b) // 2) * 1e-3 for i, b in enumerate(batches[:-1])]
    late = 100.0 + 2.5e6 + np.arange(40) * 1e-3  # 2.5e9 ms after the first ray
    stamps.append(np.concatenate([late, 100.0 + 7.0 + np.arange(40) * 1e-3]))
    return batches, flags, stamps


def _host_layers(m):
    """(region, layer, member) -> a copy of the host map's values."""
    out = {}
    for key, chunk in m.chunks.items():
        for layer, members in MEMBERS.items():
            li = m.layer_index(layer)
            if li >= 0:
                for member in members:
                    out[(key, layer, member)] = np.array(chunk.layers[li][member])
    return out


class _Recorder:
    def __init__(self):
        self.wires, self.records = [], []


def _run_reference(layers, mode):
    batches, flags, stamps = _sequence()
    rec = _Recorder()
    expand_env, pallas_env = MODES[mode]
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OHM_FUSED", "0")
        mp.setenv("OHM_EXPAND", expand_env)
        mp.setenv("OHM_PALLAS", pallas_env)
        m = OccupancyMap(resolution=0.1, region_voxel_dims=8, flags=_flags(layers, MapFlag))
        ref = TpuRayMapper(m, capacity=32, validate=True, rayflow=True, scatter_cap=0)
        inner_expand, inner_dispatch = ref_tpu_map.expand_records_jit, ref._dispatch_rayflow

        def expand(batch, cfg):
            out = inner_expand(batch, cfg)
            rec.records.append({k: np.asarray(v) for k, v in out[0].items()})
            return out

        def dispatch(batch, cfg, n_rays, fl):
            rec.wires.append(np.array(batch["rayw"]))
            return inner_dispatch(batch, cfg, n_rays, fl)

        mp.setattr(ref_tpu_map, "expand_records_jit", expand)
        ref._dispatch_rayflow = dispatch
        ref.prime_caps(batches)
        for rays, fl, ts in zip(batches, flags, stamps):
            ref.integrate_rays(rays, timestamps=ts, ray_update_flags=fl)
        ref.sync_voxels()
    return _host_layers(m), ref.stats, dict(ref.arena.stats), rec


def _run_port(layers, use_async=False, record=True):
    batches, flags, stamps = _sequence()
    rec = _Recorder()
    m = PortMap(resolution=0.1, region_voxel_dims=8, flags=_flags(layers, PortMapFlag))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OHM_FUSED", "0")  # the reference's split-phase apply, as _run_reference's
        port = TorchRayMapper(m, capacity=32, validate=True, device="cpu", rayflow=True)
    with pytest.MonkeyPatch.context() as mp:
        if record:
            inner_expand, inner_dispatch = port_torch_map.expand_records, port._dispatch

            def expand(b, cfg):
                out = inner_expand(b, cfg)
                rec.records.append({k: v.numpy().copy() for k, v in out[0].items()})
                return out

            def dispatch(wire, cfg, n_rays):
                rec.wires.append(wire.numpy().copy())
                return inner_dispatch(wire, cfg, n_rays)

            mp.setattr(port_torch_map, "expand_records", expand)
            port._dispatch = dispatch
        port.prime_caps(batches)
        submit = port.integrate_rays_async if use_async else port.integrate_rays
        for rays, fl, ts in zip(batches, flags, stamps):
            submit(rays, timestamps=ts, ray_update_flags=fl)
        port.sync_voxels()
    return _host_layers(m), port.stats, dict(port.arena.stats), rec


@pytest.fixture(scope="module")
def ports():
    return {name: _run_port(layers) for name, layers in LAYER_SETS.items()}


@pytest.fixture(scope="module")
def refs():
    return {}


def _ref(refs, name, mode):
    if (name, mode) not in refs:
        refs[(name, mode)] = _run_reference(LAYER_SETS[name], mode)
    return refs[(name, mode)]


def _code_agreement(a, b, fields):
    """Share of identical codes, and the largest difference in quanta of any
    packed field (shift, mask) where they differ."""
    same = float((a == b).mean()) if a.size else 1.0
    worst = 0
    for shift, mask in fields:
        qa = (a.astype(np.int64) >> shift) & mask
        qb = (b.astype(np.int64) >> shift) & mask
        worst = max(worst, int(np.abs(qa - qb).max(initial=0)))
    return same, worst


MEAN_FIELDS = [(0, 1023), (10, 1023), (20, 1023), (31, 1)]
NORMAL_FIELDS = [(0, 0x3FFF), (15, 0x3FFF), (30, 1), (31, 1)]


def _compare_maps(ref, port):
    assert ref.keys() == port.keys()
    codes = {"coord": ([], [], MEAN_FIELDS), "packed_normal": ([], [], NORMAL_FIELDS)}
    for key in ref:
        a, b = ref[key], port[key]
        member = key[2]
        if member in codes:
            written = (a != 0) | (b != 0)
            codes[member][0].append(a[written])
            codes[member][1].append(b[written])
        elif member == "traversal":
            np.testing.assert_allclose(b, a, atol=1e-5, rtol=1e-5, err_msg=str(key))
        else:  # occupancy bits, mean counts and touch times exactly
            assert np.array_equal(a.view(np.uint32), b.view(np.uint32)), key
    for member, (xs, ys, fields) in codes.items():
        if xs:
            same, worst = _code_agreement(np.concatenate(xs), np.concatenate(ys), fields)
            assert same >= 0.999 and worst <= 1, (member, same, worst)


def _compare_streams(ref_rec, port_rec):
    assert len(ref_rec.wires) == len(port_rec.wires) > len(_sequence()[0])
    for w_ref, w_port in zip(ref_rec.wires, port_rec.wires):
        assert np.array_equal(w_ref, w_port)
    for r, p in zip(ref_rec.records, port_rec.records):
        assert np.array_equal(r["key"], p["key"])
        assert np.array_equal(r["end_flat"], p["end_flat"])
        assert np.array_equal(r["end_is_hit"], p["end_is_hit"])
        if "trav" in r:
            keys, a, b = r["key"], r["trav"], p["trav"]
            uniq, first_idx, counts = np.unique(keys, return_index=True, return_counts=True)
            solo = first_idx[counts == 1]
            np.testing.assert_allclose(b[solo], a[solo], rtol=2e-6, atol=1e-6)
            order = np.argsort(keys, kind="stable")
            bounds = np.flatnonzero(np.concatenate([[True], keys[order][1:] != keys[order][:-1]]))
            np.testing.assert_allclose(np.add.reduceat(b[order].astype(np.float64), bounds),
                                       np.add.reduceat(a[order].astype(np.float64), bounds),
                                       rtol=2e-6, atol=1e-6)


#: Each layer alone under one of the reference's two expand paths, and all
#: four together under both.
CASES = [("mean", "xla"), ("traversal", "interpret"), ("touch", "xla"),
         ("incident", "interpret"), ("all", "interpret"), ("all", "xla")]


@pytest.mark.parametrize("name,mode", CASES)
def test_layers_match_reference(ports, refs, name, mode):
    ref_layers, ref_stats, ref_arena, ref_rec = _ref(refs, name, mode)
    port_layers, port_stats, port_arena, port_rec = ports[name]
    _compare_streams(ref_rec, port_rec)
    _compare_maps(ref_layers, port_layers)
    assert ref_stats == port_stats
    assert ref_arena == port_arena
    assert port_arena["evictions"] >= 20
    assert port_stats["batches"] > len(_sequence()[0])  # CacheFull split a batch
    for k in ("missed_updates", "overflow", "dropped_updates", "compaction_dropped"):
        assert port_stats[k] == 0, k


def test_incident_normal_reads_denormal_directions_as_zero():
    """All four layers on two batches of tests/test_torch_mapper.py's
    denormal-direction rays (np.random.default_rng(3)), the port on the CPU
    against TpuRayMapper on the rayflow wire (split-phase apply).  XLA reads
    a denormal direction component as a zero of its sign, so such a ray
    neither sets the normal's negative-z bit nor counts as a nonzero z: the
    packed normals are held bit for bit, the other layers as in
    test_layers_match_reference, the stats equal."""
    from test_torch_mapper import _denormal_rays

    rng = np.random.default_rng(3)
    batches = [_denormal_rays(rng), _denormal_rays(rng)]
    stamps = [100.0 + i + np.arange(len(b) // 2) * 1e-3 for i, b in enumerate(batches)]
    layers = LAYER_SETS["all"]
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OHM_FUSED", "0")
        m = OccupancyMap(resolution=0.1, region_voxel_dims=8, flags=_flags(layers, MapFlag))
        ref = TpuRayMapper(m, capacity=64, validate=True, rayflow=True, scatter_cap=0)
        for rays, ts in zip(batches, stamps):
            ref.integrate_rays(rays, timestamps=ts)
        ref.sync_voxels()
    pm = PortMap(resolution=0.1, region_voxel_dims=8, flags=_flags(layers, PortMapFlag))
    port = TorchRayMapper(pm, capacity=64, validate=True, device="cpu", rayflow=True)
    for rays, ts in zip(batches, stamps):
        port.integrate_rays(rays, timestamps=ts)
    port.sync_voxels()
    ref_layers, port_layers = _host_layers(m), _host_layers(pm)
    _compare_maps(ref_layers, port_layers)
    normals = [k for k in ref_layers if k[2] == "packed_normal"]
    assert sum(int(np.count_nonzero(ref_layers[k])) for k in normals) > 20
    for key in normals:
        assert np.array_equal(ref_layers[key], port_layers[key]), key
    assert ref.stats == port.stats


def test_layers_hold_values(ports):
    """Every layer was written, and the last batch's touch times are an
    unsigned maximum over values on both sides of 2^31."""
    layers = ports["all"][0]
    for layer, members in MEMBERS.items():
        for member in members:
            vals = [v for k, v in layers.items() if k[1:] == (layer, member)]
            assert sum(int(np.count_nonzero(v != (np.inf if layer == "occupancy" else 0)))
                       for v in vals) > 100, (layer, member)
    touch = np.concatenate([v for k, v in layers.items() if k[2] == "touch"])
    assert (touch >= 2**31).sum() > 20 and ((touch > 0) & (touch < 2**31)).sum() > 20


def test_async_worker_gives_the_same_map(ports):
    """integrate_rays_async through eviction and a CacheFull split leaves
    the map integrate_rays leaves, bit for bit, with the same stats."""
    layers, stats, arena, _ = _run_port(LAYER_SETS["all"], use_async=True, record=False)
    sync_layers, sync_stats, sync_arena, _ = ports["all"]
    assert layers.keys() == sync_layers.keys()
    for key, val in layers.items():
        assert np.array_equal(val.view(np.uint32), sync_layers[key].view(np.uint32)), key
    assert stats == sync_stats and arena == sync_arena


def test_worker_error_surfaces_on_flush():
    """A batch that fails in the worker (one 60 m ray crosses more regions
    than the 64-slot arena holds, and a single ray cannot be split) raises
    on the next flush; the batches around it are integrated, and the mapper
    goes on working."""
    m = PortMap(resolution=0.1, region_voxel_dims=8, flags=PortMapFlag.TRAVERSAL)
    mapper = TorchRayMapper(m, capacity=64, validate=True, device="cpu", rayflow=True)
    good = _cluster(32, np.random.default_rng(3), CENTRES[0], np.full((1, 3), 0.5))
    mapper.integrate_rays_async(good)
    mapper.integrate_rays_async(np.array([[0.0, 0.0, 0.0], [60.0, 0.0, 0.0]]))
    mapper.integrate_rays_async(good)
    with pytest.raises(CacheFull):
        mapper.flush()
    mapper.flush()  # raised once
    assert mapper.stats["batches"] == 2
    mapper.integrate_rays_async(good)
    mapper.sync_voxels()
    assert mapper.stats["batches"] == 3
    assert mapper._worker.is_alive()


def test_worker_under_thread_switching():
    """Many small queued batches with a short thread switch interval, stats
    read between them: every batch is integrated once, in order, and the map
    equals the synchronous one bit for bit."""
    rng = np.random.default_rng(5)
    batches = [_cluster(6, rng, CENTRES[i % 2], np.full((1, 3), 0.4)) for i in range(40)]
    stamps = [100.0 + i + np.arange(6) * 1e-3 for i in range(40)]
    maps = []
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for queued in (False, True):
            m = PortMap(resolution=0.1, region_voxel_dims=8, flags=PortMapFlag.TOUCH_TIME
                        | PortMapFlag.TRAVERSAL)
            mapper = TorchRayMapper(m, capacity=16, validate=True, device="cpu", rayflow=True)
            submit = mapper.integrate_rays_async if queued else mapper.integrate_rays
            for i, (rays, ts) in enumerate(zip(batches, stamps)):
                submit(rays, timestamps=ts)
                if i % 7 == 0:
                    assert mapper.stats["batches"] == i + 1
            mapper.sync_voxels()
            assert mapper.stats["batches"] == 40
            maps.append(_host_layers(m))
    finally:
        sys.setswitchinterval(interval)
    assert maps[0].keys() == maps[1].keys()
    for key, val in maps[0].items():
        assert np.array_equal(val.view(np.uint32), maps[1][key].view(np.uint32)), key


def _box_room(n, rng, half=(4.0, 4.0, 2.0)):
    """tests/test_tpu_integrate.py's box room: a sensor at the centre."""
    dirs = rng.normal(size=(n, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    t = np.min(np.asarray(half) / np.abs(dirs), axis=1)
    rays = np.zeros((2 * n, 3))
    rays[1::2] = dirs * t[:, None]
    return rays


def test_all_layers_match_the_oracle():
    """The port against the f64 oracle on a box scan in four timestamped
    batches, at the JAX tests' tolerances: occupancy within 1e-4 on all but
    1% of observed voxels (compare_occupancy: f32 corner tie-breaks and the
    batch's hit/miss merge against the oracle's ray-by-ray order); mean
    counts equal and mean positions within 2e-3 and traversal within
    atol 2e-3 / rtol 1e-3 (tests/test_tpu_integrate.py); touch times within
    0.002 s (tests/test_occupancy_oracle.py).  The reference merges a
    batch's incident directions in one weighted sum where the oracle
    updates sample by sample: the two normals stay within 0.5 degrees (0.03
    measured, the codec's quantum)."""
    rng = np.random.default_rng(7)
    flags = PortMapFlag.VOXEL_MEAN | PortMapFlag.TRAVERSAL | PortMapFlag.TOUCH_TIME \
        | PortMapFlag.INCIDENT_NORMAL
    batches = [_box_room(150, rng) for _ in range(4)]
    stamps = [50.0 + i + np.arange(150) * 1e-3 for i in range(4)]
    maps = []
    for make in (lambda m: TorchRayMapper(m, capacity=256, validate=True, device="cpu",
                                          rayflow=True),
                 RayMapperOccupancy):
        m = PortMap(resolution=0.25, flags=flags)
        mapper = make(m)
        for rays, ts in zip(batches, stamps):
            mapper.integrate_rays(rays, timestamps=ts)
        if hasattr(mapper, "sync_voxels"):
            mapper.sync_voxels()
        maps.append(m)
    port, oracle = (_host_layers(m) for m in maps)
    assert port.keys() == oracle.keys()
    compared = failures = 0
    worst = {"occupancy": 0.0, "mean": 0.0, "traversal": 0.0, "touch_s": 0.0, "angle_deg": 0.0}
    for key, a in oracle.items():
        b = port[key]
        layer = key[1]
        if layer == "occupancy":
            inf_a, inf_b = np.isinf(a), np.isinf(b)
            compared += int((~inf_a | ~inf_b).sum())
            failures += int((inf_a != inf_b).sum())
            both = ~inf_a & ~inf_b
            diff = np.abs(a[both] - b[both])
            failures += int((diff > 1e-4).sum())
            worst["occupancy"] = max(worst["occupancy"], float(diff.max(initial=0)))
        elif key[2] == "count":
            assert np.array_equal(a, b), key
        elif key[2] == "coord":
            act = oracle[key[:2] + ("count",)] > 0
            ca = port_subvoxel.sub_voxel_to_local_coord(a[act], 0.25)
            cb = port_subvoxel.sub_voxel_to_local_coord(b[act], 0.25)
            np.testing.assert_allclose(cb, ca, atol=2e-3)
            worst["mean"] = max(worst["mean"], float(np.abs(ca - cb).max(initial=0)))
        elif layer == "traversal":
            np.testing.assert_allclose(b, a, atol=2e-3, rtol=1e-3)
            worst["traversal"] = max(worst["traversal"], float(np.abs(a - b).max()))
        elif layer == "touch_time":
            assert np.array_equal(a > 0, b > 0)
            dt = np.abs(a.astype(np.float64) - b.astype(np.float64)) * 1e-3
            worst["touch_s"] = max(worst["touch_s"], float(dt.max()))
        else:
            assert np.array_equal(a != 0, b != 0), key
            na = port_subvoxel.decode_normal(a[a != 0])
            nb = port_subvoxel.decode_normal(b[b != 0])
            cos = np.clip(np.sum(na * nb, axis=-1), -1.0, 1.0)
            worst["angle_deg"] = max(worst["angle_deg"],
                                     float(np.degrees(np.arccos(cos)).max(initial=0)))
    assert compared > 1000 and failures <= 0.01 * compared, (failures, compared)
    assert worst["touch_s"] <= 0.002, worst
    assert worst["angle_deg"] <= 0.5, worst
