"""TorchNdtMap with the side layers traversal, touch time and incident
normal on the CPU against TpuNdtMap with its Pallas kernels in interpret
mode (OHM_PALLAS=2, OHM_EXPAND=2: the branch the JAX package takes on a
TPU, whose deposit kernel steps aside for traversal) under the split-phase
apply (OHM_FUSED=0), and against the port's f64 oracle.  Each mapper runs
on its own package's host map.

The scene is tests/test_ndt.py's: a plane built in four 50-ray batches from
a sensor 2 m above it, then two 30-ray batches through it (0.25 m voxels,
region dims 8, so V = 512 as the reference's deposit kernel needs; a
32-slot arena), each ray with a timestamp.  Where a scenario says
``late``, the last batch gives its rays twice, with touch times above
2^31 ms first and below after, so a voxel's touch time is an unsigned
maximum, not the last write.  The scenarios cover each layer alone and
all three, NDT-OM and NDT-TM, the rayflow and the segmented wire,
``miss_k=4`` (an overflow) with traversal (the flagged records beyond K
drop in compacted-stream order) and without (sorted-stream order), and
``miss_k="exact"``.

Against TpuNdtMap: the wire bytes, each batch's K stream (the records the
NDT math took, in the order their sums run: the ids equal, so the dropped
sets are the same), the walk keys and voxel planes of K1, the stats, mean
counts, hit/miss counts and touch times are equal; occupancy, covariance,
intensity, traversal and the K stream's delta and traversal within
atol = rtol = 1e-5 (XLA's CPU backend contracts products and sums of the
jitted reference into FMAs; the port rounds each op); mean and incident
codes identical on >= 99.9% of written voxels and within one quantum
elsewhere.  Against the oracle: tests/test_ndt.py's tolerances, traversal
as its test_ndt_traversal_accumulates_on_gaussian_voxels (rtol 1e-3,
atol 2e-3), touch times within 2 ms."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import ohm_tpu.mapping.ndt_map as ref_ndt_map
import ohm_tpu.ops.integrate_ndt as ref_ndt_ops
import ohm_tpu_torch.mapping.ndt_map as port_ndt_map
import ohm_tpu_torch.ops.integrate_ndt as port_ndt_ops
from ohm_tpu.core.map import MapFlag, OccupancyMap
from ohm_tpu.mapping.ndt_map import TpuNdtMap
from ohm_tpu.ops import expand_pallas
from ohm_tpu.ops.integrate import _unpack_batch
from ohm_tpu.oracle.ndt import NdtParams
from ohm_tpu_torch import TorchNdtMap
from ohm_tpu_torch.core.map import MapFlag as PortMapFlag
from ohm_tpu_torch.core.map import OccupancyMap as PortMap
from ohm_tpu_torch.mapping.batch import prepare_ray_batch
from ohm_tpu_torch.oracle.ndt import NdtParams as PortNdtParams
from ohm_tpu_torch.oracle.ndt import RayMapperNdt as PortRayMapperNdt
from ohm_tpu_torch.ops import deposit_cuda, expand_cuda, gather_cuda
from ohm_tpu_torch.ops.wire import unpack_batch

STATS = ("touched", "ndt_flagged", "ndt_overflow", "missed_updates", "overflow",
         "compaction_dropped")
TOL = dict(atol=1e-5, rtol=1e-5)
ALL = ("TRAVERSAL", "TOUCH_TIME", "INCIDENT_NORMAL")
SCENARIOS = {
    "traversal_overflow": dict(layers=("TRAVERSAL",), tm=False, rayflow=True, miss_k=4),
    "touch_overflow": dict(layers=("TOUCH_TIME",), tm=False, rayflow=True, miss_k=4,
                           late=True),
    "incident_tm": dict(layers=("INCIDENT_NORMAL",), tm=True, rayflow=True, miss_k=1 << 15),
    "all_om": dict(layers=ALL, tm=False, rayflow=True, miss_k=1 << 15),
    "all_tm_overflow": dict(layers=ALL, tm=True, rayflow=True, miss_k=4, late=True),
    "all_tm_segmented": dict(layers=ALL, tm=True, rayflow=False, miss_k=1 << 15),
    "all_exact_segmented": dict(layers=ALL, tm=False, rayflow=False, miss_k="exact"),
}
OVERFLOWING = ("traversal_overflow", "touch_overflow", "all_tm_overflow")
#: Host-map layer -> its members.
MEMBERS = {"occupancy": ("occupancy",), "mean": ("coord", "count"),
           "covariance": ("P00", "P01", "P11", "P02", "P12", "P22"),
           "intensity": ("mean", "cov"), "hit_miss_count": ("hit_count", "miss_count"),
           "traversal": ("traversal",), "touch_time": ("touch",),
           "incident_normal": ("packed_normal",)}
MEAN_FIELDS = [(0, 1023), (10, 1023), (20, 1023), (31, 1)]
NORMAL_FIELDS = [(0, 0x3FFF), (15, 0x3FFF), (30, 1), (31, 1)]


def _flags(names, flag_cls):
    out = flag_cls.NONE
    for name in names:
        out |= getattr(flag_cls, name)
    return out


def _plane(n, rng):
    rays = np.empty((2 * n, 3))
    rays[0::2] = (0.0, 0.0, 2.0)
    rays[1::2] = np.column_stack([rng.uniform(-1, 1, n), rng.uniform(-1, 1, n),
                                  rng.normal(0, 0.005, n)])
    return rays


def _through(n, rng):
    rays = np.empty((2 * n, 3))
    rays[0::2] = (0.0, 0.0, 2.0)
    rays[1::2] = np.column_stack([rng.uniform(-0.8, 0.8, n), rng.uniform(-0.8, 0.8, n),
                                  np.full(n, -0.8)])
    return rays


def _scene(spec):
    """(batches, intensities or Nones, timestamps) of one scenario."""
    rng = np.random.default_rng(17)
    batches = [_plane(50, rng) for _ in range(4)] + [_through(30, rng) for _ in range(2)]
    stamps = [100.0 + i + np.arange(len(b) // 2) * 1e-3 for i, b in enumerate(batches)]
    if spec.get("late"):
        batches[-1] = np.concatenate([batches[-1], batches[-1]])
        stamps[-1] = np.concatenate([100.0 + 2.5e6 + np.arange(30) * 1e-3,  # 2.5e9 ms on
                                     100.0 + 7.0 + np.arange(30) * 1e-3])
    intens = [rng.uniform(10.0, 20.0, len(b) // 2).astype(np.float32) if spec["tm"] else None
              for b in batches]
    return batches, intens, stamps


class _Recorder:
    """Each batch's stats, wire arrays, K stream and (port) flag gather and
    K3 walk streams."""

    def __init__(self):
        self.stats, self.wires, self.cfgs, self.k_streams = [], [], [], []
        self.flags, self.walks = [], []


def _host_layers(m) -> dict:
    out = {}
    for key, chunk in m.chunks.items():
        for layer, members in MEMBERS.items():
            li = m.layer_index(layer)
            if li >= 0:
                for member in members:
                    out[(key, layer, member)] = np.array(chunk.layers[li][member])
    return out


def _integrate(mapper, spec):
    batches, intens, stamps = _scene(spec)
    if spec["rayflow"]:
        mapper.prime_caps(batches)
    for rays, inten, ts in zip(batches, intens, stamps):
        mapper.integrate_rays(rays, intensities=inten, timestamps=ts)
    mapper.sync_voxels()


def _run_reference(spec):
    rec = _Recorder()
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OHM_FUSED", "0")
        mp.setenv("OHM_PALLAS", "2")
        mp.setenv("OHM_EXPAND", "2")
        m = OccupancyMap(resolution=0.25, region_voxel_dims=8,
                         flags=_flags(spec["layers"], MapFlag))
        ref = TpuNdtMap(m, NdtParams(ndt_tm=spec["tm"]), capacity=32,
                        validate=spec["miss_k"] != 4, miss_k=spec["miss_k"])
        ref.rayflow = spec["rayflow"]

        def integrate(arena, batch, cfg):  # a fresh jit, traced with the K stream's spy
            return ref_ndt_ops.integrate_ndt(arena, batch, cfg)

        jitted = jax.jit(integrate, static_argnames=("cfg",))

        def recorded(arena, batch, cfg):
            rec.wires.append({k: np.array(v) for k, v in batch.items()})
            rec.cfgs.append(cfg.base)
            out = jitted(arena, batch, cfg)
            rec.stats.append({k: int(out[1][k]) for k in STATS})
            return out

        inner_reduce = ref_ndt_ops._segment_reduce

        def segment_reduce(ids, payloads, base):
            if len(payloads) <= 3:  # the K stream's (the hit phase's has ten or more)
                jax.debug.callback(
                    lambda i, *p: rec.k_streams.append((np.array(i), [np.array(x) for x in p])),
                    ids, *[v for v, _ in payloads])
            return inner_reduce(ids, payloads, base)

        mp.setattr(ref_ndt_map, "integrate_ndt_jit", recorded)
        mp.setattr(ref_ndt_ops, "_segment_reduce", segment_reduce)
        _integrate(ref, spec)
        jax.effects_barrier()
    return m, ref.stats, rec


def _run_port(spec):
    rec = _Recorder()
    m = PortMap(resolution=0.25, region_voxel_dims=8, flags=_flags(spec["layers"], PortMapFlag))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OHM_FUSED", "0")  # the reference's split-phase apply, as _run_reference's
        port = TorchNdtMap(m, PortNdtParams(ndt_tm=spec["tm"]), capacity=32,
                           validate=spec["miss_k"] != 4, miss_k=spec["miss_k"],
                           rayflow=spec["rayflow"], device="cpu")
    inner = port_ndt_map.integrate_ndt
    inner_dispatch = port._dispatch
    inner_reduce = port_ndt_ops.segment_reduce
    inner_flags = gather_cuda.gather_ndt_flags
    inner_k3 = deposit_cuda.deposit_and_sweep_ndt

    def integrate(arena, b, cfg):
        out = inner(arena, b, cfg)
        rec.stats.append({k: int(out[k]) for k in STATS})
        return out

    def dispatch(upload, cfg, n_rays, n_segments=None):
        if isinstance(upload, torch.Tensor):
            rec.wires.append({"rayw": upload.numpy().copy()})
        else:
            rec.wires.append({k: v.numpy().copy() for k, v in upload.items()})
        rec.cfgs.append(cfg)
        return inner_dispatch(upload, cfg, n_rays, n_segments)

    def segment_reduce(ids, payloads, mode="sum"):
        if payloads.dim() == 2 and payloads.shape[1] <= 3:
            rec.k_streams.append((ids.numpy().copy(),
                                  [payloads[:, j].numpy().copy()
                                   for j in range(payloads.shape[1])]))
        return inner_reduce(ids, payloads, mode)

    def flags(occ, count, ids, threshold, sentinel):
        out = inner_flags(occ, count, ids, threshold, sentinel)
        rec.flags.append((ids.numpy().copy(), out.numpy().copy()))
        return out

    def k3(occ, walk, end, delta, cfg, bounds_key=None):
        rec.walks.append((walk.numpy().copy(), bounds_key.numpy().copy(), cfg.sentinel))
        return inner_k3(occ, walk, end, delta, cfg, bounds_key=bounds_key)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_ndt_map, "integrate_ndt", integrate)
        mp.setattr(port_ndt_ops, "segment_reduce", segment_reduce)
        mp.setattr(gather_cuda, "gather_ndt_flags", flags)
        mp.setattr(deposit_cuda, "deposit_and_sweep_ndt", k3)
        port._dispatch = dispatch
        _integrate(port, spec)
    return m, port.stats, rec


def _run_oracle(spec):
    m = PortMap(resolution=0.25, region_voxel_dims=8, flags=_flags(spec["layers"], PortMapFlag))
    oracle = PortRayMapperNdt(m, PortNdtParams(ndt_tm=spec["tm"]))
    batches, intens, stamps = _scene(spec)
    for rays, inten, ts in zip(batches, intens, stamps):
        oracle.integrate_rays(rays, intensities=inten, timestamps=ts)
    return m


@pytest.fixture(scope="module")
def runs():
    return {name: {"ref": _run_reference(spec), "port": _run_port(spec)}
            for name, spec in SCENARIOS.items()}


def _codes(a, b, fields):
    same = float((a == b).mean()) if a.size else 1.0
    worst = 0
    for shift, mask in fields:
        qa = (a.astype(np.int64) >> shift) & mask
        qb = (b.astype(np.int64) >> shift) & mask
        worst = max(worst, int(np.abs(qa - qb).max(initial=0)))
    return same, worst


@pytest.mark.parametrize("name", SCENARIOS)
def test_wires_equal(runs, name):
    ref, port = runs[name]["ref"][2].wires, runs[name]["port"][2].wires
    assert len(ref) == len(port) >= 6
    for a, b in zip(ref, port):
        wire = "rayw" if SCENARIOS[name]["rayflow"] else "wire"
        assert np.array_equal(a[wire], b[wire])
        if "intensity" in a:
            assert np.array_equal(a["intensity"], b["intensity"])


@pytest.mark.parametrize("name", SCENARIOS)
def test_k_streams_equal(runs, name):
    """The records the NDT math took, batch by batch: the same voxel ids in
    the same order (so the same records were dropped), their delta and
    (with traversal) traversal within 1e-5."""
    ref, port = runs[name]["ref"][2].k_streams, runs[name]["port"][2].k_streams
    assert len(ref) == len(port) >= 6
    taken = 0
    for (ids_r, cols_r), (ids_p, cols_p) in zip(ref, port):
        assert np.array_equal(ids_r, ids_p)
        assert len(cols_r) == len(cols_p) == (3 if "TRAVERSAL" in SCENARIOS[name]["layers"]
                                               else 2)
        for a, b in zip(cols_r, cols_p):
            np.testing.assert_allclose(b, a, **TOL)
        taken += int((ids_p != ids_p.max()).sum())
    assert taken > 0


@pytest.mark.parametrize("name", SCENARIOS)
def test_batch_stats_equal(runs, name):
    ref, port = runs[name]["ref"][2].stats, runs[name]["port"][2].stats
    assert ref == port
    total = {k: sum(s[k] for s in port) for k in STATS}
    assert total["ndt_flagged"] > 0
    assert (total["ndt_overflow"] > 0) == (name in OVERFLOWING)
    ref_stats, port_stats = runs[name]["ref"][1], runs[name]["port"][1]
    for k in ("rays", "segments", "batches", "missed_updates", "overflow",
              "compaction_dropped", "ndt_overflow"):
        assert ref_stats[k] == port_stats[k], k


@pytest.mark.parametrize("name", SCENARIOS)
def test_host_maps_agree(runs, name):
    ref, port = _host_layers(runs[name]["ref"][0]), _host_layers(runs[name]["port"][0])
    assert ref.keys() == port.keys()
    codes = {"coord": ([], [], MEAN_FIELDS), "packed_normal": ([], [], NORMAL_FIELDS)}
    written = {}
    for key in ref:
        a, b = ref[key], port[key]
        member = key[2]
        if member in codes:
            w = (a != 0) | (b != 0)
            codes[member][0].append(a[w])
            codes[member][1].append(b[w])
        elif a.dtype == np.float32:
            assert np.array_equal(np.isinf(a), np.isinf(b)), key
            fin = np.isfinite(a)
            np.testing.assert_allclose(b[fin], a[fin], err_msg=str(key), **TOL)
        else:  # mean, hit and miss counts and touch times exactly
            assert np.array_equal(a, b), key
        written[member] = written.get(member, 0) + int(np.count_nonzero(
            np.isfinite(b) if member == "occupancy" else b))
    for member, (xs, ys, fields) in codes.items():
        if xs:
            same, worst = _codes(np.concatenate(xs), np.concatenate(ys), fields)
            assert same >= 0.999 and worst <= 1, (member, same, worst)
    for member in ("occupancy", "count", "traversal", "touch", "packed_normal"):
        assert written.get(member, 100) >= 100, (member, written)


@pytest.mark.parametrize("name", [n for n in SCENARIOS if SCENARIOS[n]["rayflow"]])
def test_walk_keys_equal(runs, name):
    """The last batch's config, walk keys, voxel planes and traversal, from
    K1 of both packages (the reference's in interpret mode)."""
    ref, port = runs[name]["ref"][2], runs[name]["port"][2]
    jcfg, pcfg = ref.cfgs[-1], port.cfgs[-1]
    assert {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(pcfg)} \
        == dataclasses.asdict(pcfg)
    wire = ref.wires[-1]["rayw"]
    trav = "TRAVERSAL" in SCENARIOS[name]["layers"]
    ref_key, ref_trav, ref_aux = expand_pallas.expand_keys(
        _unpack_batch({"rayw": jnp.asarray(wire)}, jcfg), jcfg, with_vox=True,
        with_trav=trav, interpret=True)
    key, aux = expand_cuda.expand_keys(unpack_batch(torch.from_numpy(wire), pcfg), pcfg,
                                       with_vox=True, with_trav=trav)
    assert np.array_equal(np.asarray(ref_key), key.numpy())
    live = key.numpy() != pcfg.sentinel
    assert live.sum() > 100
    assert np.array_equal(np.asarray(ref_aux["vox"])[live], aux["vox"].numpy()[live])
    if trav:
        np.testing.assert_allclose(aux["trav"].numpy(), np.asarray(ref_trav),
                                   rtol=2e-6, atol=1e-6)


def test_drop_orders(runs):
    """Under miss_k=4 the K stream is the first four flagged records in
    sorted-stream order without traversal, and in compacted-stream order
    with it, which differs from the sorted order in some batch."""
    for name in OVERFLOWING:
        rec = runs[name]["port"][2]
        trav = "TRAVERSAL" in SCENARIOS[name]["layers"]
        differs = 0
        for (sids, flag), (ids_k, _) in zip(rec.flags, rec.k_streams):
            sorted_first = sids[flag > 0][:4]
            taken = ids_k[:len(sorted_first)]
            if trav:
                differs += not np.array_equal(np.sort(taken), sorted_first)
            else:
                assert np.array_equal(taken, sorted_first), name
        assert differs > 0 if trav else True, name


def test_ndt_walk_stream_masks_a_prefix_of_each_run_under_traversal(runs):
    """K3 reads the walk stream with its unmasked bounds and needs the
    records the NDT math took (masked to the sentinel key) first in each
    voxel's run.  With traversal the K stream is chosen in compacted-stream
    order; the masked records still form a prefix of each run, and some
    runs are cut part way."""
    cut = 0
    for name in ("traversal_overflow", "all_tm_overflow"):
        for walk, bounds, sentinel in runs[name]["port"][2].walks:
            assert bool((bounds[1:] >= bounds[:-1]).all())
            masked = walk != bounds
            assert bool((walk[masked] == sentinel << 1).all())
            same_run = bounds[1:] == bounds[:-1]
            assert not bool((same_run & ~masked[:-1] & masked[1:]).any())
            cut += int((same_run & masked[:-1] & ~masked[1:]).sum())
    assert cut > 0


def _split_voxels(spec) -> set:
    """(region, voxel index) of each voxel where the segmented wire starts a
    ray's second or later segment."""
    m = PortMap(resolution=0.25, region_voxel_dims=8, flags=PortMapFlag.NONE)
    edge = 0.999 * 8 * 0.25
    out = set()
    for rays in _scene(spec)[0]:
        prepared = prepare_ray_batch(m, rays, segment_length=edge)
        n = prepared.n_segments
        ints, flags = prepared.arrays["ints"][:n], prepared.arrays["flags"][:n]
        for v in ints[~flags[:, 2] & flags[:, 3], 0:3]:
            region, local = v // 8, v % 8
            out.add((tuple(int(x) for x in region), int(local[0] + 8 * local[1] + 64 * local[2])))
    return out


@pytest.mark.parametrize("name", [n for n in SCENARIOS if n not in OVERFLOWING])
def test_port_matches_oracle(runs, name):
    """tests/test_ndt.py's tolerances: occupancy within 5e-3 on all but 4%
    of voxels, mean counts equal and covariance within 5e-3 on active
    voxels; traversal within rtol 1e-3 / atol 2e-3; touch times within
    2 ms.

    On the segmented wire, the voxel where a ray's later segment starts
    takes only that segment's part of the ray in the reference (the earlier
    segment stops short of its end voxel, integrate_ndt.py:113-133), so its
    traversal falls short of the oracle's, which walks the ray whole: there
    the port is held at or below the oracle, and to the reference (the
    other tests) bit for bit in its sums' order."""
    spec = SCENARIOS[name]
    oracle = _host_layers(_run_oracle(spec))
    port = _host_layers(runs[name]["port"][0])
    split = set() if spec["rayflow"] else _split_voxels(spec)
    compared = failures = 0
    full = np.full(512, np.inf, np.float32)
    for key in {k[0] for k in oracle} | {k[0] for k in port}:
        a = oracle.get((key, "occupancy", "occupancy"), full)
        b = port.get((key, "occupancy", "occupancy"), full)
        inf_a, inf_b = np.isinf(a), np.isinf(b)
        compared += int((~inf_a | ~inf_b).sum())
        failures += int((inf_a != inf_b).sum())
        both = ~inf_a & ~inf_b
        failures += int((np.abs(a[both] - b[both]) > 5e-3).sum())
    assert compared > 100 and failures <= 0.04 * compared, (failures, compared)
    checked = {"traversal": 0, "touch": 0, "split": 0}
    for (key, layer, member), a in oracle.items():
        b = port[(key, layer, member)]
        if member == "count":
            assert np.array_equal(a, b), key
        elif layer == "covariance":
            act = oracle[(key, "mean", "count")] > 0
            np.testing.assert_allclose(b[act], a[act], atol=5e-3)
        elif member == "traversal":
            at_split = np.zeros(a.shape, bool)
            at_split[[i for r, i in split if r == key]] = True
            assert bool((b[at_split] <= a[at_split] + 2e-3).all()), key
            mask = ((a > 0) | (b > 0)) & ~at_split
            np.testing.assert_allclose(b[mask], a[mask], rtol=1e-3, atol=2e-3, err_msg=str(key))
            checked["traversal"] += int(mask.sum())
            checked["split"] += int(at_split.sum())
        elif member == "touch":
            assert np.abs(a.astype(np.int64) - b.astype(np.int64)).max() <= 2, key
            checked["touch"] += int(np.count_nonzero(a))
    layers = spec["layers"]
    assert checked["traversal"] > 100 or "TRAVERSAL" not in layers
    assert checked["touch"] > 100 or "TOUCH_TIME" not in layers
    assert (checked["split"] > 0) == (not spec["rayflow"] and "TRAVERSAL" in layers)
