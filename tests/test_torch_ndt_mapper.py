"""TorchNdtMap on the CPU against TpuNdtMap on the rayflow wire with its
kernels in interpret mode (OHM_PALLAS=2, OHM_EXPAND=2: the branch the JAX
package takes on a TPU), and against the f64 oracle RayMapperNdt.

Scenarios, each run once per module for both mappers (region dims 8, so
V = 512 as the reference's deposit kernel needs; 0.25 m voxels):

  one_batch  the reference builds a plane in four batches; its arena
             (Gaussian-bearing voxels included) moves into the port through
             arena_from_reference, and one batch of rays through the plane
             runs on both
  eviction   planes at three places through a 12-slot arena: every visit
             evicts regions to the host map and brings them back
  overflow   miss_k=4: flagged records beyond 4 fall back to standard misses
  exact      miss_k="exact"
  tm         NDT-TM with intensities
  auto_miss_k
             the default miss_k: sized on the fourth batch, then a cube of
             samples densifies until a batch overflows it and it escalates
             (no oracle run: ~7,700 rays)

Against TpuNdtMap: the wire bytes, the walk keys, mean and hit/miss counts,
each batch's miss_k, the final miss_k and the stats (touched, ndt_flagged,
ndt_overflow, missed_updates, overflow, compaction_dropped) are equal; occupancy, covariance and
intensity agree within atol = rtol = 1e-5 (XLA's CPU backend contracts
products and sums of the jitted reference into FMAs; the port rounds each
op, as the TPU does); mean codes are identical on >= 99.9% of active voxels
and within one quantum elsewhere.  Against the oracle: tests/test_ndt.py's
tolerances."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import ohm_tpu.mapping.ndt_map as ref_ndt_map
import ohm_tpu_torch.mapping.ndt_map as port_ndt_map
from ohm_tpu.core.layout import (COVARIANCE_LAYER, HIT_MISS_COUNT_LAYER, INTENSITY_LAYER,
                                 MEAN_LAYER, OCCUPANCY_LAYER)
from ohm_tpu.core.map import MapFlag, OccupancyMap
from ohm_tpu.mapping.ndt_map import TpuNdtMap
from ohm_tpu.ops import expand_pallas
from ohm_tpu.ops.integrate import _unpack_batch
from ohm_tpu.oracle.ndt import NdtParams, RayMapperNdt
from ohm_tpu_torch import TorchNdtMap
from ohm_tpu_torch.mapping.arena import arena_from_reference
from ohm_tpu_torch.mapping.filters import use_safe_default_filter
from ohm_tpu_torch.ops import expand_cuda
from ohm_tpu_torch.ops.config import IntegrateConfig
from ohm_tpu_torch.ops.wire import unpack_batch

STATS = ("touched", "ndt_flagged", "ndt_overflow", "missed_updates", "overflow",
         "compaction_dropped")
TOL = dict(atol=1e-5, rtol=1e-5)


def _plane(n, rng, centre=(0.0, 0.0)):
    """Rays from a sensor 2 m above a horizontal plane (tests/test_ndt.py)."""
    cx, cy = centre
    samples = np.column_stack([cx + rng.uniform(-1, 1, n), cy + rng.uniform(-1, 1, n),
                               rng.normal(0, 0.005, n)])
    rays = np.empty((2 * n, 3))
    rays[0::2] = (cx, cy, 2.0)
    rays[1::2] = samples
    return rays


def _through(n, rng, centre=(0.0, 0.0)):
    """Rays from the same sensor through the plane to z = -0.8."""
    cx, cy = centre
    rays = np.empty((2 * n, 3))
    rays[0::2] = (cx, cy, 2.0)
    rays[1::2] = np.column_stack([cx + rng.uniform(-0.8, 0.8, n),
                                  cy + rng.uniform(-0.8, 0.8, n), np.full(n, -0.8)])
    return rays


def _cloud(n, rng, below=False):
    """Rays from a sensor above a 2 m cube of samples centred at (4, 0, 0):
    to samples inside it, or (``below``) through all of it to z = -2.5.
    Once the cube's voxels hold Gaussians, every ray crosses several."""
    rays = np.empty((2 * n, 3))
    rays[0::2] = (4.0, 0.0, 3.5)
    rays[1::2] = np.column_stack([4.0 + rng.uniform(-0.95, 0.95, n), rng.uniform(-0.95, 0.95, n),
                                  np.full(n, -2.5) if below else rng.uniform(-0.95, 0.95, n)])
    return rays


def _scenarios():
    rng = np.random.default_rng(17)
    build = [_plane(50, rng) for _ in range(4)]
    through = [_through(30, rng) for _ in range(2)]
    far = [(0.0, 0.0), (20.0, 0.0), (0.0, 20.0)]
    visits = [0, 1, 0, 2, 1, 0]
    evict = []
    for i, c in enumerate(visits):
        evict += [_plane(50, rng, far[c]) for _ in range(2 if i < 3 else 1)]
        evict.append(_through(30, rng, far[c]))
    intens = [rng.uniform(10.0, 20.0, len(b) // 2).astype(np.float32)
              for b in build + through]
    # Densifying: the default miss_k sizes itself on the fourth (plane)
    # batch to 4096; the cube's flagged records then outgrow it.
    dense = build + [_cloud(1500, rng) for _ in range(3)] + [_cloud(1500, rng, True)
                                                             for _ in range(2)]
    return {
        "one_batch": dict(batches=build + through[:1], capacity=32, miss_k=1 << 15,
                          seeded=len(build)),
        "eviction": dict(batches=evict, capacity=12, miss_k=1 << 15),
        "overflow": dict(batches=build + through, capacity=32, miss_k=4),
        "exact": dict(batches=build + through, capacity=32, miss_k="exact"),
        "tm": dict(batches=build + through, capacity=32, miss_k=1 << 15, tm=True,
                   intens=intens),
        "auto_miss_k": dict(batches=dense, capacity=32, miss_k=None, oracle=False),
    }


class _Recorder:
    """Records each batch's stats, miss_k and wire of one mapper class."""

    def __init__(self):
        self.stats, self.miss_k, self.wires = [], [], []


def _mapper_args(spec) -> dict:
    """validate drains the stats after every batch (so a sized miss_k
    escalates before the next); miss_k None is the default, auto-sized."""
    args = dict(capacity=spec["capacity"], validate=spec["miss_k"] != 4)
    if spec["miss_k"] is not None:
        args["miss_k"] = spec["miss_k"]
    return args


def _run_reference(mp, spec, rec):
    m = OccupancyMap(resolution=0.25, region_voxel_dims=8, flags=MapFlag.NONE)
    ref = TpuNdtMap(m, NdtParams(ndt_tm=spec.get("tm", False)), **_mapper_args(spec))
    ref.rayflow = True
    inner_jit, inner_dispatch = ref_ndt_map.integrate_ndt_jit, ref._dispatch_rayflow

    def jit(arena, batch, cfg):
        out = inner_jit(arena, batch, cfg)
        rec.stats.append({k: int(out[1][k]) for k in STATS})
        rec.miss_k.append(cfg.miss_k)
        return out

    def dispatch(batch, base_cfg, n_rays, flags):
        rec.wires.append((np.array(batch["rayw"]), base_cfg))
        return inner_dispatch(batch, base_cfg, n_rays, flags)

    mp.setattr(ref_ndt_map, "integrate_ndt_jit", jit)
    ref._dispatch_rayflow = dispatch
    ref.prime_caps(spec["batches"])
    return m, ref


def _run_port(mp, spec, rec):
    m = OccupancyMap(resolution=0.25, region_voxel_dims=8, flags=MapFlag.NONE)
    port = TorchNdtMap(m, NdtParams(ndt_tm=spec.get("tm", False)), device="cpu",
                       **_mapper_args(spec))
    inner, inner_dispatch = port_ndt_map.integrate_ndt, port._dispatch

    def integrate(arena, b, cfg):
        out = inner(arena, b, cfg)
        rec.stats.append({k: int(out[k]) for k in STATS})
        rec.miss_k.append(cfg.miss_k)
        return out

    def dispatch(wire, cfg, n_rays):
        rec.wires.append((wire.numpy().copy(), cfg))
        return inner_dispatch(wire, cfg, n_rays)

    mp.setattr(port_ndt_map, "integrate_ndt", integrate)
    port._dispatch = dispatch
    port.prime_caps(spec["batches"])
    return m, port


def _run(spec):
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OHM_PALLAS", "2")
        mp.setenv("OHM_EXPAND", "2")
        rec_r, rec_p = _Recorder(), _Recorder()
        m_r, ref = _run_reference(mp, spec, rec_r)
        m_p, port = _run_port(mp, spec, rec_p)
        intens = spec.get("intens") or [None] * len(spec["batches"])
        seeded = spec.get("seeded", 0)
        for rays, inten in zip(spec["batches"][:seeded], intens):
            ref.integrate_rays(rays, intensities=inten)
        if seeded:
            arrays = {k: np.asarray(v) for k, v in ref.arena.arrays.items()}
            port.arena = arena_from_reference(arrays, ref.arena.capacity, port.region_shift,
                                              port.device, directory=ref.arena)
            rec_r.stats.clear()
            rec_r.miss_k.clear()
            rec_r.wires.clear()
        for rays, inten in zip(spec["batches"][seeded:], intens[seeded:]):
            ref.integrate_rays(rays, intensities=inten)
            port.integrate_rays(rays, intensities=inten)
        out["ref_arena"] = {k: np.asarray(v) for k, v in ref.arena.arrays.items()}
        out["port_arena"] = {k: v.numpy().copy() for k, v in port.arena.layers.items()}
        ref.sync_voxels()
        port.sync_voxels()
        out.update(ref=(m_r, ref.stats, rec_r), port=(m_p, port.stats, rec_p),
                   arena_stats=(dict(ref.arena.stats), dict(port.arena.stats)),
                   miss_k=(ref.miss_k, port.miss_k))
    if not spec.get("oracle", True):
        return out
    oracle_map = OccupancyMap(resolution=0.25, region_voxel_dims=8, flags=MapFlag.NONE)
    use_safe_default_filter(oracle_map)
    oracle = RayMapperNdt(oracle_map, NdtParams(ndt_tm=spec.get("tm", False)))
    for rays, inten in zip(spec["batches"], intens):
        oracle.integrate_rays(rays, intensities=inten)
    out["oracle"] = oracle_map
    return out


SCENARIOS = ("one_batch", "eviction", "overflow", "exact", "tm", "auto_miss_k")
OVERFLOWING = ("overflow", "auto_miss_k")


@pytest.fixture(scope="module")
def runs():
    return {name: _run(spec) for name, spec in _scenarios().items()}


def _layers(m) -> dict:
    idx = {n: m.layer_index(n) for n in (OCCUPANCY_LAYER, MEAN_LAYER, COVARIANCE_LAYER,
                                         INTENSITY_LAYER, HIT_MISS_COUNT_LAYER)}
    out = {}
    for key, c in m.chunks.items():
        d = {"occupancy": c.layers[idx[OCCUPANCY_LAYER]][OCCUPANCY_LAYER],
             "coord": c.layers[idx[MEAN_LAYER]]["coord"],
             "count": c.layers[idx[MEAN_LAYER]]["count"],
             "cov": np.stack([c.layers[idx[COVARIANCE_LAYER]][f] for f in
                              ("P00", "P01", "P11", "P02", "P12", "P22")], axis=-1)}
        if idx[INTENSITY_LAYER] >= 0:
            d["intensity"] = np.stack([c.layers[idx[INTENSITY_LAYER]]["mean"],
                                       c.layers[idx[INTENSITY_LAYER]]["cov"]], axis=-1)
            d["hit_count"] = c.layers[idx[HIT_MISS_COUNT_LAYER]]["hit_count"]
            d["miss_count"] = c.layers[idx[HIT_MISS_COUNT_LAYER]]["miss_count"]
        out[key] = d
    return out


def _assert_mean_codes(ref_coord, port_coord):
    identical = (ref_coord == port_coord).mean()
    assert identical >= 0.999, identical
    for axis in range(3):
        qa = ((ref_coord >> (10 * axis)) & 1023).astype(np.int64)
        qb = ((port_coord >> (10 * axis)) & 1023).astype(np.int64)
        assert np.abs(qa - qb).max(initial=0) <= 1


@pytest.mark.parametrize("name", SCENARIOS)
def test_host_maps_agree(runs, name):
    ref, port = _layers(runs[name]["ref"][0]), _layers(runs[name]["port"][0])
    assert ref.keys() == port.keys()
    coords = [[], []]
    for key in ref:
        a, b = ref[key], port[key]
        assert np.array_equal(np.isinf(a["occupancy"]), np.isinf(b["occupancy"]))
        fin = np.isfinite(a["occupancy"])
        np.testing.assert_allclose(b["occupancy"][fin], a["occupancy"][fin], **TOL)
        np.testing.assert_allclose(b["cov"], a["cov"], **TOL)
        for n in ("count", "hit_count", "miss_count"):
            if n in a:
                assert np.array_equal(a[n], b[n]), n
        if "intensity" in a:
            np.testing.assert_allclose(b["intensity"], a["intensity"], **TOL)
        act = a["count"] > 0
        coords[0].append(a["coord"][act])
        coords[1].append(b["coord"][act])
    _assert_mean_codes(np.concatenate(coords[0]), np.concatenate(coords[1]))
    assert sum(int(np.isfinite(d["occupancy"]).sum()) for d in port.values()) > 100


@pytest.mark.parametrize("name", SCENARIOS)
def test_batch_stats_equal(runs, name):
    ref, port = runs[name]["ref"][2].stats, runs[name]["port"][2].stats
    assert len(ref) == len(port) > 0
    assert ref == port
    total = {k: sum(s[k] for s in port) for k in STATS}
    assert total["ndt_flagged"] > 0
    assert total["ndt_overflow"] > 0 if name in OVERFLOWING else total["ndt_overflow"] == 0
    assert runs[name]["port"][1]["ndt_flagged"] == total["ndt_flagged"]
    assert runs[name]["port"][1]["ndt_overflow"] == runs[name]["ref"][1]["ndt_overflow"]
    assert runs[name]["arena_stats"][0] == runs[name]["arena_stats"][1]
    assert runs[name]["ref"][2].miss_k == runs[name]["port"][2].miss_k
    assert runs[name]["miss_k"][0] == runs[name]["miss_k"][1]


def test_auto_miss_k_sizes_then_escalates(runs):
    """The default miss_k shrinks on the fourth batch, a later batch
    overflows it, and the drain after that batch escalates it: the same K
    per batch, the same overflow and the same final K as TpuNdtMap."""
    run = runs["auto_miss_k"]
    ks, stats = run["port"][2].miss_k, run["port"][2].stats
    assert ks[:4] == [1 << 16] * 4 and ks[4] == 4096
    first = next(i for i, s in enumerate(stats) if s["ndt_overflow"])
    assert first >= 4 and stats[first]["ndt_flagged"] > 4096
    assert ks[first + 1] > ks[first]
    assert run["miss_k"][0] == run["miss_k"][1] >= ks[-1] > 4096
    assert run["port"][1]["ndt_overflow"] == run["ref"][1]["ndt_overflow"] > 0


@pytest.mark.parametrize("name", SCENARIOS)
def test_wires_and_walk_keys_equal(runs, name):
    ref, port = runs[name]["ref"][2].wires, runs[name]["port"][2].wires
    assert len(ref) == len(port)
    for (w_r, _), (w_p, _) in zip(ref, port):
        assert np.array_equal(w_r, w_p)
    # The last batch's walk keys and voxel planes, from both packages' expand.
    wire, jcfg = ref[-1]
    pcfg = port[-1][1]
    assert {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(IntegrateConfig)} \
        == dataclasses.asdict(pcfg)
    ref_key, _, ref_aux = expand_pallas.expand_keys(
        _unpack_batch({"rayw": jnp.asarray(wire)}, jcfg), jcfg, with_vox=True, interpret=True)
    key, aux = expand_cuda.expand_keys(unpack_batch(torch.from_numpy(wire), pcfg), pcfg,
                                       with_vox=True)
    assert np.array_equal(np.asarray(ref_key), key.numpy())
    live = key.numpy() != pcfg.sentinel
    assert np.array_equal(np.asarray(ref_aux["vox"])[live], aux["vox"].numpy()[live])


@pytest.mark.parametrize("name", SCENARIOS)
def test_arenas_agree(runs, name):
    """The device arenas themselves, before the host sync: every layer over
    [0, sentinel], u32 layers as bit patterns."""
    ref, port = runs[name]["ref_arena"], runs[name]["port_arena"]
    assert ref.keys() == port.keys()
    n = port["occupancy"].shape[0]
    for layer, b in port.items():
        a = ref[layer][:n]
        if a.dtype == np.uint32:
            b = b.view(np.uint32)
            if layer == "mean_coord":
                act = ref["mean_count"][:n] > 0
                _assert_mean_codes(a[act], b[act])
            else:
                assert np.array_equal(a, b), layer
        else:
            assert np.array_equal(np.isinf(a), np.isinf(b)), layer
            fin = np.isfinite(a)
            np.testing.assert_allclose(b[fin], a[fin], **TOL)


@pytest.mark.parametrize("name", ["one_batch", "eviction", "exact", "tm"])
def test_port_matches_oracle(runs, name):
    """tests/test_ndt.py's tolerances: occupancy within 5e-3 on all but 4%
    of voxels, mean counts equal and covariance within 5e-3 on active
    voxels; NDT-TM intensity as test_ndt_tm_layers."""
    ref, port = _layers(runs[name]["oracle"]), _layers(runs[name]["port"][0])
    compared = failures = 0
    full = np.full(512, np.inf, np.float32)
    for key in set(ref) | set(port):
        a = ref[key]["occupancy"] if key in ref else full
        b = port[key]["occupancy"] if key in port else full
        inf_a, inf_b = np.isinf(a), np.isinf(b)
        compared += int((~inf_a | ~inf_b).sum())
        failures += int((inf_a != inf_b).sum())
        both = ~inf_a & ~inf_b
        failures += int((np.abs(a[both] - b[both]) > 5e-3).sum())
    assert compared > 100 and failures <= 0.04 * compared, (failures, compared)
    checked = 0
    for key, a in ref.items():
        b = port[key]
        assert np.array_equal(a["count"], b["count"])
        act = a["count"] > 0
        np.testing.assert_allclose(b["cov"][act], a["cov"][act], atol=5e-3)
        if "intensity" in a and act.any():
            np.testing.assert_allclose(b["intensity"][act, 0], a["intensity"][act, 0],
                                       rtol=1e-3, atol=1e-2)
            np.testing.assert_allclose(b["intensity"][act, 1], a["intensity"][act, 1],
                                       rtol=0.5, atol=0.3)
            ha, hb = a["hit_count"][act].astype(np.int64), b["hit_count"][act].astype(np.int64)
            assert np.abs(ha - hb).max() <= max(2, int(0.1 * ha.max()))
        checked += int(act.sum())
    assert checked > 0


def test_arena_from_reference_cuts_padding():
    """A reference NDT arena (+inf unobserved) with its scratch tail becomes
    a +inf-encoded port arena of capacity * V + 1 voxels; every layer keeps
    its bits, u32 layers as int32 bit patterns."""
    from ohm_tpu.mapping.arena import VoxelArena as RefArena

    ref = RefArena(4, 3, ["occupancy", "mean_coord", "mean_count", "cov"], scatter_pad=100)
    rng = np.random.default_rng(3)
    occ = np.asarray(ref.arrays["occupancy"]).copy()
    occ[:2048] = np.where(rng.random(2048) < 0.5, np.float32(np.inf),
                          rng.normal(0, 1, 2048).astype(np.float32))
    coord = rng.integers(0, 2**32, occ.shape[0], dtype=np.uint32)
    cov = rng.normal(0, 1, np.asarray(ref.arrays["cov"]).shape).astype(np.float32)
    arena = arena_from_reference({"occupancy": occ, "mean_coord": coord,
                                  "mean_count": np.asarray(ref.arrays["mean_count"]),
                                  "cov": cov},
                                 4, 3, torch.device("cpu"), directory=ref)
    n = 4 * 512 + 1
    assert arena.occupancy.shape == (n,) and arena.layers["cov"].shape == (n, 6)
    assert np.array_equal(arena.occupancy.numpy().view(np.uint32), occ[:n].view(np.uint32))
    assert np.array_equal(arena.layers["cov"].numpy(), cov[:n])
    assert arena.layers["mean_coord"].dtype == torch.int32
    assert np.array_equal(arena.layers["mean_coord"].numpy().view(np.uint32), coord[:n])
    assert arena.free_slots == ref.free_slots and arena.occupancy_encoding == "inf"
