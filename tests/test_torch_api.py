"""The port's public surface against the JAX package's, on the CPU:

  signatures   each mapper's constructor takes the reference's parameters,
               in its order, with its kinds and defaults; the port's own
               (``device``, and NDT's and TSDF's keyword-only knobs) follow
  None         ``rayflow=None`` reads OHM_RAYFLOW (unset or "1": the rayflow
               wire, one segment a ray; "0": the segmented wire) and
               ``stream_budget=None`` reads OHM_STREAM_BUDGET, for all three
               mappers (tpu_map.py:76-79,146-149)
  grouping     ``_rayflow_grouping`` reads OHM_RAYFLOW_G and OHM_SNAKE as the
               reference's does; G=8 without snake moves no occupancy bit
  O2           the port's counterparts of tests/test_tpu_integrate.py's
               test_stream_budget_presplit and test_group_compaction_exact,
               beside TpuRayMapper on the same batches
  scatter_cap  TorchTsdfMap's window: tests/test_tsdf.py's capped-against-
               uncapped run, the auto-sizing, and a pinned small cap on
               ``per_visit=False`` dropping what TpuTsdfMap drops
  exports      every public name of ``ohm_tpu`` and ``ohm_tpu.mapping`` has its
               counterpart in ``ohm_tpu_torch`` and ``ohm_tpu_torch.mapping``,
               imported with JAX blocked
  sharded      the sharded mappers take ``scatter_pad`` where the reference's
               do

tests/conftest.py sets OHM_RAYFLOW=0 for the run, so the reference's mappers
here take the segmented wire; the port's calls that need the rayflow wire
set it themselves.
"""

import ast
import inspect
import os
import subprocess
import sys

import numpy as np
import pytest

import ohm_tpu_torch
from ohm_tpu.core.layout import TSDF_LAYER
from ohm_tpu.core.map import MapFlag as RefFlag
from ohm_tpu.core.map import OccupancyMap as RefMap
from ohm_tpu.mapping.ndt_map import TpuNdtMap
from ohm_tpu.mapping.tpu_map import TpuRayMapper
from ohm_tpu.mapping.tsdf_map import TpuTsdfMap
from ohm_tpu.oracle.tsdf import TsdfOptions as RefTsdfOptions
from ohm_tpu.parallel import mapper as ref_parallel_mapper
from ohm_tpu.parallel import rayflow as ref_parallel_rayflow
from ohm_tpu_torch import (MapFlag, OccupancyMap, TorchNdtMap, TorchRayMapper,
                           TorchTsdfMap)
from ohm_tpu_torch.ops import integrate_tsdf as port_integrate_tsdf
from ohm_tpu_torch.oracle.tsdf import TsdfOptions
from ohm_tpu_torch.parallel import (ResidentShardedArena, ShardedRayFlowMapper,
                                    ShardedRayMapper, ShardMesh)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KNOBS = ("OHM_RAYFLOW", "OHM_STREAM_BUDGET", "OHM_RAYFLOW_G", "OHM_SNAKE")

#: (reference, port) constructors whose parameters must match.
PAIRS = {
    "occupancy": (TpuRayMapper, TorchRayMapper),
    "ndt": (TpuNdtMap, TorchNdtMap),
    "tsdf": (TpuTsdfMap, TorchTsdfMap),
    "sharded": (ref_parallel_mapper.ShardedRayMapper, ShardedRayMapper),
    "sharded_rayflow": (ref_parallel_rayflow.ShardedRayFlowMapper, ShardedRayFlowMapper),
    "resident_arena": (ref_parallel_mapper.ResidentShardedArena, ResidentShardedArena),
}
#: The port's parameters past the reference's, by pair.
PORT_EXTRAS = {"occupancy": ["device"], "ndt": ["device", "stream_budget", "rayflow"],
               "tsdf": ["device", "stream_budget", "rayflow"], "sharded": [],
               "sharded_rayflow": [], "resident_arena": []}


@pytest.fixture
def knobs(monkeypatch):
    """The knobs unset (their defaults); a test sets what it needs."""
    for name in KNOBS:
        monkeypatch.delenv(name, raising=False)
    return monkeypatch


def _box_rays(n, rng, half=(2.0, 2.0, 1.25)):
    """A box-room scan from the origin (tests/test_tpu_integrate.py's)."""
    dirs = rng.normal(size=(n, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    t = np.min(np.where(dirs != 0, np.asarray(half) / np.abs(dirs), np.inf), axis=1)
    rays = np.zeros((2 * n, 3))
    rays[1::2] = dirs * t[:, None]
    return rays


def _sphere_rays(n, rng, radius):
    """tests/test_tsdf.py's sphere_rays about the origin."""
    dirs = rng.normal(size=(n, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    rays = np.zeros((2 * n, 3))
    rays[1::2] = dirs * radius
    return rays


def _layer_bits(m, layer: str, member: str) -> dict:
    li = m.layer_index(layer)
    return {k: np.array(c.layers[li][member]).view(np.uint32) for k, c in m.chunks.items()}


def _layer(m, layer: str, member: str) -> dict:
    li = m.layer_index(layer)
    return {k: np.array(c.layers[li][member]) for k, c in m.chunks.items()}


def _assert_bits_equal(a: dict, b: dict) -> None:
    assert a.keys() == b.keys() and len(a) > 0
    for k in a:
        assert np.array_equal(a[k], b[k]), k


# ---------------------------------------------------------------- signatures


@pytest.mark.parametrize("pair", list(PAIRS))
def test_constructor_takes_the_reference_parameters_first(pair):
    ref_cls, port_cls = PAIRS[pair]
    ref = list(inspect.signature(ref_cls.__init__).parameters.values())[1:]
    port = list(inspect.signature(port_cls.__init__).parameters.values())[1:]
    assert [(p.name, p.kind, p.default) for p in port[:len(ref)]] == [
        (p.name, p.kind, p.default) for p in ref]
    assert [p.name for p in port[len(ref):]] == PORT_EXTRAS[pair]
    assert all(p.default is not inspect.Parameter.empty for p in port[len(ref):])


# ---------------------------------------------------------- the None defaults


def _make(kind: str, m, **kw):
    if kind == "ndt":
        return TorchNdtMap(m, None, 256, device="cpu", **kw)
    if kind == "tsdf":
        return TorchTsdfMap(m, None, 256, device="cpu", **kw)
    return TorchRayMapper(m, 256, device="cpu", **kw)


def _port_map():
    # 0.8 m regions: a ray of the scan crosses several, so the segmented
    # wire counts more segments than rays.
    return OccupancyMap(resolution=0.1, region_voxel_dims=8, flags=MapFlag.NONE)


@pytest.mark.parametrize("kind", ["occupancy", "ndt", "tsdf"])
@pytest.mark.parametrize("env", [None, "1", "0"], ids=["unset", "on", "off"])
def test_rayflow_none_reads_ohm_rayflow(knobs, kind, env):
    if env is not None:
        knobs.setenv("OHM_RAYFLOW", env)
    rays = _box_rays(96, np.random.default_rng(5))
    mapper = _make(kind, _port_map())
    assert mapper.rayflow == (env != "0")
    mapper.integrate_rays(rays)
    stats = mapper.stats
    assert stats["rays"] == 96
    if env == "0":
        assert stats["segments"] > 2 * stats["rays"]
    else:
        assert stats["segments"] == stats["rays"]
    knobs.setenv("OHM_RAYFLOW", "1" if env == "0" else "0")  # an explicit value wins
    assert _make(kind, _port_map(), rayflow=env != "0").rayflow == (env != "0")


@pytest.mark.parametrize("kind", ["occupancy", "ndt", "tsdf"])
def test_stream_budget_none_reads_ohm_stream_budget(knobs, kind):
    rays = _box_rays(300, np.random.default_rng(11))  # past the presplit's 256 rays
    member = {"occupancy": ("occupancy", "occupancy"), "ndt": ("occupancy", "occupancy"),
              "tsdf": (TSDF_LAYER, "distance")}[kind]
    maps, mappers = [], []
    for kw in (dict(), dict(stream_budget=1 << 21)):
        m = _port_map()
        mapper = _make(kind, m, rayflow=True, **kw)
        mapper.integrate_rays(rays)
        mapper.sync_voxels()
        maps.append(_layer_bits(m, *member))
        mappers.append(mapper)
    assert [mp.stream_budget for mp in mappers] == [1 << 21] * 2
    _assert_bits_equal(maps[0], maps[1])
    assert mappers[0].stats["batches"] == 1
    knobs.setenv("OHM_STREAM_BUDGET", "4000")  # the batch's estimate is over 4000
    small = _make(kind, _port_map(), rayflow=True)
    assert small.stream_budget == 4000
    small.integrate_rays(rays)
    assert small.stats["batches"] > 1 and small.stats["rays"] == 300
    assert _make(kind, _port_map(), stream_budget=0).stream_budget == 0


# ------------------------------------------------------------- the grouping


@pytest.mark.parametrize("snake", ["1", "0"], ids=["snake", "no_snake"])
@pytest.mark.parametrize("G", ["8", "16", "64", "128"])
def test_rayflow_grouping_reads_the_reference_knobs(knobs, G, snake):
    knobs.setenv("OHM_RAYFLOW_G", G)
    knobs.setenv("OHM_SNAKE", snake)
    for rpad in (8, 16, 24, 64, 96, 128, 256, 320, 1024, 8192):
        assert TorchRayMapper._rayflow_grouping(rpad) == TpuRayMapper._rayflow_grouping(rpad)


def test_rayflow_grouping_defaults(knobs):
    assert TorchRayMapper._rayflow_grouping(256) == (64, True)
    assert TorchRayMapper._rayflow_grouping(24) == (8, True)
    assert TorchRayMapper._rayflow_grouping(20) == (8, False)


def test_group_of_8_without_snake_moves_no_occupancy_bit(knobs):
    """One batch under OHM_RAYFLOW_G=8 OHM_SNAKE=0 against the defaults:
    the compaction groups 8 rays unpermuted, occupancy keeps its bits and
    traversal moves by reassociation only, within the reference's 1e-3
    (tests/test_tpu_integrate.py:357)."""
    rays = _box_rays(512, np.random.default_rng(7), half=(4.0, 4.0, 2.0))
    out = {}
    for env in ({}, {"OHM_RAYFLOW_G": "8", "OHM_SNAKE": "0"}):
        with pytest.MonkeyPatch.context() as mp:
            for k, v in env.items():
                mp.setenv(k, v)
            m = OccupancyMap(resolution=0.1, flags=MapFlag.TRAVERSAL)
            mapper = TorchRayMapper(m, 128, validate=True, device="cpu")
            cfgs, inner = [], mapper._dispatch

            def dispatch(upload, cfg, n_rays, n_segments=None, inner=inner, cfgs=cfgs):
                cfgs.append(cfg)
                return inner(upload, cfg, n_rays, n_segments)

            mapper._dispatch = dispatch
            mapper.integrate_rays(rays)
            mapper.sync_voxels()
        assert mapper.stats["segments"] == 512 and mapper.stats["compaction_dropped"] == 0
        out[bool(env)] = (m, cfgs[0].group_size)
    (m_def, g_def), (m_8, g_8) = out[False], out[True]
    assert (g_def, g_8) == (64, 8)
    _assert_bits_equal(_layer_bits(m_def, "occupancy", "occupancy"),
                       _layer_bits(m_8, "occupancy", "occupancy"))
    ta, tb = _layer(m_def, "traversal", "traversal"), _layer(m_8, "traversal", "traversal")
    assert ta.keys() == tb.keys()
    for k in ta:
        np.testing.assert_allclose(ta[k], tb[k], atol=1e-3)


# ------------------------------------------------ the reference's O2 tests


def _occupancy(m) -> dict:
    return _layer(m, "occupancy", "occupancy")


def compare_occupancy(cpu_map, gpu_map, tolerance=1e-4, allowed_failure_ratio=0.01):
    """tests/test_tpu_integrate.py's compare_occupancy: over the union of
    regions, a voxel fails where one side is unobserved and the other not
    or where both differ by more than ``tolerance``; at most
    ``allowed_failure_ratio`` of the observed voxels may fail."""
    a, b = _occupancy(cpu_map), _occupancy(gpu_map)
    full = np.full(int(np.prod(cpu_map.region_voxel_dims)), np.inf, np.float32)
    failures = processed = 0
    for key in set(a) | set(b):
        x, y = a.get(key, full), b.get(key, full)
        ix, iy = np.isinf(x), np.isinf(y)
        processed += int((~ix | ~iy).sum())
        failures += int((ix != iy).sum())
        both = ~ix & ~iy
        failures += int((np.abs(x[both] - y[both]) > tolerance).sum())
    assert processed > 0
    assert failures <= allowed_failure_ratio * processed, (failures, processed)


@pytest.fixture(scope="module")
def presplit_reference():
    """test_stream_budget_presplit's two reference runs (the segmented wire,
    as tests/conftest.py sets it): unsplit and under a 12000 budget."""
    rays = _box_rays(512, np.random.default_rng(47), half=(4.0, 4.0, 2.0))
    out = {}
    for budget in (0, 12000):
        m = RefMap(resolution=0.1, flags=RefFlag.NONE)
        ref = TpuRayMapper(m, capacity=256, stream_budget=budget, validate=True)
        ref.integrate_rays(rays)
        ref.sync_voxels()
        out[budget] = (m, ref._stats["batches"], ref._presplit_all([rays]))
    return rays, out


@pytest.mark.parametrize("rayflow", [False, True], ids=["segmented", "rayflow"])
def test_stream_budget_presplit(presplit_reference, rayflow):
    """A batch whose estimated record stream exceeds ``stream_budget`` is
    split in half before prep, and the result matches the unsplit mapper
    (tests/test_tpu_integrate.py:388-414), on each wire; the port splits
    where the reference does and matches its maps at the same tolerance."""
    rays, ref = presplit_reference
    runs = {}
    for budget in (0, 12000):
        m = OccupancyMap(resolution=0.1, flags=MapFlag.NONE)
        mapper = TorchRayMapper(m, capacity=256, stream_budget=budget, validate=True,
                                rayflow=rayflow, device="cpu")
        mapper.integrate_rays(rays)
        mapper.sync_voxels()
        runs[budget] = (m, mapper)
    (m_whole, whole), (m_split, split) = runs[0], runs[12000]
    assert split._stats["batches"] > whole._stats["batches"] >= 1
    assert split._stats["batches"] == ref[12000][1] and whole._stats["batches"] == ref[0][1]
    compare_occupancy(m_whole, m_split, tolerance=2e-4)
    for budget, (m, _) in runs.items():
        compare_occupancy(ref[budget][0], m, tolerance=2e-4)
    parts = split._presplit_all([rays])
    assert len(parts) >= 2
    assert sum(p.shape[0] for p in parts) == rays.reshape(-1, 3).shape[0]
    assert len(parts) == len(ref[12000][2]) and all(
        np.array_equal(a, b) for a, b in zip(parts, ref[12000][2]))


def _compaction_rays():
    rng = np.random.default_rng(7)
    n = 256
    dirs = rng.normal(size=(n, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    t = np.min(np.where(dirs != 0, np.array([4.0, 4.0, 2.0]) / np.abs(dirs), np.inf), axis=1)
    rays = np.zeros((2 * n, 3))
    rays[1::2] = dirs * t[:, None]
    return rays


def test_group_compaction_exact():
    """tests/test_tpu_integrate.py:325-358 on the port's segmented wire:
    compaction forced off through ``_group_cap`` leaves the live arena's
    occupancy bit-equal and traversal within 1e-3, and compaction drops
    nothing; beside TpuRayMapper on the same batches (the segmented wire,
    compaction on), the same arena bits and traversal within 1e-3."""
    rays = _compaction_rays()
    outs = []
    for force_off in (False, True):
        m = OccupancyMap(resolution=0.1, flags=MapFlag.TRAVERSAL)
        mp = TorchRayMapper(m, capacity=128, validate=True, rayflow=False, device="cpu")
        if force_off:
            mp._group_cap = lambda prepared: 0
        mp.integrate_rays(rays)
        mp.integrate_rays(rays)
        mp.sync_voxels()
        outs.append(mp)
    ref = TpuRayMapper(RefMap(resolution=0.1, flags=RefFlag.TRAVERSAL), capacity=128,
                       validate=True, rayflow=False)
    ref.integrate_rays(rays)
    ref.integrate_rays(rays)
    V = outs[0]._config(0).sentinel
    assert V == ref._config(0).sentinel
    occ = [mp.arena.layers["occupancy"][:V].numpy() for mp in outs]
    trav = [mp.arena.layers["traversal"][:V].numpy() for mp in outs]
    np.testing.assert_array_equal(occ[0], occ[1])
    np.testing.assert_allclose(trav[0], trav[1], atol=1e-3)
    assert outs[0].stats["compaction_dropped"] == 0
    assert outs[0]._cap_cache > 0  # compaction was on
    ref_occ = np.asarray(ref.arena.arrays["occupancy"])[:V]
    np.testing.assert_allclose(occ[0], ref_occ, atol=1e-5, rtol=0)
    assert np.array_equal(np.signbit(occ[0]) & (occ[0] == 0),
                          np.signbit(ref_occ) & (ref_occ == 0))  # unobserved alike
    np.testing.assert_allclose(trav[0], np.asarray(ref.arena.arrays["traversal"])[:V],
                               atol=1e-3)
    assert ref.stats["compaction_dropped"] == 0


# --------------------------------------------------------- TSDF scatter_cap


class _Windows:
    """Records each scatter_window call's (cap, stream length, dropped)."""

    def __init__(self, mp):
        self.calls = []
        inner = port_integrate_tsdf.scatter_window

        def window(mask, cap):
            out = inner(mask, cap)
            self.calls.append((cap, mask.shape[0], int(out[1])))
            return out

        mp.setattr(port_integrate_tsdf, "scatter_window", window)


@pytest.mark.parametrize("per_visit", [True, False], ids=["per_visit", "per_batch"])
def test_tsdf_capped_matches_uncapped_with_negative_distances(per_visit):
    """tests/test_tsdf.py:126-168 on the port, at 512-ray batches: a map
    holding negative distances, scatter_cap 0 against 4096 over six
    batches.  The per-visit route takes no window (the reference's kernel
    route); on the per-batch route the window engages (0 < cap < the
    record count) and drops nothing.  Both maps agree."""
    maps, caps_seen, windows = [], [], []
    for cap in (0, 4096):
        rng = np.random.default_rng(17)
        m = OccupancyMap(resolution=0.25, flags=MapFlag.NONE)
        with pytest.MonkeyPatch.context() as mp:
            rec = _Windows(mp)
            tsdf = TorchTsdfMap(m, TsdfOptions(default_truncation_distance=0.3,
                                               per_visit=per_visit),
                                capacity=64, validate=True, scatter_cap=cap, rayflow=True,
                                device="cpu")
            for k in range(6):
                tsdf.integrate_rays(_sphere_rays(512, rng, radius=1.2 + 0.3 * (k % 3)))
            tsdf.sync_voxels()
        assert tsdf.stats["dropped_updates"] == 0
        caps_seen.append(tsdf.scatter_cap)
        maps.append(m)
        windows.append(rec.calls)
    assert caps_seen == [0, 4096]
    if per_visit:
        assert windows == [[], []]
    else:
        assert len(windows[1]) == 6
        assert all(0 < cap < n_rec and dropped == 0 for cap, n_rec, dropped in windows[1])
        assert all(cap == 0 for cap, _, _ in windows[0])
    w0, w1 = (_layer(m, TSDF_LAYER, "weight") for m in maps)
    d0, d1 = (_layer(m, TSDF_LAYER, "distance") for m in maps)
    assert w0.keys() == w1.keys()
    checked, saw_negative = 0, False
    for key in w0:
        active = (w0[key] > 0) | (w1[key] > 0)
        saw_negative |= bool((d0[key][active] < -1e-3).any())
        np.testing.assert_allclose(w0[key][active], w1[key][active], rtol=1e-5, atol=1e-4)
        np.testing.assert_allclose(d0[key][active], d1[key][active], atol=1e-4)
        checked += int(active.sum())
    assert checked > 0
    assert saw_negative, "scene never produced negative distances"


@pytest.fixture(scope="module")
def tsdf_batches():
    rng = np.random.default_rng(23)
    return [_sphere_rays(200, rng, radius=1.2 + 0.3 * (k % 3)) for k in range(5)]


def test_tsdf_auto_scatter_cap_sizes_as_the_reference(tsdf_batches):
    """"auto" sizes from the fourth batch's touched count, 2x headroom, a
    power of two of at least 65536: after the same batches the port's
    scatter_cap reads the reference's."""
    caps = []
    for port in (False, True):
        if port:
            mapper = TorchTsdfMap(OccupancyMap(resolution=0.25, flags=MapFlag.NONE),
                                  capacity=64, validate=True, rayflow=False, device="cpu")
        else:
            mapper = TpuTsdfMap(RefMap(resolution=0.25, flags=RefFlag.NONE), capacity=64,
                                validate=True)
        seen = []
        for rays in tsdf_batches:
            mapper.integrate_rays(rays)
            seen.append(mapper.scatter_cap)
        caps.append(seen)
    assert caps[0] == caps[1] == [0, 0, 0, 1 << 16, 1 << 16]


def test_tsdf_pinned_cap_drops_what_the_reference_drops(tsdf_batches):
    """A pinned window below each batch's touched voxels on the
    ``per_visit=False`` route: the port drops and counts what TpuTsdfMap
    drops (both on the segmented wire), and their maps agree within the
    per-batch tolerance of tests/test_torch_tsdf_mapper.py (the jitted
    blocked sums move distances by up to 2.5e-4)."""
    cap = 600
    batches = tsdf_batches[:3]
    ref_m = RefMap(resolution=0.25, flags=RefFlag.NONE)
    ref = TpuTsdfMap(ref_m, RefTsdfOptions(default_truncation_distance=0.3, per_visit=False),
                     capacity=64, scatter_cap=cap)
    port_m = OccupancyMap(resolution=0.25, flags=MapFlag.NONE)
    port = TorchTsdfMap(port_m, TsdfOptions(default_truncation_distance=0.3, per_visit=False),
                        capacity=64, scatter_cap=cap, rayflow=False, device="cpu")
    for rays in batches:
        ref.integrate_rays(rays)
        port.integrate_rays(rays)
    ref.sync_voxels()
    port.sync_voxels()
    dropped = port.stats["dropped_updates"]
    assert dropped > 0 and dropped == ref.stats["dropped_updates"]
    assert port.scatter_cap == ref.scatter_cap == cap
    w_r, w_p = _layer(ref_m, TSDF_LAYER, "weight"), _layer(port_m, TSDF_LAYER, "weight")
    d_r, d_p = _layer(ref_m, TSDF_LAYER, "distance"), _layer(port_m, TSDF_LAYER, "distance")
    assert w_r.keys() == w_p.keys()
    for key in w_r:
        np.testing.assert_array_equal(w_r[key], w_p[key])
        np.testing.assert_allclose(d_p[key], d_r[key], atol=2.5e-4, rtol=0)
    with pytest.raises(RuntimeError, match="dropped_updates"):
        strict = TorchTsdfMap(OccupancyMap(resolution=0.25, flags=MapFlag.NONE),
                              TsdfOptions(default_truncation_distance=0.3, per_visit=False),
                              capacity=64, validate=True,
                              scatter_cap=cap, rayflow=False, device="cpu")
        for rays in batches:
            strict.integrate_rays(rays)


def test_scatter_window_keeps_the_first_rows_in_stream_order():
    import torch

    mask = torch.tensor([True, False, True, True, False, True, True])
    kept, dropped = port_integrate_tsdf.scatter_window(mask, 3)
    assert kept.tolist() == [True, False, True, True, False, False, False]
    assert int(dropped) == 2
    for cap in (0, 7, 9):  # no window: 0, or not below the stream length
        kept, dropped = port_integrate_tsdf.scatter_window(mask, cap)
        assert kept is mask and int(dropped) == 0


# ------------------------------------------------------------------ exports


def _reference_exports() -> dict:
    """The public names of ohm_tpu (its imports, and the lazily loaded save
    and load) and of ohm_tpu.mapping, by module, with Tpu renamed Torch."""
    out = {}
    for module, path in (("ohm_tpu_torch", "ohm_tpu/__init__.py"),
                         ("ohm_tpu_torch.mapping", "ohm_tpu/mapping/__init__.py")):
        with open(os.path.join(REPO, path)) as f:
            tree = ast.parse(f.read())
        names = [a.asname or a.name for n in tree.body if isinstance(n, ast.ImportFrom)
                 for a in n.names]
        if module == "ohm_tpu_torch":
            names += ["save", "load"]
        out[module] = sorted(n.replace("TpuRayMapper", "TorchRayMapper") for n in names)
    return out


_EXPORTS_SCRIPT = """
import importlib, sys
sys.modules["jax"] = None  # any import of jax now raises ImportError
exports = {exports!r}
for module, names in exports.items():
    mod = importlib.import_module(module)
    for name in names:
        assert name in mod.__all__, (module, name)
        exec(f"from {{module}} import {{name}}")
from ohm_tpu_torch import OccupancyMap, MapFlag, RayFlag, save, load
from ohm_tpu_torch.core.map import OccupancyMap as _Map
from ohm_tpu_torch.io import save as _save
assert OccupancyMap is _Map and save is _save
print(sorted(n for n in sys.modules if n.startswith(("jax.", "ohm_tpu."))
             or n in ("ohm_tpu", "triton")))
"""


def test_the_reference_exports_import_with_jax_blocked():
    exports = _reference_exports()
    assert {"OccupancyMap", "MapFlag", "RayFlag", "save", "load",
            "default_layout"} <= set(exports["ohm_tpu_torch"])
    assert exports["ohm_tpu_torch.mapping"] == ["TorchRayMapper", "VoxelArena"]
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", _EXPORTS_SCRIPT.format(exports=exports)],
                         capture_output=True, text=True, cwd=REPO, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
    assert set(exports["ohm_tpu_torch"]) <= set(ohm_tpu_torch.__all__)


# ------------------------------------------------------------------ sharded


def test_sharded_mappers_take_scatter_pad():
    """The reference tests' forms (tests/test_sharded.py:202,247,
    tests/test_sharded_rayflow.py:70,106) construct and integrate on a CPU
    mesh; the positional form puts scatter_pad fifth, as the reference
    does, and the occupancy equals the single-device mapper's bit for
    bit."""
    mesh = ShardMesh.repeat("cpu", 2)
    rng = np.random.default_rng(29)
    batches = []
    for _ in range(2):
        rays = rng.uniform(-6, 6, (2 * 96, 3))
        rays[0::2] *= 0.05
        batches.append(rays)
    m_ref = OccupancyMap(resolution=0.25, flags=MapFlag.NONE)
    single = TorchRayMapper(m_ref, capacity=512, rayflow=True, device="cpu")
    for rays in batches:
        single.integrate_rays(rays)
    single.sync_voxels()
    want = _layer_bits(m_ref, "occupancy", "occupancy")
    for cls in (ShardedRayMapper, ShardedRayFlowMapper):
        m = OccupancyMap(resolution=0.25, flags=MapFlag.NONE)
        sh = cls(m, mesh, capacity=64, scatter_pad=1 << 16, validate=True)
        assert sh.scatter_pad == 1 << 16 and sh.validate is True
        for rays in batches:
            sh.integrate_rays(rays)
        sh.sync_voxels()
        _assert_bits_equal(_layer_bits(m, "occupancy", "occupancy"), want)
        positional = cls(OccupancyMap(resolution=0.25, flags=MapFlag.NONE), mesh,
                         "occupancy", 64, 1 << 16, True)
        assert (positional.scatter_pad, positional.validate) == (1 << 16, True)
    arena = ResidentShardedArena(mesh, 16, 5, ["occupancy"], 1 << 16)
    assert arena.scatter_pad == 1 << 16 and arena.occupancy_encoding == "zero"
