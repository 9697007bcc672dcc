"""Host half of the PyTorch port against the JAX package: the copied host
code (region table, rayflow wire, default ray filter) matches its source
text and output byte for byte, the config matches TpuRayMapper's, the
arena allocates and evicts like the reference arena, and the device wire
decode gives every field bit for bit."""

import dataclasses
import inspect

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ohm_tpu.core import filters as ref_filters
from ohm_tpu.core.map import MapFlag, OccupancyMap
from ohm_tpu.mapping import arena as ref_arena
from ohm_tpu.mapping import batch as ref_batch
from ohm_tpu.mapping.tpu_map import TpuRayMapper
from ohm_tpu.ops import regiontable as ref_table
from ohm_tpu.ops.integrate import _unpack_batch
from ohm_tpu_torch import TorchRayMapper
from ohm_tpu_torch.mapping import arena as port_arena
from ohm_tpu_torch.mapping import batch as port_batch
from ohm_tpu_torch.mapping import filters as port_filters
from ohm_tpu_torch.ops import regiontable as port_table
from ohm_tpu_torch.ops.config import IntegrateConfig
from ohm_tpu_torch.ops.wire import unpack_batch


def _rays(n, rng, origin=(0.0, 0.0, 0.0), spread=4.0):
    """Rays from one sensor pose (so start_frac dictionary-encodes)."""
    dirs = rng.normal(size=(n, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    rays = np.empty((2 * n, 3))
    rays[0::2] = origin
    rays[1::2] = np.asarray(origin) + dirs * rng.uniform(0.3, spread, n)[:, None]
    return rays


def _port_cfg(jcfg):
    """The port's config carrying the same values as a JAX config."""
    names = [f.name for f in dataclasses.fields(IntegrateConfig)]
    return IntegrateConfig(**{k: getattr(jcfg, k) for k in names})


@pytest.fixture(scope="module")
def prepared():
    """One batch prepared and allocated by both packages (same sequence)."""
    rays = _rays(200, np.random.default_rng(5))
    out = {}
    for name, batch_mod, arena in (
            ("ref", ref_batch, ref_arena.VoxelArena(64, 5, ["occupancy"], scatter_pad=0,
                                                    occupancy_encoding="zero")),
            ("port", port_batch, port_arena.VoxelArena(64, 5, torch.device("cpu")))):
        m = OccupancyMap(resolution=0.1, flags=MapFlag.NONE)
        rf = batch_mod.prepare_rayflow(m, rays)
        assert rf is not None
        arena.ensure_regions(rf.region_keys, host_map=m)
        out[name] = (batch_mod, rf, arena)
    assert len(out["ref"][1].region_keys) <= 255  # every cdict mode applies
    return out


CDICT_FDICT = [(c, f) for c in (0, 1, 2) for f in (False, True)]


def _wires(prepared, cdict, fdict):
    wires = []
    for batch_mod, rf, arena in (prepared["ref"], prepared["port"]):
        perm = batch_mod.snake_perm(rf.crossings, 64)
        fd = batch_mod.frac_dict_of(rf) if fdict else None
        if fdict:
            assert fd is not None
        wires.append(batch_mod.rayflow_wire(rf, arena.table, with_touch=False,
                                            with_intensity=False, cdict=cdict,
                                            fdict=fd, perm=perm))
    return wires, prepared["ref"][1].table_k


@pytest.mark.parametrize("cdict,fdict", CDICT_FDICT)
def test_rayflow_wire_bytes_match(prepared, cdict, fdict):
    (w_ref, w_port), _ = _wires(prepared, cdict, fdict)
    assert w_ref.dtype == w_port.dtype == np.uint8
    assert np.array_equal(w_ref, w_port)


@pytest.mark.parametrize("cdict,fdict", CDICT_FDICT)
def test_unpack_batch_bit_identical(prepared, cdict, fdict):
    (wire, _), table_k = _wires(prepared, cdict, fdict)
    m = OccupancyMap(resolution=0.1, flags=MapFlag.NONE)
    jcfg = dataclasses.replace(
        TpuRayMapper(m, capacity=64, rayflow=True)._config(0),
        table_k=table_k, rayw_cdict=cdict, rayw_fdict=fdict)
    ref = _unpack_batch({"rayw": jnp.asarray(wire)}, jcfg)
    port = unpack_batch(torch.from_numpy(wire), _port_cfg(jcfg))
    for name, val in port.items():
        a = np.asarray(ref[name])
        b = val.numpy()
        assert a.shape == b.shape, name
        if a.dtype == np.float32:
            a, b = a.view(np.uint32), b.view(np.uint32)
        assert np.array_equal(a, b.astype(a.dtype)), name


def test_unpack_ndt_wire_with_intensity_bit_identical():
    """The NDT wire: an intensity block after abs16, the source ray order
    from abs16's spare bits and end_frac, every field bit for bit."""
    from ohm_tpu.mapping.ndt_map import TpuNdtMap
    from ohm_tpu.oracle.ndt import NdtParams
    from ohm_tpu_torch import TorchNdtMap

    rng = np.random.default_rng(12)
    rays = _rays(300, rng, spread=5.0)
    intens = rng.uniform(0.0, 100.0, 300).astype(np.float32)
    ref = TpuNdtMap(OccupancyMap(resolution=0.1, flags=MapFlag.NONE),
                    NdtParams(ndt_tm=True), capacity=64)
    port = TorchNdtMap(OccupancyMap(resolution=0.1, flags=MapFlag.NONE),
                       NdtParams(ndt_tm=True), capacity=64, device="cpu")
    w_ref, c_ref, _ = ref._rayflow_setup_host(rays, None, intens, 0)
    w_port, c_port, _ = port._rayflow_setup_host(rays, None, intens, 0)
    assert np.array_equal(w_ref, w_port)
    assert c_ref.rayw_intensity and c_port.rayw_intensity
    jb = _unpack_batch({"rayw": jnp.asarray(w_ref)}, c_ref)
    pb = unpack_batch(torch.from_numpy(w_port), c_port)
    for name in ("intensity", "ray_order", "end_frac", "start_abs", "tcand", "valid"):
        a, b = np.asarray(jb[name]), pb[name].numpy()
        if a.dtype == np.float32:
            a, b = a.view(np.uint32), b.view(np.uint32)
        assert np.array_equal(a, b.astype(a.dtype)), name
    # Snake ordering permutes the rows; ray_order maps them back.
    order = pb["ray_order"].numpy()[pb["valid"].numpy()]
    assert sorted(order) == list(range(300)) and not np.array_equal(order, np.arange(300))
    assert np.array_equal(pb["intensity"].numpy()[pb["valid"].numpy()], intens[order])


def test_unpack_rejects_a_wire_of_the_wrong_layout(prepared):
    (wire, _), table_k = _wires(prepared, 1, True)
    m = OccupancyMap(resolution=0.1, flags=MapFlag.NONE)
    cfg = TorchRayMapper(m, capacity=64, device="cpu")._config(0, table_k=table_k)
    with pytest.raises(ValueError):
        unpack_batch(torch.from_numpy(wire), cfg)  # cdict 0 layout


def test_mapper_setup_wire_and_config_match():
    """The mappers' host setup over a batch sequence: the same cdict/fdict
    choice, snake order, caps and config, and the same wire bytes."""
    rng = np.random.default_rng(11)
    batches = [_rays(96, rng), _rays(160, rng, origin=(3.0, -2.0, 0.5), spread=6.0),
               _rays(64, rng)]
    m_ref = OccupancyMap(resolution=0.1, flags=MapFlag.NONE)
    m_port = OccupancyMap(resolution=0.1, flags=MapFlag.NONE)
    ref = TpuRayMapper(m_ref, capacity=64, rayflow=True)
    port = TorchRayMapper(m_port, capacity=64, device="cpu")
    ref.prime_caps(batches)
    port.prime_caps(batches)
    names = [f.name for f in dataclasses.fields(IntegrateConfig)]
    for flags, rays in zip((0, 4, 0), batches):
        w_ref, c_ref, n_ref = ref._rayflow_setup_host(rays, None, None, flags)
        w_port, c_port, n_port = port._rayflow_setup_host(rays, None, None, flags)
        assert n_ref == n_port
        assert np.array_equal(w_ref, w_port)
        assert {k: getattr(c_ref, k) for k in names} == dataclasses.asdict(c_port)
        assert c_ref.sentinel == c_port.sentinel
        assert c_ref.voxels_per_region == c_port.voxels_per_region
    assert ref.arena.slot_of == port.arena.slot_of


def test_copied_host_code_matches_its_source():
    pairs = [(ref_table.hash_region, port_table.hash_region),
             (ref_table.pack_ab, port_table.pack_ab)]
    for meth in ("__init__", "insert", "remove", "_grow", "lookup_np"):
        pairs.append((getattr(ref_table.HostRegionTable, meth),
                      getattr(port_table.HostRegionTable, meth)))
    for name in ("_next_bucket", "PreparedRayflow", "prepare_rayflow",
                 "snake_perm", "frac_dict_of", "rayflow_wire"):
        pairs.append((getattr(ref_batch, name), getattr(port_batch, name)))
    for ref, port in pairs:
        assert inspect.getsource(ref) == inspect.getsource(port), ref.__qualname__
    assert ref_table.PROBE_DEPTH == port_table.PROBE_DEPTH
    assert ref_table.EMPTY_AB == port_table.EMPTY_AB


def test_region_table_matches_under_churn():
    rng = np.random.default_rng(3)
    ref, port = ref_table.HostRegionTable(64), port_table.HostRegionTable(64)
    live = {}
    for step in range(600):
        if live and rng.random() < 0.4:
            key = list(live)[rng.integers(len(live))]
            assert ref.remove(key) == port.remove(key)
            del live[key]
        else:
            key = tuple(int(v) for v in rng.integers(-40, 40, 3))
            live[key] = int(rng.integers(0, 8000))
            ref.insert(key, live[key])
            port.insert(key, live[key])
        if step % 50 == 0:
            probe = rng.integers(-40, 40, (200, 3))
            probe[:len(live)] = list(live)[:200]
            assert np.array_equal(ref.lookup_np(probe), port.lookup_np(probe))
    assert ref.table_size == port.table_size > 64  # grew
    for a in ("ab", "z", "slot"):
        assert np.array_equal(getattr(ref, a), getattr(port, a))
    assert ref.count == port.count


def test_arena_allocation_and_eviction_match():
    """The same ensure_regions sequence gives the same slots, LRU victims,
    stats and CacheFull in both arenas."""
    rng = np.random.default_rng(8)
    ref = ref_arena.VoxelArena(8, 2, ["occupancy"], scatter_pad=0, occupancy_encoding="zero")
    port = port_arena.VoxelArena(8, 2, torch.device("cpu"))
    for _ in range(40):
        keys = rng.integers(-3, 3, (int(rng.integers(1, 7)), 3))
        keys = np.unique(keys, axis=0)
        outcome = []
        for arena in (ref, port):
            try:
                arena.ensure_regions(keys)
                outcome.append(None)
            except (ref_arena.CacheFull, port_arena.CacheFull):
                outcome.append("full")
        assert outcome[0] == outcome[1]
        assert ref.slot_of == port.slot_of
        assert ref.stats == port.stats
    assert port.stats["evictions"] > 0


def test_arena_occupancy_encoding_matches():
    rng = np.random.default_rng(2)
    host = rng.normal(0, 2, 4096).astype(np.float32)
    host[rng.random(4096) < 0.3] = np.inf
    host[:4] = [0.0, -0.0, np.inf, -np.inf]
    ref = ref_arena.VoxelArena(2, 2, ["occupancy"], scatter_pad=0, occupancy_encoding="zero")
    enc = port_arena.encode_occupancy(host)
    assert np.array_equal(enc.view(np.uint32), ref._encode_occupancy(host).view(np.uint32))
    dec = port_arena.decode_occupancy(enc)
    assert np.array_equal(dec.view(np.uint32), ref._decode_occupancy(enc).view(np.uint32))


def test_default_ray_filter_matches_reference():
    rng = np.random.default_rng(4)
    starts = rng.normal(size=(64, 3))
    ends = rng.normal(size=(64, 3)) * 10
    starts[3, 1] = np.nan
    ends[5, 2] = np.inf
    ends[7] = starts[7] + [3e10, 0, 0]
    for max_range in (0.0, 1e10):
        a = ref_filters.good_ray_filter(starts, ends, max_range)
        b = port_filters.good_ray_filter(starts, ends, max_range)
        for x, y in zip(a, b):
            assert x.dtype == y.dtype
            assert np.array_equal(x, y, equal_nan=x.dtype.kind == "f")
    m = OccupancyMap(resolution=0.1)
    port_filters.use_safe_default_filter(m)
    assert m.ray_filter is port_filters._default_filter

    def own(s, e):
        return ref_filters.clip_ray_filter(s, e, 5.0)
    m.ray_filter = own
    port_filters.use_safe_default_filter(m)
    assert m.ray_filter is own  # a filter the caller set stays
