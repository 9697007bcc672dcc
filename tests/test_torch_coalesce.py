"""The worker's coalesced and chained submission on the CPU
(TorchRayMapper._integrate_group, _upload, _chain_cfg, _dispatch_chain;
ops.integrate.integrate_chain): tests/test_rayflow.py:345-470 on the port.
Each holds the worker's result to synchronous integrate_rays calls bit for
bit: through a wire-length change and under eviction pressure (a pending
group's wires name slots, so an eviction flushes the group first), for
the NDT and TSDF mappers (which take the coalesced upload row by row), and
a full group chained under the split and under the fused apply."""

import numpy as np
import pytest

from ohm_tpu_torch import TorchNdtMap, TorchRayMapper, TorchTsdfMap
from ohm_tpu_torch.core.layout import (COVARIANCE_LAYER, OCCUPANCY_LAYER, TRAVERSAL_LAYER,
                                       TSDF_LAYER)
from ohm_tpu_torch.core.map import MapFlag, OccupancyMap
from ohm_tpu_torch.oracle.ndt import NdtParams


def _scene(n, rng):
    """Rays from the origin to the walls of a room (5.5 x 5.5 x 3 m half
    extents): they cross the 6.4 m regions at 0.2 m."""
    dirs = rng.normal(size=(n, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    t = np.min(np.where(dirs != 0, np.array([5.5, 5.5, 3.0]) / np.abs(dirs), np.inf), axis=1)
    rays = np.zeros((2 * n, 3))
    rays[1::2] = dirs * t[:, None]
    return rays


def _members(m, layer, members):
    i = m.layer_index(layer)
    return {(key, name): np.array(c.layers[i][name]) for key, c in m.chunks.items()
            for name in members}


def _assert_bits(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert np.array_equal(a[k].view(np.uint32), b[k].view(np.uint32)), k


class _Uploads:
    """Counts the rows of each coalesced upload."""

    def __init__(self, mapper):
        self.rows = []
        inner = mapper._upload

        def upload(wires):
            self.rows.append(len(wires))
            return inner(wires)

        mapper._upload = upload


def _run(batches, async_mode, capacity=64, flags=MapFlag.TRAVERSAL, cls=TorchRayMapper,
         validate=True, **kw):
    m = OccupancyMap(resolution=0.2, flags=flags)
    mapper = cls(m, capacity=capacity, validate=validate, device="cpu", rayflow=True, **kw)
    uploads = _Uploads(mapper)
    for b in batches:
        if async_mode:
            mapper.integrate_rays_async(b)
        else:
            mapper.integrate_rays(b)
    mapper.sync_voxels()
    return m, mapper, uploads


def test_coalesced_async_matches_sequential():
    """Bit for bit against sequential calls, through a mid-stream change of
    wire length (a 300-ray batch, 512 rows, among 96-ray ones, 256 rows)."""
    rng = np.random.default_rng(17)
    batches = [_scene(96, rng) for _ in range(7)]
    batches[3] = _scene(300, rng)
    members = {OCCUPANCY_LAYER: ("occupancy",), TRAVERSAL_LAYER: ("traversal",)}
    m_seq, mp_seq, up_seq = _run(batches, False)
    m_co, mp_co, up_co = _run(batches, True, validate=False)
    assert mp_co.stats["missed_updates"] == 0 and mp_co.stats["batches"] == 7
    assert up_seq.rows == [] and sum(up_co.rows) == 7
    for layer, names in members.items():
        _assert_bits(_members(m_seq, layer, names), _members(m_co, layer, names))


def test_group_of_queued_batches_goes_up_in_one_copy():
    """Batches queued together form one group (one upload of their stacked
    wires), flushed where the wire length changes."""
    rng = np.random.default_rng(19)
    batches = [_scene(96, rng) for _ in range(3)] + [_scene(300, rng)]
    m = OccupancyMap(resolution=0.2, flags=MapFlag.NONE)
    mapper = TorchRayMapper(m, capacity=64, validate=True, device="cpu", rayflow=True)
    uploads = _Uploads(mapper)
    mapper._integrate_group([(b, None, None, 0) for b in batches])
    assert uploads.rows == [3, 1]
    m_seq, _, _ = _run(batches, False, flags=MapFlag.NONE)
    mapper.sync_voxels()
    _assert_bits(_members(m_seq, OCCUPANCY_LAYER, ("occupancy",)),
                 _members(m, OCCUPANCY_LAYER, ("occupancy",)))


def test_coalesced_async_with_eviction_pressure():
    """A 12-slot arena and three disjoint clusters: allocations evict
    between queued batches, NeedsEviction flushes the pending group, and
    the map still equals sequential integration's."""
    rng = np.random.default_rng(23)
    centres = [np.array(c) for c in ((0.0, 0.0, 0.0), (40.0, 0.0, 0.0), (0.0, 40.0, 0.0))]
    batches = []
    for i in range(6):
        c = centres[i % 3]
        rays = np.empty((96, 3))
        rays[0::2] = c
        rays[1::2] = c + rng.uniform(-5, 5, (48, 3))
        batches.append(rays)
    m_seq, _, _ = _run(batches, False, capacity=12, flags=MapFlag.NONE)
    m_co, mp_co, _ = _run(batches, True, capacity=12, flags=MapFlag.NONE)
    assert mp_co.arena.stats["evictions"] > 0
    _assert_bits(_members(m_seq, OCCUPANCY_LAYER, ("occupancy",)),
                 _members(m_co, OCCUPANCY_LAYER, ("occupancy",)))


@pytest.mark.parametrize("kind", ["ndt", "tsdf"])
def test_coalesced_async_ndt_and_tsdf_match_sequential(kind):
    """The NDT and TSDF mappers take the coalesced upload row by row (their
    own device steps; no chain)."""
    rng = np.random.default_rng(31)
    batches = [_scene(64, rng) for _ in range(5)]
    if kind == "ndt":
        cls, kw = TorchNdtMap, dict(params=NdtParams())
        layer, names = COVARIANCE_LAYER, ("P00", "P01", "P11", "P02", "P12", "P22")
    else:
        cls, kw, layer, names = TorchTsdfMap, {}, TSDF_LAYER, ("weight", "distance")
    m_a, _, _ = _run(batches, False, flags=MapFlag.NONE, cls=cls, **kw)
    m_b, mp_b, up_b = _run(batches, True, flags=MapFlag.NONE, cls=cls, **kw)
    assert sum(up_b.rows) == 5 and mp_b._chain_cfg([(None, None, 64, 0)] * 4) is None
    for lay, mem in ((layer, names), (OCCUPANCY_LAYER, ("occupancy",))):
        _assert_bits(_members(m_a, lay, mem), _members(m_b, lay, mem))


@pytest.mark.parametrize("fused", ["0", "2"], ids=["split", "fused"])
def test_chained_dispatch_matches_sequential(fused, monkeypatch):
    """A full group after the sizing batches runs as one chain
    (integrate_chain: decode, expand and apply of each row in order), bit
    for bit the batches' own dispatches, traversal included."""
    monkeypatch.setenv("OHM_FUSED", fused)
    rng = np.random.default_rng(41)
    warm = [_scene(96, rng) for _ in range(4)]   # window-sizing batches
    group = [_scene(96, rng) for _ in range(4)]  # the chained group

    def run(chained):
        m = OccupancyMap(resolution=0.2, flags=MapFlag.TRAVERSAL)
        mapper = TorchRayMapper(m, capacity=64, validate=True, device="cpu", rayflow=True)
        for b in warm:
            mapper.integrate_rays(b)  # sizes row_cap and scatter_cap alike
        routes = []
        if chained:
            inner = mapper._dispatch_chain

            def counted(stacked, pending, cfg):
                routes.append(len(pending))
                inner(stacked, pending, cfg)
                routes.append(mapper.last_route)

            mapper._dispatch_chain = counted
            mapper._integrate_group([(b, None, None, 0) for b in group])
            assert routes[0] == len(group), "chain path not engaged"
        else:
            for b in group:
                mapper.integrate_rays(b)
                routes.append(mapper.last_route)
        mapper.sync_voxels()
        return m, mapper, routes

    m_c, mp_c, routes_c = run(True)
    m_s, mp_s, routes_s = run(False)
    want = "fused" if fused == "2" else "split"
    assert routes_c == [4, f"chain_{want}"] and routes_s == [want] * 4
    assert mp_c.stats == mp_s.stats
    for layer, names in ((OCCUPANCY_LAYER, ("occupancy",)), (TRAVERSAL_LAYER, ("traversal",))):
        _assert_bits(_members(m_c, layer, names), _members(m_s, layer, names))
