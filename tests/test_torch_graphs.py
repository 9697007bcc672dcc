"""The worker's captured graphs on the CPU (mapping.graphs.GraphCache,
TorchRayMapper._dispatch_group and _graph_key), with a stand-in for the
CUDA capture: where the graph engages and where the group stays eager, the
key's parts, the cache's bound, a new epoch, a capture that raises, the
kernel launches a capture takes back and a replay counts, and the map the
replays leave, bit for bit the eager worker's.

The stand-in cannot defer the work as a CUDA graph does: its capture runs
the body, the replay the mapper issues right after is skipped, and a later
replay runs the body again, reading the static input the upload has just
overwritten and writing its stats into the captured ones."""

import numpy as np
import pytest
import torch

from ohm_tpu_torch import TorchNdtMap, TorchRayMapper, TorchTsdfMap
from ohm_tpu_torch.core.map import MapFlag, OccupancyMap
from ohm_tpu_torch.mapping import graphs
from ohm_tpu_torch.mapping.graphs import CAPTURE, EAGER, REPLAY, GraphCache
from ohm_tpu_torch.ops import deposit_cuda, expand_cuda
from ohm_tpu_torch.utils.profile import Profile


class FakeGraph:
    def __init__(self, body, out):
        self.body, self.out, self.fresh = body, out, True

    def replay(self):
        if self.fresh:  # the capture already ran the body
            self.fresh = False
            return
        self.out.copy_(self.body())


class FakeCapture:
    """CudaCapture's call on the CPU; ``fail`` raises as a capture that
    meets an operation a graph cannot hold.  A body that raises leaves the
    arena's ``layers`` as they were, as a capture launches nothing."""

    def __init__(self, layers, fail=False):
        self.layers = layers
        self.fail = fail

    def __call__(self, body):
        if self.fail:
            raise RuntimeError("operation not permitted when stream is capturing")
        before = {k: v.clone() for k, v in self.layers.items()}
        try:
            out = body()
        except Exception:
            for k, v in before.items():
                self.layers[k].copy_(v)
            raise
        return FakeGraph(body, out), out


def _scene(n, rng):
    """Rays from the origin to the walls of a room (5.5 x 5.5 x 3 m half
    extents), at 0.2 m."""
    dirs = rng.normal(size=(n, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    t = np.min(np.where(dirs != 0, np.array([5.5, 5.5, 3.0]) / np.abs(dirs), np.inf), axis=1)
    rays = np.zeros((2 * n, 3))
    rays[1::2] = dirs * t[:, None]
    return rays


BATCHES = [_scene(96, np.random.default_rng(23 + i)) for i in range(16)]


def _mapper(kind="occupancy", graphs=True, fail=False, flags=MapFlag.NONE, **kw):
    """A CPU mapper on the rayflow wire, primed on BATCHES, with a graph
    cache over the stand-in capture (``graphs``)."""
    m = OccupancyMap(resolution=0.2, flags=flags)
    kw = {"capacity": 64, "device": "cpu", "rayflow": True, **kw}
    if kind == "ndt":
        mapper = TorchNdtMap(m, miss_k="exact", **kw)
    elif kind == "tsdf":
        mapper = TorchTsdfMap(m, **kw)
    else:
        mapper = TorchRayMapper(m, **kw)
    mapper.prime_caps(BATCHES)
    if graphs:
        mapper.graphs = GraphCache(FakeCapture(mapper.arena.layers, fail))
    return m, mapper


def _groups(mapper, batches, size=4):
    """``batches`` through the worker's group path, ``size`` a group (on
    this thread, so that the groups are the same on every run)."""
    for i in range(0, len(batches), size):
        mapper._integrate_group([(b, None, None, 0) for b in batches[i:i + size]])


def _sized(mapper):
    """Four synchronous batches: the auto-sized windows are read."""
    for b in BATCHES[:4]:
        mapper.integrate_rays(b)


def _host_bits(m):
    return {(k, i): np.ascontiguousarray(layer).tobytes()
            for k, c in m.chunks.items() for i, layer in enumerate(c.layers)}


def _counts(mapper):
    g = mapper.graphs
    return (g.captures, g.replays, g.fallbacks) if g is not None else None


def _rule_cpu_device(monkeypatch):
    # On the CPU the mapper has no graph cache: every group runs eagerly.
    _, mapper = _mapper(graphs=False)
    assert mapper.graphs is None
    _sized(mapper)
    _groups(mapper, BATCHES[4:12])
    assert mapper._graph_key([(np.zeros(8, np.uint8), None, 96, 0, 0)], None) is None
    assert mapper.last_route in ("chain_fused", "chain_split")


def _rule_validate(monkeypatch):
    _, mapper = _mapper(validate=True)
    _sized(mapper)
    _groups(mapper, BATCHES[4:16])
    assert _counts(mapper) == (0, 0, 0) and not mapper.graphs._seen


def _rule_segmented(monkeypatch):
    # rayflow=False: every batch takes the segmented wire's synchronous path.
    _, mapper = _mapper(rayflow=False)
    _groups(mapper, BATCHES[:12])
    assert _counts(mapper) == (0, 0, 0) and not mapper.graphs._seen


def _rule_monolith(monkeypatch):
    monkeypatch.setenv("OHM_MONOLITH", "1")
    _, mapper = _mapper()
    _groups(mapper, BATCHES[:12])
    assert mapper.last_route == "monolith"
    assert _counts(mapper) == (0, 0, 0) and not mapper.graphs._seen


def _rule_synchronous(monkeypatch):
    _, mapper = _mapper()
    for b in BATCHES[:12]:
        mapper.integrate_rays(b)
    assert _counts(mapper) == (0, 0, 0) and not mapper.graphs._seen


def _rule_sizing_pending(monkeypatch):
    # The first batches read the windows back (row_cap, scatter_cap): eager.
    _, mapper = _mapper()
    _groups(mapper, BATCHES[:3], size=1)
    assert mapper.row_cap == 0 and _counts(mapper) == (0, 0, 0) and not mapper.graphs._seen
    _groups(mapper, BATCHES[3:4], size=1)
    assert mapper.row_cap > 0 and mapper.scatter_cap > 0
    _groups(mapper, BATCHES[4:6], size=1)
    assert mapper.graphs.captures == 1


def _rule_second_sighting(monkeypatch):
    m, mapper = _mapper()
    ref_m, ref = _mapper(graphs=False)
    for mp in (mapper, ref):
        _sized(mp)
    _groups(mapper, BATCHES[4:8])
    assert _counts(mapper) == (0, 0, 0) and len(mapper.graphs._seen) == 1
    _groups(mapper, BATCHES[8:12])
    assert _counts(mapper) == (1, 4, 0)
    route = mapper.last_route
    _groups(mapper, BATCHES[12:16])
    assert _counts(mapper) == (1, 8, 0) and mapper.last_route == route
    _groups(ref, BATCHES[4:16])
    mapper.sync_voxels()
    ref.sync_voxels()
    assert mapper.stats == ref.stats and mapper.stats["batches"] == 16
    assert _host_bits(m) == _host_bits(ref_m)


def _pending(mapper, batches):
    """A pending group of ``batches``, as the worker holds it."""
    out = []
    for b in batches:
        wire, cfg, n = mapper._rayflow_setup_host(np.asarray(b), None, None, 0)
        out.append((wire, cfg, n, 0, 0))
    return out


def _rule_key_parts(monkeypatch):
    # The occupancy mapper, row by row and chained: row_cap, through the
    # route (the fused apply, forced) and the chain's resolved config.
    monkeypatch.setenv("OHM_FUSED", "2")
    _, occ = _mapper()
    _sized(occ)
    group = _pending(occ, BATCHES[4:8])
    cfg = occ._chain_cfg(group)
    rows, chain = occ._graph_key(group, None), occ._graph_key(group, cfg)
    assert rows is not None and rows == occ._graph_key(list(group), None)
    assert chain[2] == ("chain", cfg) and cfg.row_cap > 0 and chain != rows
    occ.row_cap //= 2
    assert occ._graph_key(group, None) != rows
    assert occ._graph_key(group, occ._chain_cfg(group)) != chain
    occ.row_cap *= 2
    assert occ._graph_key(group, None) == rows
    # The wire's byte length and the chain length.
    longer = [(np.concatenate([p[0], np.zeros(256, np.uint8)]),) + p[1:] for p in group]
    assert occ._graph_key(longer, None) != rows
    assert occ._graph_key(group[:3], None) != rows
    # An arena layer moved.
    layer = next(iter(occ.arena.layers))
    occ.arena.layers[layer] = occ.arena.layers[layer].clone()
    assert occ._graph_key(group, None) != rows
    # NDT's miss-phase K.
    _, ndt = _mapper(kind="ndt")
    _sized(ndt)
    group = _pending(ndt, BATCHES[4:6])
    key = ndt._graph_key(group, None)
    assert key is not None
    ndt.miss_k = 1 << 12
    assert ndt._graph_key(group, None) != key


def _rule_lru(monkeypatch):
    cache = GraphCache(FakeCapture({}))
    static = torch.zeros(1)
    for k in range(9):
        assert cache.step(k) == (EAGER, None)
        assert cache.step(k) == (CAPTURE, None)
        assert cache.capture(k, static, lambda: torch.zeros(1, 4, dtype=torch.int64)) is not None
        assert cache.step(k)[0] == REPLAY
    assert GraphCache.capacity == 8 and len(cache) == 8 and cache.captures == 9
    assert cache.step(0) == (EAGER, None)  # the least recently used went first
    assert all(cache.step(k)[0] == REPLAY for k in range(1, 9))


def _rule_new_epoch(monkeypatch):
    # A new epoch drops every graph and every key seen once; eager keys stay.
    cache = GraphCache(FakeCapture({}))
    static = torch.zeros(1)
    for k in range(3):
        cache.step(k, "a")
        assert cache.step(k, "a") == (CAPTURE, None)
        cache.capture(k, static, lambda: torch.zeros(1, 4, dtype=torch.int64))
    cache.step(3, "a")
    cache._eager[4] = True
    assert len(cache) == 3 and cache.step(0, "b") == (EAGER, None) and len(cache) == 0
    assert cache.step(3, "b") == (EAGER, None) and cache.step(4, "b") == (EAGER, None)
    assert cache.step(0, "b") == (CAPTURE, None)
    # The mappers' epochs: row_cap, scatter_cap, the arena's addresses, NDT's K.
    _, occ = _mapper()
    _sized(occ)
    epoch = occ._graph_epoch()
    occ.row_cap *= 2
    assert occ._graph_epoch() != epoch
    occ.row_cap //= 2
    occ.scatter_cap *= 2
    assert occ._graph_epoch() != epoch
    occ.scatter_cap //= 2
    layer = next(iter(occ.arena.layers))
    occ.arena.layers[layer] = occ.arena.layers[layer].clone()
    assert occ._graph_epoch() != epoch
    _, ndt = _mapper(kind="ndt")
    _sized(ndt)
    epoch = ndt._graph_epoch()
    ndt.miss_k = 1 << 12
    assert ndt._graph_epoch() != epoch
    # Through the worker: doubling row_cap, as an escalation does, drops the
    # group's graph; the key is captured again at its second sighting.
    _, mapper = _mapper()
    _sized(mapper)
    _groups(mapper, BATCHES[4:12])
    assert _counts(mapper) == (1, 4, 0) and len(mapper.graphs) == 1
    mapper.row_cap *= 2
    _groups(mapper, BATCHES[4:8])
    assert len(mapper.graphs) == 0 and _counts(mapper) == (1, 4, 0)
    _groups(mapper, BATCHES[8:12])
    assert len(mapper.graphs) == 1 and _counts(mapper) == (2, 8, 0)


def _rule_launch_counts(monkeypatch):
    # The kernel wrappers count at the call: a capture's calls launch
    # nothing and are taken back, a replay adds them, a capture that raises
    # leaves the counts as they were.
    k1, k2 = expand_cuda.expand_keys, deposit_cuda.deposit_and_sweep
    assert {k1, k2} <= set(graphs._COUNTED)
    monkeypatch.setattr(k1, "launches", 5)
    monkeypatch.setattr(k2, "launches", 7)

    def body():
        k1.launches += 2  # as two calls of the wrapper count
        k2.launches += 1
        return torch.zeros(1, 4, dtype=torch.int64)

    cache = GraphCache(FakeCapture({}))
    entry = cache.capture("k", torch.zeros(1), body)
    assert (k1.launches, k2.launches) == (5, 7)
    assert sorted(n for _, n in entry.launches) == [1, 2]
    cache.replay(entry)  # the stand-in's first replay runs nothing: the capture ran it
    assert (k1.launches, k2.launches) == (7, 8)

    def raises():
        body()
        raise RuntimeError("operation not permitted when stream is capturing")

    assert cache.capture("r", torch.zeros(1), raises) is None
    assert (k1.launches, k2.launches) == (7, 8) and cache.fallbacks == 1


def _rule_capture_raises(monkeypatch):
    m, mapper = _mapper(fail=True)
    ref_m, ref = _mapper(graphs=False)
    for mp in (mapper, ref):
        _sized(mp)
        _groups(mp, BATCHES[4:16])
    assert _counts(mapper) == (0, 0, 1) and mapper.graphs.capacity == 8
    assert len(mapper.graphs._eager) == 1 and len(mapper.graphs) == 0
    mapper.sync_voxels()
    ref.sync_voxels()
    assert _host_bits(m) == _host_bits(ref_m)


def _rule_host_read_in_capture(monkeypatch):
    # The traversal layer's compaction reads a count back (a Profile.sync
    # scope): the capture stops there, and the key stays eager.
    m, mapper = _mapper(flags=MapFlag.TRAVERSAL)
    ref_m, ref = _mapper(graphs=False, flags=MapFlag.TRAVERSAL)
    for mp in (mapper, ref):
        _sized(mp)
        _groups(mp, BATCHES[4:16])
    assert _counts(mapper) == (0, 0, 1)
    assert not Profile.instance()._tls.__dict__.get("forbid_syncs")
    mapper.sync_voxels()
    ref.sync_voxels()
    assert _host_bits(m) == _host_bits(ref_m)


RULES = {
    "cpu_device": _rule_cpu_device,
    "validate": _rule_validate,
    "segmented_wire": _rule_segmented,
    "monolith": _rule_monolith,
    "synchronous_path": _rule_synchronous,
    "sizing_pending": _rule_sizing_pending,
    "second_sighting_captures": _rule_second_sighting,
    "key_parts": _rule_key_parts,
    "lru_bound": _rule_lru,
    "new_epoch": _rule_new_epoch,
    "launch_counts": _rule_launch_counts,
    "capture_raises": _rule_capture_raises,
    "host_read_in_capture": _rule_host_read_in_capture,
}


@pytest.mark.parametrize("rule", list(RULES))
def test_graph_engagement(rule, monkeypatch):
    """One engagement rule of the worker's graphs."""
    RULES[rule](monkeypatch)


@pytest.mark.parametrize("kind", ["ndt", "tsdf"])
def test_replayed_rows_leave_the_eager_map(kind):
    """The NDT and TSDF mappers' groups (row by row, no chain) replayed:
    the eager worker's map and stats, bit for bit."""
    m, mapper = _mapper(kind)
    ref_m, ref = _mapper(kind, graphs=False)
    for mp in (mapper, ref):
        _sized(mp)
        _groups(mp, BATCHES[4:16])
    assert _counts(mapper) == (1, 8, 0)
    mapper.sync_voxels()
    ref.sync_voxels()
    assert mapper.stats == ref.stats
    assert _host_bits(m) == _host_bits(ref_m)
