"""The fused row-local apply (ops.integrate.apply_records_fused and the NDT
fused deposit) on the CPU: tests/test_fused_apply.py's five cases on the
port, each against the port's split apply and against the JAX package's
mappers under the same OHM_FUSED.

OHM_FUSED=2 forces the fused apply wherever row_cap is sized (from the
fourth batch), OHM_FUSED=0 keeps the split one.  Occupancy is held bit for
bit (the counts are integers), row_cap after every batch and the dropped
updates equal to the reference's.  Traversal differs from the split apply
by f32 reassociation only, held to the reference's own 2e-4
(tests/test_fused_apply.py:77): the blocked segment sums' rounding scales
with the in-row prefix, here up to ~5e-5.  The NDT differential holds
occupancy within 1e-5 (the jitted reference contracts into FMAs).

Scenes: box scans from the centre of a room (half extents 4 x 4 x 2 m),
0.1 m voxels (NDT: 0.2 m), region dims 8, 384 rays a batch, six batches;
the reference keeps its split deposit uncapped (scatter_cap=0).
"""

import numpy as np
import pytest

from ohm_tpu.core.layout import OCCUPANCY_LAYER, TRAVERSAL_LAYER
from ohm_tpu.core.map import MapFlag, OccupancyMap
from ohm_tpu.core.rayflags import RayFlag
from ohm_tpu.mapping.ndt_map import TpuNdtMap
from ohm_tpu.mapping.tpu_map import TpuRayMapper
from ohm_tpu.oracle.ndt import NdtParams
from ohm_tpu_torch import TorchNdtMap, TorchRayMapper
from ohm_tpu_torch.core.map import OccupancyMap as PortMap
from ohm_tpu_torch.oracle.ndt import NdtParams as PortNdtParams

N_BATCHES = 6
TRAV_ATOL = 2e-4


def _box_rays(n, rng, half=(4.0, 4.0, 2.0)):
    dirs = rng.normal(size=(n, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    t = np.min(np.asarray(half) / np.abs(dirs), axis=1)
    rays = np.zeros((2 * n, 3))
    rays[1::2] = dirs * t[:, None]
    return rays


def _batches(seed, n=384):
    rng = np.random.default_rng(seed)
    return [_box_rays(n, rng) for _ in range(N_BATCHES)]


def _layer(m, name):
    i = m.layer_index(name)
    return {k: c.layers[i][name].copy() for k, c in m.chunks.items()} if i >= 0 else None


def _run(port, fused, batches, flags=0, map_flags=MapFlag.NONE, rayflow=True, ndt=False,
         row_cap_at=None):
    """Integrate ``batches`` under OHM_FUSED=``fused`` (the port's mapper on
    the CPU, or the JAX package's); ``row_cap_at`` = (batch, cap) pins
    row_cap before that batch.  Returns (occupancy, traversal, row_cap after
    each batch and after the last drain, the routes taken, stats)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OHM_FUSED", fused)
        res = 0.2 if ndt else 0.1
        m = (PortMap if port else OccupancyMap)(resolution=res, region_voxel_dims=8,
                                                flags=int(map_flags))
        validate = row_cap_at is None
        if ndt:
            params = (PortNdtParams if port else NdtParams)()
            kw = dict(device="cpu") if port else {}
            mapper = (TorchNdtMap if port else TpuNdtMap)(m, params, capacity=1024,
                                                          validate=validate, **kw)
            mapper.rayflow = rayflow
        elif port:
            mapper = TorchRayMapper(m, capacity=1024, validate=validate, device="cpu",
                                    rayflow=rayflow)
        else:
            mapper = TpuRayMapper(m, capacity=1024, validate=validate, rayflow=rayflow,
                                  scatter_cap=0)
        mapper.prime_caps(batches)
        caps, routes = [], []
        for i, rays in enumerate(batches):
            if row_cap_at is not None and i == row_cap_at[0]:
                mapper.row_cap = row_cap_at[1]
            mapper.integrate_rays(rays, ray_update_flags=int(flags))
            caps.append(mapper.row_cap)
            routes.append(getattr(mapper, "last_route", None))
        mapper.sync_voxels()
        stats = mapper.stats
        caps.append(mapper.row_cap)  # after the drain's escalation
    return _layer(m, OCCUPANCY_LAYER), _layer(m, TRAVERSAL_LAYER), caps, routes, stats


def _assert_bits(a, b):
    assert a.keys() == b.keys()
    for key in a:
        x, y = a[key].view(np.uint32), b[key].view(np.uint32)
        assert np.array_equal(x, y), (key, np.flatnonzero(x != y)[:8])


def _assert_close(a, b, atol):
    assert a.keys() == b.keys()
    for key in a:
        assert np.array_equal(np.isinf(a[key]), np.isinf(b[key])), key
        fin = np.isfinite(a[key])
        assert np.abs(a[key][fin] - b[key][fin]).max(initial=0.0) <= atol, key


@pytest.fixture(scope="module")
def box_runs():
    """Port fused/split and reference fused, on each wire."""
    out = {}
    for rayflow in (True, False):
        batches = _batches(7)
        out[rayflow] = {name: _run(port, fused, batches, rayflow=rayflow)
                        for name, port, fused in (("split", True, "0"), ("fused", True, "2"),
                                                  ("ref", False, "2"))}
    return out


@pytest.mark.parametrize("rayflow", [False, True], ids=["segmented", "rayflow"])
def test_fused_bit_identical_occupancy(box_runs, rayflow):
    split, fused = box_runs[rayflow]["split"], box_runs[rayflow]["fused"]
    assert fused[2][-1] > 0, "fused path never activated"
    assert fused[3][:3] == ["split"] * 3 and fused[3][3:] == ["fused"] * 3
    assert split[3] == ["split"] * N_BATCHES
    _assert_bits(split[0], fused[0])


@pytest.mark.parametrize("rayflow", [False, True], ids=["segmented", "rayflow"])
def test_fused_matches_reference(box_runs, rayflow):
    """OHM_FUSED=2 in both packages: occupancy bits, row_cap after every
    batch and the stats (dropped_updates included) equal."""
    fused, ref = box_runs[rayflow]["fused"], box_runs[rayflow]["ref"]
    _assert_bits(fused[0], ref[0])
    assert fused[2] == ref[2]
    for name in ("rays", "segments", "batches", "missed_updates", "overflow",
                 "dropped_updates", "compaction_dropped"):
        assert fused[4][name] == ref[4][name], name


def test_fused_traversal_reassociation_only():
    batches = _batches(11)
    flags = MapFlag.VOXEL_MEAN | MapFlag.TRAVERSAL
    split = _run(True, "0", batches, map_flags=flags)
    fused = _run(True, "2", batches, map_flags=flags)
    ref = _run(False, "2", batches, map_flags=flags)
    assert fused[3][-1] == "fused" and fused[2] == ref[2]
    _assert_bits(split[0], fused[0])
    _assert_bits(fused[0], ref[0])
    _assert_close(split[1], fused[1], TRAV_ATOL)
    _assert_close(fused[1], ref[1], TRAV_ATOL)


FLAG_MATRIX = (RayFlag.END_POINT_AS_FREE,
               RayFlag.EXCLUDE_ORIGIN | RayFlag.EXCLUDE_SAMPLE,
               RayFlag.EXCLUDE_FREE,
               RayFlag.EXCLUDE_OCCUPIED | RayFlag.EXCLUDE_UNOBSERVED)


@pytest.mark.parametrize("flags", FLAG_MATRIX, ids=lambda f: f"flags{int(f)}")
def test_fused_flag_matrix_bit_identical(flags):
    """Fused against split across the ray flags (the exclusions run partly
    in the expand, partly in the sweep both applies share), and against the
    reference's fused apply."""
    batches = _batches(29)[:5]
    split = _run(True, "0", batches, flags=flags)
    fused = _run(True, "2", batches, flags=flags)
    ref = _run(False, "2", batches, flags=flags)
    assert fused[2][-1] > 0 and fused[3][-1] == "fused"
    _assert_bits(split[0], fused[0])
    _assert_bits(fused[0], ref[0])
    assert fused[2] == ref[2]


def test_fused_ndt_bit_identical_occupancy():
    """NDT with traversal (where the reference's fused std-count deposit
    runs): fused against the port's K3 path bit for bit, and against
    TpuNdtMap under OHM_FUSED=2 within 1e-5, with the same row_cap after
    every batch and the same dropped updates."""
    rng = np.random.default_rng(13)
    batches = [_box_rays(384, rng) for _ in range(N_BATCHES)]
    kw = dict(ndt=True, map_flags=MapFlag.TRAVERSAL)
    split = _run(True, "0", batches, **kw)
    fused = _run(True, "2", batches, **kw)
    ref = _run(False, "2", batches, **kw)
    assert fused[2][-1] > 0, "fused NDT deposit never activated"
    assert "fused" in fused[3] and set(split[3]) == {"k3"}
    _assert_bits(split[0], fused[0])
    assert fused[2] == ref[2]
    assert fused[4]["dropped_updates"] == ref[4]["dropped_updates"] == 0
    _assert_close(fused[0], ref[0], 1e-5)
    _assert_close(split[1], fused[1], TRAV_ATOL)
    _assert_close(fused[1], ref[1], TRAV_ATOL)


def test_fused_row_cap_overflow_counts_drops():
    """A row_cap far below the sized budget drops voxel-lasts, counted in
    dropped_updates; both packages drop the same ones (each row's highest
    ids) and escalate row_cap alike."""
    batches = _batches(3)[:5]
    port = _run(True, "1", batches, row_cap_at=(4, 8))
    ref = _run(False, "1", batches, row_cap_at=(4, 8))
    assert port[3][-1] == "fused"
    assert port[4]["dropped_updates"] > 0
    assert port[4]["dropped_updates"] == ref[4]["dropped_updates"]
    assert port[2] == ref[2] and port[2][-1] == 16  # escalated once, on drain
    _assert_bits(port[0], ref[0])
