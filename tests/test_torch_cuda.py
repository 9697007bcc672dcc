"""The port's CUDA kernels against their plain PyTorch versions, on the card
(marker ``cuda``; skipped where torch sees no CUDA device).  Keys, voxel
planes, missed counts, gathered flags, occupancy bits and touched counts
must be identical, at the bench shape: 8192 box-scene rays, a 512-slot
arena of 32^3 regions; the f32 gather and the TSDF pair deposit bit for
bit over -0.0, infinities and NaN payloads; the expand kernel's traversal
output bit for bit on every lane; the five deposit probes, the one-hot
probe on random records (also against bincount), and the slot-grid deposit
(on the probe's bench-shaped stream, its edge streams and a ragged tail,
and on a second run) bit for bit, the slot-grid deposit and K3 equal to
the scatter yardstick; the
expand kernel's in-kernel prelude (overflow, the end voxel's enter time)
against the plain prelude on every wire layout and on edge rays; the fused
NDT flag gather against its plain version at the NDT-OM arena; the
run-length deposits K2 and K3 on the streams their design makes risky
(ohm_tpu_torch.testing's edge streams), bit for bit and the same bits on a
second run; the fused TSDF per-visit update (K5+K6) on its edge streams,
bit for bit and the same bits on a second run; and the K1, K2, K4 and
fused TSDF wrappers issuing no PyTorch op but their outputs' or scratch
allocations.
TorchNdtMap (with and without its side layers, on both wires), TorchTsdfMap
and TorchRayMapper with the side layers on the card must agree with
themselves on the CPU and give the same bits on every run, and so must the
queries (RaysQuery, LineKeysQuery, ClearanceProcess); so must TorchRayMapper on
the segmented wire, its STOP_ON_FIRST_OCCUPIED monolith included, with K2
launched and K1 not; and ShardedRayFlowMapper on four shards of the card,
bit for bit TorchRayMapper's occupancy, with K1 and K2 on every shard.  The
loops the port's benches time through the asynchronous worker
(timed_integration, integrate_frame) leave the map the same synchronous
calls leave, bit for bit, for occupancy, TSDF and NDT-TM.  The worker's
groups replayed from captured CUDA graphs (mapping.graphs) leave the eager
worker's map, drained stats and kernel launch counts bit for bit, for every
mapper kind, through a row_cap escalation that forces a recapture.

This file imports no JAX, so it also runs where JAX is not installed:
    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""

import dataclasses

import numpy as np
import pytest
import torch

from ohm_tpu_torch import TorchNdtMap, TorchRayMapper, TorchTsdfMap
from ohm_tpu_torch.core.map import MapFlag, OccupancyMap
from ohm_tpu_torch.core.rayflags import RayFlag
from ohm_tpu_torch.oracle.ndt import NdtParams
from ohm_tpu_torch.oracle.tsdf import TsdfOptions
from ohm_tpu_torch.ops import probes_cuda
from ohm_tpu_torch.ops.deposit_cuda import (
    deposit_and_sweep, deposit_and_sweep_ndt, deposit_and_sweep_ndt_reference,
    deposit_and_sweep_reference, tsdf_set_deposit, tsdf_set_deposit_reference)
from ohm_tpu_torch.mapping import graphs as worker_graphs
from ohm_tpu_torch.mapping.batch import frac_dict_of, prepare_rayflow, rayflow_wire
from ohm_tpu_torch.ops.expand_cuda import _prelude, expand_keys, expand_keys_reference
from ohm_tpu_torch.ops.gather_cuda import (
    gather_ndt_flags, gather_ndt_flags_reference, gather_plane, gather_plane_reference,
    gather_planes_f32, gather_planes_f32_reference)
from ohm_tpu_torch.ops.integrate import expand_records
from ohm_tpu_torch.ops.slotgrid_cuda import (scatter_deposit, slotgrid_deposit,
                                             slotgrid_deposit_reference)
from ohm_tpu_torch.ops.wire import unpack_batch
from ohm_tpu_torch.scripts import probe_deposit as pd
from ohm_tpu_torch.ops.tsdf_cuda import tsdf_visits, tsdf_visits_reference
from ohm_tpu_torch.testing import (BENCH_WORKER_KINDS, DEPOSIT_EDGE_STREAMS, NDT_EDGE_STREAMS,
                                   PROBE_LIBRARY_CALLS, TSDF_VISIT_STREAMS, bench_worker_maps,
                                   deposit_edge_stream, dispatched_ops, edge_rays,
                                   fused_traversal_atol, map_bytes,
                                   ndt_edge_streams, ndt_flag_arena, tsdf_visit_stream)

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _box_rays(n, rng, half=(10.0, 10.0, 5.0)):
    dirs = rng.normal(size=(n, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    t = np.min(np.asarray(half) / np.abs(dirs), axis=1)
    rays = np.zeros((2 * n, 3))
    rays[1::2] = dirs * t[:, None]
    return rays


@pytest.fixture(scope="module")
def bench_batch(cuda):
    rays = _box_rays(8192, np.random.default_rng(2024))
    mapper = TorchRayMapper(OccupancyMap(resolution=0.1, flags=MapFlag.NONE),
                            capacity=512, device=cuda, rayflow=True)
    wire, cfg, _ = mapper._rayflow_setup_host(rays, None, None, 0)
    return mapper, unpack_batch(torch.from_numpy(wire).to(cuda), cfg), cfg


@pytest.mark.parametrize("exclude_origin", [False, True])
@pytest.mark.parametrize("corrupt", [False, True])
def test_expand_kernel_matches_plain(bench_batch, exclude_origin, corrupt):
    _, b, cfg = bench_batch
    if corrupt:  # records in the dropped candidate's region miss
        b = dict(b, tcand=b["tcand"].clone())
        b["tcand"][::2, 0] = 0
    key, aux = expand_keys(b, cfg, exclude_origin=exclude_origin)
    ref_key, ref_missed = expand_keys_reference(b, cfg, exclude_origin=exclude_origin)
    torch.cuda.synchronize()
    assert torch.equal(key, ref_key)
    assert int(aux["missed_n"]) == int(ref_missed)
    assert (int(ref_missed) > 0) == corrupt


@pytest.mark.parametrize("flags", [0, int(RayFlag.EXCLUDE_FREE), int(RayFlag.EXCLUDE_OCCUPIED),
                                   int(RayFlag.EXCLUDE_UNOBSERVED)])
def test_deposit_kernel_matches_plain(bench_batch, flags):
    mapper, b, cfg = bench_batch
    cfg = dataclasses.replace(cfg, ray_flags=flags)
    key_s = torch.sort(expand_records(b, cfg)[0]["key"]).values
    rng = np.random.default_rng(flags)
    occ = np.full(cfg.sentinel + 1, np.float32(-0.0), np.float32)
    seeded = rng.integers(0, cfg.sentinel, cfg.sentinel // 8)
    occ[seeded] = rng.normal(0.0, 2.0, seeded.size).astype(np.float32)
    occ = torch.from_numpy(occ).to(key_s.device)
    out, touched = deposit_and_sweep(occ.clone(), key_s, cfg)
    ref_out, ref_touched = deposit_and_sweep_reference(occ.clone(), key_s, cfg)
    torch.cuda.synchronize()
    assert torch.equal(out.view(torch.int32), ref_out.view(torch.int32))
    assert int(touched) == int(ref_touched) > 0


def _arena(cfg, device, unobserved, seed):
    """A batch-start arena of ``cfg.sentinel + 1`` voxels: ``unobserved``
    (-0.0 or +inf) but on an eighth of them, some at the clamp bounds."""
    rng = np.random.default_rng(seed)
    occ = np.full(cfg.sentinel + 1, np.float32(unobserved), np.float32)
    seeded = rng.integers(0, cfg.sentinel, cfg.sentinel // 8)
    occ[seeded] = rng.normal(0.0, 2.0, seeded.size).astype(np.float32)
    occ[seeded[:500]] = np.float32(cfg.max_value)
    occ[seeded[500:1000]] = np.float32(cfg.min_value)
    return torch.from_numpy(occ).to(device)


@pytest.mark.parametrize("name", DEPOSIT_EDGE_STREAMS)
def test_deposit_kernel_matches_plain_on_edge_streams(bench_batch, name):
    """The run-length kernel at the bench arena (512 slots x 32768 voxels)
    on the streams its design makes risky: bit for bit against the plain
    version, the touched count equal, and two runs give the same bits."""
    _, b, cfg = bench_batch
    keys = torch.from_numpy(deposit_edge_stream(name, cfg.sentinel)).to(b["valid"].device)
    occ = _arena(cfg, keys.device, -0.0, seed=11)
    out, touched = deposit_and_sweep(occ.clone(), keys, cfg)
    again, touched_again = deposit_and_sweep(occ.clone(), keys, cfg)
    ref_out, ref_touched = deposit_and_sweep_reference(occ.clone(), keys, cfg)
    torch.cuda.synchronize()
    assert torch.equal(out.view(torch.int32), ref_out.view(torch.int32))
    assert torch.equal(again.view(torch.int32), out.view(torch.int32))
    assert int(touched) == int(ref_touched) == int(touched_again)
    assert (int(touched) > 0) == (name not in ("empty", "all_sentinel"))


@pytest.mark.parametrize("bounds", [True, False], ids=["bounds", "sorted_here"])
@pytest.mark.parametrize("form", ["sparse", "dense"])
@pytest.mark.parametrize("name", NDT_EDGE_STREAMS)
def test_ndt_deposit_kernel_matches_plain_on_edge_streams(bench_batch, name, form, bounds):
    """K3 at the bench arena on its edge streams (K2's, end-only voxels,
    delta-only voxels, +-0.0 deltas, a delta behind zero-valued records),
    end keys shuffled, the walk with its bounds (masked records a prefix of
    each run) or sorted by the wrapper: bit for bit against the plain
    version, the touched count equal, two runs the same bits."""
    _, b, cfg = bench_batch
    dev = b["valid"].device
    st = {k: torch.from_numpy(v).to(dev) for k, v in ndt_edge_streams(name, cfg.sentinel).items()}
    end = st["end"][torch.randperm(st["end"].numel(), device=dev)]
    delta = (st["dkeys"], st["dvals"]) if form == "sparse" else st["plane"]
    kw = {"bounds_key": st["bounds"]} if bounds else {}
    occ = _arena(cfg, dev, np.inf, seed=12)
    out, touched = deposit_and_sweep_ndt(occ.clone(), st["walk"], end, delta, cfg, **kw)
    again, touched_again = deposit_and_sweep_ndt(occ.clone(), st["walk"], end, delta, cfg, **kw)
    ref_out, ref_touched = deposit_and_sweep_ndt_reference(occ.clone(), st["walk"], end, delta,
                                                           cfg)
    torch.cuda.synchronize()
    assert torch.equal(out.view(torch.int32), ref_out.view(torch.int32))
    assert torch.equal(again.view(torch.int32), out.view(torch.int32))
    assert int(touched) == int(ref_touched) == int(touched_again)


def test_mapper_on_card_matches_cpu(cuda):
    rays = _box_rays(1024, np.random.default_rng(7))
    occ = []
    for device in (cuda, "cpu"):
        m = OccupancyMap(resolution=0.1, flags=MapFlag.NONE)
        mapper = TorchRayMapper(m, capacity=512, validate=True, device=device, rayflow=True)
        mapper.integrate_rays(rays)
        mapper.sync_voxels()
        oi = m.layer_index("occupancy")
        occ.append({k: c.layers[oi]["occupancy"].view(np.uint32).copy()
                    for k, c in m.chunks.items()})
    assert occ[0].keys() == occ[1].keys()
    for k in occ[0]:
        assert np.array_equal(occ[0][k], occ[1][k])


def test_segmented_mapper_on_card_matches_cpu(cuda):
    """rayflow=False on a box scan, then clearing batches (the monolith):
    the card's map bit-identical to the CPU's, and to a second card run;
    K2 launched on the card, K1 never."""
    from ohm_tpu_torch.ops import deposit_cuda, expand_cuda

    rng = np.random.default_rng(7)
    scan = _box_rays(1024, rng)
    clear = _box_rays(1024, rng, half=(11.0, 11.0, 5.5))
    flags = int(RayFlag.END_POINT_AS_FREE | RayFlag.STOP_ON_FIRST_OCCUPIED
                | RayFlag.EXCLUDE_FREE | RayFlag.EXCLUDE_UNOBSERVED)
    occ = []
    for device in (cuda, cuda, "cpu"):
        expand_cuda.expand_keys.launches = deposit_cuda.deposit_and_sweep.launches = 0
        m = OccupancyMap(resolution=0.1, flags=MapFlag.NONE)
        mapper = TorchRayMapper(m, capacity=512, validate=True, rayflow=False, device=device)
        mapper.integrate_rays(scan)
        mapper.integrate_rays(clear, ray_update_flags=flags)
        mapper.sync_voxels()
        if device != "cpu":
            assert expand_cuda.expand_keys.launches == 0
            assert deposit_cuda.deposit_and_sweep.launches == mapper.stats["batches"] == 2
        oi = m.layer_index("occupancy")
        occ.append({k: c.layers[oi]["occupancy"].view(np.uint32).copy()
                    for k, c in m.chunks.items()})
    assert occ[0].keys() == occ[1].keys() == occ[2].keys() and len(occ[0]) > 0
    for k in occ[0]:
        assert np.array_equal(occ[0][k], occ[1][k]) and np.array_equal(occ[0][k], occ[2][k])


@pytest.mark.parametrize("exclude_origin", [False, True])
def test_expand_voxel_planes_match_plain(bench_batch, exclude_origin):
    _, b, cfg = bench_batch
    key, aux = expand_keys(b, cfg, exclude_origin=exclude_origin, with_vox=True)
    ref_key, _, ref_vox = expand_keys_reference(b, cfg, exclude_origin=exclude_origin,
                                                with_vox=True)
    torch.cuda.synchronize()
    live = ref_key != cfg.sentinel
    assert torch.equal(key, ref_key)
    assert int(live.sum()) > 100_000
    assert torch.equal(aux["vox"][live], ref_vox[live])


def _ndt_inputs(cfg, device, seed):
    """A +inf-encoded arena, a masked sorted walk stream, unsorted end keys,
    a sparse miss delta (one value per voxel, some zero) and its plane."""
    rng = np.random.default_rng(seed)
    n = cfg.sentinel
    occ = np.full(n + 1, np.inf, np.float32)
    seeded = rng.integers(0, n, n // 8)
    occ[seeded] = rng.normal(0.0, 2.0, seeded.size).astype(np.float32)
    occ[seeded[:1000]] = np.float32(cfg.max_value)
    flat = np.sort(rng.integers(0, n, 600_000))
    walk = np.where(rng.random(flat.size) < 0.2, n, flat) << 1
    end = (rng.integers(0, n, 8192) << 1) | (rng.random(8192) < 0.7)
    dk = np.sort(np.concatenate([rng.choice(flat, 20_000), np.full(500, n)]))
    last = np.concatenate([dk[1:] != dk[:-1], [True]]) & (dk < n)
    dv = np.where(last & (rng.random(dk.size) < 0.9), rng.normal(0, 0.3, dk.size), 0.0)
    plane = np.zeros(n + 1, np.float32)
    plane[dk[last]] = dv[last]
    t = [torch.from_numpy(np.ascontiguousarray(x)).to(device) for x in (
        occ, walk.astype(np.int32), end.astype(np.int32), (dk << 1).astype(np.int32),
        dv.astype(np.float32), plane)]
    return t[0], t[1], t[2], (t[3], t[4]), t[5]


@pytest.mark.parametrize("form", ["sparse", "dense"])
def test_ndt_deposit_kernel_matches_plain(bench_batch, form):
    _, _, cfg = bench_batch
    occ, walk, end, sparse, plane = _ndt_inputs(cfg, bench_batch[1]["start_abs"].device, 5)
    delta = sparse if form == "sparse" else plane
    out, touched = deposit_and_sweep_ndt(occ.clone(), walk, end, delta, cfg)
    ref_out, ref_touched = deposit_and_sweep_ndt_reference(occ.clone(), walk, end, delta, cfg)
    torch.cuda.synchronize()
    assert torch.equal(out.view(torch.int32), ref_out.view(torch.int32))
    assert int(touched) == int(ref_touched) > 0


def test_gather_kernel_matches_plain(bench_batch):
    _, _, cfg = bench_batch
    rng = np.random.default_rng(8)
    dev = bench_batch[1]["start_abs"].device
    plane = torch.from_numpy((rng.random(cfg.sentinel + 1) < 0.3).astype(np.int8)).to(dev)
    ids = np.concatenate([np.sort(rng.integers(0, cfg.sentinel, 1_000_000)),
                          np.full(50_000, cfg.sentinel)]).astype(np.int32)
    ids = torch.from_numpy(ids).to(dev)
    # 16-byte vectors, and with a scalar tail (n % 4 == 3); ids that do not
    # start on a 16-byte boundary are refused.
    for part in (ids, ids[:-1]):
        out = gather_plane(plane, part, cfg.sentinel)
        ref = gather_plane_reference(plane, part, cfg.sentinel)
        torch.cuda.synchronize()
        assert torch.equal(out, ref) and int(out.sum()) > 0
    with pytest.raises(ValueError, match="aligned"):
        gather_plane(plane, ids[1:], cfg.sentinel)


@pytest.mark.parametrize("threshold", [3, 1, 0])
def test_ndt_flag_gather_matches_plain(cuda, threshold):
    cfg = TorchNdtMap(OccupancyMap(resolution=0.2, flags=MapFlag.NONE), capacity=1024,
                      device=cuda, rayflow=True)._config(0)
    rng = np.random.default_rng(30 + threshold)
    occ, count = ndt_flag_arena(cfg.sentinel + 1, cfg.sentinel, rng, 50_000, 50_000)
    occ, count = torch.from_numpy(occ).to(cuda), torch.from_numpy(count.view(np.int32)).to(cuda)
    ids = np.concatenate([np.sort(rng.integers(0, cfg.sentinel, 600_000)),
                          np.full(40_001, cfg.sentinel)]).astype(np.int32)
    ids = torch.from_numpy(ids).to(cuda)
    for part in (ids, ids[:-2], ids[4:-1]):
        out = gather_ndt_flags(occ, count, part, threshold, cfg.sentinel)
        ref = gather_ndt_flags_reference(occ, count, part, threshold, cfg.sentinel)
        torch.cuda.synchronize()
        assert torch.equal(out, ref)
        assert 0 < int(out.sum()) < part.numel() - 40_000
    with pytest.raises(ValueError, match="aligned"):
        gather_ndt_flags(occ, count, ids[3:], threshold, cfg.sentinel)
    out = gather_ndt_flags(occ, count, ids, threshold, cfg.sentinel)
    real = ids[:600_000].long()
    nan_or_big = (torch.isnan(occ[real]) & (count[real] >= threshold)) | (
        (count[real] < 0) & ~torch.isposinf(occ[real]))
    assert int(nan_or_big.sum()) > 200 and bool((out[:600_000][nan_or_big] == 1).all())


def test_k1_and_k4_wrappers_issue_only_their_allocations(bench_batch):
    _, b, cfg = bench_batch
    ops = dispatched_ops(lambda: expand_keys(b, cfg, with_trav=True, with_vox=True))
    assert ops and set(ops) <= {"empty", "empty_strided"}, ops
    ids = torch.sort(expand_keys(b, cfg)[0].reshape(-1)).values
    occ = torch.full((cfg.sentinel + 1,), float("inf"), device=ids.device)
    count = torch.zeros(cfg.sentinel + 1, dtype=torch.int32, device=ids.device)
    plane = torch.zeros(cfg.sentinel + 1, dtype=torch.int8, device=ids.device)
    for fn in (lambda: gather_ndt_flags(occ, count, ids, 3, cfg.sentinel),
               lambda: gather_plane(plane, ids, cfg.sentinel)):
        ops = dispatched_ops(fn)
        assert ops and set(ops) <= {"empty_like", "empty", "empty_strided"}, ops


def test_deposit_wrappers_issue_only_their_scratch(bench_batch):
    """K2's and K3's wrappers (K3 with the walk's bounds, as the mappers call
    it) issue no PyTorch op but one allocation (the touched count, or K3's
    table) and the view of its count."""
    _, b, cfg = bench_batch
    dev = b["valid"].device
    keys = torch.from_numpy(deposit_edge_stream("block_edges", cfg.sentinel)).to(dev)
    st = {k: torch.from_numpy(v).to(dev)
          for k, v in ndt_edge_streams("delta_last", cfg.sentinel).items()}
    occ = _arena(cfg, dev, -0.0, seed=13)
    for fn in (lambda: deposit_and_sweep(occ, keys, cfg),
               lambda: deposit_and_sweep_ndt(occ, st["walk"], st["end"],
                                             (st["dkeys"], st["dvals"]), cfg,
                                             bounds_key=st["bounds"])):
        ops = dispatched_ops(fn)
        assert ops and set(ops) <= {"empty", "select"} and ops.count("empty") == 1, ops


def _ndt_run(device, tm, rng_seed=6):
    """tests/test_ndt.py's plane-then-through scene on TorchNdtMap."""
    rng = np.random.default_rng(rng_seed)
    n = 200
    build = np.empty((2 * n, 3))
    build[0::2] = (0.0, 0.0, 2.0)
    build[1::2] = np.column_stack([rng.uniform(-1, 1, n), rng.uniform(-1, 1, n),
                                   rng.normal(0, 0.005, n)])
    through = np.empty((120, 3))
    through[0::2] = (0.0, 0.0, 2.0)
    through[1::2] = np.column_stack([rng.uniform(-0.8, 0.8, 60), rng.uniform(-0.8, 0.8, 60),
                                     np.full(60, -0.8)])
    m = OccupancyMap(resolution=0.25, flags=MapFlag.NONE)
    mapper = TorchNdtMap(m, NdtParams(ndt_tm=tm), capacity=64, validate=True, device=device,
                         rayflow=True)
    for rays in [build[i:i + 50] for i in range(0, 400, 50)] + [through[:60], through[60:]]:
        mapper.integrate_rays(rays, intensities=rng.uniform(10, 20, len(rays) // 2))
    mapper.sync_voxels()
    layers = {}
    for key, c in m.chunks.items():
        for li, layer in enumerate(c.layers):
            for f in layer.dtype.names:
                layers[(key, li, f)] = np.array(layer[f])
    return layers, mapper.stats


@pytest.mark.parametrize("tm", [False, True])
def test_ndt_mapper_on_card_matches_cpu(cuda, tm):
    card, stats = _ndt_run(cuda, tm)
    card2, _ = _ndt_run(cuda, tm)
    cpu, cpu_stats = _ndt_run("cpu", tm)
    assert stats == cpu_stats and stats["ndt_flagged"] > 0 and stats["ndt_overflow"] == 0
    assert card.keys() == card2.keys() == cpu.keys()
    for k in card:
        assert np.array_equal(card[k].view(np.uint32), card2[k].view(np.uint32)), k
        a, b = card[k], cpu[k]
        if a.dtype == np.float32:
            fin = np.isfinite(b)
            assert np.array_equal(fin, np.isfinite(a)), k
            np.testing.assert_allclose(a[fin], b[fin], atol=1e-5, rtol=1e-5)
        elif k[2] == "coord":
            assert (a == b).mean() >= 0.999
        else:
            assert np.array_equal(a, b), k


def _ndt_layers_run(device, tm: bool, rayflow: bool):
    """_ndt_run's scene on a map with traversal, touch time and incident
    normal, a timestamp per ray, on either wire."""
    rng = np.random.default_rng(6)
    m = OccupancyMap(resolution=0.25, flags=MapFlag.TRAVERSAL | MapFlag.TOUCH_TIME
                     | MapFlag.INCIDENT_NORMAL)
    mapper = TorchNdtMap(m, NdtParams(ndt_tm=tm), capacity=64, validate=True, device=device,
                         rayflow=rayflow)
    for i in range(6):
        rays = np.empty((120, 3))
        rays[0::2] = (0.0, 0.0, 2.0)
        z = rng.normal(0, 0.005, 60) if i < 4 else np.full(60, -0.8)
        rays[1::2] = np.column_stack([rng.uniform(-1, 1, 60), rng.uniform(-1, 1, 60), z])
        mapper.integrate_rays(rays, intensities=rng.uniform(10, 20, 60),
                              timestamps=10.0 + i + np.arange(60) * 1e-3)
    mapper.sync_voxels()
    layers = {(key, li, f): np.array(layer[f]) for key, c in m.chunks.items()
              for li, layer in enumerate(c.layers) for f in layer.dtype.names}
    return layers, mapper.stats


@pytest.mark.parametrize("tm", [False, True])
@pytest.mark.parametrize("rayflow", [True, False])
def test_ndt_layers_mapper_on_card_matches_cpu(cuda, tm, rayflow):
    """The NDT side layers on the card: the same bits on a second run; the
    CPU's counts, touch times and stats, floats within 1e-5, mean and
    normal codes identical on >= 99.9% of written voxels."""
    card, stats = _ndt_layers_run(cuda, tm, rayflow)
    card2, _ = _ndt_layers_run(cuda, tm, rayflow)
    cpu, cpu_stats = _ndt_layers_run("cpu", tm, rayflow)
    assert stats == cpu_stats and stats["ndt_flagged"] > 0
    assert card.keys() == card2.keys() == cpu.keys()
    assert {k[2] for k in card} >= {"traversal", "touch", "packed_normal"}
    for k in card:
        assert np.array_equal(card[k].view(np.uint32), card2[k].view(np.uint32)), k
        a, b = card[k], cpu[k]
        if a.dtype == np.float32:
            fin = np.isfinite(b)
            assert np.array_equal(fin, np.isfinite(a)), k
            np.testing.assert_allclose(a[fin], b[fin], atol=1e-5, rtol=1e-5)
        elif k[2] in ("coord", "packed_normal"):
            written = (a != 0) | (b != 0)
            assert (a[written] == b[written]).mean() >= 0.999, k
        else:
            assert np.array_equal(a, b), k


def test_queries_on_card_match_cpu(cuda):
    """RaysQuery, LineKeysQuery and ClearanceProcess on the card against the
    CPU on one map: states, voxels, keys and clearance bit for bit, ranges
    and volumes within rtol 1e-5."""
    from ohm_tpu_torch.core.layout import CLEARANCE_LAYER
    from ohm_tpu_torch.oracle.occupancy import RayMapperOccupancy
    from ohm_tpu_torch.query import ClearanceProcess, LineKeysQuery, RaysQuery

    rng = np.random.default_rng(21)
    m = OccupancyMap(resolution=0.25, flags=MapFlag.NONE)
    RayMapperOccupancy(m).integrate_rays(_box_rays(2048, rng, half=(4.0, 4.0, 2.0)))
    rays = np.empty((1024, 3))
    rays[0::2] = rng.uniform(-3.0, 3.0, (512, 3))
    rays[1::2] = rays[0::2] + rng.normal(0.0, 6.0, (512, 3))
    out = []
    for device in (cuda, "cpu"):
        q, k = RaysQuery(m, device=device), LineKeysQuery(m, device=device)
        for query in (q, k):
            query.set_rays(rays)
            query.execute()
        ClearanceProcess(m, search_radius=1.0, device=device).update(force=True)
        ci = m.layer_index(CLEARANCE_LAYER)
        out.append((q, k, {key: c.layers[ci][CLEARANCE_LAYER].copy()
                           for key, c in m.chunks.items()}))
    (q1, k1, c1), (q2, k2, c2) = out
    assert np.array_equal(q1.terminal_states, q2.terminal_states)
    assert np.array_equal(q1.intersected_voxels, q2.intersected_voxels)
    np.testing.assert_allclose(q1.ranges, q2.ranges, rtol=1e-5)
    np.testing.assert_allclose(q1.unobserved_volumes, q2.unobserved_volumes, rtol=1e-5)
    assert all(np.array_equal(a, b) for a, b in zip(k1.result_keys, k2.result_keys))
    assert c1.keys() == c2.keys() and all(
        np.array_equal(c1[key].view(np.uint32), c2[key].view(np.uint32)) for key in c1)
    assert len(set(q1.terminal_states.tolist())) >= 2


def _special_planes(rng, n, device):
    """Two f32 planes of n + 1 voxels holding -0.0, +-inf, NaN payloads and
    denormals among normal values."""
    out = []
    for _ in range(2):
        p = rng.normal(0.0, 2.0, n + 1).astype(np.float32)
        at = rng.choice(n, 20_000, replace=False)
        p[at[:10_000]] = np.array([-0.0, np.inf, -np.inf, 1e-40], np.float32)[
            np.arange(10_000) % 4]
        p.view(np.uint32)[at[10_000:]] = np.array([0x7FC00000, 0x7FA00001, 0xFFC12345],
                                                  np.uint32)[np.arange(10_000) % 3]
        out.append(torch.from_numpy(p).to(device))
    return out


def test_gather_f32_kernel_matches_plain(bench_batch):
    _, b, cfg = bench_batch
    dev = b["start_abs"].device
    rng = np.random.default_rng(10)
    planes = _special_planes(rng, cfg.sentinel, dev)
    ids = np.concatenate([np.sort(rng.integers(0, cfg.sentinel, 1_000_000)),
                          np.full(50_000, cfg.sentinel)]).astype(np.int32)
    ids = torch.from_numpy(ids).to(dev)
    out = gather_planes_f32(planes, ids, cfg.sentinel)
    ref = gather_planes_f32_reference(planes, ids, cfg.sentinel)
    torch.cuda.synchronize()
    for a, r in zip(out, ref):
        assert torch.equal(a.view(torch.int32), r.view(torch.int32))
    assert int((out[0][-50_000:].view(torch.int32) != 0).sum()) == 0
    assert bool(torch.isnan(out[1]).any())


def test_tsdf_deposit_kernel_matches_plain(bench_batch):
    _, b, cfg = bench_batch
    dev = b["start_abs"].device
    rng = np.random.default_rng(11)
    weight, distance = _special_planes(rng, cfg.sentinel, dev)
    ids = np.sort(rng.integers(0, cfg.sentinel, 1_000_000))
    ids = np.concatenate([ids, np.full(20_000, cfg.sentinel)]).astype(np.int32)
    last = np.concatenate([ids[1:] != ids[:-1], [True]]) & (ids < cfg.sentinel)
    dep = last & (rng.random(ids.size) < 0.9)
    w = np.where(dep, rng.uniform(1e-5, 1e4, ids.size), 0.0).astype(np.float32)
    d = np.where(dep, rng.uniform(-0.1, 0.1, ids.size), 0.0).astype(np.float32)
    k = np.flatnonzero(dep)[:4000]
    d[k] = np.array([-0.0, np.inf, -np.inf, np.nan], np.float32)[np.arange(k.size) % 4]
    w[-20_000:] = 1.0  # sentinel records never store
    args = [torch.from_numpy(x).to(dev) for x in (ids, w, d)]
    out = tsdf_set_deposit(weight.clone(), distance.clone(), *args, cfg.sentinel)
    ref = tsdf_set_deposit_reference(weight.clone(), distance.clone(), *args, cfg.sentinel)
    torch.cuda.synchronize()
    for a, r, before in zip(out, ref, (weight, distance)):
        assert torch.equal(a.view(torch.int32), r.view(torch.int32))
        assert int((a.view(torch.int32) != before.view(torch.int32)).sum()) > 100_000


@pytest.mark.parametrize("name", TSDF_VISIT_STREAMS)
def test_tsdf_visits_kernel_matches_plain_on_edge_streams(bench_batch, name):
    """K5+K6 fused against its plain version on the edge streams over a
    bench-sized arena, both planes bit for bit, and the same bits on a
    second run; the wrapper counts one launch a call."""
    _, b, cfg = bench_batch
    dev = b["start_abs"].device
    s = tsdf_visit_stream(name, cfg.sentinel, seed=14)
    ids, wsdf = (torch.from_numpy(s[k]).to(dev) for k in ("ids", "wsdf"))
    w = None if s["w"] is None else torch.from_numpy(s["w"]).to(dev)
    planes = tuple(torch.from_numpy(s[k]).to(dev) for k in ("weight", "distance"))
    tsdf_visits.launches = 0
    outs = []
    for fn in (tsdf_visits, tsdf_visits, tsdf_visits_reference):
        weight, distance = (p.clone() for p in planes)
        fn(weight, distance, ids, w, wsdf, s["trunc"], s["max_weight"], cfg.sentinel)
        outs.append((weight, distance))
    torch.cuda.synchronize()
    assert tsdf_visits.launches == 2
    for a, a2, r, before in zip(*outs, planes):
        assert torch.equal(a.view(torch.int32), r.view(torch.int32))
        assert torch.equal(a.view(torch.int32), a2.view(torch.int32))
    stored = int((outs[0][0].view(torch.int32) != planes[0].view(torch.int32)).sum())
    assert stored > 100 if name != "all_sentinel" else stored == 0


def test_tsdf_visits_wrapper_issues_only_its_scratch(bench_batch):
    _, b, cfg = bench_batch
    dev = b["start_abs"].device
    s = tsdf_visit_stream("weighted", cfg.sentinel, seed=15)
    args = [torch.from_numpy(s[k]).to(dev) for k in ("weight", "distance", "ids", "w", "wsdf")]
    ops = dispatched_ops(lambda: tsdf_visits(*args, s["trunc"], s["max_weight"], cfg.sentinel))
    assert ops == ["empty"], ops


def _tsdf_run(device):
    """tests/test_tsdf.py's sphere scene on TorchTsdfMap."""
    rng = np.random.default_rng(12)
    dirs = rng.normal(size=(2000, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    rays = np.zeros((4000, 3))
    rays[1::2] = dirs * 2.0
    m = OccupancyMap(resolution=0.1, flags=MapFlag.NONE)
    mapper = TorchTsdfMap(m, TsdfOptions(default_truncation_distance=0.3), capacity=64,
                          validate=True, device=device, rayflow=True)
    for i in range(0, 4000, 1000):
        mapper.integrate_rays(rays[i:i + 1000])
    mapper.sync_voxels()
    idx = m.layer_index("tsdf")
    return ({k: (np.array(c.layers[idx]["weight"]), np.array(c.layers[idx]["distance"]))
             for k, c in m.chunks.items()}, mapper.stats)


def test_tsdf_mapper_on_card_matches_cpu(cuda):
    card, stats = _tsdf_run(cuda)
    card2, _ = _tsdf_run(cuda)
    cpu, cpu_stats = _tsdf_run("cpu")
    assert stats == cpu_stats and stats["batches"] == 4
    assert card.keys() == card2.keys() == cpu.keys() and len(card) > 0
    for k in card:
        for a, a2, c in zip(card[k], card2[k], cpu[k]):
            assert np.array_equal(a.view(np.uint32), a2.view(np.uint32)), k
            np.testing.assert_allclose(a, c, atol=1e-5, rtol=1e-5)
        assert np.array_equal(card[k][0], cpu[k][0])  # weights equal


@pytest.mark.parametrize("exclude_origin", [False, True])
@pytest.mark.parametrize("with_vox", [False, True])
def test_expand_traversal_matches_plain(bench_batch, exclude_origin, with_vox):
    _, b, cfg = bench_batch
    key, aux = expand_keys(b, cfg, exclude_origin=exclude_origin, with_trav=True,
                           with_vox=with_vox)
    ref = expand_keys_reference(b, cfg, exclude_origin=exclude_origin, with_vox=with_vox,
                                with_trav=True)
    torch.cuda.synchronize()
    assert torch.equal(key, ref[0]) and int(aux["missed_n"]) == int(ref[1])
    assert torch.equal(aux["trav"].view(torch.int32), ref[-1].view(torch.int32))
    assert float(aux["trav"].sum()) > 1000.0
    if with_vox:
        live = ref[0] != cfg.sentinel
        assert torch.equal(aux["vox"][live], ref[2][live])


def _layers_run(device, use_async=False):
    """A box scan in four timestamped batches on a map with all four side
    layers; region -> member -> host array, and the stats."""
    rng = np.random.default_rng(9)
    flags = MapFlag.VOXEL_MEAN | MapFlag.TRAVERSAL | MapFlag.TOUCH_TIME | MapFlag.INCIDENT_NORMAL
    m = OccupancyMap(resolution=0.1, flags=flags)
    mapper = TorchRayMapper(m, capacity=512, validate=True, device=device, rayflow=True)
    submit = mapper.integrate_rays_async if use_async else mapper.integrate_rays
    for i in range(4):
        submit(_box_rays(2048, rng), timestamps=20.0 + i + np.arange(2048) * 1e-4)
    mapper.sync_voxels()
    out = {}
    for key, c in m.chunks.items():
        for li, layer in enumerate(c.layers):
            for f in layer.dtype.names:
                out[(key, f)] = np.array(layer[f])
    return out, mapper.stats


def test_layers_mapper_on_card_matches_cpu(cuda):
    card, stats = _layers_run(cuda)
    card2, _ = _layers_run(cuda)
    queued, queued_stats = _layers_run(cuda, use_async=True)
    cpu, cpu_stats = _layers_run("cpu")
    assert stats == cpu_stats == queued_stats and stats["batches"] == 4
    assert card.keys() == card2.keys() == queued.keys() == cpu.keys() and len(card) > 0
    members = {k[1] for k in card}
    assert members >= {"occupancy", "coord", "count", "traversal", "touch", "packed_normal"}
    codes = {"coord": [], "packed_normal": []}
    for k in card:
        assert np.array_equal(card[k].view(np.uint32), card2[k].view(np.uint32)), k
        assert np.array_equal(card[k].view(np.uint32), queued[k].view(np.uint32)), k
        a, c = card[k], cpu[k]
        if k[1] == "traversal":
            np.testing.assert_allclose(a, c, atol=1e-5, rtol=1e-5)
        elif k[1] in codes:
            written = (a != 0) | (c != 0)
            codes[k[1]].append(a[written] == c[written])
        else:  # occupancy bits, mean counts and touch times
            assert np.array_equal(a.view(np.uint32), c.view(np.uint32)), k
    for member, same in codes.items():
        same = np.concatenate(same)
        assert same.size > 1000 and same.mean() >= 0.999, member


@pytest.mark.parametrize("name", list(probes_cuda.PROBES))
def test_probe_kernel_matches_plain(cuda, name):
    args = probes_cuda.probe_inputs(cuda)[name]
    out = probes_cuda.PROBES[name](*args)
    ref = probes_cuda.PLAIN[name](*args)
    torch.cuda.synchronize()
    assert torch.equal(out.view(torch.int32), ref.view(torch.int32))
    assert np.array_equal(out.cpu().numpy(), probes_cuda.expected_outputs()[name])


@pytest.mark.parametrize("rows", [1, 4, 8, "one_cell"])
def test_onehot_probe_on_random_records(cuda, rows):
    """The one-hot product on the tensor cores against its plain version and
    bincount: random records with 1, 4 and 8 rows of 128, and 512 records in
    one cell."""
    if rows == "one_cell":
        v = torch.full((4, 128), 12_345, dtype=torch.int32, device=cuda)
    else:
        rng = np.random.default_rng(rows)
        v = torch.from_numpy(rng.integers(0, pd.V, (rows, 128)).astype(np.int32)).to(cuda)
    out = probes_cuda.onehot_mma(v)
    ref = probes_cuda.onehot_mma_reference(v)
    lib = PROBE_LIBRARY_CALLS["onehot_mxu_dot"](v)
    torch.cuda.synchronize()
    assert torch.equal(out, ref) and torch.equal(out, lib)
    assert float(out.sum()) == v.numel()
    if rows == "one_cell":
        assert float(out[12_345 >> 9, 12_345 & 511]) == 512.0


def _probe_stream(name, device):
    if name == "bench":
        keys, occ, c = pd.make_stream(), pd.initial_occupancy()[:pd.C * pd.V], pd.C
    else:
        keys, occ, c = pd.edge_stream(name)
    return torch.from_numpy(keys).to(device), torch.from_numpy(occ).to(device), c


@pytest.mark.parametrize("fuse_sweep", [True, False], ids=["fused", "counts"])
@pytest.mark.parametrize("name", ("bench",) + pd.EDGE_STREAMS)
def test_slotgrid_kernel_matches_plain(cuda, name, fuse_sweep):
    keys, occ, c = _probe_stream(name, cuda)
    out = slotgrid_deposit(keys, occ.clone(), c, fuse_sweep=fuse_sweep, **pd.SWEEP)
    again = slotgrid_deposit(keys, occ.clone(), c, fuse_sweep=fuse_sweep, **pd.SWEEP)
    ref = slotgrid_deposit_reference(keys, occ.clone(), c, fuse_sweep=fuse_sweep, **pd.SWEEP)
    torch.cuda.synchronize()
    assert torch.equal(out.view(torch.int32), ref.view(torch.int32))
    assert torch.equal(out.view(torch.int32), again.view(torch.int32))
    if name == "long_run":
        assert float(out[977]) == (pd.LONG_RUN if not fuse_sweep else float(ref[977]))


@pytest.mark.parametrize("fuse_sweep", [True, False], ids=["fused", "counts"])
def test_slotgrid_kernel_on_a_ragged_tail(cuda, fuse_sweep):
    """A stream whose length is no multiple of the kernel's tile or of 4
    (a scalar tail), keys below 0 and past the slots, and an occupancy
    longer than the slots, whose tail stays as it was; misaligned keys are
    refused; a fused call issues no PyTorch op."""
    keys, occ, c = _probe_stream("run_across_tiles", cuda)
    keys = torch.cat([torch.tensor([-9, -2], dtype=torch.int32, device=cuda), keys[:-515],
                      torch.full((5,), 2**31 - 1, dtype=torch.int32, device=cuda)])
    occ = torch.cat([occ, torch.full((7,), 3.0, device=cuda)])
    for k in (keys, keys[:-3].clone()):
        out = slotgrid_deposit(k, occ.clone(), c, fuse_sweep=fuse_sweep, **pd.SWEEP)
        ref = slotgrid_deposit_reference(k, occ.clone(), c, fuse_sweep=fuse_sweep, **pd.SWEEP)
        torch.cuda.synchronize()
        assert torch.equal(out.view(torch.int32), ref.view(torch.int32))
        assert torch.equal(out[c * pd.V:], occ[c * pd.V:])
    with pytest.raises(ValueError, match="16-byte"):
        slotgrid_deposit(keys[1:], occ.clone(), c, fuse_sweep=fuse_sweep, **pd.SWEEP)
    if fuse_sweep:
        assert dispatched_ops(lambda: slotgrid_deposit(keys, occ, c, **pd.SWEEP)) == []


def test_slotgrid_and_k3_match_the_scatter_yardstick(cuda):
    keys, _, c = _probe_stream("bench", cuda)
    occ_flat = torch.from_numpy(pd.initial_occupancy()).to(cuda)
    n_vox = c * pd.V
    want = scatter_deposit(keys, occ_flat, c, **pd.SWEEP)[:n_vox]
    grid = pd.deposit(keys, occ_flat.clone(), c)[:n_vox]
    k3 = pd.k3_deposit(keys, occ_flat.clone(), pd.k3_config(c))[:n_vox]
    torch.cuda.synchronize()
    assert pd.largest_count(keys, c) < 65535
    assert torch.equal(grid.view(torch.int32), want.view(torch.int32))
    assert torch.equal(k3.view(torch.int32), want.view(torch.int32))


def _k1_batch(device, cdict: int, fdict: bool):
    """A 2048-ray box scan's wire with the given candidate dictionary and
    start-frac dictionary, decoded on ``device``; edge rays in its first 48
    rows (starts on voxel walls, zero lengths, a denormal direction component
    on an axis the ray crosses once, which reads as zero, invalid
    rays, more than S crossings)."""
    mapper = TorchRayMapper(OccupancyMap(resolution=0.1, flags=MapFlag.NONE), capacity=512,
                            device=device, rayflow=True)
    rf = prepare_rayflow(mapper.map, _box_rays(2048, np.random.default_rng(40 + cdict),
                                               half=(6.0, 6.0, 3.0)))
    mapper.arena.ensure_regions(rf.region_keys, host_map=mapper.map)
    assert len(rf.region_keys) <= 255  # every dictionary can hold the candidates
    fd = frac_dict_of(rf) if fdict else None
    assert (fd is not None) == fdict
    wire = rayflow_wire(rf, mapper.arena.table, with_touch=False, with_intensity=False,
                        cdict=cdict, fdict=fd)
    cfg = mapper._config(0, max_steps=-(-(rf.max_axis_steps + 1) // 32) * 32,
                         table_k=rf.table_k, rayw_cdict=cdict, rayw_fdict=fdict)
    b = unpack_batch(torch.from_numpy(wire).to(device), cfg)
    edge_rays(b, cfg)
    return b, cfg


@pytest.mark.parametrize("fdict", [True, False], ids=["fdict", "floats"])
@pytest.mark.parametrize("cdict", [0, 1, 2])
def test_expand_kernel_prelude_matches_plain(cuda, cdict, fdict):
    b, cfg = _k1_batch(cuda, cdict, fdict)
    assert (b["direction"].stride(0), b["length"].stride(0)) == ((4, 4) if fdict else (7, 7))
    for kw in ({"exclude_origin": False}, {"exclude_origin": True, "with_trav": True},
               {"exclude_origin": False, "with_trav": True, "with_vox": True}):
        key, aux = expand_keys(b, cfg, **kw)
        ref = expand_keys_reference(b, cfg, kw["exclude_origin"], with_vox=kw.get("with_vox", False),
                                    with_trav=kw.get("with_trav", False))
        ref_aux = _prelude(b, cfg)[-1]
        torch.cuda.synchronize()
        assert torch.equal(key, ref[0]) and int(aux["missed_n"]) == int(ref[1])
        assert aux["overflow"].dtype == torch.bool
        assert torch.equal(aux["overflow"], ref_aux["overflow"])
        assert torch.equal(aux["end_enter"].view(torch.int32),
                           ref_aux["end_enter"].view(torch.int32))
        if kw.get("with_trav"):
            assert torch.equal(aux["trav"].view(torch.int32), ref[-1].view(torch.int32))
        if kw.get("with_vox"):
            live = ref[0] != cfg.sentinel
            assert torch.equal(aux["vox"][live], ref[2][live])
    assert bool(aux["overflow"][40:48].all()) and not bool(aux["overflow"][:40].any())
    # The denormal component reads as zero (inv = 3e38, as under XLA): the
    # one crossing's time is e0 = (half - start_frac) * 3e38, finite.
    assert bool(torch.isfinite(aux["end_enter"][24:]).all())
    assert bool((aux["end_enter"][28:32] > 1e30).all())


def test_ohmpop_from_laz_on_card_matches_cpu(cuda, tmp_path):
    """ohmpop --device cuda on a small .laz (a ground plane and a wall around
    a static sensor, a timestamp a point) against --device cpu: the same
    chunks, occupancy bits and mean counts identical, mean codes identical
    on >= 99.9% of written voxels; K1 and K2 launched."""
    from ohm_tpu_torch.app import ohmpop
    from ohm_tpu_torch.core.layout import MEAN_LAYER, OCCUPANCY_LAYER
    from ohm_tpu_torch.io import load
    from ohm_tpu_torch.io.las import write_laz

    rng = np.random.default_rng(12)
    n = 6000
    ground = np.column_stack([rng.uniform(-15, 15, (n, 2)), np.zeros(n)])
    wall = np.column_stack([np.full(n // 3, 12.0), rng.uniform(-12, 12, n // 3),
                            rng.uniform(0, 3, n // 3)])
    pts = np.concatenate([ground, wall])
    t = 50.0 + np.arange(len(pts)) * 1e-4
    laz, traj = str(tmp_path / "scan.laz"), str(tmp_path / "traj.txt")
    write_laz(laz, pts, timestamps=t)
    with open(traj, "w") as f:
        f.write(f"{t[0]} 0 0 1.5\n{t[-1] + 1} 0 0 1.5\n")
    expand_keys.launches = deposit_and_sweep.launches = 0
    maps = {}
    for device in ("cuda", "cpu"):
        base = str(tmp_path / device)
        assert ohmpop.main([laz, traj, "-o", base, "--resolution", "0.2", "--voxel-mean",
                            "--arena-capacity", "256", "--batch-size", "2048", "-q",
                            "--no-cloud", "--device", device]) == 0
        if device == "cuda":
            assert expand_keys.launches > 0 and deposit_and_sweep.launches > 0
        maps[device] = load(base + ".ohm")[0]
    card, cpu = maps["cuda"], maps["cpu"]
    assert card.chunks.keys() == cpu.chunks.keys() and len(card.chunks) > 0
    oi, mi = card.layer_index(OCCUPANCY_LAYER), card.layer_index(MEAN_LAYER)
    same = []
    for key, chunk in card.chunks.items():
        other = cpu.chunks[key]
        assert np.array_equal(chunk.layers[oi][OCCUPANCY_LAYER].view(np.uint32),
                              other.layers[oi][OCCUPANCY_LAYER].view(np.uint32)), key
        assert np.array_equal(chunk.layers[mi]["count"], other.layers[mi]["count"]), key
        a, b = chunk.layers[mi]["coord"], other.layers[mi]["coord"]
        written = (a != 0) | (b != 0)
        same.append(a[written] == b[written])
    same = np.concatenate(same)
    assert same.size > 1000 and same.mean() >= 0.999


def test_sharded_rayflow_mapper_on_card_matches_single_device(cuda):
    """ShardedRayFlowMapper on four shards of the one card (bench.py's box,
    0.1 m, 4 x 2048-ray batches): occupancy bit-identical to TorchRayMapper
    on the card and to a second sharded card run; K1 and K2 launched on
    every shard."""
    from ohm_tpu_torch.ops import deposit_cuda, expand_cuda
    from ohm_tpu_torch.parallel import ShardedRayFlowMapper, ShardMesh

    rng = np.random.default_rng(2024)
    batches = [_box_rays(2048, rng) for _ in range(4)]
    occ = []
    for sharded in (True, True, False):
        expand_cuda.expand_keys.launches = deposit_cuda.deposit_and_sweep.launches = 0
        m = OccupancyMap(resolution=0.1, flags=MapFlag.NONE)
        if sharded:
            mapper = ShardedRayFlowMapper(m, ShardMesh.repeat(cuda, 4), capacity=512,
                                          validate=True)
        else:
            mapper = TorchRayMapper(m, capacity=512, validate=True, device=cuda, rayflow=True)
        for rays in batches:
            mapper.integrate_rays(rays)
        mapper.sync_voxels()
        if sharded:
            assert expand_cuda.expand_keys.launches == 4 * len(batches)
            assert deposit_cuda.deposit_and_sweep.launches == 4 * len(batches)
            assert mapper.stats["routing_dropped"] == 0
        oi = m.layer_index("occupancy")
        occ.append({k: c.layers[oi]["occupancy"].view(np.uint32).copy()
                    for k, c in m.chunks.items()})
    assert occ[0].keys() == occ[1].keys() == occ[2].keys() and len(occ[0]) > 0
    for k in occ[0]:
        assert np.array_equal(occ[0][k], occ[1][k]) and np.array_equal(occ[0][k], occ[2][k])


@pytest.mark.parametrize("kind", BENCH_WORKER_KINDS)
def test_bench_worker_loop_gives_the_synchronous_map(cuda, kind):
    worker, sync = bench_worker_maps(kind, "cuda")
    a, b = map_bytes(worker), map_bytes(sync)
    assert len(worker.chunks) > 0 and a.keys() == b.keys()
    assert all(a[k] == b[k] for k in a)


def _route_run(device, fused, batches, worker=False, flags=MapFlag.TRAVERSAL, **kw):
    """``batches`` through a TorchRayMapper built under OHM_FUSED=``fused``
    (synchronous calls, or the sizing half through the worker thread and
    the rest as one of its groups); its routes and host layers."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OHM_FUSED", fused)
        m = OccupancyMap(resolution=0.1, flags=flags)
        mapper = TorchRayMapper(m, capacity=512, validate=True, device=device, rayflow=True,
                                **kw)
    mapper.prime_caps(batches)
    routes = []
    half = len(batches) // 2
    if worker:
        for b in batches[:half]:
            mapper.integrate_rays_async(b)
        mapper.flush()
        mapper._integrate_group([(b, None, None, 0) for b in batches[half:]])
        routes.append(mapper.last_route)
    else:
        for b in batches:
            mapper.integrate_rays(b)
            routes.append(mapper.last_route)
    mapper.sync_voxels()
    out = {}
    for layer in ("occupancy", "traversal"):
        i = m.layer_index(layer)
        if i >= 0:
            out.update({(k, layer): c.layers[i][layer].copy() for k, c in m.chunks.items()})
    return routes, out, mapper


def _same_occupancy(a, b):
    occ = [k for k in a if k[1] == "occupancy"]
    return sorted(occ) == sorted(k for k in b if k[1] == "occupancy") and all(
        np.array_equal(a[k].view(np.uint32), b[k].view(np.uint32)) for k in occ)


def test_fused_and_delta_routes_on_card_match_split(cuda):
    """The fused apply (OHM_FUSED=2) and the delta path on the card: the
    split apply's occupancy bit for bit (traversal within
    testing.fused_traversal_atol, the blocked sums' rounding bound), the
    card's fused run equal to the CPU's (traversal within 1e-5), and a
    second card run the same bits."""
    rng = np.random.default_rng(11)
    batches = [_box_rays(2048, rng) for _ in range(6)]
    split = _route_run(cuda, "0", batches)
    fused = _route_run(cuda, "2", batches)
    again = _route_run(cuda, "2", batches)
    cpu = _route_run("cpu", "2", batches)
    delta = _route_run(cuda, "0", batches, flags=MapFlag.NONE, delta_path=True)
    assert fused[0][3:] == ["fused"] * 3 and delta[0][4:] == ["delta"] * 2
    assert _same_occupancy(split[1], fused[1]) and _same_occupancy(split[1], delta[1])
    assert _same_occupancy(fused[1], cpu[1])
    for k, v in fused[1].items():
        assert np.array_equal(v.view(np.uint32), again[1][k].view(np.uint32)), k
        if k[1] == "traversal":
            assert np.abs(v - split[1][k]).max() <= fused_traversal_atol(0.1)
            np.testing.assert_allclose(v, cpu[1][k], atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("fused", ["0", "2"], ids=["split", "fused"])
def test_coalesced_worker_on_card_matches_sequential(cuda, fused):
    """The worker on the card (its thread, pinned coalesced uploads, then a
    group of four chained) leaves the synchronous calls' map bit for bit."""
    rng = np.random.default_rng(17)
    batches = [_box_rays(2048, rng) for _ in range(8)]
    seq = _route_run(cuda, fused, batches)
    co = _route_run(cuda, fused, batches, worker=True)
    assert co[0] == ["chain_fused" if fused == "2" else "chain_split"]
    assert co[2]._staged, "no pinned upload"
    assert co[1].keys() == seq[1].keys()
    for k, v in co[1].items():
        assert np.array_equal(v.view(np.uint32), seq[1][k].view(np.uint32)), k


def test_hardware_fused_differential_on_card(cuda):
    from ohm_tpu_torch import bench

    rng = np.random.default_rng(bench.SEED)
    bench.box_scene_rays(1024, rng)
    assert bench.hardware_fused_differential(rng, "cuda")["bit_identical"]


#: The mapper kinds on the worker's group path: (class, map flags, arguments,
#: group size, whether the graph holds its device step).  The occupancy
#: mapper's side layers compact their voxels with a count read back
#: (ops.integrate._compact_lasts): their captures stop there and the groups
#: stay eager.  NDT's side layers read nothing back.
GRAPH_KINDS = {
    "occupancy_chain": (TorchRayMapper, MapFlag.NONE, {}, 4, True),
    "occupancy_single": (TorchRayMapper, MapFlag.NONE, {}, 1, True),
    "occupancy_delta": (TorchRayMapper, MapFlag.NONE, {"delta_path": True}, 4, True),
    "ndt_om": (TorchNdtMap, MapFlag.NONE, {"miss_k": "exact"}, 4, True),
    "ndt_tm": (TorchNdtMap, MapFlag.NONE, {"params": NdtParams(ndt_tm=True), "miss_k": "exact"},
               4, True),
    "tsdf": (TorchTsdfMap, MapFlag.NONE, {}, 4, True),
    "occupancy_layers": (TorchRayMapper, MapFlag.VOXEL_MEAN | MapFlag.TRAVERSAL
                         | MapFlag.TOUCH_TIME | MapFlag.INCIDENT_NORMAL, {}, 4, False),
    "ndt_layers": (TorchNdtMap, MapFlag.TRAVERSAL | MapFlag.TOUCH_TIME
                   | MapFlag.INCIDENT_NORMAL, {"miss_k": "exact"}, 4, True),
}


def _graph_run(device, kind, batches, graphs, escalate_at=None):
    """``batches`` through a mapper of ``kind``: four synchronous calls
    (the windows sized), then the worker's groups, on this thread so that
    the groups are the same on every run, with the graphs (``graphs``) or
    without; at group ``escalate_at`` row_cap doubles, as an escalation
    doubles it.  Returns (host map bytes, drained stats, stats, routes,
    mapper, the worker's kernel launches by wrapper)."""
    cls, flags, kw, size, _ = GRAPH_KINDS[kind]
    rng = np.random.default_rng(31)
    m = OccupancyMap(resolution=0.1, flags=flags)
    mapper = cls(m, capacity=512, device=device, rayflow=True, **kw)
    if not graphs:
        mapper.graphs = None
    mapper.prime_caps(batches)
    for b in batches[:4]:
        mapper.integrate_rays(b, timestamps=rng.uniform(0, 10, len(b) // 2),
                              intensities=rng.uniform(10, 20, len(b) // 2))
    drained, routes = mapper._drain_stats(), []
    for fn in worker_graphs._COUNTED:
        fn.launches = 0
    for g, i in enumerate(range(4, len(batches), size)):
        if g == escalate_at:
            mapper.row_cap *= 2
        mapper._integrate_group([(b, rng.uniform(10, 20, len(b) // 2),
                                  rng.uniform(0, 10, len(b) // 2), 0)
                                 for b in batches[i:i + size]])
        drained += mapper._drain_stats()
        routes.append(mapper.last_route)
    mapper.sync_voxels()
    launches = {fn.__name__: fn.launches for fn in worker_graphs._COUNTED}
    return map_bytes(m), drained, mapper.stats, routes, mapper, launches


def _same_run(a, b):
    assert a[0].keys() == b[0].keys() and len(a[0]) > 0
    assert all(a[0][k] == b[0][k] for k in a[0]), [k for k in a[0] if a[0][k] != b[0][k]][:4]
    assert a[1] == b[1] and a[2] == b[2] and a[3] == b[3]
    assert a[5] == b[5] and sum(a[5].values()) > 0, (a[5], b[5])


@pytest.mark.parametrize("kind", list(GRAPH_KINDS))
def test_graph_replay_matches_eager_on_card(cuda, kind):
    """32 box batches of 4096 rays through the worker's groups, replayed
    from captured graphs: the eager worker's map, drained stats (an entry
    each, the same values), stats, routes and kernel launch counts, bit for
    bit.  The kinds whose device step reads the host fall back once and
    stay eager."""
    rng = np.random.default_rng(29)
    batches = [_box_rays(4096, rng) for _ in range(32)]
    eager = _graph_run(cuda, kind, batches, graphs=False)
    graphed = _graph_run(cuda, kind, batches, graphs=True)
    _same_run(graphed, eager)
    cache, size, holds = graphed[4].graphs, GRAPH_KINDS[kind][3], GRAPH_KINDS[kind][4]
    if holds:
        # The first group of a key runs eagerly, the second captures.
        assert (cache.captures, cache.fallbacks) == (1, 0), kind
        assert cache.replays == 28 - size, kind
    else:
        assert (cache.captures, cache.replays, cache.fallbacks) == (0, 0, 1), kind


def test_graph_recaptures_after_a_row_cap_escalation(cuda):
    """Chains under the fused apply (OHM_FUSED=2), row_cap doubled after the
    third group: a new key, captured again at its second sighting; the
    eager worker's map and stats bit for bit."""
    rng = np.random.default_rng(37)
    batches = [_box_rays(4096, rng) for _ in range(32)]
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OHM_FUSED", "2")
        eager = _graph_run(cuda, "occupancy_chain", batches, graphs=False, escalate_at=3)
        graphed = _graph_run(cuda, "occupancy_chain", batches, graphs=True, escalate_at=3)
    _same_run(graphed, eager)
    assert set(graphed[3]) == {"chain_fused"}
    cache = graphed[4].graphs
    # Groups 0-2: seen, captured, replayed; 3-6: seen, captured, replayed
    # twice.  The new epoch dropped the first key's graph.
    assert (cache.captures, cache.replays, cache.fallbacks) == (2, 20, 0)
    assert len(cache) == 1
