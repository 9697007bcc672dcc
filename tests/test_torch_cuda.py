"""The port's CUDA kernels against their plain PyTorch versions, on the card
(marker ``cuda``; skipped where torch sees no CUDA device).  Keys, voxel
planes, missed counts, gathered flags, occupancy bits and touched counts
must be identical, at the bench shape: 8192 box-scene rays, a 512-slot
arena of 32^3 regions.  TorchNdtMap on the card must agree with itself on
the CPU (NDT-OM and NDT-TM) and give the same bits on every run.

This file imports no JAX, so it also runs where JAX is not installed:
    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""

import dataclasses

import numpy as np
import pytest
import torch

from ohm_tpu.core.map import MapFlag, OccupancyMap
from ohm_tpu.core.rayflags import RayFlag
from ohm_tpu.oracle.ndt import NdtParams
from ohm_tpu_torch import TorchNdtMap, TorchRayMapper
from ohm_tpu_torch.ops.deposit_cuda import (
    deposit_and_sweep, deposit_and_sweep_ndt, deposit_and_sweep_ndt_reference,
    deposit_and_sweep_reference)
from ohm_tpu_torch.ops.expand_cuda import expand_keys, expand_keys_reference
from ohm_tpu_torch.ops.gather_cuda import gather_plane, gather_plane_reference
from ohm_tpu_torch.ops.integrate import expand_records
from ohm_tpu_torch.ops.wire import unpack_batch

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
                            capacity=512, device=cuda)
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


def test_mapper_on_card_matches_cpu(cuda):
    rays = _box_rays(1024, np.random.default_rng(7))
    occ = []
    for device in (cuda, "cpu"):
        m = OccupancyMap(resolution=0.1, flags=MapFlag.NONE)
        mapper = TorchRayMapper(m, capacity=512, validate=True, device=device)
        mapper.integrate_rays(rays)
        mapper.sync_voxels()
        oi = m.layer_index("occupancy")
        occ.append({k: c.layers[oi]["occupancy"].view(np.uint32).copy()
                    for k, c in m.chunks.items()})
    assert occ[0].keys() == occ[1].keys()
    for k in occ[0]:
        assert np.array_equal(occ[0][k], occ[1][k])


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
    out = gather_plane(plane, ids, cfg.sentinel)
    ref = gather_plane_reference(plane, ids, cfg.sentinel)
    torch.cuda.synchronize()
    assert torch.equal(out, ref) and int(out.sum()) > 0


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
    mapper = TorchNdtMap(m, NdtParams(ndt_tm=tm), capacity=64, validate=True, device=device)
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
