#!/usr/bin/env python3
"""Drive the ohm_tpu_torch occupancy and NDT paths once on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root; needs one CUDA device

Phases, in order; each prints one JSON line, and any failure raises, so the
exit code is not 0 and no result line is printed:

  device       nvidia-smi's name and power limit, torch's device name
  build        nvcc builds ohm_tpu_torch/csrc/*.cu for sm_90a (seconds, ptxas)
  k1_expand    the expand kernel against its plain PyTorch version on wires
               of the box, corner and miss scenes: keys and missed counts
               bit-identical (tolerance 0)
  k2_deposit   the deposit-and-sweep kernel against its plain version at the
               bench shape (512 slots x 32768 voxels, ~1.1M keys) under each
               exclude flag: occupancy bits and touched count identical
  hardware_differential
               TorchRayMapper on the card, 1024-ray box scan, against the
               f64 oracle under bench.py's gate, and bit-identical to the
               same mapper on the CPU
  occupancy_integrate_rays_per_sec
               bench.py's configuration (box scene, seed 2024, 8192-ray
               batches, 40 timed after 4 warm-up, 512-slot arena), timed
               with synchronous integrate_rays; then host prep, device time
               per batch and per stage, each kernel beside its plain version,
               and (the "profile" line) torch.profiler's device time by
               kernel and the device's idle share over 8 batches
  k1_vox       the expand kernel's voxel planes (the NDT path's with_vox)
               against the plain walk's voxels on the box, corner and miss
               scenes, on every lane whose key is not the sentinel, bit for
               bit
  k3_ndt_deposit
               the NDT deposit-and-sweep kernel against its plain version at
               the NDT-OM shape (1024 slots x 32768 voxels, ~1.1M walk keys,
               8192 end keys), with the miss delta as a sparse stream and as
               a dense plane, over an arena mixing +inf, free, occupied and
               saturated voxels: occupancy bits and touched count identical
  k4_gather    the plane-gather kernel against its plain version on a
               sorted stream of ~1.5M ids with sentinel padding, identical
  ndt_hardware_differential
               TorchNdtMap on the card, NDT-OM and NDT-TM (with intensities),
               on tests/test_ndt.py's plane-then-through scene, against the
               f64 oracle under that test's tolerances, against the port on
               the CPU (atol = rtol = 1e-5, counts equal, mean codes equal on
               >= 99.9% of active voxels and within one quantum elsewhere),
               and bit-identical between two card runs
  ndt_om_rays_per_sec
               scripts/bench_modes.py config 3 on the port: box scene, 0.2 m
               voxels, 1024-slot arena, 8192-ray batches, 40 timed after 6
               warm-up; host prep, device time, each kernel beside its plain
               version, the launch counts, and a profile line; before it
               (the "ndt_om_kernel_checks" line) K1 with voxel planes, K4
               and K3 on the arguments this path gave them in one batch,
               each against its plain version bit for bit
  ndt_tm_integrate_rays_per_sec
               the integrate part of config 5: one 1,048,576-ray box frame
               (half extents 15, 15, 7), intensities uniform in [0, 1),
               miss_k 32768, synchronous 8192-ray batches

Then one JSON line of the kernels, nvidia-smi's line, and the result line
{"ok": true, "device": {...}}.  The script uses the port and the host
modules of ohm_tpu that are free of JAX (the host map, the f64 oracle, the
native wire library); it fails if JAX was imported.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from ohm_tpu.core.layout import (COVARIANCE_LAYER, HIT_MISS_COUNT_LAYER, INTENSITY_LAYER,
                                 MEAN_LAYER, OCCUPANCY_LAYER)
from ohm_tpu.core.map import MapFlag, OccupancyMap
from ohm_tpu.core.rayflags import RayFlag
from ohm_tpu.oracle.ndt import NdtParams, RayMapperNdt
from ohm_tpu.oracle.occupancy import RayMapperOccupancy
from ohm_tpu_torch import TorchNdtMap, TorchRayMapper
from ohm_tpu_torch.mapping.filters import use_safe_default_filter
from ohm_tpu_torch.ops import _build, deposit_cuda, expand_cuda, gather_cuda
from ohm_tpu_torch.ops.integrate import expand_records
from ohm_tpu_torch.ops.wire import unpack_batch

REPO = os.path.dirname(os.path.abspath(__file__))

SEED = 2024
RESOLUTION = 0.1
CAPACITY = 512
RAYS_PER_BATCH = 8192
N_BATCHES = 40
WARMUP = 4
GATE = {"tolerance": 1e-4, "allowed_ratio": 1e-4, "worst_bound": 2e-3}  # bench.py

# scripts/bench_modes.py configs 3 and 5 (NDT-OM, NDT-TM integrate).
NDT_RESOLUTION = 0.2
NDT_CAPACITY = 1024
NDT_WARMUP = 6
TM_FRAME_RAYS = 1 << 20
TM_HALF = (15.0, 15.0, 7.0)
TM_MISS_K = 1 << 15
# Port on the card against the port on the CPU.
PORT_TOL = {"atol": 1e-5, "rtol": 1e-5, "mean_code_identical": 0.999}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def box_scene_rays(n, rng, half=(10.0, 10.0, 5.0), sensor=(0.0, 0.0, 0.0)):
    """Sensor at the centre of a box room, rays to its walls (bench.py)."""
    dirs = rng.normal(size=(n, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    t = np.min(np.where(dirs != 0, np.asarray(half) / np.abs(dirs), np.inf), axis=1)
    rays = np.empty((2 * n, 3), dtype=np.float64)
    rays[0::2] = sensor
    rays[1::2] = np.asarray(sensor) + dirs * t[:, None]
    return rays


def corner_scene_rays(n, rng, spread=5.0):
    """Random short rays plus exact-corner and axis-aligned rays, which hit
    the walk's ties (tests/test_expand_pallas.py)."""
    dirs = rng.normal(size=(n, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    lengths = rng.uniform(0.25, spread, n)
    origins = rng.uniform(-0.8, 0.8, (n, 3))
    dirs[:64] = np.array([1.0, 1.0, 1.0]) / np.sqrt(3.0)
    origins[:64] = 0.0
    dirs[64:96] = np.eye(3)[np.arange(32) % 3]
    rays = np.zeros((2 * n, 3))
    rays[0::2] = origins
    rays[1::2] = origins + dirs * lengths[:, None]
    return rays


def cuda_ms(fn, reps: int = 20) -> float:
    """Mean ms per call of ``fn`` on the current stream (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def plain_vs_kernel_ms(plain, kernel, reps: int = 20) -> tuple[float, float]:
    """Times in turns (plain, kernel, kernel, plain); returns the means."""
    p1, k1, k2, p2 = (cuda_ms(f, reps) for f in (plain, kernel, kernel, plain))
    return (p1 + p2) / 2, (k1 + k2) / 2


def phase_device() -> dict:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    info = {"phase": "device", "nvidia_smi": smi,
            "name": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
            "torch": torch.__version__, "cuda": torch.version.cuda}
    emit(info)
    return info


def phase_build() -> None:
    seconds, log = _build.build(force=True, verbose=True)
    ptxas = [ln.strip() for ln in log.splitlines() if "registers" in ln or "Compiling entry" in ln]
    emit({"phase": "build", "seconds": seconds,
          "sources": [os.path.relpath(p, REPO) for p in _build.sources()],
          "flags": _build.NVCC_FLAGS, "ptxas": ptxas})


def _wire_batch(rays, flags=0):
    """A scene's rayflow wire as the main path prepares it, decoded on the card."""
    mapper = TorchRayMapper(OccupancyMap(resolution=RESOLUTION, flags=MapFlag.NONE),
                            capacity=CAPACITY, device="cuda")
    mapper.prime_caps([rays])
    wire, cfg, _ = mapper._rayflow_setup_host(rays, None, None, flags)
    return unpack_batch(torch.from_numpy(wire).cuda(), cfg), cfg


def phase_k1() -> dict:
    rng = np.random.default_rng(SEED)
    cases = []
    box_b, box_cfg = _wire_batch(box_scene_rays(RAYS_PER_BATCH, rng))
    cases.append(("box", box_b, box_cfg, 0))
    corner_b, corner_cfg = _wire_batch(corner_scene_rays(2048, rng))
    cases.append(("corner_exclude_origin", corner_b, corner_cfg, int(RayFlag.EXCLUDE_ORIGIN)))
    # Miss scene: drop the first candidate of every other ray, so records in
    # that region resolve to no slot and must be counted as missed.
    miss_b = dict(box_b)
    miss_b["tcand"] = box_b["tcand"].clone()
    miss_b["tcand"][::2, 0] = 0
    cases.append(("box_missed", miss_b, box_cfg, 0))
    rows = []
    for name, b, cfg, flags in cases:
        excl = bool(flags & RayFlag.EXCLUDE_ORIGIN)
        key_k, aux = expand_cuda.expand_keys(b, cfg, exclude_origin=excl)
        key_p, missed_p = expand_cuda.expand_keys_reference(b, cfg, exclude_origin=excl)
        b_cpu = {k: v.cpu() for k, v in b.items()}
        key_c, missed_c = expand_cuda.expand_keys_reference(b_cpu, cfg, exclude_origin=excl)
        torch.cuda.synchronize()
        missed_k = int(aux["missed_n"])
        err = int((key_k.long() - key_p.long()).abs().max())
        ok = (torch.equal(key_k, key_p) and torch.equal(key_k.cpu(), key_c)
              and missed_k == int(missed_p) == int(missed_c))
        rows.append({"scene": name, "rays": int(b["valid"].sum()), "records": key_k.numel(),
                     "missed": missed_k, "max_abs_err": err, "bit_identical": ok})
        if not ok:
            raise AssertionError(f"expand kernel differs from its plain version on {name}: {rows[-1]}")
    if rows[-1]["missed"] == 0:
        raise AssertionError("the miss scene made no record miss")
    result = {"phase": "k1_expand", "tolerance": 0, "cases": rows}
    emit(result)
    return {"max_abs_err": max(r["max_abs_err"] for r in rows), "wire": (box_b, box_cfg),
            "cases": cases}


def phase_k1_vox(k1: dict) -> dict:
    """K1's voxel planes against the plain walk's voxels on non-sentinel lanes."""
    rows = []
    for name, b, cfg, flags in k1["cases"]:
        excl = bool(flags & RayFlag.EXCLUDE_ORIGIN)
        key_k, aux = expand_cuda.expand_keys(b, cfg, exclude_origin=excl, with_vox=True)
        key_p, _, vox_p = expand_cuda.expand_keys_reference(b, cfg, exclude_origin=excl,
                                                            with_vox=True)
        torch.cuda.synchronize()
        live = key_p != cfg.sentinel
        vk, vp = aux["vox"][live], vox_p[live]
        err = int((vk.long() - vp.long()).abs().max()) if vk.numel() else 0
        ok = torch.equal(key_k, key_p) and torch.equal(vk, vp) and vk.numel() > 0
        rows.append({"scene": name, "lanes_compared": int(live.sum()), "max_abs_err": err,
                     "bit_identical": bool(ok)})
        if not ok:
            raise AssertionError(f"expand kernel's voxel planes differ on {name}: {rows[-1]}")
    emit({"phase": "k1_vox", "tolerance": 0, "cases": rows})
    return {"max_abs_err": max(r["max_abs_err"] for r in rows)}


def _bench_arena_and_stream(cfg, rng):
    """A 512-slot arena mixing unobserved (-0.0), free, occupied and
    saturated voxels, and a sorted ~1.1M-key stream over 320 live slots."""
    n_vox = cfg.sentinel
    occ = np.full(n_vox + 1, np.float32(-0.0), np.float32)
    seeded = rng.integers(0, n_vox, n_vox // 4)
    occ[seeded] = rng.normal(0.0, 2.0, seeded.size).astype(np.float32)
    occ[seeded[: seeded.size // 50]] = np.float32(cfg.max_value)  # clamped high
    n = 1_100_000
    slots = rng.integers(0, 320, n)
    flat = slots * cfg.voxels_per_region + rng.integers(0, cfg.voxels_per_region, n)
    hot = rng.random(n) < 0.3
    flat[hot] = (slots[hot] * 7919) % n_vox  # repeated voxels: counts > 1
    hit = (rng.random(n) < 0.1).astype(np.int64)
    sent = rng.random(n) < 0.05
    flat[sent] = n_vox
    hit[sent] = rng.integers(0, 2, int(sent.sum()))
    key = np.sort((flat << 1) | hit).astype(np.int32)
    return torch.from_numpy(occ).cuda(), torch.from_numpy(key).cuda()


def phase_k2() -> dict:


    base = TorchRayMapper(OccupancyMap(resolution=RESOLUTION, flags=MapFlag.NONE),
                          capacity=CAPACITY, device="cuda")._config(0)
    occ0, keys = _bench_arena_and_stream(base, np.random.default_rng(SEED))
    cases = [(int(f), {}) for f in (0, RayFlag.EXCLUDE_FREE, RayFlag.EXCLUDE_OCCUPIED,
                                    RayFlag.EXCLUDE_UNOBSERVED,
                                    RayFlag.EXCLUDE_FREE | RayFlag.EXCLUDE_OCCUPIED)]
    cases.append((0, {"saturation_min": -1.0, "saturation_max": 2.0}))
    rows = []
    for flags, extra in cases:
        cfg = dataclasses.replace(base, ray_flags=flags, **extra)
        occ_k, touched_k = deposit_cuda.deposit_and_sweep(occ0.clone(), keys, cfg)
        occ_p, touched_p = deposit_cuda.deposit_and_sweep_reference(occ0.clone(), keys, cfg)
        torch.cuda.synchronize()
        same = torch.equal(occ_k.view(torch.int32), occ_p.view(torch.int32))
        fin = torch.isfinite(occ_k) & torch.isfinite(occ_p)
        err = float((occ_k[fin] - occ_p[fin]).abs().max())
        changed = int((occ_k.view(torch.int32) != occ0.view(torch.int32)).sum())
        rows.append({"flags": flags, **extra, "keys": keys.numel(), "touched": int(touched_k),
                     "changed": changed, "max_abs_err": err,
                     "bit_identical": bool(same and int(touched_k) == int(touched_p))})
        if not rows[-1]["bit_identical"]:
            raise AssertionError(f"deposit kernel differs from its plain version: {rows[-1]}")
    emit({"phase": "k2_deposit", "tolerance": 0, "cases": rows})
    return {"max_abs_err": max(r["max_abs_err"] for r in rows)}


def _ndt_config_at_bench_shape():
    """The base config of the NDT-OM configuration (0.2 m, 32^3 regions,
    1024 slots)."""
    return TorchNdtMap(OccupancyMap(resolution=NDT_RESOLUTION, flags=MapFlag.NONE),
                       capacity=NDT_CAPACITY, device="cuda")._config(0)


def _ndt_arena_and_streams(cfg, rng):
    """An NDT arena mixing +inf (unobserved), free, occupied and clamped
    voxels; a ~1.1M walk stream of misses in sorted order, a fifth of it
    masked to the sentinel as the NDT miss phase masks Gaussian-handled
    records; 8192 end keys (hits and misses, unsorted); and a sparse miss
    delta over 32768 records with one value per voxel at its last record,
    some values zero, and its dense plane."""
    n_vox = cfg.sentinel
    occ = np.full(n_vox + 1, np.inf, np.float32)
    seeded = rng.integers(0, n_vox, n_vox // 4)
    occ[seeded] = rng.normal(0.0, 2.0, seeded.size).astype(np.float32)
    occ[seeded[: seeded.size // 50]] = np.float32(cfg.max_value)
    occ[seeded[seeded.size // 50: seeded.size // 25]] = np.float32(cfg.min_value)
    live = rng.integers(0, 320, 1_100_000) * cfg.voxels_per_region
    flat = np.sort(live + rng.integers(0, cfg.voxels_per_region, live.size))
    walk = np.where(rng.random(flat.size) < 0.2, n_vox, flat) << 1
    end_flat = rng.integers(0, n_vox, RAYS_PER_BATCH)
    end_flat[rng.random(RAYS_PER_BATCH) < 0.05] = n_vox
    end = (end_flat << 1) | (rng.random(RAYS_PER_BATCH) < 0.7)
    dk = np.sort(np.concatenate([rng.choice(flat, 30_000), np.full(2768, n_vox)]))
    last = np.concatenate([dk[1:] != dk[:-1], [True]]) & (dk < n_vox)
    dv = np.where(last, rng.normal(0.0, 0.3, dk.size), 0.0).astype(np.float32)
    dv[last & (rng.random(dk.size) < 0.1)] = 0.0  # voxels whose deltas sum to 0
    plane = np.zeros(n_vox + 1, np.float32)
    plane[dk[last]] = dv[last]
    cuda = [torch.from_numpy(np.ascontiguousarray(x)).cuda() for x in (
        occ, walk.astype(np.int32), end.astype(np.int32), (dk << 1).astype(np.int32), dv,
        plane)]
    return cuda[0], cuda[1], cuda[2], (cuda[3], cuda[4]), cuda[5]


def phase_k3() -> dict:
    base = _ndt_config_at_bench_shape()
    occ0, walk, end, sparse, plane = _ndt_arena_and_streams(base, np.random.default_rng(SEED))
    rows, results = [], {}
    for name, delta, extra in (("sparse", sparse, {}), ("dense", plane, {}),
                               ("sparse_saturation", sparse,
                                {"saturation_min": -1.0, "saturation_max": 2.0})):
        cfg = dataclasses.replace(base, **extra)
        occ_k, touched_k = deposit_cuda.deposit_and_sweep_ndt(occ0.clone(), walk, end, delta, cfg)
        occ_p, touched_p = deposit_cuda.deposit_and_sweep_ndt_reference(
            occ0.clone(), walk, end, delta, cfg)
        torch.cuda.synchronize()
        same = torch.equal(occ_k.view(torch.int32), occ_p.view(torch.int32))
        fin = torch.isfinite(occ_k) & torch.isfinite(occ_p)
        err = float((occ_k[fin] - occ_p[fin]).abs().max())
        changed = int((occ_k.view(torch.int32) != occ0.view(torch.int32)).sum())
        results[name] = occ_k
        rows.append({"delta": name, **extra, "walk_keys": walk.numel(), "end_keys": end.numel(),
                     "touched": int(touched_k), "changed": changed, "max_abs_err": err,
                     "bit_identical": bool(same and int(touched_k) == int(touched_p))})
        if not rows[-1]["bit_identical"] or changed == 0:
            raise AssertionError(f"NDT deposit kernel differs from its plain version: {rows[-1]}")
    if not torch.equal(results["sparse"].view(torch.int32), results["dense"].view(torch.int32)):
        raise AssertionError("the sparse and dense miss deltas deposit differently")
    emit({"phase": "k3_ndt_deposit", "tolerance": 0, "cases": rows})
    return {"max_abs_err": max(r["max_abs_err"] for r in rows)}


def phase_k4() -> dict:
    cfg = _ndt_config_at_bench_shape()
    rng = np.random.default_rng(SEED)
    n_vox = cfg.sentinel
    plane = torch.from_numpy((rng.random(n_vox + 1) < 0.3).astype(np.int8)).cuda()
    live = rng.integers(0, 320, 1_400_000) * cfg.voxels_per_region
    ids = np.concatenate([np.sort(live + rng.integers(0, cfg.voxels_per_region, live.size)),
                          np.full(150_000, n_vox)]).astype(np.int32)
    ids = torch.from_numpy(ids).cuda()
    out_k = gather_cuda.gather_plane(plane, ids, n_vox)
    out_p = gather_cuda.gather_plane_reference(plane, ids, n_vox)
    torch.cuda.synchronize()
    err = int((out_k - out_p).abs().max())
    ok = torch.equal(out_k, out_p) and int(out_k[-150_000:].abs().sum()) == 0
    row = {"ids": ids.numel(), "sentinel_ids": 150_000, "flagged": int(out_k.sum()),
           "max_abs_err": err, "bit_identical": bool(ok)}
    emit({"phase": "k4_gather", "tolerance": 0, **row})
    if not ok:
        raise AssertionError(f"gather kernel differs from its plain version: {row}")
    return {"max_abs_err": err}


def _host_occupancy(m) -> dict:
    oi = m.layer_index(OCCUPANCY_LAYER)
    return {k: c.layers[oi][OCCUPANCY_LAYER].copy() for k, c in m.chunks.items()}


def phase_hardware_differential() -> None:
    rays = box_scene_rays(1024, np.random.default_rng(SEED))
    maps = {}
    for device in ("cuda", "cpu"):
        m = OccupancyMap(resolution=RESOLUTION, flags=MapFlag.NONE)
        mapper = TorchRayMapper(m, capacity=CAPACITY, validate=True, device=device)
        mapper.integrate_rays(rays)
        mapper.sync_voxels()
        maps[device] = m
    cpu_map = OccupancyMap(resolution=RESOLUTION, flags=MapFlag.NONE)
    use_safe_default_filter(cpu_map)  # the oracle reads the map's filter too
    RayMapperOccupancy(cpu_map).integrate_rays(rays)

    dev, port_cpu, ref = (_host_occupancy(m) for m in (maps["cuda"], maps["cpu"], cpu_map))
    bit_identical = dev.keys() == port_cpu.keys() and all(
        np.array_equal(dev[k].view(np.uint32), port_cpu[k].view(np.uint32)) for k in dev)
    worst, failures, compared = 0.0, 0, 0
    full = np.full(int(np.prod(cpu_map.region_voxel_dims)), np.inf, np.float32)
    for key in set(ref) | set(dev):
        a, b = ref.get(key, full), dev.get(key, full)
        inf_a, inf_b = np.isinf(a), np.isinf(b)
        compared += int((~inf_a | ~inf_b).sum())
        failures += int((inf_a != inf_b).sum())
        both = ~inf_a & ~inf_b
        if both.any():
            diff = np.abs(a[both] - b[both])
            worst = max(worst, float(diff.max()))
            failures += int((diff > GATE["tolerance"]).sum())
    ok = (compared > 0 and failures <= GATE["allowed_ratio"] * compared
          and worst <= GATE["worst_bound"] and bit_identical)
    emit({"metric": "hardware_differential", "compared_voxels": compared,
          "mismatches": failures, "worst_abs_diff": worst,
          "bit_identical_to_cpu": bool(bit_identical), "ok": bool(ok)})
    if not ok:
        raise AssertionError("GPU-vs-oracle differential failed")


def plane_rays(n, rng, z=0.0, extent=1.0, sensor=(0.0, 0.0, 2.0)):
    """Rays from a fixed sensor to samples on a horizontal plane
    (tests/test_ndt.py)."""
    samples = np.column_stack([rng.uniform(-extent, extent, n), rng.uniform(-extent, extent, n),
                               np.full(n, z) + rng.normal(0, 0.005, n)])
    rays = np.empty((2 * n, 3))
    rays[0::2] = sensor
    rays[1::2] = samples
    return rays


def ndt_scene(tm: bool):
    """tests/test_ndt.py's miss scene: a plane built in 50-ray batches, then
    60 rays through it in 30-ray batches; intensities for NDT-TM."""
    rng = np.random.default_rng(6)
    build = plane_rays(200, rng)
    n = 60
    through = np.empty((2 * n, 3))
    through[0::2] = (0.0, 0.0, 2.0)
    through[1::2] = np.column_stack([rng.uniform(-0.8, 0.8, n), rng.uniform(-0.8, 0.8, n),
                                     np.full(n, -0.8)])
    batches = [build[i:i + 50] for i in range(0, build.shape[0], 50)]
    batches += [through[i:i + 30] for i in range(0, through.shape[0], 30)]
    intens = [rng.uniform(10.0, 20.0, len(b) // 2).astype(np.float32) if tm else None
              for b in batches]
    return batches, intens


def ndt_map_layers(m) -> dict:
    """region -> {layer name: host array} of an NDT map."""
    idx = {name: m.layer_index(name) for name in (
        OCCUPANCY_LAYER, MEAN_LAYER, COVARIANCE_LAYER, INTENSITY_LAYER, HIT_MISS_COUNT_LAYER)}
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
        out[key] = {k: np.array(v) for k, v in d.items()}
    return out


def run_ndt_port(device, tm: bool):
    """TorchNdtMap over ndt_scene; returns (map, stats)."""
    batches, intens = ndt_scene(tm)
    m = OccupancyMap(resolution=0.25, flags=MapFlag.NONE)
    mapper = TorchNdtMap(m, NdtParams(ndt_tm=tm), capacity=64, validate=True, device=device)
    for rays, inten in zip(batches, intens):
        mapper.integrate_rays(rays, intensities=inten)
    mapper.sync_voxels()
    return m, mapper.stats


def compare_to_oracle(oracle_map, dev_map, tm: bool) -> dict:
    """tests/test_ndt.py's tolerances: occupancy within 5e-3 on all but 4%
    of voxels; mean counts equal and covariance within 5e-3 on active
    voxels; for NDT-TM (test_ndt_tm_layers) intensity mean within
    rtol 1e-3 / atol 1e-2, intensity covariance within rtol 0.5 / atol 0.3,
    hit counts within max(2, 10%)."""
    ref, dev = ndt_map_layers(oracle_map), ndt_map_layers(dev_map)
    compared = failures = 0
    worst = 0.0
    full = np.full(int(np.prod(oracle_map.region_voxel_dims)), np.inf, np.float32)
    for key in set(ref) | set(dev):
        a = ref[key]["occupancy"] if key in ref else full
        b = dev[key]["occupancy"] if key in dev else full
        inf_a, inf_b = np.isinf(a), np.isinf(b)
        compared += int((~inf_a | ~inf_b).sum())
        failures += int((inf_a != inf_b).sum())
        both = ~inf_a & ~inf_b
        if both.any():
            diff = np.abs(a[both] - b[both])
            worst = max(worst, float(diff.max()))
            failures += int((diff > 5e-3).sum())
    ok = compared > 0 and failures <= 0.04 * compared
    cov_worst, active_n = 0.0, 0
    for key, a in ref.items():
        b = dev.get(key)
        ok = ok and b is not None and np.array_equal(a["count"], b["count"])
        if b is None:
            continue
        act = a["count"] > 0
        active_n += int(act.sum())
        if act.any():
            cov_worst = max(cov_worst, float(np.abs(
                a["cov"][act].astype(np.float64) - b["cov"][act]).max()))
            if tm:
                ok = ok and np.allclose(b["intensity"][act, 0], a["intensity"][act, 0],
                                        rtol=1e-3, atol=1e-2)
                ok = ok and np.allclose(b["intensity"][act, 1], a["intensity"][act, 1],
                                        rtol=0.5, atol=0.3)
                ha = a["hit_count"][act].astype(np.int64)
                hb = b["hit_count"][act].astype(np.int64)
                ok = ok and np.abs(ha - hb).max() <= max(2, int(0.1 * ha.max()))
    ok = bool(ok and active_n > 0 and cov_worst <= 5e-3)
    return {"compared_voxels": compared, "mismatches": failures, "worst_abs_diff": worst,
            "active_voxels": active_n, "cov_worst_abs_diff": cov_worst, "ok": ok}


def compare_port(a_map, b_map) -> dict:
    """The port on two devices: the same voxels observed; occupancy, cov and
    intensity within PORT_TOL; counts equal; mean codes identical on at
    least 99.9% of active voxels and within one quantum per axis elsewhere."""
    a, b = ndt_map_layers(a_map), ndt_map_layers(b_map)
    ok = a.keys() == b.keys()
    worst = {"occupancy": 0.0, "cov": 0.0, "intensity": 0.0}
    active = code_same = 0
    code_step = 0
    for key in a.keys() & b.keys():
        x, y = a[key], b[key]
        ok = ok and np.array_equal(np.isinf(x["occupancy"]), np.isinf(y["occupancy"]))
        for name in worst:
            if name not in x:
                continue
            p, q = x[name], y[name]
            fin = np.isfinite(p) & np.isfinite(q)
            ok = ok and np.allclose(p[fin], q[fin], atol=PORT_TOL["atol"], rtol=PORT_TOL["rtol"])
            if fin.any():
                worst[name] = max(worst[name], float(np.abs(p[fin] - q[fin]).max()))
        for name in ("count", "hit_count", "miss_count"):
            if name in x:
                ok = ok and np.array_equal(x[name], y[name])
        act = x["count"] > 0
        active += int(act.sum())
        cx, cy = x["coord"][act], y["coord"][act]
        code_same += int((cx == cy).sum())
        for axis in range(3):
            qa = (cx >> (10 * axis)) & 1023
            qb = (cy >> (10 * axis)) & 1023
            code_step = max(code_step, int(np.abs(qa.astype(np.int64) - qb).max(initial=0)))
    share = code_same / max(active, 1)
    ok = bool(ok and active > 0 and share >= PORT_TOL["mean_code_identical"] and code_step <= 1)
    return {"worst_abs_diff": worst, "active_voxels": active, "mean_code_identical": share,
            "mean_code_max_quanta": code_step, "ok": ok}


def maps_bit_identical(a_map, b_map) -> bool:
    a, b = ndt_map_layers(a_map), ndt_map_layers(b_map)
    return a.keys() == b.keys() and all(
        np.array_equal(a[k][n].view(np.uint32), b[k][n].view(np.uint32))
        for k in a for n in a[k])


def phase_ndt_hardware_differential() -> None:
    rows = []
    for tm in (False, True):
        batches, intens = ndt_scene(tm)
        oracle_map = OccupancyMap(resolution=0.25, flags=MapFlag.NONE)
        use_safe_default_filter(oracle_map)  # the oracle reads the map's filter too
        oracle = RayMapperNdt(oracle_map, NdtParams(ndt_tm=tm))
        for rays, inten in zip(batches, intens):
            oracle.integrate_rays(rays, intensities=inten)
        card, stats = run_ndt_port("cuda", tm)
        card2, _ = run_ndt_port("cuda", tm)
        cpu, cpu_stats = run_ndt_port("cpu", tm)
        row = {"mode": "ndt_tm" if tm else "ndt_om",
               "oracle": compare_to_oracle(oracle_map, card, tm),
               "card_vs_cpu": compare_port(card, cpu),
               "card_runs_bit_identical": maps_bit_identical(card, card2),
               "stats": {k: stats[k] for k in ("ndt_flagged", "ndt_overflow", "missed_updates",
                                               "overflow", "compaction_dropped")},
               "stats_equal_cpu": stats == cpu_stats}
        row["ok"] = bool(row["oracle"]["ok"] and row["card_vs_cpu"]["ok"]
                         and row["card_runs_bit_identical"] and row["stats_equal_cpu"]
                         and stats["ndt_flagged"] > 0 and stats["ndt_overflow"] == 0)
        rows.append(row)
    emit({"metric": "ndt_hardware_differential", "cases": rows,
          "ok": all(r["ok"] for r in rows)})
    if not all(r["ok"] for r in rows):
        raise AssertionError("NDT GPU differential failed")


def profile_main_path(mapper, batches, path: str = "occupancy", intens=None) -> None:
    """torch.profiler over synchronous integrate_rays calls: device time by
    kernel and the device's idle share of the window."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i, b in enumerate(batches):
            mapper.integrate_rays(b, intensities=None if intens is None else intens[i])
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for e in prof.key_averages():
        # Device-side rows only (kernels, copies, memsets): the host-op rows
        # repeat their children's device time.
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        rows.append({"name": e.key[:90], "calls": e.count, "ms": us / 1e3})
    rows.sort(key=lambda r: -r["ms"])
    busy = sum(r["ms"] for r in rows)
    launches = sum(r["calls"] for r in rows)
    emit({"phase": "profile", "path": path, "batches": len(batches), "wall_ms": wall_ms,
          "device_busy_ms": busy if rows else "not measured",
          "device_idle_share": 1 - busy / wall_ms if rows else "not measured",
          "device_rows": len(rows), "device_launches_per_batch": launches / len(batches),
          "top_kernels": rows[:14]})


def phase_bench(k1: dict) -> dict:
    rng = np.random.default_rng(SEED)
    m = OccupancyMap(resolution=RESOLUTION, flags=MapFlag.NONE)
    mapper = TorchRayMapper(m, capacity=CAPACITY, device="cuda")
    batches = [box_scene_rays(RAYS_PER_BATCH, rng) for _ in range(N_BATCHES)]
    mapper.prime_caps(batches)
    for i in range(WARMUP):
        mapper.integrate_rays(batches[i % N_BATCHES])
    torch.cuda.synchronize()

    # The main path, counted: every count is 0 just before it.
    expand_cuda.expand_keys.launches = 0
    deposit_cuda.deposit_and_sweep.launches = 0
    t0 = time.perf_counter()
    for b in batches:
        mapper.integrate_rays(b)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = {"expand_keys": expand_cuda.expand_keys.launches,
                "deposit_and_sweep": deposit_cuda.deposit_and_sweep.launches}
    stats = mapper.stats
    for name in ("missed_updates", "overflow", "compaction_dropped", "dropped_updates"):
        if stats[name]:
            raise AssertionError(f"main path reported {name}={stats[name]}")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel of the main path never launched: {launches}")

    # Host prep alone (the arena already holds every region).
    t0 = time.perf_counter()
    setups = [mapper._rayflow_setup_host(b, None, None, 0) for b in batches]
    host_prep_ms = (time.perf_counter() - t0) / N_BATCHES * 1e3
    wires = [torch.from_numpy(w).cuda() for w, _, _ in setups]
    torch.cuda.synchronize()

    # Device only: dispatch on resident wires; then the same with events
    # around each stage.
    t0 = time.perf_counter()
    for w, (_, cfg, n) in zip(wires, setups):
        mapper._dispatch(w, cfg, n)
    torch.cuda.synchronize()
    device_ms = (time.perf_counter() - t0) / N_BATCHES * 1e3
    occ = mapper.arena.occupancy
    stage = {"expand": 0.0, "sort": 0.0, "deposit": 0.0}
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    for w, (_, cfg, _) in zip(wires, setups):
        ev[0].record()
        records, _ = expand_records(unpack_batch(w, cfg), cfg)
        ev[1].record()
        key_s = torch.sort(records["key"]).values
        ev[2].record()
        deposit_cuda.deposit_and_sweep(occ, key_s, cfg)
        ev[3].record()
        torch.cuda.synchronize()
        for i, name in enumerate(stage):
            stage[name] += ev[i].elapsed_time(ev[i + 1]) / N_BATCHES
    mapper._drain_stats()

    # Each kernel beside its plain version, at the main path's shapes.
    b, cfg = k1["wire"]
    k1_plain, k1_kern = plain_vs_kernel_ms(
        lambda: expand_cuda.expand_keys_reference(b, cfg),
        lambda: expand_cuda.expand_keys(b, cfg))
    cfg0 = setups[0][1]
    records, _ = expand_records(unpack_batch(wires[0], cfg0), cfg0)
    key_s = torch.sort(records["key"]).values
    occ_a, occ_b = occ.clone(), occ.clone()
    k2_plain, k2_kern = plain_vs_kernel_ms(
        lambda: deposit_cuda.deposit_and_sweep_reference(occ_a, key_s, cfg0),
        lambda: deposit_cuda.deposit_and_sweep(occ_b, key_s, cfg0))

    profile_main_path(mapper, batches[:8])

    rays_per_sec = RAYS_PER_BATCH * N_BATCHES / elapsed
    emit({"metric": "occupancy_integrate_rays_per_sec", "value": rays_per_sec,
          "unit": "rays/s", "batches": N_BATCHES, "rays_per_batch": RAYS_PER_BATCH,
          "host_prep_ms_per_batch": host_prep_ms, "device_ms_per_batch": device_ms,
          "stage_ms_per_batch": stage, "keys_per_batch": int(records["key"].numel()),
          "wire_bytes_per_ray": setups[0][0].nbytes / RAYS_PER_BATCH,
          "kernel_ms": {"expand_keys": k1_kern, "deposit_and_sweep": k2_kern},
          "plain_ms": {"expand_keys": k1_plain, "deposit_and_sweep": k2_plain},
          "launches": launches,
          "stats": {k: stats[k] for k in ("missed_updates", "overflow", "compaction_dropped")},
          "max_memory_allocated_bytes": torch.cuda.max_memory_allocated()})
    return {"launches": launches, "ms": {"expand_keys": k1_kern, "deposit_and_sweep": k2_kern},
            "plain_ms": {"expand_keys": k1_plain, "deposit_and_sweep": k2_plain}}


def _snapshot(x):
    """A copy of a call's argument as it is now: tensors cloned, through
    tuples and dicts (the NDT deposit updates the arena in place)."""
    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, (tuple, list)):
        return type(x)(_snapshot(v) for v in x)
    if isinstance(x, dict):
        return {k: _snapshot(v) for k, v in x.items()}
    return x


@contextlib.contextmanager
def first_call_args(module, name):
    """Within the block, record the (args, kwargs) of the first call of
    ``module.name`` as they were when it was called; the call still runs."""
    fn = getattr(module, name)
    seen = []

    def wrapper(*args, **kwargs):
        if not seen:
            seen.append((_snapshot(args), _snapshot(kwargs)))
        return fn(*args, **kwargs)
    wrapper.launches = 0  # the wrapped function counts under its module name
    setattr(module, name, wrapper)
    try:
        yield seen
    finally:
        setattr(module, name, fn)


def phase_ndt_om_bench() -> dict:
    rng = np.random.default_rng(SEED)
    m = OccupancyMap(resolution=NDT_RESOLUTION, flags=MapFlag.NONE)
    mapper = TorchNdtMap(m, capacity=NDT_CAPACITY, device="cuda")
    batches = [box_scene_rays(RAYS_PER_BATCH, rng) for _ in range(N_BATCHES)]
    mapper.prime_caps(batches)
    for i in range(NDT_WARMUP):
        mapper.integrate_rays(batches[i % N_BATCHES])
    # Reading the stats drains them: miss_k, sized on the fourth batch,
    # escalates here if the warm-up overflowed it.
    overflow_before = mapper.stats["ndt_overflow"]
    torch.cuda.synchronize()

    # The NDT-OM path, counted: every count is 0 just before it.
    counters = {"expand_keys": expand_cuda.expand_keys,
                "gather_plane": gather_cuda.gather_plane,
                "deposit_and_sweep_ndt": deposit_cuda.deposit_and_sweep_ndt}
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    for b in batches:
        mapper.integrate_rays(b)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    stats = mapper.stats
    timed_overflow = stats["ndt_overflow"] - overflow_before
    for name in ("missed_updates", "overflow", "compaction_dropped", "dropped_updates"):
        if stats[name]:
            raise AssertionError(f"NDT-OM path reported {name}={stats[name]}")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel of the NDT-OM path never launched: {launches}")

    t0 = time.perf_counter()
    setups = [mapper._rayflow_setup_host(b, None, None, 0) for b in batches]
    host_prep_ms = (time.perf_counter() - t0) / N_BATCHES * 1e3
    wires = [torch.from_numpy(w).cuda() for w, _, _ in setups]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for w, (_, cfg, n) in zip(wires, setups):
        mapper._dispatch(w, cfg, n)
    torch.cuda.synchronize()
    device_ms = (time.perf_counter() - t0) / N_BATCHES * 1e3

    # Each kernel beside its plain version on the arguments the path gave
    # it in one more batch.
    with first_call_args(expand_cuda, "expand_keys") as k1_args, \
            first_call_args(gather_cuda, "gather_plane") as k4_args, \
            first_call_args(deposit_cuda, "deposit_and_sweep_ndt") as k3_args:
        mapper._dispatch(wires[0], setups[0][1], setups[0][2])
    torch.cuda.synchronize()
    (b, cfg0), kw = k1_args[0]
    (plane, ids, sentinel), _ = k4_args[0]
    (occ, walk, end, delta, dcfg), _ = k3_args[0]
    errs = check_ndt_path_calls(k1_args[0], k4_args[0], k3_args[0])
    kernel_ms, plain_ms = {}, {}
    plain_ms["expand_keys"], kernel_ms["expand_keys"] = plain_vs_kernel_ms(
        lambda: expand_cuda.expand_keys_reference(b, cfg0, kw["exclude_origin"], with_vox=True),
        lambda: expand_cuda.expand_keys(b, cfg0, **kw))
    plain_ms["gather_plane"], kernel_ms["gather_plane"] = plain_vs_kernel_ms(
        lambda: gather_cuda.gather_plane_reference(plane, ids, sentinel),
        lambda: gather_cuda.gather_plane(plane, ids, sentinel))
    occ_a, occ_b = occ.clone(), occ.clone()
    plain_ms["deposit_and_sweep_ndt"], kernel_ms["deposit_and_sweep_ndt"] = plain_vs_kernel_ms(
        lambda: deposit_cuda.deposit_and_sweep_ndt_reference(occ_a, walk, end, delta, dcfg),
        lambda: deposit_cuda.deposit_and_sweep_ndt(occ_b, walk, end, delta, dcfg))
    mapper._drain_stats()

    profile_main_path(mapper, batches[:8], path="ndt_om")
    rays_per_sec = RAYS_PER_BATCH * N_BATCHES / elapsed
    emit({"metric": "ndt_om_rays_per_sec", "value": rays_per_sec, "unit": "rays/s",
          "batches": N_BATCHES, "warmup": NDT_WARMUP, "rays_per_batch": RAYS_PER_BATCH,
          "resolution": NDT_RESOLUTION, "capacity": NDT_CAPACITY, "miss_k": mapper.miss_k,
          "host_prep_ms_per_batch": host_prep_ms, "device_ms_per_batch": device_ms,
          "walk_keys_per_batch": walk.numel(), "k_stream": delta[0].numel(),
          "kernel_ms": kernel_ms, "plain_ms": plain_ms, "launches": launches,
          "timed_ndt_overflow": timed_overflow,
          "stats": {k: stats[k] for k in ("missed_updates", "overflow", "compaction_dropped",
                                          "ndt_overflow", "ndt_flagged")},
          "max_memory_allocated_bytes": torch.cuda.max_memory_allocated()})
    return {"launches": launches, "ms": kernel_ms, "plain_ms": plain_ms, "max_abs_err": errs}


def check_ndt_path_calls(k1_call, k4_call, k3_call) -> dict:
    """Each kernel against its plain version on the arguments the NDT-OM
    path gave it (0.2 m voxels, 1024 slots, the intensity wire): K1's keys
    and missed count, and its voxel planes on lanes whose key is not the
    sentinel; K4's output; K3's occupancy bits and touched count, each run
    on its own clone of the arena.  Bit for bit; raises on any difference."""
    (b, cfg), kw = k1_call
    key_k, aux = expand_cuda.expand_keys(b, cfg, **kw)
    key_p, missed_p, vox_p = expand_cuda.expand_keys_reference(
        b, cfg, kw["exclude_origin"], with_vox=True)
    live = key_p != cfg.sentinel
    vk, vp = aux["vox"][live], vox_p[live]
    k1_err = max(int((key_k.long() - key_p.long()).abs().max()),
                 int((vk.long() - vp.long()).abs().max()) if vk.numel() else 0)
    k1_ok = (torch.equal(key_k, key_p) and torch.equal(vk, vp) and vk.numel() > 0
             and int(aux["missed_n"]) == int(missed_p))

    (plane, ids, sentinel), _ = k4_call
    out_k = gather_cuda.gather_plane(plane, ids, sentinel)
    out_p = gather_cuda.gather_plane_reference(plane, ids, sentinel)
    k4_err = int((out_k - out_p).abs().max())
    k4_ok = torch.equal(out_k, out_p)

    (occ, walk, end, delta, dcfg), _ = k3_call
    occ_k, touched_k = deposit_cuda.deposit_and_sweep_ndt(occ.clone(), walk, end, delta, dcfg)
    occ_p, touched_p = deposit_cuda.deposit_and_sweep_ndt_reference(
        occ.clone(), walk, end, delta, dcfg)
    torch.cuda.synchronize()
    fin = torch.isfinite(occ_k) & torch.isfinite(occ_p)
    k3_err = float((occ_k[fin] - occ_p[fin]).abs().max())
    changed = int((occ_k.view(torch.int32) != occ.view(torch.int32)).sum())
    k3_ok = (torch.equal(occ_k.view(torch.int32), occ_p.view(torch.int32))
             and int(touched_k) == int(touched_p) and changed > 0)

    row = {"expand_keys": {"lanes_compared": int(live.sum()), "missed": int(missed_p),
                           "max_abs_err": k1_err, "bit_identical": bool(k1_ok)},
           "gather_plane": {"ids": ids.numel(), "flagged": int(out_k.sum()),
                            "max_abs_err": k4_err, "bit_identical": bool(k4_ok)},
           "deposit_and_sweep_ndt": {"walk_keys": walk.numel(), "end_keys": end.numel(),
                                     "k_stream": delta[0].numel(), "touched": int(touched_k),
                                     "changed": changed, "max_abs_err": k3_err,
                                     "bit_identical": bool(k3_ok)}}
    emit({"phase": "ndt_om_kernel_checks", "tolerance": 0, **row})
    if not (k1_ok and k4_ok and k3_ok):
        raise AssertionError(f"a kernel differs from its plain version on the NDT-OM path: {row}")
    return {name: r["max_abs_err"] for name, r in row.items()}


def phase_ndt_tm_frame() -> None:
    rng = np.random.default_rng(SEED)
    m = OccupancyMap(resolution=NDT_RESOLUTION, flags=MapFlag.NONE)
    mapper = TorchNdtMap(m, params=NdtParams(ndt_tm=True), capacity=NDT_CAPACITY,
                         miss_k=TM_MISS_K, device="cuda")
    frame = box_scene_rays(TM_FRAME_RAYS, rng, half=TM_HALF)
    intens = rng.uniform(0.0, 1.0, TM_FRAME_RAYS).astype(np.float32)
    step = 2 * RAYS_PER_BATCH
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(0, frame.shape[0], step):
        mapper.integrate_rays(frame[i:i + step], intensities=intens[i // 2:i // 2 + RAYS_PER_BATCH])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    stats = mapper.stats
    for name in ("missed_updates", "overflow", "compaction_dropped"):
        if stats[name]:
            raise AssertionError(f"NDT-TM frame reported {name}={stats[name]}")
    t0 = time.perf_counter()
    mapper.sync_voxels()
    sync_s = time.perf_counter() - t0
    lay = ndt_map_layers(m)
    observed = sum(int(np.isfinite(d["occupancy"]).sum()) for d in lay.values())
    finite = all(np.isfinite(d["cov"]).all() and np.isfinite(d["intensity"]).all()
                 for d in lay.values())
    if observed == 0 or not finite or stats["ndt_flagged"] == 0:
        raise AssertionError(f"NDT-TM frame: observed={observed} finite={finite} "
                             f"ndt_flagged={stats['ndt_flagged']}")
    emit({"metric": "ndt_tm_integrate_rays_per_sec", "value": TM_FRAME_RAYS / seconds,
          "unit": "rays/s", "seconds": seconds, "rays": TM_FRAME_RAYS,
          "batches": TM_FRAME_RAYS // RAYS_PER_BATCH, "miss_k": mapper.miss_k,
          "sync_voxels_s": sync_s, "observed_voxels": observed,
          "stats": {k: stats[k] for k in ("ndt_overflow", "ndt_flagged", "missed_updates")}})


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs one NVIDIA GPU",
              file=sys.stderr)
        return 1
    info = phase_device()
    phase_build()
    # The occupancy path first: the NDT kernel checks allocate arena-sized
    # host and device buffers, and ahead of its timed run they slowed it.
    k1 = phase_k1()
    k2 = phase_k2()
    phase_hardware_differential()
    bench = phase_bench(k1)
    k1_vox = phase_k1_vox(k1)
    k3 = phase_k3()
    k4 = phase_k4()
    phase_ndt_hardware_differential()
    ndt = phase_ndt_om_bench()
    phase_ndt_tm_frame()
    if "jax" in sys.modules:
        raise AssertionError("JAX was imported")
    # launches: each kernel's count on its path (K1: the occupancy path; it
    # also runs on the NDT-OM path, whose count is "ndt_om_launches").
    emit({"kernels": [
        {"name": "expand_keys", "route": "cuda", "source": "ohm_tpu_torch/csrc/expand.cu",
         "replaces": "ohm_tpu/ops/expand_pallas.py:185",
         "launches": bench["launches"]["expand_keys"],
         "max_abs_err": max(k1["max_abs_err"], k1_vox["max_abs_err"],
                            ndt["max_abs_err"]["expand_keys"]),
         "ms": bench["ms"]["expand_keys"], "plain_ms": bench["plain_ms"]["expand_keys"],
         "ndt_om_launches": ndt["launches"]["expand_keys"],
         "with_vox_ms": ndt["ms"]["expand_keys"],
         "with_vox_plain_ms": ndt["plain_ms"]["expand_keys"]},
        {"name": "deposit_and_sweep", "route": "cuda", "source": "ohm_tpu_torch/csrc/deposit.cu",
         "replaces": "ohm_tpu/ops/deposit_pallas.py:439",
         "launches": bench["launches"]["deposit_and_sweep"], "max_abs_err": k2["max_abs_err"],
         "ms": bench["ms"]["deposit_and_sweep"],
         "plain_ms": bench["plain_ms"]["deposit_and_sweep"]},
        {"name": "deposit_and_sweep_ndt", "route": "cuda",
         "source": "ohm_tpu_torch/csrc/deposit.cu",
         "replaces": "ohm_tpu/ops/deposit_pallas.py:449",
         "launches": ndt["launches"]["deposit_and_sweep_ndt"],
         "max_abs_err": max(k3["max_abs_err"], ndt["max_abs_err"]["deposit_and_sweep_ndt"]),
         "ms": ndt["ms"]["deposit_and_sweep_ndt"],
         "plain_ms": ndt["plain_ms"]["deposit_and_sweep_ndt"]},
        {"name": "gather_plane", "route": "cuda", "source": "ohm_tpu_torch/csrc/gather.cu",
         "replaces": "ohm_tpu/ops/deposit_pallas.py:479",
         "launches": ndt["launches"]["gather_plane"],
         "max_abs_err": max(k4["max_abs_err"], ndt["max_abs_err"]["gather_plane"]),
         "ms": ndt["ms"]["gather_plane"], "plain_ms": ndt["plain_ms"]["gather_plane"]},
    ]})
    print(info["nvidia_smi"], flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
