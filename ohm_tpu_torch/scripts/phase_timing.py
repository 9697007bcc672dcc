"""Per-stage timing of the port's integrate pipeline (the counterpart of
scripts/phase_timing.py).

    python -m ohm_tpu_torch.scripts.phase_timing                 # on the card
    python -m ohm_tpu_torch.scripts.phase_timing --device cpu --rays 512 --capacity 256

bench.py's box scene (seed 2024, 0.1 m voxels, 32^3 regions), ``--rays``
rays a batch (8192) through TorchRayMapper on the rayflow wire: three
warm-up batches (the arena holds every region after them), then each of
six batches stage by stage, each stage ended by a synchronize: host prep
(region allocation and the wire), the upload, decode + expand (K1 and the
compaction row sort), and the three applies on one expand's records, each
on its own copy of the occupancy: the split apply (a key sort and K2), the
fused row-local apply (row_cap sized as the mapper sizes it) and the delta
path (its window sized as the mapper sizes it).  Then the same batches
through synchronous integrate_rays and through the worker
(integrate_rays_async, coalesced uploads, after one untimed pass that
starts it), fenced.

Prints JSON lines: ``stages`` (ms a stage a batch: device time between
CUDA events on a card, host clock to the synchronize beside it; on the
CPU the host clock only), ``touched`` (touched voxels per batch, and the
fused and delta applies' occupancy against the split one's, bit for bit)
and ``pipelined`` (ms a batch of each loop); each with ``backend`` and
``device``.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time

import numpy as np
import torch

from ohm_tpu_torch.bench import SEED, box_scene_rays, device_keys, emit, fence
from ohm_tpu_torch.core.map import MapFlag, OccupancyMap
from ohm_tpu_torch.device import resolve_device
from ohm_tpu_torch.mapping.torch_map import TorchRayMapper
from ohm_tpu_torch.ops.integrate import (apply_delta, apply_records, apply_records_fused,
                                         expand_records)
from ohm_tpu_torch.ops.wire import decode

STAGES = ("host_prep", "upload", "expand", "split_apply", "fused_apply", "delta_apply")


class StageClock:
    """Times one stage: host clock to a synchronize, and on a card the
    device time between two CUDA events around it."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.device = device
        self.host_ms = {name: [] for name in STAGES}
        self.device_ms = {name: [] for name in STAGES}

    def __call__(self, name: str, fn):
        fence(self.device)
        if self.cuda:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
        t0 = time.perf_counter()
        out = fn()
        if self.cuda:
            end.record()
        fence(self.device)
        self.host_ms[name].append((time.perf_counter() - t0) * 1e3)
        if self.cuda:
            self.device_ms[name].append(start.elapsed_time(end))
        return out

    def row(self) -> dict:
        out = {"metric": "stages"}
        for name in STAGES:
            out[f"{name}_host_ms"] = float(np.mean(self.host_ms[name]))
            out[f"{name}_device_ms"] = (float(np.mean(self.device_ms[name])) if self.cuda
                                        else "not measured")
        return out


def run(device="cuda", rays: int = 8192, capacity: int = 2048, warmup: int = 3,
        timed: int = 6) -> list[dict]:
    device = resolve_device(device)
    rng = np.random.default_rng(SEED)
    m = OccupancyMap(resolution=0.1, flags=MapFlag.NONE)
    mapper = TorchRayMapper(m, capacity=capacity, device=device)
    batches = [box_scene_rays(rays, rng) for _ in range(warmup + timed)]
    mapper.prime_caps(batches)
    for b in batches[:warmup]:
        mapper.integrate_rays(b)
    fence(device)

    clock = StageClock(device)
    touched, same = [], {"fused": True, "delta": True}
    for b in batches[warmup:]:
        wire, cfg, n_rays = clock("host_prep", lambda: mapper._rayflow_setup_host(b, None, None, 0))
        up = clock("upload", lambda: torch.from_numpy(wire).to(device))
        records, stats = clock("expand", lambda: expand_records(decode(up, cfg), cfg))
        # The mapper's own sizing: row_cap from the stat, the delta window
        # from the split apply's touched count.
        mapper._auto_size_row_cap(stats, n_rays)
        occ0 = mapper.arena.occupancy
        split = occ0.clone()
        t = clock("split_apply", lambda: apply_records(split, records, cfg))
        touched.append(int(t))
        mapper._auto_size_scatter_cap({"touched": t}, n_rays)
        fused = occ0.clone()
        fcfg = dataclasses.replace(cfg, row_cap=max(mapper.row_cap, 256))
        clock("fused_apply", lambda: apply_records_fused(fused, records, fcfg))
        delta = occ0.clone()
        dcfg = dataclasses.replace(cfg, scatter_cap=mapper.scatter_cap)
        clock("delta_apply", lambda: apply_delta(delta, records["key"], dcfg))
        same["fused"] &= bool(torch.equal(fused.view(torch.int32), split.view(torch.int32)))
        same["delta"] &= bool(torch.equal(delta.view(torch.int32), split.view(torch.int32)))
        mapper.arena.layers["occupancy"] = split
        mapper._stats["batches"] += 1

    keys = device_keys(device)
    rows = [emit({**clock.row(), "rays_per_batch": rays, "batches": timed, **keys}),
            emit({"metric": "touched", "per_batch": touched, "row_cap": mapper.row_cap,
                  "scatter_cap": mapper.scatter_cap,
                  "fused_bit_identical": same["fused"], "delta_bit_identical": same["delta"],
                  **keys})]

    def loop(submit):
        fence(device)
        t0 = time.perf_counter()
        for b in batches[warmup:]:
            submit(b)
        mapper.flush()
        fence(device)
        return (time.perf_counter() - t0) / timed * 1e3

    loop(mapper.integrate_rays_async)  # the worker thread started, its buffers pinned
    rows.append(emit({"metric": "pipelined", "sync_ms_per_batch": loop(mapper.integrate_rays),
                      "worker_ms_per_batch": loop(mapper.integrate_rays_async),
                      "last_route": mapper.last_route, **keys}))
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cuda: the hand kernels on the card (raises without one); "
                         "cpu: their plain PyTorch versions")
    ap.add_argument("--rays", type=int, default=8192, help="rays a batch")
    ap.add_argument("--capacity", type=int, default=2048, help="arena slots")
    args = ap.parse_args(argv)
    run(args.device, args.rays, args.capacity)
    return 0


if __name__ == "__main__":
    sys.exit(main())
