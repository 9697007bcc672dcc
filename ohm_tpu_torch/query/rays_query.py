"""RaysQuery: per-ray range to the first occupied voxel and unobserved
volume, on PyTorch (CUDA or CPU).

Counterpart of ``ohm_tpu/query/rays_query.py`` (reference: ohm/RaysQuery,
ohmgpu/gpu/RaysQuery.cl): per visited voxel accumulate
``volume_coefficient * (exit^3 - enter^3)`` while unobserved, track the exit
range while not occupied, stop at the first occupied voxel (strictly above
the threshold), and report the terminal voxel's occupancy type.

One query is one upload of the segmented wire with its t0 float block
(mapping.batch.build_wire), one device step (``rays_query_device``: the
ordered walk, the corner-slot resolve, an occupancy gather, the
first-occupied prefix and the per-ray stitch of segment partials) and one
readback.  None of it is a Pallas kernel in the reference, so PyTorch ops
are the port.  The per-ray volume sums each ray's segments in order
(ops.segments.segment_reduce, one fixed order on every device and run);
the stitch's integer minimum and maximum are ``scatter_reduce``.
"""

from __future__ import annotations

import dataclasses
from enum import IntEnum

import numpy as np
import torch

from ohm_tpu_torch.core import keys as keymath
from ohm_tpu_torch.device import resolve_device
from ohm_tpu_torch.mapping.batch import build_wire, fill_corner_slots, prepare_ray_batch
from ohm_tpu_torch.ops.ddawalk import walk_rays
from ohm_tpu_torch.ops.integrate import resolve_corner_slots
from ohm_tpu_torch.ops.segments import segment_reduce
from ohm_tpu_torch.ops.wire import decode
from ohm_tpu_torch.query.base import AsyncQueryMixin


class OccupancyType(IntEnum):
    """Reference: ohm/OccupancyType.h (kNull=-2 .. kOccupied=1)."""

    NULL = -2
    UNOBSERVED = -1
    FREE = 0
    OCCUPIED = 1


def _unobserved(occ: torch.Tensor, zero_unobserved: bool) -> torch.Tensor:
    """The arena's unobserved marker: -0.0 ("zero") or +inf ("inf")."""
    if zero_unobserved:
        return (occ == 0) & torch.signbit(occ)
    return torch.isposinf(occ)


def rays_query_device(occupancy: torch.Tensor, upload: dict, cfg, n_pad: int,
                      zero_unobserved: bool) -> torch.Tensor:
    """The query on the device (rays_query.py:43-139): per-segment partials,
    then the per-ray stitch.  ``upload`` is the segmented batch on the
    arena's device, ``cfg`` its config (``wire_tsdf``).

    Returns f32[n_pad, 7]: (range, volume, terminal code, voxel xyz,
    has_ray).  As the reference's sequential per-ray walk: the volume sums
    the segments up to and including the first one holding an occupied
    voxel; range, terminal and voxel come from that segment (or the ray's
    last segment when nothing is occupied)."""
    b = decode(upload, cfg)
    sentinel = cfg.sentinel
    walk = walk_rays(b["start_abs"], b["end_abs"], b["start_frac"], b["direction"],
                     b["length"], cfg.resolution, cfg.max_steps)
    B, S = walk["valid"].shape
    dev = occupancy.device

    # The end voxel as a final step, for final segments only (a non-final
    # segment's boundary voxel belongs to the next segment).
    end_flat, _ = resolve_corner_slots(b["end_abs"], cfg, b["rmin"], b["corner_slots"])
    walk_flat, _ = resolve_corner_slots(walk["voxels"], cfg, b["rmin"], b["corner_slots"])
    end_step = (b["is_sample"] | b["end_as_miss"]) & b["valid"]
    ids = torch.cat([torch.where(walk["valid"], walk_flat, torch.full_like(walk_flat, sentinel)),
                     torch.where(end_step, end_flat, torch.full_like(end_flat, sentinel))[:, None]],
                    dim=1)
    enters = torch.cat([walk["enters"], walk["end_enter"][:, None]], dim=1)
    exits = torch.cat([walk["exits"], b["length"][:, None]], dim=1)
    valid = torch.cat([walk["valid"], end_step[:, None]], dim=1) & b["valid"][:, None]

    occ = occupancy[ids.long()]
    unobs = _unobserved(occ, zero_unobserved)
    occupied = valid & ~unobs & (occ > cfg.occupancy_threshold)
    # Steps strictly after the first occupied voxel are not visited.
    occ_i = occupied.to(torch.int32)
    visited = valid & ((torch.cumsum(occ_i, dim=1, dtype=torch.int32) - occ_i) == 0)

    # The unobserved volume cubes ray-global ranges (ohm/RaysQuery.cpp:
    # 147-149): segment-local times offset by the segment's start t0.
    t0 = b["t0"]
    hi = t0[:, None] + exits
    lo = t0[:, None] + enters
    cube = hi * hi * hi - lo * lo * lo
    vol = torch.where(visited & unobs, cube, torch.zeros_like(cube)).sum(dim=1)
    not_occ_visit = visited & ~occupied
    range_local = torch.where(not_occ_visit, exits, torch.zeros_like(exits)).amax(dim=1)
    occ_found = occupied.any(dim=1)

    # The terminal voxel is the last visited one.
    step = torch.arange(S + 1, dtype=torch.int64, device=dev)
    last = torch.where(visited, step, torch.full_like(step, -1)).amax(dim=1).clamp(min=0)
    term_unobs = unobs.gather(1, last[:, None])[:, 0]
    term_occ = occupied.gather(1, last[:, None])[:, 0]
    terminal = torch.where(term_unobs, int(OccupancyType.UNOBSERVED),
                           torch.where(term_occ, int(OccupancyType.OCCUPIED),
                                       int(OccupancyType.FREE)))
    terminal = torch.where(visited.any(dim=1), terminal, int(OccupancyType.NULL))
    term_vox = torch.cat([walk["voxels"], b["end_abs"][:, None, :]], dim=1)[
        torch.arange(B, device=dev), last]

    # The per-ray stitch: a ray's segments are contiguous, its first one
    # flagged exclude_start; padding segments sit at the tail.
    valid_seg = b["valid"]
    is_first = (b["exclude_start"] & valid_seg).to(torch.int64)
    ray_of = torch.clamp(torch.cumsum(is_first, 0) - 1, 0, n_pad - 1)
    pos = torch.arange(B, dtype=torch.int64, device=dev)
    found_i = occ_found.to(torch.int64)
    pre = torch.cumsum(found_i, 0) - found_i  # occupied segments before this one
    start_pre = torch.cummax(torch.where(is_first > 0, pre, torch.full_like(pre, -1)), 0).values
    seg_iter = valid_seg & (pre == start_pre)  # the segments the host loop visits

    ray_last, vol_run = segment_reduce(ray_of, torch.where(seg_iter, vol, torch.zeros_like(vol)))
    vol_ray = torch.zeros(n_pad + 1, dtype=torch.float32, device=dev)
    vol_ray[torch.where(ray_last, ray_of, torch.full_like(ray_of, n_pad))] = torch.where(
        ray_last, vol_run, torch.zeros_like(vol_run))
    big = 1 << 30
    first_occ = torch.full((n_pad,), big, dtype=torch.int64, device=dev).scatter_reduce(
        0, ray_of, torch.where(seg_iter & occ_found, pos, torch.full_like(pos, big)), "amin")
    last_seg = torch.full((n_pad,), -1, dtype=torch.int64, device=dev).scatter_reduce(
        0, ray_of, torch.where(valid_seg, pos, torch.full_like(pos, -1)), "amax")
    chosen = torch.clamp(torch.where(first_occ < big, first_occ, last_seg), 0, B - 1)
    has = last_seg >= 0
    zero = torch.zeros(n_pad, dtype=torch.float32, device=dev)
    rng_ray = torch.where(has, t0[chosen] + range_local[chosen], zero)
    state_ray = torch.where(has, terminal[chosen], int(OccupancyType.NULL))
    vox_ray = torch.where(has[:, None], term_vox[chosen], 0)
    return torch.cat([rng_ray[:, None], vol_ray[:n_pad, None], state_ray[:, None].float(),
                      vox_ray.float(), has[:, None].float()], dim=1)


class RaysQuery(AsyncQueryMixin):
    """Batch ray query (reference API: ohm/RaysQuery.h:23-45).

    Without a ``mapper``, the query builds a TorchRayMapper on ``device``
    over the map's regions and keeps it for later executes."""

    def __init__(self, map_obj=None, mapper=None, volume_coefficient: float = 1.0,
                 device="cuda"):
        self.map = map_obj if map_obj is not None else (mapper.map if mapper else None)
        self.mapper = mapper
        self.device = mapper.device if mapper is not None else resolve_device(device)
        self.volume_coefficient = float(volume_coefficient)
        self.rays = np.zeros((0, 3))
        self.ranges = None
        self.unobserved_volumes = None
        self.terminal_states = None
        self.intersected_voxels = None

    def set_rays(self, rays):
        self.rays = np.asarray(rays, dtype=np.float64).reshape(-1, 3)

    def add_rays(self, rays):
        self.rays = np.concatenate([self.rays, np.asarray(rays, dtype=np.float64).reshape(-1, 3)])

    def _prepare_device_call(self):
        """Host side of one query: batch prep, region residency, the upload
        and config.  Returns None when no segment survives the filter,
        else the arguments of :func:`rays_query_device` (split out so a
        benchmark can time the device step on a resident upload)."""
        from ohm_tpu_torch.mapping.torch_map import TorchRayMapper

        m = self.map
        mapper = self.mapper
        if mapper is None:
            # A transient arena over the map's regions, kept on the query
            # so warm executes find it resident.
            mapper = self._query_mapper = getattr(
                self, "_query_mapper", None) or TorchRayMapper(
                    m, capacity=max(64, m.region_count() + 8), device=self.device)
        prepared = prepare_ray_batch(m, self.rays, segment_length=mapper.segment_length)
        if prepared.n_segments == 0:
            return None
        # Queries see existing regions and create none: only regions the
        # host map holds are made resident.
        present = np.array([k for k in map(tuple, prepared.region_keys)
                            if m.region(k) is not None], dtype=np.int32).reshape(-1, 3)
        if len(present):
            mapper.arena.ensure_regions(present, host_map=m)
        fill_corner_slots(prepared, mapper.arena.table)

        dims0 = int(m.region_voxel_dims[0])
        cfg = dataclasses.replace(mapper._config(0), wire_tsdf=True, with_touch_time=False)
        if dims0 <= 32 and mapper.arena.capacity < 32767:
            upload = {"wire": build_wire(prepared, dims0, with_mean=True, with_tsdf=True,
                                         with_touch=False)}
        else:
            arrays = prepared.arrays
            upload = {"ints": arrays["ints"], "floats": arrays["floats"],
                      "flags": arrays["flags"]}
        upload = {k: torch.from_numpy(v).to(mapper.device) for k, v in upload.items()}
        n_rays = self.rays.shape[0] // 2
        n_pad = 64
        while n_pad < n_rays:
            n_pad *= 2
        return (mapper.arena.occupancy, upload, cfg, n_pad,
                mapper.arena.occupancy_encoding == "zero")

    def execute(self):
        m = self.map
        n_rays = self.rays.shape[0] // 2
        call = self._prepare_device_call()
        if call is None:
            self.ranges = np.zeros(n_rays, np.float32)
            self.unobserved_volumes = np.zeros(n_rays)
            self.terminal_states = np.full(n_rays, OccupancyType.NULL, np.int32)
            self.intersected_voxels = np.zeros((n_rays, 3), np.int32)
            return True
        packed = rays_query_device(*call).cpu().numpy()

        # Filtered-out rays produce no segments; stitched results map back
        # through the per-ray filter acceptance.
        if m.ray_filter is not None and n_rays:
            _, _, _, accept = m.ray_filter(self.rays[0::2], self.rays[1::2])
        else:
            accept = np.ones(n_rays, dtype=bool)
        out_idx = np.flatnonzero(accept)

        ranges = np.zeros(n_rays, np.float32)
        volumes = np.zeros(n_rays)
        states = np.full(n_rays, OccupancyType.NULL, np.int32)
        voxels = np.zeros((n_rays, 3), np.int32)
        n_stitched = len(out_idx)
        if n_stitched:
            rows = packed[:n_stitched]
            ranges[out_idx] = rows[:, 0]
            volumes[out_idx] = rows[:, 1].astype(np.float64) * self.volume_coefficient
            states[out_idx] = rows[:, 2].astype(np.int32)
            voxels[out_idx] = rows[:, 3:6].astype(np.int32)

        self.ranges = ranges
        self.unobserved_volumes = volumes
        self.terminal_states = states
        self.intersected_voxels = voxels
        return True

    def terminal_keys(self):
        """Terminal voxels as (region, local) keys."""
        return keymath.abs_to_key(self.intersected_voxels, self.map.region_voxel_dims)
