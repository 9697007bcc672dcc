"""LineKeysQuery: batch DDA voxel key lists for many rays, on PyTorch
(CUDA or CPU).

Counterpart of ``ohm_tpu/query/line_keys.py`` (reference:
ohm/LineKeysQuery.cpp, ohmgpu/gpu/LineKeys.cl:97): for each ray, the ordered
list of voxel keys from origin to sample inclusive.  The segmented batch's
blocks go up once; the ordered walk (ops.ddawalk.walk_rays) expands every
segment in lock-step, and the padded [B, S, 3] block with its validity
comes back once, to be cut into the reference's per-ray key lists on the
host.
"""

from __future__ import annotations

import numpy as np
import torch

from ohm_tpu_torch.core import keys as keymath
from ohm_tpu_torch.device import resolve_device
from ohm_tpu_torch.mapping.batch import max_steps_for, prepare_ray_batch
from ohm_tpu_torch.ops.ddawalk import walk_rays
from ohm_tpu_torch.query.base import AsyncQueryMixin


def walk_keys(ints, floats, flags, resolution: float, max_steps: int):
    """The walk of each segment (``_walk_keys``, line_keys.py:27-39):
    voxels i32[B, S+1, 3] (the end voxel last), valid bool[B, S+1] (the end
    voxel on final segments only) and the counts."""
    end_abs = ints[:, 3:6]
    walk = walk_rays(ints[:, 0:3], end_abs, floats[:, 0:3], floats[:, 3:6], floats[:, 6],
                     resolution, max_steps)
    include_end = flags[:, 0] | flags[:, 1]  # final segments
    voxels = torch.cat([walk["voxels"], end_abs[:, None, :]], dim=1)
    valid = torch.cat([walk["valid"], (include_end & flags[:, 3])[:, None]], dim=1)
    return voxels, valid, valid.sum(dim=1)


class LineKeysQuery(AsyncQueryMixin):
    """Computes per-ray voxel key lists (reference API: ohm/LineKeysQuery.h)."""

    def __init__(self, map_obj, device="cuda"):
        self.map = map_obj
        self.device = resolve_device(device)
        self.rays = np.zeros((0, 3))
        self.result_keys = None  # list of (region, local) arrays per ray
        self.result_counts = None

    def set_rays(self, rays):
        self.rays = np.asarray(rays, dtype=np.float64).reshape(-1, 3)

    def execute(self):
        m = self.map
        prepared = prepare_ray_batch(m, self.rays)
        n_rays = self.rays.shape[0] // 2
        if prepared.n_segments == 0:
            self.result_keys = [np.zeros((0, 3), np.int32) for _ in range(n_rays)]
            self.result_counts = np.zeros(n_rays, np.int64)
            return True
        resolution = float(m.resolution)
        max_steps = max_steps_for(0.999 * float(m.region_voxel_dims.min()) * resolution,
                                  resolution)
        arrays = {k: torch.from_numpy(prepared.arrays[k]).to(self.device)
                  for k in ("ints", "floats", "flags")}
        voxels, valid, _ = walk_keys(arrays["ints"], arrays["floats"], arrays["flags"],
                                     resolution, max_steps)
        voxels, valid = voxels.cpu().numpy(), valid.cpu().numpy()

        total = prepared.n_segments
        is_first = prepared.arrays["flags"][:total, 2]
        ray_of = np.cumsum(is_first.astype(np.int64)) - 1
        if m.ray_filter is not None and n_rays:
            _, _, _, accept = m.ray_filter(self.rays[0::2], self.rays[1::2])
        else:
            accept = np.ones(n_rays, dtype=bool)
        out_idx = np.flatnonzero(accept)

        keys_per_ray = [np.zeros((0, 3), np.int32) for _ in range(n_rays)]
        for s in range(total):
            abs_keys = voxels[s][valid[s]]
            r = out_idx[ray_of[s]]
            keys_per_ray[r] = np.concatenate([keys_per_ray[r], abs_keys.astype(np.int32)])
        self.result_keys = keys_per_ray
        self.result_counts = np.array([len(k) for k in keys_per_ray], np.int64)
        return True

    def keys_for(self, ray_index):
        """Keys of one ray as (region [N,3], local [N,3])."""
        return keymath.abs_to_key(self.result_keys[ray_index], self.map.region_voxel_dims)
