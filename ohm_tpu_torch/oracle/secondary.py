"""Secondary (dual-return) sample mapper.

Reference parity: ohm/RayMapperSecondarySample.{h,cpp} +
ohm/VoxelSecondarySample.h — per secondary sample, update Welford range
statistics (quantised mean, m2) in the voxel containing the secondary
sample.  Rays are (primary_sample, secondary_sample) pairs; the "range" is
the distance between them.  CPU only in the reference
(docs/docvoxellayers.md:113).
"""

from __future__ import annotations

import numpy as np

from ohm_tpu_torch.core import keys as keymath
from ohm_tpu_torch.core.layout import SECONDARY_SAMPLES_LAYER

QUANTISATION_FACTOR = 1000.0
MAX_RANGE = (np.iinfo(np.uint16).max - 1) / QUANTISATION_FACTOR


def add_secondary_sample(voxel, idx, range_: float):
    """Welford update (reference: ohm/VoxelSecondarySample.h:87-99)."""
    range_ = min(float(range_), MAX_RANGE)
    range_mean = float(voxel["range_mean"][idx]) / QUANTISATION_FACTOR
    count = int(voxel["count"][idx]) + 1
    delta = range_ - range_mean
    range_mean += delta / count
    voxel["range_mean"][idx] = np.uint16(range_mean * QUANTISATION_FACTOR)
    delta2 = range_ - range_mean
    voxel["m2"][idx] = voxel["m2"][idx] + np.float32(delta * delta2)
    voxel["count"][idx] = count


def secondary_sample_range_mean(voxel, idx) -> float:
    return float(voxel["range_mean"][idx]) / QUANTISATION_FACTOR


def secondary_sample_std_dev(voxel, idx) -> float:
    count = int(voxel["count"][idx])
    if count < 2:
        return 0.0
    return float(np.sqrt(voxel["m2"][idx] / count))


class RayMapperSecondarySample:
    """Dual-return statistics mapper (reference API: RayMapperSecondarySample.h:21-66)."""

    def __init__(self, map_obj):
        self.map = map_obj
        map_obj.layout.add_secondary_samples()
        map_obj.ensure_chunk_layers()
        self.layer = map_obj.layer_index(SECONDARY_SAMPLES_LAYER)

    def integrate_rays(self, rays, intensities=None, timestamps=None, ray_update_flags=0):
        m = self.map
        rays = np.asarray(rays, dtype=np.float64).reshape(-1, 3)
        n = rays.shape[0] // 2
        dims = m.region_voxel_dims
        m.touch()
        for i in range(n):
            primary = rays[2 * i]
            secondary = rays[2 * i + 1]
            rng = float(np.linalg.norm(secondary - primary))
            region, local = m.voxel_key(secondary)
            chunk = m.region(region, allow_create=True)
            idx = int(keymath.voxel_index(local, dims))
            add_secondary_sample(chunk.layers[self.layer], idx, rng)
            chunk.dirty_stamp = m.stamp
            chunk.touched_stamps[self.layer] = m.stamp
        return n
