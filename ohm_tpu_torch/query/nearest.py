"""NearestNeighbours: occupied voxels near a point within a radius.

Reference parity: ohm/NearestNeighbours.{h,cpp} (CPU brute force over
chunks).  Vectorised numpy over candidate regions — region AABB culling
replaces the reference's per-chunk iteration.
"""

from __future__ import annotations

import numpy as np

from ohm_tpu_torch.core import keys as keymath
from ohm_tpu_torch.core.layout import OCCUPANCY_LAYER
from ohm_tpu_torch.query.base import AsyncQueryMixin


class NearestNeighbours(AsyncQueryMixin):
    def __init__(self, map_obj, near_point=(0.0, 0.0, 0.0), search_radius: float = 1.0):
        self.map = map_obj
        self.near_point = np.asarray(near_point, dtype=np.float64)
        self.search_radius = float(search_radius)
        self.intersected_voxels = None  # abs voxel coords [N, 3]
        self.ranges = None

    def execute(self):
        m = self.map
        occ_idx = m.layer_index(OCCUPANCY_LAYER)
        threshold = np.float32(m.occupancy_threshold_value)
        dims = m.region_voxel_dims
        half_region = 0.5 * m.region_spatial_dims
        hits = []
        ranges = []
        for key, chunk in m.chunks.items():
            # Region AABB cull.
            nearest = np.clip(self.near_point, chunk.centre - half_region, chunk.centre + half_region)
            if np.linalg.norm(nearest - self.near_point) > self.search_radius:
                continue
            occ = chunk.layers[occ_idx][OCCUPANCY_LAYER]
            occupied = np.flatnonzero(np.isfinite(occ) & (occ >= threshold))
            if not occupied.size:
                continue
            local = keymath.local_key_from_index(occupied, dims)
            region = np.broadcast_to(np.asarray(key, np.int32), (len(occupied), 3))
            centres = m.voxel_centre_global(region, local)
            d = np.linalg.norm(centres - self.near_point, axis=1)
            sel = d <= self.search_radius
            if sel.any():
                hits.append(keymath.key_to_abs(region[sel], local[sel], dims))
                ranges.append(d[sel])
        if hits:
            self.intersected_voxels = np.concatenate(hits)
            self.ranges = np.concatenate(ranges).astype(np.float32)
        else:
            self.intersected_voxels = np.zeros((0, 3), np.int32)
            self.ranges = np.zeros(0, np.float32)
        return True

    def number_of_results(self) -> int:
        return 0 if self.ranges is None else len(self.ranges)
