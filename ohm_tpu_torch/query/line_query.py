"""LineQuery: voxels along a segment with per-voxel clearance.

Reference parity: ohm/LineQuery.{h,cpp} (CPU brute force / TBB) and
ohmgpu/LineQueryGpu.cpp (clearance layer via ClearanceProcess).  This
implementation follows the GPU variant: ensure the clearance layer is
current for the touched regions, then walk the line reading it.
"""

from __future__ import annotations

import numpy as np

from ohm_tpu_torch.core import keys as keymath
from ohm_tpu_torch.core.layout import CLEARANCE_LAYER, OCCUPANCY_LAYER
from ohm_tpu_torch.oracle import linewalk
from ohm_tpu_torch.query.clearance import ClearanceProcess
from ohm_tpu_torch.query.base import AsyncQueryMixin


class LineQuery(AsyncQueryMixin):
    def __init__(self, map_obj, start_point=(0, 0, 0), end_point=(0, 0, 0),
                 search_radius: float = 1.0, query_flags: int = 0):
        self.map = map_obj
        self.start_point = np.asarray(start_point, dtype=np.float64)
        self.end_point = np.asarray(end_point, dtype=np.float64)
        self.search_radius = float(search_radius)
        self.query_flags = query_flags
        self.intersected_voxels = None  # abs voxel coords
        self.ranges = None  # clearance per voxel

    def set_line(self, start_point, end_point):
        self.start_point = np.asarray(start_point, dtype=np.float64)
        self.end_point = np.asarray(end_point, dtype=np.float64)

    def execute(self):
        m = self.map
        # Collect the line's voxels with the shared oracle walk (queries are
        # small; the device path is not worth a dispatch here).
        voxels = []

        def visit(abs_key, _marker, _enter, _exit):
            voxels.append(abs_key.copy())
            return True

        linewalk.walk_segment_keys(m, self.start_point, self.end_point, visit)
        voxels = np.array(voxels, dtype=np.int32).reshape(-1, 3)

        # Ensure clearance coverage for the touched regions.
        dims = m.region_voxel_dims
        regions = np.unique(np.floor_divide(voxels, dims), axis=0)
        present = [tuple(int(v) for v in r) for r in regions if m.region(tuple(int(v) for v in r)) is not None]
        proc = ClearanceProcess(m, self.search_radius, self.query_flags)
        if present:
            proc.update(present, force=True)

        clear_idx = m.layer_index(CLEARANCE_LAYER)
        ranges = np.full(len(voxels), -1.0, np.float32)
        region, local = keymath.abs_to_key(voxels, dims)
        idx = keymath.voxel_index(local, dims)
        for i in range(len(voxels)):
            chunk = m.region(region[i])
            if chunk is not None:
                ranges[i] = chunk.layers[clear_idx][CLEARANCE_LAYER][int(idx[i])]
        self.intersected_voxels = voxels
        self.ranges = ranges
        return True

    def number_of_results(self) -> int:
        return 0 if self.ranges is None else len(self.ranges)
