"""Typed voxel accessors and geometric helpers.

Reference parity: ohm/Voxel.h (Voxel<T> layer-validated accessor),
ohm/VoxelBuffer.h (raw retained view), ohm/Aabb.h, ohm/CalculateSegmentKeys.h.
Python-side access is thin over the structured numpy chunk arrays; these
wrappers exist to give reference users the same navigation idioms
(set_key, read/write, next_in_region iteration).
"""

from __future__ import annotations

import numpy as np

from ohm_tpu_torch.core import keys as keymath


class VoxelBuffer:
    """Raw view over one chunk layer (reference: ohm/VoxelBuffer.h)."""

    def __init__(self, chunk, layer_index: int):
        self.chunk = chunk
        self.layer_index = layer_index
        self.array = chunk.layers[layer_index]

    def read_voxel(self, voxel_index: int):
        return self.array[voxel_index]

    def write_voxel(self, voxel_index: int, value):
        self.array[voxel_index] = value
        return self

    @property
    def voxel_count(self) -> int:
        return len(self.array)


class Voxel:
    """Layer-validated voxel accessor (reference: ohm/Voxel.h:291-292).

    >>> v = Voxel(map, map.layer_index("occupancy"))
    >>> v.set_key(region, local); v.read()["occupancy"]
    """

    def __init__(self, map_obj, layer_index: int, allow_create: bool = False):
        self.map = map_obj
        self.layer_index = layer_index
        self.allow_create = allow_create
        self._chunk = None
        self._voxel_index = -1

    @property
    def is_layer_valid(self) -> bool:
        return 0 <= self.layer_index < len(self.map.layout)

    @property
    def is_valid(self) -> bool:
        return self._chunk is not None and self._voxel_index >= 0

    def set_key(self, region, local) -> "Voxel":
        key = tuple(int(v) for v in np.asarray(region).reshape(3))
        if self._chunk is None or self._chunk.region_key != key:
            self._chunk = self.map.region(key, allow_create=self.allow_create)
        self._voxel_index = int(keymath.voxel_index(np.asarray(local), self.map.region_voxel_dims)) \
            if self._chunk is not None else -1
        return self

    def set_point(self, point) -> "Voxel":
        region, local = self.map.voxel_key(np.asarray(point, np.float64))
        return self.set_key(region, local)

    def read(self):
        return self._chunk.layers[self.layer_index][self._voxel_index]

    def write(self, value):
        self._chunk.layers[self.layer_index][self._voxel_index] = value
        self._chunk.dirty_stamp = self.map.stamp
        self._chunk.touched_stamps[self.layer_index] = self.map.stamp
        return self


class Aabb:
    """Axis-aligned box helpers (reference: ohm/Aabb.h)."""

    def __init__(self, min_ext, max_ext):
        self.min_ext = np.asarray(min_ext, np.float64)
        self.max_ext = np.asarray(max_ext, np.float64)

    def contains(self, point) -> bool:
        p = np.asarray(point, np.float64)
        return bool(np.all(p >= self.min_ext) and np.all(p <= self.max_ext))

    def overlaps(self, other: "Aabb") -> bool:
        return bool(np.all(self.min_ext <= other.max_ext) and np.all(other.min_ext <= self.max_ext))

    def expand(self, point):
        p = np.asarray(point, np.float64)
        self.min_ext = np.minimum(self.min_ext, p)
        self.max_ext = np.maximum(self.max_ext, p)
        return self

    @property
    def centre(self):
        return 0.5 * (self.min_ext + self.max_ext)

    @property
    def half_extents(self):
        return 0.5 * (self.max_ext - self.min_ext)


def calculate_segment_keys(map_obj, start, end, include_end: bool = True):
    """Voxel key list for one segment (reference: ohm/CalculateSegmentKeys.h).

    Returns abs voxel coords [N, 3]; split with keys.abs_to_key as needed.
    """
    from ohm_tpu_torch.oracle import linewalk

    out = []

    def visit(abs_key, _marker, _enter, _exit):
        out.append(abs_key.copy())
        return True

    flags = 0 if include_end else linewalk.EXCLUDE_END_VOXEL
    linewalk.walk_segment_keys(map_obj, start, end, visit, flags)
    return np.asarray(out, np.int32).reshape(-1, 3)
