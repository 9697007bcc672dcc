"""Synthetic map generators (reference: ohmtools/OhmGen.{h,cpp}).

Direct voxel-state seeding for tests and demos: empty boxes, box rooms with
occupied walls, and sloped ground planes.
"""

from __future__ import annotations

import numpy as np

from ohm_tpu_torch.core import keys as keymath
from ohm_tpu_torch.core.layout import OCCUPANCY_LAYER


def _set_voxels(m, points, value):
    dims = m.region_voxel_dims
    occ_idx = m.layer_index(OCCUPANCY_LAYER)
    region, local = m.voxel_key(np.asarray(points, dtype=np.float64))
    idx = keymath.voxel_index(local, dims)
    for r, i in zip(map(tuple, region.reshape(-1, 3)), np.atleast_1d(idx)):
        chunk = m.region(r, allow_create=True)
        chunk.layers[occ_idx][OCCUPANCY_LAYER][int(i)] = np.float32(value)
        chunk.dirty_stamp = m.stamp


def _voxel_grid(min_ext, max_ext, resolution):
    axes = [np.arange(min_ext[i] + resolution / 2, max_ext[i], resolution) for i in range(3)]
    g = np.meshgrid(*axes, indexing="ij")
    return np.column_stack([a.ravel() for a in g])


def fill_map_with_empty_space(m, min_ext, max_ext, value=None):
    """Set all voxels in the box to free (reference: ohmgen::fillMapWithEmptySpace)."""
    m.touch()
    value = m.miss_value if value is None else value
    pts = _voxel_grid(np.asarray(min_ext, float), np.asarray(max_ext, float), m.resolution)
    _set_voxels(m, pts, value)
    return len(pts)


def box_room(m, min_ext, max_ext, voxel_step: int = 1):
    """Free interior with occupied walls (reference: ohmgen::boxRoom)."""
    m.touch()
    res = m.resolution
    min_ext = np.asarray(min_ext, float)
    max_ext = np.asarray(max_ext, float)
    fill_map_with_empty_space(m, min_ext + res, max_ext - res)
    # Walls: the boundary voxel shells.
    pts = _voxel_grid(min_ext, max_ext, res)
    on_wall = np.zeros(len(pts), bool)
    for a in range(3):
        on_wall |= (pts[:, a] < min_ext[a] + res) | (pts[:, a] > max_ext[a] - res)
    _set_voxels(m, pts[on_wall], m.hit_value if m.hit_value > 0 else 2.0)
    return int(on_wall.sum())


def slope(m, min_ext, max_ext, gradient: float = 0.2):
    """Sloped occupied ground plane (reference: ohmgen::slope)."""
    m.touch()
    res = m.resolution
    min_ext = np.asarray(min_ext, float)
    max_ext = np.asarray(max_ext, float)
    xs = np.arange(min_ext[0] + res / 2, max_ext[0], res)
    ys = np.arange(min_ext[1] + res / 2, max_ext[1], res)
    gx, gy = np.meshgrid(xs, ys, indexing="ij")
    gz = min_ext[2] + gradient * (gx - min_ext[0])
    pts = np.column_stack([gx.ravel(), gy.ravel(), gz.ravel()])
    _set_voxels(m, pts, m.hit_value if m.hit_value > 0 else 2.0)
    return len(pts)
