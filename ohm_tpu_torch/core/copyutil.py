"""Filtered map-to-map copy (reference: ohm/CopyUtil.{h,cpp}).

Supports layer filters, AABB region filters and updated-since-stamp
incremental sync between maps with compatible layouts.
"""

from __future__ import annotations

import numpy as np


def can_copy(dst_map, src_map) -> bool:
    """Maps must share resolution, region dims and origin (reference: canCopy)."""
    return (
        dst_map.resolution == src_map.resolution
        and np.array_equal(dst_map.region_voxel_dims, src_map.region_voxel_dims)
        and np.allclose(dst_map.origin, src_map.origin)
    )


def copy_map(dst_map, src_map, layers=None, extents=None, updated_since=None) -> int:
    """Copy chunks from src to dst.

    layers: layer-name list (default: all layers present in both layouts).
    extents: (min, max) world AABB; only overlapping regions copy.
    updated_since: stamp; only chunks with dirty_stamp > updated_since copy
    (reference: copyMapFilters + collectDirtyRegions).
    Returns the number of chunks copied.
    """
    if not can_copy(dst_map, src_map):
        raise ValueError("maps are incompatible for copy (resolution/dims/origin)")
    if layers is None:
        layers = [l.name for l in src_map.layout if dst_map.layout.layer(l.name)]
    copied = 0
    for key, chunk in src_map.chunks.items():
        if updated_since is not None and chunk.dirty_stamp <= updated_since:
            continue
        if extents is not None:
            if not chunk.overlaps_extents(np.asarray(extents[0]), np.asarray(extents[1]),
                                          src_map.region_spatial_dims):
                continue
        dst_chunk = dst_map.region(key, allow_create=True)
        for name in layers:
            si = src_map.layout.layer_index(name)
            di = dst_map.layout.layer_index(name)
            if si < 0 or di < 0:
                continue
            dst_chunk.layers[di] = chunk.layers[si].copy()
            dst_chunk.touched_stamps[di] = chunk.touched_stamps[si]
        dst_chunk.dirty_stamp = chunk.dirty_stamp
        dst_chunk.touched_time = chunk.touched_time
        copied += 1
    return copied
