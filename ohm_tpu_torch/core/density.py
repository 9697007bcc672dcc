"""Voxel density queries: hit count / traversal.

Reference parity: ohm/Density.h:32-55 — density = VoxelMean::count /
traversal.  Zero when the count is zero, the voxel is absent, or the map
lacks the mean/traversal layers; +inf when the count is non-zero but the
traversal is zero.  Interpretation/thresholding is left to the caller.

Beyond the reference's single-voxel accessor, ``voxel_density_batch`` and
``region_density`` provide vectorised forms (the natural shape for a
TPU-resident map — density over whole regions is one elementwise divide).
"""

from __future__ import annotations

import numpy as np

from ohm_tpu_torch.core.layout import MEAN_LAYER, TRAVERSAL_LAYER


def _layer_indices(m):
    mean_idx = m.layer_index(MEAN_LAYER)
    trav_idx = m.layer_index(TRAVERSAL_LAYER)
    return mean_idx, trav_idx


def voxel_density(m, key=None, point=None) -> float:
    """Density of one voxel addressed by (region, local) key or a point.

    Reference: ohm/Density.h voxelDensity(map, key).
    """
    mean_idx, trav_idx = _layer_indices(m)
    if mean_idx < 0 or trav_idx < 0:
        return 0.0
    if key is None:
        region, local = m.voxel_key(np.asarray(point, dtype=np.float64))
    else:
        region, local = key
    chunk = m.region(region)
    if chunk is None:
        return 0.0
    idx = int(m.voxel_index(np.asarray(local)))
    count = float(chunk.layers[mean_idx]["count"][idx])
    traversal = float(chunk.layers[trav_idx]["traversal"][idx])
    if count <= 0:
        return 0.0
    return count / traversal if traversal > 0 else float("inf")


def voxel_density_batch(m, points) -> np.ndarray:
    """Densities for an array of query points (f32 [N])."""
    pts = np.asarray(points, dtype=np.float64).reshape(-1, 3)
    out = np.zeros(len(pts), np.float32)
    mean_idx, trav_idx = _layer_indices(m)
    if mean_idx < 0 or trav_idx < 0:
        return out
    regions, locals_ = m.voxel_key(pts)
    for i in range(len(pts)):
        chunk = m.region(regions[i])
        if chunk is None:
            continue
        idx = int(m.voxel_index(locals_[i]))
        count = float(chunk.layers[mean_idx]["count"][idx])
        traversal = float(chunk.layers[trav_idx]["traversal"][idx])
        if count > 0:
            out[i] = count / traversal if traversal > 0 else np.inf
    return out


def region_density(m, region_key) -> np.ndarray | None:
    """Density of every voxel in one region (f32 [voxels_per_region]).

    Vectorised region-level form (one elementwise divide over the chunk).
    Returns None when the region is absent or layers are missing.
    """
    mean_idx, trav_idx = _layer_indices(m)
    if mean_idx < 0 or trav_idx < 0:
        return None
    chunk = m.region(region_key)
    if chunk is None:
        return None
    count = chunk.layers[mean_idx]["count"].astype(np.float32)
    traversal = chunk.layers[trav_idx]["traversal"]
    with np.errstate(divide="ignore", invalid="ignore"):
        d = np.where(count > 0,
                     np.where(traversal > 0, count / np.maximum(traversal, 1e-30), np.inf),
                     0.0)
    return d.astype(np.float32)
