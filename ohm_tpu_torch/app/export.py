"""Map export helpers shared by ohm2ply / ohmpop (reference: utils/ohm2ply).

Extraction modes: occupancy (mean-preferred points), occupancy-centre,
covariance (NDT ellipsoids), clearance, density, heightmap, heightmap-mesh.
"""

from __future__ import annotations

import numpy as np

from ohm_tpu_torch.core import keys as keymath
from ohm_tpu_torch.core import subvoxel
from ohm_tpu_torch.core.layout import (
    OCCUPANCY_LAYER,
    MEAN_LAYER,
    COVARIANCE_LAYER,
    CLEARANCE_LAYER,
    TRAVERSAL_LAYER,
)


def occupied_points(m, use_mean: bool = True):
    """Occupied voxel positions, voxel-mean preferred (ohm2ply mode occupancy)."""
    occ_idx = m.layer_index(OCCUPANCY_LAYER)
    mean_idx = m.layer_index(MEAN_LAYER) if use_mean else -1
    dims = m.region_voxel_dims
    threshold = np.float32(m.occupancy_threshold_value)
    out = []
    for key, chunk in m.chunks.items():
        occ = chunk.layers[occ_idx][OCCUPANCY_LAYER]
        sel = np.flatnonzero(np.isfinite(occ) & (occ >= threshold))
        if not sel.size:
            continue
        local = keymath.local_key_from_index(sel, dims)
        region = np.broadcast_to(np.asarray(key, np.int32), (len(sel), 3))
        pts = m.voxel_centre_global(region, local)
        if mean_idx >= 0:
            coord = chunk.layers[mean_idx]["coord"][sel]
            pts = pts + subvoxel.sub_voxel_to_local_coord(coord, m.resolution)
        out.append(pts)
    return np.concatenate(out) if out else np.zeros((0, 3))


def colour_by_height(points, axis: int = 2):
    """Simple height colourisation (ohm2ply colour mode)."""
    if not len(points):
        return np.zeros((0, 3), np.uint8)
    h = points[:, axis]
    t = (h - h.min()) / max(h.max() - h.min(), 1e-9)
    r = (255 * t).astype(np.uint8)
    b = (255 * (1 - t)).astype(np.uint8)
    g = (255 * (1 - np.abs(2 * t - 1))).astype(np.uint8)
    return np.column_stack([r, g, b])


def covariance_ellipsoids(m, stds: float = 1.0, rings: int = 8):
    """NDT ellipsoid meshes: (vertices, triangles) merged over occupied voxels.

    Reference: ohm2ply --mode=covariance ellipsoid export.
    """
    occ_idx = m.layer_index(OCCUPANCY_LAYER)
    cov_idx = m.layer_index(COVARIANCE_LAYER)
    mean_idx = m.layer_index(MEAN_LAYER)
    if cov_idx < 0:
        raise ValueError("map has no covariance layer")
    dims = m.region_voxel_dims
    threshold = np.float32(m.occupancy_threshold_value)

    # Unit sphere template.
    theta = np.linspace(0, np.pi, rings)
    phi = np.linspace(0, 2 * np.pi, 2 * rings, endpoint=False)
    tt, pp = np.meshgrid(theta, phi, indexing="ij")
    sphere = np.column_stack([
        (np.sin(tt) * np.cos(pp)).ravel(),
        (np.sin(tt) * np.sin(pp)).ravel(),
        np.cos(tt).ravel()])
    n_sph = len(sphere)
    tris = []
    P = 2 * rings
    for i in range(rings - 1):
        for j in range(P):
            a = i * P + j
            b = i * P + (j + 1) % P
            c = (i + 1) * P + j
            d = (i + 1) * P + (j + 1) % P
            tris += [(a, b, c), (b, d, c)]
    sphere_tris = np.array(tris, np.int32)

    verts_out = []
    tris_out = []
    base = 0
    for key, chunk in m.chunks.items():
        occ = chunk.layers[occ_idx][OCCUPANCY_LAYER]
        sel = np.flatnonzero(np.isfinite(occ) & (occ >= threshold))
        if not sel.size:
            continue
        cov = chunk.layers[cov_idx]
        local = keymath.local_key_from_index(sel, dims)
        region = np.broadcast_to(np.asarray(key, np.int32), (len(sel), 3))
        centres = m.voxel_centre_global(region, local)
        if mean_idx >= 0:
            centres = centres + subvoxel.sub_voxel_to_local_coord(
                chunk.layers[mean_idx]["coord"][sel], m.resolution)
        s6 = np.stack([cov[k][sel] for k in ("P00", "P01", "P11", "P02", "P12", "P22")], axis=-1)
        s_mat = np.zeros((len(sel), 3, 3))
        s_mat[:, 0, 0] = s6[:, 0]
        s_mat[:, 1, 0] = s6[:, 1]
        s_mat[:, 1, 1] = s6[:, 2]
        s_mat[:, 2, 0] = s6[:, 3]
        s_mat[:, 2, 1] = s6[:, 4]
        s_mat[:, 2, 2] = s6[:, 5]
        for j in range(len(sel)):
            v = centres[j] + stds * (sphere @ s_mat[j].T)
            verts_out.append(v)
            tris_out.append(sphere_tris + base)
            base += n_sph
    if not verts_out:
        return np.zeros((0, 3)), np.zeros((0, 3), np.int32)
    return np.concatenate(verts_out), np.concatenate(tris_out)


def clearance_points(m):
    """Voxels with computed clearance (ohm2ply mode clearance)."""
    clear_idx = m.layer_index(CLEARANCE_LAYER)
    if clear_idx < 0:
        raise ValueError("map has no clearance layer")
    dims = m.region_voxel_dims
    pts = []
    vals = []
    for key, chunk in m.chunks.items():
        c = chunk.layers[clear_idx][CLEARANCE_LAYER]
        sel = np.flatnonzero(c >= 0)
        if not sel.size:
            continue
        local = keymath.local_key_from_index(sel, dims)
        region = np.broadcast_to(np.asarray(key, np.int32), (len(sel), 3))
        pts.append(m.voxel_centre_global(region, local))
        vals.append(c[sel])
    if not pts:
        return np.zeros((0, 3)), np.zeros(0, np.float32)
    return np.concatenate(pts), np.concatenate(vals)


def density_points(m, threshold: float = 0.0):
    """Density = mean count / traversal (reference: ohm/Density.h:32-40)."""
    mean_idx = m.layer_index(MEAN_LAYER)
    trav_idx = m.layer_index(TRAVERSAL_LAYER)
    if mean_idx < 0 or trav_idx < 0:
        raise ValueError("density export requires mean + traversal layers")
    dims = m.region_voxel_dims
    pts = []
    vals = []
    for key, chunk in m.chunks.items():
        count = chunk.layers[mean_idx]["count"]
        trav = chunk.layers[trav_idx]["traversal"]
        with np.errstate(divide="ignore", invalid="ignore"):
            density = np.where(trav > 0, count / np.maximum(trav, 1e-12), 0.0)
        sel = np.flatnonzero(density > threshold)
        if not sel.size:
            continue
        local = keymath.local_key_from_index(sel, dims)
        region = np.broadcast_to(np.asarray(key, np.int32), (len(sel), 3))
        pts.append(m.voxel_centre_global(region, local))
        vals.append(density[sel].astype(np.float32))
    if not pts:
        return np.zeros((0, 3)), np.zeros(0, np.float32)
    return np.concatenate(pts), np.concatenate(vals)


def heightmap_points(m):
    """Points from a heightmap map file (ohm2ply mode heightmap)."""
    from ohm_tpu_torch.heightmap.heightmap import HEIGHTMAP_LAYER, _AXIS_OF, UpAxis

    hm_idx = m.layer_index(HEIGHTMAP_LAYER)
    occ_idx = m.layer_index(OCCUPANCY_LAYER)
    if hm_idx < 0:
        raise ValueError("not a heightmap map (no heightmap layer)")
    axis_code = m.info.get("heightmap-axis")
    axis_val = axis_code.value if hasattr(axis_code, "value") else (axis_code if axis_code is not None else 2)
    axis = _AXIS_OF[UpAxis(int(axis_val))]
    dims = m.region_voxel_dims
    pts = []
    for key, chunk in m.chunks.items():
        occ = chunk.layers[occ_idx][OCCUPANCY_LAYER]
        sel = np.flatnonzero(np.isfinite(occ))
        if not sel.size:
            continue
        local = keymath.local_key_from_index(sel, dims)
        region = np.broadcast_to(np.asarray(key, np.int32), (len(sel), 3))
        centres = m.voxel_centre_global(region, local)
        centres[:, axis] += chunk.layers[hm_idx]["height"][sel]
        pts.append(centres)
    return np.concatenate(pts) if pts else np.zeros((0, 3))
