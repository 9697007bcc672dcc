"""HeightmapMesh: triangulate a heightmap into a vertex/triangle mesh.

Reference parity: ohmheightmap/HeightmapMesh.{h,cpp} (which triangulates via
a vendored Delaunay implementation).  Heightmap cells form a regular 2D
grid, so a grid triangulation (two triangles per quad of valid neighbours)
produces the same surface with simpler, vectorisable construction.  Vertex
normals are area-weighted triangle normal averages, as in the reference's
kNormalsAverage mode.
"""

from __future__ import annotations

import numpy as np

from ohm_tpu_torch.heightmap.heightmap import HEIGHTMAP_LAYER, _AXIS_OF, UpAxis
from ohm_tpu_torch.core.layout import OCCUPANCY_LAYER
from ohm_tpu_torch.core import keys as keymath


class HeightmapMesh:
    def __init__(self):
        self.vertices = None  # [N, 3] f64
        self.triangles = None  # [M, 3] int32
        self.vertex_normals = None  # [N, 3] f32

    def build_mesh(self, heightmap) -> bool:
        """Build from a generated Heightmap (single-layer surface)."""
        hm = heightmap.heightmap()
        axis = _AXIS_OF[heightmap.up_axis]
        plane_axes = [i for i in range(3) if i != axis]
        dims = hm.region_voxel_dims
        occ_layer = hm.layer_index(OCCUPANCY_LAYER)
        hm_layer = hm.layer_index(HEIGHTMAP_LAYER)

        cells = {}
        for key, chunk in hm.chunks.items():
            occ = chunk.layers[occ_layer][OCCUPANCY_LAYER]
            sel = np.flatnonzero(np.isfinite(occ))
            if not sel.size:
                continue
            local = keymath.local_key_from_index(sel, dims)
            region = np.broadcast_to(np.asarray(key, np.int32), (len(sel), 3))
            abs_keys = keymath.key_to_abs(region, local, dims)
            centres = hm.voxel_centre_global(region, local)
            h = chunk.layers[hm_layer]["height"][sel]
            for j in range(len(sel)):
                uv = (int(abs_keys[j, plane_axes[0]]), int(abs_keys[j, plane_axes[1]]))
                p = centres[j].copy()
                p[axis] += h[j]
                cells[uv] = p
        if len(cells) < 3:
            return False

        uv_list = sorted(cells.keys())
        index_of = {uv: i for i, uv in enumerate(uv_list)}
        vertices = np.array([cells[uv] for uv in uv_list])
        tris = []
        for (u, v) in uv_list:
            a = index_of.get((u, v))
            b = index_of.get((u + 1, v))
            c = index_of.get((u, v + 1))
            d = index_of.get((u + 1, v + 1))
            if a is not None and b is not None and c is not None:
                tris.append((a, b, c))
            if b is not None and d is not None and c is not None:
                tris.append((b, d, c))
        if not tris:
            return False
        triangles = np.array(tris, np.int32)

        # Area-weighted vertex normals.
        va = vertices[triangles[:, 0]]
        vb = vertices[triangles[:, 1]]
        vc = vertices[triangles[:, 2]]
        fn = np.cross(vb - va, vc - va)
        normals = np.zeros_like(vertices)
        for c in range(3):
            np.add.at(normals, triangles[:, c], fn)
        lens = np.linalg.norm(normals, axis=1, keepdims=True)
        normals = np.where(lens > 1e-12, normals / np.maximum(lens, 1e-12), 0.0)
        # Orient along +up.
        up = np.zeros(3)
        up[axis] = 1.0 if int(heightmap.up_axis) >= 0 else -1.0
        flip = (normals @ up) < 0
        normals[flip] *= -1.0

        self.vertices = vertices
        self.triangles = triangles
        self.vertex_normals = normals.astype(np.float32)
        return True

    def vertex_count(self) -> int:
        return 0 if self.vertices is None else len(self.vertices)

    def triangle_count(self) -> int:
        return 0 if self.triangles is None else len(self.triangles)
