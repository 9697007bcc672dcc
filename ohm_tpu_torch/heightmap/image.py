"""HeightmapImage: render a heightmap mesh to normals / depth bitmaps.

Reference parity: ohmheightmapimage/HeightmapImage.h:27-160 — the reference
renders the triangulated heightmap into an offscreen OpenGL FBO producing
kImageNormals (RGB f32), kImageNormals888 (RGB24) or kImageHeights (f32
depth) bitmaps, with values interpolated across triangles.  Here the same
bitmaps come from a vectorised barycentric software rasteriser (no GL): each
triangle's pixels interpolate vertex heights/normals exactly as the GPU
pipeline would.

Normal encoding matches the reference contract (HeightmapImage.h:111-121):
a horizontal surface maps to colour (0.5, 0.5, 1.0); recover the normal by
remapping each channel from [0, 1] to [-1, 1].
"""

from __future__ import annotations

import dataclasses
from enum import IntEnum

import numpy as np

from ohm_tpu_torch.heightmap.heightmap import _AXIS_OF


class ImageType(IntEnum):
    """Reference: HeightmapImage::ImageType."""

    NORMALS = 0      # RGB f32 normals
    NORMALS_888 = 1  # RGB24 normals
    HEIGHTS = 2      # f32 relative depth


@dataclasses.dataclass
class BitmapInfo:
    """Reference: HeightmapImage::BitmapInfo."""

    image_width: int = 0
    image_height: int = 0
    bpp: int = 0
    image_type: ImageType = ImageType.NORMALS
    image_extents_min: np.ndarray | None = None
    image_extents_max: np.ndarray | None = None


class HeightmapImage:
    """Software render of a heightmap mesh (reference: HeightmapImage)."""

    def __init__(self, image_type: ImageType = ImageType.NORMALS, pixels_per_voxel: int = 1):
        self.desired_image_type = ImageType(image_type)
        self.pixels_per_voxel = max(1, int(pixels_per_voxel))
        self._bitmap = None
        self._info = BitmapInfo()

    def bitmap(self):
        """(array, BitmapInfo) of the last render; array is [H, W, 3] u8 for
        NORMALS_888, [H, W, 3] f32 for NORMALS, [H, W] f32 for HEIGHTS."""
        return self._bitmap, self._info

    def generate_bitmap(self, mesh, up_axis) -> bool:
        """Render a HeightmapMesh (reference: generateBitmap(mesh, up))."""
        if mesh.vertices is None or mesh.triangle_count() == 0:
            return False
        axis = _AXIS_OF[up_axis]
        up_sign = 1.0 if int(up_axis) >= 0 else -1.0
        plane = [i for i in range(3) if i != axis]

        verts = np.asarray(mesh.vertices, np.float64)
        tris = np.asarray(mesh.triangles, np.int64)
        normals = np.asarray(mesh.vertex_normals, np.float64)

        uv = verts[:, plane]
        depth = verts[:, axis] * up_sign
        lo = uv.min(axis=0)
        hi = uv.max(axis=0)
        # Pixel pitch from the mesh's grid spacing (voxel resolution).
        diffs = np.abs(np.diff(np.unique(np.round(uv[:, 0], 9))))
        pitch = float(diffs[diffs > 1e-9].min()) if (diffs > 1e-9).any() else 1.0
        pitch /= self.pixels_per_voxel
        W = int(np.floor((hi[0] - lo[0]) / pitch)) + 1
        H = int(np.floor((hi[1] - lo[1]) / pitch)) + 1

        img_n = np.zeros((H, W, 3), np.float32)
        img_d = np.zeros((H, W), np.float32)
        img_z = np.full((H, W), -np.inf, np.float32)  # depth buffer (up = near)

        px = (uv - lo) / pitch  # vertex pixel coordinates
        for t in tris:
            p = px[t]  # [3, 2]
            zmin = np.floor(p.min(axis=0)).astype(int)
            zmax = np.ceil(p.max(axis=0)).astype(int)
            xs = np.arange(max(zmin[0], 0), min(zmax[0], W - 1) + 1)
            ys = np.arange(max(zmin[1], 0), min(zmax[1], H - 1) + 1)
            if not len(xs) or not len(ys):
                continue
            gx, gy = np.meshgrid(xs, ys)
            # Barycentric coordinates.
            d = (p[1, 1] - p[2, 1]) * (p[0, 0] - p[2, 0]) + (p[2, 0] - p[1, 0]) * (p[0, 1] - p[2, 1])
            if abs(d) < 1e-12:
                continue
            w0 = ((p[1, 1] - p[2, 1]) * (gx - p[2, 0]) + (p[2, 0] - p[1, 0]) * (gy - p[2, 1])) / d
            w1 = ((p[2, 1] - p[0, 1]) * (gx - p[2, 0]) + (p[0, 0] - p[2, 0]) * (gy - p[2, 1])) / d
            w2 = 1.0 - w0 - w1
            inside = (w0 >= -1e-9) & (w1 >= -1e-9) & (w2 >= -1e-9)
            if not inside.any():
                continue
            z = w0 * depth[t[0]] + w1 * depth[t[1]] + w2 * depth[t[2]]
            n = (w0[..., None] * normals[t[0]] + w1[..., None] * normals[t[1]]
                 + w2[..., None] * normals[t[2]])
            yy = gy[inside]
            xx = gx[inside]
            zz = z[inside].astype(np.float32)
            win = zz > img_z[yy, xx]
            yy, xx, zz = yy[win], xx[win], zz[win]
            img_z[yy, xx] = zz
            img_d[yy, xx] = zz
            nn = n[inside][win]
            nn /= np.maximum(np.linalg.norm(nn, axis=-1, keepdims=True), 1e-12)
            img_n[yy, xx] = nn

        covered = np.isfinite(img_z)
        zmin = float(img_d[covered].min()) if covered.any() else 0.0
        img_d = np.where(covered, img_d - zmin, 0.0).astype(np.float32)

        # Normal channels: remap [-1, 1] -> [0, 1]; up axis in blue
        # (horizontal surface -> (0.5, 0.5, 1.0), HeightmapImage.h:114-118).
        enc = np.zeros((H, W, 3), np.float32)
        enc[..., 0] = 0.5 * (img_n[..., plane[0]] + 1.0)
        enc[..., 1] = 0.5 * (img_n[..., plane[1]] + 1.0)
        enc[..., 2] = 0.5 * (img_n[..., axis] * up_sign + 1.0)
        enc = np.where(covered[..., None], enc, 0.0)

        if self.desired_image_type == ImageType.HEIGHTS:
            self._bitmap = img_d
            bpp = 4
        elif self.desired_image_type == ImageType.NORMALS_888:
            self._bitmap = np.clip(enc * 255.0 + 0.5, 0, 255).astype(np.uint8)
            bpp = 3
        else:
            self._bitmap = enc
            bpp = 12
        self._info = BitmapInfo(image_width=W, image_height=H, bpp=bpp,
                                image_type=self.desired_image_type,
                                image_extents_min=np.append(lo, zmin),
                                image_extents_max=np.append(hi, float(depth.max())))
        return True

    def generate_from_heightmap(self, heightmap) -> bool:
        """Convenience: triangulate a built Heightmap, then render it."""
        from ohm_tpu_torch.heightmap.mesh import HeightmapMesh

        mesh = HeightmapMesh()
        if not mesh.build_mesh(heightmap):
            return False
        return self.generate_bitmap(mesh, heightmap.up_axis)
