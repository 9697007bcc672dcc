"""ohmhm2img: render a heightmap .ohm to an image.

Reference parity: utils/ohmhm2img + ohmheightmapimage/HeightmapImage
(offscreen OpenGL render of heights/normals/traversability); here a direct
raster of the heightmap grid written as PNG (stdlib zlib encoder) — no GL.
"""

from __future__ import annotations

import argparse
import struct
import sys
import zlib

import numpy as np


def write_png(filename: str, rgb: np.ndarray):
    """Minimal RGB8 PNG writer (no external deps)."""
    h, w = rgb.shape[:2]
    raw = b"".join(b"\x00" + rgb[y].tobytes() for y in range(h))

    def chunk(tag, data):
        out = struct.pack(">I", len(data)) + tag + data
        return out + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)

    with open(filename, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)))
        f.write(chunk(b"IDAT", zlib.compress(raw, 6)))
        f.write(chunk(b"IEND", b""))


def main(argv=None):
    p = argparse.ArgumentParser(prog="ohmhm2img", description=__doc__)
    p.add_argument("map", help="heightmap .ohm")
    p.add_argument("output", nargs="?", default="", help="output .png / .npy")
    p.add_argument("--mode", default="height",
                   choices=["height", "heights-f32", "normals", "normals-f32", "type"],
                   help="image content; normals*/heights* are mesh-rendered with "
                        "triangle interpolation (reference: HeightmapImage kImageNormals/"
                        "kImageNormals888/kImageHeights); 'type' is a cell raster")
    p.add_argument("--pixels-per-voxel", type=int, default=1)
    args = p.parse_args(argv)

    import os

    from ohm_tpu_torch.io import load
    from ohm_tpu_torch.core import keys as keymath
    from ohm_tpu_torch.heightmap.heightmap import HEIGHTMAP_LAYER, _AXIS_OF, UpAxis
    from ohm_tpu_torch.core.layout import OCCUPANCY_LAYER

    float_mode = args.mode in ("heights-f32", "normals-f32")
    out = args.output or os.path.splitext(args.map)[0] + (".npy" if float_mode else ".png")
    m, _ = load(args.map)

    if args.mode in ("heights-f32", "normals", "normals-f32") or args.mode == "height":
        rendered = _render_mesh_modes(m, args, out, float_mode)
        if rendered is not None:
            return rendered
    hm_idx = m.layer_index(HEIGHTMAP_LAYER)
    occ_idx = m.layer_index(OCCUPANCY_LAYER)
    if hm_idx < 0:
        print("not a heightmap map", file=sys.stderr)
        return 1
    axis_code = m.info.get("heightmap-axis")
    axis = _AXIS_OF[UpAxis(int(axis_code.value if hasattr(axis_code, "value") else (axis_code or 2)))]
    plane = [i for i in range(3) if i != axis]
    dims = m.region_voxel_dims

    cells = {}
    for key, chunk in m.chunks.items():
        occ = chunk.layers[occ_idx][OCCUPANCY_LAYER]
        sel = np.flatnonzero(np.isfinite(occ))
        if not sel.size:
            continue
        local = keymath.local_key_from_index(sel, dims)
        region = np.broadcast_to(np.asarray(key, np.int32), (len(sel), 3))
        abs_keys = keymath.key_to_abs(region, local, dims)
        centres = m.voxel_centre_global(region, local)
        heights = centres[:, axis] + chunk.layers[hm_idx]["height"][sel]
        normals = np.column_stack([chunk.layers[hm_idx][f"normal_{c}"][sel] for c in "xyz"])
        for j in range(len(sel)):
            uv = (int(abs_keys[j, plane[0]]), int(abs_keys[j, plane[1]]))
            cells[uv] = (heights[j], normals[j], occ[sel[j]] >= m.occupancy_threshold_value)
    if not cells:
        print("empty heightmap", file=sys.stderr)
        return 1

    us = [uv[0] for uv in cells]
    vs = [uv[1] for uv in cells]
    u0, v0 = min(us), min(vs)
    W, H = max(us) - u0 + 1, max(vs) - v0 + 1
    img = np.zeros((H, W, 3), np.uint8)
    hs = np.array([c[0] for c in cells.values()])
    hmin, hmax = hs.min(), hs.max()
    for (u, v), (h, n, real) in cells.items():
        x, y = u - u0, H - 1 - (v - v0)
        if args.mode == "height":
            t = (h - hmin) / max(hmax - hmin, 1e-9)
            img[y, x] = (int(255 * t),) * 3
        elif args.mode == "normals":
            img[y, x] = tuple(int(127.5 * (c + 1)) for c in n)
        else:
            img[y, x] = (0, 200, 0) if real else (200, 120, 0)
    write_png(out, img)
    print(f"wrote {out} ({W}x{H})")
    return 0


def _render_mesh_modes(m, args, out, float_mode):
    """Mesh-rendered modes via HeightmapImage; returns exit code or None to
    fall back to the cell raster (mesh too small)."""
    from ohm_tpu_torch.heightmap.image import HeightmapImage, ImageType
    from ohm_tpu_torch.heightmap.mesh import HeightmapMesh
    from ohm_tpu_torch.heightmap.heightmap import Heightmap, UpAxis

    axis_code = m.info.get("heightmap-axis")
    up_axis = UpAxis(int(axis_code.value if hasattr(axis_code, "value") else (axis_code or 2)))

    # Rebuild a Heightmap wrapper around the loaded map for mesh construction.
    hm = Heightmap(up_axis=up_axis)
    hm._heightmap = m
    hm._source = m
    mesh = HeightmapMesh()
    if not mesh.build_mesh(hm):
        return None

    itype = {"height": ImageType.HEIGHTS, "heights-f32": ImageType.HEIGHTS,
             "normals": ImageType.NORMALS_888, "normals-f32": ImageType.NORMALS}[args.mode]
    img = HeightmapImage(itype, pixels_per_voxel=args.pixels_per_voxel)
    if not img.generate_bitmap(mesh, up_axis):
        return None
    bitmap, info = img.bitmap()
    if float_mode:
        np.save(out, bitmap)
    elif args.mode == "height":
        lo, hi = float(bitmap.min()), float(bitmap.max())
        g = ((bitmap - lo) / max(hi - lo, 1e-9) * 255.0).astype(np.uint8)
        write_png(out, np.repeat(g[::-1, :, None], 3, axis=2))
    else:
        write_png(out, bitmap[::-1])
    print(f"wrote {out} ({info.image_width}x{info.image_height}, {args.mode})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
