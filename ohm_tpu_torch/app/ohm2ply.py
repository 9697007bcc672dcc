"""ohm2ply: export a .ohm map to PLY.

Reference parity: utils/ohm2ply (docs/docutils.md:71-97) — modes occupancy,
occupancy-centre, covariance, clearance, density, heightmap, heightmap-mesh.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def main(argv=None):
    p = argparse.ArgumentParser(prog="ohm2ply", description=__doc__)
    p.add_argument("map", help=".ohm file")
    p.add_argument("output", nargs="?", default="", help="output .ply (default: map name)")
    p.add_argument("--mode", default="occupancy",
                   choices=["occupancy", "occupancy-centre", "covariance", "clearance",
                            "density", "heightmap", "heightmap-mesh"])
    p.add_argument("--colour", default="height", choices=["none", "height"],
                   help="point colourisation")
    p.add_argument("--threshold", type=float, default=0.0, help="density threshold")
    args = p.parse_args(argv)

    import os

    from ohm_tpu_torch.io import load
    from ohm_tpu_torch.io.ply import save_cloud_ply, save_mesh_ply
    from ohm_tpu_torch.app import export

    out = args.output or os.path.splitext(args.map)[0] + ".ply"
    m, _ = load(args.map)

    if args.mode in ("occupancy", "occupancy-centre"):
        pts = export.occupied_points(m, use_mean=args.mode == "occupancy")
        colours = export.colour_by_height(pts) if args.colour == "height" else None
        save_cloud_ply(out, pts, colours=colours)
    elif args.mode == "covariance":
        verts, tris = export.covariance_ellipsoids(m)
        save_mesh_ply(out, verts, tris)
    elif args.mode == "clearance":
        pts, vals = export.clearance_points(m)
        t = vals / max(vals.max(), 1e-9)
        colours = np.column_stack([(255 * t), np.zeros_like(t), 255 * (1 - t)]).astype(np.uint8)
        save_cloud_ply(out, pts, colours=colours)
    elif args.mode == "density":
        pts, vals = export.density_points(m, args.threshold)
        colours = export.colour_by_height(pts) if len(pts) else None
        save_cloud_ply(out, pts, colours=colours)
    elif args.mode == "heightmap":
        pts = export.heightmap_points(m)
        colours = export.colour_by_height(pts) if args.colour == "height" else None
        save_cloud_ply(out, pts, colours=colours)
    elif args.mode == "heightmap-mesh":
        from ohm_tpu_torch.heightmap import Heightmap, HeightmapMesh
        from ohm_tpu_torch.heightmap.heightmap import _AXIS_OF, UpAxis

        # Rebuild a mesh directly from the serialised heightmap layer.
        pts = export.heightmap_points(m)
        hm = Heightmap()
        hm._heightmap = m
        hm._source = m
        axis_code = m.info.get("heightmap-axis")
        hm.up_axis = UpAxis(int(axis_code.value if hasattr(axis_code, "value") else (axis_code or 2)))
        mesh = HeightmapMesh()
        if not mesh.build_mesh(hm):
            print("no mesh could be generated", file=sys.stderr)
            return 1
        save_mesh_ply(out, mesh.vertices, mesh.triangles, mesh.vertex_normals)
    print(f"wrote {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
