"""ohmheightmap: generate a heightmap .ohm from an occupancy .ohm.

Reference parity: utils/ohmheightmap (docs/docutils.md:99-108).
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None):
    p = argparse.ArgumentParser(prog="ohmheightmap", description=__doc__)
    p.add_argument("map", help="input .ohm")
    p.add_argument("output", nargs="?", default="", help="output .ohm (default: <map>-heightmap.ohm)")
    p.add_argument("--mode", default="planar", choices=["planar", "fill", "layered", "layered-unordered"])
    p.add_argument("--clearance", type=float, default=1.0, help="minimum clearance above ground")
    p.add_argument("--floor", type=float, default=0.0, help="floor limit below reference height")
    p.add_argument("--ceiling", type=float, default=0.0, help="ceiling limit above reference height")
    p.add_argument("--up", default="z", choices=["x", "y", "z", "-x", "-y", "-z"])
    p.add_argument("--position", type=float, nargs=3, default=(0.0, 0.0, 0.0), help="reference position")
    p.add_argument("--virtual-surfaces", action="store_true")
    p.add_argument("--no-voxel-mean", action="store_true")
    args = p.parse_args(argv)

    import os

    from ohm_tpu_torch.io import load, save
    from ohm_tpu_torch.heightmap import Heightmap, HeightmapMode, UpAxis

    out = args.output or os.path.splitext(args.map)[0] + "-heightmap.ohm"
    m, _ = load(args.map)

    up = {"x": UpAxis.X, "y": UpAxis.Y, "z": UpAxis.Z,
          "-x": UpAxis.NEG_X, "-y": UpAxis.NEG_Y, "-z": UpAxis.NEG_Z}[args.up]
    mode = {"planar": HeightmapMode.PLANAR, "fill": HeightmapMode.SIMPLE_FILL,
            "layered": HeightmapMode.LAYERED_FILL,
            "layered-unordered": HeightmapMode.LAYERED_FILL_UNORDERED}[args.mode]

    hm = Heightmap(min_clearance=args.clearance, up_axis=up)
    hm.mode = mode
    hm.floor = args.floor
    hm.ceiling = args.ceiling
    hm.generate_virtual_surfaces = args.virtual_surfaces
    hm.use_voxel_mean = not args.no_voxel_mean
    n = hm.build_heightmap(m, reference_pos=args.position)
    save(out, hm.heightmap())
    print(f"wrote {out} ({n} heightmap voxels)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
