"""ohmsubmap: extract a sub-map from a .ohm file.

Reference parity: utils/ohmsubmap (AABB-filtered copy via CopyUtil).
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None):
    p = argparse.ArgumentParser(prog="ohmsubmap", description=__doc__)
    p.add_argument("map", help="input .ohm")
    p.add_argument("output", help="output .ohm")
    p.add_argument("--min", type=float, nargs=3, required=True, help="AABB minimum (x y z)")
    p.add_argument("--max", type=float, nargs=3, required=True, help="AABB maximum (x y z)")
    args = p.parse_args(argv)

    from ohm_tpu_torch.io import load, save
    from ohm_tpu_torch.core.copyutil import copy_map
    from ohm_tpu_torch.core.map import OccupancyMap, MapFlag
    import copy as pycopy

    src, _ = load(args.map)
    dst = OccupancyMap(resolution=src.resolution, region_voxel_dims=tuple(src.region_voxel_dims),
                       flags=MapFlag.NONE, layout=pycopy.deepcopy(src.layout), origin=src.origin)
    dst.hit_value = src.hit_value
    dst.miss_value = src.miss_value
    dst.occupancy_threshold_value = src.occupancy_threshold_value
    n = copy_map(dst, src, extents=(args.min, args.max))
    save(args.output, dst)
    print(f"wrote {args.output}: {n} regions")
    return 0


if __name__ == "__main__":
    sys.exit(main())
