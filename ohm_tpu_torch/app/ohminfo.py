"""ohminfo: display .ohm map header, layout and MapInfo.

Reference parity: utils/ohminfo (docs/docutils.md:66-69).
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def main(argv=None):
    p = argparse.ArgumentParser(prog="ohminfo", description=__doc__)
    p.add_argument("map", help=".ohm file")
    p.add_argument("--voxel-stats", action="store_true", help="scan chunks for voxel statistics")
    args = p.parse_args(argv)

    from ohm_tpu_torch.io.serialise import load_header, load
    from ohm_tpu_torch.core.probability import value_to_probability

    header, version, layout, info = load_header(args.map)
    print(f"File: {args.map}")
    print(f"Version: {version[0]}.{version[1]}.{version[2]}")
    print(f"Resolution: {header['resolution']}")
    print(f"Origin: {tuple(header['origin'])}")
    print(f"Region dimensions: {tuple(int(v) for v in header['region_voxel_dims'])}"
          f" ({tuple(header['region_spatial'])} m)")
    print(f"Regions: {header['region_count']}")
    print(f"Hit value: {header['hit_value']:.6g} "
          f"(p={float(value_to_probability(header['hit_value'])):.4g})")
    print(f"Miss value: {header['miss_value']:.6g} "
          f"(p={float(value_to_probability(header['miss_value'])):.4g})")
    print(f"Occupancy threshold: {header['occupancy_threshold_value']:.6g}")
    print(f"Stamp: {header['stamp']}  First ray time: {header['first_ray_time']}")
    print(f"Flags: 0x{header['flags']:x}")
    print("Layers:")
    for layer in layout:
        members = ", ".join(f"{mm.name}:{mm.type.name.lower()}" for mm in layer.voxel_layout.members)
        print(f"  {layer.layer_index}: {layer.name} ({layer.voxel_byte_size()} B/voxel) [{members}]")
    if info:
        print("MapInfo:")
        for name, value in info.items():
            v = value.value if hasattr(value, "value") else value
            print(f"  {name}: {v}")
    if args.voxel_stats:
        m, _ = load(args.map)
        occ_idx = m.layer_index("occupancy")
        occupied = free = unobserved = 0
        for chunk in m:
            occ = chunk.layers[occ_idx]["occupancy"]
            finite = np.isfinite(occ)
            occupied += int((finite & (occ >= m.occupancy_threshold_value)).sum())
            free += int((finite & (occ < m.occupancy_threshold_value)).sum())
            unobserved += int((~finite).sum())
        print(f"Voxels: occupied={occupied} free={free} unobserved={unobserved}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
