"""ohmfilter: filter a point cloud against a map's occupied voxels.

Reference parity: utils/ohmfilter (docs/docutils.md:110-112).
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def main(argv=None):
    p = argparse.ArgumentParser(prog="ohmfilter", description=__doc__)
    p.add_argument("map", help=".ohm file")
    p.add_argument("cloud", help="input cloud (.ply/.xyz)")
    p.add_argument("output", nargs="?", default="", help="output .ply")
    p.add_argument("--invert", action="store_true", help="keep points OUTSIDE occupied voxels")
    args = p.parse_args(argv)

    import os

    from ohm_tpu_torch.io import load
    from ohm_tpu_torch.io.slam import load_cloud
    from ohm_tpu_torch.io.ply import save_cloud_ply
    from ohm_tpu_torch.core.layout import OCCUPANCY_LAYER

    out = args.output or os.path.splitext(args.cloud)[0] + "-filtered.ply"
    m, _ = load(args.map)
    cloud = load_cloud(args.cloud)
    pts = cloud["points"]

    occ_idx = m.layer_index(OCCUPANCY_LAYER)
    region, local = m.voxel_key(pts)
    idx = m.voxel_index(local)
    keep = np.zeros(len(pts), bool)
    # Group by region for chunked lookup.
    from ohm_tpu_torch.core import keys as keymath

    packed = keymath.pack_region_key(region)
    order = np.argsort(packed, kind="stable")
    threshold = np.float32(m.occupancy_threshold_value)
    i = 0
    while i < len(order):
        j = i
        while j < len(order) and packed[order[j]] == packed[order[i]]:
            j += 1
        sel = order[i:j]
        chunk = m.region(region[sel[0]])
        if chunk is not None:
            occ = chunk.layers[occ_idx][OCCUPANCY_LAYER]
            vals = occ[idx[sel]]
            keep[sel] = np.isfinite(vals) & (vals >= threshold)
        i = j
    if args.invert:
        keep = ~keep
    save_cloud_ply(out, pts[keep])
    print(f"wrote {out}: kept {int(keep.sum())} / {len(pts)} points")
    return 0


if __name__ == "__main__":
    sys.exit(main())
