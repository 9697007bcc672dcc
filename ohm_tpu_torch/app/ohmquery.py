"""ohmquery: run map queries from the command line.

Reference parity: utils/ohmquery (LineQuery / NearestNeighbours / RaysQuery
runner, docs/docutils.md:124-126).
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def main(argv=None):
    p = argparse.ArgumentParser(prog="ohmquery", description=__doc__)
    p.add_argument("map", help=".ohm file")
    sub = p.add_subparsers(dest="query", required=True)

    ln = sub.add_parser("line", help="voxels + clearance along a line")
    ln.add_argument("--start", type=float, nargs=3, required=True)
    ln.add_argument("--end", type=float, nargs=3, required=True)
    ln.add_argument("--radius", type=float, default=1.0)

    nn = sub.add_parser("nearest", help="occupied voxels near a point")
    nn.add_argument("--point", type=float, nargs=3, required=True)
    nn.add_argument("--radius", type=float, default=1.0)

    ry = sub.add_parser("rays", help="range to first occupied voxel along rays")
    ry.add_argument("--ray", type=float, nargs=6, action="append", required=True,
                    metavar=("X0 Y0 Z0 X1 Y1 Z1".split()[0]))
    ry.add_argument("--device", choices=["cuda", "cpu"], default="cuda")

    args = p.parse_args(argv)
    from ohm_tpu_torch.io import load

    m, _ = load(args.map)

    if args.query == "line":
        from ohm_tpu_torch.query import LineQuery

        q = LineQuery(m, args.start, args.end, args.radius)
        q.execute()
        for vox, rng in zip(q.intersected_voxels, q.ranges):
            print(f"voxel {tuple(vox)} clearance {rng:.3f}")
    elif args.query == "nearest":
        from ohm_tpu_torch.query import NearestNeighbours

        q = NearestNeighbours(m, args.point, args.radius)
        q.execute()
        order = np.argsort(q.ranges)
        for i in order:
            print(f"voxel {tuple(q.intersected_voxels[i])} range {q.ranges[i]:.3f}")
        print(f"{q.number_of_results()} results")
    elif args.query == "rays":
        from ohm_tpu_torch.query import RaysQuery

        rays = np.asarray(args.ray, dtype=np.float64).reshape(-1, 6)
        q = RaysQuery(m, device=args.device)
        q.set_rays(rays.reshape(-1, 3))
        q.execute()
        for i in range(len(rays)):
            print(f"ray {i}: range {q.ranges[i]:.3f} state {int(q.terminal_states[i])} "
                  f"unobserved_volume {q.unobserved_volumes[i]:.4g}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
