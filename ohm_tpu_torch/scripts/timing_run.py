"""Run an ohmpop timing matrix and collate the results.

Analogue of the reference timing utilities
(scripts/ohm-timing-run.py — builds ohmpop command matrices over compute
type and occupancy mode — and scripts/ohm-parse-timing.py:15-16 — regex
parsing of "Total processing time" from the logs).  Here each run invokes
``ohm_tpu_torch.app.ohmpop`` in-process and reads the harness stats directly,
emitting one CSV with rays/sec per configuration.

Usage:
  python -m ohm_tpu_torch.scripts.timing_run --cloud scan.ply --traj traj.txt \
      --device cuda cpu --mode occupancy ndt --resolution 0.1 -o timing.csv
"""

from __future__ import annotations

import argparse
import csv
import itertools
import os
import sys
import time


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="ohm_tpu_torch timing matrix")
    p.add_argument("--cloud", required=True, help="point cloud file")
    p.add_argument("--traj", default=None, help="trajectory file")
    p.add_argument("--device", nargs="+", default=["cuda"], choices=["cuda", "cpu", "oracle"])
    p.add_argument("--mode", nargs="+", default=["occupancy"],
                   choices=["occupancy", "mean", "ndt", "ndt-tm", "tsdf"])
    p.add_argument("--resolution", type=float, nargs="+", default=[0.1])
    p.add_argument("--batch-size", type=int, nargs="+", default=[4096])
    p.add_argument("--point-limit", type=int, default=0)
    p.add_argument("--output", "-o", default="timing.csv")
    p.add_argument("--dry-run", action="store_true",
                   help="print the run matrix without executing")
    return p.parse_args(argv)


def run_one(args, device, mode, resolution, batch_size, out_dir):
    from ohm_tpu_torch.app.harness import MapHarness, MapOptions, OutputOptions
    from ohm_tpu_torch.io.slam import SlamCloudLoader

    source = SlamCloudLoader(args.cloud, args.traj)
    # "mean" = occupancy + voxel mean (reference --occ vocabulary).
    map_mode = "occupancy" if mode == "mean" else mode
    opts = MapOptions(resolution=resolution, mode=map_mode, device=device,
                      voxel_mean=mode in ("mean", "ndt", "ndt-tm"),
                      batch_size=batch_size, point_limit=args.point_limit)
    base = os.path.join(out_dir, f"{device}-{mode}-{resolution:g}-{batch_size}")
    output = OutputOptions(base_name=base, save_map=False, save_cloud=False, quiet=True)
    harness = MapHarness(opts, output, source)
    t0 = time.perf_counter()
    rc = harness.run()
    wall = time.perf_counter() - t0
    row = dict(device=device, mode=mode, resolution=resolution, batch_size=batch_size,
               rc=rc, wall_s=round(wall, 3), **{k: (round(v, 3) if isinstance(v, float) else v)
                                                for k, v in harness.stats.items()})
    return row


def main(argv=None):
    args = parse_args(argv)
    matrix = list(itertools.product(args.device, args.mode, args.resolution, args.batch_size))
    if args.dry_run:
        for cfg in matrix:
            print("run:", dict(zip(("device", "mode", "resolution", "batch_size"), cfg)))
        return 0
    out_dir = os.path.dirname(os.path.abspath(args.output)) or "."
    rows = []
    for device, mode, resolution, batch_size in matrix:
        print(f"[timing] {device} {mode} res={resolution:g} batch={batch_size} ...",
              flush=True)
        row = run_one(args, device, mode, resolution, batch_size, out_dir)
        print(f"[timing]   -> {row.get('rays_per_sec', 0):.0f} rays/s "
              f"({row.get('rays', 0)} rays, {row['wall_s']} s wall)", flush=True)
        rows.append(row)
    if rows:
        keys = sorted({k for r in rows for k in r})
        with open(args.output, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=keys)
            w.writeheader()
            w.writerows(rows)
        print(f"[timing] wrote {args.output} ({len(rows)} rows)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
