"""ohmpop: populate an occupancy map from a point cloud (+ trajectory).

Reference parity: utils/ohmpop (docs/docutils.md:19-63) — same flag
vocabulary; '--device cuda' replaces the cpu/cuda/ocl binary split.
"""

from __future__ import annotations

import argparse
import sys


def build_parser():
    p = argparse.ArgumentParser(prog="ohmpop", description=__doc__)
    p.add_argument("cloud", help="input point cloud (.ply/.xyz/.txt/.las)")
    p.add_argument("trajectory", nargs="?", help="trajectory file (time x y z [q])")
    p.add_argument("--output", "-o", default="", help="output base name (default: cloud name)")
    p.add_argument("--resolution", type=float, default=0.1)
    p.add_argument("--dim", type=int, default=32, help="region voxel dimension")
    p.add_argument("--hit", type=float, default=0.9, help="hit probability")
    p.add_argument("--miss", type=float, default=0.45, help="miss probability")
    p.add_argument("--threshold", type=float, default=0.5, help="occupancy threshold probability")
    p.add_argument("--mode", choices=["occupancy", "ndt", "ndt-tm", "tsdf"], default="occupancy")
    p.add_argument("--voxel-mean", action="store_true")
    p.add_argument("--traversal", action="store_true")
    p.add_argument("--touch-time", action="store_true")
    p.add_argument("--incident-normal", action="store_true")
    p.add_argument("--sensor-noise", type=float, default=0.05)
    p.add_argument("--ndt-sample-threshold", type=int, default=3)
    p.add_argument("--ndt-adaptation-rate", type=float, default=0.0)
    p.add_argument("--tsdf-max-weight", type=float, default=1e4)
    p.add_argument("--tsdf-truncation", type=float, default=0.1)
    p.add_argument("--ray-length-max", type=float, default=0.0)
    p.add_argument("--point-limit", type=int, default=0,
                   help="process at most this many sample points (0 = all)")
    p.add_argument("--start-time", type=float, default=0.0,
                   help="skip data before this offset from the first timestamp (s)")
    p.add_argument("--time-limit", type=float, default=0.0,
                   help="process at most this data-time interval (s)")
    p.add_argument("--stats", choices=["off", "console", "csv"], default="off",
                   help="ray statistics mode; csv writes <output>_stats.csv")
    p.add_argument("--return-number-mode", choices=["off", "auto", "explicit"], default="off",
                   help="dual-return handling: secondary samples layer + stats")
    p.add_argument("--batch-size", type=int, default=4096)
    p.add_argument("--batch-delta", type=float, default=0.0,
                   help="maximum sensor movement (m) before forcing a batch up; "
                        "zero/negative to disable")
    p.add_argument("--device", choices=["cuda", "cpu", "oracle"], default="cuda",
                   help="cuda: the port's mappers on the card; cpu: their plain PyTorch "
                        "versions; oracle: the f64 host mappers")
    p.add_argument("--arena-capacity", type=int, default=2048, help="device region arena capacity")
    p.add_argument("--ray-cloud", action="store_true", help="cloud normals encode sample->sensor")
    p.add_argument("--sensor", type=float, nargs=3, default=(0.0, 0.0, 0.0),
                   help="fixed sensor position when no trajectory is given")
    p.add_argument("--no-map", action="store_true", help="skip .ohm output")
    p.add_argument("--no-cloud", action="store_true", help="skip .ply output")
    p.add_argument("--save-info", action="store_true")
    p.add_argument("--trace", default="", help="write a JSONL trace stream")
    p.add_argument("--quiet", "-q", action="store_true")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    from ohm_tpu_torch.app.harness import MapHarness, MapOptions, OutputOptions
    from ohm_tpu_torch.io.slam import SlamCloudLoader

    import os

    base = args.output or os.path.splitext(args.cloud)[0]
    source = SlamCloudLoader(args.cloud, args.trajectory, ray_cloud=args.ray_cloud,
                             fixed_origin=args.sensor,
                             return_number_mode=args.return_number_mode,
                             sensor_batch_delta=args.batch_delta)
    map_options = MapOptions(
        resolution=args.resolution, region_dim=args.dim,
        hit_probability=args.hit, miss_probability=args.miss,
        threshold_probability=args.threshold,
        voxel_mean=args.voxel_mean or args.mode in ("ndt", "ndt-tm"),
        traversal=args.traversal, touch_time=args.touch_time,
        incident_normal=args.incident_normal, mode=args.mode,
        sensor_noise=args.sensor_noise, ndt_sample_threshold=args.ndt_sample_threshold,
        ndt_adaptation_rate=args.ndt_adaptation_rate,
        tsdf_max_weight=args.tsdf_max_weight, tsdf_truncation=args.tsdf_truncation,
        device=args.device, arena_capacity=args.arena_capacity,
        batch_size=args.batch_size, ray_length_max=args.ray_length_max,
        sensor_batch_delta=args.batch_delta,
        point_limit=args.point_limit, start_time=args.start_time,
        time_limit=args.time_limit, stats_mode=args.stats,
        return_number_mode=args.return_number_mode,
    )
    output = OutputOptions(base_name=base, save_map=not args.no_map,
                           save_cloud=not args.no_cloud, save_info=args.save_info,
                           trace=args.trace, quiet=args.quiet)
    harness = MapHarness(map_options, output, source)
    return harness.run()


if __name__ == "__main__":
    sys.exit(main())
