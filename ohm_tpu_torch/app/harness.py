"""MapHarness: the shared application skeleton.

Reference parity: ohmapp/MapHarness.h:50-303, ohmapp/DataSource.h,
ohmapp/SlamIOSource.cpp, ohmapp/OhmAppCpu.cpp, ohmapp/OhmAppGpu.cpp —
options -> prepare -> batched run with progress -> finalise -> save stats
and .ohm/.ply outputs, with SIGINT multi-level quit.

The port of ``ohm_tpu/app/harness.py``: ``MapOptions``, ``RayStats``,
``OutputOptions`` and ``MapHarness`` keep the reference's text, except that
``MapOptions.device`` defaults to "cuda" and ``run`` sets up no compile
cache (the port's kernels build once into ``ohm_tpu_torch/_build/``).
``build_mapper`` builds the port's mappers.
"""

from __future__ import annotations

import dataclasses
import signal
import time

import numpy as np

from ohm_tpu_torch.core.map import OccupancyMap, MapFlag
from ohm_tpu_torch.io import save
from ohm_tpu_torch.io.slam import SlamCloudLoader
from ohm_tpu_torch.utils.progress import ProgressMonitor
from ohm_tpu_torch.utils.log import get_logger
from ohm_tpu_torch.utils.trace import Trace, TracingRayMapper

log = get_logger("app")


@dataclasses.dataclass
class MapOptions:
    """Map options (reference: MapHarness::MapOptions + OhmAppCpu options)."""

    resolution: float = 0.1
    region_dim: int = 32
    hit_probability: float = 0.9
    miss_probability: float = 0.45
    threshold_probability: float = 0.5
    voxel_mean: bool = False
    traversal: bool = False
    touch_time: bool = False
    incident_normal: bool = False
    mode: str = "occupancy"  # occupancy | ndt | ndt-tm | tsdf
    # NDT parameters (reference: NdtMapDetail defaults):
    sensor_noise: float = 0.05
    ndt_sample_threshold: int = 3
    ndt_adaptation_rate: float = 0.0
    # TSDF parameters:
    tsdf_max_weight: float = 1e4
    tsdf_truncation: float = 0.1
    # Device options (reference: OhmAppGpu GpuOptions):
    device: str = "cuda"  # cuda | cpu (plain PyTorch) | oracle (f64 host)
    arena_capacity: int = 2048
    batch_size: int = 4096
    ray_length_max: float = 0.0
    # Data source options (reference: ohmapp/DataSource.h:75-87):
    point_limit: int = 0  # process at most this many sample points (0 = all)
    #: Force a batch when the sensor moves more than this (m) from the
    #: batch's first origin (ohmapp/SlamIOSource.cpp:28); <= 0 disables.
    sensor_batch_delta: float = 0.0
    start_time: float = 0.0  # skip data before first_timestamp + start_time
    time_limit: float = 0.0  # process at most this data-time interval
    stats_mode: str = "off"  # off | console | csv
    return_number_mode: str = "off"  # off | auto | explicit (dual returns)


@dataclasses.dataclass
class RayStats:
    """Ray batch statistics (reference: ohmapp/DataSource.h:103-161).

    Times are seconds; ``data_*`` in the source's timestamp base,
    ``process_*`` in wall clock since run start.
    """

    process_time_start: float = float("inf")
    process_time_end: float = 0.0
    data_time_start: float = float("inf")
    data_time_end: float = 0.0
    ray_length_minimum: float = float("inf")
    ray_length_maximum: float = 0.0
    ray_length_total: float = 0.0
    ray_count: int = 0

    def ray_length_average(self) -> float:
        return self.ray_length_total / self.ray_count if self.ray_count else 0.0

    def data_time(self) -> float:
        dt = self.data_time_end - self.data_time_start
        return dt if np.isfinite(dt) else 0.0

    def process_time(self) -> float:
        dt = self.process_time_end - self.process_time_start
        return dt if np.isfinite(dt) else 0.0

    def data_rays_per_second(self) -> float:
        return self.ray_count / self.data_time() if self.data_time() > 0 else 0.0

    def process_rays_per_second(self) -> float:
        return self.ray_count / self.process_time() if self.process_time() > 0 else 0.0

    def merge(self, other: "RayStats"):
        """Accumulate (reference: DataSource::addBatchStats, DataSource.cpp:106-121)."""
        self.data_time_start = min(self.data_time_start, other.data_time_start)
        self.data_time_end = max(self.data_time_end, other.data_time_end)
        self.process_time_start = min(self.process_time_start, other.process_time_start)
        self.process_time_end = max(self.process_time_end, other.process_time_end)
        self.ray_length_minimum = min(self.ray_length_minimum, other.ray_length_minimum)
        self.ray_length_maximum = max(self.ray_length_maximum, other.ray_length_maximum)
        self.ray_length_total += other.ray_length_total
        self.ray_count += other.ray_count

    CSV_HEADER = ("process_time_start,process_time_end,data_time_start,data_time_end,"
                  "ray_count,ray_length_minimum,ray_length_maximum,ray_length_average,"
                  "rays_per_second_data,rays_per_second_process")

    def csv_row(self) -> str:
        """CSV row matching the reference column order (DataSource.cpp:135-157)."""
        return (f"{self.process_time_start:.9g},{self.process_time_end:.9g},"
                f"{self.data_time_start:.9g},{self.data_time_end:.9g},{self.ray_count},"
                f"{self.ray_length_minimum if self.ray_count else 0.0:.9g},"
                f"{self.ray_length_maximum:.9g},{self.ray_length_average():.9g},"
                f"{self.data_rays_per_second():.9g},{self.process_rays_per_second():.9g}")


@dataclasses.dataclass
class OutputOptions:
    base_name: str = "map"
    save_map: bool = True
    save_cloud: bool = True
    save_info: bool = False
    trace: str = ""
    quiet: bool = False


def build_mapper(map_options: MapOptions):
    """Construct (OccupancyMap, ray mapper) per the options
    (reference: OhmAppCpu/OhmAppGpu prepareForRun).

    ``device``: "cuda", the port's mappers on the card; "cpu", the same
    mappers running their kernels' plain PyTorch versions; "oracle", the
    f64 host mappers (what the JAX package calls "cpu").  Nothing falls
    back: "cuda" without a CUDA device raises."""
    flags = MapFlag.NONE
    if map_options.voxel_mean:
        flags |= MapFlag.VOXEL_MEAN
    if map_options.traversal:
        flags |= MapFlag.TRAVERSAL
    if map_options.touch_time:
        flags |= MapFlag.TOUCH_TIME
    if map_options.incident_normal:
        flags |= MapFlag.INCIDENT_NORMAL

    m = OccupancyMap(resolution=map_options.resolution,
                     region_voxel_dims=map_options.region_dim, flags=flags)
    m.set_hit_probability(map_options.hit_probability)
    m.set_miss_probability(map_options.miss_probability)
    m.set_occupancy_threshold_probability(map_options.threshold_probability)
    if map_options.ray_length_max > 0:
        from ohm_tpu_torch.core.filters import clip_ray_filter

        max_len = map_options.ray_length_max
        m.ray_filter = lambda s, e: clip_ray_filter(s, e, max_len)

    mode = map_options.mode
    if map_options.device == "oracle":
        if mode in ("ndt", "ndt-tm"):
            from ohm_tpu_torch.oracle.ndt import RayMapperNdt, NdtParams

            mapper = RayMapperNdt(m, NdtParams(
                sensor_noise=map_options.sensor_noise,
                sample_threshold=map_options.ndt_sample_threshold,
                adaptation_rate=map_options.ndt_adaptation_rate,
                ndt_tm=mode == "ndt-tm"))
        elif mode == "tsdf":
            from ohm_tpu_torch.oracle.tsdf import RayMapperTsdf, TsdfOptions

            mapper = RayMapperTsdf(m, TsdfOptions(
                max_weight=map_options.tsdf_max_weight,
                default_truncation_distance=map_options.tsdf_truncation))
        else:
            from ohm_tpu_torch.oracle.occupancy import RayMapperOccupancy

            mapper = RayMapperOccupancy(m)
    else:
        # "cuda" or "cpu"; resolve_device raises for a CUDA device that is
        # not there and for any other name.
        if mode in ("ndt", "ndt-tm"):
            from ohm_tpu_torch.mapping.ndt_map import TorchNdtMap
            from ohm_tpu_torch.oracle.ndt import NdtParams

            mapper = TorchNdtMap(m, NdtParams(
                sensor_noise=map_options.sensor_noise,
                sample_threshold=map_options.ndt_sample_threshold,
                adaptation_rate=map_options.ndt_adaptation_rate,
                ndt_tm=mode == "ndt-tm"), capacity=map_options.arena_capacity,
                device=map_options.device)
        elif mode == "tsdf":
            from ohm_tpu_torch.mapping.tsdf_map import TorchTsdfMap
            from ohm_tpu_torch.oracle.tsdf import TsdfOptions

            mapper = TorchTsdfMap(m, TsdfOptions(
                max_weight=map_options.tsdf_max_weight,
                default_truncation_distance=map_options.tsdf_truncation),
                capacity=map_options.arena_capacity, device=map_options.device)
        else:
            from ohm_tpu_torch.mapping.torch_map import TorchRayMapper

            mapper = TorchRayMapper(m, capacity=map_options.arena_capacity,
                                    device=map_options.device)
    return m, mapper


class MapHarness:
    """Run loop: data source -> mapper batches -> finalise -> save.

    Reference: MapHarness::run (ohmapp/MapHarness.cpp) including the
    SIGINT quit-level escalation (ohmapp/ohmappmain.inl:18-53).
    """

    def __init__(self, map_options: MapOptions, output: OutputOptions, source: SlamCloudLoader):
        self.map_options = map_options
        self.output = output
        self.source = source
        self.quit_level = 0
        self.map = None
        self.mapper = None
        self.stats = {}
        self.global_stats = RayStats()

    def _install_signals(self):
        def on_sigint(_sig, _frame):
            self.quit_level += 1
            if self.quit_level > 2:
                raise KeyboardInterrupt

        try:
            signal.signal(signal.SIGINT, on_sigint)
        except ValueError:
            pass  # not on the main thread (tests)

    def run(self) -> int:
        self._install_signals()
        self.map, self.mapper = build_mapper(self.map_options)
        mapper = self.mapper
        trace = None
        if self.output.trace:
            trace = Trace(self.output.trace)
            mapper = TracingRayMapper(mapper, trace)

        progress = ProgressMonitor(label="rays ")
        progress.set_target(self.source.point_count)
        if not self.output.quiet:
            progress.start_thread()

        opts = self.map_options
        if opts.sensor_batch_delta > 0 and hasattr(self.source, "sensor_batch_delta"):
            # Propagate sensor-motion batch forcing to the data source
            # (reference: ohmapp/SlamIOSource.cpp:125).
            self.source.sensor_batch_delta = opts.sensor_batch_delta
        stats_csv = None
        if opts.stats_mode == "csv":
            stats_csv = open(self.output.base_name + "_stats.csv", "w")
            stats_csv.write(RayStats.CSV_HEADER + "\n")
        window: list[RayStats] = []  # 20-deep ring (SlamIOSource.h:107)
        window_next = 0

        # Dual returns: secondary samples feed a host-side stats mapper in
        # addition to the primary (reference: OhmAppCpu.cpp:489-536 — the
        # secondary mapper has no GPU equivalent, docs/docvoxellayers.md:113).
        secondary_mapper = None
        primary_flags = 0
        if opts.return_number_mode != "off":
            from ohm_tpu_torch.core.rayflags import RayFlag
            from ohm_tpu_torch.oracle.secondary import RayMapperSecondarySample

            secondary_mapper = RayMapperSecondarySample(self.map)
            primary_flags = int(RayFlag.EXCLUDE_ORIGIN)

        t0 = time.perf_counter()
        total_rays = 0
        first_time = None
        while self.quit_level == 0:
            batch = self.source.next_batch(opts.batch_size)
            if batch is None:
                break
            rays, timestamps, intensities, return_numbers = batch
            finish = False
            if timestamps is not None and len(timestamps):
                if first_time is None:
                    first_time = float(timestamps[0])
                # start_time / time_limit trim (reference: DataSource.h:79-83;
                # SlamIOSource treats them relative to the first timestamp).
                keep = np.ones(len(timestamps), bool)
                if opts.start_time > 0:
                    keep &= timestamps >= first_time + opts.start_time
                if opts.time_limit > 0:
                    over = timestamps > first_time + opts.start_time + opts.time_limit
                    keep &= ~over
                    finish |= bool(over.any())
                if not keep.all():
                    rays = rays.reshape(-1, 2, 3)[keep].reshape(-1, 3)
                    timestamps = timestamps[keep]
                    if intensities is not None:
                        intensities = intensities[keep]
                    if return_numbers is not None:
                        return_numbers = return_numbers[keep]
            if opts.point_limit and total_rays + len(rays) // 2 >= opts.point_limit:
                n_keep = opts.point_limit - total_rays
                rays = rays[:2 * n_keep]
                timestamps = timestamps[:n_keep] if timestamps is not None else None
                intensities = intensities[:n_keep] if intensities is not None else None
                return_numbers = return_numbers[:n_keep] if return_numbers is not None else None
                finish = True
            bs = RayStats()
            bs.process_time_start = time.perf_counter() - t0
            if len(rays):
                use_dual = secondary_mapper is not None and return_numbers is not None
                n = mapper.integrate_rays(rays, intensities=intensities, timestamps=timestamps,
                                          ray_update_flags=primary_flags if use_dual else 0)
                if use_dual and return_numbers.any():
                    sec = return_numbers != 0
                    secondary_mapper.integrate_rays(rays.reshape(-1, 2, 3)[sec].reshape(-1, 3))
            else:
                n = 0
            bs.process_time_end = time.perf_counter() - t0
            if n and opts.stats_mode != "off":
                lengths = np.linalg.norm(rays[1::2] - rays[0::2], axis=1)
                bs.ray_length_minimum = float(lengths.min())
                bs.ray_length_maximum = float(lengths.max())
                bs.ray_length_total = float(lengths.sum())
                bs.ray_count = n
                if timestamps is not None and len(timestamps):
                    bs.data_time_start = float(timestamps[0])
                    bs.data_time_end = float(timestamps[-1])
                if len(window) < 20:
                    window.append(bs)
                    window_next = len(window) % 20
                else:
                    window[window_next] = bs
                    window_next = (window_next + 1) % 20
                windowed = RayStats()
                for w in window:
                    windowed.merge(w)
                if stats_csv is not None:
                    stats_csv.write(windowed.csv_row() + "\n")
                elif opts.stats_mode == "console" and not self.output.quiet:
                    log.info("window: %d rays, %.0f rays/s (data %.0f/s), len %.2f-%.2f m",
                             windowed.ray_count, windowed.process_rays_per_second(),
                             windowed.data_rays_per_second(), windowed.ray_length_minimum,
                             windowed.ray_length_maximum)
                self.global_stats.merge(bs)
            total_rays += n
            progress.increment(n)
            if finish:
                break
        if hasattr(mapper, "sync_voxels"):
            mapper.sync_voxels()
        elapsed = time.perf_counter() - t0
        progress.join(display_final=not self.output.quiet)
        if stats_csv is not None:
            stats_csv.close()
        if opts.stats_mode != "off" and not self.output.quiet and self.global_stats.ray_count:
            # End-of-run global stats (reference: MapHarness.cpp:313-317).
            log.info("Ray length minimum: %.4f", self.global_stats.ray_length_minimum)
            log.info("Ray length maximum: %.4f", self.global_stats.ray_length_maximum)
            log.info("Ray length average: %.4f", self.global_stats.ray_length_average())

        self.stats = {
            "rays": total_rays,
            "elapsed_s": elapsed,
            "rays_per_sec": total_rays / max(elapsed, 1e-9),
            "regions": self.map.region_count(),
        }
        if not self.output.quiet:
            log.info("Total processing time: %.3f s (%s rays, %.0f rays/s)",
                     elapsed, total_rays, self.stats["rays_per_sec"])

        if self.output.save_info:
            self.map.info["generator"] = "ohm_tpu ohmpop"
            self.map.info["mode"] = self.map_options.mode
            self.map.info["rays"] = total_rays
        if self.output.save_map:
            save(self.output.base_name + ".ohm", self.map)
        if self.output.save_cloud:
            self._save_cloud(self.output.base_name + ".ply")
        if trace:
            trace.close()
        return 0

    def _save_cloud(self, filename: str):
        """One point per occupied voxel, mean position preferred
        (reference: ohmpop default PLY output)."""
        from ohm_tpu_torch.app.export import occupied_points

        pts = occupied_points(self.map)
        from ohm_tpu_torch.io.ply import save_cloud_ply

        save_cloud_ply(filename, pts)
