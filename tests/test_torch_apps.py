"""The port's applications: tests/test_apps.py's 18 tests on ohm_tpu_torch,
at the same sizes, with "--device cpu" (the port's mappers running their
plain PyTorch versions) where the reference passes "--device tpu" and
"oracle" (the f64 host mappers) where it passes "cpu"; then ohmpop of the
same scene through both packages (the JAX package on its rayflow wire
under JAX_PLATFORMS=cpu, the port on the CPU): chunk keys, occupancy bits
and mean counts identical, mean codes identical on >= 99.9% of written
voxels and within one quantum per axis elsewhere
(tests/test_torch_layers_mapper.py's rule); and "--device cuda" raising
where there is no CUDA device, with no fallback."""

import os

import numpy as np
import pytest

from ohm_tpu_torch.io.ply import save_cloud_ply, load_ply


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """Synthetic scan: floor + wall observed from a moving sensor."""
    d = tmp_path_factory.mktemp("scene")
    rng = np.random.default_rng(77)
    n = 1500
    # Sensor path along x.
    t = np.linspace(0.0, 10.0, n)
    sensor = np.column_stack([t * 0.3, np.zeros(n), np.full(n, 1.0)])
    # Samples: floor or wall at x=5.
    is_wall = rng.random(n) < 0.3
    floor_pts = np.column_stack([
        sensor[:, 0] + rng.uniform(-2, 2, n), rng.uniform(-2, 2, n), np.zeros(n)])
    wall_pts = np.column_stack([
        np.full(n, 5.0), rng.uniform(-2, 2, n), rng.uniform(0, 2, n)])
    samples = np.where(is_wall[:, None], wall_pts, floor_pts)

    cloud_file = str(d / "cloud.ply")
    _write_timed_ply(cloud_file, samples, t)
    traj_file = str(d / "traj.txt")
    with open(traj_file, "w") as f:
        f.write("time x y z\n")
        for i in range(0, n, 10):
            f.write(f"{t[i]} {sensor[i, 0]} {sensor[i, 1]} {sensor[i, 2]}\n")
    return {"dir": str(d), "cloud": cloud_file, "traj": traj_file, "n": n}


def _write_timed_ply(filename, points, times):
    import numpy as np

    n = len(points)
    header = (
        "ply\nformat binary_little_endian 1.0\n"
        f"element vertex {n}\n"
        "property double x\nproperty double y\nproperty double z\n"
        "property double time\nend_header\n"
    )
    rec = np.zeros(n, dtype=[("xyz", np.float64, 3), ("t", np.float64)])
    rec["xyz"] = points
    rec["t"] = times
    with open(filename, "wb") as f:
        f.write(header.encode("ascii"))
        f.write(rec.tobytes())


def test_ohmpop_pipeline(scene, tmp_path):
    from ohm_tpu_torch.app import ohmpop, ohminfo, ohm2ply, ohmheightmap, ohmhm2img
    from ohm_tpu_torch.app import ohmfilter, ohmcmp, ohmsubmap, ohmprob, ohmquery

    base = str(tmp_path / "scene-map")
    rc = ohmpop.main([scene["cloud"], scene["traj"], "-o", base, "--resolution", "0.2",
                      "--voxel-mean", "--device", "cpu", "--arena-capacity", "128",
                      "--batch-size", "512", "--save-info", "--quiet"])
    assert rc == 0
    assert os.path.exists(base + ".ohm")
    assert os.path.exists(base + ".ply")

    # ohminfo runs and reports layers.
    assert ohminfo.main([base + ".ohm", "--voxel-stats"]) == 0

    # ohm2ply occupancy export produces points.
    out_ply = str(tmp_path / "occ.ply")
    assert ohm2ply.main([base + ".ohm", out_ply]) == 0
    props = load_ply(out_ply)
    assert len(props["x"]) > 50

    # Heightmap generation + image.
    hm_file = str(tmp_path / "hm.ohm")
    assert ohmheightmap.main([base + ".ohm", hm_file, "--clearance", "0.5",
                              "--position", "1", "0", "1"]) == 0
    assert os.path.exists(hm_file)
    png_file = str(tmp_path / "hm.png")
    assert ohmhm2img.main([hm_file, png_file]) == 0
    with open(png_file, "rb") as f:
        assert f.read(8) == b"\x89PNG\r\n\x1a\n"

    # Heightmap PLY export from the serialised heightmap.
    hm_ply = str(tmp_path / "hm.ply")
    assert ohm2ply.main([hm_file, hm_ply, "--mode", "heightmap"]) == 0

    # ohmfilter keeps wall/floor points, rejects mid-air points.
    test_cloud = str(tmp_path / "test_cloud.ply")
    pts = np.array([[5.0, 0.0, 1.0],   # on the wall
                    [0.0, 0.0, 0.0],   # on the floor
                    [2.0, 0.0, 5.0]])  # in the sky (unobserved)
    save_cloud_ply(test_cloud, pts)
    filtered = str(tmp_path / "filtered.ply")
    assert ohmfilter.main([base + ".ohm", test_cloud, filtered]) == 0
    kept = load_ply(filtered)
    assert len(kept["x"]) < 3, "sky point must be filtered out"

    # ohmsubmap extracts fewer regions; ohmcmp self-compare passes.
    sub_file = str(tmp_path / "sub.ohm")
    assert ohmsubmap.main([base + ".ohm", sub_file, "--min", "-1", "-1", "-1",
                           "--max", "1", "1", "1"]) == 0
    assert ohmcmp.main([base + ".ohm", base + ".ohm"]) == 0
    assert ohmcmp.main([base + ".ohm", sub_file]) == 1  # differs

    # ohmprob round trip.
    assert ohmprob.main(["0.9"]) == 0
    assert ohmprob.main(["2.1972246"]) == 0

    # ohmquery nearest + rays.
    assert ohmquery.main([base + ".ohm", "nearest", "--point", "5", "0", "1",
                          "--radius", "0.5"]) == 0
    assert ohmquery.main([base + ".ohm", "rays", "--ray", "0", "0", "1", "8", "0", "1",
                          "--device", "cpu"]) == 0


def test_slam_loader_interpolates(scene):
    from ohm_tpu_torch.io.slam import SlamCloudLoader

    loader = SlamCloudLoader(scene["cloud"], scene["traj"])
    assert loader.point_count == scene["n"]
    batch = loader.next_batch(100)
    rays, times, _, _ = batch
    # Origins interpolated along the sensor path: z == 1, x in path range.
    origins = rays[0::2]
    np.testing.assert_allclose(origins[:, 2], 1.0, atol=1e-9)
    assert origins[:, 0].min() >= -0.01
    assert times is not None


def test_slam_loader_sensor_batch_delta(scene):
    """--batch-delta forces a batch when the sensor moves more than the
    threshold from the batch's first origin (ohmapp/SlamIOSource.cpp:28,
    300-304: the exceeding sample starts the NEXT batch)."""
    from ohm_tpu_torch.io.slam import SlamCloudLoader

    delta = 0.5
    loader = SlamCloudLoader(scene["cloud"], scene["traj"],
                             sensor_batch_delta=delta)
    total = 0
    sizes = []
    while True:
        batch = loader.next_batch(100000)  # batch_size alone would take all
        if batch is None:
            break
        rays = batch[0]
        origins = rays[0::2]
        n = len(origins)
        total += n
        sizes.append(n)
        # Every origin in the batch is within delta of the batch's first
        # origin (strictly: only the batch-starting sample may exceed).
        d = np.linalg.norm(origins - origins[0], axis=1)
        assert np.all(d[:-1] <= delta + 1e-9)
    assert total == scene["n"]
    # Sensor travels ~3 m at 0.3 m/s over the scene -> several forced cuts.
    assert len(sizes) >= 4

    # Disabled (default) takes everything in one batch.
    loader2 = SlamCloudLoader(scene["cloud"], scene["traj"])
    batch = loader2.next_batch(100000)
    assert len(batch[0]) // 2 == scene["n"]


def test_transform_samples():
    from ohm_tpu_torch.io.slam import transform_samples

    traj_t = np.array([0.0, 1.0, 2.0])
    traj_p = np.array([[0.0, 0, 0], [1.0, 0, 0], [2.0, 0, 0]])
    # Local samples 1 m ahead in y.
    times = np.array([0.5, 1.5])
    local = np.array([[0.0, 1.0, 0.0], [0.0, 1.0, 0.0]])
    rays = transform_samples(times, local, traj_t, traj_p)
    np.testing.assert_allclose(rays[0], [0.5, 0, 0])
    np.testing.assert_allclose(rays[1], [0.5, 1, 0])
    np.testing.assert_allclose(rays[2], [1.5, 0, 0])

    # With quaternions: 90 degree z rotation at t=1 rotates y -> -x... (x,y,z,w)
    qz90 = np.array([0.0, 0.0, np.sin(np.pi / 4), np.cos(np.pi / 4)])
    qid = np.array([0.0, 0.0, 0.0, 1.0])
    rays_q = transform_samples(np.array([1.0]), np.array([[0.0, 1.0, 0.0]]),
                               traj_t, traj_p, np.stack([qz90, qz90, qz90]))
    np.testing.assert_allclose(rays_q[1], [0.0, 0.0, 0.0], atol=1e-9)  # y rotated to -x from (1,0,0)


def test_ray_pattern_clearing():
    from ohm_tpu_torch.core.raypattern import RayPatternConical, ClearingPattern
    from ohm_tpu_torch.core.map import OccupancyMap, MapFlag
    from ohm_tpu_torch.oracle.occupancy import RayMapperOccupancy

    m = OccupancyMap(resolution=0.25, flags=MapFlag.NONE)
    mapper = RayMapperOccupancy(m)
    # Occupied obstacle ahead.
    for _ in range(3):
        mapper.integrate_rays(np.array([[0.0, 0, 0], [1.5, 0, 0]]))
    v_before = m.voxel_value(point=[1.5, 0, 0])
    assert v_before >= m.occupancy_threshold_value

    pattern = RayPatternConical((1.0, 0, 0), cone_angle=0.3, range_=3.0, angular_resolution=0.15)
    assert pattern.ray_count > 5
    clearing = ClearingPattern(pattern)
    clearing.apply(mapper, position=(0.0, 0.0, 0.0))
    v_after = m.voxel_value(point=[1.5, 0, 0])
    assert v_after < v_before, "clearing must degrade the occupied voxel"
    # Free/unobserved voxels untouched (EXCLUDE_FREE | EXCLUDE_UNOBSERVED).
    assert np.isinf(m.voxel_value(point=[0.5, 0.4, 0.4]))


def test_secondary_samples():
    from ohm_tpu_torch.oracle.secondary import RayMapperSecondarySample, secondary_sample_range_mean, \
        secondary_sample_std_dev
    from ohm_tpu_torch.core.map import OccupancyMap, MapFlag
    from ohm_tpu_torch.core.layout import SECONDARY_SAMPLES_LAYER

    m = OccupancyMap(resolution=0.25, flags=MapFlag.NONE)
    mapper = RayMapperSecondarySample(m)
    # Primary at origin-ish, secondaries clustered at [1,0,0] with range ~2.
    # All secondaries inside the voxel [1.0, 1.25) (res 0.25 grid boundaries).
    rays = np.array([
        [-1.0, 0, 0], [1.05, 0, 0],
        [-1.0, 0, 0], [1.10, 0, 0],
        [-1.0, 0, 0], [1.20, 0, 0],
    ])
    mapper.integrate_rays(rays)
    region, local = m.voxel_key([1.1, 0, 0])
    chunk = m.region(region)
    idx = int(m.voxel_index(local))
    layer = chunk.layers[m.layer_index(SECONDARY_SAMPLES_LAYER)]
    assert layer["count"][idx] == 3
    assert secondary_sample_range_mean(layer, idx) == pytest.approx(2.1167, abs=0.01)
    assert secondary_sample_std_dev(layer, idx) < 0.2


def test_profile_and_progress_and_trace(tmp_path):
    import time

    from ohm_tpu_torch.utils import Profile, ProfileMarker, ProgressMonitor, Trace

    prof = Profile()
    with ProfileMarker("outer", prof):
        with ProfileMarker("inner", prof):
            time.sleep(0.01)
    report = prof.report()
    assert "outer" in report and "inner" in report

    pm = ProgressMonitor(interval=0.01, out=open(os.devnull, "w"))
    pm.set_target(10)
    pm.start_thread()
    for _ in range(10):
        pm.increment()
    pm.join()
    assert pm.progress == 10

    trace_file = str(tmp_path / "trace.jsonl")
    with Trace(trace_file) as tr:
        tr.event("test", value=1)
    lines = open(trace_file).read().strip().splitlines()
    assert len(lines) == 3  # begin, event, end


def test_ohmgen_generators():
    from ohm_tpu_torch.tools import fill_map_with_empty_space, box_room, slope
    from ohm_tpu_torch.core.map import OccupancyMap, MapFlag

    m = OccupancyMap(resolution=0.25, flags=MapFlag.NONE)
    box_room(m, (-1.0, -1.0, -1.0), (1.0, 1.0, 1.0))
    # Interior free, wall occupied.
    assert m.voxel_value(point=[0.0, 0.0, 0.0]) < m.occupancy_threshold_value
    assert m.voxel_value(point=[0.99, 0.0, 0.0]) >= m.occupancy_threshold_value

    m2 = OccupancyMap(resolution=0.25, flags=MapFlag.NONE)
    slope(m2, (-1, -1, 0), (1, 1, 2), gradient=0.5)
    assert m2.voxel_value(point=[0.9, 0.0, 0.95]) >= m2.occupancy_threshold_value


def test_ohmpop_stats_and_limits(scene, tmp_path):
    """DataSource stats + point/time limits (reference: ohmapp/DataSource.h:75-87,
    DataSource.cpp:135-157 CSV column order, SlamIOSource.cpp:207-212)."""
    from ohm_tpu_torch.app import ohmpop
    from ohm_tpu_torch.app.harness import MapHarness, MapOptions, OutputOptions, RayStats
    from ohm_tpu_torch.io.slam import SlamCloudLoader

    base = str(tmp_path / "stats-map")
    rc = ohmpop.main([scene["cloud"], scene["traj"], "-o", base, "--resolution", "0.2",
                      "--device", "oracle", "--batch-size", "128", "--quiet",
                      "--stats", "csv", "--point-limit", "300"])
    assert rc == 0
    with open(base + "_stats.csv") as f:
        lines = f.read().strip().splitlines()
    assert lines[0] == RayStats.CSV_HEADER
    assert len(lines) >= 2
    last = lines[-1].split(",")
    assert len(last) == 10
    assert 0 < int(last[4]) <= 300  # windowed ray_count respects the limit
    assert float(last[9]) > 0  # rays_per_second_process

    # Precise limit + global stats through the harness surface.
    source = SlamCloudLoader(scene["cloud"], scene["traj"])
    h = MapHarness(
        MapOptions(resolution=0.2, device="oracle", batch_size=128, point_limit=300,
                   stats_mode="console"),
        OutputOptions(base_name=str(tmp_path / "lim"), save_map=False,
                      save_cloud=False, quiet=True), source)
    assert h.run() == 0
    assert h.stats["rays"] == 300
    assert h.global_stats.ray_count == 300
    assert 0 < h.global_stats.ray_length_minimum <= h.global_stats.ray_length_maximum
    assert h.global_stats.ray_length_minimum <= h.global_stats.ray_length_average() \
        <= h.global_stats.ray_length_maximum

    # Time windowing: start_time skips early data, time_limit bounds the span.
    source = SlamCloudLoader(scene["cloud"], scene["traj"])
    h2 = MapHarness(
        MapOptions(resolution=0.2, device="oracle", batch_size=128,
                   start_time=2.0, time_limit=3.0, stats_mode="console"),
        OutputOptions(base_name=str(tmp_path / "tlim"), save_map=False,
                      save_cloud=False, quiet=True), source)
    assert h2.run() == 0
    assert 0 < h2.stats["rays"] < scene["n"]
    span = h2.global_stats.data_time_end - h2.global_stats.data_time_start
    assert span <= 3.0 + 1e-6


def test_dual_returns_secondary_samples(scene, tmp_path):
    """ReturnNumberMode auto: consecutive same-timestamp samples become
    secondary returns feeding the secondary-samples layer
    (reference: OhmAppCpu.cpp:489-536, slamio/SlamCloudLoader.cpp:404-413)."""
    import numpy as np
    from ohm_tpu_torch.app import ohmpop
    from ohm_tpu_torch.io import load
    from ohm_tpu_torch.core.layout import SECONDARY_SAMPLES_LAYER

    # Duplicate every 4th timestamp to fabricate dual returns.
    from ohm_tpu_torch.io.ply import load_ply
    props = load_ply(scene["cloud"])
    t = np.asarray(props["time"]).copy()
    t[1::4] = t[0::4][: len(t[1::4])]
    pts = np.column_stack([props["x"], props["y"], props["z"]])
    dual_cloud = str(tmp_path / "dual.ply")
    _write_timed_ply(dual_cloud, pts, np.sort(t))

    base = str(tmp_path / "dual-map")
    rc = ohmpop.main([dual_cloud, scene["traj"], "-o", base, "--resolution", "0.2",
                      "--device", "oracle", "--batch-size", "256", "--quiet",
                      "--return-number-mode", "auto", "--no-cloud"])
    assert rc == 0
    m, _ = load(base + ".ohm")
    sec_idx = m.layer_index(SECONDARY_SAMPLES_LAYER)
    assert sec_idx >= 0
    total = sum(int(c.layers[sec_idx]["count"].sum()) for c in m.chunks.values())
    assert total > 0


def test_ray_stats_window_ring():
    """RayStats merge + 20-deep window semantics (DataSource.cpp:106-121)."""
    from ohm_tpu_torch.app.harness import RayStats

    g = RayStats()
    for i in range(25):
        b = RayStats(process_time_start=float(i), process_time_end=float(i + 1),
                     data_time_start=float(i), data_time_end=float(i + 1),
                     ray_length_minimum=1.0 + i, ray_length_maximum=2.0 + i,
                     ray_length_total=10.0, ray_count=10)
        g.merge(b)
    assert g.ray_count == 250
    assert g.ray_length_minimum == 1.0
    assert g.ray_length_maximum == 26.0
    assert abs(g.ray_length_average() - 1.0) < 1e-9
    assert g.data_time() == 25.0
    row = g.csv_row().split(",")
    assert len(row) == 10 and int(row[4]) == 250


def test_timing_run_script(scene, tmp_path):
    """ohm_tpu_torch.scripts.timing_run end-to-end on the CPU oracle
    (reference analogue: scripts/ohm-timing-run.py matrix +
    ohm-parse-timing.py)."""
    import csv

    from ohm_tpu_torch.scripts import timing_run as mod

    assert mod.main(["--cloud", scene["cloud"], "--traj", scene["traj"],
                     "--device", "oracle", "--dry-run"]) == 0
    out = str(tmp_path / "timing.csv")
    assert mod.main(["--cloud", scene["cloud"], "--traj", scene["traj"],
                     "--device", "oracle", "--mode", "occupancy",
                     "--resolution", "0.25", "--point-limit", "200",
                     "-o", out]) == 0
    with open(out) as f:
        rows = list(csv.DictReader(f))
    assert len(rows) == 1
    assert rows[0]["device"] == "oracle"
    assert int(rows[0]["rays"]) == 200
    assert float(rows[0]["rays_per_sec"]) > 0


def test_ray_mapper_trace_decorator(tmp_path):
    # Reference: ohm/RayMapperTrace.h:38-80 — wraps a mapper, visualising
    # rays, voxel type transitions and NDT ellipsoids per integration.
    import json

    from ohm_tpu_torch.core.map import OccupancyMap, MapFlag
    from ohm_tpu_torch.oracle.ndt import RayMapperNdt
    from ohm_tpu_torch.utils.trace import Trace, RayMapperTrace

    m = OccupancyMap(resolution=0.25, flags=MapFlag.VOXEL_MEAN)
    m.layout.add_covariance()
    m.ensure_chunk_layers()
    inner = RayMapperNdt(m)
    trace_file = str(tmp_path / "rmtrace.jsonl")
    rays = np.array([[0.0, 0.0, 0.0], [1.5, 0.1, 0.0]] * 4)
    with Trace(trace_file) as tr:
        mapper = RayMapperTrace(inner, tr)
        n = mapper.integrate_rays(rays)
        assert n == 4
        mapper.integrate_rays(rays)  # repeat: more hits, fewer transitions
    events = [json.loads(l) for l in open(trace_file)]
    integ = [e for e in events if e["event"] == "integrate_rays"]
    assert len(integ) == 2
    first = integ[0]
    # First batch: voxels transition from unobserved.
    kinds = {(c["from"], c["to"]) for c in first["voxel_changes"]}
    assert ("null", "free") in kinds or ("unobserved", "free") in kinds
    assert any(c["to"] == "occupied" for c in first["voxel_changes"])
    # NDT covariance produces ellipsoids at occupied voxels.
    assert integ[1]["ellipsoids"], "expected NDT ellipsoids after hits"
    e = integ[1]["ellipsoids"][0]
    assert len(e["pos"]) == 3 and len(e["scale"]) == 3


def test_las_native_reader_roundtrip(tmp_path):
    """Native .las reader (io.las, ASPRS spec) round-trips points, GPS time,
    intensity and return numbers written by write_las."""
    import numpy as np
    from ohm_tpu_torch.io.las import read_las, write_las

    rng = np.random.default_rng(5)
    pts = rng.uniform(-40, 40, (500, 3))
    ts = np.sort(rng.uniform(0, 10, 500))
    intens = rng.integers(0, 65535, 500).astype(np.uint16)
    rn = rng.integers(1, 3, 500).astype(np.uint8)
    nr = np.full(500, 2, np.uint8)
    path = str(tmp_path / "cloud.las")
    write_las(path, pts, timestamps=ts, intensities=intens,
              return_numbers=rn, number_of_returns=nr)
    out = read_las(path)
    np.testing.assert_allclose(out["points"], pts, atol=1e-3)
    np.testing.assert_allclose(out["timestamps"], ts)
    np.testing.assert_array_equal(out["intensities"], intens.astype(np.float32))
    np.testing.assert_array_equal(out["return_numbers"], rn)
    np.testing.assert_array_equal(out["number_of_returns"], nr)


def test_ohmpop_from_las_end_to_end(tmp_path, scene):
    """BASELINE config-2 shape from a real .las in one command: ohmpop over a
    LAS cloud + trajectory to a saved .ohm (VERDICT round-2 item 7)."""
    import numpy as np
    from ohm_tpu_torch.app import ohmpop, ohminfo
    from ohm_tpu_torch.io.las import write_las
    from ohm_tpu_torch.io.slam import load_cloud

    cloud = load_cloud(scene["cloud"])
    las_path = str(tmp_path / "scene.las")
    write_las(las_path, cloud["points"], timestamps=cloud.get("timestamps"),
              intensities=np.zeros(len(cloud["points"]), np.uint16))

    base = str(tmp_path / "las-map")
    rc = ohmpop.main([las_path, scene["traj"], "-o", base, "--resolution", "0.2",
                      "--voxel-mean", "--device", "cpu", "--arena-capacity", "128",
                      "--batch-size", "512", "--quiet"])
    assert rc == 0
    assert os.path.exists(base + ".ohm")
    assert ohminfo.main([base + ".ohm"]) == 0


def test_debug_draw_snapshot(tmp_path):
    # Reference: ohm/DebugDraw.h:17-32 — whole-map voxel/ellipsoid snapshot
    # pushed to the trace sink.
    import json

    from ohm_tpu_torch.core.map import OccupancyMap
    from ohm_tpu_torch.utils.trace import Trace, debug_draw

    m = OccupancyMap(resolution=0.2)
    m.layout.add_covariance()
    m.layout.add_mean()
    m.integrate_rays(np.array([[0.0, 0.0, 0.0, 0.9, 0.1, 0.1]]))
    occ_idx = m.layer_index("occupancy")
    cov_idx = m.layer_index("covariance")
    for _key, chunk in m.chunks.items():
        occ = chunk.layers[occ_idx]["occupancy"]
        sel = np.flatnonzero(occ > 0)
        for name in ("P00", "P11", "P22"):
            chunk.layers[cov_idx][name][sel] = 0.05
    trace_file = str(tmp_path / "dd.jsonl")
    with Trace(trace_file) as tr:
        debug_draw(m, tr)
    events = [json.loads(l) for l in open(trace_file)]
    dd = [e for e in events if e["event"] == "debug_draw"]
    assert len(dd) == 1
    snap = dd[0]
    assert snap["voxel_count"] == 5  # 4 free + 1 occupied along the ray
    assert sum(snap["occupied"]) == 1
    assert snap["omitted"] == 0
    assert len(snap["ellipsoids"]) == 1
    ell = snap["ellipsoids"][0]
    assert ell["scale"] == pytest.approx([0.05] * 3, abs=1e-6)
    # Mean offset applied: centre is near the sample, not the voxel centre.
    assert np.allclose(ell["pos"], [0.9, 0.1, 0.1], atol=0.2)


def test_ray_mapper_trace_incremental_protocol(tmp_path):
    """Round-4 trace depth (reference RayMapperTrace.cpp viewer protocol):
    occupancy_mesh_update carries stable vertex indices with free-list reuse
    (OccupancyMesh::update), and ndt_sector events replace each (region,
    octant) sector's full ellipsoid set by shape id / destroy emptied
    sectors (drawNdt's MultiShape setReplace + destroy)."""
    import json

    from ohm_tpu_torch.core.map import OccupancyMap, MapFlag
    from ohm_tpu_torch.oracle.ndt import RayMapperNdt
    from ohm_tpu_torch.utils.trace import Trace, RayMapperTrace

    m = OccupancyMap(resolution=0.25, flags=MapFlag.VOXEL_MEAN)
    m.layout.add_covariance()
    m.ensure_chunk_layers()
    inner = RayMapperNdt(m)
    trace_file = str(tmp_path / "rmtrace2.jsonl")
    hit_a = np.array([[0.0, 0.0, 0.0], [1.0, 0.05, 0.05]] * 5)
    # The through-rays pass exactly through A's Gaussian mean (NDT-OM miss
    # evidence is strongest where the Gaussian says matter should be;
    # far-from-mean passes produce p~0.5, no adjustment) and their sample
    # voxel lies in the NEXT region, so freeing A empties A's sector and
    # must destroy it.
    through = np.array([[0.0, 0.0, 0.0], [5.0, 0.25, 0.25]] * 60)
    hit_b = np.array([[0.0, 0.0, 0.0], [-1.0, 0.0, 0.0]] * 5)
    with Trace(trace_file) as tr:
        mp = RayMapperTrace(inner, tr)
        mp.integrate_rays(hit_a)     # voxel A occupied
        mp.integrate_rays(through)   # A freed by misses
        mp.integrate_rays(hit_b)     # voxel B occupied: index reuse
    events = [json.loads(l) for l in open(trace_file)]
    mesh = [e for e in events if e["event"] == "occupancy_mesh_update"]
    assert len(mesh) == 3
    a_idx = [v["i"] for v in mesh[0]["added"]
             if abs(v["pos"][0] - 1.125) < 0.2]
    assert len(a_idx) == 1, "voxel A not added in batch 1"
    assert a_idx[0] in mesh[1]["removed"], "voxel A not removed when freed"
    # Free-list reuse: 3 additions, 1 removal — with reuse the index space
    # stays {0, 1}; without it a third index would appear.
    all_added = [v["i"] for e in mesh for v in e["added"]]
    assert len(all_added) == 3 and len(mesh[1]["removed"]) == 1
    assert max(all_added) == 1, "freed vertex index not reused (free list)"
    assert a_idx[0] in all_added[1:], "A's slot never reassigned"

    sect = [e for e in events if e["event"] == "ndt_sector"]
    dest = [e for e in events if e["event"] == "ndt_sector_destroy"]
    assert sect, "no ndt_sector replace events"
    assert all(e["replace"] for e in sect)
    assert all(len(e["shape_id"]) == 4 and 0 <= e["shape_id"][3] < 8 for e in sect)
    # A's sector was created in batch 1 and destroyed when A freed.
    a_sector = sect[0]["shape_id"]
    assert any(e["shape_id"] == a_sector for e in dest), \
        "emptied sector not destroyed"
    # Ellipsoid payloads carry pose + axes (viewer-replayable).
    e0 = sect[0]["ellipsoids"][0]
    assert set(e0) >= {"pos", "scale", "axes"}


def test_transform_samples_device_matches_host():
    """Device-side sample transform (io.slam.transform_samples_device — the
    TransformSamples.cl analogue) agrees with the f64 host path to f32
    tolerance on a rotating + translating trajectory."""
    from ohm_tpu_torch.io.slam import transform_samples, transform_samples_device

    rng = np.random.default_rng(31)
    n = 500
    tt = np.linspace(0.0, 5.0, 20)
    tp = np.column_stack([tt * 0.5, np.sin(tt), np.zeros_like(tt)])
    ang = tt * 0.3
    tq = np.column_stack([np.zeros_like(tt), np.zeros_like(tt),
                          np.sin(ang / 2), np.cos(ang / 2)])
    st = rng.uniform(0.05, 4.95, n)
    local = rng.uniform(-2, 2, (n, 3))

    host = transform_samples(st, local, tt, tp, tq)
    dev = transform_samples_device(st, local, tt, tp, tq, device="cpu").numpy()
    np.testing.assert_allclose(dev, host, atol=5e-4)

    # No-rotation variant.
    host2 = transform_samples(st, local, tt, tp, None)
    dev2 = transform_samples_device(st, local, tt, tp, None, device="cpu").numpy()
    np.testing.assert_allclose(dev2, host2, atol=5e-4)


#: (shift, mask) of each packed field of a mean code: x, y, z and the
#: written bit (tests/test_torch_layers_mapper.py's MEAN_FIELDS).
MEAN_FIELDS = [(0, 1023), (10, 1023), (20, 1023), (31, 1)]


def _layer_members(path, load):
    """(region, layer name, member) -> array of every chunk of a .ohm."""
    m, _ = load(path)
    return {(k, layer.name, name): np.ascontiguousarray(c.layers[i][name])
            for k, c in m.chunks.items() for i, layer in enumerate(m.layout)
            for name in c.layers[i].dtype.names}


def _assert_same_map(ref, port):
    """Keys, occupancy bits and mean counts identical; mean codes identical
    on >= 99.9% of written voxels and within one quantum elsewhere."""
    assert ref.keys() == port.keys() and len(ref) > 0
    codes = []
    for key, a in ref.items():
        b = port[key]
        if key[2] == "coord":
            written = (a != 0) | (b != 0)
            codes.append((a[written], b[written]))
        else:
            assert a.dtype == b.dtype and np.array_equal(a.view(np.uint8), b.view(np.uint8)), key
    a = np.concatenate([x for x, _ in codes]).astype(np.int64)
    b = np.concatenate([y for _, y in codes]).astype(np.int64)
    assert a.size > 100
    assert float((a == b).mean()) >= 0.999
    for shift, mask in MEAN_FIELDS:
        assert int(np.abs(((a >> shift) & mask) - ((b >> shift) & mask)).max()) <= 1


def test_ohmpop_matches_the_jax_package(scene, tmp_path, monkeypatch):
    """ohmpop of one scene through both packages: the JAX package's mapper
    on its rayflow wire (the one the port takes) with the split-phase apply,
    the port's on the CPU."""
    import ohm_tpu.app.ohmpop as ref_ohmpop
    import ohm_tpu.io as ref_io
    from ohm_tpu_torch import io as port_io
    from ohm_tpu_torch.app import ohmpop

    args = [scene["cloud"], scene["traj"], "--resolution", "0.2", "--voxel-mean",
            "--arena-capacity", "128", "--batch-size", "512", "--quiet", "--no-cloud"]
    monkeypatch.setenv("OHM_RAYFLOW", "1")
    monkeypatch.setenv("OHM_FUSED", "0")
    ref_base, port_base = str(tmp_path / "ref"), str(tmp_path / "port")
    assert ref_ohmpop.main(args + ["-o", ref_base, "--device", "tpu"]) == 0
    assert ohmpop.main(args + ["-o", port_base, "--device", "cpu"]) == 0
    _assert_same_map(_layer_members(ref_base + ".ohm", ref_io.load),
                     _layer_members(port_base + ".ohm", port_io.load))


def test_ohmpop_on_cuda_raises_without_a_device(scene, tmp_path, monkeypatch):
    """No fallback: "--device cuda" (the default) raises where PyTorch sees
    no CUDA device, and writes nothing."""
    import torch

    from ohm_tpu_torch.app import ohmpop

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    base = str(tmp_path / "cuda-map")
    for device in ([], ["--device", "cuda"]):
        with pytest.raises(RuntimeError, match="CUDA"):
            ohmpop.main([scene["cloud"], scene["traj"], "-o", base, "--quiet"] + device)
    assert not os.path.exists(base + ".ohm")
