"""The port's two bench entry points (``ohm_tpu_torch.bench`` and
``ohm_tpu_torch.scripts.bench_modes``) against ``bench.py`` and
``scripts/bench_modes.py`` on the CPU:

  source        the scene functions are copies of the reference's text
  differentials the port's hardware_differential line and its
                hardware_differential_worst_abs_err row equal the
                reference's under JAX on the CPU, for the same seed
  entry points  both mains run at a small size (their functions called with
                small arguments) and print the reference's keys plus
                ``backend`` and ``device``; --device cuda exits non-zero
                without a card
  worker        the loops the benches time go through the asynchronous
                worker and leave the map the same synchronous calls leave,
                bit for bit (occupancy, TSDF, NDT-TM with intensities and
                timestamps)

``scripts/bench_modes.py`` parses its arguments and imports JAX when it is
imported; it is loaded from its path into a fresh module with its argv set.
"""

import ast
import functools
import importlib.util
import inspect
import json
import os
import subprocess
import sys

import numpy as np
import pytest

import bench as ref_bench
from ohm_tpu_torch import bench
from ohm_tpu_torch.scripts import bench_modes
from ohm_tpu_torch.testing import BENCH_WORKER_KINDS, bench_worker_maps, map_bytes

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEVICE_KEYS = {"backend", "device"}
#: The keys of each line the reference prints, by metric (bench.py:70-72,
#: 180-185, 253-262; scripts/bench_modes.py:136-137, 188-189, 238-241,
#: 272-280, 294-295, 304-305, 322-323, 382-392).
REFERENCE_KEYS = {
    "hardware_differential": {"metric", "compared_voxels", "mismatches", "worst_abs_diff", "ok"},
    "hardware_fused_differential": {"metric", "bit_identical"},
    "occupancy_integrate_rays_per_sec": {"metric", "value", "unit", "vs_baseline"},
    "bench_attribution": {"metric", "wire_bytes_per_ray", "host_prep_ms_per_batch",
                          "transfer_ms_per_batch", "transfer_mb_per_s",
                          "device_only_rays_per_sec", "device_only_ms_per_batch",
                          "tunnel_rtt_ms"},
    "hardware_differential_worst_abs_err": {"metric", "value", "unit", "voxels"},
    "occupancy_mean_outdoor_rays_per_sec": {"metric", "value", "unit", "vs_baseline", "source"},
    "rays_query_p50_ms": {"metric", "value", "unit", "vs_baseline", "rays", "tunnel_rtt_ms",
                          "device_ms_per_query"},
    "sharded_n1_overhead": {"metric", "sharded_rays_per_sec", "single_rays_per_sec",
                            "overhead_frac", "wire_bytes_per_ray", "routed_copies_per_ray"},
    "ndt_om_rays_per_sec": {"metric", "value", "unit", "vs_baseline"},
    "tsdf_rays_per_sec": {"metric", "value", "unit", "vs_baseline"},
    "layered_heightmap_build_sec": {"metric", "value", "unit", "source_voxels"},
    "ndt_tm_pipeline_frame_sec": {"metric", "value", "unit", "rays", "integrate_sec",
                                  "clearance_sec", "clearance_incremental_sec",
                                  "clearance_incremental_regions", "heightmap_sec",
                                  "rays_per_sec"},
}
BENCH_MODES_METRICS = ["hardware_differential_worst_abs_err",
                       "occupancy_mean_outdoor_rays_per_sec", "rays_query_p50_ms",
                       "sharded_n1_overhead", "ndt_om_rays_per_sec", "tsdf_rays_per_sec",
                       "layered_heightmap_build_sec"]
#: Small sizes for the CPU: 256 rays a batch; 512 slots hold a box batch's
#: ~205 regions at 0.1 m and the outdoor frame's ~250-285 at 0.2 m.
SMALL = {"rays_per_batch": 256, "capacity": 512}


def _source_of(path: str, name: str) -> str:
    """The text of the top-level function ``name`` in the file at ``path``."""
    with open(os.path.join(REPO, path)) as f:
        text = f.read()
    node = next(n for n in ast.parse(text).body
                if isinstance(n, ast.FunctionDef) and n.name == name)
    return ast.get_source_segment(text, node) + "\n"


@pytest.mark.parametrize("path,name,port", [("bench.py", "box_scene_rays", bench),
                                            ("scripts/bench_modes.py", "outdoor_rays",
                                             bench_modes)], ids=["box", "outdoor"])
def test_scene_function_is_a_copy(path, name, port):
    assert inspect.getsource(getattr(port, name)) == _source_of(path, name)


@functools.lru_cache(maxsize=None)
def reference_bench_modes():
    """scripts/bench_modes.py as a fresh module (its argv: --platform cpu)."""
    spec = importlib.util.spec_from_file_location(
        "_bench_modes_reference", os.path.join(REPO, "scripts", "bench_modes.py"))
    mod = importlib.util.module_from_spec(spec)
    argv, path = list(sys.argv), list(sys.path)
    sys.argv[:] = ["bench_modes.py", "--platform", "cpu"]
    sys.path.insert(0, REPO)  # its `import bench`
    try:
        spec.loader.exec_module(mod)
    finally:
        sys.argv[:] = argv
        sys.path[:] = path
    return mod


def _json_lines(text: str) -> list[dict]:
    return [json.loads(ln) for ln in text.splitlines() if ln.startswith("{")]


class _FirstHalfDone(Exception):
    """Raised where bench.hardware_check starts its second (fused) half."""


def test_hardware_check_matches_the_reference(monkeypatch, capsys):
    """The port's line against the reference's first half (its box scan
    against the oracle); the fused half (the port's
    hardware_fused_differential, below) is stopped where it draws its first
    batch."""
    scans = []

    def first_scan_only(n, rng, *args, **kwargs):
        if scans:
            raise _FirstHalfDone
        scans.append(n)
        return bench.box_scene_rays(n, rng, *args, **kwargs)

    monkeypatch.setattr(ref_bench, "box_scene_rays", first_scan_only)
    with pytest.raises(_FirstHalfDone):
        ref_bench.hardware_check(np.random.default_rng(bench.SEED))
    ref = _json_lines(capsys.readouterr().out)[0]
    assert scans == [1024]
    port = bench.hardware_check(np.random.default_rng(bench.SEED), "cpu")
    assert ref["metric"] == port["metric"] == "hardware_differential"
    assert port["ok"] and ref["ok"] and port["compared_voxels"] > 100_000
    for key in ("compared_voxels", "mismatches", "worst_abs_diff"):
        assert port[key] == ref[key], key
    assert set(port) == REFERENCE_KEYS["hardware_differential"] | DEVICE_KEYS
    assert _json_lines(capsys.readouterr().out) == [port]


def test_hardware_fused_differential_draws_the_reference_batches(monkeypatch, capsys):
    """bench.py's fused half draws six 512-ray batches after the first
    half's 1024-ray scan (bench.py:39,88); the port's draws the same ones
    from the same generator and prints its line (bit_identical on the CPU)
    with the reference's keys."""
    rng = np.random.default_rng(bench.SEED)
    ref_bench.box_scene_rays(1024, rng)
    want = [ref_bench.box_scene_rays(512, rng) for _ in range(6)]
    drawn, inner = [], bench.box_scene_rays

    def recorded(n, rng, *args, **kwargs):
        drawn.append(inner(n, rng, *args, **kwargs))
        return drawn[-1]

    monkeypatch.setattr(bench, "box_scene_rays", recorded)
    rng = np.random.default_rng(bench.SEED)
    bench.box_scene_rays(1024, rng)
    # The fused route on the rayflow wire, the mappers' default (only the
    # port's mappers run here).
    monkeypatch.setenv("OHM_RAYFLOW", "1")
    row = bench.hardware_fused_differential(rng, "cpu")
    assert len(drawn) == 7 and all(np.array_equal(a, b) for a, b in zip(want, drawn[1:]))
    assert row["bit_identical"] and row["metric"] == "hardware_fused_differential"
    assert set(row) == REFERENCE_KEYS["hardware_fused_differential"] | DEVICE_KEYS
    assert _json_lines(capsys.readouterr().out) == [row]


def test_differential_on_hardware_matches_the_reference():
    ref = reference_bench_modes().differential_on_hardware()
    port = bench_modes.differential_on_hardware("cpu")
    assert port == ref and port["voxels"] > 1000


def _check_lines(rows: list[dict], metrics: list[str]) -> None:
    assert [r["metric"] for r in rows] == metrics
    for r in rows:
        assert set(r) == REFERENCE_KEYS[r["metric"]] | DEVICE_KEYS, r["metric"]
        assert r["backend"] == "cpu" and r["device"] == "cpu"
        assert r.get("vs_baseline") is None


def test_bench_main_at_a_small_size(monkeypatch, capsys):
    """bench.main sizes the run by the reference's switch (16384 rays a
    batch here: 20 batches) and calls bench.run, here at 256 rays and 4
    batches."""
    seen, run = [], bench.run

    def small_run(device, rays_per_batch, n_batches, check, attrib):
        seen.append((device, rays_per_batch, n_batches, check, attrib))
        return run(device, 256, 4, check=check, attrib=attrib)

    monkeypatch.setattr(bench, "run", small_run)
    monkeypatch.setenv("OHM_BENCH_RAYS", "16384")
    monkeypatch.delenv("OHM_BENCH_CHECK", raising=False)
    monkeypatch.delenv("OHM_BENCH_ATTRIB", raising=False)
    assert bench.main(["--device", "cpu"]) == 0
    assert seen == [("cpu", 16384, 20, True, True)]
    rows = _json_lines(capsys.readouterr().out)
    _check_lines(rows, ["hardware_differential", "hardware_fused_differential",
                        "occupancy_integrate_rays_per_sec", "bench_attribution"])
    assert rows[0]["ok"] and rows[1]["bit_identical"]
    assert rows[2]["value"] > 0 and rows[2]["unit"] == "rays/s"
    assert rows[3]["wire_bytes_per_ray"] > 0 and rows[3]["device_only_rays_per_sec"] > 0


def test_bench_modes_main_at_a_small_size(monkeypatch, capsys, tmp_path):
    """bench_modes.main runs run (here at SMALL, --quick: config 5 left
    out) and writes the rows it printed, each stamped with a SHA, to
    --out."""
    run = bench_modes.run
    monkeypatch.setattr(bench_modes, "run",
                        lambda device, quick: run(device, quick=quick, **SMALL))
    out = tmp_path / "rows.json"
    assert bench_modes.main(["--device", "cpu", "--quick", "--out", str(out)]) == 0
    rows = _json_lines(capsys.readouterr().out)
    _check_lines(rows, BENCH_MODES_METRICS)
    written = json.loads(out.read_text())
    sha = written[0]["sha"]
    assert sha and all(r.pop("sha") == sha for r in written)
    assert written == rows
    by = {r["metric"]: r for r in rows}
    assert by["occupancy_mean_outdoor_rays_per_sec"]["source"] == "laz"
    assert by["sharded_n1_overhead"]["routed_copies_per_ray"] == 1.0
    assert by["layered_heightmap_build_sec"]["source_voxels"] > 0


def test_ndt_tm_pipeline_at_a_small_size():
    row = bench_modes.ndt_tm_pipeline(np.random.default_rng(bench_modes.SEED), "cpu",
                                      rays_per_batch=256, capacity=128, frame_rays=2048,
                                      delta_rays=256)
    assert set(row) == REFERENCE_KEYS["ndt_tm_pipeline_frame_sec"]
    assert row["rays"] == 2048 and row["clearance_incremental_regions"] > 0
    assert row["value"] == pytest.approx(
        row["integrate_sec"] + row["clearance_sec"] + row["heightmap_sec"], abs=2e-3)


@pytest.mark.parametrize("module,extra", [("ohm_tpu_torch.bench", []),
                                          ("ohm_tpu_torch.scripts.bench_modes", ["--quick"])],
                         ids=["bench", "bench_modes"])
def test_cuda_device_without_a_card_exits_non_zero(module, extra, tmp_path):
    """No CUDA device shows (CUDA_VISIBLE_DEVICES empty): the command
    raises through ohm_tpu_torch.device before any line, on any machine."""
    env = dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "-m", module, "--device", "cuda", *extra],
                         capture_output=True, text=True, cwd=tmp_path, env=env, timeout=300)
    assert out.returncode != 0
    assert "CUDA is not available" in out.stderr
    assert not any(ln.startswith("{") for ln in out.stdout.splitlines())
    assert not list(tmp_path.iterdir())


@pytest.mark.parametrize("kind", BENCH_WORKER_KINDS)
def test_worker_loop_gives_the_synchronous_map(kind, monkeypatch):
    # The worker coalesces rayflow wires; tests/conftest.py's OHM_RAYFLOW=0
    # would send every batch to the segmented wire and the synchronous path.
    monkeypatch.setenv("OHM_RAYFLOW", "1")
    worker, sync = bench_worker_maps(kind, "cpu")
    a, b = map_bytes(worker), map_bytes(sync)
    assert len(worker.chunks) > 0 and a.keys() == b.keys()
    assert all(a[k] == b[k] for k in a)
