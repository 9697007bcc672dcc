"""The PyTorch port's boundaries: it imports and integrates without JAX and
without any module of the JAX package (on the rayflow and the segmented
wire; its apps from a .laz; its sharded mappers; its two benches), its
default device is CUDA and never quietly the CPU, and its mappers take any
map layout, as the reference's do."""

import ctypes
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from ohm_tpu_torch import TorchRayMapper, TorchTsdfMap, resolve_device
from ohm_tpu_torch.core.map import MapFlag, OccupancyMap
from ohm_tpu_torch.core.rayflags import RayFlag
from ohm_tpu_torch.ops import _build

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port_env() -> dict:
    """A subprocess's environment: the repository on the path, and the
    rayflow wire that the port's mappers take by default (tests/conftest.py
    sets OHM_RAYFLOW=0 for the test run, which these scripts would
    inherit)."""
    return dict(os.environ, PYTHONPATH=REPO, OHM_RAYFLOW="1")

_SCRIPT = """
import sys
import numpy as np
import ohm_tpu_torch
from ohm_tpu_torch.core.map import OccupancyMap
rng = np.random.default_rng(0)
rays = np.zeros((128, 3))
rays[1::2] = rng.uniform(-3, 3, (64, 3))
m = OccupancyMap(resolution=0.1)
mapper = ohm_tpu_torch.TorchRayMapper(m, capacity=64, validate=True, device="cpu")
assert mapper.integrate_rays(rays) == 64
mapper.sync_voxels()
assert mapper.stats["batches"] == 1 and len(m.chunks) > 0
from ohm_tpu_torch.oracle.ndt import NdtParams
for tm in (False, True):
    m = OccupancyMap(resolution=0.1)
    ndt = ohm_tpu_torch.TorchNdtMap(m, NdtParams(ndt_tm=tm), capacity=64, validate=True,
                                    device="cpu")
    for _ in range(2):
        ndt.integrate_rays(rays, intensities=rng.uniform(0, 1, 64))
    ndt.sync_voxels()
    assert ndt.stats["batches"] == 2 and len(m.chunks) > 0
from ohm_tpu_torch.oracle.tsdf import TsdfOptions
for per_visit in (True, False):
    m = OccupancyMap(resolution=0.1)
    tsdf = ohm_tpu_torch.TorchTsdfMap(m, TsdfOptions(per_visit=per_visit), capacity=64,
                                      validate=True, device="cpu")
    tsdf.integrate_rays(rays)
    tsdf.sync_voxels()
    assert tsdf.stats["batches"] == 1 and len(m.chunks) > 0
from ohm_tpu_torch.core.map import MapFlag
m = OccupancyMap(resolution=0.1, flags=MapFlag.VOXEL_MEAN | MapFlag.TRAVERSAL
                 | MapFlag.TOUCH_TIME | MapFlag.INCIDENT_NORMAL)
layers = ohm_tpu_torch.TorchRayMapper(m, capacity=64, validate=True, device="cpu")
for i in range(2):
    layers.integrate_rays_async(rays, timestamps=10.0 + i + np.arange(64) * 1e-3)
layers.sync_voxels()
assert layers.stats["batches"] == 2 and len(m.chunks) > 0
m = OccupancyMap(resolution=0.1, flags=MapFlag.TRAVERSAL | MapFlag.TOUCH_TIME
                 | MapFlag.INCIDENT_NORMAL)
ndt_layers = ohm_tpu_torch.TorchNdtMap(m, NdtParams(ndt_tm=True), capacity=64, validate=True,
                                       device="cpu")
ndt_layers.integrate_rays(rays, intensities=rng.uniform(0, 1, 64),
                          timestamps=10.0 + np.arange(64) * 1e-3)
ndt_layers.sync_voxels()
assert ndt_layers.stats["batches"] == 1 and len(m.chunks) > 0
from ohm_tpu_torch.core.raypattern import ClearingPattern, RayPatternConical
m = OccupancyMap(resolution=0.1, flags=MapFlag.TRAVERSAL)
seg = ohm_tpu_torch.TorchRayMapper(m, capacity=9000, validate=True, device="cpu")
seg.integrate_rays(rays)
ClearingPattern(RayPatternConical((1, 0, 0), 0.3, 4.0, 0.1)).apply(seg, (0.0, 0.0, 0.0))
seg.sync_voxels()
assert seg.stats["batches"] == 2 and seg.stats["segments"] > 64 and len(m.chunks) > 0
for mapper in (ohm_tpu_torch.TorchNdtMap(OccupancyMap(resolution=0.1), NdtParams(ndt_tm=True),
                                         capacity=64, validate=True, device="cpu",
                                         rayflow=False),
               ohm_tpu_torch.TorchTsdfMap(OccupancyMap(resolution=0.1), capacity=64,
                                          validate=True, device="cpu", rayflow=False)):
    mapper.integrate_rays(rays, intensities=rng.uniform(0, 1, 64))
    mapper.sync_voxels()
    assert mapper.stats["segments"] > 64
from ohm_tpu_torch.scripts import probe_deposit
assert probe_deposit.main(["--device", "cpu", "--small"])["ok"]
print(sorted(n for n in sys.modules if n == "jax" or n.startswith(("jax.", "ohm_tpu."))
             or n == "ohm_tpu"))
"""


def test_import_and_cpu_integrate_leave_jax_and_ohm_tpu_out():
    env = _port_env()
    out = subprocess.run([sys.executable, "-c", _SCRIPT], capture_output=True,
                         text=True, cwd=REPO, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


_QUERY_SCRIPT = """
import sys
sys.modules["jax"] = None  # any import of jax now raises ImportError
import numpy as np
from ohm_tpu_torch.core.map import OccupancyMap
from ohm_tpu_torch.oracle.occupancy import RayMapperOccupancy
from ohm_tpu_torch.query import (ClearanceProcess, LineKeysQuery, LineQuery,
                                 NearestNeighbours, OccupancyType, RaysQuery)
m = OccupancyMap(resolution=0.25)
rays = np.array([[0.0, 0.0, 0.0], [2.0, 0.1, 0.0]] * 8)
RayMapperOccupancy(m).integrate_rays(rays)
q = RaysQuery(m, device="cpu")
q.set_rays(np.array([[0.0, 0.0, 0.0], [3.0, 0.1, 0.0]]))
q.execute()
assert q.terminal_states[0] == OccupancyType.OCCUPIED
k = LineKeysQuery(m, device="cpu")
k.set_rays(rays[:2])
k.execute()
assert k.result_counts[0] > 0
assert ClearanceProcess(m, search_radius=0.5, device="cpu").update(force=True) > 0
assert NearestNeighbours(m, near_point=(2.0, 0.0, 0.0), search_radius=0.6).execute()
print(sorted(n for n in sys.modules if n.startswith(("jax.", "ohm_tpu."))
             or n in ("ohm_tpu", "triton")))
"""


def test_queries_import_and_run_with_jax_blocked():
    env = _port_env()
    out = subprocess.run([sys.executable, "-c", _QUERY_SCRIPT], capture_output=True,
                         text=True, cwd=REPO, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


_APPS_SCRIPT = """
import os
import sys
import tempfile
sys.modules["jax"] = None  # any import of jax now raises ImportError
import numpy as np
import ohm_tpu_torch.app
import ohm_tpu_torch.heightmap
import ohm_tpu_torch.io
from ohm_tpu_torch.app import ohmheightmap, ohminfo, ohmpop
from ohm_tpu_torch.io.las import write_laz
rng = np.random.default_rng(3)
pts = np.column_stack([rng.uniform(-3, 3, (400, 2)), np.zeros(400)])
t = 10.0 + np.arange(400) * 1e-3
with tempfile.TemporaryDirectory() as d:
    cloud, traj, base = (os.path.join(d, n) for n in ("c.laz", "t.txt", "map"))
    write_laz(cloud, pts, timestamps=t)
    with open(traj, "w") as f:
        f.write(f"{t[0]} 0 0 1.5\\n{t[-1] + 1} 0 0 1.5\\n")
    assert ohmpop.main([cloud, traj, "-o", base, "--resolution", "0.25", "--voxel-mean",
                        "--arena-capacity", "64", "-q", "--device", "cpu"]) == 0
    assert ohminfo.main([base + ".ohm"]) == 0
    assert ohmheightmap.main([base + ".ohm", base + "-hm.ohm", "--clearance", "0.5"]) == 0
print(sorted(n for n in sys.modules if n.startswith(("jax.", "ohm_tpu."))
             or n in ("ohm_tpu", "triton")))
"""


def test_apps_import_and_run_with_jax_blocked():
    """ohm_tpu_torch.app, .io and .heightmap import, and ohmpop builds a map
    from a .laz on the CPU, with JAX blocked and no module of ohm_tpu
    loaded."""
    env = _port_env()
    out = subprocess.run([sys.executable, "-c", _APPS_SCRIPT], capture_output=True,
                         text=True, cwd=REPO, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


_PARALLEL_SCRIPT = """
import sys
sys.modules["jax"] = None  # any import of jax now raises ImportError
import numpy as np
import ohm_tpu_torch.parallel as par
from ohm_tpu_torch.core.map import OccupancyMap
rng = np.random.default_rng(1)
rays = rng.uniform(-6, 6, (2 * 256, 3))
rays[0::2] *= 0.05
mesh = par.ShardMesh.repeat("cpu", 2)
for cls in (par.ShardedRayMapper, par.ShardedRayFlowMapper):
    mapper = cls(OccupancyMap(resolution=0.25), mesh, capacity=32, validate=True)
    assert mapper.integrate_rays(rays) == 256
    mapper.sync_voxels()
    assert len(mapper.map.chunks) > 0
print(sorted(n for n in sys.modules if n.startswith(("jax.", "ohm_tpu."))
             or n in ("ohm_tpu", "triton")))
"""


def test_parallel_imports_and_steps_with_jax_blocked():
    """ohm_tpu_torch.parallel imports, and a sharded step runs on both wires
    on the CPU, with JAX blocked and no module of ohm_tpu loaded."""
    env = _port_env()
    out = subprocess.run([sys.executable, "-c", _PARALLEL_SCRIPT], capture_output=True,
                         text=True, cwd=REPO, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


_BENCH_SCRIPT = """
import sys
sys.modules["jax"] = None  # any import of jax now raises ImportError
from ohm_tpu_torch import bench
from ohm_tpu_torch.scripts import bench_modes
rows = bench.run("cpu", 256, 4, check=False)
assert [r["metric"] for r in rows] == ["occupancy_integrate_rays_per_sec", "bench_attribution"]
assert bench_modes.differential_on_hardware("cpu")["voxels"] > 0
print(sorted(n for n in sys.modules if n.startswith(("jax.", "ohm_tpu.", "scripts."))
             or n in ("ohm_tpu", "scripts", "bench", "triton")))
"""


def test_bench_modules_import_and_run_with_jax_blocked():
    """ohm_tpu_torch.bench and ohm_tpu_torch.scripts.bench_modes import and
    run on the CPU with JAX blocked, and load no module of ohm_tpu, nor the
    root bench.py or scripts/."""
    env = _port_env()
    out = subprocess.run([sys.executable, "-c", _BENCH_SCRIPT], capture_output=True,
                         text=True, cwd=REPO, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


_ROUTES_SCRIPT = """
import os, sys
sys.modules["jax"] = None  # any import of jax now raises ImportError
import numpy as np
from ohm_tpu_torch import TorchNdtMap, TorchRayMapper
from ohm_tpu_torch.core.map import MapFlag, OccupancyMap
from ohm_tpu_torch.ops import integrate, segments
rng = np.random.default_rng(0)
batches = []
for _ in range(6):
    rays = np.zeros((512, 3))
    rays[1::2] = rng.uniform(-2, 2, (256, 3))
    batches.append(rays)
os.environ["OHM_FUSED"] = "2"
fused = TorchRayMapper(OccupancyMap(resolution=0.1, region_voxel_dims=8, flags=MapFlag.TRAVERSAL),
                       capacity=256, validate=True, device="cpu")
ndt = TorchNdtMap(OccupancyMap(resolution=0.1, region_voxel_dims=8, flags=MapFlag.TRAVERSAL),
                  capacity=256, validate=True, device="cpu")
del os.environ["OHM_FUSED"]
delta = TorchRayMapper(OccupancyMap(resolution=0.1, region_voxel_dims=8), capacity=256,
                       validate=True, device="cpu", delta_path=True)
for mapper in (fused, ndt, delta):
    for b in batches[:4]:
        mapper.integrate_rays(b)
    mapper._integrate_group([(b, None, None, 0) for b in batches[4:]])
    mapper.integrate_rays_async(batches[0])
    mapper.sync_voxels()
assert (fused.last_route, ndt.last_route, delta.last_route) == ("fused", "fused", "delta")
print(sorted(n for n in sys.modules if n.startswith(("jax.", "ohm_tpu.", "scripts."))
             or n in ("ohm_tpu", "scripts", "bench", "triton")))
"""


def test_apply_routes_import_and_run_with_jax_blocked():
    """The fused, NDT fused and delta routes and the worker's group import
    and run on the CPU with JAX blocked, and load no module of ohm_tpu, nor
    the root bench.py or scripts/."""
    env = _port_env()
    out = subprocess.run([sys.executable, "-c", _ROUTES_SCRIPT], capture_output=True,
                         text=True, cwd=REPO, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_parallel_defaults_to_cuda_and_raises_without_it(monkeypatch):
    from ohm_tpu_torch.parallel import ShardMesh, dryrun_multichip

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ShardMesh.repeat()
    with pytest.raises(RuntimeError, match="CUDA"):
        ShardMesh.over_cards(4)
    with pytest.raises(RuntimeError, match="CUDA"):
        dryrun_multichip(4)
    assert ShardMesh.repeat("cpu", 3).devices == [torch.device("cpu")] * 3


def test_no_source_of_the_port_imports_jax():
    pattern = re.compile(r"^\s*(import\s+jax|from\s+jax\b|import\s+ohm_tpu\b|from\s+ohm_tpu[. ]"
                         r"|import\s+scripts\b|from\s+scripts\b|import\s+bench\b|from\s+bench\b)",
                         re.MULTILINE)
    paths = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(os.path.join(REPO, "ohm_tpu_torch")):
        paths += [os.path.join(root, f) for f in files if f.endswith(".py")]
    assert len(paths) > 10
    for path in paths:
        with open(path) as f:
            assert not pattern.search(f.read()), path


def test_deposit_probe_runs_as_a_module_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=REPO)
    cmd = [sys.executable, "-m", "ohm_tpu_torch.scripts.probe_deposit", "--device", "cpu",
           "--small"]
    out = subprocess.run(cmd, capture_output=True, text=True, cwd=REPO, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert lines[0] == "device: cpu  stream N=8192 C=8 live=5"
    assert sum(" OK: " in ln for ln in lines) == 5
    assert "  [slotgrid] vs f32 scatter path: bit mismatches=0" in lines
    assert not any("ms/iter" in ln for ln in lines)


def test_default_device_is_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        TorchRayMapper(OccupancyMap(resolution=0.1), capacity=64)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("meta")


def _integrates_and_keeps(mapper, m, layer: str) -> None:
    """Two batches through ``mapper``; ``layer``, filled between them, keeps
    its values, as the reference's mappers leave a layer they do not know."""
    rays = np.zeros((64, 3))
    rays[1::2] = np.random.default_rng(5).uniform(-2, 2, (32, 3))
    mapper.integrate_rays(rays)
    mapper.sync_voxels()
    li = m.layer_index(layer)
    kept = {}
    for key, chunk in m.chunks.items():
        arr = chunk.layers[li]
        for name in arr.dtype.names:
            arr[name] = np.arange(arr[name].size).reshape(arr[name].shape) % 97 + 1
            kept[(key, name)] = np.array(arr[name])
    mapper.integrate_rays(rays)
    mapper.sync_voxels()
    assert kept and mapper.stats["batches"] == 2
    for (key, name), want in kept.items():
        assert np.array_equal(m.chunks[key].layers[li][name], want), (key, name)


def test_what_is_not_ported_raises():
    """A map layer the occupancy mapper does not update stays as the host
    map holds it, as the reference leaves it; what the segmented wire took
    over raises nothing either: STOP_ON_FIRST_OCCUPIED, an arena over 8191
    regions and a batch outside the rayflow envelope each integrate there,
    with the segments counted."""
    m = OccupancyMap(resolution=0.1, flags=MapFlag.VOXEL_MEAN | MapFlag.TRAVERSAL
                     | MapFlag.TOUCH_TIME | MapFlag.INCIDENT_NORMAL)
    mapper = TorchRayMapper(m, capacity=64, device="cpu", rayflow=True)
    assert sorted(mapper.arena.layers) == ["incident", "mean_coord", "mean_count",
                                           "occupancy", "touch_time", "traversal"]
    m.layout.add_intensity()  # an NDT-TM layer the occupancy mapper does not update
    mapper = TorchRayMapper(m, capacity=64, device="cpu", rayflow=True)
    assert "intensity" not in mapper.arena.layers
    _integrates_and_keeps(mapper, m, "intensity")
    big = TorchRayMapper(OccupancyMap(resolution=0.1), capacity=8192, device="cpu",
                         rayflow=True)
    rays = np.array([[0.0, 0.0, 0.0], [1.0, 0.5, 0.2]])
    assert big.integrate_rays(rays) == 1
    assert big.stats["segments"] == 1 and big._k_cache_rf == 4  # not the rayflow wire
    mapper = TorchRayMapper(OccupancyMap(resolution=0.1), capacity=64, device="cpu", rayflow=True)
    assert mapper.integrate_rays(rays, ray_update_flags=RayFlag.STOP_ON_FIRST_OCCUPIED) == 1
    assert mapper.integrate_rays_async(
        rays, ray_update_flags=RayFlag.STOP_ON_FIRST_OCCUPIED) == 1
    assert mapper.integrate_rays_async(rays) == 1
    mapper.flush()
    assert mapper.stats["batches"] == 3 and mapper.stats["segments"] == 3
    # A ray over 32 regions (0.8 m regions, 40 m ray) leaves the rayflow
    # envelope: 51 segments of at most one region edge.
    fine = TorchRayMapper(OccupancyMap(resolution=0.1, region_voxel_dims=8),
                          capacity=64, device="cpu", rayflow=True)
    fine.integrate_rays(np.array([[0.0, 0.0, 0.0], [40.0, 0.0, 0.0]]))
    assert fine.stats["segments"] == 51 and fine.stats["rays"] == 1


def test_what_is_not_ported_under_ndt_raises():
    from ohm_tpu_torch import TorchNdtMap
    from ohm_tpu_torch.oracle.ndt import NdtParams
    from ohm_tpu_torch.ops.expand_cuda import expand_keys
    from ohm_tpu_torch.ops.wire import unpack_batch

    # The side layers integrate under NDT, each in the arena and written.
    rays = np.zeros((64, 3))
    rays[1::2] = np.random.default_rng(4).uniform(-2, 2, (32, 3))
    for flag, layer, arena_layer in ((MapFlag.TRAVERSAL, "traversal", "traversal"),
                                     (MapFlag.TOUCH_TIME, "touch_time", "touch_time"),
                                     (MapFlag.INCIDENT_NORMAL, "incident_normal", "incident")):
        m = OccupancyMap(resolution=0.1, flags=flag)
        ndt = TorchNdtMap(m, capacity=64, validate=True, device="cpu", rayflow=True)
        assert arena_layer in ndt.arena.layers
        ndt.integrate_rays(rays, timestamps=10.0 + np.arange(32) * 1e-3)
        ndt.sync_voxels()
        li = m.layer_index(layer)
        member = m.chunks[next(iter(m.chunks))].layers[li].dtype.names[0]
        assert sum(int(np.count_nonzero(c.layers[li][member])) for c in m.chunks.values()) > 0
    # NDT-OM leaves the NDT-TM layer it does not update as the host map
    # holds it.
    m = OccupancyMap(resolution=0.1, flags=MapFlag.NONE)
    m.layout.add_intensity()
    ndt = TorchNdtMap(m, NdtParams(), capacity=64, device="cpu", rayflow=True)
    assert "intensity" not in ndt.arena.layers
    _integrates_and_keeps(ndt, m, "intensity")
    mapper = TorchNdtMap(OccupancyMap(resolution=0.1, flags=MapFlag.NONE), capacity=64,
                         device="cpu", rayflow=True)
    assert mapper.arena.occupancy_encoding == "inf"
    assert torch.isposinf(mapper.arena.occupancy).all()
    # The worker is the base mapper's: queued NDT batches give the map the
    # synchronous calls give.
    rays = np.zeros((64, 3))
    rays[1::2] = np.random.default_rng(4).uniform(-2, 2, (32, 3))
    maps = []
    for submit in ("integrate_rays", "integrate_rays_async"):
        m = OccupancyMap(resolution=0.1, flags=MapFlag.NONE)
        ndt = TorchNdtMap(m, capacity=64, validate=True, device="cpu", rayflow=True)
        for _ in range(2):
            getattr(ndt, submit)(rays)
        ndt.sync_voxels()
        maps.append({k: c.layers[m.layer_index("occupancy")]["occupancy"].copy()
                     for k, c in m.chunks.items()})
    assert maps[0].keys() == maps[1].keys() and len(maps[0]) > 0
    assert all(np.array_equal(maps[0][k].view(np.uint32), maps[1][k].view(np.uint32))
               for k in maps[0])
    # K1's traversal output runs beside the voxel planes.
    wire, cfg, _ = ndt._rayflow_setup_host(rays, None, None, 0)
    b = unpack_batch(torch.from_numpy(wire), cfg)
    _, aux = expand_keys(b, cfg, with_trav=True, with_vox=True)
    assert aux["trav"].shape == aux["vox"].shape[:2] and float(aux["trav"].sum()) > 0


def test_build_takes_every_cuda_source_for_hopper():
    names = sorted(os.path.basename(p) for p in _build.sources())
    assert names == ["common.cu", "deposit.cu", "expand.cu", "gather.cu", "probes.cu",
                     "slotgrid.cu", "tsdf.cu"]
    sig = _build._SIGNATURES
    assert set(sig) >= {"ohm_gather_planes_f32", "ohm_tsdf_set_deposit", "ohm_tsdf_visits",
                        "ohm_slotgrid_deposit", "ohm_probe_onehot_mma", "ohm_probe_empty"}
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    # P-B takes no part bounds: keys, n_keys, n_vox, occupancy, the four
    # sweep values, fuse_sweep, stream.
    assert sig["ohm_slotgrid_deposit"] == [P, I, I, P] + [F] * 4 + [I, P]
    assert sig["ohm_probe_empty"] == [P]
    # K5+K6 fused: planes, ids, w (or null), wsdf, n, sentinel, trunc,
    # max_weight, near_zero, scratch, stream.
    assert sig["ohm_tsdf_visits"] == [P] * 5 + [I, I, F, F, F, P, P]
    # K4 and its fused flag gather: (planes..., ids, n, [threshold,] sentinel, out, stream).
    assert sig["ohm_gather_plane"] == [P, P, I, I, P, P]
    assert sig["ohm_gather_ndt_flags"] == [P, P, P, I, I, I, P, P]
    # K1 reads the unpacked batch: three f32 views with their row strides,
    # start_abs, end_abs, valid, exclude_start, tcand, gmeta, the resolution;
    # writes key, trav, vox, missed, overflow, end_enter; then B, S, K,
    # shift, v, sentinel, exclude_origin and the stream.
    assert sig["ohm_expand_keys"] == [P, I, P, I, P, I] + [P] * 6 + [F] + [P] * 6 + [I] * 7 + [P]
    flags = " ".join(_build.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags
    assert "-fmad=false" in flags and "fast_math" not in flags
    assert _build.LIB_PATH.startswith(os.path.join(REPO, "ohm_tpu_torch", "_build"))


def test_what_is_not_ported_under_tsdf_raises():
    """The TSDF mapper takes the segmented wire outside the rayflow
    envelope; it adds its layer to the map and keeps the others as they
    are."""
    m = OccupancyMap(resolution=0.1, region_voxel_dims=8, flags=MapFlag.VOXEL_MEAN)
    mapper = TorchTsdfMap(m, capacity=64, device="cpu", rayflow=True)
    assert m.layer_index("tsdf") >= 0 and m.layer_index("mean") >= 0
    assert sorted(mapper.arena.layers) == ["occupancy", "tsdf_distance", "tsdf_weight"]
    mapper.integrate_rays(np.array([[0.0, 0.0, 0.0], [40.0, 0.0, 0.0]]))
    assert mapper.stats["segments"] == 51
    rays = np.array([[0.0, 0.0, 0.0], [1.0, 0.5, 0.2]])
    assert mapper.integrate_rays_async(rays) == 1
    mapper.sync_voxels()
    assert mapper.stats["batches"] == 2
