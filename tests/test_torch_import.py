"""The PyTorch port's boundaries: it imports and integrates without JAX,
its default device is CUDA and never quietly the CPU, and what it has not
ported yet raises."""

import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from ohm_tpu.core.map import MapFlag, OccupancyMap
from ohm_tpu.core.rayflags import RayFlag
from ohm_tpu_torch import TorchRayMapper, resolve_device
from ohm_tpu_torch.ops import _build

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_SCRIPT = """
import sys
import numpy as np
import ohm_tpu_torch
from ohm_tpu.core.map import OccupancyMap
rng = np.random.default_rng(0)
rays = np.zeros((128, 3))
rays[1::2] = rng.uniform(-3, 3, (64, 3))
m = OccupancyMap(resolution=0.1)
mapper = ohm_tpu_torch.TorchRayMapper(m, capacity=64, validate=True, device="cpu")
assert mapper.integrate_rays(rays) == 64
mapper.sync_voxels()
assert mapper.stats["batches"] == 1 and len(m.chunks) > 0
from ohm_tpu.oracle.ndt import NdtParams
for tm in (False, True):
    m = OccupancyMap(resolution=0.1)
    ndt = ohm_tpu_torch.TorchNdtMap(m, NdtParams(ndt_tm=tm), capacity=64, validate=True,
                                    device="cpu")
    for _ in range(2):
        ndt.integrate_rays(rays, intensities=rng.uniform(0, 1, 64))
    ndt.sync_voxels()
    assert ndt.stats["batches"] == 2 and len(m.chunks) > 0
print("jax" in sys.modules)
"""


def test_import_and_cpu_integrate_leave_jax_out():
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", _SCRIPT], capture_output=True,
                         text=True, cwd=REPO, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "False"


def test_no_source_of_the_port_imports_jax():
    pattern = re.compile(r"^\s*(import\s+jax|from\s+jax\b)", re.MULTILINE)
    paths = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(os.path.join(REPO, "ohm_tpu_torch")):
        paths += [os.path.join(root, f) for f in files if f.endswith(".py")]
    assert len(paths) > 10
    for path in paths:
        with open(path) as f:
            assert not pattern.search(f.read()), path


def test_default_device_is_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        TorchRayMapper(OccupancyMap(resolution=0.1), capacity=64)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("meta")


def test_what_is_not_ported_raises():
    with pytest.raises(NotImplementedError, match="occupancy"):
        TorchRayMapper(OccupancyMap(resolution=0.1, flags=MapFlag.VOXEL_MEAN),
                       capacity=64, device="cpu")
    with pytest.raises(ValueError, match="segmented"):
        TorchRayMapper(OccupancyMap(resolution=0.1), capacity=8192, device="cpu")
    mapper = TorchRayMapper(OccupancyMap(resolution=0.1), capacity=64, device="cpu")
    rays = np.array([[0.0, 0.0, 0.0], [1.0, 0.5, 0.2]])
    with pytest.raises(NotImplementedError, match="STOP_ON_FIRST_OCCUPIED"):
        mapper.integrate_rays(rays, ray_update_flags=RayFlag.STOP_ON_FIRST_OCCUPIED)
    with pytest.raises(NotImplementedError):
        mapper.integrate_rays_async(rays)
    # A ray over 32 regions (0.8 m regions, 40 m ray) leaves the rayflow
    # envelope; the segmented wire is not ported.
    fine = TorchRayMapper(OccupancyMap(resolution=0.1, region_voxel_dims=8),
                          capacity=64, device="cpu")
    with pytest.raises(NotImplementedError, match="segmented"):
        fine.integrate_rays(np.array([[0.0, 0.0, 0.0], [40.0, 0.0, 0.0]]))


def test_what_is_not_ported_under_ndt_raises():
    from ohm_tpu.oracle.ndt import NdtParams
    from ohm_tpu_torch import TorchNdtMap
    from ohm_tpu_torch.ops.expand_cuda import expand_keys

    for flag in (MapFlag.TRAVERSAL, MapFlag.TOUCH_TIME, MapFlag.INCIDENT_NORMAL):
        with pytest.raises(NotImplementedError, match="NDT"):
            TorchNdtMap(OccupancyMap(resolution=0.1, flags=flag), capacity=64, device="cpu")
    # NDT-OM refuses the NDT-TM layers it does not update.
    m = OccupancyMap(resolution=0.1, flags=MapFlag.NONE)
    m.layout.add_intensity()
    with pytest.raises(NotImplementedError, match="intensity"):
        TorchNdtMap(m, NdtParams(), capacity=64, device="cpu")
    mapper = TorchNdtMap(OccupancyMap(resolution=0.1, flags=MapFlag.NONE), capacity=64,
                         device="cpu")
    assert mapper.arena.occupancy_encoding == "inf"
    assert torch.isposinf(mapper.arena.occupancy).all()
    with pytest.raises(NotImplementedError):
        mapper.integrate_rays_async(np.zeros((2, 3)))
    with pytest.raises(NotImplementedError, match="with_trav"):
        expand_keys({}, mapper._config(0), with_trav=True)


def test_build_takes_every_cuda_source_for_hopper():
    names = sorted(os.path.basename(p) for p in _build.sources())
    assert names == ["common.cu", "deposit.cu", "expand.cu", "gather.cu"]
    flags = " ".join(_build.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags
    assert "-fmad=false" in flags and "fast_math" not in flags
    assert _build.LIB_PATH.startswith(os.path.join(REPO, "ohm_tpu_torch", "_build"))
