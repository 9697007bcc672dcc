"""ohmbench's own tests: ``python -m pytest ohmbench/tests -q``.

The tests marked ``cuda`` need the card (they skip on a machine without
one, deciding inside the ``card`` fixture); the rest run on the CPU at
sizes it holds, through the kernels' plain versions."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

#: Overrides that cut each cell of BENCHMARK.json to a size the CPU runs in
#: seconds (a cell not in BENCHMARK.json would name itself under "cell").
SMALL = {
    "occ-box-stream": {"config": {"batch_size": 256, "arena_capacity": 512},
                       "traffic": {"batching": {"pool_batches": 6}}},
    # A smaller room, so that its walls' voxels gather the samples that make
    # Gaussians (three or more) within a few batches.
    "ndt-box-stream": {"config": {"batch_size": 512, "arena_capacity": 256},
                       "traffic": {"batching": {"pool_batches": 6},
                                   "scene": {"half_extents": [0.6, 0.6, 0.35]},
                                   "path": {"radius_m": 0.2}}},
    # The first two revolutions of the drive, in 0.4 m voxels and 8^3
    # regions: the cell's 3.2 m regions, so its arena keeps its 8192 slots
    # (the segmented wire) with no eviction, in 16 MiB.
    "occ-survey-stream": {"config": {"batch_size": 256, "resolution": 0.4, "region_dim": 8},
                          "traffic": {"path": {"to_m": [-119.7, 0.0]},
                                      "warmup": {"batches": 4}}},
}


def cell_of(name: str) -> dict:
    """The cell ``name``: its BENCHMARK.json entry, or the one SMALL gives."""
    from ohmbench import run

    return SMALL[name].get("cell") or next(
        w for w in run.load_bench()["workloads"] if w["name"] == name)


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA card (skipped without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
