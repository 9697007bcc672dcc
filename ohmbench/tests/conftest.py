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

from ohmbench import run, small  # noqa: E402


#: The overrides that cut each cell of BENCHMARK.json to a size the CPU runs
#: in seconds, from the cells' small files (a cell without one is left out
#: here, and fails ``test_benchmark_cells_name_their_configuration_files``).
SMALL = {w["name"]: small.load(w["name"])["overrides"] for w in run.load_bench()["workloads"]
         if small.path(w["name"])}


def cell_of(name: str) -> dict:
    """The cell ``name``: its BENCHMARK.json entry, or the one its small
    file gives."""
    return small.load(name)["overrides"].get("cell") or next(
        w for w in run.load_bench()["workloads"] if w["name"] == name)


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA card (skipped without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
