"""Each traffic mix is the same batches for one seed and other batches for
another, on the CPU at a small size."""

import numpy as np
import pytest

from ohmbench import generator, run
from conftest import SMALL, cell_of

CELLS = [cell_of(name) for name in SMALL]


def pool_of(cell, seed):
    _, config, mix, _ = run.load_cell(cell["name"], SMALL[cell["name"]])
    return generator.make_pool(mix, seed, "cpu"), mix, config


@pytest.mark.parametrize("cell", CELLS, ids=lambda w: w["name"])
def test_pool_is_deterministic_per_seed(cell):
    a, mix, config = pool_of(cell, 2**31 + 12345)
    b, _, _ = pool_of(cell, 2**31 + 12345)
    c, _, _ = pool_of(cell, 7)
    assert len(a) == mix["batching"]["pool_batches"]
    assert all(x.shape == (2 * config["batch_size"], 3) and x.dtype == np.float64 for x in a)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not all(np.array_equal(x, y) for x, y in zip(a, c))


@pytest.mark.parametrize("cell", CELLS, ids=lambda w: w["name"])
def test_rays_end_on_the_scene(cell):
    pool, mix, _ = pool_of(cell, 11)
    rays = np.concatenate(pool)
    length = np.linalg.norm(rays[1::2] - rays[0::2], axis=1)
    assert np.all(np.isfinite(rays))
    assert np.all(length <= mix["sensor"]["max_range_m"] + 1e-9)
    assert np.all(length > 0)

