"""Each traffic mix is the same batches for one seed and other batches for
another, on the CPU at a small size; the box stream's pool bit for bit as
the generator made it before its parts were split into files."""

import hashlib

import numpy as np
import pytest

from ohmbench import generator, run
from conftest import SMALL, cell_of

CELLS = [cell_of(name) for name in SMALL]

#: SHA-256 of the box stream's whole pool (256 batches of 4096 rays, the
#: batches' bytes in order) made on the CPU, taken with the generator of
#: one file (room, sphere and orbit inline) that the parts replaced.
BOX_POOL_SHA256 = {
    7: "e0bd36b701f196059831d4cf89eafd67e1e525f434bba271dd03f0da2eaed220",
    2**31 + 12345: "03c591e39ad5ee12ce44bbe6d7d7e17b8e00e0c46b1e0f786734694c9f643d21",
    2**33 + 977: "d11b6dec0157bd131d024ccbe5745f84063e6fd4e14f0e98dea9fa132af26449",
}


def pool_of(cell, seed):
    _, config, mix, _ = run.load_cell(cell["name"], SMALL[cell["name"]])
    return generator.make_pool(mix, seed, "cpu"), mix, config


@pytest.mark.parametrize("cell", CELLS, ids=lambda w: w["name"])
def test_pool_is_deterministic_per_seed(cell):
    a, mix, config = pool_of(cell, 2**31 + 12345)
    b, _, _ = pool_of(cell, 2**31 + 12345)
    c, _, _ = pool_of(cell, 7)
    if mix["batching"]["pool_batches"] == "path":
        assert len(a) > 0
    else:
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



@pytest.mark.parametrize("seed", sorted(BOX_POOL_SHA256))
def test_box_pool_is_bit_for_bit_the_one_file_generators(seed):
    _, _, mix, _ = run.load_cell("occ-box-stream")
    h = hashlib.sha256()
    for batch in generator.make_pool(mix, seed, "cpu"):
        h.update(batch.tobytes())
    assert h.hexdigest() == BOX_POOL_SHA256[seed]
