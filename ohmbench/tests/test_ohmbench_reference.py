"""The reference against ohm's f64 CPU semantics (the port's oracle, a
frozen transcription of ohm's CPU code): the walk visit for visit, and the
occupancy of a batch voxel for voxel."""

import numpy as np
import pytest
import torch

from ohmbench.reference import compare
from ohmbench.reference.occupancy import OccupancyParams, OccupancyReference, update
from ohmbench.reference.walk import Grid, unpack_ids, walk

GRID = Grid(0.1, 32)


def rays(n, seed, on_boundaries=True):
    """Random segments, some with an end or a start on a voxel boundary."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-5, 5, (n, 3))
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    s = o + d * rng.uniform(0.0, 12.0, (n, 1))
    if on_boundaries:
        s[: n // 8, 0] = np.round(s[: n // 8, 0], 1)
        o[n // 8: n // 4] = np.round(o[n // 8: n // 4], 1)
        s[n // 4: n // 4 + 4] = o[n // 4: n // 4 + 4]  # zero length
    r = np.empty((2 * n, 3))
    r[0::2], r[1::2] = o, s
    return r


def oracle_visits(r):
    from ohm_tpu_torch.core.keys import key_to_abs
    from ohm_tpu_torch.core.map import MapFlag, OccupancyMap
    from ohm_tpu_torch.oracle import linewalk

    m = OccupancyMap(resolution=GRID.resolution, region_voxel_dims=GRID.region_dim,
                     flags=MapFlag.NONE)
    out = []
    for o, s in zip(r[0::2], r[1::2]):
        seen = []
        linewalk.walk_segment_keys(m, o, s, lambda k, *_: seen.append(tuple(int(v) for v in k))
                                   or True, linewalk.EXCLUDE_END_VOXEL)
        region, local = m.voxel_key(s)
        out.append((seen, tuple(int(v) for v in key_to_abs(region, local, m.region_voxel_dims))))
    return out


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_walk_matches_the_oracle_visit_for_visit(seed):
    r = rays(300, seed)
    t = torch.from_numpy(r)
    v = walk(t[0::2], t[1::2], GRID)
    miss = unpack_ids(v.miss_ids).numpy()
    ray = v.ray_of_miss.numpy()
    end = unpack_ids(v.end_ids).numpy()
    for i, (seen, end_key) in enumerate(oracle_visits(r)):
        assert [tuple(x) for x in miss[ray == i]] == seen
        assert tuple(end[i]) == end_key


def test_float32_walk_is_another_walk():
    r = rays(300, 4)
    t = torch.from_numpy(r)
    a = walk(t[0::2], t[1::2], GRID)
    b = walk(t[0::2], t[1::2], GRID, torch.float32)
    assert not (torch.equal(a.miss_ids, b.miss_ids) and torch.equal(a.end_ids, b.end_ids))


def test_one_batch_matches_the_sequential_oracle():
    """From an empty map, one batch whose voxels meet no clamp in mid-batch
    gives ohm's sequential result: rays from one origin that hit no voxel
    twice, so no voxel takes a hit and a miss together."""
    from ohm_tpu_torch.core.map import MapFlag, OccupancyMap
    from ohm_tpu_torch.oracle.occupancy import RayMapperOccupancy

    rng = np.random.default_rng(5)
    n = 200
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    r = np.empty((2 * n, 3))
    r[0::2] = (0.03, 0.02, 0.01)
    r[1::2] = r[0::2] + d * 3.0
    m = OccupancyMap(resolution=GRID.resolution, flags=MapFlag.NONE)
    RayMapperOccupancy(m).integrate_rays(r)
    oi = m.layer_index("occupancy")
    oracle = compare.read_map({k: {"occupancy.occupancy": c.layers[oi]["occupancy"]}
                               for k, c in m.chunks.items()}, GRID.region_dim, GRID.resolution,
                              "cpu")
    ref = OccupancyReference(GRID, OccupancyParams(m.hit_value, m.miss_value))
    ref.walk_batches(lambda i: torch.from_numpy(r), [0])
    mine = ref.replay([0])
    result = compare.mismatch(mine["ids"], mine["occupancy"], oracle["ids"], oracle["occupancy"])
    assert result["voxels"] > 1000
    assert result["mismatched"] == 0


def test_update_clamps_and_starts_unobserved_voxels_at_zero():
    p = OccupancyParams.from_probabilities(0.9, 0.45)
    v = torch.tensor([float("inf"), float("inf"), 3.4, -1.9, -1.5])
    hits = torch.tensor([1, 0, 1, 0, 2], dtype=torch.int32)
    misses = torch.tensor([0, 3, 0, 2, 1], dtype=torch.int32)
    out = update(v, hits, misses, p)
    hit, miss = np.float32(p.hit_value), np.float32(p.miss_value)
    assert out[0] == hit
    assert out[1] == np.float32(3 * miss)
    assert out[2] == np.float32(3.511) and out[3] == np.float32(-2.0)
    assert out[4] == np.float32(np.float32(-1.5) + np.float32(np.float32(2 * hit) + miss))
