"""The NDT-OM reference against ohm's sequential CPU semantics (the port's
f64 oracle, a transcription of ohm/CovarianceVoxelCompute.h): the miss
adjustment function for function, the batch merge of a voxel's samples
against one sample at a time, and a first batch voxel for voxel."""

import numpy as np
import pytest
import torch

from ohmbench.modes import ndt
from ohmbench.reference import compare
from ohmbench.reference.ndt import NdtParams, NdtReference, merge, miss_delta
from ohmbench.reference.occupancy import OccupancyParams
from test_ohmbench_reference import GRID

PARAMS = NdtParams()


def random_sqrt_cov(rng, n):
    """Packed lower-triangular square roots with a positive diagonal."""
    L = rng.normal(scale=0.01, size=(n, 6))
    for i in (0, 2, 5):
        L[:, i] = np.abs(L[:, i]) + 0.005
    return L


@pytest.mark.parametrize("seed", [1, 2])
def test_miss_delta_matches_the_oracle(seed):
    from ohm_tpu_torch.oracle.ndt import calculate_miss_ndt

    rng = np.random.default_rng(seed)
    n = 200
    L = random_sqrt_cov(rng, n)
    mean = rng.uniform(-0.05, 0.05, (n, 3))
    sensor = rng.uniform(-3, 3, (n, 3))
    sample = mean + rng.normal(scale=0.05, size=(n, 3))
    mine = miss_delta(*(torch.from_numpy(x) for x in (L, sensor, sample, mean)), PARAMS)
    for i in range(n):
        value, _ = calculate_miss_ndt(L[i], np.float32(0.0), sensor[i], sample[i], mean[i],
                                      PARAMS.sample_threshold, np.float32(-0.2),
                                      PARAMS.adaptation_rate, PARAMS.sensor_noise,
                                      PARAMS.sample_threshold)
        assert float(mine[i]) == pytest.approx(float(value), abs=1e-6)


@pytest.mark.parametrize("n0", [0, 1, 7])
def test_batch_merge_is_the_sequential_update(n0):
    """k samples merged at once give the covariance and mean that ohm's
    update gives one sample at a time (in float64, with the mean kept
    exact)."""
    from ohm_tpu_torch.oracle.ndt import calculate_hit_with_covariance, initialise_covariance

    rng = np.random.default_rng(n0 + 10)
    res = GRID.resolution
    earlier = rng.uniform(-0.04, 0.04, (n0, 3))
    later = rng.uniform(-0.04, 0.04, (5, 3))
    cov, mean, count = initialise_covariance(res), np.zeros(3), 0
    for j, z in enumerate(np.concatenate([earlier, later])):
        if j == n0:
            cov0, mean0 = cov.copy(), mean.copy()
        cov, _, _ = calculate_hit_with_covariance(cov, np.float32(0.5), z, mean, count, 0.85,
                                                  res, -1.4, 100)
        mean = mean + (z - mean) / (count + 1)
        count += 1
    t = lambda a: torch.from_numpy(np.asarray(a, dtype=np.float64))[None]  # noqa: E731
    zz = np.stack([later[:, 0] ** 2, later[:, 0] * later[:, 1], later[:, 1] ** 2,
                   later[:, 0] * later[:, 2], later[:, 1] * later[:, 2], later[:, 2] ** 2], 1)
    L, m, n = merge(t(cov0), t(mean0), torch.tensor([float(n0)], dtype=torch.float64),
                    torch.tensor([5.0], dtype=torch.float64), t(later.sum(0)), t(zz.sum(0)), res)
    assert float(n[0]) == count
    assert torch.allclose(m[0], torch.from_numpy(mean), atol=1e-12)
    assert torch.allclose(L[0], torch.from_numpy(cov), atol=1e-12)


def test_first_batch_matches_the_sequential_oracle():
    """From an empty map, rays from one origin that each end in a voxel of
    their own and cross no sample voxel: no miss meets a Gaussian, so the
    batch gives ohm's sequential NDT-OM map, count, mean and covariance."""
    from ohm_tpu_torch.core.map import MapFlag, OccupancyMap
    from ohm_tpu_torch.oracle.ndt import RayMapperNdt

    rng = np.random.default_rng(7)
    n = 150
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    r = np.empty((2 * n, 3))
    r[0::2] = (0.03, 0.02, 0.01)
    r[1::2] = r[0::2] + d * rng.uniform(2.0, 3.0, (n, 1))
    m = OccupancyMap(resolution=GRID.resolution, flags=MapFlag.VOXEL_MEAN)
    RayMapperNdt(m).integrate_rays(r)
    oi, mi, ci = (m.layer_index(x) for x in ("occupancy", "mean", "covariance"))
    chunks = {key: {"occupancy.occupancy": c.layers[oi]["occupancy"],
                    "mean.coord": c.layers[mi]["coord"], "mean.count": c.layers[mi]["count"],
                    **{"covariance." + k: c.layers[ci][k] for k in compare.COV_KEYS}}
              for key, c in m.chunks.items()}
    oracle = compare.read_map(chunks, GRID.region_dim, GRID.resolution, "cpu")
    ref = NdtReference(GRID, OccupancyParams(m.hit_value, m.miss_value), PARAMS)
    ref.walk_batches(lambda i: torch.from_numpy(r), [0])
    mine = ref.replay([0])
    assert mine["ndt_ids"].shape[0] == n
    result = ndt.compare(oracle, mine, GRID.resolution)
    assert result["voxel_mismatch_share"]["voxels"] > 1000
    assert result["voxel_mismatch_share"]["mismatched"] == 0
    assert result["ndt_mismatch_share"]["mismatched"] == 0
