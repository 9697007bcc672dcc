"""Each roofline's work count on the CPU at a small size: the visits it
counts are the visits ohm's walk makes (the port's f64 oracle, walked ray
by ray), and the touched voxels are the distinct voxels of the batch."""

import pytest
import torch

from ohmbench import run
from ohmbench.reference.occupancy import count_batch
from test_ohmbench_reference import GRID, oracle_visits, rays


@pytest.fixture(scope="module")
def batches():
    rs = [rays(200, seed) for seed in (21, 22)]
    return rs, [count_batch(torch.from_numpy(r), GRID) for r in rs]


def test_k1_counts_every_step_and_each_ray_once(batches):
    rs, counts = batches
    k1 = run.load_metric("k1_roofline.stream")
    steps = sum(len(seen) for r in rs for seen, _ in oracle_visits(r))
    n_rays = sum(len(r) // 2 for r in rs)
    assert k1.work(counts) == (24 * n_rays + 4 * steps, 2 * steps)


def test_k2_counts_every_visit_and_each_touched_voxel(batches):
    rs, counts = batches
    k2 = run.load_metric("k2_roofline.stream")
    visits, touched = 0, 0
    for r in rs:
        walked = oracle_visits(r)
        voxels = set()
        for seen, end in walked:
            visits += len(seen) + 1
            voxels.update(seen)
            voxels.add(end)
        touched += len(voxels)
    assert k2.work(counts) == (4 * visits + 8 * touched, 4 * touched)


def test_roofline_share_is_the_bound_over_the_time():
    from ohmbench.peaks import PEAKS, roofline_share

    peaks = PEAKS["NVIDIA H100 80GB HBM3"]
    assert roofline_share(3.35e9, 0, 2e-3, peaks) == pytest.approx(50.0)
    assert roofline_share(0, 67e9, 1e-3, peaks) == pytest.approx(100.0)
    assert roofline_share(1, 1, 0.0, peaks) is None
    assert roofline_share(1, 1, 1.0, None) is None


def test_k3_counts_every_visit_each_touched_voxel_and_each_gaussian_voxel(batches):
    rs, counts = batches
    k3 = run.load_metric("k3_roofline.stream")
    visits, touched = 0, 0
    for r in rs:
        voxels = set()
        for seen, end in oracle_visits(r):
            visits += len(seen) + 1
            voxels.update(seen)
            voxels.add(end)
        touched += len(voxels)
    assert k3.work(counts, 17) == (4 * visits + 8 * touched + 8 * 17, 4 * touched)


def test_the_ndt_reference_counts_the_same_visits(batches):
    """The NDT cell's K1 and K3 read their counts from the NDT reference's
    walk: the same batches, the same visits."""
    from ohmbench.reference.ndt import NdtParams, NdtReference
    from ohmbench.reference.occupancy import OccupancyParams

    rs, counts = batches
    ref = NdtReference(GRID, OccupancyParams.from_probabilities(0.9, 0.45), NdtParams())
    ref.walk_batches(lambda i: torch.from_numpy(rs[i]), [0, 1])
    for i, c in enumerate(counts):
        mine = ref.counts[i]
        assert (mine.rays, mine.misses_total) == (c.rays, c.misses_total)
        assert torch.equal(mine.ids, c.ids)
