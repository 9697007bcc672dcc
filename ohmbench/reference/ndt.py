"""An NDT-OM map (occupancy, voxel mean, covariance) after a sequence of
batches, from the rays alone.

The semantics are ohm's NDT-OM update (ohm/RayMapperNdt.cpp,
ohm/CovarianceVoxelCompute.h, ohm/VoxelMeanCompute.h) in its batch form:
within one ``integrate_rays`` call every voxel is judged against its state
before the call.

Misses
    A voxel a ray passes through before its sample voxel takes a miss.  Where
    the voxel is observed and holds at least ``sample_threshold`` samples
    (it bears a Gaussian), the miss adds the NDT-OM adjustment
    (CovarianceVoxelCompute.h:508-637: the maximum-likelihood point of the
    ray against the voxel's Gaussian, ``log(pu / (1 - pu))`` with
    ``pu = 0.5 - 0.5 * adaptation_rate * p(x|voxel) * (1 - p(x|sample))``);
    otherwise the map's miss value.
Hits
    The sample voxel takes the hit value, and its samples merge into the
    voxel's mean and covariance.  ohm's update is the running (population)
    covariance started from a seed, ``(seed + scatter) / n`` with
    ``seed = (0.1 * resolution)^2 I``; a voxel with no samples, or one held
    free (below ``reinitialise_covariance_threshold``) with at least
    ``reinitialise_covariance_point_count`` samples, starts again from the
    seed.  The batch's samples merge at once (Chan's parallel combination of
    two scatters), in float64.
Occupancy
    As ``occupancy.update``: ``hits * hit + misses * miss + ndt_delta`` added
    in float32, the one-sided clamp, saturated voxels kept.
Storage
    Values, covariance (the packed lower-triangular square root
    ``[L00; L10 L11; L20 L21 L22]``) are stored in ``values`` (float32 as ohm
    states it); the mean is stored in ohm's sub-voxel code, 10 bits an axis
    across the voxel, and read back from it.

Every distinct batch is walked once (``walk.walk``); ``replay`` then
applies a sequence of batch indices in order on the device.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ohmbench.reference.occupancy import (UNOBSERVED, BatchCounts, OccupancyParams,
                                          probability_to_value)
from ohmbench.reference.walk import Grid, unpack_ids, voxel_centres, walk

#: Positions of the sub-voxel mean code on each axis (10 bits).
MEAN_POSITIONS = 1023


@dataclass(frozen=True)
class NdtParams:
    """NDT-OM's parameters (ohm/private/NdtMapDetail.h:21-45; ohmpop's
    defaults)."""
    sensor_noise: float = 0.05
    sample_threshold: int = 3
    adaptation_rate: float = 0.2
    reinitialise_covariance_threshold: float = probability_to_value(0.2)
    reinitialise_covariance_point_count: int = 100

    @classmethod
    def from_config(cls, ndt: dict, miss_probability: float) -> "NdtParams":
        """From a configuration's ``ndt`` group; an adaptation rate of 0
        derives from the miss probability (ohm/NdtMap.h:146-149)."""
        rate = ndt["adaptation_rate"] or max(0.0, min(2.0 * (1.0 - 2.0 * miss_probability), 1.0))
        return cls(ndt["sensor_noise"], int(ndt["sample_threshold"]), float(rate),
                   probability_to_value(ndt["reinitialise_covariance_threshold_probability"]),
                   int(ndt["reinitialise_covariance_point_count"]))


@dataclass
class BatchVisits:
    """One distinct batch: its counts, and its visits as indices into the
    reference's voxel universe (filled by ``replay``)."""
    counts: BatchCounts
    miss_ids: torch.Tensor
    ray_of_miss: torch.Tensor
    end_ids: torch.Tensor
    origins: torch.Tensor
    samples: torch.Tensor
    miss_at: torch.Tensor | None = None
    end_at: torch.Tensor | None = None


def _solve(L: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Forward substitution with packed lower-triangular ``L`` [..., 6]."""
    x0 = y[..., 0] / L[..., 0]
    x1 = (y[..., 1] - L[..., 1] * x0) / L[..., 2]
    x2 = (y[..., 2] - L[..., 3] * x0 - L[..., 4] * x1) / L[..., 5]
    return torch.stack([x0, x1, x2], dim=-1)


def miss_delta(L, sensor, sample, mean, p: NdtParams) -> torch.Tensor:
    """NDT-OM's log-odds adjustment of a miss on a Gaussian voxel
    (CovarianceVoxelCompute.h:226-272, 598-637); NaN becomes 0, as there."""
    ray = sample - sensor
    ray = ray / ray.norm(dim=-1, keepdim=True)
    a = _solve(L, ray)
    b = _solve(L, sensor - mean)
    t = -(a * b).sum(-1) / (a * a).sum(-1)
    x_ml = ray * t[:, None] + sensor
    s = _solve(L, x_ml - mean)
    p_voxel = torch.exp(-0.5 * (s * s).sum(-1))
    d = x_ml - sample
    p_sample = torch.exp(-0.5 * (d * d).sum(-1) / (p.sensor_noise * p.sensor_noise))
    pu = 0.5 - 0.5 * p.adaptation_rate * p_voxel * (1.0 - p_sample)
    delta = torch.log(pu / (1.0 - pu))
    return torch.where(torch.isnan(delta), torch.zeros_like(delta), delta)


def _outer6(v: torch.Tensor) -> torch.Tensor:
    x, y, z = v.unbind(-1)
    return torch.stack([x * x, x * y, y * y, x * z, y * z, z * z], dim=-1)


def square(L: torch.Tensor) -> torch.Tensor:
    """L L^T, packed as [P00, P01, P11, P02, P12, P22]."""
    l00, l10, l11, l20, l21, l22 = L.unbind(-1)
    return torch.stack([l00 * l00, l10 * l00, l10 * l10 + l11 * l11, l20 * l00,
                        l20 * l10 + l21 * l11, l20 * l20 + l21 * l21 + l22 * l22], dim=-1)


def _cholesky(P: torch.Tensor) -> torch.Tensor:
    """The packed lower-triangular square root of packed symmetric ``P``."""
    l00 = torch.sqrt(P[..., 0])
    l10 = P[..., 1] / l00
    l11 = torch.sqrt(P[..., 2] - l10 * l10)
    l20 = P[..., 3] / l00
    l21 = (P[..., 4] - l20 * l10) / l11
    l22 = torch.sqrt(P[..., 5] - l20 * l20 - l21 * l21)
    return torch.stack([l00, l10, l11, l20, l21, l22], dim=-1)


def merge(L, mu0, n0, k, z_sum, zz_sum, resolution: float) -> tuple:
    """Voxels' Gaussians after ``k`` samples (summed ``z_sum``, and their
    outer products ``zz_sum``, packed) join ``n0`` earlier ones of mean
    ``mu0`` and covariance square root ``L`` (ignored where ``n0`` is 0):
    ohm's running covariance from its seed, ``(seed + scatter) / n``, with
    the two scatters combined at once (Chan et al.).  Returns (L, mean,
    count)."""
    seed = (0.1 * resolution) ** 2
    mu_b = z_sum / k[:, None]
    scatter = zz_sum - k[:, None] * _outer6(mu_b)
    seed6 = torch.tensor([seed, 0, seed, 0, 0, seed], dtype=L.dtype, device=L.device)
    base = torch.where((n0 > 0)[:, None], n0[:, None] * square(L), seed6)
    Q = base + scatter + (n0 * k / (n0 + k))[:, None] * _outer6(mu_b - mu0)
    n = n0 + k
    return _cholesky(Q / n[:, None]), (mu0 * n0[:, None] + z_sum) / n[:, None], n


def mean_code(local: torch.Tensor, resolution: float) -> torch.Tensor:
    """ohm's sub-voxel mean code of voxel-centre-relative points, as the
    position index on each axis (VoxelMeanCompute.h:69-92)."""
    q = resolution / MEAN_POSITIONS
    return torch.clamp(torch.floor((local + 0.5 * resolution) / q + 0.5), 0, MEAN_POSITIONS)


def mean_of_code(code: torch.Tensor, resolution: float) -> torch.Tensor:
    """The voxel-centre-relative point a mean code stands for
    (VoxelMeanCompute.h:102-122)."""
    return code * (resolution / MEAN_POSITIONS) - 0.5 * resolution


class NdtReference:
    """The reference NDT-OM map of a sequence of batches.

    ``geometry`` and ``values`` are the precisions of the walk and the NDT
    math, and of what the map stores: float64 and float32 as ohm states
    them, lower for the control."""

    def __init__(self, grid: Grid, occupancy: OccupancyParams, ndt: NdtParams,
                 geometry=torch.float64, values=torch.float32):
        self.grid = grid
        self.occ = occupancy
        self.ndt = ndt
        self.geometry = geometry
        self.values_dtype = values
        self.batches: dict[int, BatchVisits] = {}
        #: Voxels that took NDT misses, each replayed batch in order.
        self.gauss_voxels: list[int] = []

    @property
    def counts(self) -> dict[int, BatchCounts]:
        return {i: b.counts for i, b in self.batches.items()}

    def walk_batches(self, batch, indices) -> None:
        """Walk every distinct batch among ``indices`` not walked yet."""
        for i in sorted(set(int(i) for i in indices) - set(self.batches)):
            rays = batch(i)
            v = walk(rays[0::2], rays[1::2], self.grid, self.geometry)
            ids = torch.unique(torch.cat([v.miss_ids, v.end_ids]))
            counts = BatchCounts(ids, None, None, int(v.end_ids.shape[0]),
                                 int(v.miss_ids.shape[0]))
            self.batches[i] = BatchVisits(counts, v.miss_ids, v.ray_of_miss, v.end_ids,
                                          rays[0::2].to(self.geometry),
                                          rays[1::2].to(self.geometry))

    def replay(self, sequence) -> dict:
        """Every voxel the sequence observed, after applying it in order:
        sorted ``ids`` i64[V], ``occupancy`` f32[V], and for the voxels with
        samples ``ndt_ids``, ``count`` i64, ``mean`` f32[., 3] (voxel-centre
        relative) and ``cov`` f32[., 6] (the packed square root)."""
        g = self.geometry
        res = self.grid.resolution
        universe = torch.unique(torch.cat([b.counts.ids for b in self.batches.values()]))
        abs_keys = unpack_ids(universe)
        region = torch.div(abs_keys, self.grid.region_dim, rounding_mode="floor")
        centres = voxel_centres(region, abs_keys - region * self.grid.region_dim, self.grid, g)
        for b in self.batches.values():
            b.miss_at = torch.searchsorted(universe, b.miss_ids)
            b.end_at = torch.searchsorted(universe, b.end_ids)
        V = universe.shape[0]
        dev = universe.device
        vd = self.values_dtype
        occ = torch.full((V,), UNOBSERVED, dtype=vd, device=dev)
        count = torch.zeros(V, dtype=torch.int64, device=dev)
        code = torch.zeros((V, 3), dtype=g, device=dev)
        L = torch.zeros((V, 6), dtype=vd, device=dev)
        p, q = self.occ, self.ndt
        gauss_voxels = []
        for i in sequence:
            b = self.batches[int(i)]
            # Misses, judged against the batch-start state.
            observed = ~(torch.isinf(occ) & (occ > 0))
            gauss = (observed & (count >= q.sample_threshold))[b.miss_at]
            at = b.miss_at[gauss]
            ray = b.ray_of_miss[gauss]
            centre = centres[at]
            delta = miss_delta(L[at].to(g), b.origins[ray] - centre, b.samples[ray] - centre,
                               mean_of_code(code[at], res), q)
            delta_sum = torch.zeros(V, dtype=g, device=dev).index_add_(0, at, delta)
            gauss_voxels.append((torch.bincount(at, minlength=V) > 0).sum())
            misses = torch.bincount(b.miss_at[~gauss], minlength=V)
            hits = torch.bincount(b.end_at, minlength=V)

            # Hits: the batch's samples merged into each sample voxel.
            ends, k = torch.unique(b.end_at, return_counts=True)
            inv = torch.searchsorted(ends, b.end_at)
            z = b.samples - centres[b.end_at]
            z_sum = torch.zeros((ends.shape[0], 3), dtype=g, device=dev).index_add_(0, inv, z)
            zz_sum = torch.zeros((ends.shape[0], 6), dtype=g, device=dev).index_add_(
                0, inv, _outer6(z))
            n_old = count[ends]
            reset = (n_old == 0) | ((occ[ends].to(g) < q.reinitialise_covariance_threshold)
                                    & (n_old >= q.reinitialise_covariance_point_count))
            n0 = torch.where(reset, torch.zeros_like(n_old), n_old).to(g)
            mu0 = torch.where(reset[:, None], torch.zeros_like(z_sum),
                              mean_of_code(code[ends], res))
            L_new, mean_new, n_new = merge(L[ends].to(g), mu0, n0, k.to(g), z_sum, zz_sum, res)

            # Occupancy, then the hit voxels' Gaussians.
            occ = occupancy_update(occ, hits, misses, delta_sum.to(vd), p)
            L[ends] = L_new.to(vd)
            code[ends] = mean_code(mean_new.to(vd).to(g), res)
            count[ends] = n_new.to(torch.int64)
        self.gauss_voxels = torch.stack(gauss_voxels).tolist() if gauss_voxels else []
        observed = ~(torch.isinf(occ) & (occ > 0))
        sampled = count > 0
        return {"ids": universe[observed], "occupancy": occ[observed].to(torch.float32),
                "ndt_ids": universe[sampled], "count": count[sampled],
                "mean": mean_of_code(code[sampled], res).to(torch.float32),
                "cov": L[sampled].to(torch.float32)}


def occupancy_update(values, hits, misses, delta, p: OccupancyParams) -> torch.Tensor:
    """Every voxel's value after a batch, from its batch-start value (+inf
    where unobserved), its hit and standard-miss counts and its summed NDT
    adjustment, in ``values``' dtype (ohm/VoxelOccupancyCompute.h:44-153 in
    batch form)."""
    dt = values.dtype
    unobserved = torch.isinf(values) & (values > 0)
    total = hits.to(dt) * p.hit_value
    total = total + misses.to(dt) * p.miss_value
    total = total + delta
    value = torch.where(unobserved, torch.zeros_like(values), values) + total
    value = torch.where(total > 0, torch.clamp(value, max=p.max_value), value)
    value = torch.where(total < 0, torch.clamp(value, min=p.min_value), value)
    touched = (hits + misses > 0) | (delta != 0)
    saturated = ~unobserved & ((values <= p.saturation_min) | (values >= p.saturation_max))
    return torch.where(~touched | saturated, values, value)

