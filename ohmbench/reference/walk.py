"""Voxel keys and the line walk, vectorised over a batch of rays.

Frozen copies, in PyTorch, of ohm's quantisation (ohm/MapCoord.h:45-93,
ohm/MapRegion.cpp:32-69: region first, then the voxel within the region's
minimum corner, with its 1e-6 pull-back) and of its CPU line walk
(ohm/LineWalkCompute.h:188-413: walkInitRay, walkCalculateSteps,
walkSelectNextAxis, walkStepNext, walkLineVoxels).  Every product and sum
is its own operation in the reference's order, so in float64 the keys and
crossing times round as ohm's CPU code rounds them.

The walk of one ray steps each axis exactly |end - start| times (its keys'
difference); the order of the steps merges the three axes' crossing times
``initial + step_delta * k``, the smallest first and, on a tie, the higher
axis first (walkSelectNextAxis compares with a strict '<').  A ray visits
as misses the voxel it starts in and every voxel it enters before its last
step; its sample voxel takes the hit.  So one stable sort by time, then
one by ray, over all the batch's steps gives every visit at once.

``dtype`` is float64 for the reference and float32 for its control: the
same walk a precision lower.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

#: Points within this distance outside a region are pulled back inside it
#: (ohm/MapCoord.h:45-80).
REGION_COORD_EPSILON = 1e-6
#: A ray shorter than sqrt of this has length 0 (ohm/LineWalk.h).
LENGTH_EPSILON = 1e-6
#: Offset that makes every absolute voxel coordinate non-negative in an id.
_ID_BIAS = 1 << 20
_ID_BITS = 21


@dataclass(frozen=True)
class Grid:
    """A map's quantisation: voxel edge (m) and voxels per region edge."""
    resolution: float
    region_dim: int

    @property
    def region_size(self) -> float:
        return float(self.region_dim) * self.resolution


def voxel_keys(points: torch.Tensor, grid: Grid):
    """(region i64[N,3], local i64[N,3]) of points f[N,3] (ohm's two-step
    quantisation, in the points' dtype)."""
    size = torch.tensor(grid.region_size, dtype=points.dtype)
    res = torch.tensor(grid.resolution, dtype=points.dtype)
    eps = torch.tensor(REGION_COORD_EPSILON, dtype=points.dtype)
    half = torch.tensor(0.5, dtype=points.dtype)
    region = torch.floor(points / size + half)
    region_min = region * size - half * size
    q = points - region_min
    q = torch.where((q < 0) & (q >= -eps), torch.zeros_like(q), q)
    q = torch.where((q >= size) & (q - eps < size), q - eps, q)
    local = torch.clamp(torch.floor(q / res), 0, grid.region_dim - 1)
    return region.to(torch.int64), local.to(torch.int64)


def voxel_centres(region: torch.Tensor, local: torch.Tensor, grid: Grid, dtype):
    """Centres of voxels in ohm's operation order (ohm/OccupancyMap.h:757-778)."""
    size = torch.tensor(grid.region_size, dtype=dtype)
    res = torch.tensor(grid.resolution, dtype=dtype)
    half = torch.tensor(0.5, dtype=dtype)
    centre = region.to(dtype) * size
    centre = centre - half * size
    centre = centre + local.to(dtype) * res
    return centre + half * res


def pack_ids(abs_keys: torch.Tensor) -> torch.Tensor:
    """One int64 id a voxel from its absolute coordinates i64[N,3]."""
    a = abs_keys + _ID_BIAS
    return (a[:, 0] << (2 * _ID_BITS)) | (a[:, 1] << _ID_BITS) | a[:, 2]


def unpack_ids(ids: torch.Tensor) -> torch.Tensor:
    """Absolute voxel coordinates i64[N,3] of packed ids."""
    mask = (1 << _ID_BITS) - 1
    return torch.stack([(ids >> (2 * _ID_BITS)) & mask, (ids >> _ID_BITS) & mask,
                        ids & mask], dim=1) - _ID_BIAS


@dataclass
class Visits:
    """One batch's visits: ``miss_ids`` i64[E] (E = every step of every
    ray, ray by ray in walk order), ``ray_of_miss`` i64[E] and ``end_ids``
    i64[B] (each ray's sample voxel)."""
    miss_ids: torch.Tensor
    ray_of_miss: torch.Tensor
    end_ids: torch.Tensor


def walk(origins: torch.Tensor, samples: torch.Tensor, grid: Grid,
         dtype=torch.float64) -> Visits:
    """Walk rays f64[B,3] -> f64[B,3] through ``grid`` in ``dtype``."""
    start = origins.to(dtype)
    end = samples.to(dtype)
    B = start.shape[0]
    dev = start.device
    s_region, s_local = voxel_keys(start, grid)
    e_region, e_local = voxel_keys(end, grid)
    dim = grid.region_dim
    start_abs = s_region * dim + s_local
    end_abs = e_region * dim + e_local
    centre = voxel_centres(s_region, s_local, grid, dtype)

    # walkInitRay / walkCalculateSteps.
    d = end - start
    length_sqr = d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1] + d[:, 2] * d[:, 2]
    has_length = length_sqr > LENGTH_EPSILON
    length = torch.where(has_length, torch.sqrt(length_sqr), torch.zeros_like(length_sqr))
    sign = d < 0
    unit = d / torch.where(has_length, length, torch.ones_like(length))[:, None]
    inf = torch.full_like(unit, float("inf"))
    inv = torch.where(unit != 0, 1.0 / torch.where(unit != 0, unit, torch.ones_like(unit)),
                      torch.copysign(inf, unit))
    inv = torch.where(has_length[:, None], inv, torch.zeros_like(inv))
    res = torch.tensor(grid.resolution, dtype=dtype)
    half = torch.tensor(0.5, dtype=dtype) * res
    vmin = centre - half
    vmax = centre + half
    initial = (torch.where(sign, vmin, vmax) - start) * inv
    shift = torch.where(sign, -1.0, 1.0).to(dtype) * res
    nxt = (torch.where(sign, vmin + shift, vmax + shift) - start) * inv
    step_delta = torch.where(torch.isinf(nxt), nxt, nxt - initial)

    # Every step of every ray: segments (ray, axis) with the higher axis
    # first, so that the stable sorts below break time ties towards it.
    n = (end_abs - start_abs).abs()
    n_rev = n.flip(1).reshape(-1)
    seg = torch.repeat_interleave(torch.arange(3 * B, device=dev), n_rev)
    E = seg.shape[0]
    offsets = torch.cumsum(n_rev, 0) - n_rev
    k = torch.arange(E, device=dev) - offsets[seg]
    ray = seg // 3
    axis = 2 - seg % 3
    t0 = initial[ray, axis]
    t = torch.where(k == 0, t0, t0 + step_delta[ray, axis] * k.to(dtype))
    order = torch.sort(t, stable=True).indices
    order = order[torch.sort(ray[order], stable=True).indices]
    ray = ray[order]
    axis = axis[order]

    # The voxel before each step: the ray's start plus its earlier steps,
    # an exclusive scan of each axis's unit steps (axis-major, so that each
    # scan runs along a contiguous row).
    direction = torch.where(sign, -1, 1).to(torch.int64)
    step = (axis[None, :] == torch.arange(3, device=dev)[:, None]).to(torch.int64)
    step = step * direction[ray, axis][None, :]
    before = torch.cumsum(step, 1) - step
    per_ray = n.sum(1)
    first = torch.cumsum(per_ray, 0) - per_ray
    base = before[:, first.clamp(max=max(E - 1, 0))] if E else before[:, :0]
    miss_abs = start_abs[ray] + (before - base[:, ray]).T
    return Visits(pack_ids(miss_abs), ray, pack_ids(end_abs))

