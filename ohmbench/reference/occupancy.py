"""Occupancy of a map after a sequence of batches, from the rays alone.

The semantics are the batch form of ohm's occupancy update
(ohm/VoxelOccupancyCompute.h:44-120, as ohm's GPU path and the measured
program apply it): within one ``integrate_rays`` call every touched voxel
is updated once, from the number of rays that hit it and the number that
passed through it, against its value before the call.  An unobserved voxel
starts from 0; the net adjustment ``hits * hit + misses * miss`` is added
in float32, each product and the sum rounded on its own; the result is
clamped to the maximum value where the adjustment is positive and to the
minimum where it is negative; a voxel that is saturated keeps its value.

``OccupancyReference`` walks each distinct batch once (a pool that the
traffic cycles through is walked once a batch), then replays the sequence.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ohmbench.reference.walk import Grid, walk

UNOBSERVED = float("inf")


def probability_to_value(p: float) -> float:
    """log-odds of ``p`` rounded to float32, as ohm stores it
    (ohm/MapProbability.h)."""
    p32 = np.asarray(np.float32(p))
    return float(np.float32(np.log(p32 / (1.0 - p32))))


@dataclass(frozen=True)
class OccupancyParams:
    """The map's probability model (ohm/OccupancyMap.cpp:207-213)."""
    hit_value: float
    miss_value: float
    min_value: float = -2.0
    max_value: float = 3.511
    saturation_min: float = float(np.finfo(np.float32).min)
    saturation_max: float = float(np.finfo(np.float32).max)

    @classmethod
    def from_probabilities(cls, hit: float, miss: float, **kw) -> "OccupancyParams":
        return cls(probability_to_value(hit), probability_to_value(miss), **kw)


@dataclass
class BatchCounts:
    """One batch reduced to its touched voxels: sorted ``ids`` i64[V] with
    ``hits`` and ``misses`` i32[V]; ``rays`` and ``misses_total`` (the walk's
    steps) count the batch's work."""
    ids: torch.Tensor
    hits: torch.Tensor
    misses: torch.Tensor
    rays: int
    misses_total: int


def count_batch(rays: torch.Tensor, grid: Grid, dtype=torch.float64) -> BatchCounts:
    """Walk one batch of interleaved origin/sample rays f64[2N,3]."""
    v = walk(rays[0::2], rays[1::2], grid, dtype)
    all_ids = torch.cat([v.miss_ids, v.end_ids])
    is_hit = torch.zeros(all_ids.shape[0], dtype=torch.int32, device=all_ids.device)
    is_hit[v.miss_ids.shape[0]:] = 1
    ids, inverse = torch.unique(all_ids, return_inverse=True)
    total = torch.bincount(inverse, minlength=ids.shape[0]).to(torch.int32)
    hits = torch.zeros_like(total).index_add_(0, inverse, is_hit)
    return BatchCounts(ids, hits, total - hits, int(v.end_ids.shape[0]),
                       int(v.miss_ids.shape[0]))


def update(values: torch.Tensor, hits: torch.Tensor, misses: torch.Tensor,
           p: OccupancyParams) -> torch.Tensor:
    """New values of touched voxels from their batch-start ``values`` (inf
    where unobserved) and counts, in ``values``' dtype."""
    dt = values.dtype
    unobserved = torch.isinf(values) & (values > 0)
    total = hits.to(dt) * p.hit_value + misses.to(dt) * p.miss_value
    value = torch.where(unobserved, torch.zeros_like(values), values) + total
    value = torch.where(total > 0, torch.clamp(value, max=p.max_value), value)
    value = torch.where(total < 0, torch.clamp(value, min=p.min_value), value)
    saturated = ~unobserved & ((values <= p.saturation_min) | (values >= p.saturation_max))
    return torch.where(saturated, values, value)


class OccupancyReference:
    """The reference map of a sequence of batches.

    ``batch(i)`` returns the rays f64[2N,3] of distinct batch ``i`` on the
    reference's device.  ``geometry`` and ``values`` are the precisions of
    the walk and of the voxel values: float64 and float32 as ohm states
    them, lower for the control."""

    def __init__(self, grid: Grid, params: OccupancyParams, geometry=torch.float64,
                 values=torch.float32):
        self.grid = grid
        self.params = params
        self.geometry = geometry
        self.values_dtype = values
        self.counts: dict[int, BatchCounts] = {}

    def walk_batches(self, batch, indices) -> None:
        """Walk every distinct batch among ``indices`` not walked yet."""
        for i in sorted(set(int(i) for i in indices) - set(self.counts)):
            self.counts[i] = count_batch(batch(i), self.grid, self.geometry)

    def replay(self, sequence) -> dict:
        """Every voxel the sequence of batch indices observed, after applying
        it in order: sorted ``ids`` i64[V] and ``occupancy`` f32[V]."""
        keys = sorted(self.counts)
        universe = torch.unique(torch.cat([self.counts[i].ids for i in keys]))
        where = {i: torch.searchsorted(universe, self.counts[i].ids) for i in keys}
        vals = torch.full(universe.shape, UNOBSERVED, dtype=self.values_dtype,
                          device=universe.device)
        for i in sequence:
            c = self.counts[int(i)]
            at = where[int(i)]
            vals[at] = update(vals[at], c.hits, c.misses, self.params)
        observed = ~(torch.isinf(vals) & (vals > 0))
        return {"ids": universe[observed], "occupancy": vals[observed].to(torch.float32)}
