"""ClearanceProcess: per-voxel range to the nearest occupied voxel, on
PyTorch (CUDA or CPU).

Counterpart of ``ohm_tpu/query/clearance.py`` (reference:
ohmgpu/ClearanceProcess, ohmgpu/gpu/RoiRangeFill.cl).  Clearance is an exact
Euclidean distance transform, and a bounded-radius squared EDT is
separable: ``D(p) = min over occupied q of |p - q|^2`` decomposes into three
axis passes of ``min_s (D(x + s) + s^2)``, which run as rolls over a dense
box of regions with a halo of the search radius, so obstacles across a
region border are seen.  The dirty regions group into boxes by bounding
box, split at the widest axis while a box exceeds ``max_box_voxels``; each
box ships one bit a voxel up and reads the interior back as u8/u16 squared
distances in voxel units, which a host table turns into metres.  The
values are integers, so every device gives the same bits.  None of this is
a Pallas kernel in the reference: PyTorch ops are the port.
"""

from __future__ import annotations

import itertools
import math

import numpy as np
import torch

from ohm_tpu_torch.core.layout import CLEARANCE_LAYER, OCCUPANCY_LAYER
from ohm_tpu_torch.device import resolve_device

#: Query flag: treat unobserved voxels as obstacles
#: (reference: ohm/QueryFlag.h kQfUnknownAsOccupied).
UNKNOWN_AS_OCCUPIED = 1 << 0

_BIG_I = 1 << 28
_TORCH_DTYPE = {np.uint8: torch.uint8, np.uint16: torch.uint16, np.int32: torch.int32}


def _edt_pass_int(d2: torch.Tensor, radius_vox: int, axis: int) -> torch.Tensor:
    """One separable squared-EDT axis pass in voxel-integer units
    (clearance.py:33-48).  Rolled-in values wrap from the opposite face;
    the halo (at least radius_vox on every side) keeps them away from every
    interior voxel."""
    acc = d2
    for s in range(1, radius_vox + 1):
        cand = torch.minimum(torch.roll(d2, s, dims=axis), torch.roll(d2, -s, dims=axis)) + s * s
        acc = torch.minimum(acc, cand)
    return acc


def edt_packed_int(occ_bits: torch.Tensor, shape, radius_vox: int, rmax2: int, lo, size,
                   out_dtype) -> torch.Tensor:
    """The integer squared EDT of one box (``_edt_packed_int_jit``,
    clearance.py:51-73): ``occ_bits`` u8, the box's occupancy in
    np.packbits order; returns the interior ``lo:lo+size`` as
    ``out_dtype``, with the dtype's maximum where nothing occupied lies
    within ``rmax2`` (squared voxels)."""
    n = shape[0] * shape[1] * shape[2]
    shifts = torch.arange(7, -1, -1, dtype=torch.uint8, device=occ_bits.device)
    bits = (occ_bits[:, None] >> shifts[None, :]) & 1
    occupied = bits.reshape(-1)[:n].reshape(shape) != 0
    d2 = torch.where(occupied, 0, _BIG_I).to(torch.int32)
    for axis in range(3):
        d2 = _edt_pass_int(d2, radius_vox, axis)
    sent = int(np.iinfo(out_dtype).max)
    d2 = torch.where(d2 <= rmax2, d2, sent)
    inner = d2[lo[0]:lo[0] + size[0], lo[1]:lo[1] + size[1], lo[2]:lo[2] + size[2]]
    return inner.to(_TORCH_DTYPE[out_dtype])


def _int_bounds(radius: float, resolution: float, radius_vox: int):
    """(rmax2, out_dtype, lut): integer-EDT readback parameters.

    rmax2 = floor((radius/res)²) is the inclusive d2 bound matching the float
    path's ``sqrt(d2) ≤ radius`` test; the LUT finishes d2→clearance on host.
    """
    rmax2 = int(math.floor((radius / resolution) ** 2 * (1.0 + 1e-9)))
    d2_cap = 3 * radius_vox * radius_vox
    out_dtype = np.uint8 if d2_cap <= 254 else (
        np.uint16 if d2_cap <= 65534 else np.int32)
    sent = np.iinfo(out_dtype).max
    lut = np.full(sent + 1, -1.0, dtype=np.float32)
    i = np.arange(min(rmax2, sent - 1) + 1, dtype=np.float64)
    lut[: len(i)] = (np.sqrt(i) * resolution).astype(np.float32)
    return rmax2, out_dtype, lut


class ClearanceProcess:
    """Computes the clearance layer for map regions (MappingProcess-style)."""

    #: Memory cap for one dense EDT box (voxels).  Larger extents are split
    #: into overlapping halo tiles (reference analogue: ClearanceProcess's
    #: per-dirty-region ROI batching keeps GPU memory bounded).
    max_box_voxels = 256 ** 3

    def __init__(self, map_obj, search_radius: float = 1.0, query_flags: int = 0,
                 device="cuda"):
        self.map = map_obj
        self.device = resolve_device(device)
        self.search_radius = float(search_radius)
        self.query_flags = query_flags
        map_obj.layout.add_clearance()
        map_obj.ensure_chunk_layers()
        self._processed_stamps: dict = {}

    def update(self, region_keys=None, force: bool = False):
        """Compute clearance for the given regions (default: all dirty regions).

        Arbitrarily large extents are processed in overlapping halo tiles:
        regions are grouped into spatial tiles whose halo-padded dense box
        stays under ``max_box_voxels``; each tile's EDT sees obstacles up to
        search_radius beyond its border, so tiling is exact.
        """
        m = self.map
        if region_keys is None:
            region_keys = [k for k, c in m.chunks.items()
                           if force or self._processed_stamps.get(k, -1) < c.dirty_stamp]
        region_keys = [tuple(int(v) for v in k) for k in region_keys]
        if not region_keys:
            return 0

        dims = m.region_voxel_dims
        res = m.resolution
        radius_vox = max(1, int(math.ceil(self.search_radius / res)))
        halo_regions = int(math.ceil(radius_vox / float(dims.min())))

        # Greedy bounding-box grouping: a scene whose halo-padded bounding
        # box fits max_box_voxels is one upload, one EDT and one readback;
        # larger or sparser dirty sets split recursively at the midpoint of
        # the widest axis (each split separates spatial clusters, so halo
        # overlap stays bounded).
        keys_arr = np.array(region_keys, dtype=np.int64)
        dims64 = np.asarray(dims, dtype=np.int64)
        groups: list = []

        def _split(idx):
            kmin = keys_arr[idx].min(axis=0)
            kmax = keys_arr[idx].max(axis=0)
            box = (kmax - kmin + 1 + 2 * halo_regions) * dims64
            extent = kmax - kmin
            if box.prod() <= self.max_box_voxels or not extent.any():
                groups.append(idx)
                return
            ax = int(np.argmax(extent))
            mid = (kmin[ax] + kmax[ax] + 1) // 2
            left = idx[keys_arr[idx, ax] < mid]
            right = idx[keys_arr[idx, ax] >= mid]
            _split(left)
            _split(right)

        _split(np.arange(len(region_keys)))
        total = 0
        mask_cache: dict = {}
        for idx in groups:
            total += self._update_box([region_keys[i] for i in idx],
                                      radius_vox, halo_regions, mask_cache)
        return total

    def _update_box(self, region_keys, radius_vox, halo_regions,
                    mask_cache=None):
        """Dense EDT over one halo-padded box of regions."""
        m = self.map
        dims = m.region_voxel_dims
        res = m.resolution
        if mask_cache is None:
            mask_cache = {}

        keys_arr = np.array(region_keys, dtype=np.int64)
        rmin = keys_arr.min(axis=0)
        rmax = keys_arr.max(axis=0)
        # Halo in whole regions so neighbouring obstacles are visible.
        bmin = rmin - halo_regions
        bmax = rmax + halo_regions
        box_regions = bmax - bmin + 1
        box_vox = box_regions * np.asarray(dims, dtype=np.int64)

        occ_idx = m.layer_index(OCCUPANCY_LAYER)
        clear_idx = m.layer_index(CLEARANCE_LAYER)
        threshold = np.float32(m.occupancy_threshold_value)

        occupied = np.zeros(tuple(box_vox), dtype=bool)
        unknown_occ = bool(self.query_flags & UNKNOWN_AS_OCCUPIED)
        if unknown_occ:
            occupied[:] = True  # anything not covered by a chunk is unobserved
        # Direct box-range lookups (not a scan over every chunk), with the
        # per-chunk obstacle mask cached across this update()'s groups (halo
        # regions recur in neighbouring groups).
        for key in itertools.product(*(range(int(b0), int(b1) + 1)
                                       for b0, b1 in zip(bmin, bmax))):
            chunk = m.chunks.get(key)
            if chunk is None:
                continue
            mask = mask_cache.get(key)
            if mask is None:
                occ = chunk.layers[occ_idx][OCCUPANCY_LAYER].reshape(
                    dims[2], dims[1], dims[0]).transpose(2, 1, 0)
                mask = np.isfinite(occ) & (occ >= threshold)
                if unknown_occ:
                    mask = mask | ~np.isfinite(occ)
                mask_cache[key] = mask
            o = (np.asarray(key, np.int64) - bmin) * dims
            occupied[o[0]:o[0] + dims[0], o[1]:o[1] + dims[1], o[2]:o[2] + dims[2]] = mask

        # Ship 1 bit/voxel up (np.packbits), run the EDT in exact integer
        # voxel units, and read back the non-halo interior as u8/u16 squared
        # distances (4x/2x smaller than f32); a host LUT finishes
        # clearance = sqrt(d2)*res.
        lo = tuple(int(v) for v in (rmin - bmin) * dims)
        size = tuple(int(v) for v in (rmax - rmin + 1) * dims)
        bits = np.packbits(occupied.reshape(-1))
        rmax2, out_dtype, lut = _int_bounds(self.search_radius, float(res),
                                            radius_vox)
        d2 = edt_packed_int(
            torch.from_numpy(bits).to(self.device), tuple(int(v) for v in box_vox),
            radius_vox, rmax2, lo, size, out_dtype).cpu().numpy()
        clearance = lut[d2]

        for key in region_keys:
            chunk = m.region(key, allow_create=True)
            o = (np.asarray(key, np.int64) - rmin) * dims
            block = clearance[o[0]:o[0] + dims[0], o[1]:o[1] + dims[1], o[2]:o[2] + dims[2]]
            chunk.layers[clear_idx][CLEARANCE_LAYER] = block.transpose(2, 1, 0).reshape(-1)
            self._processed_stamps[key] = chunk.dirty_stamp
        return len(region_keys)
