"""Packed sub-voxel mean codec on the device.

Counterpart of ``sub_voxel_coord`` and ``sub_voxel_to_local_coord`` in
``ohm_tpu/ops/subvoxel_jnp.py`` (reference: ohm/VoxelMeanCompute.h:69-122).
The uint32 pattern (10 bits per axis, bit 31 = used) lives in int32 bit
patterns, as the arena stores it; every f32 op is a separate PyTorch op in
the reference's order.
"""

from __future__ import annotations

import numpy as np
import torch

from ohm_tpu_torch.ops.ddawalk import floor_to_i32

MEAN_BITS_PER_AXIS = 10
MEAN_POSITIONS = (1 << MEAN_BITS_PER_AXIS) - 1
#: Bit 31 of the pattern as an int32.
MEAN_USED_BIT = -(1 << 31)


def _scales(resolution: float) -> tuple[float, float]:
    """(mean_res, offset) in f32, as the reference computes them."""
    res = np.float32(resolution)
    return float(res / np.float32(MEAN_POSITIONS)), float(np.float32(0.5) * res)


def sub_voxel_coord(local_coord: torch.Tensor, resolution: float) -> torch.Tensor:
    """Voxel-centre-relative coords f32[..., 3] -> int32 patterns [...]."""
    mean_res, offset = _scales(resolution)
    pos = floor_to_i32((local_coord + offset) / mean_res + 0.5)
    pos = torch.clamp(pos, 0, MEAN_POSITIONS)
    pattern = (pos[..., 0] | (pos[..., 1] << MEAN_BITS_PER_AXIS)
               | (pos[..., 2] << (2 * MEAN_BITS_PER_AXIS)))
    return pattern | MEAN_USED_BIT


def sub_voxel_to_local_coord(pattern: torch.Tensor, resolution: float) -> torch.Tensor:
    """int32 patterns [...] -> voxel-centre-relative coords f32[..., 3]
    (zero where the used bit is clear)."""
    mean_res, offset = _scales(resolution)
    used = pattern < 0  # bit 31
    axes = []
    for axis in range(3):
        q = ((pattern >> (axis * MEAN_BITS_PER_AXIS)) & MEAN_POSITIONS).to(torch.float32)
        coord = q * mean_res - offset
        axes.append(torch.where(used, coord, torch.zeros_like(coord)))
    return torch.stack(axes, dim=-1)
