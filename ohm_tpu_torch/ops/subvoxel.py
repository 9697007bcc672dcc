"""Packed sub-voxel mean and incident-normal codecs on the device.

Counterparts of ``sub_voxel_coord``, ``sub_voxel_to_local_coord``,
``decode_normal`` and ``encode_normal`` in ``ohm_tpu/ops/subvoxel_jnp.py``
(reference: ohm/VoxelMeanCompute.h:69-122, ohm/VoxelIncidentCompute.h:35-89).
The uint32 patterns (mean: 10 bits per axis, bit 31 = used; normal: 14-bit
x and y at bits 0 and 15, bit 30 = set, bit 31 = negative z) live in int32
bit patterns, as the arena stores them; every f32 op is a separate PyTorch
op in the reference's order.
"""

from __future__ import annotations

import numpy as np
import torch

from ohm_tpu_torch.ops.ddawalk import floor_to_i32

MEAN_BITS_PER_AXIS = 10
MEAN_POSITIONS = (1 << MEAN_BITS_PER_AXIS) - 1
#: Bit 31 of the pattern as an int32.
MEAN_USED_BIT = -(1 << 31)

NORMAL_QUAT = 16383.0
NORMAL_MASK = 0x3FFF
NORMAL_SET_BIT = 1 << 30
#: Bit 31 (negative z) as an int32.
NORMAL_SIGN_BIT_Z = -(1 << 31)
#: The smallest normal f32, 2^-126.
_TINY = float(np.finfo(np.float32).tiny)


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


def sqrt_f32(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded f32 square root, as XLA and CUDA's sqrtf give
    it: taken in f64 and rounded once.  (torch's vectorised f32 sqrt on the
    CPU can be one ulp off.)"""
    return torch.sqrt(x.double()).to(torch.float32)


def flush_denormals(x: torch.Tensor) -> torch.Tensor:
    """``x`` with each f32 below 2^-126 in magnitude read as a zero of its
    sign, as XLA's CPU backend and the TPU read an op's denormal inputs and
    write its denormal results; NaN and the rest stay as they are."""
    return torch.where(x.abs() < _TINY, x * 0.0, x)  # x * 0.0 keeps the sign


def decode_normal(packed: torch.Tensor) -> torch.Tensor:
    """int32 patterns [...] -> unit normals f32[..., 3] (zero where the set
    bit is clear)."""
    nx = 2.0 * ((packed & NORMAL_MASK).to(torch.float32) / NORMAL_QUAT) - 1.0
    ny = 2.0 * (((packed >> 15) & NORMAL_MASK).to(torch.float32) / NORMAL_QUAT) - 1.0
    nx = torch.clamp(nx, -1.0, 1.0)
    ny = torch.clamp(ny, -1.0, 1.0)
    nz2 = torch.clamp(1.0 - (nx * nx + ny * ny), -1.0, 1.0)
    has = (packed & NORMAL_SET_BIT) != 0
    zero = torch.zeros_like(nx)
    nx = torch.where(has, nx, zero)
    ny = torch.where(has, ny, zero)
    nz = torch.where(has, sqrt_f32(torch.clamp(nz2, min=0.0)), zero)
    nz = torch.where(packed < 0, -nz, nz)  # bit 31: negative z
    return torch.stack([nx, ny, nz], dim=-1)


def encode_normal(normal: torch.Tensor) -> torch.Tensor:
    """Normals f32[..., 3] -> int32 patterns [...]."""
    x = 0.5 * (torch.clamp(normal[..., 0], -1.0, 1.0) + 1.0)
    y = 0.5 * (torch.clamp(normal[..., 1], -1.0, 1.0) + 1.0)
    # The reference casts f32 -> u32, which truncates.  x * 16383 and
    # y * 16383 lie in [0, 16383], where .to(int32) truncates alike.
    xi = (x * NORMAL_QUAT).to(torch.int32) & NORMAL_MASK
    yi = (y * NORMAL_QUAT).to(torch.int32) & NORMAL_MASK
    packed = (xi | (yi << 15)) & ~(NORMAL_SET_BIT | NORMAL_SIGN_BIT_Z)
    packed = packed | torch.where(normal[..., 2] < 0, NORMAL_SIGN_BIT_Z, 0).to(torch.int32)
    nonzero = (normal[..., 0] != 0) | (normal[..., 1] != 0) | (normal[..., 2] != 0)
    return packed | torch.where(nonzero, NORMAL_SET_BIT, 0).to(torch.int32)
