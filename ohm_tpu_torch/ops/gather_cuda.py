"""K4, the plane gather: one int8 arena-plane value per record, as i32, and
its fused form for the NDT miss phase; and K5, the bit-exact f32 gather of
two arena planes per record.

K4 replaces ``ohm_tpu/ops/deposit_pallas.py`` ``gather_plane``; its plain
PyTorch version is ``gather_plane_reference``.  ``gather_ndt_flags`` is the
NDT miss phase's flag gather: the reference builds the arena-wide Gaussian
flag plane (``ohm_tpu/ops/integrate_ndt.py:195-197``) and gathers it with
``gather_plane``; the kernel reads occupancy and mean_count at each id and
computes the flag there (plain version ``gather_ndt_flags_reference``, that
very composition).  K5 replaces ``deposit_pallas.py`` ``gather_planes_f32``;
its plain version is ``gather_planes_f32_reference``.  The TSDF per-visit
path reads the batch-start (weight, distance) pair at every record with it
(ops.integrate_tsdf).  The kernels are in ``csrc/gather.cu``.  Each wrapper
runs the plain version for tensors on the CPU and launches the kernel for
tensors on a CUDA device.
"""

from __future__ import annotations

import torch

from ohm_tpu_torch.ops import _build

_I32_MIN, _I32_MAX = -(1 << 31), (1 << 31) - 1


def gather_plane_reference(plane: torch.Tensor, ids: torch.Tensor, sentinel: int):
    """Plain PyTorch K4: i32[N] = plane[ids] where 0 <= ids < sentinel, else 0."""
    real = (ids >= 0) & (ids < sentinel)
    vals = plane[torch.where(real, ids, torch.zeros_like(ids)).long()].to(torch.int32)
    return torch.where(real, vals, torch.zeros_like(vals))


def _dense(t: torch.Tensor, dtype: torch.dtype, device) -> bool:
    return t.dtype is dtype and t.dim() == 1 and t.is_contiguous() and t.device == device


def _ids_ok(ids: torch.Tensor) -> bool:
    """Contiguous i32[N] ids starting on a 16-byte boundary, as the kernel's
    vector loads need (torch.sort's outputs and fresh tensors are)."""
    return _dense(ids, torch.int32, ids.device) and ids.data_ptr() % 16 == 0


def gather_plane(plane: torch.Tensor, ids: torch.Tensor, sentinel: int):
    """Gather ``plane`` (int8[>= sentinel]) at ``ids`` (i32[N], ascending on
    the main path; the kernel does not need them sorted; on the card 16-byte
    aligned).  Returns i32[N]."""
    if plane.device.type == "cpu":
        return gather_plane_reference(plane, ids, sentinel)
    if not (_dense(plane, torch.int8, ids.device) and _ids_ok(ids)
            and 0 <= sentinel <= plane.shape[0]):
        raise ValueError("gather_plane takes a contiguous int8[>= sentinel] plane and "
                         "contiguous, 16-byte aligned i32[N] ids on one CUDA device")
    out = torch.empty_like(ids)
    rc = _build.entry("ohm_gather_plane")(plane.data_ptr(), ids.data_ptr(), ids.shape[0],
                                          sentinel, out.data_ptr(), _build.stream_of(ids))
    if rc:
        _build.check(rc, "gather_plane")
    gather_plane.launches += 1
    return out


#: Kernel launches since the count was last set to 0.
gather_plane.launches = 0


def gather_ndt_flags_reference(occupancy: torch.Tensor, mean_count: torch.Tensor,
                               ids: torch.Tensor, threshold: int, sentinel: int):
    """Plain fused flag gather: the Gaussian flag plane built over the whole
    arena (observed, i.e. occupancy not +inf, and mean_count's u32 at or
    above ``threshold``: a signed compare on its int32 bits plus the < 0
    term), then K4's plain gather at ``ids``.  Returns i32[N] of 0/1."""
    plane = (~torch.isposinf(occupancy)
             & ((mean_count >= threshold) | (mean_count < 0))).to(torch.int8)
    return gather_plane_reference(plane, ids, sentinel)


def gather_ndt_flags(occupancy: torch.Tensor, mean_count: torch.Tensor, ids: torch.Tensor,
                     threshold: int, sentinel: int):
    """The NDT miss phase's Gaussian flag at ``ids`` (i32[N], ascending on
    the main path; on the card 16-byte aligned), read from the arena's
    ``occupancy`` (f32[>= sentinel], +inf unobserved) and ``mean_count`` (u32
    as int32[>= sentinel]) without building the flag plane.  Returns i32[N]:
    1 where 0 <= id < sentinel and the voxel is flagged, else 0."""
    if ids.device.type == "cpu":
        return gather_ndt_flags_reference(occupancy, mean_count, ids, threshold, sentinel)
    dev = ids.device
    if not (_dense(occupancy, torch.float32, dev) and _dense(mean_count, torch.int32, dev)
            and _ids_ok(ids)
            and 0 <= sentinel <= min(occupancy.shape[0], mean_count.shape[0])
            and _I32_MIN <= threshold <= _I32_MAX):
        raise ValueError("gather_ndt_flags takes contiguous f32 occupancy and int32 "
                         "mean_count of >= sentinel voxels, contiguous, 16-byte aligned "
                         "i32[N] ids on one CUDA device and an int32 threshold")
    out = torch.empty_like(ids)
    rc = _build.entry("ohm_gather_ndt_flags")(
        occupancy.data_ptr(), mean_count.data_ptr(), ids.data_ptr(), ids.shape[0],
        threshold, sentinel, out.data_ptr(), _build.stream_of(ids))
    if rc:
        _build.check(rc, "gather_ndt_flags")
    gather_ndt_flags.launches += 1
    return out


#: Kernel launches since the count was last set to 0.
gather_ndt_flags.launches = 0


def gather_planes_f32_reference(planes, ids: torch.Tensor, sentinel: int):
    """Plain PyTorch K5: for each f32 plane, f32[N] = plane[ids] where
    0 <= ids < sentinel, else +0.0.  Copied as 32-bit patterns, so -0.0,
    infinities, NaN payloads and denormals survive."""
    real = (ids >= 0) & (ids < sentinel)
    safe = torch.where(real, ids, torch.zeros_like(ids)).long()
    outs = []
    for plane in planes:
        bits = plane.view(torch.int32)[safe]
        outs.append(torch.where(real, bits, torch.zeros_like(bits)).view(torch.float32))
    return tuple(outs)


def gather_planes_f32(planes, ids: torch.Tensor, sentinel: int):
    """Gather two f32 arena planes (each f32[>= sentinel]) at ``ids`` (i32[N],
    ascending on the main path; the kernel does not need them sorted).
    Returns a tuple of two f32[N]."""
    planes = tuple(planes)
    if ids.device.type == "cpu":
        return gather_planes_f32_reference(planes, ids, sentinel)
    if len(planes) != 2:
        raise ValueError("the kernel gathers two planes")
    for plane in planes:
        if not (plane.dtype == torch.float32 and plane.dim() == 1 and plane.is_contiguous()
                and plane.shape[0] >= sentinel and plane.device == ids.device):
            raise ValueError("each plane must be a contiguous f32[>= sentinel] tensor "
                             "on the ids' device")
    if not (ids.dtype == torch.int32 and ids.dim() == 1 and ids.is_contiguous()):
        raise ValueError("ids must be a contiguous i32[N] tensor")
    outs = tuple(torch.empty(ids.shape[0], dtype=torch.float32, device=ids.device)
                 for _ in planes)
    rc = _build.load().ohm_gather_planes_f32(
        planes[0].data_ptr(), planes[1].data_ptr(), ids.data_ptr(), ids.shape[0], sentinel,
        outs[0].data_ptr(), outs[1].data_ptr(), _build.stream_of(ids))
    _build.check(rc, "gather_planes_f32")
    gather_planes_f32.launches += 1
    return outs


#: Kernel launches since the count was last set to 0.
gather_planes_f32.launches = 0
