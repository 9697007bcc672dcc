"""K4, the plane gather: one int8 arena-plane value per record, as i32.

Replaces ``ohm_tpu/ops/deposit_pallas.py`` ``gather_plane``.  The CUDA
kernel is ``csrc/gather.cu``; its plain PyTorch version is
``gather_plane_reference``.  ``gather_plane`` runs the plain version for
tensors on the CPU and launches the kernel for tensors on a CUDA device.
The NDT miss phase gathers its Gaussian flag plane with it
(ops.integrate_ndt).
"""

from __future__ import annotations

import torch

from ohm_tpu_torch.ops import _build


def gather_plane_reference(plane: torch.Tensor, ids: torch.Tensor, sentinel: int):
    """Plain PyTorch K4: i32[N] = plane[ids] where 0 <= ids < sentinel, else 0."""
    real = (ids >= 0) & (ids < sentinel)
    vals = plane[torch.where(real, ids, torch.zeros_like(ids)).long()].to(torch.int32)
    return torch.where(real, vals, torch.zeros_like(vals))


def gather_plane(plane: torch.Tensor, ids: torch.Tensor, sentinel: int):
    """Gather ``plane`` (int8[>= sentinel]) at ``ids`` (i32[N], ascending on
    the main path; the kernel does not need them sorted).  Returns i32[N]."""
    if plane.device.type == "cpu":
        return gather_plane_reference(plane, ids, sentinel)
    if not (plane.dtype == torch.int8 and plane.dim() == 1 and plane.is_contiguous()
            and plane.shape[0] >= sentinel):
        raise ValueError("plane must be a contiguous int8[>= sentinel] tensor")
    if not (ids.dtype == torch.int32 and ids.dim() == 1 and ids.is_contiguous()
            and ids.device == plane.device):
        raise ValueError("ids must be a contiguous i32[N] tensor on the plane's device")
    out = torch.empty_like(ids)
    rc = _build.load().ohm_gather_plane(
        plane.data_ptr(), ids.data_ptr(), ids.shape[0], sentinel, out.data_ptr(),
        _build.stream_of(out))
    _build.check(rc, "gather_plane")
    gather_plane.launches += 1
    return out


#: Kernel launches since the count was last set to 0.
gather_plane.launches = 0
