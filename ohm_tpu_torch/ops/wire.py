"""Rayflow wire decode on the device.

Counterpart of the rayflow branch of ``_unpack_batch`` in
``ohm_tpu/ops/integrate.py``.  The wire is one uint8 tensor
(mapping.batch.rayflow_wire); every block is reinterpreted in place with
``Tensor.view(dtype)`` (little-endian, as the host wrote it):

  gmeta i32[8] | floats f32[R,7] (start_frac, direction, length), or f32[R,4]
  (direction, length) under the start_frac dictionary | abs16 u16[R,6] |
  [intensity f32[R]] | [frac dict f32[256,3] + frac idx u8[R]] | candidates

The intensity block rides on the NDT wire (``cfg.rayw_intensity``); the
port's wires carry no touch-time block.  abs16 words hold 11-bit
bbox-relative endpoint voxel coords; their 5 spare high bits carry valid,
fold (end-as-miss) and the 16-bit source ray index ``ray_order`` (the host
may permute wire rows; order-sensitive consumers key on it).
Candidates are i32[R,K] ((slot+1) << 18 | bbox-relative region), or a
dictionary of packed candidates with u8 (cdict 1) or u16 (cdict 2) indices.
"""

from __future__ import annotations

import torch

from ohm_tpu_torch.ops.config import IntegrateConfig
from ohm_tpu_torch.ops.ddawalk import f32


def _view(part: torch.Tensor, dtype: torch.dtype, shape) -> torch.Tensor:
    """Reinterpret a uint8 slice of the wire as ``dtype`` with ``shape``
    (every block starts 4-byte aligned: rpad is a multiple of 256)."""
    return part.view(dtype).reshape(shape)


def unpack_batch(buf: torch.Tensor, cfg: IntegrateConfig) -> dict:
    """Decode a rayflow wire (uint8[L] on any device) into per-ray tensors."""
    if buf.dtype != torch.uint8 or buf.dim() != 1 or not buf.is_contiguous():
        raise ValueError("the rayflow wire is a contiguous 1-D uint8 tensor")
    K = cfg.table_k
    cdict = int(cfg.rayw_cdict)
    fdict = bool(cfg.rayw_fdict)
    fw = 4 if fdict else 7
    intens_bpr = 4 if cfg.rayw_intensity else 0
    cand_bpr = {0: 4 * K, 1: K, 2: 2 * K}[cdict]
    cand_fixed = {0: 0, 1: 1024, 2: 8192}[cdict]
    bpr = 4 * fw + 12 + intens_bpr + (1 if fdict else 0) + cand_bpr
    fixed = 32 + cand_fixed + (3072 if fdict else 0)
    R = (buf.shape[0] - fixed) // bpr
    if R <= 0 or R * bpr + fixed != buf.shape[0]:
        raise ValueError(
            f"wire of {buf.shape[0]} bytes does not match the layout "
            f"(K={K}, cdict={cdict}, fdict={fdict}, "
            f"intensity={cfg.rayw_intensity})")
    off = 0

    def take(nbytes):
        nonlocal off
        part = buf[off:off + nbytes]
        off += nbytes
        return part

    gmeta = _view(take(32), torch.int32, (8,))
    floats = _view(take(4 * fw * R), torch.float32, (R, fw))
    # u16 words via int16: the high bit is data, so mask after widening.
    a16raw = _view(take(12 * R), torch.int16, (R, 6)).to(torch.int32) & 0xFFFF
    a16 = a16raw & 0x7FF
    hi = a16raw >> 11
    intensity = (_view(take(4 * R), torch.float32, (R,)) if intens_bpr
                 else torch.zeros(R, dtype=torch.float32, device=buf.device))
    if fdict:
        frac_tab = _view(take(3072), torch.float32, (256, 3))
        fidx = take(R).long()
    if cdict == 2:
        cand_dict = _view(take(8192), torch.int32, (2048,))
        cidx = _view(take(2 * K * R), torch.int16, (R, K)).long() & 0xFFFF
        tcand = cand_dict[cidx]
    elif cdict == 1:
        cand_dict = _view(take(1024), torch.int32, (256,))
        tcand = cand_dict[take(K * R).reshape(R, K).long()]
    else:
        tcand = _view(take(4 * K * R), torch.int32, (R, K))

    bbox_min_vox = gmeta[0:3] * (1 << cfg.region_shift)
    valid = (hi[:, 0] & 1) != 0
    fold = (hi[:, 0] & 2) != 0
    if fdict:
        direction = floats[:, 0:3]
        length = floats[:, 3]
        start_frac = frac_tab[fidx]  # exact table gather (bit-identical)
    else:
        direction = floats[:, 3:6]
        length = floats[:, 6]
        start_frac = floats[:, 0:3]
    start_abs = a16[:, 0:3] + bbox_min_vox[None, :]
    end_abs = a16[:, 3:6] + bbox_min_vox[None, :]
    # Separate ops, each rounded once, in the reference's order.
    end_frac = start_frac + (start_abs - end_abs).to(torch.float32) * f32(cfg.resolution)
    end_frac = end_frac + length[:, None] * direction
    ray_order = (hi[:, 0] >> 2) | (hi[:, 1] << 3) | (hi[:, 2] << 8) | (hi[:, 3] << 13)
    return {
        "start_abs": start_abs,
        "end_abs": end_abs,
        "start_frac": start_frac,
        "end_frac": end_frac,
        "direction": direction,
        "length": length,
        "is_sample": valid & ~fold,
        "end_as_miss": valid & fold,
        "exclude_start": valid,  # every ray record contains its origin
        "valid": valid,
        "intensity": intensity,
        "tcand": tcand,
        "gmeta": gmeta,
        "ray_order": ray_order,
    }
