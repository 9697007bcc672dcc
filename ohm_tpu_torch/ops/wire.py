"""Wire decode on the device: the rayflow wire and the segmented wire.

Counterpart of ``_unpack_batch`` in ``ohm_tpu/ops/integrate.py``.
``decode`` takes what a mapper uploads: a uint8 tensor is a rayflow wire
(``unpack_batch``), a dict is a segmented batch (``unpack_segmented``).

The rayflow wire is one uint8 tensor
(mapping.batch.rayflow_wire); every block is reinterpreted in place with
``Tensor.view(dtype)`` (little-endian, as the host wrote it):

  gmeta i32[8] | floats f32[R,7] (start_frac, direction, length), or f32[R,4]
  (direction, length) under the start_frac dictionary | abs16 u16[R,6] |
  [touch u32[R]] | [intensity f32[R]] | [frac dict f32[256,3] + frac idx
  u8[R]] | candidates

The touch-time block rides when the map has a touch-time layer
(``cfg.with_touch_time``): each ray's milliseconds since the map's first
ray, kept as int32 bit patterns (``touch_enc``).  The intensity block rides
on the NDT wire (``cfg.rayw_intensity``).  abs16 words hold 11-bit
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


def end_frac_of(start_frac, start_abs, end_abs, length, direction, resolution: float):
    """A ray's end point relative to its end voxel's origin, from its start
    voxel, start fraction, direction and length: separate ops, each rounded
    once, in the reference's order (integrate.py:_unpack_batch).  The
    sharded rayflow step derives it again after routing
    (parallel.rayflow), bit for bit."""
    end_frac = start_frac + (start_abs - end_abs).to(torch.float32) * f32(resolution)
    return end_frac + length[:, None] * direction


def unpack_batch(buf: torch.Tensor, cfg: IntegrateConfig) -> dict:
    """Decode a rayflow wire (uint8[L] on any device) into per-ray tensors."""
    if buf.dtype != torch.uint8 or buf.dim() != 1 or not buf.is_contiguous():
        raise ValueError("the rayflow wire is a contiguous 1-D uint8 tensor")
    K = cfg.table_k
    cdict = int(cfg.rayw_cdict)
    fdict = bool(cfg.rayw_fdict)
    fw = 4 if fdict else 7
    touch_bpr = 4 if cfg.with_touch_time else 0
    intens_bpr = 4 if cfg.rayw_intensity else 0
    cand_bpr = {0: 4 * K, 1: K, 2: 2 * K}[cdict]
    cand_fixed = {0: 0, 1: 1024, 2: 8192}[cdict]
    bpr = 4 * fw + 12 + touch_bpr + intens_bpr + (1 if fdict else 0) + cand_bpr
    fixed = 32 + cand_fixed + (3072 if fdict else 0)
    R = (buf.shape[0] - fixed) // bpr
    if R <= 0 or R * bpr + fixed != buf.shape[0]:
        raise ValueError(
            f"wire of {buf.shape[0]} bytes does not match the layout "
            f"(K={K}, cdict={cdict}, fdict={fdict}, "
            f"touch={cfg.with_touch_time}, intensity={cfg.rayw_intensity})")
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
    touch_enc = _view(take(4 * R), torch.int32, (R,)) if touch_bpr else None
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
    end_frac = end_frac_of(start_frac, start_abs, end_abs, length, direction, cfg.resolution)
    ray_order = (hi[:, 0] >> 2) | (hi[:, 1] << 3) | (hi[:, 2] << 8) | (hi[:, 3] << 13)
    batch = {
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
        # Every rayflow record is a whole ray: it starts at the sensor.
        "t0": torch.zeros_like(length),
        "full_length": length,
    }
    if touch_enc is not None:  # only maps with a touch-time layer read it
        batch["touch_enc"] = touch_enc
    return batch


def _float_width(cfg: IntegrateConfig) -> int:
    """The segmented wire's float block width (mapping.batch.build_wire):
    t0 and full_length ride for TSDF (12), end_frac with the mean layer
    (10), else start_frac, direction and length (7)."""
    if cfg.wire_tsdf:
        return 12
    return 10 if cfg.with_mean else 7


def unpack_segmented(batch: dict, cfg: IntegrateConfig) -> dict:
    """Decode a segmented batch on any device into per-segment tensors.

    ``batch`` holds one of three layouts (mapping.batch), as the reference's
    ``_unpack_batch`` reads them, and for the NDT mappers an f32
    ``intensity`` per segment beside it:

      "wire"   the packed single buffer, uint8[L] (pack_wire / build_wire):
               floats f32[B,W] | offs u32[B,2] | [touch u32[B]] | ints16
               i16[B,11] | flags u8[B,4] | pad to 4 bytes
      "ints16" the compact blocks (compact_batch): ints16 (rmin xyz, the 8
               corner slots), offs (the endpoints' 6-bit offsets from the
               rmin region's origin, 3 x 6 bits a word), floats, flags, touch
      "ints"   the full blocks (PreparedBatch.arrays: ints i32[B,17], floats
               f32[B,12], flags bool[B,4], touch), which the mappers ship at
               capacity 32767 or more or region dims over 32

    u32 words (offs, touch) are int32 bit patterns here."""
    intensity = batch.get("intensity")
    if "wire" in batch:
        buf = batch["wire"]
        if buf.dtype != torch.uint8 or buf.dim() != 1 or not buf.is_contiguous():
            raise ValueError("the segmented wire is a contiguous 1-D uint8 tensor")
        w = _float_width(cfg)
        touch_bps = 4 if cfg.with_touch_time else 0
        bps = 4 * w + 8 + touch_bps + 22 + 4
        B = buf.shape[0] // bps  # the pad is under 4 bytes
        if B <= 0 or buf.shape[0] - B * bps >= 4:
            raise ValueError(f"segmented wire of {buf.shape[0]} bytes does not match the "
                             f"layout (float width {w}, touch={cfg.with_touch_time})")
        off = 0

        def take(nbytes):
            nonlocal off
            part = buf[off:off + nbytes]
            off += nbytes
            return part

        batch = {"floats": _view(take(4 * w * B), torch.float32, (B, w)),
                 "offs": _view(take(8 * B), torch.int32, (B, 2))}
        batch["touch"] = _view(take(4 * B), torch.int32, (B,)) if touch_bps else None
        batch["ints16"] = _view(take(22 * B), torch.int16, (B, 11))
        batch["flags"] = take(4 * B).reshape(B, 4) != 0
    floats, flags = batch["floats"], batch["flags"]
    if "ints" in batch:
        ints = batch["ints"]
        start_abs, end_abs = ints[:, 0:3], ints[:, 3:6]
        rmin, corner_slots = ints[:, 6:9], ints[:, 9:17]
    else:
        ints16 = batch["ints16"].to(torch.int32)
        rmin, corner_slots = ints16[:, 0:3], ints16[:, 3:11]
        base = rmin << cfg.region_shift
        offs = batch["offs"]
        shifts = torch.tensor([0, 6, 12], dtype=torch.int32, device=offs.device)
        start_abs = base + ((offs[:, 0:1] >> shifts) & 0x3F)
        end_abs = base + ((offs[:, 1:2] >> shifts) & 0x3F)
    B = floats.shape[0]
    touch = batch.get("touch")
    out = {
        "start_abs": start_abs,
        "end_abs": end_abs,
        "rmin": rmin,
        "corner_slots": corner_slots,
        "start_frac": floats[:, 0:3],
        "direction": floats[:, 3:6],
        "length": floats[:, 6],
        "is_sample": flags[:, 0],
        "end_as_miss": flags[:, 1],
        "exclude_start": flags[:, 2],
        "valid": flags[:, 3],
        "touch_enc": (touch if touch is not None
                      else torch.zeros(B, dtype=torch.int32, device=floats.device)),
        "intensity": (intensity if intensity is not None
                      else torch.zeros(B, dtype=torch.float32, device=floats.device)),
    }
    if floats.shape[1] >= 10:
        out["end_frac"] = floats[:, 7:10]
    if floats.shape[1] >= 12:
        out["t0"] = floats[:, 10]
        out["full_length"] = floats[:, 11]
    return out


def decode(upload, cfg: IntegrateConfig) -> dict:
    """A mapper's upload decoded: a uint8 tensor is a rayflow wire, a dict
    a segmented batch."""
    if isinstance(upload, dict):
        return unpack_segmented(upload, cfg)
    return unpack_batch(upload, cfg)
