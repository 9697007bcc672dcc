"""Native LAS/LAZ point-cloud reader (no external dependencies).

Reference parity: slamio/PointCloudReaderPdal.{h,cpp} reads LAS/LAZ (among
other formats) through PDAL; PDAL is not available in this environment, so
.las is parsed directly against the public ASPRS LAS 1.0-1.4 specification
and .laz through a from-scratch LASzip codec (ohm_tpu/native/laszip.cpp:
pointwise-chunked compressor 2, record version 2 item codecs POINT10 /
GPSTIME11 / RGB12 / BYTE — LAS 1.2 point formats 0-3 plus extra bytes —
and layered compressor 3, version 3 item codecs POINT14 / RGB14 /
RGBNIR14 / BYTE14 — LAS 1.4 point formats 6-8).  Both fixed- and
VARIABLE-chunked streams are handled (variable chunk tables carry
per-chunk point-count/byte-size pairs — the framing spatially-sorted and
COPC-style writers emit); the v4 selective-update codecs are rejected with
a clear error.  Round-trips are pinned by tests/test_laz.py; cross-implementation
bit-compatibility of the layered codecs could not be verified in this
environment (no third-party .laz available) — docs/STATUS.md carries the
caveat.

Covers point data record formats 0-10 uncompressed: scaled XYZ, intensity,
GPS time, return number / number of returns (dual-return detection for the
secondary-samples mapper — reference slamio/SlamCloudLoader.h dual return
handling).
"""

from __future__ import annotations

import struct

import numpy as np

#: GPS-time byte offset within a point record, per point data format id.
_GPS_OFFSET = {1: 20, 3: 20, 4: 20, 5: 20, 6: 22, 7: 22, 8: 22, 9: 22, 10: 22}
#: Formats whose return info lives in byte 14 as two 4-bit fields (1.4 era).
_EXTENDED_RETURNS = {6, 7, 8, 9, 10}

#: LASzip item type ids (laszip VLR item list).
_LZ_BYTE, _LZ_POINT10, _LZ_GPSTIME11, _LZ_RGB12 = 0, 6, 7, 8
_LZ_SUPPORTED = {_LZ_BYTE, _LZ_POINT10, _LZ_GPSTIME11, _LZ_RGB12}
#: LAS 1.4 layered (compressor 3) item type ids, record version 3.
_LZ_POINT14, _LZ_RGB14, _LZ_RGBNIR14, _LZ_BYTE14 = 10, 11, 12, 14
_LZ_LAYERED = {_LZ_POINT14, _LZ_RGB14, _LZ_RGBNIR14, _LZ_BYTE14}


def _parse_records(rec: np.ndarray, fmt: int, scale, offset) -> dict:
    """Field extraction from raw point records u8[N, rec_len]."""
    n_points, rec_len = rec.shape

    def field(off, dtype, count=1):
        width = np.dtype(dtype).itemsize * count
        block = np.ascontiguousarray(rec[:, off:off + width])
        arr = block.view(dtype)
        return arr[:, 0] if count == 1 else arr

    xyz_i = field(0, "<i4", 3).astype(np.float64)
    out = {"points": xyz_i * scale[None, :] + offset[None, :]}
    if rec_len >= 14:
        out["intensities"] = field(12, "<u2").astype(np.float32)
    gps_off = _GPS_OFFSET.get(int(fmt))
    if gps_off is not None and rec_len >= gps_off + 8:
        out["timestamps"] = field(gps_off, "<f8").astype(np.float64)
    if fmt in _EXTENDED_RETURNS:
        rb = rec[:, 14]
        out["return_numbers"] = (rb & 0x0F).astype(np.uint8)
        out["number_of_returns"] = (rb >> 4).astype(np.uint8)
    else:
        rb = rec[:, 14]
        out["return_numbers"] = (rb & 0x07).astype(np.uint8)
        out["number_of_returns"] = ((rb >> 3) & 0x07).astype(np.uint8)
    return out


def _find_laszip_vlr(data: bytes, header_size: int, n_vlrs: int):
    """Walk the VLR block; return the parsed laszip VLR payload or None."""
    pos = header_size
    for _ in range(n_vlrs):
        if pos + 54 > len(data):
            return None
        user_id = data[pos + 2:pos + 18].rstrip(b"\0")
        record_id = struct.unpack_from("<H", data, pos + 18)[0]
        length = struct.unpack_from("<H", data, pos + 20)[0]
        payload = data[pos + 54:pos + 54 + length]
        pos += 54 + length
        if user_id == b"laszip encoded" and record_id == 22204:
            return _parse_laszip_vlr(payload)
    return None


def _parse_laszip_vlr(payload: bytes) -> dict:
    (compressor, coder, vmaj, vmin, vrev, options, chunk_size,
     n_evlrs, evlr_off, num_items) = struct.unpack_from("<HHBBHIIqqH", payload, 0)
    items = []
    for i in range(num_items):
        t, s, v = struct.unpack_from("<HHH", payload, 34 + 6 * i)
        items.append((t, s, v))
    return {"compressor": compressor, "coder": coder,
            "version": (vmaj, vmin, vrev), "chunk_size": chunk_size,
            "items": items}


def _read_laz_records(data: bytes, filename: str, point_offset: int,
                      n_points: int, rec_len: int) -> np.ndarray:
    """Decompress the LASzip point stream to raw records u8[N, rec_len]."""
    from ohm_tpu_torch import native

    header_size = struct.unpack_from("<H", data, 94)[0]
    n_vlrs = struct.unpack_from("<I", data, 100)[0]
    vlr = _find_laszip_vlr(data, header_size, n_vlrs)
    if vlr is None:
        raise ValueError(f"{filename}: compressed LAZ without a laszip VLR")
    if vlr["coder"] != 0:
        raise ValueError(f"{filename}: unsupported LASzip coder {vlr['coder']}")
    if vlr["compressor"] not in (1, 2, 3):
        raise NotImplementedError(
            f"{filename}: LASzip compressor {vlr['compressor']} is not "
            "supported")
    layered = vlr["compressor"] == 3
    if layered:
        for t, s, v in vlr["items"]:
            if t not in _LZ_LAYERED or v != 3:
                raise NotImplementedError(
                    f"{filename}: LASzip layered item type {t} v{v} not "
                    "supported (POINT14/RGB14/RGBNIR14/BYTE14 v3 only)")
    else:
        for t, s, v in vlr["items"]:
            if t not in _LZ_SUPPORTED or v != 2:
                raise NotImplementedError(
                    f"{filename}: LASzip item type {t} v{v} not supported "
                    "(point formats 0-3 + extra bytes only)")
    sizes = [s for _, s, _ in vlr["items"]]
    if sum(sizes) != rec_len:
        raise ValueError(f"{filename}: laszip item sizes {sizes} != record "
                         f"length {rec_len}")

    chunk_counts = None
    if vlr["compressor"] == 1:  # pointwise: one chunk, no table
        stream = np.frombuffer(data, np.uint8, offset=point_offset)
        chunk_size, starts = 0xFFFFFFFF, [0]
    else:
        table_off = struct.unpack_from("<q", data, point_offset)[0]
        if table_off == -1:  # streaming writer: offset stored in last 8 bytes
            table_off = struct.unpack_from("<q", data, len(data) - 8)[0]
        if not point_offset + 8 <= table_off <= len(data) - 8:
            raise ValueError(f"{filename}: bad LASzip chunk table offset")
        stream = np.frombuffer(data, np.uint8,
                               count=table_off - point_offset - 8,
                               offset=point_offset + 8)
        version, n_chunks = struct.unpack_from("<II", data, table_off)
        if version != 0:
            raise ValueError(f"{filename}: LASzip chunk table v{version}")
        chunk_size = vlr["chunk_size"]
        payload = np.frombuffer(data, np.uint8, offset=table_off + 8)
        if chunk_size == 0xFFFFFFFF:
            # Variable chunking (spatially-sorted / COPC-style writers): the
            # table carries per-chunk (point count, byte size) pairs.
            chunk_counts, chunk_bytes = native.laz_read_chunk_table_variable(
                payload, n_chunks)
        else:
            chunk_bytes = native.laz_read_chunk_table(payload, n_chunks)
        starts = np.concatenate([[0], np.cumsum(chunk_bytes[:-1])])
    types = [t for t, _, _ in vlr["items"]]
    return native.laz_decompress(stream, types, sizes, n_points, chunk_size,
                                 starts, layered=layered,
                                 chunk_counts=chunk_counts)


def read_las(filename: str) -> dict:
    """Parse a .las / .laz file; returns dict with 'points' f64[N,3] and,
    when present in the format, 'timestamps' f64[N], 'intensities' f32[N],
    'return_numbers' u8[N], 'number_of_returns' u8[N]."""
    with open(filename, "rb") as f:
        header = f.read(375)
        if len(header) < 227 or header[0:4] != b"LASF":
            raise ValueError(f"{filename}: not a LAS file (missing LASF signature)")
        ver_major, ver_minor = header[24], header[25]
        point_offset = int(np.frombuffer(header, "<u4", 1, 96)[0])
        fmt = header[104]
        compressed = bool(fmt & 0x80)
        fmt = fmt & 0x7F
        if fmt > 10:
            raise ValueError(f"{filename}: unsupported point data format {fmt}")
        rec_len = int(np.frombuffer(header, "<u2", 1, 105)[0])
        n_points = int(np.frombuffer(header, "<u4", 1, 107)[0])
        if n_points == 0 and ver_major == 1 and ver_minor >= 4 and len(header) >= 255:
            n_points = int(np.frombuffer(header, "<u8", 1, 247)[0])
        scale = np.frombuffer(header, "<f8", 3, 131).copy()
        offset = np.frombuffer(header, "<f8", 3, 155).copy()

        if compressed:
            f.seek(0)
            data = f.read()
            rec = _read_laz_records(data, filename, point_offset, n_points,
                                    rec_len)
            return _parse_records(rec, fmt, scale, offset)

        f.seek(point_offset)
        raw = f.read(n_points * rec_len)
    if len(raw) < n_points * rec_len:
        n_points = len(raw) // rec_len
        raw = raw[: n_points * rec_len]
    rec = np.frombuffer(raw, np.uint8).reshape(n_points, rec_len)
    return _parse_records(rec, fmt, scale, offset)


def _build_records_fmt1(points, timestamps, intensities, return_numbers,
                        number_of_returns, scale, offset):
    """Raw LAS point format 1 records (28 B) from field arrays."""
    n = len(points)
    rec = np.zeros((n, 28), np.uint8)
    xyz_i = np.round((points - offset[None, :]) / scale[None, :]).astype("<i4")
    rec[:, 0:12] = np.ascontiguousarray(xyz_i).view(np.uint8).reshape(n, 12)
    if intensities is not None:
        rec[:, 12:14] = np.asarray(intensities, "<u2").view(np.uint8).reshape(n, 2)
    rn = np.asarray(return_numbers, np.uint8) if return_numbers is not None else np.ones(n, np.uint8)
    nr = np.asarray(number_of_returns, np.uint8) if number_of_returns is not None else np.ones(n, np.uint8)
    rec[:, 14] = (rn & 0x07) | ((nr & 0x07) << 3)
    if timestamps is not None:
        rec[:, 20:28] = np.asarray(timestamps, "<f8").view(np.uint8).reshape(n, 8)
    return rec


def _build_records_fmt6(points, timestamps, intensities, return_numbers,
                        number_of_returns, scale, offset,
                        scanner_channels=None):
    """Raw LAS 1.4 point format 6 records (30 B) from field arrays."""
    n = len(points)
    rec = np.zeros((n, 30), np.uint8)
    xyz_i = np.round((points - offset[None, :]) / scale[None, :]).astype("<i4")
    rec[:, 0:12] = np.ascontiguousarray(xyz_i).view(np.uint8).reshape(n, 12)
    if intensities is not None:
        rec[:, 12:14] = np.asarray(intensities, "<u2").view(np.uint8).reshape(n, 2)
    rn = np.asarray(return_numbers, np.uint8) if return_numbers is not None else np.ones(n, np.uint8)
    nr = np.asarray(number_of_returns, np.uint8) if number_of_returns is not None else np.ones(n, np.uint8)
    rec[:, 14] = (rn & 0x0F) | ((nr & 0x0F) << 4)
    if scanner_channels is not None:
        rec[:, 15] = (np.asarray(scanner_channels, np.uint8) & 0x03) << 4
    if timestamps is not None:
        rec[:, 22:30] = np.asarray(timestamps, "<f8").view(np.uint8).reshape(n, 8)
    return rec


def _las_header(n: int, fmt: int, rec_len: int, point_offset: int,
                n_vlrs: int, scale, offset, points,
                version=(1, 2)) -> bytearray:
    """Minimal LAS public header block; LAS 1.4 (375 B header, 64-bit point
    count at offset 247, legacy count zeroed for formats 6+) when
    ``version`` is (1, 4)."""
    header_size = 375 if version >= (1, 4) else 227
    header = bytearray(header_size)
    header[0:4] = b"LASF"
    header[24], header[25] = version
    header[94:96] = header_size.to_bytes(2, "little")
    header[96:100] = int(point_offset).to_bytes(4, "little")
    header[100:104] = int(n_vlrs).to_bytes(4, "little")
    header[104] = fmt
    header[105:107] = rec_len.to_bytes(2, "little")
    if version >= (1, 4) and (fmt & 0x7F) > 5:
        header[247:255] = n.to_bytes(8, "little")
    else:
        header[107:111] = n.to_bytes(4, "little")
        if version >= (1, 4):
            header[247:255] = n.to_bytes(8, "little")
    header[131:155] = np.asarray(scale, np.float64).tobytes()
    header[155:179] = np.asarray(offset, np.float64).tobytes()
    if n:
        header[179:227] = np.concatenate(
            [points.max(axis=0), points.min(axis=0)])[[0, 3, 1, 4, 2, 5]].tobytes()
    return header


def write_las(filename: str, points, timestamps=None, intensities=None,
              return_numbers=None, number_of_returns=None,
              scale=(1e-3, 1e-3, 1e-3)) -> None:
    """Write a minimal LAS 1.2 file (format 1: XYZ + intensity + GPS time).

    Primarily for tests and ohmfilter/ohm2ply-style export round-trips."""
    points = np.asarray(points, np.float64).reshape(-1, 3)
    n = len(points)
    scale = np.asarray(scale, np.float64)
    offset = points.min(axis=0) if n else np.zeros(3)
    rec = _build_records_fmt1(points, timestamps, intensities,
                              return_numbers, number_of_returns, scale, offset)
    header = _las_header(n, 1, 28, 227, 0, scale, offset, points)
    with open(filename, "wb") as f:
        f.write(bytes(header))
        f.write(rec.tobytes())


def write_laz(filename: str, points, timestamps=None, intensities=None,
              return_numbers=None, number_of_returns=None,
              scale=(1e-3, 1e-3, 1e-3), chunk_size: int = 50000,
              point_format: int = 1, scanner_channels=None,
              chunk_counts=None) -> None:
    """Write a LASzip-compressed .laz.

    ``point_format`` 1 (default): LAS 1.2, pointwise-chunked compressor 2
    with POINT10 + GPSTIME11 v2 item codecs.  ``point_format`` 6: LAS 1.4,
    layered compressor 3 with the POINT14 v3 item codec (the "native
    extension" framing modern fmt-6+ sensors emit).  Both carry a standard
    chunk table.  ``chunk_counts`` (a per-chunk point-count list summing to
    >= n) selects VARIABLE chunking — chunk_size 0xFFFFFFFF in the VLR and
    a (count, byte-size)-pair chunk table, the framing spatially-sorted
    writers emit."""
    from ohm_tpu_torch import native

    points = np.asarray(points, np.float64).reshape(-1, 3)
    n = len(points)
    scale = np.asarray(scale, np.float64)
    offset = points.min(axis=0) if n else np.zeros(3)
    if point_format == 6:
        rec = _build_records_fmt6(points, timestamps, intensities,
                                  return_numbers, number_of_returns, scale,
                                  offset, scanner_channels)
        items = [(_LZ_POINT14, 30, 3)]
        # laszip VLR version field = LASzip library version (3.4 era for the
        # layered codecs); the LAS header carries the 1.4 file version.
        compressor, version, las_version, fmt, rec_len = 3, (3, 4), (1, 4), 6, 30
    elif point_format == 1:
        rec = _build_records_fmt1(points, timestamps, intensities,
                                  return_numbers, number_of_returns, scale,
                                  offset)
        items = [(_LZ_POINT10, 20, 2), (_LZ_GPSTIME11, 8, 2)]
        compressor, version, las_version, fmt, rec_len = 2, (2, 2), (1, 2), 1, 28
    else:
        raise ValueError(f"write_laz: unsupported point_format {point_format}"
                         " (1 or 6)")
    if chunk_counts is not None:
        chunk_size = 0xFFFFFFFF
    vlr_payload = struct.pack("<HHBBHIIqqH", compressor, 0, version[0],
                              version[1], 0, 0, chunk_size, 0, 0, len(items))
    for t, s, v in items:
        vlr_payload += struct.pack("<HHH", t, s, v)
    vlr = struct.pack("<H", 0) + b"laszip encoded".ljust(16, b"\0")
    vlr += struct.pack("<HH", 22204, len(vlr_payload))
    vlr += b"ohm_tpu laszip".ljust(32, b"\0")
    vlr += vlr_payload

    header_size = 375 if las_version >= (1, 4) else 227
    point_offset = header_size + len(vlr)
    header = _las_header(n, fmt | 0x80, rec_len, point_offset, 1, scale,
                         offset, points, version=las_version)
    if n:
        stream, chunk_bytes = native.laz_compress(
            rec, [t for t, _, _ in items], [s for _, s, _ in items],
            chunk_size, layered=(compressor == 3), chunk_counts=chunk_counts)
    else:
        stream, chunk_bytes = b"", []
    table_off = point_offset + 8 + len(stream)
    with open(filename, "wb") as f:
        f.write(bytes(header))
        f.write(vlr)
        f.write(struct.pack("<q", table_off))
        f.write(stream)
        f.write(struct.pack("<II", 0, len(chunk_bytes)))
        if chunk_counts is not None:
            # Record ACTUAL per-chunk counts (the last chunk may be short of
            # its requested count) — third-party readers trust the table.
            actual, left = [], n
            for c in list(chunk_counts)[:len(chunk_bytes)]:
                actual.append(min(int(c), left))
                left -= actual[-1]
            f.write(native.laz_write_chunk_table_variable(actual, chunk_bytes))
        else:
            f.write(native.laz_write_chunk_table(chunk_bytes))
