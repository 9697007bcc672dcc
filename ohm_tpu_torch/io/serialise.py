"""Byte-compatible .ohm map serialisation.

Reference parity: ohm/MapSerialise.cpp, ohm/Stream.cpp, ohm/serialise/*.

Format (v0.5.0, marker 0x44330011; ohm/MapSerialise.cpp:83-95,288-327):
  [raw little-endian header]
    u32 marker, u32 major, u16 minor, u16 patch
    3 x f64 origin, 3 x f64 region spatial dims, 3 x i32 region voxel dims
    f64 resolution, f64 occupancy threshold value, f64 hit value, f64 miss value
    u32 chunk count
    f64 first ray time (v0.5+), u64 map stamp (v0.3+), u32 map flags (v0.3.2+)
  [raw] u32 MapInfo item count
  [single zlib deflate stream for everything below — ohm/Stream.cpp]
    MapInfo items (u16 name len, name, u8 type, value; ohm/MapSerialise.cpp:96-245)
    layout (i32 layer count; per layer: u32+name, u32 flags, u16 subsampling,
            u32 voxel bytes, u32 member count; per member: u32+name, u16 type,
            u16 offset, u64 clear pattern; ohm/MapSerialise.cpp saveLayout)
    per chunk: 3 x i32 region coord, 3 x f64 centre, f64 touched time;
               per non-skipped layer: u64 touched stamp (v0.4+), raw voxel bytes

Versioned loading keeps old maps readable (v0 and v0.1 .. v0.5; 0.3.x is
explicitly unsupported, matching the reference).  Byte-exactness of voxel
payloads is guaranteed by the packed structured dtypes in core.layout.
"""

from __future__ import annotations

import dataclasses
import struct
import zlib
from enum import IntEnum
from typing import Optional

import numpy as np

from ohm_tpu_torch.core.layout import DataType, MapLayout, MapLayer
from ohm_tpu_torch.core.map import OccupancyMap, MapFlag, MapChunk

MAP_HEADER_MARKER = 0x44330011
CURRENT_VERSION = (0, 5, 0)
SUPPORTED_MIN = (0, 1, 0)
SUPPORTED_MAX = (0, 5, 0)


class SerialisationError(RuntimeError):
    pass


class MapValueType(IntEnum):
    """MapInfo value types (reference: ohm/MapInfo.h:38-53)."""

    NONE = 0
    INT8 = 1
    UINT8 = 2
    INT16 = 3
    UINT16 = 4
    INT32 = 5
    UINT32 = 6
    INT64 = 7
    UINT64 = 8
    FLOAT32 = 9
    FLOAT64 = 10
    BOOLEAN = 11
    STRING = 12


_VALUE_STRUCT = {
    MapValueType.INT8: "<b",
    MapValueType.UINT8: "<B",
    MapValueType.INT16: "<h",
    MapValueType.UINT16: "<H",
    MapValueType.INT32: "<i",
    MapValueType.UINT32: "<I",
    MapValueType.INT64: "<q",
    MapValueType.UINT64: "<Q",
    MapValueType.FLOAT32: "<f",
    MapValueType.FLOAT64: "<d",
}


@dataclasses.dataclass
class MapValue:
    """A typed MapInfo entry (reference: ohm/MapInfo.h MapValue)."""

    name: str
    type: MapValueType
    value: object

    @staticmethod
    def infer(name: str, value) -> "MapValue":
        if isinstance(value, MapValue):
            return value
        if isinstance(value, bool):
            return MapValue(name, MapValueType.BOOLEAN, value)
        if isinstance(value, (int, np.integer)):
            return MapValue(name, MapValueType.INT64, int(value))
        if isinstance(value, (float, np.floating)):
            return MapValue(name, MapValueType.FLOAT64, float(value))
        if isinstance(value, str):
            return MapValue(name, MapValueType.STRING, value)
        raise SerialisationError(f"unsupported MapInfo value for {name!r}: {type(value)}")


# --------------------------------------------------------------------------- #
# Streams: raw section followed by one zlib deflate stream (ohm/Stream.cpp).


class _OutStream:
    def __init__(self, fileobj, compress: bool = True):
        self.f = fileobj
        self.compressor = zlib.compressobj() if compress else None

    def write_raw(self, data: bytes):
        self.f.write(data)

    def write(self, data: bytes):
        if self.compressor is None:
            self.f.write(data)
        else:
            out = self.compressor.compress(data)
            if out:
                self.f.write(out)

    def close(self):
        if self.compressor is not None:
            self.f.write(self.compressor.flush())
            self.compressor = None


class _InStream:
    def __init__(self, fileobj, compress: bool = True):
        self.f = fileobj
        self.decompressor = zlib.decompressobj() if compress else None
        self.buffer = b""

    def read_raw(self, n: int) -> bytes:
        data = self.f.read(n)
        if len(data) != n:
            raise SerialisationError("unexpected end of file (raw section)")
        return data

    def read(self, n: int) -> bytes:
        if self.decompressor is None:
            return self.read_raw(n)
        while len(self.buffer) < n:
            chunk = self.f.read(64 * 1024)
            if not chunk:
                self.buffer += self.decompressor.flush()
                if len(self.buffer) < n:
                    raise SerialisationError("unexpected end of compressed stream")
                break
            self.buffer += self.decompressor.decompress(chunk)
        out, self.buffer = self.buffer[:n], self.buffer[n:]
        return out


def _w(stream, fmt, *values, raw=False):
    data = struct.pack(fmt, *values)
    (stream.write_raw if raw else stream.write)(data)


def _r(stream, fmt, raw=False):
    size = struct.calcsize(fmt)
    data = stream.read_raw(size) if raw else stream.read(size)
    out = struct.unpack(fmt, data)
    return out[0] if len(out) == 1 else out


# --------------------------------------------------------------------------- #
# MapInfo


def _save_map_info(stream: _OutStream, info: dict):
    # Item count is written raw (before the deflate stream starts) —
    # quirk preserved from the reference (saveMapInfo uses writeUncompressed
    # for the count, compressed writes for the items).
    _w(stream, "<I", len(info), raw=True)
    for name, value in info.items():
        mv = MapValue.infer(name, value)
        nb = mv.name.encode("utf-8")
        _w(stream, "<H", len(nb))
        stream.write(nb)
        _w(stream, "<B", int(mv.type))
        if mv.type == MapValueType.BOOLEAN:
            _w(stream, "<B", 1 if mv.value else 0)
        elif mv.type == MapValueType.STRING:
            sb = str(mv.value).encode("utf-8")
            _w(stream, "<H", len(sb))
            stream.write(sb)
        else:
            _w(stream, _VALUE_STRUCT[mv.type], mv.value)


def _load_map_info(stream: _InStream) -> dict:
    count = _r(stream, "<I", raw=True)
    info = {}
    for _ in range(count):
        name_len = _r(stream, "<H")
        name = stream.read(name_len).decode("utf-8", "replace")
        vtype = MapValueType(_r(stream, "<B"))
        if vtype == MapValueType.BOOLEAN:
            value = bool(_r(stream, "<B"))
        elif vtype == MapValueType.STRING:
            slen = _r(stream, "<H")
            value = stream.read(slen).decode("utf-8", "replace")
        elif vtype == MapValueType.NONE:
            value = None
        else:
            value = _r(stream, _VALUE_STRUCT[vtype])
        info[name] = MapValue(name, vtype, value)
    return info


# --------------------------------------------------------------------------- #
# Layout


def _save_layout(stream: _OutStream, layout: MapLayout):
    _w(stream, "<i", len(layout))
    for layer in layout:
        nb = layer.name.encode("utf-8")
        _w(stream, "<I", len(nb))
        stream.write(nb)
        _w(stream, "<I", layer.flags)
        _w(stream, "<H", layer.subsampling)
        _w(stream, "<I", layer.voxel_byte_size())
        _w(stream, "<I", len(layer.voxel_layout.members))
        for member in layer.voxel_layout.members:
            mb = member.name.encode("utf-8")
            _w(stream, "<I", len(mb))
            stream.write(mb)
            _w(stream, "<H", int(member.type))
            _w(stream, "<H", member.offset)
            _w(stream, "<Q", member.clear_value & 0xFFFFFFFFFFFFFFFF)


def _load_layout(stream: _InStream) -> MapLayout:
    layout = MapLayout()
    layer_count = _r(stream, "<i")
    for _ in range(layer_count):
        name = stream.read(_r(stream, "<I")).decode("utf-8", "replace")
        flags = _r(stream, "<I")
        subsampling = _r(stream, "<H")
        layer = layout.add_layer(name, subsampling=subsampling)
        layer.flags = flags
        _voxel_bytes = _r(stream, "<I")
        member_count = _r(stream, "<I")
        for j in range(member_count):
            mname = stream.read(_r(stream, "<I")).decode("utf-8", "replace")
            mtype = _r(stream, "<H")
            moffset = _r(stream, "<H")
            clear = _r(stream, "<Q")
            member = layer.voxel_layout.add_member(mname, DataType(mtype), clear)
            if member.offset != moffset:
                raise SerialisationError(
                    f"member offset mismatch for {name}.{mname}: {member.offset} != {moffset}"
                )
        if layer.voxel_byte_size() != _voxel_bytes:
            raise SerialisationError(
                f"voxel byte size mismatch for layer {name}: {layer.voxel_byte_size()} != {_voxel_bytes}"
            )
    return layout


# --------------------------------------------------------------------------- #
# Chunks


def _save_chunk(stream: _OutStream, chunk: MapChunk, map_obj: OccupancyMap):
    _w(stream, "<3i", *chunk.region_key)
    _w(stream, "<3d", *chunk.centre)
    _w(stream, "<d", chunk.touched_time)
    for i, layer in enumerate(map_obj.layout):
        if layer.flags & MapLayer.SKIP_SERIALISE:
            continue
        _w(stream, "<Q", int(chunk.touched_stamps[i]))
        stream.write(chunk.layers[i].tobytes())


def _load_chunk(stream: _InStream, map_obj: OccupancyMap, with_stamps: bool) -> MapChunk:
    coord = _r(stream, "<3i")
    centre = _r(stream, "<3d")
    touched_time = _r(stream, "<d")
    chunk = MapChunk(coord, centre, map_obj.layout, map_obj.region_voxel_dims)
    chunk.touched_time = touched_time
    for i, layer in enumerate(map_obj.layout):
        if layer.flags & MapLayer.SKIP_SERIALISE:
            continue
        if with_stamps:
            chunk.touched_stamps[i] = _r(stream, "<Q")
        nbytes = layer.volume(map_obj.region_voxel_dims) * layer.voxel_byte_size()
        data = stream.read(nbytes)
        chunk.layers[i] = np.frombuffer(data, dtype=layer.voxel_layout.numpy_dtype()).copy()
    return chunk


# --------------------------------------------------------------------------- #
# Public API


def save(filename: str, map_obj: OccupancyMap, progress=None):
    """Write a v0.5.0 .ohm file (reference: ohm/MapSerialise.cpp save)."""
    with open(filename, "wb") as f:
        stream = _OutStream(f, compress=True)
        _w(stream, "<IIHH", MAP_HEADER_MARKER, *CURRENT_VERSION, raw=True)
        _w(stream, "<3d", *map_obj.origin, raw=True)
        _w(stream, "<3d", *map_obj.region_spatial_dims, raw=True)
        _w(stream, "<3i", *map_obj.region_voxel_dims, raw=True)
        _w(stream, "<d", map_obj.resolution, raw=True)
        _w(stream, "<d", map_obj.occupancy_threshold_value, raw=True)
        _w(stream, "<d", map_obj.hit_value, raw=True)
        _w(stream, "<d", map_obj.miss_value, raw=True)
        _w(stream, "<I", len(map_obj.chunks), raw=True)
        _w(stream, "<d", map_obj.first_ray_time, raw=True)
        _w(stream, "<Q", map_obj.stamp, raw=True)
        _w(stream, "<I", int(map_obj.flags), raw=True)

        _save_map_info(stream, map_obj.info)
        _save_layout(stream, map_obj.layout)
        if progress:
            progress.set_target(len(map_obj.chunks))
        for chunk in map_obj.chunks.values():
            _save_chunk(stream, chunk, map_obj)
            if progress:
                progress.increment()
        stream.close()


def _read_header(stream: _InStream):
    marker, major = _r(stream, "<II", raw=True)
    if marker != MAP_HEADER_MARKER:
        # Version 0 files carry no marker: those 8 bytes are origin.x
        # (reference: ohm/MapSerialise.cpp loadHeader migration path).
        import struct as _struct

        origin_x = _struct.unpack("<d", _struct.pack("<II", marker, major))[0]
        header = {}
        header["origin"] = np.array([origin_x, *_r(stream, "<2d", raw=True)])
        header["region_spatial"] = np.array(_r(stream, "<3d", raw=True))
        header["region_voxel_dims"] = np.array(_r(stream, "<3i", raw=True), dtype=np.int32)
        header["resolution"] = _r(stream, "<d", raw=True)
        header["occupancy_threshold_value"] = _r(stream, "<d", raw=True)
        header["hit_value"] = _r(stream, "<d", raw=True)
        header["miss_value"] = _r(stream, "<d", raw=True)
        header["region_count"] = _r(stream, "<I", raw=True)
        header["first_ray_time"] = -1.0
        header["stamp"] = 0
        header["flags"] = 0
        return (0, 0, 0), header
    minor, patch = _r(stream, "<HH", raw=True)
    version = (major, minor, patch)
    if not (SUPPORTED_MIN <= version <= SUPPORTED_MAX):
        raise SerialisationError(f"unsupported .ohm version {version}")
    if version[0] == 0 and version[1] == 3:
        # 0.3.x used a deprecated progressive sub-voxel encoding
        # (ohm/MapSerialise.cpp:95).
        raise SerialisationError("deprecated .ohm version 0.3.x is not supported")

    header = {}
    header["origin"] = np.array(_r(stream, "<3d", raw=True))
    header["region_spatial"] = np.array(_r(stream, "<3d", raw=True))
    header["region_voxel_dims"] = np.array(_r(stream, "<3i", raw=True), dtype=np.int32)
    header["resolution"] = _r(stream, "<d", raw=True)
    header["occupancy_threshold_value"] = _r(stream, "<d", raw=True)
    header["hit_value"] = _r(stream, "<d", raw=True)
    header["miss_value"] = _r(stream, "<d", raw=True)
    header["region_count"] = _r(stream, "<I", raw=True)
    header["first_ray_time"] = _r(stream, "<d", raw=True) if version >= (0, 5, 0) else -1.0
    header["stamp"] = _r(stream, "<Q", raw=True) if version >= (0, 3, 0) else 0
    header["flags"] = _r(stream, "<I", raw=True) if version >= (0, 3, 2) else 0
    return version, header


def _build_map(header) -> OccupancyMap:
    m = OccupancyMap(
        resolution=header["resolution"],
        region_voxel_dims=tuple(header["region_voxel_dims"]),
        flags=MapFlag(header["flags"]),
        layout=MapLayout(),  # replaced by the serialised layout
        origin=header["origin"],
    )
    m.layout = MapLayout()  # drop auto-added layers; file layout is authoritative
    m.occupancy_threshold_value = header["occupancy_threshold_value"]
    m.hit_value = header["hit_value"]
    m.miss_value = header["miss_value"]
    m.first_ray_time = header["first_ray_time"]
    m.stamp = header["stamp"]
    return m


def load(filename: str, progress=None) -> tuple[OccupancyMap, tuple]:
    """Load a .ohm file (v0.1 - v0.5). Returns (map, version)."""
    with open(filename, "rb") as f:
        stream = _InStream(f, compress=True)
        version, header = _read_header(stream)
        m = _build_map(header)

        if version == (0, 0, 0):
            return _load_v0_body(stream, m, header, progress), version
        if version >= (0, 2, 0):
            info = _load_map_info(stream)
            m.info = info
        m.layout = _load_layout(stream)

        with_stamps = version >= (0, 4, 0)
        if progress:
            progress.set_target(header["region_count"])
        for _ in range(header["region_count"]):
            chunk = _load_chunk(stream, m, with_stamps)
            m.chunks[chunk.region_key] = chunk
            if progress:
                progress.increment()
        return m, version


def _load_v0_body(stream: _InStream, m: OccupancyMap, header, progress):
    """Version-zero chunks: interleaved occupancy/clearance float pairs
    (reference: ohm/serialise/MapSerialiseV0.cpp loadChunk)."""
    m.layout.add_occupancy()
    m.layout.add_clearance()
    volume = int(np.prod(m.region_voxel_dims))
    occ_dtype = m.layout.layers[0].voxel_layout.numpy_dtype()
    clear_dtype = m.layout.layers[1].voxel_layout.numpy_dtype()
    for _ in range(header["region_count"]):
        coord = _r(stream, "<3i")
        centre = _r(stream, "<3d")
        touched_time = _r(stream, "<d")
        chunk = MapChunk(coord, centre, m.layout, m.region_voxel_dims)
        chunk.touched_time = touched_time
        data = np.frombuffer(stream.read(volume * 8), dtype=np.float32).reshape(-1, 2)
        occ = np.zeros(volume, dtype=occ_dtype)
        occ["occupancy"] = data[:, 0]
        clear = np.zeros(volume, dtype=clear_dtype)
        clear["clearance"] = data[:, 1]
        chunk.layers[0] = occ
        chunk.layers[1] = clear
        m.chunks[chunk.region_key] = chunk
        if progress:
            progress.increment()
    return m


def load_header(filename: str) -> tuple[dict, tuple, Optional[MapLayout], dict]:
    """Read header + MapInfo + layout only (reference: ohm/MapSerialise.cpp loadHeader).

    Returns (header dict, version, layout, info).
    """
    with open(filename, "rb") as f:
        stream = _InStream(f, compress=True)
        version, header = _read_header(stream)
        info = _load_map_info(stream) if version >= (0, 2, 0) else {}
        if version == (0, 0, 0):
            # v0 files carry no layout section (the chunk payload follows the
            # header directly); synthesise the fixed occupancy+clearance
            # layout, as the reference loadHeader does
            # (ohm/MapSerialise.cpp:744-752).
            layout = MapLayout()
            layout.add_occupancy()
            layout.add_clearance()
        else:
            layout = _load_layout(stream)
        return header, version, layout, info
