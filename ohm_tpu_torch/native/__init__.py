"""The rayflow host pass (``batch_prep.cpp``) and the LASzip codec
(``laszip.cpp``) in C++, bound with ctypes.

Both sources are copies of ``ohm_tpu/native``'s.  This loader keeps only
what the port calls: for ``mapping.batch``, the map parameters struct, the
segmented wire's ``count_segments``, ``fill_segments``, ``unique_regions``,
``compact_wire`` and ``lookup_slots``, and the rayflow wire's
``rayflow_build`` and ``rayflow_finish``; for ``io.las``, the ``laz_*``
codec calls; each as in ``ohm_tpu/native/__init__.py``.  Each library
builds on first use with the reference's flags into ``ohm_tpu_torch/_build/``
(ignored by git), and a failed build raises with g++'s errors: the port has
no numpy rayflow wire to fall back to, and no .laz reader without the codec.
``build(force=True)`` and ``build_laz(force=True)`` rebuild them, so a
library built on another machine (``-march=native``) is never loaded by
mistake.
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_HERE = os.path.dirname(__file__)
_SRC = os.path.join(_HERE, "batch_prep.cpp")
_LIB = os.path.join(os.path.dirname(_HERE), "_build", "libbatchprep.so")

_lib = None


class MapParamsStruct(ctypes.Structure):
    _fields_ = [
        ("origin", ctypes.c_double * 3),
        ("region_spatial", ctypes.c_double * 3),
        ("resolution", ctypes.c_double),
        ("region_dim", ctypes.c_int32),
    ]


def _compile(src: str, lib: str, flags: list, force: bool) -> str:
    """g++ ``src`` into the shared library ``lib`` unless it is newer than
    its source; returns its path.  Raises with g++'s errors when it fails."""
    if not force and os.path.exists(lib) and os.path.getmtime(lib) >= os.path.getmtime(src):
        return lib
    os.makedirs(os.path.dirname(lib), exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.tmp"
    proc = subprocess.run(["g++", *flags, "-shared", "-fPIC", src, "-o", tmp],
                          capture_output=True, text=True, timeout=120)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed to build {src} ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, lib)
    return lib


def build(force: bool = False) -> str:
    """Compile the rayflow host pass (see ``_compile``)."""
    # -ffp-contract=off: the endpoint quantisation must round like the f64
    # oracle; a contracted a*b - c flips floor() for points exactly on a
    # voxel boundary.
    return _compile(_SRC, _LIB, ["-O3", "-march=native", "-ffp-contract=off"], force)


def _ptr(arr, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def get_lib():
    """The native library, built on first use (a failed build raises)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        lib.count_segments.restype = ctypes.c_int64
        lib.unique_regions.restype = ctypes.c_int64
        lib.rayflow_build.restype = ctypes.c_int64
        _lib = lib
    return _lib


def available() -> bool:
    """True once the library is loaded (``mapping.batch`` asks before each
    batch); it builds on first use, and a failed build raises."""
    return get_lib() is not None


def count_segments(starts, ends, accept, segment_length):
    lib = get_lib()
    n = len(starts)
    n_seg = np.zeros(n, np.int32)
    total = lib.count_segments(
        _ptr(starts, ctypes.c_double), _ptr(ends, ctypes.c_double),
        _ptr(accept, ctypes.c_uint8), ctypes.c_int64(n),
        ctypes.c_double(segment_length), _ptr(n_seg, ctypes.c_int32))
    return int(total), n_seg

def fill_segments(starts, ends, accept, filter_flags, timestamps, time_base,
                  n_seg, segment_length, sample_in_ray, params: MapParamsStruct,
                  ints, floats, flags, touch, corner_regions, ray_index):
    lib = get_lib()
    lib.fill_segments(
        _ptr(starts, ctypes.c_double), _ptr(ends, ctypes.c_double),
        _ptr(accept, ctypes.c_uint8), _ptr(filter_flags, ctypes.c_uint32),
        _ptr(timestamps, ctypes.c_double) if timestamps is not None else None,
        ctypes.c_double(time_base), ctypes.c_int64(len(starts)),
        _ptr(n_seg, ctypes.c_int32), ctypes.c_double(segment_length),
        ctypes.c_int(1 if sample_in_ray else 0), ctypes.byref(params),
        _ptr(ints, ctypes.c_int32), _ptr(floats, ctypes.c_float),
        _ptr(flags, ctypes.c_uint8), _ptr(touch, ctypes.c_uint32),
        _ptr(corner_regions, ctypes.c_int32), _ptr(ray_index, ctypes.c_int32))

def unique_regions(regions, cap: int = 65536):
    """Deduplicate region triples (C++ hash set); one pass, order of first
    appearance.  Replaces pack_region_key + np.unique on the prep hot path."""
    lib = get_lib()
    flat = np.ascontiguousarray(regions.reshape(-1, 3), dtype=np.int32)
    out = np.empty((cap, 3), np.int32)
    n = lib.unique_regions(_ptr(flat, ctypes.c_int32), ctypes.c_int64(len(flat)),
                           _ptr(out, ctypes.c_int32), ctypes.c_int64(cap))
    if n < 0:
        raise ValueError(f"more than {cap} unique regions in one batch")
    uniq = out[:n]
    # np.unique order (sorted by packed key) — keeps parity with the numpy
    # fallback and deterministic slot assignment; n is small (~regions).
    key = (uniq[:, 0].astype(np.int64) & 0xFFFF
           | (uniq[:, 1].astype(np.int64) & 0xFFFF) << 16
           | (uniq[:, 2].astype(np.int64) & 0xFFFF) << 32)
    return uniq[np.argsort(key)].copy()

def compact_wire(ints, floats, flags, touch, region_dim: int, width: int,
                 with_touch: bool):
    """One-pass packed wire buffer (layout: mapping.batch.pack_wire)."""
    lib = get_lib()
    b = len(ints)
    nbytes = 4 * width * b + 8 * b + (4 * b if with_touch else 0) + 22 * b + 4 * b
    pad = (-nbytes) % 4
    out = np.zeros(nbytes + pad, np.uint8)
    lib.compact_wire(
        _ptr(ints, ctypes.c_int32), _ptr(floats, ctypes.c_float),
        _ptr(flags, ctypes.c_uint8), _ptr(touch, ctypes.c_uint32),
        ctypes.c_int64(b), ctypes.c_int32(region_dim), ctypes.c_int32(width),
        ctypes.c_int(1 if with_touch else 0), _ptr(out, ctypes.c_uint8))
    return out


def rayflow_build(starts, ends, filter_flags, timestamps, time_base,
                  intensities, sample_in_ray, params: MapParamsStruct,
                  rpad: int, region_cap: int = 65536, ray_k: int = 32):
    """Fused single-pass rayflow prep (region DDA + quantisation + wire
    blocks + crossings); see batch_prep.cpp rayflow_build.  Returns a dict of
    numpy arrays carrying all state to rayflow_finish; raises on global
    region-cap overflow.  Per-ray candidate overflow shows as ray_count -1
    (the caller leaves the rayflow wire)."""
    lib = get_lib()
    n = len(starts)
    regions = np.empty((region_cap, 3), np.int32)
    bbox = np.zeros(6, np.int32)
    # No sentinel fill: rayflow_finish reads only the first ray_count[i]
    # entries of each row.
    ray_table = np.empty((max(n, 1), ray_k, 3), np.int32)
    ray_cidx = np.empty((max(n, 1), ray_k), np.uint16)
    ray_count = np.zeros(max(n, 1), np.int32)
    floats = np.zeros((rpad, 7), np.float32)
    abs_i32 = np.zeros((rpad, 6), np.int32)
    meta = np.zeros(rpad, np.uint32)
    touch = np.zeros(rpad, np.uint32)
    intens = np.zeros(rpad, np.float32)
    crossings = np.zeros(rpad, np.int32)
    frac_dict = np.zeros((256, 3), np.float32)
    frac_idx = np.zeros(max(n, 1), np.uint8)
    stats = np.zeros(4, np.int32)
    ts = np.ascontiguousarray(timestamps, np.float64) if timestamps is not None else None
    iv = np.ascontiguousarray(intensities, np.float32) if intensities is not None else None
    n_regions = lib.rayflow_build(
        _ptr(starts, ctypes.c_double), _ptr(ends, ctypes.c_double),
        _ptr(np.ascontiguousarray(filter_flags, np.uint32), ctypes.c_uint32),
        _ptr(ts, ctypes.c_double) if ts is not None else None,
        ctypes.c_double(time_base),
        _ptr(iv, ctypes.c_float) if iv is not None else None,
        ctypes.c_int64(n), ctypes.c_int(1 if sample_in_ray else 0),
        ctypes.byref(params),
        _ptr(regions, ctypes.c_int32), ctypes.c_int64(region_cap),
        _ptr(bbox, ctypes.c_int32),
        _ptr(ray_table, ctypes.c_int32), ctypes.c_int32(ray_k),
        _ptr(ray_count, ctypes.c_int32), _ptr(ray_cidx, ctypes.c_uint16),
        _ptr(floats, ctypes.c_float), _ptr(abs_i32, ctypes.c_int32),
        _ptr(meta, ctypes.c_uint32), _ptr(touch, ctypes.c_uint32),
        _ptr(intens, ctypes.c_float), _ptr(crossings, ctypes.c_int32),
        _ptr(frac_dict, ctypes.c_float), _ptr(frac_idx, ctypes.c_uint8),
        _ptr(stats, ctypes.c_int32))
    if n_regions < 0:
        raise ValueError(f"more than {region_cap} unique regions in one ray batch")
    return {"region_keys": regions[:n_regions].copy(), "bbox": bbox,
            "ray_table": ray_table, "ray_count": ray_count,
            "ray_cidx": ray_cidx, "floats": floats,
            "abs_i32": abs_i32, "meta": meta, "touch": touch, "intens": intens,
            "crossings": crossings, "max_axis": int(stats[0]),
            "max_crossings": int(stats[1]), "max_ray_k": int(stats[2]),
            "frac_dict": frac_dict, "frac_idx": frac_idx,
            "n_frac": int(stats[3])}


def rayflow_finish(prep: dict, n_rays: int, rpad: int, table_k: int,
                   params: MapParamsStruct, table, with_touch: bool,
                   with_intensity: bool, cdict: int = 0,
                   fdict=None, perm=None) -> np.ndarray:
    """Resolve candidate slots against the arena hash table and assemble the
    complete rayflow transfer buffer (one C pass; layout documented on
    batch_prep.cpp rayflow_finish).  ``cdict`` selects the dictionary wire:
    mode 1 = 256-entry packed-candidate dict + u8 indices (K instead of 4K
    B/ray; requires len(region_keys) <= 255), mode 2 = 2048-entry dict + u16
    indices (2K B/ray; <= 2047 regions).  ``fdict`` (optional) is a
    (dict f32[256,3], idx u8[n_rays]) pair dictionary-encoding start_frac
    (12 -> 1 B/ray + a fixed 3 KiB block; mapping.batch.frac_dict_of)."""
    lib = get_lib()
    region_keys = prep["region_keys"]
    cdict = int(cdict)
    cand_bytes = {0: 4 * rpad * table_k,
                  1: 1024 + rpad * table_k,
                  2: 8192 + 2 * rpad * table_k}[cdict]
    float_bytes = 16 if fdict is not None else 28
    frac_bytes = (3072 + rpad) if fdict is not None else 0
    nbytes = 32 + rpad * (float_bytes + 12 + (4 if with_touch else 0)
                          + (4 if with_intensity else 0)) + frac_bytes + cand_bytes
    wire = np.zeros(nbytes, np.uint8)
    ray_k = prep["ray_table"].shape[1]
    lib.rayflow_finish(
        ctypes.c_int64(n_rays), ctypes.c_int64(rpad),
        ctypes.c_int32(ray_k), ctypes.c_int32(table_k),
        _ptr(prep["bbox"], ctypes.c_int32), ctypes.byref(params),
        _ptr(prep["floats"], ctypes.c_float),
        _ptr(prep["abs_i32"], ctypes.c_int32),
        _ptr(prep["meta"], ctypes.c_uint32),
        _ptr(prep["touch"], ctypes.c_uint32),
        _ptr(prep["intens"], ctypes.c_float),
        _ptr(prep["ray_table"], ctypes.c_int32),
        _ptr(prep["ray_count"], ctypes.c_int32),
        _ptr(prep["ray_cidx"], ctypes.c_uint16),
        _ptr(region_keys, ctypes.c_int32), ctypes.c_int64(len(region_keys)),
        _ptr(table.ab, ctypes.c_int32), _ptr(table.z, ctypes.c_int32),
        _ptr(table.slot, ctypes.c_int32), ctypes.c_int32(table.table_size),
        ctypes.c_int(1 if with_touch else 0),
        ctypes.c_int(1 if with_intensity else 0),
        ctypes.c_int(cdict),
        ctypes.c_int(1 if fdict is not None else 0),
        _ptr(fdict[0], ctypes.c_float) if fdict is not None else None,
        _ptr(fdict[1], ctypes.c_uint8) if fdict is not None else None,
        _ptr(np.ascontiguousarray(perm, np.int32), ctypes.c_int32)
        if perm is not None else None,
        _ptr(wire, ctypes.c_uint8))
    return wire


def lookup_slots(regions, table):
    """Vectorised region -> slot resolution via the host table (C++)."""
    lib = get_lib()
    regions = np.ascontiguousarray(regions, dtype=np.int32)
    flat = regions.reshape(-1, 3)
    out = np.empty(len(flat), np.int32)
    lib.lookup_slots(
        _ptr(flat, ctypes.c_int32), ctypes.c_int64(len(flat)),
        _ptr(table.ab, ctypes.c_int32), _ptr(table.z, ctypes.c_int32),
        _ptr(table.slot, ctypes.c_int32), ctypes.c_int32(table.table_size),
        _ptr(out, ctypes.c_int32))
    return out.reshape(regions.shape[:-1])


# --------------------------------------------------------------------------- #
# LASzip (.laz) point codec: laszip.cpp, a copy of ohm_tpu/native/laszip.cpp,
# built as its own library into ohm_tpu_torch/_build/.  The entries below
# get_laz_lib are copies of the reference's.

_LAZ_SRC = os.path.join(_HERE, "laszip.cpp")
_LAZ_LIB = os.path.join(os.path.dirname(_HERE), "_build", "libohmlaz.so")
_laz_lib = None


def build_laz(force: bool = False) -> str:
    """Compile the LASzip codec (see ``_compile``)."""
    return _compile(_LAZ_SRC, _LAZ_LIB, ["-O2"], force)


def get_laz_lib():
    """The LASzip codec library, built on first use (a failed build raises)."""
    global _laz_lib
    if _laz_lib is None:
        lib = ctypes.CDLL(build_laz())
        for fn in ("laszip_decompress", "laszip_compress",
                   "laszip_decompress_layered", "laszip_compress_layered",
                   "laszip_read_chunk_table", "laszip_write_chunk_table",
                   "laszip_read_chunk_table_variable",
                   "laszip_write_chunk_table_variable"):
            getattr(lib, fn).restype = ctypes.c_int64
        _laz_lib = lib
    return _laz_lib


def laz_decompress(stream: np.ndarray, item_types, item_sizes, n_points: int,
                   chunk_size: int, chunk_starts, layered: bool = False,
                   chunk_counts=None) -> np.ndarray:
    """Decompress a LASzip point stream into raw point records
    (u8[n_points, point_size]).  ``chunk_starts`` are byte offsets of each
    chunk within ``stream``; ``layered`` selects the compressor-3 framing
    (LAS 1.4 point formats 6+).  ``chunk_counts`` gives per-chunk point
    counts for variable-chunked streams (chunk_size == 0xFFFFFFFF)."""
    lib = get_laz_lib()
    if lib is None:
        raise RuntimeError("LASzip codec unavailable (no C++ compiler)")
    types = np.ascontiguousarray(item_types, np.int32)
    sizes = np.ascontiguousarray(item_sizes, np.int32)
    starts = np.ascontiguousarray(chunk_starts, np.int64)
    point_size = int(sizes.sum())
    stream = np.ascontiguousarray(stream, np.uint8)
    out = np.zeros(n_points * point_size, np.uint8)
    if chunk_counts is not None:
        chunk_counts = np.ascontiguousarray(chunk_counts, np.int64)
        counts_ptr = _ptr(chunk_counts, ctypes.c_int64)
    else:
        counts_ptr = None
    fn = lib.laszip_decompress_layered if layered else lib.laszip_decompress
    rc = fn(
        _ptr(stream, ctypes.c_uint8), ctypes.c_int64(stream.size),
        _ptr(types, ctypes.c_int32), _ptr(sizes, ctypes.c_int32),
        ctypes.c_int32(len(types)), ctypes.c_int64(n_points),
        ctypes.c_uint32(chunk_size & 0xFFFFFFFF),
        _ptr(starts, ctypes.c_int64), ctypes.c_int32(len(starts)),
        counts_ptr, _ptr(out, ctypes.c_uint8))
    if rc != 0:
        raise ValueError(f"LASzip decompression failed (code {rc})")
    return out.reshape(n_points, point_size)


def laz_compress(records: np.ndarray, item_types, item_sizes,
                 chunk_size: int = 50000, layered: bool = False,
                 chunk_counts=None):
    """Compress raw point records (u8[n_points, point_size]) into a LASzip
    stream (``layered`` = compressor-3 framing for LAS 1.4 formats 6+).
    ``chunk_counts`` selects VARIABLE chunking with the given per-chunk
    point counts (pass chunk_size=0xFFFFFFFF in the VLR in that case).
    Returns (stream bytes, chunk byte lengths)."""
    lib = get_laz_lib()
    if lib is None:
        raise RuntimeError("LASzip codec unavailable (no C++ compiler)")
    records = np.ascontiguousarray(records, np.uint8)
    n_points, point_size = records.shape
    types = np.ascontiguousarray(item_types, np.int32)
    sizes = np.ascontiguousarray(item_sizes, np.int32)
    assert int(sizes.sum()) == point_size
    if chunk_counts is not None:
        chunk_counts = np.ascontiguousarray(chunk_counts, np.int64)
        assert int(chunk_counts.sum()) >= n_points, "chunk counts must cover all points"
        counts_ptr = _ptr(chunk_counts, ctypes.c_int64)
        n_chunk_cap = len(chunk_counts)
    else:
        counts_ptr = None
        eff_chunk = n_points if chunk_size == 0xFFFFFFFF else chunk_size
        n_chunk_cap = max(1, -(-n_points // max(eff_chunk, 1)))
    chunk_bytes = np.zeros(n_chunk_cap, np.int64)
    n_chunks = np.zeros(1, np.int32)
    cap = records.size + 4096 + 64 * n_chunk_cap
    fn = lib.laszip_compress_layered if layered else lib.laszip_compress
    while True:
        out = np.zeros(cap, np.uint8)
        total = fn(
            _ptr(records, ctypes.c_uint8), ctypes.c_int64(n_points),
            _ptr(types, ctypes.c_int32), _ptr(sizes, ctypes.c_int32),
            ctypes.c_int32(len(types)), ctypes.c_uint32(chunk_size & 0xFFFFFFFF),
            counts_ptr, _ptr(out, ctypes.c_uint8), ctypes.c_int64(cap),
            _ptr(chunk_bytes, ctypes.c_int64), _ptr(n_chunks, ctypes.c_int32))
        if total == -1:  # incompressible input: retry with a larger buffer
            cap *= 2
            continue
        if total < 0:
            raise ValueError(f"LASzip compression failed (code {total})")
        return bytes(out[:total]), chunk_bytes[: int(n_chunks[0])].tolist()


def laz_read_chunk_table(payload: np.ndarray, n_chunks: int) -> np.ndarray:
    """Decode the arithmetic-coded chunk-size list (after the u32 version /
    u32 count words of the chunk table)."""
    lib = get_laz_lib()
    payload = np.ascontiguousarray(payload, np.uint8)
    out = np.zeros(n_chunks, np.int64)
    rc = lib.laszip_read_chunk_table(
        _ptr(payload, ctypes.c_uint8), ctypes.c_int64(payload.size),
        ctypes.c_int32(n_chunks), _ptr(out, ctypes.c_int64))
    if rc != 0:
        raise ValueError(f"LASzip chunk table decode failed (code {rc})")
    return out


def laz_write_chunk_table(chunk_bytes) -> bytes:
    lib = get_laz_lib()
    arr = np.ascontiguousarray(chunk_bytes, np.int64)
    cap = 16 + 8 * max(len(arr), 1)
    out = np.zeros(cap, np.uint8)
    n = lib.laszip_write_chunk_table(
        _ptr(arr, ctypes.c_int64), ctypes.c_int32(len(arr)),
        _ptr(out, ctypes.c_uint8), ctypes.c_int64(cap))
    if n < 0:
        raise ValueError("LASzip chunk table encode overflow")
    return bytes(out[:n])


def laz_read_chunk_table_variable(payload: np.ndarray, n_chunks: int):
    """Decode a VARIABLE chunk table payload (chunk_size == 0xFFFFFFFF):
    per-chunk (point count, byte size) pairs.  Returns (counts, bytes)."""
    lib = get_laz_lib()
    payload = np.ascontiguousarray(payload, np.uint8)
    counts = np.zeros(n_chunks, np.int64)
    nbytes = np.zeros(n_chunks, np.int64)
    rc = lib.laszip_read_chunk_table_variable(
        _ptr(payload, ctypes.c_uint8), ctypes.c_int64(payload.size),
        ctypes.c_int32(n_chunks), _ptr(counts, ctypes.c_int64),
        _ptr(nbytes, ctypes.c_int64))
    if rc != 0:
        raise ValueError(f"LASzip variable chunk table decode failed (code {rc})")
    return counts, nbytes


def laz_write_chunk_table_variable(chunk_counts, chunk_bytes) -> bytes:
    lib = get_laz_lib()
    counts = np.ascontiguousarray(chunk_counts, np.int64)
    arr = np.ascontiguousarray(chunk_bytes, np.int64)
    assert len(counts) == len(arr)
    cap = 16 + 16 * max(len(arr), 1)
    out = np.zeros(cap, np.uint8)
    n = lib.laszip_write_chunk_table_variable(
        _ptr(counts, ctypes.c_int64), _ptr(arr, ctypes.c_int64),
        ctypes.c_int32(len(arr)), _ptr(out, ctypes.c_uint8),
        ctypes.c_int64(cap))
    if n < 0:
        raise ValueError("LASzip variable chunk table encode overflow")
    return bytes(out[:n])
