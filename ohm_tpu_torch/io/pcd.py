"""PCD (Point Cloud Library) point-cloud codec, from scratch.

The reference reads PCD (among many formats) through PDAL
(its slamio/PointCloudReaderPdal.cpp); this module implements the
PCD v0.7 container natively so slamio keeps PDAL-breadth ingestion without
external dependencies.  Supports DATA ascii, binary and binary_compressed
(LZF, per-field SoA layout as written by pcl::io::savePCDFileBinaryCompressed).

Writer notes: ascii and binary are byte-faithful PCL-compatible files;
binary_compressed output uses LZF with a greedy 3-byte-hash matcher (the
same scheme libLZF uses), decodable by PCL.
"""

from __future__ import annotations

import numpy as np

_TYPE_MAP = {
    ("F", 4): "<f4", ("F", 8): "<f8",
    ("I", 1): "<i1", ("I", 2): "<i2", ("I", 4): "<i4", ("I", 8): "<i8",
    ("U", 1): "<u1", ("U", 2): "<u2", ("U", 4): "<u4", ("U", 8): "<u8",
}


def lzf_decompress(data: bytes, expected_size: int) -> bytes:
    """LZF decompression (libLZF stream format, as used by PCL)."""
    out = bytearray(expected_size)
    i, o, n = 0, 0, len(data)
    while i < n:
        ctrl = data[i]
        i += 1
        if ctrl < 32:  # literal run of ctrl+1 bytes
            run = ctrl + 1
            out[o:o + run] = data[i:i + run]
            i += run
            o += run
        else:  # back reference
            length = ctrl >> 5
            if length == 7:
                length += data[i]
                i += 1
            ref = o - ((ctrl & 0x1F) << 8) - data[i] - 1
            i += 1
            length += 2
            if ref < 0:
                raise ValueError("corrupt LZF stream (reference before start)")
            for _ in range(length):  # may self-overlap; copy bytewise
                out[o] = out[ref]
                o += 1
                ref += 1
    if o != expected_size:
        raise ValueError(f"LZF stream decompressed to {o}, expected {expected_size}")
    return bytes(out)


def lzf_compress(data: bytes) -> bytes:
    """Greedy LZF compression (3-byte hash chains, libLZF-compatible output)."""
    n = len(data)
    out = bytearray()
    lit_start = 0  # start of the pending literal run

    def flush_literals(end):
        s = lit_start
        while s < end:
            run = min(32, end - s)
            out.append(run - 1)
            out.extend(data[s:s + run])
            s += run

    htab = {}
    i = 0
    while i < n - 2:
        key = data[i:i + 3]
        ref = htab.get(key, -1)
        htab[key] = i
        off = i - ref - 1
        if ref >= 0 and 0 <= off < 8192 and data[ref:ref + 3] == key:
            # extend the match (LZF max length = 2 + 7 + 255 = 264)
            length = 3
            maxlen = min(264, n - i)
            while length < maxlen and data[ref + length] == data[i + length]:
                length += 1
            flush_literals(i)
            enc = length - 2
            if enc < 7:
                out.append((enc << 5) | (off >> 8))
            else:
                out.append((7 << 5) | (off >> 8))
                out.append(enc - 7)
            out.append(off & 0xFF)
            i += length
            lit_start = i
        else:
            i += 1
    flush_literals(n)
    return bytes(out)


def _parse_header(f):
    header = {}
    while True:
        line = f.readline()
        if not line:
            raise ValueError("truncated PCD header")
        text = line.decode("ascii", "replace").strip()
        if not text or text.startswith("#"):
            continue
        parts = text.split()
        header[parts[0].upper()] = parts[1:]
        if parts[0].upper() == "DATA":
            return header


def _header_fields(header):
    """Per-FIELD descriptors [(base_name, fmt, count)] — COUNT grouping is
    needed by the binary_compressed reader (a field's count values are
    interleaved per point within that field's SoA chunk)."""
    fields = header["FIELDS"]
    sizes = [int(s) for s in header["SIZE"]]
    types = header["TYPE"]
    counts = [int(c) for c in header.get("COUNT", ["1"] * len(fields))]
    out = []
    for j, (name, size, typ, count) in enumerate(zip(fields, sizes, types, counts)):
        fmt = _TYPE_MAP.get((typ.upper(), size))
        if fmt is None:
            raise ValueError(f"unsupported PCD field type {typ}{size}")
        out.append((f"_pad{j}" if name == "_" else name, fmt, count))
    return out


def _header_dtype(header):
    names, formats = [], []
    for name, fmt, count in _header_fields(header):
        for c in range(count):
            names.append(name if count == 1 else f"{name}_{c}")
            formats.append(fmt)
    return np.dtype({"names": names, "formats": formats})


def read_pcd(filename: str) -> dict:
    """Read a PCD file -> slamio cloud dict ('points', optional 'timestamps',
    'intensities', 'normals', plus every raw field under 'fields')."""
    with open(filename, "rb") as f:
        header = _parse_header(f)
        dtype = _header_dtype(header)
        npoints = int(header["POINTS"][0]) if "POINTS" in header else (
            int(header["WIDTH"][0]) * int(header.get("HEIGHT", ["1"])[0]))
        mode = header["DATA"][0].lower()
        if mode == "ascii":
            rows = np.loadtxt(f, dtype=np.float64, ndmin=2, max_rows=npoints)
            rec = np.zeros(npoints, dtype)
            for j, nm in enumerate(dtype.names):
                if j < rows.shape[1]:
                    rec[nm] = rows[:, j].astype(dtype[nm])
        elif mode == "binary":
            rec = np.frombuffer(f.read(npoints * dtype.itemsize),
                                dtype=dtype, count=npoints)
        elif mode == "binary_compressed":
            csize, usize = np.frombuffer(f.read(8), "<u4")
            raw = lzf_decompress(f.read(int(csize)), int(usize))
            # SoA per FIELD: each field's chunk holds its COUNT values
            # interleaved per point ([p0c0 p0c1 ... p1c0 ...]).
            rec = np.zeros(npoints, dtype)
            off = 0
            for nm, fmt, count in _header_fields(header):
                w = np.dtype(fmt).itemsize
                chunk = np.frombuffer(raw[off:off + w * count * npoints], fmt)
                off += w * count * npoints
                if count == 1:
                    rec[nm] = chunk
                else:
                    chunk = chunk.reshape(npoints, count)
                    for c in range(count):
                        rec[f"{nm}_{c}"] = chunk[:, c]
        else:
            raise ValueError(f"unsupported PCD DATA mode {mode!r}")

    out = {"fields": {nm: np.asarray(rec[nm]) for nm in dtype.names}}
    if all(k in dtype.names for k in ("x", "y", "z")):
        pts = np.column_stack([rec["x"], rec["y"], rec["z"]]).astype(np.float64)
        finite = np.isfinite(pts).all(axis=1)  # PCL stores invalid points as NaN
        out["points"] = pts[finite]
        for tname in ("time", "timestamp", "t", "gps_time"):
            if tname in dtype.names:
                out["timestamps"] = np.asarray(rec[tname], np.float64)[finite]
                break
        if "intensity" in dtype.names:
            out["intensities"] = np.asarray(rec["intensity"], np.float32)[finite]
        if all(k in dtype.names for k in ("normal_x", "normal_y", "normal_z")):
            out["normals"] = np.column_stack(
                [rec["normal_x"], rec["normal_y"], rec["normal_z"]]
            ).astype(np.float32)[finite]
    return out


def write_pcd(filename: str, fields: dict, mode: str = "binary") -> None:
    """Write a PCD v0.7 file from {name: 1-D array} columns (equal length)."""
    names = list(fields)
    cols = [np.asarray(fields[n]) for n in names]
    npoints = len(cols[0]) if cols else 0
    sizes, types = [], []
    for c in cols:
        if c.dtype.kind == "f":
            types.append("F")
        elif c.dtype.kind == "i":
            types.append("I")
        elif c.dtype.kind == "u":
            types.append("U")
        else:
            raise ValueError(f"unsupported dtype {c.dtype}")
        sizes.append(str(c.dtype.itemsize))
    header = (
        "# .PCD v0.7 - Point Cloud Data file format\n"
        "VERSION 0.7\n"
        f"FIELDS {' '.join(names)}\n"
        f"SIZE {' '.join(sizes)}\n"
        f"TYPE {' '.join(types)}\n"
        f"COUNT {' '.join(['1'] * len(names))}\n"
        f"WIDTH {npoints}\nHEIGHT 1\nVIEWPOINT 0 0 0 1 0 0 0\n"
        f"POINTS {npoints}\nDATA {mode}\n"
    )
    with open(filename, "wb") as f:
        f.write(header.encode("ascii"))
        if mode == "ascii":
            for i in range(npoints):
                f.write(" ".join(repr(c[i].item()) for c in cols).encode("ascii"))
                f.write(b"\n")
        elif mode == "binary":
            rec = np.zeros(npoints, np.dtype({
                "names": names,
                "formats": [c.dtype.newbyteorder("<") for c in cols]}))
            for n, c in zip(names, cols):
                rec[n] = c
            f.write(rec.tobytes())
        elif mode == "binary_compressed":
            raw = b"".join(np.ascontiguousarray(
                c.astype(c.dtype.newbyteorder("<"))).tobytes() for c in cols)
            comp = lzf_compress(raw)
            f.write(np.asarray([len(comp), len(raw)], "<u4").tobytes())
            f.write(comp)
        else:
            raise ValueError(f"unsupported PCD DATA mode {mode!r}")
