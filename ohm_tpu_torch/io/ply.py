"""PLY point cloud / mesh IO.

Reference parity: ohmutil/PlyMesh, ohmutil/PlyPointStream (export) and the
slamio miniply/rply readers (import).  Binary little-endian PLY, plus ASCII
reading for robustness.
"""

from __future__ import annotations

import struct

import numpy as np


def save_cloud_ply(filename: str, points, colours=None, normals=None):
    """Write a binary PLY point cloud (reference: ohmtools::saveCloud)."""
    points = np.asarray(points, dtype=np.float64).reshape(-1, 3)
    n = len(points)
    props = ["property double x", "property double y", "property double z"]
    if normals is not None:
        props += ["property float nx", "property float ny", "property float nz"]
    if colours is not None:
        props += ["property uchar red", "property uchar green", "property uchar blue"]
    header = (
        "ply\nformat binary_little_endian 1.0\n"
        f"element vertex {n}\n" + "\n".join(props) + "\nend_header\n"
    )
    with open(filename, "wb") as f:
        f.write(header.encode("ascii"))
        if colours is None and normals is None:
            f.write(np.ascontiguousarray(points).tobytes())
        else:
            dtype = [("xyz", np.float64, 3)]
            if normals is not None:
                dtype.append(("n", np.float32, 3))
            if colours is not None:
                dtype.append(("rgb", np.uint8, 3))
            rec = np.zeros(n, dtype=dtype)
            rec["xyz"] = points
            if normals is not None:
                rec["n"] = np.asarray(normals, np.float32).reshape(-1, 3)
            if colours is not None:
                rec["rgb"] = np.asarray(colours, np.uint8).reshape(-1, 3)
            f.write(rec.tobytes())


def save_mesh_ply(filename: str, vertices, triangles, vertex_normals=None):
    """Write a binary PLY triangle mesh (reference: ohmutil/PlyMesh)."""
    vertices = np.asarray(vertices, dtype=np.float32).reshape(-1, 3)
    triangles = np.asarray(triangles, dtype=np.int32).reshape(-1, 3)
    props = ["property float x", "property float y", "property float z"]
    if vertex_normals is not None:
        props += ["property float nx", "property float ny", "property float nz"]
    header = (
        "ply\nformat binary_little_endian 1.0\n"
        f"element vertex {len(vertices)}\n" + "\n".join(props) + "\n"
        f"element face {len(triangles)}\n"
        "property list uchar int vertex_indices\nend_header\n"
    )
    with open(filename, "wb") as f:
        f.write(header.encode("ascii"))
        if vertex_normals is not None:
            rec = np.zeros(len(vertices), dtype=[("v", np.float32, 3), ("n", np.float32, 3)])
            rec["v"] = vertices
            rec["n"] = np.asarray(vertex_normals, np.float32).reshape(-1, 3)
            f.write(rec.tobytes())
        else:
            f.write(np.ascontiguousarray(vertices).tobytes())
        face = np.zeros(len(triangles), dtype=[("n", np.uint8), ("idx", np.int32, 3)])
        face["n"] = 3
        face["idx"] = triangles
        f.write(face.tobytes())


_PLY_TYPES = {
    "char": "i1", "int8": "i1", "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2", "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4", "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4", "double": "f8", "float64": "f8",
}


def load_ply(filename: str) -> dict:
    """Read a PLY file's vertex element into named numpy arrays.

    Supports binary little-endian and ASCII formats (the slamio readers'
    scope).  Returns {property name: array}; list properties are skipped.
    """
    with open(filename, "rb") as f:
        line = f.readline().strip()
        if line != b"ply":
            raise ValueError("not a PLY file")
        fmt = None
        elements = []  # (name, count, [(prop, type)])
        while True:
            line = f.readline()
            if not line:
                raise ValueError("unterminated PLY header")
            parts = line.decode("ascii", "replace").strip().split()
            if not parts:
                continue
            if parts[0] == "format":
                fmt = parts[1]
            elif parts[0] == "element":
                elements.append((parts[1], int(parts[2]), []))
            elif parts[0] == "property":
                if parts[1] == "list":
                    elements[-1][2].append((parts[-1], ("list", parts[2], parts[3])))
                else:
                    elements[-1][2].append((parts[2], parts[1]))
            elif parts[0] == "end_header":
                break

        out = {}
        for name, count, props in elements:
            if any(isinstance(t, tuple) for _, t in props):
                if name != "vertex":
                    # Parse-and-skip list elements (e.g. faces).
                    if fmt == "ascii":
                        for _ in range(count):
                            f.readline()
                    else:
                        for _ in range(count):
                            for pname, t in props:
                                if isinstance(t, tuple):
                                    cnt_t = np.dtype(_PLY_TYPES[t[1]])
                                    n_items = int(np.frombuffer(f.read(cnt_t.itemsize), cnt_t)[0])
                                    f.read(n_items * np.dtype(_PLY_TYPES[t[2]]).itemsize)
                                else:
                                    f.read(np.dtype(_PLY_TYPES[t]).itemsize)
                    continue
            dtype = np.dtype([(pname, _PLY_TYPES[t]) for pname, t in props])
            if fmt == "ascii":
                rows = [f.readline().split()[: len(props)] for _ in range(count)]
                arr = np.zeros(count, dtype=dtype)
                for ci, (pname, t) in enumerate(props):
                    col = [r[ci] for r in rows]
                    arr[pname] = np.asarray(col, dtype=_PLY_TYPES[t])
            elif fmt == "binary_little_endian":
                arr = np.frombuffer(f.read(count * dtype.itemsize), dtype=dtype, count=count)
            else:
                raise ValueError(f"unsupported PLY format {fmt}")
            if name == "vertex":
                for pname, _ in props:
                    out[pname] = np.ascontiguousarray(arr[pname])
        return out
