"""PLY point-cloud / mesh I/O (colmap_tpu/utils/ply.py).

reference behavior: src/colmap/util/ply.{h,cc} — binary little-endian and
ascii PLY with xyz / normal / rgb properties. The files are byte-identical
to colmap_tpu's. The ASCII writers format the whole table with one string
operation instead of a Python loop over rows: a fused cloud has millions.
"""

from __future__ import annotations

import numpy as np


def _ascii_rows(floats, ints=None) -> bytes:
    """Rows of "%.6f" floats (N, k) and, if given, "%d" ints (N, m), space
    separated, one line each: colmap_tpu's ``f"{v:.6f}"`` and ``str(int(v))``."""
    floats = np.asarray(floats)
    n = len(floats)
    if n == 0:
        return b""
    cols = [floats.astype(np.float64)]
    fmt = ["%.6f"] * floats.shape[1]
    if ints is not None:
        cols.append(np.asarray(ints).astype(np.int64))
        fmt += ["%d"] * cols[-1].shape[1]
    table = np.empty((n, len(fmt)), dtype=object)
    k = 0
    for c in cols:
        table[:, k:k + c.shape[1]] = np.array(c.tolist(), dtype=object).reshape(n, -1)
        k += c.shape[1]
    row = " ".join(fmt) + "\n"
    return ((row * n) % tuple(table.ravel().tolist())).encode()


def write_ply(path, points, normals=None, colors=None, binary=True):
    """Write a point cloud. points (N, 3) float; normals (N, 3) float;
    colors (N, 3) uint8."""
    points = np.asarray(points, dtype=np.float32)
    n = len(points)
    props = ["property float x", "property float y", "property float z"]
    if normals is not None:
        props += ["property float nx", "property float ny", "property float nz"]
    if colors is not None:
        props += ["property uchar red", "property uchar green", "property uchar blue"]
    fmt = "binary_little_endian 1.0" if binary else "ascii 1.0"
    header = (
        "ply\n"
        f"format {fmt}\n"
        f"element vertex {n}\n" + "\n".join(props) + "\nend_header\n"
    )
    if normals is not None:
        normals = np.asarray(normals, dtype=np.float32)
    if colors is not None:
        colors = np.asarray(colors, dtype=np.uint8)
    with open(path, "wb") as f:
        f.write(header.encode())
        if binary:
            fields = [("x", "<f4"), ("y", "<f4"), ("z", "<f4")]
            if normals is not None:
                fields += [("nx", "<f4"), ("ny", "<f4"), ("nz", "<f4")]
            if colors is not None:
                fields += [("red", "u1"), ("green", "u1"), ("blue", "u1")]
            rec = np.empty(n, dtype=fields)
            rec["x"], rec["y"], rec["z"] = points[:, 0], points[:, 1], points[:, 2]
            if normals is not None:
                rec["nx"], rec["ny"], rec["nz"] = normals[:, 0], normals[:, 1], normals[:, 2]
            if colors is not None:
                rec["red"], rec["green"], rec["blue"] = colors[:, 0], colors[:, 1], colors[:, 2]
            f.write(rec.tobytes())
        else:
            floats = points if normals is None else np.concatenate([points, normals], axis=1)
            f.write(_ascii_rows(floats, colors))


def write_ply_mesh(path, vertices, faces, colors=None, binary=True):
    """Write a triangle mesh. vertices (V, 3) float; faces (F, 3) int;
    colors (V, 3) uint8 optional.

    reference behavior: util/ply.cc WriteTextPlyMesh/WriteBinaryPlyMesh.
    """
    vertices = np.asarray(vertices, dtype=np.float32)
    faces = np.asarray(faces, dtype=np.int32)
    nv, nf = len(vertices), len(faces)
    props = ["property float x", "property float y", "property float z"]
    if colors is not None:
        props += ["property uchar red", "property uchar green", "property uchar blue"]
        colors = np.asarray(colors, dtype=np.uint8)
    fmt = "binary_little_endian 1.0" if binary else "ascii 1.0"
    header = (
        "ply\n"
        f"format {fmt}\n"
        f"element vertex {nv}\n" + "\n".join(props) + "\n"
        f"element face {nf}\n"
        "property list uchar int vertex_index\n"
        "end_header\n"
    )
    with open(path, "wb") as f:
        f.write(header.encode())
        if binary:
            fields = [("x", "<f4"), ("y", "<f4"), ("z", "<f4")]
            if colors is not None:
                fields += [("red", "u1"), ("green", "u1"), ("blue", "u1")]
            rec = np.empty(nv, dtype=fields)
            rec["x"], rec["y"], rec["z"] = vertices[:, 0], vertices[:, 1], vertices[:, 2]
            if colors is not None:
                rec["red"], rec["green"], rec["blue"] = colors[:, 0], colors[:, 1], colors[:, 2]
            f.write(rec.tobytes())
            frec = np.empty(nf, dtype=[("n", "u1"), ("a", "<i4"), ("b", "<i4"), ("c", "<i4")])
            frec["n"] = 3
            frec["a"], frec["b"], frec["c"] = faces[:, 0], faces[:, 1], faces[:, 2]
            f.write(frec.tobytes())
        else:
            f.write(_ascii_rows(vertices, colors))
            if nf:
                f.write((("3 %d %d %d\n" * nf) % tuple(faces.astype(np.int64).ravel().tolist()))
                        .encode())


def _read_header(f):
    lines = []
    while True:
        line = f.readline().decode().strip()
        lines.append(line)
        if line == "end_header":
            return lines


_TYPEMAP = {"float": "<f4", "double": "<f8", "uchar": "u1", "uint8": "u1"}


def read_ply_mesh(path):
    """Read a triangle mesh PLY -> dict with vertices/faces (+colors)."""
    with open(path, "rb") as f:
        header_lines = _read_header(f)
        binary = any("binary_little_endian" in line for line in header_lines)
        nv = nf = 0
        props = []
        cur_elem = None
        for line in header_lines:
            if line.startswith("element vertex"):
                nv = int(line.split()[-1])
                cur_elem = "vertex"
            elif line.startswith("element face"):
                nf = int(line.split()[-1])
                cur_elem = "face"
            elif line.startswith("property") and not line.startswith("property list"):
                if cur_elem == "vertex":
                    _, typ, name = line.split()
                    props.append((name, typ))
        out = {}
        if binary:
            dtype = np.dtype([(name, _TYPEMAP[typ]) for (name, typ) in props])
            rec = np.frombuffer(f.read(nv * dtype.itemsize), dtype=dtype, count=nv)
            out["vertices"] = np.stack([rec["x"], rec["y"], rec["z"]], axis=1).astype(np.float32)
            if "red" in dtype.names:
                out["colors"] = np.stack([rec["red"], rec["green"], rec["blue"]], axis=1)
            fdt = np.dtype([("n", "u1"), ("a", "<i4"), ("b", "<i4"), ("c", "<i4")])
            frec = np.frombuffer(f.read(nf * fdt.itemsize), dtype=fdt, count=nf)
            out["faces"] = np.stack([frec["a"], frec["b"], frec["c"]], axis=1)
        else:
            rows = [f.readline().split() for _ in range(nv)]
            arr = np.asarray(rows, dtype=np.float64)
            out["vertices"] = arr[:, :3].astype(np.float32)
            names = [p[0] for p in props]
            if "red" in names:
                i = names.index("red")
                out["colors"] = arr[:, i:i + 3].astype(np.uint8)
            frows = [f.readline().split() for _ in range(nf)]
            out["faces"] = np.asarray(frows, dtype=np.int64)[:, 1:4].astype(np.int32)
    return out


def read_ply(path):
    """Read a PLY point cloud -> dict with points/normals/colors arrays."""
    with open(path, "rb") as f:
        header_lines = _read_header(f)
        binary = any("binary_little_endian" in line for line in header_lines)
        n = 0
        props = []
        for line in header_lines:
            if line.startswith("element vertex"):
                n = int(line.split()[-1])
            elif line.startswith("property") and not line.startswith("property list"):
                _, typ, name = line.split()
                props.append((name, typ))
        if binary:
            dtype = [(name, _TYPEMAP[typ]) for (name, typ) in props]
            rec = np.frombuffer(f.read(), dtype=dtype, count=n)
        else:
            data = np.loadtxt(f, max_rows=n).reshape(n, len(props))
            rec = {name: data[:, i] for i, (name, typ) in enumerate(props)}
    names = [p[0] for p in props]
    out = {"points": np.stack([np.asarray(rec[k]) for k in ("x", "y", "z")], axis=1)}
    if "nx" in names:
        out["normals"] = np.stack([np.asarray(rec[k]) for k in ("nx", "ny", "nz")], axis=1)
    if "red" in names:
        out["colors"] = np.stack([np.asarray(rec[k]) for k in ("red", "green", "blue")],
                                 axis=1).astype(np.uint8)
    return out
