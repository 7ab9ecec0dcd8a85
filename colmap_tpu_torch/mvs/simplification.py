"""Mesh simplification (colmap_tpu/mvs/simplification.py).

reference behavior: src/colmap/mvs/mesh_simplification.{h,cc} — CGAL
edge-collapse driven by a stop ratio on the edge count. The repository's
``native/mesh_ops.cpp`` implements Garland–Heckbert quadric edge collapse
behind a C interface; it is built with g++ at first use into
``colmap_tpu_torch/_build/`` (named by a hash of the source) and loaded with
ctypes, as colmap_tpu loads it. Where it does not build, ``simplify_mesh``
raises. The grid vertex clustering of colmap_tpu is ported as
``_cluster_simplify``, a function of its own.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path
from typing import Tuple

import numpy as np

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG.parent / "native" / "mesh_ops.cpp"
BUILD_DIR = _PKG / "_build"
GXX_FLAGS = ["-O3", "-shared", "-fPIC"]


@functools.cache
def _lib() -> ctypes.CDLL:
    """native/mesh_ops.cpp as a shared library, built on first use."""
    if not SOURCE.exists():
        raise RuntimeError(f"{SOURCE} is missing: mesh simplification needs it")
    key = hashlib.sha256(" ".join(GXX_FLAGS).encode() + SOURCE.read_bytes()).hexdigest()[:16]
    target = BUILD_DIR / f"libmesh_ops_{key}.so"
    if not target.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
            out = Path(tmp) / target.name
            proc = subprocess.run(["g++", *GXX_FLAGS, "-o", str(out), str(SOURCE)],
                                  capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"g++ failed to build {SOURCE}:\n{proc.stderr}")
            os.replace(out, target)
    lib = ctypes.CDLL(str(target))
    f64p = np.ctypeslib.ndpointer(np.float64, flags="C")
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C")
    lib.simplify_mesh.argtypes = [f64p, ctypes.c_int64, i64p, ctypes.c_int64, ctypes.c_int64,
                                  f64p, ctypes.POINTER(ctypes.c_int64), i64p,
                                  ctypes.POINTER(ctypes.c_int64)]
    lib.simplify_mesh.restype = None
    return lib


def simplify_mesh(vertices: np.ndarray, faces: np.ndarray,
                  factor: float) -> Tuple[np.ndarray, np.ndarray]:
    """Simplify to ~factor of the original face count (0 < factor <= 1) by
    quadric edge collapse; (vertices float32, faces int32)."""
    vertices = np.ascontiguousarray(vertices, dtype=np.float64)
    faces64 = np.ascontiguousarray(faces, dtype=np.int64)
    target = max(4, int(round(len(faces64) * float(factor))))
    out_v = np.empty_like(vertices)
    out_f = np.empty_like(faces64)
    nv = ctypes.c_int64(0)
    nf = ctypes.c_int64(0)
    _lib().simplify_mesh(vertices, len(vertices), faces64, len(faces64), target,
                         out_v, ctypes.byref(nv), out_f, ctypes.byref(nf))
    return out_v[:nv.value].astype(np.float32), out_f[:nf.value].astype(np.int32)


def _cluster_simplify(vertices, faces, target_num_faces):
    """Uniform-grid vertex clustering sized to hit ~target faces."""
    lo = vertices.min(axis=0)
    hi = vertices.max(axis=0)
    span = max(float((hi - lo).max()), 1e-12)
    # Face count scales ~ quadratically with grid resolution on a surface.
    res = max(2, int(np.sqrt(target_num_faces / 2.0)))
    for _ in range(8):
        cell = np.floor((vertices - lo) / span * res).astype(np.int64)
        key = cell[:, 0] * (res + 1) ** 2 + cell[:, 1] * (res + 1) + cell[:, 2]
        uniq, inv = np.unique(key, return_inverse=True)
        inv = inv.reshape(-1)
        # New vertex = centroid of cluster.
        sums = np.zeros((len(uniq), 3))
        np.add.at(sums, inv, vertices)
        cnt = np.bincount(inv, minlength=len(uniq)).astype(np.float64)
        new_v = sums / cnt[:, None]
        nf = inv[faces]
        keep = (nf[:, 0] != nf[:, 1]) & (nf[:, 1] != nf[:, 2]) & (nf[:, 0] != nf[:, 2])
        nf = nf[keep]
        if len(nf) <= target_num_faces * 1.2 or res <= 2:
            return new_v.astype(np.float32), nf.astype(np.int32)
        res = int(res * 0.8)
    return new_v.astype(np.float32), nf.astype(np.int32)
