"""Depth / normal map files, COLMAP-compatible (colmap_tpu/mvs/depth_map.py).

reference behavior: src/colmap/mvs/{mat.h,mat.cc:42-65,depth_map,normal_map}
— files are an ASCII header "width&height&channels&" followed by row-major
(slice-major for channels) float32 little-endian data. The files are
byte-identical to colmap_tpu's.
"""

from __future__ import annotations

import re

import numpy as np


def read_map(path: str) -> np.ndarray:
    """Read a COLMAP .bin map -> (H, W) or (H, W, C) float32 array."""
    with open(path, "rb") as f:
        header = b""
        for _ in range(3):
            while True:
                c = f.read(1)
                header += c
                if c == b"&":
                    break
        w, h, d = (int(x) for x in header.decode().split("&")[:3])
        data = np.frombuffer(f.read(4 * w * h * d), dtype="<f4")
    data = data.reshape(d, h, w)
    if d == 1:
        return data[0].copy()
    return np.moveaxis(data, 0, -1).copy()


def write_map(path: str, arr: np.ndarray):
    """Write (H, W) or (H, W, C) float32 array as a COLMAP .bin map."""
    arr = np.asarray(arr, dtype=np.float32)
    if arr.ndim == 2:
        h, w = arr.shape
        d = 1
        data = arr[None]
    else:
        h, w, d = arr.shape
        data = np.moveaxis(arr, -1, 0)
    with open(path, "wb") as f:
        f.write(f"{w}&{h}&{d}&".encode())
        f.write(np.ascontiguousarray(data, dtype="<f4").tobytes())
