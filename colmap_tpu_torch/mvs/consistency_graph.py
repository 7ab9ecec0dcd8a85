"""Per-pixel consistent-source-image lists for MVS filtering
(colmap_tpu/mvs/consistency_graph.py).

reference behavior: src/colmap/mvs/consistency_graph.{h,cc} — a flat int32
stream of (col, row, num_images, image_idx...) records with a text header
"W&H&1&", written next to the depth maps by patch_match_stereo when
--PatchMatchStereo.write_consistency_graph is set. The files are
byte-identical to colmap_tpu's; ``from_mask`` builds the stream with array
ops (a full-width map has millions of records).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

NO_CONSISTENT_IMAGE_IDS = -1


class ConsistencyGraph:
    """Sparse per-pixel lists of consistent source image indices."""

    def __init__(self, width: int, height: int, data: Sequence[int] = (), _map=None):
        self.width = int(width)
        self.height = int(height)
        self.data = np.asarray(data, dtype=np.int32)
        self._map = self._build_map() if _map is None else _map

    def _build_map(self) -> np.ndarray:
        """reference: ConsistencyGraph::InitializeMap
        (consistency_graph.cc:117-136)."""
        m = np.full((self.height, self.width), NO_CONSISTENT_IMAGE_IDS, np.int64)
        data = self.data.tolist()
        i = 0
        n = len(data)
        while i < n:
            if i + 2 >= n:
                raise ValueError(f"corrupt consistency graph at offset {i}")
            col, row, num = data[i], data[i + 1], data[i + 2]
            if num < 0 or not (0 <= col < self.width and 0 <= row < self.height):
                raise ValueError(f"corrupt consistency graph at offset {i}")
            if i + 3 + num > n:
                raise ValueError(
                    f"truncated consistency graph: record at offset {i} "
                    f"declares {num} entries but only {n - i - 3} remain"
                )
            if num > 0:
                m[row, col] = i + 2
            i += 3 + num
        return m

    def image_idxs(self, row: int, col: int) -> np.ndarray:
        """Consistent source image indices at (row, col); empty if none."""
        idx = self._map[row, col]
        if idx == NO_CONSISTENT_IMAGE_IDS:
            return np.empty(0, np.int32)
        num = int(self.data[idx])
        return self.data[idx + 1 : idx + 1 + num]

    @classmethod
    def from_mask(cls, mask: np.ndarray, image_idxs: Sequence[int]) -> "ConsistencyGraph":
        """Build from an (S, H, W) boolean per-view consistency mask and the
        global image index of each source slot: one record per pixel with a
        consistent view, in row-major order, its views in slot order."""
        mask = np.asarray(mask, bool)
        S, H, W = mask.shape
        idxs = np.asarray(image_idxs, np.int32)
        assert len(idxs) == S
        rows, cols = np.nonzero(mask.any(axis=0))
        sel = mask[:, rows, cols].T  # (P, S)
        counts = sel.sum(axis=1)
        ends = np.cumsum(3 + counts, dtype=np.int64)
        starts = ends - (3 + counts)
        data = np.empty(int(ends[-1]) if len(ends) else 0, dtype=np.int32)
        data[starts] = cols
        data[starts + 1] = rows
        data[starts + 2] = counts
        p, s = np.nonzero(sel)  # row-major: pixel by pixel, slots in order
        rank = np.cumsum(sel, axis=1)[p, s] - 1
        data[starts[p] + 3 + rank] = idxs[s]
        m = np.full((H, W), NO_CONSISTENT_IMAGE_IDS, np.int64)
        m[rows, cols] = starts + 2
        return cls(W, H, data, _map=m)

    def write(self, path: str) -> None:
        """reference: ConsistencyGraph::Write (consistency_graph.cc:103-115)."""
        with open(path, "wb") as f:
            f.write(f"{self.width}&{self.height}&1&".encode())
            f.write(self.data.astype("<i4").tobytes())

    @classmethod
    def read(cls, path: str) -> "ConsistencyGraph":
        """reference: ConsistencyGraph::Read (consistency_graph.cc:70-101)."""
        with open(path, "rb") as f:
            raw = f.read()
        # Header: "W&H&D&" text, then little-endian int32 payload.
        pos = 0
        fields = []
        for _ in range(3):
            amp = raw.index(b"&", pos)
            fields.append(int(raw[pos:amp]))
            pos = amp + 1
        width, height, depth = fields
        if width <= 0 or height <= 0 or depth <= 0:
            raise ValueError(f"invalid consistency graph header in {path}")
        data = np.frombuffer(raw[pos:], dtype="<i4")
        return cls(width, height, data)
