"""Correspondence graph: per-feature adjacency across verified image pairs.

reference behavior: src/colmap/scene/correspondence_graph.h:45-110 — built
from two-view inlier matches, supports direct and transitive correspondence
lookup plus pair statistics. Stored in compact CSR arrays per image (numpy,
host side). Counterpart of colmap_tpu/scene/correspondence_graph.py.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from colmap_tpu_torch.utils.types import image_pair_to_pair_id, pair_id_to_image_pair


class CorrespondenceGraph:
    def __init__(self):
        # per image: stacked (other_image_id, other_point2D_idx) rows sorted
        # by point2D_idx, with CSR offsets per point2D_idx.
        self._adj: Dict[int, Tuple[np.ndarray, np.ndarray, np.ndarray]] = {}
        self._num_observations: Dict[int, int] = {}  # points with >=1 corr
        self._num_correspondences: Dict[int, int] = {}
        self._pairs: Dict[int, int] = {}  # pair_id -> num corrs
        self._tmp: Dict[int, List[np.ndarray]] = {}
        self._num_points2D: Dict[int, int] = {}
        self._finalized = False

    def add_image(self, image_id: int, num_points2D: int):
        self._num_points2D[image_id] = num_points2D
        self._tmp.setdefault(image_id, [])

    def add_correspondences(self, image_id1: int, image_id2: int, matches: np.ndarray):
        """matches: (M, 2) indices into the two images' keypoints."""
        if image_id1 == image_id2 or len(matches) == 0:
            return
        m = np.asarray(matches, dtype=np.int64)
        pair_id = image_pair_to_pair_id(image_id1, image_id2)
        self._pairs[pair_id] = self._pairs.get(pair_id, 0) + len(m)
        # rows: (point2D_idx, other_image, other_idx)
        self._tmp[image_id1].append(
            np.stack([m[:, 0], np.full(len(m), image_id2), m[:, 1]], axis=1)
        )
        self._tmp[image_id2].append(
            np.stack([m[:, 1], np.full(len(m), image_id1), m[:, 0]], axis=1)
        )

    def finalize(self):
        """Compact to CSR (reference: CorrespondenceGraph::Finalize)."""
        for image_id, chunks in self._tmp.items():
            n_pts = self._num_points2D[image_id]
            if chunks:
                rows = np.concatenate(chunks, axis=0)
                # Stable sort by point2D_idx, then CSR offsets per point.
                order = np.argsort(rows[:, 0], kind="stable")
                offsets = np.zeros(n_pts + 1, dtype=np.int64)
                np.cumsum(np.bincount(rows[:, 0], minlength=n_pts), out=offsets[1:])
                rows = rows[order]
                data_img = rows[:, 1].astype(np.uint32)
                data_idx = rows[:, 2].astype(np.uint32)
            else:
                offsets = np.zeros(n_pts + 1, dtype=np.int64)
                data_img = np.zeros(0, dtype=np.uint32)
                data_idx = np.zeros(0, dtype=np.uint32)
            self._adj[image_id] = (offsets, data_img, data_idx)
            counts = np.diff(offsets)
            self._num_observations[image_id] = int(np.sum(counts > 0))
            self._num_correspondences[image_id] = int(len(data_img))
        self._tmp = {}
        self._finalized = True

    # -- queries ------------------------------------------------------------
    def exists_image(self, image_id: int) -> bool:
        return image_id in self._num_points2D

    def num_observations_for_image(self, image_id: int) -> int:
        return self._num_observations.get(image_id, 0)

    def num_correspondences_for_image(self, image_id: int) -> int:
        return self._num_correspondences.get(image_id, 0)

    def num_correspondences_between(self, image_id1: int, image_id2: int) -> int:
        return self._pairs.get(image_pair_to_pair_id(image_id1, image_id2), 0)

    def image_pairs(self) -> List[Tuple[int, int, int]]:
        """(image_id1, image_id2, num_correspondences) for all pairs."""
        out = []
        for pair_id, n in self._pairs.items():
            i1, i2 = pair_id_to_image_pair(pair_id)
            out.append((i1, i2, n))
        return out

    def find_correspondences(self, image_id: int, point2D_idx: int):
        """Direct correspondences: [(other_image_id, other_point2D_idx)]."""
        offsets, data_img, data_idx = self._adj[image_id]
        s, e = offsets[point2D_idx], offsets[point2D_idx + 1]
        return list(zip(data_img[s:e].tolist(), data_idx[s:e].tolist()))

    def find_transitive_correspondences(
        self, image_id: int, point2D_idx: int, transitivity: int = 1
    ):
        """BFS up to the given transitivity depth
        (reference: FindTransitiveCorrespondences)."""
        if transitivity <= 1:
            return self.find_correspondences(image_id, point2D_idx)
        seen = {(image_id, point2D_idx)}
        frontier = [(image_id, point2D_idx)]
        found = []
        for _ in range(transitivity):
            next_frontier = []
            for (iid, idx) in frontier:
                for corr in self.find_correspondences(iid, int(idx)):
                    if corr not in seen:
                        seen.add(corr)
                        found.append(corr)
                        next_frontier.append(corr)
            frontier = next_frontier
            if not frontier:
                break
        return found

    def has_correspondences(self, image_id: int, point2D_idx: int) -> bool:
        offsets, _, _ = self._adj[image_id]
        return offsets[point2D_idx + 1] > offsets[point2D_idx]

    def correspondence_arrays(self, image_id: int):
        """Raw CSR arrays (offsets, other_image_ids, other_point_idxs)."""
        return self._adj[image_id]
