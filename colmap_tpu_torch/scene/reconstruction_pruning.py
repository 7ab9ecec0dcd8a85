"""Reconstruction pruning: redundant-point selection by coverage gain.

A copy of colmap_tpu/scene/reconstruction_pruning.py (host Python), so
that the port does not import the JAX package. No module of either package
imports it.

reference behavior: src/colmap/scene/reconstruction_pruning.{h,cc}
FindRedundantPoints3D — greedy max-coverage selection of 3D points over an
8x8 tile grid per image; points whose marginal coverage gain falls below
`min_coverage_gain` are redundant (used to thin dense-track scenes before
global BA, sfm/incremental_mapper.h:113-117 point pruning by coverage).
"""

from __future__ import annotations

import heapq
from typing import Dict, List

import numpy as np

from colmap_tpu_torch.scene.reconstruction import Reconstruction

_NUM_TILES_PER_DIM = 8
_NUM_TILES = _NUM_TILES_PER_DIM * _NUM_TILES_PER_DIM


def _image_tile_idxs(recon: Reconstruction) -> Dict[int, np.ndarray]:
    """Per-image tile index of every 2D point (vectorized)."""
    out = {}
    for image_id, image in recon.images.items():
        cam = recon.cameras[image.camera_id]
        xy = image.points2D_xy
        tx = np.clip(
            (_NUM_TILES_PER_DIM * xy[:, 0] / cam.width).astype(np.int64),
            0, _NUM_TILES_PER_DIM - 1,
        )
        ty = np.clip(
            (_NUM_TILES_PER_DIM * xy[:, 1] / cam.height).astype(np.int64),
            0, _NUM_TILES_PER_DIM - 1,
        )
        out[image_id] = tx * _NUM_TILES_PER_DIM + ty
    return out


def find_redundant_points3D(
    min_coverage_gain: float, recon: Reconstruction
) -> List[int]:
    """Ids of points that add less than min_coverage_gain of image-tile
    coverage under greedy max-coverage selection (reference:
    reconstruction_pruning.cc:88, lazy-greedy priority queue)."""
    tile_idxs = _image_tile_idxs(recon)
    counts: Dict[int, np.ndarray] = {
        iid: np.zeros(_NUM_TILES, dtype=np.int64) for iid in recon.images
    }

    def gain(point3D) -> float:
        g = 0.0
        for el in point3D.track:
            t = tile_idxs[el.image_id][el.point2D_idx]
            n = 1 + counts[el.image_id][t]
            g += 1.0 / np.sqrt(n) - 1.0 / np.sqrt(1 + n)
        return g

    # Lazy-greedy: gains only decrease as tiles fill, so a popped entry
    # whose recomputed gain dropped is pushed back.
    heap = []
    for pid, p in recon.points3D.items():
        heapq.heappush(heap, (-gain(p), pid))

    selected = set()
    while heap:
        neg_g, pid = heapq.heappop(heap)
        if -neg_g <= min_coverage_gain:
            break
        p = recon.points3D[pid]
        g_now = gain(p)
        if g_now < -neg_g - 1e-15:
            heapq.heappush(heap, (-g_now, pid))
            continue
        selected.add(pid)
        for el in p.track:
            t = tile_idxs[el.image_id][el.point2D_idx]
            counts[el.image_id][t] += 1

    return [pid for pid in recon.points3D if pid not in selected]
