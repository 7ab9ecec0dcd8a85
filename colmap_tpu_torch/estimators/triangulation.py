"""Robust multi-view triangulation (RANSAC over view pairs).

Counterpart of colmap_tpu/estimators/triangulation.py (reference behavior:
src/colmap/estimators/triangulation.{h,cc} EstimateTriangulation): every
view pair of a track is DLT-triangulated, checked for its triangulation
angle and scored by angular error against all views; the best pair's
inliers are refit by N-view DLT, kept when they keep at least as many
inliers. Batched over tracks in the CUDA kernel K8 (kernels/sfm.py).
"""

from __future__ import annotations

import dataclasses
import math

from colmap_tpu_torch.kernels import sfm as K


@dataclasses.dataclass(frozen=True)
class TriangulationOptions:
    """reference: estimators/triangulation.h:56-79."""

    min_tri_angle_deg: float = 1.5
    max_angular_error_deg: float = 2.0


def estimate_triangulation(R, t, x, mask, options: TriangulationOptions):
    """Robust triangulation of a batch of tracks.

    R (B, V, 3, 3), t (B, V, 3) cam_from_world (padded views); x (B, V, 2)
    normalized observations; mask (B, V) validity. Returns a dict with xyz
    (B, 3), inlier_mask (B, V), num_inliers (B,) and success (B,).
    """
    xyz, inl, success = K.triangulate_tracks(
        R, t, x, mask, math.radians(options.min_tri_angle_deg),
        math.radians(options.max_angular_error_deg))
    return {"xyz": xyz, "inlier_mask": inl, "num_inliers": inl.sum(-1), "success": success}
