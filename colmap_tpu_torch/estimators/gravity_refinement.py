"""Gravity prior refinement from relative rotations over the pose graph.

A copy of colmap_tpu/estimators/gravity_refinement.py (host numpy), so that
the port does not import the JAX package. reference behavior: src/colmap/estimators/gravity_refinement.{h,cc} —
identify frames whose gravity disagrees with the gravity-aligned upright
relative rotations of too many neighbors (IdentifyErrorProneGravity), then
re-estimate each such frame's gravity as a robust average of the gravities
propagated from its neighbors (RefineGravity; ceres + arctan loss replaced
by a vectorized IRLS on the unit sphere). Trivial frames only, matching the
reference's TODO(jsch) restriction.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Set

import numpy as np

from colmap_tpu_torch.utils.types import pair_id_to_image_pair


@dataclasses.dataclass
class GravityRefinerOptions:
    """reference: gravity_refinement.h:13-34."""

    max_outlier_ratio: float = 0.5
    max_gravity_error_deg: float = 1.0
    min_num_neighbors: int = 7
    num_irls_iterations: int = 50


def gravity_aligned_rotation(g: np.ndarray) -> np.ndarray:
    """Rotation R with R @ g = (0, 1, 0) (the camera's down axis).

    reference behavior: GravityAlignedRotation (geometry/pose.h) — aligns
    the gravity direction with the y axis.
    """
    g = np.asarray(g, dtype=np.float64)
    g = g / np.linalg.norm(g)
    y = np.array([0.0, 1.0, 0.0])
    v = np.cross(g, y)
    c = float(g @ y)
    if np.linalg.norm(v) < 1e-12:
        return np.eye(3) if c > 0 else np.diag([1.0, -1.0, -1.0])
    vx = np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]])
    return np.eye(3) + vx + vx @ vx / (1.0 + c)


def closest_upright_angle(R: np.ndarray) -> float:
    """Angle of the closest rotation about the y axis.

    reference behavior: YAxisAngleFromRotation — projection of R onto
    rotations about y.
    """
    return float(np.arctan2(R[0, 2] - R[2, 0], R[0, 0] + R[2, 2]))


def upright_error_deg(R: np.ndarray) -> float:
    """Angular distance between R and its closest upright rotation."""
    a = closest_upright_angle(R)
    c, s = np.cos(a), np.sin(a)
    R_up = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
    cos_angle = (np.trace(R @ R_up.T) - 1.0) / 2.0
    return float(np.degrees(np.arccos(np.clip(cos_angle, -1.0, 1.0))))


def identify_error_prone_gravity(
    rel_rotations: Dict[int, np.ndarray],
    image_to_frame: Dict[int, int],
    gravities: Dict[int, np.ndarray],
    options: GravityRefinerOptions = GravityRefinerOptions(),
) -> Set[int]:
    """Frames whose gravity is inconsistent with too many neighbors.

    rel_rotations: pair_id -> R (cam2_from_cam1 rotation matrix).
    gravities: image_id -> gravity direction in that camera frame.
    reference behavior: IdentifyErrorProneGravity
    (gravity_refinement.cc:185-246).
    """
    mistakes: Dict[int, int] = {}
    totals: Dict[int, int] = {}
    for pair_id, R_rel in rel_rotations.items():
        id1, id2 = pair_id_to_image_pair(pair_id)
        if id1 not in gravities or id2 not in gravities:
            continue
        # A(g) maps g -> y, so A(g2) R_rel A(g1)^T fixes the y axis when the
        # two gravities are consistent with the relative rotation.
        R_aligned = (
            gravity_aligned_rotation(gravities[id2])
            @ R_rel
            @ gravity_aligned_rotation(gravities[id1]).T
        )
        err = upright_error_deg(R_aligned)
        for iid in (id1, id2):
            fid = image_to_frame[iid]
            totals[fid] = totals.get(fid, 0) + 1
            if err > options.max_gravity_error_deg:
                mistakes[fid] = mistakes.get(fid, 0) + 1
    out = set()
    for fid, total in totals.items():
        if total < options.min_num_neighbors:
            continue
        if mistakes.get(fid, 0) / total >= options.max_outlier_ratio:
            out.add(fid)
    return out


def _robust_average_direction(
    candidates: np.ndarray, loss_width: float, num_iterations: int
) -> np.ndarray:
    """IRLS mean direction with arctan-loss weights (reference: ceres
    ArctanLoss(1 - cos(max_gravity_error)))."""
    g = candidates.mean(axis=0)
    g /= np.linalg.norm(g)
    for _ in range(num_iterations):
        r = 1.0 - candidates @ g  # residuals in [0, 2]
        # arctan loss rho(s) = a * atan(s/a): weight = rho'(r^2)
        a = max(loss_width, 1e-12)
        w = 1.0 / (1.0 + (r * r / a) ** 2)
        g_new = (candidates * w[:, None]).sum(axis=0)
        n = np.linalg.norm(g_new)
        if n < 1e-12:
            break
        g_new /= n
        if np.abs(g_new @ g) > 1.0 - 1e-14:
            g = g_new
            break
        g = g_new
    return g


def refine_gravity(
    rel_rotations: Dict[int, np.ndarray],
    image_to_frame: Dict[int, int],
    gravities: Dict[int, np.ndarray],
    options: GravityRefinerOptions = GravityRefinerOptions(),
) -> Dict[int, np.ndarray]:
    """Refine per-frame gravity priors; returns {frame_id: new_gravity} for
    the frames that were corrected.

    reference behavior: GravityRefiner::RefineGravity
    (gravity_refinement.cc:39-183).
    """
    error_prone = identify_error_prone_gravity(
        rel_rotations, image_to_frame, gravities, options
    )
    if not error_prone:
        return {}
    # frame -> incident pair ids
    frame_pairs: Dict[int, List[int]] = {}
    for pair_id in rel_rotations:
        id1, id2 = pair_id_to_image_pair(pair_id)
        if id1 in gravities and id2 in gravities:
            frame_pairs.setdefault(image_to_frame[id1], []).append(pair_id)
            frame_pairs.setdefault(image_to_frame[id2], []).append(pair_id)

    frame_of = image_to_frame
    refined: Dict[int, np.ndarray] = {}
    loss_width = 1.0 - np.cos(np.radians(options.max_gravity_error_deg))
    for fid in error_prone:
        candidates = []
        for pair_id in frame_pairs.get(fid, []):
            id1, id2 = pair_id_to_image_pair(pair_id)
            R_rel = rel_rotations[pair_id]
            if frame_of[id1] == fid and frame_of[id2] != fid:
                candidates.append(R_rel.T @ gravities[id2])
            elif frame_of[id2] == fid and frame_of[id1] != fid:
                candidates.append(R_rel @ gravities[id1])
        if len(candidates) < options.min_num_neighbors:
            continue
        C = np.stack(candidates)
        C /= np.linalg.norm(C, axis=1, keepdims=True)
        g = _robust_average_direction(
            C, loss_width, options.num_irls_iterations
        )
        errors_deg = np.degrees(np.arccos(np.clip(C @ g, -1.0, 1.0)))
        outliers = (errors_deg > 2.0 * options.max_gravity_error_deg).mean()
        if outliers < options.max_outlier_ratio:
            refined[fid] = g
    return refined
