"""Coordinate frame estimation: gravity, Manhattan world, principal plane, ENU.

Counterpart of colmap_tpu/estimators/coordinate_frame.py (reference behavior: src/colmap/estimators/coordinate_frame.{h,cc} —
`EstimateGravityVectorFromImageOrientation` (consensus of camera downward
axes), `EstimateManhattanWorldFrame` (per-image line segments -> vanishing
point RANSAC -> consensus world axes), `AlignToPrincipalPlane` (point-cloud
PCA), `AlignToENUPlane` (ECEF centroid -> ENU rotation). The vanishing-point
RANSAC follows the reference's 2-line minimal solver with midpoint-line
residuals (coordinate_frame.cc VanishingPointEstimator), scored over all
hypotheses at once. Host numpy, as in colmap_tpu; the line segments of
the Manhattan frame come from image/lines.py, whose gradients run in K49 on
``device``. ``ManhattanWorldFrameOptions.max_image_size`` is never read, as
in colmap_tpu: the detector runs on the images at full resolution.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from colmap_tpu_torch.geometry import rotation as rot
from colmap_tpu_torch.scene.reconstruction import Reconstruction


def find_best_consensus_axis(axes: List[np.ndarray], max_distance: float) -> np.ndarray:
    """Axis maximizing inliers within 1-dot distance, averaged over inliers.

    reference behavior: FindBestConsensusAxis (coordinate_frame.cc:44-93).
    """
    if not axes:
        return np.zeros(3)
    A = np.stack(axes)  # (N, 3)
    dist = 1.0 - A @ A.T  # (N, N)
    inlier = dist <= max_distance
    np.fill_diagonal(inlier, True)
    counts = inlier.sum(axis=1)
    sums = np.where(inlier, dist, 0.0).sum(axis=1)
    # Most inliers; ties by smallest inlier distance sum.
    best = np.lexsort((sums, -counts))[0]
    sel = inlier[best]
    axis = A[sel].mean(axis=0)
    return axis


def estimate_gravity_from_image_orientation(
    recon: Reconstruction, max_axis_distance: float = 0.05
) -> np.ndarray:
    """Gravity = consensus of the camera frames' downward (y) axes in world.

    reference behavior: EstimateGravityVectorFromImageOrientation
    (coordinate_frame.cc:98-108).
    """
    axes = [
        recon.cam_from_world(iid).rotmat()[1]
        for iid in recon.reg_image_ids()
    ]
    return find_best_consensus_axis(axes, max_axis_distance)


# ---------------------------------------------------------------------------
# Vanishing points


def estimate_vanishing_point(
    segments,
    max_error: float = 2.0,
    min_num_inliers: int = 2,
    num_hypotheses: int = 256,
    seed: int = 0,
) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """RANSAC vanishing point from line segments.

    Minimal sample: 2 segments; vp = l1 x l2. Residual: squared signed
    distance of the segment end to the line joining the segment midpoint and
    the vanishing point (reference: VanishingPointEstimator,
    coordinate_frame.cc:112-159). All hypotheses are scored against all
    segments in one batched pass.
    Returns (vp_homogeneous, inlier_mask) or None.
    """
    n = len(segments)
    if n < 2:
        return None
    starts = np.stack([s.start for s in segments])
    ends = np.stack([s.end for s in segments])
    lines = np.cross(
        np.concatenate([starts, np.ones((n, 1))], axis=1),
        np.concatenate([ends, np.ones((n, 1))], axis=1),
    )  # (N, 3)
    rng = np.random.default_rng(seed)
    k = min(num_hypotheses, n * (n - 1) // 2)
    i1 = rng.integers(0, n, k)
    i2 = rng.integers(0, n, k)
    valid = i1 != i2
    vps = np.cross(lines[i1], lines[i2])  # (K, 3)

    mid = np.concatenate([(starts + ends) / 2.0, np.ones((n, 1))], axis=1)
    end_h = np.concatenate([ends, np.ones((n, 1))], axis=1)
    # connecting[k, i] = mid_i x vp_k
    conn = np.cross(mid[None, :, :], vps[:, None, :])  # (K, N, 3)
    num = np.einsum("kni,ni->kn", conn, end_h)
    den = np.linalg.norm(conn[..., :2], axis=-1)
    res = (num / np.maximum(den, 1e-12)) ** 2  # (K, N)
    inliers = (res <= max_error**2) & valid[:, None]
    counts = inliers.sum(axis=1)
    best = int(np.argmax(counts))
    if counts[best] < min_num_inliers:
        return None
    def score(vp):
        conn_r = np.cross(mid, vp[None, :])
        num_r = np.einsum("ni,ni->n", conn_r, end_h)
        den_r = np.linalg.norm(conn_r[..., :2], axis=-1)
        res_r = (num_r / np.maximum(den_r, 1e-12)) ** 2
        m = res_r <= max_error**2
        return m, float(np.where(m, res_r, max_error**2).sum())

    best_vp, best_mask = vps[best], inliers[best]
    _, best_cost = score(best_vp)
    # Iterated local optimization: least-squares vp over inliers (smallest
    # right singular vector of the inlier line matrix), re-scored.
    mask = best_mask
    for _ in range(3):
        L = lines[mask]
        L = L / np.maximum(np.linalg.norm(L[:, :2], axis=1, keepdims=True), 1e-12)
        _, _, Vt = np.linalg.svd(L)
        vp = Vt[-1]
        mask_r, cost_r = score(vp)
        if (mask_r.sum(), -cost_r) > (best_mask.sum(), -best_cost):
            best_vp, best_mask, best_cost = vp, mask_r, cost_r
        if mask_r.sum() == mask.sum() and (mask_r == mask).all():
            break
        mask = mask_r
    return best_vp, best_mask


@dataclasses.dataclass
class ManhattanWorldFrameOptions:
    """reference: coordinate_frame.h ManhattanWorldFrameEstimationOptions."""

    max_image_size: int = 1024
    min_line_length: float = 3.0
    line_orientation_tolerance: float = 0.2
    max_line_vp_distance: float = 0.5
    max_axis_distance: float = 0.05


def estimate_manhattan_world_frame(
    recon: Reconstruction,
    images: dict,
    options: ManhattanWorldFrameOptions = ManhattanWorldFrameOptions(),
    device=None,
) -> np.ndarray:
    """Manhattan frame (columns: rightward, downward, forward) in world.

    `images`: {image_id: grayscale ndarray} of (already undistorted) images.
    reference behavior: EstimateManhattanWorldFrame
    (coordinate_frame.cc:161-308).
    """
    from colmap_tpu_torch.image.lines import (
        LineSegmentOrientation,
        classify_line_segment_orientations,
        detect_line_segments,
    )
    from colmap_tpu_torch.sensor import models as camera_models

    rightward_axes: List[np.ndarray] = []
    downward_axes: List[np.ndarray] = []
    for iid in recon.reg_image_ids():
        if iid not in images:
            continue
        image = recon.images[iid]
        camera = recon.cameras[image.camera_id]
        segments = detect_line_segments(images[iid], options.min_line_length,
                                        device=device)
        orientations = classify_line_segment_orientations(
            segments, options.line_orientation_tolerance
        )
        horizontal = [
            s for s, o in zip(segments, orientations)
            if o == LineSegmentOrientation.HORIZONTAL
        ]
        vertical = [
            s for s, o in zip(segments, orientations)
            if o == LineSegmentOrientation.VERTICAL
        ]
        f = float(camera_models.mean_focal_length(camera.model_id, camera.params))
        pp_idxs = camera_models.principal_point_idxs(camera.model_id)
        cx, cy = float(camera.params[pp_idxs[0]]), float(camera.params[pp_idxs[1]])
        K_inv = np.array([[1.0 / f, 0, -cx / f], [0, 1.0 / f, -cy / f], [0, 0, 1.0]])
        R_wc = recon.cam_from_world(iid).rotmat().T  # world_from_cam

        h = estimate_vanishing_point(horizontal, options.max_line_vp_distance)
        if h is not None:
            axis = K_inv @ h[0]
            axis /= np.linalg.norm(axis)
            axis = R_wc @ axis
            if rightward_axes and rightward_axes[0] @ axis < 0:
                axis = -axis
            rightward_axes.append(axis)
        v = estimate_vanishing_point(vertical, options.max_line_vp_distance)
        if v is not None:
            axis = K_inv @ v[0]
            axis /= np.linalg.norm(axis)
            axis = R_wc @ axis
            # Downwards in the image assuming upright capture.
            if axis @ np.array([0.0, 1.0, 0.0]) < 0:
                axis = -axis
            downward_axes.append(axis)

    frame = np.zeros((3, 3))
    if rightward_axes:
        frame[:, 0] = find_best_consensus_axis(
            rightward_axes, options.max_axis_distance
        )
    if downward_axes:
        frame[:, 1] = find_best_consensus_axis(
            downward_axes, options.max_axis_distance
        )
    if rightward_axes and downward_axes:
        frame[:, 2] = np.cross(frame[:, 0], frame[:, 1])
        U, _, Vt = np.linalg.svd(frame)
        frame = U @ Vt
    return frame


# ---------------------------------------------------------------------------
# Alignments


def _quat(R) -> np.ndarray:
    """Rotation matrix -> unit quaternion (wxyz), float64."""
    return rot.rotmat_to_quat(torch.as_tensor(np.asarray(R, dtype=np.float64))).numpy()


def align_to_principal_plane(recon: Reconstruction) -> Tuple[float, np.ndarray, np.ndarray]:
    """Rotate so the point cloud's two principal axes span z=0 and the first
    camera is above the plane. Returns the applied (scale, quat, t).

    reference behavior: AlignToPrincipalPlane (coordinate_frame.cc:310-352).
    """
    centroid = recon.compute_centroid(0.0, 1.0)
    pts = np.stack([p.xyz for p in recon.points3D.values()]) - centroid
    U, _, _ = np.linalg.svd(pts.T @ pts)
    basis = U

    def make(rot_mat):
        quat = _quat(rot_mat)
        t = -rot_mat @ centroid
        return quat, t

    rot_mat = np.stack(
        [basis[:, 0], basis[:, 1], np.cross(basis[:, 0], basis[:, 1])]
    )
    quat, t = make(rot_mat)
    # Flip if the first camera's center ends up below the plane.
    iid0 = sorted(recon.reg_image_ids())[0]
    center = rot_mat @ recon.cam_from_world(iid0).inverse().t + t
    if center[2] < 0:
        rot_mat = np.stack(
            [basis[:, 0], -basis[:, 1], np.cross(basis[:, 0], -basis[:, 1])]
        )
        quat, t = make(rot_mat)
    recon.transform(1.0, quat, t)
    return 1.0, quat, t


def align_to_enu_plane(
    recon: Reconstruction, unscaled_scale: Optional[float] = None
) -> Tuple[float, np.ndarray, np.ndarray]:
    """Rotate an ECEF-aligned model into the local ENU frame at its centroid.

    reference behavior: AlignToENUPlane (coordinate_frame.cc:355-379).
    """
    from colmap_tpu_torch.geometry.gps import ecef_to_ellipsoid, ecef_to_enu_rotation

    centroid = recon.compute_centroid(0.0, 1.0)
    lat, lon, _ = np.asarray(ecef_to_ellipsoid(centroid))
    R = np.asarray(ecef_to_enu_rotation(float(lat), float(lon)))
    scale = 1.0 if unscaled_scale is None else 1.0 / unscaled_scale
    quat = _quat(R)
    t = -scale * R @ centroid
    recon.transform(scale, quat, t)
    return scale, quat, t


def align_to_orientation_frame(recon: Reconstruction, frame: np.ndarray):
    """Apply the inverse of an estimated world frame (e.g. Manhattan) so its
    axes become the coordinate axes. reference behavior: model_orientation_aligner
    (exe/model.cc RunModelOrientationAligner)."""
    R = frame.T  # world points expressed in the frame basis
    quat = _quat(R)
    recon.transform(1.0, quat, np.zeros(3))
    return 1.0, quat, np.zeros(3)
