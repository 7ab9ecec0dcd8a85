"""Reconstruction alignment and comparison.

reference behavior: src/colmap/estimators/alignment.h:42-86
(AlignReconstructions / CompareReconstructions) — Sim3 alignment on common
camera projection centers, then per-image rotation / projection-center
error metrics. Counterpart of colmap_tpu/estimators/alignment.py (the
subset the mapper's checks use); the Umeyama runs in float64 numpy on the
host.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from colmap_tpu_torch.scene.reconstruction import Reconstruction


def align_reconstructions(
    src: Reconstruction, dst: Reconstruction, min_common_images: int = 3
) -> Optional[tuple]:
    """Sim3 (scale, quat, t) mapping src world frame to dst world frame,
    estimated from common registered images' projection centers."""
    common = sorted(
        set(src.reg_image_ids()) & set(dst.reg_image_ids())
    )
    if len(common) < min_common_images:
        return None
    src_centers = np.stack(
        [src.cam_from_world(i).projection_center() for i in common]
    )
    dst_centers = np.stack(
        [dst.cam_from_world(i).projection_center() for i in common]
    )
    # Host float64 Umeyama (scene/similarity_transform.cc behavior): the
    # alignment is over tens of centers — device f32 here put a ~1e-3
    # noise floor under every accuracy metric computed downstream (the
    # mapper's true error is ~1e-6 deg), while costing a device round-trip.
    s, R, t = _umeyama_f64(src_centers.astype(np.float64),
                           dst_centers.astype(np.float64))
    return float(s), _quat_from_rotmat_f64(R), np.asarray(t)


def _quat_from_rotmat_f64(R: np.ndarray) -> np.ndarray:
    """Rotation matrix -> (w, x, y, z) unit quaternion, numpy float64
    (Shepperd's max-pivot branch for numerical safety)."""
    m00, m01, m02 = R[0]
    m10, m11, m12 = R[1]
    m20, m21, m22 = R[2]
    tr = m00 + m11 + m22
    if tr > 0:
        s = np.sqrt(tr + 1.0) * 2
        q = np.array([0.25 * s, (m21 - m12) / s, (m02 - m20) / s,
                      (m10 - m01) / s])
    elif m00 >= m11 and m00 >= m22:
        s = np.sqrt(1.0 + m00 - m11 - m22) * 2
        q = np.array([(m21 - m12) / s, 0.25 * s, (m01 + m10) / s,
                      (m02 + m20) / s])
    elif m11 >= m22:
        s = np.sqrt(1.0 + m11 - m00 - m22) * 2
        q = np.array([(m02 - m20) / s, (m01 + m10) / s, 0.25 * s,
                      (m12 + m21) / s])
    else:
        s = np.sqrt(1.0 + m22 - m00 - m11) * 2
        q = np.array([(m10 - m01) / s, (m02 + m20) / s, (m12 + m21) / s,
                      0.25 * s])
    return q / np.linalg.norm(q)


def _umeyama_f64(src: np.ndarray, dst: np.ndarray):
    """Closed-form similarity transform (Umeyama 1991) in numpy float64."""
    mu_s = src.mean(axis=0)
    mu_d = dst.mean(axis=0)
    cs = src - mu_s
    cd = dst - mu_d
    cov = cd.T @ cs / len(src)
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1.0
    R = U @ S @ Vt
    var_s = (cs ** 2).sum() / len(src)
    s = float(np.trace(np.diag(D) @ S) / max(var_s, 1e-30))
    t = mu_d - s * (R @ mu_s)
    return s, R, t


def apply_sim3(recon: Reconstruction, scale: float, quat: np.ndarray, t: np.ndarray):
    recon.transform(scale, quat, t)


def compare_reconstructions(
    recon: Reconstruction, gt: Reconstruction, align: bool = True
) -> Dict:
    """Per-image rotation (deg) and projection-center errors after optional
    Sim3 alignment onto the ground truth.

    reference behavior: CompareReconstructions (alignment.cc) +
    ReconstructionNear matcher (scene/reconstruction_matchers.h).
    """
    import copy

    test = copy.deepcopy(recon)
    if align:
        sim = align_reconstructions(test, gt)
        if sim is None:
            return {"num_common_images": 0}
        apply_sim3(test, *sim)
    common = sorted(set(test.reg_image_ids()) & set(gt.reg_image_ids()))
    rot_errors, center_errors = [], []
    for iid in common:
        p1 = test.cam_from_world(iid)
        p2 = gt.cam_from_world(iid)
        rot_errors.append(np.rad2deg(p1.angle_to(p2)))
        center_errors.append(
            float(np.linalg.norm(p1.projection_center() - p2.projection_center()))
        )
    return {
        "num_common_images": len(common),
        "rotation_errors_deg": np.array(rot_errors),
        "center_errors": np.array(center_errors),
        "max_rotation_error_deg": float(np.max(rot_errors)) if rot_errors else np.inf,
        "max_center_error": float(np.max(center_errors)) if center_errors else np.inf,
    }
