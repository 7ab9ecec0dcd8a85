"""Reconstruction alignment and comparison.

reference behavior: src/colmap/estimators/alignment.h:42-86
(AlignReconstructions / CompareReconstructions) — Sim3 alignment on common
camera projection centers, then per-image rotation / projection-center
error metrics; and the Sim3 alignment of a model to its images' prior
positions (AlignReconstructionToPosePriors). Counterpart of
colmap_tpu/estimators/alignment.py; the Umeyama (estimators/solvers/
similarity.py) runs in float64 numpy on the host.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from colmap_tpu_torch.estimators.solvers.similarity import umeyama
from colmap_tpu_torch.geometry import rotation as rot
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
    s, R, t = umeyama(src, dst)
    return float(s), R, t


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


def align_reconstruction_to_pose_priors(
    recon: Reconstruction,
    prior_positions: Dict[int, np.ndarray],
    robust_max_error: float = 0.0,
    seed: int = 0,
):
    """Sim3-align a reconstruction to per-image prior positions (e.g. GPS).

    reference behavior: AlignReconstructionToPosePriors (alignment.h:42-86)
    — with robust_max_error > 0 and >= 4 common images, the best of 256
    random triplets by the count of centres within robust_max_error of their
    priors, then Umeyama on its inliers; plain Umeyama otherwise. Transforms
    the reconstruction in place; returns the Sim3 (scale, quat, t) or None
    (colmap_tpu's alignment.py:130, the same triplet draws).
    """
    common = [i for i in recon.reg_image_ids() if i in prior_positions]
    if len(common) < 3:
        return None
    src = np.stack([recon.cam_from_world(i).projection_center() for i in common])
    dst = np.stack([np.asarray(prior_positions[i], dtype=np.float64) for i in common])
    if robust_max_error > 0 and len(common) >= 4:
        rng = np.random.default_rng(seed)
        best = None
        for _ in range(256):
            idx = rng.choice(len(common), 3, replace=False)
            s, R, t = umeyama(src[idx], dst[idx])
            pred = float(s) * src @ R.T + t
            inl = np.linalg.norm(pred - dst, axis=1) <= robust_max_error
            if best is None or inl.sum() > best[0]:
                best = (inl.sum(), inl)
        if best is None or best[0] < 3:
            return None
        s, R, t = umeyama(src[best[1]], dst[best[1]])
    else:
        s, R, t = umeyama(src, dst)
    quat = rot.rotmat_to_quat(torch.as_tensor(np.asarray(R, dtype=np.float64))).numpy()
    recon.transform(float(s), quat, np.asarray(t))
    return (float(s), quat, np.asarray(t))

