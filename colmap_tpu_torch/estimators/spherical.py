"""Spherical (360-degree) two-view geometry on bearing rays.

Counterpart of colmap_tpu/estimators/spherical.py (reference behavior:
EstimateSphericalTwoViewGeometry, two_view_geometry.cc:394-528). A pair of
which one camera has no pinhole image plane (EQUIRECTANGULAR) has no
meaningful F, so it is classified from a bearing-ray essential matrix and a
ray-space homography: CALIBRATED when the homography's support does not
dominate E's, else PLANAR_OR_PANORAMIC; pose recovery decomposes E over
rays, or the homography through identity calibration, and turns the latter
into PANORAMIC (pure rotation) or PLANAR (EstimateTwoViewGeometryPoseFromCamRays,
:813-905).

Both RANSACs are LO-RANSACs over hypothesis batches (optim/ransac.py) whose
batches, refits and inlier masks run in the CUDA kernels K32 (E) and K33 (H)
(kernels/spherical.py), with the rays from K5's ray mode. ``_ransac_e_rays``
and ``_ransac_h_rays`` verify one pair; the ``*_block`` forms a block of
pairs in lockstep (estimators/two_view_batch.py), each pair getting what the
one-pair form gives it. Pixel thresholds become angular ones through each
camera's focal equivalent (width / 2π for EQUIRECTANGULAR). The decision
and the pose recovery are host code and float64 torch ops.
"""

from __future__ import annotations

import numpy as np
import torch

from colmap_tpu_torch.geometry import rotation as rot
from colmap_tpu_torch.geometry.spherical import (  # noqa: F401 (this module's API)
    angular_sampson_error,
    homography_ray_angular_error,
    pose_from_essential_matrix_rays,
)
from colmap_tpu_torch.geometry.triangulation import triangulation_angle
from colmap_tpu_torch.kernels import sfm as K
from colmap_tpu_torch.kernels import spherical as KS
from colmap_tpu_torch.optim.ransac import (
    BlockRansacResult,
    RansacOptions,
    RansacResult,
    ransac_family,
)
from colmap_tpu_torch.scene.types import Pose, TwoViewGeometry, TwoViewGeometryConfig
from colmap_tpu_torch.sensor import models as camera_models
from colmap_tpu_torch.utils.dtypes import floatx, resolve_device

SPHERICAL_MODELS = (int(camera_models.CameraModelId.EQUIRECTANGULAR),)


def is_spherical(camera) -> bool:
    """reference: Camera::IsSpherical (no pinhole image plane)."""
    return int(camera.model_id) in SPHERICAL_MODELS


def camera_rays(camera, xy, device):
    """Unit bearing rays (N, 3) of pixels (N, 2) through K5's ray mode, in
    the device's working dtype."""
    dt = floatx(device)
    rays, _ = K.cam_ray_from_img(camera.model_id,
                                 torch.as_tensor(camera.params, dtype=dt).to(device),
                                 torch.as_tensor(np.asarray(xy)[:, :2], dtype=dt).to(device))
    return rays / torch.clamp(torch.linalg.vector_norm(rays, dim=-1, keepdim=True), min=1e-12)


def spherical_threshold(camera1, camera2, max_error: float) -> float:
    """The pair's angular threshold (rad) of a pixel threshold."""
    return 0.5 * float(camera1.cam_from_img_threshold(max_error)
                       + camera2.cam_from_img_threshold(max_error))


_E = (KS.spherical_e_propose_score, KS.spherical_e_refit, KS.spherical_e_inliers)
_H = (KS.spherical_h_propose_score, KS.spherical_h_refit, KS.spherical_h_inliers)


def _ransac_e_rays(generator, r1, r2, mask, max_error, options: RansacOptions) -> RansacResult:
    """Essential-matrix LO-RANSAC on rays (N, 3): 5-point on rays (up to 10
    solutions a sample), angular Sampson scoring, weighted 8-point refit;
    ``max_error`` in rad."""
    return ransac_family(generator, _E, 5, r1, r2, mask, float(max_error) ** 2, options)


def _ransac_h_rays(generator, r1, r2, mask, max_error, options: RansacOptions) -> RansacResult:
    """Ray-space homography LO-RANSAC on rays (N, 3): 4-ray DLT, angular
    transfer scoring, weighted N-ray refit; ``max_error`` in rad."""
    return ransac_family(generator, _H, 4, r1, r2, mask, float(max_error) ** 2, options)


def _block(generator, kernels, m, r1, r2, mask, max_error, options) -> BlockRansacResult:
    max_sq = torch.as_tensor(np.asarray(max_error, dtype=np.float64) ** 2).to(
        device=r1.device, dtype=r1.dtype)
    return ransac_family(generator, kernels, m, r1, r2, mask, max_sq, options)


def ransac_e_rays_block(generator, r1, r2, mask, max_error, options) -> BlockRansacResult:
    """``_ransac_e_rays`` on a block: r1, r2 (B, N, 3), mask (B, N),
    max_error (B,) rad."""
    return _block(generator, _E, 5, r1, r2, mask, max_error, options)


def ransac_h_rays_block(generator, r1, r2, mask, max_error, options) -> BlockRansacResult:
    """``_ransac_h_rays`` on a block: r1, r2 (B, N, 3), mask (B, N),
    max_error (B,) rad."""
    return _block(generator, _H, 4, r1, r2, mask, max_error, options)


def classify_spherical(g: TwoViewGeometry, options, n_matches: int, num_e: int, num_h: int,
                       mask_e, mask_h, E, H):
    """The decision of EstimateSphericalTwoViewGeometry (colmap_tpu's
    spherical.py l.206-235): fills g's config and models and returns the
    chosen inlier mask (numpy), or None for a DEGENERATE pair."""
    C = TwoViewGeometryConfig
    if num_e < options.min_num_inliers and num_h < options.min_num_inliers:
        g.config = int(C.DEGENERATE)
        return None
    best_mask, best_num = mask_e, num_e
    if num_e >= options.min_num_inliers and num_h <= options.max_H_inlier_ratio * max(num_e, 1):
        g.config, g.E = int(C.CALIBRATED), E
    else:
        g.config, g.H, g.E = int(C.PLANAR_OR_PANORAMIC), H, E
        if num_h > best_num:
            best_mask, best_num = mask_h, num_h
    if options.min_inlier_ratio > 0 and best_num < options.min_inlier_ratio * n_matches:
        g.config = int(C.DEGENERATE)
        return None
    return best_mask


def finish_spherical(g: TwoViewGeometry, options, best_mask, matches, camera1, points1, camera2,
                     points2, device):
    """The inlier matches and (optionally) the relative pose of a classified
    spherical pair."""
    g.inlier_matches = np.asarray(matches)[np.asarray(best_mask)].astype(np.uint32)
    if options.compute_relative_pose:
        recover_spherical_pose(g, camera1, points1, camera2, points2, device)
    return g


def estimate_spherical_two_view_geometry(camera1, points1, camera2, points2, matches, options,
                                         seed: int = 0, device=None) -> TwoViewGeometry:
    """Bearing-ray two-view estimation of one spherical pair on ``device``
    (reference: EstimateSphericalTwoViewGeometry, two_view_geometry.cc:394-528)."""
    from colmap_tpu_torch.estimators.two_view_geometry import ransac_generators

    device = resolve_device(device)
    g = TwoViewGeometry()
    matches = np.asarray(matches)
    if len(matches) < options.min_num_inliers:
        g.config = int(TwoViewGeometryConfig.DEGENERATE)
        return g
    r1 = camera_rays(camera1, np.asarray(points1)[matches[:, 0]], device).contiguous()
    r2 = camera_rays(camera2, np.asarray(points2)[matches[:, 1]], device).contiguous()
    mask = torch.ones(len(matches), dtype=torch.bool, device=device)
    thresh = spherical_threshold(camera1, camera2, options.ransac.max_error)
    _, gen_h, gen_e, _ = ransac_generators(seed)
    res_e = _ransac_e_rays(gen_e, r1, r2, mask, thresh, options.ransac)
    res_h = _ransac_h_rays(gen_h, r1, r2, mask, thresh, options.ransac)
    best_mask = classify_spherical(
        g, options, len(matches), res_e.num_inliers, res_h.num_inliers,
        res_e.inlier_mask.cpu().numpy(), res_h.inlier_mask.cpu().numpy(),
        res_e.model.double().cpu().numpy(), res_h.model.double().cpu().numpy())
    if best_mask is None:
        return g
    return finish_spherical(g, options, best_mask, matches, camera1, points1, camera2, points2,
                            device)


def recover_spherical_pose(g: TwoViewGeometry, camera1, points1, camera2, points2, device=None):
    """Pose recovery over bearing rays (EstimateTwoViewGeometryPoseFromCamRays,
    two_view_geometry.cc:813-905): the ray homography through identity
    calibration for PLANAR_OR_PANORAMIC (a pure rotation becomes PANORAMIC
    with tri_angle 0, else PLANAR), E's decomposition for CALIBRATED."""
    from colmap_tpu_torch.geometry.homography import pose_from_homography_matrix

    if len(g.inlier_matches) < 5:
        return
    device = resolve_device(device)
    r1 = camera_rays(camera1, np.asarray(points1)[g.inlier_matches[:, 0]], device).double()
    r2 = camera_rays(camera2, np.asarray(points2)[g.inlier_matches[:, 1]], device).double()
    C = TwoViewGeometryConfig
    if g.config == int(C.PLANAR_OR_PANORAMIC):
        eye = np.eye(3)
        R, t, _, X, count = pose_from_homography_matrix(np.asarray(g.H), eye, eye,
                                                        r1.cpu().numpy(), r2.cpu().numpy())
        if np.dot(t, t) < 1e-12:
            g.config, g.tri_angle = int(C.PANORAMIC), 0.0
        else:
            g.config = int(C.PLANAR)
            if count > 0:
                ang = triangulation_angle(torch.zeros(3, dtype=torch.float64),
                                          torch.as_tensor(-R.T @ t), torch.as_tensor(X))
                g.tri_angle = float(np.median(ang.numpy())) if len(ang) else 0.0
        g.cam2_from_cam1 = Pose(rot.rotmat_to_quat(torch.as_tensor(R)).numpy(), np.asarray(t))
        return
    if g.E is None:
        return
    E = torch.as_tensor(np.asarray(g.E), dtype=torch.float64, device=r1.device)
    R, t, X, _, ok = pose_from_essential_matrix_rays(E, r1, r2)
    g.cam2_from_cam1 = Pose(rot.rotmat_to_quat(R).cpu().numpy(), t.cpu().numpy())
    if bool(ok.any()):
        ang = triangulation_angle(torch.zeros(3, dtype=torch.float64, device=r1.device),
                                  -(R.T @ t), X)
        g.tri_angle = float(np.median(ang[ok].cpu().numpy()))
    else:
        g.tri_angle = 0.0
