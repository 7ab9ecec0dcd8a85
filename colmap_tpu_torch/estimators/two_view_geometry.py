"""Two-view geometric verification.

Counterpart of colmap_tpu/estimators/two_view_geometry.py (reference
behavior: src/colmap/estimators/two_view_geometry.{h,cc}): a calibrated pair
estimates E, F and H, an uncalibrated pair F and H, and a decision tree on
the inlier counts picks the configuration (CALIBRATED / UNCALIBRATED /
PLANAR_OR_PANORAMIC / DEGENERATE, :57-118). Every model family is a
hypothesis-batch LO-RANSAC (optim/ransac.py) whose batches, refits and
inlier masks run in CUDA kernels: K7 (E, kernels/sfm.py), K11 (F) and K12
(H, kernels/matching.py). ``_ransac_f``, ``_ransac_h`` and ``_ransac_e``
verify one pair; the ``*_block`` forms verify a block of pairs in lockstep
(estimators/two_view_batch.py) and give each pair what the one-pair form
gives it. The decision tree, watermark detection, pose recovery and focal
recovery are host code.

Each model family draws its samples from its own CPU generator
(``ransac_generators``), so a family's sample stream does not depend on how
many batches another family ran.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from colmap_tpu_torch.geometry import rotation as rot
from colmap_tpu_torch.geometry.essential import (
    essential_from_fundamental,
    essential_from_pose,
    pose_from_essential_matrix,
    sampson_error,
)
from colmap_tpu_torch.geometry.triangulation import triangulation_angle
from colmap_tpu_torch.kernels import matching as KM
from colmap_tpu_torch.kernels import sfm as K
from colmap_tpu_torch.optim.ransac import (
    BlockRansacResult,
    RansacOptions,
    RansacResult,
    ransac,
    ransac_block,
)
from colmap_tpu_torch.scene.types import Camera, Pose, TwoViewGeometry, TwoViewGeometryConfig
from colmap_tpu_torch.sensor import models as camera_models
from colmap_tpu_torch.utils.dtypes import floatx, resolve_device



def is_spherical(camera: Camera) -> bool:
    """Spherical cameras have no image-space F or H; their ray-space
    verification is not ported yet."""
    return int(camera.model_id) == int(camera_models.CameraModelId.EQUIRECTANGULAR)


@dataclasses.dataclass
class TwoViewGeometryOptions:
    """reference: estimators/two_view_geometry.h:45-131."""

    min_num_inliers: int = 15
    min_inlier_ratio: float = 0.0
    min_E_F_inlier_ratio: float = 0.95
    max_H_inlier_ratio: float = 0.8
    watermark_min_inlier_ratio: float = 0.7
    watermark_border_size: float = 0.1
    detect_watermark: bool = True
    watermark_detection_max_error: float = 4.0
    force_H_use: bool = False
    compute_relative_pose: bool = False
    # Estimate several configurations by removing the previous inlier set
    # until no model with enough support remains; more than one model gives
    # MULTIPLE with the union of the inliers (two_view_geometry.h:108-117).
    multiple_models: bool = False
    multiple_ignore_watermark: bool = True
    # Drop matches whose two keypoints barely move between the images
    # (FilterStationaryMatches, two_view_geometry.cc:1570).
    filter_stationary_matches: bool = False
    stationary_matches_max_error: float = 4.0
    # Dominant-plane-robust F (two_view_geometry.h:103 DEGENSAC).
    use_degensac: bool = False
    # Focal recovery for uncalibrated pairs (two_view_geometry.cc:560-640).
    estimate_focals: bool = True
    ransac: RansacOptions = dataclasses.field(
        default_factory=lambda: RansacOptions(
            max_error=4.0, confidence=0.999, min_num_trials=100, max_num_trials=10000,
            min_inlier_ratio=0.25, batch_size=128))


def ransac_generators(seed: int):
    """CPU generators of the F, H and E RANSACs and of DEGENSAC for ``seed``."""
    return tuple(torch.Generator().manual_seed(4 * int(seed) + k) for k in range(4))


def _ransac_f(generator: torch.Generator, x1, x2, mask, options: RansacOptions) -> RansacResult:
    """Fundamental-matrix LO-RANSAC on pixel coordinates (N, 2): 7-point
    minimal solver (up to 3 solutions per sample), weighted 8-point refit."""
    max_sq = float(options.max_error) ** 2
    return ransac(
        generator, mask, 7,
        lambda idxs: KM.fundamental_propose_score(x1, x2, mask, idxs, max_sq),
        lambda model: KM.fundamental_inliers(x1, x2, mask, model, max_sq),
        options,
        local_refine=lambda model, count: KM.fundamental_refit(x1, x2, mask, model, max_sq, count),
    )


def _ransac_h(generator: torch.Generator, x1, x2, mask, options: RansacOptions) -> RansacResult:
    """Homography LO-RANSAC on pixel coordinates (N, 2): 4-point DLT,
    weighted N-point DLT refit, forward transfer error."""
    max_sq = float(options.max_error) ** 2
    return ransac(
        generator, mask, 4,
        lambda idxs: KM.homography_propose_score(x1, x2, mask, idxs, max_sq),
        lambda model: KM.homography_inliers(x1, x2, mask, model, max_sq),
        options,
        local_refine=lambda model, count: KM.homography_refit(x1, x2, mask, model, max_sq, count),
    )


def _ransac_e(generator: torch.Generator, x1n, x2n, mask, max_error,
              options: RansacOptions) -> RansacResult:
    """Essential-matrix LO-RANSAC on normalized coordinates (N, 2): 5-point
    minimal solver (up to 10 solutions per sample) and weighted 8-point LO
    refit, the reference's LORANSAC<EssentialMatrixFivePointEstimator>
    (estimators/two_view_geometry.cc:569-636). ``max_error`` is compared
    with the square root of the Sampson error."""
    max_sq = float(max_error) ** 2
    return ransac(
        generator, mask, 5,
        lambda idxs: K.essential_propose_score(x1n, x2n, mask, idxs, max_sq),
        lambda model: K.essential_inliers(x1n, x2n, mask, model, max_sq),
        options,
        local_refine=lambda model, count: K.essential_refit(x1n, x2n, mask, model, max_sq,
                                                            count),
    )


def _block(generator, kernels, m, x1, x2, mask, max_sq, options) -> BlockRansacResult:
    propose, refit, inliers = kernels
    return ransac_block(
        generator, mask, m,
        lambda idxs, active: propose(x1, x2, mask, idxs, max_sq, active),
        lambda models: inliers(x1, x2, mask, models, max_sq),
        options,
        local_refine=lambda models, counts: refit(x1, x2, mask, models, max_sq, counts),
    )


def _ransac_f_block(generator, x1, x2, mask, options: RansacOptions) -> BlockRansacResult:
    """``_ransac_f`` on a block: x1, x2 (B, N, 2), mask (B, N)."""
    return _block(generator, (KM.fundamental_propose_score, KM.fundamental_refit,
                              KM.fundamental_inliers), 7, x1, x2, mask,
                  float(options.max_error) ** 2, options)


def _ransac_h_block(generator, x1, x2, mask, options: RansacOptions) -> BlockRansacResult:
    """``_ransac_h`` on a block: x1, x2 (B, N, 2), mask (B, N)."""
    return _block(generator, (KM.homography_propose_score, KM.homography_refit,
                              KM.homography_inliers), 4, x1, x2, mask,
                  float(options.max_error) ** 2, options)


def _ransac_e_block(generator, x1n, x2n, mask, max_error,
                    options: RansacOptions) -> BlockRansacResult:
    """``_ransac_e`` on a block: x1n, x2n (B, N, 2), mask (B, N), max_error
    (B,) float64 array, one normalized threshold per pair."""
    max_sq = torch.as_tensor(np.asarray(max_error, dtype=np.float64) ** 2).to(
        device=x1n.device, dtype=x1n.dtype)
    return _block(generator, (K.essential_propose_score, K.essential_refit, K.essential_inliers),
                  5, x1n, x2n, mask, max_sq, options)


def _detect_watermark(x1, x2, inlier_mask, w1, h1, w2, h2, opt) -> bool:
    """reference behavior: two_view_geometry.cc DetectWatermark (:70-88):
    inliers in the border region that move by a pure translation."""
    inl = np.asarray(inlier_mask)
    if inl.sum() == 0:
        return False
    p1 = np.asarray(x1)[inl]
    p2 = np.asarray(x2)[inl]
    diff = p2 - p1
    med = np.median(diff, axis=0)
    trans_ok = np.sum((diff - med) ** 2, axis=1) <= opt.watermark_detection_max_error**2
    if trans_ok.mean() < opt.watermark_min_inlier_ratio:
        return False
    b1 = opt.watermark_border_size * np.sqrt(w1 * h1)
    b2 = opt.watermark_border_size * np.sqrt(w2 * h2)
    in_border1 = (p1[:, 0] < b1) | (p1[:, 0] > w1 - b1) | (p1[:, 1] < b1) | (p1[:, 1] > h1 - b1)
    in_border2 = (p2[:, 0] < b2) | (p2[:, 0] > w2 - b2) | (p2[:, 1] < b2) | (p2[:, 1] > h2 - b2)
    border_ratio = np.mean(in_border1 & in_border2 & trans_ok)
    return bool(border_ratio > opt.watermark_min_inlier_ratio)


def filter_stationary(points1, points2, matches, max_error):
    """The matches whose keypoints move by more than ``max_error`` px."""
    disp = np.asarray(points1)[matches[:, 0]] - np.asarray(points2)[matches[:, 1]]
    return matches[np.sum(disp * disp, axis=1) > max_error**2]


def _np(x):
    return x.double().cpu().numpy()


def classify(g: TwoViewGeometry, options: TwoViewGeometryOptions, calibrated: bool, num_matches,
             num_f, num_h, num_e, mask_f, mask_h, mask_e, F, H, E, F_from_E, camera1, camera2):
    """The configuration decision tree on the three RANSAC results
    (two_view_geometry.cc:57-118). Models are numpy (3, 3) arrays, masks
    numpy (M,) bool; E, F_from_E and mask_e are read for calibrated pairs
    only. Fills g's config and models and returns the chosen inlier mask,
    or None for a DEGENERATE pair."""
    C = TwoViewGeometryConfig
    if options.force_H_use:
        best_mask, best_num = mask_h, num_h
        g.config, g.H = int(C.PLANAR_OR_PANORAMIC), H
    elif (calibrated and num_e >= options.min_num_inliers
          and num_e > options.min_E_F_inlier_ratio * num_f):
        best_mask, best_num = mask_e, num_e
        g.config, g.E, g.F = int(C.CALIBRATED), E, F_from_E
        if num_h > options.max_H_inlier_ratio * num_e:
            g.config, g.H = int(C.PLANAR_OR_PANORAMIC), H
    elif num_f >= options.min_num_inliers:
        best_mask, best_num = mask_f, num_f
        g.config, g.F = int(C.UNCALIBRATED), F
        if num_h > options.max_H_inlier_ratio * num_f:
            g.config, g.H = int(C.PLANAR_OR_PANORAMIC), H
        elif options.estimate_focals:
            _estimate_uncalibrated_focals(g, camera1, camera2)
    elif num_h >= options.min_num_inliers:
        best_mask, best_num = mask_h, num_h
        g.config, g.H = int(C.PLANAR_OR_PANORAMIC), H
    else:
        g.config = int(C.DEGENERATE)
        return None
    if best_num < options.min_num_inliers or (
            options.min_inlier_ratio > 0 and best_num < options.min_inlier_ratio * num_matches):
        g.config = int(C.DEGENERATE)
        return None
    return best_mask


def finish_geometry(g, options, best_mask, matches, x1, x2, camera1, points1, camera2, points2,
                    device):
    """Watermark test, inlier matches and (optionally) the relative pose of
    a classified pair."""
    if options.detect_watermark and _detect_watermark(
            x1, x2, best_mask, camera1.width, camera1.height, camera2.width, camera2.height,
            options):
        g.config = int(TwoViewGeometryConfig.WATERMARK)
    g.inlier_matches = matches[best_mask].astype(np.uint32)
    C = TwoViewGeometryConfig
    if options.compute_relative_pose and g.config in (
            int(C.CALIBRATED), int(C.UNCALIBRATED), int(C.PLANAR_OR_PANORAMIC)):
        _recover_pose(g, camera1, points1, camera2, points2, device)
    return g


def estimate_two_view_geometry(
    camera1: Camera,
    points1: np.ndarray,
    camera2: Camera,
    points2: np.ndarray,
    matches: np.ndarray,
    options: Optional[TwoViewGeometryOptions] = None,
    seed: int = 0,
    device=None,
) -> TwoViewGeometry:
    """Estimate and classify the two-view geometry of a matched image pair
    on ``device`` (default cuda).

    points1/points2: (N1, 2), (N2, 2) keypoint coordinates; matches (M, 2)
    uint32 index pairs into them.
    """
    if options is None:
        options = TwoViewGeometryOptions()
    device = resolve_device(device)
    matches = np.asarray(matches)
    if options.filter_stationary_matches and len(matches) > 0:
        matches = filter_stationary(points1, points2, matches,
                                    options.stationary_matches_max_error)
    if options.multiple_models:
        sub = dataclasses.replace(options, multiple_models=False,
                                  filter_stationary_matches=False)
        return estimate_multiple_two_view_geometries(camera1, points1, camera2, points2, matches,
                                                     sub, seed=seed, device=device)
    if is_spherical(camera1) or is_spherical(camera2):
        raise NotImplementedError(
            "two-view geometry of spherical cameras is not ported yet (ROADMAP queue 1)")

    g = TwoViewGeometry()
    n_matches = len(matches)
    if n_matches < options.min_num_inliers:
        g.config = int(TwoViewGeometryConfig.DEGENERATE)
        return g

    dt = floatx(device)
    x1_np = np.asarray(points1)[matches[:, 0]][:, :2].astype(np.float64)
    x2_np = np.asarray(points2)[matches[:, 1]][:, :2].astype(np.float64)
    x1 = torch.as_tensor(x1_np, dtype=dt).to(device).contiguous()
    x2 = torch.as_tensor(x2_np, dtype=dt).to(device).contiguous()
    mask = torch.ones(n_matches, dtype=torch.bool, device=device)
    gen_f, gen_h, gen_e, gen_d = ransac_generators(seed)
    calibrated = bool(camera1.has_prior_focal_length and camera2.has_prior_focal_length)

    res_f = _ransac_f(gen_f, x1, x2, mask, options.ransac)
    res_h = _ransac_h(gen_h, x1, x2, mask, options.ransac)
    res_e = None
    if calibrated:
        x1n, _ = K.cam_from_img(camera1.model_id, torch.as_tensor(camera1.params, dtype=dt).to(device), x1)
        x2n, _ = K.cam_from_img(camera2.model_id, torch.as_tensor(camera2.params, dtype=dt).to(device), x2)
        thresh_n = 0.5 * (camera1.cam_from_img_threshold(options.ransac.max_error)
                          + camera2.cam_from_img_threshold(options.ransac.max_error))
        res_e = _ransac_e(gen_e, x1n.contiguous(), x2n.contiguous(), mask, float(thresh_n),
                          options.ransac)

    num_f, num_h = res_f.num_inliers, res_h.num_inliers
    num_e = res_e.num_inliers if res_e is not None else 0
    F_model, mask_f = res_f.model, res_f.inlier_mask

    if options.use_degensac and num_f >= options.min_num_inliers:
        from colmap_tpu_torch.estimators.degensac import degensac_recover_f, is_h_degenerate

        num_fh = int((mask_f & res_h.inlier_mask).sum())
        if is_h_degenerate(num_f, num_fh):
            F_rec, n_rec, inl_rec, recovered = degensac_recover_f(
                gen_d, x1, x2, mask, F_model, mask_f, res_h.model, res_h.inlier_mask,
                options.ransac)
            if recovered:
                F_model, mask_f, num_f = F_rec, inl_rec, n_rec

    mask_e = E = F_from_E = None
    if calibrated:
        mask_e, E = res_e.inlier_mask.cpu().numpy(), _np(res_e.model)
        F_from_E = _np(KM.fundamental_fit(x1, x2, res_e.inlier_mask))
    best_mask = classify(
        g, options, calibrated, n_matches, num_f, num_h, num_e, mask_f.cpu().numpy(),
        res_h.inlier_mask.cpu().numpy(), mask_e, _np(F_model), _np(res_h.model), E, F_from_E,
        camera1, camera2)
    if best_mask is None:
        return g
    return finish_geometry(g, options, best_mask, matches, x1_np, x2_np, camera1, points1,
                           camera2, points2, device)


def _normalized(camera, x, device):
    dt = floatx(device)
    xn, _ = K.cam_from_img(camera.model_id, torch.as_tensor(camera.params, dtype=dt).to(device),
                           torch.as_tensor(np.asarray(x), dtype=dt).to(device).contiguous())
    return xn


def two_view_geometry_from_known_relative_pose(
    camera1: Camera,
    points1: np.ndarray,
    camera2: Camera,
    points2: np.ndarray,
    cam2_from_cam1: Pose,
    matches: np.ndarray,
    min_num_inliers: int = 15,
    max_error: float = 4.0,
    device=None,
) -> TwoViewGeometry:
    """Classify matches against a known relative pose, without estimation
    (TwoViewGeometryFromKnownRelativePose, two_view_geometry.cc:1586-1641):
    E from the pose, the matches whose Sampson error is within ``max_error``
    px (through the cameras' focal lengths), CALIBRATED when enough remain."""
    device = resolve_device(device)
    g = TwoViewGeometry()
    matches = np.asarray(matches)
    if len(matches) < min_num_inliers:
        g.config = int(TwoViewGeometryConfig.DEGENERATE)
        return g
    x1n = _normalized(camera1, np.asarray(points1)[matches[:, 0]][:, :2], device)
    x2n = _normalized(camera2, np.asarray(points2)[matches[:, 1]][:, :2], device)
    E = essential_from_pose(torch.as_tensor(cam2_from_cam1.quat, dtype=x1n.dtype).to(device),
                            torch.as_tensor(cam2_from_cam1.t, dtype=x1n.dtype).to(device))
    thresh = 0.5 * (camera1.cam_from_img_threshold(max_error)
                    + camera2.cam_from_img_threshold(max_error))
    inl = (sampson_error(E, x1n, x2n) <= thresh * thresh).cpu().numpy()
    if int(inl.sum()) < min_num_inliers:
        g.config = int(TwoViewGeometryConfig.DEGENERATE)
        return g
    g.config = int(TwoViewGeometryConfig.CALIBRATED)
    g.E = _np(E)
    g.cam2_from_cam1 = cam2_from_cam1
    g.inlier_matches = matches[inl].astype(np.uint32)
    return g


def extract_outlier_matches(matches: np.ndarray, inlier_matches: np.ndarray) -> np.ndarray:
    """Matches not present in inlier_matches (ExtractOutlierMatches,
    two_view_geometry.cc:157)."""
    matches = np.asarray(matches)
    if len(inlier_matches) == 0:
        return matches
    inl = {(int(a), int(b)) for a, b in np.asarray(inlier_matches)}
    keep = np.fromiter(((int(a), int(b)) not in inl for a, b in matches), dtype=bool,
                       count=len(matches))
    return matches[keep]


def estimate_multiple_two_view_geometries(
    camera1: Camera,
    points1: np.ndarray,
    camera2: Camera,
    points2: np.ndarray,
    matches: np.ndarray,
    options: TwoViewGeometryOptions,
    seed: int = 0,
    device=None,
) -> TwoViewGeometry:
    """Estimate a geometry, remove its inliers and repeat until DEGENERATE
    (EstimateMultipleTwoViewGeometries, two_view_geometry.cc:339-382): one
    surviving model keeps its configuration, several give MULTIPLE with the
    concatenated inlier matches and no single model."""
    remaining = np.asarray(matches)
    geometries = []
    round_idx = 0
    while True:
        g = estimate_two_view_geometry(camera1, points1, camera2, points2, remaining, options,
                                       seed=seed + round_idx, device=device)
        round_idx += 1
        if g.config == int(TwoViewGeometryConfig.DEGENERATE):
            break
        remaining = extract_outlier_matches(remaining, g.inlier_matches)
        if not (options.multiple_ignore_watermark
                and g.config == int(TwoViewGeometryConfig.WATERMARK)):
            geometries.append(g)
    if len(geometries) == 1:
        return geometries[0]
    out = TwoViewGeometry()
    if not geometries:
        out.config = int(TwoViewGeometryConfig.DEGENERATE)
        return out
    out.config = int(TwoViewGeometryConfig.MULTIPLE)
    out.inlier_matches = np.concatenate([g.inlier_matches for g in geometries],
                                        axis=0).astype(np.uint32)
    return out


def _calibration_matrix(camera: Camera) -> np.ndarray:
    f_idxs = camera_models.focal_length_idxs(camera.model_id)
    pp_idxs = camera_models.principal_point_idxs(camera.model_id)
    p = camera.params
    fx = p[f_idxs[0]]
    fy = p[f_idxs[1]] if len(f_idxs) > 1 else fx
    return np.array([[fx, 0, p[pp_idxs[0]]], [0, fy, p[pp_idxs[1]]], [0, 0, 1.0]])


def _recover_pose(g: TwoViewGeometry, camera1, points1, camera2, points2, device=None):
    """Decompose E (or F upgraded by the intrinsics) into a relative pose
    (EstimateTwoViewGeometryPose, two_view_geometry.cc:929)."""
    if len(g.inlier_matches) < 8:
        return
    device = resolve_device(device)
    # Intrinsics recovered by the focal paths take precedence.
    camera1 = g.camera1 if g.camera1 is not None else camera1
    camera2 = g.camera2 if g.camera2 is not None else camera2
    x1n = _normalized(camera1, np.asarray(points1)[g.inlier_matches[:, 0]][:, :2], device)
    x2n = _normalized(camera2, np.asarray(points2)[g.inlier_matches[:, 1]][:, :2], device)
    if g.config == int(TwoViewGeometryConfig.PLANAR_OR_PANORAMIC) and g.H is not None:
        _recover_pose_planar_or_panoramic(g, camera1, camera2, _np(x1n), _np(x2n))
        return
    dt = x1n.dtype
    if g.E is not None:
        E = torch.as_tensor(g.E, dtype=dt).to(device)
    else:
        E = essential_from_fundamental(
            torch.as_tensor(_calibration_matrix(camera2), dtype=dt).to(device),
            torch.as_tensor(g.F, dtype=dt).to(device),
            torch.as_tensor(_calibration_matrix(camera1), dtype=dt).to(device))
    R, t, points3D, _, ok = pose_from_essential_matrix(E, x1n, x2n)
    g.cam2_from_cam1 = Pose(_np(rot.rotmat_to_quat(R)), _np(t))
    angles = triangulation_angle(torch.zeros(3, dtype=dt, device=device), -(R.T @ t), points3D)
    ok = ok.cpu().numpy()
    g.tri_angle = float(np.median(_np(angles)[ok])) if ok.any() else 0.0


def _recover_pose_planar_or_panoramic(g, camera1, camera2, x1n, x2n):
    """Resolve a PLANAR_OR_PANORAMIC pair by decomposing its homography
    (two_view_geometry.cc:875-905): a pure rotation is PANORAMIC with
    tri_angle 0, otherwise PLANAR with the triangulated points' median angle."""
    from colmap_tpu_torch.geometry.homography import pose_from_homography_matrix

    def rays(xn):
        r = np.concatenate([xn, np.ones((len(xn), 1))], axis=1)
        return r / np.linalg.norm(r, axis=1, keepdims=True)

    R, t, _, points3D, count = pose_from_homography_matrix(
        np.asarray(g.H), _calibration_matrix(camera1), _calibration_matrix(camera2),
        rays(x1n), rays(x2n))
    if np.dot(t, t) < 1e-12:
        g.config = int(TwoViewGeometryConfig.PANORAMIC)
        g.tri_angle = 0.0
    else:
        g.config = int(TwoViewGeometryConfig.PLANAR)
        if count == 0:
            return
        angles = triangulation_angle(torch.zeros(3, dtype=torch.float64),
                                     torch.as_tensor(-R.T @ t), torch.as_tensor(points3D))
        g.tri_angle = float(np.median(angles.numpy())) if len(angles) else 0.0
    g.cam2_from_cam1 = Pose(rot.rotmat_to_quat(torch.as_tensor(R)).numpy(), np.asarray(t))


def _estimate_uncalibrated_focals(g: TwoViewGeometry, camera1, camera2):
    """Recover focal lengths for an UNCALIBRATED pair from its F
    (EstimateSharedFocalTwoViewGeometry / EstimateOneSidedFocalTwoViewGeometry,
    two_view_geometry.cc:1155-1400): the configuration stays UNCALIBRATED,
    the estimated intrinsics go into g.camera1 / g.camera2 and E is filled
    from them, so that pose recovery can use the recovered calibration."""
    from colmap_tpu_torch.estimators.solvers.focal import (
        one_sided_focal_from_geometry,
        shared_focal_from_fundamental,
        two_focals_from_fundamental,
    )

    F = np.asarray(g.F, dtype=np.float64)

    def principal_point(cam):
        i, j = camera_models.principal_point_idxs(int(cam.model_id))
        return np.asarray([cam.params[i], cam.params[j]])

    def set_focal(cam, focal):
        new = dataclasses.replace(cam, params=np.asarray(cam.params, dtype=np.float64).copy())
        for i in camera_models.focal_length_idxs(int(cam.model_id)):
            new.params[i] = focal
        new.has_prior_focal_length = False
        return new

    c1, c2 = principal_point(camera1), principal_point(camera2)
    if camera1.has_prior_focal_length == camera2.has_prior_focal_length:
        if camera1.camera_id == camera2.camera_id:
            focal, ok = shared_focal_from_fundamental(F, c1, c2)
            if not ok:
                return
            g.camera1 = set_focal(camera1, focal)
            g.camera2 = g.camera1
        else:
            f1, f2, ok = two_focals_from_fundamental(F, c1, c2)
            if not ok:
                return
            g.camera1 = set_focal(camera1, f1)
            g.camera2 = set_focal(camera2, f2)
    else:
        # One side calibrated: the other side's focal from G = T2ᵀ F K1.
        flipped = camera1.has_prior_focal_length
        cam_known, cam_unknown = (camera1, camera2) if flipped else (camera2, camera1)
        Fd = F if flipped else F.T
        cu = c2 if flipped else c1
        T = np.array([[1.0, 0.0, cu[0]], [0.0, 1.0, cu[1]], [0.0, 0.0, 1.0]])
        G = T.T @ Fd @ _calibration_matrix(cam_known)
        max_dim = float(max(cam_unknown.width, cam_unknown.height))
        focal, score = one_sided_focal_from_geometry(G, 0.1 * max_dim, 10.0 * max_dim)
        if not np.isfinite(focal) or score > 0.05:
            return
        est = set_focal(cam_unknown, focal)
        g.camera1, g.camera2 = (camera1, est) if flipped else (est, camera2)
    g.E = _calibration_matrix(g.camera2).T @ F @ _calibration_matrix(g.camera1)
