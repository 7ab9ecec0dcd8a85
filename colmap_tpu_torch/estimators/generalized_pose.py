"""Generalized (multi-camera rig) absolute pose, and structure-less absolute
pose.

Counterpart of colmap_tpu/estimators/generalized_pose.py (reference
behavior: estimators/generalized_pose.{h,cc}). Ported here:

- ``estimate_generalized_absolute_pose``: rig registration
  (EstimateGeneralizedAbsolutePose, incremental_mapper.cc:608), an
  LO-RANSAC over 6-point linear gDLT hypotheses on the ray-transfer
  constraint d × (R X + t - c) = 0, each scored by its reprojection error
  through every correspondence's camera. The batches run in the CUDA kernel
  K27 (kernels/rig.py) on the card, the host loop in optim/ransac.py, the
  local refit (weighted gDLT over the inliers) in K40 (b), float64, one
  launch and one host read (the refit's support);
- ``refine_generalized_absolute_pose``: up to 30 Cauchy-weighted LM
  iterations in float64 over the rig's 6-DoF tangent with the analytic
  Jacobian, all of them in one launch of K40 (a) and one host read;
- ``estimate_structure_less_absolute_pose``: a new camera from 2D-2D
  correspondences (EstimateStructureLessAbsolutePose, the mapper's fallback
  when an image has too few 2D-3D correspondences,
  incremental_mapper.cc:673-870). 5 + 1 RANSAC: five correspondences to one
  registered camera give the essential matrices new <- that camera
  (Nistér), cheirality picks (R, t direction) of each; one correspondence
  to another registered camera fixes the scale of t from its epipolar
  constraint. A model is scored by the generalized Sampson error of every
  correspondence against its own camera. Each batch is one launch of K37
  (kernels/solver.py structure_less_score) on the mapper's device; samples
  come from a seeded CPU ``torch.Generator`` and the host reads one packed
  best (8 bytes) per batch.

- ``estimate_generalized_relative_pose``: rig2_from_rig1 from 2D-2D
  correspondences between two rig frames (EstimateGeneralizedRelativePose):
  an LO-RANSAC over 17-point linear solves of the generalized epipolar
  constraint on Plücker rays (Li & Hartley), each model scored by the
  Sampson error of every row's own camera pair times focal². Each batch is
  one launch of K48 (kernels/rig.py gen_rel_propose_score) and one 8-byte
  read; the LO refit, the weighted 17-point solve over every row with the
  best model's inliers as weights, is one launch of K48 (c) in float64.
  colmap_tpu takes the nullspace vector's sign as eigh returns it; here it
  is fixed so that the rotation block has det >= 0, the sign for which the
  projection onto SO(3) is the rotation (ROADMAP §3).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from colmap_tpu_torch.geometry import rotation as rot
from colmap_tpu_torch.kernels import rig as KR
from colmap_tpu_torch.kernels import sfm as K
from colmap_tpu_torch.kernels import solver as KS
from colmap_tpu_torch.optim.ransac import RansacOptions, ransac, unpack_best
from colmap_tpu_torch.scene.types import Camera, Pose
from colmap_tpu_torch.utils.dtypes import floatx


@dataclasses.dataclass
class GeneralizedAbsolutePoseOptions:
    """reference: RANSACOptions passed into EstimateGeneralizedAbsolutePose
    (sfm/incremental_mapper.cc:596-600)."""

    max_error_px: float = 12.0
    min_inlier_ratio: float = 0.1
    confidence: float = 0.9999
    min_num_trials: int = 100
    max_num_trials: int = 10000
    batch_size: int = 64


def _normalize_observations(points2D, camera_idxs, cameras: Sequence[Camera], device, dtype):
    """Pixel observations undistorted into their cameras' normalized
    coordinates (K5 in float32 on the card), and each one's camera mean
    focal length, as ``dtype``."""
    n = len(points2D)
    uv = torch.zeros((n, 2), dtype=dtype, device=device)
    focal = np.zeros(n)
    for ci, cam in enumerate(cameras):
        sel = np.nonzero(camera_idxs == ci)[0]
        if len(sel):
            uv[torch.as_tensor(sel, device=device)] = _unproject(
                cam, points2D[sel], device, floatx(device)).to(dtype)
            focal[sel] = cam.mean_focal_length()
    return uv, torch.as_tensor(focal, dtype=dtype).to(device)


def gen_abs_data(points2D, points3D, camera_idxs, cams_from_rig: Sequence[Pose],
                 cameras: Sequence[Camera], device, dtype) -> KR.GenAbsData:
    """The correspondences on ``device``: rays in rig coordinates (origin the
    camera centre, direction the rotated bearing) beside the normalized
    observations and their cameras' cam_from_rig."""
    camera_idxs = np.asarray(camera_idxs, dtype=np.int64)
    uv, focal = _normalize_observations(np.asarray(points2D, dtype=np.float64), camera_idxs,
                                        cameras, device, dtype)

    def dev(a):
        return torch.as_tensor(np.asarray(a, dtype=np.float64), dtype=dtype).to(device)

    cam_q = dev(np.stack([cams_from_rig[ci].quat for ci in camera_idxs]))
    cam_t = dev(np.stack([cams_from_rig[ci].t for ci in camera_idxs]))
    q_inv = rot.quat_conjugate(cam_q)
    bearings = torch.nn.functional.normalize(torch.cat([uv, torch.ones_like(uv[:, :1])], 1), dim=1)
    return KR.GenAbsData(dev(points3D).contiguous(), (-rot.quat_rotate(q_inv, cam_t)).contiguous(),
                         rot.quat_rotate(q_inv, bearings).contiguous(), uv.contiguous(),
                         cam_q.contiguous(), cam_t.contiguous(), focal.contiguous(),
                         torch.ones(len(camera_idxs), dtype=torch.bool, device=device))


def _gen_abs_refit(data: KR.GenAbsData, model, max_sq, count, estimate_scale):
    """``_try_refine``: weighted gDLT (K40 (b), float64) on the inliers of
    ``model``, kept where it is finite and its support (K27) is larger; the
    finite test stays on the device, the host reads the support once."""
    inl = KR.gen_abs_inliers(data, model, max_sq)
    X, c, d = (x.double() for x in (data.X, data.centers, data.dirs))
    refined, ok = KR.gen_abs_refit(X, c, d, inl.double(), estimate_scale)
    refined = refined.to(model.dtype)
    count_r = int(torch.where(ok[0], KR.gen_abs_inliers(data, refined, max_sq).sum(), -1))
    return (refined, count_r) if count_r > count else (model, count)


def estimate_generalized_absolute_pose(
    points2D: np.ndarray,
    points3D: np.ndarray,
    camera_idxs: np.ndarray,
    cams_from_rig: Sequence[Pose],
    cameras: Sequence[Camera],
    options: Optional[GeneralizedAbsolutePoseOptions] = None,
    seed: int = 0,
    estimate_scale: bool = False,
    device=None,
) -> Tuple[Optional[Pose], np.ndarray, float]:
    """Rig registration from 2D-3D correspondences across the rig's cameras
    on ``device``. Returns (rig_from_world | None, inlier_mask, world_scale):
    with ``estimate_scale`` the scale s maps world points into the rig's
    metric frame (X_metric = s X_world); otherwise s == 1.
    reference: estimators/generalized_pose.h:57.
    """
    options = options or GeneralizedAbsolutePoseOptions()
    n = len(points2D)
    if n < KR.GDLT_SAMPLE:
        return None, np.zeros(n, dtype=bool), 1.0
    device = torch.device(device or "cuda")
    data = gen_abs_data(points2D, points3D, camera_idxs, cams_from_rig, cameras, device,
                        floatx(device))
    max_sq = float(options.max_error_px) ** 2
    opts = RansacOptions(min_inlier_ratio=options.min_inlier_ratio,
                         confidence=options.confidence, min_num_trials=options.min_num_trials,
                         max_num_trials=options.max_num_trials, batch_size=options.batch_size)
    res = ransac(
        torch.Generator().manual_seed(int(seed)), data.mask, KR.GDLT_SAMPLE,
        lambda idxs: KR.gen_abs_propose_score(data, idxs, max_sq, estimate_scale),
        lambda model: KR.gen_abs_inliers(data, model, max_sq),
        opts,
        local_refine=lambda model, count: _gen_abs_refit(data, model, max_sq, count,
                                                         estimate_scale),
    )
    if not res.success:
        return None, np.zeros(n, dtype=bool), 1.0
    model = res.model.double().cpu()
    quat = rot.rotmat_to_quat(model[:, :3]).numpy()
    return Pose(quat, model[:, 3].numpy()), res.inlier_mask.cpu().numpy(), float(model[0, 4])


def refit_generalized_absolute_pose(
    points2D: np.ndarray,
    points3D: np.ndarray,
    camera_idxs: np.ndarray,
    cams_from_rig: Sequence[Pose],
    cameras: Sequence[Camera],
    inlier_mask: np.ndarray,
    estimate_scale: bool = True,
    device=None,
) -> Tuple[Optional[Pose], float]:
    """gDLT over all the inliers in float64 (the LO step's refit, taken
    whatever its support; K40 (b), one host read): (rig_from_world | None,
    world scale). A RANSAC estimate keeps its best 6-point model where the
    refit adds no inlier, and with short baselines that model's scale is
    uncertain by about 1e-3; the refit over every inlier is not."""
    device = torch.device(device or "cuda")
    data = gen_abs_data(points2D, points3D, camera_idxs, cams_from_rig, cameras, device,
                        torch.float64)
    w = torch.as_tensor(np.asarray(inlier_mask, dtype=np.float64)).to(device)
    model, ok = KR.gen_abs_refit(data.X, data.centers, data.dirs, w, estimate_scale)
    out = torch.cat([model.flatten(), ok.double()]).cpu()
    if not bool(out[-1]):
        return None, 1.0
    model = out[:-1].reshape(3, 5)
    return Pose(rot.rotmat_to_quat(model[:, :3]).numpy(), model[:, 3].numpy()), float(model[0, 4])


def refine_generalized_absolute_pose(
    rig_from_world: Pose,
    points2D: np.ndarray,
    points3D: np.ndarray,
    camera_idxs: np.ndarray,
    cams_from_rig: Sequence[Pose],
    cameras: Sequence[Camera],
    inlier_mask: Optional[np.ndarray] = None,
    num_iterations: int = 30,
    loss_scale_px: float = 1.0,
    device=None,
) -> Tuple[Pose, bool]:
    """Cauchy-weighted LM refinement of rig_from_world over the reprojection
    errors, in float64 on ``device`` (colmap_tpu's loop, l.262-342): K40 (a),
    the whole loop in one launch, and one host read of (q, t).

    reference: RefineGeneralizedAbsolutePose (estimators/generalized_pose.cc).
    """
    device = torch.device(device or "cuda")
    n = len(points2D)
    if inlier_mask is None:
        inlier_mask = np.ones(n, dtype=bool)
    data = gen_abs_data(points2D, points3D, camera_idxs, cams_from_rig, cameras, device,
                        torch.float64)

    def dev(a):
        return torch.as_tensor(np.asarray(a, dtype=np.float64)).to(device)

    q, t = KR.gen_abs_refine(data.X, data.uv, data.cam_q, data.cam_t, data.focal,
                             dev(inlier_mask), dev(rig_from_world.quat), dev(rig_from_world.t),
                             num_iterations, loss_scale_px)
    qt = torch.cat([q, t]).cpu().numpy()
    q, t = qt[:4], qt[4:]
    return Pose(q, t), bool(np.isfinite(qt).all())


@dataclasses.dataclass(frozen=True)
class StructureLessAbsolutePoseOptions:
    """reference: StructureLessAbsolutePoseEstimationOptions
    (incremental_mapper.cc:763-773): Sampson scoring, stricter error."""

    max_error_px: float = 6.0
    confidence: float = 0.9999
    min_num_trials: int = 100
    max_num_trials: int = 5000
    batch_size: int = 16


def _plucker_rays(uv, cam_q, cam_t):
    """Normalized observations (N, 2) and each one's cam_from_rig -> the
    Plücker rays (direction d, moment m = c × d) and camera centres c in the
    rig frame (colmap_tpu's _plucker_rays, l.386)."""
    bearings = torch.nn.functional.normalize(torch.cat([uv, torch.ones_like(uv[:, :1])], 1),
                                             dim=1)
    q_inv = rot.quat_conjugate(cam_q)
    d = rot.quat_rotate(q_inv, bearings)
    c = -rot.quat_rotate(q_inv, cam_t)
    return d, torch.linalg.cross(c, d), c


def g17_relative_pose(q1, m1, q2, m2):
    """Linear generalized relative pose (3, 4) rig2_from_rig1 from 17+
    Plücker ray pairs (colmap_tpu's g17_relative_pose, l.349; the plain
    solve of K48, kernels/rig.py g17_solve)."""
    return KR.g17_solve(q1, m1, q2, m2)


def _weighted_g17(d1, m1, d2, m2, weights):
    """Weighted least-squares refit of the 17-point system over every row
    (colmap_tpu's _weighted_g17, l.454; K48 (c) on the card)."""
    return KR.g17_solve(d1, m1, d2, m2, weights)


@dataclasses.dataclass
class GeneralizedRelativePoseOptions:
    """colmap_tpu's options (l.479-486)."""

    max_error_px: float = 4.0
    min_inlier_ratio: float = 0.25
    confidence: float = 0.999
    min_num_trials: int = 50
    max_num_trials: int = 2000
    batch_size: int = 32


def gen_rel_data(points2D1, points2D2, camera_idxs1, camera_idxs2,
                 cams_from_rig: Sequence[Pose], cameras: Sequence[Camera], device,
                 dtype) -> KR.GenRelData:
    """The correspondences of a generalized relative pose on ``device``:
    the rays in float64, the observations, cameras and focal lengths in
    ``dtype``."""
    idx1 = np.asarray(camera_idxs1, dtype=np.int64)
    idx2 = np.asarray(camera_idxs2, dtype=np.int64)
    uv1, f1 = _normalize_observations(np.asarray(points2D1, dtype=np.float64), idx1, cameras,
                                      device, dtype)
    uv2, f2 = _normalize_observations(np.asarray(points2D2, dtype=np.float64), idx2, cameras,
                                      device, dtype)
    q = np.stack([p.quat for p in cams_from_rig]).astype(np.float64)
    t = np.stack([p.t for p in cams_from_rig]).astype(np.float64)
    cams64 = torch.as_tensor(np.concatenate([q[idx1], t[idx1], q[idx2], t[idx2]], 1)).to(device)
    d1, m1, _ = _plucker_rays(uv1.double(), cams64[:, 0:4], cams64[:, 4:7])
    d2, m2, _ = _plucker_rays(uv2.double(), cams64[:, 7:11], cams64[:, 11:14])
    return KR.GenRelData(torch.cat([d1, m1, d2, m2], 1).contiguous(),
                         torch.cat([uv1, uv2], 1).contiguous(), cams64.to(dtype).contiguous(),
                         torch.sqrt(f1 * f2).contiguous(),
                         torch.ones(len(idx1), dtype=torch.bool, device=device))


def _gen_rel_refit(data: KR.GenRelData, model, max_sq, count):
    """``_try_refine``: the weighted 17-point solve (K48 (c), float64) over
    every row with the inliers of ``model`` as weights, kept where it is
    finite and its support is larger; the host reads the support once."""
    inl = KR.gen_rel_inliers(data, model, max_sq)
    refined, ok = KR.gen_rel_refit(data.rays, inl.double())
    refined = refined.to(model.dtype)
    count_r = int(torch.where(ok[0], KR.gen_rel_inliers(data, refined, max_sq).sum(), -1))
    return (refined, count_r) if count_r > count else (model, count)


def estimate_generalized_relative_pose(
    points2D1: np.ndarray,
    points2D2: np.ndarray,
    camera_idxs1: np.ndarray,
    camera_idxs2: np.ndarray,
    cams_from_rig: Sequence[Pose],
    cameras: Sequence[Camera],
    options: Optional[GeneralizedRelativePoseOptions] = None,
    seed: int = 0,
    device=None,
) -> Tuple[Optional[Pose], np.ndarray]:
    """rig2_from_rig1 from 2D-2D correspondences between two rig frames on
    ``device``. Returns (rig2_from_rig1 | None, inlier_mask). Metric scale
    needs rays from >= 2 distinct camera centres.
    reference: estimators/generalized_pose.h EstimateGeneralizedRelativePose.
    """
    options = options or GeneralizedRelativePoseOptions()
    n = len(points2D1)
    if n < KR.G17_SAMPLE:
        return None, np.zeros(n, dtype=bool)
    device = torch.device(device or "cuda")
    data = gen_rel_data(points2D1, points2D2, camera_idxs1, camera_idxs2, cams_from_rig,
                        cameras, device, floatx(device))
    max_sq = float(options.max_error_px) ** 2
    opts = RansacOptions(min_inlier_ratio=options.min_inlier_ratio,
                         confidence=options.confidence, min_num_trials=options.min_num_trials,
                         max_num_trials=options.max_num_trials, batch_size=options.batch_size)
    res = ransac(
        torch.Generator().manual_seed(int(seed)), data.mask, KR.G17_SAMPLE,
        lambda idxs: KR.gen_rel_propose_score(data, idxs, max_sq),
        lambda model: KR.gen_rel_inliers(data, model, max_sq),
        opts,
        local_refine=lambda model, count: _gen_rel_refit(data, model, max_sq, count),
    )
    if not res.success:
        return None, np.zeros(n, dtype=bool)
    model = res.model.double().cpu()
    return (Pose(rot.rotmat_to_quat(model[:, :3]).numpy(), model[:, 3].numpy()),
            res.inlier_mask.cpu().numpy())


def _unproject(camera: Camera, xy: np.ndarray, device, dtype) -> torch.Tensor:
    params = torch.as_tensor(np.asarray(camera.params), dtype=dtype).to(device)
    uv, _ = K.cam_from_img(int(camera.model_id), params,
                           torch.as_tensor(xy, dtype=dtype).to(device).contiguous())
    return uv


def estimate_structure_less_absolute_pose(
    points2D: np.ndarray,
    world_points2D: np.ndarray,
    world_camera_idxs: np.ndarray,
    world_cams_from_world: Sequence[Pose],
    world_cameras: Sequence[Camera],
    camera: Camera,
    options: Optional[StructureLessAbsolutePoseOptions] = None,
    seed: int = 0,
    device=None,
) -> Tuple[Optional[Pose], np.ndarray]:
    """cam_from_world of a new camera from its 2D-2D correspondences to
    registered images (no triangulated structure needed). Returns
    (cam_from_world | None, inlier_mask)."""
    options = options or StructureLessAbsolutePoseOptions()
    n = len(points2D)
    world_camera_idxs = np.asarray(world_camera_idxs, dtype=np.int64)
    C = len(world_cameras)
    if n < 6 or C < 2:
        return None, np.zeros(n, dtype=bool)
    device = torch.device(device or "cuda")
    dt = floatx(device)
    uv = _unproject(camera, np.asarray(points2D, dtype=np.float64), device, dt)
    uv_w = torch.zeros((n, 2), dtype=dt, device=device)
    focal_w = np.zeros(n)
    for ci, cam in enumerate(world_cameras):
        sel = np.nonzero(world_camera_idxs == ci)[0]
        if len(sel):
            uv_w[torch.as_tensor(sel, device=device)] = _unproject(
                cam, np.asarray(world_points2D, dtype=np.float64)[sel], device, dt)
            focal_w[sel] = cam.mean_focal_length()
    focal = torch.as_tensor(np.sqrt(focal_w * camera.mean_focal_length()), dtype=dt).to(device)
    Rw = torch.as_tensor(np.stack([p.rotmat() for p in world_cams_from_world]), dtype=dt)
    tw = torch.as_tensor(np.stack([p.t for p in world_cams_from_world]), dtype=dt)
    Rw, tw = Rw.to(device), tw.to(device)

    # Correspondences grouped by world camera; cameras with fewer than five
    # are never the camera of the five-point sample.
    order = np.argsort(world_camera_idxs, kind="stable")
    counts = np.bincount(world_camera_idxs, minlength=C)
    offsets = np.concatenate([[0], np.cumsum(counts)])
    cam_probs = (counts >= 5).astype(np.float64)
    if cam_probs.sum() == 0:
        return None, np.zeros(n, dtype=bool)
    gen = torch.Generator().manual_seed(int(seed))
    probs_t = torch.as_tensor(cam_probs / cam_probs.sum())
    counts_t, offsets_t = torch.as_tensor(counts), torch.as_tensor(offsets)
    order_t = torch.as_tensor(order)
    cam_idx = torch.as_tensor(world_camera_idxs, dtype=torch.int32).to(device)
    max_sq = float(options.max_error_px) ** 2
    B = options.batch_size

    def score_batch():
        """One batch of B samples (a camera, five of its rows, a scale row),
        drawn in colmap_tpu's order, scored by K37; returns the batch's best
        model (3, 4), NaN where it has none, and its support."""
        cams = torch.multinomial(probs_t, B, replacement=True, generator=gen)
        r5 = torch.randint(0, 1 << 30, (B, 5), generator=gen) % counts_t[cams][:, None]
        idx5 = order_t[offsets_t[cams][:, None] + r5]
        r1 = torch.randint(0, n, (B,), generator=gen)
        models, _, best = KS.structure_less_score(
            uv, uv_w, cam_idx, Rw, tw, focal,
            *(x.to(torch.int32).to(device) for x in (cams, idx5, r1)), max_sq)
        support, idx = unpack_best(int(best[0]))
        return models[idx], support

    best_model, support = score_batch()
    trials = B
    nom = math.log(max(1.0 - options.confidence, 1e-30))
    while trials < options.max_num_trials:
        ratio = support / n
        denom = math.log(max(1.0 - ratio**6, 1e-30))
        dyn = 3.0 * nom / denom if denom < -1e-12 else math.inf
        if trials >= options.min_num_trials and trials >= dyn:
            break
        model, s = score_batch()
        if s > support:
            best_model, support = model, s
        trials += B
    if not bool(torch.isfinite(best_model).all()):
        return None, np.zeros(n, dtype=bool)
    inliers = KS.structure_less_inliers(uv, uv_w, cam_idx, Rw, tw, focal, best_model, max_sq)
    if int(inliers.sum()) < 6:
        return None, np.zeros(n, dtype=bool)
    R_best, t_best = best_model[:, :3], best_model[:, 3]
    R64 = R_best.double().cpu()
    return Pose(rot.rotmat_to_quat(R64).numpy(), t_best.double().cpu().numpy()), \
        inliers.cpu().numpy()
