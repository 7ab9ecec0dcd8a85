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
  local refit (weighted gDLT over the inliers) in float64 torch ops;
- ``refine_generalized_absolute_pose``: 30 Cauchy-weighted LM iterations
  in float64 over the rig's 6-DoF tangent, as torch ops with the Jacobian
  from torch.func.jacfwd;
- ``estimate_structure_less_absolute_pose``: a new camera from 2D-2D
  correspondences (EstimateStructureLessAbsolutePose, the mapper's fallback
  when an image has too few 2D-3D correspondences,
  incremental_mapper.cc:673-870). 5 + 1 RANSAC: five correspondences to one
  registered camera give the essential matrices new <- that camera
  (Nistér), cheirality picks (R, t direction) of each; one correspondence
  to another registered camera fixes the scale of t from its epipolar
  constraint. A model is scored by the generalized Sampson error of every
  correspondence against its own camera. The hypotheses run as batched
  torch ops on the mapper's device; samples come from a seeded CPU
  ``torch.Generator`` and the host reads one best support per batch.

The generalized relative pose (17-point, ``_gen_rel_ransac``) is not ported
yet (ROADMAP queue 1).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from colmap_tpu_torch.estimators.solvers.epipolar import essential_five_point
from colmap_tpu_torch.geometry import rotation as rot
from colmap_tpu_torch.geometry.essential import (
    calc_depth,
    cross_product_matrix,
    decompose_essential_matrix,
    triangulate_point_dlt,
)
from colmap_tpu_torch.kernels import rig as KR
from colmap_tpu_torch.kernels import sfm as K
from colmap_tpu_torch.optim.ransac import RansacOptions, ransac
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
    """``_try_refine``: weighted gDLT (float64 torch ops) on the inliers of
    ``model``, kept where it is finite and its support (K27) is larger."""
    inl = KR.gen_abs_inliers(data, model, max_sq)
    X, c, d = (x.double() for x in (data.X, data.centers, data.dirs))
    refined = KR.gdlt_pose(X, c, d, inl.double(), estimate_scale).to(model.dtype)
    if not bool(torch.isfinite(refined).all()):
        return model, count
    count_r = int(KR.gen_abs_inliers(data, refined, max_sq).sum())
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
    whatever its support): (rig_from_world | None, world scale). A RANSAC
    estimate keeps its best 6-point model where the refit adds no inlier,
    and with short baselines that model's scale is uncertain by about
    1e-3; the refit over every inlier is not."""
    device = torch.device(device or "cuda")
    data = gen_abs_data(points2D, points3D, camera_idxs, cams_from_rig, cameras, device,
                        torch.float64)
    w = torch.as_tensor(np.asarray(inlier_mask, dtype=np.float64)).to(device)
    model = KR.gdlt_pose(data.X, data.centers, data.dirs, w, estimate_scale).cpu()
    if not bool(torch.isfinite(model).all()):
        return None, 1.0
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
    errors, in float64 on ``device`` (colmap_tpu's loop, l.262-342).

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

    w_in = dev(inlier_mask)

    def residuals(delta, q_base, t_base):
        dq = rot.quat_normalize(torch.cat([torch.ones_like(delta[:1]), 0.5 * delta[:3]]))
        q = rot.quat_multiply(dq, q_base)
        Xr = rot.quat_rotate(q.expand(n, 4), data.X) + t_base + delta[3:]
        Xc = rot.quat_rotate(data.cam_q, Xr) + data.cam_t
        z = torch.clamp(Xc[:, 2], min=1e-8)
        return ((Xc[:, :2] / z[:, None] - data.uv) * data.focal[:, None]).reshape(-1)

    def robust_weights(r):
        e2 = (r.reshape(-1, 2) ** 2).sum(1)
        w = 1.0 / (1.0 + e2 / loss_scale_px ** 2)
        return torch.repeat_interleave(torch.sqrt(w) * torch.sqrt(w_in), 2)

    q, t = dev(rig_from_world.quat), dev(rig_from_world.t)
    lam, prev_cost = 1e-4, None
    zero = torch.zeros(6, dtype=torch.float64, device=device)
    jac = torch.func.jacfwd(residuals)
    for _ in range(num_iterations):
        r = residuals(zero, q, t)
        wts = robust_weights(r)
        Jw = jac(zero, q, t) * wts[:, None]
        rw = r * wts
        cost = float((rw ** 2).sum())
        H = Jw.T @ Jw
        step = torch.linalg.solve(H + lam * torch.diag(torch.diagonal(H) + 1e-12), -(Jw.T @ rw))
        r_new = residuals(step, q, t)
        new_cost = float(((r_new * robust_weights(r_new)) ** 2).sum())
        if new_cost < cost:
            dq = rot.quat_normalize(torch.cat([torch.ones_like(step[:1]), 0.5 * step[:3]]))
            q = rot.quat_multiply(dq, q)
            t = t + step[3:]
            lam = max(lam * 0.3, 1e-10)
            if prev_cost is not None and abs(prev_cost - new_cost) < 1e-12 * max(prev_cost, 1.0):
                break
            prev_cost = new_cost
        else:
            lam = min(lam * 10.0, 1e8)
    q, t = q.cpu().numpy(), t.cpu().numpy()
    return Pose(q, t), bool(np.isfinite(q).all() and np.isfinite(t).all())


@dataclasses.dataclass(frozen=True)
class StructureLessAbsolutePoseOptions:
    """reference: StructureLessAbsolutePoseEstimationOptions
    (incremental_mapper.cc:763-773): Sampson scoring, stricter error."""

    max_error_px: float = 6.0
    confidence: float = 0.9999
    min_num_trials: int = 100
    max_num_trials: int = 5000
    batch_size: int = 16


def _unproject(camera: Camera, xy: np.ndarray, device, dtype) -> torch.Tensor:
    params = torch.as_tensor(np.asarray(camera.params), dtype=dtype).to(device)
    uv, _ = K.cam_from_img(int(camera.model_id), params,
                           torch.as_tensor(xy, dtype=dtype).to(device).contiguous())
    return uv


def _poses_from_essentials(E, x1, x2):
    """Cheirality of every essential matrix E (..., 3, 3) on its own five
    points x1, x2 (..., 5, 2): the (R, t) of the four decompositions with
    the most points in front of both cameras (the first on a tie), and that
    count."""
    finite = torch.isfinite(E).flatten(-2).all(-1)
    E = torch.where(finite[..., None, None], E, torch.eye(3, dtype=E.dtype, device=E.device))
    R1, R2, t = decompose_essential_matrix(E)
    Rs = torch.stack([R1, R2, R1, R2], dim=-3)  # (..., 4, 3, 3)
    ts = torch.stack([t, t, -t, -t], dim=-2)  # (..., 4, 3)
    proj2 = torch.cat([Rs, ts[..., None]], dim=-1)[..., None, :, :]  # (..., 4, 1, 3, 4)
    eye34 = torch.eye(3, 4, dtype=E.dtype, device=E.device)
    X = triangulate_point_dlt(eye34, proj2, x1[..., None, :, :], x2[..., None, :, :])
    d1, d2 = calc_depth(eye34, X), calc_depth(proj2, X)
    ok = (d1 > 1e-12) & (d1 < 1000.0) & (d2 > 1e-12) & (d2 < 1000.0)  # |t| = 1
    count = ok.sum(-1)  # (..., 4)
    best = torch.argmax(count, dim=-1)  # the first of equal counts
    R = torch.take_along_dim(Rs, best[..., None, None, None], dim=-3)[..., 0, :, :]
    t = torch.take_along_dim(ts, best[..., None, None], dim=-2)[..., 0, :]
    return R, t, count.amax(-1), finite


def _sampson_sq_px(R, t, Rw, tw, cam_idx, x1h, x2h, focal):
    """(M, N) squared generalized Sampson errors in pixels of models
    cam_from_world = [R | t] (M, 3, 3), (M, 3), each correspondence against
    its own registered camera; models in chunks of at most 2^22 / N."""
    Rwn, twn = Rw[cam_idx], tw[cam_idx]
    out = []
    step = max(1, (1 << 22) // max(x1h.shape[0], 1))
    for i in range(0, R.shape[0], step):
        R_rel = torch.einsum("mab,ncb->mnac", R[i:i + step], Rwn)
        t_rel = t[i:i + step, None, :] - torch.einsum("mnab,nb->mna", R_rel, twn)
        E = cross_product_matrix(t_rel) @ R_rel
        Ex1 = torch.einsum("mnij,nj->mni", E, x1h)
        Etx2 = torch.einsum("mnji,nj->mni", E, x2h)
        num = torch.sum(x2h * Ex1, dim=-1) ** 2
        den = Ex1[..., 0] ** 2 + Ex1[..., 1] ** 2 + Etx2[..., 0] ** 2 + Etx2[..., 1] ** 2
        out.append(num / torch.clamp(den, min=1e-12) * focal**2)
    return torch.cat(out)


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
    order_t, cam_idx_cpu = torch.as_tensor(order), torch.as_tensor(world_camera_idxs)
    cam_idx = cam_idx_cpu.to(device)
    x1h = torch.cat([uv_w, torch.ones_like(uv_w[:, :1])], dim=1)
    x2h = torch.cat([uv, torch.ones_like(uv[:, :1])], dim=1)
    max_sq = float(options.max_error_px) ** 2
    B = options.batch_size

    def hypotheses():
        """(B * 10, 3, 3) rotations and (B * 10, 3) translations, NaN where
        a slot holds no valid model."""
        cams = torch.multinomial(probs_t, B, replacement=True, generator=gen)
        r5 = torch.randint(0, 1 << 30, (B, 5), generator=gen) % counts_t[cams][:, None]
        idx5 = order_t[offsets_t[cams][:, None] + r5].to(device)
        r1 = torch.randint(0, n, (B,), generator=gen)
        scale_ok = (cam_idx_cpu[r1] != cams).to(device)
        cams, r1 = cams.to(device), r1.to(device)
        x_w, x_n = uv_w[idx5], uv[idx5]  # (B, 5, 2)
        Es = essential_five_point(x_w, x_n)  # (B, 10, 3, 3): new <- world camera
        R_rel, t_dir, n_front, finite = _poses_from_essentials(
            Es, x_w[:, None], x_n[:, None])
        valid = finite & (n_front >= 4)
        # cam_from_world(s) = (R_rel, s t_dir) o (Rc, tc); the extra
        # correspondence's epipolar constraint against its camera is linear
        # in s: x2' [a + s b]x R_ns x1 = 0.
        Rc, tc = Rw[cams][:, None], tw[cams][:, None]
        R_new = R_rel @ Rc
        t_base = (R_rel @ tc[..., None])[..., 0]
        Rs2, ts2 = Rw[cam_idx[r1]][:, None], tw[cam_idx[r1]][:, None]
        R_ns = R_new @ Rs2.transpose(-1, -2)
        a = t_base - (R_ns @ ts2[..., None])[..., 0]
        Rx1 = (R_ns @ x1h[r1][:, None, :, None])[..., 0]
        x2s = x2h[r1][:, None]
        c0 = torch.sum(x2s * torch.linalg.cross(a, Rx1), dim=-1)
        c1 = torch.sum(x2s * torch.linalg.cross(t_dir, Rx1), dim=-1)
        s = -c0 / torch.where(torch.abs(c1) < 1e-12, 1e-12, c1)
        t_new = t_base + s[..., None] * t_dir
        ok = valid & (torch.abs(c1) > 1e-10) & (s > 1e-8) & scale_ok[:, None]
        nan = torch.full_like(t_new, math.nan)
        return (torch.where(ok[..., None, None], R_new, nan[..., None]).reshape(-1, 3, 3),
                torch.where(ok[..., None], t_new, nan).reshape(-1, 3))

    def score_batch():
        R, t = hypotheses()
        support = (_sampson_sq_px(R, t, Rw, tw, cam_idx, x1h, x2h, focal) <= max_sq).sum(-1)
        model_ok = torch.isfinite(R).flatten(1).all(1) & torch.isfinite(t).all(1)
        support = torch.where(model_ok, support, 0)
        best = int(torch.argmax(support))
        return R[best], t[best], int(support[best])

    R_best, t_best, support = score_batch()
    trials = B
    nom = math.log(max(1.0 - options.confidence, 1e-30))
    while trials < options.max_num_trials:
        ratio = support / n
        denom = math.log(max(1.0 - ratio**6, 1e-30))
        dyn = 3.0 * nom / denom if denom < -1e-12 else math.inf
        if trials >= options.min_num_trials and trials >= dyn:
            break
        R, t, s = score_batch()
        if s > support:
            R_best, t_best, support = R, t, s
        trials += B
    if not (torch.isfinite(R_best).all() and torch.isfinite(t_best).all()):
        return None, np.zeros(n, dtype=bool)
    inliers = _sampson_sq_px(R_best[None], t_best[None], Rw, tw, cam_idx, x1h, x2h,
                             focal)[0] <= max_sq
    if int(inliers.sum()) < 6:
        return None, np.zeros(n, dtype=bool)
    R64 = R_best.double().cpu()
    return Pose(rot.rotmat_to_quat(R64).numpy(), t_best.double().cpu().numpy()), \
        inliers.cpu().numpy()
