"""Absolute pose estimation and refinement.

Counterpart of colmap_tpu/estimators/pose.py (reference behavior:
src/colmap/estimators/pose.h:47-148): EstimateAbsolutePose (LO-RANSAC over
P3P) and RefineAbsolutePose (the shared bundle-adjustment solver on a
one-frame problem with constant points). The RANSAC batches run in the CUDA
kernel K6 (kernels/sfm.py) on the card, the host loop in optim/ransac.py.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from colmap_tpu_torch.estimators import bundle_adjustment as ba
from colmap_tpu_torch.geometry import rotation as rot
from colmap_tpu_torch.kernels import sfm as K
from colmap_tpu_torch.optim.ransac import RansacOptions, ransac
from colmap_tpu_torch.scene.types import Camera, Pose
from colmap_tpu_torch.utils.dtypes import floatx


def _p3p_ransac(generator, X, rays, uv, mask, max_error, options: RansacOptions):
    """P3P LO-RANSAC over K6: X/rays/uv (N, 3/3/2), max_error in normalized
    units. Returns a RansacResult whose model is [R | t] (3, 4)."""
    max_sq = float(max_error) ** 2
    return ransac(
        generator, mask, 3,
        lambda idxs: K.p3p_propose_score(X, rays, uv, mask, idxs, max_sq),
        lambda model: K.p3p_inliers(X, uv, mask, model, max_sq),
        options,
        local_refine=lambda model, count: K.p3p_refit(X, uv, mask, model, max_sq, count),
    )


@dataclasses.dataclass
class AbsolutePoseOptions:
    """reference: estimators/pose.h:47-76 (AbsolutePoseEstimationOptions)."""

    max_error_px: float = 12.0
    min_inlier_ratio: float = 0.1
    confidence: float = 0.9999
    min_num_trials: int = 100
    max_num_trials: int = 10000
    batch_size: int = 64
    estimate_focal_length: bool = False
    num_focal_samples: int = 30
    min_focal_ratio: float = 0.2
    max_focal_ratio: float = 5.0


def estimate_absolute_pose(
    camera: Camera,
    points2D: np.ndarray,
    points3D: np.ndarray,
    options: Optional[AbsolutePoseOptions] = None,
    seed: int = 0,
    device=None,
) -> Tuple[Optional[Pose], np.ndarray, Optional[float]]:
    """LO-RANSAC P3P absolute pose from 2D-3D correspondences on ``device``.

    Returns (cam_from_world | None, inlier_mask, focal_scale | None).
    """
    if options is None:
        options = AbsolutePoseOptions()
    if options.estimate_focal_length:
        raise NotImplementedError("focal-length search: colmap_tpu has none to port (ROADMAP §3)")
    n = len(points2D)
    if n < 4:
        return None, np.zeros(n, dtype=bool), None
    device = torch.device(device or "cuda")
    dt = floatx(device)
    xy = torch.as_tensor(np.asarray(points2D), dtype=dt).to(device)
    X = torch.as_tensor(np.asarray(points3D), dtype=dt).to(device).contiguous()
    params = torch.as_tensor(camera.params, dtype=dt).to(device)
    model_id = int(camera.model_id)
    # One unprojection gives both the normalized points and the rays.
    uv, ok = K.cam_from_img(model_id, params, xy)
    rays = torch.nn.functional.normalize(
        torch.cat([uv, torch.ones_like(uv[:, :1])], dim=1), dim=1).contiguous()
    thresh_n = camera.cam_from_img_threshold(options.max_error_px)
    opts = RansacOptions(
        min_inlier_ratio=options.min_inlier_ratio,
        confidence=options.confidence,
        min_num_trials=options.min_num_trials,
        max_num_trials=options.max_num_trials,
        batch_size=options.batch_size,
    )
    gen = torch.Generator().manual_seed(int(seed))
    res = _p3p_ransac(gen, X, rays, uv.contiguous(), ok.contiguous(), thresh_n, opts)
    if not res.success:
        return None, np.zeros(n, dtype=bool), None
    model = res.model.double().cpu()
    quat = rot.rotmat_to_quat(model[:, :3]).numpy()
    return Pose(quat, model[:, 3].numpy()), res.inlier_mask.cpu().numpy(), None


@dataclasses.dataclass
class RefinePoseOptions:
    max_iterations: int = 30
    loss: str = "cauchy"
    loss_scale: float = 1.0
    refine_focal_length: bool = False
    refine_extra_params: bool = False


def refine_absolute_pose(
    camera: Camera,
    cam_from_world: Pose,
    points2D: np.ndarray,
    points3D: np.ndarray,
    inlier_mask: Optional[np.ndarray] = None,
    options: Optional[RefinePoseOptions] = None,
    device=None,
) -> Tuple[Pose, Camera, bool]:
    """LM refinement of one pose (and optionally intrinsics) over its 2D-3D
    inliers: ``bundle_adjustment.solve`` on a one-frame problem whose points
    are constant (point mask of zeros; K2 then inverts no point block).

    reference behavior: RefineAbsolutePose (estimators/pose.cc).
    """
    if options is None:
        options = RefinePoseOptions()
    n = len(points2D)
    if inlier_mask is None:
        inlier_mask = np.ones(n, dtype=bool)
    device = torch.device(device or "cuda")
    dt = floatx(device)

    def dev(a, dtype=dt):
        return torch.as_tensor(np.asarray(a), dtype=dtype).to(device)

    problem = ba.BAProblem(
        quat=dev(cam_from_world.quat)[None],
        t=dev(cam_from_world.t)[None],
        cam_params=dev(camera.params)[None],
        points=dev(points3D),
        obs_frame=torch.zeros(n, dtype=torch.int32, device=device),
        obs_cam=torch.zeros(n, dtype=torch.int32, device=device),
        obs_point=torch.arange(n, dtype=torch.int32, device=device),
        obs_xy=dev(points2D),
        obs_w=dev(inlier_mask.astype(np.float64)),
    )
    ba_options = ba.BAOptions(
        max_iterations=options.max_iterations,
        pcg_iterations=12,
        loss=options.loss,
        loss_scale=options.loss_scale,
        refine_focal_length=options.refine_focal_length,
        refine_principal_point=False,
        refine_extra_params=options.refine_extra_params,
        refine_points=False,
    )
    model_id = int(camera.model_id)
    masks = ba.default_masks(problem, model_id, ba_options)
    solved, summary = ba.solve(problem, model_id, ba_options, masks)
    ok = summary["final_cost"] <= summary["initial_cost"]
    new_pose = Pose(solved.quat[0].double().cpu().numpy(),
                    solved.t[0].double().cpu().numpy()).normalize()
    new_camera = camera
    if options.refine_focal_length or options.refine_extra_params:
        new_camera = dataclasses.replace(
            camera, params=solved.cam_params[0].double().cpu().numpy()[: len(camera.params)])
    return new_pose, new_camera, ok
