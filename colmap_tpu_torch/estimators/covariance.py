"""Bundle-adjustment covariance estimation.

reference behavior: src/colmap/estimators/covariance.h:50-143
(EstimateBACovariance). Counterpart of colmap_tpu/estimators/covariance.py:
pose and camera-intrinsic covariances from the Schur complement of the BA
normal equations at the current state. Point covariances are not returned
(colmap_tpu's docstring names them, its code returns none).

The reduced camera system is small (n = 6F + C·P), so it is assembled
densely and inverted. colmap_tpu densifies it by applying the matrix-free
Schur matvec to the n columns of the identity; the port runs K1 (the
Jacobians with the masks folded in, in the point-major packed layout) and
K54 (``kernels/ba.py`` ``covariance_assemble``: S assembled point by point
in float64), then, on the same device in float64, colmap_tpu's
regularisation, the inverse (``torch.linalg.inv_ex``, as colmap_tpu's
``np.linalg.inv``) and the cut of the per-frame and per-camera blocks.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from colmap_tpu_torch.estimators import bundle_adjustment as ba
from colmap_tpu_torch.kernels import ba as ba_kernels


def estimate_ba_covariance(problem: ba.BAProblem, model_id, options: Optional[ba.BAOptions] = None,
                           masks: Optional[ba.BAMasks] = None, damping: float = 1e-8):
    """Pose and camera-intrinsic covariances at the problem's state, on the
    problem's device (float32 tensors on the card, where K1 takes float32;
    any float type on the CPU).

    Returns a dict of float64 numpy arrays:
        pose_covs: (F, 6, 6) per-frame covariance in the local tangent
            (rotation xyz, translation xyz); a row fixed by the masks (a
            gauge) reads 0, a fully fixed frame is all zeros.
        cam_covs: (C, P, P).
    """
    return _covariance(problem, model_id, options, masks, damping, ba_kernels.KERNELS)


def _covariance(problem, model_id, options, masks, damping, kernels):
    """estimate_ba_covariance through ``kernels`` (``ba_kernels.KERNELS``,
    or ``ba_kernels.PLAIN`` for a check on the card that runs the plain
    versions, K54's in float64)."""
    if options is None:
        options = ba.BAOptions()
    if masks is None:
        masks = ba.default_masks(problem, model_id, options)
    F = problem.quat.shape[0]
    C, P = problem.cam_params.shape
    packed, maps, _ = ba.pack_problem(problem)
    om = ba._obs_masks(masks, options)
    p = packed
    _, Jp, Jc, Jx = kernels.obs_jacobians(
        p.quat, p.t, p.cam_params, p.points, p.obs_frame, p.obs_cam, p.obs_point, p.obs_xy,
        p.obs_w, om.pose, om.cam, om.point, model_id, options.loss, options.loss_scale)
    S = kernels.covariance_assemble(Jp, Jc, Jx, maps.frame_pm, maps.cam_pm, damping, F, C)
    # Regularise the fixed (zero) rows and columns so that the inverse
    # exists; their covariance is reported as zero (covariance.py:59-66).
    diag = torch.diagonal(S).abs()
    fixed = diag < 1e-12
    S_reg = S + torch.diag(torch.where(fixed, 1.0, damping * torch.clamp(diag, min=1.0)))
    cov, info = torch.linalg.inv_ex(S_reg)
    if int(info) != 0:
        raise np.linalg.LinAlgError("Singular matrix")
    cov[fixed, :] = 0.0
    cov[:, fixed] = 0.0
    n_pose = 6 * F
    pose = torch.diagonal(cov[:n_pose, :n_pose].reshape(F, 6, F, 6), dim1=0, dim2=2)
    cam = torch.diagonal(cov[n_pose:, n_pose:].reshape(C, P, C, P), dim1=0, dim2=2)
    return {"pose_covs": pose.permute(2, 0, 1).cpu().numpy(),
            "cam_covs": cam.permute(2, 0, 1).cpu().numpy()}
