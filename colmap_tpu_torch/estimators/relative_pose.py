"""Relative pose from an essential matrix, and its nonlinear refinement.

Counterpart of colmap_tpu/estimators/relative_pose.py: Levenberg-Marquardt
on the Sampson error over the 5-dof (R, unit t) manifold, 15 steps, as
K36's refinement entry (kernels/solver.py refine_relative_poses, one launch
for any number of candidates); and of colmap_tpu/geometry/essential.py
pose_from_essential_matrix, K36's cheirality entry.
"""

from __future__ import annotations

import torch

from colmap_tpu_torch.kernels import solver


def pose_from_essential_matrix(E, x1, x2, mask=None):
    """Recover cam2_from_cam1 from E and matched normalized points.

    Tests the four (R, t) candidates and keeps the one with the most points
    in front of both cameras (reference: PoseFromEssentialMatrix): K36's
    cheirality entry for one problem (kernels/solver.py).
    E: (3, 3); x1, x2: (N, 2); mask: optional (N,) validity, padded rows
    excluded from the vote. Returns (R, t, points3D (N, 3), num_valid
    (0-dim int tensor), valid_mask (N,)).
    """
    if mask is None:
        mask = torch.ones(x1.shape[:-1], dtype=torch.bool, device=x1.device)
    R, t, X, count, ok = solver.poses_from_essentials(E[None], x1, x2, mask, (0, x1.shape[0]))
    return R[0], t[0], X, count[0], ok


def refine_relative_pose(quat, t, x1, x2, weights, num_iterations: int = 15):
    """LM on the Sampson error over (R, unit t).

    quat (4,) initial cam2_from_cam1 rotation; t (3,) translation of any
    scale; x1/x2 (N, 2) normalized coordinates; weights (N,) inlier weights.
    Returns (quat, t_unit, final_rms).
    """
    q, tt, rms = solver.refine_relative_poses(quat[None], t[None], x1, x2, weights,
                                              (0, x1.shape[0]), num_iterations)
    return q[0], tt[0], rms[0]
