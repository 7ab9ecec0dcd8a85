"""Nonlinear relative-pose (essential-matrix) refinement.

Counterpart of colmap_tpu/estimators/relative_pose.py: Levenberg-Marquardt
on the Sampson error over the 5-dof (R, unit t) manifold, 15 steps. It runs
as torch ops on the device of its inputs (called a few times per
initial-pair candidate; a kernel for it is still to be ported).
"""

from __future__ import annotations

import torch

from colmap_tpu_torch.geometry import rotation as rot
from colmap_tpu_torch.geometry.essential import cross_product_matrix


def _tangent_basis(t):
    """Two unit vectors orthogonal to unit t."""
    eye = torch.eye(3, dtype=t.dtype, device=t.device)
    ref = torch.where(torch.abs(t[0]) < 0.9, eye[0], eye[1])
    b1 = torch.linalg.cross(t, ref)
    b1 = b1 / torch.clamp(torch.linalg.vector_norm(b1), min=1e-12)
    return b1, torch.linalg.cross(t, b1)


def _sampson_residuals(quat, t, x1, x2):
    E = cross_product_matrix(t) @ rot.quat_to_rotmat(quat)
    ones = torch.ones_like(x1[..., :1])
    p1 = torch.cat([x1, ones], dim=-1)
    p2 = torch.cat([x2, ones], dim=-1)
    Ex1 = p1 @ E.T
    Etx2 = p2 @ E
    x2tEx1 = (p2 * Ex1).sum(-1)
    denom = torch.sqrt(torch.clamp(
        Ex1[..., 0] ** 2 + Ex1[..., 1] ** 2 + Etx2[..., 0] ** 2 + Etx2[..., 1] ** 2, min=1e-30))
    return x2tEx1 / denom


def _perturb(delta, quat, t, b1, b2):
    dq = rot.quat_normalize(torch.cat([torch.ones_like(delta[:1]), 0.5 * delta[:3]]))
    q = rot.quat_multiply(dq, quat)
    tt = t + delta[3] * b1 + delta[4] * b2
    return q, tt / torch.clamp(torch.linalg.vector_norm(tt), min=1e-12)


def refine_relative_pose(quat, t, x1, x2, weights, num_iterations: int = 15):
    """LM on the Sampson error over (R, unit t).

    quat (4,) initial cam2_from_cam1 rotation; t (3,) translation of any
    scale; x1/x2 (N, 2) normalized coordinates; weights (N,) inlier weights.
    Returns (quat, t_unit, final_rms).
    """
    t = t / torch.clamp(torch.linalg.vector_norm(t), min=1e-12)
    sw = torch.sqrt(weights)
    lam = 1e-4
    eye5 = torch.eye(5, dtype=x1.dtype, device=x1.device)
    for _ in range(num_iterations):
        b1, b2 = _tangent_basis(t)

        def residual_fn(delta, quat=quat, t=t, b1=b1, b2=b2):
            q, tt = _perturb(delta, quat, t, b1, b2)
            return _sampson_residuals(q, tt, x1, x2) * sw

        zero = torch.zeros(5, dtype=x1.dtype, device=x1.device)
        r = residual_fn(zero)
        J = torch.func.jacfwd(residual_fn)(zero)  # (N, 5)
        H = J.T @ J
        delta = torch.linalg.solve(H + lam * torch.diag(torch.diag(H)) + 1e-12 * eye5, -J.T @ r)
        q_new, t_new = _perturb(delta, quat, t, b1, b2)
        q_new = rot.quat_normalize(q_new)
        new_cost = float((residual_fn(zero, q_new, t_new, *_tangent_basis(t_new)) ** 2).sum())
        if new_cost < float((r**2).sum()):
            quat, t, lam = q_new, t_new, max(lam / 3.0, 1e-10)
        else:
            lam = min(lam * 5.0, 1e6)
    r = _sampson_residuals(quat, t, x1, x2)
    rms = torch.sqrt((weights * r * r).sum() / torch.clamp(weights.sum(), min=1e-12))
    return quat, t, rms
