"""Residual model of bundle adjustment: the reprojection residual over local
deltas, the quaternion exponential of the rotation update, and the robust
losses.

Counterpart of make_residual_fn, _quat_exp, _robust_weight and _robust_cost
of colmap_tpu/estimators/bundle_adjustment.py. The solver
(``estimators/bundle_adjustment.py``) and the plain versions of the kernels
(``kernels/ba.py``) both use it; the CUDA kernels implement the same model
in ``csrc/ba_jacobians.cu``.
"""

from __future__ import annotations

import torch

from colmap_tpu_torch.geometry import rotation as rot
from colmap_tpu_torch.sensor import models as camera_models


def quat_exp(w):
    """so(3) tangent (..., 3) -> unit quaternion, small-angle safe."""
    theta2 = (w * w).sum(-1, keepdim=True)
    theta = torch.sqrt(theta2 + 1e-30)
    half = 0.5 * theta
    sinc = torch.where(theta2 > 1e-12, torch.sin(half) / theta, 0.5 - theta2 / 48.0)
    return torch.cat([torch.cos(half), sinc * w], dim=-1)


def robust_weight(sq_norm, loss: str, scale: float):
    """IRLS weight ρ'(s) for squared residual norm s."""
    if loss == "trivial":
        return torch.ones_like(sq_norm)
    s = sq_norm / (scale * scale)
    if loss == "huber":
        return torch.where(s <= 1.0, 1.0, 1.0 / torch.sqrt(torch.clamp(s, min=1e-30)))
    if loss == "cauchy":
        return 1.0 / (1.0 + s)
    raise ValueError(loss)


def robust_cost(sq_norm, loss: str, scale: float):
    if loss == "trivial":
        return sq_norm
    a2 = scale * scale
    s = sq_norm / a2
    if loss == "huber":
        return torch.where(
            s <= 1.0, sq_norm, a2 * (2.0 * torch.sqrt(torch.clamp(s, min=0.0)) - 1.0)
        )
    if loss == "cauchy":
        return a2 * torch.log1p(s)
    raise ValueError(loss)


def make_residual_fn(model_id: int):
    """Per-observation reprojection residual over local deltas.

    f(dpose (6,), dcam (P,), dX (3,), quat, t, cam_params, X, xy) -> (2,).
    Rotation is left-multiplied by the quaternion exponential of dpose[:3],
    translation and the rest are additive; differentiating at delta = 0
    gives the Jacobians with respect to the local parameterization.
    """

    def f(dpose, dcam, dX, quat, t, cam_params, X, xy):
        q = rot.quat_multiply(quat_exp(dpose[:3]), quat)
        Xc = rot.quat_rotate(q, X + dX) + t + dpose[3:]
        proj, _ = camera_models.img_from_cam(
            model_id, cam_params + dcam, Xc, check_cheirality=False
        )
        return proj - xy

    return f
