"""Residuals and pose recovery of spherical (360-degree) pairs on bearing rays.

Counterpart of the geometry of colmap_tpu/estimators/spherical.py (reference
behavior: EstimateSphericalTwoViewGeometry, two_view_geometry.cc:394-528):
the angular Sampson error of an essential matrix and the angular transfer
error of a ray-space homography, both in rad², and the relative pose from
E by midpoint triangulation over rays. Torch ops on any device and dtype;
the kernels K32 and K33 (csrc/spherical_*_ransac.cu) implement the two
residuals, and the pose recovery runs as float64 torch ops.
"""

from __future__ import annotations

import torch

from colmap_tpu_torch.geometry.essential import decompose_essential_matrix


def _apply(M, v):
    return (M @ v[..., None])[..., 0]


def angular_sampson_error(E, r1, r2):
    """First-order angular epipolar error of unit rays (rad²): c² /
    (|P1 Eᵀ r2|² + |P2 E r1|²), c = r2ᵀ E r1 and P_i = I - r_i r_iᵀ the
    tangent-plane projectors. E (..., 3, 3), r1, r2 (..., 3) broadcast."""
    Er1 = _apply(E, r1)
    Etr2 = _apply(E.transpose(-1, -2), r2)
    c = (r2 * Er1).sum(-1)
    t2 = Er1 - (Er1 * r2).sum(-1, keepdim=True) * r2
    t1 = Etr2 - (Etr2 * r1).sum(-1, keepdim=True) * r1
    denom = (t1 * t1).sum(-1) + (t2 * t2).sum(-1)
    return c * c / torch.clamp(denom, min=1e-20)


def homography_ray_angular_error(H, r1, r2):
    """2 (1 - cos ∠(H r1, r2)), the squared angle for small angles (rad²).
    H (..., 3, 3), r1, r2 (..., 3) broadcast."""
    hr = _apply(H, r1)
    hr = hr / torch.clamp(torch.linalg.vector_norm(hr, dim=-1, keepdim=True), min=1e-20)
    cos = torch.clamp((hr * r2).sum(-1), -1.0, 1.0)
    return 2.0 * (1.0 - cos)


def pose_from_essential_matrix_rays(E, r1, r2, mask=None):
    """cam2_from_cam1 (R, t) from E and bearing rays (N, 3): of the four
    decompositions, the one whose midpoint triangulation puts most rays in
    front of both cameras. Returns (R, t, X (N, 3) in cam1, count, ok (N,))
    (colmap_tpu's pose_from_essential_matrix_rays)."""
    if mask is None:
        mask = torch.ones(r1.shape[:-1], dtype=torch.bool, device=r1.device)
    R1, R2, t = decompose_essential_matrix(E)
    best = None
    for R, tt in ((R1, t), (R2, t), (R1, -t), (R2, -t)):
        r2_in_1 = r2 @ R  # rows Rᵀ r2
        c2 = -(R.T @ tt)
        # The null vector of [r1, -r2_in_1, -c2] per pair.
        A = torch.stack([r1, -r2_in_1, -c2.expand_as(r1)], dim=-1)
        _, vecs = torch.linalg.eigh(A.transpose(-1, -2) @ A)
        null = vecs[..., :, 0]
        w = null[..., 2]
        lam = null[..., :2] / torch.where(torch.abs(w) > 1e-12, w, 1.0)[..., None]
        ok = (torch.abs(w) > 1e-12) & (lam[..., 0] > 1e-12) & (lam[..., 1] > 1e-12) & mask
        X = 0.5 * (lam[..., :1] * r1 + c2 + lam[..., 1:2] * r2_in_1)
        count = int(ok.sum())
        if best is None or count > best[3]:
            best = (R, tt, X, count, ok)
    return best
