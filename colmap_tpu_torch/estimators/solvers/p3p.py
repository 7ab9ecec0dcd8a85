"""Batched P3P absolute-pose minimal solver (Grunert's quartic).

Counterpart of colmap_tpu/estimators/solvers/p3p.py (reference behavior:
src/colmap/estimators/solvers/absolute_pose.*): the quartic in the distance
ratio v = s3/s1 (coefficients as in Haralick et al. 1994), the three
camera-frame distances, then the rigid pose by Kabsch alignment. These are
the plain versions of what the CUDA kernel K6 computes per sample
(csrc/p3p_ransac.cu); every function broadcasts over leading batch dims.
"""

from __future__ import annotations

import torch

from colmap_tpu_torch.optim.polynomial import solve_quartic


def kabsch(src, dst, weights=None):
    """Rigid alignment: (R, t) with dst ≈ R src + t. src, dst: (..., N, 3)."""
    if weights is None:
        weights = torch.ones(src.shape[:-1], dtype=src.dtype, device=src.device)
    wsum = torch.clamp(weights.sum(-1, keepdim=True), min=1e-30)
    src_c = (src * weights[..., None]).sum(-2) / wsum
    dst_c = (dst * weights[..., None]).sum(-2) / wsum
    src0 = src - src_c[..., None, :]
    dst0 = dst - dst_c[..., None, :]
    H = torch.einsum("...ni,...nj,...n->...ij", src0, dst0, weights)
    U, _, Vt = torch.linalg.svd(H)
    V, Ut = Vt.transpose(-1, -2), U.transpose(-1, -2)
    det = torch.linalg.det(V @ Ut)
    D = torch.ones(H.shape[:-2] + (3,), dtype=src.dtype, device=src.device)
    D[..., 2] = det
    R = V @ (D[..., None] * Ut)
    t = dst_c - torch.einsum("...ij,...j->...i", R, src_c)
    return R, t


def p3p(points3D, rays):
    """P3P for (..., 3, 3) world points and unit camera-frame bearings.

    Returns R (..., 4, 3, 3), t (..., 4, 3): up to four cam_from_world
    solutions, NaN where a root is invalid.
    """
    X1, X2, X3 = points3D[..., 0, :], points3D[..., 1, :], points3D[..., 2, :]
    f1, f2, f3 = rays[..., 0, :], rays[..., 1, :], rays[..., 2, :]
    a2 = ((X2 - X3) ** 2).sum(-1)
    b2 = ((X1 - X3) ** 2).sum(-1)
    c2 = ((X1 - X2) ** 2).sum(-1)
    cos_a = (f2 * f3).sum(-1)
    cos_b = (f1 * f3).sum(-1)
    cos_g = (f1 * f2).sum(-1)
    b2s = torch.clamp(b2, min=1e-30)
    ac_b = (a2 - c2) / b2s
    apc_b = (a2 + c2) / b2s
    A4 = (ac_b - 1.0) ** 2 - 4.0 * (c2 / b2s) * cos_a**2
    A3 = 4.0 * (ac_b * (1.0 - ac_b) * cos_b - (1.0 - apc_b) * cos_a * cos_g
                + 2.0 * (c2 / b2s) * cos_a**2 * cos_b)
    A2 = 2.0 * (ac_b**2 - 1.0 + 2.0 * ac_b**2 * cos_b**2 + 2.0 * ((b2 - c2) / b2s) * cos_a**2
                - 4.0 * apc_b * cos_a * cos_b * cos_g + 2.0 * ((b2 - a2) / b2s) * cos_g**2)
    A1 = 4.0 * (-ac_b * (1.0 + ac_b) * cos_b + 2.0 * (a2 / b2s) * cos_g**2 * cos_b
                - (1.0 - apc_b) * cos_a * cos_g)
    A0 = (1.0 + ac_b) ** 2 - 4.0 * (a2 / b2s) * cos_g**2
    v, ok = solve_quartic(A4, A3, A2, A1, A0)  # (..., 4)
    ex = lambda x: x[..., None]  # noqa: E731
    denom_u = 2.0 * (ex(cos_g) - v * ex(cos_a))
    u = ((-1.0 + ex(ac_b)) * v**2 - 2.0 * ex(ac_b * cos_b) * v + 1.0 + ex(ac_b)) / torch.where(
        torch.abs(denom_u) < 1e-12, 1.0, denom_u)
    s1_den = 1.0 + v**2 - 2.0 * v * ex(cos_b)
    s1 = torch.sqrt(ex(b2) / torch.clamp(s1_den, min=1e-30))
    ok = ok & (v > 0) & (u > 0) & (s1_den > 1e-30) & (torch.abs(denom_u) >= 1e-12)
    Y = torch.stack([s1[..., None] * f1[..., None, :], (u * s1)[..., None] * f2[..., None, :],
                     (v * s1)[..., None] * f3[..., None, :]], dim=-2)  # (..., 4, 3, 3)
    R, t = kabsch(points3D[..., None, :, :].expand(Y.shape), Y)
    nan = torch.tensor(float("nan"), dtype=R.dtype, device=R.device)
    return torch.where(ok[..., None, None], R, nan), torch.where(ok[..., None], t, nan)
