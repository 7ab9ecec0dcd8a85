"""Essential and fundamental matrix math, batched.

Counterpart of colmap_tpu/geometry/essential.py (reference behavior:
src/colmap/geometry/essential_matrix.h:53-81). Functions broadcast over
leading batch dimensions; the convention is ``x2ᵀ E x1 = 0`` with E built
from ``cam2_from_cam1`` as [t]x R. They run as torch ops on the device of
their inputs: the initial pair calls them a few times per candidate pair, on
at most a few thousand matches.
"""

from __future__ import annotations

import torch

from colmap_tpu_torch.geometry import rotation as rot


def cross_product_matrix(v):
    """(..., 3) -> (..., 3, 3) skew-symmetric matrix."""
    z = torch.zeros_like(v[..., 0])
    m = torch.stack(
        [z, -v[..., 2], v[..., 1],
         v[..., 2], z, -v[..., 0],
         -v[..., 1], v[..., 0], z],
        dim=-1,
    )
    return m.reshape(v.shape[:-1] + (3, 3))


def essential_from_pose(quat, t):
    """E = [t / |t|]x R of cam2_from_cam1 given as a wxyz quaternion (4,)
    and a translation (3,) (essential_matrix.cc EssentialMatrixFromPose)."""
    t = t / torch.clamp(torch.linalg.vector_norm(t, dim=-1, keepdim=True), min=1e-30)
    return cross_product_matrix(t) @ rot.quat_to_rotmat(quat)


def essential_from_fundamental(K2, F, K1):
    """E = K2ᵀ F K1."""
    return K2.transpose(-1, -2) @ F @ K1


def decompose_essential_matrix(E):
    """E -> (R1, R2, t) candidate decompositions.

    reference behavior: DecomposeEssentialMatrix (essential_matrix.cc):
    SVD with det-positive corrections; t is the last left singular vector.
    """
    U, _, Vt = torch.linalg.svd(E)
    U = U * torch.sign(torch.linalg.det(U))[..., None, None]
    Vt = Vt * torch.sign(torch.linalg.det(Vt))[..., None, None]
    W = torch.tensor([[0.0, 1, 0], [-1, 0, 0], [0, 0, 1]], dtype=E.dtype, device=E.device)
    R1 = U @ W @ Vt
    R2 = U @ W.T @ Vt
    t = U[..., :, 2]
    t = t / torch.clamp(torch.linalg.vector_norm(t, dim=-1, keepdim=True), min=1e-30)
    return R1, R2, t


def triangulate_point_dlt(proj1, proj2, x1, x2):
    """Two-view DLT triangulation.

    proj1/proj2: (..., 3, 4) projection matrices [R|t]; x1/x2: (..., 2)
    normalized image points. Returns (..., 3) world points (reference:
    TriangulatePoint, geometry/triangulation.cc).
    """
    rows = [
        x1[..., 0, None] * proj1[..., 2, :] - proj1[..., 0, :],
        x1[..., 1, None] * proj1[..., 2, :] - proj1[..., 1, :],
        x2[..., 0, None] * proj2[..., 2, :] - proj2[..., 0, :],
        x2[..., 1, None] * proj2[..., 2, :] - proj2[..., 1, :],
    ]
    A = torch.stack(torch.broadcast_tensors(*rows), dim=-2)  # (..., 4, 4)
    _, _, Vt = torch.linalg.svd(A)
    Xh = Vt[..., 3, :]
    w = Xh[..., 3]
    safe_w = torch.where(torch.abs(w) < 1e-30, 1.0, w)
    return Xh[..., :3] / safe_w[..., None]


def calc_depth(proj, X):
    """Depth of world point X under projection matrix proj (..., 3, 4)."""
    Xh = torch.cat([X, torch.ones_like(X[..., :1])], dim=-1)
    z = (proj[..., 2, :] * Xh).sum(-1)
    return z * torch.linalg.vector_norm(proj[..., 2, :3], dim=-1)


def pose_from_essential_matrix(E, x1, x2, mask=None):
    """Recover cam2_from_cam1 from E and matched normalized points.

    Tests the four (R, t) candidates and keeps the one with the most points
    in front of both cameras (reference: PoseFromEssentialMatrix).
    E: (3, 3); x1, x2: (N, 2); mask: optional (N,) validity, padded rows
    excluded from the vote. Returns (R, t, points3D (N, 3), num_valid
    (0-dim int tensor), valid_mask (N,)).
    """
    if mask is None:
        mask = torch.ones(x1.shape[:-1], dtype=torch.bool, device=x1.device)
    R1, R2, t = decompose_essential_matrix(E)
    eye34 = torch.eye(3, 4, dtype=E.dtype, device=E.device)
    best = None
    for R, tt in ((R1, t), (R2, t), (R1, -t), (R2, -t)):
        proj2 = torch.cat([R, tt[:, None]], dim=1)
        X = triangulate_point_dlt(eye34, proj2, x1, x2)
        d1 = calc_depth(eye34, X)
        d2 = calc_depth(proj2, X)
        max_depth = 1000.0 * torch.linalg.vector_norm(tt)
        ok = (d1 > 1e-12) & (d1 < max_depth) & (d2 > 1e-12) & (d2 < max_depth) & mask
        count = ok.sum()
        # argmax semantics: the first candidate with the largest count.
        if best is None or bool(count > best[3]):
            best = (R, tt, X, count, ok)
    return best


def sampson_error(E, x1, x2):
    """First-order geometric error of the epipolar constraint, per point.

    x1, x2: (..., 2) normalized points; E: (..., 3, 3) (reference:
    estimators/cost_functions/sampson_error.h).
    """
    u1, v1 = x1[..., 0], x1[..., 1]
    u2, v2 = x2[..., 0], x2[..., 1]
    a = E[..., 0, 0] * u1 + E[..., 0, 1] * v1 + E[..., 0, 2]
    b = E[..., 1, 0] * u1 + E[..., 1, 1] * v1 + E[..., 1, 2]
    c = E[..., 2, 0] * u1 + E[..., 2, 1] * v1 + E[..., 2, 2]
    at = E[..., 0, 0] * u2 + E[..., 1, 0] * v2 + E[..., 2, 0]
    bt = E[..., 0, 1] * u2 + E[..., 1, 1] * v2 + E[..., 2, 1]
    x2tEx1 = u2 * a + v2 * b + c
    denom = a * a + b * b + at * at + bt * bt
    return x2tEx1**2 / torch.clamp(denom, min=1e-30)


def squared_epipolar_line_distance(F, x1, x2):
    """Squared distance of x2 to the epipolar line F x1, per point. F
    (..., 3, 3); x1, x2 (..., 2) pixels; batch dimensions broadcast."""
    u1, v1 = x1[..., 0], x1[..., 1]
    u2, v2 = x2[..., 0], x2[..., 1]
    a = F[..., 0, 0] * u1 + F[..., 0, 1] * v1 + F[..., 0, 2]
    b = F[..., 1, 0] * u1 + F[..., 1, 1] * v1 + F[..., 1, 2]
    c = F[..., 2, 0] * u1 + F[..., 2, 1] * v1 + F[..., 2, 2]
    x2tFx1 = u2 * a + v2 * b + c
    return x2tFx1**2 / torch.clamp(a * a + b * b, min=1e-30)
