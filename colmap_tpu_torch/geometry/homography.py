"""Homography decomposition into relative pose + plane normal.

Counterpart of colmap_tpu/geometry/homography.py (reference behavior:
src/colmap/geometry/homography_matrix.{h,cc}): the analytical decomposition of Malis & Vargas ("Deeper understanding of the
homography decomposition for vision-based control") producing up to 4
(R, t, n) candidates plus the pure-rotation special case, and
PoseFromHomographyMatrix, which picks the candidate with the best cheirality
support / lowest angular reprojection error (homography_matrix.cc:221-254).

Host-side math in numpy, as in colmap_tpu: the decomposition is a handful
of 3x3 operations per pair and the cheirality scoring over the inlier rays
is vectorized over at most 4 candidates.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np


def _opposite_of_minor(m: np.ndarray, row: int, col: int) -> float:
    col1 = 1 if col == 0 else 0
    col2 = 1 if col == 2 else 2
    row1 = 1 if row == 0 else 0
    row2 = 1 if row == 2 else 2
    return m[row1, col2] * m[row2, col1] - m[row1, col1] * m[row2, col2]


def decompose_homography_matrix(
    H: np.ndarray, K1: np.ndarray, K2: np.ndarray
) -> Tuple[List[np.ndarray], List[np.ndarray], List[np.ndarray]]:
    """Decompose H into candidate (R, t, n) triples.

    Returns (Rs, ts, ns): the pure-rotation case yields a single candidate
    with t = n = 0; otherwise 4 candidates (reference:
    DecomposeHomographyMatrix, homography_matrix.cc:67-186).
    """
    H = np.asarray(H, np.float64)
    Hn = np.linalg.inv(np.asarray(K2, np.float64)) @ H @ np.asarray(K1, np.float64)
    # Remove scale: middle singular value to 1.
    sv = np.linalg.svd(Hn, compute_uv=False)
    Hn = Hn / sv[1]
    if np.linalg.det(Hn) < 0:
        Hn = -Hn

    S = Hn.T @ Hn - np.eye(3)
    if np.max(np.abs(S)) < 1e-3:
        # Pure rotation (panoramic pair).
        return [Hn.copy()], [np.zeros(3)], [np.zeros(3)]

    M00 = _opposite_of_minor(S, 0, 0)
    M11 = _opposite_of_minor(S, 1, 1)
    M22 = _opposite_of_minor(S, 2, 2)
    rtM00 = np.sqrt(max(M00, 0.0))
    rtM11 = np.sqrt(max(M11, 0.0))
    rtM22 = np.sqrt(max(M22, 0.0))
    M01 = _opposite_of_minor(S, 0, 1)
    M12 = _opposite_of_minor(S, 1, 2)
    M02 = _opposite_of_minor(S, 0, 2)

    def sign(x):
        return 1.0 if x >= 0 else -1.0

    e12, e02, e01 = sign(M12), sign(M02), sign(M01)
    nS = [abs(S[0, 0]), abs(S[1, 1]), abs(S[2, 2])]
    idx = int(np.argmax(nS))

    np1 = np.zeros(3)
    np2 = np.zeros(3)
    if idx == 0:
        np1[0] = np2[0] = S[0, 0]
        np1[1] = S[0, 1] + rtM22
        np2[1] = S[0, 1] - rtM22
        np1[2] = S[0, 2] + e12 * rtM11
        np2[2] = S[0, 2] - e12 * rtM11
    elif idx == 1:
        np1[0] = S[0, 1] + rtM22
        np2[0] = S[0, 1] - rtM22
        np1[1] = np2[1] = S[1, 1]
        np1[2] = S[1, 2] - e02 * rtM00
        np2[2] = S[1, 2] + e02 * rtM00
    else:
        np1[0] = S[0, 2] + e01 * rtM11
        np2[0] = S[0, 2] - e01 * rtM11
        np1[1] = S[1, 2] + rtM00
        np2[1] = S[1, 2] - rtM00
        np1[2] = np2[2] = S[2, 2]

    traceS = np.trace(S)
    v = 2.0 * np.sqrt(max(1.0 + traceS - M00 - M11 - M22, 0.0))
    ESii = sign(S[idx, idx])
    r = np.sqrt(max(2.0 + traceS + v, 0.0))
    n_t = np.sqrt(max(2.0 + traceS - v, 0.0))
    n1 = np1 / max(np.linalg.norm(np1), 1e-12)
    n2 = np2 / max(np.linalg.norm(np2), 1e-12)
    half_nt = 0.5 * n_t
    esii_t_r = ESii * r
    t1_star = half_nt * (esii_t_r * n2 - n_t * n1)
    t2_star = half_nt * (esii_t_r * n1 - n_t * n2)
    R1 = Hn @ (np.eye(3) - (2.0 / v) * np.outer(t1_star, n1))
    t1 = R1 @ t1_star
    R2 = Hn @ (np.eye(3) - (2.0 / v) * np.outer(t2_star, n2))
    t2 = R2 @ t2_star
    return (
        [R1, R1, R2, R2],
        [t1, -t1, t2, -t2],
        [-n1, n1, -n2, n2],
    )


def _cheirality_and_error(R, t, rays1, rays2):
    """Midpoint-triangulate every ray pair under (R, t); return
    (points3D (N,3), valid (N,), angular reprojection error sum over valid)
    (reference: CheckCheiralityAndReprojErrorSum,
    homography_matrix.cc:193-217)."""
    rays2_in_1 = rays2 @ R  # R^T applied row-wise
    c2_in_1 = -(R.T @ t)
    # Solve [ray1, -ray2_in_1, -c2_in_1] * (l1, l2, 1)^T = 0 per pair via
    # the right null vector of the 3x3 system.
    A = np.stack(
        [rays1, -rays2_in_1, -np.broadcast_to(c2_in_1, rays1.shape)], axis=-1
    )  # (N, 3, 3)
    _, _, Vt = np.linalg.svd(A)
    null = Vt[:, 2, :]  # (N, 3)
    w = null[:, 2]
    ok = np.abs(w) > 1e-12
    lam = null[:, :2] / np.where(ok[:, None], w[:, None], 1.0)
    ok &= (lam[:, 0] > np.finfo(float).eps) & (lam[:, 1] > np.finfo(float).eps)
    X1 = 0.5 * (
        lam[:, :1] * rays1 + c2_in_1[None] + lam[:, 1:2] * rays2_in_1
    )
    X2 = X1 @ R.T + t
    n1 = X1 / np.maximum(np.linalg.norm(X1, axis=1, keepdims=True), 1e-12)
    n2 = X2 / np.maximum(np.linalg.norm(X2, axis=1, keepdims=True), 1e-12)
    err = (1.0 - np.clip(np.sum(rays1 * n1, 1), -1, 1)) + (
        1.0 - np.clip(np.sum(rays2 * n2, 1), -1, 1)
    )
    err_sum = float(np.sum(np.where(ok, err, 0.0)))
    return X1, ok, err_sum


def pose_from_homography_matrix(
    H: np.ndarray,
    K1: np.ndarray,
    K2: np.ndarray,
    rays1: np.ndarray,
    rays2: np.ndarray,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Recover the most supported (R, t, n) from H and inlier bearing rays.

    Args:
        rays1/rays2: (N, 3) unit bearing rays in each camera.
    Returns:
        (R, t, n, points3D (M,3) in cam1, valid_count) of the winning
        candidate (reference: PoseFromHomographyMatrix,
        homography_matrix.cc:221-254 — most cheirality-positive points,
        ties broken by angular error).
    """
    rays1 = np.asarray(rays1, np.float64)
    rays2 = np.asarray(rays2, np.float64)
    Rs, ts, ns = decompose_homography_matrix(H, K1, K2)
    best = None
    for R, t, n in zip(Rs, ts, ns):
        X, ok, err = _cheirality_and_error(R, t, rays1, rays2)
        count = int(ok.sum())
        if best is None or count > best[4] or (
            count == best[4] and err < best[5]
        ):
            best = (R, t, n, X[ok], count, err)
    R, t, n, X, count, _ = best
    return R, t, n, X, count
