"""Batched epipolar solvers: E (5-point, 8-point), F (7-point, 8-point), H (DLT).

Counterpart of colmap_tpu/estimators/solvers/epipolar.py (reference
behavior: src/colmap/estimators/solvers/{essential,fundamental,homography}_
matrix.* and essential_matrix_poly.h). Every solver maps (..., m, 2) samples
(or a weighted N-point set, for the refits) to one or more 3x3 models, NaN
where a slot holds no solution, with Hartley normalization inside. The
fundamental and homography solvers are the plain versions of the CUDA
kernels K11 and K12 (csrc/fundamental_ransac.cu, csrc/homography_ransac.cu).
The 5-point solve keeps
colmap_tpu's formulation: null space of the 5x9 constraint matrix, the
10x20 cubic-constraint system, Gauss-Jordan, the 3x3 polynomial matrix
B(z) whose determinant is of degree 10, its real roots isolated on a grid of
G = 1024 cells in θ (z = tan θ, in homogeneous (sin, cos) form), split at
derivative extrema and polished by bisection, then x(z), y(z) by least
squares and a Newton-Schulz projection onto the essential manifold. These
are the plain versions of the CUDA kernel K7 (csrc/essential_ransac.cu),
batched over a leading sample dimension.
"""

from __future__ import annotations

import math

import torch

from colmap_tpu_torch.optim.polynomial import solve_cubic
from colmap_tpu_torch.optim.small_linalg import eigh_small, nullspace_small, svd3x3

GRID = 1024  # cells in θ over [-π/2, π/2]

# Monomials: deg1 [x, y, z, 1]; deg2 [x², y², z², xy, xz, yz, x, y, z, 1];
# deg3 (Nistér's order) [x³, y³, x²y, xy², x²z, x², y²z, y², xyz, xy,
#                        xz², xz, x, yz², yz, y, z³, z², z, 1].
_MUL11 = ((0, 3, 4, 6), (3, 1, 5, 7), (4, 5, 2, 8), (6, 7, 8, 9))
_MUL21 = (
    (0, 2, 4, 5), (3, 1, 6, 7), (10, 13, 16, 17), (2, 3, 8, 9), (4, 8, 10, 11),
    (8, 6, 13, 14), (5, 9, 11, 12), (9, 7, 14, 15), (11, 14, 17, 18), (12, 15, 18, 19),
)


def _mul_table(table, n_out, like):
    T = torch.zeros(len(table), len(table[0]), n_out, dtype=like.dtype, device=like.device)
    for i, row in enumerate(table):
        for j, k in enumerate(row):
            T[i, j, k] = 1.0
    return T


def _hartley_normalize(pts, weights=None):
    """Similarity T with weighted mean 0 and mean distance sqrt(2).
    Returns (pts_normalized, T (..., 3, 3))."""
    if weights is None:
        weights = torch.ones(pts.shape[:-1], dtype=pts.dtype, device=pts.device)
    wsum = torch.clamp(weights.sum(-1, keepdim=True), min=1e-30)
    centroid = (pts * weights[..., None]).sum(-2) / wsum
    centered = pts - centroid[..., None, :]
    mean_dist = (torch.linalg.vector_norm(centered, dim=-1) * weights).sum(-1) / wsum[..., 0]
    scale = math.sqrt(2.0) / torch.clamp(mean_dist, min=1e-30)
    T = torch.zeros(pts.shape[:-2] + (3, 3), dtype=pts.dtype, device=pts.device)
    T[..., 0, 0] = scale
    T[..., 1, 1] = scale
    T[..., 2, 2] = 1.0
    T[..., 0, 2] = -scale * centroid[..., 0]
    T[..., 1, 2] = -scale * centroid[..., 1]
    return centered * scale[..., None, None], T


def _epipolar_constraint_matrix(x1, x2):
    """Rows x2_i ⊗ x1_i of the system x2ᵀ E x1 = 0."""
    u1, v1 = x1[..., 0], x1[..., 1]
    u2, v2 = x2[..., 0], x2[..., 1]
    return torch.stack([u2 * u1, u2 * v1, u2, v2 * u1, v2 * v1, v2, u1, v1, torch.ones_like(u1)],
                       dim=-1)


def _smallest_right_singular(A):
    """Right singular vector of the smallest singular value of A (..., m, n):
    the exact null space by Householder QR for a minimal sample (m < n), the
    smallest eigenvector of AᵀA (eigh_small) for an overdetermined refit."""
    if A.shape[-2] < A.shape[-1]:
        return nullspace_small(A, 1)[..., :, 0]
    _, vecs = eigh_small(A.transpose(-1, -2) @ A)
    return vecs[..., :, 0]


def _det3(M):
    return (M[..., 0, 0] * (M[..., 1, 1] * M[..., 2, 2] - M[..., 1, 2] * M[..., 2, 1])
            - M[..., 0, 1] * (M[..., 1, 0] * M[..., 2, 2] - M[..., 1, 2] * M[..., 2, 0])
            + M[..., 0, 2] * (M[..., 1, 0] * M[..., 2, 1] - M[..., 1, 1] * M[..., 2, 0]))


def _similarity_inv(T):
    """Inverse of a Hartley similarity [[s, 0, tx], [0, s, ty], [0, 0, 1]]."""
    inv_s = 1.0 / T[..., 0, 0]
    out = torch.zeros_like(T)
    out[..., 0, 0] = inv_s
    out[..., 1, 1] = inv_s
    out[..., 2, 2] = 1.0
    out[..., 0, 2] = -T[..., 0, 2] * inv_s
    out[..., 1, 2] = -T[..., 1, 2] * inv_s
    return out


def _unit_frobenius(M):
    norm = torch.linalg.vector_norm(M.flatten(-2), dim=-1)
    return M / torch.clamp(norm, min=1e-30)[..., None, None]


def fundamental_eight_point(x1, x2, weights=None):
    """8-point (or weighted N-point) fundamental matrix of unit Frobenius
    norm, rank 2 enforced. x1, x2: (..., N, 2) pixels; weights (..., N)."""
    n1, T1 = _hartley_normalize(x1, weights)
    n2, T2 = _hartley_normalize(x2, weights)
    A = _epipolar_constraint_matrix(n1, n2)
    if weights is not None:
        A = A * weights[..., None]
    f = _smallest_right_singular(A)
    F = f.reshape(f.shape[:-1] + (3, 3))
    U, S, Vt = svd3x3(F)
    S = torch.cat([S[..., :2], torch.zeros_like(S[..., :1])], dim=-1)
    F = U @ (S[..., None] * Vt)
    return _unit_frobenius(T2.transpose(-1, -2) @ F @ T1)


def fundamental_seven_point(x1, x2):
    """7-point fundamental matrices: x1, x2 (..., 7, 2). Returns
    (..., 3, 3, 3), the solution axis first, NaN where a root is complex."""
    n1, T1 = _hartley_normalize(x1)
    n2, T2 = _hartley_normalize(x2)
    A = _epipolar_constraint_matrix(n1, n2)  # (..., 7, 9)
    ns = nullspace_small(A, 2)  # (..., 9, 2)
    batch = A.shape[:-2]
    f1 = ns[..., :, 0].reshape(batch + (3, 3))
    f2 = ns[..., :, 1].reshape(batch + (3, 3))
    # det(a F1 + (1 - a) F2) is a cubic in a: interpolate it at 4 nodes.
    nodes = torch.tensor([0.0, 1.0, 2.0, -1.0], dtype=x1.dtype, device=x1.device)
    gv = torch.stack([_det3(a * f1 + (1 - a) * f2) for a in nodes], dim=-1)
    V = torch.stack([nodes**3, nodes**2, nodes, torch.ones_like(nodes)], dim=-1)
    coeffs = torch.einsum("ij,...j->...i", torch.linalg.inv(V), gv)
    roots, mask = solve_cubic(coeffs[..., 0], coeffs[..., 1], coeffs[..., 2], coeffs[..., 3])
    a = roots[..., None, None]  # (..., 3, 1, 1)
    F = a * f1[..., None, :, :] + (1 - a) * f2[..., None, :, :]
    F = _unit_frobenius(T2.transpose(-1, -2)[..., None, :, :] @ F @ T1[..., None, :, :])
    nan = torch.tensor(float("nan"), dtype=x1.dtype, device=x1.device)
    return torch.where(mask[..., None, None], F, nan)


def homography_dlt(x1, x2, weights=None):
    """4-point (or weighted N-point) homography by DLT, x2 ~ H x1, of unit
    Frobenius norm. x1, x2: (..., N, 2); weights (..., N)."""
    n1, T1 = _hartley_normalize(x1, weights)
    n2, T2 = _hartley_normalize(x2, weights)
    u1, v1 = n1[..., 0], n1[..., 1]
    u2, v2 = n2[..., 0], n2[..., 1]
    z, o = torch.zeros_like(u1), torch.ones_like(u1)
    row1 = torch.stack([-u1, -v1, -o, z, z, z, u2 * u1, u2 * v1, u2], dim=-1)
    row2 = torch.stack([z, z, z, -u1, -v1, -o, v2 * u1, v2 * v1, v2], dim=-1)
    A = torch.cat([row1, row2], dim=-2)
    if weights is not None:
        A = A * torch.cat([weights, weights], dim=-1)[..., None]
    h = _smallest_right_singular(A)
    H = h.reshape(h.shape[:-1] + (3, 3))
    return _unit_frobenius(_similarity_inv(T2) @ H @ T1)


def homography_transfer_error(H, x1, x2):
    """Squared forward transfer error |H x1 - x2|² per point; inf where the
    transferred point lies at infinity (|w| < 1e-12). H (..., 3, 3); x1, x2
    (..., 2); batch dimensions broadcast."""
    u1, v1 = x1[..., 0], x1[..., 1]
    hx = H[..., 0, 0] * u1 + H[..., 0, 1] * v1 + H[..., 0, 2]
    hy = H[..., 1, 0] * u1 + H[..., 1, 1] * v1 + H[..., 1, 2]
    w = H[..., 2, 0] * u1 + H[..., 2, 1] * v1 + H[..., 2, 2]
    bad = torch.abs(w) < 1e-12
    safe_w = torch.where(bad, 1.0, w)
    dx = hx / safe_w - x2[..., 0]
    dy = hy / safe_w - x2[..., 1]
    return torch.where(bad, torch.inf, dx * dx + dy * dy)


def essential_eight_point(x1, x2, weights=None):
    """Weighted N-point essential matrix projected to singular values (1, 1, 0).

    x1, x2: (..., N, 2) normalized coordinates; weights (..., N). The
    smallest eigenvector of AᵀA comes from eigh_small, as in colmap_tpu.
    """
    n1, T1 = _hartley_normalize(x1, weights)
    n2, T2 = _hartley_normalize(x2, weights)
    A = _epipolar_constraint_matrix(n1, n2)
    if weights is not None:
        A = A * weights[..., None]
    _, vecs = eigh_small(A.transpose(-1, -2) @ A)
    E = vecs[..., :, 0].reshape(vecs.shape[:-2] + (3, 3))
    E = T2.transpose(-1, -2) @ E @ T1
    U, S, Vt = svd3x3(E)
    S_proj = torch.cat([torch.ones_like(S[..., :2]), torch.zeros_like(S[..., :1])], dim=-1)
    return U @ (S_proj[..., None] * Vt)


def _polymul(a, b):
    """Full convolution of descending-power coefficient vectors (..., m), (..., n)."""
    m, n = a.shape[-1], b.shape[-1]
    out = a.new_zeros(torch.broadcast_shapes(a.shape[:-1], b.shape[:-1]) + (m + n - 1,))
    for i in range(m):
        out[..., i:i + n] += a[..., i, None] * b
    return out


def _polyval_homog(coeffs, s, c):
    """Σ_k coeffs[k] s^(n-k) c^k for coeffs (..., n+1) and s, c (..., G)."""
    out = torch.zeros(coeffs.shape[:-1] + s.shape[-1:], dtype=coeffs.dtype, device=coeffs.device)
    for k in range(coeffs.shape[-1]):
        out = out * s + coeffs[..., k, None] * (c**k if k else 1.0)
    return out


def _first_true(mask, k):
    """Indices of the first k True entries along the last axis (0 where
    fewer), and their validity."""
    G = mask.shape[-1]
    span = torch.arange(G, device=mask.device)
    top = torch.topk(torch.where(mask, G - span, 0), k, dim=-1).values
    return torch.where(top > 0, G - top, 0), top > 0


def essential_five_point(x1, x2):
    """Nistér 5-point essential matrices: x1, x2 (..., 5, 2) normalized
    coordinates. Returns (..., 10, 3, 3), NaN where a slot holds no root."""
    return _essential_five_point_from_constraints(_epipolar_constraint_matrix(x1, x2))


def _essential_five_point_from_constraints(A):
    """Batched Nistér solve from (B, 5, 9) constraint matrices."""
    dtype, dev = A.dtype, A.device
    batch = A.shape[:-2]
    A = A.reshape(-1, 5, 9)
    B = A.shape[0]
    ns = nullspace_small(A, 4)  # (B, 9, 4): E = x E0 + y E1 + z E2 + E3
    EB = ns.reshape(B, 3, 3, 4)
    T11 = _mul_table(_MUL11, 10, A)
    T21 = _mul_table(_MUL21, 20, A)
    p11 = lambda p, q: torch.einsum("...i,...j,ijk->...k", p, q, T11)  # noqa: E731
    p21 = lambda p, q: torch.einsum("...i,...j,ijk->...k", p, q, T21)  # noqa: E731

    def minor(i0, i1, j0, j1):
        return p11(EB[:, i0, j0], EB[:, i1, j1]) - p11(EB[:, i0, j1], EB[:, i1, j0])

    det_row = (p21(minor(1, 2, 1, 2), EB[:, 0, 0]) - p21(minor(1, 2, 0, 2), EB[:, 0, 1])
               + p21(minor(1, 2, 0, 1), EB[:, 0, 2]))
    EEt = [[sum(p11(EB[:, i, j], EB[:, k, j]) for j in range(3)) for k in range(3)]
           for i in range(3)]
    trace = EEt[0][0] + EEt[1][1] + EEt[2][2]
    rows = [det_row]
    for i in range(3):
        for j in range(3):
            rows.append(sum(p21(2.0 * EEt[i][k] - (trace if i == k else 0.0), EB[:, k, j])
                            for k in range(3)))
    M = torch.stack(rows, dim=1)  # (B, 10, 20)
    # Gauss-Jordan [A1 | A2] -> [I | A1⁻¹ A2]; a singular A1 gives non-finite
    # entries and so a model that scores 0.
    Mred = torch.linalg.solve_ex(M[:, :, :10], M[:, :, 10:])[0]  # (B, 10, 10)

    def brow(i):
        r1, r2 = Mred[:, 4 + 2 * i], Mred[:, 5 + 2 * i]
        p1 = torch.stack([r2[:, 0], r2[:, 1] - r1[:, 0], r2[:, 2] - r1[:, 1], -r1[:, 2]], -1)
        p2 = torch.stack([r2[:, 3], r2[:, 4] - r1[:, 3], r2[:, 5] - r1[:, 4], -r1[:, 5]], -1)
        p3 = torch.stack([r2[:, 6], r2[:, 7] - r1[:, 6], r2[:, 8] - r1[:, 7], r2[:, 9] - r1[:, 8],
                          -r1[:, 9]], -1)
        return p1, p2, p3

    (p1a, p2a, p3a), (p1b, p2b, p3b), (p1c, p2c, p3c) = brow(0), brow(1), brow(2)
    conv = _polymul
    n_poly = (conv(p1a, conv(p2b, p3c) - conv(p2c, p3b))
              - conv(p2a, conv(p1b, p3c) - conv(p1c, p3b))
              + conv(p3a, conv(p1b, p2c) - conv(p1c, p2b)))  # (B, 11)
    tiny = 1e-300 if dtype == torch.float64 else 1e-30
    n_poly = n_poly / torch.clamp(n_poly.abs().amax(-1, keepdim=True), min=tiny)

    theta = torch.arange(GRID + 1, dtype=dtype, device=dev) / GRID * math.pi - math.pi / 2
    sin_t, cos_t = torch.sin(theta), torch.cos(theta)
    v = _polyval_homog(n_poly, sin_t, cos_t)  # (B, G+1)
    d_poly = n_poly[:, :-1] * torch.arange(10, 0, -1, dtype=dtype, device=dev)
    dv = _polyval_homog(d_poly, sin_t, cos_t)

    sign_change = v[:, :-1] * v[:, 1:] < 0
    idx, direct_valid = _first_true(sign_change, 10)
    d_lo, d_hi = theta[idx], theta[idx + 1]
    ext_cell = (dv[:, :-1] * dv[:, 1:] < 0) & ~sign_change
    eidx, e_valid = _first_true(ext_cell, 9)
    e_lo, e_hi = theta[eidx], theta[eidx + 1]
    e_dlo = torch.gather(dv, 1, eidx)

    def polyval_at(coeffs, t):
        return _polyval_homog(coeffs, torch.sin(t), torch.cos(t))

    el, eh = e_lo, e_hi
    for _ in range(50 if dtype == torch.float64 else 24):
        mid = 0.5 * (el + eh)
        right = torch.sign(polyval_at(d_poly, mid)) == torch.sign(e_dlo)
        el, eh = torch.where(right, mid, el), torch.where(right, eh, mid)
    e_mid = 0.5 * (el + eh)
    v_mid = polyval_at(n_poly, e_mid)
    split = e_valid & (torch.sign(v_mid) != torch.sign(torch.gather(v, 1, eidx))) & (v_mid != 0)

    lo = torch.cat([d_lo, e_lo, e_mid], -1)
    hi = torch.cat([d_hi, e_mid, e_hi], -1)
    valid_all = torch.cat([direct_valid, split, split], -1)
    vlo = polyval_at(n_poly, lo)
    for _ in range(60 if dtype == torch.float64 else 28):
        mid = 0.5 * (lo + hi)
        right = torch.sign(polyval_at(n_poly, mid)) == torch.sign(vlo)
        lo, hi = torch.where(right, mid, lo), torch.where(right, hi, mid)
    ridx, valid = _first_true(valid_all, 10)
    z = torch.tan(torch.gather(0.5 * (lo + hi), 1, ridx))  # (B, 10)

    def peval(p, z):
        out = torch.zeros_like(z)
        for k in range(p.shape[-1]):
            out = out * z + p[:, k, None]
        return out

    a11, a12, b1 = peval(p1a, z), peval(p2a, z), -peval(p3a, z)
    a21, a22, b2 = peval(p1b, z), peval(p2b, z), -peval(p3b, z)
    a31, a32, b3 = peval(p1c, z), peval(p2c, z), -peval(p3c, z)
    g11 = a11 * a11 + a21 * a21 + a31 * a31
    g12 = a11 * a12 + a21 * a22 + a31 * a32
    g22 = a12 * a12 + a22 * a22 + a32 * a32
    h1 = a11 * b1 + a21 * b2 + a31 * b3
    h2 = a12 * b1 + a22 * b2 + a32 * b3
    det_g = g11 * g22 - g12 * g12
    safe = torch.where(torch.abs(det_g) < 1e-30, 1.0, det_g)
    xs = (g22 * h1 - g12 * h2) / safe
    ys = (g11 * h2 - g12 * h1) / safe
    E = (xs[..., None, None] * EB[:, None, :, :, 0] + ys[..., None, None] * EB[:, None, :, :, 1]
         + z[..., None, None] * EB[:, None, :, :, 2] + EB[:, None, :, :, 3])  # (B, 10, 3, 3)
    # Newton-Schulz projection onto the essential manifold.
    fro = torch.sqrt((E * E).sum((-2, -1), keepdim=True))
    Y = E * (math.sqrt(2.0) / torch.clamp(fro, min=1e-30))
    for _ in range(3 if dtype == torch.float32 else 4):
        Y = 1.5 * Y - 0.5 * (Y @ Y.transpose(-1, -2) @ Y)
    ok = valid & (torch.abs(det_g) >= 1e-30)
    out = torch.where(ok[..., None, None], Y, torch.tensor(float("nan"), dtype=dtype, device=dev))
    return out.reshape(batch + (10, 3, 3))
