"""Batched small-matrix eigendecomposition, SVD and null space.

Counterpart of colmap_tpu/optim/small_linalg.py (the parts the mapper
calls): a fixed-sweep parallel cyclic Jacobi for symmetric n x n (n <= ~16),
a 3x3 SVD built on it, and a Householder-QR null space for wide matrices.
These are the plain versions of what the CUDA kernels K6-K8 do per sample
with ``csrc/small_linalg.cuh``.
"""

from __future__ import annotations

from functools import lru_cache

import torch


@lru_cache(maxsize=None)
def _round_robin(n: int):
    """Tournament pairing: rounds of disjoint (p, q) index pairs covering
    all n*(n-1)/2 pairs (dummy slot for odd n)."""
    m = n + (n % 2)
    arr = list(range(m))
    rounds = []
    for _ in range(m - 1):
        pairs = sorted(
            (min(arr[i], arr[m - 1 - i]), max(arr[i], arr[m - 1 - i]))
            for i in range(m // 2)
            if arr[i] < n and arr[m - 1 - i] < n
        )
        rounds.append(tuple(pairs))
        arr = [arr[0], arr[-1]] + arr[1:-1]
    return tuple(rounds)


def eigh_small(A, sweeps: int | None = None):
    """Symmetric eigendecomposition of (..., n, n), ascending eigenvalues.

    Each round applies the rotations of disjoint (p, q) pairs at once as
    A <- Jᵀ A J. The rotation is the algebraic one of Golub & Van Loan 8.4;
    rotations whose |a_pq| is below 1e-12 |a_qq - a_pp| are skipped.
    Eigenvector signs may differ from LAPACK.
    """
    n = A.shape[-1]
    if sweeps is None:
        sweeps = 9 if A.dtype == torch.float64 else 7
    eye = torch.eye(n, dtype=A.dtype, device=A.device)
    V = eye.expand(A.shape).clone()
    A = 0.5 * (A + A.transpose(-1, -2))
    rounds = [(torch.tensor([p for p, _ in r], device=A.device),
               torch.tensor([q for _, q in r], device=A.device)) for r in _round_robin(n)]
    for _ in range(sweeps):
        for ps, qs in rounds:
            app, aqq, apq = A[..., ps, ps], A[..., qs, qs], A[..., ps, qs]
            diff = aqq - app
            skip = (apq == 0) | (torch.abs(apq) * 1e12 < torch.abs(diff))
            tau = torch.where(skip, 0.0, diff / torch.where(skip, 1.0, 2.0 * apq))
            t = torch.sign(tau) / (torch.abs(tau) + torch.sqrt(1.0 + tau * tau))
            t = torch.where(tau == 0, 1.0, t)
            t = torch.where(skip, 0.0, t)
            c = 1.0 / torch.sqrt(1.0 + t * t)
            s = t * c
            J = eye.expand(A.shape).clone()
            J[..., ps, ps] = c
            J[..., qs, qs] = c
            J[..., ps, qs] = s
            J[..., qs, ps] = -s
            A = J.transpose(-1, -2) @ A @ J
            V = V @ J
        A = 0.5 * (A + A.transpose(-1, -2))
    w = torch.diagonal(A, dim1=-2, dim2=-1)
    w, order = torch.sort(w, dim=-1)
    V = torch.gather(V, -1, order[..., None, :].expand(V.shape))
    return w, V


def svd3x3(E, sweeps: int | None = None):
    """SVD of (..., 3, 3) through eigh_small(EᵀE): (U, S, Vt), S descending,
    the third left vector completed right-handed and aligned with E v2."""
    w, V = eigh_small(E.transpose(-1, -2) @ E, sweeps=sweeps)
    w = w.flip(-1)
    V = V.flip(-1)
    S = torch.sqrt(torch.clamp(w, min=0.0))
    EV = E @ V
    u0 = EV[..., 0] / torch.clamp(S[..., 0, None], min=1e-30)
    u1 = EV[..., 1] / torch.clamp(S[..., 1, None], min=1e-30)
    u1 = u1 - (u0 * u1).sum(-1, keepdim=True) * u0
    u1 = u1 / torch.clamp(torch.linalg.vector_norm(u1, dim=-1, keepdim=True), min=1e-30)
    u2 = torch.linalg.cross(u0, u1)
    sign2 = torch.sign((u2 * EV[..., 2]).sum(-1, keepdim=True))
    u2 = u2 * torch.where(sign2 == 0, 1.0, sign2)
    U = torch.stack([u0, u1, u2], dim=-1)
    return U, S, V.transpose(-1, -2)


def nullspace_small(A, k: int):
    """Orthonormal null-space basis (..., n, k) of A (..., m, n), m < n:
    the last k columns of Q from a Householder QR of Aᵀ (m reflections)."""
    m, n = A.shape[-2], A.shape[-1]
    assert m < n, "nullspace_small expects a wide matrix"
    B = A.transpose(-1, -2).clone()  # (..., n, m)
    refl = []
    for j in range(m):
        x = B[..., j:, j]
        norm = torch.sqrt((x * x).sum(-1))
        alpha = -torch.where(x[..., 0] >= 0, 1.0, -1.0) * norm
        v = x.clone()
        v[..., 0] = v[..., 0] - alpha
        vn = torch.sqrt((v * v).sum(-1, keepdim=True))
        v = v / torch.clamp(vn, min=1e-30)
        scale = torch.where(vn > 1e-30, 2.0, 0.0)
        w = (v[..., :, None] * B[..., j:, :]).sum(-2)
        B[..., j:, :] = B[..., j:, :] - scale[..., None] * v[..., :, None] * w[..., None, :]
        refl.append((j, v, scale))
    Q = torch.eye(n, dtype=A.dtype, device=A.device).expand(A.shape[:-2] + (n, n)).clone()
    for j, v, scale in reversed(refl):
        w = (v[..., :, None] * Q[..., j:, :]).sum(-2)
        Q[..., j:, :] = Q[..., j:, :] - scale[..., None] * v[..., :, None] * w[..., None, :]
    return Q[..., :, m:m + k]
