"""Umeyama similarity transform, weighted, in float64 on the host.

Counterpart of colmap_tpu/estimators/solvers/similarity.py (reference
behavior: src/colmap/estimators/solvers/similarity_transform.*), used by
model alignment, merging and the pose-prior alignment. colmap_tpu runs it as
batched jnp; the port's callers align tens of camera centres, so it is
numpy float64 (as estimators/alignment.py's alignment always was).
"""

from __future__ import annotations

import numpy as np


def umeyama(src, dst, weights=None, with_scale=True):
    """Weighted Umeyama alignment dst ≈ s R src + t of src, dst (..., N, 3).
    Returns (scale (...), R (..., 3, 3), t (..., 3)), float64."""
    src = np.asarray(src, dtype=np.float64)
    dst = np.asarray(dst, dtype=np.float64)
    if weights is None:
        weights = np.ones(src.shape[:-1])
    weights = np.asarray(weights, dtype=np.float64)
    wsum = np.maximum(weights.sum(-1, keepdims=True), 1e-30)
    src_c = (src * weights[..., None]).sum(-2) / wsum
    dst_c = (dst * weights[..., None]).sum(-2) / wsum
    src0 = src - src_c[..., None, :]
    dst0 = dst - dst_c[..., None, :]
    cov = np.einsum("...ni,...nj,...n->...ij", dst0, src0, weights) / wsum[..., None]
    U, S, Vt = np.linalg.svd(cov)
    D = np.ones(cov.shape[:-2] + (3,))
    D[..., 2] = np.sign(np.linalg.det(U) * np.linalg.det(Vt))
    R = U @ (D[..., None] * Vt)
    if with_scale:
        var_src = ((src0 ** 2).sum(-1) * weights).sum(-1) / wsum[..., 0]
        scale = (S * D).sum(-1) / np.maximum(var_src, 1e-30)
    else:
        scale = np.ones(cov.shape[:-2])
    t = dst_c - scale[..., None] * np.einsum("...ij,...j->...i", R, src_c)
    return scale, R, t
