"""Dominant-plane-robust fundamental matrix estimation (DEGENSAC).

Counterpart of colmap_tpu/estimators/degensac.py (reference behavior:
src/colmap/estimators/fundamental_matrix_degensac.{h,cc}; Chum et al.,
"Two-view geometry estimation unaffected by a dominant plane"). As in
colmap_tpu the recovery runs after the batched F RANSAC, as one
plane-and-parallax pass:

  1. if the dominant plane's H explains most F inliers, the F is suspect;
  2. pairs of off-plane correspondences are drawn in bulk, each gives
     F_k = [e'_k]x H from the epipole e'_k at the intersection of its two
     parallax lines, and all hypotheses are scored at once;
  3. the best one, refitted on its inliers, replaces F if its support is
     larger.

``use_degensac`` is off by default and the pair-block verification sends
such pairs to the per-pair path, so this runs as torch ops on the device of
its inputs; a kernel for it is still to be written.
"""

from __future__ import annotations

import torch

from colmap_tpu_torch.estimators.solvers.epipolar import _unit_frobenius, fundamental_eight_point
from colmap_tpu_torch.geometry.essential import (
    cross_product_matrix,
    squared_epipolar_line_distance,
)
from colmap_tpu_torch.optim.ransac import RansacOptions


def fundamental_from_plane_and_parallax(H, x1a, x2a, x1b, x2b):
    """F from a homography and two off-plane correspondences: the epipole e'
    is the intersection of the parallax lines l_i = (H x1_i) x x2_i, and
    F = [e']x H. Arguments broadcast; returns (..., 3, 3) of unit Frobenius
    norm."""
    def hom(x):
        return torch.cat([x, torch.ones_like(x[..., :1])], dim=-1)

    p1a, p2a, p1b, p2b = hom(x1a), hom(x2a), hom(x1b), hom(x2b)
    Hx1a = torch.einsum("...ij,...j->...i", H, p1a)
    Hx1b = torch.einsum("...ij,...j->...i", H, p1b)
    la = torch.linalg.cross(Hx1a, p2a)
    lb = torch.linalg.cross(Hx1b, p2b)
    e2 = torch.linalg.cross(la, lb)
    return _unit_frobenius(cross_product_matrix(e2) @ H)


def degensac_recover_f(generator: torch.Generator, x1, x2, mask, F, f_inlier_mask, H,
                       h_inlier_mask, options: RansacOptions, num_pair_hypotheses: int = 256):
    """Plane-and-parallax recovery of F given a dominant-plane H.

    x1, x2 (N, 2); mask (N,) valid rows; F, f_inlier_mask the F RANSAC's
    result; H, h_inlier_mask the homography and its inliers; ``generator``
    a CPU torch.Generator. Returns (F_best, num_inliers, inlier_mask,
    recovered).
    """
    max_sq = options.max_error**2
    off_plane = mask & ~h_inlier_mask
    pool = torch.nonzero(off_plane).flatten()
    n_off = int(pool.numel())
    if n_off < 2:
        inl = (squared_epipolar_line_distance(F, x1, x2) <= max_sq) & mask
        return F, int(inl.sum()), inl, False
    r = torch.randint(0, n_off, (2, num_pair_hypotheses), generator=generator).to(x1.device)
    ia, ib = pool[r[0]], pool[r[1]]
    Fs = fundamental_from_plane_and_parallax(H[None], x1[ia], x2[ia], x1[ib], x2[ib])
    res = squared_epipolar_line_distance(Fs[:, None], x1[None], x2[None])
    inl = (res <= max_sq) & mask[None, :]
    ok = torch.isfinite(Fs.flatten(1)).all(-1) & (ia != ib)
    support = torch.where(ok, inl.sum(-1), 0)
    best = int(torch.argmax(support))
    sup_best = int(support[best])

    F_ref = fundamental_eight_point(x1, x2, inl[best].to(x1.dtype))
    ref_ok = bool(torch.isfinite(F_ref).all())
    sup_ref = int(((squared_epipolar_line_distance(F_ref, x1, x2) <= max_sq) & mask).sum())
    F_rec = F_ref if ref_ok and sup_ref > sup_best else Fs[best]
    sup_rec = max(sup_best, sup_ref if ref_ok else 0)

    recovered = sup_rec > int((f_inlier_mask & mask).sum())
    F_best = F_rec if recovered else F
    inl_b = (squared_epipolar_line_distance(F_best, x1, x2) <= max_sq) & mask
    return F_best, int(inl_b.sum()), inl_b, recovered


def is_h_degenerate(num_f_inliers: int, num_fh_inliers: int, threshold: float = 0.8) -> bool:
    """The F estimate is H-degenerate when the dominant plane explains most
    of its support."""
    return num_fh_inliers >= threshold * max(num_f_inliers, 1)
