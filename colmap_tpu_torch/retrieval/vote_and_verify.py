"""Vote-and-verify spatial re-ranking for retrieval.

A copy of colmap_tpu/retrieval/vote_and_verify.py (host numpy), so that the
port does not import the JAX package.

reference behavior: src/colmap/retrieval/vote_and_verify.{h,cc} — per
candidate image, each feature match votes a 4-DoF similarity transform
(tx, ty, log-scale, angle) into a multi-resolution histogram; the top
bins seed affine transforms that are verified by two-way transfer and
scale errors; the score is the (effectively binned) inlier count. Used
by VisualIndex.query_with_verification.

The per-match transforms, the histogram voting, the inlier tests and the
affine least-squares refit are vectorized numpy over the match set; they run
per candidate image on the host next to the inverted index.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class VoteAndVerifyOptions:
    """reference: retrieval/vote_and_verify.h:37-71."""

    num_levels: int = 3
    num_transformations: int = 10
    num_trans_bins: int = 64
    num_scale_bins: int = 32
    num_angle_bins: int = 8
    max_image_size: int = 4096
    min_num_votes: int = 1
    confidence: float = 0.99
    max_transfer_error: float = 100.0 * 100.0
    max_scale_error: float = 2.0
    local_optimization: bool = True
    eff_inlier_count: bool = True
    num_eff_inlier_bins: int = 32


def _transforms_from_matches(g1: np.ndarray, g2: np.ndarray):
    """Per-match similarity transform (reference:
    FeatureGeometry::TransformFromMatch, retrieval/geometry.cc:35).

    g1, g2: (N, 4) arrays of (x, y, scale, orientation).
    Returns (tx, ty, scale, angle) each (N,).
    """
    scale = g2[:, 2] / np.maximum(g1[:, 2], 1e-12)
    angle = g2[:, 3] - g1[:, 3]
    # Wrap into (-pi, pi].
    angle = np.mod(angle + np.pi, 2.0 * np.pi) - np.pi
    ca, sa = np.cos(angle), np.sin(angle)
    tx = g2[:, 0] - scale * (ca * g1[:, 0] - sa * g1[:, 1])
    ty = g2[:, 1] - scale * (sa * g1[:, 0] + ca * g1[:, 1])
    return tx, ty, scale, angle


def _two_way_errors(A12, t12, g1, g2):
    """Squared forward+backward transfer errors and scale error of an
    affine transform (reference: ComputeTransferError/ComputeScaleError)."""
    A21 = np.linalg.inv(np.vstack([np.hstack([A12, t12[:, None]]), [0, 0, 1]]))
    A21, t21 = A21[:2, :2], A21[:2, 2]
    p1, p2 = g1[:, :2], g2[:, :2]
    fwd = p2 - (p1 @ A12.T + t12)
    bwd = p1 - (p2 @ A21.T + t21)
    err = np.sum(fwd**2, axis=1) + np.sum(bwd**2, axis=1)
    det = abs(float(np.linalg.det(A12)))
    s_t = np.sqrt(max(det, 1e-12))
    s_match = g2[:, 2] / np.maximum(g1[:, 2], 1e-12)
    scale_err = np.maximum(s_match / s_t, s_t / np.maximum(s_match, 1e-12))
    return err, scale_err


def _affine_from_similarity(tx, ty, scale, angle):
    ca, sa = np.cos(angle), np.sin(angle)
    A = scale * np.array([[ca, -sa], [sa, ca]])
    return A, np.array([tx, ty])


def _effective_inlier_count(inlier_xy: np.ndarray, num_bins: int) -> int:
    """Count distinct spatial bins covered by inliers (reference:
    ComputeEffectiveInlierCount — suppresses burst features)."""
    if len(inlier_xy) == 0:
        return 0
    mn = inlier_xy.min(axis=0)
    mx = inlier_xy.max(axis=0)
    span = np.maximum(mx - mn, 1e-12)
    idx = np.minimum(
        ((inlier_xy - mn) / span * num_bins).astype(np.int64), num_bins - 1
    )
    return len(np.unique(idx[:, 0] * num_bins + idx[:, 1]))


def vote_and_verify(
    geometries1: np.ndarray,
    geometries2: np.ndarray,
    options: Optional[VoteAndVerifyOptions] = None,
) -> int:
    """Spatial verification score for a putative match set.

    Args:
        geometries1/2: (N, 4) arrays of (x, y, scale, orientation) of the
            matched features in the query / database image.

    Returns the (effective) inlier count of the best verified transform
    (reference: VoteAndVerify, retrieval/vote_and_verify.cc:217).
    """
    if options is None:
        options = VoteAndVerifyOptions()
    g1 = np.asarray(geometries1, dtype=np.float64)
    g2 = np.asarray(geometries2, dtype=np.float64)
    n = len(g1)
    if n < 3:
        return 0

    tx, ty, scale, angle = _transforms_from_matches(g1, g2)
    max_trans = float(options.max_image_size)
    max_log_scale = np.log2(10.0)
    log_scale = np.log2(np.maximum(scale, 1e-12))
    valid = (
        (np.abs(tx) <= max_trans)
        & (np.abs(ty) <= max_trans)
        & (np.abs(log_scale) <= max_log_scale)
    )
    if valid.sum() < 3:
        return 0

    # Finest-level bin coordinates.
    def bin_of(v, lo, hi, nb):
        x = (v - lo) / (hi - lo)
        return np.minimum((x * nb).astype(np.int64), nb - 1)

    n_x = bin_of(tx, -max_trans, max_trans, options.num_trans_bins)
    n_y = bin_of(ty, -max_trans, max_trans, options.num_trans_bins)
    n_s = bin_of(log_scale, -max_log_scale, max_log_scale, options.num_scale_bins)
    n_a = bin_of(angle, -np.pi, np.pi, options.num_angle_bins)

    # Multi-resolution scores: finest-level vote counts plus coarser
    # levels at geometrically decaying weights.
    def pack(nx, ny, ns, na):
        return na + options.num_angle_bins * (
            ns + options.num_scale_bins * (nx + options.num_trans_bins * ny)
        )

    sel = np.nonzero(valid)[0]
    key0 = pack(n_x[sel], n_y[sel], n_s[sel], n_a[sel])
    uniq0, inv0, counts0 = np.unique(key0, return_inverse=True, return_counts=True)
    scores = counts0.astype(np.float64)
    weight = 0.5
    nx_l, ny_l, ns_l, na_l = n_x[sel], n_y[sel], n_s[sel], n_a[sel]
    for _level in range(1, options.num_levels):
        nx_l, ny_l, ns_l, na_l = nx_l >> 1, ny_l >> 1, ns_l >> 1, na_l >> 1
        key_l = pack(nx_l, ny_l, ns_l, na_l)
        uniq_l, inv_l, counts_l = np.unique(
            key_l, return_inverse=True, return_counts=True
        )
        # Each finest bin inherits its coarse bin's count; attribute via
        # any representative match of the finest bin.
        rep = np.zeros(len(uniq0), dtype=np.int64)
        rep[inv0] = np.arange(len(sel))
        scores += counts_l[inv_l[rep]] * weight
        weight *= 0.5

    keep = counts0 >= options.min_num_votes
    order = np.argsort(-scores[keep])
    cand_bins = np.nonzero(keep)[0][order][: options.num_transformations]

    best_num_inliers = 0
    best_A, best_t = None, None
    max_num_trials = np.inf
    for rank, b in enumerate(cand_bins):
        if rank >= max_num_trials:
            break
        members = sel[inv0 == b]
        A, t = _affine_from_similarity(
            tx[members].mean(), ty[members].mean(),
            scale[members].mean(), angle[members].mean(),
        )
        err, scale_err = _two_way_errors(A, t, g1, g2)
        inl = (err <= options.max_transfer_error) & (
            scale_err <= options.max_scale_error
        )
        ninl = int(inl.sum())
        if ninl <= best_num_inliers or ninl < 3:
            continue
        best_num_inliers = ninl
        best_A, best_t, best_inl = A, t, inl
        if best_num_inliers == n:
            break
        # Adaptive trial bound (reference: RANSAC::ComputeNumTrials).
        ratio = best_num_inliers / n
        denom = np.log(max(1.0 - ratio**3, 1e-30))
        max_num_trials = np.log(max(1.0 - options.confidence, 1e-30)) / denom

    if best_num_inliers == 0:
        return 0

    if options.local_optimization:
        # Least-squares affine refit on the inliers.
        p1 = g1[best_inl, :2]
        p2 = g2[best_inl, :2]
        M = np.hstack([p1, np.ones((len(p1), 1))])
        sol, *_ = np.linalg.lstsq(M, p2, rcond=None)
        A_lo = sol[:2].T
        t_lo = sol[2]
        if np.isfinite(A_lo).all() and abs(np.linalg.det(A_lo)) > 1e-12:
            err, scale_err = _two_way_errors(A_lo, t_lo, g1, g2)
            inl = (err <= options.max_transfer_error) & (
                scale_err <= options.max_scale_error
            )
            if int(inl.sum()) > best_num_inliers:
                best_num_inliers = int(inl.sum())
                best_A, best_t, best_inl = A_lo, t_lo, inl

    if options.eff_inlier_count:
        return _effective_inlier_count(
            g1[best_inl, :2], options.num_eff_inlier_bins
        )
    return best_num_inliers
