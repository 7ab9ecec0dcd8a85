"""Dominant-plane-robust fundamental matrix estimation (DEGENSAC).

Counterpart of colmap_tpu/estimators/degensac.py (reference behavior:
src/colmap/estimators/fundamental_matrix_degensac.{h,cc}; Chum et al.,
"Two-view geometry estimation unaffected by a dominant plane"). As in
colmap_tpu the recovery runs after the batched F RANSAC, as one
plane-and-parallax pass:

  1. if the dominant plane's H explains most F inliers, the F is suspect;
  2. pairs of off-plane correspondences are drawn in bulk, each gives
     F_k = [e'_k]x H from the epipole e'_k at the intersection of its two
     parallax lines, and all hypotheses are scored at once (K46,
     kernels/matching.py ``degensac_propose_score``);
  3. the best one, refitted on its inliers by the weighted 8-point (K11's
     refit entry, the F RANSAC's LO step), replaces F if its support is
     larger; its inlier mask comes from K11's inliers entry.

The host draws the hypotheses' 2 x K uniform numbers; the off-plane pool,
its size and the positions in it stay on the device. One read brings back
the refit's support and the pool's size. The pair-block verification sends
H-degenerate pairs to the per-pair path, as colmap_tpu does.
"""

from __future__ import annotations

from typing import Optional

import torch

from colmap_tpu_torch.estimators.solvers.epipolar import (  # noqa: F401 (this module's API)
    fundamental_from_plane_and_parallax,
)
from colmap_tpu_torch.kernels import matching as KM
from colmap_tpu_torch.optim.ransac import RansacOptions


def off_plane_pool(mask, h_inlier_mask):
    """(rows (N,) int64 with the off-plane rows first, in order; their count,
    a 0-d device tensor)."""
    off_plane = mask & ~h_inlier_mask
    return torch.argsort((~off_plane).to(torch.uint8), stable=True), off_plane.sum()


def degensac_recover_f(generator: torch.Generator, x1, x2, mask, F, f_inlier_mask, H,
                       h_inlier_mask, options: RansacOptions, num_pair_hypotheses: int = 256,
                       num_f_inliers: Optional[int] = None, positions=None):
    """Plane-and-parallax recovery of F given a dominant-plane H.

    x1, x2 (N, 2); mask (N,) valid rows; F, f_inlier_mask the F RANSAC's
    result (``num_f_inliers`` its support, read from the mask when not
    given); H, h_inlier_mask the homography and its inliers; ``generator`` a
    CPU torch.Generator, or ``positions`` (2, K) int64 positions into the
    off-plane pool (the rows of ``off_plane_pool``). Returns (F_best,
    num_inliers, inlier_mask, recovered).
    """
    max_sq = float(options.max_error) ** 2
    rows, n_off = off_plane_pool(mask, h_inlier_mask)
    if positions is None:  # 2 x K uniform numbers, scaled on the device to the pool's size
        u = torch.rand(2, num_pair_hypotheses, generator=generator, dtype=torch.float64)
        pool = torch.clamp(n_off, min=1).to(torch.float64)
        positions = torch.minimum((u.to(x1.device) * pool).to(torch.int64),
                                  (pool - 1).to(torch.int64))
    pair = rows[positions.to(x1.device)].to(torch.int32)
    Fs, _, best = KM.degensac_propose_score(x1, x2, mask, H.contiguous(), pair[0].contiguous(),
                                            pair[1].contiguous(), max_sq)
    idx = 0xFFFFFFFF - (best & 0xFFFFFFFF)
    F_rec, sup_rec = KM.fundamental_refit(x1[None], x2[None], mask[None], Fs[idx], max_sq,
                                          (best >> 32).to(torch.int32))
    h = torch.stack([sup_rec[0].double(), n_off.double()]).cpu()  # the one read
    n_rec, n_off = int(h[0]), int(h[1])
    if num_f_inliers is None:
        num_f_inliers = int((f_inlier_mask & mask).sum())
    recovered = n_off >= 2 and n_rec > num_f_inliers
    F_best = F_rec[0] if recovered else F
    inl = KM.fundamental_inliers(x1, x2, mask, F_best.contiguous(), max_sq)
    return F_best, (n_rec if recovered else num_f_inliers), inl, recovered


def is_h_degenerate(num_f_inliers: int, num_fh_inliers: int, threshold: float = 0.8) -> bool:
    """The F estimate is H-degenerate when the dominant plane explains most
    of its support."""
    return num_fh_inliers >= threshold * max(num_f_inliers, 1)
