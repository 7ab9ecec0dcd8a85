"""Two-view geometry: the essential-matrix RANSAC of the initial pair.

Counterpart of the part of colmap_tpu/estimators/two_view_geometry.py that
the incremental mapper calls (reference behavior:
src/colmap/estimators/two_view_geometry.{h,cc}): ``TwoViewGeometryOptions``
and ``_ransac_e``, the 5-point LO-RANSAC with a weighted 8-point refit. Its
batches run in the CUDA kernel K7 (kernels/sfm.py) on the card. The batched
F/H/E verification of the matching front end is not ported yet.
"""

from __future__ import annotations

import dataclasses

import torch

from colmap_tpu_torch.kernels import sfm as K
from colmap_tpu_torch.optim.ransac import RansacOptions, RansacResult, ransac


@dataclasses.dataclass
class TwoViewGeometryOptions:
    """reference: estimators/two_view_geometry.h:45-131."""

    min_num_inliers: int = 15
    min_inlier_ratio: float = 0.0
    min_E_F_inlier_ratio: float = 0.95
    max_H_inlier_ratio: float = 0.8
    watermark_min_inlier_ratio: float = 0.7
    watermark_border_size: float = 0.1
    detect_watermark: bool = True
    watermark_detection_max_error: float = 4.0
    force_H_use: bool = False
    compute_relative_pose: bool = False


def _ransac_e(generator: torch.Generator, x1n, x2n, mask, max_error,
              options: RansacOptions) -> RansacResult:
    """Essential-matrix LO-RANSAC on normalized coordinates (N, 2): 5-point
    minimal solver (up to 10 solutions per sample) and weighted 8-point LO
    refit, the reference's LORANSAC<EssentialMatrixFivePointEstimator>
    (estimators/two_view_geometry.cc:569-636). ``max_error`` is compared
    with the square root of the Sampson error."""
    max_sq = float(max_error) ** 2
    return ransac(
        generator, mask, 5,
        lambda idxs: K.essential_propose_score(x1n, x2n, mask, idxs, max_sq),
        lambda model: K.essential_inliers(x1n, x2n, mask, model, max_sq),
        options,
        local_refine=lambda model, count: K.essential_refit(x1n, x2n, mask, model, max_sq,
                                                            count),
    )
