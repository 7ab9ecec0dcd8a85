"""Sequential probability ratio test (SPRT) for early model rejection.

Counterpart of colmap_tpu/optim/sprt.py (reference behavior:
src/colmap/optim/sprt.{h,cc}; Matas and Chum, "Randomized RANSAC with
Sequential Probability Ratio Test"): a hypothesis is evaluated row by row,
its log likelihood ratio grows by log(delta / epsilon) on an inlier and
log((1 - delta) / (1 - epsilon)) on an outlier, and it is rejected at the
first row where the ratio exceeds log A, Wald's decision threshold.

``decision_threshold`` runs on the host in float64. ``sprt_evaluate`` is
kernel K47 (kernels/sprt.py): one warp per hypothesis walks its rows in
order in float64 and stops at the rejecting row.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from colmap_tpu_torch.kernels import sprt as KP


@dataclasses.dataclass(frozen=True)
class SPRTOptions:
    """reference: optim/sprt.h SPRT::Options."""

    delta: float = 0.01  # P(inlier | bad model)
    epsilon: float = 0.1  # P(inlier | good model)
    eval_time_ratio: float = 200.0  # t_M: model evaluation / row evaluation time
    num_models_per_sample: float = 1.0  # m_S


def decision_threshold(options: SPRTOptions) -> float:
    """Wald's decision threshold A: the fixed point of A = C t_M / m_S + 1 +
    log A (reference: sprt.cc UpdateDecisionThreshold)."""
    d, e = options.delta, options.epsilon
    C = (1.0 - d) * math.log((1.0 - d) / (1.0 - e)) + d * math.log(d / e)
    K = options.eval_time_ratio * C / options.num_models_per_sample + 1.0
    A = K
    for _ in range(100):
        A_new = K + math.log(A)
        if abs(A_new - A) < 1.5e-8:
            break
        A = A_new
    return A


def sprt_evaluate(residuals_sq: torch.Tensor, mask: torch.Tensor, max_residual_sq,
                  options: SPRTOptions = SPRTOptions()):
    """The SPRT over each hypothesis' residuals.

    Args:
        residuals_sq: (M, N) squared residuals of M hypotheses.
        mask: (N,) bool valid rows (an invalid row leaves the ratio as it is).
        max_residual_sq: the inlier threshold on the squared residual.

    Returns:
        (accepted (M,) bool, num_evaluated (M,) int32): whether each
        hypothesis survives, and the 1-based row at which it was rejected
        (N for survivors).
    """
    d, e = options.delta, options.epsilon
    return KP.sprt(residuals_sq, mask, float(max_residual_sq),
                   math.log(decision_threshold(options)), math.log(d / e),
                   math.log((1.0 - d) / (1.0 - e)))
