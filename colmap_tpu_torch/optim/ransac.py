"""Hypothesis-batch LO-RANSAC driven from the host.

Counterpart of colmap_tpu/optim/ransac.py (reference behavior:
src/colmap/optim/ransac.h:95-199 and loransac.h:78-130). colmap_tpu runs the
whole loop inside ``lax.while_loop``; here the loop over batches stays on
the host and each batch is one kernel launch that proposes K models, scores
them on all N data rows and picks the best on the card. The host reads one
packed scalar per batch (the best model's support and index) to decide
whether to go on. The semantics are colmap_tpu's:

- batches of K = ``batch_size`` minimal samples drawn uniformly from the
  valid rows (degenerate samples give non-finite models, which score 0);
- the best model by score (inlier count), the first on ties;
- the adaptive trial bound of ``_dyn_max_trials``;
- with a local refit, ``lo_outer_rounds`` rounds that each run batches up to
  the trial watermark ``(round + 1) * max_num_trials // rounds`` and then
  refit once (``_try_refine``: keep the refit if its support is larger);
- success when the final inlier count reaches
  ``max(min_sample_size, min_inlier_ratio * num_valid)``.

Samples come from an explicit CPU ``torch.Generator``, so the same seed
gives the same samples on every device.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple, Optional

import torch


@dataclasses.dataclass(frozen=True)
class RansacOptions:
    """reference: optim/ransac.h:50-77 (same fields and defaults as colmap_tpu)."""

    max_error: float = 4.0
    min_inlier_ratio: float = 0.1
    confidence: float = 0.99
    min_num_trials: int = 32
    max_num_trials: int = 8192
    batch_size: int = 64
    dyn_num_trials_multiplier: float = 3.0
    sampling: str = "uniform"  # "uniform"; "progressive" is not ported yet
    progressive_full_pool_trials: int = 2048
    support: str = "inlier_count"  # "inlier_count"; "m_estimator" is not ported yet
    lo_outer_rounds: int = 8


class RansacResult(NamedTuple):
    model: torch.Tensor  # best model parameters
    num_inliers: int
    inlier_mask: torch.Tensor  # (N,) bool
    num_trials: int
    success: bool


def _dyn_max_trials(num_inliers, num_samples, min_sample_size, confidence, multiplier):
    """Adaptive trial count (optim/ransac.h:179-199)."""
    ratio = num_inliers / max(num_samples, 1)
    nom = math.log(max(1.0 - confidence, 1e-30))
    denom = math.log(max(1.0 - ratio**min_sample_size, 1e-30))
    return multiplier * nom / denom if denom < -1e-12 else math.inf


def unpack_best(packed: int):
    """(support, index) from the packed best of a propose-and-score launch:
    support in the high 32 bits, 0xFFFFFFFF - index in the low 32 bits, so
    that the largest packed value is the first model of largest support."""
    return packed >> 32, 0xFFFFFFFF - (packed & 0xFFFFFFFF)


def pack_best(counts: torch.Tensor) -> torch.Tensor:
    """The packed best of ``counts`` (M,) as a (1,) int64 tensor (plain
    versions; the kernels build it with one atomicMax)."""
    idx = torch.arange(counts.shape[0], device=counts.device, dtype=torch.int64)
    packed = (counts.to(torch.int64) << 32) | (0xFFFFFFFF - idx)
    return packed.amax().reshape(1)


def ransac(
    generator: torch.Generator,
    mask: torch.Tensor,
    min_sample_size: int,
    propose_and_score: Callable,
    inliers: Callable,
    options: RansacOptions,
    local_refine: Optional[Callable] = None,
) -> RansacResult:
    """Run (LO-)RANSAC.

    Args:
        generator: CPU torch.Generator the samples are drawn from.
        mask: (N,) bool validity of the data rows.
        min_sample_size: m, rows per minimal sample.
        propose_and_score: sample_idxs (K, m) int32 on mask's device ->
            (models (M, ...), counts (M,), packed best (1,) int64), the
            models of all samples, their support and the packed best.
        inliers: model -> (N,) bool inlier mask.
        options: RansacOptions.
        local_refine: optional (model, count) -> (model, count), the
            ``_try_refine`` step.
    """
    if options.sampling != "uniform":
        raise NotImplementedError("progressive sampling is not ported yet (ROADMAP queue 1)")
    if options.support != "inlier_count":
        raise NotImplementedError("m-estimator support is not ported yet (ROADMAP queue 1)")
    device = mask.device
    valid_idx = torch.nonzero(mask.cpu()).flatten().to(torch.int32)
    num_valid = int(valid_idx.numel())
    if num_valid == 0:
        valid_idx = torch.zeros(1, dtype=torch.int32)
    K = options.batch_size
    pool = max(num_valid, 1)

    def propose():
        r = torch.randint(0, pool, (K, min_sample_size), generator=generator)
        models, _, best = propose_and_score(valid_idx[r].to(device))
        count, idx = unpack_best(int(best.item()))
        return models[idx], count

    def continue_p(count, trials):
        dyn = _dyn_max_trials(count, num_valid, min_sample_size, options.confidence,
                              options.dyn_num_trials_multiplier)
        return trials < options.max_num_trials and (
            trials < options.min_num_trials or trials < dyn)

    model, count = propose()
    if local_refine is not None:
        model, count = local_refine(model, count)
    trials = K
    done = not continue_p(count, trials) or num_valid < min_sample_size

    def run_batches(limit):
        nonlocal model, count, trials, done
        while not done and trials < limit:
            new_model, new_count = propose()
            if new_count > count:
                model, count = new_model, new_count
            trials += K
            done = not continue_p(count, trials)

    if local_refine is None:
        run_batches(math.inf)
    else:
        R = max(1, options.lo_outer_rounds)
        for rnd in range(R):
            run_batches(((rnd + 1) * options.max_num_trials) // R)
            model, count = local_refine(model, count)
            done = done or not continue_p(count, trials)

    inlier_mask = inliers(model)
    num_inliers = int(inlier_mask.sum())
    success = num_inliers >= max(min_sample_size, options.min_inlier_ratio * num_valid)
    return RansacResult(model, num_inliers, inlier_mask, trials, success)
