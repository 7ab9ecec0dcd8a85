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
gives the same samples on every device. Each batch draws K x m uniform
numbers in [0, 1) once and scales them to the problem's count of valid rows.

``ransac_block`` runs B problems of one model family in lockstep (the pair
blocks of two-view verification; colmap_tpu vmaps its loop over the pair
axis): one launch per batch spans (problem, sample), the host reads the B
packed bests in one copy and keeps each problem's trial count, early exit
and LO round. All problems see the same draws, so a problem's result in a
block equals that problem run alone; ``ransac`` is the block of one.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple, Optional

import numpy as np
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
    """The packed best of ``counts`` (M,) as a (1,) int64 tensor, or of each
    row of (B, M) as (B,) (plain versions; the kernels build it with one
    atomicMax)."""
    idx = torch.arange(counts.shape[-1], device=counts.device, dtype=torch.int64)
    packed = (counts.to(torch.int64) << 32) | (0xFFFFFFFF - idx)
    return packed.amax(-1).reshape(-1)


def _draw(generator, K, m, pool):
    """Sample positions (B, K, m) int64 in [0, pool[b]): one draw of K x m
    uniform numbers, scaled to each problem's count ``pool`` (B,)."""
    u = torch.rand(K, m, generator=generator, dtype=torch.float64)
    pool = torch.as_tensor(pool, dtype=torch.float64)[:, None, None]
    return torch.minimum((u * pool).to(torch.int64), (pool - 1).to(torch.int64))


class BlockRansacResult(NamedTuple):
    model: torch.Tensor  # (B, ...) best model of each problem
    num_inliers: np.ndarray  # (B,) int64
    inlier_mask: torch.Tensor  # (B, N) bool
    num_trials: np.ndarray  # (B,) int64
    success: np.ndarray  # (B,) bool


def ransac_block(
    generator: torch.Generator,
    mask: torch.Tensor,
    min_sample_size: int,
    propose_and_score: Callable,
    inliers: Callable,
    options: RansacOptions,
    local_refine: Optional[Callable] = None,
) -> BlockRansacResult:
    """(LO-)RANSAC on B problems in lockstep; problem b's result equals
    ``ransac`` on problem b alone with a generator in the same state.

    Args:
        generator: CPU torch.Generator; one draw per batch serves all problems.
        mask: (B, N) bool validity of the data rows of each problem.
        min_sample_size: m, rows per minimal sample.
        propose_and_score: (sample_idxs (B, K, m) int32, active (B,) bool),
            both on mask's device -> (models (B, M, ...), counts (B, M),
            packed best (B,) int64); entries of problems that are not active
            are not read.
        inliers: models (B, ...) -> (B, N) bool inlier masks.
        options: RansacOptions.
        local_refine: optional (models (B, ...), counts (B,) int32) ->
            (models, counts), the ``_try_refine`` step on every problem.
    """
    if options.sampling != "uniform":
        raise NotImplementedError("progressive sampling is not ported yet (ROADMAP queue 1)")
    if options.support != "inlier_count":
        raise NotImplementedError("m-estimator support is not ported yet (ROADMAP queue 1)")
    device = mask.device
    mask_h = mask.cpu().numpy()
    B, N = mask_h.shape
    num_valid = mask_h.sum(1)
    # Valid rows first, in order; problems without a valid row sample row 0.
    valid_idx = torch.from_numpy(np.argsort(~mask_h, axis=1, kind="stable"))
    valid_idx[torch.from_numpy(num_valid == 0)] = 0
    pool = np.maximum(num_valid, 1)
    K, m = options.batch_size, min_sample_size

    model = None
    count = np.full(B, -1, dtype=np.int64)
    trials = np.zeros(B, dtype=np.int64)

    def batch(active):
        """One batch for the active problems: keep a better model, count it."""
        nonlocal model
        r = _draw(generator, K, m, pool)  # (B, K, m)
        samples = torch.gather(valid_idx, 1, r.reshape(B, -1)).reshape(B, K, m)
        models, _, best = propose_and_score(samples.to(torch.int32).to(device),
                                            torch.from_numpy(active).to(device))
        packed = best.cpu().numpy()  # the one read of this batch
        new_count, idx = packed >> 32, 0xFFFFFFFF - (packed & 0xFFFFFFFF)
        take = np.flatnonzero(active & (new_count > count))
        if model is None:
            model = torch.zeros((B,) + tuple(models.shape[2:]), dtype=models.dtype, device=device)
        if take.size:
            rows = torch.from_numpy(take).to(device)
            model[rows] = models[rows, torch.from_numpy(idx[take]).to(device)]
            count[take] = new_count[take]
        trials[active] += K

    def refine():
        nonlocal model
        model, counts = local_refine(model, torch.from_numpy(count).to(torch.int32).to(device))
        count[:] = counts.cpu().numpy()

    def stop(b):
        dyn = _dyn_max_trials(int(count[b]), int(num_valid[b]), m, options.confidence,
                              options.dyn_num_trials_multiplier)
        t = int(trials[b])
        return not (t < options.max_num_trials and (t < options.min_num_trials or t < dyn))

    batch(np.ones(B, dtype=bool))
    if local_refine is not None:
        refine()
    done = np.array([stop(b) or num_valid[b] < m for b in range(B)])

    def run_batches(limit):
        while True:
            active = ~done & (trials < limit)
            if not active.any():
                return
            batch(active)
            for b in np.flatnonzero(active):
                done[b] = stop(b)

    if local_refine is None:
        run_batches(math.inf)
    else:
        R = max(1, options.lo_outer_rounds)
        for rnd in range(R):
            run_batches(((rnd + 1) * options.max_num_trials) // R)
            refine()
            for b in np.flatnonzero(~done):
                done[b] = stop(b)

    inlier_mask = inliers(model)
    num_inliers = inlier_mask.sum(1).cpu().numpy().astype(np.int64)
    success = num_inliers >= np.maximum(m, options.min_inlier_ratio * num_valid)
    return BlockRansacResult(model, num_inliers, inlier_mask, trials, success)


def ransac(
    generator: torch.Generator,
    mask: torch.Tensor,
    min_sample_size: int,
    propose_and_score: Callable,
    inliers: Callable,
    options: RansacOptions,
    local_refine: Optional[Callable] = None,
) -> RansacResult:
    """(LO-)RANSAC on one problem: ``ransac_block`` with B = 1.

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
    def propose(idxs, active):
        models, counts, best = propose_and_score(idxs[0])
        return models[None], counts[None], best

    def refine(models, counts):
        model, count = local_refine(models[0], int(counts[0]))
        return model[None], torch.tensor([count], dtype=torch.int32)

    res = ransac_block(generator, mask[None], min_sample_size, propose,
                       lambda models: inliers(models[0])[None], options,
                       refine if local_refine is not None else None)
    return RansacResult(res.model[0], int(res.num_inliers[0]), res.inlier_mask[0],
                        int(res.num_trials[0]), bool(res.success[0]))
