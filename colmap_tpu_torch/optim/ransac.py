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

Options (colmap_tpu optim/ransac.py:119-165):

- ``support="m_estimator"`` (MSAC): a model's score is the sum over valid
  rows of max(max_sq - r, 0), its inlier count rides along for the trial
  bound and the result, and the LO step compares scores. The kernels pack
  the float32 score's bits (a score is >= 0, so its bits order as an
  unsigned int) in the high word of the packed best; the host reads the
  best model's index, count and score in one copy. A NaN residual counts
  as an outlier (colmap_tpu's score turns NaN, see ``score_models``).
- ``sampling="progressive"`` with a ``quality_order``: the valid rows are
  laid out best first and a batch samples from the first ``pool`` of them,
  the pool growing from m to all valid rows over
  ``progressive_full_pool_trials`` trials (``progressive_pool``). Without a
  quality order it samples uniformly, as colmap_tpu does.
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
    sampling: str = "uniform"  # "uniform" | "progressive"
    progressive_full_pool_trials: int = 2048
    support: str = "inlier_count"  # "inlier_count" | "m_estimator"
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


def pack_best_scores(scores: torch.Tensor) -> torch.Tensor:
    """The packed best of MSAC ``scores`` (M,) or (B, M), all >= 0: the
    first index of the largest score, with the float32 bits of that score in
    the high 32 bits (the kernels' packing; the plain versions pick the
    index in their own precision)."""
    idx = torch.argmax(scores, dim=-1, keepdim=True)  # the first of the largest
    top = torch.gather(scores, -1, idx).float().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    return ((top << 32) | (0xFFFFFFFF - idx)).reshape(-1)


def score_models(models, res, mask, max_sq, msac: bool):
    """colmap_tpu's ``_score`` (optim/ransac.py:134-148): (counts (.., M)
    int32, scores (.., M)) of models (.., M, ...) with squared residuals
    res (.., M, N) on valid rows mask (.., N); ``max_sq`` broadcasts against
    res. The score is the count, or with ``msac`` the sum of max(max_sq - r,
    0) over valid rows; a non-finite model scores 0. A NaN residual is an
    outlier here; in colmap_tpu it makes the model's MSAC score NaN, which
    no later model can beat (ROADMAP §3)."""
    inl = (res <= max_sq) & mask[..., None, :]
    finite = torch.isfinite(models.flatten(res.dim() - 1)).all(-1)
    counts = torch.where(finite, inl.sum(-1), 0).to(torch.int32)
    if not msac:
        return counts, counts.to(res.dtype)
    scores = torch.where(inl, max_sq - res, torch.zeros_like(res)).sum(-1)
    return counts, torch.where(finite, scores, torch.zeros_like(scores))


def progressive_pool(trials, num_valid, m: int, full_pool_trials: int) -> np.ndarray:
    """The progressive pool of each problem (B,) for a batch drawn after
    ``trials`` (B,) trials: m + frac (num_valid - m) with frac = min(trials /
    full_pool_trials, 1), in float32 and cut to int32, within [m,
    max(num_valid, 1)] (colmap_tpu optim/ransac.py:121-132)."""
    f32 = np.float32
    frac = np.minimum(np.asarray(trials).astype(f32) / f32(full_pool_trials), f32(1.0))
    nv = np.asarray(num_valid)
    pool = (f32(m) + frac * (nv.astype(f32) - f32(m))).astype(np.int32)
    return np.minimum(np.maximum(pool, m), np.maximum(nv, 1)).astype(np.int64)


def _draw(generator, K, m, pool):
    """Sample positions (B, K, m) int64 in [0, pool[b]): one draw of K x m
    uniform numbers, scaled to each problem's count ``pool`` (B,)."""
    u = torch.rand(K, m, generator=generator, dtype=torch.float64)
    pool = torch.as_tensor(pool, dtype=torch.float64)[:, None, None]
    return torch.minimum((u * pool).to(torch.int64), (pool - 1).to(torch.int64))


def _sample_layout(mask_h, quality_order, progressive):
    """Row of each sample position (B, N) int64: the valid rows first, in
    order, or with progressive sampling best quality first
    (argsort(where(mask, rank, rank + N))); problems without a valid row
    sample row 0."""
    B, N = mask_h.shape
    if progressive:
        qo = np.broadcast_to(np.asarray(quality_order, dtype=np.int64).reshape(-1, N), (B, N))
        rank = np.zeros((B, N), dtype=np.int64)
        np.put_along_axis(rank, qo, np.broadcast_to(np.arange(N), (B, N)), axis=1)
        return torch.from_numpy(np.argsort(np.where(mask_h, rank, rank + N), axis=1,
                                           kind="stable"))
    valid_idx = torch.from_numpy(np.argsort(~mask_h, axis=1, kind="stable"))
    valid_idx[torch.from_numpy(mask_h.sum(1) == 0)] = 0
    return valid_idx


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
    quality_order=None,
) -> BlockRansacResult:
    """(LO-)RANSAC on B problems in lockstep; problem b's result equals
    ``ransac`` on problem b alone with a generator in the same state.

    Args:
        generator: CPU torch.Generator; one draw per batch serves all problems.
        mask: (B, N) bool validity of the data rows of each problem.
        min_sample_size: m, rows per minimal sample.
        propose_and_score: (sample_idxs (B, K, m) int32, active (B,) bool),
            both on mask's device -> (models (B, M, ...), counts (B, M),
            packed best (B,) int64), and with ``support="m_estimator"`` a
            fourth output, scores (B, M); entries of problems that are not
            active are not read.
        inliers: models (B, ...) -> (B, N) bool inlier masks.
        options: RansacOptions.
        local_refine: optional (models (B, ...), counts (B,) int32) ->
            (models, counts), the ``_try_refine`` step on every problem; with
            ``support="m_estimator"`` (models, counts, scores (B,) of the
            models' type) -> (models, counts, scores).
        quality_order: optional (N,) or (B, N) row indices, best quality
            first, for ``sampling="progressive"``.
    """
    if options.sampling not in ("uniform", "progressive"):
        raise ValueError(f"unknown sampling {options.sampling!r}")
    if options.support not in ("inlier_count", "m_estimator"):
        raise ValueError(f"unknown support {options.support!r}")
    msac = options.support == "m_estimator"
    progressive = options.sampling == "progressive" and quality_order is not None
    device = mask.device
    mask_h = mask.cpu().numpy()
    B, N = mask_h.shape
    num_valid = mask_h.sum(1)
    valid_idx = _sample_layout(mask_h, quality_order, progressive)
    K, m = options.batch_size, min_sample_size

    model = None
    count = np.full(B, -1, dtype=np.int64)
    score = np.full(B, -np.inf)
    trials = np.zeros(B, dtype=np.int64)

    def batch(active):
        """One batch for the active problems: keep a better model, count it."""
        nonlocal model
        pool = (progressive_pool(trials, num_valid, m, options.progressive_full_pool_trials)
                if progressive else np.maximum(num_valid, 1))
        r = _draw(generator, K, m, pool)  # (B, K, m)
        samples = torch.gather(valid_idx, 1, r.reshape(B, -1)).reshape(B, K, m)
        out = propose_and_score(samples.to(torch.int32).to(device),
                                torch.from_numpy(active).to(device))
        models, counts, best = out[:3]
        if msac:
            # The best model's index, count and score in the one read of this batch.
            idx = torch.clamp(0xFFFFFFFF - (best & 0xFFFFFFFF), max=counts.shape[-1] - 1)[:, None]
            h = torch.cat([idx.double(), counts.gather(1, idx).double(),
                           out[3].gather(1, idx).double()], 1).cpu().numpy()
            idx, new_count, new_score = h[:, 0].astype(np.int64), h[:, 1].astype(np.int64), h[:, 2]
        else:
            packed = best.cpu().numpy()  # the one read of this batch
            new_count, idx = packed >> 32, 0xFFFFFFFF - (packed & 0xFFFFFFFF)
            new_score = new_count
        take = np.flatnonzero(active & (new_score > score))
        if model is None:
            model = torch.zeros((B,) + tuple(models.shape[2:]), dtype=models.dtype, device=device)
        if take.size:
            rows = torch.from_numpy(take).to(device)
            model[rows] = models[rows, torch.from_numpy(idx[take]).to(device)]
            count[take] = new_count[take]
            score[take] = new_score[take]
        trials[active] += K

    def refine():
        nonlocal model
        count_t = torch.from_numpy(count).to(torch.int32).to(device)
        if msac:
            score_t = torch.from_numpy(score).to(device=device, dtype=model.dtype)
            model, counts, scores = local_refine(model, count_t, score_t)
            h = torch.stack([counts.double(), scores.double()]).cpu().numpy()
            count[:], score[:] = h[0].astype(np.int64), h[1]
        else:
            model, counts = local_refine(model, count_t)
            count[:] = counts.cpu().numpy()
            score[:] = count

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
    quality_order=None,
) -> RansacResult:
    """(LO-)RANSAC on one problem: ``ransac_block`` with B = 1.

    Args:
        generator: CPU torch.Generator the samples are drawn from.
        mask: (N,) bool validity of the data rows.
        min_sample_size: m, rows per minimal sample.
        propose_and_score: sample_idxs (K, m) int32 on mask's device ->
            (models (M, ...), counts (M,), packed best (1,) int64), the
            models of all samples, their support and the packed best, and
            with ``support="m_estimator"`` their scores (M,).
        inliers: model -> (N,) bool inlier mask.
        options: RansacOptions.
        local_refine: optional (model, count) -> (model, count), the
            ``_try_refine`` step; with ``support="m_estimator"`` (model,
            count, score) -> (model, count, score).
        quality_order: optional (N,) row indices, best quality first, for
            ``sampling="progressive"``.
    """
    def propose(idxs, active):
        return tuple(o[None] if i != 2 else o
                     for i, o in enumerate(propose_and_score(idxs[0])))

    def refine(models, counts, *scores):
        h = torch.stack([counts[:1].double(), *(s[:1].double() for s in scores)]).cpu()[:, 0]
        out = local_refine(models[0], int(h[0]), *(float(v) for v in h[1:]))
        return (out[0][None],) + tuple(torch.tensor([v]) for v in out[1:])

    res = ransac_block(generator, mask[None], min_sample_size, propose,
                       lambda models: inliers(models[0])[None], options,
                       refine if local_refine is not None else None, quality_order)
    return RansacResult(res.model[0], int(res.num_inliers[0]), res.inlier_mask[0],
                        int(res.num_trials[0]), bool(res.success[0]))


def ransac_family(generator, kernels, m, x1, x2, mask, max_sq, options: RansacOptions,
                  quality_order=None):
    """``ransac`` on one problem (x1, x2 (N, d)) or ``ransac_block`` on a
    block (B, N, d) over a model family's kernel entries ``kernels`` =
    (propose_score, refit, inliers) (kernels/sfm.py's two-view entries), in
    the support mode of ``options``; ``max_sq`` a float or, for a block, a
    (B,) tensor."""
    propose, refit, inliers = kernels
    msac = options.support == "m_estimator"
    if x1.dim() == 2:
        return ransac(generator, mask, m,
                      lambda idxs: propose(x1, x2, mask, idxs, max_sq, msac=msac),
                      lambda model: inliers(x1, x2, mask, model, max_sq), options,
                      lambda model, *support: refit(x1, x2, mask, model, max_sq, *support),
                      quality_order)
    return ransac_block(generator, mask, m,
                        lambda idxs, active: propose(x1, x2, mask, idxs, max_sq, active,
                                                     msac=msac),
                        lambda models: inliers(x1, x2, mask, models, max_sq), options,
                        lambda models, *support: refit(x1, x2, mask, models, max_sq, *support),
                        quality_order)
