"""PatchMatch multi-view stereo (colmap_tpu/mvs/patch_match.py).

reference behavior: src/colmap/mvs/patch_match_cuda.cu — per-reference-image
depth+normal estimation with random initialization, plane hypothesis
propagation, bilaterally-weighted NCC photoconsistency over source views,
pixelwise view selection via message passing (LikelihoodComputer, :700-830),
and an optional geometric-consistency pass (:601). As colmap_tpu does, the
sweep is red-black: all pixels of one colour propagate from the other colour
at once, and the view-selection chain alternates between columns and rows.

Each step is a kernel of kernels/mvs.py on the card (its plain version on
the CPU):

    initial costs                 K17 pm_cost
    view weights before a sweep   K19 pm_view_weights
    the half-iteration            K18 pm_iteration
    selection probabilities       K20 pm_view_selection
    consistency filter            K19, filter mode

The random draws come from a ``torch.Generator`` on the problem's device,
seeded by ``seed``, in colmap_tpu's order: the initial depths and normals,
then for each half-iteration the random depth, random normal, depth factor
and normal noise. Torch's stream is not JAX's: the same seed gives other
numbers than colmap_tpu.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from colmap_tpu_torch.kernels import mvs as K
from colmap_tpu_torch.kernels.mvs import Draws


@dataclasses.dataclass(frozen=True)
class PatchMatchOptions:
    """reference: mvs/patch_match_options.h (options subset)."""

    window_radius: int = 2  # 5x5 window
    window_step: int = 1
    num_iterations: int = 5
    sigma_spatial: float = 3.0
    sigma_color: float = 0.2
    depth_min: float = 0.1
    depth_max: float = 100.0
    ncc_sigma: float = 0.6
    min_triangulation_angle_deg: float = 1.0
    incident_angle_sigma: float = 0.9
    geom_consistency_weight: float = 0.3
    geom_consistency_max_cost: float = 3.0
    filter_min_ncc: float = 0.1
    filter_min_triangulation_angle_deg: float = 3.0
    filter_min_num_consistent: int = 2
    filter_geom_consistency_max_cost: float = 1.0
    # Pixelwise view selection via message passing (reference:
    # LikelihoodComputer; disable to fall back to best-half aggregation).
    view_selection: bool = True


class PatchMatchProblem(NamedTuple):
    """Tensors on one device for one reference image and its source views;
    every view has the reference's size."""

    ref_image: torch.Tensor  # (H, W) grayscale [0, 1]
    src_images: torch.Tensor  # (S, H, W)
    K_ref: torch.Tensor  # (3, 3)
    K_src: torch.Tensor  # (S, 3, 3)
    # Relative transforms: x_src = R x_ref + t.
    R_rel: torch.Tensor  # (S, 3, 3)
    t_rel: torch.Tensor  # (S, 3)
    # Source depth maps from a previous photometric pass; enables the
    # geometric-consistency term. None = photometric-only.
    src_depths: Optional[torch.Tensor] = None  # (S, H, W)


def _check_problem(problem: PatchMatchProblem) -> None:
    H, W = problem.ref_image.shape
    for name in ("src_images", "src_depths"):
        t = getattr(problem, name)
        if t is not None and tuple(t.shape[1:]) != (H, W):
            raise ValueError(f"{name} has shape {tuple(t.shape)}: every view must have the "
                             f"reference's size {H} x {W}")
    devices = {t.device for t in problem if t is not None}
    if len(devices) != 1:
        raise ValueError(f"the problem's tensors lie on several devices: {devices}")


def random_normals(gen, shape, dtype, device):
    """Random unit normals facing the camera (nz < 0)."""
    v = torch.randn(shape + (3,), generator=gen, dtype=dtype, device=device)
    return K.normalize_normals(v)


def _uniform(gen, shape, lo, hi, dtype, device):
    return lo + (hi - lo) * torch.rand(shape, generator=gen, dtype=dtype, device=device)


def draw(gen, shape, options, dtype, device) -> Draws:
    """One half-iteration's draws, in colmap_tpu's order (l.490-503)."""
    return Draws(
        depth=_uniform(gen, shape, options.depth_min, options.depth_max, dtype, device),
        normal=random_normals(gen, shape, dtype, device),
        factor=_uniform(gen, shape, -1.0, 1.0, dtype, device),
        noise=torch.randn(shape + (3,), generator=gen, dtype=dtype, device=device),
    )


def pm_iteration(problem, state, options: PatchMatchOptions, draws: Draws, parity, axis,
                 perturbation, prev_weight):
    """One red-black half-iteration (colmap_tpu's ``_pm_iteration``): the
    view weights from the current planes (K19), the plane update of pixels
    with (y + x) % 2 == parity (K18), then the selection probabilities on
    the updated per-view costs along ``axis`` (0: along H, 1: along W; K20).
    ``state`` is (depth, normal, cost, cost_all, sel_prob)."""
    depth, normal, cost, cost_all, sel_prob = state
    weights = (K.view_weights(problem, depth, normal, sel_prob, options)
               if options.view_selection else None)
    depth, normal, cost, cost_all = K.iteration(problem, depth, normal, cost, cost_all, weights,
                                                draws, parity, perturbation, options)
    if options.view_selection:
        sel_prob = K.update_sel_prob(cost_all, sel_prob, axis, prev_weight, options)
    return depth, normal, cost, cost_all, sel_prob


def patch_match(
    problem: PatchMatchProblem,
    options: Optional[PatchMatchOptions] = None,
    seed: int = 0,
    return_consistency: bool = False,
):
    """Estimate (depth, normal, cost) maps for the reference image, as
    tensors on the problem's device.

    With return_consistency=True additionally applies the reference's
    consistency filter and returns (depth, normal, cost, consistency_mask)
    where consistency_mask is a (S, H, W) bool tensor of per-source-view
    consistent estimates.
    """
    if options is None:
        options = PatchMatchOptions()
    _check_problem(problem)
    H, W = problem.ref_image.shape
    S = problem.src_images.shape[0]
    dtype, dev = problem.ref_image.dtype, problem.ref_image.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    depth = _uniform(gen, (H, W), options.depth_min, options.depth_max, dtype, dev)
    normal = random_normals(gen, (H, W), dtype, dev)
    cost_all = K.costs(problem, depth, normal, options)
    sel_prob = torch.full((S, H, W), 0.5, dtype=dtype, device=dev)
    weights = (K.view_weights(problem, depth, normal, sel_prob, options)
               if options.view_selection else None)
    state = (depth, normal, K.aggregate(cost_all, weights), cost_all, sel_prob)
    total_steps = max(1, 2 * options.num_iterations)
    step = 0
    for it in range(options.num_iterations):
        for parity in (0, 1):
            draws = draw(gen, (H, W), options, dtype, dev)
            # reference schedule (patch_match_cuda.cu:1440-1452): exponential
            # perturbation decay, linear prev-probability ramp, alternating
            # chain direction.
            state = pm_iteration(problem, state, options, draws, parity, step % 2,
                                 1.0 / 2.0 ** (it + parity / 2.0), step / total_steps)
            step += 1
    depth, normal, cost, cost_all, sel_prob = state
    if return_consistency:
        depth_f, normal_f, mask = K.consistency_filter(problem, depth, normal, cost_all,
                                                       sel_prob, options)
        return depth_f, normal_f, cost, mask
    return depth, normal, cost


def filter_depth_map(depth, cost, options: PatchMatchOptions):
    """Photometric filtering: mask out high-cost estimates
    (reference: patch_match_cuda filtering by min_ncc). numpy in, numpy out,
    as colmap_tpu."""
    ncc = 1.0 - np.asarray(cost)
    mask = ncc >= options.filter_min_ncc
    return np.where(mask, depth, 0.0), mask
