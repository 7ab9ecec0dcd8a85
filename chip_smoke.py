#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (colmap_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases; any failure exits non-zero:
  1. device: require CUDA, print the card's name and power limit;
  2. build: compile the kernels (colmap_tpu_torch/csrc) with nvcc;
  3. kernels: hold every kernel against its plain PyTorch version (run in
     float64 on the same inputs) on the card, on the headline problem
     (200 frames x 50k points x 300k observations, float32, SIMPLE_RADIAL)
     and on small problems over camera models 0-4, robust losses, ragged
     tracks, several cameras, tracks longer than a warp, 800 frames with a
     706-observation track and 4200 frames (the kernels' paths for large
     frame tables and long tracks); time kernel and plain version with CUDA
     events;
  4. headline solve: lm_solve_fused_packed for 10 LM iterations with the
     dense Schur solver ("auto") and with PCG, counting kernel launches, held
     against the colmap_tpu reference cost and against the same solve
     through the plain versions;
  5. CLI: bundle_adjuster on a synthetic 120-frame model on cuda, then
     model_analyzer;
  6. profile: device time by kernel and the device's idle share in a warm
     LM iteration of each solver (torch.profiler);
  7. mapper kernels: K5-K9 (colmap_tpu_torch/kernels/sfm.py) against their
     plain versions (float64, same inputs) at the mapper's shapes, on the
     cases of colmap_tpu_torch/kernels/sfm_cases.py (K6 and K7 on batches of
     injected samples: the same best index and model), timed with CUDA
     events;
  8. features -> model, verify scene: a synthetic 8-frame, 120-point
     database (seed 3) stripped to keypoints and descriptors, then the
     `exhaustive_matcher` and `mapper` commands on cuda, held to the ground
     truth (8/8 frames within 1e-2 deg and 1e-4 units);
  9. features -> model, full-size scene: 40 frames x 1000 points
     (SIMPLE_RADIAL, 1024 x 768, f = 2500, noise-free, seed 3), the same two
     commands, `mapper` run once under torch.profiler: frames, errors
     against the ground truth, wall time, time by phase, launches of every
     kernel, and the device's idle share, all from that run;
 10. matching kernels: K10-K12 (colmap_tpu_torch/kernels/matching.py) against
     their plain versions (float64, same inputs) on the cases of
     colmap_tpu_torch/kernels/matching_cases.py: K10 on 8 pairs of up to
     8192 x 8192 descriptors, plain and guided; K11 and K12 on batches of
     injected samples as K6 and K7; K7, K11 and K12 on a block of 64 pairs
     against their one-pair entries; timed with CUDA events;
 11. matcher at full width: 12 frames x 8182 points that every frame sees
     (about 8192 keypoints an image, 66 pairs), stripped to features, through
     `exhaustive_matcher` on cuda under torch.profiler; every pair's matches
     hold the generator's correspondences and equal the plain version's
     (float64, CPU), and its two-view geometry is CALIBRATED with at least
     99% of them as inliers and no other.
Each path is driven with the launch counts set to 0 just before it and
read just after: the BA paths (phases 4-5) must launch K1-K3 (and K4 with
the dense solver), the matcher K5, K7 and K10-K12, the mapper K1-K3 and
K5-K9 (its BA is PCG, so K4 is not on its path).
Then it prints the kernels line (JSON), the nvidia-smi line and, last,
{"ok": true, "device": {...}}. `--phases ba,sfm,mapper,matching,matcher`
runs a subset while developing; the kernels line needs them all.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

# Published peaks of one H100 SXM (NVIDIA data sheet): HBM3 bytes/s and
# float32 (non-tensor-core) operations/s, for the bound of each kernel.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12

# Final cost of colmap_tpu (JAX, CPU, float32) on the headline problem after
# 10 LM iterations, dense Schur or PCG; and its limit relative to the cost
# at the ground-truth state.
REFERENCE_FINAL_COST = 5.6219e4
MAX_FINAL_OVER_GT = 0.76

# Each kernel (float32) is held against its plain version in float64 on the
# same inputs; errors are relative to the largest entry of each output.
K1_RTOL = 1e-5
# Under huber / cauchy the weight depends on the residual, whose float32
# rounding in the kernel (proj - xy: about 1e-4 px on coordinates of 1e3 px)
# the weight carries into every Jacobian entry of small residuals.
K1_ROBUST_RTOL = 1e-4
K234_RTOL = 1e-4  # float32 sums, in an order the atomics change from run to run
# K5: one float32 projection / 25 float32 Newton steps against float64.
K5_RTOL = 1e-5
# K6, K7: float32 minimal solvers against float64; models are compared where
# the plain one has at least 90% of the best support (all-inlier samples).
K67_RTOL = 1e-3
# K8: float32 Jacobi on the 4x4 normal equations against a float64 SVD.
K8_RTOL = 1e-3
# K9: one float32 projection per observation against float64.
K9_RTOL = 1e-4
# Reference thresholds of the mapper against ground truth (BASELINE.md:13).
MAX_ROT_DEG, MAX_CENTER = 1e-2, 1e-4
# The full-size mapper scene: 40 frames x 1000 points. Its focal length of
# 2500 px (a 23 x 17 degree field of view) makes each frame see about three
# quarters of the points (tracks of 18-40 views): with the generator's
# default 1280 px every frame sees every point, the initial pair
# triangulates them all and the triangulator never creates a track.
FULL_FRAMES, FULL_FOCAL = 40, 2500.0
# K10: float32 similarities against float64; a row's accept decision may
# differ only where one of its arccos tests lies within this margin (rad).
K10_SIM_TOL = 1e-5
K10_MARGIN = 1e-5
# The full-width matcher scene: every frame sees all 8182 points, plus 10
# keypoints without a point: 8192 keypoints an image, 66 pairs.
WIDE_FRAMES, WIDE_POINTS = 12, 8182
MATCH_SOURCES = {
    "match_top2": ("colmap_tpu_torch/csrc/match_top2.cu", "colmap_tpu/feature/matcher.py:53"),
    "fundamental_ransac": ("colmap_tpu_torch/csrc/fundamental_ransac.cu",
                           "colmap_tpu/estimators/two_view_geometry.py:101"),
    "homography_ransac": ("colmap_tpu_torch/csrc/homography_ransac.cu",
                          "colmap_tpu/estimators/two_view_geometry.py:153"),
}
BA_SOURCES = {
    "ba_obs_jacobians": ("colmap_tpu_torch/csrc/ba_jacobians.cu",
                         "colmap_tpu/estimators/bundle_adjustment.py:873"),
    "ba_lm_reduce": ("colmap_tpu_torch/csrc/ba_reduce.cu",
                     "colmap_tpu/estimators/bundle_adjustment.py:1039"),
    "ba_schur_matvec": ("colmap_tpu_torch/csrc/ba_matvec.cu",
                        "colmap_tpu/estimators/bundle_adjustment.py:951"),
    "ba_dense_schur_assemble": ("colmap_tpu_torch/csrc/ba_dense_schur.cu",
                                "colmap_tpu/estimators/bundle_adjustment.py:1490"),
}
SFM_SOURCES = {
    "camera_map": ("colmap_tpu_torch/csrc/camera_map.cu", "colmap_tpu/sensor/models.py:464"),
    "p3p_ransac": ("colmap_tpu_torch/csrc/p3p_ransac.cu", "colmap_tpu/estimators/pose.py:31"),
    "essential_ransac": ("colmap_tpu_torch/csrc/essential_ransac.cu",
                         "colmap_tpu/estimators/two_view_geometry.py:127"),
    "triangulate_tracks": ("colmap_tpu_torch/csrc/triangulate_tracks.cu",
                           "colmap_tpu/estimators/triangulation.py:72"),
    "filter_points": ("colmap_tpu_torch/csrc/filter_points.cu",
                      "colmap_tpu/sfm/filtering.py:24"),
}


SIFT_SOURCES = {
    "sift_pyramid": ("colmap_tpu_torch/csrc/sift_pyramid.cu", "colmap_tpu/feature/sift.py:127"),
    "sift_extrema": ("colmap_tpu_torch/csrc/sift_extrema.cu", "colmap_tpu/feature/sift.py:144"),
    "sift_orientation": ("colmap_tpu_torch/csrc/sift_orientation.cu",
                         "colmap_tpu/feature/sift.py:236"),
    "sift_descriptor": ("colmap_tpu_torch/csrc/sift_descriptor.cu",
                        "colmap_tpu/feature/sift.py:236"),
}
# SIFT at south-building's resolution (BASELINE.json config 1), whole under
# COLMAP's default max_image_size of 3200: octave 0 is 6144 x 4608. The
# rendered scene has 1000 points (about 8000 keypoints a view).
SIFT_W, SIFT_H, SIFT_POINTS = 3072, 2304, 1000
EXTRACT_VIEWS = 4
# K13 float32 stencils against float64, level by level on the same input;
# K14's refinement is a float32 3x3 LU solve: its subpixel offsets (at most
# 1.5) are held absolutely, sigma and the response relatively; K15's theta
# and K16's descriptors (fed K15's theta) against float64 sampling.
K13_RTOL, K14_RTOL, K14_OFFSET_ATOL, K15_RAD, K16_COUNTS = 1e-5, 1e-4, 1e-3, 1e-3, 1
# Flops a gradient sample of K15 and K16 costs: the warped position (4),
# two bilinear samples of central differences (8 level reads, 6 differences
# and halvings, 14 for the weights and sums), the rotation into the patch
# frame (6), sqrt and atan2 (about 25), the Gaussian weight (about 12).
SIFT_SAMPLE_OPS = 70
# Images -> model: 12 frames of the generator's scene (seed 3, PINHOLE
# 1024 x 768, f = 1280) rendered as the CPU anchor scene is, held to
# tests/test_e2e_images.py's bounds.
IMG_FRAMES, IMG_POINTS, IMG_FOCAL, IMG_PATCH_WORLD = 12, 1000, 1280.0, 0.08
IMG_MAX_ROT_DEG, IMG_MAX_CENTER = 2.0, 0.25


def log(msg):
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()
    return out[0]


def rel_err(got, ref):
    """(max |got - ref|, that over max |ref|): the error relative to the tensor's scale."""
    d = (got.double() - ref.double()).abs().max().item()
    s = ref.double().abs().max().item()
    return d, d / max(s, 1e-30)


def time_ms(fn, reps=25):
    """Median GPU time of fn over reps launches, each between two CUDA events.

    A sleep kernel queued first lets the host enqueue all launches ahead of
    the card, so the events time the device work and not the host."""
    fn()
    torch.cuda.synchronize()
    pairs = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
             for _ in range(reps)]
    torch.cuda._sleep(50_000_000)
    for start, end in pairs:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def bound(bytes_moved, ops):
    """(bound_ms, bound_by) from this run's bytes and operations."""
    t_bytes = bytes_moved / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check(name, got, ref, rtol, errs):
    a, r = rel_err(got, ref)
    log(f"  {name}: max_abs_err {a:.3e} rel {r:.3e} (tol {rtol:g})")
    if not r <= rtol:
        raise AssertionError(f"{name}: relative error {r:.3e} > {rtol:g}")
    errs.append((a, r))


def f64(*xs):
    return tuple(x.double() if torch.is_tensor(x) and x.is_floating_point() else x for x in xs)


def compare_kernels(problem, maps, model_id, options, masks, errs, label):
    """K1-K4 against their plain versions on one problem; returns the
    float32 inputs and outputs for timing.

    The reference is the plain version evaluated in float64 on the same
    (float32) inputs, so the error is the kernel's own."""
    from colmap_tpu_torch.estimators import bundle_adjustment as ba
    from colmap_tpu_torch.kernels import ba as K

    log(f"kernels vs plain: {label}")
    om = ba._obs_masks(masks, options)
    p = problem
    args = (p.quat, p.t, p.cam_params, p.points, p.obs_frame, p.obs_cam, p.obs_point,
            p.obs_xy, p.obs_w)
    F, C = problem.quat.shape[0], problem.cam_params.shape[0]
    fpm, cpm = maps.frame_pm, maps.cam_pm
    rest = (om.pose, om.cam, om.point, model_id, options.loss, options.loss_scale)
    out_k = K.obs_jacobians(*args, *rest)
    out_p = K.obs_jacobians_plain(*f64(*args, *rest))
    k1_rtol = K1_RTOL if options.loss == "trivial" else K1_ROBUST_RTOL
    for n, a, b in zip(("r", "Jp", "Jc", "Jx"), out_k, out_p):
        check(f"K1 {n}", a, b, k1_rtol, errs["ba_obs_jacobians"])
    c_k = K.obs_cost(*args, model_id, options.loss, options.loss_scale)
    c_p = K.obs_cost_plain(*f64(*args), model_id, options.loss, options.loss_scale)
    check("K1 cost", c_k, c_p, k1_rtol, errs["ba_obs_jacobians"])

    r, Jp, Jc, Jx = out_k
    lam = 1e-3
    red_k = K.lm_reduce(r, Jp, Jc, Jx, fpm, cpm, F, C, lam)
    red_p = K.lm_reduce_plain(*f64(r, Jp, Jc, Jx), fpm, cpm, F, C, lam)
    for n, a, b in zip(red_k._fields, red_k, red_p):
        check(f"K2 {n}", a, b, K234_RTOL, errs["ba_lm_reduce"])

    g = torch.Generator(device="cuda").manual_seed(0)
    xp = torch.randn(F, 6, device="cuda", generator=g)
    xc = torch.randn(C, Jc.shape[-1], device="cuda", generator=g) * 1e-3
    Hinv, gx = red_k.Hpp_inv, red_k.gx
    mv_k = K.schur_matvec(Jp, Jc, Jx, fpm, cpm, Hinv, xp, xc)
    mv_p = K.schur_matvec_plain(*f64(Jp, Jc, Jx, fpm, cpm, Hinv, xp, xc))
    check("K3 out_p", mv_k[0], mv_p[0], K234_RTOL, errs["ba_schur_matvec"])
    check("K3 out_c", mv_k[1], mv_p[1], K234_RTOL, errs["ba_schur_matvec"])
    dx_k = K.back_substitute(Jp, Jc, Jx, fpm, cpm, Hinv, gx, xp, xc)
    dx_p = K.back_substitute_plain(*f64(Jp, Jc, Jx, fpm, cpm, Hinv, gx, xp, xc))
    check("K3 dx", dx_k, dx_p, K234_RTOL, errs["ba_schur_matvec"])

    lam_diag = torch.cat([lam * red_k.diag_pose.reshape(-1), lam * red_k.diag_cam.reshape(-1)])
    S_k = K.dense_schur_assemble(Jp, Jc, Jx, fpm, cpm, Hinv, lam_diag, F)
    S_p = K.dense_schur_assemble_plain(*f64(Jp, Jc, Jx, fpm, cpm, Hinv, lam_diag), F)
    check("K4 S", S_k, S_p, K234_RTOL, errs["ba_dense_schur_assemble"])
    return dict(args=args, rest=rest, J=out_k, red=red_k, xp=xp, xc=xc, lam=lam,
                lam_diag=lam_diag, F=F, C=C)


def ragged_problem(seed, num_frames, num_points, obs_per_point, num_cams, keep, device):
    """A synthetic problem with dropped observations (padded slots) and
    several cameras."""
    from colmap_tpu_torch.scene.synthetic_ba import synthetic_ba_problem

    problem, gt, model_id = synthetic_ba_problem(num_frames, num_points, obs_per_point,
                                                 seed=seed, device=device)
    rng = np.random.default_rng(seed)
    O = problem.obs_xy.shape[0]
    sel = torch.from_numpy(np.flatnonzero(rng.random(O) < keep)).to(device)
    cams = problem.cam_params.repeat(num_cams, 1)
    cams[:, 0] += torch.arange(num_cams, device=device, dtype=cams.dtype) * 10.0
    obs_cam = torch.from_numpy(rng.integers(0, num_cams, len(sel)).astype(np.int32)).to(device)
    p = problem._replace(
        cam_params=cams, obs_frame=problem.obs_frame[sel], obs_cam=obs_cam,
        obs_point=problem.obs_point[sel], obs_xy=problem.obs_xy[sel], obs_w=problem.obs_w[sel],
    )
    return p, model_id


def long_track_problem(seed, num_frames, num_points, track, device):
    """A synthetic problem whose point 0 is also seen by frames 0..track-1,
    measured at its projection in the initial state plus 0.5 px noise."""
    from colmap_tpu_torch.geometry import rotation as rot
    from colmap_tpu_torch.scene.synthetic_ba import synthetic_ba_problem
    from colmap_tpu_torch.sensor.models import img_from_cam

    p, _, model_id = synthetic_ba_problem(num_frames, num_points, 6, seed=seed, device=device)
    frames = torch.arange(track, device=device)
    Xc = rot.quat_rotate(p.quat[frames], p.points[0].expand(track, 3)) + p.t[frames]
    xy, _ = img_from_cam(model_id, p.cam_params[0], Xc)
    g = torch.Generator(device=device).manual_seed(seed)
    xy = xy + 0.5 * torch.randn(track, 2, device=device, generator=g)
    ids = lambda a, b: torch.cat([a, b.to(torch.int32)])  # noqa: E731
    return p._replace(
        obs_frame=ids(p.obs_frame, frames), obs_cam=ids(p.obs_cam, torch.zeros_like(frames)),
        obs_point=ids(p.obs_point, torch.zeros_like(frames)),
        obs_xy=torch.cat([p.obs_xy, xy]), obs_w=torch.cat([p.obs_w, torch.ones_like(xy[:, 0])]),
    ), model_id


def phase_kernels(headline):
    from colmap_tpu_torch.estimators import bundle_adjustment as ba
    from colmap_tpu_torch.kernels import ba as K
    from colmap_tpu_torch.scene.synthetic_ba import synthetic_ba_problem

    errs = {k: [] for k in K.LAUNCHES}
    options = ba.BAOptions(max_iterations=10, pcg_iterations=20, function_tolerance=0.0)

    def setup(problem, model_id, opts=options):
        masks = ba.fix_gauge_two_frames(ba.default_masks(problem, model_id, opts), 0, 1)
        packed, maps, _ = ba.pack_problem(problem)
        return packed, maps, masks

    for model_id in range(5):
        problem, _, _ = synthetic_ba_problem(20, 2000, 6, model_id=model_id, seed=1,
                                             device="cuda")
        packed, maps, masks = setup(problem, model_id)
        compare_kernels(packed, maps, model_id, options, masks, errs, f"model {model_id}, 20x2000")
    for loss in ("huber", "cauchy"):
        opts = ba.BAOptions(loss=loss, loss_scale=2.0)
        problem, _, model_id = synthetic_ba_problem(20, 2000, 6, seed=2, device="cuda")
        packed, maps, masks = setup(problem, model_id, opts)
        compare_kernels(packed, maps, model_id, opts, masks, errs, f"{loss} loss, 20x2000")
    problem, model_id = ragged_problem(3, 20, 2000, 6, 3, 0.7, "cuda")
    packed, maps, masks = setup(problem, model_id)
    compare_kernels(packed, maps, model_id, options, masks, errs, "ragged tracks, 3 cameras")
    problem, model_id = ragged_problem(4, 24, 300, 40, 2, 0.95, "cuda")
    packed, maps, masks = setup(problem, model_id)
    compare_kernels(packed, maps, model_id, options, masks, errs,
                    f"tracks of up to {maps.frame_pm.shape[1]} slots")
    # 800 frames: K2's frame table exceeds its shared-memory limit, so K2 adds
    # straight into global memory; one track of 706 observations makes K4 tile
    # the point's slots. 4200 frames: the same for K3's matvec table.
    for num_frames, num_points, track in ((800, 2000, 700), (4200, 1000, 0)):
        problem, model_id = long_track_problem(5, num_frames, num_points, track, "cuda")
        packed, maps, masks = setup(problem, model_id)
        ctx = compare_kernels(packed, maps, model_id, options, masks, errs,
                              f"{num_frames} frames, tracks of up to {maps.frame_pm.shape[1]} "
                              "slots")
        (_, Jp, Jc, Jx), red = ctx["J"], ctx["red"]
        ms = time_ms(lambda: K.dense_schur_assemble(Jp, Jc, Jx, maps.frame_pm, maps.cam_pm,
                                                    red.Hpp_inv, ctx["lam_diag"], num_frames),
                     reps=5)
        log(f"  K4 time: {ms:.3f} ms")

    problem, model_id, packed, maps, masks = headline
    ctx = compare_kernels(packed, maps, model_id, options, masks, errs,
                          "headline 200x50000x300000")
    return errs, ctx


def time_kernels(ctx, maps, model_id):
    """ms, plain_ms, bound_ms, bound_by per kernel at the headline shapes."""
    from colmap_tpu_torch.kernels import ba as K

    args, rest, (r, Jp, Jc, Jx), red = ctx["args"], ctx["rest"], ctx["J"], ctx["red"]
    F, C, lam, xp, xc = ctx["F"], ctx["C"], ctx["lam"], ctx["xp"], ctx["xc"]
    fpm, cpm = maps.frame_pm, maps.cam_pm
    O, P, N = r.shape[0], Jc.shape[-1], fpm.shape[0]
    capp = fpm.shape[1]
    D = ctx["lam_diag"].shape[0]
    K_ = 6 + P
    J_bytes = nbytes(r, Jp, Jc, Jx)
    ids = nbytes(fpm, cpm)
    rows = {}

    def row(name, fn, plain, bytes_moved, ops):
        ms = time_ms(fn)
        plain_ms = time_ms(plain, reps=20)
        b_ms, by = bound(bytes_moved, ops)
        rows[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=by)
        log(f"  {name}: {ms:.4f} ms (plain {plain_ms:.3f} ms, bound {b_ms:.4f} ms by {by})")

    log("kernel times at the headline shapes (median of CUDA-event-timed launches):")
    om_bytes = nbytes(*rest[:3])
    row("ba_obs_jacobians",
        lambda: K.obs_jacobians(*args, *rest), lambda: K.obs_jacobians_plain(*args, *rest),
        nbytes(*args) + om_bytes + J_bytes,
        # ~40 ops for the pose/point chain, (4 + 3 + P) x 20 for the dual
        # projection, 2 x (6 + P + 3) x 3 for weighting and masking, per slot.
        O * (40 + (7 + P) * 20 + 6 * (9 + P)))
    row("ba_lm_reduce",
        lambda: K.lm_reduce(r, Jp, Jc, Jx, fpm, cpm, F, C, lam),
        lambda: K.lm_reduce_plain(r, Jp, Jc, Jx, fpm, cpm, F, C, lam),
        J_bytes + ids + nbytes(*red),
        # per slot: Hpp/gx 36, v 12, gp/bp 24, JpT Jp 84, camera 12 P; per point ~60.
        O * (156 + 12 * P) + N * 60)
    row("ba_schur_matvec",
        lambda: K.schur_matvec(Jp, Jc, Jx, fpm, cpm, red.Hpp_inv, xp, xc),
        lambda: K.schur_matvec_plain(Jp, Jc, Jx, fpm, cpm, red.Hpp_inv, xp, xc),
        nbytes(Jp, Jc, Jx, red.Hpp_inv, xp, xc) + ids + nbytes(xp, xc),
        # per slot: u 2(6 + P) x 2 (twice), w 12, v 12, JT z 4(6 + P); per point 18.
        O * (8 * (6 + P) + 24 + 4 * (6 + P)) + N * 18)
    # Per point with n real slots (a non-zero [Jp | Jc] row) and M = nK entries:
    # W = JT Jx (6nK FMAs) and Z = W Hpp^-1 (9nK FMAs); S_corr = Z WT is
    # symmetric, so M(M+1)/2 dot products of 3 (3 FMAs each); the H_cc term
    # on the nK(K+1)/2 entries of the diagonal blocks (2 FMAs each); one add
    # into S per entry of the symmetric half. An FMA is 2 operations.
    n = ((Jp != 0).flatten(1).any(1) | (Jc != 0).flatten(1).any(1)).view(N, capp)
    n = n.sum(1).double()
    M = n * K_
    k4_ops = float((30 * n * K_ + 3 * M * (M + 1) + 2 * n * K_ * (K_ + 1)
                    + M * (M + 1) / 2).sum())
    row("ba_dense_schur_assemble",
        lambda: K.dense_schur_assemble(Jp, Jc, Jx, fpm, cpm, red.Hpp_inv, ctx["lam_diag"], F),
        lambda: K.dense_schur_assemble_plain(Jp, Jc, Jx, fpm, cpm, red.Hpp_inv,
                                             ctx["lam_diag"], F),
        nbytes(Jp, Jc, Jx, red.Hpp_inv, ctx["lam_diag"]) + ids + D * D * 4, k4_ops)
    cost_ms = time_ms(lambda: K.obs_cost(*args, model_id, "trivial", 1.0))
    log(f"  ba_obs_jacobians cost mode: {cost_ms:.4f} ms")
    return rows


def phase_headline_solve(headline, gt_cost, launches):
    from colmap_tpu_torch.estimators import bundle_adjustment as ba
    from colmap_tpu_torch.kernels import ba as K

    problem, model_id, packed, maps, masks = headline
    results = {}
    for solver in ("auto", "pcg"):
        options = ba.BAOptions(max_iterations=10, pcg_iterations=20, function_tolerance=0.0,
                               solver_type=solver)
        torch.cuda.synchronize()
        K.reset_launches()
        t0 = time.perf_counter()
        solved, cost, iters = ba.lm_solve_fused_packed(packed, maps, model_id, options, masks)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = dict(K.LAUNCHES)
        for k, v in counts.items():
            launches[k] += v
        log(f"headline solve ({solver}): final cost {cost:.6e} after {iters} iterations in "
            f"{dt:.3f} s = {iters / dt:.3f} LM iter/s; launches {counts}")
        needed = [k for k in K.LAUNCHES if k != "ba_dense_schur_assemble" or solver == "auto"]
        missing = [k for k in needed if counts[k] == 0]
        if missing:
            raise AssertionError(f"the {solver} solve launched no {missing}")
        if solver == "pcg" and counts["ba_dense_schur_assemble"]:
            raise AssertionError("the pcg solve launched the dense Schur kernel")
        if iters != 10:
            raise AssertionError(f"expected 10 LM iterations, ran {iters}")
        if not abs(cost - REFERENCE_FINAL_COST) <= 0.01 * REFERENCE_FINAL_COST:
            raise AssertionError(f"final cost {cost:.6e} is not within 1% of {REFERENCE_FINAL_COST}")
        if not cost <= MAX_FINAL_OVER_GT * gt_cost:
            raise AssertionError(f"final cost {cost:.6e} > {MAX_FINAL_OVER_GT} x gt {gt_cost:.6e}")
        for x in solved[:4]:
            if not bool(torch.isfinite(x).all()):
                raise AssertionError("non-finite parameters after the solve")
        # The first solve also pays for loading what the path calls the first
        # time (cuSOLVER, cuBLAS); a second one times the steady state.
        t0 = time.perf_counter()
        _, cost_warm, _ = ba.lm_solve_fused_packed(packed, maps, model_id, options, masks)
        torch.cuda.synchronize()
        dt_warm = time.perf_counter() - t0
        log(f"  warm: the same solve again in {dt_warm:.3f} s = {iters / dt_warm:.3f} LM iter/s "
            f"(final cost {cost_warm:.6e})")
        _, cost_plain, iters_plain = ba._lm_loop(packed, maps, model_id, options, masks,
                                                 ba._use_dense(packed, options), True,
                                                 kernels=K.PLAIN)
        rel = abs(cost - cost_plain) / cost_plain
        log(f"  same solve through the plain versions: {cost_plain:.6e} "
            f"({iters_plain} iterations), relative difference {rel:.3e}")
        if not rel <= 1e-3:
            raise AssertionError(f"kernel vs plain solve differ by {rel:.3e} > 1e-3")
        results[solver] = dict(final_cost=cost, iters=iters, iter_per_s=iters / dt,
                               warm_iter_per_s=iters / dt_warm)
    return results


def phase_profile(headline, solves):
    """Where a warm LM iteration's time goes: device time by kernel from
    torch.profiler over 3 iterations per solver, against the warm wall time
    per iteration measured without the profiler; their ratio gives the
    device's busy and idle shares."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from colmap_tpu_torch.estimators import bundle_adjustment as ba

    _, model_id, packed, maps, masks = headline
    iters = 3
    for solver in ("auto", "pcg"):
        options = ba.BAOptions(max_iterations=iters, pcg_iterations=20, function_tolerance=0.0,
                               solver_type=solver)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            ba.lm_solve_fused_packed(packed, maps, model_id, options, masks)
            torch.cuda.synchronize()
        rows = []
        for e in prof.key_averages():
            us = getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0.0))
            if e.device_type == DeviceType.CUDA and us > 0:
                rows.append((us / iters / 1e3, e.count / iters, e.key))
        wall_ms = 1e3 / solves[solver]["warm_iter_per_s"]
        if not rows:
            log(f"profile ({solver}): the profiler recorded no device time; not measured")
            continue
        busy_ms = sum(r[0] for r in rows)
        log(f"profile ({solver}), per LM iteration: device busy {busy_ms:.3f} ms of "
            f"{wall_ms:.3f} ms warm wall time, idle share {1 - busy_ms / wall_ms:.3f}")
        for ms, n, key in sorted(rows, reverse=True)[:10]:
            log(f"    {ms:9.4f} ms  {n:6.1f} launches  {key[:90]}")


def synthetic_reconstruction(num_frames, num_points, seed):
    """A Reconstruction built with the port's modules from a synthetic BA
    problem: one SIMPLE_RADIAL camera, one rig/frame/image per frame, the
    noisy initial state as the model and the measurements as 2D points."""
    from colmap_tpu_torch.scene.reconstruction import Reconstruction
    from colmap_tpu_torch.scene.synthetic_ba import synthetic_ba_problem
    from colmap_tpu_torch.scene.types import Camera, Frame, Image, Pose, Rig, TrackElement
    from colmap_tpu_torch.utils.types import SensorType

    problem, _, model_id = synthetic_ba_problem(num_frames, num_points, 6, seed=seed,
                                                dtype=torch.float64, device="cpu")
    p = {k: v.numpy() for k, v in problem._asdict().items()}
    recon = Reconstruction()
    recon.add_camera(Camera(camera_id=1, model_id=model_id, width=1024, height=768,
                            params=p["cam_params"][0].copy()))
    ok = p["obs_w"] > 0
    per_frame = [np.flatnonzero(ok & (p["obs_frame"] == f)) for f in range(num_frames)]
    for f in range(num_frames):
        iid = f + 1
        recon.add_rig(Rig(rig_id=iid, ref_sensor_id=(int(SensorType.CAMERA), 1)))
        recon.add_frame(Frame(frame_id=iid, rig_id=iid,
                              rig_from_world=Pose(p["quat"][f].copy(), p["t"][f].copy()),
                              data_ids=[(int(SensorType.CAMERA), 1, iid)]))
        image = Image(image_id=iid, name=f"image{iid:04d}.png", camera_id=1, frame_id=iid)
        image.set_points2D(p["obs_xy"][per_frame[f]])
        recon.add_image(image)
        recon.register_frame(iid)
    tracks = {}
    for f in range(num_frames):
        for idx, o in enumerate(per_frame[f]):
            tracks.setdefault(int(p["obs_point"][o]), []).append(TrackElement(f + 1, idx))
    for pt in sorted(tracks):
        if len(tracks[pt]) >= 2:
            recon.add_point3D(p["points"][pt], tracks[pt])
    return recon


def model_cost(path):
    from colmap_tpu_torch.estimators import bundle_adjustment as ba
    from colmap_tpu_torch.estimators.ba_setup import problem_from_reconstruction
    from colmap_tpu_torch.scene.reconstruction_io import read_model

    problem, index = problem_from_reconstruction(read_model(path), device="cuda")
    return float(ba.compute_cost(problem, index["model_id"], ba.BAOptions()))


def phase_cli(launches):
    from colmap_tpu_torch.cli import main as cli
    from colmap_tpu_torch.kernels import ba as K
    from colmap_tpu_torch.scene.reconstruction_io import write_model

    with tempfile.TemporaryDirectory() as tmp:
        src, dst = os.path.join(tmp, "in"), os.path.join(tmp, "out")
        recon = synthetic_reconstruction(120, 6000, seed=5)
        write_model(recon, src)
        log(f"CLI: model with {recon.num_reg_frames()} frames, {recon.num_points3D()} points, "
            f"{recon.compute_num_observations()} observations")
        torch.cuda.synchronize()
        K.reset_launches()
        t0 = time.perf_counter()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            cli.main(["bundle_adjuster", "--input_path", src, "--output_path", dst,
                      "--device", "cuda"])
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = dict(K.LAUNCHES)
        for k, v in counts.items():
            launches[k] += v
        log(buf.getvalue().strip() + f"  ({dt:.2f} s; launches {counts})")
        missing = [k for k in ("ba_obs_jacobians", "ba_lm_reduce", "ba_schur_matvec")
                   if counts[k] == 0]
        if missing:
            raise AssertionError(f"bundle_adjuster launched no {missing}")
        c0, c1 = model_cost(src), model_cost(dst)
        log(f"  cost of the model read back: {c0:.6e} -> {c1:.6e}")
        if not (math.isfinite(c1) and c1 < c0):
            raise AssertionError("bundle_adjuster did not lower the cost")
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            cli.main(["model_analyzer", "--path", dst])
        log("  model_analyzer: " + "; ".join(buf.getvalue().strip().splitlines()))
        if f"Registered frames: {recon.num_reg_frames()}" not in buf.getvalue():
            raise AssertionError("model_analyzer does not list every frame")


def phase_sfm_kernels():
    """K5-K9 against their plain versions (float64 on the same inputs), then
    their times at the mapper's shapes. Returns (errs, rows, agree): agree
    holds K6's and K7's (agreeing, near-best) model counts."""
    from colmap_tpu_torch.kernels import sfm as K
    from colmap_tpu_torch.geometry.essential import sampson_error
    from colmap_tpu_torch.kernels import sfm_cases as C
    from colmap_tpu_torch.optim.ransac import unpack_best
    from colmap_tpu_torch.sensor import models as M

    errs = {k: [] for k in K.LAUNCHES}
    rows, agree = {}, {}

    def row(name, fn, plain, bytes_moved, ops):
        ms = time_ms(fn)
        plain_ms = time_ms(plain, reps=10)
        b_ms, by = bound(bytes_moved, ops)
        rows[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=by)
        log(f"  {name}: {ms:.4f} ms (plain {plain_ms:.3f} ms, bound {b_ms:.5f} ms by {by})")

    def same(name, a, b):
        n_diff = int((a != b).sum())
        log(f"  {name}: {n_diff} of {a.numel()} differ")
        if n_diff:
            raise AssertionError(f"{name}: kernel and plain version disagree on {n_diff}")

    def same_mask(name, a, b, res, max_sq):
        """Inlier masks that agree except on rows within 2% of the threshold."""
        diff = a != b
        border = (res - max_sq).abs() <= 0.02 * max_sq
        log(f"  {name}: {int(diff.sum())} of {a.numel()} differ, {int((diff & border).sum())} "
            "of them borderline")
        if bool((diff & ~border).any()):
            raise AssertionError(f"{name}: kernel and plain version disagree off the threshold")

    log("mapper kernels vs plain (float64 on the same inputs):")
    # K5 on models 0-4 with distortion, shared and per-row parameters.
    n = 1010  # one image's keypoints in the full-size scene
    for mid in range(5):
        p, uvw, xy = C.camera_map_case(mid, n, mid, "cuda")
        xy_k, ok_k = K.img_from_cam(mid, p, uvw)
        xy_p, ok_p = M.img_from_cam(mid, p.double(), uvw.double())
        check(f"K5 project model {mid}", xy_k, xy_p, K5_RTOL, errs["camera_map"])
        same(f"K5 project valid model {mid}", ok_k, ok_p)
        uv_k, _ = K.cam_from_img(mid, p, xy)
        uv_p, _ = M.cam_from_img(mid, p.double(), xy.double())
        check(f"K5 unproject model {mid}", uv_k, uv_p, K5_RTOL, errs["camera_map"])
        uv_rows, _ = K.cam_from_img(mid, p.expand(n, -1).contiguous(), xy)
        check(f"K5 unproject per-row params model {mid}", uv_rows, uv_p, K5_RTOL,
              errs["camera_map"])

    # K6: 1000 2D-3D rows with 30% outliers, a batch of 64 injected samples.
    c = C.p3p_case(1000, 64, 0, "cuda")
    d = C.as_double(c)
    args_k = (c["X"], c["rays"], c["uv"], c["mask"], c["samples"], c["max_sq"])
    mk, ck, bk = K.p3p_propose_score(*args_k)
    mp, cp, bp = K.p3p_propose_score_plain(d["X"], d["rays"], d["uv"], d["mask"], d["samples"],
                                           d["max_sq"])
    agree["p3p_ransac"] = _check_ransac_batch(
        "K6", mk, ck, bk, mp, cp, bp, 1000, 64, errs["p3p_ransac"], unpack_best,
        lambda m: torch.where(d["mask"], K.p3p_residuals(m, d["X"], d["uv"]), torch.inf),
        d["max_sq"])
    best = unpack_best(int(bp.item()))[1]
    model = mp[best].float()
    same_mask("K6 inlier mask", K.p3p_inliers(c["X"], c["uv"], c["mask"], model, c["max_sq"]),
              K.p3p_inliers_plain(d["X"], d["uv"], d["mask"], model.double(), d["max_sq"]),
              K.p3p_residuals(model.double()[None], d["X"], d["uv"])[0], d["max_sq"])
    # Refit from a perturbed pose so that the refit has work to do.
    start = model.clone()
    start[:, 3] += 0.03
    start_count = int(K.p3p_inliers_plain(d["X"], d["uv"], d["mask"], start.double(),
                                          d["max_sq"]).sum())
    rk, nk = K.p3p_refit(c["X"], c["uv"], c["mask"], start, c["max_sq"], start_count)
    rp, np_ = K.p3p_refit_plain(d["X"], d["uv"], d["mask"], start.double(), d["max_sq"],
                                start_count)
    log(f"  K6 refit: support {start_count} -> kernel {nk}, plain {np_}")
    if nk != np_:
        raise AssertionError(f"K6 refit support: kernel {nk}, plain {np_}")
    check("K6 refit model", rk, rp, K67_RTOL, errs["p3p_ransac"])
    N = 1000
    row("p3p_ransac", lambda: K.p3p_propose_score(*args_k),
        lambda: K.p3p_propose_score_plain(*args_k),
        nbytes(c["X"], c["rays"], c["uv"], c["mask"], c["samples"], mk, ck, bk),
        # per sample: quartic ~300 flops, 4 poses (3x3 Jacobi + Kabsch) ~1500
        # each; per model and row: the residual, ~20 flops.
        64 * (300 + 4 * 1500) + 64 * 4 * N * 20)

    # K7: 1000 matches with 30% outliers, a batch of 128 injected samples.
    c = C.essential_case(1000, 128, 0, "cuda")
    d = C.as_double(c)
    args_k = (c["x1"], c["x2"], c["mask"], c["samples"], c["max_sq"])
    mk, ck, bk = K.essential_propose_score(*args_k)
    mp, cp, bp = K.essential_propose_score_plain(d["x1"], d["x2"], d["mask"], d["samples"],
                                                 d["max_sq"])
    agree["essential_ransac"] = _check_ransac_batch(
        "K7", mk, ck, bk, mp, cp, bp, 1000, 128, errs["essential_ransac"], unpack_best,
        lambda m: torch.where(d["mask"], sampson_error(m[:, None], d["x1"][None], d["x2"][None]),
                              torch.inf),
        d["max_sq"], sign_free=True)
    best = unpack_best(int(bp.item()))[1]
    model = mp[best].float()
    same_mask("K7 inlier mask",
              K.essential_inliers(c["x1"], c["x2"], c["mask"], model, c["max_sq"]),
              K.essential_inliers_plain(d["x1"], d["x2"], d["mask"], model.double(), d["max_sq"]),
              sampson_error(model.double(), d["x1"], d["x2"]), d["max_sq"])
    start = model + 0.003
    start_count = int(K.essential_inliers_plain(d["x1"], d["x2"], d["mask"], start.double(),
                                                d["max_sq"]).sum())
    rk, nk = K.essential_refit(c["x1"], c["x2"], c["mask"], start, c["max_sq"], start_count)
    rp, np_ = K.essential_refit_plain(d["x1"], d["x2"], d["mask"], start.double(), d["max_sq"],
                                      start_count)
    log(f"  K7 refit: support {start_count} -> kernel {nk}, plain {np_}")
    if nk != np_:
        raise AssertionError(f"K7 refit support: kernel {nk}, plain {np_}")
    sgn = torch.sign((rk.double() * rp).sum())
    check("K7 refit model", rk * sgn, rp, K67_RTOL, errs["essential_ransac"])
    row("essential_ransac", lambda: K.essential_propose_score(*args_k),
        lambda: K.essential_propose_score_plain(*args_k),
        nbytes(c["x1"], c["x2"], c["mask"], c["samples"], mk, ck, bk),
        # per sample: null space and elimination ~6e3 flops, the grid 2050
        # evaluations of ~25 flops, the bisections (9 x 24 + 28 x 28)
        # evaluations of ~60 flops with sin and cos, 10 models ~300; per model
        # and row: the Sampson error, ~25 flops.
        128 * (6000 + 2050 * 25 + 1000 * 60 + 3000) + 128 * 10 * N * 25)

    # K8: 1000 tracks with outlier views and two-view tracks.
    c = C.tracks_case(1000, 0, "cuda")
    d = C.as_double(c)
    args_k = (c["R"], c["t"], c["x"], c["mask"], c["min_angle"], c["max_err"])
    xk, ik, sk = K.triangulate_tracks(*args_k)
    xp, ip, sp = K.triangulate_tracks_plain(d["R"], d["t"], d["x"], d["mask"], d["min_angle"],
                                            d["max_err"])
    same("K8 success", sk, sp)
    same("K8 inlier mask", ik[sp], ip[sp])
    check("K8 xyz", xk[sp], xp[sp], K8_RTOL, errs["triangulate_tracks"])
    # Without RANSAC (the triangulator's robust_creation=False): the N-view
    # point of every track over its valid views.
    check("K8 N-view xyz", K.triangulate_multi_view_tracks(*args_k[:4]),
          K.triangulate_multi_view_tracks_plain(d["R"], d["t"], d["x"], d["mask"]), K8_RTOL,
          errs["triangulate_tracks"])
    row("triangulate_tracks", lambda: K.triangulate_tracks(*args_k),
        lambda: K.triangulate_tracks_plain(*args_k),
        nbytes(c["R"], c["t"], c["x"], c["mask"], xk, ik, sk),
        # per track: 28 pairs x (4x4 normal equations ~130, Jacobi ~2400,
        # 8 angular errors ~30 each) and the refit ~3000 flops.
        1000 * (28 * (130 + 2400 + 8 * 30) + 3000))

    # K9: 1000 points of 2-32 views, outliers and negative depths.
    c = C.filter_case(1000, 0, "cuda")
    d = C.as_double(c)
    keys = ("quat", "t", "cam_params", "xyz", "obs_xy", "valid")
    ek, dk, mck = K.filter_points(2, *(c[k] for k in keys))
    ep, dp, mcp = K.filter_points_plain(2, *(d[k] for k in keys))
    fin = torch.isfinite(ep)
    same("K9 infinite errors", torch.isfinite(ek), fin)
    check("K9 errors", ek[fin], ep[fin], K9_RTOL, errs["filter_points"])
    check("K9 depths", dk, dp, K9_RTOL, errs["filter_points"])
    check("K9 min |cos|", mck, mcp, K9_RTOL, errs["filter_points"])
    row("filter_points", lambda: K.filter_points(2, *(c[k] for k in keys)),
        lambda: K.filter_points_plain(2, *(c[k] for k in keys)),
        nbytes(*(c[k] for k in keys), ek, dk, mck),
        # per slot: rotation ~30, projection ~20, error ~6, center and ray
        # ~40, 32 cosines ~6 flops each.
        1000 * 32 * (30 + 20 + 6 + 40 + 32 * 6))

    # K5 at the mapper's shape: one image's keypoints through the Newton
    # undistortion (SIMPLE_RADIAL), the main use.
    p, uvw, xy = C.camera_map_case(2, n, 2, "cuda")
    out = K.cam_from_img(2, p, xy)
    row("camera_map", lambda: K.cam_from_img(2, p, xy), lambda: M.cam_from_img(2, p, xy),
        nbytes(p, xy, *out),
        # 25 Newton steps of ~60 flops (distortion on Dual<2>, 2x2 solve,
        # trust region) per point.
        n * 25 * 60)
    proj_ms = time_ms(lambda: K.img_from_cam(2, p, uvw))
    log(f"  camera_map project mode: {proj_ms:.4f} ms")
    return errs, rows, agree


def _check_ransac_batch(tag, mk, ck, bk, mp, cp, bp, n, n_samples, errs, unpack_best, residuals,
                        max_sq, sign_free=False, exact_best=True):
    """One propose-and-score batch of injected samples, kernel (float32)
    against plain (float64); returns (agreeing, near-best) model counts.

    - the same best: support and index, and the best model to K67_RTOL.
      With ``exact_best`` False (K11, K12 on 8192 rows of pixel coordinates,
      where all-inlier samples of a noise-free scene tie up to the few
      outliers at the threshold, which float32 rounding moves), the two
      bests may differ by n // 1000 rows of support, and the kernel's best
      model is held against the plain model of the same slot;
    - the kernel's support of each of its own models equals the float64
      count for that model (``residuals`` gives inf on invalid rows), up to
      the rows whose residual lies within 2% of the threshold (float32
      rounding can move those across it);
    - of the plain models with at least 90% of the best support, at least
      80% have a kernel solution of the same sample that agrees to K67_RTOL
      and whose support is within 1% of the rows: float32 rounding moves the
      solution of an ill-conditioned sample (close points) further. The
      largest error over all of them, agreeing or not, goes into ``errs``.
    """
    (sk, ik), (sp, ip) = unpack_best(int(bk.item())), unpack_best(int(bp.item()))
    log(f"  {tag} best: kernel support {sk} at {ik}, plain support {sp} at {ip}")
    if (sk, ik) != (sp, ip) and (exact_best or abs(sk - sp) > n // 1000):
        raise AssertionError(f"{tag}: best support {sk} at {ik} vs plain {sp} at {ip}")
    best_k = mk[ik].double()
    if sign_free:  # E and -E are the same model
        best_k = best_k * torch.sign((best_k * mp[ik]).sum())
    check(f"{tag} best model", best_k, mp[ik], K67_RTOL, errs)
    fin = torch.isfinite(mk.flatten(1)).all(1)
    res = residuals(mk[fin].double())
    counts = (res <= max_sq).sum(-1)
    borderline = ((res - max_sq).abs() <= 0.02 * max_sq).sum(-1)
    diff = (ck[fin] - counts).abs()
    log(f"  {tag}: {int(fin.sum())} finite kernel models; support against a float64 count of "
        f"the same models differs on {int((diff > 0).sum())} by at most {int(diff.max())} "
        f"(borderline rows: at most {int(borderline.max())})")
    if bool((diff > borderline).any()) or bool((ck[~fin] != 0).any()):
        raise AssertionError(f"{tag}: kernel support differs from the float64 count")

    def closest(i):
        """(absolute error, relative error, support) of the kernel solution
        of plain model i's sample that is closest to it (solvers may order
        the roots of a sample differently)."""
        per = mp.shape[0] // n_samples
        lo = (i // per) * per
        b = mp[i].double()
        cand = mk[lo:lo + per].double()
        if sign_free:  # E and -E are the same model
            cand = cand * torch.sign((cand * b).flatten(1).sum(1))[:, None, None]
        a = torch.nan_to_num((cand - b).abs().flatten(1).amax(1), nan=math.inf)
        j = int(torch.argmin(a))
        return float(a[j]), float(a[j] / b.abs().max()), int(ck[lo + j])

    near_best = torch.nonzero(cp >= 0.9 * sp).flatten().tolist()
    pairs = [(closest(i), int(cp[i])) for i in near_best]
    agree = [r for (_, r, s_k), s_p in pairs if r <= K67_RTOL and abs(s_k - s_p) <= n // 100]
    errs_m = sorted(r for (_, r, _), _ in pairs)
    errs.append((max(a for (a, _, _), _ in pairs), errs_m[-1]))
    log(f"  {tag}: {len(pairs)} plain models with >= 90% of the best support; {len(agree)} "
        f"agree with a kernel solution of their sample to {K67_RTOL:g} with a support within "
        f"{n // 100} rows (median error {errs_m[len(errs_m) // 2]:.3e}, largest "
        f"{errs_m[-1]:.3e})")
    if len(agree) < 0.8 * len(pairs):
        raise AssertionError(f"{tag}: near-best models disagree")
    log(f"  {tag}: {int((~fin).sum())} kernel / "
        f"{int((~torch.isfinite(mp.flatten(1)).all(1)).sum())} plain models non-finite")
    return len(agree), len(pairs)


def make_scene(root, num_frames, num_points, focal=1280.0, seed=3):
    """A synthetic database and its ground truth (one SIMPLE_RADIAL camera,
    1024 x 768, prior focal length, exhaustive noise-free matches), written
    with the port's generator."""
    from colmap_tpu_torch.scene.database import Database
    from colmap_tpu_torch.scene.synthetic import SyntheticDatasetOptions, synthesize_dataset

    db_path = os.path.join(root, "db.db")
    db = Database(db_path)
    gt = synthesize_dataset(
        SyntheticDatasetOptions(num_rigs=1, num_cameras_per_rig=1, num_frames_per_rig=num_frames,
                                num_points3D=num_points, camera_params=(focal, 512.0, 384.0, 0.05),
                                camera_has_prior_focal_length=True),
        db, rng=np.random.default_rng(seed))
    db.close()
    return db_path, gt


def all_launch_counts():
    from colmap_tpu_torch.kernels import ba as KB
    from colmap_tpu_torch.kernels import matching as KM
    from colmap_tpu_torch.kernels import sfm as K
    from colmap_tpu_torch.kernels import sift as KS

    return {**KB.LAUNCHES, **K.LAUNCHES, **KM.LAUNCHES, **KS.LAUNCHES}


def reset_all_launches():
    from colmap_tpu_torch.kernels import ba as KB
    from colmap_tpu_torch.kernels import matching as KM
    from colmap_tpu_torch.kernels import sfm as K
    from colmap_tpu_torch.kernels import sift as KS

    for mod in (KB, K, KM, KS):
        mod.reset_launches()


def strip_to_features(db_path):
    """Remove the generator's matches and two-view geometries from the
    database, leaving cameras, rigs, frames, images, keypoints and
    descriptors; returns the removed matches {(id1, id2): (K, 2)}."""
    from colmap_tpu_torch.scene.database import Database
    from colmap_tpu_torch.utils.types import pair_id_to_image_pair

    db = Database(db_path, must_exist=True)
    kept = {pair_id_to_image_pair(pid): m for pid, m in db.read_all_matches()}
    db.conn.execute("DELETE FROM matches")
    db.conn.execute("DELETE FROM two_view_geometries")
    db.commit()
    db.close()
    return kept


MATCHER_KERNELS = ("camera_map", "essential_ransac", "match_top2", "fundamental_ransac",
                   "homography_ransac")


def run_matcher(db_path, label):
    """`exhaustive_matcher` through the CLI on cuda with every launch count
    at 0 before; returns (verified pairs, seconds, launches)."""
    from colmap_tpu_torch.cli import main as cli

    torch.cuda.synchronize()
    reset_all_launches()
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        verified = cli.main(["exhaustive_matcher", "--database_path", db_path, "--device", "cuda"])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = all_launch_counts()
    log(f"{label}: {buf.getvalue().strip()} ({dt:.3f} s)")
    log(f"  launches: { {k: counts[k] for k in MATCHER_KERNELS} }")
    missing = [k for k in MATCHER_KERNELS if counts[k] == 0]
    if missing:
        raise AssertionError(f"{label}: the matcher launched no {missing}")
    return verified, dt, counts


def device_busy(prof):
    """(busy ms, {kernel name: (ms, launches)}) of a profiled run: the union
    of the device intervals, read from the raw event list (key_averages()
    over millions of events takes longer than the run itself)."""
    from torch.autograd import DeviceType

    spans, by_name = [], {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA and e.duration_ns() > 0:
            spans.append((e.start_ns(), e.start_ns() + e.duration_ns()))
            ms, cnt = by_name.get(e.name(), (0.0, 0))
            by_name[e.name()] = (ms + e.duration_ns() / 1e6, cnt + 1)
    if not spans:
        return None, by_name
    spans.sort()
    busy_ns, end = 0, spans[0][0]
    for a, b in spans:
        busy_ns += max(0, b - max(a, end))
        end = max(end, b)
    return busy_ns / 1e6, by_name


def log_busy(label, busy_ms, by_name, wall_ms, top=15):
    if busy_ms is None:
        log(f"  {label}: the profiler recorded no device time; idle share not measured")
        return None
    idle = 1 - busy_ms / wall_ms
    log(f"  {label}, under the profiler: device busy {busy_ms:.1f} ms of {wall_ms:.1f} ms wall, "
        f"idle share {idle:.4f}")
    for name, (ms, cnt) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]:
        log(f"    {ms:10.3f} ms  {cnt:7d} launches  {name[:90]}")
    return idle


def run_mapper(db_path, out, label, min_launches=True):
    """`mapper` through the CLI on cuda with every launch count at 0 before;
    returns (pipeline, seconds, launches, stdout)."""
    from colmap_tpu_torch.cli import main as cli

    torch.cuda.synchronize()
    reset_all_launches()
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        pipeline = cli.main(["mapper", "--database_path", db_path, "--output_path", out,
                             "--device", "cuda", "--quiet"])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = all_launch_counts()
    log(f"{label}: {buf.getvalue().strip()} ({dt:.3f} s)")
    log(f"  launches: {counts}")
    needed = [k for k in counts if k != "ba_dense_schur_assemble" and k not in MATCH_SOURCES
              and k not in SIFT_SOURCES]
    missing = [k for k in needed if counts[k] == 0]
    if min_launches and missing:
        raise AssertionError(f"{label}: the mapper launched no {missing}")
    return pipeline, dt, counts


def check_against_gt(out, gt, num_frames, label):
    from colmap_tpu_torch.estimators.alignment import compare_reconstructions
    from colmap_tpu_torch.scene.reconstruction_io import read_model

    recon = read_model(os.path.join(out, "0"))
    cmp = compare_reconstructions(recon, gt)
    n, rot_err, ctr = cmp["num_common_images"], cmp["max_rotation_error_deg"], cmp["max_center_error"]
    log(f"  {label}: {recon.num_reg_frames()}/{num_frames} frames registered, "
        f"{recon.num_points3D()} points; against ground truth: {n} common frames, max rotation "
        f"error {rot_err:.3e} deg, max center error {ctr:.3e}")
    if not (n == num_frames and rot_err <= MAX_ROT_DEG and ctr <= MAX_CENTER):
        raise AssertionError(f"{label}: {n}/{num_frames} frames, {rot_err} deg, {ctr}: outside "
                             f"{MAX_ROT_DEG} deg / {MAX_CENTER}")
    return cmp


def phase_mapper(launches):
    """The verify scene and the full-size scene from features only:
    `exhaustive_matcher`, then `mapper`, both on cuda.

    The full-size scene's mapper runs once, under torch.profiler (device
    activity only): its launches, time by phase, wall time and device busy
    time all come from that one run, and the idle share is 1 - busy / wall
    of it."""
    from torch.profiler import ProfilerActivity, profile

    results = {}
    with tempfile.TemporaryDirectory() as tmp:
        # The verify scene's initial pair triangulates every point (all are
        # seen by all 8 frames), so K8 has no track to create there; the
        # full-size scene is the path every kernel must run on.
        for label, frames, points, focal, full in (
                ("mapper, verify scene", 8, 120, 1280.0, False),
                ("mapper, full-size scene", FULL_FRAMES, 1000, FULL_FOCAL, True)):
            root = os.path.join(tmp, f"{frames}x{points}")
            os.makedirs(root)
            db_path, gt = make_scene(root, frames, points, focal)
            pairs = strip_to_features(db_path)
            verified, _, m_counts = run_matcher(db_path, label.replace("mapper", "matcher"))
            expected = sum(len(m) >= 15 for m in pairs.values())
            if verified != expected:
                raise AssertionError(f"{label}: verified {verified} of {expected} pairs")
            for k, v in m_counts.items():
                launches[k] += v
            out = os.path.join(root, "sparse")
            ctx = profile(activities=[ProfilerActivity.CUDA]) if full else contextlib.nullcontext()
            with ctx as prof:
                pipeline, dt, counts = run_mapper(db_path, out, label, min_launches=full)
            if full:
                profiled, wall_ms = prof, dt * 1e3
            for k, v in counts.items():
                launches[k] += v
            cmp = check_against_gt(out, gt, frames, label)
            phases = {k: (pipeline.timer.seconds[k], pipeline.timer.calls[k])
                      for k in sorted(pipeline.timer.seconds, key=pipeline.timer.seconds.get,
                                      reverse=True)}
            log("  time by phase (s, calls): " + ", ".join(
                f"{k} {v[0]:.3f}/{v[1]}" for k, v in phases.items()))
            results[label] = dict(seconds=dt, phases=phases, launches=counts,
                                  max_rot_deg=cmp["max_rotation_error_deg"],
                                  max_center=cmp["max_center_error"])
        busy_ms, by_name = device_busy(profiled)
        idle = log_busy("full-size scene on the card", busy_ms, by_name, wall_ms)
        if idle is not None:
            results["idle_share"] = idle
    return results


def phase_matching_kernels():
    """K10-K12 against their plain versions (float64 on the same inputs),
    the pair axis of K7, K11 and K12 against their one-pair entries, and
    their times at the matcher's shapes. Returns (errs, rows, agree)."""
    from colmap_tpu_torch.estimators.solvers.epipolar import homography_transfer_error
    from colmap_tpu_torch.feature.matcher import MatchingOptions
    from colmap_tpu_torch.geometry.essential import squared_epipolar_line_distance
    from colmap_tpu_torch.kernels import matching as KM
    from colmap_tpu_torch.kernels import matching_cases as C
    from colmap_tpu_torch.kernels import sfm as K
    from colmap_tpu_torch.optim.ransac import unpack_best

    errs = {k: [] for k in KM.LAUNCHES}
    rows, agree = {}, {}
    log("matching kernels vs plain (float64 on the same inputs):")

    # K10: 8 pairs of 5 images of up to 8192 descriptors, plain and guided.
    c = C.descriptor_case(5, 8192, 0, "cuda")
    pairs = c["pairs"][:8].contiguous()
    opts = MatchingOptions()
    for label, extra in (("plain", {}), ("guided", dict(keypoints=c["keypoints"], F=c["F"][:8]))):
        idx_k, ok_k, best_k = KM.match_top2(c["desc"], c["counts"], pairs, opts, details=True,
                                            **extra)
        torch.cuda.synchronize()
        idx_p, ok_p, margin, best_p = KM.match_top2_plain(
            c["desc"], c["counts"], pairs, opts, dtype=torch.float64, details=True, **{
                k: (v.double() if k == "F" else v) for k, v in extra.items()})
        both = ok_k & ok_p
        wrong_idx = int((idx_k[both] != idx_p[both]).sum())
        clear = margin > K10_MARGIN
        wrong_ok = int((ok_k[clear] != ok_p[clear]).sum())
        fin = torch.isfinite(best_p)
        fin &= torch.arange(fin.shape[1], device="cuda")[None] < c["counts"][pairs[:, 0].long()][:, None]
        check(f"K10 {label} best similarity", best_k[fin], best_p[fin], K10_SIM_TOL,
              errs["match_top2"])
        log(f"  K10 {label}: {int(ok_p.sum())} matches of {int(fin.sum())} rows with a candidate; "
            f"idx2 differs on {wrong_idx} accepted rows, ok differs on {wrong_ok} rows outside "
            f"the {K10_MARGIN:g} rad margin, {int((~clear).sum())} rows inside it "
            f"({int((ok_k != ok_p).sum())} of them differ)")
        if wrong_idx or wrong_ok:
            raise AssertionError(f"K10 {label}: kernel and plain version disagree")
        if not (bool((ok_p.sum(1) > 1000).all()) and bool((~ok_p & fin).sum() > 1000)):
            raise AssertionError(f"K10 {label}: the case does not exercise accept and reject")

    def library():
        out = []
        for a, b in pairs.tolist():
            n1 = KM.normalize_descriptors(c["desc"][a])
            n2 = KM.normalize_descriptors(c["desc"][b])
            sim = torch.matmul(n1, n2.T)
            out.append((sim.max(dim=1), sim.argmax(dim=0)))
        return out

    n1 = c["counts"][pairs[:, 0].long()].double()
    n2 = c["counts"][pairs[:, 1].long()].double()
    ms = time_ms(lambda: KM.match_top2(c["desc"], c["counts"], pairs, opts), reps=5)
    plain_ms = time_ms(lambda: KM.match_top2_plain(c["desc"], c["counts"], pairs, opts), reps=3)
    library_ms = time_ms(library, reps=3)
    b_ms, by = bound(float((n1 + n2).sum()) * 128 + 2 * 5 * float(n1.sum()),
                     float((2 * n1 * n2 * 128).sum()))
    rows["match_top2"] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=by,
                              library_ms=library_ms)
    log(f"  match_top2, 8 pairs: {ms:.3f} ms (plain {plain_ms:.3f} ms, torch.matmul + max + "
        f"argmax {library_ms:.3f} ms, bound {b_ms:.4f} ms by {by})")

    # K11, K12: 8192 matches with 30% outliers, a batch of 128 injected samples.
    N, KS = 8192, 128
    for tag, kind, name, residual, (propose, refit, inliers), (propose_p, refit_p, inliers_p) in (
            ("K11", "F", "fundamental_ransac", squared_epipolar_line_distance,
             (KM.fundamental_propose_score, KM.fundamental_refit, KM.fundamental_inliers),
             (KM.fundamental_propose_score_plain, KM.fundamental_refit_plain,
              KM.fundamental_inliers_plain)),
            ("K12", "H", "homography_ransac", homography_transfer_error,
             (KM.homography_propose_score, KM.homography_refit, KM.homography_inliers),
             (KM.homography_propose_score_plain, KM.homography_refit_plain,
              KM.homography_inliers_plain))):
        c = C.two_view_case(kind, N, KS, 0, "cuda")
        d = C.as_double(c)
        args = (c["x1"], c["x2"], c["mask"], c["samples"], c["max_sq"])
        mk, ck, bk = propose(*args)
        mp, cp, bp = propose_p(d["x1"], d["x2"], d["mask"], d["samples"], d["max_sq"])
        agree[name] = _check_ransac_batch(
            tag, mk, ck, bk, mp, cp, bp, N, KS, errs[name], unpack_best,
            lambda m: torch.where(d["mask"], residual(m[:, None], d["x1"][None], d["x2"][None]),
                                  torch.inf),
            d["max_sq"], sign_free=True, exact_best=False)
        model = mp[unpack_best(int(bp.item()))[1]].float()
        got = inliers(c["x1"], c["x2"], c["mask"], model, c["max_sq"])
        ref = inliers_p(d["x1"], d["x2"], d["mask"], model.double(), d["max_sq"])
        res = residual(model.double(), d["x1"], d["x2"])
        border = (res - d["max_sq"]).abs() <= 0.02 * d["max_sq"]
        log(f"  {tag} inlier mask: {int((got != ref).sum())} of {N} differ, "
            f"{int(((got != ref) & border).sum())} of them borderline")
        if bool(((got != ref) & ~border).any()):
            raise AssertionError(f"{tag} inlier mask: kernel and plain version disagree")
        # Refit from a model that keeps part of the best support, so that the
        # refit has work to do: for F the model whose support is nearest to
        # half the best (a sample with an outlier in it), for H the best with
        # a shear of 1% (an error that grows to 8 px across the image).
        half = unpack_best(int(bp.item()))[0] // 2
        start = mp[int(torch.argmin((cp - half).abs()))].float()
        if kind == "H":
            start = model.clone()
            start[0, 1] += 0.01 * model[0, 0]
        start_count = int(inliers_p(d["x1"], d["x2"], d["mask"], start.double(), d["max_sq"]).sum())
        rk, nk = refit(c["x1"], c["x2"], c["mask"], start, c["max_sq"], start_count)
        rp, np_ = refit_p(d["x1"], d["x2"], d["mask"], start.double(), d["max_sq"], start_count)
        log(f"  {tag} refit: support {start_count} -> kernel {nk}, plain {np_}")
        if abs(nk - np_) > N // 1000:  # float32 rounding moves rows at the threshold
            raise AssertionError(f"{tag} refit support: kernel {nk}, plain {np_}")
        check(f"{tag} refit model", rk * torch.sign((rk.double() * rp).sum()), rp, K67_RTOL,
              errs[name])
    c = C.two_view_case("F", N, KS, 0, "cuda", outliers=0.0)
    d = C.as_double(c)
    fit_k = KM.fundamental_fit(c["x1"], c["x2"], c["mask"])
    fit_p = KM.fundamental_fit_plain(d["x1"], d["x2"], d["mask"])
    check("K11 fit only", fit_k * torch.sign((fit_k.double() * fit_p).sum()), fit_p, K67_RTOL,
          errs["fundamental_ransac"])

    # The pair axis: a block of 64 pairs gives each pair what its one-pair entry gives.
    B, NB = 64, 2048
    for tag, kind, (propose, refit, inliers) in (
            ("K7", "E", (K.essential_propose_score, K.essential_refit, K.essential_inliers)),
            ("K11", "F", (KM.fundamental_propose_score, KM.fundamental_refit,
                          KM.fundamental_inliers)),
            ("K12", "H", (KM.homography_propose_score, KM.homography_refit,
                          KM.homography_inliers))):
        c = C.two_view_block_case(kind, B, NB, 32, 1, "cuda")
        sq = c["max_sq"]
        active = torch.ones(B, dtype=torch.bool, device="cuda")
        active[5] = False
        mb, cb, bb = propose(c["x1"], c["x2"], c["mask"], c["samples"], sq, active)
        if int(bb[5]) != 0:
            raise AssertionError(f"{tag}: a pair that is not active was scored")
        idx = torch.tensor([unpack_best(int(v))[1] for v in bb.tolist()], device="cuda")
        idx[5] = 0
        best_models = torch.nan_to_num(mb[torch.arange(B, device="cuda"), idx])
        counts = torch.tensor([unpack_best(int(v))[0] for v in bb.tolist()], dtype=torch.int32,
                              device="cuda")
        rb, nb = refit(c["x1"], c["x2"], c["mask"], best_models, sq, counts)
        ib = inliers(c["x1"], c["x2"], c["mask"], rb, sq)
        bad = 0
        for b in range(B):
            s1 = float(sq[b]) if torch.is_tensor(sq) else sq
            one = (c["x1"][b], c["x2"][b], c["mask"][b])
            r1, n1_ = refit(*one, best_models[b], s1, int(counts[b]))
            same = torch.equal(r1, rb[b]) and n1_ == int(nb[b])
            same &= torch.equal(inliers(*one, rb[b], s1), ib[b])
            if b != 5:
                m1, c1, b1 = propose(*one, c["samples"][b], s1)
                same &= int(b1) == int(bb[b]) and torch.equal(c1, cb[b])
                same &= torch.equal(torch.nan_to_num(m1), torch.nan_to_num(mb[b]))
            bad += not same
        log(f"  {tag} pair axis: {B - bad} of {B} pairs of a block equal their one-pair entries "
            f"(supports {int(nb.min())}-{int(nb.max())} of {NB})")
        if bad:
            raise AssertionError(f"{tag}: {bad} pairs of a block differ from the one-pair entry")

    # Times at the verification's block shape: 64 pairs x 8192 matches x 128 samples.
    for name, kind, propose, propose_p, m, sols, solve_flops in (
            ("fundamental_ransac", "F", KM.fundamental_propose_score,
             KM.fundamental_propose_score_plain, 7, 3, 4000),
            ("homography_ransac", "H", KM.homography_propose_score,
             KM.homography_propose_score_plain, 4, 1, 4000)):
        c = C.two_view_block_case(kind, B, N, KS, 2, "cuda")
        args = (c["x1"], c["x2"], c["mask"], c["samples"], c["max_sq"])
        out = propose(*args)
        valid = float(c["mask"].sum())
        row_ms = time_ms(lambda: propose(*args), reps=10)
        plain_ms = time_ms(lambda: propose_p(*args), reps=3)
        # per sample the solve on lane 0; per model and valid row a residual, ~20 flops.
        b_ms, by = bound(nbytes(*args[:4], *out), B * KS * solve_flops + KS * sols * valid * 20)
        rows[name] = dict(ms=row_ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=by,
                          library_ms=None)
        log(f"  {name}, block of {B} pairs x {N} rows x {KS} samples: {row_ms:.4f} ms (plain "
            f"{plain_ms:.3f} ms, bound {b_ms:.5f} ms by {by})")
    return errs, rows, agree


def phase_matcher_full(launches):
    """The full-width matcher scene through `exhaustive_matcher` on cuda,
    under torch.profiler, every pair held to the generator's
    correspondences and to the plain version (float64, CPU)."""
    from torch.profiler import ProfilerActivity, profile

    from colmap_tpu_torch.feature.matcher import MatchingOptions
    from colmap_tpu_torch.kernels import matching as KM
    from colmap_tpu_torch.scene.database import Database
    from colmap_tpu_torch.scene.types import TwoViewGeometryConfig

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        db_path, _ = make_scene(tmp, WIDE_FRAMES, WIDE_POINTS)
        truth = strip_to_features(db_path)
        log(f"matcher at full width: {WIDE_FRAMES} frames x {WIDE_POINTS} points, "
            f"{len(truth)} pairs (set-up {time.perf_counter() - t0:.1f} s)")
        # The profiler can drop the events of a run's first milliseconds, which
        # here hold K10's launch: such a profile is no measurement, so the
        # command runs again on a fresh copy of the database.
        for attempt in range(3):
            run_path = os.path.join(tmp, f"run{attempt}.db")
            shutil.copy(db_path, run_path)
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                torch.zeros(1, device="cuda").add_(1.0)  # let the tracer see a first kernel
                torch.cuda.synchronize()
                verified, dt, counts = run_matcher(run_path, "exhaustive_matcher, full width")
            busy_ms, by_name = device_busy(prof)
            if busy_ms is None or any("match_top2_kernel" in name for name in by_name):
                break
            log("  the profile lacks the matcher's kernel; running the command again")
        db_path = run_path
        for k, v in counts.items():
            launches[k] += v
        idle = log_busy("exhaustive_matcher, full width", busy_ms, by_name, dt * 1e3, top=8)
        log(f"  {len(truth)} pairs in {dt:.3f} s = {len(truth) / dt:.3f} pairs/s on "
            f"{nvidia_smi_line()}; launches { {k: counts[k] for k in MATCHER_KERNELS} }; "
            f"idle share {'not measured' if idle is None else f'{idle:.4f}'}")
        db = Database(db_path, must_exist=True)
        desc = {iid: torch.from_numpy(db.read_descriptors(iid)) for iid, _, _ in db.read_images()}
        t0 = time.perf_counter()
        worst = 1.0
        for (a, b), gen in sorted(truth.items()):
            got = {tuple(r) for r in db.read_matches(a, b).tolist()}
            gen = {tuple(r) for r in gen.tolist()}
            na, nb = len(desc[a]), len(desc[b])
            idx2, ok, _, _ = KM.match_similarity_plain(
                desc[a], desc[b], torch.ones(na, dtype=torch.bool),
                torch.ones(nb, dtype=torch.bool), MatchingOptions(), dtype=torch.float64)
            rows = torch.nonzero(ok).flatten()
            plain = set(zip(rows.tolist(), idx2[rows].tolist()))
            g = db.read_two_view_geometry(a, b)
            inl = set() if g is None else {tuple(r) for r in g.inlier_matches.tolist()}
            if not (gen <= got and got == plain):
                raise AssertionError(f"pair ({a}, {b}): {len(got)} matches written, {len(plain)} "
                                     f"by the plain version, {len(gen - got)} of the "
                                     f"generator's {len(gen)} missing")
            if not (g is not None and g.config == int(TwoViewGeometryConfig.CALIBRATED)
                    and inl <= gen and len(inl) >= 0.99 * len(gen)):
                raise AssertionError(f"pair ({a}, {b}): config {g and g.config}, {len(inl)} "
                                     f"inliers of {len(gen)}, {len(inl - gen)} not among them")
            worst = min(worst, len(inl) / len(gen))
        db.close()
        log(f"  all {len(truth)} pairs: the written matches hold the generator's and equal the "
            f"plain version's (float64, CPU, {time.perf_counter() - t0:.1f} s); CALIBRATED with "
            f"at least {worst:.4f} of them as inliers and no other")
        if verified != len(truth):
            raise AssertionError(f"verified {verified} of {len(truth)} pairs")



# ---------------------------------------------------------------------------
# SIFT: K13-K16 against their plain versions, and the extractor.
# ---------------------------------------------------------------------------


def orientation_margin(hist, n_ori):
    """(K,) smallest gap, relative to the largest bin, of a decision of the
    orientation peaks that can change the output: a bin within 1e-4 of the
    0.8 threshold or above it against the threshold and against its two
    neighbours (the local-maximum test), and the n_ori-th peak against the
    next one. Rows with a gap under 1e-4 may differ between float32 and
    float64."""
    m = hist.max(dim=1, keepdim=True).values
    cand = hist >= (0.8 - 1e-4) * m
    big = torch.full_like(hist, torch.inf)
    gaps = [torch.where(cand, g, big) for g in
            ((hist - 0.8 * m).abs(), (hist - torch.roll(hist, 1, 1)).abs(),
             (hist - torch.roll(hist, -1, 1)).abs())]
    is_local = (hist >= torch.roll(hist, 1, 1)) & (hist >= torch.roll(hist, -1, 1))
    peaks = torch.where(is_local & (hist >= 0.8 * m), hist, torch.zeros_like(hist))
    top = torch.sort(peaks, dim=1, descending=True).values[:, :n_ori + 1]
    order_gap = torch.where(top[:, :-1] > 0, top[:, :-1] - top[:, 1:], torch.inf)
    margin = torch.cat([g.min(dim=1, keepdim=True).values for g in gaps]
                       + [order_gap.min(dim=1, keepdim=True).values], 1)
    return margin.min(dim=1).values / m[:, 0]


def refine_margin(ext, options, W, H):
    """(N,) True where a keep decision of K14's refinement lies near its
    threshold: the refined |response| within 1e-4 (relative) of
    peak_threshold, or x or y within 1e-3 px of the bounds. A keep flag that
    differs anywhere else, the edge-ratio and determinant tests included,
    fails the check."""
    x, y, resp = ext.rows[:, 0].double(), ext.rows[:, 1].double(), ext.rows[:, 4].double()
    pt = options.peak_threshold
    near = (resp.abs() - pt).abs() <= 1e-4 * pt
    for v, hi in ((x, W - 1), (y, H - 1)):
        near |= ((v - 1).abs() <= 1e-3) | ((v - hi).abs() <= 1e-3)
    return near


def sampled_level_bytes(shape, x, y, lvl, frames):
    """Bytes of the distinct float32 level pixels that K15's or K16's
    samples read: the four bilinear corners of each row's 16 x 16 samples
    (with bilinear_lvl's clamps) and the neighbours their central
    differences read (none on the border rows and columns, where the
    gradient is 0), merged over rows where windows overlap. ``frames``
    (N, 2, 2) is each row's warp: sigma I for K15, sigma R(theta) for
    K16."""
    from colmap_tpu_torch.kernels import sift as KS

    L, H, W = shape
    _, pu, pv = KS._window(torch.float64, x.device)
    corner = torch.zeros((L, H, W), dtype=torch.bool, device=x.device)
    for i in range(0, len(x), 4096):
        Wm = frames[i:i + 4096].double()
        xx = x[i:i + 4096, None].double() + Wm[:, 0, 0, None] * pv + Wm[:, 0, 1, None] * pu
        yy = y[i:i + 4096, None].double() + Wm[:, 1, 0, None] * pv + Wm[:, 1, 1, None] * pu
        y0 = torch.clamp(torch.floor(yy).long(), 0, H - 2)
        x0 = torch.clamp(torch.floor(xx).long(), 0, W - 2)
        lv = lvl[i:i + 4096, None].long().expand_as(y0)
        for dy in (0, 1):
            for dx in (0, 1):
                corner[lv, y0 + dy, x0 + dx] = True
    read = torch.zeros_like(corner)
    read[:, :, :-2] |= corner[:, :, 1:-1]
    read[:, :, 2:] |= corner[:, :, 1:-1]
    read[:, :-2, :] |= corner[:, 1:-1, :]
    read[:, 2:, :] |= corner[:, 1:-1, :]
    return 4 * int(read.sum())


def phase_sift_kernels():
    """K13-K16 against their plain versions (float64 on the same inputs) on
    one rendered 3072 x 2304 view (octave 0 is 6144 x 4608), and their
    times. Returns (errs, rows)."""
    import torch.nn.functional as F

    from colmap_tpu_torch.feature import sift as FS
    from colmap_tpu_torch.kernels import sift as KS
    from colmap_tpu_torch.kernels import sift_cases as SC

    errs = {k: [] for k in KS.LAUNCHES}
    rows = {}
    opts = FS.SiftOptions()
    t0 = time.perf_counter()
    view = SC.rendered_views(1, SIFT_W, SIFT_H, num_points=SIFT_POINTS)[0]
    img = torch.from_numpy(view).to("cuda").float() / 255.0
    log(f"SIFT kernels vs plain (float64 on the same inputs), one rendered {SIFT_W} x {SIFT_H} "
        f"view (set-up {time.perf_counter() - t0:.1f} s):")

    # K13, level by level on the same input.
    up = KS.upsample2(img)
    check("K13 upsample2", up, KS.upsample2_plain(img.double()), K13_RTOL, errs["sift_pyramid"])
    base = KS.blur(up, opts.sigma0)
    check("K13 base blur", base, KS.blur_plain(up.double(), opts.sigma0), K13_RTOL,
          errs["sift_pyramid"])
    gauss, dog = KS.build_octave(base, opts)
    sigmas = KS.octave_sigmas(opts)
    for s, sigma in enumerate(sigmas):
        prev = gauss[s].double()
        check(f"K13 level {s + 1} (sigma {sigma:.3f})", gauss[s + 1], KS.blur_plain(prev, sigma),
              K13_RTOL, errs["sift_pyramid"])
        check(f"K13 DoG {s}", dog[s], gauss[s + 1].double() - prev, K13_RTOL,
              errs["sift_pyramid"])
    if not torch.equal(KS.downsample2(gauss[3]), gauss[3][::2, ::2]):
        raise AssertionError("K13 downsample2 differs from x[::2, ::2]")
    torch.cuda.synchronize()

    # K14 on K13's DoG.
    S_, H, W = dog.shape[0] - 2, dog.shape[1], dog.shape[2]
    ext = KS.detect_extrema(dog, opts)
    ref = KS.detect_extrema_plain(dog.double(), opts)
    thr = 0.8 * opts.peak_threshold
    inner = dog[1:-1].reshape(-1)
    gk, rk = set(ext.flat.tolist()), set(ref.flat.tolist())
    diff = gk ^ rk
    near = [i for i in diff if abs(abs(float(inner[i])) - thr) <= 1e-6]
    n_near = int(((inner.abs().double() - thr).abs() <= 1e-6).sum())
    log(f"  K14: {len(gk)} extrema ({len(rk)} plain); {len(diff)} differ, all within 1e-6 of the "
        f"threshold: {len(diff) == len(near)} ({n_near} samples of the octave lie there)")
    if len(diff) != len(near) or len(rk) < 1000:
        raise AssertionError("K14: the extrema differ away from the threshold")
    cap = opts.max_candidates_per_octave
    top_k, top_r = KS.top_candidates(ext, cap), KS.top_candidates(ref, cap)
    if not torch.equal(ext.flat[top_k], ref.flat[top_r]):
        raise AssertionError("K14: the selected candidates differ")
    keep_k, keep_r = ext.keep[top_k], ref.keep[top_r]
    borderline = refine_margin(ext._replace(rows=ext.rows[top_k]), opts, W, H)
    hard = (keep_k != keep_r) & ~borderline
    log(f"  K14: the same {len(top_k)} selected candidates in the same order; keep differs on "
        f"{int((keep_k != keep_r).sum())}, {int(hard.sum())} of them away from a threshold")
    if int(hard.sum()):
        raise AssertionError("K14: keep flags differ away from a threshold")
    both = keep_k & keep_r
    flat = ext.flat[top_k][both]
    start = torch.stack([flat % W, flat // W % H, flat // (H * W)], 1).double()
    for j, name in enumerate(("x", "y", "s")):
        got = ext.rows[top_k][both, j].double() - start[:, j]
        want = ref.rows[top_r][both, j].double() - start[:, j]
        a, r = rel_err(got, want)
        log(f"  K14 {name} offset: max_abs_err {a:.3e} (tol {K14_OFFSET_ATOL:g} absolute)")
        if not a <= K14_OFFSET_ATOL:
            raise AssertionError(f"K14 {name} offset: error {a:.3e} > {K14_OFFSET_ATOL:g}")
        errs["sift_extrema"].append((a, r))
    for j, name in ((3, "sigma"), (4, "response")):
        check(f"K14 refined {name}", ext.rows[top_k][both, j], ref.rows[top_r][both, j],
              K14_RTOL, errs["sift_extrema"])

    # K15 on the selected keypoints.
    sel = top_k[keep_k]
    x, y, lvl, sigma, resp = KS.selected_keypoints(ext, sel)
    g64 = gauss.double()
    theta, ok = KS.orientations(gauss, x, y, lvl, sigma, opts)
    theta_p, ok_p = KS.orientations_plain(g64, x.double(), y.double(), lvl, sigma.double(), opts)
    hist = KS.orientation_histograms_plain(g64, x.double(), y.double(), lvl, sigma.double())
    clear = orientation_margin(hist, opts.max_num_orientations) > 1e-4
    agree = (ok == ok_p).all(dim=1)
    dth = torch.remainder(theta.double() - theta_p + math.pi, 2 * math.pi) - math.pi
    both = ok & ok_p & agree[:, None]
    err = float(dth[both].abs().max())
    errs["sift_orientation"].append((err, err / math.pi))
    log(f"  K15: {len(sel)} keypoints, {int(ok.sum())} orientations; ok rows differ on "
        f"{int((~agree).sum())} keypoints ({int((~agree & clear).sum())} with a margin above "
        f"1e-4, {int((~clear).sum())} keypoints within it); theta max error {err:.3e} rad "
        f"(tol {K15_RAD:g})")
    if int((~agree & clear).sum()) or not err <= K15_RAD:
        raise AssertionError("K15: orientations differ")

    # K16 on K15's orientations.
    data, desc = KS.descriptors(gauss, x, y, lvl, sigma, resp, theta, ok, opts)
    data_p, _, desc_p = KS.descriptors_plain(g64, x.double(), y.double(), lvl, sigma.double(),
                                             resp.double(), theta.double(), opts)
    okr = ok.reshape(-1)
    dd = (desc[okr].int() - desc_p[okr].int()).abs()
    worst = int(dd.max())
    errs["sift_descriptor"].append((float(worst), worst / 255.0))
    log(f"  K16: {int(okr.sum())} rows, descriptors within {worst} count (tol {K16_COUNTS}), "
        f"{float((dd == 0).double().mean()):.6f} of entries equal")
    check("K16 rows (x, y, sigma, theta, response, frame)", data[okr], data_p[okr], 1e-5,
          errs["sift_descriptor"])
    if worst > K16_COUNTS:
        raise AssertionError("K16: descriptors differ by more than one count")

    # Times at octave 0's shapes.
    log("  times at octave 0 (6144 x 4608, 6 levels):")
    HW, n_lv = H * W, len(sigmas)
    radii = [KS.blur_radius(s) for s in [opts.sigma0] + sigmas]
    taps = [KS.gaussian_taps(s, torch.float32, "cuda") for s in [opts.sigma0] + sigmas]

    def pyramid(m):
        return m.build_octave(m.blur(m.upsample2(img), opts.sigma0), opts)

    def library():
        def conv(z, t):
            r = (t.shape[0] - 1) // 2
            z = F.conv2d(F.pad(z, (r, r, 0, 0), mode="replicate"), t.view(1, 1, 1, -1))
            return F.conv2d(F.pad(z, (0, 0, r, r), mode="replicate"), t.view(1, 1, -1, 1))

        z = F.interpolate(img[None, None], scale_factor=2, mode="bilinear", align_corners=False)
        levels = [conv(z, taps[0])]
        for t in taps[1:]:
            levels.append(conv(levels[-1], t))
        g = torch.cat(levels)
        return g, g[1:] - g[:-1]

    # Upsample 6 flops an output pixel, each blur pass 2 (2r + 1), the DoG 1.
    ops = 6 * HW + sum(2 * 2 * (2 * r + 1) * HW for r in radii) + n_lv * HW
    rows["sift_pyramid"] = _sift_row(
        "sift_pyramid", lambda: pyramid(FS.KERNELS), lambda: pyramid(FS.PLAIN),
        HW + 4 * HW * (2 * n_lv + 1), ops, library)
    n_ext = len(ext.flat)
    rows["sift_extrema"] = _sift_row(
        "sift_extrema", lambda: KS.detect_extrema(dog, opts),
        lambda: KS.detect_extrema_plain(dog, opts), 4 * (S_ + 2) * HW + 33 * n_ext,
        2 * S_ * HW + 200 * n_ext)
    K_ = len(sel)
    eye = torch.eye(2, device="cuda").expand(K_, 2, 2)
    ori_bytes = sampled_level_bytes(gauss.shape, x, y, lvl, sigma[:, None, None] * eye)
    rows["sift_orientation"] = _sift_row(
        "sift_orientation", lambda: KS.orientations(gauss, x, y, lvl, sigma, opts),
        lambda: KS.orientations_plain(gauss, x, y, lvl, sigma, opts),
        ori_bytes + 20 * K_ + 5 * ok.numel(), SIFT_SAMPLE_OPS * 256 * K_)
    rr = okr.nonzero().flatten() // opts.max_num_orientations
    th = theta.reshape(-1)[okr]
    c, s = torch.cos(th), torch.sin(th)
    rot = torch.stack([torch.stack([c, -s], -1), torch.stack([s, c], -1)], -2)
    scales = KS.dsp_scales(opts)
    desc_bytes = sampled_level_bytes(
        gauss.shape, x[rr].repeat(len(scales)), y[rr].repeat(len(scales)),
        lvl[rr].repeat(len(scales)), torch.cat([f * sigma[rr, None, None] * rot for f in scales]))
    log(f"  level bytes the samples read: K15 {ori_bytes}, K16 {desc_bytes}")
    rows["sift_descriptor"] = _sift_row(
        "sift_descriptor", lambda: KS.descriptors(gauss, x, y, lvl, sigma, resp, theta, ok, opts),
        lambda: KS.descriptors_plain(gauss, x, y, lvl, sigma, resp, theta, opts),
        desc_bytes + 24 * K_ + 4 * theta.numel() + ok.numel() + (36 + 128) * theta.numel(),
        (SIFT_SAMPLE_OPS * 256 + 8 * 4 * 256) * len(rr) * len(scales))
    return errs, rows


def _sift_row(name, fn, plain, bytes_moved, ops, library=None):
    ms = time_ms(fn, reps=10)
    plain_ms = time_ms(plain, reps=3)
    library_ms = time_ms(library, reps=10) if library else None
    b_ms, by = bound(bytes_moved, ops)
    lib = f", conv2d + interpolate {library_ms:.4f} ms" if library else ""
    log(f"    {name}: {ms:.4f} ms (plain {plain_ms:.3f} ms{lib}, bound {b_ms:.5f} ms by {by})")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=by, library_ms=library_ms)


def run_command(argv, label, kernels):
    """One CLI command on cuda with every launch count at 0 before; logs the
    kernels it launched, returns (result, seconds, launches) and fails if a
    kernel of ``kernels`` did not launch."""
    from colmap_tpu_torch.cli import main as cli

    torch.cuda.synchronize()
    reset_all_launches()
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        out = cli.main(argv + ["--device", "cuda"])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = all_launch_counts()
    log(f"{label}: {buf.getvalue().strip().splitlines()[-1]} ({dt:.3f} s)")
    log(f"  launches: { {k: v for k, v in counts.items() if v} }")
    missing = [k for k in kernels if counts[k] == 0]
    if missing:
        raise AssertionError(f"{label}: launched no {missing}")
    return out, dt, counts


def phase_extractor(launches):
    """(a) Four rendered 3072 x 2304 views through `feature_extractor` on
    cuda under torch.profiler, each held against the plain extraction on
    the card; (b) images -> model: the rendered 12-frame scene through
    `feature_extractor`, `exhaustive_matcher` and `mapper` on cuda, held to
    the ground truth."""
    from torch.profiler import ProfilerActivity, profile

    from colmap_tpu_torch.feature import sift as FS
    from colmap_tpu_torch.kernels import sift_cases as SC
    from colmap_tpu_torch.scene.database import Database
    from colmap_tpu_torch.utils.image_io import read_image_gray

    results = {}
    with tempfile.TemporaryDirectory() as tmp:
        images = os.path.join(tmp, "wide")
        t0 = time.perf_counter()
        SC.render_scene(images, EXTRACT_VIEWS, SIFT_POINTS, SIFT_W, SIFT_H, 1.25 * SIFT_W)
        log(f"extractor at full width: {EXTRACT_VIEWS} rendered {SIFT_W} x {SIFT_H} views "
            f"(set-up {time.perf_counter() - t0:.1f} s)")
        db_path = os.path.join(tmp, "wide.db")
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.zeros(1, device="cuda").add_(1.0)  # let the tracer see a first kernel
            torch.cuda.synchronize()
            _, dt, counts = run_command(["feature_extractor", "--database_path", db_path,
                                         "--image_path", images], "feature_extractor, full width",
                                        SIFT_SOURCES)
        for k, v in counts.items():
            launches[k] += v
        busy_ms, by_name = device_busy(prof)
        idle = log_busy("feature_extractor, full width", busy_ms, by_name, dt * 1e3, top=10)
        db = Database(db_path, must_exist=True)
        opts = FS.SiftOptions()
        n_kp = []
        t0 = time.perf_counter()
        for iid, name, _ in db.read_images():
            kp, desc = db.read_keypoints(iid), db.read_descriptors(iid)
            img = read_image_gray(os.path.join(images, name))
            img_t = torch.from_numpy(img).to("cuda").float() / 255.0
            rows_p, desc_p = FS._extract(img_t, opts, FS._num_octaves(img.shape, opts), FS.PLAIN)
            kp_p, desc_p = FS.cut_to_max_features(rows_p.cpu().numpy(), desc_p.cpu().numpy(), opts)
            share, worst, equal, _ = SC.match_keypoints(kp_p, desc_p, kp, desc)
            log(f"  {name}: {len(kp)} keypoints ({len(kp_p)} plain); {share:.4f} of the plain "
                f"keypoints matched, descriptors within {worst} counts, {equal:.4f} of entries "
                "equal")
            if not (share >= 0.97 and worst <= 2 and equal >= 0.95
                    and abs(len(kp) - len(kp_p)) <= 0.03 * len(kp_p)):
                raise AssertionError(f"{name}: the extraction differs from the plain version")
            n_kp.append(len(kp))
        db.close()
        log(f"  {EXTRACT_VIEWS} images in {dt:.3f} s = {EXTRACT_VIEWS / dt:.3f} images/s on "
            f"{nvidia_smi_line()}; keypoints per image {n_kp}; idle share "
            f"{'not measured' if idle is None else f'{idle:.4f}'} (plain check "
            f"{time.perf_counter() - t0:.1f} s)")
        results["full_width"] = dict(seconds=dt, images_per_s=EXTRACT_VIEWS / dt, keypoints=n_kp,
                                     idle_share=idle)

        # (b) images -> model.
        root = os.path.join(tmp, "model")
        t0 = time.perf_counter()
        gt, _, params = SC.render_scene(os.path.join(root, "images"), IMG_FRAMES, IMG_POINTS,
                                        1024, 768, IMG_FOCAL, patch_world=IMG_PATCH_WORLD)
        log(f"images -> model: {IMG_FRAMES} rendered frames x {IMG_POINTS} points, PINHOLE 1024 x "
            f"768, f = {IMG_FOCAL:g}, patch_world {IMG_PATCH_WORLD} (set-up "
            f"{time.perf_counter() - t0:.1f} s)")
        db_path = os.path.join(root, "db.db")
        seconds = {}
        _, seconds["feature_extractor"], counts = run_command(
            ["feature_extractor", "--database_path", db_path, "--image_path",
             os.path.join(root, "images"), "--camera_model", "PINHOLE", "--camera_params",
             ",".join(repr(float(v)) for v in params)], "feature_extractor", SIFT_SOURCES)
        sift_launches = {k: counts[k] for k in SIFT_SOURCES}
        for k, v in counts.items():
            launches[k] += v
        _, seconds["exhaustive_matcher"], counts = run_command(
            ["exhaustive_matcher", "--database_path", db_path], "exhaustive_matcher",
            MATCHER_KERNELS)
        for k, v in counts.items():
            launches[k] += v
        out = os.path.join(root, "sparse")
        _, seconds["mapper"], counts = run_command(
            ["mapper", "--database_path", db_path, "--output_path", out, "--quiet"], "mapper",
            ())
        for k, v in counts.items():
            launches[k] += v
        from colmap_tpu_torch.estimators.alignment import compare_reconstructions
        from colmap_tpu_torch.scene.reconstruction_io import read_model

        recon = read_model(os.path.join(out, "0"))
        cmp = compare_reconstructions(recon, gt)
        n, rot, ctr = (cmp["num_common_images"], cmp["max_rotation_error_deg"],
                       cmp["max_center_error"])
        log(f"  images -> model: {recon.num_reg_frames()}/{IMG_FRAMES} frames, "
            f"{recon.num_points3D()} points; max rotation error {rot:.4f} deg, max center error "
            f"{ctr:.5f} (bounds {IMG_MAX_ROT_DEG} deg, {IMG_MAX_CENTER}); seconds by command "
            f"{ {k: round(v, 3) for k, v in seconds.items()} }; SIFT launches {sift_launches}")
        if not (n == IMG_FRAMES and rot < IMG_MAX_ROT_DEG and ctr < IMG_MAX_CENTER):
            raise AssertionError(f"images -> model: {n}/{IMG_FRAMES} frames, {rot} deg, {ctr}")
        results["images_to_model"] = dict(seconds=seconds, frames=n, max_rot_deg=rot,
                                          max_center=ctr)
    return results


ALL_PHASES = ("ba", "sfm", "mapper", "matching", "matcher", "sift", "extractor")


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--phases", default=",".join(ALL_PHASES),
                        help="comma-separated subset of " + ",".join(ALL_PHASES))
    phases = set(parser.parse_args().phases.split(","))
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is False; it needs a CUDA card")
    smi = nvidia_smi_line()
    log(f"device: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from colmap_tpu_torch.kernels.build import library

    t0 = time.perf_counter()
    library()
    log(f"build: kernels ready in {time.perf_counter() - t0:.1f} s")

    errs, rows, agree, solves = {}, {}, {}, {}
    launches = {k: 0 for k in all_launch_counts()}
    seconds = {}

    def run(phase, fn):
        t = time.perf_counter()
        out = fn()
        seconds[phase] = round(time.perf_counter() - t, 1)
        return out

    if "ba" in phases:
        ba_errs, ba_rows, solves = run("ba", lambda: phases_ba(launches))
        errs.update(ba_errs)
        rows.update(ba_rows)
    if "sfm" in phases:
        sfm_errs, sfm_rows, sfm_agree = run("sfm", phase_sfm_kernels)
        errs.update(sfm_errs)
        rows.update(sfm_rows)
        agree.update(sfm_agree)
    if "mapper" in phases:
        run("mapper", lambda: phase_mapper(launches))
    if "matching" in phases:
        m_errs, m_rows, m_agree = run("matching", phase_matching_kernels)
        errs.update(m_errs)
        rows.update(m_rows)
        agree.update(m_agree)
    if "matcher" in phases:
        run("matcher", lambda: phase_matcher_full(launches))
    if "sift" in phases:
        s_errs, s_rows = run("sift", phase_sift_kernels)
        errs.update(s_errs)
        rows.update(s_rows)
    if "extractor" in phases:
        run("extractor", lambda: phase_extractor(launches))
    log(f"seconds by phase: {seconds}")

    sources = {**BA_SOURCES, **SFM_SOURCES, **MATCH_SOURCES, **SIFT_SOURCES}
    kernels = []
    for name, (src, replaces) in sources.items():
        if name not in rows:
            continue
        kernels.append(dict(
            name=name, route="cuda", source=src, replaces=replaces,
            launches=launches[name], max_abs_err=max(e[0] for e in errs[name]),
            max_rel_err=max(e[1] for e in errs[name]),
            ms=rows[name]["ms"], plain_ms=rows[name]["plain_ms"],
            bound_ms=rows[name]["bound_ms"], bound_by=rows[name]["bound_by"],
            library_ms=rows[name].get("library_ms"),
        ))
        if name in agree:  # near-best models that agree, of all near-best models
            kernels[-1]["near_best_agree"] = list(agree[name])
    complete = phases >= set(ALL_PHASES)
    if complete:
        idle_kernels = [k["name"] for k in kernels if k["launches"] == 0]
        if len(kernels) != len(sources) or idle_kernels:
            raise AssertionError(f"kernels without a launch on a driven path: {idle_kernels}")
    if solves:
        log("headline LM iter/s on " + smi + ": " + ", ".join(
            f"{k} {v['iter_per_s']:.3f}, warm {v['warm_iter_per_s']:.3f} "
            f"(final cost {v['final_cost']:.6e})" for k, v in solves.items()))
    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi_line())
    if not complete:
        sys.exit("chip_smoke: a subset of the phases ran; no result")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


def phases_ba(launches):
    """Phases 3-6 on the BA headline problem; returns (errs, rows, solves)."""
    from colmap_tpu_torch.estimators import bundle_adjustment as ba
    from colmap_tpu_torch.scene.synthetic_ba import synthetic_ba_problem

    t0 = time.perf_counter()
    problem, gt, model_id = synthetic_ba_problem(200, 50000, 6, seed=0, device="cuda")
    options = ba.BAOptions(max_iterations=10, pcg_iterations=20, function_tolerance=0.0)
    masks = ba.fix_gauge_two_frames(ba.default_masks(problem, model_id, options), 0, 1)
    packed, maps, caps = ba.pack_problem(problem)
    # Ground-truth parameters against the noisy measurements.
    gt_state = problem._replace(quat=gt.quat, t=gt.t, cam_params=gt.cam_params, points=gt.points)
    gt_cost = float(ba.compute_cost(gt_state, model_id, options))
    log(f"headline problem: F=200 N=50000 O={problem.obs_xy.shape[0]} capp={caps['capp']}, "
        f"initial cost {float(ba.compute_cost(problem, model_id, options)):.6e}, "
        f"ground-truth cost {gt_cost:.6e} (set-up {time.perf_counter() - t0:.1f} s)")
    headline = (problem, model_id, packed, maps, masks)
    errs, ctx = phase_kernels(headline)
    rows = time_kernels(ctx, maps, model_id)
    solves = phase_headline_solve(headline, gt_cost, launches)
    phase_cli(launches)
    phase_profile(headline, solves)
    return errs, rows, solves


if __name__ == "__main__":
    main()
