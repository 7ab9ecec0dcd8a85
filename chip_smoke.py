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
     99% of them as inliers and no other;
 12. SIFT kernels (phase `sift`): K13-K16 against float64 plain versions
     at octave 0 of a rendered 3072 x 2304 view;
 13. extractor (phase `extractor`): `feature_extractor` on four rendered
     3072 x 2304 views, then images -> model on 12 rendered frames;
 14. dense (phase `dense`): six rendered 3072 x 2304 SIMPLE_RADIAL views
     of two stepped slanted planes through `image_undistorter`,
     `patch_match_stereo --geom_consistency --write_consistency_graph` and
     `stereo_fusion`, each under torch.profiler, held to the kept share,
     depth error and fused-cloud gates of colmap_tpu's MVS tests;
 15. MVS kernels (phase `mvs`, after `dense`): K17-K20 against their plain
     versions in float64 at full width and on a 640 x 480 crop of the dense
     workspace's first problem (K18: the same plane at >= 99.9% of the
     pixels), then timed at full width;
 16. global-SfM kernels (phase `global_kernels`): K21-K23
     (colmap_tpu_torch/kernels/global_sfm.py) against float64 plain
     versions at the scale global SfM users run: K21 on a 1000-node view
     graph with 25 000 edges (2 deg noise, 5% random), L1 and Geman-McClure,
     with and without gravity projectors; K22 on 1000 cameras x 200 000
     points x 1 200 000 observations at a solve's first and last state; K23
     on 50 cameras and 2000 F edges; timed with CUDA events; then
     estimate_rotations, solve_global_positioning and calibrate_view_graph
     through the kernels and through the plain versions in float64 on the
     card, held to the truth and to each other;
 17. global SfM (phase `global`): `global_mapper` on the verify scene, the
     full-size scene (both with relative poses decomposed from E) and an
     8-frame gravity-prior scene, `rotation_averager` on the verify scene
     and `view_graph_calibrator` on a database of UNCALIBRATED pairs, each
     under torch.profiler: frames, errors against the truth, wall time,
     time by phase and the device's idle share;
 18. rig kernels (phase `rig_kernels`): K24-K27
     (colmap_tpu_torch/kernels/rig.py) against float64 plain versions on the
     rig BA headline (50 frames x 4 sensors x 50 000 points x 300 000
     observations, SIMPLE_RADIAL, Cauchy, sensors free) and on small problems
     over camera models 0-4 with a constant frame and an empty sensor row
     (K25, K26: the same bits in two runs), K27 on 1024 injected samples of a
     2000-row rig frame (the same best sample or a near-tie marked from
     float64), timed with CUDA events; then 10 LM iterations of the rig solve
     through the kernels and through the float64 plain versions, held to
     each other and to the true sensor_from_rig;
 19. rig mapper (phase `rig`): the verify rig scene (2 cameras x 6 frames x
     200 points, seed 4) stripped to features, its rigs and frames emptied
     and rebuilt by `rig_configurator`, and the full-size rig scene (4
     cameras x 10 frames x 1000 points, f = 2500, seed 3) stripped to
     features, each through `exhaustive_matcher` and `mapper` on cuda (the
     mapper under torch.profiler): frames, errors against the truth, wall
     time, time by phase and the device's idle share.
Each path is driven with the launch counts set to 0 just before it and
read just after: the BA paths (phases 4-5) must launch K1-K3 (and K4 with
the dense solver), the matcher K5, K7 and K10-K12, the mapper K1-K3 and
K5-K9 (its BA is PCG, so K4 is not on its path), the extractor K13-K16,
`image_undistorter` K5, `patch_match_stereo` K17-K20, `global_mapper` K1-K3,
K5, K21 and K22, `rotation_averager` K21, `view_graph_calibrator` K23, the
rig solve K24-K26 and the rig mapper K5, K7 and K24-K27 (and on the
full-size rig scene K8 and K9).
Then it prints the kernels line (JSON), the nvidia-smi line and, last,
{"ok": true, "device": {...}}. `--phases dense,mvs`, `--phases
global_kernels,global` or `--phases rig_kernels,rig` (or any subset of the
phases) runs a subset while developing and prints no result; the kernels
line needs them all.
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


MVS_SOURCES = {
    "pm_cost": ("colmap_tpu_torch/csrc/pm_cost.cu", "colmap_tpu/mvs/patch_match.py:155"),
    "pm_iteration": ("colmap_tpu_torch/csrc/pm_iteration.cu",
                     "colmap_tpu/mvs/patch_match.py:452"),
    "pm_view_weights": ("colmap_tpu_torch/csrc/pm_view_weights.cu",
                        "colmap_tpu/mvs/patch_match.py:415"),
    "pm_view_selection": ("colmap_tpu_torch/csrc/pm_view_selection.cu",
                          "colmap_tpu/mvs/patch_match.py:338"),
}
# The dense scene: six SIMPLE_RADIAL views at south-building's resolution
# (BASELINE.json config 1), f = 3840 px, k = -0.02, centres on a 3 x 2 grid
# 0.5 apart, all looking along +z at two slanted textured planes with a step
# between them (x < 0: z = 5 + 0.08 x + 0.05 y; x >= 0: z = 4.7 + 0.08 x -
# 0.04 y; the wall x = 0 joins them), about one texel per pixel; 300 sparse
# points on the surface make the sparse model. COLMAP's default
# max_image_size of -1 runs PatchMatch at this size.
DENSE_W, DENSE_H, DENSE_F, DENSE_K, DENSE_POINTS = 3072, 2304, 3840.0, -0.02, 300
DENSE_PLANES = ((np.array([-0.08, -0.05, 1.0]), 5.0), (np.array([-0.08, 0.04, 1.0]), 4.7))
# Gates on the geometric maps (interior: 5% margins) and the fused cloud:
# tests/test_mvs_workspace.py:93, tests/test_mvs.py:124,
# tests/test_mvs_workspace.py:100.
DENSE_MIN_KEPT, DENSE_MAX_DEPTH_ERR, DENSE_MAX_FUSED_ERR = 0.4, 0.02, 0.03
MVS_CROP_W, MVS_CROP_H = 640, 480
# K17/K18 float32 NCC moments against float64: costs to 1e-4 of their
# largest entry away from near-ties (a window tap within 1e-3 px of a
# source's border, and the like: mvs_cases' cost_ties; the geometric term
# next to a hole or a step of over 2% in a source depth map: geom_ties),
# which must leave at least 75% of the entries; K18 the same choice at >=
# 99.9% of pixels, every pixel away from near-ties of its candidates' costs
# (gap 1e-4); K19 (float64 angles) and K20 (odds) to 1e-5.
K17_RTOL, K18_MIN_SAME, K1920_ATOL, MVS_TIE_PX, MVS_TIE_GAP = 1e-4, 0.999, 1e-5, 1e-3, 1e-4
# The geometric error's float32 round trip at f = 3840 px carries about
# 1e-3 px: the filter's geometric test is a near-tie within 1e-2 px.
MVS_DEPTH_STEP, MVS_GEOM_EPS = 0.02, 1e-2
# f32 operations the PatchMatch functions need (an FMA is 2; a compare, a
# select, a floor, a reciprocal, a division, an exp or a square root is
# 1), counted from colmap_tpu/mvs/patch_match.py for the least arithmetic
# that computes it. A plane (d, n) at pixel p induces in source s the
# homography H = A_s + b_s m^T, with A_s = K_s R_s K_ref^-1 and b_s = K_s t_s
# per view and m = -K_ref^-T n / (d n . r_p) per plane, so a tap needs no
# ray and no plane depth of its own.
#  - per (pixel, tap), whatever the plane and view: the bilateral weight
#    w_sp exp(-(I_k - I_p)^2 / 2 sigma^2) (5), the weight sum (1), and
#    w (I_k - I_p), w (I_k - I_p)^2 (2): PM_TAP_OPS = 8;
#  - per (pixel, plane): n . r_p (5), times d (1), K_ref^-T n (6 FMA), a
#    reciprocal and 3 multiplications: PM_PLANE_OPS = 22;
#  - per (pixel, plane, view): H (9 FMA) and H (x, y, 1) (6 FMA, 3 adds);
#    the NCC from the six moments (sw + eps and its reciprocal 2, two means
#    2, two clamped variances 8, the covariance 3, the clamped product 2,
#    a reciprocal square root and a product 2: 19), the weight share and
#    its test (2), 1 - clip(ncc) or 2 (4): PM_VIEW_OPS = 58;
#  - per (pixel, plane, view, tap): the tap's point p + dx h0 + dy h1
#    (6 FMA), the division (a reciprocal, 2 multiplications), the bounds
#    test (5 compares, an and), the bilinear sample (2 floors, 2 fractions,
#    2 complements, 4 corner weights, a multiplication and 3 FMA: 17), and
#    the six moments (the masked weight 1; sw, swr, swrr from the tap's
#    products 3; w sv 1, sws 1, swss and swrs 2 FMA: 10):
#    PM_TAP_VIEW_OPS = 12 + 3 + 6 + 17 + 10 = 48;
#  - the geometric term per (pixel, plane, view), with P_s = K_s [R_s | t_s],
#    G_s = K_ref R_s^T K_s^-1 and g_s = K_ref R_s^T t_s per view: X = d r_p
#    (3), P_s X (9 FMA, 3 adds), the division (3), the bounds test (6), the
#    bilinear depth (17), d_s G_s (sx, sy, 1) - g_s (6 FMA, 3 adds, 3
#    multiplications, 3 subtractions), the division (3), the error (2
#    subtractions, a multiplication, an FMA, a square root), the depth tests
#    (2), the clamp and the weighted add (3): PM_GEOM_OPS = 85;
#  - K18 per active pixel: four propagated plane depths (n . r twice, a
#    multiplication, a division, the clamp: 14 each), the perturbed depth
#    (5) and normal (3 FMA, the squared norm 5, its clamp and reciprocal
#    square root 2, 3 multiplications, the sign 1: 17): PM_CAND_OPS = 78;
#    per (pixel, candidate) the aggregation (S FMA) and the strict
#    comparison (1);
#  - K19's weights per pixel: the ray, X = d r_p and 1 / |X| (13), the
#    four corners' rays and plane depths (6 + 4 x 11), the total's test and
#    reciprocal (2): PM_WEIGHT_PIXEL_OPS = 65; per (pixel, view): S_c - X
#    (3), 1 / |S_c - X| (6), the two cosines (13), the triangulation prior
#    (9), the incidence prior (5), the four corners through P_s with their
#    divisions (4 x 24), the footprint's area and ratio (24), the product,
#    the sum and the normalization (6): PM_WEIGHT_VIEW_OPS = 162;
#  - K20 per (view, sample): the emission (4), the forward message (11),
#    the backward message (10), the posterior and the blend (9):
#    PM_SEL_OPS = 34.
PM_TAP_OPS, PM_PLANE_OPS, PM_VIEW_OPS, PM_TAP_VIEW_OPS, PM_GEOM_OPS = 8, 22, 58, 48, 85
PM_CAND_OPS, PM_WEIGHT_PIXEL_OPS, PM_WEIGHT_VIEW_OPS, PM_SEL_OPS = 78, 65, 162, 34


GLOBAL_SOURCES = {
    "rotation_averaging": ("colmap_tpu_torch/csrc/rotation_averaging.cu",
                           "colmap_tpu/estimators/rotation_averaging.py:274"),
    "global_positioning": ("colmap_tpu_torch/csrc/global_positioning.cu",
                           "colmap_tpu/estimators/global_positioning.py:48"),
    "view_graph_calibration": ("colmap_tpu_torch/csrc/view_graph_calibration.cu",
                               "colmap_tpu/estimators/view_graph_calibration.py:76"),
}
# Global SfM at the scale its users run (1DSfM's collections: about 1000
# registered images, tens of thousands of view-graph edges): rotation
# averaging on 1000 nodes and 25 000 edges (a ring plus random pairs, 2 deg
# of noise on every edge, 5% replaced by random rotations); positioning on
# 1000 cameras x 200 000 points x 1 200 000 observations (tracks of 6);
# view-graph calibration on 50 cameras and 2000 F edges.
RA_NODES, RA_EDGES, GP_CAMS, GP_POINTS, GP_TRACK, VGC_CAMS, VGC_EDGES = (
    1000, 25000, 1000, 200000, 6, 50, 2000)
# K21 float32 against float64 (quaternion log, a few products per edge); K22
# float32 3x3 inverses of point blocks and Schur sums; K23's loss (its edge
# arithmetic is float64) and its gradient away from cameras on edges with
# (s0 - s1) / s0 < 1e-4, whose singular vectors are not unique.
K21_RTOL, K22_RTOL, K23_LOSS_RTOL, K23_GRAD_RTOL, K23_TIE_GAP = 1e-5, 1e-4, 1e-5, 1e-4, 1e-4
# Whole solves through the kernels against the float64 plain versions on the
# card: rotation errors within 1.05x the plain path's + 1e-3 deg, aligned
# centre errors within 2x + 1e-4 of the scene scale, focals within 1e-3.
RA_SOLVE_FACTOR, RA_SOLVE_DEG, GP_SOLVE_FACTOR, GP_SOLVE_SCALE, VGC_SOLVE_RTOL = (
    1.05, 1e-3, 2.0, 1e-4, 1e-3)
# The global mapper's gates: the reference thresholds on the verify and
# full-size scenes, colmap_tpu's own on the gravity-prior scene
# (tests/test_global_mapper.py:236-240), 0.5 deg for rotation_averager
# (tests/test_cli_tools3.py:115) and 5% on the calibrated focals.
GRAVITY_MAX_ROT_DEG, GRAVITY_MAX_CENTER, RA_CLI_MAX_DEG, VGC_CLI_RTOL = 0.5, 0.05, 0.5, 0.05
# f32 operations (an FMA is 2) of the global kernels' functions:
#  - K21 (b) per edge: x_j - x_i (3), times w (3), added at both ends (6):
#    15 with the weight's sign; per node the free mask (3) and, for nodes
#    with a gravity projector, its 3x3 product (15);
#  - K22 (b) per observation, once from each side: the projection
#    (I - d d^T) v (a dot 5, 3 FMA 6) and w times it, accumulated (6): 17;
#    per point H_pp^-1 y (15), per camera H_cc x (15) and the difference (3);
#  - K23 per edge, counted in float64 arithmetic at the float32 rate: E =
#    K_b^T F K_a (two 3x3 products with the sparse K: 54 + 54), E^T E (6
#    entries x 3 FMA: 36), a symmetric 3x3 eigensolve (about 150), the two
#    left vectors (2 x (9 FMA + 3) = 42) and their orthogonalization (15),
#    res and its derivatives (10), the four u^T dE v terms (4 x 14 = 56):
#    about 420; per camera its incidences (1 each).
RA_EDGE_OPS, RA_NODE_OPS, RA_PROJ_OPS = 15, 3, 15
GP_OBS_OPS, GP_POINT_OPS, GP_CAM_OPS = 34, 15, 18
VGC_EDGE_OPS = 420

RIG_SOURCES = {
    "rig_ba_jacobians": ("colmap_tpu_torch/csrc/rig_ba_jacobians.cu",
                         "colmap_tpu/estimators/bundle_adjustment_rig.py:169"),
    "rig_ba_reduce": ("colmap_tpu_torch/csrc/rig_ba_reduce.cu",
                      "colmap_tpu/estimators/bundle_adjustment_rig.py:238"),
    "rig_ba_matvec": ("colmap_tpu_torch/csrc/rig_ba_matvec.cu",
                      "colmap_tpu/estimators/bundle_adjustment_rig.py:255"),
    "gen_abs_ransac": ("colmap_tpu_torch/csrc/gen_abs_ransac.cu",
                       "colmap_tpu/estimators/generalized_pose.py:113"),
}
# The rig BA headline: bench.py:101's problem grouped into a 4-camera rig,
# 50 frames x 4 sensors (200 images) x 50 000 points x 300 000
# observations, SIMPLE_RADIAL, Cauchy loss, the three non-reference sensors
# free.
RIG_FRAMES, RIG_SENSORS, RIG_POINTS, RIG_TRACK = 50, 4, 50000, 6
# K24 float32 against float64 under Cauchy (the weight carries the float32
# residual's rounding, as K1's robust tolerance says); K25 and K26 float32
# sums in a fixed order; K27's all-inlier models (a float64 solve rounded to
# float32).
K24_RTOL, K2526_RTOL, K27_RTOL = 1e-4, 1e-4, 1e-4
# K27 at a rig registration's scale: 2000 correspondences of one 4-camera
# frame (30% outliers, baselines of 0.05 at a distance of 5), 1024 injected
# samples in batches of 64, the world at scale 1 and shrunk to 0.37 (a
# monocular model's arbitrary scale); rows within 1e-3 of the threshold
# count as near.
GEN_ABS_ROWS, GEN_ABS_SAMPLES, GEN_ABS_BATCH, GEN_ABS_MARGIN = 2000, 1024, 64, 1e-3
# The rig solve (10 LM iterations): kernel and float64 plain paths' final
# costs within 1e-3 of each other; each path's sensor_from_rig errors
# against the truth at most a quarter of the initial ones (sensors perturbed
# by 0.01 units and 0.1 deg a component), the kernels' within 1.1x the plain
# path's + 1e-4 units / 1e-3 deg.
RIG_SOLVE_RTOL, RIG_SENSOR_GAIN, RIG_SENSOR_FACTOR = 1e-3, 4.0, 1.1
# The full-size rig scene: 1 rig x 4 cameras x 10 frames (40 images, as
# many as the full-size mono scene) x 1000 points, SIMPLE_RADIAL 1024 x 768,
# f = 2500, seed 3.
RIG_FULL_CAMS, RIG_FULL_FRAMES = 4, 10
# f32 operations (an FMA is 2) of the rig kernels' functions:
#  - K24 per observation: two quaternion rotations (2 x 18), the
#    projection on duals of 3 + P directions (about 20 x (3 + P)), B = A Rs
#    (36), the rotation columns of Js and Jf (24), Jx = B Rf (36), the
#    weight and the scaled, masked outputs (2 x (32 + 2P) / 2): about 320
#    at P = 4;
#  - K25 per observation: Hpp and gx (36), q = r + Jx y (12), and on each
#    of its three camera-side rows -J^T r, -J^T q and J^2 (3 x 2 x 3 x 2
#    x W, W = 6 or P): about 200; per point the damped inverse and y (45);
#  - K26 (matvec) per observation: u (2 x (12 + P) FMA), w (12), z (12)
#    and J^T z on its three rows (3 x 2 x 2 x W): about 150; per point y
#    (15);
#  - K27 per sample the float64 gDLT, counted at the float32 rate: the
#    normal equations (18 rows x 78 FMA), Cholesky of 12 (about 600), the
#    3x3 Jacobi (about 500) and t (about 200): about 4100; per sample and
#    row the residual (9 FMA, a quaternion rotation 18, the error 10): 45.
RIG_K24_OBS_OPS, RIG_K25_OBS_OPS, RIG_K25_POINT_OPS, RIG_K26_OBS_OPS, RIG_K26_POINT_OPS = (
    320, 200, 45, 150, 15)
GDLT_OPS, GEN_ABS_ROW_OPS = 4100, 45


def pm_plane_ops(taps, views, geometric):
    """f32 operations of one plane's cost at one pixel in every view."""
    return PM_PLANE_OPS + views * (PM_VIEW_OPS + taps * PM_TAP_VIEW_OPS
                                   + (PM_GEOM_OPS if geometric else 0))


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


def make_scene(root, num_frames, num_points, focal=1280.0, seed=3, num_cameras=1, **options):
    """A synthetic database and its ground truth (one rig of ``num_cameras``
    SIMPLE_RADIAL cameras, 1024 x 768, prior focal length, exhaustive
    noise-free matches; other generator options from ``options``), written
    with the port's generator."""
    from colmap_tpu_torch.scene.database import Database
    from colmap_tpu_torch.scene.synthetic import SyntheticDatasetOptions, synthesize_dataset

    db_path = os.path.join(root, "db.db")
    db = Database(db_path)
    gt = synthesize_dataset(
        SyntheticDatasetOptions(num_rigs=1, num_cameras_per_rig=num_cameras,
                                num_frames_per_rig=num_frames,
                                num_points3D=num_points, camera_params=(focal, 512.0, 384.0, 0.05),
                                camera_has_prior_focal_length=True, **options),
        db, rng=np.random.default_rng(seed))
    db.close()
    return db_path, gt


def _kernel_modules():
    from colmap_tpu_torch.kernels import ba as KB
    from colmap_tpu_torch.kernels import global_sfm as KG
    from colmap_tpu_torch.kernels import rig as KR
    from colmap_tpu_torch.kernels import matching as KM
    from colmap_tpu_torch.kernels import mvs as KV
    from colmap_tpu_torch.kernels import sfm as K
    from colmap_tpu_torch.kernels import sift as KS

    return KB, K, KM, KS, KV, KG, KR


def all_launch_counts():
    return {k: v for mod in _kernel_modules() for k, v in mod.LAUNCHES.items()}


def reset_all_launches():
    for mod in _kernel_modules():
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
              and k not in SIFT_SOURCES and k not in MVS_SOURCES and k not in GLOBAL_SOURCES
              and k not in RIG_SOURCES]
    missing = [k for k in needed if counts[k] == 0]
    if min_launches and missing:
        raise AssertionError(f"{label}: the mapper launched no {missing}")
    return pipeline, dt, counts


def check_against_gt(out, gt, num_frames, label, max_rot_deg=MAX_ROT_DEG, max_center=MAX_CENTER,
                     num_images=None):
    """The model in out/0 against the ground truth: every frame registered
    (``num_images`` images in common, num_frames when not given) within the
    rotation and centre bounds after a Sim3 alignment."""
    from colmap_tpu_torch.estimators.alignment import compare_reconstructions
    from colmap_tpu_torch.scene.reconstruction_io import read_model

    recon = read_model(os.path.join(out, "0"))
    cmp = compare_reconstructions(recon, gt)
    n, rot_err, ctr = cmp["num_common_images"], cmp["max_rotation_error_deg"], cmp["max_center_error"]
    log(f"  {label}: {recon.num_reg_frames()}/{num_frames} frames registered, "
        f"{recon.num_points3D()} points; against ground truth: {n} common images, max rotation "
        f"error {rot_err:.3e} deg, max center error {ctr:.3e}")
    expected = num_frames if num_images is None else num_images
    if not (recon.num_reg_frames() == num_frames and n == expected and rot_err <= max_rot_deg
            and ctr <= max_center):
        raise AssertionError(f"{label}: {n}/{expected} images, {rot_err} deg, {ctr}: outside "
                             f"{max_rot_deg} deg / {max_center}")
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


def _surface_hit(o, d):
    """Ray parameter s (z-depth for rays with d_z = 1) and the (N, 2)
    texture coordinates of the nearest hit of rays o + s d on the dense
    scene's surface: plane A where x < 0, plane B where x >= 0, the wall
    x = 0 between them (its coordinates (z, y), shifted clear of the
    planes')."""
    (na, ca), (nb, cb) = DENSE_PLANES
    best = np.full(len(d), np.inf)
    uv = np.zeros((len(d), 2))
    for n, c, side in ((na, ca, -1), (nb, cb, 1)):
        s = (c - n @ o) / (d @ n)
        X = o + s[:, None] * d
        ok = (s > 0) & ((X[:, 0] < 0) if side < 0 else (X[:, 0] >= 0)) & (s < best)
        best[ok] = s[ok]
        uv[ok] = X[ok][:, :2]
    with np.errstate(divide="ignore", invalid="ignore"):
        s = -o[0] / d[:, 0]
        X = o + s[:, None] * d
    lo, hi = _wall_span(X[:, 1])
    ok = (s > 0) & (X[:, 2] >= lo) & (X[:, 2] <= hi) & (s < best)
    best[ok] = s[ok]
    uv[ok] = np.stack([X[ok][:, 2] - 10.0, X[ok][:, 1]], axis=1)
    return best, uv


def _wall_span(y):
    """The wall's z range at height y: between the two planes at x = 0."""
    (na, ca), (nb, cb) = DENSE_PLANES
    za, zb = ca - na[1] * y, cb - nb[1] * y
    return np.minimum(za, zb), np.maximum(za, zb)


def _texture_lookup(tex, uv, texel):
    u = uv[:, 0] / texel + tex.shape[1] / 2
    v = uv[:, 1] / texel + tex.shape[0] / 2
    u0 = np.clip(np.floor(u).astype(np.int64), 0, tex.shape[1] - 2)
    v0 = np.clip(np.floor(v).astype(np.int64), 0, tex.shape[0] - 2)
    fu, fv = np.clip(u - u0, 0, 1), np.clip(v - v0, 0, 1)
    return (tex[v0, u0] * (1 - fu) * (1 - fv) + tex[v0, u0 + 1] * fu * (1 - fv)
            + tex[v0 + 1, u0] * (1 - fu) * fv + tex[v0 + 1, u0 + 1] * fu * fv)


def render_dense_scene(root, seed=3):
    """Render the dense scene into root/images (8-bit gray PNG) and its
    sparse model into root/sparse; returns the view centres. Each pixel's
    ray comes from the port's cam_from_img of the distorted camera (on the
    host) and meets the surface exactly; the texture is uniform noise
    smoothed by a Gaussian of one texel, sampled bilinearly."""
    from scipy.ndimage import gaussian_filter

    from colmap_tpu_torch.scene.reconstruction import Reconstruction
    from colmap_tpu_torch.scene.reconstruction_io import write_model
    from colmap_tpu_torch.scene.types import Camera, Frame, Image, Pose, Rig, TrackElement
    from colmap_tpu_torch.sensor import models as camera_models
    from colmap_tpu_torch.utils.image_io import write_png
    from colmap_tpu_torch.utils.types import SensorType

    rng = np.random.default_rng(seed)
    W, H, f = DENSE_W, DENSE_H, DENSE_F
    params = np.array([f, W / 2.0, H / 2.0, DENSE_K])
    texel = 5.0 / f
    tex = gaussian_filter(rng.uniform(0.0, 1.0, (int(4.6 / texel), int(13.0 / texel)))
                          .astype(np.float32), 1.0)
    tex = (tex - tex.min()) / (tex.max() - tex.min())
    ys, xs = np.mgrid[0:H, 0:W]
    grid = torch.from_numpy(np.stack([xs + 0.5, ys + 0.5], -1).reshape(-1, 2).astype(np.float64))
    uv, _ = camera_models.cam_from_img(2, torch.from_numpy(params), grid)
    rays = np.concatenate([uv.numpy(), np.ones((len(uv), 1))], axis=1)
    centres = [np.array([x, y, 0.0]) for y in (-0.25, 0.25) for x in (-0.5, 0.0, 0.5)]
    os.makedirs(os.path.join(root, "images"), exist_ok=True)
    recon = Reconstruction()
    recon.add_camera(Camera(camera_id=1, model_id=2, width=W, height=H, params=params))
    # Sparse points on the surface, seen by every view.
    pts = []
    while len(pts) < DENSE_POINTS:
        o = np.array([rng.uniform(-1.2, 1.2), rng.uniform(-0.8, 0.8), 0.0])
        s, _ = _surface_hit(o, np.array([[0.0, 0.0, 1.0]]))
        if np.isfinite(s[0]) and abs(o[0]) > 0.02:
            pts.append(o + s[0] * np.array([0.0, 0.0, 1.0]))
    pts = np.array(pts)
    for i, c in enumerate(centres):
        iid = i + 1
        s, tuv = _surface_hit(c, rays)
        img = np.clip(np.rint(255.0 * _texture_lookup(tex, tuv, texel)), 0, 255)
        name = f"view{i}.png"
        write_png(os.path.join(root, "images", name), img.reshape(H, W).astype(np.uint8), 1)
        recon.add_rig(Rig(rig_id=iid, ref_sensor_id=(int(SensorType.CAMERA), 1)))
        recon.add_frame(Frame(frame_id=iid, rig_id=iid,
                              rig_from_world=Pose(np.array([1.0, 0, 0, 0]), -c),
                              data_ids=[(int(SensorType.CAMERA), 1, iid)]))
        image = Image(image_id=iid, name=name, camera_id=1, frame_id=iid)
        xy, _ = camera_models.img_from_cam(2, torch.from_numpy(params),
                                           torch.from_numpy(pts - c))
        image.set_points2D(xy.numpy())
        recon.add_image(image)
        recon.register_frame(iid)
    for k, X in enumerate(pts):
        recon.add_point3D(X, [TrackElement(iid, k) for iid in range(1, len(centres) + 1)])
    write_model(recon, os.path.join(root, "sparse"), fmt="bin")
    return centres


def dense_gt_depth(K, centre):
    """(H, W) z-depth of the surface along the undistorted view's pixel
    rays K^-1 (x, y, 1), the rays PatchMatch's depth maps are indexed by."""
    ys, xs = np.mgrid[0:DENSE_H, 0:DENSE_W]
    rays = np.stack([xs, ys, np.ones_like(xs)], -1).reshape(-1, 3) @ np.linalg.inv(K).T
    return _surface_hit(centre, rays)[0].reshape(DENSE_H, DENSE_W)


def fused_relative_error(pts):
    """Each fused point's distance to its surface piece (plane A for x < 0,
    B for x >= 0, or the wall) over its depth."""
    (na, ca), (nb, cb) = DENSE_PLANES
    da = np.abs(pts @ na - ca) / np.linalg.norm(na)
    db = np.abs(pts @ nb - cb) / np.linalg.norm(nb)
    lo, hi = _wall_span(pts[:, 1])
    on_wall = (pts[:, 2] >= lo) & (pts[:, 2] <= hi)
    dist = np.where(pts[:, 0] < 0, da, db)
    dist = np.where(on_wall, np.minimum(dist, np.abs(pts[:, 0])), dist)
    return dist / np.abs(pts[:, 2])


DENSE_STATE = {}


def phase_dense(launches):
    """The dense scene through the CLI on cuda, each command under
    torch.profiler: `image_undistorter` -> `patch_match_stereo
    --geom_consistency --write_consistency_graph` -> `stereo_fusion`; the
    geometric maps and the fused cloud held to the gates."""
    from torch.profiler import ProfilerActivity, profile

    from colmap_tpu_torch.mvs.depth_map import read_map
    from colmap_tpu_torch.scene.reconstruction_io import read_model
    from colmap_tpu_torch.mvs.workspace import _pinhole_K

    root = tempfile.mkdtemp(prefix="dense_")
    DENSE_STATE["root"] = root
    t0 = time.perf_counter()
    centres = render_dense_scene(root)
    log(f"dense scene: {len(centres)} SIMPLE_RADIAL views {DENSE_W} x {DENSE_H}, f = {DENSE_F:g}, "
        f"k = {DENSE_K}, {DENSE_POINTS} sparse points (set-up {time.perf_counter() - t0:.1f} s)")
    ws = os.path.join(root, "dense")
    commands = [
        ("image_undistorter", ["image_undistorter", "--image_path", os.path.join(root, "images"),
                               "--input_path", os.path.join(root, "sparse"), "--output_path", ws],
         ("camera_map",)),
        ("patch_match_stereo", ["patch_match_stereo", "--workspace_path", ws,
                                "--geom_consistency", "--write_consistency_graph"],
         tuple(MVS_SOURCES)),
        ("stereo_fusion", ["stereo_fusion", "--workspace_path", ws, "--output_path",
                           os.path.join(ws, "fused.ply")], ()),
    ]
    seconds, idle = {}, {}
    for label, argv, kernels in commands:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.zeros(1, device="cuda").add_(1.0)  # let the tracer see a first kernel
            torch.cuda.synchronize()
            out, seconds[label], counts = run_command(argv, label, kernels)
        for k, v in counts.items():
            launches[k] += v
        busy_ms, by_name = device_busy(prof)
        idle[label] = log_busy(label, busy_ms, by_name, seconds[label] * 1e3, top=8)
        if label == "stereo_fusion":
            pts = out[0]
    recon = read_model(os.path.join(ws, "sparse"))
    kept, errs = [], []
    mx, my = DENSE_W // 20, DENSE_H // 20
    for iid in recon.reg_image_ids():
        img = recon.images[iid]
        K = _pinhole_K(recon.cameras[img.camera_id])
        d = read_map(os.path.join(ws, "stereo", "depth_maps", f"{img.name}.geometric.bin"))
        gt = dense_gt_depth(K, centres[iid - 1])
        inner, g = d[my:-my, mx:-mx], gt[my:-my, mx:-mx]
        ok = inner > 0
        kept.append(float(ok.mean()))
        errs.append(np.abs(inner[ok] - g[ok]) / g[ok])
    kept_share = float(np.mean(kept))
    med = float(np.median(np.concatenate(errs)))
    fused = float(np.median(fused_relative_error(pts)))
    log(f"  dense gates on {nvidia_smi_line()}: kept share {kept_share:.4f} (per view "
        f"{[round(k, 4) for k in kept]}; bound >= {DENSE_MIN_KEPT}), median relative depth error "
        f"{med:.5f} (<= {DENSE_MAX_DEPTH_ERR}), {len(pts)} fused points, median relative "
        f"distance to the surface {fused:.5f} (<= {DENSE_MAX_FUSED_ERR}); seconds by command "
        f"{ {k: round(v, 3) for k, v in seconds.items()} }; idle share "
        f"{ {k: (None if v is None else round(v, 4)) for k, v in idle.items()} }")
    if not (kept_share >= DENSE_MIN_KEPT and med <= DENSE_MAX_DEPTH_ERR
            and fused <= DENSE_MAX_FUSED_ERR):
        raise AssertionError("dense: a gate failed")
    return dict(seconds=seconds, kept=kept_share, median_depth_err=med, fused_err=fused,
                idle=idle)


def _dense_problem(ref_index=0):
    """The full-width problem of one reference view of the dense workspace
    (its sources by shared points), with the photometric maps of the
    sources as source depths, and a state: the reference's photometric
    planes, random planes where it has none."""
    from colmap_tpu_torch.mvs import patch_match as PM
    from colmap_tpu_torch.mvs.depth_map import read_map
    from colmap_tpu_torch.mvs.workspace import _pinhole_K, select_patch_match_problems
    from colmap_tpu_torch.scene.reconstruction_io import read_model
    from colmap_tpu_torch.utils.image_io import read_image_gray

    ws = os.path.join(DENSE_STATE["root"], "dense")
    recon = read_model(os.path.join(ws, "sparse"))
    spec = select_patch_match_problems(recon)[ref_index]
    opts = PM.PatchMatchOptions(depth_min=spec.depth_min, depth_max=spec.depth_max)

    def gray(iid):
        return read_image_gray(os.path.join(ws, "images", recon.images[iid].name)) / 255.0

    def maps(iid, kind):
        return read_map(os.path.join(ws, "stereo", kind, f"{recon.images[iid].name}"
                                     ".photometric.bin"))

    ref_pose = recon.cam_from_world(spec.ref_image_id)
    rels = [recon.cam_from_world(s).compose(ref_pose.inverse()) for s in spec.src_image_ids]
    K = _pinhole_K(recon.cameras[1])
    t = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32).cuda()  # noqa: E731
    problem = PM.PatchMatchProblem(
        ref_image=t(gray(spec.ref_image_id)),
        src_images=t(np.stack([gray(s) for s in spec.src_image_ids])), K_ref=t(K),
        K_src=t(np.stack([K] * len(rels))), R_rel=t(np.stack([r.rotmat() for r in rels])),
        t_rel=t(np.stack([r.t for r in rels])),
        src_depths=t(np.stack([maps(s, "depth_maps") for s in spec.src_image_ids])))
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    depth, normal = t(maps(spec.ref_image_id, "depth_maps")), t(maps(spec.ref_image_id,
                                                                      "normal_maps"))
    draws = PM.draw(gen, tuple(depth.shape), opts, torch.float32, "cuda")
    hole = depth <= 0
    depth = torch.where(hole, draws.depth, depth)
    normal = torch.where(hole[..., None], draws.normal, normal)
    sel = 0.05 + 0.9 * torch.rand(problem.src_images.shape, generator=gen, device="cuda")
    return problem, depth, normal, sel, PM.draw(gen, tuple(depth.shape), opts, torch.float32,
                                                "cuda"), opts


def _crop(problem, depth, normal, sel, draws, x0, y0, w, h):
    """A w x h window of the reference at (x0, y0), and of each source the
    w x h window where the reference window's centre lands at its depth, so
    that the sources' borders cut the reference window only near its own
    edges (the intrinsics shifted to match)."""
    from colmap_tpu_torch.kernels.mvs import Draws

    H, W = depth.shape
    win = (slice(y0, y0 + h), slice(x0, x0 + w))
    centre = torch.tensor([x0 + w / 2.0, y0 + h / 2.0, 1.0], device="cuda", dtype=torch.float64)
    X = torch.linalg.inv(problem.K_ref.double()) @ centre * float(depth[win].median())
    ps = torch.einsum("sij,sj->si", problem.K_src.double(),
                      problem.R_rel.double() @ X + problem.t_rel.double())
    shifts, srcs, sdeps = [], [], []
    for k in range(problem.src_images.shape[0]):
        xs = int(min(max(round(float(ps[k, 0] / ps[k, 2]) - w / 2), 0), W - w))
        ys = int(min(max(round(float(ps[k, 1] / ps[k, 2]) - h / 2), 0), H - h))
        shifts.append([xs, ys])
        srcs.append(problem.src_images[k, ys:ys + h, xs:xs + w])
        sdeps.append(problem.src_depths[k, ys:ys + h, xs:xs + w])
    shift = torch.zeros((len(shifts), 3, 3), dtype=torch.float32, device="cuda")
    shift[:, :2, 2] = torch.tensor(shifts, dtype=torch.float32, device="cuda")
    ref_shift = torch.zeros((3, 3), dtype=torch.float32, device="cuda")
    ref_shift[0, 2], ref_shift[1, 2] = x0, y0
    p = problem._replace(ref_image=problem.ref_image[win].contiguous(),
                         src_images=torch.stack(srcs).contiguous(),
                         src_depths=torch.stack(sdeps).contiguous(),
                         K_ref=problem.K_ref - ref_shift, K_src=problem.K_src - shift)
    return (p, depth[win].contiguous(), normal[win].contiguous(),
            sel[(slice(None),) + win].contiguous(), Draws(*(x[win].contiguous() for x in draws)))


def _mvs_checks(where, inputs, opts, view_selection, margin, errs, failed):
    """K17-K20 against their plain versions in float64 on the same inputs
    (problem, depth, normal, sel_prob, draws): K17 photometric and
    geometric, K19's weights, K20 along H and W, and for each of
    ``view_selection`` K18 on two states at both parities and K19's
    filter. K18's shares are taken over the pixels ``margin`` or more from
    the edges. Appends to errs and to failed."""
    import dataclasses

    from colmap_tpu_torch.kernels import mvs as KV
    from colmap_tpu_torch.kernels import mvs_cases as C
    from colmap_tpu_torch.mvs import patch_match as PM

    p, d, n, s, dr = inputs
    to64 = lambda x: x.double() if torch.is_tensor(x) else x  # noqa: E731
    p64 = type(p)(*(to64(x) for x in p))
    d64, n64, s64 = d.double(), n.double(), s.double()
    dr64 = type(dr)(*(x.double() for x in dr))
    H, W = d.shape
    region = (slice(margin, H - margin), slice(margin, W - margin))
    region_label = f"the pixels {margin} px or more from the edges" if margin else "the pixels"
    log(f"  {where}:")
    for geometric in (False, True):
        pg, pg64 = (p, p64) if geometric else (p._replace(src_depths=None),
                                               p64._replace(src_depths=None))
        got = KV.costs(pg, d, n, opts)
        ref = KV.costs_plain(pg64, d64, n64, opts)
        tie = C.cost_ties(pg64, d64, n64, opts, MVS_TIE_PX)
        tie |= C.geom_ties(pg64, d64, MVS_TIE_PX, MVS_DEPTH_STEP)
        a, r = rel_err(got[~tie], ref[~tie])
        log(f"    K17 {'geometric' if geometric else 'photometric'}: max_abs_err {a:.3e} rel "
            f"{r:.3e} (tol {K17_RTOL:g}) away from {int(tie.sum())} near-tie entries of "
            f"{tie.numel()}")
        if not (r <= K17_RTOL and tie.double().mean() < 0.25):
            failed.append(f"{where}: K17 {'geometric' if geometric else 'photometric'}")
        errs["pm_cost"].append((a, r))
    w = KV.view_weights(p, d, n, s, opts)
    a, r = rel_err(w, KV.view_weights_plain(p64, d64, n64, s64, opts))
    log(f"    K19 weights: max_abs_err {a:.3e} (tol {K1920_ATOL:g} absolute)")
    if not a <= K1920_ATOL:
        failed.append(f"{where}: K19 weights")
    errs["pm_view_weights"].append((a, r))
    ca64 = KV.costs_plain(p64, d64, n64, opts)
    for axis in (0, 1):
        got = KV.update_sel_prob(ca64.float(), s, axis, 0.4, opts)
        a, r = rel_err(got, KV.update_sel_prob_plain(ca64, s64, axis, 0.4, opts))
        log(f"    K20 along {'HW'[axis]} (chains of {d.shape[axis]}): max_abs_err {a:.3e} "
            f"(tol {K1920_ATOL:g} absolute)")
        if not a <= K1920_ATOL:
            failed.append(f"{where}: K20 axis {axis}")
        errs["pm_view_selection"].append((a, r))
    # K18 on two states: the first half-iteration's (random planes, as
    # patch_match starts) and the photometric pass's planes (converged:
    # many candidates are near-equal). The same plane as the plain version
    # at >= 99.9% of the region's pixels and at every pixel away from
    # near-ties; a plane as good (its float64 cost within the tie gap of
    # the plain version's choice) at >= 99.9%. The share that also counts a
    # plane of exactly the plain version's float64 cost is logged only.
    gen = torch.Generator(device="cuda")
    gen.manual_seed(7)
    start = PM.draw(gen, tuple(d.shape), opts, torch.float32, "cuda")
    states = {"initial": (start.depth, start.normal), "photometric": (d, n)}
    for vs in view_selection:
        o = dataclasses.replace(opts, view_selection=vs)
        for label, (sd, sn) in states.items():
            sd64, sn64 = sd.double(), sn.double()
            ca_s = KV.costs_plain(p64, sd64, sn64, o)
            ww = KV.view_weights_plain(p64, sd64, sn64, s64, o) if vs else None
            cost = KV.aggregate(ca_s, ww)
            for parity in (0, 1):
                got = KV.iteration(p, sd, sn, cost.float(), ca_s.float(),
                                   None if ww is None else ww.float(), dr, parity, 0.5, o)
                ref = KV.iteration_plain(p64, sd64, sn64, cost, ca_s, ww, dr64, parity, 0.5, o)
                ties = C.choice_ties(p64, sd64, sn64, cost, ww, dr64, parity, 0.5, o,
                                     MVS_TIE_PX, MVS_TIE_GAP, MVS_DEPTH_STEP)
                plane = (((got[0].double() - ref[0]).abs() <= 1e-5 * ref[0])
                         & ((got[1].double() - ref[1]).abs().amax(-1) <= 1e-4))
                k_cost = KV.aggregate(KV.costs_plain(p64, got[0].double(), got[1].double(), o),
                                      ww)
                same = plane | (k_cost == ref[2])
                as_good = same | ((k_cost - ref[2]).abs() <= MVS_TIE_GAP)
                agree = plane & ~ties
                a, r = rel_err(got[2][agree], ref[2][agree])
                plane_share = float(plane[region].double().mean())
                good_share = float(as_good[region].double().mean())
                log(f"    K18 {'weights' if vs else 'best half'}, {label} planes, parity "
                    f"{parity}: the same plane at {plane_share:.6f} of {region_label} (>= "
                    f"{K18_MIN_SAME}; all pixels {float(plane.double().mean()):.6f}; with "
                    f"planes of equal float64 cost {float(same[region].double().mean()):.6f}), "
                    f"the same plane at {float(plane[~ties].double().mean()):.6f} away from "
                    f"{int(ties.sum())} near-ties (all), as good a plane at {good_share:.6f} "
                    f"(>= {K18_MIN_SAME}); {int((ref[0] != sd64).sum())} planes moved; cost "
                    f"max_abs_err {a:.3e} rel {r:.3e}")
                if not (bool(plane[~ties].all()) and r <= K17_RTOL
                        and plane_share >= K18_MIN_SAME and good_share >= K18_MIN_SAME):
                    failed.append(f"{where}: K18 view_selection={vs} {label} parity {parity}")
                errs["pm_iteration"].append((a, r))
        df, nf, mask = KV.consistency_filter(p, d, n, ca64.float(), s, o)
        df64, nf64, mask64 = KV.consistency_filter_plain(p64, d64, n64, ca64, s64, o)
        ok = ~C.filter_ties(p64, d64, n64, ca64, s64, o, K1920_ATOL, MVS_TIE_PX, MVS_DEPTH_STEP,
                            MVS_GEOM_EPS)
        differ = int((mask[:, ok] != mask64[:, ok]).sum())
        log(f"    K19 filter ({'selection' if vs else 'costs'}): {differ} mask entries differ "
            f"away from {int((~ok).sum())} pixels within {K1920_ATOL:g} of a threshold; kept "
            f"{int(mask64.any(0).sum())} pixels")
        if differ or not torch.equal(df[ok], df64[ok].float()):
            failed.append(f"{where}: K19 filter view_selection={vs}")
    torch.cuda.synchronize()


def phase_mvs_kernels():
    """K17-K20 against their plain versions in float64 on the dense scene's
    first reference view: at full width, with the options the dense path
    runs (view selection on), and on a 640 x 480 crop in both aggregation
    modes, where the sources' crops put many window taps on borders; then
    timed at full width. Returns (errs, rows)."""
    from colmap_tpu_torch.kernels import mvs as KV

    errs = {k: [] for k in MVS_SOURCES}
    rows, failed = {}, []
    full, depth, normal, sel, draws, opts = _dense_problem()
    H, W = depth.shape
    Sv = full.src_images.shape[0]
    log(f"MVS kernels vs plain (float64 on the same inputs), the dense scene's first reference "
        f"view and its {Sv} source views, depth range [{opts.depth_min:.3f}, "
        f"{opts.depth_max:.3f}]:")
    t0 = time.perf_counter()
    _mvs_checks(f"full width, {W} x {H}", (full, depth, normal, sel, draws), opts, (True,), 0,
                errs, failed)
    log(f"    ({time.perf_counter() - t0:.1f} s)")
    crop = _crop(full, depth, normal, sel, draws, (W - MVS_CROP_W) // 2 - 200,
                 (H - MVS_CROP_H) // 2, MVS_CROP_W, MVS_CROP_H)
    _mvs_checks(f"a {MVS_CROP_W} x {MVS_CROP_H} crop", crop, opts, (True, False), 6, errs, failed)

    # Times at full width: the first reference view and its sources.
    HW = H * W
    taps = (2 * opts.window_radius // opts.window_step + 1) ** 2
    f4 = 4
    ca = KV.costs(full, depth, normal, opts)
    ww = KV.view_weights(full, depth, normal, sel, opts)
    cost = KV.aggregate(ca, ww)
    active = (HW + 1) // 2  # parity 0
    log(f"  times at full width ({W} x {H}, {Sv} source views, {taps} taps, geometric term):")
    rows["pm_cost"] = _mvs_row(
        "pm_cost", lambda: KV.costs(full, depth, normal, opts),
        lambda: KV.costs_plain(full, depth, normal, opts),
        f4 * HW * (1 + 2 * Sv + 4) + f4 * Sv * HW,
        HW * (taps * PM_TAP_OPS + pm_plane_ops(taps, Sv, True)))
    rows["pm_iteration"] = _mvs_row(
        "pm_iteration",
        lambda: KV.iteration(full, depth, normal, cost, ca, ww, draws, 0, 0.5, opts),
        lambda: KV.iteration_plain(full, depth, normal, cost, ca, ww, draws, 0, 0.5, opts),
        f4 * HW * (1 + 2 * Sv + 4 + 1 + 2 * Sv + 8) + f4 * HW * (5 + Sv),
        active * (taps * PM_TAP_OPS + PM_CAND_OPS
                  + 7 * (2 * Sv + 1 + pm_plane_ops(taps, Sv, True))))
    rows["pm_view_weights"] = _mvs_row(
        "pm_view_weights", lambda: KV.view_weights(full, depth, normal, sel, opts),
        lambda: KV.view_weights_plain(full, depth, normal, sel, opts),
        f4 * HW * (4 + 2 * Sv), HW * (PM_WEIGHT_PIXEL_OPS + Sv * PM_WEIGHT_VIEW_OPS))
    sel_rows = [_mvs_row(f"pm_view_selection along {'HW'[axis]}",
                         lambda a=axis: KV.update_sel_prob(ca, sel, a, 0.4, opts),
                         lambda a=axis: KV.update_sel_prob_plain(ca, sel, a, 0.4, opts),
                         f4 * 3 * Sv * HW, PM_SEL_OPS * Sv * HW) for axis in (0, 1)]
    rows["pm_view_selection"] = {k: (sel_rows[0][k] + sel_rows[1][k]) / 2
                                 if isinstance(sel_rows[0][k], float) else sel_rows[0][k]
                                 for k in sel_rows[0]}
    if failed:
        raise AssertionError(f"MVS kernels differ from their plain versions: {failed}")
    return errs, rows


def _mvs_row(name, fn, plain, bytes_moved, ops):
    ms = time_ms(fn, reps=10)
    plain_ms = time_ms(plain, reps=2)
    b_ms, by = bound(bytes_moved, ops)
    log(f"    {name}: {ms:.4f} ms (plain {plain_ms:.3f} ms, bound {b_ms:.5f} ms by {by})")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=by, library_ms=None)


def _as64(nt):
    """A NamedTuple of tensors with its float tensors in float64."""
    return type(nt)(*(x.double() if torch.is_tensor(x) and x.is_floating_point() else x
                      for x in nt))


def _timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _global_row(name, fn, plain, bytes_moved, ops, library=None, plain_reps=3):
    ms = time_ms(fn, reps=20)
    plain_ms = time_ms(plain, reps=plain_reps)
    library_ms = time_ms(library, reps=20) if library else None
    b_ms, by = bound(bytes_moved, ops)
    lib = f", library {library_ms:.4f} ms" if library else ""
    log(f"    {name}: {ms:.4f} ms (plain {plain_ms:.3f} ms{lib}, bound {b_ms:.5f} ms by {by})")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=by, library_ms=library_ms)


def _entry_times(fn, plain):
    return dict(ms=time_ms(fn, reps=20), plain_ms=time_ms(plain, reps=3))


def _k21(errs, rows):
    """K21's entries against float64 on the 1000-node graph, then timed;
    the whole estimate_rotations through the kernels and through the plain
    versions in float64."""
    from colmap_tpu_torch.estimators.rotation_averaging import estimate_rotations
    from colmap_tpu_torch.estimators.rotation_averaging import spanning_tree_init
    from colmap_tpu_torch.kernels import global_cases as C
    from colmap_tpu_torch.kernels import global_sfm as G

    t0 = time.perf_counter()
    rc = C.rotation_case(RA_NODES, RA_EDGES, seed=3)
    N, E = RA_NODES, len(rc.edges)
    init = spanning_tree_init(N, rc.edges, rc.rel_quats, np.ones(E))
    free = np.ones(N)
    free[0] = 0.0
    g_world = np.array([0.0, 1.0, 0.0])
    proj = np.tile(np.eye(3), (N, 1, 1))
    proj[::2] = np.outer(g_world, g_world)
    dev = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32, device="cuda")  # noqa: E731
    edges = torch.as_tensor(rc.edges, device="cuda")
    q = dev(init)
    rng = np.random.default_rng(5)
    sigma = float(np.deg2rad(5.0))
    log(f"  K21 on {N} nodes, {E} edges ({int(rc.outliers.sum())} replaced by random rotations) "
        f"(set-up {time.perf_counter() - t0:.1f} s):")
    # Two states: random rotations (every residual far from zero) and the
    # spanning tree's (the solve's start: its N - 1 tree edges have zero
    # residual). Under L1 weights an edge with |r| < 1e-5 weighs 1e5, and
    # the float32 residual of two float32 quaternions that agree is rounding
    # (about 1e-7 rad), so there the weighted residual differs from float64
    # by about 1e-2 whatever the arithmetic: that case is logged, and the
    # whole solves below show its effect.
    q_rand = dev(C.random_quats(rng, N))
    for P in (None, proj):
        g32 = G.ra_graph(N, edges, dev(rc.rel_quats), dev(free), None if P is None else dev(P))
        g64 = _as64(g32)
        for use_l1, state, qs in ((True, "random", q_rand), (False, "random", q_rand),
                                  (False, "spanning-tree", q), (True, "spanning-tree", q)):
            tag = (f"K21 {'L1' if use_l1 else 'Geman-McClure'}, {state} rotations, "
                   f"{'gravity projectors' if P is not None else 'no projectors'}")
            st = G.ra_edge_pass(g32, qs, use_l1, sigma)
            ref = G.ra_edge_pass_plain(g64, qs.double(), use_l1, sigma)
            if use_l1 and state == "spanning-tree":
                small = int((ref.ew[:, 3] >= 1e5 * (1 - 1e-6)).sum())
                log(f"    {tag}: {small} edges at the L1 weight's clamp; edge pass errors " + ", ".join(
                    f"{f} {rel_err(getattr(st, f), getattr(ref, f))[1]:.2e}" for f in G.RAStep._fields)
                    + " (logged)")
                continue
            for f in G.RAStep._fields:
                check(f"{tag}, edge pass {f}", getattr(st, f), getattr(ref, f), K21_RTOL,
                      errs["rotation_averaging"])
            x = dev(rng.standard_normal((N, 3)))
            check(f"{tag}, matvec", G.ra_matvec(g32, st.ew, x),
                  G.ra_matvec_plain(g64, st.ew.double(), x.double()), K21_RTOL,
                  errs["rotation_averaging"])
    delta = dev(0.05 * rng.standard_normal((N, 3)))
    check("K21 node update", G.ra_update(q, delta), G.ra_update_plain(q.double(), delta.double()),
          K21_RTOL, errs["rotation_averaging"])

    # Times: the Geman-McClure edge pass, the matvec (each CG iteration's)
    # and the update, without projectors.
    g32 = G.ra_graph(N, edges, dev(rc.rel_quats), dev(free))
    g64 = _as64(g32)
    st = G.ra_edge_pass(g32, q, False, sigma)
    x = dev(rng.standard_normal((N, 3)))
    e, w = edges.long(), st.ew[:, 3]
    ar = torch.arange(N, device="cuda")
    L = torch.sparse_coo_tensor(
        torch.cat([torch.stack([e[:, 0], e[:, 1]]), torch.stack([e[:, 1], e[:, 0]]),
                   torch.stack([ar, ar])], 1),
        torch.cat([-w, -w, st.deg]), (N, N)).coalesce().to_sparse_csr()
    lap = torch.sparse.mm(L, x) * g32.free[:, None]
    a, r = rel_err(lap, G.ra_matvec(g32, st.ew, x))
    log(f"    torch.sparse.mm on the assembled weighted Laplacian (CSR) agrees with K21 (b) to "
        f"{r:.2e} of its largest entry")
    rows["rotation_averaging"] = _global_row(
        "K21 (b) Laplacian matvec", lambda: G.ra_matvec(g32, st.ew, x),
        lambda: G.ra_matvec_plain(g64, st.ew.double(), x.double()),
        4 * (3 * N + E + 2 * E + N + 3 * N), RA_EDGE_OPS * E + RA_NODE_OPS * N,
        library=lambda: torch.sparse.mm(L, x))
    rows["rotation_averaging"]["entries"] = {
        "edge_pass": _entry_times(lambda: G.ra_edge_pass(g32, q, False, sigma),
                                  lambda: G.ra_edge_pass_plain(g64, q.double(), False, sigma)),
        "update": _entry_times(lambda: G.ra_update(q, delta),
                               lambda: G.ra_update_plain(q.double(), delta.double())),
    }
    log(f"    K21 (a) edge pass, (c) update: {rows['rotation_averaging']['entries']}")

    # Whole solves.
    out = {}
    for label, kw in (("kernels", {}), ("plain float64", dict(dtype=torch.float64,
                                                                kernels=G.PLAIN))):
        stats = {}
        G.reset_launches()
        est, wall = _timed(lambda: estimate_rotations(N, rc.edges, rc.rel_quats, device="cuda",
                                                      stats=stats, **kw))
        errd = C.rotation_errors_deg(est, rc.gt)
        out[label] = dict(median_deg=float(np.median(errd)), max_deg=float(errd.max()),
                          seconds=wall, launches=G.LAUNCHES["rotation_averaging"], **stats)
        log(f"  estimate_rotations through the {label}: rotation error against the truth median "
            f"{out[label]['median_deg']:.4e} deg, max {out[label]['max_deg']:.4e} deg; "
            f"{stats['l1_iterations']} L1 + {stats['irls_iterations']} IRLS iterations, "
            f"{wall:.3f} s, {out[label]['launches']} K21 launches")
    k, p = out["kernels"], out["plain float64"]
    if not (k["median_deg"] <= RA_SOLVE_FACTOR * p["median_deg"] + RA_SOLVE_DEG
            and k["max_deg"] <= RA_SOLVE_FACTOR * p["max_deg"] + RA_SOLVE_DEG):
        raise AssertionError(f"estimate_rotations: kernels {k} against plain {p}")
    return out



def _k22(errs, rows):
    """K22's entries against float64 on 1000 cameras x 200k points x 1.2M
    observations, at the solve's first state and at its last, then timed;
    the whole solve_global_positioning through both."""
    from colmap_tpu_torch.estimators.global_positioning import solve_global_positioning
    from colmap_tpu_torch.kernels import global_cases as C
    from colmap_tpu_torch.kernels import global_sfm as G

    t0 = time.perf_counter()
    pc = C.positioning_case(GP_CAMS, GP_POINTS, GP_TRACK, seed=3)
    Cn, Pn, O = GP_CAMS, GP_POINTS, len(pc.obs_cam)
    scale = float(np.sqrt(((pc.centers - pc.centers.mean(0)) ** 2).sum(1).mean()))
    log(f"  K22 on {Cn} cameras x {Pn} points x {O} observations, 1e-3 rad of bearing noise, "
        f"scene scale {scale:.3f} (set-up {time.perf_counter() - t0:.1f} s):")
    out, final = {}, {}
    for label, kw in (("kernels", {}), ("plain float64", dict(dtype=torch.float64,
                                                                kernels=G.PLAIN))):
        stats = {}
        G.reset_launches()
        (c, X), wall = _timed(lambda: solve_global_positioning(
            Cn, Pn, pc.obs_cam, pc.obs_point, pc.dirs, device="cuda", stats=stats, **kw))
        final[label] = (c, X)
        err = np.linalg.norm(C.similarity_aligned(c, pc.centers) - pc.centers, axis=1)
        out[label] = dict(median_center=float(np.median(err)) / scale,
                          max_center=float(err.max()) / scale, seconds=wall,
                          launches=G.LAUNCHES["global_positioning"], **stats)
        log(f"  solve_global_positioning through the {label}: aligned centre error against the "
            f"truth median {out[label]['median_center']:.4e}, max {out[label]['max_center']:.4e} "
            f"of the scene scale; {stats['irls_iterations']} IRLS rounds, {wall:.3f} s, "
            f"{out[label]['launches']} K22 launches")
    k, p = out["kernels"], out["plain float64"]
    if not k["max_center"] <= GP_SOLVE_FACTOR * p["max_center"] + GP_SOLVE_SCALE:
        raise AssertionError(f"solve_global_positioning: kernels {k} against plain {p}")

    dev = lambda a, dt=torch.float32: torch.as_tensor(np.asarray(a), dtype=dt, device="cuda")  # noqa: E731
    counts = np.bincount(pc.obs_cam, minlength=Cn)
    anchor = int(np.nonzero(pc.obs_cam == int(np.argmax(counts)))[0][0])
    p32 = G.gp_problem(dev(pc.dirs), dev(pc.obs_cam, torch.int32), dev(pc.obs_point, torch.int32),
                       dev(np.ones(O)), anchor, 100.0, Cn, Pn, 0.1)
    p64 = _as64(p32)
    rng = np.random.default_rng(0)
    states = {"the first round's": (rng.standard_normal((Cn, 3)), rng.standard_normal((Pn, 3))),
              "the last round's": final["kernels"]}
    for label, (c, X) in states.items():
        c32, X32 = dev(c), dev(X)
        sys = G.gp_setup(p32, c32, X32)
        ref = G.gp_setup_plain(p64, c32.double(), X32.double())
        scales = _gp_term_scales(p64, ref, c32.double(), X32.double())
        for f in G.GPSystem._fields:
            if f in scales:
                # g_x and b vanish at the optimum: their float32 error is held
                # against float32's resolution of the terms they sum.
                a, r = rel_err(getattr(sys, f), getattr(ref, f))
                r_terms = a / scales[f]
                log(f"  K22 at {label} state, setup {f}: max_abs_err {a:.3e} rel {r:.3e}, "
                    f"{r_terms:.3e} of its terms' scale (tol {K22_RTOL:g})")
                if not r_terms <= K22_RTOL:
                    raise AssertionError(f"K22 setup {f}: {r_terms:.3e} > {K22_RTOL:g}")
                errs["global_positioning"].append((a, r_terms))
                continue
            check(f"K22 at {label} state, setup {f}", getattr(sys, f), getattr(ref, f), K22_RTOL,
                  errs["global_positioning"])
        sys64 = _as64(sys)
        check(f"K22 at {label} state, Schur matvec", G.gp_schur_matvec(p32, sys, sys.b),
              G.gp_schur_matvec_plain(p64, sys64, sys.b.double()), K22_RTOL,
              errs["global_positioning"])
        xc = 0.01 * sys.b / sys.b.abs().max()
        got = G.gp_back_substitute(p32, sys, xc, c32, X32)
        want = G.gp_back_substitute_plain(p64, sys64, xc.double(), c32.double(), X32.double())
        check(f"K22 at {label} state, back-substitution point steps", got[1] - X32,
              want[1] - X32.double(), K22_RTOL, errs["global_positioning"])
    c32, X32 = (dev(a) for a in states["the first round's"])
    sys = G.gp_setup(p32, c32, X32)
    sys64 = _as64(sys)
    rows["global_positioning"] = _global_row(
        "K22 (b) Schur matvec", lambda: G.gp_schur_matvec(p32, sys, sys.b),
        lambda: G.gp_schur_matvec_plain(p64, sys64, sys.b.double()),
        4 * (3 * O + 2 * O + O + 9 * Pn + 9 * Cn + 3 * Cn + 3 * Cn),
        GP_OBS_OPS * O + GP_POINT_OPS * Pn + GP_CAM_OPS * Cn)
    rows["global_positioning"]["entries"] = {
        "setup": _entry_times(lambda: G.gp_setup(p32, c32, X32),
                              lambda: G.gp_setup_plain(p64, c32.double(), X32.double())),
        "back_substitute": _entry_times(
            lambda: G.gp_back_substitute(p32, sys, sys.b, c32, X32),
            lambda: G.gp_back_substitute_plain(p64, sys64, sys64.b, c32.double(), X32.double())),
    }
    log(f"    K22 (a) setup, (c) back-substitution: {rows['global_positioning']['entries']}")
    return out


def _gp_term_scales(prob, sys, centers, points):
    """float32's resolution of g_x and b, which vanish at the optimum: the
    largest per-point sum of w |X_p - c_i| (each residual is the projection
    of that difference, so float32 resolves it to about 1e-7 of it) and the
    largest per-camera sum of w (|X_p - c_i| + |y0_p|), float64."""
    oc, op = prob.obs_cam.long(), prob.obs_point.long()
    w = sys.w[:, None]
    diff = w * (points[op] - centers[oc]).norm(dim=-1, keepdim=True)
    y0 = (sys.Hpp_inv @ sys.g_x[..., None])[..., 0]
    gx = torch.zeros(points.shape[0], 1, dtype=w.dtype, device=w.device).index_add_(0, op, diff)
    b = torch.zeros(centers.shape[0], 1, dtype=w.dtype, device=w.device).index_add_(
        0, oc, diff + w * y0[op].norm(dim=-1, keepdim=True))
    return {"g_x": float(gx.max()), "b": float(b.max())}


def _k23(errs, rows):
    """K23 against float64 autograd on 50 cameras and 2000 F edges at the
    priors and near the optimum, then timed; calibrate_view_graph through
    both."""
    from colmap_tpu_torch.estimators.view_graph_calibration import calibrate_view_graph
    from colmap_tpu_torch.kernels import global_cases as C
    from colmap_tpu_torch.kernels import global_sfm as G

    vc = C.calibration_case(VGC_CAMS, VGC_EDGES, seed=3)
    n, E = VGC_CAMS, VGC_EDGES
    graph = G.vgc_graph(*(torch.as_tensor(a, device="cuda")
                          for a in (vc.Fs, vc.e1, vc.e2, vc.priors, vc.pps)))
    log(f"  K23 on {n} cameras and {E} F edges, priors up to 25% off:")
    rng = np.random.default_rng(1)
    for label, x in (("at the priors", np.zeros(n)),
                     ("near the optimum", np.log(vc.true_focals / vc.priors)
                      + 1e-3 * rng.standard_normal(n))):
        x32 = torch.as_tensor(x, dtype=torch.float32, device="cuda")
        loss, grad = G.vgc_loss_grad(graph, x32)
        x64 = x32.double().requires_grad_()
        ref = G.vgc_loss_plain(graph, x64)
        (ref_g,) = torch.autograd.grad(ref, x64)
        check(f"K23 {label}, loss", loss, ref.detach(), K23_LOSS_RTOL,
              errs["view_graph_calibration"])
        near = C.calibration_near_ties(graph, x32, K23_TIE_GAP)
        check(f"K23 {label}, gradient away from {int(near.sum())} cameras on near-degenerate "
              f"edges", grad[~near], ref_g[~near], K23_GRAD_RTOL, errs["view_graph_calibration"])
    x32 = torch.zeros(n, device="cuda")

    def plain():
        x64 = x32.double().requires_grad_()
        return torch.autograd.grad(G.vgc_loss_plain(graph, x64), x64)

    rows["view_graph_calibration"] = _global_row(
        "K23 loss and gradient", lambda: G.vgc_loss_grad(graph, x32), plain,
        E * (72 + 8) + n * (8 + 16 + 4 + 4) + 4, VGC_EDGE_OPS * E + 2 * E)
    ids = list(range(n))
    args = (ids, dict(enumerate(vc.priors)), dict(enumerate(map(tuple, vc.pps))),
            [(int(a), int(b), F) for a, b, F in zip(vc.e1, vc.e2, vc.Fs)])
    out, focals = {}, {}
    for label, kw in (("kernels", {}), ("plain float64", dict(dtype=torch.float64,
                                                                kernels=G.PLAIN))):
        G.reset_launches()
        focals[label], wall = _timed(lambda: calibrate_view_graph(*args, device="cuda", **kw))
        f = np.array([focals[label][i] for i in ids])
        rel = np.abs(f - vc.true_focals) / vc.true_focals
        out[label] = dict(median_rel=float(np.median(rel)), max_rel=float(rel.max()), seconds=wall,
                          launches=G.LAUNCHES["view_graph_calibration"])
        log(f"  calibrate_view_graph through the {label}: focal error against the truth median "
            f"{out[label]['median_rel']:.4e}, max {out[label]['max_rel']:.4e} (relative); "
            f"200 Adam steps, {wall:.3f} s, {out[label]['launches']} K23 launches")
    diff = max(abs(focals["kernels"][i] - focals["plain float64"][i]) / focals["plain float64"][i]
               for i in ids)
    out["kernels_vs_plain_rel"] = diff
    log(f"  calibrate_view_graph: kernel-path focals within {diff:.3e} of the plain path's "
        f"(<= {VGC_SOLVE_RTOL})")
    if not diff <= VGC_SOLVE_RTOL:
        raise AssertionError(f"calibrate_view_graph: focals {diff} apart")
    return out


def phase_global_kernels():
    """K21-K23 against their float64 plain versions on the same inputs at
    the scale global SfM users run, timed with CUDA events beside their
    plain versions; then the three solvers through the kernels and through
    the plain versions in float64 on the card. Returns (errs, rows, solves)."""
    errs = {k: [] for k in GLOBAL_SOURCES}
    rows = {}
    log("global-SfM kernels vs plain (float64 on the same inputs):")
    solves = dict(rotations=_k21(errs, rows), positioning=_k22(errs, rows),
                  calibration=_k23(errs, rows))
    torch.cuda.synchronize()
    return errs, rows, solves


GLOBAL_MAPPER_KERNELS = ("rotation_averaging", "global_positioning", "camera_map",
                         "ba_obs_jacobians", "ba_lm_reduce", "ba_schur_matvec")


def _profiled_command(argv, label, kernels, launches):
    """run_command under torch.profiler; adds the launches to ``launches``
    and logs the device's idle share and its top items."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.zeros(1, device="cuda").add_(1.0)  # let the tracer see a first kernel
        torch.cuda.synchronize()
        out, seconds, counts = run_command(argv, label, kernels)
    for k, v in counts.items():
        launches[k] += v
    busy_ms, by_name = device_busy(prof)
    idle = log_busy(label, busy_ms, by_name, seconds * 1e3, top=8)
    return out, seconds, idle


def phase_global(launches):
    """The global-SfM commands on cuda, each under torch.profiler:
    `global_mapper` on the verify, full-size and gravity-prior scenes
    (relative poses decomposed from E), `rotation_averager` on the verify
    scene and `view_graph_calibrator` on a database of UNCALIBRATED pairs;
    each held to its gates."""
    from colmap_tpu_torch.kernels import global_cases as C
    from colmap_tpu_torch.scene.reconstruction_io import read_model

    results = {}
    with tempfile.TemporaryDirectory() as tmp:
        scenes = (
            ("verify scene", 8, dict(num_points=120, focal=1280.0, seed=3),
             MAX_ROT_DEG, MAX_CENTER),
            ("full-size scene", FULL_FRAMES, dict(num_points=1000, focal=FULL_FOCAL, seed=3),
             MAX_ROT_DEG, MAX_CENTER),
            ("gravity-prior scene", 8, dict(num_points=120, seed=11, prior_gravity=True,
                                            num_points2D_without_point3D=5),
             GRAVITY_MAX_ROT_DEG, GRAVITY_MAX_CENTER),
        )
        for label, frames, kw, max_rot, max_ctr in scenes:
            root = os.path.join(tmp, label.split()[0])
            os.makedirs(root)
            t0 = time.perf_counter()
            kw = dict(kw)
            db_path, gt = make_scene(root, frames, kw.pop("num_points"),
                                     two_view_geometry_has_relative_pose=False, **kw)
            log(f"global_mapper, {label}: {frames} frames (set-up {time.perf_counter() - t0:.1f} s)")
            out = os.path.join(root, "sparse")
            pipeline, seconds, idle = _profiled_command(
                ["global_mapper", "--database_path", db_path, "--output_path", out, "--quiet"],
                f"global_mapper, {label}", GLOBAL_MAPPER_KERNELS, launches)
            cmp = check_against_gt(out, gt, frames, f"global_mapper, {label}", max_rot, max_ctr)
            phases = {k: (round(pipeline.timer.seconds[k], 3), pipeline.timer.calls[k])
                      for k in sorted(pipeline.timer.seconds, key=pipeline.timer.seconds.get,
                                      reverse=True)}
            log("  time by phase (s, calls): " + ", ".join(
                f"{k} {v[0]:.3f}/{v[1]}" for k, v in phases.items()))
            results[label] = dict(seconds=seconds, idle=idle, phases=phases,
                                  max_rot_deg=cmp["max_rotation_error_deg"],
                                  max_center=cmp["max_center_error"])
            if label == "verify scene":
                ra_out = os.path.join(root, "rotations")
                recon, seconds, idle = _profiled_command(
                    ["rotation_averager", "--database_path", db_path, "--output_path", ra_out],
                    "rotation_averager, verify scene", ("rotation_averaging",), launches)
                recon = read_model(ra_out)
                iids = sorted(recon.reg_image_ids())
                worst = 0.0
                for iid in iids[1:]:
                    R = recon.cam_from_world(iid).rotmat() @ recon.cam_from_world(iids[0]).rotmat().T
                    R_gt = gt.cam_from_world(iid).rotmat() @ gt.cam_from_world(iids[0]).rotmat().T
                    cos = (np.trace(R @ R_gt.T) - 1.0) / 2.0
                    worst = max(worst, float(np.degrees(np.arccos(np.clip(cos, -1, 1)))))
                log(f"  rotation_averager: {len(iids)}/{frames} frames, max rotation error "
                    f"against the truth {worst:.3e} deg (<= {RA_CLI_MAX_DEG})")
                if not (len(iids) == frames and worst <= RA_CLI_MAX_DEG):
                    raise AssertionError("rotation_averager: outside its gate")
                results["rotation_averager"] = dict(seconds=seconds, idle=idle, max_deg=worst)
        path = os.path.join(tmp, "calibrator.db")
        true_focals = C.write_calibrator_database(path)
        focals, seconds, idle = _profiled_command(
            ["view_graph_calibrator", "--database_path", path],
            "view_graph_calibrator, two cameras 25% off", ("view_graph_calibration",), launches)
        rel = {cid: abs(focals[cid] - f) / f for cid, f in true_focals.items()}
        log(f"  view_graph_calibrator: focals {focals} against the truth {true_focals}: relative "
            f"errors {rel} (<= {VGC_CLI_RTOL})")
        if not max(rel.values()) <= VGC_CLI_RTOL:
            raise AssertionError("view_graph_calibrator: outside its gate")
        results["view_graph_calibrator"] = dict(seconds=seconds, idle=idle, rel=rel)
    return results


def _rig_compare(problem, model_id, options, masks, errs, label):
    """K24-K26 against their float64 plain versions on one rig problem (the
    plain versions evaluated in float64 on the kernels' float32 inputs);
    K25 and K26 give the same bits in two runs. Returns the inputs and
    outputs for timing."""
    from colmap_tpu_torch.estimators import bundle_adjustment_rig as rba
    from colmap_tpu_torch.kernels import rig as KR

    log(f"rig kernels vs plain: {label}")
    om, obs, layout = rba._obs_masks(masks, options), rba._obs(problem), rba._layout(problem)
    params = tuple(problem[:6])
    rest = (model_id, options.loss, options.loss_scale)
    obs64 = type(obs)(*f64(*obs))
    jac = KR.rig_obs_jacobians(*params, obs, *om, *rest)
    jac_p = KR.rig_obs_jacobians_plain(*f64(*params), obs64, *f64(*om), *rest)
    for n, a, b in zip(KR.RigJacobians._fields, jac, jac_p):
        check(f"K24 {n}", a, b, K24_RTOL, errs["rig_ba_jacobians"])
    check("K24 cost", KR.rig_obs_cost(*params, obs, *rest),
          KR.rig_obs_cost_plain(*f64(*params), obs64, *rest), K24_RTOL, errs["rig_ba_jacobians"])
    lam = 1e-3
    jac64 = KR.RigJacobians(*f64(*jac))
    red = KR.rig_lm_reduce(jac, obs, layout, lam)
    red_p = KR.rig_lm_reduce_plain(jac64, obs, layout, lam)
    for n, a, b in zip(red._fields, red, red_p):
        check(f"K25 {n}", a, b, K2526_RTOL, errs["rig_ba_reduce"])
    if not all(torch.equal(a, b) for a, b in zip(red, KR.rig_lm_reduce(jac, obs, layout, lam))):
        raise AssertionError(f"{label}: K25 differs between two runs")
    F, G = layout.num_frames, layout.num_sensors
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(red.g.shape, device="cuda", generator=g) * (red.diag != 0)
    x[F + G:] *= 1e-3  # camera parameters: steps of their scale
    red64 = KR.RigReduction(*f64(*red))
    mv = KR.rig_schur_matvec(jac, obs, layout, red.Hpp_inv, red.lam_diag, x)
    check("K26 matvec", mv, KR.rig_schur_matvec_plain(jac64, obs, layout, red64.Hpp_inv,
                                                      red64.lam_diag, x.double()),
          K2526_RTOL, errs["rig_ba_matvec"])
    if not torch.equal(mv, KR.rig_schur_matvec(jac, obs, layout, red.Hpp_inv, red.lam_diag, x)):
        raise AssertionError(f"{label}: K26 differs between two runs")
    check("K26 dx", KR.rig_back_substitute(jac, obs, layout, red.Hpp_inv, red.gx, x),
          KR.rig_back_substitute_plain(jac64, obs, layout, red64.Hpp_inv, red64.gx, x.double()),
          K2526_RTOL, errs["rig_ba_matvec"])
    return dict(params=params, obs=obs, om=om, rest=rest, layout=layout, jac=jac, red=red, x=x,
                lam=lam)


def _rig_small_cases(errs):
    """Models 0-4 at a small size: a constant frame, the reference sensor
    held constant, and (model 2) a sensor and a camera row that no
    observation uses."""
    from colmap_tpu_torch.estimators import bundle_adjustment as ba
    from colmap_tpu_torch.estimators import bundle_adjustment_rig as rba
    from colmap_tpu_torch.kernels import rig_cases as RC

    for model_id in range(5):
        p, _, _ = RC.rig_ba_problem(12, 3, 2000, 5, model_id=model_id, seed=10 + model_id,
                                    device="cuda")
        if model_id == 2:
            p = RC.with_empty_sensor(p)
        opts = ba.BAOptions(loss="cauchy", refine_principal_point=True)
        masks = rba.fix_gauge_two_frames(rba.default_masks(p, model_id, opts, const_frames=[3]),
                                         0, 1)
        _rig_compare(p, model_id, opts, masks, errs,
                     f"model {model_id}, 12 frames x 3 sensors x 2000 points"
                     + (", an empty sensor row" if model_id == 2 else ""))


def _k27(errs, agree):
    """K27 on batches of injected samples against its float64 plain version
    on the same (float32) inputs: every count within its near rows, the same
    best sample or a near-tie decided from the float64 arithmetic, the
    all-inlier models to K27_RTOL, the inlier mask of the best model equal
    off the near rows. Returns the timing inputs."""
    from colmap_tpu_torch.kernels import rig as KR
    from colmap_tpu_torch.kernels import rig_cases as RC
    from colmap_tpu_torch.optim.ransac import unpack_best

    max_sq = 12.0 ** 2
    same = total = ties = 0
    for seed, scale in ((31, 1.0), (32, 0.37)):
        case, _, inl = RC.gen_abs_case(GEN_ABS_ROWS, seed=seed, world_scale=scale, device="cuda")
        data = KR.GenAbsData(*(t.float() if t.is_floating_point() else t for t in case))
        data64 = KR.GenAbsData(*f64(*data))
        samples = RC.injected_samples(GEN_ABS_ROWS, GEN_ABS_SAMPLES, seed, inl, device="cuda")
        near_max = 0
        for b0 in range(0, GEN_ABS_SAMPLES, GEN_ABS_BATCH):
            sb = samples[b0:b0 + GEN_ABS_BATCH]
            m, c, best = KR.gen_abs_propose_score(data, sb, max_sq, True)
            m64, c64, best64 = KR.gen_abs_propose_score_plain(data64, sb, max_sq, True)
            count_ok, best_ok, near, tie = RC.ransac_agreement(
                c, unpack_best(int(best[0])), m64, c64, unpack_best(int(best64[0])), data64,
                max_sq, GEN_ABS_MARGIN)
            if not (count_ok and best_ok):
                raise AssertionError(f"K27 batch {b0 // GEN_ABS_BATCH} (scale {scale}): counts "
                                     f"agree {count_ok}, best agrees {best_ok}")
            full = c64 >= 0.9 * c64.max()
            a, r = rel_err(m[full], m64[full])
            if not r <= K27_RTOL:
                raise AssertionError(f"K27 models: relative error {r:.3e} > {K27_RTOL}")
            errs["gen_abs_ransac"].append((a, r))
            total += 1
            ties += int(tie)
            same += int(not tie)
            near_max = max(near_max, near)
        idx = unpack_best(int(best64[0]))[1]
        inl_k = KR.gen_abs_inliers(data, m64[idx].float(), max_sq)
        res = KR.gen_abs_residuals(m64[idx][None], data64)[0]
        far = (res - max_sq).abs() > GEN_ABS_MARGIN * max_sq
        if not torch.equal(inl_k[far], (res <= max_sq)[far]):
            raise AssertionError("K27 inlier mask differs off the near rows")
        log(f"  K27, world scale {scale}: {GEN_ABS_SAMPLES} samples x {GEN_ABS_ROWS} rows, "
            f"at most {near_max} near rows a model; best model of each batch: the float64 "
            f"one or a near-tie; max model error {max(e[1] for e in errs['gen_abs_ransac']):.3e}")
    log(f"  K27: {same} of {total} batches pick the float64 best sample, {ties} a near-tie")
    agree["gen_abs_ransac"] = (same, total)
    return data, samples[:GEN_ABS_BATCH], max_sq


def _rig_rows(ctx, k27):
    """ms, plain_ms, bound_ms, bound_by of K24-K27 at the headline shapes
    (K27: a batch of 64 samples on 2000 rows)."""
    from colmap_tpu_torch.kernels import rig as KR

    params, obs, om, rest, layout = (ctx[k] for k in ("params", "obs", "om", "rest", "layout"))
    jac, red, x, lam = ctx["jac"], ctx["red"], ctx["x"], ctx["lam"]
    O, N = jac.r.shape[0], layout.num_points
    P = jac.Jc.shape[-1]
    lay = nbytes(*layout[:7])
    ids = nbytes(*obs[:4])
    jac_bytes = nbytes(*jac)
    rows = {}
    log("rig kernel times at the headline shapes (median of CUDA-event-timed launches):")
    rows["rig_ba_jacobians"] = _global_row(
        "rig_ba_jacobians", lambda: KR.rig_obs_jacobians(*params, obs, *om, *rest),
        lambda: KR.rig_obs_jacobians_plain(*params, obs, *om, *rest),
        nbytes(*params, *obs, *om) + jac_bytes, O * RIG_K24_OBS_OPS)
    rows["rig_ba_reduce"] = _global_row(
        "rig_ba_reduce", lambda: KR.rig_lm_reduce(jac, obs, layout, lam),
        lambda: KR.rig_lm_reduce_plain(jac, obs, layout, lam),
        jac_bytes + ids + lay + nbytes(*red), O * RIG_K25_OBS_OPS + N * RIG_K25_POINT_OPS)
    rows["rig_ba_matvec"] = _global_row(
        "rig_ba_matvec",
        lambda: KR.rig_schur_matvec(jac, obs, layout, red.Hpp_inv, red.lam_diag, x),
        lambda: KR.rig_schur_matvec_plain(jac, obs, layout, red.Hpp_inv, red.lam_diag, x),
        nbytes(jac.Jf, jac.Js, jac.Jc, jac.Jx, red.Hpp_inv, red.lam_diag, x) + ids + lay
        + nbytes(x), O * RIG_K26_OBS_OPS + N * RIG_K26_POINT_OPS)
    data, samples, max_sq = k27
    K, n = samples.shape[0], data.X.shape[0]
    rows["gen_abs_ransac"] = _global_row(
        "gen_abs_ransac", lambda: KR.gen_abs_propose_score(data, samples, max_sq, True),
        lambda: KR.gen_abs_propose_score_plain(data, samples, max_sq, True),
        nbytes(data.X, data.uv, data.cam_q, data.cam_t, data.focal, data.mask, samples)
        + K * (15 * 4 + 4) + 8, K * (GDLT_OPS + n * GEN_ABS_ROW_OPS))
    rows["rig_ba_matvec"]["entries"] = {"back_substitute": _entry_times(
        lambda: KR.rig_back_substitute(jac, obs, layout, red.Hpp_inv, red.gx, x),
        lambda: KR.rig_back_substitute_plain(jac, obs, layout, red.Hpp_inv, red.gx, x))}
    rows["rig_ba_jacobians"]["entries"] = {"cost": _entry_times(
        lambda: KR.rig_obs_cost(*params, obs, *rest),
        lambda: KR.rig_obs_cost_plain(*params, obs, *rest))}
    rows["gen_abs_ransac"]["entries"] = {"inliers": _entry_times(
        lambda: KR.gen_abs_inliers(data, torch.eye(3, 5, device="cuda"), max_sq),
        lambda: KR.gen_abs_inliers_plain(data, torch.eye(3, 5, device="cuda"), max_sq))}
    return rows


def _sensor_errors(solved, gt):
    """Largest sensor_from_rig errors against the truth: (units, deg)."""
    from colmap_tpu_torch.geometry import rotation as rot

    dt = (solved.sensor_t.double() - gt.sensor_t.double()).norm(dim=-1).max().item()
    ang = rot.quat_angle(solved.sensor_quat.double(), gt.sensor_quat.double())
    return dt, math.degrees(ang.max().item())


def phase_rig_kernels():
    """K24-K27 against their float64 plain versions on the card (the rig BA
    headline, models 0-4 at a small size, K27 on injected samples), timed
    beside their plain versions; then 10 LM iterations of the rig solve on
    the headline through the kernels and through the float64 plain versions.
    Returns (errs, rows, agree)."""
    from colmap_tpu_torch.estimators import bundle_adjustment as ba
    from colmap_tpu_torch.estimators import bundle_adjustment_rig as rba
    from colmap_tpu_torch.kernels import rig as KR
    from colmap_tpu_torch.kernels import rig_cases as RC

    errs = {k: [] for k in RIG_SOURCES}
    agree = {}
    t0 = time.perf_counter()
    problem, gt, model_id = RC.rig_ba_problem(RIG_FRAMES, RIG_SENSORS, RIG_POINTS, RIG_TRACK,
                                              seed=0, device="cuda")
    # Frames 0 and 1 at the truth: the gauge (frame 0, frame 1's x) is the
    # truth's, so the solve can be held to the true sensor_from_rig.
    problem = problem._replace(quat=torch.cat([gt.quat[:2], problem.quat[2:]]),
                               t=torch.cat([gt.t[:2], problem.t[2:]]))
    options = ba.BAOptions(max_iterations=10, pcg_iterations=20, loss="cauchy",
                           function_tolerance=0.0)
    masks = rba.fix_gauge_two_frames(rba.default_masks(problem, model_id, options), 0, 1)
    log(f"rig headline: F={RIG_FRAMES} G={RIG_SENSORS} N={RIG_POINTS} "
        f"O={problem.obs_xy.shape[0]}, sensors free, Cauchy (set-up "
        f"{time.perf_counter() - t0:.1f} s)")
    ctx = _rig_compare(problem, model_id, options, masks, errs, "rig headline")
    _rig_small_cases(errs)
    log("K27 vs plain (float64 on the same inputs), injected samples:")
    k27 = _k27(errs, agree)
    rows = _rig_rows(ctx, k27)

    KR.reset_launches()
    (solved, cost, iters), seconds = _timed(lambda: rba._lm_loop(problem, model_id, options,
                                                                   masks))
    launches = dict(KR.LAUNCHES)
    p64, m64 = type(problem)(*f64(*problem)), type(masks)(*f64(*masks))
    (solved64, cost64, _), seconds64 = _timed(lambda: rba._lm_loop(p64, model_id, options, m64,
                                                                     kernels=KR.PLAIN))
    rel = abs(cost - cost64) / cost64
    st, sdeg = _sensor_errors(solved, gt)
    st64, sdeg64 = _sensor_errors(solved64, gt)
    init_t, init_deg = _sensor_errors(problem, gt)
    log(f"rig solve, {iters} LM iterations: kernels {cost:.6e} in {seconds:.3f} s "
        f"({launches}), float64 plain {cost64:.6e} in {seconds64:.3f} s, relative difference "
        f"{rel:.3e} (<= {RIG_SOLVE_RTOL}); sensor_from_rig against the truth: kernels "
        f"{st:.3e} units / {sdeg:.3e} deg, plain {st64:.3e} / {sdeg64:.3e} (initial "
        f"{init_t:.3e} / {init_deg:.3e})")
    if not (iters == 10 and rel <= RIG_SOLVE_RTOL):
        raise AssertionError(f"rig solve: {iters} iterations, kernel vs plain {rel:.3e}")
    if not (max(st, st64) * RIG_SENSOR_GAIN <= init_t
            and max(sdeg, sdeg64) * RIG_SENSOR_GAIN <= init_deg
            and st <= RIG_SENSOR_FACTOR * st64 + 1e-4
            and sdeg <= RIG_SENSOR_FACTOR * sdeg64 + 1e-3):
        raise AssertionError("rig solve: sensor_from_rig outside its gate")
    missing = [k for k in ("rig_ba_jacobians", "rig_ba_reduce", "rig_ba_matvec")
               if launches[k] == 0]
    if missing:
        raise AssertionError(f"rig solve: launched no {missing}")
    torch.cuda.synchronize()
    return errs, rows, agree


# The kernels each rig scene's mapper must launch: the verify scene's initial
# pair triangulates most points, so K8 and K9 may find no work there; the
# full-size scene runs every one.
RIG_VERIFY_KERNELS = ("camera_map", "essential_ransac", *RIG_SOURCES)
RIG_MAPPER_KERNELS = ("camera_map", "essential_ransac", "triangulate_tracks", "filter_points",
                      *RIG_SOURCES)


def phase_rig(launches):
    """The rig mapper as users reach it, each command on cuda and the
    mapper under torch.profiler: the verify rig scene
    (tests/test_rig_mapper.py:38-45) stripped to features with its rigs and
    frames emptied and rebuilt by `rig_configurator`, then the full-size
    rig scene stripped to features; `exhaustive_matcher` and `mapper` on
    each, held to the truth."""
    from colmap_tpu_torch.kernels.rig_cases import write_rig_config
    from colmap_tpu_torch.scene.database import Database
    from colmap_tpu_torch.scene.synthetic import SyntheticDatasetOptions, synthesize_dataset

    results = {}
    with tempfile.TemporaryDirectory() as tmp:
        for label in ("verify rig scene", "full-size rig scene"):
            root = os.path.join(tmp, label.split()[0])
            os.makedirs(root)
            t0 = time.perf_counter()
            if label.startswith("verify"):
                frames, images = 6, 12
                db_path = os.path.join(root, "db.db")
                db = Database(db_path)
                gt = synthesize_dataset(SyntheticDatasetOptions(
                    num_rigs=1, num_cameras_per_rig=2, num_frames_per_rig=6, num_points3D=200,
                    camera_has_prior_focal_length=True, seed=4), db)
                db.close()
            else:
                frames, images = RIG_FULL_FRAMES, RIG_FULL_FRAMES * RIG_FULL_CAMS
                db_path, gt = make_scene(root, frames, 1000, FULL_FOCAL, num_cameras=RIG_FULL_CAMS)
            pairs = strip_to_features(db_path)
            log(f"rig mapper, {label}: {frames} frames x {len(gt.cameras)} cameras, "
                f"{gt.num_points3D()} points (set-up {time.perf_counter() - t0:.1f} s)")
            if label.startswith("verify"):
                db = Database(db_path, must_exist=True)
                for table in ("rigs", "rig_sensors", "frames", "frame_data"):
                    db.conn.execute(f"DELETE FROM {table}")
                db.commit()
                db.close()
                config = os.path.join(root, "rig.json")
                write_rig_config(gt, config)
                run_command(["rig_configurator", "--database_path", db_path, "--rig_config_path",
                             config], f"rig_configurator, {label}", ())
            verified, _, m_counts = run_matcher(db_path, f"matcher, {label}")
            expected = sum(len(m) >= 15 for m in pairs.values())
            if verified != expected:
                raise AssertionError(f"{label}: verified {verified} of {expected} pairs")
            for k, v in m_counts.items():
                launches[k] += v
            out = os.path.join(root, "sparse")
            pipeline, seconds, idle = _profiled_command(
                ["mapper", "--database_path", db_path, "--output_path", out, "--quiet"],
                f"mapper, {label}",
                RIG_VERIFY_KERNELS if label.startswith("verify") else RIG_MAPPER_KERNELS, launches)
            cmp = check_against_gt(out, gt, frames, f"mapper, {label}", num_images=images)
            phases = {k: (round(pipeline.timer.seconds[k], 3), pipeline.timer.calls[k])
                      for k in sorted(pipeline.timer.seconds, key=pipeline.timer.seconds.get,
                                      reverse=True)}
            log("  time by phase (s, calls): " + ", ".join(
                f"{k} {v[0]:.3f}/{v[1]}" for k, v in phases.items()))
            results[label] = dict(seconds=seconds, idle=idle, phases=phases,
                                  max_rot_deg=cmp["max_rotation_error_deg"],
                                  max_center=cmp["max_center_error"])
    return results


ALL_PHASES = ("ba", "sfm", "mapper", "matching", "matcher", "sift", "extractor", "dense", "mvs",
              "global_kernels", "global", "rig_kernels", "rig")


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
    if "dense" in phases:
        run("dense", lambda: phase_dense(launches))
    if "mvs" in phases:
        if "dense" not in phases:
            raise SystemExit("chip_smoke: phase mvs reads the dense phase's workspace")
        v_errs, v_rows = run("mvs", phase_mvs_kernels)
        errs.update(v_errs)
        rows.update(v_rows)
    if "root" in DENSE_STATE:
        shutil.rmtree(DENSE_STATE["root"], ignore_errors=True)
    if "global_kernels" in phases:
        g_errs, g_rows, _ = run("global_kernels", phase_global_kernels)
        errs.update(g_errs)
        rows.update(g_rows)
    if "global" in phases:
        run("global", lambda: phase_global(launches))
    if "rig_kernels" in phases:
        r_errs, r_rows, r_agree = run("rig_kernels", phase_rig_kernels)
        errs.update(r_errs)
        rows.update(r_rows)
        agree.update(r_agree)
    if "rig" in phases:
        run("rig", lambda: phase_rig(launches))
    log(f"seconds by phase: {seconds}")

    sources = {**BA_SOURCES, **SFM_SOURCES, **MATCH_SOURCES, **SIFT_SOURCES, **MVS_SOURCES,
               **GLOBAL_SOURCES, **RIG_SOURCES}
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
        if "entries" in rows[name]:  # the kernel's other entries: ms and plain ms
            kernels[-1]["entries"] = rows[name]["entries"]
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
