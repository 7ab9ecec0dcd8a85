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
     against the colmap_tpu reference cost and against the same loop
     through the plain versions (cost within K234_RTOL, iterations within
     1); the device-resident loop's host reads per solve and its CUDA
     graph's record and instantiate times; with "auto", the dense path's
     Cholesky and ridge LU solves timed alone; one chunk of graph replays
     and one of eager iterations under torch.cuda.set_sync_debug_mode("error");
  5. CLI: bundle_adjuster on a synthetic 120-frame model on cuda, then
     model_analyzer;
  6. profile: device time by kernel, the device's idle share and the
     launches of other device kernels (torch ops) in a warm LM iteration of
     each solver (torch.profiler);
  7. mapper kernels: K5-K9 (colmap_tpu_torch/kernels/sfm.py) against their
     plain versions (float64, same inputs) at the mapper's shapes, on the
     cases of colmap_tpu_torch/kernels/sfm_cases.py (K6 and K7 on batches of
     injected samples: the same best index and model), timed with CUDA
     events;
  8. features -> model, verify scene: a synthetic 8-frame, 120-point
     database (seed 3) stripped to keypoints and descriptors, then the
     `exhaustive_matcher` and `mapper` commands on cuda, held to the ground
     truth (8/8 frames within 1e-2 deg and 1e-4 units);
  9. features -> model, full-size scene: 10 frames x 1000 points
     (SIMPLE_RADIAL, 1024 x 768, f = 2500, noise-free, seed 3; cut from 40
     frames, which phase 23 runs with OPENCV_FISHEYE), the same two
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
     (float64, run on the card), and its two-view geometry is CALIBRATED with at least
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
 15a. Poisson kernels (phase `mesh_kernels`, after `dense`): K41-K44 against
     their plain versions on the dense phase's fused cloud (1.9M samples)
     at depth 8 (N = 256, the path's) and 9, each run twice for the same
     bits, timed with CUDA events beside the library call that computes the
     same function (index_put_ with accumulate, conv3d, torch.div); the
     whole indicator chi - iso against the plain path in float64 on the
     card, twice for the same bits, under sync debug mode "error";
 15b. meshing and MVS tools (phase `mesh`, after `dense`): `poisson_mesher`
     on the fused cloud (its vertices on the analytic surface, its counts
     against the CPU path's), `mesh_simplifier --factor 0.1`,
     `mesh_texturer` (labels and atlas against the CPU path's),
     `delaunay_mesher` and `advancing_front_mesher` on every k-th fused
     point, `image_rectifier` on two dense views (against the CPU path) and
     `image_undistorter --output_type PMVS` and `CMP-MVS` (colmap_tpu's
     file layout), each under torch.profiler;
 16. global-SfM kernels (phase `global_kernels`): K21-K23
     (colmap_tpu_torch/kernels/global_sfm.py) against float64 plain
     versions at the scale global SfM users run: K21 on a 1000-node view
     graph with 25 000 edges (2 deg noise, 5% random), L1 and Geman-McClure,
     with and without gravity projectors; K22 on 1000 cameras x 200 000
     points x 1 200 000 observations at a solve's first and last state; K23
     on 50 cameras and 2000 F edges; timed with CUDA events; then
     estimate_rotations, solve_global_positioning and calibrate_view_graph
     through the kernels and through the plain versions in float64 on the
     card, held to the truth and to each other; then K39 (the CG step, both
     modes) against float64 on the same graph and problem, timed, and one
     round of each solver's CG replayed from its CUDA graph under sync debug
     mode "error", equal to the eager round to the bit;
 17. global SfM (phase `global`): `global_mapper` on the verify scene, the
     full-size scene (both with relative poses decomposed from E) and an
     8-frame gravity-prior scene (the full-size scene at 10 frames, as in
     phase 9), `rotation_averager` on the verify scene
     and `view_graph_calibrator` on a database of UNCALIBRATED pairs, each
     under torch.profiler but the verify and gravity-prior scenes' mapper:
     frames, errors against the truth, wall time, time by phase and the
     device's idle share;
 18. rig kernels (phase `rig_kernels`): K24-K27
     (colmap_tpu_torch/kernels/rig.py) against float64 plain versions on the
     rig BA headline (50 frames x 4 sensors x 50 000 points x 300 000
     observations, SIMPLE_RADIAL, Cauchy, sensors free) and on small problems
     over camera models 0-4 with a constant frame and an empty sensor row
     (K25, K26: the same bits in two runs), K27 on 1024 injected samples of a
     2000-row rig frame (the same best sample or a near-tie marked from
     float64), timed with CUDA events; K34's rig set-up (c) and undamped
     step and K38 (the rig LM candidate and accept) against float64 on the
     headline's first step, timed; then 10 LM iterations of the rig solve
     through the kernels and through the float64 plain versions, held to
     each other and to the true sensor_from_rig; then the device-resident
     rig loop: a replay and an eager iteration under sync debug mode
     "error", a warm solve under torch.profiler (wall per iteration, idle
     share, host reads, the graph's record and instantiate times);
 19. rig mapper (phase `rig`): the verify rig scene (2 cameras x 6 frames x
     200 points, seed 4) stripped to features, its rigs and frames emptied
     and rebuilt by `rig_configurator`, and the full-size rig scene (4
     cameras x 5 frames x 1000 points, f = 2500, seed 3; cut from 10
     frames) stripped to
     features, each through `exhaustive_matcher` and `mapper` on cuda (the
     full-size scene's mapper under torch.profiler): frames, errors against the truth, wall
     time, time by phase and the device's idle share;
 20. retrieval kernels (phase `retrieval_kernels`): K28-K31
     (colmap_tpu_torch/kernels/retrieval.py) against float64 plain versions
     on a collection of 1000 images x 2000 uint8 descriptors with a known
     neighbour structure (BASELINE.json config 3's scale): K28 with a flat
     1024-word vocabulary over all 2M rows, K28 and K29 over level 4 of a
     branching-8, depth-5 tree (4096 nodes x 8 children; K29 the same bits
     in two runs), K30 through that tree (sorted passes at 2M rows, a warp a
     row at one image's 2000 rows: the same leaves on those rows; the
     CUDA launches a call of each, counted in a captured graph and under
     the profiler; both regimes timed from 2000 rows to 2M); indices equal
     except at near-ties
     marked from float64, each chosen centroid within 1e-5 of the nearest's
     float64 distance; K31 (S = W Wᵀ of rank_images_bow) on the W of that
     tree's words, 1000 x 32 768, within 1e-5, exactly symmetric, the same
     bits twice, and the bits of its sparse path's integer model (the card
     chose the inverted file); timed with CUDA events, its parts under
     torch.profiler;
 21. retrieval (phase `retrieval`): the collection written to a database,
     `vocab_tree_builder --depth 5 --branching 8`, `vocab_tree_retriever
     --num_images 10`, `vocab_tree_matcher --num_images 10` up to its pair
     list (verification stubbed: the collection has no geometry), each
     under torch.profiler, and `vocab_tree_pairs`: recall@10 of the true
     neighbours >= 0.8, the first 100 images' top-10 lists against the
     float64 plain path's, K31 on the W that `vocab_tree_pairs` built; then 12
     rendered frames (phase 13's scene) through
     `feature_extractor`, `vocab_tree_builder` (flat, then depth 3),
     `vocab_tree_matcher --num_images 5` and `mapper`, held to the images ->
     model gates; the driven commands' K30 calls and rows by regime;
 22. camera kernels (phase `camera_kernels`): K5 in its three modes
     (project, the z = 1 lift, unit rays) for camera models 5-17 on one
     image's points and over a 185-degree lens's whole image, K1 for each
     model at the BA headline, K9 on 1000 points and K24 at the rig BA
     headline (K24-K26 through the 17-column camera rows of the 16-parameter
     model), the same for a problem mixing SIMPLE_RADIAL and OPENCV_FISHEYE
     (K1, K9 and K24 once per model), against float64 plain versions; K32
     and K33 on 360-degree rays (injected samples of an 8192-ray pair against
     float64, a block of 64 pairs x 8192 rays against the one-pair entries),
     timed;
 23. cameras (phase `cameras`): `mapper` on the full-size scene with
     OPENCV_FISHEYE and on a full-size mixed scene (2 rigs x 20 frames,
     SIMPLE_RADIAL + OPENCV_FISHEYE), `global_mapper` on the fisheye scene,
     `image_undistorter` on a 12 MP fisheye still against the float64
     undistortion, and `exhaustive_matcher` on 24 EQUIRECTANGULAR frames at
     5760 x 2880 (276 pairs, a rotation-only pair, planted outliers) held to
     colmap_tpu's spherical bounds on every pair's relative pose; each but
     the mixed scene's mapper under torch.profiler;
 24. solver kernels (phase `solver_kernels`): K34 (PCG's set-up in both
     preconditioner modes and its step) and K35 (the LM candidate and
     accept) against float64 plain versions at a mapper-sized local BA
     (15 x 1500) and at the BA headline, K34's step by its launch plan
     (one warp up to 32 frames and 128 camera entries) and by the block on
     the same seeded vectors from 4 to 200 frames, K36 (cheirality and
     refinement) on the initial pair's 3 seeds x 8192 rows and cheirality
     on 780 pose graph edges x 200 rows, K37 on 16 injected samples at the rendered
     scene's shape (2000 rows, 11 registered cameras; every near-best model
     of its check within 1e-6 of float64), K40 (the rig pose refinement
     and refit) on 2000 rows x 4 cameras in float64, timed; at both BA
     shapes the loop's costs that the graph's size rule and the done
     flag's chunk weigh (an eager iteration, recording and instantiating a
     graph, a replay, one flag read, a whole solve);
 25. option kernels (phase `options_kernels`): K45 (Baumberg affine
     shapes) and K15 and K16 on its affine frames at octave 0 of a rendered
     3072 x 2304 view, K46 (DEGENSAC's hypotheses) at 8192 rows x 256
     hypotheses, the MSAC mode of K7, K11 and K12 on a matcher-phase block
     (8 pairs x 8192 matches) and of K32 and K33 on a 64-pair x 8192-ray
     360-degree block, K47 (the SPRT) at 256 hypotheses x 8192 rows, all
     against float64 plain versions, timed with CUDA events;
 26. options (phase `options`): `run_feature_extraction` with
     estimate_affine_shape on four rendered 3072 x 2304 views (6-column
     frames; a 768 x 576 crop's count against the CPU path; a view
     stretched 1.6x in x matches better with affine shapes than without),
     64 planted plane + parallax pairs of 8192 matches through the block
     verifier with use_degensac (each equal to the pair alone, its F
     keeping the off-plane matches), the matcher scene of phase 11 with
     MSAC support (CALIBRATED, >= 99% inliers), progressive sampling on one
     of its pairs with a quality order by descriptor distance, and
     `sprt_evaluate`, each under torch.profiler;
 27. tools kernels (phase `tools_kernels`): K48 (the generalized relative
     pose's propose-and-score, inlier and weighted-refit entries) on 32
     injected samples of an 8192-row pair of the 4 x 5 rig scene's
     4-camera layout with 25% outliers, and K49 (line gradients) on a
     3072 x 2304 view, against float64 plain versions, timed (K49 beside
     F.conv2d with hypot and atan2);
 28. orientation (phase `orientation`): `model_orientation_aligner --method
     MANHATTAN-WORLD` on a rendered Manhattan facade (8 views at 3072 x
     2304, rolled and yawed), the frame within 0.99 dots of the world's X
     and Y, then IMAGE-ORIENTATION and PRINCIPAL-PLANE on phase mapper's
     model;
 29. compat (phase `compat`): pycolmap_compat's
     estimate_generalized_relative_pose on 8192 rig correspondences with
     25% planted outliers (0.5 deg, 0.05, 0.9 of the inliers kept), a
     pycolmap-style script (extract_features -> match_exhaustive ->
     incremental_mapping) on 12 rendered frames (12/12), then
     `automatic_reconstructor` on them and `color_extractor`;
 30. tools (phase `tools`): point_triangulator, image_registrator,
     point_filtering, guided_geometric_verifier, hierarchical_mapper and
     pose_prior_mapper on the verify scene on cuda, held to the mapper's
     gates, then every file tool once on their outputs;
 31. learned kernels (phase `learned_kernels`): ALIKED on a rendered 3072 x
     2304 view with random weights (seed 0), K = 8192: every K50 call
     (convolutions, upsamplings) against its F.conv2d-based plain version
     (TF32 off) within 1e-4, K51 the plain version's keypoint list in its
     order (positions within 1e-5 px beyond one float32 ulp of the
     coordinate; its parts under torch.profiler), K52 against the dense plain SDDH
     (the whole image convolved, as colmap_tpu) within 1e-4, peak memory;
     then LightGlue (9 layers, hidden 256, 4 heads) on one pair of 2048 of
     the view's features: every K53 (a) call of the forward within 1e-4,
     K53 (b)'s match list equal to the plain version's but at near-ties of
     float64 scores; each timed beside its plain version and the library
     call (F.conv2d, F.max_pool2d + torch.topk, scaled_dot_product_attention,
     log_softmax + argmax);
 32. learned (phase `learned`): `feature_extractor --descriptor_type aliked`
     on four rendered 3072 x 2304 views under torch.profiler (128-d uint8
     descriptors), `exhaustive_matcher` on them (ALIKED_BRUTEFORCE), the 12
     rendered 1024 x 768 frames extracted at 2048 ALIKED features and
     matched by run_exhaustive_matching with matcher_type="lightglue"
     (threshold 0) under torch.profiler (pairs/s, idle share), then one
     frame against a copy of itself under another name (through the
     pipeline) and against a permuted copy: on its SIFT features at least
     100 mutual matches, at least 0.99 of them correct; on its ALIKED
     features the counts (random weights make ALIKED's uint8 descriptors
     nearly parallel: LightGlue keeps ~1 match);
 33. covariance (phase `covariance`): estimate_ba_covariance (K1, K54, the
     float64 inverse) on the verify BA scene (8 x 120 x 5, 1 px noise,
     two-frame gauge, intrinsics fixed) and on the BA headline, against the
     same function through the plain versions in float64 on the same
     float32 inputs; K54 against its plain version, the inverse against
     np.linalg.inv, the fixed rows exactly 0, the free pose blocks
     positive-definite; cond(S); K54 timed at the headline;
 34. sharded (phase `sharded`): solve_sharded_packed on the BA headline (10
     iterations, PCG 20) in an NCCL group of one rank in this process, PCG
     and dense, against solve_packed (the same iterations, the cost within
     1e-6); K35's split candidate and K4 without its diagonal against
     float64; two ranks on this card over gloo (parallel/dist_cases.py),
     their cameras equal to the bit, against solve_packed, seconds an
     iteration beside the single card's; hierarchical_mapper through the
     CLI under COLMAP_TPU_MULTIHOST=1 with torchrun's variables (a group of
     one rank) registering what it registers alone.
Each path is driven with the launch counts set to 0 just before it and
read just after: the BA paths (phases 4-5) must launch K1-K3 and K35 (and
K4 with the dense solver, K34 with PCG), the matcher K5, K7 and K10-K12,
the mapper K1-K3, K5-K9 and K34-K36 (its BA is PCG, so K4 is not on its
path), the rendered 12-frame mapper K37 too, the extractor K13-K16,
`image_undistorter` K5, `patch_match_stereo` K17-K20, `poisson_mesher`
K41-K44, `mesh_texturer`, `image_rectifier` and both exports K5,
`global_mapper` K1-K3,
K5, K21, K22 and K34-K36 and K39, `rotation_averager` K21, `view_graph_calibrator` K23,
the rig solve K24-K26 and K38 and the rig mapper K5, K7, K24-K27, K34, K38
and K40 (and on the full-size rig scene K8 and K9), `vocab_tree_builder` K28 and K29,
`vocab_tree_pairs` K28, K29 and K31, `vocab_tree_retriever` and `vocab_tree_matcher` K30 (the
matcher also K5, K7 and K10-K12 on the rendered frames), the fisheye and
mixed mappers K1-K3, K5-K9 and K34-K36, `exhaustive_matcher` on 360-degree
frames K5, K10, K32 and K33, affine `run_feature_extraction` K13-K16 and
K45, the DEGENSAC block K11, K12 and K46, the MSAC matcher K5, K7 and
K10-K12, `sprt_evaluate` K47, `model_orientation_aligner` K49,
estimate_generalized_relative_pose K48, the pycolmap script and
`automatic_reconstructor` K13-K16, K5, K7, K10-K12 and the mapper's,
`point_triangulator` K8, `image_registrator` K6, `point_filtering` K9,
`feature_extractor --descriptor_type aliked` K50-K52, ALIKED's
`exhaustive_matcher` K10, LightGlue's run_exhaustive_matching K53,
estimate_ba_covariance K1 and K54, and the sharded solves K1-K3, K35 and
K34 (PCG) or K4 (dense).
The weighing: the wrappers of K2, K3, K12, K13, K18, K22, K28, K33, K34
and K50 count their launches by shape (kernels/tally.py), the driven runs'
shapes are summed beside their launches (add_launches), and each shape
class (sizes rounded up to powers of two) with at least 5% of its kernel's
driven launches is timed again, through a call kept at that class, beside
its bound; it logs launches x (ms - bound) by kernel ("weighing: " line).
Then it prints the kernels line (JSON), the nvidia-smi line and, last,
{"ok": true, "device": {...}}. `--phases dense,mvs`, `--phases
dense,mesh_kernels,mesh`, `--phases
global_kernels,global`, `--phases rig_kernels,rig` or `--phases
retrieval_kernels,retrieval`, `--phases camera_kernels,cameras` or
`--phases solver_kernels` or `--phases options_kernels,options` or `--phases
tools_kernels,orientation,compat,tools` or `--phases learned_kernels,learned` or
`--phases covariance,sharded` (or any
subset of the phases) runs a subset
while developing and prints no result; the kernels line needs them all.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import dataclasses
import gc
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
from collections import Counter

import numpy as np
import torch

T_START = time.perf_counter()

# Published peaks of one H100 SXM (NVIDIA data sheet): HBM3 bytes/s and
# float32 (non-tensor-core) operations/s, for the bound of each kernel.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12
PEAK_TF32_OPS_PER_S = 495e12  # dense TF32 on the tensor cores

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
# The SIMPLE_RADIAL full-size scene of phases mapper and global runs at a
# quarter of its depth (10 frames), to keep the script within its time:
# phase cameras runs the 40-frame scene through `mapper` and
# `global_mapper` with OPENCV_FISHEYE, the same paths at full depth.
CUT_FRAMES = 10
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
MESH_SOURCES = {
    "poisson_splat": ("colmap_tpu_torch/csrc/poisson_splat.cu", "colmap_tpu/mvs/meshing.py:54"),
    "poisson_stencil": ("colmap_tpu_torch/csrc/poisson_stencil.cu",
                        "colmap_tpu/mvs/meshing.py:78"),
    "poisson_spectral": ("colmap_tpu_torch/csrc/poisson_spectral.cu",
                         "colmap_tpu/mvs/meshing.py:95"),
    "poisson_iso": ("colmap_tpu_torch/csrc/poisson_iso.cu", "colmap_tpu/mvs/meshing.py:110"),
}
# Phase mesh_kernels: K41-K44 at the path's depth 8 (N = 256) and at depth
# 9 (N = 512) to show how the time scales. K41 (b) sums in float64 in sorted
# order, its plain version on the card by float64 index_add_ in another
# order: 1e-6 of the grid's largest entry. K43's cosines come from two
# libraries: 1e-6. K44 (a) sums in float64 in another order than the
# float64 plain gather over the float32 chi: 1e-6 relative. The whole
# indicator (float32 kernels, cuFFT in float32) against the plain path in
# float64: 1e-4 of max |chi - iso|.
MESH_DEPTHS = (8, 9)
K41_RTOL, K43_RTOL, K44_RTOL, MESH_INDICATOR_RTOL = 1e-6, 1e-6, 1e-6, 1e-4
# Phase mesh's gates. The Poisson mesh lies on the dense scene's surface:
# median vertex distance at most half a voxel (scale / N), 90% within 1.5
# voxels; the card's mesh and the CPU path's differ in counts by at most
# 0.1% (a voxel within rounding of 0 may change sides between the paths).
# The quadric simplifier keeps at most 12% of the faces at --factor 0.1
# (colmap_tpu's test_simplify_mesh_quadric) within one voxel of the surface.
# Texturing labels at least 90% of the faces, the card's labels equal the
# CPU path's on 99.9% (its projections are float32), atlas texels within 1
# count where they agree. Delaunay meshing and the advancing front run on
# every k-th fused point, about MESH_SUBSAMPLE of them (their host loops and
# Qhull at 1.9M points would not finish): face centroids within the fused
# cloud's gate (DENSE_MAX_FUSED_ERR, over depth). Rectified pixels within 1
# count of the CPU path's on 99.9%.
MESH_MAX_MEDIAN_VOXELS, MESH_WITHIN_VOXELS, MESH_MIN_WITHIN = 0.5, 1.5, 0.9
MESH_MAX_COUNT_DIFF = 1e-3
SIMPLIFY_MAX_KEPT, SIMPLIFY_MAX_MEDIAN_VOXELS = 0.12, 1.0
TEX_MIN_LABELLED, TEX_MIN_SAME_LABEL = 0.9, 0.999
MESH_SUBSAMPLE = 20000
RECT_MIN_SAME = 0.999
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
    "global_cg": ("colmap_tpu_torch/csrc/global_cg.cu",
                  "colmap_tpu/estimators/rotation_averaging.py:123"),
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
# K39 against float64 on the same float32 inputs, each step fed the float32
# matvec: float32 vectors, float64 dots; r, z and p shrink as CG converges
# and r - alpha Ap cancels, so each vector is held to the larger of its own
# scale and its set-up's. K39_STEPS steps in each mode. Operations per
# vector entry of a step: two dots (4), two axpys (4), z = M r (1), p =
# z + beta p (2): 11.
K39_RTOL, K39_STEPS, K39_ENTRY_OPS = 1e-4, 40, 11

RIG_SOURCES = {
    "rig_ba_jacobians": ("colmap_tpu_torch/csrc/rig_ba_jacobians.cu",
                         "colmap_tpu/estimators/bundle_adjustment_rig.py:169"),
    "rig_ba_reduce": ("colmap_tpu_torch/csrc/rig_ba_reduce.cu",
                      "colmap_tpu/estimators/bundle_adjustment_rig.py:238"),
    "rig_ba_matvec": ("colmap_tpu_torch/csrc/rig_ba_matvec.cu",
                      "colmap_tpu/estimators/bundle_adjustment_rig.py:255"),
    "gen_abs_ransac": ("colmap_tpu_torch/csrc/gen_abs_ransac.cu",
                       "colmap_tpu/estimators/generalized_pose.py:113"),
    "rig_lm_update": ("colmap_tpu_torch/csrc/rig_lm_update.cu",
                      "colmap_tpu/estimators/bundle_adjustment_rig.py:319"),
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
# The full-size rig scene: 1 rig x 4 cameras x 5 frames (20 images, cut from
# 10 frames to keep the script within its time) x 1000 points, SIMPLE_RADIAL
# 1024 x 768, f = 2500, seed 3.
RIG_FULL_CAMS, RIG_FULL_FRAMES = 4, 5
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


RETRIEVAL_SOURCES = {
    "retrieval_assign": ("colmap_tpu_torch/csrc/retrieval_assign.cu",
                         "colmap_tpu/retrieval/visual_index.py:56"),
    "retrieval_update": ("colmap_tpu_torch/csrc/retrieval_update.cu",
                         "colmap_tpu/retrieval/visual_index.py:39"),
    "retrieval_descend": ("colmap_tpu_torch/csrc/retrieval_descend.cu",
                          "colmap_tpu/retrieval/visual_index.py:117"),
    "retrieval_gram": ("colmap_tpu_torch/csrc/retrieval_gram.cu",
                       "colmap_tpu/retrieval/visual_index.py:487"),
}
# Retrieval at BASELINE.json config 3's scale: an unordered collection of
# 1000 images x 2000 uint8 descriptors (the matchers' default
# --max_features_per_image), a flat vocabulary of 1024 words (the builder's
# default), a tree of branching 8 and depth 5 (32 768 leaves, the size COLMAP
# ships for 1k-10k images) trained on the builder's default 200 000-row sample.
RET_IMAGES, RET_PER_IMAGE, RET_WORDS, RET_BRANCHING, RET_DEPTH, RET_SAMPLE = (
    1000, 2000, 1024, 8, 5, 200000)
# Gates: recall@10 of the generator's true neighbours (the 10 images nearest
# in index, which share the most of its pool window); the retriever's top-10
# against the float64 plain path's on 100 query images; K29 within 2e-7 of
# the scale (float64 sums rounded once to float32); K31 within 1e-5 of the
# scale (its sparse path: exact products summed as integers of 2^-F, one
# float32 rounding; its dense path: float32 sums of up to K products).
RET_RECALL, RET_SUBSET, K29_RTOL, K31_RTOL = 0.8, 100, 2e-7, 1e-5
# f32 operations (an FMA is 2): K28 and K30 3 per (row, centroid, dim), a
# subtraction and an FMA; K29 1 per (row, dim), its float64 add counted at
# the float32 rate; K31 in gram_work, from the run's W.
RET_DIST_OPS, RET_SUM_OPS = 3, 1
# Retrieval on the images -> model scene: 5 neighbours an image, so that
# retrieval chooses among the 66 pairs.
RET_IMG_NEIGHBORS = 5

CAMERA_SOURCES = {
    "spherical_e_ransac": ("colmap_tpu_torch/csrc/spherical_e_ransac.cu",
                           "colmap_tpu/estimators/spherical.py:84"),
    "spherical_h_ransac": ("colmap_tpu_torch/csrc/spherical_h_ransac.cu",
                           "colmap_tpu/estimators/spherical.py:103"),
}
# K5 on models 5-17 against float64, per row of the output's scale: up to 25
# float32 Newton steps through up to 12 distortion terms. Rows whose float64
# ray lies within 1 degree of 90 degrees off axis are left out of the value
# check (the z = 1 lift diverges there), not of the validity check.
K5_NEW_RTOL = 1e-4
# K1 and K24 on models 5-17 and on mixed problems against float64: the
# projection through up to 12 distortion terms and the fisheye atan in
# float32 (Cauchy's weight carries the residual's rounding, as K1's robust
# tolerance says).
K1_NEW_RTOL = 1e-4
# ... checked on the first 60 000 observations of each headline (a fifth;
# the kernels compute each observation alone), timed on all 300 000.
K1_CHECK_OBS = 60000
# K32 / K33 on 360-degree rays: a block of 64 pairs x 8192 rays, as the
# 360-degree matcher of phase cameras sends them (blocks of up to 64 pairs;
# 8192 keypoints a frame, all of them matched), 128 samples a pair; one pair
# of injected samples at 8192 rays against float64. The plain version's
# time on the block is taken over pieces of SPH_PLAIN_PAIRS pairs (one
# piece of E's (pairs, 1280 models, 8192 rays, 3) intermediates is 1 GB).
SPH_PAIRS, SPH_ROWS, SPH_SAMPLES, SPH_PLAIN_PAIRS = 64, 8192, 128, 8
# f32 operations (an FMA is 2): K32 per sample K7's 5-point count (see phase
# sfm: null space and elimination 6e3, the grid 2050 x 25, the bisections
# 1000 x 60, the models 3e3), per model and ray the angular Sampson error
# (80); K33 per sample the 8 kept DLT rows (4 x 23), Householder QR of their
# 9 x 8 transpose (46 flops an entry of a reflector's column over 8
# reflectors: 46 x 44), the null vector (5 x 44) and its norm (30), per ray
# the angular transfer error (45).
SPH_E_SAMPLE_OPS, SPH_E_ROW_OPS = 6000 + 2050 * 25 + 1000 * 60 + 3000, 80
SPH_H_SAMPLE_OPS, SPH_H_ROW_OPS = 4 * 23 + 46 * 44 + 5 * 44 + 30, 45
# Phase solver_kernels (K34-K37) and the device-resident LM loop.
SOLVER_SOURCES = {
    "ba_pcg": ("colmap_tpu_torch/csrc/ba_pcg.cu",
               "colmap_tpu/estimators/bundle_adjustment.py:986"),
    "ba_lm_update": ("colmap_tpu_torch/csrc/ba_lm_update.cu",
                     "colmap_tpu/estimators/bundle_adjustment.py:435"),
    "relative_pose": ("colmap_tpu_torch/csrc/relative_pose.cu",
                      "colmap_tpu/geometry/essential.py:94"),
    "structure_less_ransac": ("colmap_tpu_torch/csrc/structure_less_ransac.cu",
                              "colmap_tpu/estimators/generalized_pose.py:552"),
    "gen_abs_refine": ("colmap_tpu_torch/csrc/gen_abs_refine.cu",
                       "colmap_tpu/estimators/generalized_pose.py:262"),
}
# Published float64 peaks of one H100 SXM (NVIDIA data sheet): outside the
# tensor cores, the bound of float64 work without a GEMM form (K36, K40,
# K47 and K48: small per-row solves and tests); through the FP64 tensor
# cores (DMMA), the bound of float64 work with one (K54's S_corr =
# sum Z W^T).
PEAK_F64_OPS_PER_S = 34e12
PEAK_F64_TC_OPS_PER_S = 67e12
# K34 against float64 on the same float32 inputs: float32 vectors and 6x6
# blocks, float64 dot products; K35's candidate: one float32 update per entry.
K34_RTOL = K234_RTOL
K35_RTOL = 1e-5
# K36: float64 arithmetic from float32 inputs, float32 outputs; a row whose
# depth lies at a limit (an outlier triangulated at infinity) may flip: at
# most K36_FLIP_SHARE of the rows.
K36_RTOL = 1e-5
K36_FLIP_SHARE = 1e-3
# The mapper-sized local BA of phase solver_kernels (the 40-frame mapper's
# local BAs hold 10-20 frames and 1-2k points) and K36's shapes: the initial
# pair's 3 seeds at 8192 rows (the matcher's keypoints per image), 780
# edges of 200 rows (the 40-frame pose graph); K37 at the rendered scene's
# shape: 2000 correspondences against 11 registered cameras, one batch of
# 16 samples.
LOCAL_BA = (15, 1500)
EARLY_LOCAL_BA = (8, 600)  # the mapper's first local BAs
REL_ROWS, REL_SEEDS, GRAPH_EDGES, GRAPH_ROWS = 8192, 3, 780, 200
SL_ROWS, SL_CAMS, SL_SAMPLES = 2000, 11, 16
# K37's check: four batches of injected samples. Its five-point solve runs
# in float64 (in float32 it missed the roots of ill-conditioned samples: 35
# of 42 near-best models agreed on the card), so every near-best model must
# have a kernel solution of its sample within 1% of the rows of its support
# and within K37_MODEL_RTOL of it; all-inlier samples tie, so the best
# supports may differ by SL_ROWS // 500 rows.
SL_CHECK_SAMPLES, K37_AGREE, K37_MODEL_RTOL = 64, 1.0, 1e-6
# Operations (an FMA is 2). K34's step per vector entry: lam D p, two dots,
# two axpys, z = M r (12 for a pose entry), p = z + beta p: ~24, plus 72 per
# frame. K35's candidate per frame: the exponential, the product and its
# norm (~90), per camera parameter 5, per point 15. K36 (a), in float64,
# per DLT triangulation (four to vote on each masked row, the winner again
# on every row): the 4x4 DLT (16), A^T A (128), its symmetrization (12), 10
# sweeps of 6 skip tests (240) and the point and depth test (~25); per
# Jacobi rotation the skip rule lets through, c and s (~13) and three
# 4-entry row or column pairs (72): _k36_ops counts these rotations on this
# run's rows. Its refinement per row and step: the residual and 5
# derivatives (~160) and the normal equations (40), then the cost pass
# (~40), 15 steps. K37
# per sample the 5-point solve (as K32, SPH_E_SAMPLE_OPS) and per model and
# row the generalized Sampson error (~110).
K34_ENTRY_OPS, K34_FRAME_OPS = 24, 72
K35_FRAME_OPS, K35_CAM_OPS, K35_POINT_OPS = 90, 5, 15
K36_TRI_OPS, K36_ROTATION_OPS = 420, 85
K36_REFINE_ROW_OPS = 15 * (160 + 40 + 40)
K37_ROW_OPS = 110
# K38 against float64: K35's tolerance. Its candidate's operations per
# frame or sensor row as K35's per frame, per camera-side entry (W a row)
# 5, per point 15.
K38_RTOL = K35_RTOL
# K40 in float64 against float64: 1e-9 of each output's scale. Its
# float64 operations per row: in a refinement iteration the residual (two
# quaternion rotations ~60, the projection and the weight ~16), the 2 x 6
# Jacobian (6 columns of a cross product and a rotation, ~250), the normal
# equations (2 x 28 FMA, 112) and the candidate's residual (~76): ~510,
# times the iterations this run's data takes; in the refit the three rows of
# the 12 x 12 normal equations (3 x ~210) and the second pass (~60): ~700.
K40_RTOL, K40_ROW_OPS, K40_REFIT_ROW_OPS = 1e-9, 510, 700
# Phase cameras. The full-size scene (40 x 1000, 1024 x 768) with an
# action camera's OPENCV_FISHEYE: colmap_tpu's mixed-model test's
# distortion (0.01, -0.005, 0.001, 0) at the full-size scene's focal length
# of 2500 px (at the test's 900 px every frame sees every point and the
# triangulator has no track to create); the mixed scene: 2 rigs of one
# camera, SIMPLE_RADIAL and that OPENCV_FISHEYE, 20 frames each.
FISHEYE_PARAMS = (FULL_FOCAL, FULL_FOCAL, 512.0, 384.0, 0.01, -0.005, 0.001, 0.0)
MIXED_FRAMES = 20
# image_undistorter on a 12 MP action-camera still: OPENCV_FISHEYE 4000 x
# 3000 with a 120-degree horizontal field of view (f = 2000 px / 60 deg).
UND_W, UND_H = 4000, 3000
UND_PARAMS = (1910.0, 1910.0, 2000.0, 1500.0, 0.01, -0.005, 0.001, 0.0)
# Its output against the float64 plain undistortion on the CPU: pixels (8-bit,
# truncated) within 1 level, at most this share off by exactly 1 (float32
# sampling positions move a truncation across a level).
UND_MAX_OFF_BY_ONE = 0.02
# exhaustive_matcher on 360-degree frames: 24 EQUIRECTANGULAR frames of a
# consumer 360 camera's still (5760 x 2880), 8192 points each (all seen by
# every frame, 0.25 px of noise, 3% of each frame's keypoints moved to
# random pixels), 276 pairs, frames 0 and 1 at one center: that pair is
# PLANAR or PANORAMIC (with noise colmap_tpu gives PLANAR too: its H is a
# rotation only to the noise's accuracy), the others CALIBRATED.
# colmap_tpu's test bounds on the relative pose
# (tests/test_ransac_two_view.py:440-500), and a bound on the share of
# planted outlier matches among the inliers: colmap_tpu keeps 1.10% (42 of
# 3820) on eight pairs of this database, the port 1.13%
# (tests/spherical_noise_witness.py; a random match lies within the 4 px
# band of E's great circles with a chance of ~0.6%, and RANSAC's largest
# support favours the models that hold a few more of them); 1.5% leaves
# room for the spread over 276 pairs.
PANO_FRAMES, PANO_POINTS = 24, 8192
PANO_ROT_TOL, PANO_T_TOL, PANO_MAX_OUTLIER_SHARE = 0.02, 0.05, 0.015
PANO_KERNELS = ("camera_map", "match_top2", "spherical_e_ransac", "spherical_h_ransac")


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


def kernel_split(fn, reps=5):
    """(device busy ms, {kernel: (device ms, launches)}, wall ms), each a
    call of fn, for log_busy: torch.profiler over reps calls (device_busy),
    means a call; the wall is host time around reps calls ending in a
    synchronize, without the profiler. The profiler can drop the events of
    its first milliseconds, so a sleep kernel (spin_kernel) runs first and is
    left out. These calls keep the card busy for most of their wall
    (0.48-0.97 in the runs that recorded them whole), so a busy time under a
    quarter of it is taken for lost events: None, not measured."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / reps
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(20_000_000)
        torch.cuda.synchronize()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    busy_ms, by_name = device_busy(prof, skip="spin_kernel")
    split = {}
    for name, (ms, cnt) in by_name.items():
        short = name.split("(")[0].split("::")[-1]
        a, c = split.get(short, (0.0, 0))
        split[short] = (a + ms / reps, c + cnt / reps)
    if busy_ms is None or busy_ms / reps < 0.25 * wall_ms:
        return None, split, wall_ms
    return busy_ms / reps, split, wall_ms


def log_parts(label, fn, reps=20):
    """Each kernel's device ms a call of fn (kernel_split over reps calls),
    printed even where the busy share is not measured; returns the split."""
    busy, split, wall = kernel_split(fn, reps)
    parts = ", ".join(f"{k} {ms:.4f} ms x {cnt:g}"
                      for k, (ms, cnt) in sorted(split.items(), key=lambda kv: -kv[1][0]))
    log(f"  {label}, a call under the profiler: {parts or 'no device events'}; device busy "
        f"{'not measured' if busy is None else f'{busy:.4f} ms'} of {wall:.4f} ms wall")
    return split


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
    lam = torch.tensor(1e-3, device="cuda")
    red_k = K.lm_reduce(r, Jp, Jc, Jx, fpm, cpm, F, C, lam)
    red_p = K.lm_reduce_plain(*f64(r, Jp, Jc, Jx), fpm, cpm, F, C, lam.double())
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


def sync_free_chunk(headline, solver):
    """One chunk of DONE_CHUNK iterations of the device-resident LM loop at
    the headline under torch.cuda.set_sync_debug_mode("error"), as the loop
    runs them: graph replays for PCG (and eager launches, as the size rule
    runs short solves), eager launches for the dense solver. Any host read
    inside the chunk raises."""
    from colmap_tpu_torch.estimators import bundle_adjustment as ba
    from colmap_tpu_torch.kernels import ba as K
    from colmap_tpu_torch.kernels import solver as KL
    from colmap_tpu_torch.utils import cuda_graph

    _, model_id, packed, maps, masks = headline
    options = ba.BAOptions(max_iterations=10, pcg_iterations=20, function_tolerance=0.0,
                           solver_type=solver)
    use_dense = ba._use_dense(packed, options)
    state, sc, groups = ba._start(packed, model_id, options, options.initial_lambda, 2.0,
                                  K.KERNELS)
    obs_masks = ba._obs_masks(masks, options)

    def step():
        ba._lm_iteration(state, maps, model_id, options, obs_masks, sc, K.KERNELS, use_dense,
                         True, groups)

    step()
    replay = None if use_dense else cuda_graph.capture(step, torch.device("cuda"),
                                                       (K, KL))[0]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for run in (step,) if replay is None else (replay, step):
            for _ in range(ba.DONE_CHUNK):
                run()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    it, chunks = int(sc.S[3].item()), 1 if replay is None else 2
    log(f"  sync debug mode 'error': {'a chunk of graph replays and ' if replay else ''}a chunk "
        f"of eager iterations ({solver}, {ba.DONE_CHUNK} each) ran without a host read; {it} "
        "iterations")
    if it != 1 + chunks * ba.DONE_CHUNK:
        raise AssertionError(f"the checked chunks ran {it} iterations")


def _dense_solve_ms(packed):
    """The dense path's library solves at this problem's size D = 6F + C P
    (bundle_adjustment.py _dense_schur_solve): the Cholesky route and the
    ridge LU that runs beside it every iteration, on an SPD S of the
    problem's type. Returns the ridge's ms."""
    F = packed.quat.shape[0]
    C, P = packed.cam_params.shape
    D, dtype = 6 * F + C * P, packed.points.dtype
    g = torch.Generator(device="cuda").manual_seed(0)
    M = torch.randn(D, D, generator=g, device="cuda", dtype=dtype)
    S = M @ M.T / D + torch.eye(D, device="cuda", dtype=dtype)
    b = torch.randn(D, generator=g, device="cuda", dtype=dtype)
    eye = torch.eye(D, device="cuda", dtype=dtype)

    def chol():
        L, info = torch.linalg.cholesky_ex(S)
        torch.cholesky_solve(b[:, None], L)
        return (info != 0) | ~torch.isfinite(L).all()

    chol_ms = time_ms(chol, reps=10)
    ridge_ms = time_ms(lambda: torch.linalg.solve_ex(S + 1e-6 * eye, b), reps=10)
    log(f"  dense path at D = {D}: Cholesky route {chol_ms:.4f} ms, the ridge LU beside it "
        f"{ridge_ms:.4f} ms an iteration")
    return ridge_ms


@contextlib.contextmanager
def gc_pauses():
    """The host garbage collector's pauses inside the block: yields a dict
    that holds, after the block, the collections by generation and their
    milliseconds."""
    out, t0 = {"collections": [0, 0, 0], "ms": 0.0}, [0.0]

    def note(phase, info):
        if phase == "start":
            t0[0] = time.perf_counter()
        else:
            out["collections"][info["generation"]] += 1
            out["ms"] += (time.perf_counter() - t0[0]) * 1e3

    gc.callbacks.append(note)
    try:
        yield out
    finally:
        gc.callbacks.remove(note)


def phase_headline_solve(headline, gt_cost, launches):
    from colmap_tpu_torch.estimators import bundle_adjustment as ba
    from colmap_tpu_torch.kernels import ba as K

    problem, model_id, packed, maps, masks = headline
    results = {}
    for solver in ("auto", "pcg"):
        options = ba.BAOptions(max_iterations=10, pcg_iterations=20, function_tolerance=0.0,
                               solver_type=solver)
        torch.cuda.synchronize()
        reset_all_launches()
        t0 = time.perf_counter()
        solved, cost, iters = ba.lm_solve_fused_packed(packed, maps, model_id, options, masks)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = all_launch_counts().only(lambda k, v: k in BA_SOURCES
                                          or k in ("ba_pcg", "ba_lm_update"))
        add_launches(launches, counts)
        log(f"headline solve ({solver}): final cost {cost:.6e} after {iters} iterations in "
            f"{dt:.3f} s = {iters / dt:.3f} LM iter/s; launches {counts}; K3 launches per "
            f"solve {counts['ba_schur_matvec']}")
        needed = [k for k in counts if (k != "ba_dense_schur_assemble" or solver == "auto")
                  and (k != "ba_pcg" or solver == "pcg")]
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
        # time (cuSOLVER, cuBLAS); a second one, the loop lm_solve_fused_packed
        # runs, times the steady state and reports what the loop did.
        use_dense = ba._use_dense(packed, options)
        with gc_pauses() as pauses:
            t0 = time.perf_counter()
            _, cost_warm, _, warm_info = ba._lm_loop(packed, maps, model_id, options, masks,
                                                     use_dense, True, with_info=True)
            torch.cuda.synchronize()
            dt_warm = time.perf_counter() - t0
        graph_ms = (warm_info["record_s"] + warm_info["instantiate_s"]) * 1e3
        log(f"  warm: the same solve again in {dt_warm:.3f} s = {iters / dt_warm:.3f} LM iter/s, "
            f"{dt_warm / iters * 1e3:.3f} ms per iteration, of which the graph's recording and "
            f"instantiation take {graph_ms / iters:.3f} (final cost {cost_warm:.6e}); "
            f"device-resident loop: {warm_info['host_reads']} host reads per solve (the done "
            f"flag every {ba.DONE_CHUNK} iterations, then the result), graph "
            f"{warm_info['graph']}: recorded in {warm_info['record_s'] * 1e3:.2f} ms, "
            f"instantiated in {warm_info['instantiate_s'] * 1e3:.2f} ms; the host's garbage "
            f"collector inside it: {pauses['collections']} collections by generation, "
            f"{pauses['ms']:.2f} ms")
        ridge_ms = _dense_solve_ms(packed) if use_dense else None
        _, cost_plain, iters_plain = ba._lm_loop(packed, maps, model_id, options, masks,
                                                 ba._use_dense(packed, options), True,
                                                 kernels=K.PLAIN)
        rel = abs(cost - cost_plain) / cost_plain
        log(f"  same loop through the plain versions: {cost_plain:.6e} "
            f"({iters_plain} iterations), relative difference {rel:.3e} (tol {K234_RTOL:g})")
        if not (rel <= K234_RTOL and abs(iters - iters_plain) <= 1):
            raise AssertionError(f"device loop vs plain loop: {rel:.3e}, {iters} vs "
                                 f"{iters_plain} iterations")
        sync_free_chunk(headline, solver)
        results[solver] = dict(final_cost=cost, iters=iters, iter_per_s=iters / dt,
                               warm_iter_per_s=iters / dt_warm, ridge_ms=ridge_ms,
                               host_reads=warm_info["host_reads"],
                               record_ms=warm_info["record_s"] * 1e3,
                               instantiate_ms=warm_info["instantiate_s"] * 1e3,
                               plain_cost=cost_plain, plain_iters=iters_plain)
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
        ours = sum(n for _, n, key in rows if "ctt::" in key)
        others = sum(n for _, n, key in rows) - ours
        log(f"profile ({solver}), per LM iteration: device busy {busy_ms:.3f} ms of "
            f"{wall_ms:.3f} ms warm wall time, idle share {1 - busy_ms / wall_ms:.3f}; "
            f"{ours:.1f} launches of the port's kernels, {others:.1f} of other device kernels "
            "(torch ops, memsets, cuSOLVER)")
        solves[solver]["idle_share"] = 1 - busy_ms / wall_ms
        solves[solver]["other_kernels_per_iter"] = others
        for ms, n, key in sorted(rows, reverse=True)[:12]:
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
    from colmap_tpu_torch.scene.reconstruction_io import write_model

    with tempfile.TemporaryDirectory() as tmp:
        src, dst = os.path.join(tmp, "in"), os.path.join(tmp, "out")
        recon = synthetic_reconstruction(120, 6000, seed=5)
        write_model(recon, src)
        log(f"CLI: model with {recon.num_reg_frames()} frames, {recon.num_points3D()} points, "
            f"{recon.compute_num_observations()} observations")
        torch.cuda.synchronize()
        reset_all_launches()
        t0 = time.perf_counter()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            cli.main(["bundle_adjuster", "--input_path", src, "--output_path", dst,
                      "--device", "cuda"])
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = all_launch_counts().only(lambda k, v: v)
        add_launches(launches, counts)
        log(buf.getvalue().strip() + f"  ({dt:.2f} s; launches {counts})")
        missing = [k for k in ("ba_obs_jacobians", "ba_lm_reduce", "ba_schur_matvec", "ba_pcg",
                               "ba_lm_update") if not counts.get(k)]
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
    from colmap_tpu_torch.kernels import meshing as KP
    from colmap_tpu_torch.kernels import mvs as KV
    from colmap_tpu_torch.kernels import retrieval as KT
    from colmap_tpu_torch.kernels import sfm as K
    from colmap_tpu_torch.kernels import sift as KS
    from colmap_tpu_torch.kernels import solver as KL
    from colmap_tpu_torch.kernels import spherical as KQ
    from colmap_tpu_torch.kernels import lines as KN
    from colmap_tpu_torch.kernels import sprt as KW
    from colmap_tpu_torch.kernels import aliked as KA
    from colmap_tpu_torch.kernels import lightglue as KLG

    return KB, K, KM, KS, KV, KG, KR, KT, KQ, KL, KP, KW, KN, KA, KLG


class Counts(dict):
    """Launches by kernel, and ``shapes``: the launch shapes
    (kernels/tally.py) counted with them."""

    shapes: Counter

    def only(self, keep):
        """The counts of the kernels k with keep(k, launches), their shapes
        kept."""
        out = Counts({k: v for k, v in self.items() if keep(k, v)})
        out.shapes = self.shapes
        return out


def all_launch_counts():
    counts = Counts({k: v for mod in _kernel_modules() for k, v in mod.LAUNCHES.items()})
    counts.shapes = Counter()
    for mod in _kernel_modules():
        if hasattr(mod, "SHAPES"):
            counts.shapes.update(mod.SHAPES.counts)
    return counts


# Launch shapes of the driven paths: (kernel, entry, *sizes) -> launches,
# summed by add_launches beside ``launches``.
PATH_SHAPES = Counter()


def add_launches(launches, counts):
    """Add a driven run's ``counts`` (all_launch_counts, or a part of them)
    to ``launches``, and their kernels' launch shapes to PATH_SHAPES."""
    for k, v in counts.items():
        launches[k] += v
    for key, n in counts.shapes.items():
        if key[0] in counts:
            PATH_SHAPES[key] += n


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


def device_busy(prof, skip=None):
    """(busy ms, {kernel name: (ms, launches)}) of a profiled run: the union
    of the device intervals, read from the raw event list (key_averages()
    over millions of events takes longer than the run itself); kernels whose
    name holds ``skip`` are left out."""
    from torch.autograd import DeviceType

    spans, by_name = [], {}
    for e in prof.profiler.kineto_results.events():
        if (e.device_type() == DeviceType.CUDA and e.duration_ns() > 0
                and not (skip and skip in e.name())):
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
        log(f"  {label}: the profiler recorded no device time, or too little; not measured")
        return None
    idle = 1 - busy_ms / wall_ms
    log(f"  {label}, under the profiler: device busy {busy_ms:.4f} ms of {wall_ms:.4f} ms wall, "
        f"idle share {idle:.4f}")
    for name, (ms, cnt) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]:
        log(f"    {ms:12.4f} ms  {cnt:7g} launches  {name[:90]}")
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
              and k not in RIG_SOURCES and k not in RETRIEVAL_SOURCES
              and k not in CAMERA_SOURCES and k not in MESH_SOURCES and k not in OPTIONS_SOURCES
              and k not in TOOLS_SOURCES and k not in LEARNED_SOURCES
              and k not in COVARIANCE_SOURCES
              and k not in ("structure_less_ransac", "gen_abs_refine")]
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


MAPPER_STATE = {}


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
                ("mapper, full-size scene", CUT_FRAMES, 1000, FULL_FOCAL, True)):
            root = os.path.join(tmp, f"{frames}x{points}")
            os.makedirs(root)
            db_path, gt = make_scene(root, frames, points, focal)
            pairs = strip_to_features(db_path)
            verified, _, m_counts = run_matcher(db_path, label.replace("mapper", "matcher"))
            expected = sum(len(m) >= 15 for m in pairs.values())
            if verified != expected:
                raise AssertionError(f"{label}: verified {verified} of {expected} pairs")
            add_launches(launches, m_counts)
            out = os.path.join(root, "sparse")
            ctx = profile(activities=[ProfilerActivity.CUDA]) if full else contextlib.nullcontext()
            with ctx as prof:
                pipeline, dt, counts = run_mapper(db_path, out, label, min_launches=full)
            if full:
                profiled, wall_ms = prof, dt * 1e3
            add_launches(launches, counts)
            cmp = check_against_gt(out, gt, frames, label)
            if not full:
                from colmap_tpu_torch.scene.reconstruction_io import read_model

                MAPPER_STATE["verify"] = read_model(os.path.join(out, "0"))
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
    correspondences and to the plain version (float64, run on the card)."""
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
        add_launches(launches, counts)
        idle = log_busy("exhaustive_matcher, full width", busy_ms, by_name, dt * 1e3, top=8)
        log(f"  {len(truth)} pairs in {dt:.3f} s = {len(truth) / dt:.3f} pairs/s on "
            f"{nvidia_smi_line()}; launches { {k: counts[k] for k in MATCHER_KERNELS} }; "
            f"idle share {'not measured' if idle is None else f'{idle:.4f}'}")
        db = Database(db_path, must_exist=True)
        desc = {iid: torch.from_numpy(db.read_descriptors(iid)).cuda()
                for iid, _, _ in db.read_images()}
        t0 = time.perf_counter()
        worst = 1.0
        for (a, b), gen in sorted(truth.items()):
            got = {tuple(r) for r in db.read_matches(a, b).tolist()}
            gen = {tuple(r) for r in gen.tolist()}
            na, nb = len(desc[a]), len(desc[b])
            idx2, ok, _, _ = KM.match_similarity_plain(
                desc[a], desc[b], torch.ones(na, dtype=torch.bool, device="cuda"),
                torch.ones(nb, dtype=torch.bool, device="cuda"), MatchingOptions(),
                dtype=torch.float64)
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
            f"plain version's (float64, on the card, {time.perf_counter() - t0:.1f} s); CALIBRATED with "
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

    buf = io.StringIO()

    def run():
        with contextlib.redirect_stdout(buf):
            return cli.main(argv + ["--device", "cuda"])

    return _counted(label, run, kernels,
                    lambda dt: f"{buf.getvalue().strip().splitlines()[-1]} ({dt:.3f} s)")


def _counted(label, fn, kernels, what=None, launches=None):
    """fn() with every launch count at 0 before; logs ``label`` (with
    ``what(seconds)``, else the seconds) and the kernels it launched, adds
    them to ``launches`` if given, fails if a kernel of ``kernels`` did not
    launch; returns (result, seconds, launches of this call)."""
    torch.cuda.synchronize()
    reset_all_launches()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = all_launch_counts()
    if launches is not None:
        add_launches(launches, counts)
    log(f"{label}: {what(dt) if what else f'{dt:.3f} s'}")
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
        add_launches(launches, counts)
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
        add_launches(launches, counts)
        _, seconds["exhaustive_matcher"], counts = run_command(
            ["exhaustive_matcher", "--database_path", db_path], "exhaustive_matcher",
            MATCHER_KERNELS)
        add_launches(launches, counts)
        out = os.path.join(root, "sparse")
        # The rendered scene registers a frame from 2D-2D correspondences
        # alone (structure-less, K37).
        _, seconds["mapper"], counts = run_command(
            ["mapper", "--database_path", db_path, "--output_path", out, "--quiet"], "mapper",
            ("structure_less_ransac", "ba_pcg", "ba_lm_update", "relative_pose"))
        add_launches(launches, counts)
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
    from colmap_tpu_torch.kernels import meshing_cases as MC

    return MC.surface_distance(pts) / np.abs(pts[:, 2])


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
        add_launches(launches, counts)
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


# ---------------------------------------------------------------------------
# Phases mesh_kernels and mesh: the rest of MVS on the dense workspace.
# ---------------------------------------------------------------------------


def _mesh_inputs():
    """The dense phase's fused cloud as poisson_mesh hands it to the
    indicator: (points01, normals, weights) float32 on the card, and the
    cloud's points, normals, colours and the bounding box's scale."""
    from colmap_tpu_torch.kernels import meshing_cases as MC
    from colmap_tpu_torch.utils.ply import read_ply

    data = read_ply(os.path.join(DENSE_STATE["root"], "dense", "fused.ply"))
    pts = np.asarray(data["points"], dtype=np.float64)
    nrm = np.asarray(data["normals"], dtype=np.float64)
    nrm = nrm / np.maximum(np.linalg.norm(nrm, axis=1, keepdims=True), 1e-12)
    p01, _, scale = MC.normalize(pts)
    t = lambda a: torch.as_tensor(a, dtype=torch.float32).cuda().contiguous()  # noqa: E731
    return (t(p01), t(nrm), torch.ones(len(pts), device="cuda"), pts, nrm, data.get("colors"),
            scale)


def _twice_equal(fn):
    """fn's output and whether a second run gives the same bits."""
    a, b = fn(), fn()
    torch.cuda.synchronize()
    a_t = a if isinstance(a, tuple) else (a,)
    b_t = b if isinstance(b, tuple) else (b,)
    return a, all(torch.equal(x, y) for x, y in zip(a_t, b_t))


def _mesh_entry(name, fn, plain, bytes_moved, ops, library=None, plain_reps=3):
    ms = time_ms(fn, reps=10)
    plain_ms = time_ms(plain, reps=plain_reps)
    library_ms = time_ms(library, reps=5) if library else None
    b_ms, by = bound(bytes_moved, ops)
    lib = f", library {library_ms:.4f} ms" if library else ""
    log(f"    {name}: {ms:.4f} ms (plain {plain_ms:.3f} ms{lib}, bound {b_ms:.5f} ms by {by})")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=by, library_ms=library_ms)


def _poisson_depth(KM, x, n, w, depth, errs, failed):
    """K41-K44 at one depth: each entry against its plain version on the
    same inputs on the card, twice for the same bits, and timed. Returns
    {kernel: {entry: row}}."""
    import torch.nn.functional as Fnn

    N = 1 << depth
    P = x.shape[0]
    NNN, bins = N ** 3, N * N * (N // 2 + 1)
    out = {k: {} for k in MESH_SOURCES}
    tag = f"depth {depth} (N = {N})"
    log(f"  {tag}, {P} samples, {8 * P} contributions:")

    def record(kernel, label, ok, a=0.0, r=0.0):
        errs[kernel].append((a, r))
        if not ok:
            failed.append(f"{tag}: {label}")

    # K41 (a): corners and weights, equal to the plain version.
    (keys, wk), same = _twice_equal(lambda: KM.splat_corners(x, w, N))
    kp, wp = KM.splat_corners_plain(x, w, N)
    ok = same and torch.equal(keys, kp) and torch.equal(wk, wp)
    log(f"    K41 (a): keys and weights equal to the plain version: {ok}")
    record("poisson_splat", "K41 (a)", ok)
    sort_ms = time_ms(lambda: torch.sort(keys, stable=True), reps=5)
    ks, perm = torch.sort(keys, stable=True)
    runs = torch.unique_consecutive(ks, return_counts=True)[1]
    # K41 (b): the sums in float64 in sorted order; the plain version's
    # float64 index_add_ on the card adds in another order.
    grid, same = _twice_equal(lambda: KM.splat_sum(ks, perm, wk, n, N))
    a, r = rel_err(grid, KM.splat_sum_plain(ks, perm, wk, n, N))
    ok = same and r <= K41_RTOL
    log(f"    K41 (b): {len(runs)} voxels hit, longest run {int(runs.max())}; max_abs_err "
        f"{a:.3e} rel {r:.3e} (tol {K41_RTOL:g}), same bits twice: {same}")
    record("poisson_splat", "K41 (b)", ok, a, r)
    # K42 (a) along x, y, z and (b): equal to the plain versions.
    blurred = grid
    for axis in (0, 1, 2):
        nxt, same = _twice_equal(lambda: KM.blur(blurred, axis))
        ok = same and torch.equal(nxt, KM.blur_plain(blurred, axis))
        record("poisson_stencil", f"K42 (a) axis {axis}", ok)
        blurred = nxt
    div, same = _twice_equal(lambda: KM.divergence(blurred))
    ok = same and torch.equal(div, KM.divergence_plain(blurred))
    log(f"    K42 (a) x, y, z and (b): equal to the plain versions, same bits twice: "
        f"{not any(f.startswith(tag + ': K42') for f in failed)}")
    record("poisson_stencil", "K42 (b)", ok)
    # K43: cosines of two libraries.
    fft_ms = time_ms(lambda: torch.fft.rfftn(div), reps=5)
    spec = torch.fft.rfftn(div)
    got, same = _twice_equal(lambda: KM.spectral_divide_(spec.clone(), 1.0))
    a, r = rel_err(torch.view_as_real(got),
                   torch.view_as_real(KM.spectral_divide_plain(spec, 1.0)))
    log(f"    K43: max_abs_err {a:.3e} rel {r:.3e} (tol {K43_RTOL:g}), same bits twice: {same}")
    record("poisson_spectral", "K43", same and r <= K43_RTOL, a, r)
    out["poisson_spectral"]["bits"] = _k43_bits(KM, spec, got, depth)
    chi = torch.fft.irfftn(got, s=(N, N, N))
    # K44 (a) against the float64 plain gather, (b) equal to chi - iso.
    iso, same = _twice_equal(lambda: KM.iso_level(chi, x, w))
    iso64 = KM.iso_level_plain(chi.double(), x.double(), w.double())
    a, r = rel_err(iso, iso64)
    log(f"    K44 (a): iso {float(iso):.9g} (float64 {float(iso64):.9g}), rel {r:.3e} (tol "
        f"{K44_RTOL:g}), same bits twice: {same}")
    record("poisson_iso", "K44 (a)", same and r <= K44_RTOL, a, r)
    shifted = KM.shift_(chi.clone(), iso)
    ok = torch.equal(shifted, chi - iso) and torch.equal(KM.shift_(chi.clone(), iso), shifted)
    record("poisson_iso", "K44 (b)", ok)

    # Times; bounds from this run's counts (16 bytes a sample in, 8 keys and
    # weights out; the grid 16 N^3 bytes; the spectrum 8 bytes a bin).
    log(f"    (the stable sort of the keys {sort_ms:.4f} ms, rfftn {fft_ms:.4f} ms)")
    flat = [(c, ks.long()) for c in range(4)]
    vals = torch.cat([n[perm // 8] * wk[perm][:, None], wk[perm][:, None]], 1).t().contiguous()
    cidx = torch.cat([torch.full_like(i, c) for c, i in flat])
    kidx = torch.cat([i for _, i in flat])
    out["poisson_splat"]["(a)"] = _mesh_entry(
        "K41 (a) corners", lambda: KM.splat_corners(x, w, N),
        lambda: KM.splat_corners_plain(x, w, N), P * (16 + 64), P * (12 + 3 + 8 * 13))
    out["poisson_splat"]["(b)"] = _mesh_entry(
        "K41 (b) sums", lambda: KM.splat_sum(ks, perm, wk, n, N),
        lambda: KM.splat_sum_plain(ks, perm, wk, n, N),
        8 * P * (4 + 8 + 4) + 12 * P + 16 * NNN, 8 * P * 7,
        library=lambda: torch.zeros((4, NNN), device="cuda").index_put_(
            (cidx, kidx), vals.reshape(-1), accumulate=True))
    weight = torch.tensor([0.25, 0.5, 0.25], device="cuda")
    g5 = grid.reshape(4, 1, N, N, N)
    out["poisson_stencil"]["(a)"] = _mesh_entry(
        "K42 (a) one blur pass (x)", lambda: KM.blur(grid, 0), lambda: KM.blur_plain(grid, 0),
        2 * 16 * NNN, 4 * 4 * NNN,
        library=lambda: Fnn.conv3d(Fnn.pad(g5, (0, 0, 0, 0, 1, 1), mode="circular"),
                                   weight.reshape(1, 1, 3, 1, 1)))
    out["poisson_stencil"]["(b)"] = _mesh_entry(
        "K42 (b) divergence", lambda: KM.divergence(blurred),
        lambda: KM.divergence_plain(blurred), 16 * NNN, 6 * NNN)
    lam = KM.laplacian_eigenvalues(N, "cuda") - np.float32(1e-4)
    work = spec.clone()
    out["poisson_spectral"]["(a)"] = _mesh_entry(
        "K43 spectral divide", lambda: KM.spectral_divide_(work, 1.0),
        lambda: KM.spectral_divide_plain(spec, 1.0), 16 * bins, 5 * bins,
        library=lambda: torch.div(spec, lam))
    shift_buf = chi.clone()
    out["poisson_iso"]["(a)"] = _mesh_entry(
        "K44 (a) iso level", lambda: KM.iso_level(chi, x, w),
        lambda: KM.iso_level_plain(chi, x, w), 48 * P + 4, P * (15 + 8 * 16))
    out["poisson_iso"]["(b)"] = _mesh_entry(
        "K44 (b) shift", lambda: KM.shift_(shift_buf, iso), lambda: KM.shift_plain(chi, iso),
        8 * NNN, NNN)
    del grid, blurred, div, spec, got, chi, shifted, work, shift_buf, vals, cidx, kidx, lam, g5
    torch.cuda.empty_cache()
    return out


def _k43_bits(KM, spec, got, depth):
    """Whether K43's output on this spectrum has the bits of its tables'
    model divided on the card (laplacian_axis_terms with torch's cos and
    divide), and the SHA-256 (16 hex digits) of its output on a seeded
    spectrum, rfftn(randn(N^3)) from torch.Generator seed `depth`, which
    tools/ab_cases.py's spectral case digests the same way for two trees."""
    import hashlib

    N = 1 << depth
    e_ij, e_k = KM.laplacian_axis_terms(N, "cuda")
    den = ((e_ij[:, None, None] + e_ij[None, :, None]) + e_k[None, None, :]) - np.float32(1e-4)
    model = torch.equal(torch.view_as_real(torch.complex(spec.real / den, spec.imag / den)),
                        torch.view_as_real(got))
    seeded = torch.fft.rfftn(torch.randn(N, N, N, generator=torch.Generator().manual_seed(
        depth)).cuda())
    digest = hashlib.sha256(torch.view_as_real(KM.spectral_divide_(seeded, 1.0)).contiguous()
                            .cpu().numpy().tobytes()).hexdigest()[:16]
    log(f"    K43: the bits of its tables' model on the card: {model}; on the seeded spectrum "
        f"sha256 {digest}")
    del den, seeded
    return {"model_same_bits": model, "seeded_sha256": digest}


def phase_mesh_kernels():
    """K41-K44 against their plain versions on the dense phase's fused cloud
    at depth 8 (the path's) and depth 9, each run twice for the same bits,
    and timed; the whole indicator chi - iso against the plain path in
    float64 on the card within MESH_INDICATOR_RTOL of its largest
    magnitude, twice for the same bits, under sync debug mode "error".
    Returns (errs, rows)."""
    from colmap_tpu_torch.kernels import meshing as KM

    errs = {k: [] for k in MESH_SOURCES}
    failed = []
    x, n, w, *_ = _mesh_inputs()
    log(f"Poisson kernels vs plain on the dense scene's fused cloud ({x.shape[0]} samples):")
    by_depth = {d: _poisson_depth(KM, x, n, w, d, errs, failed) for d in MESH_DEPTHS}
    N = 1 << MESH_DEPTHS[0]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        chi, dens = KM.poisson_indicator(x, n, w, N, 1.0)
        chi2, dens2 = KM.poisson_indicator(x, n, w, N, 1.0)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    same = torch.equal(chi, chi2) and torch.equal(dens, dens2)
    del chi2, dens2
    chi64, dens64 = KM.poisson_indicator_plain(x.double(), n.double(), w.double(), N, 1.0)
    a, r = rel_err(chi, chi64)
    ad, rd = rel_err(dens, dens64)
    log(f"  the indicator at depth {MESH_DEPTHS[0]}: chi - iso max_abs_err {a:.3e} rel {r:.3e} "
        f"(tol {MESH_INDICATOR_RTOL:g}), W_s rel {rd:.3e}; same bits twice: {same}; no host "
        "read between the splat and the shift (sync debug mode error)")
    if not (same and r <= MESH_INDICATOR_RTOL and rd <= MESH_INDICATOR_RTOL):
        failed.append("the indicator")
    del chi, dens, chi64, dens64
    for d in MESH_DEPTHS:
        _, dt = _timed(lambda: KM.poisson_indicator(x, n, w, 1 << d, 1.0))
        log(f"  the indicator at depth {d}: {dt * 1e3:.2f} ms wall (splat to shift)")
    torch.cuda.empty_cache()
    rows = {}
    for kernel, main_entry in (("poisson_splat", "(b)"), ("poisson_stencil", "(a)"),
                               ("poisson_spectral", "(a)"), ("poisson_iso", "(a)")):
        row = dict(by_depth[MESH_DEPTHS[0]][kernel][main_entry])
        row["entries"] = {f"{e} depth {d}": {k: v for k, v in ent.items() if k != "bound_by"}
                          for d in MESH_DEPTHS for e, ent in by_depth[d][kernel].items()
                          if not (d == MESH_DEPTHS[0] and e == main_entry)}
        rows[kernel] = row
    if failed:
        raise AssertionError(f"Poisson kernels differ from their plain versions: {failed}")
    return errs, rows


def _mesh_stats(verts, voxel):
    from colmap_tpu_torch.kernels import meshing_cases as MC

    d = MC.surface_distance(np.asarray(verts, dtype=np.float64)) / voxel
    return float(np.median(d)), float((d <= MESH_WITHIN_VOXELS).mean())


def _atlas_faces(F, options):
    """(A, A) face index of each atlas texel (-1 in the gutters), from the
    port's layout."""
    from colmap_tpu_torch.mvs.texturing import atlas_layout

    s, cell, grid, A, placed = atlas_layout(F, options)
    owner = np.full((A, A), -1, dtype=np.int64)
    ii, jj = np.mgrid[0:s, 0:s]
    lower = ii + jj <= s - 1
    for fi in range(placed):
        gy, gx = divmod(fi // 2, grid)
        y0, x0 = gy * cell + 1, gx * cell + 1
        mask = lower if fi % 2 == 0 else ~lower
        owner[y0 + ii[mask], x0 + jj[mask]] = fi
    return owner


def _texture_views(sparse, images_dir):
    from colmap_tpu_torch.mvs.workspace import _pinhole_K
    from colmap_tpu_torch.scene.reconstruction_io import read_model
    from colmap_tpu_torch.utils.image_io import read_image, to_rgb

    recon = read_model(sparse)
    views, images = [], {}
    for iid in recon.reg_image_ids():
        img = recon.images[iid]
        cam = recon.cameras[img.camera_id]
        pose = recon.cam_from_world(iid)
        images[iid] = to_rgb(read_image(os.path.join(images_dir, img.name)))
        views.append({"K": _pinhole_K(cam), "R": pose.rotmat(), "t": pose.t.copy(),
                      "width": cam.width, "height": cam.height, "image_key": iid})
    return views, images


def _subsampled_workspace(ws, out, stride):
    """Every stride-th fused point of ws with its normal, colour and .vis
    list, and ws's sparse model, as a workspace at out."""
    from colmap_tpu_torch.mvs.fusion import read_fused_vis, write_fused_vis
    from colmap_tpu_torch.utils.ply import read_ply, write_ply

    data = read_ply(os.path.join(ws, "fused.ply"))
    vis = read_fused_vis(os.path.join(ws, "fused.ply.vis"))
    os.makedirs(out, exist_ok=True)
    keep = np.arange(0, len(data["points"]), stride)
    write_ply(os.path.join(out, "fused.ply"), data["points"][keep], data["normals"][keep],
              None if data.get("colors") is None else data["colors"][keep])
    write_fused_vis(os.path.join(out, "fused.ply.vis"), [vis[i] for i in keep])
    shutil.copytree(os.path.join(ws, "sparse"), os.path.join(out, "sparse"))
    return len(keep)


def phase_mesh(launches):
    """The rest of MVS through the CLI on cuda, each command under
    torch.profiler (wall time, idle share): `poisson_mesher` on the dense
    workspace's fused cloud at depth 8, `mesh_simplifier --factor 0.1` on
    its mesh, `mesh_texturer` on that, `delaunay_mesher` and
    `advancing_front_mesher` on a subsampled workspace, `image_rectifier` on
    two of the dense views, `image_undistorter --output_type PMVS` and
    `CMP-MVS`; each held to its gates, the card's results against the CPU
    path's where the slice names one."""
    from colmap_tpu_torch.image.rectification import rectify_and_undistort_stereo_images
    from colmap_tpu_torch.mvs import meshing as MM
    from colmap_tpu_torch.mvs import texturing as MT
    from colmap_tpu_torch.scene.reconstruction_io import read_model
    from colmap_tpu_torch.utils.image_io import read_image
    from colmap_tpu_torch.utils.ply import read_ply_mesh

    root = DENSE_STATE["root"]
    ws = os.path.join(root, "dense")
    out = os.path.join(root, "mesh")
    os.makedirs(out, exist_ok=True)
    _, _, _, pts, nrm, colors, scale = _mesh_inputs()
    N = 1 << MESH_DEPTHS[0]
    voxel = scale / N
    seconds, idle, failed = {}, {}, []

    def command(label, argv, kernels=()):
        res, seconds[label], idle[label] = _profiled_command(argv, label, kernels, launches)
        return res

    # 1. Poisson at depth 8, against the analytic surface and the CPU path.
    poisson = os.path.join(out, "meshed-poisson.ply")
    verts, faces, _ = command("poisson_mesher", [
        "poisson_mesher", "--input_path", os.path.join(ws, "fused.ply"), "--output_path",
        poisson], tuple(MESH_SOURCES))
    med, within = _mesh_stats(verts, voxel)
    t0 = time.perf_counter()
    v_cpu, f_cpu, _ = MM.poisson_mesh(pts, nrm, colors, MM.PoissonMeshingOptions(depth=8),
                                      device="cpu")
    cpu_s = time.perf_counter() - t0
    dv = abs(len(verts) - len(v_cpu)) / max(len(v_cpu), 1)
    df = abs(len(faces) - len(f_cpu)) / max(len(f_cpu), 1)
    log(f"  poisson_mesher: {len(verts)} vertices, {len(faces)} faces (the CPU path "
        f"{len(v_cpu)}, {len(f_cpu)} in {cpu_s:.1f} s: differ by {dv:.2e}, {df:.2e}; tol "
        f"{MESH_MAX_COUNT_DIFF:g}); voxel {voxel:.5f}: median distance to the surface "
        f"{med:.4f} voxels (<= {MESH_MAX_MEDIAN_VOXELS}), {within:.4f} within "
        f"{MESH_WITHIN_VOXELS} voxels (>= {MESH_MIN_WITHIN})")
    if not (med <= MESH_MAX_MEDIAN_VOXELS and within >= MESH_MIN_WITHIN
            and dv <= MESH_MAX_COUNT_DIFF and df <= MESH_MAX_COUNT_DIFF and len(faces)):
        failed.append("poisson_mesher")

    # 2. Quadric simplification to a tenth.
    simple = os.path.join(out, "meshed-simple.ply")
    sv, sf = command("mesh_simplifier", ["mesh_simplifier", "--input_path", poisson,
                                         "--output_path", simple, "--factor", "0.1"])
    s_med, _ = _mesh_stats(sv, voxel)
    kept = len(sf) / max(len(faces), 1)
    log(f"  mesh_simplifier: {len(faces)} -> {len(sf)} faces ({kept:.4f} kept, <= "
        f"{SIMPLIFY_MAX_KEPT}), median distance {s_med:.4f} voxels (<= "
        f"{SIMPLIFY_MAX_MEDIAN_VOXELS})")
    if not (kept <= SIMPLIFY_MAX_KEPT and s_med <= SIMPLIFY_MAX_MEDIAN_VOXELS and len(sf)):
        failed.append("mesh_simplifier")

    # 3. Texturing, against the CPU path on the same views and images.
    atlas, _, labels = command("mesh_texturer", [
        "mesh_texturer", "--input_path", simple, "--sparse_path", os.path.join(ws, "sparse"),
        "--image_path", os.path.join(ws, "images"), "--output_path",
        os.path.join(out, "textured.obj")], ("camera_map",))
    mesh = read_ply_mesh(simple)
    views, images = _texture_views(os.path.join(ws, "sparse"), os.path.join(ws, "images"))
    atlas_cpu, _, labels_cpu = MT.texture_mesh(mesh["vertices"], mesh["faces"], views, images,
                                               device="cpu")
    labelled = float((labels >= 0).mean())
    same = float((labels == labels_cpu).mean())
    owner = _atlas_faces(len(labels), MT.TextureMappingOptions())
    agree = np.where(owner >= 0, (labels == labels_cpu)[np.maximum(owner, 0)], True)
    texel = int(np.abs(atlas.astype(int) - atlas_cpu.astype(int))[agree].max())
    log(f"  mesh_texturer: {labelled:.4f} of {len(labels)} faces labelled (>= "
        f"{TEX_MIN_LABELLED}), labels equal to the CPU path's on {same:.5f} (>= "
        f"{TEX_MIN_SAME_LABEL}), atlas {atlas.shape[0]}^2 within {texel} counts where they "
        "agree (<= 1)")
    if not (labelled >= TEX_MIN_LABELLED and same >= TEX_MIN_SAME_LABEL and texel <= 1):
        failed.append("mesh_texturer")

    # 4. Delaunay and the advancing front on a subsampled workspace.
    stride = max(1, len(pts) // MESH_SUBSAMPLE)
    sub = os.path.join(out, "sub")
    n_sub = _subsampled_workspace(ws, sub, stride)
    for label, argv in (
            ("delaunay_mesher", ["delaunay_mesher", "--input_path", sub]),
            ("advancing_front_mesher", ["advancing_front_mesher", "--input_path",
                                        os.path.join(sub, "fused.ply")])):
        v, f = command(label, argv + ["--output_path", os.path.join(out, label + ".ply")])
        cen = np.asarray(v, dtype=np.float64)[f].mean(axis=1) if len(f) else np.zeros((0, 3))
        err = float(np.median(fused_relative_error(cen))) if len(f) else 1.0
        log(f"  {label}: every {stride}-th fused point ({n_sub}), {len(f)} faces, median "
            f"face-centroid distance to the surface over depth {err:.5f} (<= "
            f"{DENSE_MAX_FUSED_ERR})")
        if not (len(f) and err <= DENSE_MAX_FUSED_ERR):
            failed.append(label)

    # 5. Rectification of two dense views, against the CPU path.
    recon = read_model(os.path.join(root, "sparse"))
    names = [recon.images[i].name for i in sorted(recon.reg_image_ids())[:2]]
    with open(os.path.join(out, "pairs.txt"), "w") as fh:
        fh.write(f"{names[0]} {names[1]}\n")
    rect = os.path.join(out, "rectified")
    command("image_rectifier", [
        "image_rectifier", "--image_path", os.path.join(root, "images"), "--input_path",
        os.path.join(root, "sparse"), "--output_path", rect, "--stereo_pairs_list",
        os.path.join(out, "pairs.txt")], ("camera_map",))
    stem = f"{os.path.splitext(names[0])[0]}-{os.path.splitext(names[1])[0]}"
    Q = np.loadtxt(os.path.join(rect, stem, "Q.txt"))
    ids = {recon.images[i].name: i for i in recon.reg_image_ids()}
    c1 = recon.cameras[recon.images[ids[names[0]]].camera_id]
    c2 = recon.cameras[recon.images[ids[names[1]]].camera_id]
    rel = recon.cam_from_world(ids[names[1]]).compose(recon.cam_from_world(ids[names[0]]).inverse())
    imgs = [read_image(os.path.join(root, "images", nm)) for nm in names]
    r_cpu = rectify_and_undistort_stereo_images(*imgs, c1, c2, rel, device="cpu")[:2]
    shares = []
    for nm, ref in zip(names, r_cpu):
        got = read_image(os.path.join(rect, stem, nm)).astype(int)
        shares.append(float((np.abs(got - ref.astype(int)) <= 1).mean()))
    log(f"  image_rectifier: Q finite {bool(np.isfinite(Q).all())}, pixels within 1 count of "
        f"the CPU path's {[round(s_, 6) for s_ in shares]} (>= {RECT_MIN_SAME})")
    if not (np.isfinite(Q).all() and min(shares) >= RECT_MIN_SAME):
        failed.append("image_rectifier")

    # 6. The PMVS and CMP-MVS exports: colmap_tpu's layout.
    n_reg = len(recon.reg_image_ids())
    for kind in ("PMVS", "CMP-MVS"):
        dst = os.path.join(out, kind)
        command(f"image_undistorter {kind}", [
            "image_undistorter", "--image_path", os.path.join(root, "images"), "--input_path",
            os.path.join(root, "sparse"), "--output_path", dst, "--output_type", kind],
            ("camera_map",))
        if kind == "PMVS":
            base = os.path.join(dst, "pmvs")
            txts = [os.path.join(base, "txt", f"{i:08d}.txt") for i in range(n_reg)]
            files = txts + [os.path.join(base, "visualize", f"{i:08d}.jpg") for i in range(n_reg)]
            files += [os.path.join(base, "option-all"), os.path.join(base, "vis.dat"),
                      os.path.join(dst, "run-pmvs.sh")]
            with open(os.path.join(base, "vis.dat")) as fh:
                ok = fh.readline().strip() == "VISDATA" and int(fh.readline()) == n_reg
        else:
            txts = [os.path.join(dst, f"{i + 1:05d}_P.txt") for i in range(n_reg)]
            files = txts + [os.path.join(dst, f"{i + 1:05d}.jpg") for i in range(n_reg)]
            ok = True
        ok = ok and all(os.path.exists(p) for p in files)
        ok = ok and all(open(p).readline().strip() == "CONTOUR" for p in txts)
        log(f"  image_undistorter --output_type {kind}: colmap_tpu's layout ({len(files)} "
            f"files, CONTOUR headers): {ok}")
        if not ok:
            failed.append(f"image_undistorter {kind}")

    log(f"  mesh phase on {nvidia_smi_line()}: seconds by command "
        f"{ {k: round(v, 3) for k, v in seconds.items()} }; idle share "
        f"{ {k: (None if v is None else round(v, 4)) for k, v in idle.items()} }")
    if failed:
        raise AssertionError(f"mesh: a gate failed: {failed}")
    return dict(seconds=seconds, idle=idle)

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
    GLOBAL_STATE["ra"] = (g32, g64, q, sigma)

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
    GLOBAL_STATE["gp"] = (p32, p64, c32, X32)
    return out


GLOBAL_STATE = {}


def _cg_steps(tag, mode, setup_args, matvec, steps, errs):
    """K39's set-up and ``steps`` steps against float64, each step fed the
    float32 matvec of the kernel's p; returns the kernel's state after the
    set-up (for timing) and the step at which the freeze rule fired."""
    from colmap_tpu_torch.kernels import global_sfm as G

    st = G.cg_setup(mode, *setup_args)
    ref = G.cg_setup_plain(mode, setup_args[0].double(), setup_args[1].double(),
                           *setup_args[2:])
    for f in G.CGState._fields:
        check(f"K39 {tag} set-up {f}", getattr(st, f), getattr(ref, f), K39_RTOL,
              errs["global_cg"])
    first = G.CGState(*(x.clone() for x in st))
    scale = {f: float(getattr(ref, f).abs().max()) for f in ("r", "z", "p")}
    frozen = None
    worst = [0.0, 0.0]
    for k in range(steps):
        if frozen is None and not bool(st.scal[0] > 1e-12 * st.scal[1]):
            frozen = k
        Ap = matvec(st.p)
        ref = G.cg_step_plain(mode, _as64(st), Ap.double())
        st = G.cg_step(mode, st, Ap)
        for f in G.CGState._fields:
            a = float((getattr(st, f).double() - getattr(ref, f)).abs().max())
            r = a / max(float(getattr(ref, f).abs().max()), scale.get(f, 0.0), 1e-300)
            worst = [max(worst[0], a), max(worst[1], r)]
    log(f"  K39 {tag}: {steps} steps, largest error {worst[1]:.3e} of each vector's scale "
        f"(tol {K39_RTOL:g}); freeze rule fired at step {frozen}")
    if not worst[1] <= K39_RTOL:
        raise AssertionError(f"K39 {tag}: {worst[1]:.3e} > {K39_RTOL:g}")
    errs["global_cg"].append(tuple(worst))
    return first, frozen


def _k39(errs, rows):
    """K39 in both modes against float64 on _k21's graph (1000 nodes x
    25 000 edges, the spanning tree's rotations, Geman-McClure weights) and
    _k22's problem (1000 cameras, the first round's state), each step fed
    the float32 matvec; timed. Then one iteration of each solver with its CG
    replayed from a CUDA graph (the replay under sync debug mode "error")
    against the same round run eagerly through the kernels (the same bits)
    and through the plain versions in float64 (logged)."""
    from colmap_tpu_torch.estimators import global_positioning as GPm
    from colmap_tpu_torch.estimators import rotation_averaging as RAm
    from colmap_tpu_torch.kernels import global_sfm as G
    from colmap_tpu_torch.utils import cuda_graph

    g32, g64, q, sigma = GLOBAL_STATE["ra"]
    p32, p64, c32, X32 = GLOBAL_STATE["gp"]
    dev = torch.device("cuda")
    step = G.ra_edge_pass(g32, q, False, sigma)
    st_ra, _ = _cg_steps("rotation mode", G.CG_ROTATION, (step.b, step.deg),
                         lambda x: G.ra_matvec(g32, step.ew, x), K39_STEPS, errs)
    sys = G.gp_setup(p32, c32, X32)
    st_gp, frozen = _cg_steps("positioning mode", G.CG_POSITIONING,
                              (sys.b, sys.diag_c, p32.eps_rel),
                              lambda x: G.gp_schur_matvec(p32, sys, x), K39_STEPS, errs)
    Ap = G.ra_matvec(g32, step.ew, st_ra.p)
    n = st_ra.x.numel()
    rows["global_cg"] = _global_row(
        "K39 step, rotation mode", lambda: G.cg_step(G.CG_ROTATION, st_ra, Ap),
        lambda: G.cg_step_plain(G.CG_ROTATION, _as64(st_ra), Ap.double()),
        4 * 8 * n + 16, K39_ENTRY_OPS * n, plain_reps=10)
    Ap_gp = G.gp_schur_matvec(p32, sys, st_gp.p)
    rows["global_cg"]["entries"] = {
        "setup_rotation": _entry_times(lambda: G.cg_setup(G.CG_ROTATION, step.b, step.deg),
                                       lambda: G.cg_setup_plain(G.CG_ROTATION, step.b.double(),
                                                                step.deg.double())),
        "step_positioning": _entry_times(
            lambda: G.cg_step(G.CG_POSITIONING, st_gp, Ap_gp),
            lambda: G.cg_step_plain(G.CG_POSITIONING, _as64(st_gp), Ap_gp.double()))}
    log(f"    K39 entries: {rows['global_cg']['entries']}")

    # One round of each solver through its CG graph.
    N, E = q.shape[0], g32.edges.shape[0]
    buf = G.ra_step_buffers(N, E, dev)
    cg = cuda_graph.StepGraph(lambda: RAm.solve_tangent_cg(g32, buf, 50), dev, (G,), True)
    for _ in range(2):  # eager, then recorded and replayed
        G.ra_edge_pass(g32, q, False, sigma, out=buf)
        cg()
    torch.cuda.set_sync_debug_mode("error")
    try:
        x_graph = cg()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    x_eager = RAm.solve_tangent_cg(g32, G.ra_edge_pass(g32, q, False, sigma), 50)
    x_plain = RAm.solve_tangent_cg(g64, G.ra_edge_pass_plain(g64, q.double(), False, sigma), 50,
                                   G.PLAIN)
    gbuf = G.gp_system_buffers(p32)
    gcg = cuda_graph.StepGraph(lambda: GPm._cg(p32, gbuf, 100, G.KERNELS), dev, (G,), True)
    for _ in range(2):
        GPm._irls_round(p32, c32, X32, 100, G.KERNELS, gcg, gbuf)
    G.gp_setup(p32, c32, X32, out=gbuf)
    torch.cuda.set_sync_debug_mode("error")
    try:
        xc_graph = gcg()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    xc_eager = GPm._cg(p32, G.gp_setup(p32, c32, X32), 100, G.KERNELS)
    xc_plain = GPm._cg(p64, G.gp_setup_plain(p64, c32.double(), X32.double()), 100, G.PLAIN)
    same = torch.equal(x_graph, x_eager) and torch.equal(xc_graph, xc_eager)
    log(f"  CG graphs (recorded in {cg.record_s * 1e3:.2f} and {gcg.record_s * 1e3:.2f} ms, "
        f"instantiated in {cg.instantiate_s * 1e3:.2f} and {gcg.instantiate_s * 1e3:.2f} ms): "
        f"a replay of each ran under sync debug mode \"error\"; rotation CG (50 steps) and "
        f"positioning CG (100 steps) replayed equal the eager rounds bit for bit: {same}; "
        f"against the float64 plain rounds: {rel_err(x_graph, x_plain)[1]:.3e} and "
        f"{rel_err(xc_graph, xc_plain)[1]:.3e} of the step's scale (logged)")
    if not same:
        raise AssertionError("K39: a CG replayed from its graph differs from the eager round")


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
    the plain versions in float64 on the card; then K39 (_k39). Returns
    (errs, rows, solves)."""
    errs = {k: [] for k in GLOBAL_SOURCES}
    rows = {}
    log("global-SfM kernels vs plain (float64 on the same inputs):")
    solves = dict(rotations=_k21(errs, rows), positioning=_k22(errs, rows),
                  calibration=_k23(errs, rows))
    _k39(errs, rows)
    torch.cuda.synchronize()
    return errs, rows, solves


GLOBAL_MAPPER_KERNELS = ("rotation_averaging", "global_positioning", "global_cg", "camera_map",
                         "ba_obs_jacobians", "ba_lm_reduce", "ba_schur_matvec", "ba_pcg",
                         "ba_lm_update", "relative_pose")


def _profiled_command(argv, label, kernels, launches, profiled=True):
    """run_command under torch.profiler; adds the launches to ``launches``
    and logs the device's idle share and its top items. With ``profiled``
    False (to keep the script's time: the profiler's stop and the reading
    of its trace cost ~15 s on a small scene, ~60 s on a 40-frame mapper
    run) it runs the command alone and gives no idle share."""
    from torch.profiler import ProfilerActivity, profile

    if not profiled:
        out, seconds, counts = run_command(argv, label, kernels)
        add_launches(launches, counts)
        return out, seconds, None
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.zeros(1, device="cuda").add_(1.0)  # let the tracer see a first kernel
        torch.cuda.synchronize()
        out, seconds, counts = run_command(argv, label, kernels)
        t1 = time.perf_counter()
    t2 = time.perf_counter()
    add_launches(launches, counts)
    busy_ms, by_name = device_busy(prof)
    idle = log_busy(label, busy_ms, by_name, seconds * 1e3, top=8)
    log(f"  (the profiler's stop {t2 - t1:.1f} s, reading its trace "
        f"{time.perf_counter() - t2:.1f} s, {time.perf_counter() - t0:.1f} s in all)")
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
            ("full-size scene", CUT_FRAMES, dict(num_points=1000, focal=FULL_FOCAL, seed=3),
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
                f"global_mapper, {label}", GLOBAL_MAPPER_KERNELS, launches,
                profiled=label == "full-size scene")
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


def _k38(problem, model_id, options, masks, errs):
    """K34's rig set-up (c) and step and K38's candidate and accept against
    their float64 plain versions on the rig headline's first LM step (lam
    1e-3), the padding columns 0; timed. Returns (K38's row, K34's rig
    entries, K34's errors)."""
    from colmap_tpu_torch.kernels import rig as KR
    from colmap_tpu_torch.kernels import rig_cases as RC
    from colmap_tpu_torch.kernels import solver as KL

    log("K34 (c), K38 vs float64 plain: rig headline")
    k34_errs = []
    lam = torch.tensor(1e-3, device="cuda")
    c = RC.lm_step_inputs(problem, model_id, options, masks, lam, KR.KERNELS)
    red = c["red"]
    R, W = red.b.shape
    red64 = _as64(red)
    M, b = red.precond.reshape(-1), red.b.reshape(-1)
    st = KL.pcg_setup_diag(M, b)
    ref = KL.pcg_setup_diag_plain(M.double(), b.double())
    for n, a, r in zip(KL.PCGState._fields, st, ref):
        check(f"K34 (c) set-up {n}", a, r, K34_RTOL, k34_errs)
    no_poses = torch.zeros(0, 6, device="cuda")
    Ap = KR.rig_schur_matvec(c["jac"], c["obs"], c["layout"], red.Hpp_inv, red.lam_diag,
                             st.p.view(R, W))
    ref = KL.pcg_step_plain(_as64(st), no_poses.double(), Ap.double(), None, None, None)
    st_t = KL.pcg_step(KL.PCGState(*(x.clone() for x in st)), no_poses, Ap.clone(), None, None,
                       None)
    for n, a, r in zip(KL.PCGState._fields, st_t, ref):
        check(f"K34 rig step {n}", a, r, K34_RTOL, k34_errs)
    pad = red.precond == 0
    if not all(bool((v.view(R, W)[pad] == 0).all()) for v in (st_t.x, st_t.r, st_t.z, st_t.p)):
        raise AssertionError("K34 rig step: a padding column is not 0")
    params = tuple(problem[:6])
    x, dx = c["x"], c["dx"]
    cand, pred = KR.rig_lm_candidate(params, x, dx, red, lam)
    cand64, pred64 = KR.rig_lm_candidate_plain(tuple(f64(*params)), x.double(), dx.double(),
                                               red64, lam.double())
    for n, a, r in zip(("quat", "t", "sensor_quat", "sensor_t", "cam_params", "points", "pred"),
                       (*cand, pred), (*cand64, pred64)):
        check(f"K38 candidate {n}", a, r, K38_RTOL, errs["rig_lm_update"])
    rest = (model_id, options.loss, options.loss_scale)
    new_cost = KR.rig_obs_cost64(*cand, c["obs"], *rest)
    S0 = torch.tensor([2.0, 0, 0, 0, 0, 0, 0, 0, 0], dtype=torch.float64, device="cuda")
    S0[1:3] = KR.rig_obs_cost64(*params, c["obs"], *rest)
    state = tuple(t.clone() for t in params)
    state64 = tuple(f64(*params))
    S, S64 = S0.clone(), S0.clone()
    lam_k, lam64 = lam.clone(), lam.double()
    flag, flag64 = (torch.zeros(1, dtype=torch.uint8, device="cuda") for _ in range(2))
    KR.rig_lm_accept(lam_k, S, new_cost, pred, state, cand, 1e-10, 1e10, 1e-6, flag)
    KR.rig_lm_accept_plain(lam64, S64, new_cost, pred, state64, cand64, 1e-10, 1e10, 1e-6,
                           flag64)
    log(f"  K38 accept: S {S.tolist()} (plain {S64.tolist()})")
    if not (torch.equal(S[[0, 3, 4, 5, 6]], S64[[0, 3, 4, 5, 6]]) and torch.equal(flag, flag64)):
        raise AssertionError("K38 accept: nu, the count or the flags differ from float64")
    check("K38 accept lam", lam_k, lam64, 1e-6, errs["rig_lm_update"])
    for n, a, r in zip(("quat", "t", "sensor_quat", "sensor_t", "cam_params", "points"), state,
                       state64):
        check(f"K38 accept state {n}", a, r, K38_RTOL, errs["rig_lm_update"])
    before = [t.clone() for t in state]
    KR.rig_lm_accept(lam_k, S, S[1].clone(), pred, state, cand, 1e-10, 1e10, 1e-6, flag)
    if not (S[5].item() == 0 and all(torch.equal(a, r) for a, r in zip(before, state))):
        raise AssertionError("K38 accept: a rejected step moved the state")
    F, G, N = problem.quat.shape[0], problem.sensor_quat.shape[0], problem.points.shape[0]
    CP = problem.cam_params.numel()
    state_bytes = 4 * (7 * (F + G) + CP + 3 * N)
    row = _solver_row(
        "rig_lm_update candidate",
        time_ms(lambda: KR.rig_lm_candidate(params, x, dx, red, lam)),
        time_ms(lambda: KR.rig_lm_candidate_plain(tuple(f64(*params)), x.double(), dx.double(),
                                                  red64, lam.double()), reps=10),
        bound(2 * state_bytes + 4 * (3 * R * W + 9 * N),
              K35_FRAME_OPS * (F + G) + K35_CAM_OPS * R * W + K35_POINT_OPS * N))

    def accept():
        S.copy_(S0)  # an accepted step each time: the copy runs
        KR.rig_lm_accept(lam_k, S, new_cost, pred, state, cand, 1e-10, 1e10, 1e-6, flag)

    def accept_plain():
        S64.copy_(S0)
        KR.rig_lm_accept_plain(lam64, S64, new_cost, pred, state64, cand64, 1e-10, 1e10, 1e-6,
                               flag64)

    row["entries"] = {"accept": _entry_times(accept, accept_plain)}
    st64 = _as64(st)
    k34 = {"rig_setup_diag": _entry_times(lambda: KL.pcg_setup_diag(M, b),
                                          lambda: KL.pcg_setup_diag_plain(M.double(), b.double())),
           "rig_step": _entry_times(
               lambda: KL.pcg_step(st_t, no_poses, Ap, None, None, None),
               lambda: KL.pcg_step_plain(st64, no_poses.double(), Ap.double(), None, None, None))}
    log(f"    rig_lm_update accept, K34's rig entries: {row['entries']}, {k34}")
    return row, k34, k34_errs


def _rig_loop_costs(problem, model_id, options, masks):
    """The device-resident rig LM loop on the headline: one graph replay
    and one eager iteration under sync debug mode "error" (no host read),
    then a warm solve under the profiler: its wall per iteration, idle
    share, host reads, and its graph's record and instantiate times."""
    from torch.profiler import ProfilerActivity, profile

    from colmap_tpu_torch.estimators import bundle_adjustment as ba
    from colmap_tpu_torch.estimators import bundle_adjustment_rig as rba
    from colmap_tpu_torch.kernels import rig as KR
    from colmap_tpu_torch.kernels import solver as KL
    from colmap_tpu_torch.kernels.ba import model_groups
    from colmap_tpu_torch.utils import cuda_graph

    om, layout = rba._obs_masks(masks, options), rba._layout(problem)
    groups = model_groups(model_id, problem.cam_params, problem.obs_cam)
    state = problem._replace(**{k: getattr(problem, k).clone() for k in
                                ("quat", "t", "sensor_quat", "sensor_t", "cam_params",
                                 "points")})
    cost = KR.rig_obs_cost64(*state[:6], rba._obs(state), model_id, options.loss,
                             options.loss_scale)
    sc = ba._lm_scalars(cost, options.initial_lambda, 2.0, torch.float32)

    def step():
        rba._lm_iteration(state, layout, model_id, options, om, sc, KR.KERNELS, groups)

    step()
    replay, _, _, _ = cuda_graph.capture(step, torch.device("cuda"), (KR, KL))
    torch.cuda.set_sync_debug_mode("error")
    try:
        replay()
        step()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    log("  rig loop: a graph replay and an eager iteration ran under sync debug mode \"error\"")
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.zeros(1, device="cuda").add_(1.0)
        torch.cuda.synchronize()
        (_, cost, iters, info), wall = _timed(lambda: rba._lm_loop(problem, model_id, options,
                                                                     masks, with_info=True))
    busy_ms, by_name = device_busy(prof)
    idle = log_busy("rig solve, warm", busy_ms, by_name, wall * 1e3, top=8)
    log(f"  rig solve, warm: {iters} LM iterations in {wall:.3f} s, {wall / iters * 1e3:.3f} ms "
        f"an iteration (the host loop it replaced: 0.090 s for 10), {info['host_reads']} host reads, graph "
        f"{info['graph']}: recorded in {info['record_s'] * 1e3:.2f} ms, instantiated in "
        f"{info['instantiate_s'] * 1e3:.2f} ms; final cost {cost:.6e}")
    return dict(seconds=wall, iters=iters, idle=idle, **info)


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
    Then K34's rig entries and K38 against float64 and the device-resident
    loop's costs. Returns (errs, rows, agree, K34's rig entries and
    errors)."""
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
    rows["rig_lm_update"], k34_entries, k34_errs = _k38(problem, model_id, options, masks, errs)

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
    missing = [k for k in ("rig_ba_jacobians", "rig_ba_reduce", "rig_ba_matvec", "rig_lm_update")
               if launches[k] == 0]
    if missing:
        raise AssertionError(f"rig solve: launched no {missing}")
    _rig_loop_costs(problem, model_id, options, masks)
    torch.cuda.synchronize()
    return errs, rows, agree, dict(entries={"ba_pcg": k34_entries}, errs={"ba_pcg": k34_errs})


# The kernels each rig scene's mapper must launch: the verify scene's initial
# pair triangulates most points, so K8 and K9 may find no work there; the
# full-size scene runs every one.
RIG_VERIFY_KERNELS = ("camera_map", "essential_ransac", "ba_pcg", "gen_abs_refine", *RIG_SOURCES)
RIG_MAPPER_KERNELS = ("camera_map", "essential_ransac", "triangulate_tracks", "filter_points",
                      "ba_pcg", "gen_abs_refine", *RIG_SOURCES)


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
            add_launches(launches, m_counts)
            out = os.path.join(root, "sparse")
            pipeline, seconds, idle = _profiled_command(
                ["mapper", "--database_path", db_path, "--output_path", out, "--quiet"],
                f"mapper, {label}",
                RIG_VERIFY_KERNELS if label.startswith("verify") else RIG_MAPPER_KERNELS, launches,
                profiled=not label.startswith("verify"))
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


RETRIEVAL_STATE = {}


def _retrieval_corpus():
    """The 1000-image corpus (made once, shared by both retrieval phases)."""
    from colmap_tpu_torch.kernels import retrieval_cases as TC

    if "corpus" not in RETRIEVAL_STATE:
        t0 = time.perf_counter()
        RETRIEVAL_STATE["corpus"] = TC.corpus(RET_IMAGES, RET_PER_IMAGE, seed=0)
        log(f"retrieval corpus: {RET_IMAGES} images x {RET_PER_IMAGE} uint8 descriptors, windows "
            f"of {RETRIEVAL_STATE['corpus'].window} pool rows every "
            f"{RETRIEVAL_STATE['corpus'].step} (set-up {time.perf_counter() - t0:.1f} s)")
    return RETRIEVAL_STATE["corpus"]


def _builder_sample(n):
    """The rows vocab_tree_builder trains on (its rng(0) subsample)."""
    return np.random.default_rng(0).choice(n, RET_SAMPLE, replace=False)


def gram_work(W):
    """(bytes, f32 operations) that S = W Wᵀ needs on this W: W read once and
    S written once; an FMA for each pair i <= j of images and each word both
    hold (S is symmetric, and a product with a zero adds nothing)."""
    c = (W != 0).sum(0).double()
    return nbytes(W) + 4 * W.shape[0] ** 2, float((c * (c + 1)).sum())


def descend_work(x, leaves, B, L):
    """(bytes, f32 operations) K30 needs on these rows: each row read once,
    its leaf written once, and each child row the call touches read once
    (the B children of every node a row passes through, from the leaves);
    RET_DIST_OPS a (row, child, dim)."""
    N, D = x.shape
    leaves = leaves.long()
    nodes = sum(int(torch.unique(leaves // B ** (L - lv)).numel()) for lv in range(L))
    return nbytes(x) + 4 * N + nodes * B * D * 4, RET_DIST_OPS * N * B * L * D


def graph_launches(fn):
    """(CUDA launches, {kind: count}) of one call of fn: the kernel, memset
    and copy nodes of a CUDA graph captured from that call, counted by the
    driver (cuGraphGetNodes); (None, reason) where the capture or the count
    fails."""
    import ctypes

    fn()
    torch.cuda.synchronize()
    try:
        g = torch.cuda.CUDAGraph(keep_graph=True)
        with torch.cuda.graph(g, capture_error_mode="relaxed"):
            fn()
        cu = ctypes.CDLL("libcuda.so.1")
        graph, n = ctypes.c_void_p(g.raw_cuda_graph()), ctypes.c_size_t(0)
        if cu.cuGraphGetNodes(graph, None, ctypes.byref(n)):
            raise RuntimeError("cuGraphGetNodes failed")
        nodes = (ctypes.c_void_p * n.value)()
        if cu.cuGraphGetNodes(graph, nodes, ctypes.byref(n)):
            raise RuntimeError("cuGraphGetNodes failed")
        kinds = {}
        for node in nodes:
            t = ctypes.c_int(-1)
            if cu.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(t)):
                raise RuntimeError("cuGraphNodeGetType failed")
            kind = {0: "kernel", 1: "memcpy", 2: "memset", 5: "empty"}.get(t.value, t.value)
            kinds[kind] = kinds.get(kind, 0) + 1
        del g
    except Exception as e:  # a measurement, not a check: reported as not measured
        return None, f"not measured: {e!r}"
    return sum(v for k, v in kinds.items() if k != "empty"), kinds


def _descend_regimes(KT, x, flat, B, L):
    """K30's two regimes (``_descend_run``) timed on the first n rows of x
    for n around DESCEND_SORTED_MIN_ROWS and at all of them, their leaves
    the same bits at each n: where they cross places the threshold."""
    D = x.shape[1]
    plans = {"direct": KT.DescendPlan("direct", ((0, L),), 0, 1),
             "sorted": KT._descend_plan(KT.DESCEND_SORTED_MIN_ROWS, B, L, D)}
    times = {}
    for n in (RET_PER_IMAGE, 65536, 131072, 196608, 262144, x.shape[0]):
        part = x[:n]
        a, b = (KT._descend_run(part, flat, B, L, p) for p in plans.values())
        if not torch.equal(a, b):
            raise AssertionError(f"retrieval_descend: the regimes' leaves differ at {n} rows")
        times[n] = [time_ms(lambda p=p: KT._descend_run(part, flat, B, L, p), reps=20)
                    for p in plans.values()]
    faster = [n for n, (d, s) in times.items() if s < d]
    log("  retrieval_descend, direct / sorted ms by rows (the same leaves at each): " + "; ".join(
        f"{n} {d:.4f} / {s:.4f}" for n, (d, s) in times.items())
        + f"; sorted faster from {min(faster) if faster else 'none of them'} "
        f"(DESCEND_SORTED_MIN_ROWS {KT.DESCEND_SORTED_MIN_ROWS})")


def _nonzero(W):
    c = (W != 0).sum(0).double()
    return (f"{float((W != 0).double().mean()):.4f} of it nonzero, "
            f"{float((c * (c + 1)).sum() / 2):.4g} products Σ c_k (c_k + 1) / 2, "
            f"the most images on one word {int(c.max())}")


def gram_check(name, W, errs, sparse=None):
    """K31 on W against its float64 plain version: within K31_RTOL of the
    scale, exactly symmetric, the same bits in two runs. Whether S has the
    bits of the sparse path's integer model (gram_fixed_plain) shows which
    regime the card chose; ``sparse`` True requires them."""
    from colmap_tpu_torch.kernels import retrieval as KT

    got, again = KT.gram(W), KT.gram(W)
    if not (torch.equal(got, again) and torch.equal(got, got.T)):
        raise AssertionError(f"{name}: two runs differ, or S is not symmetric")
    model = bool(torch.equal(got, KT.gram_fixed_plain(W)))
    check(f"{name} ({_nonzero(W)}), exactly symmetric, the same bits in two runs; the bits of "
          f"the integer model (sparse regime): {model}", got, KT.gram_plain(W.double()),
          K31_RTOL, errs)
    if sparse and not model:
        raise AssertionError(f"{name}: S is not the sparse path's integer sum")


def phase_retrieval_kernels():
    """K28-K31 against their float64 plain versions on the same inputs, on
    the 1000-image corpus (2M rows): K28 with a flat 1024-word vocabulary;
    K28 and K29 over level 4 of a branching-8, depth-5 tree built from the
    builder's sample (4096 nodes x 8 children); K29 the same bits in two
    runs; K30 through that tree; K31 on rank_images_bow's W of that tree's
    words (1000 x 32 768). Indices equal except at near-ties marked from
    float64; errs of K28 and K30: how far beyond the nearest the chosen
    centroids lie, in float64. Timed with CUDA events. Returns (errs,
    rows)."""
    from colmap_tpu_torch.kernels import retrieval as KT
    from colmap_tpu_torch.kernels import retrieval_cases as TC
    from colmap_tpu_torch.retrieval.visual_index import bow_matrix, build_vocabulary_tree

    errs = {k: [] for k in RETRIEVAL_SOURCES}
    rows = {}
    corpus = _retrieval_corpus()
    x = torch.from_numpy(corpus.descriptors.reshape(-1, 128)).to("cuda").float()
    N, D = x.shape
    rng = np.random.default_rng(1)
    log(f"retrieval kernels vs plain (float64 on the same inputs), {N} rows:")

    def indices(name, got, want_near, excess):
        """got against float64's indices; errs: the float64 distance to the
        centroid got chose, beyond the nearest (abs, and over the nearest)."""
        want, near = (t.cpu().numpy() for t in want_near)
        n, nn, nd = TC.agree(got.cpu().numpy(), want, near, name)
        a, r = (float(t.max()) for t in excess(got))
        log(f"  {name}: {n} rows, {nn} near-ties ({nd} of them differ); every other row equal; "
            f"the chosen centroids' float64 squared distance beyond the nearest: {a:.4e} "
            f"({r:.3e} of it, limit {KT.NEAR_TIE:g})")
        if not r <= KT.NEAR_TIE:
            raise AssertionError(f"{name}: a chosen centroid {r:.3e} beyond the nearest")
        errs[name.split()[0]].append((a, r))

    vocab = (x[torch.as_tensor(rng.choice(N, RET_WORDS, replace=False), device="cuda")]
             + torch.as_tensor(rng.normal(0, 8.0, (RET_WORDS, D)), dtype=torch.float32,
                               device="cuda")).contiguous()
    indices("retrieval_assign flat", KT.assign(x, vocab), KT.nearest64(x, vocab),
            lambda got: KT.excess64(x, vocab, got))

    t0 = time.perf_counter()
    tree = build_vocabulary_tree(corpus.descriptors.reshape(-1, D)[_builder_sample(N)],
                                 RET_BRANCHING, RET_DEPTH, device="cuda")
    torch.cuda.synchronize()
    log(f"  tree {RET_BRANCHING}^{RET_DEPTH} = {tree.num_words} leaves built on the kernels in "
        f"{time.perf_counter() - t0:.1f} s")
    flat = tree.concatenated
    top = sum(RET_BRANCHING ** (lv + 1) for lv in range(RET_DEPTH - 1))
    nodes = KT.descend(x, flat[:top].contiguous(), RET_BRANCHING, RET_DEPTH - 1)
    cents = tree.levels[-1].reshape(-1, D).float().contiguous()
    child = KT.assign(x, cents, nodes, RET_BRANCHING)
    indices("retrieval_assign level 4", child, KT.nearest64(x, cents, nodes, RET_BRANCHING),
            lambda got: KT.excess64(x, cents, got, nodes, RET_BRANCHING))
    seg = nodes.long() * RET_BRANCHING + child.long()
    new, counts = KT.update(x, seg, cents)
    new2, counts2 = KT.update(x, seg, cents)
    ref, ref_counts = KT.update_plain(x, seg, cents.double())
    if not (torch.equal(new, new2) and torch.equal(counts, counts2)):
        raise AssertionError("K29: two runs differ")
    if not torch.equal(counts, ref_counts):
        raise AssertionError("K29: counts differ from the plain version's")
    check(f"retrieval_update over {len(counts)} segments ({int((counts == 0).sum())} empty), "
          "the same bits in two runs", new, ref, K29_RTOL, errs["retrieval_update"])
    indices("retrieval_descend", KT.descend(x, flat, RET_BRANCHING, RET_DEPTH),
            KT.descend64(x, flat, RET_BRANCHING, RET_DEPTH),
            lambda got: KT.descend_excess64(x, flat, RET_BRANCHING, RET_DEPTH, got))
    # K31 on rank_images_bow's W for this tree: the images' words by K30
    # (TreeVocabulary.assign), weighted and normalized by bow_matrix.
    W = bow_matrix(tree.assign(x), [RET_PER_IMAGE] * RET_IMAGES, tree.num_words)
    gram_check(f"retrieval_gram, W {RET_IMAGES} x {tree.num_words}", W, errs["retrieval_gram"],
               sparse=True)

    S = len(counts)
    B, L = RET_BRANCHING, RET_DEPTH
    log("  times:")
    rows["retrieval_assign"] = _global_row(
        f"retrieval_assign flat, {N} rows x {RET_WORDS} words", lambda: KT.assign(x, vocab),
        lambda: KT.assign_plain(x, vocab), nbytes(x, vocab) + 4 * N,
        RET_DIST_OPS * N * RET_WORDS * D, library=lambda: torch.cdist(x, vocab).argmin(1),
        plain_reps=1)
    rows["retrieval_assign"]["entries"] = {"level 4": dict(
        ms=time_ms(lambda: KT.assign(x, cents, nodes, B), reps=10),
        plain_ms=time_ms(lambda: KT.assign_plain(x, cents, nodes, B), reps=1))}

    def library_update():
        sums = torch.zeros_like(cents).index_add_(0, seg, x)
        cnt = torch.bincount(seg, minlength=S)
        return torch.where(cnt[:, None] > 0, sums / cnt.clamp(min=1)[:, None], cents)

    rows["retrieval_update"] = _global_row(
        f"retrieval_update, {N} rows into {S} segments (with its stable sort)",
        lambda: KT.update(x, seg, cents), lambda: KT.update_plain(x, seg, cents),
        nbytes(x, seg, cents, new, counts), RET_SUM_OPS * N * D, library=library_update,
        plain_reps=1)
    # K30 at the corpus's 2M rows (rank_images_bow, the sorted regime) and at
    # one image's rows (VisualIndex.add and query, the direct regime): the
    # same bits on image 0's rows; the CUDA launches of a call, counted from
    # a captured graph and from the profiler (the plan's figure beside them).
    leaves = KT.descend(x, flat, B, L)
    one = x[:RET_PER_IMAGE]
    one_leaves = KT.descend(one, flat, B, L)
    if not torch.equal(one_leaves, leaves[:RET_PER_IMAGE]):
        raise AssertionError("retrieval_descend: one image's leaves differ from the corpus call's")
    log(f"  retrieval_descend: image 0's {RET_PER_IMAGE} rows get the corpus call's leaves")
    per_call = {}
    for rows_in in (x, one):
        n = rows_in.shape[0]
        plan = KT._descend_plan(n, B, L, D)
        label = f"{n} rows, {plan.regime}"
        got, kinds = graph_launches(lambda: KT.descend(rows_in, flat, B, L))
        split = log_parts(f"retrieval_descend, {label}", lambda: KT.descend(rows_in, flat, B, L))
        log(f"  retrieval_descend, {label}: passes {list(plan.passes)}, {plan.smem_bytes} shared "
            f"bytes a block; CUDA launches a call {got} in a captured graph ({kinds}), "
            f"{sum(c for _, c in split.values()):g} under the profiler, {plan.launches} by the plan")
        per_call[label] = got
    rows["retrieval_descend"] = _global_row(
        f"retrieval_descend, {N} rows through {B}^{L} ({KT._descend_plan(N, B, L, D).regime})",
        lambda: KT.descend(x, flat, B, L), lambda: KT.descend_plain(x, flat, B, L),
        *descend_work(x, leaves, B, L), plain_reps=1)
    entry = _global_row(
        f"retrieval_descend, one image's {RET_PER_IMAGE} rows "
        f"({KT._descend_plan(RET_PER_IMAGE, B, L, D).regime})",
        lambda: KT.descend(one, flat, B, L), lambda: KT.descend_plain(one, flat, B, L),
        *descend_work(one, one_leaves, B, L), plain_reps=3)
    rows["retrieval_descend"]["entries"] = {f"one image, {RET_PER_IMAGE} rows": entry}
    rows["retrieval_descend"]["extra"] = {"launches_a_call": per_call}
    _descend_regimes(KT, x, flat, B, L)
    b, ops = gram_work(W)
    rows["retrieval_gram"] = _global_row(
        f"retrieval_gram, W {RET_IMAGES} x {tree.num_words} ({_nonzero(W)})",
        lambda: KT.gram(W), lambda: KT.gram_plain(W), b, ops,
        library=lambda: torch.matmul(W, W.T))
    log_busy("  retrieval_gram, a call", *kernel_split(lambda: KT.gram(W)))
    del x, W
    torch.cuda.synchronize()
    return errs, rows


RETRIEVAL_QUERY_KERNELS = ("retrieval_descend",)
RETRIEVAL_BUILD_KERNELS = ("retrieval_assign", "retrieval_update")


def _write_corpus_database(path, corpus):
    """The corpus as a database: one SIMPLE_RADIAL camera, images
    img0000.png... in order (ids 1..1000), random keypoints."""
    from colmap_tpu_torch.scene.database import Database
    from colmap_tpu_torch.scene.types import Camera

    rng = np.random.default_rng(2)
    db = Database(path)
    cid = db.write_camera(Camera.create(1, "SIMPLE_RADIAL", 1200.0, 1600, 1200))
    for i, desc in enumerate(corpus.descriptors):
        iid = db.write_image(f"img{i:04d}.png", cid)
        n = len(desc)
        db.write_keypoints(iid, np.column_stack([rng.uniform(0, 1600, n), rng.uniform(0, 1200, n),
                                                 rng.uniform(1, 6, n), rng.uniform(-3, 3, n)]))
        db.write_descriptors(iid, desc)
    db.commit()
    db.close()


def _top10_against_plain(tree_path, corpus, ranked):
    """The retriever's lists of the first RET_SUBSET images against an index
    whose words come from K30's float64 plain version on the card. Every
    image's words are held against the float64 ones (equal but at
    near-ties); a list may differ only where the query or a differing image
    has a word that K30 put elsewhere. Returns (lists equal, lists excused,
    images with such a word)."""
    from colmap_tpu_torch.kernels import retrieval as KT
    from colmap_tpu_torch.kernels import retrieval_cases as TC
    from colmap_tpu_torch.retrieval.visual_index import VisualIndex, load_vocab_tree

    class PlainIndex(VisualIndex):
        def _assign(self, desc):
            return KT.descend_plain(desc, self.tree.concatenated, self.tree.branching,
                                    self.tree.depth)

    tree = load_vocab_tree(tree_path, "cuda")
    args = (tree.concatenated, tree.branching, tree.depth)
    plain = PlainIndex(tree, device="cuda")
    moved = []
    for i, desc in enumerate(corpus.descriptors):
        d = torch.from_numpy(desc).to("cuda").float()
        plain.add(i + 1, d)
        want, near = (t.cpu().numpy() for t in KT.descend64(d, *args))
        got = KT.descend(d, *args).cpu().numpy()
        TC.agree(got, want, near, f"retrieval_descend, image {i + 1}")
        moved.append(bool((got != want).any()))
    equal = excused = 0
    for i in range(RET_SUBSET):
        want = [r.image_id for r in plain.query(corpus.descriptors[i], 10, exclude_image_id=i + 1)]
        got = [r.image_id for r in ranked[i + 1]]
        if got == want:
            equal += 1
            continue
        differ = {a for a, b in zip(got, want) if a != b} | {b for a, b in zip(got, want) if a != b}
        if moved[i] or any(moved[j - 1] for j in differ):
            excused += 1
            continue
        raise AssertionError(f"image {i + 1}: top-10 {got} differs from the plain path's {want} "
                             "with the same words")
    return equal, excused, sum(moved)


def phase_retrieval(launches, errs, rows):
    """The retrieval commands on cuda, each under torch.profiler: (a) the
    1000-image corpus written to a database, `vocab_tree_builder --depth 5
    --branching 8`, `vocab_tree_retriever --num_images 10`,
    `vocab_tree_matcher --num_images 10` up to its pair list (its
    verification replaced by a stub that records the pairs: the corpus has
    no geometry) and `vocab_tree_pairs`; recall@10 of the true neighbours
    held at RET_RECALL, the top-10 lists against the float64 plain path;
    (b) images -> model: the 12 rendered frames through `feature_extractor`,
    `vocab_tree_builder` (flat, then --depth 3 --branching 8),
    `vocab_tree_matcher --num_images 5` and `mapper`, held to the images ->
    model gates."""
    import colmap_tpu_torch.controllers.feature_pipeline as FP
    from colmap_tpu_torch.kernels import retrieval as KT
    from colmap_tpu_torch.kernels import retrieval_cases as TC
    from colmap_tpu_torch.kernels import sift_cases as SC
    from colmap_tpu_torch.retrieval.visual_index import vocab_tree_pairs

    results = {}
    corpus = _retrieval_corpus()
    truth = TC.true_neighbors(RET_IMAGES, 10)
    by_regime = {"direct": [0, 0], "sorted": [0, 0]}  # K30 on the driven paths: calls, rows

    def k30_tally():
        """Adds the K30 calls and rows of the command just driven (each
        starts with every count at 0) to by_regime."""
        for r, tally in by_regime.items():
            tally[0] += KT.DESCEND_CALLS[r]
            tally[1] += KT.DESCEND_ROWS[r]

    with tempfile.TemporaryDirectory() as tmp:
        db_path, tree = os.path.join(tmp, "corpus.db"), os.path.join(tmp, "tree.npz")
        t0 = time.perf_counter()
        _write_corpus_database(db_path, corpus)
        log(f"retrieval, corpus: database written in {time.perf_counter() - t0:.1f} s")
        seconds, idles = {}, {}
        _, seconds["vocab_tree_builder"], idles["vocab_tree_builder"] = _profiled_command(
            ["vocab_tree_builder", "--database_path", db_path, "--vocab_tree_path", tree,
             "--depth", str(RET_DEPTH), "--branching", str(RET_BRANCHING)],
            "vocab_tree_builder, corpus", RETRIEVAL_BUILD_KERNELS, launches)
        k30_tally()
        ranked, seconds["vocab_tree_retriever"], idles["vocab_tree_retriever"] = _profiled_command(
            ["vocab_tree_retriever", "--database_path", db_path, "--vocab_tree_path", tree,
             "--num_images", "10"], "vocab_tree_retriever, corpus", RETRIEVAL_QUERY_KERNELS,
            launches)
        k30_tally()
        rec = TC.recall({i - 1: [r.image_id - 1 for r in res] for i, res in ranked.items()}, truth)
        pairs = []
        real = FP.run_matches_import
        FP.run_matches_import = lambda db, p, *a, **k: pairs.extend(p) or 0
        try:
            _, seconds["vocab_tree_matcher (pairs)"], idles["vocab_tree_matcher (pairs)"] = (
                _profiled_command(["vocab_tree_matcher", "--database_path", db_path,
                                   "--vocab_tree_path", tree, "--num_images", "10"],
                                  "vocab_tree_matcher up to its pair list, corpus",
                                  RETRIEVAL_QUERY_KERNELS, launches))
            k30_tally()
        finally:
            FP.run_matches_import = real
        near_pairs = sum(abs(a - b) <= 5 for a, b in pairs)
        seen = []
        real_gram = KT.gram
        KT.gram = lambda w: seen.append(w) or real_gram(w)  # keeps the path's W
        torch.cuda.synchronize()
        reset_all_launches()
        t0 = time.perf_counter()
        try:
            bow_pairs = vocab_tree_pairs({i: d for i, d in enumerate(corpus.descriptors)},
                                         device="cuda")
            torch.cuda.synchronize()
        finally:
            KT.gram = real_gram
        seconds["vocab_tree_pairs"] = time.perf_counter() - t0
        counts = all_launch_counts()
        add_launches(launches, counts)
        k30_tally()
        if not (counts["retrieval_assign"] and counts["retrieval_update"]
                and counts["retrieval_gram"]):
            raise AssertionError("vocab_tree_pairs: launched no K28, K29 or K31")
        # K31 on the W that vocab_tree_pairs handed it (its flat vocabulary).
        W = seen[0]
        name = f"retrieval_gram, vocab_tree_pairs' W {W.shape[0]} x {W.shape[1]}"
        gram_check(name, W, errs.setdefault("retrieval_gram", []))
        name += f" ({_nonzero(W)})"
        b, ops = gram_work(W)
        entry = dict(ms=time_ms(lambda: KT.gram(W), reps=20),
                     plain_ms=time_ms(lambda: KT.gram_plain(W), reps=3),
                     library_ms=time_ms(lambda: torch.matmul(W, W.T), reps=20))
        entry["bound_ms"], entry["bound_by"] = bound(b, ops)
        log(f"    {name}: {entry['ms']:.4f} ms (plain {entry['plain_ms']:.3f} ms, library "
            f"{entry['library_ms']:.4f} ms, bound {entry['bound_ms']:.5f} ms by "
            f"{entry['bound_by']})")
        log_busy("  retrieval_gram on vocab_tree_pairs' W, a call", *kernel_split(lambda: KT.gram(W)))
        if "retrieval_gram" in rows:
            rows["retrieval_gram"]["entries"] = {name: entry}
        del seen, W
        bow_near = sum(abs(a - b) <= 5 for a, b in bow_pairs)
        t0 = time.perf_counter()
        equal, excused, moved = _top10_against_plain(tree, corpus, ranked)
        log(f"  corpus: recall@10 {rec:.4f} (>= {RET_RECALL}); matcher pairs {len(pairs)}, "
            f"{near_pairs} within 5 images; vocab_tree_pairs {len(bow_pairs)} pairs "
            f"({bow_near} within 5 images) in {seconds['vocab_tree_pairs']:.3f} s; top-10 of "
            f"{RET_SUBSET} images equal to the float64 plain path's: {equal}, excused by "
            f"near-ties {excused} ({moved} images hold a word that K30 put elsewhere at a "
            f"near-tie; check {time.perf_counter() - t0:.1f} s)")
        if rec < RET_RECALL:
            raise AssertionError(f"retrieval: recall@10 {rec:.4f} < {RET_RECALL}")
        results["corpus"] = dict(seconds=seconds, idle=idles, recall=rec, pairs=len(pairs),
                                 top10_equal=equal, top10_excused=excused)

        # (b) images -> model through retrieval.
        root = os.path.join(tmp, "model")
        t0 = time.perf_counter()
        gt, _, params = SC.render_scene(os.path.join(root, "images"), IMG_FRAMES, IMG_POINTS,
                                        1024, 768, IMG_FOCAL, patch_world=IMG_PATCH_WORLD)
        log(f"retrieval, images -> model: {IMG_FRAMES} rendered frames (set-up "
            f"{time.perf_counter() - t0:.1f} s)")
        db_path = os.path.join(root, "db.db")
        seconds = {}
        steps = (
            ("feature_extractor", ["--image_path", os.path.join(root, "images"), "--camera_model",
                                   "PINHOLE", "--camera_params",
                                   ",".join(repr(float(v)) for v in params)], SIFT_SOURCES),
            ("vocab_tree_builder", ["--vocab_tree_path", os.path.join(root, "flat.npz")],
             RETRIEVAL_BUILD_KERNELS),
            ("vocab_tree_builder", ["--vocab_tree_path", os.path.join(root, "tree.npz"),
                                    "--depth", "3", "--branching", "8"], RETRIEVAL_BUILD_KERNELS),
            ("vocab_tree_matcher", ["--vocab_tree_path", os.path.join(root, "tree.npz"),
                                    "--num_images", str(RET_IMG_NEIGHBORS)],
             RETRIEVAL_QUERY_KERNELS + MATCHER_KERNELS),
            ("mapper", ["--output_path", os.path.join(root, "sparse"), "--quiet"],
             ("camera_map", "p3p_ransac", *list(BA_SOURCES)[:3])),
        )
        for k, (cmd, extra, kernels) in enumerate(steps):
            label = f"{cmd} ({k})"
            _, seconds[label], counts = run_command([cmd, "--database_path", db_path] + extra,
                                                    f"{cmd}, images -> model", kernels)
            add_launches(launches, counts)
            k30_tally()
        from colmap_tpu_torch.estimators.alignment import compare_reconstructions
        from colmap_tpu_torch.scene.database import Database
        from colmap_tpu_torch.scene.reconstruction_io import read_model

        db = Database(db_path, must_exist=True)
        matched = len(db.read_all_matches())
        db.close()
        recon = read_model(os.path.join(root, "sparse", "0"))
        cmp = compare_reconstructions(recon, gt)
        n, rot, ctr = (cmp["num_common_images"], cmp["max_rotation_error_deg"],
                       cmp["max_center_error"])
        log(f"  images -> model through retrieval: {matched} of 66 pairs matched; "
            f"{recon.num_reg_frames()}/{IMG_FRAMES} frames, {recon.num_points3D()} points; max "
            f"rotation error {rot:.4f} deg, max center error {ctr:.5f} (bounds {IMG_MAX_ROT_DEG} "
            f"deg, {IMG_MAX_CENTER}); seconds by command "
            f"{ {k: round(v, 3) for k, v in seconds.items()} }")
        if not (n == IMG_FRAMES and rot < IMG_MAX_ROT_DEG and ctr < IMG_MAX_CENTER
                and matched < 66):
            raise AssertionError(f"retrieval, images -> model: {n}/{IMG_FRAMES} frames, {rot} deg, "
                                 f"{ctr}, {matched} pairs")
        results["images_to_model"] = dict(seconds=seconds, frames=n, max_rot_deg=rot,
                                          max_center=ctr, pairs=matched)
    log("  K30 on the driven paths by regime: " + "; ".join(
        f"{r} {c} calls, {n} rows ({n / max(c, 1):.0f} a call)" for r, (c, n) in by_regime.items()))
    if "retrieval_descend" in rows:  # the retrieval_kernels phase ran
        rows["retrieval_descend"].setdefault("extra", {})["path_calls_by_regime"] = {
            r: c for r, (c, _) in by_regime.items()}
    return results


def check_rows(name, got, ref, rtol, errs):
    """Per row: max |got - ref| over max(|ref| of the row, 1), for maps whose
    rows differ in scale (z = 1 lifts near 90 degrees off axis)."""
    d = (got.double() - ref.double()).abs().amax(-1)
    r = d / torch.clamp(ref.double().abs().amax(-1), min=1.0)
    a, rr = (float(d.max()), float(r.max())) if d.numel() else (0.0, 0.0)
    log(f"  {name}: max_abs_err {a:.3e} rel (per row) {rr:.3e} (tol {rtol:g})")
    if not rr <= rtol:
        raise AssertionError(f"{name}: relative error {rr:.3e} > {rtol:g}")
    errs.append((a, rr))


def _same_valid(name, got, ref):
    n = int((got != ref).sum())
    if n:
        raise AssertionError(f"{name}: {n} of {got.numel()} validity flags differ from float64")


def _k5_new_models(errs, entries):
    """K5's three modes on models 5-17 against float64: one image's points
    and, for the lenses that see beyond 90 degrees, a 185-degree lens's
    whole image (a 129 x 97 grid from corner to corner)."""
    from colmap_tpu_torch.kernels import sfm as K
    from colmap_tpu_torch.kernels import sfm_cases as C
    from colmap_tpu_torch.sensor import models as M

    for m in range(5, 18):
        name = M.MODEL_ID_TO_NAME[m]
        p, uvw, xy = C.camera_map_case(m, 1010, m, "cuda")
        got, ok = K.img_from_cam(m, p, uvw)
        ref, ok_ref = M.img_from_cam(m, p.double(), uvw.double())
        _same_valid(f"K5 project {name}", ok, ok_ref)
        check_rows(f"K5 project {name}", got[ok_ref], ref[ok_ref], K5_NEW_RTOL, errs)
        grids = [("points", p, xy)]
        if m in C.WIDE_MODELS:
            gp, gxy = C.wide_grid_case(m, 129, "cuda")
            grids.append(("185-degree grid", gp, gxy[: 129 * 97]))
        for where, prm, pix in grids:
            ray, ok_r = K.cam_ray_from_img(m, prm, pix)
            ray_ref, ok_rr = M.cam_ray_from_img(m, prm.double(), pix.double())
            _same_valid(f"K5 ray {name} {where}", ok_r, ok_rr)
            away = (ray_ref[:, 2].abs() > math.sin(math.radians(1.0))) & ok_rr
            check_rows(f"K5 ray {name} {where}", ray[away], ray_ref[away], K5_NEW_RTOL, errs)
            uv, ok_u = K.cam_from_img(m, prm, pix)
            uv_ref, ok_ur = M.cam_from_img(m, prm.double(), pix.double())
            _same_valid(f"K5 unproject {name} {where}", ok_u, ok_ur)
            check_rows(f"K5 unproject {name} {where} ({int(away.sum())} of {len(away)} rows "
                       "away from 90 deg)", uv[away], uv_ref[away], K5_NEW_RTOL, errs)
    # Times at the shapes of their paths: a 360-degree frame's 8192 keypoints
    # to rays, a fisheye frame's 1010 keypoints through the Newton undistortion.
    p = torch.tensor([5760.0, 2880.0], device="cuda")
    xy = torch.rand(8192, 2, device="cuda") * p
    entries["ray, EQUIRECTANGULAR, 8192 keypoints"] = _entry_times(
        lambda: K.cam_ray_from_img(17, p, xy), lambda: M.cam_ray_from_img(17, p, xy))
    p, _, xy = C.camera_map_case(5, 1010, 5, "cuda")
    entries["unproject, OPENCV_FISHEYE, 1010 keypoints"] = _entry_times(
        lambda: K.cam_from_img(5, p, xy), lambda: M.cam_from_img(5, p, xy))
    log(f"  K5 times: {entries}")


def _k1_models(errs, entries):
    """K1 for each of models 5-17 and for a mixed problem at the BA
    headline's shape (200 frames x 50k points x 300k observations, Cauchy)
    against float64 (Jacobians and cost), timed. The headline's poses,
    points and measurements with the cases' camera parameters of each
    model (the mixed problem: frames alternate a SIMPLE_RADIAL and an
    OPENCV_FISHEYE camera)."""
    from colmap_tpu_torch.estimators import bundle_adjustment as ba
    from colmap_tpu_torch.kernels import ba as KB
    from colmap_tpu_torch.kernels import sfm_cases as C
    from colmap_tpu_torch.scene.synthetic_ba import synthetic_ba_problem
    from colmap_tpu_torch.sensor import models as M

    headline, _, _ = synthetic_ba_problem(200, 50000, 6, seed=0, device="cuda")
    options = ba.BAOptions(loss="cauchy")

    def problem_of(model_id):
        if isinstance(model_id, tuple):
            p = headline._replace(cam_params=_mixed_rows(),
                                  obs_cam=(headline.obs_frame % 2).to(torch.int32))
        else:
            p = headline._replace(cam_params=torch.as_tensor(
                C.camera_params(model_id), dtype=torch.float32, device="cuda")[None].contiguous())
        return p, options, ba._obs_masks(ba.default_masks(p, model_id, options), options)

    def run(label, model_id, problem, options, om):
        p = problem
        args = (p.quat, p.t, p.cam_params, p.points, p.obs_frame, p.obs_cam, p.obs_point,
                p.obs_xy, p.obs_w)
        rest = (model_id, options.loss, options.loss_scale)
        # Against float64 on the first K1_CHECK_OBS observations (the
        # function is per observation); timed on all of them.
        sl = tuple(a[:K1_CHECK_OBS] if a.shape[0] == p.obs_xy.shape[0] else a for a in args)
        KB.reset_launches()
        J = KB.obs_jacobians(*sl, *om, *rest)
        launches = KB.LAUNCHES["ba_obs_jacobians"]
        ref = KB.obs_jacobians_plain(*f64(*sl), *f64(*om), *rest)
        for n, a, b in zip(("r", "Jp", "Jc", "Jx"), J, ref):
            check(f"K1 {label} {n}", a, b, K1_NEW_RTOL, errs)
        check(f"K1 {label} cost", KB.obs_cost(*sl, *rest), KB.obs_cost_plain(*f64(*sl), *rest),
              K1_NEW_RTOL, errs)
        del ref
        # Timed as the solver calls it: a mixed problem's groups built once.
        groups = KB.model_groups(model_id, p.cam_params, p.obs_cam)
        J = KB.obs_jacobians(*args, *om, *rest, groups)
        O, P = p.obs_xy.shape[0], p.cam_params.shape[1]
        ms = time_ms(lambda: KB.obs_jacobians(*args, *om, *rest, groups), reps=10)
        plain_ms = time_ms(lambda: KB.obs_jacobians_plain(*args, *om, *rest, groups), reps=3)
        b_ms, by = bound(nbytes(*args, *om) + nbytes(*J), O * (40 + (7 + P) * 20 + 6 * (9 + P)))
        entries[label] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=by,
                              launches_per_call=launches)
        log(f"  K1 {label}: {ms:.4f} ms (plain {plain_ms:.3f} ms, bound {b_ms:.5f} ms by {by}; "
            f"{launches} launches a call)")

    for m in range(5, 18):
        run(M.MODEL_ID_TO_NAME[m], m, *problem_of(m))
    run("mixed SIMPLE_RADIAL + OPENCV_FISHEYE", (2, 5), *problem_of((2, 5)))
    if entries["mixed SIMPLE_RADIAL + OPENCV_FISHEYE"]["launches_per_call"] != 2:
        raise AssertionError("mixed K1: not one launch per model")


def _mixed_rows():
    """Camera rows of SIMPLE_RADIAL and OPENCV_FISHEYE padded to 9 columns
    (the widest model's 8 and the model position), on the card."""
    from colmap_tpu_torch.kernels import sfm_cases as C
    from colmap_tpu_torch.sensor import models as M

    _, rows = M.pack_mixed_params([C.camera_params(2), C.camera_params(5)], [2, 5])
    return torch.as_tensor(rows, dtype=torch.float32, device="cuda")


def _k9_k24_models(errs, entries):
    """K9 for each of models 5-17 and for mixed rows on 1000 points of 2-32
    views; K24 for each of them at the rig BA headline's shape (Cauchy), and
    K24-K26 through _rig_compare on RAD_TAN_THIN_PRISM_FISHEYE (16
    parameters, the 17-column camera-side rows) and on the mixed rows."""
    from colmap_tpu_torch.estimators import bundle_adjustment as ba
    from colmap_tpu_torch.estimators import bundle_adjustment_rig as rba
    from colmap_tpu_torch.kernels import ba as KB
    from colmap_tpu_torch.kernels import rig as KR
    from colmap_tpu_torch.kernels import rig_cases as RC
    from colmap_tpu_torch.kernels import sfm as K
    from colmap_tpu_torch.kernels import sfm_cases as C
    from colmap_tpu_torch.sensor import models as M

    keys = ("quat", "t", "cam_params", "xyz", "obs_xy", "valid")
    cams = _mixed_rows()
    for m in list(range(5, 18)) + [(2, 5)]:
        label = "mixed" if isinstance(m, tuple) else M.MODEL_ID_TO_NAME[m]
        c = C.filter_case(1000, 0, "cuda", model_id=2 if isinstance(m, tuple) else m)
        if isinstance(m, tuple):
            pick = torch.as_tensor(np.random.default_rng(3).integers(0, 2, tuple(c["valid"].shape)),
                                   device="cuda")
            c["cam_params"] = cams[pick].contiguous()
        d = C.as_double(c)
        ek, dk, mk = K.filter_points(m, *(c[k] for k in keys))
        ep, dp, mp = K.filter_points_plain(m, *(d[k] for k in keys))
        fin = torch.isfinite(ep)
        _same_valid(f"K9 {label} infinite errors", torch.isfinite(ek), fin)
        # Errors in front of the camera: behind it the filter deletes the
        # observation by its depth whatever its error, and the division
        # models, which have no cheirality test, put such points 1e5-1e6 px
        # off, where float32 keeps a residual to ~0.1 px only.
        front = fin & (dp > 0)
        check(f"K9 {label} errors", ek[front], ep[front], K9_RTOL, errs["filter_points"])
        check(f"K9 {label} depths", dk, dp, K9_RTOL, errs["filter_points"])
        check(f"K9 {label} min |cos|", mk, mp, K9_RTOL, errs["filter_points"])
    options = ba.BAOptions(loss="cauchy", function_tolerance=0.0)
    headline, _, _ = RC.rig_ba_problem(RIG_FRAMES, RIG_SENSORS, RIG_POINTS, RIG_TRACK, seed=0,
                                       device="cuda")
    for m in list(range(5, 18)) + [(2, 5)]:
        label = "mixed" if isinstance(m, tuple) else M.MODEL_ID_TO_NAME[m]
        problem = headline
        if isinstance(m, tuple):
            rows = cams[torch.arange(RIG_SENSORS, device="cuda") % 2]
        else:
            rows = torch.as_tensor(C.camera_params(m), dtype=torch.float32,
                                   device="cuda").expand(RIG_SENSORS, -1)
        problem = problem._replace(cam_params=rows.contiguous())
        masks = rba.fix_gauge_two_frames(rba.default_masks(problem, m, options), 0, 1)
        if m in (11, (2, 5)):
            ctx = _rig_compare(problem, m, options, masks, errs, f"rig headline, {label}")
            params, obs, om, rest = ctx["params"], ctx["obs"], ctx["om"], ctx["rest"]
        else:
            om, obs = rba._obs_masks(masks, options), rba._obs(problem)
            params, rest = tuple(problem[:6]), (m, options.loss, options.loss_scale)
            sl = type(obs)(*(a[:K1_CHECK_OBS] for a in obs))  # as K1: a slice against float64
            jac = KR.rig_obs_jacobians(*params, sl, *om, *rest)
            ref = KR.rig_obs_jacobians_plain(*f64(*params), type(obs)(*f64(*sl)), *f64(*om),
                                             *rest)
            for n, a, b in zip(KR.RigJacobians._fields, jac, ref):
                check(f"K24 {label} {n}", a, b, K1_NEW_RTOL, errs["rig_ba_jacobians"])
            del ref
        O, P = problem.obs_xy.shape[0], problem.cam_params.shape[1]
        groups = KB.model_groups(m, problem.cam_params, obs.obs_cam)  # once, as the solver
        jac = KR.rig_obs_jacobians(*params, obs, *om, *rest, groups)
        ms = time_ms(lambda: KR.rig_obs_jacobians(*params, obs, *om, *rest, groups), reps=10)
        plain_ms = time_ms(lambda: KR.rig_obs_jacobians_plain(*params, obs, *om, *rest, groups),
                           reps=3)
        b_ms, by = bound(nbytes(*params, *obs, *om) + nbytes(*jac),
                         O * (RIG_K24_OBS_OPS + 20 * (P - 4)))
        entries[label] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=by)
        log(f"  K24 {label}: {ms:.4f} ms (plain {plain_ms:.3f} ms, bound {b_ms:.5f} ms by {by})")


def _spherical_kernels(errs, rows, agree):
    """K32 and K33: injected samples of one 8192-ray pair against float64
    (the same best, supports, near-best models), the inlier mask and the
    refit; a block of 64 pairs x 8192 rays against the one-pair entries on
    three of its pairs; times of the block at that shape."""
    from colmap_tpu_torch.geometry.spherical import (angular_sampson_error,
                                                     homography_ray_angular_error)
    from colmap_tpu_torch.kernels import spherical as KQ
    from colmap_tpu_torch.kernels import spherical_cases as Q
    from colmap_tpu_torch.kernels.sfm_cases import as_double
    from colmap_tpu_torch.optim.ransac import unpack_best

    def same_mask(name, a, b, res, max_sq):
        diff = a != b
        border = (res - max_sq).abs() <= 0.02 * max_sq
        log(f"  {name}: {int(diff.sum())} of {a.numel()} differ, {int((diff & border).sum())} "
            "of them borderline")
        if bool((diff & ~border).any()):
            raise AssertionError(f"{name}: kernel and plain version disagree off the threshold")

    for kind, name, tag, m, sols, residual, sample_ops, row_ops in (
            ("E", "spherical_e", "K32", 5, KQ.E_SOLUTIONS, angular_sampson_error,
             SPH_E_SAMPLE_OPS, SPH_E_ROW_OPS),
            ("H", "spherical_h", "K33", 4, KQ.H_SOLUTIONS, homography_ray_angular_error,
             SPH_H_SAMPLE_OPS, SPH_H_ROW_OPS)):
        propose, refit, inliers = (getattr(KQ, f"{name}_{e}") for e in
                                   ("propose_score", "refit", "inliers"))
        plain = [getattr(KQ, f"{name}_{e}_plain") for e in ("propose_score", "refit", "inliers")]
        c = Q.ray_case(kind, SPH_ROWS, SPH_SAMPLES, 0, "cuda")
        d = as_double(c)
        args = (c["x1"], c["x2"], c["mask"], c["samples"], c["max_sq"])
        mk, ck, bk = propose(*args)
        mp, cp, bp = plain[0](d["x1"], d["x2"], d["mask"], d["samples"], d["max_sq"])
        agree[f"{name}_ransac"] = _check_ransac_batch(
            tag, mk, ck, bk, mp, cp, bp, SPH_ROWS, SPH_SAMPLES, errs[f"{name}_ransac"],
            unpack_best,
            lambda mm: torch.where(d["mask"], residual(mm[:, None], d["x1"][None], d["x2"][None]),
                                   torch.inf),
            d["max_sq"], sign_free=True, exact_best=False)
        best = unpack_best(int(bp.item()))[1]
        model = mp[best].float()
        same_mask(f"{tag} inlier mask", inliers(c["x1"], c["x2"], c["mask"], model, c["max_sq"]),
                  plain[2](d["x1"], d["x2"], d["mask"], model.double(), d["max_sq"]),
                  residual(model.double(), d["x1"], d["x2"]), d["max_sq"])
        start = model.clone()
        start[0, 1] += 0.01 * float(model.abs().max())
        n0 = int(plain[2](d["x1"], d["x2"], d["mask"], start.double(), d["max_sq"]).sum())
        rk, nk = refit(c["x1"], c["x2"], c["mask"], start, c["max_sq"], n0)
        rp, np_ = plain[1](d["x1"], d["x2"], d["mask"], start.double(), d["max_sq"], n0)
        log(f"  {tag} refit: support {n0} -> kernel {nk}, plain {np_}")
        if abs(nk - np_) > SPH_ROWS // 1000:
            raise AssertionError(f"{tag} refit support: kernel {nk}, plain {np_}")
        check(f"{tag} refit model", rk * torch.sign((rk.double() * rp).sum()), rp, K67_RTOL,
              errs[f"{name}_ransac"])
        # The block: 64 pairs of 8192 rays (valid counts 8192 down to 4096).
        blk = Q.ray_block_case(kind, SPH_PAIRS, SPH_ROWS, SPH_SAMPLES, 1, "cuda")
        bargs = (blk["x1"], blk["x2"], blk["mask"], blk["samples"], blk["max_sq"])
        mb, cb, bb = propose(*bargs)
        for b in (0, SPH_PAIRS // 2, SPH_PAIRS - 1):
            sq = float(blk["max_sq"][b])
            m1, c1, b1 = propose(blk["x1"][b], blk["x2"][b], blk["mask"][b], blk["samples"][b], sq)
            if not (int(b1) == int(bb[b]) and torch.equal(c1, cb[b])
                    and torch.equal(torch.nan_to_num(m1), torch.nan_to_num(mb[b]))):
                raise AssertionError(f"{tag}: pair {b} of the block differs from its one-pair run")
        log(f"  {tag}: a block of {SPH_PAIRS} pairs gives pairs 0, {SPH_PAIRS // 2}, "
            f"{SPH_PAIRS - 1} exactly what the one-pair entry gives")
        rays = int(blk["mask"].sum())
        pieces = [tuple(a[i:i + SPH_PLAIN_PAIRS] for a in bargs)
                  for i in range(0, SPH_PAIRS, SPH_PLAIN_PAIRS)]
        rows[f"{name}_ransac"] = _global_row(
            f"{name}_ransac", lambda: propose(*bargs),
            lambda: [plain[0](*piece) for piece in pieces],
            nbytes(*bargs[:4], mb, cb, bb),
            SPH_PAIRS * SPH_SAMPLES * sample_ops + SPH_SAMPLES * sols * rays * row_ops)
        picks = [unpack_best(int(v)) for v in bb.tolist()]
        idx = torch.tensor([p[1] for p in picks], device="cuda")
        start = torch.nan_to_num(mb[torch.arange(SPH_PAIRS, device="cuda"), idx])
        counts = torch.tensor([p[0] for p in picks], dtype=torch.int32, device="cuda")
        rows[f"{name}_ransac"]["entries"] = {
            "refit": _entry_times(lambda: refit(*bargs[:3], start, bargs[4], counts),
                                  lambda: plain[1](*bargs[:3], start, bargs[4], counts)),
            "inliers": _entry_times(lambda: inliers(*bargs[:3], start, bargs[4]),
                                    lambda: plain[2](*bargs[:3], start, bargs[4]))}


def phase_camera_kernels():
    """Phase camera_kernels: K5 (three modes), K1, K9 and K24 for camera
    models 5-17 and for a problem that mixes SIMPLE_RADIAL and
    OPENCV_FISHEYE, against float64 plain versions at the shapes of the
    existing phases (K1 and K24 at the BA and rig BA headlines); K32 and K33
    against theirs on 360-degree rays. Returns (errs, rows, agree, entries):
    entries holds per-model times to add to the K1, K5 and K24 rows."""
    errs = {k: [] for k in ("camera_map", "ba_obs_jacobians", "filter_points",
                            "rig_ba_jacobians", "rig_ba_reduce", "rig_ba_matvec",
                            *CAMERA_SOURCES)}
    rows, agree = {}, {}
    entries = {"camera_map": {}, "ba_obs_jacobians": {}, "rig_ba_jacobians": {}}
    log("camera kernels vs plain (float64 on the same inputs), models 5-17 and mixed models:")
    for label, step in (
            ("K5", lambda: _k5_new_models(errs["camera_map"], entries["camera_map"])),
            ("K1", lambda: _k1_models(errs["ba_obs_jacobians"], entries["ba_obs_jacobians"])),
            ("K9 and K24", lambda: _k9_k24_models(errs, entries["rig_ba_jacobians"])),
            ("K32 and K33 on 5760 x 2880 rays", lambda: _spherical_kernels(errs, rows, agree))):
        t0 = time.perf_counter()
        step()
        log(f"  ({label}: {time.perf_counter() - t0:.1f} s)")
    torch.cuda.synchronize()
    return errs, rows, agree, entries


def _fisheye_scene(root, frames_per_rig, num_rigs=1, mixed=False, **options):
    """A full-size database (1000 points, 1024 x 768, prior focal lengths)
    of OPENCV_FISHEYE cameras, or with ``mixed`` of rigs alternating
    SIMPLE_RADIAL and OPENCV_FISHEYE, and its ground truth."""
    kw = dict(camera_model_ids=(2, 5) if mixed else (5,),
              camera_params_list=((FULL_FOCAL, 512.0, 384.0, 0.05), FISHEYE_PARAMS) if mixed
              else (FISHEYE_PARAMS,))
    from colmap_tpu_torch.scene.database import Database
    from colmap_tpu_torch.scene.synthetic import SyntheticDatasetOptions, synthesize_dataset

    db_path = os.path.join(root, "db.db")
    db = Database(db_path)
    gt = synthesize_dataset(SyntheticDatasetOptions(
        num_rigs=num_rigs, num_cameras_per_rig=1, num_frames_per_rig=frames_per_rig,
        num_points3D=1000, camera_has_prior_focal_length=True, **kw, **options),
        db, rng=np.random.default_rng(3))
    db.close()
    return db_path, gt


# The camera mappers must launch K1-K3, K5-K9 and K34-K36.
CAMERA_MAPPER_KERNELS = ("ba_obs_jacobians", "ba_lm_reduce", "ba_schur_matvec", "camera_map",
                         "p3p_ransac", "essential_ransac", "triangulate_tracks", "filter_points",
                         "ba_pcg", "ba_lm_update", "relative_pose")


def _camera_mapper(root, label, num_frames, launches, results, profiled, **scene):
    """A fisheye (or mixed) scene stripped to features through
    `exhaustive_matcher` and `mapper` (under torch.profiler when
    ``profiled``), held to the ground truth."""
    t0 = time.perf_counter()
    db_path, gt = _fisheye_scene(root, **scene)
    pairs = strip_to_features(db_path)
    log(f"{label}: set-up {time.perf_counter() - t0:.1f} s")
    verified, m_sec, m_counts = run_matcher(db_path, f"exhaustive_matcher, {label}")
    expected = sum(len(m) >= 15 for m in pairs.values())
    if verified != expected:
        raise AssertionError(f"{label}: verified {verified} of {expected} pairs")
    add_launches(launches, m_counts)
    out = os.path.join(root, "sparse")
    pipeline, seconds, idle = _profiled_command(
        ["mapper", "--database_path", db_path, "--output_path", out, "--quiet"],
        f"mapper, {label}", CAMERA_MAPPER_KERNELS, launches, profiled=profiled)
    cmp = check_against_gt(out, gt, num_frames, f"mapper, {label}")
    phases = {k: (round(pipeline.timer.seconds[k], 3), pipeline.timer.calls[k])
              for k in sorted(pipeline.timer.seconds, key=pipeline.timer.seconds.get,
                              reverse=True)}
    log("  time by phase (s, calls): " + ", ".join(
        f"{k} {v[0]:.3f}/{v[1]}" for k, v in phases.items()))
    results[label] = dict(matcher_seconds=m_sec, seconds=seconds, idle=idle, phases=phases,
                          max_rot_deg=cmp["max_rotation_error_deg"],
                          max_center=cmp["max_center_error"])


def _undistorter(root, launches, results):
    """`image_undistorter` on a 12 MP OPENCV_FISHEYE still against the
    float64 plain undistortion on the CPU."""
    from colmap_tpu_torch.image.undistortion import undistort_camera, undistort_image
    from colmap_tpu_torch.scene.reconstruction_io import read_model, write_model
    from colmap_tpu_torch.scene.synthetic import SyntheticDatasetOptions, synthesize_dataset
    from colmap_tpu_torch.utils.image_io import read_image, write_png

    recon = synthesize_dataset(SyntheticDatasetOptions(
        num_rigs=1, num_frames_per_rig=1, num_points3D=20, camera_model_id=5,
        camera_params=UND_PARAMS, camera_width=UND_W, camera_height=UND_H), None,
        rng=np.random.default_rng(5))
    cam = recon.cameras[1]
    name = recon.images[1].name
    rng = np.random.default_rng(5)
    yy, xx = np.mgrid[0:UND_H, 0:UND_W].astype(np.float64)
    img = 128.0 + 40.0 * np.sin(xx / 37.0) * np.cos(yy / 23.0)
    for _ in range(6):
        a, b, ph = rng.uniform(0.005, 0.05, 3)
        img += 12.0 * np.sin(a * xx + b * yy + 10 * ph)
    img = np.clip(img + rng.normal(0, 4.0, img.shape), 0, 255).astype(np.uint8)
    os.makedirs(os.path.join(root, "images"))
    write_png(os.path.join(root, "images", name), img)
    os.makedirs(os.path.join(root, "sparse"))
    write_model(recon, os.path.join(root, "sparse"))
    ws = os.path.join(root, "ws")
    _, seconds, idle = _profiled_command(
        ["image_undistorter", "--image_path", os.path.join(root, "images"), "--input_path",
         os.path.join(root, "sparse"), "--output_path", ws],
        "image_undistorter, 12 MP OPENCV_FISHEYE still", ("camera_map",), launches)
    got = read_image(os.path.join(ws, "images", name))
    t0 = time.perf_counter()
    ucam = undistort_camera(cam, device="cpu")
    ref = undistort_image(img, cam, ucam, device="cpu")
    out_cam = read_model(os.path.join(ws, "sparse")).cameras[1]
    cam_err = float(np.abs(np.asarray(out_cam.params) - ucam.params).max()
                    / np.abs(ucam.params).max())
    diff = np.abs(got.astype(np.int64) - ref.astype(np.int64))
    off1 = float((diff == 1).mean())
    log(f"  undistorted {got.shape} against float64 on the CPU ({time.perf_counter() - t0:.1f} s):"
        f" camera params within {cam_err:.3e}, max level difference {int(diff.max())}, share "
        f"off by 1 {off1:.5f} (<= {UND_MAX_OFF_BY_ONE})")
    if not (got.shape == ref.shape and int(diff.max()) <= 1 and off1 <= UND_MAX_OFF_BY_ONE
            and cam_err <= 1e-5):
        raise AssertionError("image_undistorter: outside its gate")
    results["image_undistorter"] = dict(seconds=seconds, idle=idle, off_by_one=off1)


def _pano_matcher(root, launches, results):
    """`exhaustive_matcher` on the 360-degree database under torch.profiler,
    then every pair's verified geometry and relative pose against the truth
    (recover_spherical_pose on the card, float64)."""
    from colmap_tpu_torch.estimators.spherical import recover_spherical_pose
    from colmap_tpu_torch.geometry import rotation as rot
    from colmap_tpu_torch.kernels import spherical_cases as Q
    from colmap_tpu_torch.scene.database import Database
    from colmap_tpu_torch.scene.types import TwoViewGeometryConfig as CFG

    db_path = os.path.join(root, "pano.db")
    t0 = time.perf_counter()
    poses, outliers = Q.write_database(db_path, PANO_FRAMES, PANO_POINTS, seed=9)
    log(f"360-degree database: {PANO_FRAMES} EQUIRECTANGULAR frames {Q.WIDTH} x {Q.HEIGHT}, "
        f"{PANO_POINTS} keypoints each (set-up {time.perf_counter() - t0:.1f} s)")
    verified, seconds, idle = _profiled_command(
        ["exhaustive_matcher", "--database_path", db_path],
        "exhaustive_matcher, 360-degree frames", PANO_KERNELS, launches)
    db = Database(db_path, must_exist=True)
    cam = db.read_camera(1)
    kps = {i + 1: db.read_keypoints(i + 1)[:, :2] for i in range(PANO_FRAMES)}
    t0 = time.perf_counter()
    planted = planted_in = 0
    worst_r = worst_t = 0.0
    configs = {}
    for i1, i2, g in db.read_all_two_view_geometries():
        matches = db.read_matches(i1, i2)
        planted += int((outliers[i1][matches[:, 0]] | outliers[i2][matches[:, 1]]).sum())
        inl = g.inlier_matches
        planted_in += int((outliers[i1][inl[:, 0]] | outliers[i2][inl[:, 1]]).sum())
        rotation_only = (i1, i2) == (1, 2)
        expected = CFG.PLANAR_OR_PANORAMIC if rotation_only else CFG.CALIBRATED
        if g.config != int(expected):
            raise AssertionError(f"pair {i1}-{i2}: {CFG(g.config).name}, expected {expected.name}")
        recover_spherical_pose(g, cam, kps[i1], cam, kps[i2], device="cuda")
        if rotation_only:
            log(f"  rotation-only pair: {CFG(g.config).name} after pose recovery")
        configs[CFG(g.config).name] = configs.get(CFG(g.config).name, 0) + 1
        (R1, t1), (R2, t2) = poses[i1 - 1], poses[i2 - 1]
        R = R2 @ R1.T
        R_est = rot.quat_to_rotmat(torch.as_tensor(g.cam2_from_cam1.quat)).numpy()
        worst_r = max(worst_r, float(np.abs(R_est - R).max()))
        if rotation_only:
            if g.config not in (int(CFG.PLANAR), int(CFG.PANORAMIC)):
                raise AssertionError(f"rotation-only pair: {CFG(g.config).name}")
            continue
        t = t2 - R @ t1
        t /= np.linalg.norm(t)
        worst_t = max(worst_t, float(min(np.abs(g.cam2_from_cam1.t - t).max(),
                                         np.abs(g.cam2_from_cam1.t + t).max())))
    db.close()
    share = planted_in / max(planted, 1)
    log(f"  360-degree pairs: {verified} verified, configurations after pose recovery {configs}; "
        f"largest rotation error {worst_r:.3e} (<= {PANO_ROT_TOL}), translation direction "
        f"{worst_t:.3e} (<= {PANO_T_TOL}); {planted_in} of {planted} planted outlier matches among "
        f"the inliers, {share:.5f} (<= {PANO_MAX_OUTLIER_SHARE}); pose recovery "
        f"{time.perf_counter() - t0:.1f} s")
    n_pairs = PANO_FRAMES * (PANO_FRAMES - 1) // 2
    if not (sum(configs.values()) == n_pairs and configs.get("CALIBRATED") == n_pairs - 1
            and worst_r <= PANO_ROT_TOL and worst_t <= PANO_T_TOL
            and share <= PANO_MAX_OUTLIER_SHARE):
        raise AssertionError("360-degree matcher: outside its gates")
    results["360 matcher"] = dict(seconds=seconds, idle=idle, pairs=n_pairs, max_rot=worst_r,
                                  max_t=worst_t, outlier_share=share)


def phase_cameras(launches):
    """Phase cameras: `mapper` on the full-size scene with OPENCV_FISHEYE and
    on a full-size mixed scene (2 rigs x 20 frames, SIMPLE_RADIAL +
    OPENCV_FISHEYE), `global_mapper` on the fisheye scene, `image_undistorter`
    on a 12 MP fisheye still and `exhaustive_matcher` on 24 360-degree
    frames, each but the mixed scene's mapper under torch.profiler, each
    held to its gates."""
    results = {}
    with tempfile.TemporaryDirectory() as tmp:
        # The mixed scene's mapper runs unprofiled: the profiler's stop and
        # the reading of its trace cost ~60 s on a 40-frame mapper run.
        for label, frames, profiled, scene in (
                ("full-size OPENCV_FISHEYE scene", FULL_FRAMES, True,
                 dict(frames_per_rig=FULL_FRAMES)),
                ("full-size mixed scene", 2 * MIXED_FRAMES, False,
                 dict(frames_per_rig=MIXED_FRAMES, num_rigs=2, mixed=True))):
            root = os.path.join(tmp, label.split()[1])
            os.makedirs(root)
            _camera_mapper(root, label, frames, launches, results, profiled, **scene)
        root = os.path.join(tmp, "global")
        os.makedirs(root)
        db_path, gt = _fisheye_scene(root, FULL_FRAMES, two_view_geometry_has_relative_pose=False)
        out = os.path.join(root, "sparse")
        pipeline, seconds, idle = _profiled_command(
            ["global_mapper", "--database_path", db_path, "--output_path", out, "--quiet"],
            "global_mapper, full-size OPENCV_FISHEYE scene", GLOBAL_MAPPER_KERNELS, launches)
        cmp = check_against_gt(out, gt, FULL_FRAMES, "global_mapper, OPENCV_FISHEYE scene")
        results["global_mapper"] = dict(seconds=seconds, idle=idle,
                                        max_rot_deg=cmp["max_rotation_error_deg"],
                                        max_center=cmp["max_center_error"])
        root = os.path.join(tmp, "undistort")
        os.makedirs(root)
        _undistorter(root, launches, results)
        _pano_matcher(tmp, launches, results)
    log(f"cameras phase on {nvidia_smi_line()}: " + "; ".join(
        f"{k}: {round(v['seconds'], 3)} s, idle {None if v.get('idle') is None else round(v['idle'], 4)}"
        for k, v in results.items()))
    return results


def bound64(bytes_moved, ops64):
    """bound() for float64 work without a GEMM form (K36, K40, K47, K48)."""
    t_bytes = bytes_moved / PEAK_BYTES_PER_S * 1e3
    t_ops = ops64 / PEAK_F64_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _solver_row(name, ms, plain_ms, b):
    log(f"    {name}: {ms:.4f} ms (plain {plain_ms:.3f} ms, bound {b[0]:.5f} ms by {b[1]})")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=b[0], bound_by=b[1], library_ms=None)


def _k34_k35(label, problem, model_id, maps, masks, errs, timed):
    """K34's set-up (both preconditioners) and step, K35's candidate and
    accept against their float64 plain versions on the same inputs (one LM
    step's state at lam = 1e-3); with ``timed`` their times at these shapes.
    Returns {name: row} when timed."""
    from colmap_tpu_torch.estimators import bundle_adjustment as ba
    from colmap_tpu_torch.kernels import ba as K
    from colmap_tpu_torch.kernels import solver as KL

    log(f"K34, K35 vs float64 plain: {label}")
    options = ba.BAOptions(loss="cauchy")
    om = ba._obs_masks(masks, options)
    p = problem
    F, (C, P), N = p.quat.shape[0], p.cam_params.shape, p.points.shape[0]
    fpm, cpm = maps.frame_pm, maps.cam_pm
    J = K.obs_jacobians(*p, om.pose, om.cam, om.point, model_id, options.loss,
                        options.loss_scale)
    lam = torch.tensor(1e-3, device="cuda")
    red = K.lm_reduce(*J, fpm, cpm, F, C, lam)
    red64 = _as64(red)
    for bj in (True, False):
        tag = "block-Jacobi" if bj else "scalar Jacobi"
        st = KL.pcg_setup(red.Hcc_pose, red.diag_pose, red.diag_cam, red.bp, red.bc, lam, bj)
        ref = KL.pcg_setup_plain(red64.Hcc_pose, red64.diag_pose, red64.diag_cam, red64.bp,
                                 red64.bc, lam.double(), bj)
        for n, a, b in zip(KL.PCGState._fields, st, ref):
            check(f"K34 set-up ({tag}) {n}", a, b, K34_RTOL, errs["ba_pcg"])
        Ap_p, Ap_c = K.schur_matvec(*J[1:], fpm, cpm, red.Hpp_inv, st.p[:6 * F].view(F, 6),
                                    st.p[6 * F:].view(C, P))
        ref = KL.pcg_step_plain(_as64(st), Ap_p.double(), Ap_c.double(), lam.double(),
                                red64.diag_pose, red64.diag_cam)
        st = KL.pcg_step(st, Ap_p, Ap_c, lam, red.diag_pose, red.diag_cam)
        for n, a, b in zip(KL.PCGState._fields, st, ref):
            if n != "M":
                check(f"K34 step ({tag}) {n}", a, b, K34_RTOL, errs["ba_pcg"])
    dp, dc = st.x[:6 * F].view(F, 6), st.x[6 * F:].view(C, P)
    dx = K.back_substitute(*J[1:], fpm, cpm, red.Hpp_inv, red.gx, dp, dc)
    params = (p.quat, p.t, p.cam_params, p.points)
    cand, pred = KL.lm_candidate(*params, dp, dc, dx, red, lam)
    cand64, pred64 = KL.lm_candidate_plain(*f64(*params, dp, dc, dx), red64, lam.double())
    for n, a, b in zip(("quat", "t", "cam_params", "points"), cand, cand64):
        check(f"K35 candidate {n}", a, b, K35_RTOL, errs["ba_lm_update"])
    check("K35 candidate pred", pred, pred64, K35_RTOL, errs["ba_lm_update"])
    new_cost = K.obs_cost64(*cand, *p[4:], model_id, options.loss, options.loss_scale)
    cost = K.obs_cost64(*p, model_id, options.loss, options.loss_scale)
    S0 = torch.tensor([2.0, 0, 0, 0, 0, 0, 0, 0, 0], dtype=torch.float64, device="cuda")
    S0[1:3] = cost
    state = tuple(x.clone() for x in params)
    state64 = tuple(x.double() for x in params)
    S, S64 = S0.clone(), S0.clone()
    lam_k, lam64 = lam.clone(), lam.double()
    flag, flag64 = (torch.zeros(1, dtype=torch.uint8, device="cuda") for _ in range(2))
    KL.lm_accept(lam_k, S, new_cost, pred, state, cand, 1e-10, 1e10, 1e-6, flag)
    KL.lm_accept_plain(lam64, S64, new_cost, pred, state64, cand64, 1e-10, 1e10, 1e-6, flag64)
    log(f"  K35 accept: S {S.tolist()} (plain {S64.tolist()}), lam {lam_k.item():.6e} (plain "
        f"{lam64.item():.6e})")
    if not (torch.equal(S[[0, 3, 4, 5, 6]], S64[[0, 3, 4, 5, 6]]) and torch.equal(flag, flag64)):
        raise AssertionError("K35 accept: nu, the count or the flags differ from float64")
    check("K35 accept costs", S[1:3], S64[1:3], 1e-12, errs["ba_lm_update"])
    check("K35 accept lam", lam_k, lam64, 1e-6, errs["ba_lm_update"])
    for n, a, b in zip(("quat", "t", "cam_params", "points"), state, state64):
        check(f"K35 accept state {n}", a, b, K35_RTOL, errs["ba_lm_update"])
    if not timed:
        return {}
    n_vec = 6 * F + C * P
    vec_bytes = 4 * (11 * n_vec + 36 * F)
    st_t = KL.pcg_setup(red.Hcc_pose, red.diag_pose, red.diag_cam, red.bp, red.bc, lam, True)
    Ap_p, Ap_c = K.schur_matvec(*J[1:], fpm, cpm, red.Hpp_inv, st_t.p[:6 * F].view(F, 6),
                                st_t.p[6 * F:].view(C, P))
    st64 = _as64(st_t)
    rows = {}
    rows["ba_pcg"] = _solver_row(
        "ba_pcg step", time_ms(lambda: KL.pcg_step(st_t, Ap_p, Ap_c, lam, red.diag_pose,
                                                   red.diag_cam)),
        time_ms(lambda: KL.pcg_step_plain(st64, Ap_p.double(), Ap_c.double(), lam.double(),
                                          red64.diag_pose, red64.diag_cam), reps=10),
        bound(vec_bytes, K34_ENTRY_OPS * n_vec + K34_FRAME_OPS * F))
    rows["ba_pcg"]["entries"] = {"setup": _entry_times(
        lambda: KL.pcg_setup(red.Hcc_pose, red.diag_pose, red.diag_cam, red.bp, red.bc, lam, True),
        lambda: KL.pcg_setup_plain(red64.Hcc_pose, red64.diag_pose, red64.diag_cam, red64.bp,
                                   red64.bc, lam.double(), True))}
    state_bytes = 4 * (7 * F + C * P + 3 * N)
    rows["ba_lm_update"] = _solver_row(
        "ba_lm_update candidate",
        time_ms(lambda: KL.lm_candidate(*params, dp, dc, dx, red, lam)),
        time_ms(lambda: KL.lm_candidate_plain(*f64(*params, dp, dc, dx), red64, lam.double()),
                reps=10),
        bound(2 * state_bytes + 4 * (18 * F + 4 * C * P + 9 * N),
              K35_FRAME_OPS * F + K35_CAM_OPS * C * P + K35_POINT_OPS * N))

    def accept():
        S.copy_(S0)  # an accepted step each time: the copy runs
        KL.lm_accept(lam_k, S, new_cost, pred, state, cand, 1e-10, 1e10, 1e-6, flag)

    def accept_plain():
        S64.copy_(S0)
        KL.lm_accept_plain(lam64, S64, new_cost, pred, state64, cand64, 1e-10, 1e10, 1e-6,
                           flag64)

    rows["ba_lm_update"]["entries"] = {"accept": _entry_times(accept, accept_plain)}
    return rows


def _loop_costs(label, problem, model_id, maps, masks, dense=False, reps=10):
    """What bundle_adjustment.py's size rule (GRAPH_MIN_ITERATIONS) and the
    flag's chunk (DONE_CHUNK) weigh, at these shapes with the mapper's BA
    options (with ``dense``, its dense Schur solver instead of PCG): an
    eager iteration's wall, recording and instantiating its graph, a
    replay's wall (T_i), one read of the done flag (T_r: a read after every
    replay against one after all of them), and a whole solve."""
    from colmap_tpu_torch.estimators import bundle_adjustment as ba
    from colmap_tpu_torch.kernels import ba as K
    from colmap_tpu_torch.kernels import solver as KL
    from colmap_tpu_torch.sfm.incremental_mapper import PIPELINE_BA_OPTIONS
    from colmap_tpu_torch.utils import cuda_graph

    options = PIPELINE_BA_OPTIONS
    if dense:
        options = dataclasses.replace(options, solver_type="dense_schur")
    state, sc, groups = ba._start(problem, model_id, options, options.initial_lambda, 2.0,
                                  K.KERNELS)
    om = ba._obs_masks(masks, options)

    def step():
        ba._lm_iteration(state, maps, model_id, options, om, sc, K.KERNELS, dense, True, groups)

    def wall_ms(fn, read_each=False):
        sc.done.item()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
            if read_each:
                sc.done.item()
        sc.done.item()
        return (time.perf_counter() - t0) / reps * 1e3

    gc_ms = [0.0, 0.0]  # Python's garbage collection: ms in it, start of a pass

    def gc_timer(phase, _):
        if phase == "start":
            gc_ms[1] = time.perf_counter()
        else:
            gc_ms[0] += (time.perf_counter() - gc_ms[1]) * 1e3

    def capture():
        gc_ms[0] = 0.0
        gc.callbacks.append(gc_timer)
        try:
            replay, _, rec_s, inst_s = cuda_graph.capture(step, torch.device("cuda"), (K, KL))
        finally:
            gc.callbacks.remove(gc_timer)
        return replay, rec_s, inst_s, gc_ms[0]

    step()  # loads what the first call needs, as the loop's eager iteration
    eager = wall_ms(step)
    # The first capture at a shape may pay one-off costs; every solve of a
    # running mapper records its own graph, so the second one is weighed.
    _, first_s, _, first_gc = capture()
    replay, rec_s, inst_s, rec_gc = capture()
    rep = wall_ms(replay)
    t_r = wall_ms(replay, read_each=True) - rep
    rec_ms = (rec_s + inst_s) * 1e3
    even = 1 + rec_ms / (eager - rep) if eager > rep else math.inf
    t0 = time.perf_counter()
    _, _, n, info = ba._lm_loop(problem, maps, model_id, options, masks, dense, True,
                                with_info=True)
    solve_s = time.perf_counter() - t0
    k_star = math.sqrt(2 * n * max(t_r, 0.0) / rep)
    log(f"  loop costs, {label} (the mapper's BA options{', dense Schur' if dense else ''}): "
        f"eager iteration {eager:.3f} ms, "
        f"graph recorded in {rec_s * 1e3:.2f} ms (the first at this shape "
        f"{first_s * 1e3:.2f} ms; Python's garbage collection inside them {rec_gc:.2f} and "
        f"{first_gc:.2f} ms) and instantiated in {inst_s * 1e3:.2f} ms, "
        f"replay {rep:.3f} ms (T_i), flag read {t_r * 1e3:.1f} us (T_r); the graph pays from "
        f"iteration {even:.2f} (GRAPH_MIN_ITERATIONS {ba.GRAPH_MIN_ITERATIONS}); a solve ran "
        f"{n} iterations in {solve_s * 1e3:.1f} ms with {info['host_reads']} host reads, "
        f"k* = sqrt(2 n T_r / T_i) = {k_star:.2f} (DONE_CHUNK {ba.DONE_CHUNK})")


def _k36_ops(c64, R, t):
    """Float64 operations of K36 (a) on these rows: K36_TRI_OPS per DLT
    triangulation and K36_ROTATION_OPS per Jacobi rotation that the skip
    rule lets through. The rotations are counted by running small_linalg.cuh's
    cyclic Jacobi (10 sweeps, the same skip rule) in torch on each
    triangulation's A^T A, under E's four candidates (masked rows) and the
    winner R, t (every row). Returns (operations, triangulations,
    rotations)."""
    from colmap_tpu_torch.geometry.essential import decompose_essential_matrix

    E, x1, x2, mask = c64["E"], c64["x1"], c64["x2"], c64["mask"]
    sizes = torch.tensor(c64["offsets"], device=E.device).diff()
    pid = torch.repeat_interleave(torch.arange(E.shape[0], device=E.device), sizes)
    R1, R2, t0 = decompose_essential_matrix(E)
    Rs = [R1, R2, R1, R2, R.double()]
    ts = [t0, t0, -t0, -t0, t.double()]
    mats = []
    for c in range(5):
        rows = mask if c < 4 else torch.ones_like(mask)
        Rr, tr = Rs[c][pid][rows], ts[c][pid][rows]
        u1, w1 = x1[rows, 0], x1[rows, 1]
        u2, w2 = x2[rows, 0, None], x2[rows, 1, None]
        A = torch.zeros(Rr.shape[0], 4, 4, dtype=torch.float64, device=E.device)
        A[:, 0, 0] = -1.0
        A[:, 0, 2] = u1
        A[:, 1, 1] = -1.0
        A[:, 1, 2] = w1
        A[:, 2, :3] = u2 * Rr[:, 2] - Rr[:, 0]
        A[:, 3, :3] = w2 * Rr[:, 2] - Rr[:, 1]
        A[:, 2, 3] = u2[:, 0] * tr[:, 2] - tr[:, 0]
        A[:, 3, 3] = w2[:, 0] * tr[:, 2] - tr[:, 1]
        mats.append(A.transpose(1, 2) @ A)
    A = torch.cat(mats)
    A = 0.5 * (A + A.transpose(1, 2))
    turns = 0
    for _ in range(10):
        for p in range(3):
            for q in range(p + 1, 4):
                apq, diff = A[:, p, q], A[:, q, q] - A[:, p, p]
                go = (apq != 0) & ~(apq.abs() * 1e12 < diff.abs())
                turns += int(go.sum())
                tau = diff / torch.where(go, 2.0 * apq, 1.0)
                tt = torch.where(tau == 0, 1.0,
                                 torch.sign(tau) / (tau.abs() + torch.sqrt(1.0 + tau * tau)))
                cc = torch.where(go, torch.rsqrt(1.0 + tt * tt), 1.0)[:, None]
                ss = torch.where(go, tt * torch.rsqrt(1.0 + tt * tt), 0.0)[:, None]
                cp, cq = A[:, :, p].clone(), A[:, :, q].clone()
                A[:, :, p], A[:, :, q] = cc * cp - ss * cq, ss * cp + cc * cq
                rp, rq = A[:, p, :].clone(), A[:, q, :].clone()
                A[:, p, :], A[:, q, :] = cc * rp - ss * rq, ss * rp + cc * rq
    return K36_TRI_OPS * A.shape[0] + K36_ROTATION_OPS * turns, A.shape[0], turns


def _k36(errs, rows):
    """K36's cheirality entry on the initial pair's 3 seeds x 8192 rows and
    on 780 pose-graph edges x 200 rows, its refinement on the 3 seeds,
    against float64 plain versions; timed."""
    from colmap_tpu_torch.kernels import solver as KL
    from colmap_tpu_torch.kernels import solver_cases as SC

    def cheirality(label, sizes, seed):
        c = SC.relative_pose_case(sizes, seed, "cuda")
        c64 = SC.as_double(c)
        args = (c["E"], c["x1"], c["x2"], c["mask"], c["offsets"])
        args64 = (c64["E"], c64["x1"], c64["x2"], c64["mask"], c["offsets"])
        out = KL.poses_from_essentials(*args)
        ref, plain_s = _timed(lambda: KL.poses_from_essentials_plain(*args64))
        check(f"K36 {label} R", out[0], ref[0], K36_RTOL, errs["relative_pose"])
        check(f"K36 {label} t", out[1], ref[1], K36_RTOL, errs["relative_pose"])
        flips = int((out[4] != ref[4]).sum())
        dcount = int((out[3].long() - ref[3]).abs().max())
        rows_n = out[4].numel()
        log(f"  K36 {label}: {flips} of {rows_n} rows flip their cheirality, counts within "
            f"{dcount} (at most {K36_FLIP_SHARE:g} of the rows)")
        if flips > K36_FLIP_SHARE * rows_n or dcount > K36_FLIP_SHARE * rows_n:
            raise AssertionError(f"K36 {label}: cheirality differs from float64")
        keep = (out[4] & ref[4])[:, None]
        check(f"K36 {label} points", torch.where(keep, out[2], 0.0),
              torch.where(keep, ref[2], 0.0), 1e-4, errs["relative_pose"])
        ms = time_ms(lambda: KL.poses_from_essentials(*args), reps=10)
        ops, tris, turns = _k36_ops(c64, ref[0], ref[1])
        b = bound64(nbytes(c["E"], c["x1"], c["x2"], c["mask"], *out), ops)
        log(f"  K36 {label}: {ops:.4e} float64 operations ({tris} triangulations, {turns} "
            f"Jacobi rotations, {turns / tris:.2f} each), bound {b[0]:.5f} ms by {b[1]}")
        return c, c64, ms, plain_s * 1e3, b

    c, c64, ms, plain_ms, b = cheirality("initial pair, 3 seeds x 8192 rows",
                                         [REL_ROWS] * REL_SEEDS, 1)
    rows["relative_pose"] = _solver_row("relative_pose cheirality, 3 x 8192", ms, plain_ms, b)
    _, _, g_ms, g_plain_ms, _ = cheirality(f"pose graph, {GRAPH_EDGES} edges x {GRAPH_ROWS} rows",
                                           [GRAPH_ROWS] * GRAPH_EDGES, 2)
    args = (c["q0"], c["t0"], c["x1"], c["x2"], c["weights"], c["offsets"])
    args64 = (c64["q0"], c64["t0"], c64["x1"], c64["x2"], c64["weights"], c["offsets"])
    q, t, rms = KL.refine_relative_poses(*args)
    (q64, t64, rms64), r_plain_s = _timed(lambda: KL.refine_relative_poses_plain(*args64))
    check("K36 refine q", q, q64, K36_RTOL, errs["relative_pose"])
    check("K36 refine t", t, t64, K36_RTOL, errs["relative_pose"])
    check("K36 refine rms", rms, rms64, 1e-4, errs["relative_pose"])
    r_ms = time_ms(lambda: KL.refine_relative_poses(*args), reps=10)
    log(f"    relative_pose pose graph: {g_ms:.4f} ms (plain {g_plain_ms:.1f} ms); refine, 3 x "
        f"8192: {r_ms:.4f} ms (plain {r_plain_s * 1e3:.1f} ms, bound "
        f"{bound64(0, K36_REFINE_ROW_OPS * REL_ROWS * REL_SEEDS)[0]:.5f} ms by operations)")
    rows["relative_pose"]["entries"] = {
        "pose_graph_780_edges": dict(ms=g_ms, plain_ms=g_plain_ms),
        "refine_3x8192": dict(ms=r_ms, plain_ms=r_plain_s * 1e3)}


def _k37(errs, rows, agree):
    """K37 on 64 injected samples at the rendered scene's shape against the
    float64 plain version (_check_k37), and its inlier entry; timed on one
    batch of 16 samples."""
    from colmap_tpu_torch.kernels import solver as KL
    from colmap_tpu_torch.kernels import solver_cases as SC
    from colmap_tpu_torch.optim.ransac import unpack_best

    c = SC.structure_less_case(SL_ROWS, SL_CAMS, SL_CHECK_SAMPLES, 3, "cuda")
    c64 = SC.as_double(c)
    a = [c[k] for k in SC.STRUCTURE_LESS_ARGS]
    a64 = [c64[k] for k in SC.STRUCTURE_LESS_ARGS]
    smp = [c[k] for k in SC.SAMPLE_ARGS]
    mk, ck, bk = KL.structure_less_score(*a, *smp, 36.0)
    mp, cp, bp = KL.structure_less_score_plain(*a64, *smp, 36.0)
    agreeing, near, agreeing_rel = _check_k37(
        mk, ck, bk, mp, cp, bp, lambda models: KL.structure_less_residuals_plain(models, *a64),
        errs["structure_less_ransac"])
    agree["structure_less_ransac"] = (agreeing, near)
    batch = [x[:SL_SAMPLES] for x in smp]  # one batch, as the mapper sends it
    _, plain_s = _timed(lambda: KL.structure_less_score_plain(*a64, *batch, 36.0))
    _, ip = unpack_best(int(bp.item()))
    inl = KL.structure_less_inliers(*a, mp[ip].float(), 36.0)
    res = KL.structure_less_residuals_plain(mp[ip][None], *a64)[0]
    flips = int((inl != (res <= 36.0)).sum())
    border = int(((res - 36.0).abs() <= 0.02 * 36.0).sum())
    log(f"  K37 inliers of the best model: {int(inl.sum())} rows, {flips} differ from float64 "
        f"({border} within 2% of the threshold)")
    if flips > border:
        raise AssertionError("K37 inliers differ from float64")
    ms = time_ms(lambda: KL.structure_less_score(*a, *batch, 36.0))
    rows["structure_less_ransac"] = _solver_row(
        "structure_less_ransac score, 16 samples x 2000 rows x 11 cameras", ms, plain_s * 1e3,
        bound(nbytes(*a, *batch) + SL_SAMPLES * 10 * (12 + 1) * 4 + 8,
              SL_SAMPLES * (SPH_E_SAMPLE_OPS + 10 * SL_ROWS * K37_ROW_OPS)))
    rows["structure_less_ransac"]["extra"] = {"agreeing_max_rel_err": agreeing_rel}
    rows["structure_less_ransac"]["entries"] = {"inliers": _entry_times(
        lambda: KL.structure_less_inliers(*a, mp[ip].float(), 36.0),
        lambda: KL.structure_less_inliers_plain(*a64, mp[ip], 36.0))}


def _check_k37(mk, ck, bk, mp, cp, bp, residuals, errs, max_sq=36.0):
    """K37's batch (a float64 solve, float32 models) against float64 on the
    same samples; returns the (agreeing, near-best) model counts and the
    agreeing ones' largest relative error.

    - the kernel's support of each of its models equals a float64 count of
      the same model, up to the rows within 2% of the threshold; NaN models
      score 0;
    - the best supports agree within SL_ROWS // 500 rows (all-inlier
      samples tie: which of them is first may differ);
    - of the plain models with at least 90% of the best support, at least
      K37_AGREE (all) have a kernel solution of the same sample whose
      float64 support lies within 1% of the rows of theirs and which lies
      within K37_MODEL_RTOL of the model (relative to its largest entry).

    The error that goes into ``errs`` is over every near-best model: the
    closest finite kernel solution of its sample, or, where the sample has
    none, the model's own size (relative error 1, as if the kernel returned
    zeros). Also returns the largest relative error over the agreeing ones.
    """
    from colmap_tpu_torch.optim.ransac import unpack_best

    n, per = SL_ROWS, 10  # 10 model slots a sample
    (sk, ik), (sp, ip) = unpack_best(int(bk.item())), unpack_best(int(bp.item()))
    log(f"  K37 best: kernel support {sk} at {ik}, plain support {sp} at {ip}")
    if abs(sk - sp) > n // 500:
        raise AssertionError(f"K37: best support {sk} vs plain {sp}")
    fin = torch.isfinite(mk.flatten(1)).all(1)
    res = residuals(mk[fin].double())
    counts64 = torch.zeros(mk.shape[0], dtype=torch.long, device=mk.device)
    counts64[fin] = (res <= max_sq).sum(-1)
    borderline = ((res - max_sq).abs() <= 0.02 * max_sq).sum(-1)
    diff = (ck[fin] - counts64[fin]).abs()
    log(f"  K37: {int(fin.sum())} finite kernel models ({int(torch.isfinite(mp.flatten(1)).all(1).sum())}"
        f" plain); support against a float64 count of the same models differs on "
        f"{int((diff > 0).sum())} by at most {int(diff.max())} (borderline rows: at most "
        f"{int(borderline.max())})")
    if bool((diff > borderline).any()) or bool((ck[~fin] != 0).any()):
        raise AssertionError("K37: kernel support differs from the float64 count")
    near_best = torch.nonzero(cp >= 0.9 * sp).flatten().tolist()
    all_errs, agreeing_rel, none, missed = [], [], 0, []
    for i in near_best:
        lo = (i // per) * per
        scale = float(mp[i].abs().max())
        if not bool(fin[lo:lo + per].any()):
            none += 1
            all_errs.append((scale, 1.0))
            continue
        gap = torch.nan_to_num((mk[lo:lo + per].double() - mp[i]).abs().flatten(1).amax(1),
                               nan=math.inf)
        a = float(gap.min())
        all_errs.append((a, a / scale))
        if (int((counts64[lo:lo + per][fin[lo:lo + per]] - int(cp[i])).abs().min()) <= n // 100
                and a / scale <= K37_MODEL_RTOL):
            agreeing_rel.append(a / scale)
        else:
            missed.append((i // per, i, a / scale))
    agreeing = len(agreeing_rel)
    if missed:
        log(f"  K37: near-best models without an agreeing kernel solution (sample, model, "
            f"closest relative error): {missed}")
    if agreeing < K37_AGREE * len(near_best):
        raise AssertionError(f"K37: {agreeing} of {len(near_best)} near-best models agree")
    errs.append((max(a for a, _ in all_errs), max(r for _, r in all_errs)))
    rel = sorted(agreeing_rel)
    log(f"  K37: {len(near_best)} plain models with >= 90% of the best support; {agreeing} have "
        f"a kernel solution of their sample within {n // 100} rows of their float64 support and "
        f"{K37_MODEL_RTOL:g} of the model "
        f"(the closest one's error: median {rel[len(rel) // 2]:.3e}, largest {rel[-1]:.3e}); "
        f"over all {len(near_best)}: largest {errs[-1][1]:.3e} ({none} samples with no finite "
        "kernel model)")
    return agreeing, len(near_best), rel[-1]


def _k40(errs, rows):
    """K40 against its float64 plain versions at a rig registration's
    scale (2000 rows of one 4-camera frame, 30% outliers): (a) the
    refinement from a start 3 degrees and 0.05 off, every row weighted (the
    Cauchy loss meets the outliers); (b) the weighted refit over the true
    inliers, with and without the scale; timed."""
    from colmap_tpu_torch.kernels import rig as KR
    from colmap_tpu_torch.kernels import rig_cases as RC

    log(f"K40 vs float64 plain: {GEN_ABS_ROWS} rows x 4 cameras")
    rows_, q0, t0, Rt = RC.refine_case(GEN_ABS_ROWS, 3, device="cuda")
    q, t = KR.gen_abs_refine(*rows_, q0, t0)
    trace = []
    (q64, t64), plain_s = _timed(lambda: KR.gen_abs_refine_plain(*rows_, q0, t0, trace=trace))
    check("K40 refine q", q, q64, K40_RTOL, errs["gen_abs_refine"])
    check("K40 refine t", t, t64, K40_RTOL, errs["gen_abs_refine"])
    log(f"  K40 refine: {len(trace)} iterations ({trace.count(False)} rejected) in the plain "
        f"loop; t against the truth {float((t.cpu() - torch.as_tensor(Rt[:, 3])).abs().max()):.3e}")
    data, _, inl = RC.gen_abs_case(GEN_ABS_ROWS, seed=4, world_scale=0.37, device="cuda")
    w = torch.as_tensor(inl, dtype=torch.float64, device="cuda")
    for scale in (False, True):
        m, ok = KR.gen_abs_refit(data.X, data.centers, data.dirs, w, scale)
        m64, ok64 = KR.gen_abs_refit_plain(data.X, data.centers, data.dirs, w, scale)
        if not (bool(ok[0]) and bool(ok64[0])):
            raise AssertionError(f"K40 refit (scale {scale}): flags {bool(ok[0])}, plain "
                                 f"{bool(ok64[0])}")
        check(f"K40 refit (scale {scale})", m, m64, K40_RTOL, errs["gen_abs_refine"])
    n = GEN_ABS_ROWS
    ms = time_ms(lambda: KR.gen_abs_refine(*rows_, q0, t0), reps=10)
    rows["gen_abs_refine"] = _solver_row(
        f"gen_abs_refine (a), {n} rows x 4 cameras, {len(trace)} iterations", ms, plain_s * 1e3,
        bound64(nbytes(*rows_, q0, t0) + 7 * 8, K40_ROW_OPS * n * len(trace)))
    rows["gen_abs_refine"]["entries"] = {"refit": _entry_times(
        lambda: KR.gen_abs_refit(data.X, data.centers, data.dirs, w, True),
        lambda: KR.gen_abs_refit_plain(data.X, data.centers, data.dirs, w, True))}
    log(f"    gen_abs_refine (b) refit: {rows['gen_abs_refine']['entries']} (bound "
        f"{bound64(nbytes(data.X, data.centers, data.dirs, w), K40_REFIT_ROW_OPS * n)[0]:.5f} ms)")


# K34's step by plan on seeded vectors (solver_cases.pcg_vectors): the
# weighing's heaviest classes (F 8 CP 4, F 4 CP 4, F 8 CP 8), the one-warp
# instances at the plan's bound (32 frames and 32, 64 and 128 camera
# entries), the rig's undamped step and the BA headline.
K34_PLAN_SHAPES = ((8, 4, True), (4, 4, True), (8, 8, True), (32, 32, True), (32, 64, True),
                   (32, 128, True), (0, 96, False), (200, 4, True))


def _k34_plans(errs, rows):
    """K34's step by its plan and by the block on the same inputs, against
    float64 and timed (in place, as the PCG runs it), at K34_PLAN_SHAPES;
    the times go into the K34 row's entries."""
    from colmap_tpu_torch.kernels import solver as KL
    from colmap_tpu_torch.kernels.solver_cases import pcg_vectors

    log("K34 step by plan (seeded vectors; CUDA-event-timed launches):")
    entries = rows["ba_pcg"]["entries"]
    for F, CP, damped in K34_PLAN_SHAPES:
        st0, Ap0, damping = pcg_vectors(F, CP, damped, F + CP, "cuda")
        ref = KL.pcg_step_plain(_as64(st0), *f64(*Ap0), *f64(*damping))
        plan = KL.pcg_step_plan(F, CP)
        times = {}
        for pl in dict.fromkeys([plan, 0]):
            st = KL.PCGState(*(v.clone() for v in st0))
            Ap = tuple(a.clone() for a in Ap0)
            KL.pcg_step_planned(st, *Ap, *damping, pl)
            for n, a, b in zip(KL.PCGState._fields[1:], st[1:], ref[1:]):
                check(f"K34 step F {F} CP {CP} by {pl} {n}", a, b, K34_RTOL, errs["ba_pcg"])
            times[pl] = time_ms(lambda: KL.pcg_step_planned(st, *Ap, *damping, pl), reps=200)
        n = 6 * F + CP
        b_ms, by = bound(4 * (11 * n + 36 * F), K34_ENTRY_OPS * n + K34_FRAME_OPS * F)
        entries[f"step F {F} CP {CP}{'' if damped else ' undamped'}"] = dict(
            ms=times[plan], plan=plan, block_ms=times[0], bound_ms=b_ms)
        log(f"    F {F}, CP {CP}: plan {plan} {times[plan]:.5f} ms, block {times[0]:.5f} ms, "
            f"bound {b_ms:.5f} ms by {by}")


def phase_solver_kernels():
    """K34-K37 and K40 against their float64 plain versions: K34 and K35 at
    the BA headline and at a mapper-sized local BA, K34's step by plan
    (_k34_plans), K36 on the initial
    pair's seeds and on a pose graph's edges, K37 on injected samples at the
    rendered scene's shape, K40 at a rig registration's; timed with CUDA
    events. Returns (errs, rows, agree)."""
    from colmap_tpu_torch.estimators import bundle_adjustment as ba
    from colmap_tpu_torch.scene.synthetic_ba import synthetic_ba_problem

    errs = {k: [] for k in SOLVER_SOURCES}
    rows, agree = {}, {}
    for (F, N), timed in ((EARLY_LOCAL_BA, False), (LOCAL_BA, False), ((200, 50000), True)):
        problem, _, model_id = synthetic_ba_problem(F, N, 6, seed=0, device="cuda")
        masks = ba.fix_gauge_two_frames(ba.default_masks(problem, model_id, ba.BAOptions()), 0, 1)
        packed, maps, _ = ba.pack_problem(problem)
        label = "headline 200 x 50000" if timed else f"local BA {F} x {N}"
        if timed:
            log("K34, K35 times at the headline shapes (median of CUDA-event-timed launches):")
        rows.update(_k34_k35(label, packed, model_id, maps, masks, errs, timed))
        _loop_costs(label, packed, model_id, maps, masks)
        if timed:
            _loop_costs(label, packed, model_id, maps, masks, dense=True)
    _k34_plans(errs, rows)
    _k36(errs, rows)
    _k37(errs, rows, agree)
    _k40(errs, rows)
    return errs, rows, agree


# ---------------------------------------------------------------------------
# Options of the front end and of RANSAC: K45-K47, the MSAC mode, shapes.
# ---------------------------------------------------------------------------

OPTIONS_SOURCES = {
    "sift_affine_shape": ("colmap_tpu_torch/csrc/sift_affine_shape.cu",
                          "colmap_tpu/feature/sift.py:472"),
    "degensac": ("colmap_tpu_torch/csrc/degensac.cu", "colmap_tpu/estimators/degensac.py:70"),
    "sprt": ("colmap_tpu_torch/csrc/sprt.cu", "colmap_tpu/optim/sprt.py:53"),
}
# K45 against float64: five Baumberg iterations feed float32 moment sums
# back into A. Shapes within K45_ATOL, except keypoints whose float64 shape
# (before the guard) has its largest entry within K45_GUARD_TIE of 8.
K45_ATOL, K45_GUARD_TIE = 1e-3, 1e-3
# Flops a sample and iteration of K45: the warped position (4), two
# bilinear gradient samples (~28), A^T grad (6), the Gaussian weight (~12),
# the three moments (6).
K45_SAMPLE_OPS = 56
# Phase options_kernels' shapes: 8192 rows (the matcher's keypoints a
# frame); K46's 256 hypotheses (colmap_tpu's num_pair_hypotheses); MSAC on
# a matcher-phase block of 8 pairs and on a 64-pair 360-degree block, 128
# samples a pair; K47 on 256 hypotheses of that block's first pair.
OPT_ROWS, DEG_HYPOTHESES, MSAC_PAIRS, MSAC_SAMPLES = 8192, 256, 8, 128
# MSAC scores of the kernel's models against a float64 score of the same
# models (float32 residuals summed in another order); two bests are a
# near-tie where the float64 score of the kernel's pick lies within
# MSAC_TIE of the plain best (K32's float32 five-point solve on noisy rays
# moved a pick's score by 1.06e-3 of the best on an H100; its count check
# allows n // 1000 rows),
# K46's where their float64 supports lie within K46_TIE_ROWS rows; K47's
# decisions may differ where a running float64 sum lies within K47_TIE of
# log A.
MSAC_RTOL, MSAC_TIE, K46_TIE_ROWS, K47_TIE = 1e-5, 2e-3, OPT_ROWS // 1000, 1e-9
# K33 computes its residual as |h - q|^2 of float32 unit rays: at a 4 px
# threshold (1.9e-5 rad^2) that holds ~1e-4 of a residual; an H100 run
# measured 7.9e-5 of a near-best score.
MSAC_RTOL_K33 = 5e-4
# f32 operations: K46 per hypothesis (two parallax lines, the epipole,
# [e]x H and its norm) ~150, per row the epipolar distance ~20; MSAC adds
# two per row and model to K7's, K11's, K12's, K32's and K33's counts (see
# phases sfm, matching, camera_kernels); K47 per evaluated row a compare, a
# select and the scan's float64 adds (~8).
K46_HYP_OPS, K46_ROW_OPS, K47_ROW_OPS = 150, 20, 8
# Phase options: 64 uncalibrated pairs of 8192 matches, 80% on a dominant
# plane, 15% off it, 5% random; the final F keeps at least DEG_KEEP_OFF of
# the planted off-plane matches. Affine SIFT: the count within
# AFFINE_COUNT_TOL of the CPU path's on a 768 x 576 crop; a view stretched
# STRETCH times in x matches at least STRETCH_GAIN times as well with
# affine shapes as without (tests/test_features.py:169's check).
DEG_PAIRS, DEG_PLANE, DEG_OFF, DEG_KEEP_OFF = 64, 0.80, 0.15, 0.95
AFFINE_CROP, AFFINE_COUNT_TOL, STRETCH, STRETCH_GAIN = (768, 576), 0.01, 1.6, 1.2
OPTIONS_STATE = {}


def _options_views():
    """The four rendered 3072 x 2304 views of phases options_kernels and
    options (BASELINE.json config 1's size), rendered once."""
    if "dir" not in OPTIONS_STATE:
        from colmap_tpu_torch.kernels import sift_cases as SC

        d = tempfile.mkdtemp()
        t0 = time.perf_counter()
        _, names, _ = SC.render_scene(d, EXTRACT_VIEWS, SIFT_POINTS, SIFT_W, SIFT_H,
                                      1.25 * SIFT_W)
        OPTIONS_STATE.update(dir=d, names=names)
        log(f"  {EXTRACT_VIEWS} rendered {SIFT_W} x {SIFT_H} views "
            f"({time.perf_counter() - t0:.1f} s)")
    return OPTIONS_STATE["dir"], OPTIONS_STATE["names"]


def _view(i):
    from colmap_tpu_torch.utils.image_io import read_image_gray

    d, names = _options_views()
    return read_image_gray(os.path.join(d, names[i]))


def _options_sift(errs, rows, entries):
    """K45 and K15, K16 on affine frames at octave 0 of view 0."""
    from colmap_tpu_torch.feature import sift as FS
    from colmap_tpu_torch.kernels import sift as KS

    img = torch.from_numpy(_view(0)).to("cuda").float() / 255.0
    opts = FS.SiftOptions(estimate_affine_shape=True)
    gauss, dog = KS.build_octave(KS.blur(KS.upsample2(img), opts.sigma0), opts)
    ext = KS.detect_extrema(dog, opts)
    del dog
    sel = KS.select_candidates(ext, opts.max_candidates_per_octave)
    x, y, lvl, sigma, resp = KS.selected_keypoints(ext, sel)
    K_, g64 = len(sel), gauss.double()
    x64, y64, s64 = x.double(), y.double(), sigma.double()
    shapes = KS.affine_shapes(gauss, x, y, lvl, sigma, opts)
    raw = KS.affine_shapes_plain(g64, x64, y64, lvl, s64, opts, guard=False)
    ref = KS.affine_shapes_plain(g64, x64, y64, lvl, s64, opts)
    near = torch.isfinite(raw).all(dim=(1, 2)) & (
        (raw.abs().amax(dim=(1, 2)) - 8.0).abs() <= K45_GUARD_TIE)
    err = (shapes.double() - ref).abs().amax(dim=(1, 2))
    worst = float(err[~near].max())
    errs["sift_affine_shape"].append((worst, worst / float(ref.abs().max())))
    guarded = int((~(torch.isfinite(raw).all(dim=(1, 2)) & (raw.abs().amax(dim=(1, 2)) < 8))).sum())
    log(f"  K45: {K_} keypoints of octave 0, {guarded} at the guard (identity), {int(near.sum())} "
        f"within {K45_GUARD_TIE:g} of it; shapes within {worst:.3e} of float64 (tol "
        f"{K45_ATOL:g}), median {float(err.median()):.3e}; largest |A| entry "
        f"{float(ref.abs().max()):.3f}")
    if not worst <= K45_ATOL:
        raise AssertionError(f"K45: shapes differ from float64 by {worst:.3e}")
    # K15 and K16 on the kernel's shapes.
    n_ori = opts.max_num_orientations
    theta, ok = KS.orientations(gauss, x, y, lvl, sigma, opts, shapes)
    sh64 = shapes.double()
    theta_p, ok_p = KS.orientations_plain(g64, x64, y64, lvl, s64, opts, sh64)
    hist = KS.orientation_histograms_plain(g64, x64, y64, lvl, s64, sh64)
    clear = orientation_margin(hist, n_ori) > 1e-4
    agree = (ok == ok_p).all(dim=1)
    dth = torch.remainder(theta.double() - theta_p + math.pi, 2 * math.pi) - math.pi
    both = ok & ok_p & agree[:, None]
    th_err = float(dth[both].abs().max())
    errs["sift_orientation"].append((th_err, th_err / math.pi))
    log(f"  K15 on affine frames: {int(ok.sum())} orientations; ok rows differ on "
        f"{int((~agree).sum())} keypoints ({int((~agree & clear).sum())} with a margin above "
        f"1e-4); theta max error {th_err:.3e} rad (tol {K15_RAD:g})")
    if int((~agree & clear).sum()) or not th_err <= K15_RAD:
        raise AssertionError("K15 on affine frames: orientations differ")
    data, desc = KS.descriptors(gauss, x, y, lvl, sigma, resp, theta, ok, opts, shapes)
    data_p, _, desc_p = KS.descriptors_plain(g64, x64, y64, lvl, s64, resp.double(),
                                             theta.double(), opts, sh64)
    okr = ok.reshape(-1)
    dd = (desc[okr].int() - desc_p[okr].int()).abs()
    counts = int(dd.max())
    errs["sift_descriptor"].append((float(counts), counts / 255.0))
    log(f"  K16 on affine frames: {int(okr.sum())} rows, descriptors within {counts} count "
        f"(tol {K16_COUNTS}), {float((dd == 0).double().mean()):.6f} of entries equal")
    check("K16 affine rows (x, y, sigma, theta, response, frame)", data[okr], data_p[okr], 1e-5,
          errs["sift_descriptor"])
    if counts > K16_COUNTS:
        raise AssertionError("K16 on affine frames: descriptors differ by more than one count")
    log("  times at octave 0 (6144 x 4608) with estimate_affine_shape:")
    frames = sigma[:, None, None] * shapes
    iters = opts.affine_shape_iterations
    rows["sift_affine_shape"] = _sift_row(
        "sift_affine_shape", lambda: KS.affine_shapes(gauss, x, y, lvl, sigma, opts),
        lambda: KS.affine_shapes_plain(gauss, x, y, lvl, sigma, opts),
        sampled_level_bytes(gauss.shape, x, y, lvl, frames) + 36 * K_,
        K45_SAMPLE_OPS * 256 * iters * K_)
    ori_bytes = sampled_level_bytes(gauss.shape, x, y, lvl, frames)
    entries["sift_orientation"]["affine frames, octave 0"] = _entry_row(
        "sift_orientation, affine frames", lambda: KS.orientations(gauss, x, y, lvl, sigma, opts, shapes),
        lambda: KS.orientations_plain(gauss, x, y, lvl, sigma, opts, shapes),
        ori_bytes + 36 * K_ + 5 * ok.numel(), SIFT_SAMPLE_OPS * 256 * K_)
    rr = okr.nonzero().flatten() // n_ori
    th = theta.reshape(-1)[okr]
    c, s = torch.cos(th), torch.sin(th)
    rot = torch.stack([torch.stack([c, -s], -1), torch.stack([s, c], -1)], -2)
    desc_bytes = sampled_level_bytes(gauss.shape, x[rr], y[rr], lvl[rr],
                                     sigma[rr, None, None] * (shapes[rr] @ rot))
    entries["sift_descriptor"]["affine frames, octave 0"] = _entry_row(
        "sift_descriptor, affine frames", lambda: KS.descriptors(gauss, x, y, lvl, sigma, resp, theta, ok, opts, shapes),
        lambda: KS.descriptors_plain(gauss, x, y, lvl, sigma, resp, theta, opts, shapes),
        desc_bytes + 40 * K_ + 4 * theta.numel() + ok.numel() + (36 + 128) * theta.numel(),
        (SIFT_SAMPLE_OPS * 256 + 8 * 4 * 256) * len(rr))


def _entry_row(label, fn, plain, bytes_moved, ops, reps=10, plain_reps=3, ops64=0):
    ms, plain_ms = time_ms(fn, reps=reps), time_ms(plain, reps=plain_reps)
    b_ms, by = bound64(bytes_moved, ops64) if ops64 else bound(bytes_moved, ops)
    log(f"    {label}: {ms:.4f} ms (plain {plain_ms:.3f} ms, bound {b_ms:.5f} ms by {by})")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=by)


def _msac_checks(tag, name, propose, propose_p, residual, case, errs, pieces, rtol=MSAC_RTOL):
    """The MSAC mode of one propose-and-score kernel on a block, against
    float64 in pieces of ``pieces`` pairs: the kernel's scores of its
    near-best models (a float64 score of at least 90% of the pair's best)
    against a float64 score of the same models, relative to each (a
    degenerate model's float32 residuals can be off by px^2 on single rows,
    so the largest error over all models is logged, not gated); its counts
    against a float64 count (up to rows within 2% of the threshold); its
    best against the plain version's (the same index or a near-tie).
    Returns the block's args and (pairs with the same best, pairs)."""
    from colmap_tpu_torch.kernels.sfm_cases import as_double
    from colmap_tpu_torch.optim.ransac import score_models

    c = case
    args = (c["x1"], c["x2"], c["mask"], c["samples"], c["max_sq"])
    mk, ck, bk, sk = propose(*args, msac=True)
    B = c["x1"].shape[0]
    worst_s, worst_a, worst_all, moved, same, ties = 0.0, 0.0, 0.0, 0, 0, 0
    for lo in range(0, B, pieces):
        sl = slice(lo, min(B, lo + pieces))
        piece = {k: (v[sl] if torch.is_tensor(v) and v.dim() else v) for k, v in c.items()}
        d = as_double(piece)
        sq = d["max_sq"]
        mp, cp, bp, sp = propose_p(d["x1"], d["x2"], d["mask"], d["samples"], sq, msac=True)
        for j, b in enumerate(range(sl.start, sl.stop)):
            s_b = float(sq[j]) if torch.is_tensor(sq) else sq
            m64 = mk[b].double()
            res = residual(m64[:, None], d["x1"][j][None], d["x2"][j][None])
            cnt64, s64 = score_models(m64, res, d["mask"][j], s_b, True)
            err = (sk[b].double() - s64).abs()
            rel = err / s64.clamp(min=1e-30)
            top = s64 >= 0.9 * s64.max()
            worst_a = max(worst_a, float(err[top].max()))
            worst_s = max(worst_s, float(rel[top].max()))
            worst_all = max(worst_all, float(err.max() / s64.max()))
            fin = torch.isfinite(m64.flatten(1)).all(1)
            border = ((torch.where(d["mask"][j], res, torch.inf) - s_b).abs()
                      <= 0.02 * s_b).sum(-1)
            moved += int(((ck[b] - cnt64).abs() > border)[fin].sum())
            ik = 0xFFFFFFFF - (int(bk[b]) & 0xFFFFFFFF)
            ip = 0xFFFFFFFF - (int(bp[j]) & 0xFFFFFFFF)
            if ik != int(torch.argmax(sk[b])):
                raise AssertionError(f"{tag} MSAC: pair {b}'s packed best is not the first "
                                     "largest score")
            if ik == ip:
                same += 1
            elif float(s64[ik]) >= (1 - MSAC_TIE) * float(sp[j, ip]):
                ties += 1
            else:
                raise AssertionError(f"{tag} MSAC: pair {b}'s best {ik} (float64 score "
                                     f"{float(s64[ik]):.6g}) vs plain {ip} ({float(sp[j, ip]):.6g})")
        del mp, cp, bp, sp
    errs[name].append((worst_a, worst_s))
    log(f"  {tag} MSAC on {B} pairs x {c['x1'].shape[1]} rows x {c['samples'].shape[1]} samples: "
        f"near-best scores within {worst_s:.3e} of float64 (tol {rtol:g}; all models "
        f"{worst_all:.3e} of the best score); counts beyond the "
        f"threshold's 2% on {moved} models; best: {same} pairs the same, {ties} near-ties")
    if not worst_s <= rtol or moved:
        raise AssertionError(f"{tag} MSAC: scores or counts differ from float64")
    return args, [same, same + ties]


def _options_msac(errs, entries):
    """The MSAC mode of K7, K11, K12 (a matcher-phase block of 8 pairs x 8192
    matches) and K32, K33 (a 64-pair x 8192-ray 360-degree block)."""
    from colmap_tpu_torch.estimators.solvers.epipolar import homography_transfer_error
    from colmap_tpu_torch.geometry.essential import sampson_error, squared_epipolar_line_distance
    from colmap_tpu_torch.geometry.spherical import (angular_sampson_error,
                                                     homography_ray_angular_error)
    from colmap_tpu_torch.kernels import matching as KM
    from colmap_tpu_torch.kernels import matching_cases as C
    from colmap_tpu_torch.kernels import sfm as K
    from colmap_tpu_torch.kernels import spherical as KQ
    from colmap_tpu_torch.kernels import spherical_cases as Q

    out = {}
    for tag, name, kind, propose, propose_p, residual, sample_ops, row_ops, sols in (
            ("K7", "essential_ransac", "E", K.essential_propose_score,
             K.essential_propose_score_plain, sampson_error, SPH_E_SAMPLE_OPS, 27, 10),
            ("K11", "fundamental_ransac", "F", KM.fundamental_propose_score,
             KM.fundamental_propose_score_plain, squared_epipolar_line_distance, 4000, 22, 3),
            ("K12", "homography_ransac", "H", KM.homography_propose_score,
             KM.homography_propose_score_plain, homography_transfer_error, 4000, 22, 1),
            ("K32", "spherical_e_ransac", "sE", KQ.spherical_e_propose_score,
             KQ.spherical_e_propose_score_plain, angular_sampson_error, SPH_E_SAMPLE_OPS,
             SPH_E_ROW_OPS + 2, 10),
            ("K33", "spherical_h_ransac", "sH", KQ.spherical_h_propose_score,
             KQ.spherical_h_propose_score_plain, homography_ray_angular_error, SPH_H_SAMPLE_OPS,
             SPH_H_ROW_OPS + 2, 1)):
        if kind.startswith("s"):
            case = Q.ray_block_case(kind[1], SPH_PAIRS, SPH_ROWS, MSAC_SAMPLES, 4, "cuda")
            pieces = SPH_PLAIN_PAIRS
        else:
            case = C.two_view_block_case(kind, MSAC_PAIRS, OPT_ROWS, MSAC_SAMPLES, 3, "cuda")
            pieces = MSAC_PAIRS
        args, same_best = _msac_checks(tag, name, propose, propose_p, residual, case, errs,
                                       pieces, MSAC_RTOL_K33 if tag == "K33" else MSAC_RTOL)
        if kind == "F":
            out["F"] = case
        B, k = case["x1"].shape[0], case["samples"].shape[1]
        valid = float(case["mask"].sum())
        ms = time_ms(lambda: propose(*args, msac=True), reps=10)
        plain_ms = 0.0
        for lo in range(0, B, pieces):
            piece = [a[lo:lo + pieces] if torch.is_tensor(a) and a.dim() else a for a in args]
            plain_ms += time_ms(lambda: propose_p(*piece, msac=True), reps=1)
        b_ms, by = bound(nbytes(*args[:4]) + B * k * sols * 48 + 8 * B,
                         B * k * sample_ops + k * sols * valid * row_ops)
        entries[name][f"msac, {B} pairs x {case['x1'].shape[1]} rows x {k} samples"] = dict(
            ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=by, same_best=same_best)
        log(f"    {name} MSAC: {ms:.4f} ms (plain {plain_ms:.3f} ms, bound {b_ms:.5f} ms by {by})")
    return out


def _degensac_case(n, seed):
    """One uncalibrated pair of n pixel matches (1024 x 768): DEG_PLANE on
    a plane, DEG_OFF off it, the rest random; returns x1, x2 (n, 2) float64
    numpy, the planted rows' kind (0 plane, 1 off the plane, 2 random)."""
    from colmap_tpu_torch.kernels import matching_cases as C

    rng = np.random.default_rng(seed)
    n_plane, n_off = int(DEG_PLANE * n), int(DEG_OFF * n)
    p = C.two_view_case("H", n, 2, seed, "cpu", outliers=0.0, valid=n)
    g = C.two_view_case("F", n, 2, seed + 1, "cpu", outliers=0.0, valid=n)
    x1 = np.concatenate([p["x1"][:n_plane].numpy(), g["x1"][n_plane:].numpy()]).astype(np.float64)
    x2 = np.concatenate([p["x2"][:n_plane].numpy(), g["x2"][n_plane:].numpy()]).astype(np.float64)
    kind = np.zeros(n, dtype=np.int64)
    kind[n_plane:n_plane + n_off] = 1
    kind[n_plane + n_off:] = 2
    x2[kind == 2] = rng.uniform(0, [C.WIDTH, C.HEIGHT], (int((kind == 2).sum()), 2))
    perm = rng.permutation(n)
    return x1[perm], x2[perm], kind[perm]


def _options_degensac(errs, rows, agree):
    """K46 at 8192 rows x 256 hypotheses against float64."""
    from colmap_tpu_torch.estimators.solvers.epipolar import homography_dlt
    from colmap_tpu_torch.geometry.essential import squared_epipolar_line_distance
    from colmap_tpu_torch.kernels import matching as KM
    from colmap_tpu_torch.kernels.matching_cases import MAX_SQ_PX

    x1n, x2n, kind = _degensac_case(OPT_ROWS, 11)
    rng = np.random.default_rng(12)
    off = np.flatnonzero(kind != 0)  # the pool: rows the plane's H does not explain
    ia = torch.from_numpy(off[rng.integers(0, len(off), DEG_HYPOTHESES)].astype(np.int32)).cuda()
    ib = torch.from_numpy(off[rng.integers(0, len(off), DEG_HYPOTHESES)].astype(np.int32)).cuda()
    x1d, x2d = torch.from_numpy(x1n).cuda(), torch.from_numpy(x2n).cuda()
    mask = torch.ones(OPT_ROWS, dtype=torch.bool, device="cuda")
    H64 = homography_dlt(x1d[torch.from_numpy(kind == 0).cuda()],
                         x2d[torch.from_numpy(kind == 0).cuda()])
    x1, x2, H = x1d.float().contiguous(), x2d.float().contiguous(), H64.float().contiguous()
    Fs, counts, best = KM.degensac_propose_score(x1, x2, mask, H, ia, ib, MAX_SQ_PX)
    Fp, cp, bp = KM.degensac_propose_score_plain(x1.double(), x2.double(), mask, H.double(), ia,
                                                 ib, MAX_SQ_PX)
    (sk, ik), (sp, ip) = [(int(v) >> 32, 0xFFFFFFFF - (int(v) & 0xFFFFFFFF)) for v in (best, bp)]
    res = squared_epipolar_line_distance(Fs.double()[:, None], x1.double()[None],
                                         x2.double()[None])
    fin = torch.isfinite(Fs.flatten(1)).all(1) & (ia != ib)
    border = ((res - MAX_SQ_PX).abs() <= 0.02 * MAX_SQ_PX).sum(-1)
    moved = int(((counts - (res <= MAX_SQ_PX).sum(-1)).abs() > border)[fin].sum())
    near = torch.nonzero(cp >= 0.9 * sp).flatten()
    sign = torch.sign((Fs.double()[near] * Fp[near]).flatten(1).sum(1))[:, None, None]
    e = (Fs.double()[near] * sign - Fp[near]).abs().flatten(1).amax(1)
    good = int((e <= K67_RTOL).sum())
    errs["degensac"].append((float(e.max()), float(e.max())))
    agree["degensac"] = (good, len(near))
    tie = abs(int(cp[ik]) - int(cp[ip])) <= K46_TIE_ROWS
    log(f"  K46, {OPT_ROWS} rows x {DEG_HYPOTHESES} hypotheses: best {ik} (support {sk}) vs "
        f"plain {ip} ({sp}){'' if ik == ip else f', a near-tie: {tie}'}; counts beyond the "
        f"threshold's 2% on {moved} hypotheses; {good} of {len(near)} near-best hypotheses "
        f"within {K67_RTOL:g} of float64 (largest {float(e.max()):.3e}); "
        f"{int((ia == ib).sum())} with ia = ib")
    if (ik != ip and not tie) or moved or good < 0.8 * len(near) or int(counts[ia == ib].sum()):
        raise AssertionError("K46 differs from its float64 plain version")
    ops = DEG_HYPOTHESES * K46_HYP_OPS + DEG_HYPOTHESES * OPT_ROWS * K46_ROW_OPS
    rows["degensac"] = _entry_row(
        "degensac", lambda: KM.degensac_propose_score(x1, x2, mask, H, ia, ib, MAX_SQ_PX),
        lambda: KM.degensac_propose_score_plain(x1, x2, mask, H, ia, ib, MAX_SQ_PX),
        nbytes(x1, x2, mask, H, ia, ib, Fs, counts, best), ops)
    rows["degensac"]["library_ms"] = None


def _options_sprt(errs, rows, case):
    """K47 on 256 hypotheses x 8192 rows: F models of random 7-point samples
    of the MSAC block's first pair and their squared epipolar distances."""
    from colmap_tpu_torch.geometry.essential import squared_epipolar_line_distance
    from colmap_tpu_torch.kernels import matching as KM
    from colmap_tpu_torch.kernels import sprt as KP
    from colmap_tpu_torch.kernels.matching_cases import MAX_SQ_PX
    from colmap_tpu_torch.optim.sprt import SPRTOptions, decision_threshold

    x1, x2, mask = case["x1"][0], case["x2"][0], case["mask"][0]
    valid = int(mask.sum())
    samples = torch.from_numpy(np.random.default_rng(9).integers(
        0, valid, (DEG_HYPOTHESES, 7)).astype(np.int32)).cuda()
    models, _, _ = KM.fundamental_propose_score(x1, x2, mask, samples, MAX_SQ_PX)
    models = models[torch.isfinite(models.flatten(1)).all(1)][:DEG_HYPOTHESES]
    res = squared_epipolar_line_distance(models[:, None], x1[None], x2[None]).contiguous()
    o = SPRTOptions()
    args = (MAX_SQ_PX, math.log(decision_threshold(o)), math.log(o.delta / o.epsilon),
            math.log((1 - o.delta) / (1 - o.epsilon)))
    acc, num = KP.sprt(res, mask, *args)
    acc_p, num_p = KP.sprt_plain(res, mask, *args)
    steps = KP.sprt_steps(res, mask, MAX_SQ_PX, args[2], args[3])
    near = ((torch.cumsum(steps, -1) - args[1]).abs() <= K47_TIE).any(-1)
    diff = (acc != acc_p) | (num != num_p)
    worst = float((num - num_p).abs()[~near].max())
    errs["sprt"].append((worst, worst / res.shape[1]))
    log(f"  K47, {res.shape[0]} hypotheses x {res.shape[1]} rows: {int(acc.sum())} accepted, "
        f"rows evaluated {int(num.sum())} of {num.numel() * res.shape[1]}; decisions differ on "
        f"{int(diff.sum())} ({int((diff & ~near).sum())} away from a near-tie, {int(near.sum())} "
        f"near-ties)")
    if int((diff & ~near).sum()):
        raise AssertionError("K47 differs from its float64 plain version")

    def library():
        return torch.argmax((torch.cumsum(steps, -1) > args[1]).to(torch.uint8), -1)

    bytes_moved = 4 * int(num.long().sum()) + mask.numel() + 5 * res.shape[0]
    row = _entry_row("sprt", lambda: KP.sprt(res, mask, *args),
                     lambda: KP.sprt_plain(res, mask, *args),
                     bytes_moved, 0, ops64=K47_ROW_OPS * int(num.long().sum()))
    row["library_ms"] = time_ms(library, reps=10)
    log(f"    sprt: torch.cumsum + argmax on the float64 steps {row['library_ms']:.4f} ms")
    plan = KP.plan()
    log(f"    K47 design: one block of {plan['threads']} threads a hypothesis ({res.shape[0]} "
        f"blocks), tiles of {plan['tile_rows']} rows, {plan['registers']} registers and "
        f"{plan['local_bytes']} spilled bytes a thread, {plan['shared_bytes']} B static shared "
        f"a block")
    split = log_parts("sprt", lambda: KP.sprt(res, mask, *args))
    row["extra"] = {"design": plan, "parts_ms": {name: ms for name, (ms, _) in split.items()}}
    rows["sprt"] = row


def phase_options_kernels():
    """K45 (and K15, K16 on affine frames), K46, the MSAC mode of K7, K11,
    K12, K32 and K33, and K47 against their plain versions (float64 on the
    same inputs), timed with CUDA events at the paths' shapes. Returns
    (errs, rows, agree, entries); entries hold the extended kernels' new
    modes."""
    names = (*OPTIONS_SOURCES, "sift_orientation", "sift_descriptor", "essential_ransac",
             "fundamental_ransac", "homography_ransac", "spherical_e_ransac",
             "spherical_h_ransac")
    errs = {k: [] for k in names}
    entries = {k: {} for k in names[3:]}
    rows, agree = {}, {}
    log("option kernels vs plain (float64 on the same inputs):")
    for label, step in (("K45, K15, K16 on affine frames", lambda: _options_sift(errs, rows,
                                                                                  entries)),
                        ("K46", lambda: _options_degensac(errs, rows, agree)),
                        ("MSAC", lambda: OPTIONS_STATE.update(msac=_options_msac(errs, entries))),
                        ("K47", lambda: _options_sprt(errs, rows, OPTIONS_STATE["msac"]["F"]))):
        t0 = time.perf_counter()
        step()
        log(f"  ({label}: {time.perf_counter() - t0:.1f} s)")
    OPTIONS_STATE.pop("msac", None)
    torch.cuda.synchronize()
    return errs, rows, agree, entries


def _driven(label, fn, kernels, launches):
    """Run fn with every launch count at 0 before, under torch.profiler;
    adds its launches, fails if a kernel of ``kernels`` did not launch;
    returns (result, seconds, idle share)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.zeros(1, device="cuda").add_(1.0)  # let the tracer see a first kernel
        torch.cuda.synchronize()
        reset_all_launches()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    counts = all_launch_counts()
    add_launches(launches, counts)
    busy_ms, by_name = device_busy(prof)
    idle = log_busy(label, busy_ms, by_name, dt * 1e3, top=6)
    log(f"  {label}: {dt:.3f} s, idle share {'not measured' if idle is None else f'{idle:.4f}'}; "
        f"launches { {k: v for k, v in counts.items() if v} }")
    missing = [k for k in kernels if counts[k] == 0]
    if missing:
        raise AssertionError(f"{label}: launched no {missing}")
    return out, dt, idle


def _stretch_rate(img, img_s, opts):
    """tests/test_features.py:169's measure: matches (ratio 0.9) between a
    view and the view stretched STRETCH times in x that land within 4 px of
    the known stretch, over the view's keypoints."""
    from colmap_tpu_torch.feature.matcher import MatchingOptions, match_descriptors
    from colmap_tpu_torch.feature.sift import extract_sift

    kp1, d1 = extract_sift(img, opts, device="cuda")
    kp2, d2 = extract_sift(img_s, opts, device="cuda")
    m = match_descriptors(d1, d2, MatchingOptions(max_ratio=0.9), device="cuda").astype(np.int64)
    p1, p2 = kp1[m[:, 0], :2], kp2[m[:, 1], :2]
    good = (np.abs(p1[:, 0] * STRETCH - p2[:, 0]) < 4.0) & (np.abs(p1[:, 1] - p2[:, 1]) < 4.0)
    return float(good.sum()) / max(len(kp1), 1), len(kp1), len(m)


def _options_affine(launches, results):
    """run_feature_extraction with estimate_affine_shape on the four views,
    the crop's count against the CPU path, and the stretch check."""
    from colmap_tpu_torch.controllers.feature_pipeline import run_feature_extraction
    from colmap_tpu_torch.feature.sift import SiftOptions, extract_sift
    from colmap_tpu_torch.scene.database import Database

    d, names = _options_views()
    opts = SiftOptions(estimate_affine_shape=True)
    with tempfile.TemporaryDirectory() as tmp:
        db = Database(os.path.join(tmp, "affine.db"))
        _, dt, idle = _driven(
            "run_feature_extraction, estimate_affine_shape, 4 views",
            lambda: run_feature_extraction(db, d, sift_options=opts, device="cuda"),
            (*SIFT_SOURCES, "sift_affine_shape"), launches)
        kps = [db.read_keypoints(iid) for iid, _, _ in db.read_images()]
        db.close()
    if not all(k.shape[1] == 6 and len(k) > 1000 for k in kps):
        raise AssertionError(f"affine extraction: keypoint shapes {[k.shape for k in kps]}")
    log(f"  {len(kps)} images in {dt:.3f} s = {len(kps) / dt:.3f} images/s on "
        f"{nvidia_smi_line()}; 6-column frames, keypoints per image {[len(k) for k in kps]}")
    results["affine_extraction"] = dict(seconds=dt, idle_share=idle,
                                        keypoints=[len(k) for k in kps])
    view = _view(0)
    w, h = AFFINE_CROP
    y0, x0 = (view.shape[0] - h) // 2, (view.shape[1] - w) // 2
    crop = np.ascontiguousarray(view[y0:y0 + h, x0:x0 + w])
    t0 = time.perf_counter()
    uncut = SiftOptions(estimate_affine_shape=True, max_num_features=1 << 20)
    kc, _ = extract_sift(crop, uncut, device="cuda")
    kp, _ = extract_sift(crop, uncut, device="cpu")
    log(f"  a {w} x {h} crop of view 0, no cut to max_num_features: {len(kc)} affine keypoints "
        f"on the card, {len(kp)} on the CPU path ({time.perf_counter() - t0:.1f} s)")
    if abs(len(kc) - len(kp)) > AFFINE_COUNT_TOL * len(kp):
        raise AssertionError("affine extraction: the crop's count differs from the CPU path's")
    W = view.shape[1]
    xs = np.arange(int(W * STRETCH)) / STRETCH
    xi = np.clip(np.floor(xs).astype(int), 0, W - 2)
    fx = (xs - xi).astype(np.float32)
    v = view.astype(np.float32) / 255.0
    stretched = v[:, xi] * (1 - fx) + v[:, xi + 1] * fx
    t0 = time.perf_counter()
    rate_a, n_a, m_a = _stretch_rate(v, stretched, opts)
    rate_p, n_p, m_p = _stretch_rate(v, stretched, SiftOptions())
    log(f"  stretch {STRETCH} in x at {W} x {view.shape[0]}: affine {rate_a:.4f} of {n_a} "
        f"keypoints matched to the stretch ({m_a} matches), plain {rate_p:.4f} of {n_p} "
        f"({m_p}); ratio {rate_a / max(rate_p, 1e-12):.3f} (gate > {STRETCH_GAIN}; "
        f"{time.perf_counter() - t0:.1f} s)")
    results["stretch"] = dict(affine=rate_a, plain=rate_p)
    if not rate_a > STRETCH_GAIN * rate_p:
        raise AssertionError("affine shapes do not match a stretched view better")


def _options_degensac_pairs(launches, results):
    """64 planted plane + parallax pairs through the block verifier with
    use_degensac, each against estimate_two_view_geometry on it alone."""
    from colmap_tpu_torch.estimators.two_view_batch import estimate_two_view_geometries_batched
    from colmap_tpu_torch.estimators.two_view_geometry import (TwoViewGeometryOptions,
                                                               estimate_two_view_geometry)
    from colmap_tpu_torch.geometry.essential import squared_epipolar_line_distance
    from colmap_tpu_torch.kernels import matching_cases as C
    from colmap_tpu_torch.scene.types import Camera

    cam = Camera.create(1, 1, C.FOCAL, C.WIDTH, C.HEIGHT)  # PINHOLE, no prior focal length
    items, kinds = [], []
    for p in range(DEG_PAIRS):
        x1, x2, kind = _degensac_case(OPT_ROWS, 100 + 2 * p)
        items.append((cam, x1, cam, x2, np.stack([np.arange(OPT_ROWS)] * 2, 1).astype(np.uint32)))
        kinds.append(kind)
    opts = TwoViewGeometryOptions(use_degensac=True)
    geoms, dt, idle = _driven(f"block verifier, use_degensac, {DEG_PAIRS} pairs x {OPT_ROWS}",
                              lambda: estimate_two_view_geometries_batched(items, opts,
                                                                           device="cuda"),
                              ("degensac", "fundamental_ransac", "homography_ransac"), launches)
    routed = all_launch_counts()["degensac"]
    worst, configs = 1.0, {}
    for (cam1, x1, cam2, x2, m), kind, g in zip(items, kinds, geoms):
        if g.F is None:
            raise AssertionError(f"DEGENSAC pair: config {g.config} without F")
        d = squared_epipolar_line_distance(torch.from_numpy(g.F), torch.from_numpy(x1[kind == 1]),
                                           torch.from_numpy(x2[kind == 1]))
        worst = min(worst, float((d <= 16.0).double().mean()))
        configs[g.config] = configs.get(g.config, 0) + 1
    t0 = time.perf_counter()
    for item, g in zip(items, geoms):
        one = estimate_two_view_geometry(*item, opts, device="cuda")
        if not (one.config == g.config and np.array_equal(one.inlier_matches, g.inlier_matches)
                and np.array_equal(one.F, g.F)):
            raise AssertionError("DEGENSAC pair: the block's result differs from the pair alone")
    log(f"  {DEG_PAIRS} pairs ({DEG_PLANE:.0%} on a plane, {DEG_OFF:.0%} off it): {routed} "
        f"H-degenerate pairs through DEGENSAC (one K46 launch each); configurations {configs}; "
        f"the final F keeps at least {worst:.4f} of the planted off-plane matches (gate "
        f"{DEG_KEEP_OFF}); each pair equals estimate_two_view_geometry alone "
        f"({time.perf_counter() - t0:.1f} s)")
    results["degensac"] = dict(seconds=dt, idle_share=idle, pairs_per_s=DEG_PAIRS / dt,
                               degensac_pairs=routed, min_off_plane_kept=worst)
    if routed != DEG_PAIRS or worst < DEG_KEEP_OFF:
        raise AssertionError("DEGENSAC: a pair skipped DEGENSAC or lost its off-plane matches")


def _options_matcher(launches, results):
    """The matcher phase's scene with MSAC support, progressive sampling on
    one pair, and the SPRT on that pair's hypotheses."""
    from colmap_tpu_torch.controllers.feature_pipeline import (MatchingPipelineOptions,
                                                               run_exhaustive_matching)
    from colmap_tpu_torch.estimators.two_view_geometry import (TwoViewGeometryOptions,
                                                               estimate_two_view_geometry)
    from colmap_tpu_torch.geometry.essential import squared_epipolar_line_distance
    from colmap_tpu_torch.kernels import matching as KM
    from colmap_tpu_torch.optim.sprt import sprt_evaluate
    from colmap_tpu_torch.scene.database import Database
    from colmap_tpu_torch.scene.types import TwoViewGeometryConfig

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        db_path, _ = make_scene(tmp, WIDE_FRAMES, WIDE_POINTS)
        truth = strip_to_features(db_path)
        log(f"  MSAC matcher: {WIDE_FRAMES} frames x {WIDE_POINTS} points, {len(truth)} pairs "
            f"(set-up {time.perf_counter() - t0:.1f} s)")
        base = TwoViewGeometryOptions()
        msac = dataclasses.replace(base.ransac, support="m_estimator")
        mopts = MatchingPipelineOptions(verification=dataclasses.replace(base, ransac=msac))
        db = Database(db_path, must_exist=True)
        verified, dt, idle = _driven("exhaustive matching, support m_estimator",
                                     lambda: run_exhaustive_matching(db, mopts, device="cuda"),
                                     MATCHER_KERNELS, launches)
        worst = 1.0
        for (a, b), gen in truth.items():
            g = db.read_two_view_geometry(a, b)
            gen = {tuple(r) for r in gen.tolist()}
            inl = set() if g is None else {tuple(r) for r in g.inlier_matches.tolist()}
            if not (g is not None and g.config == int(TwoViewGeometryConfig.CALIBRATED)
                    and inl <= gen and len(inl) >= 0.99 * len(gen)):
                raise AssertionError(f"MSAC pair ({a}, {b}): config {g and g.config}, "
                                     f"{len(inl)} inliers of {len(gen)}")
            worst = min(worst, len(inl) / len(gen))
        log(f"  all {verified} pairs CALIBRATED with at least {worst:.4f} of the generator's "
            f"matches as inliers and no other, in {dt:.3f} s = {verified / dt:.3f} pairs/s")
        results["msac_matcher"] = dict(seconds=dt, idle_share=idle, pairs=verified,
                                       min_inlier_share=worst)
        # Progressive sampling on pair (1, 2), best first by descriptor distance.
        cams = db.read_cameras()
        imgs = {iid: cid for iid, _, cid in db.read_images()}
        m = db.read_matches(1, 2).astype(np.int64)
        kp1, kp2 = db.read_keypoints(1), db.read_keypoints(2)
        d1, d2 = db.read_descriptors(1), db.read_descriptors(2)
        dist = np.linalg.norm(d1[m[:, 0]].astype(np.float64) - d2[m[:, 1]].astype(np.float64),
                              axis=1)
        order = np.argsort(dist, kind="stable")
        pair = (cams[imgs[1]], kp1, cams[imgs[2]], kp2, m.astype(np.uint32))
        uniform = estimate_two_view_geometry(*pair, base, device="cuda")
        prog_opts = dataclasses.replace(base, ransac=dataclasses.replace(
            base.ransac, sampling="progressive"))
        prog, dt_p, _ = _driven("progressive sampling, pair (1, 2)",
                                lambda: estimate_two_view_geometry(*pair, prog_opts,
                                                                   device="cuda",
                                                                   quality_order=order),
                                ("fundamental_ransac", "homography_ransac", "essential_ransac"),
                                launches)
        log(f"  progressive: config {prog.config} with {len(prog.inlier_matches)} inliers, "
            f"uniform {uniform.config} with {len(uniform.inlier_matches)}, of {len(m)} matches")
        if prog.config != uniform.config or prog.config != int(TwoViewGeometryConfig.CALIBRATED):
            raise AssertionError("progressive sampling changed the configuration")
        db.close()
        # The SPRT on 256 F hypotheses of that pair (random 7-point samples).
        x1 = torch.from_numpy(kp1[m[:, 0], :2]).cuda()
        x2 = torch.from_numpy(kp2[m[:, 1], :2]).cuda()
        mask = torch.ones(len(m), dtype=torch.bool, device="cuda")
        samples = torch.from_numpy(np.random.default_rng(6).integers(
            0, len(m), (DEG_HYPOTHESES, 7)).astype(np.int32)).cuda()
        models, counts, _ = KM.fundamental_propose_score(x1, x2, mask, samples, 16.0)
        fin = torch.isfinite(models.flatten(1)).all(1)
        models, share = models[fin][:DEG_HYPOTHESES], (counts[fin][:DEG_HYPOTHESES] / len(m))
        res = squared_epipolar_line_distance(models[:, None], x1[None], x2[None]).contiguous()
        (acc, num), dt_s, _ = _driven("sprt_evaluate", lambda: sprt_evaluate(res, mask, 16.0),
                                      ("sprt",), launches)
        good, bad = share >= 0.5, share <= 0.02
        log(f"  SPRT on {len(models)} F hypotheses x {len(m)} rows: {int(acc.sum())} accepted; "
            f"all {int(good.sum())} with >= 50% support accepted: {bool(acc[good].all())}; all "
            f"{int(bad.sum())} with <= 2% rejected: {bool((~acc[bad]).all())}, after "
            f"{float(num[bad].double().mean()) if bad.any() else 0:.1f} rows on average")
        if not (bool(acc[good].all()) and bool((~acc[bad]).all()) and good.any() and bad.any()):
            raise AssertionError("SPRT: a good hypothesis rejected or a bad one accepted")
        results["progressive"] = dict(seconds=dt_p, config=prog.config)
        results["sprt"] = dict(seconds=dt_s, accepted=int(acc.sum()))


def phase_options(launches):
    """The options through the port's entry points on cuda: affine SIFT
    through run_feature_extraction, DEGENSAC through the block verifier,
    MSAC through the matcher, progressive sampling through
    estimate_two_view_geometry, the SPRT through sprt_evaluate; each driven
    with the launch counts at 0 before, under torch.profiler."""
    results = {}
    for label, step in (("affine SIFT", lambda: _options_affine(launches, results)),
                        ("DEGENSAC", lambda: _options_degensac_pairs(launches, results)),
                        ("MSAC, progressive, SPRT", lambda: _options_matcher(launches,
                                                                             results))):
        t0 = time.perf_counter()
        step()
        log(f"  ({label}: {time.perf_counter() - t0:.1f} s)")
    return results


# ---------------------------------------------------------------------------
# The sparse-model tools and the rest of the CLI: K48, K49, the new commands.
# ---------------------------------------------------------------------------

TOOLS_SOURCES = {
    "gen_rel_ransac": ("colmap_tpu_torch/csrc/gen_rel_ransac.cu",
                       "colmap_tpu/estimators/generalized_pose.py:397"),
    "line_gradients": ("colmap_tpu_torch/csrc/line_gradients.cu", "colmap_tpu/image/lines.py:61"),
}
# K48 at the generalized relative pose's shape: one rig pair of 8192
# correspondences over the 4-camera layout of the 4 x 5 rig scene (the
# synthetic generator's rig, seed 3), 25% planted outliers, a batch of 32
# injected samples (half from the inliers), 4 px. A near-best model (90% of
# the best support, not degenerate) within K48_TOL plus the float64
# eigensolve's bound rig_cases.SOLVE_EPS / gap.
REL_ROWS, REL_SAMPLES, REL_OUTLIERS, REL_MAX_SQ, K48_TOL = 8192, 32, 0.25, 16.0, 1e-6
# f32 operations of K48's scoring a row and model (three quaternion
# rotations and an inverse one, two 3 x 3 products, two crosses, the
# Sampson ratio: ~200); f64 operations of a sample's solve: the 171 Gram
# sums over 17 rows, and K48_SWEEPS Jacobi sweeps of 17 rounds x 9 rotations
# x 54 updates of 6 operations (a CPU run of the kernel's ordering on this
# case's samples stopped after 7-8 sweeps); the refit's Gram sums a row.
K48_ROW_OPS, K48_SWEEPS = 200, 8
K48_SOLVE_OPS = 17 * 171 * 2 + K48_SWEEPS * 17 * 9 * 54 * 6
K48_REFIT_ROW_OPS = 18 * 4 + 171 * 3
# The compat phase's gates: tests/test_generalized_pose.py:129-133.
REL_ROT_DEG, REL_T, REL_KEEP = 0.5, 0.05, 0.9
# K49 on a 3072 x 2304 view (BASELINE.json config 1's frames) against its
# float64 plain version: magnitudes within K49_RTOL relative, angles within
# K49_ANGLE_TOL rad modulo pi where the gradient is not 0.
K49_RTOL, K49_ANGLE_TOL = 1e-5, 1e-5
# The Manhattan facade: 8 views at 3072 x 2304, f = 2400 (the 640 x 480, f
# = 500 scene of tests/test_coordinate_frame.py at full size), rolled and
# yawed by a few degrees; the frame's axes within the reference test's 0.99
# dot of the world's X and Y.
ORIENT_VIEWS, ORIENT_W, ORIENT_H, ORIENT_FOCAL, ORIENT_DOT = 8, 3072, 2304, 2400.0, 0.99
ORIENT_ROLLS = (0.0, 4.0, -4.0, 2.0, -2.0, 6.0, -6.0, 3.0)
ORIENT_YAWS = (0.0, 3.0, -3.0, -2.0, 2.0, 1.0, -1.0, 4.0)
# Phase compat maps the 12 rendered frames of phase extractor rendered with
# the focal length the reader guesses (1.2 x 1024 px; pycolmap's
# extract_features and automatic_reconstructor take no intrinsics).
COMPAT_FOCAL = 1.2 * 1024
HIER_MAX_CENTER = 1e-3
MAPPER_KERNELS = ("ba_obs_jacobians", "ba_lm_reduce", "ba_schur_matvec", "camera_map",
                  "essential_ransac", "p3p_ransac", "ba_pcg", "ba_lm_update", "relative_pose")


def _k48_sensors():
    """(q, t) sensor_from_rig of the 4 x 5 rig scene's four cameras."""
    from colmap_tpu_torch.scene.synthetic import SyntheticDatasetOptions, synthesize_dataset
    from colmap_tpu_torch.scene.types import Pose, SensorType

    gt = synthesize_dataset(SyntheticDatasetOptions(
        num_rigs=1, num_cameras_per_rig=4, num_frames_per_rig=5, num_points3D=1000,
        camera_params=(FULL_FOCAL, 512.0, 384.0, 0.05), camera_has_prior_focal_length=True),
        None, rng=np.random.default_rng(3))
    rig = gt.rigs[min(gt.rigs)]
    poses = [rig.sensor_from_rig((int(SensorType.CAMERA), c)) or Pose.identity()
             for c in sorted(gt.cameras)]
    return np.stack([p.quat for p in poses]), np.stack([p.t for p in poses])


def _k48_case(seed):
    from colmap_tpu_torch.kernels import rig_cases as RC

    return RC.gen_rel_case(REL_ROWS, outlier_ratio=REL_OUTLIERS, seed=seed,
                           sensors=_k48_sensors(), focal=FULL_FOCAL)


def _k48(errs, rows, agree):
    """K48 (a)-(c) against their float64 plain versions on one 8192-row
    rig pair: the same injected samples fed to both; timed."""
    from colmap_tpu_torch.kernels import rig as KR
    from colmap_tpu_torch.kernels import rig_cases as RC
    from colmap_tpu_torch.optim.ransac import unpack_best

    case = _k48_case(7)
    data = RC.gen_rel_tensors(case, "cuda", torch.float32)
    data64 = KR.GenRelData(data.rays, *f64(*data[1:]))
    samples = RC.gen_rel_samples(REL_ROWS, REL_SAMPLES, 5, case["inliers"], device="cuda")
    m, c, b = KR.gen_rel_propose_score(data, samples, REL_MAX_SQ)
    (m64, c64, b64), plain_s = _timed(
        lambda: KR.gen_rel_propose_score_plain(data64, samples, REL_MAX_SQ))
    a = RC.gen_rel_agreement(c, unpack_best(int(b[0])), m, m64, c64, unpack_best(int(b64[0])),
                             data64, samples, REL_MAX_SQ, tol=K48_TOL)
    log(f"K48 vs float64 plain: {REL_ROWS} rows x 4 cameras, {REL_SAMPLES} injected samples "
        f"({a['degenerate']} degenerate, not compared): counts within their near rows "
        f"{a['count_ok']}, best sample {unpack_best(int(b[0]))} against {unpack_best(int(b64[0]))}"
        f" (tie {a['tie']}), {a['near_best']} near-best models within {K48_TOL:g} + eps / gap: "
        f"{a['model_ok']} (largest error {a['max_model_err']:.3e}, the best's gap "
        f"{a['best_gap']:.3e})")
    if not (a["count_ok"] and a["best_ok"] and a["model_ok"]):
        raise AssertionError(f"K48 propose-and-score disagrees with its plain version: {a}")
    errs["gen_rel_ransac"].append((a["max_model_err"], a["max_model_err"]))
    agree["gen_rel_ransac"] = (a["near_best"], a["near_best"])
    best = unpack_best(int(b64[0]))[1]
    inl = KR.gen_rel_inliers(data, m64[best].float(), REL_MAX_SQ)
    res = KR.gen_rel_residuals(m64[best][None], data64)[0]
    far = (res - REL_MAX_SQ).abs() > 1e-3 * REL_MAX_SQ
    if not torch.equal(inl[far], (res <= REL_MAX_SQ)[far]):
        raise AssertionError("K48 inliers: the mask differs from float64 off the near rows")
    w = (res <= REL_MAX_SQ).double()
    model, ok = KR.gen_rel_refit(data.rays, w)
    model64, ok64 = KR.gen_rel_refit_plain(data.rays, w)
    if not (bool(ok[0]) and bool(ok64[0])):
        raise AssertionError("K48 refit: a solve failed")
    check("K48 refit (float64 both)", model, model64, 1e-9, errs["gen_rel_ransac"])
    rel = case["rel"]
    truth = torch.as_tensor(np.concatenate([rel.rotmat(), rel.t[:, None]], 1))
    log(f"  K48 refit over the {int(w.sum())} inliers against the truth: "
        f"{float((model.cpu() - truth).abs().max()):.3e}")
    n, k = REL_ROWS, REL_SAMPLES
    t_ops = (k * n * K48_ROW_OPS / PEAK_F32_OPS_PER_S
             + k * K48_SOLVE_OPS / PEAK_F64_OPS_PER_S) * 1e3
    t_bytes = (nbytes(*data, samples) + nbytes(m, c) + 8) / PEAK_BYTES_PER_S * 1e3
    b_ms, by = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
    ms = time_ms(lambda: KR.gen_rel_propose_score(data, samples, REL_MAX_SQ), reps=20)
    plain_ms = time_ms(lambda: KR.gen_rel_propose_score_plain(data, samples, REL_MAX_SQ),
                       reps=3)
    log(f"    gen_rel_ransac (a), {n} rows x {k} samples: {ms:.4f} ms (plain, float32 scoring, "
        f"{plain_ms:.3f} ms; float64 {plain_s * 1e3:.3f} ms; bound {b_ms:.5f} ms by {by})")
    rows["gen_rel_ransac"] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=by,
                                  library_ms=None, entries={
                                      "inliers": _entry_times(
                                          lambda: KR.gen_rel_inliers(data, m[0], REL_MAX_SQ),
                                          lambda: KR.gen_rel_inliers_plain(data, m[0],
                                                                           REL_MAX_SQ)),
                                      "refit": _entry_times(
                                          lambda: KR.gen_rel_refit(data.rays, w),
                                          lambda: KR.gen_rel_refit_plain(data.rays, w))},
                                  extra=dict(degenerate_samples=a["degenerate"]))
    log(f"    gen_rel_ransac (b), (c): {rows['gen_rel_ransac']['entries']} (refit bound "
        f"{bound64(nbytes(data.rays, w), K48_REFIT_ROW_OPS * n)[0]:.5f} ms)")


def _facade(root):
    """The Manhattan facade of tests/test_coordinate_frame.py's
    _manhattan_scene at 3072 x 2304: axis-aligned segments at z 5 and 6.5,
    seen by ORIENT_VIEWS cameras at the origin rolled and yawed by a few
    degrees; the views written as PNG, the model (PINHOLE) as BIN. Returns
    (model path, image path)."""
    from colmap_tpu_torch.scene.reconstruction import Reconstruction
    from colmap_tpu_torch.scene.reconstruction_io import write_model
    from colmap_tpu_torch.scene.types import Camera, Frame, Image, Pose, Rig, SensorType
    from colmap_tpu_torch.utils.image_io import write_png

    W, H, f = ORIENT_W, ORIENT_H, ORIENT_FOCAL
    recon = Reconstruction()
    recon.add_camera(Camera.create(1, 1, f, W, H))
    segs = [(np.array([-2.0, y, z]), np.array([2.0, y, z])) for y in (-1.0, 0.0, 1.0)
            for z in (5.0, 6.5)]
    segs += [(np.array([x, -1.5, z]), np.array([x, 1.5, z])) for x in (-1.5, 0.0, 1.5)
             for z in (5.0, 6.5)]
    images = os.path.join(root, "images")
    os.makedirs(images)
    cam = int(SensorType.CAMERA)
    for k in range(ORIENT_VIEWS):
        rz, ry = np.radians(ORIENT_ROLLS[k]), np.radians(ORIENT_YAWS[k])
        qz = np.array([np.cos(rz / 2), 0.0, 0.0, np.sin(rz / 2)])
        qy = np.array([np.cos(ry / 2), 0.0, np.sin(ry / 2), 0.0])
        pose = Pose(qz, np.zeros(3)).compose(Pose(qy, np.zeros(3)))
        recon.add_rig(Rig(rig_id=k + 1, ref_sensor_id=(cam, 1)))
        recon.add_frame(Frame(frame_id=k + 1, rig_id=k + 1, rig_from_world=pose,
                              data_ids=[(cam, 1, k + 1)]))
        img = Image(image_id=k + 1, name=f"im{k}.png", camera_id=1, frame_id=k + 1)
        img.set_points2D(np.zeros((1, 2)))
        recon.add_image(img)
        recon.register_frame(k + 1)
        canvas = np.zeros((H, W), dtype=np.uint8)
        R = pose.rotmat()
        for a, b in segs:
            pa, pb = R @ a, R @ b
            ua = np.array([f * pa[0] / pa[2] + W / 2, f * pa[1] / pa[2] + H / 2])
            ub = np.array([f * pb[0] / pb[2] + W / 2, f * pb[1] / pb[2] + H / 2])
            ts = np.linspace(0.0, 1.0, int(np.ceil(np.linalg.norm(ub - ua) * 2)) + 1)
            xy = np.rint(np.outer(1 - ts, ua) + np.outer(ts, ub)).astype(np.int64)
            ok = (xy[:, 0] >= 0) & (xy[:, 0] < W) & (xy[:, 1] >= 0) & (xy[:, 1] < H)
            xi, yi = xy[ok, 0], xy[ok, 1]
            canvas[yi, xi] = 255
            canvas[np.minimum(yi + 1, H - 1), xi] = 255
        write_png(os.path.join(images, img.name), canvas, level=1)
    model = os.path.join(root, "model")
    write_model(recon, model, fmt="bin")
    return model, images, recon


def _k49(errs, rows):
    """K49 against its float64 plain version on a 3072 x 2304 facade view;
    timed beside its plain version and one library convolution."""
    from colmap_tpu_torch.kernels import lines as KL
    from colmap_tpu_torch.utils.image_io import read_image_gray

    with tempfile.TemporaryDirectory() as tmp:
        _, images, _ = _facade(tmp)
        view = read_image_gray(os.path.join(images, "im1.png"))
    # Gray levels with texture: the facade's strokes plus a seeded noise.
    view = np.clip(view.astype(np.int64) + np.random.default_rng(3).integers(
        0, 40, view.shape), 0, 255).astype(np.float32)
    img = torch.from_numpy(view).cuda()
    mag, ang = KL.line_gradients(img)
    mag64, ang64 = KL.line_gradients_plain(img.double())
    strong = mag64 > 0
    check("K49 magnitude", mag, mag64, K49_RTOL, errs["line_gradients"])
    rel = float(((mag.double() - mag64).abs() / mag64.clamp(min=1e-30))[strong].max())
    d = torch.remainder(ang.double() - ang64 + torch.pi / 2, torch.pi) - torch.pi / 2
    worst = float(d[strong].abs().max())
    log(f"  K49 at {ORIENT_W} x {ORIENT_H}: magnitudes within {rel:.3e} relative, angles within "
        f"{worst:.3e} rad modulo pi (tolerances {K49_RTOL:g}, {K49_ANGLE_TOL:g})")
    if not (rel <= K49_RTOL and worst <= K49_ANGLE_TOL):
        raise AssertionError("K49 disagrees with its float64 plain version")
    errs["line_gradients"].append((worst, worst))
    ms = time_ms(lambda: KL.line_gradients(img), reps=25)
    plain_ms = time_ms(lambda: KL.line_gradients_plain(img), reps=10)
    library_ms = time_ms(lambda: KL.line_gradients_library(img), reps=25)
    b_ms, by = bound(12 * img.numel(), 0)
    log(f"    line_gradients, {ORIENT_W} x {ORIENT_H}: {ms:.4f} ms (plain {plain_ms:.3f} ms, "
        f"F.conv2d + hypot + atan2 + wraps {library_ms:.4f} ms, TF32 off; bound {b_ms:.5f} ms "
        f"by {by})")
    rows["line_gradients"] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=by,
                                  library_ms=library_ms)


def phase_tools_kernels():
    """K48 and K49 against their float64 plain versions at the paths'
    shapes, timed with CUDA events (K49 beside F.conv2d on the replicate-
    padded view with hypot, atan2 and the wraps, TF32 off). Returns (errs,
    rows, agree)."""
    errs = {k: [] for k in TOOLS_SOURCES}
    rows, agree = {}, {}
    torch.backends.cudnn.allow_tf32 = False
    for label, step in (("K48", lambda: _k48(errs, rows, agree)), ("K49", lambda: _k49(errs, rows))):
        t0 = time.perf_counter()
        step()
        log(f"  ({label}: {time.perf_counter() - t0:.1f} s)")
    return errs, rows, agree


def _verify_model(root):
    """Phase mapper's verify-scene model (8 frames x 120 points), or, when
    that phase did not run, the same scene through `mapper` here. Returns
    the model's path."""
    from colmap_tpu_torch.scene.reconstruction_io import write_model

    out = os.path.join(root, "verify_model")
    if "verify" in MAPPER_STATE:
        write_model(MAPPER_STATE["verify"], out, fmt="bin")
        return out
    scene = os.path.join(root, "verify_scene")
    os.makedirs(scene)
    db_path, _ = make_scene(scene, 8, 120, 1280.0)
    run_mapper(db_path, os.path.join(scene, "sparse"), "mapper, verify scene", min_launches=False)
    shutil.copytree(os.path.join(scene, "sparse", "0"), out)
    return out


def _frame_dots(src, out):
    """The aligned world's X and Y axes (the estimated frame's rightward and
    downward axes) against the source world's X and Y: (dot x, dot y)."""
    from colmap_tpu_torch.scene.reconstruction_io import read_model

    a, b = read_model(src), read_model(out)
    iid = sorted(a.reg_image_ids())[0]
    frame = a.cam_from_world(iid).rotmat().T @ b.cam_from_world(iid).rotmat()
    return abs(float(frame[0, 0])), abs(float(frame[1, 1]))


def phase_orientation(launches):
    """`model_orientation_aligner --method MANHATTAN-WORLD` on the rendered
    facade (8 views at 3072 x 2304) on cuda under torch.profiler, the frame
    held to the reference test's 0.99 dots; then IMAGE-ORIENTATION and
    PRINCIPAL-PLANE on phase mapper's model."""
    results = {}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        model, images, _ = _facade(tmp)
        log(f"orientation: the facade, {ORIENT_VIEWS} views at {ORIENT_W} x {ORIENT_H} "
            f"(set-up {time.perf_counter() - t0:.1f} s)")
        out = os.path.join(tmp, "aligned")
        _, dt, idle = _profiled_command(
            ["model_orientation_aligner", "--input_path", model, "--output_path", out,
             "--image_path", images, "--method", "MANHATTAN-WORLD"],
            "model_orientation_aligner MANHATTAN-WORLD", ("line_gradients",), launches)
        dx, dy = _frame_dots(model, out)
        log(f"  the frame's rightward axis at {np.degrees(np.arccos(min(dx, 1.0))):.4f} deg of X, "
            f"downward at {np.degrees(np.arccos(min(dy, 1.0))):.4f} deg of Y (dots {dx:.6f}, "
            f"{dy:.6f}; gate {ORIENT_DOT}); {ORIENT_VIEWS} views in {dt:.3f} s = "
            f"{ORIENT_VIEWS / dt:.3f} views/s on {nvidia_smi_line()}")
        if not (dx > ORIENT_DOT and dy > ORIENT_DOT):
            raise AssertionError("MANHATTAN-WORLD: the frame misses the facade's axes")
        results["manhattan"] = dict(seconds=dt, idle_share=idle, dot_x=dx, dot_y=dy)
        src = _verify_model(tmp)
        for method in ("IMAGE-ORIENTATION", "PRINCIPAL-PLANE"):
            _, dt, _ = run_command(["model_orientation_aligner", "--input_path", src,
                                    "--output_path", os.path.join(tmp, method), "--method",
                                    method], f"model_orientation_aligner {method}", ())
            log(f"  {method}: host only (no device work), {dt:.3f} s")
            results[method] = dict(seconds=dt)
    return results


def _render_compat(root):
    from colmap_tpu_torch.kernels import sift_cases as SC

    t0 = time.perf_counter()
    gt, names, _ = SC.render_scene(os.path.join(root, "images"), IMG_FRAMES, IMG_POINTS, 1024, 768,
                                   COMPAT_FOCAL, patch_world=IMG_PATCH_WORLD)
    log(f"  {IMG_FRAMES} rendered frames x {IMG_POINTS} points, PINHOLE 1024 x 768, f = "
        f"{COMPAT_FOCAL:g} (set-up {time.perf_counter() - t0:.1f} s)")
    return gt, names


def _against_gt(recon, gt, frames, label):
    from colmap_tpu_torch.estimators.alignment import compare_reconstructions

    cmp = compare_reconstructions(recon, gt)
    n, rot, ctr = cmp["num_common_images"], cmp["max_rotation_error_deg"], cmp["max_center_error"]
    log(f"  {label}: {recon.num_reg_frames()}/{frames} frames, {recon.num_points3D()} points; "
        f"max rotation error {rot:.4f} deg, max center error {ctr:.5f} (bounds "
        f"{IMG_MAX_ROT_DEG} deg, {IMG_MAX_CENTER})")
    if not (n == frames and rot < IMG_MAX_ROT_DEG and ctr < IMG_MAX_CENTER):
        raise AssertionError(f"{label}: {n}/{frames} frames, {rot} deg, {ctr}")
    return cmp


def phase_compat(launches):
    """pycolmap_compat on cuda: estimate_generalized_relative_pose on an
    8192-row pair of the 4-camera layout with 25% planted outliers (the
    gates of tests/test_generalized_pose.py), then a pycolmap-style script
    (extract_features -> match_exhaustive -> incremental_mapping) on the 12
    rendered frames; each driven with the launch counts at 0 before, under
    torch.profiler."""
    import colmap_tpu_torch.pycolmap_compat as pycolmap

    results = {}
    case = _k48_case(9)
    (pose, inl), dt, idle = _driven(
        "pycolmap.estimate_generalized_relative_pose, 8192 rows",
        lambda: pycolmap.estimate_generalized_relative_pose(
            case["points2D1"], case["points2D2"], case["camera_idxs1"], case["camera_idxs2"],
            case["cams_from_rig"], case["cameras"], device="cuda"),
        ("gen_rel_ransac",), launches)
    rel, planted = case["rel"], case["inliers"]
    rot = float(np.degrees(pose.angle_to(rel)))
    terr = float(np.abs(pose.t - rel.t).max())
    kept = float((inl & planted).sum() / planted.sum())
    log(f"  rig2_from_rig1: rotation error {rot:.3e} deg, metric t error {terr:.3e}, "
        f"{kept:.4f} of the planted inliers kept, {int((inl & ~planted).sum())} planted outliers "
        f"in (gates {REL_ROT_DEG} deg, {REL_T}, {REL_KEEP}); {dt:.3f} s")
    if not (rot < REL_ROT_DEG and terr < REL_T and kept >= REL_KEEP):
        raise AssertionError("estimate_generalized_relative_pose outside its gates")
    results["generalized_relative_pose"] = dict(seconds=dt, idle_share=idle, rot_deg=rot,
                                                t_err=terr, kept=kept)
    with tempfile.TemporaryDirectory() as tmp:
        log("pycolmap-style script on the rendered frames:")
        gt, _ = _render_compat(tmp)
        db = os.path.join(tmp, "db.db")
        seconds = {}
        _, seconds["extract_features"], _ = _driven(
            "pycolmap.extract_features", lambda: pycolmap.extract_features(
                db, os.path.join(tmp, "images"), camera_model="PINHOLE", device="cuda"),
            tuple(SIFT_SOURCES), launches)
        _, seconds["match_exhaustive"], _ = _driven(
            "pycolmap.match_exhaustive", lambda: pycolmap.match_exhaustive(db, device="cuda"),
            MATCHER_KERNELS, launches)
        models, seconds["incremental_mapping"], idle = _driven(
            "pycolmap.incremental_mapping",
            lambda: pycolmap.incremental_mapping(db, output_path=os.path.join(tmp, "sparse"),
                                                 device="cuda"), MAPPER_KERNELS, launches)
        _against_gt(models[0], gt, IMG_FRAMES, "pycolmap script")
        results["script"] = dict(seconds=seconds, idle_share_mapping=idle)
        _tools_on_rendered(tmp, gt, launches, results)
    return results


def _tools_on_rendered(tmp, gt, launches, results):
    """automatic_reconstructor (sparse, quality high) on the rendered
    frames, then color_extractor on its model."""
    images = os.path.join(tmp, "images")
    ws = os.path.join(tmp, "ws")
    models, dt, idle = _profiled_command(
        ["automatic_reconstructor", "--workspace_path", ws, "--image_path", images,
         "--camera_model", "PINHOLE"], f"automatic_reconstructor, {IMG_FRAMES} rendered frames",
        (*SIFT_SOURCES, *MATCHER_KERNELS, *MAPPER_KERNELS), launches, profiled=False)
    _against_gt(models[0], gt, IMG_FRAMES, "automatic_reconstructor")
    results["automatic_reconstructor"] = dict(seconds=dt)
    dt = _host(["color_extractor", "--input_path", os.path.join(ws, "sparse", "0"),
                "--image_path", images, "--output_path", os.path.join(tmp, "colored")],
               "color_extractor")
    results["color_extractor"] = dict(seconds=dt)


def phase_tools(launches):
    """Every other new command once through the CLI on cuda where it takes
    --device: point_triangulator, image_registrator, point_filtering,
    guided_geometric_verifier, hierarchical_mapper and pose_prior_mapper on
    the verify scene (phase mapper's: 8 frames x 120 points, seed 3; the
    prior scene with position priors), each under torch.profiler and held
    to the mapper's gates; then the file tools on their outputs."""
    from colmap_tpu_torch.scene.reconstruction_io import read_model, write_model
    from colmap_tpu_torch.scene.types import INVALID_POINT3D

    results, walls = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        db_path, gt = make_scene(tmp, 8, 120, 1280.0)
        gt_dir = os.path.join(tmp, "gt")
        write_model(gt, gt_dir, fmt="bin")
        poses = copy.deepcopy(gt)
        for pid in list(poses.points3D):
            poses.delete_point3D(pid)
        for image in poses.images.values():
            image.points2D_p3d[:] = INVALID_POINT3D
        src = os.path.join(tmp, "poses")
        write_model(poses, src, fmt="bin")
        tri = os.path.join(tmp, "triangulated")
        n, walls["point_triangulator"], results["point_triangulator_idle"] = _profiled_command(
            ["point_triangulator", "--database_path", db_path, "--input_path", src,
             "--output_path", tri], "point_triangulator", ("triangulate_tracks",), launches)
        os.makedirs(os.path.join(tmp, "tri_model"))
        shutil.copytree(tri, os.path.join(tmp, "tri_model", "0"))
        check_against_gt(os.path.join(tmp, "tri_model"), gt, 8, "point_triangulator")
        if read_model(tri).num_points3D() < 0.9 * gt.num_points3D():
            raise AssertionError("point_triangulator: too few points")
        partial = copy.deepcopy(gt)
        for iid in sorted(gt.reg_image_ids())[-2:]:
            partial.deregister_frame(partial.images[iid].frame_id)
        write_model(partial, os.path.join(tmp, "partial"), fmt="bin")
        reg = os.path.join(tmp, "registered")
        added, walls["image_registrator"], results["image_registrator_idle"] = _profiled_command(
            ["image_registrator", "--database_path", db_path, "--input_path",
             os.path.join(tmp, "partial"), "--output_path", os.path.join(reg, "0")],
            "image_registrator", ("p3p_ransac",), launches)
        check_against_gt(reg, gt, 8, "image_registrator")
        if added != 2:
            raise AssertionError(f"image_registrator registered {added} of 2 images")
        _, walls["point_filtering"], _ = _profiled_command(
            ["point_filtering", "--input_path", tri, "--output_path", os.path.join(tmp, "filt")],
            "point_filtering", ("filter_points",), launches, profiled=False)
        _, walls["guided_geometric_verifier"], _ = _profiled_command(
            ["guided_geometric_verifier", "--database_path", db_path],
            "guided_geometric_verifier", ("camera_map", "essential_ransac"), launches,
            profiled=False)
        hier = os.path.join(tmp, "hier")
        models, walls["hierarchical_mapper"], results["hierarchical_idle"] = _profiled_command(
            ["hierarchical_mapper", "--database_path", db_path, "--output_path", hier,
             "--leaf_max_num_images", "5", "--image_overlap", "2", "--quiet"],
            "hierarchical_mapper (leaves of at most 5 images)", MAPPER_KERNELS, launches)
        leaves = _leaves(db_path, 5, 2)
        # Leaves mapped apart and merged by a Sim3 on their shared images:
        # colmap_tpu's test asks for the frames only; the centres are held
        # at HIER_MAX_CENTER (a CPU run: 2.5e-4).
        check_against_gt(hier, gt, 8, f"hierarchical_mapper, {leaves} leaves",
                         max_center=HIER_MAX_CENTER)
        if leaves < 2:
            raise AssertionError("hierarchical_mapper: the scene was not split")
        prior_root = os.path.join(tmp, "prior")
        os.makedirs(prior_root)
        prior_db, prior_gt = make_scene(prior_root, 8, 120, 1280.0, prior_position=True)
        models, walls["pose_prior_mapper"], results["pose_prior_idle"] = _profiled_command(
            ["pose_prior_mapper", "--database_path", prior_db, "--output_path",
             os.path.join(prior_root, "sparse")], "pose_prior_mapper", MAPPER_KERNELS, launches)
        recon = read_model(os.path.join(prior_root, "sparse", "0"))
        err = max(np.linalg.norm(recon.cam_from_world(i).projection_center()
                                 - prior_gt.cam_from_world(i).projection_center())
                  for i in recon.reg_image_ids())
        log(f"  pose_prior_mapper: {recon.num_reg_frames()}/8 frames, centres {err:.3e} from the "
            f"priors' (the truth's) frame, no further alignment")
        if not (recon.num_reg_frames() == 8 and err < 1e-3):
            raise AssertionError("pose_prior_mapper: not in the priors' frame")
        walls.update(_file_tools(tmp, db_path, tri, gt_dir))
    log(f"  tools: seconds by command { {k: round(v, 3) for k, v in walls.items()} }")
    results["seconds"] = walls
    return results


def _leaves(db_path, leaf_max, overlap):
    """The hierarchical mapper's leaf count on the database's verified
    pairs (its clustering, run alone)."""
    from colmap_tpu_torch.scene.clustering import SceneClusteringOptions, cluster_scene
    from colmap_tpu_torch.scene.database import Database

    db = Database(db_path, must_exist=True)
    weights = {(a, b): float(len(g.inlier_matches))
               for a, b, g in db.read_all_two_view_geometries()
               if g is not None and len(g.inlier_matches)}
    ids = [iid for iid, _, _ in db.read_images()]
    db.close()
    return len(cluster_scene(ids, weights, SceneClusteringOptions(leaf_max_num_images=leaf_max,
                                                                  image_overlap=overlap)))


def _host(argv, label):
    """A file tool through the CLI (no --device); its wall seconds."""
    from colmap_tpu_torch.cli import main as cli

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        cli.main(argv)
    dt = time.perf_counter() - t0
    lines = buf.getvalue().strip().splitlines()
    log(f"  {label}: {lines[-1] if lines else ''} ({dt:.3f} s, host only)")
    return dt


def _file_tools(tmp, db_path, model, gt_dir):
    """The commands that only rewrite files, each once on the tools'
    outputs; every one must exit 0 (gui must exit 1, as colmap_tpu's)."""
    from colmap_tpu_torch.cli import main as cli

    walls = {}
    out = lambda name: os.path.join(tmp, "files", name)  # noqa: E731
    os.makedirs(out(""))
    for kind, name in (("BIN", "bin"), ("TXT", "txt"), ("PLY", "m.ply"), ("NVM", "m.nvm"),
                       ("Bundler", "m.out"), ("VRML", "m.wrl"), ("R3D", "r3d"), ("CAM", "cam")):
        walls[f"model_converter {kind}"] = _host(
            ["model_converter", "--input_path", model, "--output_path", out(name),
             "--output_type", kind], f"model_converter {kind}")
    tf = out("tf.txt")
    with open(tf, "w") as f:
        f.write("2.0 1 0 0 0 1.0 2.0 3.0")
    walls["model_transformer"] = _host(["model_transformer", "--input_path", model,
                                        "--output_path", out("moved"), "--transform_path", tf],
                                       "model_transformer")
    walls["model_aligner"] = _host(["model_aligner", "--input_path", out("moved"),
                                    "--ref_model_path", gt_dir, "--output_path", out("aligned")],
                                   "model_aligner")
    walls["model_merger"] = _host(["model_merger", "--input_path1", gt_dir, "--input_path2",
                                   out("moved"), "--output_path", out("merged")], "model_merger")
    walls["model_cropper"] = _host(["model_cropper", "--input_path", model, "--output_path",
                                    out("cropped"), "--boundary=-1,-1,-1,0,1,1"], "model_cropper")
    walls["model_comparer"] = _host(["model_comparer", "--input_path1", out("aligned"),
                                     "--input_path2", gt_dir], "model_comparer")
    walls["model_splitter"] = _host(["model_splitter", "--input_path", model, "--output_path",
                                     out("parts")], "model_splitter")
    walls["model_clusterer"] = _host(["model_clusterer", "--input_path", model, "--output_path",
                                      out("clusters"), "--leaf_max_num_images", "4"],
                                     "model_clusterer")
    ids = out("ids.txt")
    with open(ids, "w") as f:
        f.write("1\n")
    walls["image_deleter"] = _host(["image_deleter", "--input_path", model, "--output_path",
                                    out("deleted"), "--image_ids_path", ids], "image_deleter")
    walls["image_filterer"] = _host(["image_filterer", "--input_path", model, "--output_path",
                                     out("filtered")], "image_filterer")
    walls["project_generator"] = _host(["project_generator", "--database_path", db_path,
                                        "--output_path", out("project.ini")],
                                       "project_generator")
    shutil.copy(db_path, out("copy.db"))
    import sqlite3

    conn = sqlite3.connect(out("copy.db"))  # image names are unique in a database
    conn.execute("UPDATE images SET name = 'copy_' || name")
    conn.commit()
    conn.close()
    walls["database_merger"] = _host(["database_merger", "--database_path1", db_path,
                                      "--database_path2", out("copy.db"),
                                      "--merged_database_path", out("merged.db")],
                                     "database_merger")
    walls["database_cleaner"] = _host(["database_cleaner", "--database_path", out("copy.db"),
                                       "--type", "matches"], "database_cleaner")
    feats, imgs = out("feats"), out("imgs")
    os.makedirs(feats)
    os.makedirs(imgs)
    from colmap_tpu_torch.utils.image_io import write_png

    rng = np.random.default_rng(0)
    write_png(os.path.join(imgs, "a.png"), rng.integers(0, 255, (60, 80), dtype=np.uint8))
    with open(os.path.join(feats, "a.png.txt"), "w") as f:
        f.write("2 128\n" + "\n".join(" ".join(["1.0"] * 4 + ["7"] * 128) for _ in range(2)))
    walls["feature_importer"] = _host(["feature_importer", "--database_path", out("imp.db"),
                                       "--image_path", imgs, "--import_path", feats],
                                      "feature_importer")
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            cli.main(["gui"])
        raise AssertionError("gui returned")
    except SystemExit as e:
        if e.code != 1:
            raise
    log("  gui: exits 1 (headless), as colmap_tpu's")
    return walls


LEARNED_SOURCES = {
    "aliked_conv": ("colmap_tpu_torch/csrc/aliked_conv.cu", "colmap_tpu/feature/aliked.py:120"),
    "aliked_dkd": ("colmap_tpu_torch/csrc/aliked_dkd.cu", "colmap_tpu/feature/aliked.py:141"),
    "aliked_sddh": ("colmap_tpu_torch/csrc/aliked_sddh.cu", "colmap_tpu/feature/aliked.py:201"),
    "lightglue_attention": ("colmap_tpu_torch/csrc/lightglue_attention.cu",
                            "colmap_tpu/feature/lightglue.py:118"),
}
# ALIKED at the extractor's width: rendered 3072 x 2304 views (BASELINE.json
# config 1's frames), K = 8192 (SiftOptions.max_num_features, the
# pipeline's cap), random weights from init_params' seed 0. Each K50 call
# and K52 within K50_RTOL of their plain versions (F.conv2d with TF32 off;
# K52's plain version the dense SDDH that convolves the whole image, as
# colmap_tpu), relative to the output's largest magnitude; K51 the plain
# version's keypoint list in its order, refined positions within K51_PX
# beyond one float32 ulp of the coordinate (the sum x + dx is rounded).
ALIKED_K, K50_RTOL, K51_PX, K52_RTOL = 8192, 1e-4, 1e-5, 1e-4
# LightGlue at its published width (LightGlueOptions: 9 layers, hidden 256,
# 4 heads) on one pair of 2048 keypoints (the cap): the first 2048 ALIKED
# features of a view against the same features moved by 3.5 px, their
# descriptors perturbed, in a permuted order. Every K53 (a) call within
# K53_RTOL of its plain version; K53 (b) the plain version's match list,
# where a row may differ only if a score of its decision lies within
# K53_TIE of another (float64 scores).
LG_N, K53_RTOL, K53_TIE = 2048, 1e-4, 1e-6
# Phase learned: LightGlue on the 12 rendered 1024 x 768 frames (phase
# extractor's scene) extracted at 2048 ALIKED features, threshold 0 (random
# weights keep no match at the default 0.1); one frame against a copy of
# itself under another name and against a permuted copy keeps at least
# LG_MIN_MATCHES mutual matches, at least LG_MIN_CORRECT of them right, on
# SIFT features (tests/test_learned_features.py:70-105's property; on
# ALIKED's uint8 descriptors random weights keep ~1 match, logged).
LG_FRAME_FEATURES, LG_MIN_MATCHES, LG_MIN_CORRECT = 2048, 100, 0.99
LEARNED_STATE = {}


def _learned_views():
    """The EXTRACT_VIEWS rendered 3072 x 2304 views (made once, shared by
    the two learned phases): their directory."""
    from colmap_tpu_torch.kernels import sift_cases as SC

    if "views" not in LEARNED_STATE:
        root = tempfile.mkdtemp(prefix="learned_")
        t0 = time.perf_counter()
        SC.render_scene(os.path.join(root, "wide"), EXTRACT_VIEWS, SIFT_POINTS, SIFT_W, SIFT_H,
                        1.25 * SIFT_W)
        log(f"learned: {EXTRACT_VIEWS} rendered {SIFT_W} x {SIFT_H} views (set-up "
            f"{time.perf_counter() - t0:.1f} s)")
        LEARNED_STATE.update(root=root, views=os.path.join(root, "wide"))
    return LEARNED_STATE["views"]


def _conv_ops(x, w, pool):
    h, wd = (x.shape[1] // 2, x.shape[2] // 2) if pool else x.shape[1:]
    return 2 * w.numel() * h * wd


def _backbone_plain(p, img):
    """backbone_and_score through the plain versions (F.conv2d, TF32 off)."""
    from colmap_tpu_torch.kernels import aliked as KA

    S = KA.ACT_SELU

    def block(x, q, pool=False):
        x = KA.conv_plain(x, q["conv1"]["w"], q["conv1"]["b"], S, pool)
        return KA.conv_plain(x, q["conv2"]["w"], q["conv2"]["b"], S)

    H, W = img.shape
    f1 = block(img[None], p["block1"])
    f2 = block(f1, p["block2"], True)
    f3 = block(f2, p["block3"], True)
    f4 = block(f3, p["block4"], True)
    parts = [KA.conv_plain(f1, p["agg1"]["w"], p["agg1"]["b"], S)]
    for i, f in enumerate((f2, f3, f4), start=2):
        parts.append(KA.upsample_selu_plain(KA.conv_plain(f, p[f"agg{i}"]["w"], p[f"agg{i}"]["b"]),
                                            (H, W)))
    s = torch.cat(parts)
    for name in ("smh1", "smh2", "smh3"):
        s = KA.conv_plain(s, p[name]["w"], p[name]["b"], S)
    return KA.conv_plain(s, p["smh4"]["w"], p["smh4"]["b"], KA.ACT_SIGMOID)[0]


def _k50(img, p, errs, rows):
    """K50 on a full-width view: each call against its plain version on the
    same inputs, then the whole backbone timed three ways."""
    import torch.nn.functional as F

    from colmap_tpu_torch.feature import aliked as TA
    from colmap_tpu_torch.kernels import aliked as KA

    calls, worst = [], [0.0, 0.0]
    conv, upsample = KA.conv, KA.upsample_selu

    def conv_checked(x, w, b, act=KA.ACT_NONE, pool=False, out=None):
        y = conv(x, w, b, act, pool, out)
        a, r = rel_err(y, KA.conv_plain(x, w, b, act, pool))
        calls.append(("conv", x, w, b, pool))
        worst[:] = [max(worst[0], a), max(worst[1], r)]
        if not r <= K50_RTOL:
            raise AssertionError(f"K50 (a) {tuple(w.shape)} pool={pool}: relative error {r:.3e}")
        return y

    def upsample_checked(src, out):
        y = upsample(src, out)
        a, r = rel_err(y, KA.upsample_selu_plain(src, tuple(out.shape[1:])))
        calls.append(("upsample", src, tuple(out.shape[1:])))
        worst[:] = [max(worst[0], a), max(worst[1], r)]
        if not r <= K50_RTOL:
            raise AssertionError(f"K50 (b) {tuple(src.shape)}: relative error {r:.3e}")
        return y

    KA.conv, KA.upsample_selu = conv_checked, upsample_checked
    try:
        feat, score = TA.backbone_and_score(p, img)
    finally:
        KA.conv, KA.upsample_selu = conv, upsample
    a, r = rel_err(score, _backbone_plain(p, img))
    log(f"  K50: {len(calls)} calls (convs and upsamplings) each within {worst[1]:.3e} of the "
        f"plain version (max abs {worst[0]:.3e}, tolerance {K50_RTOL:g}); the score map within "
        f"{r:.3e}; peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    errs["aliked_conv"].append(tuple(worst))
    ops = sum(_conv_ops(c[1], c[2], c[4]) for c in calls if c[0] == "conv")
    H, W = img.shape
    b_ms, by = bound(4 * H * W * (2 + feat.shape[0]), ops)
    lib_in = [(F.avg_pool2d(x[None], 2)[0] if pool else x, w, b)
              for kind, x, w, b, pool in (c for c in calls if c[0] == "conv")]
    ups = [(c[1], c[2]) for c in calls if c[0] == "upsample"]

    def library():
        for x, w, b in lib_in:
            F.conv2d(x[None], w, b, padding=w.shape[-1] // 2)
        for src, size in ups:
            F.interpolate(src[None], size=size, mode="bilinear", align_corners=False)

    ms = time_ms(lambda: TA.backbone_and_score(p, img), reps=5)
    plain_ms = time_ms(lambda: _backbone_plain(p, img), reps=3)
    library_ms = time_ms(library, reps=3)
    log(f"    aliked_conv, the backbone and score head at {W} x {H} ({ops / 2e9:.1f} GMAC): "
        f"{ms:.3f} ms (plain {plain_ms:.3f} ms; F.conv2d x {len(lib_in)} + F.interpolate x "
        f"{len(ups)}, TF32 off, {library_ms:.3f} ms; bound {b_ms:.4f} ms by {by})")
    rows["aliked_conv"] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=by,
                               library_ms=library_ms)
    return feat, score


def _k51(score, errs, rows):
    from colmap_tpu_torch.kernels import aliked as KA

    xy, sc = KA.dkd(score, ALIKED_K, 2, 0.2)
    xy_p, sc_p = KA.dkd_plain(score, ALIKED_K, 2, 0.2)
    same = len(sc) == len(sc_p) and bool(torch.equal(sc, sc_p))
    err = beyond = float("inf")
    if len(xy) and same:
        d = (xy - xy_p).abs()
        err = float(d.max())
        # x + dx is rounded to float32: one ulp of the coordinate (2.4e-4 px
        # at 2048-4095) is the refinement's resolution there.
        ulp = torch.nextafter(xy_p.abs(), torch.full_like(xy_p, torch.inf)) - xy_p.abs()
        beyond = float((d - ulp).clamp(min=0).max())
    cand = KA.dkd_plain(score, score.numel(), 2, 0.2)[1].numel()
    log(f"  K51: {cand} candidates; {len(xy)} keypoints ({len(xy_p)} plain), the same list in "
        "the same order: "
        f"{same}; refined positions within {err:.3e} px, {beyond:.3e} px beyond one float32 "
        f"ulp of the coordinate (tolerance {K51_PX:g})")
    if not (same and beyond <= K51_PX and len(xy) > 0):
        raise AssertionError("K51 disagrees with its plain version")
    errs["aliked_dkd"].append((err, err / max(float(xy_p.abs().max()), 1e-30)))
    H, W = score.shape
    b_ms, by = bound(4 * H * W + 12 * len(xy), 0)
    ms = time_ms(lambda: KA.dkd(score, ALIKED_K, 2, 0.2), reps=10)
    plain_ms = time_ms(lambda: KA.dkd_plain(score, ALIKED_K, 2, 0.2), reps=5)
    library_ms = time_ms(lambda: KA.dkd_library(score, ALIKED_K, 2, 0.2), reps=10)
    log(f"    aliked_dkd at {W} x {H}, K = {ALIKED_K}: {ms:.4f} ms with its one count read, "
        f"after the last launch (plain {plain_ms:.3f} ms; F.max_pool2d + torch.topk "
        f"{library_ms:.4f} ms; bound {b_ms:.5f} ms by {by})")
    log_busy("  aliked_dkd, a call", *kernel_split(lambda: KA.dkd(score, ALIKED_K, 2, 0.2)))
    rows["aliked_dkd"] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=by,
                              library_ms=library_ms)
    return xy


def _k52(feat, xy, p, errs, rows):
    from colmap_tpu_torch.kernels import aliked as KA

    o = p["sddh_offset"]
    off_args = (o["conv1"]["w"], o["conv1"]["b"], o["conv2"]["w"], o["conv2"]["b"])
    off = KA.sddh_offsets(feat, xy, *off_args)
    check("K52 (a) offsets against the dense plain version", off,
          KA.sddh_offsets_plain(feat, xy, *off_args), K52_RTOL, errs["aliked_sddh"])
    d_args = (p["sddh_weight"]["w"], p["sddh_weight"]["b"], p["sddh_agg"]["w"])
    check("K52 (b) descriptors on the same offsets", KA.sddh_describe(feat, xy, off, *d_args),
          KA.sddh_describe_plain(feat, xy, off, *d_args), K52_RTOL, errs["aliked_sddh"])
    torch.cuda.reset_peak_memory_stats()
    desc = KA.sddh(feat, xy, p)
    check("K52 descriptors against the dense plain SDDH", desc, KA.sddh_plain(feat, xy, p),
          K52_RTOL, errs["aliked_sddh"])
    log(f"  K52: peak memory with the dense plain version "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    C, H, W = feat.shape
    n, M = len(xy), p["sddh_agg"]["w"].shape[0]
    macs = n * (16 * C * C * 9 + 4 * 2 * M * C * 9 + 2 * M * C * C)
    moved = 4 * (n * (36 + 4 * M) * C + n * (2 + C) + sum(t.numel() for t in (*off_args, *d_args)))
    b_ms, by = bound(moved, 2 * macs)
    ms = time_ms(lambda: KA.sddh(feat, xy, p), reps=10)
    plain_ms = time_ms(lambda: KA.sddh_plain(feat, xy, p), reps=3)
    ms_a = time_ms(lambda: KA.sddh_offsets(feat, xy, *off_args), reps=10)
    log(f"    aliked_sddh, {n} keypoints ({macs / 1e9:.1f} GMAC sparse): {ms:.3f} ms, (a) "
        f"{ms_a:.3f} ms (the dense plain version {plain_ms:.3f} ms; bound {b_ms:.4f} ms by {by})")
    rows["aliked_sddh"] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=by,
                               library_ms=None, entries={"offsets": dict(ms=ms_a)})


def _lg_pair(xy, desc, shape):
    """Set 1: the first LG_N features; set 2: the same moved by 3.5 px, the
    descriptors perturbed and renormalized, permuted. Normalized as
    match_lightglue's prep; returns (tensors on the card, perm)."""
    from colmap_tpu_torch.feature.lightglue import _prep

    rng = np.random.default_rng(7)
    n = min(LG_N, len(xy))
    xy, desc = xy[:n].cpu().numpy(), desc[:n].cpu().numpy()
    perm = rng.permutation(n)
    xy2 = (xy + 3.5)[perm]
    d2 = (desc + 0.05 * rng.normal(size=desc.shape).astype(np.float32))[perm]
    d1, k1 = _prep(desc, xy, shape, LG_N)
    d2, k2 = _prep(d2, xy2, shape, LG_N)
    return [torch.from_numpy(a).cuda() for a in (d1, k1, d2, k2)], perm


def _k53(xy, desc, shape, errs, rows):
    """K53 (a) at every call of one pair's forward and K53 (b) on its
    similarity, against their plain versions; timed."""
    from colmap_tpu_torch.feature.lightglue import LightGlue, LightGlueOptions
    from colmap_tpu_torch.kernels import lightglue as KLG

    (d1, k1, d2, k2), perm = _lg_pair(xy, desc, shape)
    n = len(d1)
    model = LightGlue(None, LightGlueOptions(filter_threshold=0.0)).cuda()
    mask = torch.ones(n, dtype=torch.bool, device="cuda")
    calls, worst = [], [0.0, 0.0]
    attention = KLG.attention

    def checked(q, k, v, mq, mk, heads, cos=None, sin=None):
        y = attention(q, k, v, mq, mk, heads, cos, sin)
        a, r = rel_err(y, KLG.attention_plain(q, k, v, mq, mk, heads, cos, sin))
        worst[:] = [max(worst[0], a), max(worst[1], r)]
        if not r <= K53_RTOL:
            raise AssertionError(f"K53 (a) call {len(calls)}: relative error {r:.3e}")
        calls.append((q, k, v, mq, mk, heads, cos, sin))
        return y

    KLG.attention = checked
    try:
        with torch.inference_mode():
            sim, m1, m2 = model.head(d1, k1, mask, d2, k2, mask)
    finally:
        KLG.attention = attention
    log(f"  K53 (a): {len(calls)} calls of one {n} x {n} pair's forward (9 layers, hidden 256, "
        f"4 heads), each within {worst[1]:.3e} of the plain version (max abs {worst[0]:.3e}, "
        f"tolerance {K53_RTOL:g})")
    errs["lightglue_attention"].append(tuple(worst))
    q, k, v, mq, mk, heads, cos, sin = calls[0]
    ops = 4 * heads * n * n * 64
    b_ms, by = bound(4 * 4 * n * 256 + 2 * 4 * n * 32, ops)
    ms = time_ms(lambda: KLG.attention(q, k, v, mq, mk, heads, cos, sin), reps=25)
    plain_ms = time_ms(lambda: KLG.attention_plain(q, k, v, mq, mk, heads, cos, sin), reps=10)
    library_ms = time_ms(lambda: KLG.attention_library(q, k, v, mk, heads), reps=25)
    fwd_ms = time_ms(lambda: model.head(d1, k1, mask, d2, k2, mask), reps=5)
    tf32_ms = 3 * ops / PEAK_TF32_OPS_PER_S * 1e3
    log(f"    lightglue_attention (a), self-attention with the rotation, {n} x {n}: {ms:.4f} ms "
        f"(plain {plain_ms:.3f} ms; F.scaled_dot_product_attention with the additive mask "
        f"{library_ms:.4f} ms; bound {b_ms:.5f} ms by {by}, {tf32_ms:.5f} ms for the three TF32 "
        f"passes at 495 TFLOP/s); the pair's forward {fwd_ms:.3f} ms")
    plan = KLG.attention_plan(heads, n, n)
    log(f"    K53 (a) design at {n} x {n}, {heads} heads: {plan['splits']} key splits, tile grid "
        f"{plan['grid']} of {plan['threads']} threads, {plan['registers']} registers and "
        f"{plan['local_bytes']} spilled bytes a thread, {plan['shared_bytes']} B dynamic shared "
        f"a block, {plan['blocks_per_sm']} blocks an SM on {plan['sms']} SMs")
    split = log_parts("lightglue_attention (a), self-attention with the rotation",
                      lambda: KLG.attention(q, k, v, mq, mk, heads, cos, sin))
    log_parts("lightglue_attention (a), cross-attention", lambda: KLG.attention(q, k, v, mq, mk,
                                                                                 heads))

    # (b): the match list against the plain version's; near-ties from float64.
    matches, _ = KLG.log_assignment(sim, mask, mask, m1, m2, 0.0)
    s32 = KLG.log_assignment_plain(sim, mask, mask, m1, m2)
    ref = KLG.extract_matches_plain(s32, mask, mask, 0.0)
    s64 = KLG.log_assignment_plain(sim.double(), mask, mask, m1.double(), m2.double())
    got_set = {tuple(r) for r in matches.long().tolist()}
    ref_set = {tuple(r) for r in ref.tolist()}
    top_r = torch.topk(s64, 2, dim=1).values
    top_c = torch.topk(s64, 2, dim=0).values
    tie_r = (top_r[:, 0] - top_r[:, 1]) < K53_TIE
    tie_c = (top_c[0] - top_c[1]) < K53_TIE
    bad = [(i, j) for (i, j) in got_set ^ ref_set if not (tie_r[i] or tie_c[j])]
    correct = float(np.mean([perm[j] == i for i, j in got_set])) if got_set else 0.0
    log(f"  K53 (b): {len(got_set)} matches ({len(ref_set)} plain), {len(got_set ^ ref_set)} "
        f"differing, {len(bad)} of them outside a near-tie ({K53_TIE:g}); {correct:.4f} of the "
        f"kernel's matches the planted correspondence")
    if bad or not got_set:
        raise AssertionError(f"K53 (b) disagrees with its plain version: {bad[:5]}")
    errs["lightglue_attention"].append((0.0, 0.0))
    N1, N2 = sim.shape
    b_b, by_b = bound(4 * N1 * N2 + 5 * (N1 + N2) + 8 * len(matches), 0)
    ms_b = time_ms(lambda: KLG.log_assignment(sim, mask, mask, m1, m2, 0.0), reps=25)
    plain_b = time_ms(lambda: KLG.extract_matches_plain(
        KLG.log_assignment_plain(sim, mask, mask, m1, m2), mask, mask, 0.0), reps=10)
    lib_b = time_ms(lambda: KLG.log_assignment_library(sim), reps=25)
    log(f"    lightglue_attention (b), the log-assignment and match list, {N1} x {N2}: "
        f"{ms_b:.4f} ms with its count read (plain {plain_b:.3f} ms; log_softmax x 2 + argmax x 2 "
        f"{lib_b:.4f} ms; bound {b_b:.5f} ms by {by_b})")
    rows["lightglue_attention"] = dict(
        ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=by, library_ms=library_ms,
        entries={"log_assignment": dict(ms=ms_b, plain_ms=plain_b, bound_ms=b_b, bound_by=by_b,
                                        library_ms=lib_b)},
        extra={"pair_forward_ms": fwd_ms, "design": plan,
               "parts_ms": {name: ms for name, (ms, _) in split.items()}})


def phase_learned_kernels():
    """K50-K53 against their plain versions on the card at full width: one
    rendered 3072 x 2304 view through the backbone (K50), DKD at K = 8192
    (K51) and SDDH (K52, against the dense plain version), then one pair of
    2048 of its features through LightGlue (K53); timed with CUDA events.
    Returns (errs, rows)."""
    from colmap_tpu_torch.feature.aliked import AlikedOptions, init_params
    from colmap_tpu_torch.kernels import aliked as KA
    from colmap_tpu_torch.utils.image_io import read_image_gray
    from colmap_tpu_torch.utils.param_tree import map_tree

    errs = {k: [] for k in LEARNED_SOURCES}
    rows = {}
    torch.backends.cudnn.allow_tf32 = False
    views = _learned_views()
    name = sorted(os.listdir(views))[0]
    img = torch.from_numpy(read_image_gray(os.path.join(views, name)).astype(np.float32) / 255.0)
    img = img.cuda()
    p = map_tree(lambda t: t.cuda(), init_params(AlikedOptions(max_num_keypoints=ALIKED_K)))
    torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode():
        t0 = time.perf_counter()
        feat, score = _k50(img, p, errs, rows)
        log(f"  (K50: {time.perf_counter() - t0:.1f} s)")
        t0 = time.perf_counter()
        xy = _k51(score, errs, rows)
        log(f"  (K51: {time.perf_counter() - t0:.1f} s)")
        t0 = time.perf_counter()
        _k52(feat, xy, p, errs, rows)
        desc = KA.sddh(feat, xy, p)
        log(f"  (K52: {time.perf_counter() - t0:.1f} s)")
        del feat, score
        t0 = time.perf_counter()
        _k53(xy, desc, tuple(img.shape), errs, rows)
        log(f"  (K53: {time.perf_counter() - t0:.1f} s)")
    return errs, rows


LEARNED_EXTRACT_KERNELS = ("aliked_conv", "aliked_dkd", "aliked_sddh")


def _lightglue_checks(root, images, frame, launches, results):
    """One frame against a copy of itself under another name (through
    feature_extractor and run_exhaustive_matching) and against a permuted
    copy (match_lightglue): mutual matches and the share that is right. The
    gates hold on SIFT features (SIFT_LIGHTGLUE); on ALIKED's the counts
    are logged: with random weights, the uint8 storage (d + 1) 127.5 turns
    every ALIKED descriptor nearly parallel, and LightGlue keeps ~1 match."""
    from colmap_tpu_torch.controllers.feature_pipeline import (
        MatchingPipelineOptions, run_exhaustive_matching)
    from colmap_tpu_torch.feature.lightglue import LightGlueOptions, match_lightglue
    from colmap_tpu_torch.scene.database import Database

    opts = MatchingPipelineOptions(matcher_type="lightglue",
                                   lightglue_options=LightGlueOptions(filter_threshold=0.0))
    out = {}
    for kind, kernels, gated in (("sift", SIFT_SOURCES, True),
                                 ("aliked", LEARNED_EXTRACT_KERNELS, False)):
        pair_dir = os.path.join(root, f"pair_{kind}")
        os.makedirs(pair_dir)
        shutil.copy(os.path.join(images, frame), os.path.join(pair_dir, "a_" + frame))
        shutil.copy(os.path.join(images, frame), os.path.join(pair_dir, "b_copy_" + frame))
        pair_db = pair_dir + ".db"
        run_command(["feature_extractor", "--database_path", pair_db, "--image_path", pair_dir,
                     "--descriptor_type", kind, "--max_num_features", str(LG_FRAME_FEATURES)],
                    f"feature_extractor --descriptor_type {kind}, a frame and its copy", kernels)
        db = Database(pair_db, must_exist=True)
        _driven(f"LightGlue on {kind} features, a frame against its copy",
                lambda: run_exhaustive_matching(db, opts, device="cuda"), ("lightglue_attention",),
                launches)
        (_, m), = db.read_all_matches()
        ids = [iid for iid, _, _ in db.read_images()]
        kp, desc = db.read_keypoints(ids[0]), db.read_descriptors(ids[0])
        cam = next(iter(db.read_cameras().values()))
        db.close()
        shape = (cam.height, cam.width)
        perm = np.random.default_rng(5).permutation(len(kp))
        mp = match_lightglue(desc.astype(np.float32), kp, desc[perm].astype(np.float32), kp[perm],
                             shape, shape, None, opts.lightglue_options, "cuda")
        for label, mm, right in (("copy", m, lambda r: r[:, 0] == r[:, 1]),
                                 ("permuted copy", mp, lambda r: perm[r[:, 1]] == r[:, 0])):
            share = float(np.mean(right(mm))) if len(mm) else 0.0
            log(f"  LightGlue on {kind} features, {frame} against its {label}: {len(mm)} mutual "
                f"matches of {len(kp)} keypoints, {share:.4f} correct" + (
                    f" (gates: >= {LG_MIN_MATCHES}, >= {LG_MIN_CORRECT})" if gated else
                    " (no gate: random weights)"))
            if gated and not (len(mm) >= LG_MIN_MATCHES and share >= LG_MIN_CORRECT):
                raise AssertionError(f"LightGlue against the {label}: {len(mm)} matches, {share}")
            out[f"{kind} {label}"] = dict(matches=len(mm), correct=share, keypoints=len(kp))
    results["self_match"] = out


def phase_learned(launches):
    """Learned features through the normal entry points on cuda:
    `feature_extractor --descriptor_type aliked` on four rendered 3072 x
    2304 views under torch.profiler (128-d uint8 descriptors, at most 8192 a
    view), `exhaustive_matcher` on them (ALIKED_BRUTEFORCE, K10), then the
    12 rendered 1024 x 768 frames extracted with 2048 ALIKED features and
    matched by run_exhaustive_matching with matcher_type="lightglue"
    (threshold 0) under torch.profiler, then the copy and permuted-copy
    checks on SIFT and ALIKED features of one frame."""
    from torch.profiler import ProfilerActivity, profile

    from colmap_tpu_torch.controllers.feature_pipeline import (
        MatchingPipelineOptions, run_exhaustive_matching)
    from colmap_tpu_torch.feature.lightglue import LightGlueOptions
    from colmap_tpu_torch.kernels import sift_cases as SC
    from colmap_tpu_torch.scene.database import Database

    results = {}
    views = _learned_views()
    root = LEARNED_STATE["root"]
    db_path = os.path.join(root, "wide.db")
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.zeros(1, device="cuda").add_(1.0)  # let the tracer see a first kernel
        torch.cuda.synchronize()
        _, dt, counts = run_command(["feature_extractor", "--database_path", db_path,
                                     "--image_path", views, "--descriptor_type", "aliked"],
                                    "feature_extractor --descriptor_type aliked, full width",
                                    LEARNED_EXTRACT_KERNELS)
    add_launches(launches, counts)
    busy_ms, by_name = device_busy(prof)
    idle = log_busy("feature_extractor --descriptor_type aliked", busy_ms, by_name, dt * 1e3,
                    top=8)
    db = Database(db_path, must_exist=True)
    n_kp = []
    for iid, _, _ in db.read_images():
        kp, desc = db.read_keypoints(iid), db.read_descriptors(iid)
        if not (0 < len(kp) <= ALIKED_K and desc.dtype == np.uint8
                and desc.shape == (len(kp), 128)):
            raise AssertionError(f"image {iid}: {len(kp)} keypoints, descriptors "
                                 f"{desc.dtype} {desc.shape}")
        n_kp.append(len(kp))
    db.close()
    log(f"  {EXTRACT_VIEWS} images in {dt:.3f} s = {EXTRACT_VIEWS / dt:.3f} images/s on "
        f"{nvidia_smi_line()}; keypoints per view {n_kp}; 128-d uint8 descriptors; idle share "
        f"{'not measured' if idle is None else f'{idle:.4f}'}")
    results["extract_full_width"] = dict(seconds=dt, images_per_s=EXTRACT_VIEWS / dt,
                                         keypoints=n_kp, idle_share=idle)
    _, dt, counts = run_command(["exhaustive_matcher", "--database_path", db_path],
                                "exhaustive_matcher on ALIKED features (ALIKED_BRUTEFORCE)",
                                ("match_top2",))
    add_launches(launches, counts)
    results["aliked_bruteforce_s"] = dt

    frames = os.path.join(root, "frames")
    t0 = time.perf_counter()
    SC.render_scene(os.path.join(frames, "images"), IMG_FRAMES, IMG_POINTS, 1024, 768, IMG_FOCAL,
                    patch_world=IMG_PATCH_WORLD)
    log(f"LightGlue: {IMG_FRAMES} rendered 1024 x 768 frames (set-up "
        f"{time.perf_counter() - t0:.1f} s)")
    images = os.path.join(frames, "images")
    fdb = os.path.join(frames, "db.db")
    _, dt, counts = run_command(["feature_extractor", "--database_path", fdb, "--image_path",
                                 images, "--descriptor_type", "aliked", "--max_num_features",
                                 str(LG_FRAME_FEATURES)],
                                "feature_extractor --descriptor_type aliked, 12 frames",
                                LEARNED_EXTRACT_KERNELS)
    add_launches(launches, counts)
    db = Database(fdb, must_exist=True)
    opts = MatchingPipelineOptions(matcher_type="lightglue",
                                   lightglue_options=LightGlueOptions(filter_threshold=0.0))
    n_pairs = IMG_FRAMES * (IMG_FRAMES - 1) // 2
    n_verified, dt, idle = _driven("run_exhaustive_matching, matcher_type lightglue",
                                   lambda: run_exhaustive_matching(db, opts, device="cuda"),
                                   ("lightglue_attention",), launches)
    counts = [len(m) for _, m in db.read_all_matches()]
    db.close()
    log(f"  LightGlue matcher: {n_pairs} pairs in {dt:.3f} s = {n_pairs / dt:.2f} pairs/s on "
        f"{nvidia_smi_line()}, idle share {'not measured' if idle is None else f'{idle:.4f}'}; "
        f"{n_verified} pairs verified; matches a pair {min(counts)}-{max(counts)} "
        f"(random weights)")
    if len(counts) != n_pairs:
        raise AssertionError(f"LightGlue wrote {len(counts)} match lists for {n_pairs} pairs")
    results["lightglue_matcher"] = dict(seconds=dt, pairs_per_s=n_pairs / dt, idle_share=idle,
                                        verified=n_verified)
    _lightglue_checks(frames, images, sorted(os.listdir(images))[0], launches, results)
    return results


# Phase covariance: K54 (the BA covariance's float64 S) and the covariance path.
COVARIANCE_SOURCES = {
    "ba_covariance_assemble": ("colmap_tpu_torch/csrc/ba_covariance.cu",
                               "colmap_tpu/estimators/covariance.py:57"),
}
# K54 against its plain version in float64 on the same float32 Jacobians:
# float64 sums in the atomics' order, relative to S's largest entry (H_cc -
# S_corr cancels, so the terms are larger than S).
K54_RTOL = 1e-10
# torch.linalg.inv_ex against np.linalg.inv of the same float64 S_reg: two
# LU inverses differ by about n eps cond(S_reg) (n eps = 1.3e-13 at n =
# 1204), relative to the inverse's largest entry.
INV_RTOL_PER_COND = 1e-12
# The card's covariances (float32 Jacobians) against the float64 plain path:
# the largest relative Frobenius error of a free pose block, and the largest
# error of the camera blocks relative to their largest entry (measured
# 6.9e-8 and 6.8e-10 at the headline on an H100).
COV_POSE_RTOL = 1e-5
COV_CAM_RTOL = 1e-5
# Phase sharded: the point-sharded solve against solve_packed on the BA
# headline, the same iterations and the final cost within this (the two
# solves differ only in the order of float32 sums).
SHARDED_COST_RTOL = 1e-6


def _covariance_scene(name, problem, model_id, masks, launches, errs):
    """estimate_ba_covariance on the card (K1 + K54) against the same
    function through the plain versions in float64 on the same float32
    inputs; K54 and the inverse against their float64 references; the fixed
    rows and the free pose blocks. Returns K54's inputs for timing."""
    from colmap_tpu_torch.estimators import bundle_adjustment as ba
    from colmap_tpu_torch.estimators import covariance as cv
    from colmap_tpu_torch.kernels import ba as K

    options = ba.BAOptions()
    cov, dt, _ = _counted(f"estimate_ba_covariance, {name}",
                          lambda: cv.estimate_ba_covariance(problem, model_id, options, masks),
                          ("ba_obs_jacobians", "ba_covariance_assemble"), launches=launches)
    p64 = problem._replace(**{k: getattr(problem, k).double() for k in
                              ("quat", "t", "cam_params", "points", "obs_xy", "obs_w")})
    m64 = ba.BAMasks(*(m.double() for m in masks))
    ref = cv._covariance(p64, model_id, options, m64, 1e-8, K.PLAIN)
    F = problem.quat.shape[0]
    C, P = problem.cam_params.shape
    fixed = (torch.cat([torch.cat([masks.frame_mask[:, None].expand(-1, 3),
                                   masks.frame_trans_mask], 1).reshape(-1),
                        masks.cam_mask.reshape(-1)]) == 0).cpu().numpy()
    pose_fixed = fixed[:6 * F].reshape(F, 6)
    worst = 0.0
    for f in range(F):
        free = ~pose_fixed[f]
        got, want = cov["pose_covs"][f], ref["pose_covs"][f]
        if not (np.isfinite(got).all() and (got[~free] == 0).all() and (got[:, ~free] == 0).all()):
            raise AssertionError(f"{name}: pose block {f} is not finite or not 0 on its fixed rows")
        if free.any():
            blk = got[np.ix_(free, free)]
            if not np.linalg.eigvalsh(blk).min() > 0:
                raise AssertionError(f"{name}: free pose block {f} is not positive-definite")
            worst = max(worst, np.linalg.norm(got - want) / np.linalg.norm(want))
    cam_err = (np.abs(cov["cam_covs"] - ref["cam_covs"]).max()
               / max(np.abs(ref["cam_covs"]).max(), 1e-300))

    # K54 against its plain version on the same float32 Jacobians; S's fixed rows.
    packed, maps, _ = ba.pack_problem(problem)
    om = ba._obs_masks(masks, options)
    pk = packed
    _, Jp, Jc, Jx = K.obs_jacobians(pk.quat, pk.t, pk.cam_params, pk.points, pk.obs_frame,
                                    pk.obs_cam, pk.obs_point, pk.obs_xy, pk.obs_w, om.pose,
                                    om.cam, om.point, model_id, "trivial", 1.0)
    args = (Jp, Jc, Jx, maps.frame_pm, maps.cam_pm, 1e-8, F, C)
    S = K.covariance_assemble(*args)
    check(f"K54 S ({name})", S, K.covariance_assemble_plain(*args), K54_RTOL,
          errs["ba_covariance_assemble"])
    fixed_t = torch.from_numpy(fixed).cuda()
    if not ((S[fixed_t] == 0).all() and (S[:, fixed_t] == 0).all()):
        raise AssertionError(f"{name}: K54's S is not exactly 0 on the fixed rows")
    free_t = ~fixed_t
    cond_free = torch.linalg.cond(S[free_t][:, free_t]).item()
    # The inverse on the card against np.linalg.inv of the same S_reg (float64).
    diag = torch.diagonal(S).abs()
    S_reg = S + torch.diag(torch.where(diag < 1e-12, 1.0, 1e-8 * torch.clamp(diag, min=1.0)))
    inv = torch.linalg.inv_ex(S_reg)[0].cpu().numpy()
    inv_np = np.linalg.inv(S_reg.cpu().numpy())
    cond_reg = float(np.linalg.cond(S_reg.cpu().numpy()))
    inv_rel = np.abs(inv - inv_np).max() / np.abs(inv_np).max()
    log(f"  {name}: n = {6 * F + C * P} ({int(fixed.sum())} fixed rows, exactly 0 in S and in "
        f"the covariances); cond(S) over the free rows {cond_free:.4e}, cond(S_reg) "
        f"{cond_reg:.4e}; torch.linalg.inv_ex vs np.linalg.inv: rel {inv_rel:.3e} (tol "
        f"{INV_RTOL_PER_COND:g} x cond(S_reg)); pose blocks against the float64 plain path: "
        f"max relative Frobenius error {worst:.3e} (tol {COV_POSE_RTOL:g}), camera blocks "
        f"rel {cam_err:.3e} (tol {COV_CAM_RTOL:g}); wall {dt:.3f} s on {nvidia_smi_line()}")
    if not inv_rel <= INV_RTOL_PER_COND * cond_reg:
        raise AssertionError(f"{name}: the inverse differs from np.linalg.inv by {inv_rel:.3e}")
    if not worst <= COV_POSE_RTOL:
        raise AssertionError(f"{name}: pose covariance error {worst:.3e} > {COV_POSE_RTOL}")
    if not cam_err <= COV_CAM_RTOL:
        raise AssertionError(f"{name}: camera covariance error {cam_err:.3e} > {COV_CAM_RTOL}")
    return args, dict(seconds=dt, cond_free=cond_free, cond_reg=cond_reg, inv_rel=inv_rel,
                      pose_rel_frob=worst, cam_rel=cam_err)


def phase_covariance(launches):
    """estimate_ba_covariance (K1 + K54 + the float64 inverse) on the verify
    scene (8 x 120 x 5, 1 px noise, seed 2, two-frame gauge, intrinsics
    fixed) and on the BA headline (two-frame gauge, default intrinsics),
    held as _covariance_scene says; K54 timed at the headline."""
    from colmap_tpu_torch.estimators import bundle_adjustment as ba
    from colmap_tpu_torch.kernels import ba as K
    from colmap_tpu_torch.scene.synthetic_ba import synthetic_ba_problem

    errs = {"ba_covariance_assemble": []}
    results = {}
    problem, _, model_id = synthetic_ba_problem(8, 120, 5, pixel_noise=1.0, seed=2, device="cuda")
    masks = ba.fix_gauge_two_frames(ba.default_masks(problem, model_id, ba.BAOptions()), 0, 1)
    masks = masks._replace(cam_mask=torch.zeros_like(masks.cam_mask))
    _, results["verify"] = _covariance_scene("verify scene", problem, model_id, masks, launches,
                                             errs)
    problem, _, model_id = synthetic_ba_problem(200, 50000, 6, seed=0, device="cuda")
    masks = ba.fix_gauge_two_frames(ba.default_masks(problem, model_id, ba.BAOptions()), 0, 1)
    args, results["headline"] = _covariance_scene("BA headline", problem, model_id, masks,
                                                  launches, errs)
    Jp, Jc, Jx, fpm, cpm, lam, F, C = args
    N, capp = fpm.shape
    P, D = Jc.shape[-1], 6 * F + C * Jc.shape[-1]
    Kw = 6 + P
    # As K4's count (time_kernels), in float64: per point with n real slots
    # and M = nK entries, W and Z (30 nK), S_corr's symmetric half (3 M (M +
    # 1)), the H_cc term (2 nK (K + 1)), the adds into S (M (M + 1) / 2), and
    # H_pp with its inverse (24 capp + 60).
    n = ((Jp != 0).flatten(1).any(1) | (Jc != 0).flatten(1).any(1)).view(N, capp).sum(1).double()
    M = n * Kw
    ops = float((30 * n * Kw + 3 * M * (M + 1) + 2 * n * Kw * (Kw + 1) + M * (M + 1) / 2).sum()
                + N * (24 * capp + 60))
    b_bytes = nbytes(Jp, Jc, Jx, fpm, cpm) + D * D * 8
    ms = time_ms(lambda: K.covariance_assemble(*args))
    plain_ms = time_ms(lambda: K.covariance_assemble_plain(*args), reps=3)
    t_bytes = b_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_F64_TC_OPS_PER_S * 1e3
    b_ms, by = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
    log(f"  ba_covariance_assemble at the headline (D = {D}): {ms:.4f} ms (plain {plain_ms:.3f} "
        f"ms, bound {b_ms:.4f} ms by {by}: {b_bytes / 1e6:.1f} MB, {ops / 1e9:.3f} GFLOP f64); "
        f"launches on the driven paths {launches['ba_covariance_assemble']}")
    rows = {"ba_covariance_assemble": dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                                           bound_by=by, library_ms=None)}
    return errs, rows, results


def _headline_problem():
    from colmap_tpu_torch.estimators import bundle_adjustment as ba
    from colmap_tpu_torch.parallel.dist_cases import HEADLINE_OPTIONS
    from colmap_tpu_torch.scene.synthetic_ba import synthetic_ba_problem

    problem, _, model_id = synthetic_ba_problem(200, 50000, 6, seed=0, device="cuda")
    options = ba.BAOptions(**HEADLINE_OPTIONS)
    masks = ba.fix_gauge_two_frames(ba.default_masks(problem, model_id, options), 0, 1)
    return problem, model_id, options, masks


def _same_solve(label, summary, ref_summary):
    rel = abs(summary["final_cost"] - ref_summary["final_cost"]) / ref_summary["final_cost"]
    log(f"  {label}: final cost {summary['final_cost']:.9e} in {summary['num_iterations']} "
        f"iterations; solve_packed {ref_summary['final_cost']:.9e} in "
        f"{ref_summary['num_iterations']}: relative difference {rel:.3e} "
        f"(tol {SHARDED_COST_RTOL:g})")
    if summary["num_iterations"] != ref_summary["num_iterations"] or not rel <= SHARDED_COST_RTOL:
        raise AssertionError(f"{label}: differs from solve_packed")
    return rel


def _split_kernel_checks(problem, model_id, options, masks, errs):
    """K35's split candidate and K4 without its diagonal (the sharded
    solve's modes) against their plain versions in float64 at the headline."""
    from colmap_tpu_torch.estimators import bundle_adjustment as ba
    from colmap_tpu_torch.kernels import ba as K
    from colmap_tpu_torch.kernels import solver as KL

    pk, maps, _ = ba.pack_problem(problem)
    om = ba._obs_masks(masks, options)
    J = K.obs_jacobians(*pk, om.pose, om.cam, om.point, model_id, "trivial", 1.0)
    F, C = pk.quat.shape[0], pk.cam_params.shape[0]
    lam = torch.tensor(1e-3, device="cuda")
    red = K.lm_reduce(*J, maps.frame_pm, maps.cam_pm, F, C, lam)
    red64 = K.LMReduction(*f64(*red))
    g = torch.Generator(device="cuda").manual_seed(0)
    dp = torch.randn(F, 6, device="cuda", generator=g) * 1e-3
    dc = torch.randn(C, J[2].shape[-1], device="cuda", generator=g) * 1e-3
    dx = K.back_substitute(*J[1:], maps.frame_pm, maps.cam_pm, red.Hpp_inv, red.gx, dp, dc)
    params = (pk.quat, pk.t, pk.cam_params, pk.points)
    cand, pred = KL.lm_candidate(*params, dp, dc, dx, red, lam, split=True)
    _, pred_fused = KL.lm_candidate(*params, dp, dc, dx, red, lam)
    _, pred64 = KL.lm_candidate_plain(*f64(*params, dp, dc, dx), red64, lam.double(), split=True)
    check("K35 split candidate pred (camera part, point part)", pred, pred64, K35_RTOL,
          errs.setdefault("ba_lm_update", []))
    check("K35 split pred sum against the fused pred", pred.sum(), pred_fused, 1e-12,
          errs["ba_lm_update"])
    ops = (*J[1:], maps.frame_pm, maps.cam_pm, red.Hpp_inv)
    lam_diag = torch.cat([lam * red.diag_pose.reshape(-1), lam * red.diag_cam.reshape(-1)])
    S = K.dense_schur_assemble(*ops, lam_diag, F, diagonal=False)
    check("K4 S without its diagonal", S,
          K.dense_schur_assemble_plain(*f64(*ops, lam_diag), F, diagonal=False), K234_RTOL,
          errs.setdefault("ba_dense_schur_assemble", []))


def _sharded_costs(problem, model_id, options, masks):
    """Where a sharded PCG solve's time goes in an NCCL group of one rank:
    the device's busy and idle share over a warm solve (torch.profiler),
    and the wall time of one all-reduce of the camera system (6F + C P
    floats) through the solve's hook, over 200 calls."""
    from torch.profiler import ProfilerActivity, profile

    from colmap_tpu_torch.parallel import sharded_ba

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.zeros(1, device="cuda").add_(1.0)  # let the tracer see a first kernel
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sharded_ba.solve_sharded_packed(problem, model_id, options, masks)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    busy_ms, by_name = device_busy(prof)
    idle = log_busy("solve_sharded_packed (pcg), NCCL world size 1", busy_ms, by_name,
                    dt * 1e3, top=8)
    F, (C, P) = problem.quat.shape[0], problem.cam_params.shape
    buf = torch.zeros(6 * F + C * P, device="cuda")
    reduce = sharded_ba.make_reduce()
    reduce(buf)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(200):
        reduce(buf)
    torch.cuda.synchronize()
    us = (time.perf_counter() - t0) / 200 * 1e6
    log(f"    one all-reduce of {buf.numel()} floats through the hook: {us:.1f} us (NCCL, world "
        f"size 1, 200 calls)")
    return dict(idle_share=idle, allreduce_us=us)


def phase_sharded(launches, errs):
    """The point-sharded solve (parallel/sharded_ba.py) on the BA headline,
    10 LM iterations, PCG 20: (a) in this process in an NCCL group of one
    rank, PCG and the dense path, against solve_packed; K35's split mode
    and K4 without its diagonal against float64; (b) two ranks on this card
    over gloo (parallel/dist_cases.py case headline), every rank's cameras
    equal to the bit, against solve_packed, seconds an iteration beside the
    single card's warm iteration; (c) hierarchical_mapper through the CLI
    under COLMAP_TPU_MULTIHOST=1 with torchrun's variables (a group of one
    rank) registers what the run without them registers."""
    import dataclasses

    from colmap_tpu_torch.estimators import bundle_adjustment as ba
    from colmap_tpu_torch.parallel import dist_cases, multihost, sharded_ba

    results = {}
    problem, model_id, options, masks = _headline_problem()
    ba_kernels = ("ba_obs_jacobians", "ba_lm_reduce", "ba_schur_matvec", "ba_lm_update")
    single, warm = {}, {}
    for solver in ("pcg", "auto"):
        opts = dataclasses.replace(options, solver_type=solver)
        ba.solve_packed(problem, model_id, opts, masks)  # loads what the path calls first
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        single[solver] = ba.solve_packed(problem, model_id, opts, masks)[1]
        torch.cuda.synchronize()
        warm[solver] = (time.perf_counter() - t0) / single[solver]["num_iterations"]
    multihost.initialize(f"tcp://127.0.0.1:{dist_cases.free_port()}", 1, 0, backend="nccl")
    try:
        for solver in ("pcg", "auto"):
            opts = dataclasses.replace(options, solver_type=solver)
            need = ba_kernels + (("ba_pcg",) if solver == "pcg" else ("ba_dense_schur_assemble",))
            (_, summary), _, _ = _counted(f"solve_sharded_packed ({solver}), NCCL world size 1",
                                          lambda: sharded_ba.solve_sharded_packed(
                                              problem, model_id, opts, masks), need,
                                          launches=launches)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sharded_ba.solve_sharded_packed(problem, model_id, opts, masks)
            torch.cuda.synchronize()
            per_it = (time.perf_counter() - t0) / summary["num_iterations"]
            rel = _same_solve(f"NCCL world 1 ({solver})", summary, single[solver])
            log(f"    warm call / iterations (packing included) {per_it * 1e3:.3f} ms sharded, "
                f"{warm[solver] * 1e3:.3f} ms solve_packed (the same card)")
            results[f"nccl1_{solver}"] = dict(ms_per_iteration=per_it * 1e3,
                                              single_ms_per_iteration=warm[solver] * 1e3,
                                              cost_rel=rel)
        results["nccl1_pcg"].update(_sharded_costs(problem, model_id, options, masks))
        _split_kernel_checks(problem, model_id, options, masks, errs)
    finally:
        multihost.shutdown()

    with tempfile.TemporaryDirectory() as out:
        wall = dist_cases.launch("headline", 2, out, device="cuda:0", timeout=400)
        ranks = [dict(np.load(os.path.join(out, f"rank{r}_headline.npz"))) for r in range(2)]
    for key in ("quat", "t", "cam_params", "points"):
        if not np.array_equal(ranks[0][key], ranks[1][key]):
            raise AssertionError(f"gloo 2 ranks: the ranks' {key} differ")
    summary = json.loads(str(ranks[0]["summary"]))
    rel = _same_solve("gloo, 2 ranks on one card (pcg)", summary, single["pcg"])
    per_it = max(float(r["seconds"]) for r in ranks) / summary["num_iterations"]
    us = max(float(r["allreduce_us"]) for r in ranks)
    log(f"    the ranks' cameras and points equal to the bit; warm call / iterations "
        f"{per_it * 1e3:.3f} ms, solve_packed {warm['pcg'] * 1e3:.3f} ms on {nvidia_smi_line()}; "
        f"{options.pcg_iterations + 3} all-reduces an iteration, one staged all-reduce of the "
        f"camera system {us:.1f} us (200 calls); the ranks' wall {wall:.1f} s")
    results["gloo2_pcg"] = dict(ms_per_iteration=per_it * 1e3,
                                single_ms_per_iteration=warm["pcg"] * 1e3, cost_rel=rel,
                                num_devices=summary["num_devices"], allreduce_us=us)

    with tempfile.TemporaryDirectory() as root:
        db_path, _ = make_scene(root, 8, 120)
        base = ["hierarchical_mapper", "--database_path", db_path, "--leaf_max_num_images", "5",
                "--image_overlap", "2", "--quiet", "--output_path"]
        models, _, counts = run_command(base + [os.path.join(root, "alone")],
                                        "hierarchical_mapper, one process", MAPPER_KERNELS)
        add_launches(launches, counts)
        env = dict(COLMAP_TPU_MULTIHOST="1", MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(dist_cases.free_port()), WORLD_SIZE="1", RANK="0",
                   LOCAL_RANK="0")
        saved = {k: os.environ.get(k) for k in env}
        os.environ.update(env)
        try:
            grouped, _, counts = run_command(
                base + [os.path.join(root, "group")],
                "hierarchical_mapper, COLMAP_TPU_MULTIHOST=1 under torchrun's variables",
                MAPPER_KERNELS)
            joined = torch.distributed.is_initialized() and multihost.process_count() == 1
        finally:
            multihost.shutdown()
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        add_launches(launches, counts)
        ids = lambda ms: [sorted(m.reg_image_ids()) for m in ms]
        if not joined or ids(grouped) != ids(models):
            raise AssertionError(f"hierarchical_mapper in a group: joined {joined}, registered "
                                 f"{ids(grouped)} against {ids(models)}")
        log(f"  hierarchical_mapper joined an NCCL group of one rank and registered "
            f"{ids(grouped)}, as alone")
    return results


# ---------------------------------------------------------------------------
# The weighing: launches x (ms - bound) at the shapes the driven paths ran.
# ---------------------------------------------------------------------------

# The ten kernels that head the table's launches x (ms - bound) (PERF.md):
# their wrappers keep a launch-shape tally (kernels/tally.py).
WEIGHED = ("ba_schur_matvec", "aliked_conv", "sift_pyramid", "pm_iteration", "global_positioning",
           "spherical_h_ransac", "ba_pcg", "retrieval_assign", "homography_ransac",
           "ba_lm_reduce")
# A shape class with at least this share of its kernel's driven launches is
# timed; the others are charged at the timed class nearest in size.
WEIGH_SHARE = 0.05


def shape_work(kernel, entry, sizes, args):
    """(bytes, f32 operations) of one call of ``kernel``'s ``entry`` at
    ``sizes`` (its tally's sizes; ``args``, the call's arguments, give the
    valid rows of the RANSACs), by the formula of the kernel's row in the
    kernels line; the entries the row does not time by the same counts."""
    if kernel == "ba_schur_matvec":
        N, capp, F, C, P = sizes
        O = N * capp
        out = 4 * (6 * F + C * P) if entry == "matvec" else 24 * N
        return (4 * O * 2 * (9 + P) + 36 * N + 8 * O + 4 * (6 * F + C * P) + out,
                O * (8 * (6 + P) + 24 + 4 * (6 + P)) + N * 18)
    if kernel == "ba_lm_reduce":
        N, capp, F, C, P = sizes
        O = N * capp
        return (4 * O * (20 + 2 * P) + 8 * O + 4 * (54 * F + 3 * C * P + 15 * N),
                O * (156 + 12 * P) + N * 60)
    if kernel == "ba_pcg":
        if entry == "setup_diag":
            return 4 * 6 * sizes[0], K34_ENTRY_OPS * sizes[0]
        F, CP = sizes[:2]
        n = 6 * F + CP
        return 4 * (11 * n + 36 * F), K34_ENTRY_OPS * n + K34_FRAME_OPS * F
    if kernel == "sift_pyramid":
        H, W = sizes[:2]
        HW = H * W
        if entry == "upsample2":
            return 4 * 5 * HW, 6 * 4 * HW
        if entry == "downsample2":
            return 4 * HW + HW, 0
        r, dog = sizes[2:]
        return 4 * HW * (4 + 2 * dog), 2 * 2 * (2 * r + 1) * HW + dog * HW
    if kernel == "pm_iteration":
        Sv, H, W, taps, geometric = sizes
        HW = H * W
        planes = 4 * HW * (1 + Sv + Sv * geometric + 4 + 1 + Sv + Sv * (entry == "weights") + 8)
        return (planes + 4 * HW * (5 + Sv),
                (HW + 1) // 2 * (taps * PM_TAP_OPS + PM_CAND_OPS
                                 + 7 * (2 * Sv + 1 + pm_plane_ops(taps, Sv, geometric))))
    if kernel == "global_positioning":
        O, C, P = sizes
        return (4 * (6 * O + 9 * P + 15 * C),
                GP_OBS_OPS * O + GP_POINT_OPS * P + GP_CAM_OPS * C)
    if kernel in ("spherical_h_ransac", "homography_ransac"):
        B, N, K = sizes
        valid = float(args[2].sum())
        sample_ops, row_ops = ((SPH_H_SAMPLE_OPS, SPH_H_ROW_OPS)
                               if kernel == "spherical_h_ransac" else (4000, 20))
        tensors = [a for a in args[:4] if torch.is_tensor(a)]
        if entry == "propose":
            return nbytes(*tensors) + 4 * 10 * B * K, B * K * sample_ops + K * valid * row_ops
        return nbytes(*tensors) + 4 * B * N, valid * row_ops
    if kernel == "retrieval_assign":
        N, D, G = sizes
        x, cents, groups = args[:3]
        return nbytes(x, cents, groups) + 4 * N, RET_DIST_OPS * N * G * D
    if kernel == "aliked_conv":
        if entry == "upsample_selu":
            c, h, w, H, W = sizes
            return 4 * c * (h * w + H * W), 10 * c * H * W
        cin, hin, win, cout, k, pool = sizes
        h, w = (hin // 2, win // 2) if pool else (hin, win)
        return (4 * (cin * hin * win + cout * h * w + cout * (cin * k * k + 1)),
                2 * cout * cin * k * k * h * w)
    raise ValueError(f"no work formula for {kernel}")


def phase_weighing():
    """Weigh the WEIGHED kernels at the shapes the driven paths launched
    them at (PATH_SHAPES): each shape class with at least WEIGH_SHARE of its
    kernel's launches is timed again through the call kept at that class
    (CUDA events; a call that launches n kernels counts ms / n a launch)
    and bound by shape_work; the rest is charged at the nearest timed class
    (kernels/tally.py weigh). Logs the table and a JSON line; returns it."""
    from colmap_tpu_torch.kernels import tally as TL

    counts = Counter({k: n for k, n in PATH_SHAPES.items() if k[0] in WEIGHED})
    samples = {}
    for mod in _kernel_modules():
        if hasattr(mod, "SHAPES"):
            samples.update(mod.SHAPES.samples)
    log(f"weighing {len(WEIGHED)} kernels at the shape classes of their driven launches "
        f"(sizes rounded up to powers of two; timed where a class holds >= {WEIGH_SHARE:g} of "
        f"its kernel's launches):")
    timed = {}
    for key in TL.classes_to_time(counts, WEIGH_SHARE):
        if key not in samples:
            log(f"  {key}: no call kept at this class (launched only inside a graph's capture)")
            continue
        sizes, fn, args, per_call = samples[key]
        first = time_ms(lambda: fn(*args), reps=3)
        ms = time_ms(lambda: fn(*args), reps=max(3, min(25, int(100.0 / max(first, 1e-3)))))
        nb, ops = shape_work(key[0], key[1], sizes, args)
        b_ms, by = bound(nb / per_call, ops / per_call)
        timed[key] = (ms / per_call, b_ms)
        log(f"  {key[0]} {key[1]} at {sizes} (class {list(key[2:])}): {ms / per_call:.5f} ms a "
            f"launch, bound {b_ms:.5f} ms by {by}")
    for mod in _kernel_modules():
        if hasattr(mod, "SHAPES"):
            mod.SHAPES.reset_samples()
            mod.SHAPES.sampling = False
    result = TL.weigh(counts, timed, WEIGH_SHARE)
    order = sorted(result, key=lambda k: -(result[k]["weight_ms"] or 0.0))
    for k in order:
        r = result[k]
        w = "not timed" if r["weight_ms"] is None else f"{r['weight_ms'] / 1e3:.4f} s"
        log(f"  {k}: {r['launches']} launches over {len(r['rows'])} shape classes, launches x "
            f"(ms - bound) = {w}")
    log("weighing: " + json.dumps({"card": nvidia_smi_line(), "order": order, "kernels": result}))
    return result


ALL_PHASES = ("ba", "sfm", "mapper", "matching", "matcher", "sift", "extractor", "dense", "mvs",
              "mesh_kernels", "mesh", "global_kernels", "global", "rig_kernels", "rig", "retrieval_kernels", "retrieval",
              "camera_kernels", "cameras", "solver_kernels", "options_kernels", "options",
              "tools_kernels", "orientation", "compat", "tools", "learned_kernels", "learned",
              "covariance", "sharded")


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

    for mod in _kernel_modules():  # keep a call at each launch shape for the weighing
        if hasattr(mod, "SHAPES"):
            mod.SHAPES.sampling = True
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
    for phase in ("mesh_kernels", "mesh"):
        if phase in phases and "dense" not in phases:
            raise SystemExit(f"chip_smoke: phase {phase} reads the dense phase's workspace")
    if "mesh_kernels" in phases:
        p_errs, p_rows = run("mesh_kernels", phase_mesh_kernels)
        errs.update(p_errs)
        rows.update(p_rows)
    if "mesh" in phases:
        run("mesh", lambda: phase_mesh(launches))
    if "root" in DENSE_STATE:
        shutil.rmtree(DENSE_STATE["root"], ignore_errors=True)
    if "global_kernels" in phases:
        g_errs, g_rows, _ = run("global_kernels", phase_global_kernels)
        errs.update(g_errs)
        rows.update(g_rows)
    if "global" in phases:
        run("global", lambda: phase_global(launches))
    extra = dict(entries={}, errs={})
    if "rig_kernels" in phases:
        r_errs, r_rows, r_agree, extra = run("rig_kernels", phase_rig_kernels)
        errs.update(r_errs)
        rows.update(r_rows)
        agree.update(r_agree)
    if "rig" in phases:
        run("rig", lambda: phase_rig(launches))
    if "retrieval_kernels" in phases:
        t_errs, t_rows = run("retrieval_kernels", phase_retrieval_kernels)
        errs.update(t_errs)
        rows.update(t_rows)
    if "retrieval" in phases:
        run("retrieval", lambda: phase_retrieval(launches, errs, rows))
    cam_entries = {}
    if "camera_kernels" in phases:
        c_errs, c_rows, c_agree, cam_entries = run("camera_kernels", phase_camera_kernels)
        for k, v in c_errs.items():
            errs.setdefault(k, []).extend(v)
        rows.update(c_rows)
        agree.update(c_agree)
    if "cameras" in phases:
        run("cameras", lambda: phase_cameras(launches))
    if "solver_kernels" in phases:
        l_errs, l_rows, l_agree = run("solver_kernels", phase_solver_kernels)
        errs.update(l_errs)
        rows.update(l_rows)
        agree.update(l_agree)
    opt_entries = {}
    if "options_kernels" in phases:
        o_errs, o_rows, o_agree, opt_entries = run("options_kernels", phase_options_kernels)
        for k, v in o_errs.items():
            errs.setdefault(k, []).extend(v)
        rows.update(o_rows)
        for k, v in o_agree.items():
            agree.setdefault(k, v)
    if "options" in phases:
        run("options", lambda: phase_options(launches))
    if "dir" in OPTIONS_STATE:
        shutil.rmtree(OPTIONS_STATE["dir"], ignore_errors=True)
    if "tools_kernels" in phases:
        k_errs, k_rows, k_agree = run("tools_kernels", phase_tools_kernels)
        errs.update(k_errs)
        rows.update(k_rows)
        agree.update(k_agree)
    for phase, fn in (("orientation", phase_orientation), ("compat", phase_compat),
                      ("tools", phase_tools)):
        if phase in phases:
            run(phase, lambda: fn(launches))
    if "learned_kernels" in phases:
        n_errs, n_rows = run("learned_kernels", phase_learned_kernels)
        errs.update(n_errs)
        rows.update(n_rows)
    if "learned" in phases:
        run("learned", lambda: phase_learned(launches))
    if "root" in LEARNED_STATE:
        shutil.rmtree(LEARNED_STATE["root"], ignore_errors=True)
    if "covariance" in phases:
        v_errs, v_rows, _ = run("covariance", lambda: phase_covariance(launches))
        errs.update(v_errs)
        rows.update(v_rows)
    if "sharded" in phases:
        run("sharded", lambda: phase_sharded(launches, errs))
    if PATH_SHAPES:
        run("weighing", phase_weighing)
    new = sum(seconds.get(k, 0.0) for k in ("covariance", "sharded"))
    log(f"seconds by phase: {seconds}; the covariance and sharded phases {new:.1f} s, the whole "
        f"script {time.perf_counter() - T_START:.1f} s")
    # Models 5-17 and mixed: the kernel's other inputs; K34's rig entries.
    for name, ents in (*cam_entries.items(), *extra["entries"].items(), *opt_entries.items()):
        if name in rows and ents:
            rows[name].setdefault("entries", {}).update(ents)
    for name, e in extra["errs"].items():
        errs.setdefault(name, []).extend(e)

    sources = {**BA_SOURCES, **SFM_SOURCES, **MATCH_SOURCES, **SIFT_SOURCES, **MVS_SOURCES,
               **MESH_SOURCES, **GLOBAL_SOURCES, **RIG_SOURCES, **RETRIEVAL_SOURCES, **CAMERA_SOURCES,
               **SOLVER_SOURCES, **OPTIONS_SOURCES, **TOOLS_SOURCES, **LEARNED_SOURCES,
               **COVARIANCE_SOURCES}
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
        kernels[-1].update(rows[name].get("extra", {}))
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
            f"({1e3 / v['warm_iter_per_s']:.3f} ms an iteration, idle share "
            f"{v.get('idle_share', float('nan')):.3f}, {v['host_reads']} host reads, graph "
            f"{v['record_ms']:.2f} + {v['instantiate_ms']:.2f} ms"
            + ("" if v["ridge_ms"] is None else f", ridge LU {v['ridge_ms']:.4f} ms") + "; final cost "
            f"{v['final_cost']:.6e} in {v['iters']} iterations, plain loop "
            f"{v['plain_cost']:.6e} in {v['plain_iters']})" for k, v in solves.items()))
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
