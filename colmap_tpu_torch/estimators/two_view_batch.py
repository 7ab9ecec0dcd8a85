"""Pair-block two-view verification: a block of pairs per kernel launch.

Counterpart of colmap_tpu/estimators/two_view_batch.py (the reference runs a
verifier thread pool over single pairs, controllers/feature_matching_utils.h:
50-133; colmap_tpu vmaps its E, F and H LO-RANSACs over a padded pair axis).
Here the three RANSACs of a block of up to 64 pairs advance in lockstep
(optim/ransac.py ``ransac_block``): each launch of K7, K11 or K12 spans
(pair, sample), and the host reads the block's packed bests once per batch.
Pairs of different match counts share a block through padding to the
block's largest count with a row mask. Only the configuration decision tree
(two_view_geometry.cc:57-118) runs per pair, on the host. A pair's result
does not depend on the block it is verified in: it equals
``estimate_two_view_geometry`` on that pair (tests/test_torch_matching.py).
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from colmap_tpu_torch.estimators.two_view_geometry import (
    TwoViewGeometryOptions,
    _ransac_e_block,
    _ransac_f_block,
    _ransac_h_block,
    classify,
    estimate_two_view_geometry,
    filter_stationary,
    finish_geometry,
    is_spherical,
    ransac_generators,
)
from colmap_tpu_torch.kernels import matching as KM
from colmap_tpu_torch.kernels import sfm as K
from colmap_tpu_torch.scene.types import Camera, TwoViewGeometry, TwoViewGeometryConfig
from colmap_tpu_torch.utils.dtypes import floatx, resolve_device


class _BlockResult(NamedTuple):
    """Numpy results of one block: models (B, 3, 3) float64, counts (B,),
    masks (B, M)."""

    F: np.ndarray
    H: np.ndarray
    E: np.ndarray
    F_from_E: np.ndarray
    num_f: np.ndarray
    num_h: np.ndarray
    num_e: np.ndarray
    num_fh: np.ndarray  # |F inliers ∩ H inliers| (the DEGENSAC trigger)
    mask_f: np.ndarray
    mask_h: np.ndarray
    mask_e: np.ndarray


def _verify_block(seed, coords, mask, thresh_n, calibrated, ransac_options) -> _BlockResult:
    """E, F and H estimation over a pair block.

    coords (B, M, 8) packed [x1 | x2 | x1n | x2n] and mask (B, M) on the
    device; thresh_n (B,) float64 normalized thresholds and calibrated (B,)
    bool on the host. E runs on the calibrated pairs only (the others get no
    valid row, which ends their RANSAC after its first batch).
    """
    x1, x2, x1n, x2n = (coords[..., i:i + 2].contiguous() for i in (0, 2, 4, 6))
    gen_f, gen_h, gen_e, _ = ransac_generators(seed)
    res_f = _ransac_f_block(gen_f, x1, x2, mask, ransac_options)
    res_h = _ransac_h_block(gen_h, x1, x2, mask, ransac_options)
    mask_e = mask & torch.from_numpy(np.asarray(calibrated)).to(mask.device)[:, None]
    res_e = _ransac_e_block(gen_e, x1n, x2n, mask_e, thresh_n, ransac_options)
    f_from_e = KM.fundamental_fit(x1, x2, res_e.inlier_mask)
    num_fh = (res_f.inlier_mask & res_h.inlier_mask).sum(-1)

    def host(x):
        return x.double().cpu().numpy() if x.is_floating_point() else x.cpu().numpy()

    return _BlockResult(
        F=host(res_f.model), H=host(res_h.model), E=host(res_e.model), F_from_E=host(f_from_e),
        num_f=res_f.num_inliers, num_h=res_h.num_inliers, num_e=res_e.num_inliers,
        num_fh=host(num_fh), mask_f=host(res_f.inlier_mask), mask_h=host(res_h.inlier_mask),
        mask_e=host(res_e.inlier_mask))


class _PairTask(NamedTuple):
    index: int  # position in the caller's pair list
    camera1: Camera
    camera2: Camera
    points1: np.ndarray
    points2: np.ndarray
    matches: np.ndarray  # after the stationary filter
    x1: np.ndarray  # (m, 2) matched pixel coordinates
    x2: np.ndarray
    x1n: np.ndarray  # normalized coordinates
    x2n: np.ndarray
    thresh_n: float
    calibrated: bool


def _classify_pair(task: _PairTask, block: _BlockResult, b: int,
                   options: TwoViewGeometryOptions, seed: int, device) -> TwoViewGeometry:
    """The host decision tree on the block's results for pair b."""
    m = len(task.matches)
    num_f = int(block.num_f[b])
    if options.use_degensac and num_f >= options.min_num_inliers:
        from colmap_tpu_torch.estimators.degensac import is_h_degenerate

        if is_h_degenerate(num_f, int(block.num_fh[b])):
            # Rare: recover F by plane and parallax on the per-pair path.
            return estimate_two_view_geometry(task.camera1, task.points1, task.camera2,
                                              task.points2, task.matches, options, seed=seed,
                                              device=device)
    g = TwoViewGeometry()
    best_mask = classify(
        g, options, task.calibrated, m, num_f, int(block.num_h[b]),
        int(block.num_e[b]) if task.calibrated else 0,
        block.mask_f[b, :m], block.mask_h[b, :m], block.mask_e[b, :m],
        block.F[b], block.H[b], block.E[b], block.F_from_E[b], task.camera1, task.camera2)
    if best_mask is None:
        return g
    return finish_geometry(g, options, best_mask, task.matches, task.x1, task.x2, task.camera1,
                           task.points1, task.camera2, task.points2, device)


def _normalize_keypoints(items, cache, device):
    """Fill ``cache`` {(id(points), camera_id): normalized (N, 2)} for every
    image of ``items`` with one K5 cam_from_img launch per camera model."""
    groups: Dict[int, list] = {}
    seen = set()
    for cam1, pts1, cam2, pts2, _ in items:
        for cam, pts in ((cam1, pts1), (cam2, pts2)):
            key = (id(pts), cam.camera_id)
            if key not in cache and key not in seen and not is_spherical(cam):
                seen.add(key)
                groups.setdefault(int(cam.model_id), []).append((key, cam, np.asarray(pts)[:, :2]))
    dt = floatx(device)
    for model_id, members in groups.items():
        pts = np.concatenate([p for _, _, p in members])
        if len(pts) == 0:
            uv = np.zeros((0, 2))
        else:
            params = np.concatenate([np.broadcast_to(np.asarray(cam.params, dtype=np.float64),
                                                     (len(p), len(cam.params)))
                                     for _, cam, p in members])
            uv, _ = K.cam_from_img(model_id, torch.as_tensor(params, dtype=dt).to(device),
                                   torch.as_tensor(pts, dtype=dt).to(device))
            uv = uv.double().cpu().numpy()
        start = 0
        for key, _, p in members:
            cache[key] = uv[start:start + len(p)]
            start += len(p)


def estimate_two_view_geometries_batched(
    items: Sequence[Tuple[Camera, np.ndarray, Camera, np.ndarray, np.ndarray]],
    options: Optional[TwoViewGeometryOptions] = None,
    seed: int = 0,
    max_block_pairs: int = 64,
    normalized_cache: Optional[Dict[tuple, np.ndarray]] = None,
    device=None,
) -> List[TwoViewGeometry]:
    """Verify many pairs in blocks of up to ``max_block_pairs`` on ``device``.

    items: (camera1, points1, camera2, points2, matches) per pair, as for
    estimate_two_view_geometry. normalized_cache lets callers keep the
    per-image normalized keypoints across calls.
    """
    if options is None:
        options = TwoViewGeometryOptions()
    device = resolve_device(device)
    out: List[Optional[TwoViewGeometry]] = [None] * len(items)
    if normalized_cache is None:
        normalized_cache = {}
    for cam1, _, cam2, _, _ in items:
        if is_spherical(cam1) or is_spherical(cam2):
            raise NotImplementedError(
                "two-view geometry of spherical cameras is not ported yet (ROADMAP queue 1)")
    _normalize_keypoints(items, normalized_cache, device)

    tasks: List[_PairTask] = []
    for i, (cam1, pts1, cam2, pts2, matches) in enumerate(items):
        matches = np.asarray(matches)
        if options.multiple_models:
            out[i] = estimate_two_view_geometry(cam1, pts1, cam2, pts2, matches, options,
                                                seed=seed, device=device)
            continue
        if options.filter_stationary_matches and len(matches) > 0:
            matches = filter_stationary(pts1, pts2, matches, options.stationary_matches_max_error)
        if len(matches) < options.min_num_inliers:
            out[i] = TwoViewGeometry(config=int(TwoViewGeometryConfig.DEGENERATE))
            continue
        thresh_n = 0.5 * (cam1.cam_from_img_threshold(options.ransac.max_error)
                          + cam2.cam_from_img_threshold(options.ransac.max_error))
        tasks.append(_PairTask(
            index=i, camera1=cam1, camera2=cam2, points1=pts1, points2=pts2, matches=matches,
            x1=np.asarray(pts1)[matches[:, 0]][:, :2].astype(np.float64),
            x2=np.asarray(pts2)[matches[:, 1]][:, :2].astype(np.float64),
            x1n=normalized_cache[(id(pts1), cam1.camera_id)][matches[:, 0]],
            x2n=normalized_cache[(id(pts2), cam2.camera_id)][matches[:, 1]],
            thresh_n=float(thresh_n),
            calibrated=bool(cam1.has_prior_focal_length and cam2.has_prior_focal_length)))

    # Blocks of similar match counts pad least.
    tasks.sort(key=lambda t: -len(t.matches))
    dt = floatx(device)
    for start in range(0, len(tasks), max_block_pairs):
        chunk = tasks[start:start + max_block_pairs]
        width = len(chunk[0].matches)
        coords = np.zeros((len(chunk), width, 8))
        mask = np.zeros((len(chunk), width), dtype=bool)
        for b, t in enumerate(chunk):
            m = len(t.matches)
            coords[b, :m] = np.concatenate([t.x1, t.x2, t.x1n, t.x2n], axis=1)
            mask[b, :m] = True
        block = _verify_block(
            seed, torch.as_tensor(coords, dtype=dt).to(device), torch.from_numpy(mask).to(device),
            np.asarray([t.thresh_n for t in chunk]), [t.calibrated for t in chunk],
            options.ransac)
        for b, t in enumerate(chunk):
            out[t.index] = _classify_pair(t, block, b, options, seed, device)
    return out  # type: ignore[return-value]
