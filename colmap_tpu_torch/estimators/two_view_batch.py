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

Spherical pairs (a camera without an image plane, EQUIRECTANGULAR) go into
blocks of their own: bearing rays from K5's ray mode, then the E and H
RANSACs on rays of K32 and K33 over the block (estimators/spherical.py)
with EstimateSphericalTwoViewGeometry's decision per pair; colmap_tpu sends
each of them to its one-pair path instead.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from colmap_tpu_torch.estimators import spherical as SPH
from colmap_tpu_torch.estimators.two_view_geometry import (
    TwoViewGeometryOptions,
    _ransac_e_block,
    _ransac_f_block,
    _ransac_h_block,
    classify,
    estimate_two_view_geometry,
    filter_stationary,
    finish_geometry,
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
    x1n: np.ndarray  # normalized coordinates (m, 2), or unit rays (m, 3) of a spherical pair
    x2n: np.ndarray
    thresh_n: float  # normalized threshold, or angular (rad) for a spherical pair
    calibrated: bool
    spherical: bool


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


def _is_spherical_pair(cam1, cam2) -> bool:
    return SPH.is_spherical(cam1) or SPH.is_spherical(cam2)


def _lift_key(pts, camera, spherical: bool) -> tuple:
    """The cache key of an image's lifted keypoints: (id(points), camera_id),
    with "ray" appended for the rays of the images of spherical pairs."""
    return (id(pts), camera.camera_id) + (("ray",) if spherical else ())


def _normalize_keypoints(items, cache, device, rays=False):
    """Fill ``cache`` with the normalized keypoints (N, 2) of every image of
    the pinhole pairs of ``items`` (K5 cam_from_img) or, with ``rays``, the
    unit bearing rays (N, 3) of every image of the spherical pairs (K5's ray
    mode); one launch per camera model."""
    groups: Dict[int, list] = {}
    seen = set()
    for cam1, pts1, cam2, pts2, _ in items:
        if _is_spherical_pair(cam1, cam2) != rays:
            continue
        for cam, pts in ((cam1, pts1), (cam2, pts2)):
            key = _lift_key(pts, cam, rays)
            if key not in cache and key not in seen:
                seen.add(key)
                groups.setdefault(int(cam.model_id), []).append((key, cam, np.asarray(pts)[:, :2]))
    dt = floatx(device)
    lift = K.cam_ray_from_img if rays else K.cam_from_img
    for model_id, members in groups.items():
        pts = np.concatenate([p for _, _, p in members])
        if len(pts) == 0:
            uv = np.zeros((0, 3 if rays else 2))
        else:
            params = np.concatenate([np.broadcast_to(np.asarray(cam.params, dtype=np.float64),
                                                     (len(p), len(cam.params)))
                                     for _, cam, p in members])
            uv, _ = lift(model_id, torch.as_tensor(params, dtype=dt).to(device),
                         torch.as_tensor(pts, dtype=dt).to(device))
            if rays:  # as estimators/spherical.py camera_rays
                uv = uv / torch.clamp(torch.linalg.vector_norm(uv, dim=-1, keepdim=True),
                                      min=1e-12)
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
    per-image normalized keypoints (and the rays of the images of
    spherical pairs) across calls.
    """
    if options is None:
        options = TwoViewGeometryOptions()
    device = resolve_device(device)
    out: List[Optional[TwoViewGeometry]] = [None] * len(items)
    if normalized_cache is None:
        normalized_cache = {}
    _normalize_keypoints(items, normalized_cache, device)
    _normalize_keypoints(items, normalized_cache, device, rays=True)

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
        spherical = _is_spherical_pair(cam1, cam2)
        if spherical:
            thresh_n = SPH.spherical_threshold(cam1, cam2, options.ransac.max_error)
        else:
            thresh_n = 0.5 * (cam1.cam_from_img_threshold(options.ransac.max_error)
                              + cam2.cam_from_img_threshold(options.ransac.max_error))
        tasks.append(_PairTask(
            index=i, camera1=cam1, camera2=cam2, points1=pts1, points2=pts2, matches=matches,
            x1=np.asarray(pts1)[matches[:, 0]][:, :2].astype(np.float64),
            x2=np.asarray(pts2)[matches[:, 1]][:, :2].astype(np.float64),
            x1n=normalized_cache[_lift_key(pts1, cam1, spherical)][matches[:, 0]],
            x2n=normalized_cache[_lift_key(pts2, cam2, spherical)][matches[:, 1]],
            thresh_n=float(thresh_n),
            calibrated=bool(cam1.has_prior_focal_length and cam2.has_prior_focal_length),
            spherical=spherical))

    # Blocks of one kind and of similar match counts pad least.
    tasks.sort(key=lambda t: (t.spherical, -len(t.matches)))
    dt = floatx(device)
    for kind in (False, True):
        kind_tasks = [t for t in tasks if t.spherical == kind]
        for start in range(0, len(kind_tasks), max_block_pairs):
            chunk = kind_tasks[start:start + max_block_pairs]
            width = len(chunk[0].matches)
            coords = np.zeros((len(chunk), width, 6 if kind else 8))
            mask = np.zeros((len(chunk), width), dtype=bool)
            for b, t in enumerate(chunk):
                m = len(t.matches)
                coords[b, :m] = np.concatenate(
                    [t.x1n, t.x2n] if kind else [t.x1, t.x2, t.x1n, t.x2n], axis=1)
                mask[b, :m] = True
            coords_d = torch.as_tensor(coords, dtype=dt).to(device)
            mask_d = torch.from_numpy(mask).to(device)
            thresh = np.asarray([t.thresh_n for t in chunk])
            if kind:
                geoms = _verify_spherical_block(seed, coords_d, mask_d, thresh, chunk, options,
                                                device)
                for t, g in zip(chunk, geoms):
                    out[t.index] = g
                continue
            block = _verify_block(seed, coords_d, mask_d, thresh, [t.calibrated for t in chunk],
                                  options.ransac)
            for b, t in enumerate(chunk):
                out[t.index] = _classify_pair(t, block, b, options, seed, device)
    return out  # type: ignore[return-value]


def _verify_spherical_block(seed, rays, mask, thresh, chunk, options, device):
    """E and H on the rays (B, M, 6) [r1 | r2] of a block of spherical pairs
    (K32, K33), then each pair's decision; returns their TwoViewGeometry."""
    r1, r2 = rays[..., :3].contiguous(), rays[..., 3:].contiguous()
    _, gen_h, gen_e, _ = ransac_generators(seed)
    res_e = SPH.ransac_e_rays_block(gen_e, r1, r2, mask, thresh, options.ransac)
    res_h = SPH.ransac_h_rays_block(gen_h, r1, r2, mask, thresh, options.ransac)
    E, H = res_e.model.double().cpu().numpy(), res_h.model.double().cpu().numpy()
    mask_e, mask_h = res_e.inlier_mask.cpu().numpy(), res_h.inlier_mask.cpu().numpy()
    out = []
    for b, t in enumerate(chunk):
        m = len(t.matches)
        g = TwoViewGeometry()
        best_mask = SPH.classify_spherical(g, options, m, int(res_e.num_inliers[b]),
                                           int(res_h.num_inliers[b]), mask_e[b, :m],
                                           mask_h[b, :m], E[b], H[b])
        if best_mask is not None:
            SPH.finish_spherical(g, options, best_mask, t.matches, t.camera1, t.points1,
                                 t.camera2, t.points2, device)
        out.append(g)
    return out
