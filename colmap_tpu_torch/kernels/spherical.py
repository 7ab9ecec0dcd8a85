"""Spherical two-view kernels: wrappers, plain PyTorch versions, launch counts.

Two CUDA kernels carry the ray-space RANSACs of spherical (360-degree)
pairs (sources in ``colmap_tpu_torch/csrc``):

    K32 spherical_e_ransac  spherical_e_propose_score, spherical_e_refit,
                            spherical_e_inliers
    K33 spherical_h_ransac  spherical_h_propose_score, spherical_h_refit,
                            spherical_h_inliers

They port colmap_tpu/estimators/spherical.py ``_ransac_e_rays`` (the 5-point
solve on rays, angular Sampson scoring, the unconditioned 8-point refit) and
``_ransac_h_rays`` (the 4-ray DLT, angular transfer scoring, the N-ray
refit). Each has K7's three entries and pair axis (see kernels/sfm.py): one
problem, rays x1, x2 (N, 3) and mask (N,), or a block of B problems (B, N,
3), with one squared angular threshold (rad²) for all or one per problem and
an optional ``active`` byte per problem. As the other kernel modules do,
each wrapper runs the plain version when its tensors lie on the CPU and
launches the kernel when they lie on a CUDA device, and never falls back.
``LAUNCHES`` counts kernel launches by kernel name.
"""

from __future__ import annotations

import ctypes
import functools

from colmap_tpu_torch.estimators.solvers.epipolar import (
    essential_eight_point_rays,
    essential_five_point_rays,
    homography_ray_dlt,
)
from colmap_tpu_torch.geometry.spherical import angular_sampson_error, homography_ray_angular_error
from colmap_tpu_torch.kernels import sfm as S

LAUNCHES = {"spherical_e_ransac": 0, "spherical_h_ransac": 0}

E_SOLUTIONS = 10
H_SOLUTIONS = 1
RAY_DIM = 3


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# Plain versions.
# ---------------------------------------------------------------------------


def spherical_e_propose_score_plain(r1, r2, mask, samples, max_sq, active=None, msac=False):
    """K32 propose-and-score: the 5-point solve on each sample of rays,
    angular Sampson scoring."""
    return S.two_view_propose_score_plain(essential_five_point_rays, angular_sampson_error, r1,
                                          r2, mask, samples, max_sq, active, msac)


def spherical_e_inliers_plain(r1, r2, mask, model, max_sq):
    return S.two_view_inliers_plain(angular_sampson_error, r1, r2, mask, model, max_sq)


def spherical_e_refit_plain(r1, r2, mask, model, max_sq, count, score=None):
    """K32 refit: the weighted 8-point on rays over the model's inliers."""
    return S.two_view_refit_plain(essential_eight_point_rays, angular_sampson_error, r1, r2, mask,
                                  model, max_sq, count, score)


def spherical_h_propose_score_plain(r1, r2, mask, samples, max_sq, active=None, msac=False):
    """K33 propose-and-score: the 4-ray DLT on each sample, angular
    transfer scoring."""
    def solve(s1, s2):
        return homography_ray_dlt(s1, s2)[..., None, :, :]

    return S.two_view_propose_score_plain(solve, homography_ray_angular_error, r1, r2, mask,
                                          samples, max_sq, active, msac)


def spherical_h_inliers_plain(r1, r2, mask, model, max_sq):
    return S.two_view_inliers_plain(homography_ray_angular_error, r1, r2, mask, model, max_sq)


def spherical_h_refit_plain(r1, r2, mask, model, max_sq, count, score=None):
    """K33 refit: the weighted N-ray DLT over the model's inliers."""
    return S.two_view_refit_plain(homography_ray_dlt, homography_ray_angular_error, r1, r2, mask,
                                  model, max_sq, count, score)


# ---------------------------------------------------------------------------
# CUDA wrappers.
# ---------------------------------------------------------------------------

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {}
for _name in ("spherical_e", "spherical_h"):
    _SIGNATURES[f"{_name}_propose_score_f32"] = [_I, _I, _I, _F] + [_P] * 9 + [_I, _P] + [_P]
    _SIGNATURES[f"{_name}_refit_f32"] = [_I, _I, _F, _P, _I] + [_P] * 7 + [_I, _F, _P, _P] + [_P]
    _SIGNATURES[f"{_name}_inliers_f32"] = [_I, _I, _F] + [_P] * 6 + [_P]


@functools.cache
def _lib():
    from colmap_tpu_torch.kernels.build import library

    lib = library()
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def _call(fn_name, *args):
    err = getattr(_lib(), fn_name)(*args)
    if err != 0:
        raise RuntimeError(f"{fn_name} failed to launch: CUDA error {err}")


def spherical_e_propose_score(r1, r2, mask, samples, max_sq, active=None, msac=False):
    """K32 propose-and-score. r1, r2 (N, 3) unit rays, mask (N,), samples
    (K, 5) int32, or a block of B problems. Returns models (.., 10K, 3, 3),
    counts (.., 10K), packed best (B,)."""
    if r1.device.type == "cpu":
        return spherical_e_propose_score_plain(r1, r2, mask, samples, max_sq, active, msac)
    out = S.two_view_propose_score(_call, "spherical_e", 5, E_SOLUTIONS, r1, r2, mask, samples,
                                   max_sq, active, dim=RAY_DIM, msac=msac)
    LAUNCHES["spherical_e_ransac"] += 1
    return out


def spherical_e_refit(r1, r2, mask, model, max_sq, count, score=None):
    """K32 refit (``_try_refine`` of the ray E RANSAC). Returns (model, count)."""
    if r1.device.type == "cpu":
        return spherical_e_refit_plain(r1, r2, mask, model, max_sq, count, score)
    out = S.two_view_refit(_call, "spherical_e", r1, r2, mask, model, max_sq, count, dim=RAY_DIM,
                           score=score)
    LAUNCHES["spherical_e_ransac"] += 1
    return out


def spherical_e_inliers(r1, r2, mask, model, max_sq):
    """K32 inlier mask (.., N) of one essential matrix per problem."""
    if r1.device.type == "cpu":
        return spherical_e_inliers_plain(r1, r2, mask, model, max_sq)
    out = S.two_view_inliers(_call, "spherical_e", r1, r2, mask, model, max_sq, dim=RAY_DIM)
    LAUNCHES["spherical_e_ransac"] += 1
    return out


def spherical_h_propose_score(r1, r2, mask, samples, max_sq, active=None, msac=False):
    """K33 propose-and-score. r1, r2 (N, 3) unit rays, mask (N,), samples
    (K, 4) int32, or a block of B problems. Returns models (.., K, 3, 3),
    counts (.., K), packed best (B,)."""
    if r1.device.type == "cpu":
        return spherical_h_propose_score_plain(r1, r2, mask, samples, max_sq, active, msac)
    out = S.two_view_propose_score(_call, "spherical_h", 4, H_SOLUTIONS, r1, r2, mask, samples,
                                   max_sq, active, dim=RAY_DIM, msac=msac)
    LAUNCHES["spherical_h_ransac"] += 1
    return out


def spherical_h_refit(r1, r2, mask, model, max_sq, count, score=None):
    """K33 refit (``_try_refine`` of the ray H RANSAC). Returns (model, count)."""
    if r1.device.type == "cpu":
        return spherical_h_refit_plain(r1, r2, mask, model, max_sq, count, score)
    out = S.two_view_refit(_call, "spherical_h", r1, r2, mask, model, max_sq, count, dim=RAY_DIM,
                           score=score)
    LAUNCHES["spherical_h_ransac"] += 1
    return out


def spherical_h_inliers(r1, r2, mask, model, max_sq):
    """K33 inlier mask (.., N) of one ray homography per problem."""
    if r1.device.type == "cpu":
        return spherical_h_inliers_plain(r1, r2, mask, model, max_sq)
    out = S.two_view_inliers(_call, "spherical_h", r1, r2, mask, model, max_sq, dim=RAY_DIM)
    LAUNCHES["spherical_h_ransac"] += 1
    return out
