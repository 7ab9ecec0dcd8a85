"""Matching and two-view verification kernels: wrappers, plain versions, counts.

Three CUDA kernels carry the device programs of descriptor matching and
two-view verification (sources in ``colmap_tpu_torch/csrc``):

    K10 match_top2          match_top2 (plain and guided)
    K11 fundamental_ransac  fundamental_propose_score, fundamental_refit,
                            fundamental_inliers, fundamental_fit
    K12 homography_ransac   homography_propose_score, homography_refit,
                            homography_inliers

As in kernels/sfm.py, each wrapper runs the plain version when its tensors
lie on the CPU and launches the kernel when they lie on a CUDA device; on a
CUDA tensor it launches or raises. ``LAUNCHES`` counts kernel launches by
kernel name.

K10 takes a block of pairs: one table of the block's descriptor sets
(I, cap, 128) uint8 with the per-image counts (I,), and (B, 2) indices into
it. It returns, per pair, for each descriptor of image 1 the index of its
best match in image 2 and whether the match passes the distance, ratio and
cross checks (colmap_tpu's ``match_similarity``); with keypoints and one F
per pair, candidates must also lie within ``guided_max_error`` px of each
other's epipolar lines (``match_guided_similarity``).

K11 and K12 have K7's three entries (see kernels/sfm.py: one problem or a
block of B problems, the same packed best, the MSAC mode); K11's
``fundamental_fit`` is the weighted 8-point alone, on the rows of a given
mask.

    K46 degensac  degensac_propose_score

K46 builds DEGENSAC's plane-and-parallax hypotheses F_k = [e'_k]x H, one per
pair of off-plane rows (ia_k, ib_k), scores each on all N rows by K11's
squared epipolar line distance (0 where ia_k = ib_k or F_k is not finite)
and packs the first of largest support, as a propose-and-score entry does.
The recovery refits the best on K11's refit entry (estimators/degensac.py).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from colmap_tpu_torch.estimators.solvers.epipolar import (
    fundamental_eight_point,
    fundamental_from_plane_and_parallax,
    fundamental_seven_point,
    homography_dlt,
    homography_transfer_error,
)
from colmap_tpu_torch.geometry.essential import squared_epipolar_line_distance
from colmap_tpu_torch.kernels import sfm as S
from colmap_tpu_torch.optim.ransac import pack_best, score_models

LAUNCHES = {"match_top2": 0, "fundamental_ransac": 0, "homography_ransac": 0, "degensac": 0}

DESC_DIM = 128
F_SOLUTIONS = 3
H_SOLUTIONS = 1


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# Plain versions.
# ---------------------------------------------------------------------------


def normalize_descriptors(d, dtype=torch.float32):
    d = d.to(dtype)
    return d / torch.clamp(torch.linalg.vector_norm(d, dim=-1, keepdim=True), min=1e-12)


def best_two(sim):
    """(best, second best, argmax) per row of sim (N, M): the first index of
    the largest value, and the largest value over all other columns (so a
    duplicate of the best counts as second)."""
    idx = torch.argmax(sim, dim=1)  # the first of the maximal values
    best = torch.gather(sim, 1, idx[:, None])[:, 0]
    masked = sim.scatter(1, idx[:, None], -torch.inf)
    return best, masked.amax(dim=1), idx


def epipolar_ok(xy1, xy2, F, max_error):
    """(N, M) bool: both symmetric epipolar distances of (xy1[n], xy2[m])
    under F are at most ``max_error`` px."""
    p1 = torch.cat([xy1, torch.ones_like(xy1[:, :1])], dim=1)
    p2 = torch.cat([xy2, torch.ones_like(xy2[:, :1])], dim=1)
    Fx1 = p1 @ F.T  # lines in image 2
    Ftx2 = p2 @ F  # lines in image 1
    num = torch.abs(Fx1 @ p2.T)
    d_2 = num / torch.clamp(torch.sqrt(Fx1[:, 0] ** 2 + Fx1[:, 1] ** 2)[:, None], min=1e-12)
    d_1 = num / torch.clamp(torch.sqrt(Ftx2[:, 0] ** 2 + Ftx2[:, 1] ** 2)[None, :], min=1e-12)
    return (d_1 <= max_error) & (d_2 <= max_error)


def match_similarity_plain(d1, d2, mask1, mask2, options, geo_ok=None, dtype=torch.float32):
    """colmap_tpu's match_similarity on one pair: d1 (N, 128), d2 (M, 128)
    uint8, row masks; ``geo_ok`` (N, M) restricts the candidates (guided
    matching). Returns idx2 (N,) int64, ok (N,) bool, the decision margins
    (N,) (the smaller distance of a row's two arccos tests from their
    thresholds) and the best similarities (N,)."""
    sim = normalize_descriptors(d1, dtype) @ normalize_descriptors(d2, dtype).T
    keep = mask1[:, None] & mask2[None, :]
    if geo_ok is not None:
        keep = keep & geo_ok
    sim = torch.where(keep, sim, -torch.inf)
    best, second, idx2 = best_two(sim)
    dist_best = torch.arccos(torch.clamp(best, -1.0, 1.0))
    dist_second = torch.arccos(torch.clamp(second, -1.0, 1.0))
    ok = torch.isfinite(best)
    ok &= dist_best <= options.max_distance
    ok &= dist_best <= options.max_ratio * dist_second
    if options.cross_check:
        best_idx1 = torch.argmax(sim, dim=0)
        ok &= best_idx1[idx2] == torch.arange(sim.shape[0], device=sim.device)
    ok &= mask1
    margin = torch.minimum(torch.abs(dist_best - options.max_distance),
                           torch.abs(dist_best - options.max_ratio * dist_second))
    return idx2, ok, torch.nan_to_num(margin, nan=torch.inf), best


def match_top2_plain(desc, counts, pairs, options, keypoints=None, F=None, dtype=torch.float32,
                     details=False):
    """K10's function, pair by pair: desc (I, cap, 128) uint8, counts (I,),
    pairs (B, 2). Returns idx2 (B, cap) int32 and ok (B, cap) bool, and with
    ``details`` also the decision margins and the best similarities (B, cap)."""
    cap = desc.shape[1]
    rows = torch.arange(cap, device=desc.device)
    outs = []
    for b in range(pairs.shape[0]):
        i1, i2 = int(pairs[b, 0]), int(pairs[b, 1])
        m1, m2 = rows < counts[i1], rows < counts[i2]
        geo = None
        if F is not None:
            geo = epipolar_ok(keypoints[i1].to(dtype), keypoints[i2].to(dtype), F[b].to(dtype),
                              options.guided_max_error)
        outs.append(match_similarity_plain(desc[i1], desc[i2], m1, m2, options, geo, dtype))
    idx2 = torch.stack([o[0] for o in outs]).to(torch.int32)
    ok = torch.stack([o[1] for o in outs])
    if details:
        return idx2, ok, torch.stack([o[2] for o in outs]), torch.stack([o[3] for o in outs])
    return idx2, ok


def fundamental_propose_score_plain(x1, x2, mask, samples, max_sq, active=None, msac=False):
    """K11 propose-and-score: 7-point on each sample (3 slots per sample,
    NaN where a root is complex), squared epipolar line distance."""
    return S.two_view_propose_score_plain(fundamental_seven_point, squared_epipolar_line_distance,
                                          x1, x2, mask, samples, max_sq, active, msac)


def fundamental_inliers_plain(x1, x2, mask, model, max_sq):
    return S.two_view_inliers_plain(squared_epipolar_line_distance, x1, x2, mask, model, max_sq)


def fundamental_refit_plain(x1, x2, mask, model, max_sq, count, score=None):
    """K11 refit: weighted 8-point (rank 2 enforced) on the model's inliers."""
    return S.two_view_refit_plain(fundamental_eight_point, squared_epipolar_line_distance, x1, x2,
                                  mask, model, max_sq, count, score)


def fundamental_fit_plain(x1, x2, rows):
    """K11 fit only: the weighted 8-point on the rows of ``rows`` (.., N) bool."""
    return fundamental_eight_point(x1, x2, rows.to(x1.dtype))


def homography_propose_score_plain(x1, x2, mask, samples, max_sq, active=None, msac=False):
    """K12 propose-and-score: 4-point DLT on each sample, transfer error."""
    return S.two_view_propose_score_plain(
        lambda s1, s2: homography_dlt(s1, s2)[..., None, :, :], homography_transfer_error,
        x1, x2, mask, samples, max_sq, active, msac)


def homography_inliers_plain(x1, x2, mask, model, max_sq):
    return S.two_view_inliers_plain(homography_transfer_error, x1, x2, mask, model, max_sq)


def homography_refit_plain(x1, x2, mask, model, max_sq, count, score=None):
    """K12 refit: weighted N-point DLT on the model's inliers."""
    return S.two_view_refit_plain(homography_dlt, homography_transfer_error, x1, x2, mask, model,
                                  max_sq, count, score)


def degensac_propose_score_plain(x1, x2, mask, H, ia, ib, max_sq):
    """K46: the plane-and-parallax F of each pair of rows (ia, ib) (K,) and
    its support on the N rows. Returns models (K, 3, 3), counts (K,) and the
    packed best (1,)."""
    ia, ib = ia.long(), ib.long()
    Fs = fundamental_from_plane_and_parallax(H[None], x1[ia], x2[ia], x1[ib], x2[ib])
    res = squared_epipolar_line_distance(Fs[:, None], x1[None], x2[None])
    counts, _ = score_models(Fs, res, mask, max_sq, False)
    counts = torch.where(ia != ib, counts, 0)
    return Fs, counts, pack_best(counts)


# ---------------------------------------------------------------------------
# CUDA wrappers.
# ---------------------------------------------------------------------------

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_PROPOSE = [_I, _I, _I, _F] + [_P] * 9 + [_I, _P] + [_P]
_REFIT = [_I, _I, _F, _P, _I] + [_P] * 7 + [_I, _F, _P, _P] + [_P]
_INLIERS = [_I, _I, _F] + [_P] * 6 + [_P]
_SIGNATURES = {
    "match_top2_f32": [_I, _I, _I, _F] + [_P] * 9 + [_P],
    "match_finish_f32": [_I, _I, _I, _F, _F] + [_P] * 7 + [_P],
    "fundamental_propose_score_f32": _PROPOSE,
    "fundamental_refit_f32": _REFIT,
    "fundamental_inliers_f32": _INLIERS,
    "fundamental_fit_f32": [_I, _I] + [_P] * 4 + [_P],
    "homography_propose_score_f32": _PROPOSE,
    "homography_refit_f32": _REFIT,
    "homography_inliers_f32": _INLIERS,
    "degensac_propose_score_f32": [_I, _I, _F] + [_P] * 9 + [_P],
}


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


f32, i32, u8 = torch.float32, torch.int32, torch.bool


# K10 -----------------------------------------------------------------------


def match_top2(desc, counts, pairs, options, keypoints=None, F=None, details=False):
    """K10: best match, ratio, distance and cross checks for a block of pairs.

    desc (I, cap, 128) uint8; counts (I,) int32 valid rows per image; pairs
    (B, 2) int32 indices into the table. Guided matching: keypoints
    (I, cap, 2) float32 and F (B, 3, 3) float32. Returns idx2 (B, cap) int32
    and ok (B, cap) bool; rows beyond an image's count are not ok. With
    ``details`` also the best similarities (B, cap), defined on valid rows.
    """
    if desc.device.type == "cpu":
        out = match_top2_plain(desc, counts, pairs, options, keypoints, F, details=details)
        return (out[0], out[1], out[3]) if details else out
    dev = S._require_cuda(desc)
    n_img, cap = desc.shape[:2]
    b = pairs.shape[0]
    S._check("desc", desc, torch.uint8, (n_img, cap, DESC_DIM), dev)
    S._check("counts", counts, i32, (n_img,), dev)
    S._check("pairs", pairs, i32, (b, 2), dev)
    guided = F is not None
    if guided:
        S._check("keypoints", keypoints, f32, (n_img, cap, 2), dev)
        S._check("F", F, f32, (b, 3, 3), dev)
    idx2 = torch.zeros(b, cap, dtype=i32, device=dev)
    ok = torch.zeros(b, cap, dtype=u8, device=dev)
    if b == 0 or cap == 0:
        return (idx2, ok, torch.zeros(b, cap, dtype=f32, device=dev)) if details else (idx2, ok)
    best = torch.empty(b, cap, dtype=f32, device=dev)
    second = torch.empty(b, cap, dtype=f32, device=dev)
    # Per column of each pair, the packed (ordered similarity, 0xFFFFFFFF -
    # row) of its best row; 0 is below every packed value.
    col_best = torch.zeros(b, cap, dtype=torch.int64, device=dev)
    _call("match_top2_f32", b, cap, int(guided), float(options.guided_max_error),
          *map(S._ptr, (desc, counts, pairs)), S._opt_ptr(keypoints), S._opt_ptr(F),
          *map(S._ptr, (best, second, idx2, col_best)), S._stream(dev))
    LAUNCHES["match_top2"] += 1
    _call("match_finish_f32", b, cap, int(options.cross_check), float(options.max_distance),
          float(options.max_ratio), *map(S._ptr, (counts, pairs, best, second, idx2, col_best, ok)),
          S._stream(dev))
    LAUNCHES["match_top2"] += 1
    return (idx2, ok, best) if details else (idx2, ok)


# K11 -----------------------------------------------------------------------


def fundamental_propose_score(x1, x2, mask, samples, max_sq, active=None, msac=False):
    """K11 propose-and-score. x1, x2 (N, 2) pixels, mask (N,), samples (K, 7)
    int32, or a block of B problems. Returns models (.., 3K, 3, 3), counts
    (.., 3K), packed best (B,)."""
    if x1.device.type == "cpu":
        return fundamental_propose_score_plain(x1, x2, mask, samples, max_sq, active, msac)
    out = S.two_view_propose_score(_call, "fundamental", 7, F_SOLUTIONS, x1, x2, mask, samples,
                                   max_sq, active, msac=msac)
    LAUNCHES["fundamental_ransac"] += 1
    return out


def fundamental_refit(x1, x2, mask, model, max_sq, count, score=None):
    """K11 refit (``_try_refine`` of the F RANSAC). Returns (model, count)."""
    if x1.device.type == "cpu":
        return fundamental_refit_plain(x1, x2, mask, model, max_sq, count, score)
    out = S.two_view_refit(_call, "fundamental", x1, x2, mask, model, max_sq, count, score=score)
    LAUNCHES["fundamental_ransac"] += 1
    return out


def fundamental_inliers(x1, x2, mask, model, max_sq):
    """K11 inlier mask (.., N) of one fundamental matrix per problem."""
    if x1.device.type == "cpu":
        return fundamental_inliers_plain(x1, x2, mask, model, max_sq)
    out = S.two_view_inliers(_call, "fundamental", x1, x2, mask, model, max_sq)
    LAUNCHES["fundamental_ransac"] += 1
    return out


def fundamental_fit(x1, x2, rows):
    """K11 fit only: the 8-point fundamental matrix (.., 3, 3) of the rows
    marked in ``rows`` (.., N) bool (the F of a calibrated pair, fitted on
    the inliers of its essential matrix)."""
    if x1.device.type == "cpu":
        return fundamental_fit_plain(x1, x2, rows)
    dev, b, lead, n = S._check_two_view(x1, x2, rows)
    out = torch.empty(lead + (3, 3), dtype=f32, device=dev)
    _call("fundamental_fit_f32", b, n, *map(S._ptr, (x1, x2, rows, out)), S._stream(dev))
    LAUNCHES["fundamental_ransac"] += 1
    return out


# K12 -----------------------------------------------------------------------


def homography_propose_score(x1, x2, mask, samples, max_sq, active=None, msac=False):
    """K12 propose-and-score. x1, x2 (N, 2) pixels, mask (N,), samples (K, 4)
    int32, or a block of B problems. Returns models (.., K, 3, 3), counts
    (.., K), packed best (B,)."""
    if x1.device.type == "cpu":
        return homography_propose_score_plain(x1, x2, mask, samples, max_sq, active, msac)
    out = S.two_view_propose_score(_call, "homography", 4, H_SOLUTIONS, x1, x2, mask, samples,
                                   max_sq, active, msac=msac)
    LAUNCHES["homography_ransac"] += 1
    return out


def homography_refit(x1, x2, mask, model, max_sq, count, score=None):
    """K12 refit (``_try_refine`` of the H RANSAC). Returns (model, count)."""
    if x1.device.type == "cpu":
        return homography_refit_plain(x1, x2, mask, model, max_sq, count, score)
    out = S.two_view_refit(_call, "homography", x1, x2, mask, model, max_sq, count, score=score)
    LAUNCHES["homography_ransac"] += 1
    return out


def homography_inliers(x1, x2, mask, model, max_sq):
    """K12 inlier mask (.., N) of one homography per problem."""
    if x1.device.type == "cpu":
        return homography_inliers_plain(x1, x2, mask, model, max_sq)
    out = S.two_view_inliers(_call, "homography", x1, x2, mask, model, max_sq)
    LAUNCHES["homography_ransac"] += 1
    return out


# K46 -----------------------------------------------------------------------


def degensac_propose_score(x1, x2, mask, H, ia, ib, max_sq):
    """K46: one warp per hypothesis. x1, x2 (N, 2) pixels, mask (N,), H
    (3, 3), ia, ib (K,) int32 rows. Returns models (K, 3, 3), counts (K,),
    packed best (1,)."""
    if x1.device.type == "cpu":
        return degensac_propose_score_plain(x1, x2, mask, H, ia, ib, max_sq)
    dev, _, lead, n = S._check_two_view(x1, x2, mask)
    if lead:
        raise ValueError("K46 takes one problem: x1 (N, 2)")
    k = ia.shape[0]
    S._check("H", H, f32, (3, 3), dev)
    S._check("ia", ia, i32, (k,), dev)
    S._check("ib", ib, i32, (k,), dev)
    models = torch.empty(k, 3, 3, dtype=f32, device=dev)
    counts = torch.empty(k, dtype=i32, device=dev)
    best = torch.zeros(1, dtype=torch.int64, device=dev)
    if k:
        _call("degensac_propose_score_f32", n, k, float(max_sq),
              *map(S._ptr, (x1, x2, mask, H, ia, ib, models, counts, best)), S._stream(dev))
        LAUNCHES["degensac"] += 1
    return models, counts, best
