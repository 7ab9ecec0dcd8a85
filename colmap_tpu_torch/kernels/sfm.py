"""Incremental-mapper kernels: wrappers, plain PyTorch versions, launch counts.

Five CUDA kernels carry the device programs of the incremental mapper
(sources in ``colmap_tpu_torch/csrc``):

    K5 camera_map          img_from_cam, cam_from_img, cam_ray_from_img
    K6 p3p_ransac          p3p_propose_score, p3p_refit, p3p_inliers
    K7 essential_ransac    essential_propose_score, essential_refit,
                           essential_inliers
    K8 triangulate_tracks  triangulate_tracks, triangulate_multi_view_tracks
    K9 filter_points       filter_points

Each wrapper runs the plain version when its tensors lie on the CPU and
launches the kernel when they lie on a CUDA device; on a CUDA tensor it
launches or raises, it never falls back. ``LAUNCHES`` counts kernel launches
by kernel name (a wrapper adds one where it launches, nowhere else). The
plain versions (``*_plain``) compute the same function from the port's torch
modules; they are what the CPU tests hold against colmap_tpu and what a check
on the card holds the kernels against.

RANSAC batches: the propose-and-score entries take the batch's sample
indices (K, m) int32, drawn by the caller, and return every model of the
batch (M = K x solutions per sample), its support (inlier count, 0 for a
non-finite model) and the packed best (``optim.ransac.pack_best``: support
in the high 32 bits, 0xFFFFFFFF - index in the low 32). The refit entries
are colmap_tpu's ``_try_refine``: refit on the inliers of the given model,
keep the refit if its support is larger; they return (model, support).

MSAC (``RansacOptions.support="m_estimator"``): the two-view entries (K7
here, K11 and K12 in kernels/matching.py, K32 and K33 in
kernels/spherical.py) take ``msac``: propose-and-score then also returns
each model's score, the sum over valid rows of max(max_sq - r, 0) (0 for a
non-finite model), and packs the first model of largest score
(``optim.ransac.pack_best_scores``); the refit takes the score to beat and
returns (model, count, score), kept where the refit's score is larger. With
the defaults the entries compute what they did before.

The pair axis: the two-view entries (K7 here, K11 and K12 in
kernels/matching.py) also take a block of B problems, x1, x2 (B, N, 2), mask
(B, N), samples (B, K, m), ``max_sq`` a float or a (B,) tensor, and an
optional ``active`` (B,) bool whose False problems the launch skips. One
launch spans (problem, sample); models, counts and bests gain a leading B,
and the refit takes and returns (B,) int32 counts on the device. A problem's
result in a block equals that of the one-problem entry.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from colmap_tpu_torch.estimators.solvers.epipolar import essential_eight_point, essential_five_point
from colmap_tpu_torch.estimators.solvers.p3p import kabsch, p3p
from colmap_tpu_torch.geometry import rotation as rot
from colmap_tpu_torch.geometry.essential import sampson_error
from colmap_tpu_torch.geometry.triangulation import triangulate_multi_view, triangulation_angle
from colmap_tpu_torch.optim.ransac import pack_best, pack_best_scores, score_models
from colmap_tpu_torch.sensor import models as camera_models

LAUNCHES = {
    "camera_map": 0,
    "p3p_ransac": 0,
    "essential_ransac": 0,
    "triangulate_tracks": 0,
    "filter_points": 0,
}

# Camera models that csrc/camera_models.cuh implements: all 18.
CUDA_MODELS = frozenset(range(18))
P3P_SOLUTIONS = 4
E_SOLUTIONS = 10
TRACK_VIEWS = 8  # views per track row of K8 (the triangulator's MAX_V)
FILTER_VIEWS = 32  # views per point of K9 (filter_points3D's max_views)


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# Plain versions.
# ---------------------------------------------------------------------------


def p3p_residuals(models, X, uv):
    """Squared reprojection errors (M, N) of [R | t] models (M, 3, 4) on
    world points X (N, 3) against normalized observations uv (N, 2); inf
    behind the camera (z < 1e-8)."""
    Xc = torch.einsum("mij,nj->mni", models[..., :3], X) + models[:, None, :, 3]
    z = Xc[..., 2]
    behind = z < 1e-8
    proj = Xc[..., :2] / torch.where(behind, 1.0, z)[..., None]
    err = ((proj - uv[None]) ** 2).sum(-1)
    return torch.where(behind, torch.inf, err)


def p3p_propose_score_plain(X, rays, uv, mask, samples, max_sq):
    """K6 propose-and-score: P3P on each sample, every pose scored on all rows."""
    Rs, ts = p3p(X[samples.long()], rays[samples.long()])
    models = torch.cat([Rs, ts[..., None]], dim=-1).reshape(-1, 3, 4)
    counts, _ = score_models(models, p3p_residuals(models, X, uv), mask, max_sq, False)
    return models, counts, pack_best(counts)


def p3p_inliers_plain(X, uv, mask, model, max_sq):
    return (p3p_residuals(model[None], X, uv)[0] <= max_sq) & mask


def p3p_refit_plain(X, uv, mask, model, max_sq, count):
    """K6 refit: weighted Kabsch of X onto the observed rays at the model's
    depths (colmap_tpu's EPnP-lite LO step)."""
    w = p3p_inliers_plain(X, uv, mask, model, max_sq).to(X.dtype)
    Xc = X @ model[:, :3].T + model[:, 3]
    depth = torch.clamp(Xc[:, 2], min=1e-6)
    target = torch.cat([uv, torch.ones_like(uv[:, :1])], dim=-1) * depth[:, None]
    R, t = kabsch(X, target, w)
    refined = torch.cat([R, t[:, None]], dim=1)
    if not bool(torch.isfinite(refined).all()):
        return model, count
    count_r = int(p3p_inliers_plain(X, uv, mask, refined, max_sq).sum())
    return (refined, count_r) if count_r > count else (model, count)


def _threshold(max_sq, ndim):
    """A float threshold, or a (B,) tensor of them shaped to broadcast
    against ``ndim`` dimensions."""
    return max_sq.reshape((-1,) + (1,) * (ndim - 1)) if torch.is_tensor(max_sq) else max_sq


def two_view_propose_score_plain(solve, residual, x1, x2, mask, samples, max_sq, active=None,
                                 msac=False):
    """Propose-and-score of a two-view model family, one problem or a block:
    ``solve`` maps samples (.., m, 2) x 2 to models (.., S, 3, 3) and
    ``residual`` (models, x1, x2) broadcasts to squared errors. Problems
    whose ``active`` is False get zero counts (and scores) and a zero best.
    With ``msac`` also returns the scores (.., M)."""
    if x1.dim() == 2:
        out = two_view_propose_score_plain(
            solve, residual, x1[None], x2[None], mask[None], samples[None], max_sq, msac=msac)
        return tuple(o if i == 2 else o[0] for i, o in enumerate(out))
    B = x1.shape[0]
    s = samples.long()
    rows = torch.arange(B, device=x1.device)[:, None, None]
    models = solve(x1[rows, s], x2[rows, s]).reshape(B, -1, 3, 3)
    res = residual(models[:, :, None], x1[:, None], x2[:, None])  # (B, M, N)
    counts, scores = score_models(models, res, mask, _threshold(max_sq, 3), msac)
    best = pack_best_scores(scores) if msac else pack_best(counts)
    if active is not None:
        counts = torch.where(active[:, None], counts, 0)
        scores = torch.where(active[:, None], scores, 0)
        best = torch.where(active, best, 0)
    return (models, counts, best, scores) if msac else (models, counts, best)


def two_view_inliers_plain(residual, x1, x2, mask, model, max_sq):
    """Inlier mask (.., N) of one model per problem."""
    if x1.dim() == 2:
        return (residual(model, x1, x2) <= max_sq) & mask
    return (residual(model[:, None], x1, x2) <= _threshold(max_sq, 2)) & mask


def two_view_refit_plain(fit, residual, x1, x2, mask, model, max_sq, count, score=None):
    """``_try_refine``: ``fit`` (x1, x2, weights) on the model's inliers,
    kept where it is finite and its support is larger. One problem: count an
    int, returns (model, int); a block: (B,) int32 counts, returns tensors.
    With an MSAC ``score`` (a float, or (B,)) the refit is kept where its
    score is larger, and (model, count, score) come back."""
    if x1.dim() == 2:
        out = two_view_refit_plain(
            fit, residual, x1[None], x2[None], mask[None], model[None], max_sq,
            torch.tensor([count], dtype=torch.int32, device=x1.device),
            None if score is None else torch.tensor([score], dtype=x1.dtype, device=x1.device))
        return (out[0][0], int(out[1][0])) + (() if score is None else (float(out[2][0]),))
    inl = two_view_inliers_plain(residual, x1, x2, mask, model, max_sq)
    refined = fit(x1, x2, inl.to(x1.dtype))
    res = residual(refined[:, None], x1, x2)  # (B, N)
    count_r, score_r = score_models(refined[:, None], res[:, None], mask, _threshold(max_sq, 3),
                                    score is not None)
    count_r, score_r = count_r[:, 0], score_r[:, 0]
    if score is None:
        take = count_r > count
    else:
        take = score_r > score
    take &= torch.isfinite(refined.flatten(1)).all(-1)
    out = (torch.where(take[:, None, None], refined, model),
           torch.where(take, count_r, count).to(torch.int32))
    return out if score is None else out + (torch.where(take, score_r, score.to(score_r.dtype)),)


def essential_propose_score_plain(x1, x2, mask, samples, max_sq, active=None, msac=False):
    """K7 propose-and-score: 5-point on each sample, Sampson scoring."""
    return two_view_propose_score_plain(essential_five_point, sampson_error, x1, x2, mask,
                                        samples, max_sq, active, msac)


def essential_inliers_plain(x1, x2, mask, model, max_sq):
    return two_view_inliers_plain(sampson_error, x1, x2, mask, model, max_sq)


def essential_refit_plain(x1, x2, mask, model, max_sq, count, score=None):
    """K7 refit: weighted 8-point on the model's inliers."""
    return two_view_refit_plain(essential_eight_point, sampson_error, x1, x2, mask, model, max_sq,
                                count, score)


def _angular_errors(X, R, t, x):
    """Angle between observed and estimated rays per view; π behind the
    camera. X (..., 3); R (..., V, 3, 3); t, x (..., V, 3/2)."""
    Xc = torch.einsum("...vij,...j->...vi", R, X) + t
    ray_obs = camera_models.ray_from_plane(x)
    ray_est = Xc / torch.clamp(torch.linalg.vector_norm(Xc, dim=-1, keepdim=True), min=1e-12)
    ang = torch.arccos(torch.clamp((ray_obs * ray_est).sum(-1), -1.0, 1.0))
    return torch.where(Xc[..., 2] > 0, ang, torch.pi)


def triangulate_tracks_plain(R, t, x, mask, min_angle, max_err):
    """K8: colmap_tpu's estimate_triangulation on a batch of tracks.

    R (B, V, 3, 3), t (B, V, 3) cam_from_world; x (B, V, 2) normalized
    observations; mask (B, V). min_angle / max_err in radians. Returns xyz
    (B, 3), inlier mask (B, V), success (B,).
    """
    B, V = x.shape[:2]
    P = torch.cat([R, t[..., None]], dim=-1)
    C = -torch.einsum("bvji,bvj->bvi", R, t)
    ii, jj = torch.meshgrid(torch.arange(V), torch.arange(V), indexing="ij")
    ii, jj = ii.reshape(-1).to(x.device), jj.reshape(-1).to(x.device)
    pair_ok = (ii < jj) & mask[:, ii] & mask[:, jj]
    x1, x2, P1, P2 = x[:, ii], x[:, jj], P[:, ii], P[:, jj]
    A = torch.stack([x1[..., 0, None] * P1[..., 2, :] - P1[..., 0, :],
                     x1[..., 1, None] * P1[..., 2, :] - P1[..., 1, :],
                     x2[..., 0, None] * P2[..., 2, :] - P2[..., 0, :],
                     x2[..., 1, None] * P2[..., 2, :] - P2[..., 1, :]], dim=-2)
    Xh = torch.linalg.svd(A)[2][..., 3, :]
    w = Xh[..., 3]
    Xs = Xh[..., :3] / torch.where(torch.abs(w) < 1e-12, 1.0, w)[..., None]  # (B, V*V, 3)
    pair_ok &= triangulation_angle(C[:, ii], C[:, jj], Xs) >= min_angle
    errs = _angular_errors(Xs, R[:, None], t[:, None], x[:, None])  # (B, V*V, V)
    support = ((errs <= max_err) & mask[:, None, :]).sum(-1)
    support = torch.where(pair_ok & torch.isfinite(Xs).all(-1), support, 0)
    best = torch.argmax(support, dim=-1)
    b = torch.arange(B, device=x.device)
    X_best = Xs[b, best]
    inl = (errs[b, best] <= max_err) & mask
    X_ref = triangulate_multi_view(P, x, inl)
    inl_ref = (_angular_errors(X_ref, R, t, x) <= max_err) & mask
    take = (inl_ref.sum(-1) >= inl.sum(-1)) & torch.isfinite(X_ref).all(-1)
    xyz = torch.where(take[:, None], X_ref, X_best)
    inl_out = torch.where(take[:, None], inl_ref, inl)
    success = (inl_out.sum(-1) >= 2) & (support[b, best] >= 2)
    return xyz, inl_out, success


def triangulate_multi_view_tracks_plain(R, t, x, mask):
    """K8 without RANSAC: colmap_tpu's triangulate_multi_view of each track
    over its valid views. Returns xyz (B, 3)."""
    return triangulate_multi_view(torch.cat([R, t[..., None]], dim=-1), x, mask)


def filter_points_plain(model_id, quat, t, cam_params, xyz, obs_xy, valid):
    """K9: colmap_tpu's _filter_kernel.

    quat/t (P, V, 4/3) cam_from_world per observation; cam_params (P, V, K),
    or for a tuple of models the padded rows with their model-position
    column (through img_from_cam_switch);
    xyz (P, 3); obs_xy (P, V, 2); valid (P, V). Returns (errors (P, V) px,
    inf where the projection is invalid and 0 on padding; depths (P, V);
    min_cos (P,), the smallest |cos| between the viewing rays of two valid
    views, 1 when there is no such pair).
    """
    Xc = rot.quat_rotate(quat, xyz[:, None, :]) + t
    depth = Xc[..., 2]
    if isinstance(model_id, tuple):
        proj, ok = camera_models.img_from_cam_switch(
            model_id, torch.round(cam_params[..., -1]).long(), cam_params[..., :-1], Xc)
    else:
        proj, ok = camera_models.img_from_cam(model_id, cam_params, Xc)
    err = torch.linalg.vector_norm(proj - obs_xy, dim=-1)
    err = torch.where(ok & valid, err, torch.inf)
    err = torch.where(valid, err, 0.0)
    centers = -rot.quat_rotate(rot.quat_conjugate(rot.quat_normalize(quat)), t)
    rays = xyz[:, None, :] - centers
    rays = rays / torch.clamp(torch.linalg.vector_norm(rays, dim=-1, keepdim=True), min=1e-30)
    cos_pair = torch.einsum("pvi,pwi->pvw", rays, rays)
    V = valid.shape[1]
    eye = torch.eye(V, dtype=torch.bool, device=valid.device)[None]
    pair_valid = valid[:, :, None] & valid[:, None, :] & ~eye
    cos_pair = torch.where(pair_valid, torch.abs(cos_pair), 1.0)
    return err, depth, cos_pair.reshape(cos_pair.shape[0], -1).amin(-1)


# ---------------------------------------------------------------------------
# CUDA wrappers.
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_F = ctypes.c_float

# Argument types of the C entries: scalars first, then tensor pointers in the
# order the wrappers pass them, then the stream.
_SIGNATURES = {
    "camera_map_f32": [_I, _I, _LL, _I] + [_P] * 4 + [_P],
    "p3p_propose_score_f32": [_I, _I, _F] + [_P] * 8 + [_P],
    "p3p_refit_f32": [_I, _F, _I] + [_P] * 6 + [_P],
    "p3p_inliers_f32": [_I, _F] + [_P] * 5 + [_P],
    "essential_propose_score_f32": [_I, _I, _I, _F] + [_P] * 9 + [_I, _P] + [_P],
    "essential_refit_f32": [_I, _I, _F, _P, _I] + [_P] * 7 + [_I, _F, _P, _P] + [_P],
    "essential_inliers_f32": [_I, _I, _F] + [_P] * 6 + [_P],
    "triangulate_tracks_f32": [_I, _I, _F, _F] + [_P] * 7 + [_P],
    "filter_points_f32": [_I, _I, _I, _I, _I] + [_P] * 10 + [_P],
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


def _ptr(x):
    return _P(x.data_ptr())


def _stream(device):
    return _P(torch.cuda.current_stream(device).cuda_stream)


def _check(name, x, dtype, shape, device):
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise TypeError(f"{name} has dtype {x.dtype}; the CUDA kernel takes {dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected {tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _call(fn_name, *args):
    err = getattr(_lib(), fn_name)(*args)
    if err != 0:
        raise RuntimeError(f"{fn_name} failed to launch: CUDA error {err}")


def _require_cuda(x):
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    return x.device


def _check_model(model_id):
    for m in model_id if isinstance(model_id, tuple) else (model_id,):
        if int(m) not in CUDA_MODELS:
            raise ValueError(f"no camera model with id {m}")


f32, i32, u8 = torch.float32, torch.int32, torch.bool


# K5 ------------------------------------------------------------------------


def _camera_map(mode, model_id, params, pts, d_in, d_out=2):
    dev = _require_cuda(pts)
    _check_model(model_id)
    n_par = camera_models.model_num_params(model_id)
    batch = pts.shape[:-1]
    flat = pts.reshape(-1, d_in).contiguous()
    n = flat.shape[0]
    if params.dim() == 1:
        stride, prm = 0, params.contiguous()
        _check("params", prm, f32, (n_par,), dev)
    else:
        stride = n_par
        prm = torch.broadcast_to(params, batch + (n_par,)).reshape(-1, n_par).contiguous()
        _check("params", prm, f32, (n, n_par), dev)
    _check("points", flat, f32, (n, d_in), dev)
    out = torch.empty(n, d_out, dtype=f32, device=dev)
    valid = torch.empty(n, dtype=u8, device=dev)
    if n:
        _call("camera_map_f32", int(model_id), mode, n, stride,
              *map(_ptr, (prm, flat, out, valid)), _stream(dev))
        LAUNCHES["camera_map"] += 1
    return out.reshape(batch + (d_out,)), valid.reshape(batch)


def img_from_cam(model_id, params, uvw):
    """K5 project mode: camera-frame points (..., 3) -> pixels (..., 2) and
    img_from_cam's validity (the cheirality test and the model's own).
    params (P,) or (..., P) per row."""
    if uvw.device.type == "cpu":
        return camera_models.img_from_cam(model_id, params, uvw)
    return _camera_map(0, model_id, params, uvw, 3)


def cam_from_img(model_id, params, xy):
    """K5 unproject mode: pixels (..., 2) -> the z = 1 plane (..., 2) and
    cam_from_img's validity: the closed forms where the model has one, else
    _newton_undistort's 25 trust-region Newton steps."""
    if xy.device.type == "cpu":
        return camera_models.cam_from_img(model_id, params, xy)
    return _camera_map(1, model_id, params, xy, 2)


def cam_ray_from_img(model_id, params, xy):
    """K5 ray mode: pixels (..., 2) -> unit bearings (..., 3) and their
    validity; EQUIRECTANGULAR's closed form, the normalized z = 1 lift for
    the other models."""
    if xy.device.type == "cpu":
        return camera_models.cam_ray_from_img(model_id, params, xy)
    return _camera_map(2, model_id, params, xy, 2, 3)


# K6 ------------------------------------------------------------------------


def _check_rows(dev, n, **tensors):
    for name, (x, width) in tensors.items():
        shape = (n,) if width is None else (n, width)
        _check(name, x, u8 if width is None else f32, shape, dev)


def p3p_propose_score(X, rays, uv, mask, samples, max_sq):
    """K6 propose-and-score. X, rays (N, 3), uv (N, 2), mask (N,), samples
    (K, 3) int32. Returns models (4K, 3, 4), counts (4K,), packed best (1,)."""
    if X.device.type == "cpu":
        return p3p_propose_score_plain(X, rays, uv, mask, samples, max_sq)
    dev = _require_cuda(X)
    n, k = X.shape[0], samples.shape[0]
    _check_rows(dev, n, X=(X, 3), rays=(rays, 3), uv=(uv, 2), mask=(mask, None))
    _check("samples", samples, i32, (k, 3), dev)
    models = torch.empty(k * P3P_SOLUTIONS, 3, 4, dtype=f32, device=dev)
    counts = torch.empty(k * P3P_SOLUTIONS, dtype=i32, device=dev)
    best = torch.zeros(1, dtype=torch.int64, device=dev)
    _call("p3p_propose_score_f32", n, k, float(max_sq),
          *map(_ptr, (X, rays, uv, mask, samples, models, counts, best)), _stream(dev))
    LAUNCHES["p3p_ransac"] += 1
    return models, counts, best


def p3p_refit(X, uv, mask, model, max_sq, count):
    """K6 refit (``_try_refine`` of the P3P RANSAC). Returns (model, count)."""
    if X.device.type == "cpu":
        return p3p_refit_plain(X, uv, mask, model, max_sq, count)
    dev = _require_cuda(X)
    n = X.shape[0]
    _check_rows(dev, n, X=(X, 3), uv=(uv, 2), mask=(mask, None))
    model = model.contiguous()
    _check("model", model, f32, (3, 4), dev)
    out = torch.empty(3, 4, dtype=f32, device=dev)
    out_count = torch.empty(1, dtype=i32, device=dev)
    _call("p3p_refit_f32", n, float(max_sq), int(count),
          *map(_ptr, (X, uv, mask, model, out, out_count)), _stream(dev))
    LAUNCHES["p3p_ransac"] += 1
    return out, int(out_count.item())


def p3p_inliers(X, uv, mask, model, max_sq):
    """K6 inlier mask (N,) of one [R | t] model."""
    if X.device.type == "cpu":
        return p3p_inliers_plain(X, uv, mask, model, max_sq)
    dev = _require_cuda(X)
    n = X.shape[0]
    _check_rows(dev, n, X=(X, 3), uv=(uv, 2), mask=(mask, None))
    model = model.contiguous()
    _check("model", model, f32, (3, 4), dev)
    inl = torch.empty(n, dtype=u8, device=dev)
    _call("p3p_inliers_f32", n, float(max_sq), *map(_ptr, (X, uv, mask, model, inl)),
          _stream(dev))
    LAUNCHES["p3p_ransac"] += 1
    return inl


# K7 (and the shape K11 and K12 share with it) ------------------------------


def _opt_ptr(x):
    return None if x is None else _ptr(x)


def _max_sq_args(max_sq, b, dev):
    """(scalar, pointer) of a threshold given as a float or a (B,) tensor."""
    if torch.is_tensor(max_sq):
        _check("max_sq", max_sq, f32, (b,), dev)
        return 0.0, _ptr(max_sq)
    return float(max_sq), None


def _check_two_view(x1, x2, mask, dim=2):
    """Device, problem count and leading shape of one problem (N, dim) or a
    block (B, N, dim); dim is 2 for image points, 3 for bearing rays."""
    dev = _require_cuda(x1)
    lead = tuple(x1.shape[:-2])
    if len(lead) > 1:
        raise ValueError(f"x1 has shape {tuple(x1.shape)}, expected (N, {dim}) or (B, N, {dim})")
    n = x1.shape[-2]
    _check("x1", x1, f32, lead + (n, dim), dev)
    _check("x2", x2, f32, lead + (n, dim), dev)
    _check("mask", mask, u8, lead + (n,), dev)
    return dev, (lead[0] if lead else 1), lead, n


def two_view_propose_score(call, name, m, solutions, x1, x2, mask, samples, max_sq, active,
                           dim=2, msac=False):
    """Launch ``<name>_propose_score_f32``: samples (K, m) or (B, K, m) int32.
    Returns models (.., K * solutions, 3, 3), counts (.., K * solutions),
    packed best (B,) int64, and with ``msac`` the scores (.., K * solutions)."""
    dev, b, lead, n = _check_two_view(x1, x2, mask, dim)
    k = samples.shape[-2]
    _check("samples", samples, i32, lead + (k, m), dev)
    if active is not None:
        _check("active", active, u8, (b,), dev)
    sq, sq_ptr = _max_sq_args(max_sq, b, dev)
    models = torch.empty(lead + (k * solutions, 3, 3), dtype=f32, device=dev)
    counts = torch.empty(lead + (k * solutions,), dtype=i32, device=dev)
    scores = torch.empty(lead + (k * solutions,), dtype=f32, device=dev) if msac else None
    best = torch.zeros(b, dtype=torch.int64, device=dev)
    call(f"{name}_propose_score_f32", b, n, k, sq, sq_ptr,
         *map(_ptr, (x1, x2, mask, samples)), _opt_ptr(active),
         *map(_ptr, (models, counts, best)), int(msac), _opt_ptr(scores), _stream(dev))
    return (models, counts, best, scores) if msac else (models, counts, best)


def two_view_refit(call, name, x1, x2, mask, model, max_sq, count, dim=2, score=None):
    """Launch ``<name>_refit_f32``. One problem: count an int, returns
    (model, int); a block: count (B,) int32 on the device, returns tensors.
    With an MSAC ``score`` (a float, or (B,) float32 on the device) the
    refit is kept where its score is larger and the score comes back too."""
    dev, b, lead, n = _check_two_view(x1, x2, mask, dim)
    model = model.contiguous()
    _check("model", model, f32, lead + (3, 3), dev)
    sq, sq_ptr = _max_sq_args(max_sq, b, dev)
    out = torch.empty(lead + (3, 3), dtype=f32, device=dev)
    out_count = torch.empty(b, dtype=i32, device=dev)
    out_score = torch.empty(b, dtype=f32, device=dev) if score is not None else None
    if lead:
        _check("count", count, i32, (b,), dev)
        scalar, count_ptr = 0, _ptr(count)
    else:
        scalar, count_ptr = int(count), None
    score_scalar, score_ptr = 0.0, None
    if score is not None:
        if lead:
            _check("score", score, f32, (b,), dev)
            score_ptr = _ptr(score)
        else:
            score_scalar = float(score)
    call(f"{name}_refit_f32", b, n, sq, sq_ptr, scalar, count_ptr,
         *map(_ptr, (x1, x2, mask, model, out, out_count)), int(score is not None),
         score_scalar, score_ptr, _opt_ptr(out_score), _stream(dev))
    if lead:
        return (out, out_count) + (() if score is None else (out_score,))
    if score is None:
        return out, int(out_count.item())
    h = torch.stack([out_count.double(), out_score.double()]).cpu()  # one read
    return out, int(h[0, 0]), float(h[1, 0])


def two_view_inliers(call, name, x1, x2, mask, model, max_sq, dim=2):
    """Launch ``<name>_inliers_f32``: the inlier mask (.., N) of one model per problem."""
    dev, b, lead, n = _check_two_view(x1, x2, mask, dim)
    model = model.contiguous()
    _check("model", model, f32, lead + (3, 3), dev)
    sq, sq_ptr = _max_sq_args(max_sq, b, dev)
    inl = torch.empty(lead + (n,), dtype=u8, device=dev)
    call(f"{name}_inliers_f32", b, n, sq, sq_ptr, *map(_ptr, (x1, x2, mask, model, inl)),
         _stream(dev))
    return inl


def essential_propose_score(x1, x2, mask, samples, max_sq, active=None, msac=False):
    """K7 propose-and-score. x1, x2 (N, 2), mask (N,), samples (K, 5) int32,
    or a block of B problems. Returns models (.., 10K, 3, 3), counts
    (.., 10K), packed best (B,), and with ``msac`` the scores (.., 10K)."""
    if x1.device.type == "cpu":
        return essential_propose_score_plain(x1, x2, mask, samples, max_sq, active, msac)
    out = two_view_propose_score(_call, "essential", 5, E_SOLUTIONS, x1, x2, mask, samples,
                                 max_sq, active, msac=msac)
    LAUNCHES["essential_ransac"] += 1
    return out


def essential_refit(x1, x2, mask, model, max_sq, count, score=None):
    """K7 refit (``_try_refine`` of the essential RANSAC). Returns (model,
    count), and the score with an MSAC ``score``."""
    if x1.device.type == "cpu":
        return essential_refit_plain(x1, x2, mask, model, max_sq, count, score)
    out = two_view_refit(_call, "essential", x1, x2, mask, model, max_sq, count, score=score)
    LAUNCHES["essential_ransac"] += 1
    return out


def essential_inliers(x1, x2, mask, model, max_sq):
    """K7 inlier mask (.., N) of one essential matrix per problem."""
    if x1.device.type == "cpu":
        return essential_inliers_plain(x1, x2, mask, model, max_sq)
    out = two_view_inliers(_call, "essential", x1, x2, mask, model, max_sq)
    LAUNCHES["essential_ransac"] += 1
    return out


# K8 ------------------------------------------------------------------------


def triangulate_tracks(R, t, x, mask, min_angle, max_err):
    """K8: robust triangulation of B tracks of V = 8 views. See
    triangulate_tracks_plain."""
    if x.device.type == "cpu":
        return triangulate_tracks_plain(R, t, x, mask, min_angle, max_err)
    return _triangulate_tracks(True, R, t, x, mask, min_angle, max_err)


def triangulate_multi_view_tracks(R, t, x, mask):
    """K8 without RANSAC: the N-view triangulation of each of B tracks of
    V = 8 views over its valid views. See triangulate_multi_view_tracks_plain."""
    if x.device.type == "cpu":
        return triangulate_multi_view_tracks_plain(R, t, x, mask)
    return _triangulate_tracks(False, R, t, x, mask, 0.0, 0.0)[0]


def _triangulate_tracks(robust, R, t, x, mask, min_angle, max_err):
    dev = _require_cuda(x)
    B, V = x.shape[:2]
    if V != TRACK_VIEWS:
        raise ValueError(f"K8 takes tracks of {TRACK_VIEWS} view slots, got {V}")
    for name, a, dt, shape in (("R", R, f32, (B, V, 3, 3)), ("t", t, f32, (B, V, 3)),
                               ("x", x, f32, (B, V, 2)), ("mask", mask, u8, (B, V))):
        _check(name, a, dt, shape, dev)
    xyz = torch.empty(B, 3, dtype=f32, device=dev)
    inl = torch.empty(B, V, dtype=u8, device=dev)
    success = torch.empty(B, dtype=u8, device=dev)
    if B:
        _call("triangulate_tracks_f32", B, int(robust), float(min_angle), float(max_err),
              *map(_ptr, (R, t, x, mask, xyz, inl, success)), _stream(dev))
        LAUNCHES["triangulate_tracks"] += 1
    return xyz, inl, success


# K9 ------------------------------------------------------------------------


def filter_points(model_id, quat, t, cam_params, xyz, obs_xy, valid):
    """K9: per-(point, view) reprojection error and depth, per-point smallest
    |cos| between viewing rays. See filter_points_plain."""
    if xyz.device.type == "cpu":
        return filter_points_plain(model_id, quat, t, cam_params, xyz, obs_xy, valid)
    dev = _require_cuda(xyz)
    _check_model(model_id)
    P, V = valid.shape
    K = cam_params.shape[-1]
    if isinstance(model_id, tuple):
        if K != max(camera_models.model_num_params(m) for m in model_id) + 1:
            raise ValueError(f"cam_params has {K} columns for models {model_id}")
    elif K != camera_models.model_num_params(model_id):
        raise ValueError(f"cam_params has {K} columns for model {model_id}")
    if V > FILTER_VIEWS:
        raise ValueError(f"K9 takes at most {FILTER_VIEWS} views per point, got {V}")
    for name, a, dt, shape in (("quat", quat, f32, (P, V, 4)), ("t", t, f32, (P, V, 3)),
                               ("cam_params", cam_params, f32, (P, V, K)),
                               ("xyz", xyz, f32, (P, 3)), ("obs_xy", obs_xy, f32, (P, V, 2)),
                               ("valid", valid, u8, (P, V))):
        _check(name, a, dt, shape, dev)
    err = torch.empty(P, V, dtype=f32, device=dev)
    depth = torch.empty(P, V, dtype=f32, device=dev)
    min_cos = torch.empty(P, dtype=f32, device=dev)
    if not P:
        return err, depth, min_cos
    if isinstance(model_id, tuple):
        # One launch per model over the points with a slot of that model.
        pos = torch.round(cam_params[..., -1]).long()
        groups = [(int(m), k, (pos == k).any(1).nonzero()[:, 0].to(i32))
                  for k, m in enumerate(model_id)]
    else:
        groups = [(int(model_id), -1, None)]
    for m, k, pts in groups:
        n = P if pts is None else pts.shape[0]
        if n:
            _call("filter_points_f32", m, n, V, K, k, _opt_ptr(pts),
                  *map(_ptr, (quat, t, cam_params, xyz, obs_xy, valid, err, depth, min_cos)),
                  _stream(dev))
            LAUNCHES["filter_points"] += 1
    return err, depth, min_cos
