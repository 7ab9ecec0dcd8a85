"""Camera models: batched projection for all 18 COLMAP models, in PyTorch.

Counterpart of colmap_tpu/sensor/models.py (reference: COLMAP
src/colmap/sensor/models.h). Every model is a pure function on whole point
batches built from elementwise torch ops only, so the same code runs under
``torch.func.vmap``/``jacfwd`` (the plain version of the bundle-adjustment
Jacobian kernel differentiates it) and on any device.

    img_from_cam(model_id, params, uvw) -> (xy, valid)
    cam_from_img(model_id, params, xy) -> (uv, valid)   (z = 1 plane)
    cam_ray_from_img(model_id, params, xy) -> (ray, valid)   (unit bearing)
    img_from_cam_switch(model_ids, idx, params, uvw) -> (xy, valid)   (mixed models)

Problems that mix camera models (bundle adjustment, filtering) carry one
parameter row per camera padded to the widest model plus a trailing
model-position column, the camera's position in the sorted tuple of the
models present, as colmap_tpu packs them (``pack_mixed_params``); the
``model_id`` of such a problem is that tuple.

These are the plain versions. The mapper reaches them through the camera
map wrappers of ``colmap_tpu_torch/kernels/sfm.py``, which launch the CUDA
kernel K5 on card tensors; the kernels carry their own copy of these
formulas in ``colmap_tpu_torch/csrc/camera_models.cuh``.

Conventions (identical to the reference):
- image coords: upper-left corner (0, 0); pixel centers at (i+0.5, j+0.5).
- projection: normalize (u,v,w) -> (u/w, v/w), distort, then focal+pp.
- fisheye models first map through the equidistant fisheye transform
  (u,v) -> (u,v)·atan(r)/r and distort in theta-space.
"""

from __future__ import annotations

import enum
import math

import numpy as np
import torch

MAX_NUM_PARAMS = 16  # RadTanThinPrismFisheye


class CameraModelId(enum.IntEnum):
    """reference: src/colmap/sensor/models.h:90-119."""

    INVALID = -1
    SIMPLE_PINHOLE = 0
    PINHOLE = 1
    SIMPLE_RADIAL = 2
    RADIAL = 3
    OPENCV = 4
    OPENCV_FISHEYE = 5
    FULL_OPENCV = 6
    FOV = 7
    SIMPLE_RADIAL_FISHEYE = 8
    RADIAL_FISHEYE = 9
    THIN_PRISM_FISHEYE = 10
    RAD_TAN_THIN_PRISM_FISHEYE = 11
    SIMPLE_DIVISION = 12
    DIVISION = 13
    SIMPLE_FISHEYE = 14
    FISHEYE = 15
    EUCM = 16
    EQUIRECTANGULAR = 17


# name, num_params, focal idxs, principal point idxs, extra (distortion) idxs.
_MODEL_TABLE = {
    CameraModelId.SIMPLE_PINHOLE: ("SIMPLE_PINHOLE", 3, (0,), (1, 2), ()),
    CameraModelId.PINHOLE: ("PINHOLE", 4, (0, 1), (2, 3), ()),
    CameraModelId.SIMPLE_RADIAL: ("SIMPLE_RADIAL", 4, (0,), (1, 2), (3,)),
    CameraModelId.RADIAL: ("RADIAL", 5, (0,), (1, 2), (3, 4)),
    CameraModelId.OPENCV: ("OPENCV", 8, (0, 1), (2, 3), (4, 5, 6, 7)),
    CameraModelId.OPENCV_FISHEYE: ("OPENCV_FISHEYE", 8, (0, 1), (2, 3), (4, 5, 6, 7)),
    CameraModelId.FULL_OPENCV: (
        "FULL_OPENCV", 12, (0, 1), (2, 3), (4, 5, 6, 7, 8, 9, 10, 11)),
    CameraModelId.FOV: ("FOV", 5, (0, 1), (2, 3), (4,)),
    CameraModelId.SIMPLE_RADIAL_FISHEYE: (
        "SIMPLE_RADIAL_FISHEYE", 4, (0,), (1, 2), (3,)),
    CameraModelId.RADIAL_FISHEYE: ("RADIAL_FISHEYE", 5, (0,), (1, 2), (3, 4)),
    CameraModelId.THIN_PRISM_FISHEYE: (
        "THIN_PRISM_FISHEYE", 12, (0, 1), (2, 3), tuple(range(4, 12))),
    CameraModelId.RAD_TAN_THIN_PRISM_FISHEYE: (
        "RAD_TAN_THIN_PRISM_FISHEYE", 16, (0, 1), (2, 3), tuple(range(4, 16))),
    CameraModelId.SIMPLE_DIVISION: ("SIMPLE_DIVISION", 4, (0,), (1, 2), (3,)),
    CameraModelId.DIVISION: ("DIVISION", 5, (0, 1), (2, 3), (4,)),
    CameraModelId.SIMPLE_FISHEYE: ("SIMPLE_FISHEYE", 3, (0,), (1, 2), ()),
    CameraModelId.FISHEYE: ("FISHEYE", 4, (0, 1), (2, 3), ()),
    CameraModelId.EUCM: ("EUCM", 6, (0, 1), (2, 3), (4, 5)),
    CameraModelId.EQUIRECTANGULAR: ("EQUIRECTANGULAR", 2, (), (), ()),
}

MODEL_NAME_TO_ID = {v[0]: k for k, v in _MODEL_TABLE.items()}
MODEL_ID_TO_NAME = {int(k): v[0] for k, v in _MODEL_TABLE.items()}


def model_num_params(model_id) -> int:
    return _MODEL_TABLE[CameraModelId(int(model_id))][1]


def focal_length_idxs(model_id):
    return _MODEL_TABLE[CameraModelId(int(model_id))][2]


def principal_point_idxs(model_id):
    return _MODEL_TABLE[CameraModelId(int(model_id))][3]


def extra_params_idxs(model_id):
    return _MODEL_TABLE[CameraModelId(int(model_id))][4]


def initialize_params(model_id, focal_length: float, width: int, height: int):
    """Default parameters for a model (reference: InitializeParams per model)."""
    mid = CameraModelId(int(model_id))
    n = model_num_params(mid)
    params = np.zeros(n, dtype=np.float64)
    if mid == CameraModelId.EQUIRECTANGULAR:
        params[:] = [width, height]
        return params
    f_idxs, pp_idxs = focal_length_idxs(mid), principal_point_idxs(mid)
    for i in f_idxs:
        params[i] = focal_length
    params[pp_idxs[0]] = width / 2.0
    params[pp_idxs[1]] = height / 2.0
    if mid == CameraModelId.FOV:
        params[4] = 1e-2
    elif mid == CameraModelId.EUCM:
        params[4], params[5] = 0.0, 1.0
    return params


def mean_focal_length(model_id, params):
    idxs = list(focal_length_idxs(model_id))
    if not idxs:  # EQUIRECTANGULAR: focal equivalent = width / (2*pi)
        return params[..., 0] / (2.0 * np.pi)
    return sum(params[..., i] for i in idxs) / len(idxs)


def cam_from_img_threshold(model_id, params, threshold):
    """Pixel threshold -> normalized-plane threshold (models.h:1131-1139)."""
    return threshold / mean_focal_length(model_id, params)


# ---------------------------------------------------------------------------
# Distortion functions: (extra_params, u, v) -> (du, dv), elementwise; u/v are
# coordinates in the normalized (or fisheye theta-) plane.
# ---------------------------------------------------------------------------


def _dist_none(e, u, v):
    return torch.zeros_like(u), torch.zeros_like(v)


def _dist_simple_radial(e, u, v):
    radial = e[0] * (u * u + v * v)
    return u * radial, v * radial


def _dist_radial(e, u, v):
    r2 = u * u + v * v
    radial = e[0] * r2 + e[1] * r2 * r2
    return u * radial, v * radial


def _dist_opencv(e, u, v):
    k1, k2, p1, p2 = e[0], e[1], e[2], e[3]
    u2, v2, uv = u * u, v * v, u * v
    r2 = u2 + v2
    radial = k1 * r2 + k2 * r2 * r2
    du = u * radial + 2 * p1 * uv + p2 * (r2 + 2 * u2)
    dv = v * radial + 2 * p2 * uv + p1 * (r2 + 2 * v2)
    return du, dv


def _dist_opencv_fisheye(e, u, v):
    # theta-space polynomial: k1 θ² + k2 θ⁴ + k3 θ⁶ + k4 θ⁸.
    k1, k2, k3, k4 = e[0], e[1], e[2], e[3]
    t2 = u * u + v * v
    radial = t2 * (k1 + t2 * (k2 + t2 * (k3 + t2 * k4)))
    return u * radial, v * radial


def _dist_full_opencv(e, u, v):
    k1, k2, p1, p2, k3, k4, k5, k6 = (e[i] for i in range(8))
    u2, v2, uv = u * u, v * v, u * v
    r2 = u2 + v2
    r4 = r2 * r2
    r6 = r4 * r2
    radial = (1 + k1 * r2 + k2 * r4 + k3 * r6) / (1 + k4 * r2 + k5 * r4 + k6 * r6) - 1
    du = u * radial + 2 * p1 * uv + p2 * (r2 + 2 * u2)
    dv = v * radial + 2 * p2 * uv + p1 * (r2 + 2 * v2)
    return du, dv


def _dist_fov(e, u, v):
    # Devernay-Faugeras FOV model with the reference's Taylor fallbacks
    # (models.h FOVCameraModel::Distortion).
    omega = e[0]
    eps = 1e-4
    r2 = u * u + v * v
    omega2 = omega * omega
    tan_half = torch.tan(omega / 2)
    r = torch.sqrt(torch.clamp(r2, min=1e-30))
    safe_omega = torch.where(omega2 < eps, torch.ones_like(omega), omega)
    factor_full = torch.atan(r * 2 * tan_half) / (r * safe_omega)
    factor_small_omega = (omega2 * r2) / 3 - omega2 / 12 + 1
    factor_small_r = (-2 * tan_half * (4 * r2 * tan_half * tan_half - 3)) / (
        3 * safe_omega
    )
    factor = torch.where(
        omega2 < eps, factor_small_omega,
        torch.where(r2 < eps, factor_small_r, factor_full),
    )
    return u * (factor - 1), v * (factor - 1)


def _undist_fov(e, u, v):
    # Closed-form inverse (models.h FOVCameraModel::Undistortion).
    omega = e[0]
    eps = 1e-4
    r2 = u * u + v * v
    omega2 = omega * omega
    tan_half = torch.tan(omega / 2)
    r = torch.sqrt(torch.clamp(r2, min=1e-30))
    safe_tan = _safe(torch.abs(tan_half) < 1e-30, tan_half)
    factor_full = torch.tan(r * omega) / (r * 2 * safe_tan)
    factor_small_omega = (omega2 * r2) / 3 - omega2 / 12 + 1
    factor_small_r = (omega * (omega2 * r2 + 3)) / (6 * safe_tan)
    factor = torch.where(
        omega2 < eps, factor_small_omega, torch.where(r2 < eps, factor_small_r, factor_full)
    )
    return u * factor, v * factor


def _dist_thin_prism(e, u, v):
    k1, k2, p1, p2, k3, k4, sx1, sy1 = (e[i] for i in range(8))
    u2, v2, uv = u * u, v * v, u * v
    r2 = u2 + v2
    r4 = r2 * r2
    radial = k1 * r2 + k2 * r4 + k3 * r4 * r2 + k4 * r4 * r4
    du = u * radial + 2 * p1 * uv + p2 * (r2 + 2 * u2) + sx1 * r2
    dv = v * radial + 2 * p2 * uv + p1 * (r2 + 2 * v2) + sy1 * r2
    return du, dv


def _dist_radtan_thin_prism(e, u, v):
    # 6 radial theta-coefficients, 2 tangential, 4 thin-prism
    # (models.h RadTanThinPrismFisheyeModel::Distortion).
    t2 = u * u + v * v
    th_radial = torch.ones_like(u)
    tp = torch.ones_like(u)
    for i in range(6):
        tp = tp * t2
        th_radial = th_radial + e[i] * tp
    p0, p1 = e[6], e[7]
    s0, s1, s2, s3 = e[8], e[9], e[10], e[11]
    x = th_radial * u
    y = th_radial * v
    x2, y2, xy = x * x, y * y, x * y
    r2 = x2 + y2
    r4 = r2 * r2
    dx_tang = 2 * p1 * xy + p0 * (r2 + 2 * x2)
    dy_tang = 2 * p0 * xy + p1 * (r2 + 2 * y2)
    dx_tp = s0 * r2 + s1 * r4
    dy_tp = s2 * r2 + s3 * r4
    return x + dx_tang + dx_tp - u, y + dy_tang + dy_tp - v


# model -> (distortion fn in normalized plane or theta plane, is_fisheye)
_DISTORTIONS = {
    CameraModelId.SIMPLE_PINHOLE: (_dist_none, False),
    CameraModelId.PINHOLE: (_dist_none, False),
    CameraModelId.SIMPLE_RADIAL: (_dist_simple_radial, False),
    CameraModelId.RADIAL: (_dist_radial, False),
    CameraModelId.OPENCV: (_dist_opencv, False),
    CameraModelId.OPENCV_FISHEYE: (_dist_opencv_fisheye, True),
    CameraModelId.FULL_OPENCV: (_dist_full_opencv, False),
    CameraModelId.FOV: (_dist_fov, False),
    CameraModelId.SIMPLE_RADIAL_FISHEYE: (_dist_simple_radial, True),
    CameraModelId.RADIAL_FISHEYE: (_dist_radial, True),
    CameraModelId.THIN_PRISM_FISHEYE: (_dist_thin_prism, True),
    CameraModelId.RAD_TAN_THIN_PRISM_FISHEYE: (_dist_radtan_thin_prism, True),
    CameraModelId.SIMPLE_FISHEYE: (_dist_none, True),
    CameraModelId.FISHEYE: (_dist_none, True),
}


def _fisheye_from_normal(u, v):
    """(u, v) -> (u, v) * atan(r)/r (equidistant fisheye forward map)."""
    r = torch.sqrt(u * u + v * v)
    scale = torch.where(
        r > 1e-12, torch.atan(r) / torch.clamp(r, min=1e-30), torch.ones_like(r)
    )
    return u * scale, v * scale


def _normal_from_fisheye(uu, vv):
    """Inverse of _fisheye_from_normal: (u, v) * sin(θ) / (θ cos θ)."""
    theta = torch.sqrt(uu * uu + vv * vv)
    theta_cos = theta * torch.cos(theta)
    big = theta_cos > 1e-12
    scale = torch.where(big, torch.sin(theta) / torch.where(big, theta_cos, 1.0), 1.0)
    return uu * scale, vv * scale


def _split_focal_pp(model_id, params):
    """Indexes the last axis so per-observation parameter batches work."""
    f_idxs = focal_length_idxs(model_id)
    pp_idxs = principal_point_idxs(model_id)
    if len(f_idxs) == 1:
        fx = fy = params[..., f_idxs[0]]
    else:
        fx, fy = params[..., f_idxs[0]], params[..., f_idxs[1]]
    cx, cy = params[..., pp_idxs[0]], params[..., pp_idxs[1]]
    return fx, fy, cx, cy


def _extra(model_id, params):
    return [params[..., i] for i in extra_params_idxs(model_id)]


def _safe(cond, x):
    """x where cond is False, 1 where it is True."""
    return torch.where(cond, torch.ones_like(x), x)


def img_from_cam(model_id, params, uvw, check_cheirality=True):
    """Project camera-frame points to pixel coordinates.

    Args:
        model_id: int model id.
        params: (num_params,) or (..., num_params) camera parameters.
        uvw: (..., 3) points in the camera frame.
    Returns:
        xy: (..., 2) pixel coordinates; valid: (...,) bool mask.
    """
    mid = CameraModelId(int(model_id))
    u, v, w = uvw[..., 0], uvw[..., 1], uvw[..., 2]
    eps = torch.finfo(uvw.dtype).eps

    if mid == CameraModelId.EQUIRECTANGULAR:
        width, height = params[..., 0], params[..., 1]
        horizontal = torch.sqrt(u * u + w * w)
        valid = horizontal + torch.abs(v) >= eps
        theta = torch.atan2(u, w)
        phi = torch.atan2(-v, horizontal)
        x = (theta / (2 * math.pi) + 0.5) * width
        y = (0.5 - phi / math.pi) * height
        return torch.stack(torch.broadcast_tensors(x, y), dim=-1), valid

    if mid == CameraModelId.EUCM:
        fx, fy, cx, cy = _split_focal_pp(mid, params)
        alpha, beta = params[..., 4], params[..., 5]
        valid = w >= eps if check_cheirality else torch.abs(w) >= eps
        rho2 = beta * (u * u + v * v) + w * w
        valid = valid & (rho2 >= 0)
        rho = torch.sqrt(torch.clamp(rho2, min=0.0))
        den = alpha * rho + (1.0 - alpha) * w
        valid = valid & (den >= eps if check_cheirality else torch.abs(den) >= eps)
        safe_den = _safe(torch.abs(den) < eps, den)
        x = fx * u / safe_den + cx
        y = fy * v / safe_den + cy
        return torch.stack([x, y], dim=-1), valid

    if mid in (CameraModelId.SIMPLE_DIVISION, CameraModelId.DIVISION):
        fx, fy, cx, cy = _split_focal_pp(mid, params)
        k = _extra(mid, params)[0]
        rho = torch.sqrt(u * u + v * v)
        disc_sq = w * w - 4 * rho * rho * k
        valid = disc_sq >= 0
        disc = torch.sqrt(torch.clamp(disc_sq, min=0.0))
        denom = w + disc
        valid = valid & (torch.abs(denom) >= eps)
        r = 2.0 / _safe(torch.abs(denom) < eps, denom)
        x = fx * r * u + cx
        y = fy * r * v + cy
        return torch.stack([x, y], dim=-1), valid

    # Generic perspective / fisheye path.
    dist_fn, is_fisheye = _DISTORTIONS[mid]
    valid = w >= eps if check_cheirality else torch.abs(w) >= eps
    safe_w = _safe(torch.abs(w) < eps, w)
    un, vn = u / safe_w, v / safe_w
    if is_fisheye:
        un, vn = _fisheye_from_normal(un, vn)
    du, dv = dist_fn(_extra(mid, params), un, vn)
    xd, yd = un + du, vn + dv
    fx, fy, cx, cy = _split_focal_pp(mid, params)
    x = fx * xd + cx
    y = fy * yd + cy
    return torch.stack([x, y], dim=-1), valid


def _newton_undistort(dist_fn, extra, u0, v0, num_iterations=25):
    """Solve x + d(x) = x0 by Newton iteration with a trust region.

    reference behavior: models.h IterativeUndistortion :1141-1200 (100 iters,
    rel/abs step radius 0.1). As colmap_tpu: a fixed count of 25 steps, the
    2x2 Jacobian by forward-mode differentiation of the distortion function
    (two jvps over the whole batch), the step scaled to at most
    max(0.1 |x|, 0.1). The step count sets the result; keep it.
    """

    def residual(u, v):
        du, dv = dist_fn(extra, u, v)
        return u + du, v + dv

    u, v = u0, v0
    one, zero = torch.ones_like(u0), torch.zeros_like(u0)
    for _ in range(num_iterations):
        (ru, rv), (a, c) = torch.func.jvp(residual, (u, v), (one, zero))
        _, (b, d) = torch.func.jvp(residual, (u, v), (zero, one))
        e0, e1 = ru - u0, rv - v0
        det = a * d - b * c
        inv_det = torch.where(torch.abs(det) > 1e-30, 1.0 / _safe(det == 0, det), 0.0)
        dx0 = inv_det * (d * e0 - b * e1)
        dx1 = inv_det * (-c * e0 + a * e1)
        step_norm = torch.sqrt(dx0 * dx0 + dx1 * dx1)
        max_step = torch.clamp(torch.sqrt(u * u + v * v) * 0.1, min=0.1)
        scale = torch.clamp(max_step / torch.clamp(step_norm, min=1e-30), max=1.0)
        u, v = u - dx0 * scale, v - dx1 * scale
    return u, v


def img_from_cam_switch(model_ids: tuple, idx, params, uvw, check_cheirality=True):
    """Mixed-model projection (colmap_tpu's img_from_cam_switch, a
    lax.switch over the models present): each row through the model
    ``model_ids[idx]`` with its first model_num_params columns of params.

    Args:
        model_ids: tuple of the distinct model ids present.
        idx: int position into model_ids, or a tensor of positions (...,)
            broadcast against the rows.
        params: (..., Pmax) rows padded to the widest model (without the
            model-position column).
        uvw: (..., 3) camera-frame points.
    Returns (xy (..., 2), valid (...,)).
    """
    if not torch.is_tensor(idx):
        m = int(model_ids[int(idx)])
        return img_from_cam(m, params[..., :model_num_params(m)], uvw, check_cheirality)
    batch = torch.broadcast_shapes(idx.shape, params.shape[:-1], uvw.shape[:-1])
    idx = idx.expand(batch)
    params = params.expand(batch + params.shape[-1:])
    uvw = uvw.expand(batch + (3,))
    xy = uvw.new_zeros(batch + (2,))
    valid = torch.zeros(batch, dtype=torch.bool, device=uvw.device)
    for k, m in enumerate(model_ids):
        sel = idx == k
        if bool(sel.any()):
            P = model_num_params(m)
            xy[sel], valid[sel] = img_from_cam(int(m), params[sel][..., :P], uvw[sel],
                                               check_cheirality)
    return xy, valid


def pack_mixed_params(cameras_params, camera_model_ids):
    """colmap_tpu's packing of a problem's cameras: (model_id, rows). One
    model: its id and the rows as they are; several: the sorted tuple of
    the models present and rows (C, Pmax + 1) padded with zeros to the
    widest model, the last column the camera's position in that tuple."""
    ids = sorted({int(m) for m in camera_model_ids})
    if len(ids) == 1:
        return ids[0], np.stack([np.asarray(p, dtype=np.float64) for p in cameras_params])
    pos = {m: k for k, m in enumerate(ids)}
    p_max = max(model_num_params(m) for m in ids)
    rows = np.zeros((len(cameras_params), p_max + 1))
    for row, (params, m) in enumerate(zip(cameras_params, camera_model_ids)):
        rows[row, : len(params)] = params
        rows[row, -1] = pos[int(m)]
    return tuple(ids), rows


def row_models(model_id, cam_params):
    """The model id of each row (C,) of cam_params, host ints."""
    if not isinstance(model_id, tuple):
        return [int(model_id)] * cam_params.shape[0]
    pos = torch.round(cam_params[:, -1]).long().tolist()
    return [int(model_id[k]) for k in pos]


def cam_from_img(model_id, params, xy):
    """Lift pixel coordinates to the normalized z=1 camera plane.

    params: (num_params,) or (..., num_params) matched to xy (..., 2).
    Returns (uv, valid): uv (..., 2) such that (u, v, 1) is the ray.
    """
    mid = CameraModelId(int(model_id))
    x, y = xy[..., 0], xy[..., 1]
    eps = torch.finfo(xy.dtype).eps

    if mid == CameraModelId.EQUIRECTANGULAR:
        width, height = params[..., 0], params[..., 1]
        theta = 2 * math.pi * (x / width - 0.5)
        phi = math.pi * (0.5 - y / height)
        cos_phi = torch.cos(phi)
        rx = cos_phi * torch.sin(theta)
        ry = -torch.sin(phi)
        rz = cos_phi * torch.cos(theta)
        valid = rz > eps
        safe_rz = _safe(torch.abs(rz) < eps, rz)
        return torch.stack([rx / safe_rz, ry / safe_rz], dim=-1), valid

    fx, fy, cx, cy = _split_focal_pp(mid, params)
    uu = (x - cx) / fx
    vv = (y - cy) / fy
    if mid == CameraModelId.EUCM:
        alpha, beta = params[..., 4], params[..., 5]
        r2 = uu * uu + vv * vv
        gamma = 1.0 - alpha
        radicand = 1.0 - (alpha - gamma) * beta * r2
        valid = radicand >= 0
        helper_den = alpha * torch.sqrt(torch.clamp(radicand, min=0.0)) + gamma
        valid = valid & (helper_den >= eps)
        helper = (1.0 - alpha * alpha * beta * r2) / _safe(helper_den < eps, helper_den)
        valid = valid & (helper >= eps)
        safe_helper = _safe(torch.abs(helper) < eps, helper)
        return torch.stack([uu / safe_helper, vv / safe_helper], dim=-1), valid

    if mid in (CameraModelId.SIMPLE_DIVISION, CameraModelId.DIVISION):
        k = _extra(mid, params)[0]
        denom = 1.0 + k * (uu * uu + vv * vv)
        valid = torch.abs(denom) >= eps
        safe = _safe(torch.abs(denom) < eps, denom)
        return torch.stack([uu / safe, vv / safe], dim=-1), valid

    ones = torch.ones_like(uu, dtype=torch.bool)
    if mid == CameraModelId.FOV:
        u, v = _undist_fov(_extra(mid, params), uu, vv)
        return torch.stack([u, v], dim=-1), ones

    dist_fn, is_fisheye = _DISTORTIONS[mid]
    extra = _extra(mid, params)
    if extra:
        # Per-row parameters enter the Newton solve broadcast to the points.
        extra = [torch.broadcast_to(e, uu.shape) for e in extra]
        uu, vv = _newton_undistort(dist_fn, extra, uu, vv)
    if is_fisheye:
        uu, vv = _normal_from_fisheye(uu, vv)
    return torch.stack([uu, vv], dim=-1), ones


def cam_ray_from_img(model_id, params, xy):
    """Pixel -> unit bearing vector in the camera frame (..., 3)."""
    mid = CameraModelId(int(model_id))
    if mid == CameraModelId.EQUIRECTANGULAR:
        x, y = xy[..., 0], xy[..., 1]
        theta = 2 * math.pi * (x / params[..., 0] - 0.5)
        phi = math.pi * (0.5 - y / params[..., 1])
        cos_phi = torch.cos(phi)
        ray = torch.stack(
            [cos_phi * torch.sin(theta), -torch.sin(phi), cos_phi * torch.cos(theta)], dim=-1
        )
        return ray, torch.ones(ray.shape[:-1], dtype=torch.bool, device=ray.device)
    uv, valid = cam_from_img(model_id, params, xy)
    return ray_from_plane(uv), valid


def ray_from_plane(uv):
    """(u, v) on the z = 1 plane -> unit ray (u, v, 1) / |(u, v, 1)|."""
    ray = torch.cat([uv, torch.ones_like(uv[..., :1])], dim=-1)
    return ray / torch.linalg.vector_norm(ray, dim=-1, keepdim=True)


def has_bogus_params(
    model_id,
    params,
    width,
    height,
    min_focal_length_ratio,
    max_focal_length_ratio,
    max_extra_param,
):
    """reference behavior: CameraModelHasBogusParams (models.h:912).
    Host-side check on a numpy parameter vector."""
    mid = CameraModelId(int(model_id))
    params = np.asarray(params)
    if mid == CameraModelId.EQUIRECTANGULAR:
        return False
    for i in focal_length_idxs(mid):
        ratio = params[i] / max(width, height)
        if ratio < min_focal_length_ratio or ratio > max_focal_length_ratio:
            return True
    pp = principal_point_idxs(mid)
    if params[pp[0]] < 0 or params[pp[0]] > width:
        return True
    if params[pp[1]] < 0 or params[pp[1]] > height:
        return True
    for i in extra_params_idxs(mid):
        if abs(params[i]) > max_extra_param:
            return True
    if mid == CameraModelId.EUCM:
        alpha, beta = params[..., 4], params[..., 5]
        if alpha < 0 or alpha > 1 or beta <= 0:
            return True
    return False
