"""Rig kernels: wrappers, plain PyTorch versions, launch counts.

Four CUDA kernels carry the device programs of the rig paths of the
incremental mapper (sources in ``colmap_tpu_torch/csrc``):

    K24 rig_ba_jacobians   rig_obs_jacobians, rig_obs_cost
    K25 rig_ba_reduce      rig_lm_reduce
    K26 rig_ba_matvec      rig_schur_matvec, rig_back_substitute
    K27 gen_abs_ransac     gen_abs_propose_score, gen_abs_inliers

K24-K26 carry colmap_tpu/estimators/bundle_adjustment_rig.py (``lm_step``
and ``lm_solve_fused``); K27 carries ``_gen_abs_ransac`` of
colmap_tpu/estimators/generalized_pose.py. As the other kernel modules do,
each wrapper runs the plain version when its tensors lie on the CPU and
launches the kernel when they lie on a CUDA device; on a CUDA tensor it
launches or raises, it never falls back. ``LAUNCHES`` counts kernel launches
by kernel name (a wrapper adds one where it launches, nowhere else). The
plain versions are written for any float dtype: the tests run them in
float64 against colmap_tpu, and a check on the card holds the kernels
against them. ``KERNELS`` bundles the BA wrappers, which the solver runs,
and ``PLAIN`` their plain versions, which only the solver's private loop
takes.

The camera side of a rig problem: R = F + G + C rows, frames (F, 6 columns:
rotation then translation), sensors (G, 6) and cameras (C, P), kept in one
(R, 8) tensor whose unused columns are 0 (P <= 8 for models 0-4). PCG runs
on that one tensor. ``rig_layout`` builds the CSR lists the kernels sum over
once per solve: each point's observations, and each camera-side row's
observations cut into chunks of at most ``CHUNK`` entries; every sum is a
gather in a fixed order and a fixed tree, never a float atomic, so two runs
on the same inputs agree to the bit.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from colmap_tpu_torch.estimators.ba_residual import quat_exp, robust_cost, robust_weight
from colmap_tpu_torch.geometry import rotation as rot
from colmap_tpu_torch.kernels import sfm as S
from colmap_tpu_torch.kernels.ba import CUDA_MODELS, LOSSES, _segment_sum, inv3x3_spd
from colmap_tpu_torch.kernels.global_sfm import csr
from colmap_tpu_torch.optim.ransac import pack_best
from colmap_tpu_torch.sensor import models as camera_models

LAUNCHES = {
    "rig_ba_jacobians": 0,
    "rig_ba_reduce": 0,
    "rig_ba_matvec": 0,
    "gen_abs_ransac": 0,
}

W = 8  # columns of a camera-side row: 6 for frames and sensors, P <= 8 for cameras
CHUNK = 1024  # camera-side entries one block of K25 / K26 sums
GDLT_SAMPLE = 6

f32, f64, i32 = torch.float32, torch.float64, torch.int32


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# Layout of a rig BA problem.
# ---------------------------------------------------------------------------


class RigLayout(NamedTuple):
    """The observations of a rig BA problem by point and by camera-side row
    (frames, then sensors, then cameras), on the problem's device."""

    pt_offsets: torch.Tensor  # (N + 1,) int32
    pt_obs: torch.Tensor  # (O,) int32
    seg_obs: torch.Tensor  # (3O,) int32 observation ids, row by row
    chunk_row: torch.Tensor  # (K,) int32 camera-side row of each chunk
    chunk_start: torch.Tensor  # (K,) int32 first entry of seg_obs
    chunk_end: torch.Tensor  # (K,) int32 one past the last entry
    row_chunks: torch.Tensor  # (R + 1,) int32 chunks of each row
    num_frames: int
    num_sensors: int
    num_cams: int
    num_points: int
    num_params: int


def rig_layout(obs_frame, obs_sensor, obs_cam, obs_point, num_frames: int, num_sensors: int,
               num_cams: int, num_points: int, num_params: int) -> RigLayout:
    F, G, C, N = int(num_frames), int(num_sensors), int(num_cams), int(num_points)
    R = F + G + C
    pt_offsets, pt_obs = csr(obs_point, N)
    keys = torch.cat([obs_frame.long(), F + obs_sensor.long(), F + G + obs_cam.long()])
    seg_offsets, order = csr(keys, R)
    seg_offsets = seg_offsets.long()
    seg_obs = order.long() % max(obs_frame.shape[0], 1)
    counts = seg_offsets[1:] - seg_offsets[:-1]
    per_row = (counts + CHUNK - 1) // CHUNK
    row_chunks = torch.zeros(R + 1, dtype=torch.long, device=keys.device)
    row_chunks[1:] = torch.cumsum(per_row, 0)
    chunk_row = torch.repeat_interleave(torch.arange(R, device=keys.device), per_row)
    k = torch.arange(chunk_row.shape[0], device=keys.device) - row_chunks[chunk_row]
    chunk_start = seg_offsets[chunk_row] + k * CHUNK
    chunk_end = torch.minimum(chunk_start + CHUNK, seg_offsets[chunk_row + 1])
    return RigLayout(pt_offsets, pt_obs, seg_obs.to(i32), chunk_row.to(i32),
                     chunk_start.to(i32), chunk_end.to(i32), row_chunks.to(i32), F, G, C, N,
                     int(num_params))


# ---------------------------------------------------------------------------
# Plain versions.
# ---------------------------------------------------------------------------


class RigObs(NamedTuple):
    """A rig problem's observation arrays (index tensors int32)."""

    obs_frame: torch.Tensor
    obs_sensor: torch.Tensor
    obs_cam: torch.Tensor
    obs_point: torch.Tensor
    obs_xy: torch.Tensor
    obs_w: torch.Tensor


class RigJacobians(NamedTuple):
    """K24's per-observation outputs: √w-weighted residuals and masked
    Jacobian blocks (frame, sensor, camera, point)."""

    r: torch.Tensor  # (O, 2)
    Jf: torch.Tensor  # (O, 2, 6)
    Js: torch.Tensor  # (O, 2, 6)
    Jc: torch.Tensor  # (O, 2, P)
    Jx: torch.Tensor  # (O, 2, 3)


class RigReduction(NamedTuple):
    """K25's sums for one LM step. Camera-side tensors are (R, 8)."""

    g: torch.Tensor  # -Σ Jᵀ r
    b: torch.Tensor  # reduced right-hand side g - Σ Jᵀ Jx Hpp⁻¹ gx
    diag: torch.Tensor  # Σ J²
    lam_diag: torch.Tensor  # λ Σ J², the damping of the reduced system
    precond: torch.Tensor  # Jacobi 1 / (Σ J² + λ Σ J²), 0 where that is <= 1e-12
    gx: torch.Tensor  # (N, 3) -Σ Jxᵀ r
    Hpp_inv: torch.Tensor  # (N, 3, 3) (Hpp + diag(λ diag(Hpp) + 1e-12))⁻¹
    diag_x: torch.Tensor  # (N, 3) diag(Hpp)


def rig_residual(dframe, dsensor, dcam, dX, fq, ft, sq, st, cam_params, X, xy, model_id):
    """cam_from_world = sensor_from_rig ∘ rig_from_world, each rotation
    updated by ``quat_exp(δ) · q``; the residual proj - xy (2,)."""
    qf = rot.quat_multiply(quat_exp(dframe[..., :3]), fq)
    qs = rot.quat_multiply(quat_exp(dsensor[..., :3]), sq)
    X_rig = rot.quat_rotate(qf, X + dX) + ft + dframe[..., 3:]
    Xc = rot.quat_rotate(qs, X_rig) + st + dsensor[..., 3:]
    proj, _ = camera_models.img_from_cam(model_id, cam_params + dcam, Xc, check_cheirality=False)
    return proj - xy


def rig_obs_cost_plain(quat, t, sensor_quat, sensor_t, cam_params, points, obs: RigObs,
                       model_id: int, loss: str, loss_scale: float):
    """½ Σ ρ(‖r‖²)·w over all observations, non-finite terms dropped (K24
    cost mode; colmap_tpu's compute_cost)."""
    f, s = obs.obs_frame.long(), obs.obs_sensor.long()
    X_rig = rot.quat_rotate(quat[f], points[obs.obs_point.long()]) + t[f]
    Xc = rot.quat_rotate(sensor_quat[s], X_rig) + sensor_t[s]
    proj, _ = camera_models.img_from_cam(model_id, cam_params[obs.obs_cam.long()], Xc,
                                         check_cheirality=False)
    r = proj - obs.obs_xy
    sq = (r * r).sum(-1)
    sq = torch.where(torch.isfinite(sq), sq, 0.0)
    return 0.5 * (robust_cost(sq, loss, loss_scale) * obs.obs_w).sum()


def rig_obs_jacobians_plain(quat, t, sensor_quat, sensor_t, cam_params, points, obs: RigObs,
                            pose_mask, sensor_mask, cam_mask, point_mask, model_id: int,
                            loss: str, loss_scale: float) -> RigJacobians:
    """K24's function: jacfwd + vmap over ``rig_residual`` (colmap_tpu's
    _obs_jacobians), the robust IRLS weight times obs_w, zero rows where
    anything is not finite, √w scaling, then the masks of _apply_masks:
    pose_mask (F, 6) rotation and translation columns, sensor_mask (G,),
    cam_mask (C, P), point_mask (N,)."""
    f, s = obs.obs_frame.long(), obs.obs_sensor.long()
    c, p = obs.obs_cam.long(), obs.obs_point.long()
    P = cam_params.shape[1]

    def fn(df, ds, dc, dX, fq, ft, sq, st, cp, X, xy):
        r = rig_residual(df, ds, dc, dX, fq, ft, sq, st, cp, X, xy, model_id)
        return r, r

    z = quat.new_zeros
    jac = torch.func.jacfwd(fn, argnums=(0, 1, 2, 3), has_aux=True)
    (Jf, Js, Jc, Jx), r = torch.func.vmap(jac, in_dims=(None,) * 4 + (0,) * 7)(
        z(6), z(6), z(P), z(3), quat[f], t[f], sensor_quat[s], sensor_t[s], cam_params[c],
        points[p], obs.obs_xy)
    O = r.shape[0]
    w = robust_weight((r * r).sum(-1), loss, loss_scale) * obs.obs_w
    finite = torch.isfinite(r).all(-1)
    for J in (Jf, Js, Jc, Jx):
        finite &= torch.isfinite(J.reshape(O, -1)).all(-1)
    sw = torch.sqrt(torch.where(finite, w, 0.0))[:, None]
    keep = finite[:, None, None]

    def scale(J, m):
        return torch.where(keep, J, 0.0) * sw[..., None] * m

    return RigJacobians(
        torch.where(finite[:, None], r, 0.0) * sw,
        scale(Jf, pose_mask[f][:, None, :]),
        scale(Js, sensor_mask[s][:, None, None]),
        scale(Jc, cam_mask[c][:, None, :]),
        scale(Jx, point_mask[p][:, None, None]),
    )


def _family_blocks(jac: RigJacobians):
    """The three camera-side Jacobian blocks padded to W columns."""
    pad = W - jac.Jc.shape[-1]
    return (torch.nn.functional.pad(jac.Jf, (0, 2)), torch.nn.functional.pad(jac.Js, (0, 2)),
            torch.nn.functional.pad(jac.Jc, (0, pad)))


def _cam_side_sum(jac: RigJacobians, obs: RigObs, layout: RigLayout, v):
    """Σ Jᵀ v (R, W) over each row's observations, v (O, 2)."""
    F, G, C = layout.num_frames, layout.num_sensors, layout.num_cams
    Jf, Js, Jc = _family_blocks(jac)
    return torch.cat([
        _segment_sum((Jf * v[..., None]).sum(1), obs.obs_frame, F),
        _segment_sum((Js * v[..., None]).sum(1), obs.obs_sensor, G),
        _segment_sum((Jc * v[..., None]).sum(1), obs.obs_cam, C),
    ])


def _cam_side_apply(jac: RigJacobians, obs: RigObs, layout: RigLayout, x):
    """u = Jf x_f + Js x_s + Jc x_c (O, 2) for a camera-side vector x (R, W)."""
    F, G = layout.num_frames, layout.num_sensors
    Jf, Js, Jc = _family_blocks(jac)
    return ((Jf * x[obs.obs_frame.long()][:, None, :]).sum(-1)
            + (Js * x[F + obs.obs_sensor.long()][:, None, :]).sum(-1)
            + (Jc * x[F + G + obs.obs_cam.long()][:, None, :]).sum(-1))


def rig_lm_reduce_plain(jac: RigJacobians, obs: RigObs, layout: RigLayout,
                        lam: float) -> RigReduction:
    """K25's function: lm_step's gradients (l.350-353), _build_schur's
    point blocks and damping (l.238-252), the reduced right-hand side
    (l.356-361) and _pcg's Jacobi preconditioner (l.284-290)."""
    N = layout.num_points
    p = obs.obs_point.long()
    gx = -_segment_sum((jac.Jx * jac.r[..., None]).sum(1), p, N)
    Hpp = _segment_sum((jac.Jx[..., :, None] * jac.Jx[..., None, :]).sum(1), p, N)
    diag_x = torch.diagonal(Hpp, dim1=-2, dim2=-1).clone()
    Hpp_inv = inv3x3_spd(Hpp + torch.diag_embed(lam * diag_x + 1e-12))
    y = (Hpp_inv * gx[:, None, :]).sum(-1)
    v = (jac.Jx * y[p][:, None, :]).sum(-1)
    g = -_cam_side_sum(jac, obs, layout, jac.r)
    b = g - _cam_side_sum(jac, obs, layout, v)
    Jf, Js, Jc = _family_blocks(jac)
    sq = (Jf * Jf, Js * Js, Jc * Jc)
    diag = torch.cat([
        _segment_sum(sq[0].sum(1), obs.obs_frame, layout.num_frames),
        _segment_sum(sq[1].sum(1), obs.obs_sensor, layout.num_sensors),
        _segment_sum(sq[2].sum(1), obs.obs_cam, layout.num_cams),
    ])
    lam_diag = lam * diag
    damped = diag + lam_diag
    precond = torch.where(damped > 1e-12, 1.0 / torch.where(damped > 1e-12, damped, 1.0), 0.0)
    return RigReduction(g, b, diag, lam_diag, precond, gx, Hpp_inv, diag_x)


def rig_schur_matvec_plain(jac: RigJacobians, obs: RigObs, layout: RigLayout, Hpp_inv,
                           lam_diag, x):
    """K26, matvec mode: (H_cc - H_cp Hpp⁻¹ H_pc + λD) x on the camera side
    (colmap_tpu's _schur_matvec, l.255-278). x, result (R, W)."""
    p = obs.obs_point.long()
    u = _cam_side_apply(jac, obs, layout, x)
    w = _segment_sum((jac.Jx * u[..., None]).sum(1), p, layout.num_points)
    y = (Hpp_inv * w[:, None, :]).sum(-1)
    v = (jac.Jx * y[p][:, None, :]).sum(-1)
    return _cam_side_sum(jac, obs, layout, u - v) + lam_diag * x


def rig_back_substitute_plain(jac: RigJacobians, obs: RigObs, layout: RigLayout, Hpp_inv, gx, x):
    """K26, back-substitution mode: dx = Hpp⁻¹ (gx - H_pc x) (l.364-370)."""
    u = _cam_side_apply(jac, obs, layout, x)
    w = _segment_sum((jac.Jx * u[..., None]).sum(1), obs.obs_point, layout.num_points)
    return (Hpp_inv * (gx - w)[:, None, :]).sum(-1)


# K27's plain versions ------------------------------------------------------


def gdlt_pose(X, origins, dirs, weights=None, estimate_scale: bool = False):
    """Generalized absolute pose from n >= 6 ray-point correspondences, any
    leading batch dimensions: X, origins, dirs (..., n, 3), weights (..., n).

    Least squares over the 12 entries of (R, t) on d × (R X + t - c) = 0,
    R projected onto SO(3); with ``estimate_scale`` the world scale is the
    mean singular value of the raw rotation block; then t re-solved.
    Returns (..., 3, 5) [R | t | s e1] (colmap_tpu's gdlt_pose, l.54-109).
    """
    dtype = X.dtype
    if weights is None:
        weights = torch.ones(X.shape[:-1], dtype=dtype, device=X.device)
    D = _skew(dirs)  # (..., n, 3, 3)
    A_R = torch.einsum("...nia,...nb->...niab", D, X).reshape(X.shape[:-1] + (3, 9))
    A = torch.cat([A_R, D], dim=-1)  # (..., n, 3, 12)
    b = torch.einsum("...nij,...nj->...ni", D, origins)
    sw = torch.sqrt(torch.clamp(weights, min=0.0))[..., None]
    A = (A * sw[..., None]).flatten(-3, -2)
    b = (b * sw).flatten(-2, -1)
    eye12 = torch.eye(12, dtype=dtype, device=X.device)
    At = A.transpose(-1, -2)
    u = torch.linalg.solve(At @ A + 1e-10 * eye12, (At @ b[..., None]))[..., 0]
    R_raw = u[..., :9].reshape(u.shape[:-1] + (3, 3))
    U, sv, Vt = torch.linalg.svd(R_raw)
    d = torch.sign(torch.linalg.det(U @ Vt))
    ones = torch.ones_like(d)
    R = U @ torch.diag_embed(torch.stack([ones, ones, d], dim=-1)) @ Vt
    s = sv.mean(-1) if estimate_scale else torch.ones_like(d)
    Xs = s[..., None, None] * X
    rhs = torch.einsum("...nij,...nj->...ni", D,
                       origins - torch.einsum("...ab,...nb->...na", R, Xs))
    Dw = D * weights[..., None, None]
    MtM = torch.einsum("...nki,...nkj->...ij", Dw, D)
    Mtb = torch.einsum("...nki,...nk->...i", Dw, rhs)
    t = torch.linalg.solve(MtM + 1e-10 * torch.eye(3, dtype=dtype, device=X.device),
                           Mtb[..., None])[..., 0]
    s_col = torch.cat([s[..., None], torch.zeros_like(t[..., :2])], dim=-1)
    return torch.cat([R, t[..., None], s_col[..., None]], dim=-1)


def _skew(v):
    z = torch.zeros_like(v[..., 0])
    return torch.stack([
        torch.stack([z, -v[..., 2], v[..., 1]], dim=-1),
        torch.stack([v[..., 2], z, -v[..., 0]], dim=-1),
        torch.stack([-v[..., 1], v[..., 0], z], dim=-1),
    ], dim=-2)


class GenAbsData(NamedTuple):
    """The correspondences of one generalized-absolute-pose RANSAC: world
    points, rays in rig coordinates (origin, unit direction), normalized
    observations in their cameras, each correspondence's cam_from_rig and
    its camera's mean focal length (the pixel scale of the error)."""

    X: torch.Tensor  # (N, 3)
    centers: torch.Tensor  # (N, 3)
    dirs: torch.Tensor  # (N, 3)
    uv: torch.Tensor  # (N, 2)
    cam_q: torch.Tensor  # (N, 4)
    cam_t: torch.Tensor  # (N, 3)
    focal: torch.Tensor  # (N,)
    mask: torch.Tensor  # (N,) bool


def gen_abs_residuals(models, data: GenAbsData):
    """Squared reprojection errors in pixels (M, N) of (M, 3, 5) models
    through each correspondence's cam_from_rig; inf behind the camera
    (colmap_tpu's residual, l.138-153)."""
    R, t, s = models[:, :, :3], models[:, :, 3], models[:, 0, 4]
    Xr = torch.einsum("mij,nj->mni", R, data.X) * s[:, None, None] + t[:, None, :]
    Xc = rot.quat_rotate(data.cam_q[None], Xr) + data.cam_t[None]
    z = Xc[..., 2]
    behind = z < 1e-8
    proj = Xc[..., :2] / torch.where(behind, 1.0, z)[..., None]
    err = ((proj - data.uv[None]) ** 2).sum(-1) * data.focal[None] ** 2
    return torch.where(behind, torch.inf, err)


def gen_abs_propose_score_plain(data: GenAbsData, samples, max_sq, estimate_scale: bool):
    """K27 propose-and-score: gdlt_pose on each 6-point sample, solved in
    float64 whatever the data's dtype (as the kernel solves), every model
    scored on all rows in the data's dtype. Returns models (K, 3, 5), counts
    (K,), packed best (1,)."""
    s = samples.long()
    X, c, d = (x[s].double() for x in (data.X, data.centers, data.dirs))
    models = gdlt_pose(X, c, d, estimate_scale=estimate_scale).to(data.X.dtype)
    res = gen_abs_residuals(models, data)
    counts = ((res <= max_sq) & data.mask[None]).sum(-1).to(i32)
    counts = torch.where(torch.isfinite(models.flatten(1)).all(-1), counts, 0)
    return models, counts, pack_best(counts)


def gen_abs_inliers_plain(data: GenAbsData, model, max_sq):
    return (gen_abs_residuals(model[None], data)[0] <= max_sq) & data.mask


# ---------------------------------------------------------------------------
# CUDA wrappers.
# ---------------------------------------------------------------------------

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_LAYOUT = [_P] * 7  # pt_offsets, pt_obs, seg_obs, chunk_row, chunk_start, chunk_end, row_chunks
_SIGNATURES = {
    "rig_ba_jacobians_f32": [_I, _I, _I, _F, _LL, _I] + [_P] * 23 + [_P],
    "rig_ba_reduce_f32": [_I] * 6 + [_F] + [_P] * 5 + _LAYOUT + [_P] * 10 + [_P],
    "rig_ba_matvec_f32": [_I, _LL, _I, _I, _I, _I, _I, _I] + [_P] * 8 + _LAYOUT + [_P] * 7
                         + [_P],
    "gen_abs_propose_score_f32": [_I, _I, _I, _F] + [_P] * 12 + [_P],
    "gen_abs_inliers_f32": [_I, _F] + [_P] * 8 + [_P],
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


def _opt(x):
    return S._P(0) if x is None else S._ptr(x)


def _check_model(model_id, P):
    if isinstance(model_id, tuple):
        raise NotImplementedError("rig problems that mix camera models are not ported yet; "
                                  "colmap_tpu handles them")
    if int(model_id) not in CUDA_MODELS:
        raise NotImplementedError(
            f"camera model {camera_models.MODEL_ID_TO_NAME[int(model_id)]} has no CUDA "
            "projection yet (csrc/camera_models.cuh implements models 0-4)")
    if P != camera_models.model_num_params(int(model_id)):
        raise ValueError(f"cam_params has {P} columns for model {model_id}")


def _k24_checks(quat, t, sensor_quat, sensor_t, cam_params, points, obs: RigObs, model_id, loss):
    dev = S._require_cuda(points)
    F, G = quat.shape[0], sensor_quat.shape[0]
    C, P = cam_params.shape
    N, O = points.shape[0], obs.obs_xy.shape[0]
    _check_model(model_id, P)
    if loss not in LOSSES:
        raise ValueError(loss)
    for name, x, dt, shape in (
        ("quat", quat, f32, (F, 4)), ("t", t, f32, (F, 3)),
        ("sensor_quat", sensor_quat, f32, (G, 4)), ("sensor_t", sensor_t, f32, (G, 3)),
        ("cam_params", cam_params, f32, (C, P)), ("points", points, f32, (N, 3)),
        ("obs_frame", obs.obs_frame, i32, (O,)), ("obs_sensor", obs.obs_sensor, i32, (O,)),
        ("obs_cam", obs.obs_cam, i32, (O,)), ("obs_point", obs.obs_point, i32, (O,)),
        ("obs_xy", obs.obs_xy, f32, (O, 2)), ("obs_w", obs.obs_w, f32, (O,)),
    ):
        S._check(name, x, dt, shape, dev)
    return dev, F, G, C, P, N, O


def _k24_args(quat, t, sensor_quat, sensor_t, cam_params, points, obs: RigObs):
    return tuple(map(S._ptr, (quat, t, sensor_quat, sensor_t, cam_params, points, obs.obs_frame,
                              obs.obs_sensor, obs.obs_cam, obs.obs_point, obs.obs_xy, obs.obs_w)))


def rig_obs_jacobians(quat, t, sensor_quat, sensor_t, cam_params, points, obs: RigObs,
                      pose_mask, sensor_mask, cam_mask, point_mask, model_id: int, loss: str,
                      loss_scale: float) -> RigJacobians:
    """K24, Jacobian mode. See rig_obs_jacobians_plain for the function."""
    if points.device.type == "cpu":
        return rig_obs_jacobians_plain(quat, t, sensor_quat, sensor_t, cam_params, points, obs,
                                       pose_mask, sensor_mask, cam_mask, point_mask, model_id,
                                       loss, loss_scale)
    dev, F, G, C, P, N, O = _k24_checks(quat, t, sensor_quat, sensor_t, cam_params, points, obs,
                                        model_id, loss)
    for name, x, shape in (("pose_mask", pose_mask, (F, 6)), ("sensor_mask", sensor_mask, (G,)),
                           ("cam_mask", cam_mask, (C, P)), ("point_mask", point_mask, (N,))):
        S._check(name, x, f32, shape, dev)
    e = functools.partial(torch.empty, dtype=f32, device=dev)
    out = RigJacobians(e(O, 2), e(O, 2, 6), e(O, 2, 6), e(O, 2, P), e(O, 2, 3))
    _call("rig_ba_jacobians_f32", int(model_id), 0, LOSSES[loss], float(loss_scale), O, P,
          *_k24_args(quat, t, sensor_quat, sensor_t, cam_params, points, obs),
          *map(S._ptr, (pose_mask, sensor_mask, cam_mask, point_mask, *out)), _P(0), _P(0),
          S._stream(dev))
    LAUNCHES["rig_ba_jacobians"] += 1
    return out


K24_COST_BLOCK = 256


def rig_obs_cost(quat, t, sensor_quat, sensor_t, cam_params, points, obs: RigObs, model_id: int,
                 loss: str, loss_scale: float):
    """K24, cost mode: ½ Σ ρ(‖r‖²)·w as a 0-d float32 tensor, summed in
    double by blocks in a fixed tree. See rig_obs_cost_plain."""
    if points.device.type == "cpu":
        return rig_obs_cost_plain(quat, t, sensor_quat, sensor_t, cam_params, points, obs,
                                  model_id, loss, loss_scale)
    dev, F, G, C, P, N, O = _k24_checks(quat, t, sensor_quat, sensor_t, cam_params, points, obs,
                                        model_id, loss)
    partials = torch.empty(max(1, -(-O // K24_COST_BLOCK)), dtype=f64, device=dev)
    cost = torch.empty((), dtype=f64, device=dev)
    _call("rig_ba_jacobians_f32", int(model_id), 1, LOSSES[loss], float(loss_scale), O, P,
          *_k24_args(quat, t, sensor_quat, sensor_t, cam_params, points, obs),
          *([_P(0)] * 9), S._ptr(partials), S._ptr(cost), S._stream(dev))
    LAUNCHES["rig_ba_jacobians"] += 1
    return cost.to(f32)


def _layout_checks(layout: RigLayout, dev, O):
    N, R = layout.num_points, layout.num_frames + layout.num_sensors + layout.num_cams
    K = layout.chunk_row.shape[0]
    for name, x, shape in (
        ("pt_offsets", layout.pt_offsets, (N + 1,)), ("pt_obs", layout.pt_obs, (O,)),
        ("seg_obs", layout.seg_obs, (3 * O,)), ("chunk_row", layout.chunk_row, (K,)),
        ("chunk_start", layout.chunk_start, (K,)), ("chunk_end", layout.chunk_end, (K,)),
        ("row_chunks", layout.row_chunks, (R + 1,)),
    ):
        S._check(name, x, i32, shape, dev)
    return tuple(map(S._ptr, layout[:7])), K, R


def _jac_checks(jac: RigJacobians, obs: RigObs, layout: RigLayout):
    dev = S._require_cuda(jac.Jx)
    O, P = jac.r.shape[0], layout.num_params
    for name, x, dt, shape in (
        ("r", jac.r, f32, (O, 2)), ("Jf", jac.Jf, f32, (O, 2, 6)), ("Js", jac.Js, f32, (O, 2, 6)),
        ("Jc", jac.Jc, f32, (O, 2, P)), ("Jx", jac.Jx, f32, (O, 2, 3)),
        ("obs_frame", obs.obs_frame, i32, (O,)), ("obs_sensor", obs.obs_sensor, i32, (O,)),
        ("obs_cam", obs.obs_cam, i32, (O,)), ("obs_point", obs.obs_point, i32, (O,)),
    ):
        S._check(name, x, dt, shape, dev)
    lay, K, R = _layout_checks(layout, dev, O)
    ids = tuple(map(S._ptr, (obs.obs_frame, obs.obs_sensor, obs.obs_cam, obs.obs_point)))
    return dev, O, P, K, R, lay, ids


def rig_lm_reduce(jac: RigJacobians, obs: RigObs, layout: RigLayout, lam: float) -> RigReduction:
    """K25. See rig_lm_reduce_plain for the function."""
    if jac.Jx.device.type == "cpu":
        return rig_lm_reduce_plain(jac, obs, layout, lam)
    dev, O, P, K, R, lay, ids = _jac_checks(jac, obs, layout)
    N = layout.num_points
    e = functools.partial(torch.empty, dtype=f32, device=dev)
    out = RigReduction(g=e(R, W), b=e(R, W), diag=e(R, W), lam_diag=e(R, W), precond=e(R, W),
                       gx=e(N, 3), Hpp_inv=e(N, 3, 3), diag_x=e(N, 3))
    q, partials = e(O, 2), e(K, 3 * W)
    _call("rig_ba_reduce_f32", N, layout.num_frames, layout.num_sensors, layout.num_cams, P, K,
          float(lam), *map(S._ptr, (jac.r, jac.Jf, jac.Js, jac.Jc, jac.Jx)), *lay,
          *map(S._ptr, (q, partials, out.gx, out.Hpp_inv, out.diag_x, out.g, out.b, out.diag,
                        out.lam_diag, out.precond)), S._stream(dev))
    LAUNCHES["rig_ba_reduce"] += 1
    return out


def _k26(mode, jac: RigJacobians, obs: RigObs, layout: RigLayout, Hpp_inv, lam_diag, gx, x):
    dev, O, P, K, R, lay, ids = _jac_checks(jac, obs, layout)
    N = layout.num_points
    x = x.contiguous()
    S._check("x", x, f32, (R, W), dev)
    S._check("Hpp_inv", Hpp_inv, f32, (N, 3, 3), dev)
    if mode == 0:
        S._check("lam_diag", lam_diag, f32, (R, W), dev)
        out = torch.empty(R, W, dtype=f32, device=dev)
    else:
        S._check("gx", gx, f32, (N, 3), dev)
        out = torch.empty(N, 3, dtype=f32, device=dev)
    uz = torch.empty(O, 2, dtype=f32, device=dev)
    partials = torch.empty(K, W, dtype=f32, device=dev)
    _call("rig_ba_matvec_f32", mode, O, N, layout.num_frames, layout.num_sensors,
          layout.num_cams, P, K, *map(S._ptr, (jac.Jf, jac.Js, jac.Jc, jac.Jx)), *ids, *lay,
          S._ptr(Hpp_inv), _opt(lam_diag), _opt(gx), S._ptr(x), S._ptr(uz), S._ptr(partials),
          S._ptr(out), S._stream(dev))
    LAUNCHES["rig_ba_matvec"] += 1
    return out


def rig_schur_matvec(jac: RigJacobians, obs: RigObs, layout: RigLayout, Hpp_inv, lam_diag, x):
    """K26, matvec mode. See rig_schur_matvec_plain for the function."""
    if jac.Jx.device.type == "cpu":
        return rig_schur_matvec_plain(jac, obs, layout, Hpp_inv, lam_diag, x)
    return _k26(0, jac, obs, layout, Hpp_inv, lam_diag, None, x)


def rig_back_substitute(jac: RigJacobians, obs: RigObs, layout: RigLayout, Hpp_inv, gx, x):
    """K26, back-substitution mode. See rig_back_substitute_plain."""
    if jac.Jx.device.type == "cpu":
        return rig_back_substitute_plain(jac, obs, layout, Hpp_inv, gx, x)
    return _k26(1, jac, obs, layout, Hpp_inv, None, gx, x)


def _k27_checks(data: GenAbsData):
    dev = S._require_cuda(data.X)
    n = data.X.shape[0]
    for name, x, width in (("X", data.X, 3), ("centers", data.centers, 3),
                           ("dirs", data.dirs, 3), ("uv", data.uv, 2), ("cam_q", data.cam_q, 4),
                           ("cam_t", data.cam_t, 3)):
        S._check(name, x, f32, (n, width), dev)
    S._check("focal", data.focal, f32, (n,), dev)
    S._check("mask", data.mask, torch.bool, (n,), dev)
    return dev, n


def gen_abs_propose_score(data: GenAbsData, samples, max_sq, estimate_scale: bool):
    """K27 propose-and-score. samples (K, 6) int32. Returns models (K, 3, 5),
    counts (K,), packed best (1,)."""
    if data.X.device.type == "cpu":
        return gen_abs_propose_score_plain(data, samples, max_sq, estimate_scale)
    dev, n = _k27_checks(data)
    k = samples.shape[0]
    S._check("samples", samples, i32, (k, GDLT_SAMPLE), dev)
    models = torch.empty(k, 3, 5, dtype=f32, device=dev)
    counts = torch.empty(k, dtype=i32, device=dev)
    best = torch.zeros(1, dtype=torch.int64, device=dev)
    _call("gen_abs_propose_score_f32", n, k, int(bool(estimate_scale)), float(max_sq),
          *map(S._ptr, (data.X, data.centers, data.dirs, data.uv, data.cam_q, data.cam_t,
                        data.focal, data.mask, samples, models, counts, best)), S._stream(dev))
    LAUNCHES["gen_abs_ransac"] += 1
    return models, counts, best


def gen_abs_inliers(data: GenAbsData, model, max_sq):
    """K27 inlier mask (N,) of one (3, 5) model."""
    if data.X.device.type == "cpu":
        return gen_abs_inliers_plain(data, model, max_sq)
    dev, n = _k27_checks(data)
    model = model.to(f32).contiguous()
    S._check("model", model, f32, (3, 5), dev)
    inl = torch.empty(n, dtype=torch.bool, device=dev)
    if n:
        _call("gen_abs_inliers_f32", n, float(max_sq),
              *map(S._ptr, (data.X, data.uv, data.cam_q, data.cam_t, data.focal, data.mask, model,
                            inl)), S._stream(dev))
        LAUNCHES["gen_abs_ransac"] += 1
    return inl


class RigKernels(NamedTuple):
    obs_jacobians: object
    obs_cost: object
    lm_reduce: object
    schur_matvec: object
    back_substitute: object


KERNELS = RigKernels(rig_obs_jacobians, rig_obs_cost, rig_lm_reduce, rig_schur_matvec,
                     rig_back_substitute)
PLAIN = RigKernels(rig_obs_jacobians_plain, rig_obs_cost_plain, rig_lm_reduce_plain,
                   rig_schur_matvec_plain, rig_back_substitute_plain)
