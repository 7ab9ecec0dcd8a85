"""Rig kernels: wrappers, plain PyTorch versions, launch counts.

Seven CUDA kernels carry the device programs of the rig paths of the
incremental mapper and of the generalized relative pose (sources in
``colmap_tpu_torch/csrc``):

    K24 rig_ba_jacobians   rig_obs_jacobians, rig_obs_cost
    K25 rig_ba_reduce      rig_lm_reduce
    K26 rig_ba_matvec      rig_schur_matvec, rig_back_substitute
    K27 gen_abs_ransac     gen_abs_propose_score, gen_abs_inliers
    K38 rig_lm_update      rig_lm_candidate, rig_lm_accept
    K40 gen_abs_refine     gen_abs_refine, gen_abs_refit
    K48 gen_rel_ransac     gen_rel_propose_score, gen_rel_inliers, gen_rel_refit

K24-K26 and K38 carry colmap_tpu/estimators/bundle_adjustment_rig.py
(``lm_step`` and ``lm_solve_fused``; the PCG between them is K34 of
kernels/solver.py); K27 carries ``_gen_abs_ransac`` of
colmap_tpu/estimators/generalized_pose.py, K40 its
``refine_generalized_absolute_pose`` and the weighted ``gdlt_pose`` of the
LO refit, in float64; K48 carries ``_gen_rel_ransac`` (the 17-point
generalized relative pose, ``g17_relative_pose`` and the LO step's
``_weighted_g17``), its solves in float64. As the other kernel modules do,
each wrapper runs the plain version when its tensors lie on the CPU and
launches the kernel when they lie on a CUDA device; on a CUDA tensor it
launches or raises, it never falls back. ``LAUNCHES`` counts kernel launches
by kernel name (a wrapper adds one where it launches, nowhere else). The
plain versions are written for any float dtype: the tests run them in
float64 against colmap_tpu, and a check on the card holds the kernels
against them. ``KERNELS`` bundles the BA wrappers (with K34's, which the
rig's PCG runs), which the solver runs, and ``PLAIN`` their plain versions,
which only the solver's private loop takes.

The camera side of a rig problem: R = F + G + C rows, frames (F, 6 columns:
rotation then translation), sensors (G, 6) and cameras (C, P), kept in one
(R, W) tensor whose unused columns are 0: W = 8 when P <= 8, else 17 (the 16
parameters of RAD_TAN_THIN_PRISM_FISHEYE, or a mixed problem's widest model
and its model-position column; ``row_width``). PCG runs on that one tensor.
A problem that mixes camera models runs K24 once per model over that
model's observations, as K1 does (kernels/ba.py model_groups; the solver
builds the groups once and passes them as ``groups``). ``rig_layout``
builds the CSR lists the kernels sum over
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
from colmap_tpu_torch.kernels.ba import (
    LOSSES,
    _check_model,
    _groups,
    _row_width,
    _segment_sum,
    inv3x3_spd,
)
from colmap_tpu_torch.kernels.global_sfm import csr
from colmap_tpu_torch.kernels.solver import (
    LM_FIELDS,
    lm_accept_plain,
    pcg_setup_diag,
    pcg_setup_diag_plain,
    pcg_step,
    pcg_step_plain,
)
from colmap_tpu_torch.kernels.tally import ShapeTally
from colmap_tpu_torch.optim.ransac import pack_best
from colmap_tpu_torch.sensor import models as camera_models

LAUNCHES = {
    "rig_ba_jacobians": 0,
    "rig_ba_reduce": 0,
    "rig_ba_matvec": 0,
    "gen_abs_ransac": 0,
    "rig_lm_update": 0,
    "gen_abs_refine": 0,
    "gen_rel_ransac": 0,
}
# Launch shapes of K26, counted where LAUNCHES is (kernels/tally.py).
SHAPES = ShapeTally()

W = 8  # columns of a camera-side row: 6 for frames and sensors, P <= 8 for cameras
WIDE_W = 17  # the camera-side row width when P > 8
CHUNK = 1024  # camera-side entries one block of K25 / K26 sums
GDLT_SAMPLE = 6
G17_SAMPLE = 17

f32, f64, i32 = torch.float32, torch.float64, torch.int32


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    SHAPES.reset()


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


def row_width(P: int) -> int:
    """Columns of the camera-side tensor for camera rows of P columns."""
    return W if P <= W else WIDE_W


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


def _subset(obs: RigObs, slots) -> RigObs:
    s = slots.long()
    return RigObs(*(x[s] for x in obs))


def rig_obs_cost_plain(quat, t, sensor_quat, sensor_t, cam_params, points, obs: RigObs,
                       model_id, loss: str, loss_scale: float, groups=None):
    """½ Σ ρ(‖r‖²)·w over all observations, non-finite terms dropped (K24
    cost mode; colmap_tpu's compute_cost); a tuple of models by model."""
    if isinstance(model_id, tuple):
        total = obs.obs_xy.new_zeros(())
        for m, slots in _groups(groups, model_id, cam_params, obs.obs_cam):
            total = total + rig_obs_cost_plain(
                quat, t, sensor_quat, sensor_t, cam_params[:, :camera_models.model_num_params(m)],
                points, _subset(obs, slots), m, loss, loss_scale)
        return total
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
                            pose_mask, sensor_mask, cam_mask, point_mask, model_id,
                            loss: str, loss_scale: float, groups=None) -> RigJacobians:
    """K24's function: jacfwd + vmap over ``rig_residual`` (colmap_tpu's
    _obs_jacobians), the robust IRLS weight times obs_w, zero rows where
    anything is not finite, √w scaling, then the masks of _apply_masks:
    pose_mask (F, 6) rotation and translation columns, sensor_mask (G,),
    cam_mask (C, P), point_mask (N,). A tuple of models runs each model on
    its observations, Jc zero in the columns the model does not have."""
    if isinstance(model_id, tuple):
        O, Wc = obs.obs_xy.shape[0], cam_params.shape[1]
        z = obs.obs_xy.new_zeros
        out = RigJacobians(z(O, 2), z(O, 2, 6), z(O, 2, 6), z(O, 2, Wc), z(O, 2, 3))
        for m, slots in _groups(groups, model_id, cam_params, obs.obs_cam):
            P, s = camera_models.model_num_params(m), slots.long()
            jac = rig_obs_jacobians_plain(quat, t, sensor_quat, sensor_t, cam_params[:, :P],
                                          points, _subset(obs, slots), pose_mask, sensor_mask,
                                          cam_mask[:, :P], point_mask, m, loss, loss_scale)
            out.r[s], out.Jf[s], out.Js[s], out.Jx[s] = jac.r, jac.Jf, jac.Js, jac.Jx
            out.Jc[s, :, :P] = jac.Jc
        return out
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
    """The three camera-side Jacobian blocks padded to the row width."""
    P = jac.Jc.shape[-1]
    w = row_width(P)
    pad = torch.nn.functional.pad
    return pad(jac.Jf, (0, w - 6)), pad(jac.Js, (0, w - 6)), pad(jac.Jc, (0, w - P))


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
                        lam) -> RigReduction:
    """K25's function: lm_step's gradients (l.350-353), _build_schur's
    point blocks and damping (l.238-252), the reduced right-hand side
    (l.356-361) and _pcg's Jacobi preconditioner (l.284-290). lam a float
    or a 0-d tensor."""
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


# K38's and K40's plain versions -------------------------------------------


def rig_lm_candidate_plain(state, x, dx, red: RigReduction, lam):
    """K38 candidate: colmap_tpu's _apply_update (l.319) on the state
    (quat, t, sensor_quat, sensor_t, cam_params, points) with the (R, W)
    camera-side step x and the point step dx, and lm_step's predicted
    decrease (l.378-387) 0.5 (x.g + dx.gx + lam (diag x^2 + diag_x dx^2)).
    Returns (the candidate state, pred 0-d float64)."""
    quat, t, squat, st, cam, points = state
    F, G, P = quat.shape[0], squat.shape[0], cam.shape[1]
    df, ds, dc = x[:F, :6], x[F:F + G, :6], x[F + G:, :P]
    cand = (rot.quat_normalize(rot.quat_multiply(quat_exp(df[:, :3]), quat)), t + df[:, 3:],
            rot.quat_normalize(rot.quat_multiply(quat_exp(ds[:, :3]), squat)), st + ds[:, 3:],
            cam + dc, points + dx)
    pred = 0.5 * ((x * red.g).sum() + (dx * red.gx).sum()
                  + lam * ((red.diag * x * x).sum() + (red.diag_x * dx * dx).sum()))
    return cand, pred.double()


# K38 accept, in place: K35's rule (the gain ratio, the damping update, the
# last accepted cost, the done test of lm_solve_fused l.409-424, frozen once
# done) on the six state tensors; solver.lm_accept_plain takes any state.
rig_lm_accept_plain = lm_accept_plain


def _gen_abs_row_terms(data64, q, t, loss_scale: float, w_in, jacobian: bool):
    """Residuals (n, 2), weights (n,) and, with ``jacobian``, the analytic
    Jacobians (n, 2, 6) at delta = 0 of refine_generalized_absolute_pose's
    residual (colmap_tpu l.296-306): rotation columns -[R X]x, translation
    I, through cam_from_rig; 0 in z where the depth is clamped."""
    X, uv, cam_q, cam_t, focal = data64
    n = X.shape[0]
    Y = rot.quat_rotate(q.expand(n, 4), X)
    Xc = rot.quat_rotate(cam_q, Y + t) + cam_t
    clamped = ~(Xc[:, 2] > 1e-8)
    z = torch.where(clamped, 1e-8, Xc[:, 2])
    proj = Xc[:, :2] / z[:, None]
    r = (proj - uv) * focal[:, None]
    e2 = (r * r).sum(1)
    wt = torch.sqrt(1.0 / (1.0 + e2 / loss_scale ** 2)) * torch.sqrt(w_in)
    if not jacobian:
        return r, wt, None
    eye = torch.eye(3, dtype=X.dtype, device=X.device)
    cols = torch.cat([torch.linalg.cross(eye[None].expand(n, 3, 3),
                                         Y[:, None, :].expand(n, 3, 3), dim=-1),
                      eye[None].expand(n, 3, 3)], dim=1)  # (n, 6, 3): dXr / d delta_c
    dXc = rot.quat_rotate(cam_q[:, None, :].expand(n, 6, 4), cols)  # (n, 6, 3)
    dz = torch.where(clamped[:, None], 0.0, dXc[..., 2])
    J = torch.stack([dXc[..., 0] - proj[:, :1] * dz, dXc[..., 1] - proj[:, 1:] * dz], dim=1)
    return r, wt, J * (focal / z)[:, None, None]


def gen_abs_refine_plain(X, uv, cam_q, cam_t, focal, w_in, q0, t0, num_iterations: int = 30,
                         loss_scale: float = 1.0, trace=None):
    """K40 (a): colmap_tpu's refine_generalized_absolute_pose loop (l.262-345)
    with the analytic Jacobian: Cauchy x inlier weights, LM on the 6-DoF rig
    tangent, accept / reject with lam x 0.3 (>= 1e-10) / x 10 (<= 1e8), the
    1e-12 relative early stop. Rows float64. Returns (q (4,), t (3,)); a
    ``trace`` list receives each iteration's accept decision."""
    data = (X, uv, cam_q, cam_t, focal)
    q, t = q0, t0
    lam, prev_cost = 1e-4, None
    for _ in range(num_iterations):
        r, wt, J = _gen_abs_row_terms(data, q, t, loss_scale, w_in, True)
        Jw = (J * wt[:, None, None]).reshape(-1, 6)
        rw = (r * wt[:, None]).reshape(-1)
        cost = float((rw ** 2).sum())
        H = Jw.T @ Jw
        step = torch.linalg.solve(H + lam * torch.diag(torch.diagonal(H) + 1e-12), -(Jw.T @ rw))
        dq = rot.quat_normalize(torch.cat([torch.ones_like(step[:1]), 0.5 * step[:3]]))
        qc, tc = rot.quat_multiply(dq, q), t + step[3:]
        r_new, wt_new, _ = _gen_abs_row_terms(data, qc, tc, loss_scale, w_in, False)
        new_cost = float(((r_new * wt_new[:, None]) ** 2).sum())
        if trace is not None:
            trace.append(new_cost < cost)
        if new_cost < cost:
            q, t = qc, tc
            lam = max(lam * 0.3, 1e-10)
            if prev_cost is not None and abs(prev_cost - new_cost) < 1e-12 * max(prev_cost, 1.0):
                break
            prev_cost = new_cost
        else:
            lam = min(lam * 10.0, 1e8)
    return q, t


def gen_abs_refit_plain(X, centers, dirs, weights, estimate_scale: bool):
    """K40 (b): the weighted gdlt_pose (l.54-109) over every row with its
    weight, and whether the model is finite. Returns (model (3, 5), ok (1,)
    bool)."""
    model = gdlt_pose(X, centers, dirs, weights, estimate_scale)
    ok = torch.isfinite(model).all().reshape(1)
    return torch.where(ok, model, torch.nan), ok


# K48's plain versions ------------------------------------------------------


class GenRelData(NamedTuple):
    """The correspondences of one generalized-relative-pose RANSAC: each
    row's Plücker rays in its rig frame (direction and moment c × d of the
    ray in rig 1, then in rig 2; float64, the solves' type), its normalized
    observations, the cam_from_rig of its two cameras and the geometric mean
    of their focal lengths (the pixel scale of the error)."""

    rays: torch.Tensor  # (N, 12) float64: d1, m1, d2, m2
    obs: torch.Tensor  # (N, 4): uv1, uv2
    cams: torch.Tensor  # (N, 14): q1 (wxyz), t1, q2, t2
    focal: torch.Tensor  # (N,)
    mask: torch.Tensor  # (N,) bool


def g17_solve(d1, m1, d2, m2, weights=None):
    """The (weighted) 17-point linear solve of the generalized epipolar
    constraint q2' E q1 + q2' R m1 + m2' R q1 = 0, any leading batch
    dimensions: d1, m1, d2, m2 (..., n, 3), weights (..., n). The smallest
    eigenvector of AᵀA, its sign fixed so that the rotation block has det >=
    0, the block projected onto SO(3), E divided by the signed mean singular
    value and t taken from E Rᵀ = [t]x. Returns (..., 3, 4) rig2_from_rig1
    (colmap_tpu's g17_relative_pose, l.349-383, and _weighted_g17,
    l.454-476, which take eigh's sign as it comes)."""
    cE = torch.einsum("...ni,...nj->...nij", d2, d1).flatten(-2)
    cR = (torch.einsum("...ni,...nj->...nij", d2, m1)
          + torch.einsum("...ni,...nj->...nij", m2, d1)).flatten(-2)
    A = torch.cat([cE, cR], dim=-1)
    if weights is not None:
        A = A * torch.sqrt(torch.clamp(weights, min=0.0))[..., None]
    _, vecs = torch.linalg.eigh(A.transpose(-1, -2) @ A)
    u = vecs[..., 0]
    R_raw = u[..., 9:].reshape(u.shape[:-1] + (3, 3))
    sign = torch.where(torch.linalg.det(R_raw) < 0, -1.0, 1.0).to(u.dtype)
    u = u * sign[..., None]
    E_raw = u[..., :9].reshape(u.shape[:-1] + (3, 3))
    R_raw = R_raw * sign[..., None, None]
    U, sv, Vt = torch.linalg.svd(R_raw)
    d = torch.sign(torch.linalg.det(U @ Vt))
    ones = torch.ones_like(d)
    R = U @ torch.diag_embed(torch.stack([ones, ones, d], dim=-1)) @ Vt
    lam = sv.mean(-1) * d
    E = E_raw / torch.where(lam.abs() < 1e-12, 1.0, lam)[..., None, None]
    T = E @ R.transpose(-1, -2)
    t = 0.5 * torch.stack([T[..., 2, 1] - T[..., 1, 2], T[..., 0, 2] - T[..., 2, 0],
                           T[..., 1, 0] - T[..., 0, 1]], dim=-1)
    return torch.cat([R, t[..., None]], dim=-1)


def _rays(rays):
    return rays[..., 0:3], rays[..., 3:6], rays[..., 6:9], rays[..., 9:12]


def gen_rel_residuals(models, data: GenRelData):
    """Squared Sampson errors in pixels (M, N) of (M, 3, 4) rig2_from_rig1
    models, each row through the relative pose of its two cameras
    (colmap_tpu's residual, l.414-441)."""
    q1, t1, q2, t2 = (data.cams[:, 0:4], data.cams[:, 4:7], data.cams[:, 7:11],
                      data.cams[:, 11:14])
    R1, R2 = rot.quat_to_rotmat(q1), rot.quat_to_rotmat(q2)
    Rm, tm = models[:, :, :3], models[:, :, 3]
    R_rel = torch.einsum("nab,mbc,ndc->mnad", R2, Rm, R1)
    c1 = -torch.einsum("nba,nb->na", R1, t1)
    t_rel = torch.einsum("nab,mnb->mna", R2,
                         torch.einsum("mab,nb->mna", Rm, c1) + tm[:, None]) + t2
    E = _skew(t_rel) @ R_rel
    ones = torch.ones_like(data.obs[:, :1])
    x1h = torch.cat([data.obs[:, 0:2], ones], 1)
    x2h = torch.cat([data.obs[:, 2:4], ones], 1)
    Ex1 = torch.einsum("mnij,nj->mni", E, x1h)
    Etx2 = torch.einsum("mnji,nj->mni", E, x2h)
    num = (x2h * Ex1).sum(-1) ** 2
    den = Ex1[..., 0] ** 2 + Ex1[..., 1] ** 2 + Etx2[..., 0] ** 2 + Etx2[..., 1] ** 2
    return num / torch.clamp(den, min=1e-12) * data.focal ** 2


def gen_rel_propose_score_plain(data: GenRelData, samples, max_sq):
    """K48 propose-and-score: g17_solve on each 17-row sample in float64,
    every model scored on all rows in the observations' dtype. Returns
    models (K, 3, 4), counts (K,), packed best (1,)."""
    d1, m1, d2, m2 = _rays(data.rays[samples.long()].double())
    models = g17_solve(d1, m1, d2, m2).to(data.obs.dtype)
    res = gen_rel_residuals(models, data)
    counts = ((res <= max_sq) & data.mask[None]).sum(-1).to(i32)
    counts = torch.where(torch.isfinite(models.flatten(1)).all(-1), counts, 0)
    return models, counts, pack_best(counts)


def gen_rel_inliers_plain(data: GenRelData, model, max_sq):
    return (gen_rel_residuals(model[None].to(data.obs.dtype), data)[0] <= max_sq) & data.mask


def gen_rel_refit_plain(rays, weights):
    """K48 (c): the weighted 17-point solve over every row, float64. Returns
    (model (3, 4), NaN where not finite; ok (1,) bool)."""
    model = g17_solve(*_rays(rays), weights)
    ok = torch.isfinite(model).all().reshape(1)
    return torch.where(ok, model, torch.nan), ok


# ---------------------------------------------------------------------------
# CUDA wrappers.
# ---------------------------------------------------------------------------

_P, _I, _LL, _F, _D = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float,
                       ctypes.c_double)
_LAYOUT = [_P] * 7  # pt_offsets, pt_obs, seg_obs, chunk_row, chunk_start, chunk_end, row_chunks
_SIGNATURES = {
    "rig_ba_jacobians_f32": [_I, _I, _I, _F, _LL, _I, _I, _P] + [_P] * 23 + [_P],
    "rig_ba_reduce_f32": [_I] * 7 + [_P] + [_P] * 5 + _LAYOUT + [_P] * 10 + [_P],
    "rig_ba_matvec_f32": [_I, _LL, _I, _I, _I, _I, _I, _I, _I] + [_P] * 8 + _LAYOUT
                         + [_P] * 7 + [_P],
    "gen_abs_propose_score_f32": [_I, _I, _I, _F] + [_P] * 12 + [_P],
    "gen_abs_inliers_f32": [_I, _F] + [_P] * 8 + [_P],
    "rig_lm_candidate_f32": [_I] * 5 + [_LL] + [_P] * 21 + [_I, _P],
    "rig_lm_accept_f32": [_I, _I, _I, _LL] + [_P] * 4 + [_D] * 3 + [_P] * 13 + [_I, _P],
    "gen_abs_refine_f64": [_I, _I, _D] + [_P] * 10 + [_P],
    "gen_abs_refit_f64": [_I, _I] + [_P] * 6 + [_P],
    "gen_rel_propose_score_f32": [_I, _I, _F] + [_P] * 9 + [_P],
    "gen_rel_inliers_f32": [_I, _F] + [_P] * 6 + [_P],
    "gen_rel_refit_f64": [_I] + [_P] * 5 + [_P],
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


def _k24_checks(quat, t, sensor_quat, sensor_t, cam_params, points, obs: RigObs, model_id, loss):
    dev = S._require_cuda(points)
    F, G = quat.shape[0], sensor_quat.shape[0]
    C, P = cam_params.shape
    N, O = points.shape[0], obs.obs_xy.shape[0]
    _check_model(model_id)
    if P != _row_width(model_id):
        raise ValueError(f"cam_params has {P} columns for model {model_id}")
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


def _k24_launch(mode, model, slots, n, cam_params, args, rest, loss, loss_scale, dev):
    _call("rig_ba_jacobians_f32", model, mode, LOSSES[loss], float(loss_scale), n,
          camera_models.model_num_params(model), cam_params.shape[1], _opt(slots), *args, *rest,
          S._stream(dev))
    LAUNCHES["rig_ba_jacobians"] += 1


def rig_obs_jacobians(quat, t, sensor_quat, sensor_t, cam_params, points, obs: RigObs,
                      pose_mask, sensor_mask, cam_mask, point_mask, model_id, loss: str,
                      loss_scale: float, groups=None) -> RigJacobians:
    """K24, Jacobian mode. See rig_obs_jacobians_plain for the function."""
    if points.device.type == "cpu":
        return rig_obs_jacobians_plain(quat, t, sensor_quat, sensor_t, cam_params, points, obs,
                                       pose_mask, sensor_mask, cam_mask, point_mask, model_id,
                                       loss, loss_scale, groups)
    dev, F, G, C, P, N, O = _k24_checks(quat, t, sensor_quat, sensor_t, cam_params, points, obs,
                                        model_id, loss)
    for name, x, shape in (("pose_mask", pose_mask, (F, 6)), ("sensor_mask", sensor_mask, (G,)),
                           ("cam_mask", cam_mask, (C, P)), ("point_mask", point_mask, (N,))):
        S._check(name, x, f32, shape, dev)
    e = functools.partial(torch.empty, dtype=f32, device=dev)
    out = RigJacobians(e(O, 2), e(O, 2, 6), e(O, 2, 6), e(O, 2, P), e(O, 2, 3))
    if O == 0:
        return out
    args = _k24_args(quat, t, sensor_quat, sensor_t, cam_params, points, obs)
    rest = (*map(S._ptr, (pose_mask, sensor_mask, cam_mask, point_mask, *out)), _P(0), _P(0))
    for m, slots in _groups(groups, model_id, cam_params, obs.obs_cam):
        n = O if slots is None else slots.shape[0]
        _k24_launch(0, m, slots, n, cam_params, args, rest, loss, loss_scale, dev)
    return out


K24_COST_BLOCK = 256


def rig_obs_cost64(quat, t, sensor_quat, sensor_t, cam_params, points, obs: RigObs, model_id,
                   loss: str, loss_scale: float, groups=None):
    """K24, cost mode: ½ Σ ρ(‖r‖²)·w as a 0-d float64 tensor, summed in
    double by blocks in a fixed tree (and over the models of a mixed
    problem in their order); the LM loop keeps it on the card. See
    rig_obs_cost_plain."""
    if points.device.type == "cpu":
        return rig_obs_cost_plain(quat, t, sensor_quat, sensor_t, cam_params, points, obs,
                                  model_id, loss, loss_scale, groups).double()
    dev, F, G, C, P, N, O = _k24_checks(quat, t, sensor_quat, sensor_t, cam_params, points, obs,
                                        model_id, loss)
    args = _k24_args(quat, t, sensor_quat, sensor_t, cam_params, points, obs)
    costs = []
    for m, slots in _groups(groups, model_id, cam_params, obs.obs_cam):
        n = O if slots is None else slots.shape[0]
        partials = torch.empty(max(1, -(-n // K24_COST_BLOCK)), dtype=f64, device=dev)
        costs.append(torch.empty((), dtype=f64, device=dev))
        _k24_launch(1, m, slots, n, cam_params, args,
                    (*([_P(0)] * 9), S._ptr(partials), S._ptr(costs[-1])), loss, loss_scale, dev)
    if not costs:
        return torch.zeros((), dtype=f64, device=dev)
    return sum(costs[1:], costs[0])


def rig_obs_cost(quat, t, sensor_quat, sensor_t, cam_params, points, obs: RigObs, model_id,
                 loss: str, loss_scale: float, groups=None):
    """K24, cost mode as a 0-d float32 tensor (rig_obs_cost64 rounded). See
    rig_obs_cost_plain for the function."""
    if points.device.type == "cpu":
        return rig_obs_cost_plain(quat, t, sensor_quat, sensor_t, cam_params, points, obs,
                                  model_id, loss, loss_scale, groups)
    return rig_obs_cost64(quat, t, sensor_quat, sensor_t, cam_params, points, obs, model_id,
                          loss, loss_scale, groups).to(f32)


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


def rig_lm_reduce(jac: RigJacobians, obs: RigObs, layout: RigLayout, lam) -> RigReduction:
    """K25. lam a 0-d float32 tensor on the card (the LM loop's, which K38
    updates; a float is copied to the card first). See rig_lm_reduce_plain
    for the function."""
    if jac.Jx.device.type == "cpu":
        return rig_lm_reduce_plain(jac, obs, layout, lam)
    dev, O, P, K, R, lay, ids = _jac_checks(jac, obs, layout)
    if not torch.is_tensor(lam):
        lam = torch.full((), float(lam), dtype=f32, device=dev)
    S._check("lam", lam, f32, (), dev)
    N, w = layout.num_points, row_width(P)
    e = functools.partial(torch.empty, dtype=f32, device=dev)
    out = RigReduction(g=e(R, w), b=e(R, w), diag=e(R, w), lam_diag=e(R, w), precond=e(R, w),
                       gx=e(N, 3), Hpp_inv=e(N, 3, 3), diag_x=e(N, 3))
    q, partials = e(O, 2), e(K, 3 * w)
    _call("rig_ba_reduce_f32", N, layout.num_frames, layout.num_sensors, layout.num_cams, P, K, w,
          S._ptr(lam), *map(S._ptr, (jac.r, jac.Jf, jac.Js, jac.Jc, jac.Jx)), *lay,
          *map(S._ptr, (q, partials, out.gx, out.Hpp_inv, out.diag_x, out.g, out.b, out.diag,
                        out.lam_diag, out.precond)), S._stream(dev))
    LAUNCHES["rig_ba_reduce"] += 1
    return out


def _k26(mode, jac: RigJacobians, obs: RigObs, layout: RigLayout, Hpp_inv, lam_diag, gx, x):
    dev, O, P, K, R, lay, ids = _jac_checks(jac, obs, layout)
    N, w = layout.num_points, row_width(P)
    x = x.contiguous()
    S._check("x", x, f32, (R, w), dev)
    S._check("Hpp_inv", Hpp_inv, f32, (N, 3, 3), dev)
    if mode == 0:
        S._check("lam_diag", lam_diag, f32, (R, w), dev)
        out = torch.empty(R, w, dtype=f32, device=dev)
    else:
        S._check("gx", gx, f32, (N, 3), dev)
        out = torch.empty(N, 3, dtype=f32, device=dev)
    uz = torch.empty(O, 2, dtype=f32, device=dev)
    partials = torch.empty(K, w, dtype=f32, device=dev)
    _call("rig_ba_matvec_f32", mode, O, N, layout.num_frames, layout.num_sensors,
          layout.num_cams, P, K, w, *map(S._ptr, (jac.Jf, jac.Js, jac.Jc, jac.Jx)), *ids, *lay,
          S._ptr(Hpp_inv), _opt(lam_diag), _opt(gx), S._ptr(x), S._ptr(uz), S._ptr(partials),
          S._ptr(out), S._stream(dev))
    LAUNCHES["rig_ba_matvec"] += 1
    SHAPES.add("rig_ba_matvec", "back_substitute" if mode else "matvec", (O, N, R, w), _k26,
               (mode, jac, obs, layout, Hpp_inv, lam_diag, gx, x))
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


# K38 -----------------------------------------------------------------------


def _state_checks(state, dev):
    quat, _, squat, _, cam, points = state
    F, G, N = quat.shape[0], squat.shape[0], points.shape[0]
    shapes = ((F, 4), (F, 3), (G, 4), (G, 3), tuple(cam.shape), (N, 3))
    for k, (x, shape) in enumerate(zip(state, shapes)):
        S._check(f"state[{k}]", x, f32, shape, dev)
    return shapes


def rig_lm_candidate(state, x, dx, red: RigReduction, lam):
    """K38 candidate. state (quat, t, sensor_quat, sensor_t, cam_params,
    points); x (R, W), dx (N, 3); lam a 0-d float32 tensor. See
    rig_lm_candidate_plain for the function."""
    if x.device.type == "cpu":
        return rig_lm_candidate_plain(state, x, dx, red, lam)
    dev = S._require_cuda(x)
    shapes = _state_checks(state, dev)
    (F, _), (G, _), (C, P), (N, _) = shapes[0], shapes[2], shapes[4], shapes[5]
    R, w = F + G + C, row_width(P)
    for name, t, shape in (("x", x, (R, w)), ("dx", dx, (N, 3)), ("g", red.g, (R, w)),
                           ("gx", red.gx, (N, 3)), ("diag", red.diag, (R, w)),
                           ("diag_x", red.diag_x, (N, 3)), ("lam", lam, ())):
        S._check(name, t, f32, shape, dev)
    cand = tuple(torch.empty(sh, dtype=f32, device=dev) for sh in shapes)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    partial = torch.empty(max(1, 2 * sms), dtype=f64, device=dev)
    pred = torch.empty((), dtype=f64, device=dev)
    _call("rig_lm_candidate_f32", F, G, C, P, w, N,
          *map(S._ptr, (lam, *state, x, dx, red.g, red.gx, red.diag, red.diag_x, *cand, partial,
                        pred)), _I(sms), S._stream(dev))
    LAUNCHES["rig_lm_update"] += 1
    return cand, pred


def rig_lm_accept(lam, S_, new_cost, pred, state, cand, min_lambda: float, max_lambda: float,
                  function_tolerance: float, done_flag) -> None:
    """K38 accept, in place on lam, the state S_ (solver.LM_FIELDS), done_flag
    and the six state tensors. See rig_lm_accept_plain for the function."""
    if S_.device.type == "cpu":
        return rig_lm_accept_plain(lam, S_, new_cost, pred, state, cand, min_lambda, max_lambda,
                                   function_tolerance, done_flag)
    dev = S._require_cuda(S_)
    shapes = _state_checks(state, dev)
    for k, (c, shape) in enumerate(zip(cand, shapes)):
        S._check(f"cand[{k}]", c, f32, shape, dev)
    S._check("lam", lam, f32, (), dev)
    S._check("S", S_, f64, (len(LM_FIELDS),), dev)
    S._check("new_cost", new_cost, f64, (), dev)
    S._check("pred", pred, f64, (), dev)
    S._check("done_flag", done_flag, torch.uint8, (1,), dev)
    (F, _), (G, _), (C, P), (N, _) = shapes[0], shapes[2], shapes[4], shapes[5]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    _call("rig_lm_accept_f32", F, G, C * P, N, *map(S._ptr, (lam, S_, new_cost, pred)),
          _D(min_lambda), _D(max_lambda), _D(function_tolerance),
          *map(S._ptr, (done_flag, *state, *cand)), _I(sms), S._stream(dev))
    LAUNCHES["rig_lm_update"] += 1


# K40 -----------------------------------------------------------------------


def gen_abs_refine(X, uv, cam_q, cam_t, focal, w_in, q0, t0, num_iterations: int = 30,
                   loss_scale: float = 1.0):
    """K40 (a): the whole refinement in one launch; every tensor float64 on
    the card (rows (n, 3), (n, 2), (n, 4), (n, 3), (n,), (n,); q0 (4,), t0
    (3,)). Returns (q, t) on the card. See gen_abs_refine_plain."""
    if X.device.type == "cpu":
        return gen_abs_refine_plain(X, uv, cam_q, cam_t, focal, w_in, q0, t0, num_iterations,
                                    loss_scale)
    dev = S._require_cuda(X)
    n = X.shape[0]
    q0, t0 = q0.contiguous(), t0.contiguous()
    for name, t, shape in (("X", X, (n, 3)), ("uv", uv, (n, 2)), ("cam_q", cam_q, (n, 4)),
                           ("cam_t", cam_t, (n, 3)), ("focal", focal, (n,)),
                           ("w_in", w_in, (n,)), ("q0", q0, (4,)), ("t0", t0, (3,))):
        S._check(name, t, f64, shape, dev)
    q = torch.empty(4, dtype=f64, device=dev)
    t = torch.empty(3, dtype=f64, device=dev)
    _call("gen_abs_refine_f64", n, int(num_iterations), _D(loss_scale),
          *map(S._ptr, (X, uv, cam_q, cam_t, focal, w_in, q0, t0, q, t)), S._stream(dev))
    LAUNCHES["gen_abs_refine"] += 1
    return q, t


def gen_abs_refit(X, centers, dirs, weights, estimate_scale: bool):
    """K40 (b): the weighted gDLT in one launch; X, centers, dirs (n, 3),
    weights (n,) float64 on the card. Returns (model (3, 5) float64, NaN
    where a solve failed; ok (1,) bool), both on the card. See
    gen_abs_refit_plain."""
    if X.device.type == "cpu":
        return gen_abs_refit_plain(X, centers, dirs, weights, estimate_scale)
    dev = S._require_cuda(X)
    n = X.shape[0]
    for name, t, shape in (("X", X, (n, 3)), ("centers", centers, (n, 3)),
                           ("dirs", dirs, (n, 3)), ("weights", weights, (n,))):
        S._check(name, t, f64, shape, dev)
    model = torch.empty(3, 5, dtype=f64, device=dev)
    ok = torch.empty(1, dtype=torch.bool, device=dev)
    _call("gen_abs_refit_f64", n, int(bool(estimate_scale)),
          *map(S._ptr, (X, centers, dirs, weights, model, ok)), S._stream(dev))
    LAUNCHES["gen_abs_refine"] += 1
    return model, ok


# K48 -----------------------------------------------------------------------


def _k48_checks(data: GenRelData):
    dev = S._require_cuda(data.obs)
    n = data.obs.shape[0]
    S._check("rays", data.rays, f64, (n, 12), dev)
    S._check("obs", data.obs, f32, (n, 4), dev)
    S._check("cams", data.cams, f32, (n, 14), dev)
    S._check("focal", data.focal, f32, (n,), dev)
    S._check("mask", data.mask, torch.bool, (n,), dev)
    return dev, n


def gen_rel_propose_score(data: GenRelData, samples, max_sq):
    """K48 propose-and-score. samples (K, 17) int32. Returns models (K, 3,
    4), counts (K,), packed best (1,)."""
    if data.obs.device.type == "cpu":
        return gen_rel_propose_score_plain(data, samples, max_sq)
    dev, n = _k48_checks(data)
    k = samples.shape[0]
    S._check("samples", samples, i32, (k, G17_SAMPLE), dev)
    models = torch.empty(k, 3, 4, dtype=f32, device=dev)
    counts = torch.empty(k, dtype=i32, device=dev)
    best = torch.zeros(1, dtype=torch.int64, device=dev)
    _call("gen_rel_propose_score_f32", n, k, float(max_sq),
          *map(S._ptr, (data.rays, data.obs, data.cams, data.focal, data.mask, samples, models,
                        counts, best)), S._stream(dev))
    LAUNCHES["gen_rel_ransac"] += 1
    return models, counts, best


def gen_rel_inliers(data: GenRelData, model, max_sq):
    """K48 inlier mask (N,) of one (3, 4) model."""
    if data.obs.device.type == "cpu":
        return gen_rel_inliers_plain(data, model, max_sq)
    dev, n = _k48_checks(data)
    model = model.to(f32).contiguous()
    S._check("model", model, f32, (3, 4), dev)
    inl = torch.empty(n, dtype=torch.bool, device=dev)
    if n:
        _call("gen_rel_inliers_f32", n, float(max_sq),
              *map(S._ptr, (data.obs, data.cams, data.focal, data.mask, model, inl)),
              S._stream(dev))
        LAUNCHES["gen_rel_ransac"] += 1
    return inl


def gen_rel_refit(rays, weights):
    """K48 (c): the weighted 17-point solve in one launch; rays (n, 12),
    weights (n,) float64 on the card. Returns (model (3, 4) float64, NaN
    where not finite; ok (1,) bool), both on the card."""
    if rays.device.type == "cpu":
        return gen_rel_refit_plain(rays, weights)
    dev = S._require_cuda(rays)
    n = rays.shape[0]
    S._check("rays", rays, f64, (n, 12), dev)
    S._check("weights", weights, f64, (n,), dev)
    partial = torch.empty(max((n + 255) // 256, 1), 171, dtype=f64, device=dev)
    model = torch.empty(3, 4, dtype=f64, device=dev)
    ok = torch.empty(1, dtype=torch.bool, device=dev)
    _call("gen_rel_refit_f64", n, *map(S._ptr, (rays, weights, partial, model, ok)),
          S._stream(dev))
    LAUNCHES["gen_rel_ransac"] += 1
    return model, ok


class RigKernels(NamedTuple):
    obs_jacobians: object
    obs_cost: object
    obs_cost64: object
    lm_reduce: object
    schur_matvec: object
    back_substitute: object
    pcg_setup: object
    pcg_step: object
    lm_candidate: object
    lm_accept: object


def _rig_obs_cost64_plain(*args, **kwargs):
    return rig_obs_cost_plain(*args, **kwargs).double()


KERNELS = RigKernels(rig_obs_jacobians, rig_obs_cost, rig_obs_cost64, rig_lm_reduce,
                     rig_schur_matvec, rig_back_substitute, pcg_setup_diag, pcg_step,
                     rig_lm_candidate, rig_lm_accept)
PLAIN = RigKernels(rig_obs_jacobians_plain, rig_obs_cost_plain, _rig_obs_cost64_plain,
                   rig_lm_reduce_plain, rig_schur_matvec_plain, rig_back_substitute_plain,
                   pcg_setup_diag_plain, pcg_step_plain, rig_lm_candidate_plain,
                   rig_lm_accept_plain)
