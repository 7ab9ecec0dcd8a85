"""Rig-aware bundle adjustment: frames, sensor_from_rig, intrinsics, points.

Counterpart of colmap_tpu/estimators/bundle_adjustment_rig.py (reference
behavior: src/colmap/estimators/bundle_adjustment.* with rigs). The
reprojection chain is cam_from_world = sensor_from_rig ∘ rig_from_world:
frames own rig_from_world, each (rig, sensor) pair owns one sensor_from_rig
shared by all its frames, and every rotation is updated by ``quat_exp(δ) · q``.

Each LM step runs the rig kernels of ``colmap_tpu_torch.kernels.rig``:

    K24 rig_obs_jacobians / rig_obs_cost   residuals, four Jacobian blocks, cost
    K25 rig_lm_reduce                      gradients, Hpp⁻¹, reduced right-hand
                                           side, damping and Jacobi diagonals
    K26 rig_schur_matvec                   the reduced system in PCG;
        rig_back_substitute                the point update

and plain torch for PCG's vector updates on the (F + G + C, W) camera-side
tensor (kernels/rig.py row_width), the quaternion update and the damping rule (the same rule,
acceptance test and stopping rule as colmap_tpu's lm_step and
lm_solve_fused). The loop runs on the host and reads two scalars per
iteration (the new cost and the predicted decrease).

Problem layout:
    frames:       quat (F, 4), t (F, 3)                rig_from_world
    sensors:      sensor_quat (G, 4), sensor_t (G, 3)  sensor_from_rig
    cameras:      cam_params (C, P)                    one model id per problem, or
                                                       mixed models' padded rows
                                                       (as estimators/bundle_adjustment.py)
    points:       points (N, 3)
    observations: obs_frame/obs_sensor/obs_cam/obs_point (O,) int32,
                  obs_xy (O, 2), obs_w (O,)
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from colmap_tpu_torch.estimators.ba_residual import quat_exp
from colmap_tpu_torch.estimators.bundle_adjustment import BAOptions, camera_mask
from colmap_tpu_torch.geometry import rotation as rot
from colmap_tpu_torch.kernels import rig as rig_kernels
from colmap_tpu_torch.kernels.ba import model_groups
from colmap_tpu_torch.sensor import models as camera_models


class RigBAProblem(NamedTuple):
    quat: torch.Tensor  # (F, 4) rig_from_world rotation
    t: torch.Tensor  # (F, 3)
    sensor_quat: torch.Tensor  # (G, 4) sensor_from_rig rotation
    sensor_t: torch.Tensor  # (G, 3)
    cam_params: torch.Tensor  # (C, P)
    points: torch.Tensor  # (N, 3)
    obs_frame: torch.Tensor  # (O,) int32
    obs_sensor: torch.Tensor  # (O,) int32
    obs_cam: torch.Tensor  # (O,) int32
    obs_point: torch.Tensor  # (O,) int32
    obs_xy: torch.Tensor  # (O, 2)
    obs_w: torch.Tensor  # (O,)


class RigBAMasks(NamedTuple):
    """Variability masks. 1.0 = free, 0.0 = constant."""

    frame_mask: torch.Tensor  # (F,)
    frame_trans_mask: torch.Tensor  # (F, 3)
    sensor_mask: torch.Tensor  # (G,) 0 for reference sensors (identity)
    cam_mask: torch.Tensor  # (C, P)
    point_mask: torch.Tensor  # (N,)


def default_masks(problem: RigBAProblem, model_id, options: BAOptions,
                  ref_sensors=(0,), const_frames=None) -> RigBAMasks:
    """All frames, non-reference sensors and points free; the camera
    parameters the options name free (colmap_tpu's default_masks)."""
    F, G = problem.quat.shape[0], problem.sensor_quat.shape[0]
    like = dict(dtype=problem.points.dtype, device=problem.points.device)
    frame_mask = torch.ones(F, **like)
    if const_frames is not None:
        frame_mask[torch.as_tensor(list(const_frames), dtype=torch.long,
                                   device=frame_mask.device)] = 0.0
    sensor_mask = torch.ones(G, **like)
    for s in ref_sensors:
        sensor_mask[s] = 0.0
    cam_mask = camera_mask(problem.cam_params, model_id, options)
    return RigBAMasks(frame_mask, frame_mask[:, None] * torch.ones(F, 3, **like), sensor_mask,
                      cam_mask, torch.ones(problem.points.shape[0], **like))


def fix_gauge_two_frames(masks: RigBAMasks, frame1: int, frame2: int) -> RigBAMasks:
    """frame1 fully fixed, frame2's translation x-component fixed."""
    frame_mask = masks.frame_mask.clone()
    frame_mask[frame1] = 0.0
    ftm = masks.frame_trans_mask.clone()
    ftm[frame1] = 0.0
    ftm[frame2, 0] = 0.0
    return masks._replace(frame_mask=frame_mask, frame_trans_mask=ftm)


def _obs(problem: RigBAProblem) -> rig_kernels.RigObs:
    p = problem
    return rig_kernels.RigObs(p.obs_frame, p.obs_sensor, p.obs_cam, p.obs_point, p.obs_xy,
                              p.obs_w)


def _cost(problem: RigBAProblem, model_id, options: BAOptions, kernels, groups=None):
    p = problem
    return kernels.obs_cost(p.quat, p.t, p.sensor_quat, p.sensor_t, p.cam_params, p.points,
                            _obs(p), model_id, options.loss, options.loss_scale, groups)


def compute_cost(problem: RigBAProblem, model_id, options: BAOptions):
    """½ Σ ρ(‖r‖²)·w as a 0-d tensor (K24, cost mode)."""
    return _cost(problem, model_id, options, rig_kernels.KERNELS)


def compute_residuals(problem: RigBAProblem, model_id):
    """Unweighted residuals (O, 2) of every observation."""
    p = problem
    f, s = p.obs_frame.long(), p.obs_sensor.long()
    X_rig = rot.quat_rotate(p.quat[f], p.points[p.obs_point.long()]) + p.t[f]
    Xc = rot.quat_rotate(p.sensor_quat[s], X_rig) + p.sensor_t[s]
    rows = p.cam_params[p.obs_cam.long()]
    if isinstance(model_id, tuple):
        proj, _ = camera_models.img_from_cam_switch(model_id, torch.round(rows[:, -1]).long(),
                                                    rows[:, :-1], Xc, check_cheirality=False)
    else:
        proj, _ = camera_models.img_from_cam(model_id, rows, Xc, check_cheirality=False)
    return proj - p.obs_xy


class _ObsMasks(NamedTuple):
    """Mask tables K24 folds into the Jacobians (constant across the solve)."""

    pose: torch.Tensor  # (F, 6): rotation columns, then translation
    sensor: torch.Tensor  # (G,)
    cam: torch.Tensor  # (C, P)
    point: torch.Tensor  # (N,)


def _obs_masks(masks: RigBAMasks, options: BAOptions) -> _ObsMasks:
    rot_m = masks.frame_mask * (1.0 if options.refine_rotations else 0.0)
    pose = torch.cat([rot_m[:, None].expand(-1, 3), masks.frame_trans_mask], dim=-1)
    return _ObsMasks(pose.contiguous(), masks.sensor_mask.contiguous(),
                     masks.cam_mask.contiguous(), masks.point_mask.contiguous())


def _pcg(matvec, precond, b, iterations: int):
    """Jacobi-preconditioned CG with a fixed iteration count on the
    camera-side tensor (colmap_tpu's _pcg over the three families)."""
    x = torch.zeros_like(b)
    r = b
    z = precond * r
    p = z
    rz = (r * z).sum()
    zero = torch.zeros_like(rz)
    for _ in range(iterations):
        Ap = matvec(p)
        pAp = (p * Ap).sum()
        alpha = torch.where(pAp.abs() > 1e-30, rz / pAp, zero)
        x = x + alpha * p
        r = r - alpha * Ap
        z = precond * r
        rz_new = (r * z).sum()
        beta = torch.where(rz.abs() > 1e-30, rz_new / rz, zero)
        p = z + beta * p
        rz = rz_new
    return x


def _apply_update(problem: RigBAProblem, x, dx) -> RigBAProblem:
    """x: the (F + G + C, W) camera-side step; dx: (N, 3)."""
    F, G = problem.quat.shape[0], problem.sensor_quat.shape[0]
    P = problem.cam_params.shape[1]
    df, ds, dc = x[:F, :6], x[F:F + G, :6], x[F + G:, :P]
    return problem._replace(
        quat=rot.quat_normalize(rot.quat_multiply(quat_exp(df[:, :3]), problem.quat)),
        t=problem.t + df[:, 3:],
        sensor_quat=rot.quat_normalize(rot.quat_multiply(quat_exp(ds[:, :3]),
                                                         problem.sensor_quat)),
        sensor_t=problem.sensor_t + ds[:, 3:],
        cam_params=problem.cam_params + dc,
        points=problem.points + dx,
    )


def _layout(problem: RigBAProblem) -> rig_kernels.RigLayout:
    p = problem
    return rig_kernels.rig_layout(p.obs_frame, p.obs_sensor, p.obs_cam, p.obs_point,
                                  p.quat.shape[0], p.sensor_quat.shape[0], p.cam_params.shape[0],
                                  p.points.shape[0], p.cam_params.shape[1])


def _lm_step(problem: RigBAProblem, layout, model_id, options: BAOptions,
             obs_masks: _ObsMasks, lam: float, nu: float, cost: float, kernels, groups):
    """One LM iteration; ``cost`` is the cost at the current state;
    ``groups`` the observations of each model (model_groups). Returns
    (problem, lam, nu, new_cost, accepted, out_cost) with Python scalars."""
    p = problem
    obs = _obs(p)
    jac = kernels.obs_jacobians(p.quat, p.t, p.sensor_quat, p.sensor_t, p.cam_params, p.points,
                                obs, obs_masks.pose, obs_masks.sensor, obs_masks.cam,
                                obs_masks.point, model_id, options.loss, options.loss_scale,
                                groups)
    red = kernels.lm_reduce(jac, obs, layout, lam)
    x = _pcg(lambda v: kernels.schur_matvec(jac, obs, layout, red.Hpp_inv, red.lam_diag, v),
             red.precond, red.b, options.pcg_iterations)
    dx = kernels.back_substitute(jac, obs, layout, red.Hpp_inv, red.gx, x)
    new_problem = _apply_update(problem, x, dx)
    new_cost = float(_cost(new_problem, model_id, options, kernels, groups))
    pred = 0.5 * float(
        (x * red.g).sum() + (dx * red.gx).sum()
        + lam * ((red.diag * x * x).sum() + (red.diag_x * dx * dx).sum())
    )
    rho = (cost - new_cost) / max(pred, 1e-30)
    if new_cost < cost and pred > 0:
        shrink = max(1.0 / 3.0, 1.0 - (2.0 * rho - 1.0) ** 3)
        new_lam = min(max(lam * shrink, options.min_lambda), options.max_lambda)
        return new_problem, new_lam, 2.0, new_cost, True, new_cost
    return problem, min(lam * nu, options.max_lambda), nu * 2.0, new_cost, False, cost


def _lm_loop(problem: RigBAProblem, model_id, options: BAOptions, masks: RigBAMasks,
             kernels=rig_kernels.KERNELS):
    """The LM loop of every rig solve (colmap_tpu's lm_solve_fused).
    ``kernels`` is ``rig_kernels.KERNELS``; a check on the card passes
    ``rig_kernels.PLAIN`` to run the same solve through the plain versions.
    Returns (problem, final cost, iterations)."""
    obs_masks = _obs_masks(masks, options)
    layout = _layout(problem)
    # The observations of each model of a mixed problem, once per solve.
    groups = model_groups(model_id, problem.cam_params, problem.obs_cam)
    lam, nu = float(options.initial_lambda), 2.0
    cur_cost = last_cost = float(_cost(problem, model_id, options, kernels, groups))
    it, done = 0, False
    while not done and it < options.max_iterations:
        problem, lam, nu, new_cost, accepted, cur_cost = _lm_step(
            problem, layout, model_id, options, obs_masks, lam, nu, cur_cost, kernels, groups)
        rel = abs(last_cost - new_cost) / max(new_cost, 1e-30)
        done = (accepted and rel < options.function_tolerance) or (
            not accepted and lam >= options.max_lambda)
        if accepted:
            last_cost = new_cost
        it += 1
    return problem, cur_cost, it


def solve(problem: RigBAProblem, model_id, options: Optional[BAOptions] = None,
          masks: Optional[RigBAMasks] = None):
    """Run LM to convergence (colmap_tpu's ``solve``). Returns (problem,
    summary dict with initial_cost, final_cost, num_iterations)."""
    if options is None:
        options = BAOptions()
    if masks is None:
        masks = default_masks(problem, model_id, options)
    solved, final_cost, n_iters = _lm_loop(problem, model_id, options, masks)
    initial = float(compute_cost(problem, model_id, options))
    return solved, {"initial_cost": initial, "final_cost": float(final_cost),
                    "num_iterations": int(n_iters)}
