"""Rig-aware bundle adjustment: frames, sensor_from_rig, intrinsics, points.

Counterpart of colmap_tpu/estimators/bundle_adjustment_rig.py (reference
behavior: src/colmap/estimators/bundle_adjustment.* with rigs). The
reprojection chain is cam_from_world = sensor_from_rig ∘ rig_from_world:
frames own rig_from_world, each (rig, sensor) pair owns one sensor_from_rig
shared by all its frames, and every rotation is updated by ``quat_exp(δ) · q``.

Each LM step runs the rig kernels of ``colmap_tpu_torch.kernels.rig`` and
K34 of ``kernels.solver``:

    K24 rig_obs_jacobians / rig_obs_cost64 residuals, four Jacobian blocks, cost
    K25 rig_lm_reduce                      gradients, Hpp⁻¹, reduced right-hand
                                           side, damping and Jacobi diagonals
    K34 pcg_setup_diag / pcg_step          PCG's vectors and scalars on the
                                           flattened (F + G + C, W) camera-side
                                           tensor (kernels/rig.py row_width)
    K26 rig_schur_matvec                   the reduced system in PCG;
        rig_back_substitute                the point update
    K38 rig_lm_candidate / rig_lm_accept   the update, predicted decrease,
                                           damping rule and stopping test

(the same rule, acceptance test and stopping rule as colmap_tpu's lm_step
and lm_solve_fused). The loop is device-resident, as the packed solve's
(estimators/bundle_adjustment.py ``drive``): lam, nu, the costs, the
iteration count and ``done`` live in device memory, a solve captures one
iteration as a CUDA graph and replays it, and the host reads a 1-byte done
flag once per DONE_CHUNK iterations.

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

from colmap_tpu_torch.estimators import bundle_adjustment as ba
from colmap_tpu_torch.estimators.bundle_adjustment import BAOptions, camera_mask
from colmap_tpu_torch.geometry import rotation as rot
from colmap_tpu_torch.kernels import rig as rig_kernels
from colmap_tpu_torch.kernels import solver
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


def _layout(problem: RigBAProblem) -> rig_kernels.RigLayout:
    p = problem
    return rig_kernels.rig_layout(p.obs_frame, p.obs_sensor, p.obs_cam, p.obs_point,
                                  p.quat.shape[0], p.sensor_quat.shape[0], p.cam_params.shape[0],
                                  p.points.shape[0], p.cam_params.shape[1])


def _pcg(kernels, jac, obs, layout, red, iterations: int):
    """Jacobi-preconditioned CG with a fixed iteration count on the flattened
    camera-side tensor (colmap_tpu's _pcg over the three families): K34's
    set-up (c) from K25's preconditioner, then per iteration K26's matvec
    (its product holds λD) and K34's step with F = 0 and no damping term.
    Returns x (R, W)."""
    R, W = red.b.shape
    st = kernels.pcg_setup(red.precond.reshape(-1), red.b.reshape(-1))
    no_poses = red.b.new_zeros(0, 6)
    for _ in range(iterations):
        Ap = kernels.schur_matvec(jac, obs, layout, red.Hpp_inv, red.lam_diag, st.p.view(R, W))
        st = kernels.pcg_step(st, no_poses, Ap, None, None, None)
    return st.x.view(R, W)


def _params(state: RigBAProblem):
    return (state.quat, state.t, state.sensor_quat, state.sensor_t, state.cam_params,
            state.points)


def _lm_iteration(state: RigBAProblem, layout, model_id, options: BAOptions,
                  obs_masks: _ObsMasks, sc, kernels, groups) -> None:
    """One LM iteration, in place on ``state``'s parameter tensors and the
    scalars ``sc`` (bundle_adjustment._LMScalars): K24, K25, PCG (K34, K26),
    K26's back-substitution, K38's candidate, K24's cost and K38's accept.
    It reads nothing back to the host, so it can be captured as a CUDA
    graph; once ``done`` is set it changes nothing."""
    p = state
    obs = _obs(p)
    jac = kernels.obs_jacobians(*_params(p), obs, obs_masks.pose, obs_masks.sensor,
                                obs_masks.cam, obs_masks.point, model_id, options.loss,
                                options.loss_scale, groups)
    red = kernels.lm_reduce(jac, obs, layout, sc.lam)
    x = _pcg(kernels, jac, obs, layout, red, options.pcg_iterations)
    dx = kernels.back_substitute(jac, obs, layout, red.Hpp_inv, red.gx, x)
    cand, pred = kernels.lm_candidate(_params(p), x, dx, red, sc.lam)
    new_cost = kernels.obs_cost64(*cand, obs, model_id, options.loss, options.loss_scale, groups)
    kernels.lm_accept(sc.lam, sc.S, new_cost, pred, _params(p), cand, options.min_lambda,
                      options.max_lambda, options.function_tolerance, sc.done)


def _lm_loop(problem: RigBAProblem, model_id, options: BAOptions, masks: RigBAMasks,
             kernels=rig_kernels.KERNELS, with_info=False):
    """The LM loop of every rig solve (colmap_tpu's lm_solve_fused).
    ``kernels`` is ``rig_kernels.KERNELS``; a check on the card passes
    ``rig_kernels.PLAIN`` to run the same solve through the plain versions.
    Returns (problem, final cost, iterations), and with ``with_info`` the
    loop's info dict (bundle_adjustment.drive). On the card the host reads
    the done flag once per DONE_CHUNK iterations and replays a CUDA graph of
    one iteration under the size rule GRAPH_MIN_ITERATIONS."""
    dev = problem.points.device
    obs_masks = _obs_masks(masks, options)
    layout = _layout(problem)
    # The observations of each model of a mixed problem, once per solve.
    groups = model_groups(model_id, problem.cam_params, problem.obs_cam)
    state = problem._replace(**{k: getattr(problem, k).clone() for k in
                                ("quat", "t", "sensor_quat", "sensor_t", "cam_params",
                                 "points")})
    cost = kernels.obs_cost64(*_params(state), _obs(state), model_id, options.loss,
                              options.loss_scale, groups)
    sc = ba._lm_scalars(cost, options.initial_lambda, 2.0, problem.points.dtype)

    def step():
        _lm_iteration(state, layout, model_id, options, obs_masks, sc, kernels, groups)

    graph_wanted = (dev.type == "cuda" and kernels is rig_kernels.KERNELS
                    and options.max_iterations >= ba.GRAPH_MIN_ITERATIONS)
    info = ba.drive(step, sc, dev, options.max_iterations, graph_wanted, (rig_kernels, solver))
    S = info.pop("S")
    if with_info:
        return state, S["cost"], int(S["it"]), info
    return state, S["cost"], int(S["it"])


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
