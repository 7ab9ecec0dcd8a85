"""Bundle adjustment: Levenberg-Marquardt on the point-Schur-reduced system.

Counterpart of colmap_tpu/estimators/bundle_adjustment.py (reference:
src/colmap/estimators/bundle_adjustment{.h,_ceres.h,_caspar.h}). The solver
works in the point-major packed layout of ``pack_problem``: observations
sorted by point and padded to a common per-point capacity ``capp``, so every
point-side sum is a contiguous run of slots. Each LM step runs the four
kernels of ``colmap_tpu_torch.kernels.ba``:

    K1 obs_jacobians / obs_cost    residuals, Jacobians, robust weights; cost
    K2 lm_reduce                   gradients, Hpp⁻¹, reduced right-hand side
    K3 schur_matvec                reduced-system matvec in PCG; back-substitution
    K4 dense_schur_assemble        explicit S for the dense Cholesky solve

and plain torch for the rest: PCG's vector updates on (F, 6) + (C, P)
tensors, the Cholesky of S, the quaternion update and the damping rule. The
loop runs on the host and reads three scalars per iteration (costs and the
predicted decrease); colmap_tpu runs the same loop on the device.

Problem layout (struct-of-arrays tensors; padding rows carry weight 0):
    frame poses:  quat (F, 4), t (F, 3)           cam_from_world
    cameras:      cam_params (C, P)                one model id per problem
    points:       points (N, 3)
    observations: obs_frame/obs_cam/obs_point (O,) int32, obs_xy (O, 2), obs_w (O,)

Parameterization: rotation by a left-multiplied quaternion exponential,
translation, masked camera parameters and points additive. Gauge and
constant blocks via per-block masks (reference: BundleAdjustmentConfig).
The residual model (make_residual_fn, quat_exp, the robust losses) is in
``ba_residual.py``. Mixed camera models in one problem are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from colmap_tpu_torch.estimators.ba_residual import quat_exp
from colmap_tpu_torch.geometry import rotation as rot
from colmap_tpu_torch.kernels import ba as ba_kernels
from colmap_tpu_torch.sensor import models as camera_models


class BAProblem(NamedTuple):
    quat: torch.Tensor  # (F, 4) cam_from_world rotation
    t: torch.Tensor  # (F, 3)
    cam_params: torch.Tensor  # (C, P)
    points: torch.Tensor  # (N, 3)
    obs_frame: torch.Tensor  # (O,) int32
    obs_cam: torch.Tensor  # (O,) int32
    obs_point: torch.Tensor  # (O,) int32
    obs_xy: torch.Tensor  # (O, 2)
    obs_w: torch.Tensor  # (O,) float: 0 = padding/invalid


@dataclasses.dataclass(frozen=True)
class BAOptions:
    """Solver envelope per the Caspar defaults (bundle_adjustment_caspar.h:
    107-120: 200 LM iters max, 20 PCG iters/step) and Ceres-compatible
    termination. Same fields and defaults as colmap_tpu's BAOptions."""

    max_iterations: int = 50
    pcg_iterations: int = 30
    pcg_rtol: float = 1e-2
    initial_lambda: float = 1e-4
    min_lambda: float = 1e-10
    max_lambda: float = 1e10
    function_tolerance: float = 1e-6
    loss: str = "trivial"  # trivial | huber | cauchy
    loss_scale: float = 1.0
    refine_focal_length: bool = True
    refine_principal_point: bool = False
    refine_extra_params: bool = True
    refine_points: bool = True
    refine_poses: bool = True
    refine_rotations: bool = True  # False: stage-1 global BA (positions only)
    # Kept for parity with colmap_tpu; the packed layout is always sorted by
    # point, so the port reads neither this nor pcg_rtol.
    obs_sorted_by_point: bool = False
    # "auto" takes the dense Schur solve when 6F + C*P <= dense_schur_max_dim
    # and PCG beyond (reference: bundle_adjustment_ceres.h:68-76).
    solver_type: str = "auto"  # "auto" | "dense_schur" | "pcg"
    dense_schur_max_dim: int = 4096


class BAMasks(NamedTuple):
    """Variability masks. 1.0 = free, 0.0 = constant (gauge/config)."""

    frame_mask: torch.Tensor  # (F,) pose blocks free?
    frame_trans_mask: torch.Tensor  # (F, 3) per-component translation freedom
    cam_mask: torch.Tensor  # (C, P) per-parameter freedom
    point_mask: torch.Tensor  # (N,)


class PackedMaps(NamedTuple):
    frame_pm: torch.Tensor  # (N, capp) int32 frame id per slot (dummy -> 0)
    cam_pm: torch.Tensor  # (N, capp) int32 camera id per slot (dummy -> 0)


def _single_model(model_id) -> int:
    if isinstance(model_id, tuple):
        raise NotImplementedError(
            "problems that mix camera models are not ported yet; "
            "colmap_tpu handles them"
        )
    return int(model_id)


def default_masks(problem: BAProblem, model_id: int, options: BAOptions,
                  const_frames=None, const_points=None) -> BAMasks:
    model_id = _single_model(model_id)
    F = problem.quat.shape[0]
    C, P = problem.cam_params.shape
    N = problem.points.shape[0]
    like = dict(dtype=problem.points.dtype, device=problem.points.device)
    frame_mask = torch.ones(F, **like)
    if const_frames is not None:
        frame_mask[torch.as_tensor(const_frames, device=frame_mask.device)] = 0.0
    if not options.refine_poses:
        frame_mask = torch.zeros(F, **like)
    frame_trans_mask = torch.ones(F, 3, **like) * frame_mask[:, None]
    cam_mask = torch.zeros(C, P, **like)
    if options.refine_focal_length:
        cam_mask[:, list(camera_models.focal_length_idxs(model_id))] = 1.0
    if options.refine_principal_point:
        cam_mask[:, list(camera_models.principal_point_idxs(model_id))] = 1.0
    if options.refine_extra_params:
        cam_mask[:, list(camera_models.extra_params_idxs(model_id))] = 1.0
    point_mask = torch.ones(N, **like) if options.refine_points else torch.zeros(N, **like)
    if const_points is not None:
        point_mask[torch.as_tensor(const_points, device=point_mask.device)] = 0.0
    return BAMasks(frame_mask, frame_trans_mask, cam_mask, point_mask)


def fix_gauge_two_frames(masks: BAMasks, frame1: int, frame2: int) -> BAMasks:
    """Gauge TWO_CAMS_FROM_WORLD (bundle_adjustment.h): frame1 fully fixed,
    frame2's translation x-component fixed (scale gauge)."""
    frame_mask = masks.frame_mask.clone()
    frame_mask[frame1] = 0.0
    ftm = masks.frame_trans_mask.clone()
    ftm[frame1] = 0.0
    ftm[frame2, 0] = 0.0
    return masks._replace(frame_mask=frame_mask, frame_trans_mask=ftm)


def pack_problem(problem: BAProblem, align: int = 2, capp: Optional[int] = None):
    """Repack observations into the point-major padded layout (host numpy).

    Returns (packed BAProblem with Opm = N*capp observations in point-major
    order, PackedMaps, capacities dict) on the problem's device. Dummy slots
    carry obs_w = 0 and frame/cam id 0; their Jacobian rows are zero.
    """
    F = int(problem.quat.shape[0])
    N = int(problem.points.shape[0])
    device = problem.points.device
    obs_frame = problem.obs_frame.cpu().numpy()
    obs_cam = problem.obs_cam.cpu().numpy()
    obs_point = problem.obs_point.cpu().numpy()
    obs_xy = problem.obs_xy.cpu().numpy()
    obs_w = problem.obs_w.cpu().numpy()
    O = len(obs_frame)

    counts_p = np.bincount(obs_point, minlength=N)
    if capp is None:
        capp = int(max(1, -(-int(counts_p.max(initial=0)) // align) * align))
    if int(counts_p.max(initial=0)) > capp:
        raise ValueError("capp too small")
    Opm = N * capp

    order = np.argsort(obs_point, kind="stable")
    starts = np.concatenate([[0], np.cumsum(counts_p)]).astype(np.int64)
    rank = np.arange(O, dtype=np.int64) - starts[obs_point[order]]
    slots = obs_point[order].astype(np.int64) * capp + rank

    frame_pm = np.zeros(Opm, dtype=np.int32)
    cam_pm = np.zeros(Opm, dtype=np.int32)
    p_xy = np.zeros((Opm, 2), dtype=obs_xy.dtype)
    p_w = np.zeros(Opm, dtype=obs_w.dtype)
    frame_pm[slots] = obs_frame[order]
    cam_pm[slots] = obs_cam[order]
    p_xy[slots] = obs_xy[order]
    p_w[slots] = obs_w[order]

    def dev(a):
        return torch.from_numpy(a).to(device)

    packed = problem._replace(
        obs_frame=dev(frame_pm),
        obs_cam=dev(cam_pm),
        obs_point=dev(np.repeat(np.arange(N, dtype=np.int32), capp)),
        obs_xy=dev(p_xy),
        obs_w=dev(p_w),
    )
    maps = PackedMaps(packed.obs_frame.view(N, capp), packed.obs_cam.view(N, capp))
    counts_f = np.bincount(obs_frame, minlength=F)
    capf = int(max(1, -(-int(counts_f.max(initial=0)) // align) * align))
    return packed, maps, {"capf": capf, "capp": capp}


def compute_cost(problem: BAProblem, model_id: int, options: BAOptions):
    """½ Σ ρ(‖r‖²)·w as a 0-d tensor (K1, cost mode)."""
    return _cost(problem, model_id, options, ba_kernels.KERNELS)


def _cost(problem: BAProblem, model_id: int, options: BAOptions, kernels):
    p = problem
    return kernels.obs_cost(p.quat, p.t, p.cam_params, p.points, p.obs_frame, p.obs_cam,
                             p.obs_point, p.obs_xy, p.obs_w, _single_model(model_id),
                             options.loss, options.loss_scale)


# K1 reads each slot's point id, so the packed layout needs no separate path.
compute_cost_packed = compute_cost


class _ObsMasks(NamedTuple):
    """Mask tables K1 folds into the Jacobians (constant across the solve)."""

    pose: torch.Tensor  # (F, 6): rotation columns, then translation
    cam: torch.Tensor  # (C, P)
    point: torch.Tensor  # (N,)


def _obs_masks(masks: BAMasks, options: BAOptions) -> _ObsMasks:
    rot_m = masks.frame_mask * (1.0 if options.refine_rotations else 0.0)
    pose = torch.cat([rot_m[:, None].expand(-1, 3), masks.frame_trans_mask], dim=-1)
    return _ObsMasks(pose.contiguous(), masks.cam_mask.contiguous(),
                     masks.point_mask.contiguous())


def _dot(ap, ac, bp, bc):
    return (ap * bp).sum() + (ac * bc).sum()


def _where0(cond, x):
    return torch.where(cond, x, torch.zeros_like(x))


def _pcg(matvec, precond, lam_dp, lam_dc, bp, bc, iterations: int):
    """Preconditioned CG on (S + λD) x = b with a fixed iteration count."""
    xp, xc = torch.zeros_like(bp), torch.zeros_like(bc)
    rp, rc = bp, bc
    zp, zc = precond(rp, rc)
    pp, pc = zp, zc
    rz = _dot(rp, rc, zp, zc)
    for _ in range(iterations):
        Ap, Ac = matvec(pp, pc)
        Ap = Ap + lam_dp * pp
        Ac = Ac + lam_dc * pc
        pAp = _dot(pp, pc, Ap, Ac)
        alpha = _where0(pAp.abs() > 1e-30, rz / pAp)
        xp = xp + alpha * pp
        xc = xc + alpha * pc
        rp = rp - alpha * Ap
        rc = rc - alpha * Ac
        zp, zc = precond(rp, rc)
        rz_new = _dot(rp, rc, zp, zc)
        beta = _where0(rz.abs() > 1e-30, rz_new / rz)
        pp = zp + beta * pp
        pc = zc + beta * pc
        rz = rz_new
    return xp, xc


def _dense_schur_solve(S, bp, bc):
    """Cholesky solve of the assembled S; ridge solve if S is not SPD."""
    F, C = bp.shape[0], bc.shape[0]
    b = torch.cat([bp.reshape(-1), bc.reshape(-1)])
    L, info = torch.linalg.cholesky_ex(S)
    if int(info) == 0 and bool(torch.isfinite(L).all()):
        d = torch.cholesky_solve(b[:, None], L)[:, 0]
    else:
        eye = torch.eye(S.shape[0], dtype=S.dtype, device=S.device)
        d = torch.linalg.solve(S + 1e-6 * eye, b)
    return d[: 6 * F].reshape(F, 6), d[6 * F:].reshape(C, -1)


def _apply_update(problem: BAProblem, dp, dc, dx) -> BAProblem:
    quat = rot.quat_normalize(rot.quat_multiply(quat_exp(dp[:, :3]), problem.quat))
    return problem._replace(
        quat=quat,
        t=problem.t + dp[:, 3:],
        cam_params=problem.cam_params + dc,
        points=problem.points + dx,
    )


def _use_dense(problem: BAProblem, options: BAOptions) -> bool:
    F = problem.quat.shape[0]
    C, P = problem.cam_params.shape
    return options.solver_type == "dense_schur" or (
        options.solver_type == "auto" and 6 * F + C * P <= options.dense_schur_max_dim
    )


def _lm_step_packed_impl(problem: BAProblem, maps: PackedMaps, model_id: int,
                         options: BAOptions, obs_masks: _ObsMasks, lam: float,
                         nu: float, cost: float, kernels, use_dense: bool,
                         block_jacobi: bool):
    """One LM iteration in the point-major layout; ``cost`` is the cost at the
    current state. Returns (problem, lam, nu, cost, new_cost, accepted,
    out_cost) with Python scalars."""
    p = problem
    F = p.quat.shape[0]
    C = p.cam_params.shape[0]
    r, Jp, Jc, Jx = kernels.obs_jacobians(
        p.quat, p.t, p.cam_params, p.points, p.obs_frame, p.obs_cam, p.obs_point,
        p.obs_xy, p.obs_w, obs_masks.pose, obs_masks.cam, obs_masks.point,
        model_id, options.loss, options.loss_scale,
    )
    red = kernels.lm_reduce(r, Jp, Jc, Jx, maps.frame_pm, maps.cam_pm, F, C, lam)
    lam_dp = lam * red.diag_pose
    lam_dc = lam * red.diag_cam

    if use_dense:
        lam_diag = torch.cat([lam_dp.reshape(-1), lam_dc.reshape(-1)])
        S = kernels.dense_schur_assemble(Jp, Jc, Jx, maps.frame_pm, maps.cam_pm,
                                          red.Hpp_inv, lam_diag, F)
        dp, dc = _dense_schur_solve(S, red.bp, red.bc)
    else:
        if block_jacobi:
            # 6x6 pose blocks of H_cc (Ceres SCHUR_JACOBI), scalar Jacobi for
            # the camera parameters.
            Mp = torch.linalg.inv(red.Hcc_pose + torch.diag_embed(lam_dp + 1e-10))
        else:
            diag_p = red.diag_pose + lam_dp
            Mp = _where0(diag_p > 1e-12, 1.0 / diag_p)
        diag_c = red.diag_cam + lam_dc
        Mc = _where0(diag_c > 1e-12, 1.0 / diag_c)

        def precond(rp, rc):
            if block_jacobi:
                return (Mp @ rp[..., None])[..., 0], Mc * rc
            return Mp * rp, Mc * rc

        def matvec(xp, xc):
            return kernels.schur_matvec(Jp, Jc, Jx, maps.frame_pm, maps.cam_pm,
                                         red.Hpp_inv, xp, xc)

        dp, dc = _pcg(matvec, precond, lam_dp, lam_dc, red.bp, red.bc,
                      options.pcg_iterations)

    dx = kernels.back_substitute(Jp, Jc, Jx, maps.frame_pm, maps.cam_pm,
                                  red.Hpp_inv, red.gx, dp, dc)
    new_problem = _apply_update(problem, dp, dc, dx)
    new_cost = float(_cost(new_problem, model_id, options, kernels))
    pred = 0.5 * float(
        (dp * red.gp).sum() + (dc * red.gc).sum() + (dx * red.gx).sum()
        + lam * (
            (red.diag_pose * dp * dp).sum()
            + (red.diag_cam * dc * dc).sum()
            + (red.diag_pt * dx * dx).sum()
        )
    )
    rho = (cost - new_cost) / max(pred, 1e-30)
    accepted = new_cost < cost and pred > 0
    if accepted:
        shrink = max(1.0 / 3.0, 1.0 - (2.0 * rho - 1.0) ** 3)
        new_lam = min(max(lam * shrink, options.min_lambda), options.max_lambda)
        return new_problem, new_lam, 2.0, cost, new_cost, True, new_cost
    new_lam = min(lam * nu, options.max_lambda)
    return problem, new_lam, nu * 2.0, cost, new_cost, False, cost


def lm_step_packed(problem: BAProblem, maps: PackedMaps, model_id: int,
                   options: BAOptions, masks: BAMasks, lam: float, nu: float):
    """One LM iteration in the packed layout (same semantics as colmap_tpu's
    lm_step_packed). Returns (problem, lam, nu, cost, new_cost, accepted)."""
    model_id = _single_model(model_id)
    cost = float(compute_cost(problem, model_id, options))
    out = _lm_step_packed_impl(problem, maps, model_id, options, _obs_masks(masks, options),
                               lam, nu, cost, ba_kernels.KERNELS,
                               _use_dense(problem, options), True)
    return out[:6]


def _lm_loop(problem, maps, model_id, options, masks, use_dense, block_jacobi,
             verbose=False, kernels=ba_kernels.KERNELS):
    """The LM loop of every solve. ``kernels`` is ``ba_kernels.KERNELS``;
    a check on the card passes ``ba_kernels.PLAIN`` to run the same solve
    through the plain versions."""
    model_id = _single_model(model_id)
    obs_masks = _obs_masks(masks, options)
    lam, nu = float(options.initial_lambda), 2.0
    cur_cost = last_cost = float(_cost(problem, model_id, options, kernels))
    it, done = 0, False
    while not done and it < options.max_iterations:
        problem, lam, nu, cost, new_cost, accepted, cur_cost = _lm_step_packed_impl(
            problem, maps, model_id, options, obs_masks, lam, nu, cur_cost,
            kernels, use_dense, block_jacobi,
        )
        if verbose:
            print(f"  LM it {it}: cost {cost:.6e} -> {new_cost:.6e} "
                  f"accepted={accepted} lam={lam:.2e}")
        rel = abs(last_cost - new_cost) / max(new_cost, 1e-30)
        done = (accepted and rel < options.function_tolerance) or (
            not accepted and lam >= options.max_lambda
        )
        if accepted:
            last_cost = new_cost
        it += 1
    return problem, cur_cost, it


def lm_solve_fused_packed(problem: BAProblem, maps: PackedMaps, model_id: int,
                          options: BAOptions, masks: BAMasks):
    """Full packed LM solve. Returns (problem, final_cost, num_iterations).

    Stops on function tolerance or lambda saturation, as colmap_tpu's
    fused loop. ``solver_type`` picks the dense Schur solve (K4 + Cholesky)
    or PCG with the block-Jacobi preconditioner (K3)."""
    return _lm_loop(problem, maps, model_id, options, masks, _use_dense(problem, options), True)


def _unpack(problem: BAProblem, solved: BAProblem) -> BAProblem:
    return problem._replace(quat=solved.quat, t=solved.t,
                            cam_params=solved.cam_params, points=solved.points)


def solve_packed(problem: BAProblem, model_id: int,
                 options: Optional[BAOptions] = None,
                 masks: Optional[BAMasks] = None):
    """Pack + solve + unpack. Parameters keep their layout (only the
    observation arrays are permuted internally). Returns (problem, summary)."""
    if options is None:
        options = BAOptions()
    if masks is None:
        masks = default_masks(problem, model_id, options)
    packed, maps, _ = pack_problem(problem)
    initial_cost = float(compute_cost(packed, model_id, options))
    solved, final_cost, n_iters = lm_solve_fused_packed(packed, maps, model_id, options, masks)
    return _unpack(problem, solved), {
        "initial_cost": initial_cost,
        "final_cost": float(final_cost),
        "num_iterations": int(n_iters),
    }


def solve(problem: BAProblem, model_id: int, options: Optional[BAOptions] = None,
          masks: Optional[BAMasks] = None, verbose: bool = False):
    """Run LM to convergence with colmap_tpu's ``solve`` semantics: always
    PCG, with the scalar Jacobi preconditioner, whatever ``solver_type`` says.
    It runs on the packed kernels. Returns (problem, summary dict)."""
    if options is None:
        options = BAOptions()
    if masks is None:
        masks = default_masks(problem, model_id, options)
    initial_cost = float(compute_cost(problem, model_id, options))
    packed, maps, _ = pack_problem(problem)
    solved, final_cost, n_iters = _lm_loop(packed, maps, model_id, options, masks,
                                           False, False, verbose)
    return _unpack(problem, solved), {
        "initial_cost": initial_cost,
        "final_cost": float(final_cost),
        "num_iterations": int(n_iters),
    }
