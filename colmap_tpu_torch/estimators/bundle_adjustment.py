"""Bundle adjustment: Levenberg-Marquardt on the point-Schur-reduced system.

Counterpart of colmap_tpu/estimators/bundle_adjustment.py (reference:
src/colmap/estimators/bundle_adjustment{.h,_ceres.h,_caspar.h}). The solver
works in the point-major packed layout of ``pack_problem``: observations
sorted by point and padded to a common per-point capacity ``capp``, so every
point-side sum is a contiguous run of slots. Each LM step runs the kernels of
``colmap_tpu_torch.kernels.ba`` and ``kernels.solver``:

    K1 obs_jacobians / obs_cost    residuals, Jacobians, robust weights; cost
    K2 lm_reduce                   gradients, Hpp⁻¹, reduced right-hand side
    K3 schur_matvec                reduced-system matvec in PCG; back-substitution
    K4 dense_schur_assemble        explicit S for the dense Cholesky solve
    K34 pcg_setup / pcg_step       PCG's preconditioner, vectors and scalars
    K35 lm_candidate / lm_accept   the update, predicted decrease, damping rule

and library calls for the Cholesky (or ridge) solve of S. The loop is
device-resident, as colmap_tpu's while_loop: lam, nu, the costs, the
iteration count and ``done`` live in device memory, a PCG solve captures
one iteration as a CUDA graph and replays it (GRAPH_MIN_ITERATIONS), and
the host reads a 1-byte done flag once per DONE_CHUNK iterations.

Problem layout (struct-of-arrays tensors; padding rows carry weight 0):
    frame poses:  quat (F, 4), t (F, 3)           cam_from_world
    cameras:      cam_params (C, P)                one model id per problem, or
                                                   rows (C, Pmax + 1) of mixed models
    points:       points (N, 3)
    observations: obs_frame/obs_cam/obs_point (O,) int32, obs_xy (O, 2), obs_w (O,)

Parameterization: rotation by a left-multiplied quaternion exponential,
translation, masked camera parameters and points additive. Gauge and
constant blocks via per-block masks (reference: BundleAdjustmentConfig).
The residual model (make_residual_fn, quat_exp, the robust losses) is in
``ba_residual.py``. A problem that mixes camera models has a tuple of
model ids and colmap_tpu's padded rows with a trailing model-position column
(sensor/models.py pack_mixed_params); K1 runs once per model present.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from colmap_tpu_torch.kernels import ba as ba_kernels
from colmap_tpu_torch.kernels import solver
from colmap_tpu_torch.sensor import models as camera_models
from colmap_tpu_torch.utils import cuda_graph


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
    # K2's sums by frame and camera (kernels/ba.py slot_order); the plain
    # versions need none.
    order: Optional[ba_kernels.SlotOrder] = None


def camera_mask(cam_params, model_id, options: BAOptions):
    """(C, P) freedom of each camera row's parameters by its model; a mixed
    problem's padding and model-position column stay constant."""
    C, P = cam_params.shape
    mask = torch.zeros(C, P, dtype=cam_params.dtype)
    for row, m in enumerate(camera_models.row_models(model_id, cam_params)):
        idxs = []
        if options.refine_focal_length:
            idxs += list(camera_models.focal_length_idxs(m))
        if options.refine_principal_point:
            idxs += list(camera_models.principal_point_idxs(m))
        if options.refine_extra_params:
            idxs += list(camera_models.extra_params_idxs(m))
        mask[row, idxs] = 1.0
    return mask.to(cam_params.device)


def default_masks(problem: BAProblem, model_id, options: BAOptions,
                  const_frames=None, const_points=None) -> BAMasks:
    F = problem.quat.shape[0]
    N = problem.points.shape[0]
    like = dict(dtype=problem.points.dtype, device=problem.points.device)
    frame_mask = torch.ones(F, **like)
    if const_frames is not None:
        frame_mask[torch.as_tensor(const_frames, device=frame_mask.device)] = 0.0
    if not options.refine_poses:
        frame_mask = torch.zeros(F, **like)
    frame_trans_mask = torch.ones(F, 3, **like) * frame_mask[:, None]
    cam_mask = camera_mask(problem.cam_params, model_id, options)
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
    carry obs_w = 0 and frame/cam id 0; their Jacobian rows are zero. The
    maps' ``order`` lists the real slots by frame and by camera for K2.
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
    real = np.zeros(Opm, dtype=bool)
    real[slots] = True
    order = ba_kernels.slot_order(frame_pm, cam_pm, real, F, problem.cam_params.shape[0], device)
    maps = PackedMaps(packed.obs_frame.view(N, capp), packed.obs_cam.view(N, capp), order)
    counts_f = np.bincount(obs_frame, minlength=F)
    capf = int(max(1, -(-int(counts_f.max(initial=0)) // align) * align))
    return packed, maps, {"capf": capf, "capp": capp}


def compute_cost(problem: BAProblem, model_id, options: BAOptions):
    """½ Σ ρ(‖r‖²)·w as a 0-d tensor (K1, cost mode)."""
    return _cost(problem, model_id, options, ba_kernels.KERNELS)


def _cost(problem: BAProblem, model_id, options: BAOptions, kernels, groups=None):
    p = problem
    return kernels.obs_cost(p.quat, p.t, p.cam_params, p.points, p.obs_frame, p.obs_cam,
                             p.obs_point, p.obs_xy, p.obs_w, model_id, options.loss,
                             options.loss_scale, groups)


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


def _dense_schur_solve(S, bp, bc):
    """Cholesky solve of the assembled S, or the ridge solve of
    S + 1e-6 I where S is not SPD, chosen on the device as colmap_tpu does
    (l.1636-1642): both are computed, no host read."""
    F, C = bp.shape[0], bc.shape[0]
    b = torch.cat([bp.reshape(-1), bc.reshape(-1)])
    L, info = torch.linalg.cholesky_ex(S)
    d = torch.cholesky_solve(b[:, None], L)[:, 0]
    bad = (info != 0) | ~torch.isfinite(L).all()
    eye = torch.eye(S.shape[0], dtype=S.dtype, device=S.device)
    d_ridge = torch.linalg.solve_ex(S + 1e-6 * eye, b)[0]
    d = torch.where(bad, d_ridge, d)
    return d[: 6 * F].reshape(F, 6), d[6 * F:].reshape(C, -1)


def _use_dense(problem: BAProblem, options: BAOptions) -> bool:
    F = problem.quat.shape[0]
    C, P = problem.cam_params.shape
    return options.solver_type == "dense_schur" or (
        options.solver_type == "auto" and 6 * F + C * P <= options.dense_schur_max_dim
    )


def _pcg(kernels, Jp, Jc, Jx, maps: PackedMaps, red, lam, block_jacobi: bool, iterations: int,
         reduce=None):
    """PCG on (S + λD) x = b with a fixed iteration count: K34's set-up,
    then per iteration K3's matvec (summed over the ranks by ``reduce``, if
    given) and K34's step. Returns (dp, dc)."""
    F = red.bp.shape[0]
    C, P = red.bc.shape
    st = kernels.pcg_setup(red.Hcc_pose, red.diag_pose, red.diag_cam, red.bp, red.bc, lam,
                           block_jacobi)
    for _ in range(iterations):
        Ap_p, Ap_c = kernels.schur_matvec(Jp, Jc, Jx, maps.frame_pm, maps.cam_pm, red.Hpp_inv,
                                          st.p[:6 * F].view(F, 6), st.p[6 * F:].view(C, P))
        if reduce is not None:
            reduce(Ap_p, Ap_c)
        st = kernels.pcg_step(st, Ap_p, Ap_c, lam, red.diag_pose, red.diag_cam)
    return st.x[:6 * F].view(F, 6), st.x[6 * F:].view(C, P)


class _LMScalars(NamedTuple):
    """The loop's scalars in device memory: lam (0-d, the problem's type),
    K35's state S (float64, ``solver.LM_FIELDS``) and the 1-byte done flag."""

    lam: torch.Tensor
    S: torch.Tensor
    done: torch.Tensor


def _lm_scalars(cost, lam: float, nu: float, dtype) -> _LMScalars:
    """Scalars at the start of a solve; ``cost`` is a 0-d float64 tensor on
    the problem's device (no host read)."""
    dev = cost.device
    S = torch.zeros(len(solver.LM_FIELDS), dtype=torch.float64, device=dev)
    S[0] = nu
    S[1:3] = cost
    return _LMScalars(torch.full((), lam, dtype=dtype, device=dev), S,
                      torch.zeros(1, dtype=torch.uint8, device=dev))


def _lm_iteration(state: BAProblem, maps: PackedMaps, model_id, options: BAOptions,
                  obs_masks: _ObsMasks, sc: _LMScalars, kernels, use_dense: bool,
                  block_jacobi: bool, groups, reduce=None) -> None:
    """One LM iteration in the point-major layout, in place on ``state``'s
    parameter tensors and ``sc``: K1, K2, the dense solve (K4 + Cholesky) or
    PCG (K34, K3), K3's back-substitution, K35's candidate, K1's cost and
    K35's accept. It reads nothing back to the host, so it can be captured
    as a CUDA graph; once ``done`` is set it changes nothing.

    ``reduce(*tensors)``, given, sums its tensors over the ranks of a
    point-sharded solve in place (parallel/sharded_ba.py; colmap_tpu's
    psums): K2's camera-side outputs, each PCG matvec, the dense path's S
    (whose diagonal is then added once, l.1635), and the new cost with the
    point part of the predicted decrease. So every value that K34 and K35
    decide on is the same, bit for bit, on every rank."""
    p = state
    F = p.quat.shape[0]
    C = p.cam_params.shape[0]
    lam = sc.lam
    r, Jp, Jc, Jx = kernels.obs_jacobians(
        p.quat, p.t, p.cam_params, p.points, p.obs_frame, p.obs_cam, p.obs_point,
        p.obs_xy, p.obs_w, obs_masks.pose, obs_masks.cam, obs_masks.point,
        model_id, options.loss, options.loss_scale, groups,
    )
    red = kernels.lm_reduce(r, Jp, Jc, Jx, maps.frame_pm, maps.cam_pm, F, C, lam, maps.order)
    if reduce is not None:
        reduce(red.gp, red.gc, red.bp, red.bc, red.diag_pose, red.diag_cam, red.Hcc_pose)
    if use_dense:
        lam_diag = torch.cat([(lam * red.diag_pose).reshape(-1), (lam * red.diag_cam).reshape(-1)])
        S = kernels.dense_schur_assemble(Jp, Jc, Jx, maps.frame_pm, maps.cam_pm,
                                          red.Hpp_inv, lam_diag, F, diagonal=reduce is None)
        if reduce is not None:
            reduce(S)
            S.diagonal().add_(lam_diag + 1e-10)
        dp, dc = _dense_schur_solve(S, red.bp, red.bc)
    else:
        dp, dc = _pcg(kernels, Jp, Jc, Jx, maps, red, lam, block_jacobi, options.pcg_iterations,
                      reduce)
    dx = kernels.back_substitute(Jp, Jc, Jx, maps.frame_pm, maps.cam_pm,
                                  red.Hpp_inv, red.gx, dp, dc)
    cand, pred = kernels.lm_candidate(p.quat, p.t, p.cam_params, p.points, dp, dc, dx, red, lam,
                                      split=reduce is not None)
    new_cost = kernels.obs_cost64(*cand, p.obs_frame, p.obs_cam, p.obs_point, p.obs_xy, p.obs_w,
                                  model_id, options.loss, options.loss_scale, groups)
    if reduce is not None:
        summed = torch.stack([new_cost, pred[1]])
        reduce(summed)
        new_cost, pred = summed[0], pred[0] + summed[1]
    kernels.lm_accept(lam, sc.S, new_cost, pred, (p.quat, p.t, p.cam_params, p.points), cand,
                      options.min_lambda, options.max_lambda, options.function_tolerance,
                      sc.done)


def _own_state(problem: BAProblem) -> BAProblem:
    """The parameter tensors the loop updates in place: copies, so the
    caller's problem stays as it was."""
    return problem._replace(quat=problem.quat.clone(), t=problem.t.clone(),
                            cam_params=problem.cam_params.clone(),
                            points=problem.points.clone())


def _start(problem: BAProblem, model_id, options: BAOptions, lam: float, nu: float, kernels,
           reduce=None):
    """(state, scalars, groups) at the start of a solve: the model groups of
    a mixed problem (once per solve), the state's copy, its cost on the
    device (summed over the ranks by ``reduce``, if given)."""
    groups = ba_kernels.model_groups(model_id, problem.cam_params, problem.obs_cam)
    p = _own_state(problem)
    cost = kernels.obs_cost64(p.quat, p.t, p.cam_params, p.points, p.obs_frame, p.obs_cam,
                              p.obs_point, p.obs_xy, p.obs_w, model_id, options.loss,
                              options.loss_scale, groups)
    if reduce is not None:
        reduce(cost)
    return p, _lm_scalars(cost, lam, nu, problem.points.dtype), groups


def lm_step_packed(problem: BAProblem, maps: PackedMaps, model_id,
                   options: BAOptions, masks: BAMasks, lam: float, nu: float,
                   reduce=None, solve_semantics: bool = False):
    """One LM iteration in the packed layout (same semantics as colmap_tpu's
    lm_step_packed). Returns (problem, lam, nu, cost, new_cost, accepted)
    with Python scalars. ``reduce`` as in _lm_iteration (one rank's shard
    of a point-sharded problem); ``solve_semantics``: PCG with the scalar
    Jacobi preconditioner whatever ``solver_type`` says, as ``solve``."""
    kernels = ba_kernels.KERNELS
    state, sc, groups = _start(problem, model_id, options, lam, nu, kernels, reduce)
    cost = sc.S[1].item()
    use_dense = not solve_semantics and _use_dense(problem, options)
    _lm_iteration(state, maps, model_id, options, _obs_masks(masks, options), sc, kernels,
                  use_dense, not solve_semantics, groups, reduce)
    S = dict(zip(solver.LM_FIELDS, sc.S.tolist()))
    return (state, float(sc.lam), S["nu"], cost, S["new_cost"], bool(S["accepted"]))


# Host reads of the done flag on the card: one per DONE_CHUNK iterations.
# A read drains the queue and costs T_r; an iteration past ``done`` is a
# frozen no-op that costs its device time T_i. For n iterations the
# overhead n T_r / k + (k - 1) T_i / 2 is least near k = sqrt(2 n T_r / T_i),
# 0.5-1.4 at the mapper's local BAs and at the BA headline (T_r 17-69 us,
# T_i 0.8-2.2 ms, n 10-22: chip_smoke.py phase solver_kernels, "loop
# costs"; PERF.md §6).
DONE_CHUNK = 1
# The graph's size rule: a PCG solve captures one iteration as a CUDA graph
# and replays it when it may run at least GRAPH_MIN_ITERATIONS iterations.
# The first iteration runs eagerly; recording and instantiating cost R, a
# replay saves s = (eager - replay) per iteration, so the graph pays for
# itself from iteration 1 + R / s on: 2.3-7.5 at the shapes the same lines
# measure, from 8 x 600 to the headline. Below that count, and on the dense
# path (its iteration is bound by the card: a replay saves nothing), the
# same kernels launch without a graph.
GRAPH_MIN_ITERATIONS = 8


def drive(step, sc: _LMScalars, device, max_iterations: int, graph_wanted: bool, modules,
          verbose_step=None):
    """The host side of a device-resident LM loop (the packed and the rig
    solves): run ``step`` (one in-place LM iteration) until ``sc.done`` or
    ``max_iterations``. On the card the host runs DONE_CHUNK iterations
    between two reads of the 1-byte done flag; with ``graph_wanted`` the
    first iteration runs eagerly (it loads what its library calls need) and
    the rest replay a CUDA graph of one iteration, captured once
    (utils/cuda_graph.py; ``modules`` are the kernel modules whose launch
    counts a replay moves). Iterations past ``done`` change nothing (K35,
    K38). ``verbose_step(n, cost_before)``, if given, runs after every
    iteration, which then reads the cost each time. Returns the info dict:
    whether a graph was replayed, its record and instantiate seconds, the
    host reads, the iterations taken, and the final scalar state ``S``."""
    chunk = DONE_CHUNK if device.type == "cuda" and verbose_step is None else 1
    run = cuda_graph.StepGraph(step, device, modules, graph_wanted)
    reads, n = 0, 0
    while n < max_iterations:
        for _ in range(min(chunk, max_iterations - n)):
            cost = sc.S[1].item() if verbose_step is not None else None
            run()
            n += 1
            if verbose_step is not None:
                verbose_step(n, cost)
        reads += 1
        if sc.done.item():
            break
    S = dict(zip(solver.LM_FIELDS, sc.S.tolist()))
    return dict(graph=run.replay is not None, record_s=run.record_s,
                instantiate_s=run.instantiate_s, host_reads=reads + 1, S=S,
                iterations=int(S["it"]))


def _lm_loop(problem, maps, model_id, options, masks, use_dense, block_jacobi,
             verbose=False, kernels=ba_kernels.KERNELS, with_info=False, reduce=None):
    """The LM loop of every solve: (state, final cost, iterations), and with
    ``with_info`` a fourth value, a dict of what the solve did (whether it
    replayed a graph, the seconds to record and instantiate it, its host
    reads, its iterations). ``kernels`` is ``ba_kernels.KERNELS``; a check on
    the card passes ``ba_kernels.PLAIN`` to run the same solve through the
    plain versions.

    Everything between two reads of the 1-byte done flag stays on the
    device (``drive``): a PCG solve replays a CUDA graph of one iteration
    under the size rule GRAPH_MIN_ITERATIONS; the dense path launches
    eagerly. ``verbose`` reads and prints every iteration. With ``reduce``
    (one rank's shard of a point-sharded solve, see _lm_iteration) the
    iterations launch without a graph: the collectives are not captured."""
    dev = problem.points.device
    obs_masks = _obs_masks(masks, options)
    state, sc, groups = _start(problem, model_id, options, options.initial_lambda, 2.0,
                               kernels, reduce)

    def step():
        _lm_iteration(state, maps, model_id, options, obs_masks, sc, kernels, use_dense,
                      block_jacobi, groups, reduce)

    def verbose_step(n, cost):
        S = dict(zip(solver.LM_FIELDS, sc.S.tolist()))
        print(f"  LM it {n - 1}: cost {cost:.6e} -> {S['new_cost']:.6e} "
              f"accepted={bool(S['accepted'])} lam={float(sc.lam):.2e}")

    graph_wanted = (dev.type == "cuda" and kernels is ba_kernels.KERNELS and not use_dense
                    and reduce is None and options.max_iterations >= GRAPH_MIN_ITERATIONS)
    info = drive(step, sc, dev, options.max_iterations, graph_wanted, (ba_kernels, solver),
                 verbose_step if verbose else None)
    S = info.pop("S")
    if with_info:
        return state, S["cost"], int(S["it"]), info
    return state, S["cost"], int(S["it"])


def lm_solve_fused_packed(problem: BAProblem, maps: PackedMaps, model_id,
                          options: BAOptions, masks: BAMasks):
    """Full packed LM solve. Returns (problem, final_cost, num_iterations).

    Stops on function tolerance or lambda saturation, as colmap_tpu's
    fused loop. ``solver_type`` picks the dense Schur solve (K4 + Cholesky)
    or PCG with the block-Jacobi preconditioner (K3)."""
    return _lm_loop(problem, maps, model_id, options, masks, _use_dense(problem, options), True)


def _unpack(problem: BAProblem, solved: BAProblem) -> BAProblem:
    return problem._replace(quat=solved.quat, t=solved.t,
                            cam_params=solved.cam_params, points=solved.points)


def solve_packed(problem: BAProblem, model_id,
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


def solve(problem: BAProblem, model_id, options: Optional[BAOptions] = None,
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
