"""Global positioning: camera centers and points from bearing directions.

Counterpart of colmap_tpu/estimators/global_positioning.py (reference
behavior: src/colmap/estimators/global_positioning.h:33-120). The
per-observation scale is eliminated in closed form, leaving the projected
residual r = (I − d dᵀ)(X_p − c_i), linear in the unknowns; each IRLS round
(Huber weights) solves the linear system by point-Schur elimination and
Jacobi-preconditioned CG. The gauges: one observation's parallel component
pinned to 1 (scale, weight relative to the mean observation weight) and the
best-covered camera's centre held fixed (translation). See colmap_tpu's
module for the derivation.

One round runs on K22 and K39 (kernels/global_sfm.py): setup, the CG
(K39's set-up, then ``cg_iterations`` x (K22's Schur matvec, K39's step
with colmap_tpu's freeze rule ``live = rz > 1e-12 rz0``)) and the
back-substitution. On the card the CG is one CUDA graph: the setup writes
into the solve's own buffers, the first round's CG runs eagerly, the
second's is captured, and every later one replays it; no CG step reads the
host. The host reads the cost once per round. The relative ridge and the mean-relative anchor weight are float32
numerics, kept as they are.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from colmap_tpu_torch.kernels import global_sfm as K
from colmap_tpu_torch.utils import cuda_graph
from colmap_tpu_torch.utils.dtypes import floatx, resolve_device


@dataclasses.dataclass(frozen=True)
class GlobalPositioningOptions:
    max_num_iterations: int = 100  # IRLS rounds
    cg_iterations: int = 100
    huber_scale: float = 0.1
    function_tolerance: float = 1e-10
    seed: int = 0
    init_scale: float = 1.0
    anchor_weight: float = 100.0


def _cg(prob: K.GPProblem, sys: K.GPSystem, cg_iterations: int, kernels):
    """The round's CG on the Schur system: K39's set-up (M from diag_c with
    the relative ridge), then cg_iterations x (K22 (b), K39's step in
    positioning mode). Returns xc (C, 3)."""
    st = kernels.cg_setup(K.CG_POSITIONING, sys.b, sys.diag_c, prob.eps_rel)
    for _ in range(cg_iterations):
        st = kernels.cg_step(K.CG_POSITIONING, st, kernels.gp_schur_matvec(prob, sys, st.p))
    return st.x


def _irls_round(prob: K.GPProblem, centers, points, cg_iterations: int, kernels=K.KERNELS,
                cg=None, buf=None):
    """One IRLS round; returns ((centers, points), cost at the input state).
    With ``cg`` (a cuda_graph.StepGraph of ``_cg`` over the buffers ``buf``)
    the setup writes into ``buf`` and ``cg`` runs the CG."""
    if cg is None:
        sys = kernels.gp_setup(prob, centers, points)
        xc = _cg(prob, sys, cg_iterations, kernels)
    else:
        sys = kernels.gp_setup(prob, centers, points, out=buf)
        xc = cg()
    return kernels.gp_back_substitute(prob, sys, xc, centers, points), sys.cost


def solve_global_positioning(
    num_cams: int,
    num_points: int,
    obs_cam: np.ndarray,
    obs_point: np.ndarray,
    dirs_world: np.ndarray,
    obs_w: Optional[np.ndarray] = None,
    options: Optional[GlobalPositioningOptions] = None,
    init_centers: Optional[np.ndarray] = None,
    init_points: Optional[np.ndarray] = None,
    dtype=None,
    device=None,
    kernels=K.KERNELS,
    stats: Optional[dict] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Camera centers (C, 3) and points (P, 3), float64, from world-frame
    bearings ``dirs_world`` (O, 3) pointing from each observation's camera
    centre toward its point. The similarity gauge is the internal anchor's;
    align afterwards as needed. The initial centres and points are drawn from
    ``np.random.default_rng(options.seed)``, as colmap_tpu draws them. Runs on
    ``device`` (default cuda) in ``dtype`` (default its floatx); ``kernels``
    and ``stats`` as in rotation_averaging.estimate_rotations.
    """
    if options is None:
        options = GlobalPositioningOptions()
    device = resolve_device(device)
    dtype = dtype or floatx(device)
    rng = np.random.default_rng(options.seed)
    if init_centers is None:
        init_centers = options.init_scale * rng.standard_normal((num_cams, 3))
    if init_points is None:
        init_points = options.init_scale * rng.standard_normal((num_points, 3))
    if obs_w is None:
        obs_w = np.ones(len(obs_cam))

    d = np.asarray(dirs_world, dtype=np.float64)
    d = d / np.maximum(np.linalg.norm(d, axis=1, keepdims=True), 1e-30)

    def dev(a, dt=dtype):
        return torch.as_tensor(np.asarray(a), dtype=dt).to(device).contiguous()

    ow = dev(obs_w)
    # Scale anchor: the first observation of the best-covered camera.
    counts = np.bincount(np.asarray(obs_cam), minlength=num_cams)
    anchor_obs = int(np.nonzero(np.asarray(obs_cam) == int(np.argmax(counts)))[0][0])
    prob = K.gp_problem(dev(d), dev(obs_cam, torch.int32), dev(obs_point, torch.int32), ow,
                        anchor_obs, options.anchor_weight * float(ow.mean()), num_cams,
                        num_points, options.huber_scale)
    centers, points = dev(init_centers), dev(init_points)
    cg = buf = None
    if device.type == "cuda" and kernels is K.KERNELS:
        buf = K.gp_system_buffers(prob)
        cg = cuda_graph.StepGraph(lambda: _cg(prob, buf, options.cg_iterations, kernels), device,
                                  (K,), True)
    prev = np.inf
    rounds = 0
    for _ in range(options.max_num_iterations):
        (centers, points), cost = _irls_round(prob, centers, points, options.cg_iterations,
                                              kernels, cg, buf)
        rounds += 1
        c = float(cost)
        if abs(prev - c) < options.function_tolerance * max(c, 1e-12):
            break
        prev = c
    if stats is not None:
        stats.update(irls_iterations=rounds, cost=c if rounds else None,
                     cg_graph=cg is not None and cg.replay is not None,
                     record_s=0.0 if cg is None else cg.record_s,
                     instantiate_s=0.0 if cg is None else cg.instantiate_s)
    return centers.double().cpu().numpy(), points.double().cpu().numpy()
