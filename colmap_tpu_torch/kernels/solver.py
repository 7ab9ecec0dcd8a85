"""The mapper's solver loops: wrappers, plain PyTorch versions, launch counts.

Four CUDA kernels carry what the mapper's solvers ran as host loops of
small torch ops (sources in ``colmap_tpu_torch/csrc``):

    K34 ba_pcg                 pcg_setup, pcg_step, pcg_setup_diag
    K35 ba_lm_update           lm_candidate, lm_accept
    K36 relative_pose          poses_from_essentials, refine_relative_poses
    K37 structure_less_ransac  structure_less_score, structure_less_inliers

K34 and K35 make the packed LM solve of ``estimators/bundle_adjustment.py``
device-resident: between two reads of its 1-byte done flag, one LM
iteration is K1, K2, K34's set-up, pcg_iterations x (K3, K34's step), K3's
back-substitution, K35's candidate, K1's cost and K35's accept, with lam, nu,
the costs and the iteration count in device memory. The rig BA's PCG
(estimators/bundle_adjustment_rig.py) runs K34 too: its set-up (c) from
K25's Jacobi preconditioner, and the step with F = 0 and no damping term
(K26's product holds it).

Each wrapper runs the plain version when its tensors lie on the CPU and
launches the kernel when they lie on a CUDA device; on a CUDA tensor it
launches or raises, it never falls back. ``LAUNCHES`` counts kernel launches
by kernel name (a wrapper adds one where it launches, nowhere else; a
replay of the LM loop's CUDA graph adds the launches the graph holds, and
recording it adds none). The
plain versions are float64-capable torch code; the CPU tests hold them
against colmap_tpu, and a check on the card holds the kernels against them.

Layouts. K34's vectors are flat (6F + C*P,), poses first; its
preconditioner M is (36F + C*P,): a 6x6 block per frame (a diagonal block
in scalar mode), then the camera entries. K35's scalar state ``S`` is nine
float64 values (``LM_FIELDS``); lam is a 0-d tensor of the problem's type.
K36 takes problems with their rows in CSR order: ``offsets`` (B + 1 ints)
gives problem k the rows offsets[k]..offsets[k + 1] of x1, x2 (rows, 2) and
the mask or weights. K37 takes the host's samples (camera, five rows and
the scale row of each) and returns every model [R | t] (10 per sample, NaN
where a slot holds none), its support and the batch's packed best
(``optim.ransac.pack_best``).
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from colmap_tpu_torch.estimators.ba_residual import quat_exp
from colmap_tpu_torch.estimators.solvers.epipolar import essential_five_point
from colmap_tpu_torch.geometry import rotation as rot
from colmap_tpu_torch.geometry.essential import (
    calc_depth,
    cross_product_matrix,
    decompose_essential_matrix,
    triangulate_point_dlt,
)
from colmap_tpu_torch.kernels.tally import ShapeTally
from colmap_tpu_torch.optim.ransac import pack_best

LAUNCHES = {
    "ba_pcg": 0,
    "ba_lm_update": 0,
    "relative_pose": 0,
    "structure_less_ransac": 0,
}
# Launch shapes of the kernels above, counted where LAUNCHES is (kernels/tally.py).
SHAPES = ShapeTally()

# K35's scalar state, one float64 each, in this order.
LM_FIELDS = ("nu", "cost", "last_cost", "it", "done", "accepted", "take", "new_cost", "pred")


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    SHAPES.reset()


class PCGState(NamedTuple):
    """K34's state: preconditioner, iterate, residual, preconditioned
    residual, direction (flat, poses first) and rz (1,) float64."""

    M: torch.Tensor
    x: torch.Tensor
    r: torch.Tensor
    z: torch.Tensor
    p: torch.Tensor
    rz: torch.Tensor


# ---------------------------------------------------------------------------
# Plain versions.
# ---------------------------------------------------------------------------


def _precond_plain(M, v, F: int):
    """M v: 6x6 blocks on the pose entries, scalars on the camera entries."""
    zp = (M[:36 * F].view(F, 6, 6) @ v[:6 * F].view(F, 6, 1)).reshape(-1)
    return torch.cat([zp, M[36 * F:] * v[6 * F:]])


def pcg_setup_plain(Hcc_pose, diag_pose, diag_cam, bp, bc, lam, block_jacobi: bool) -> PCGState:
    """K34 set-up: the preconditioner of _packed_pcg (6x6 inverses of
    H_cc's pose blocks + diag(lam diag_pose + 1e-10), l.993-1002) or of
    _pcg (scalar Jacobi, l.397-404), x = 0, r = b, z = p = M r, rz = r.z."""
    F = bp.shape[0]
    if block_jacobi:
        Mp = torch.linalg.inv(Hcc_pose + torch.diag_embed(lam * diag_pose + 1e-10))
    else:
        d = diag_pose + lam * diag_pose
        Mp = torch.diag_embed(torch.where(d > 1e-12, 1.0 / d, 0.0))
    dc = diag_cam + lam * diag_cam
    Mc = torch.where(dc > 1e-12, 1.0 / dc, 0.0)
    M = torch.cat([Mp.reshape(-1), Mc.reshape(-1)])
    b = torch.cat([bp.reshape(-1), bc.reshape(-1)])
    z = _precond_plain(M, b, F)
    rz = (b.double() * z.double()).sum().reshape(1)
    return PCGState(M, torch.zeros_like(b), b, z, z.clone(), rz)


def pcg_setup_diag_plain(M, b) -> PCGState:
    """K34 set-up (c), the rig BA's (colmap_tpu's bundle_adjustment_rig.py
    _pcg, l.281-296): the given scalar preconditioner M, x = 0, r = b,
    z = p = M r, rz = r.z; M and b flat (n,)."""
    z = M * b
    rz = (b.double() * z.double()).sum().reshape(1)
    return PCGState(M, torch.zeros_like(b), b, z, z.clone(), rz)


def pcg_step_plain(st: PCGState, Ap_p, Ap_c, lam, diag_pose, diag_cam) -> PCGState:
    """K34 step, after Ap = S p (K3): the fori_loop body of _packed_pcg
    (l.1015-1032) with the lam D p term of _packed_matvec; with diag_pose
    and diag_cam None (the rig's step, F = 0), Ap as it is."""
    F = Ap_p.shape[0]
    Ap = torch.cat([Ap_p.reshape(-1), Ap_c.reshape(-1)])
    if diag_cam is not None:
        Ap = Ap + lam * torch.cat([diag_pose.reshape(-1), diag_cam.reshape(-1)]) * st.p
    pAp = (st.p.double() * Ap.double()).sum()
    rz = st.rz[0]
    alpha = torch.where(pAp.abs() > 1e-30, rz / pAp, 0.0).to(st.x.dtype)
    x = st.x + alpha * st.p
    r = st.r - alpha * Ap
    z = _precond_plain(st.M, r, F)
    rz_new = (r.double() * z.double()).sum()
    beta = torch.where(rz.abs() > 1e-30, rz_new / rz, 0.0).to(st.x.dtype)
    return PCGState(st.M, x, r, z, z + beta * st.p, rz_new.reshape(1))


def lm_candidate_plain(quat, t, cam_params, points, dp, dc, dx, red, lam, split: bool = False):
    """K35 candidate: _apply_update (l.435) and the predicted decrease of
    l.1137-1146, 0.5 (g.d + lam diag.d^2) over poses, cameras and points.
    ``red`` is K2's LMReduction. Returns ((quat, t, cam, points), pred
    0-d float64); with ``split``, pred is (2,) float64: the pose and camera
    part, then the point part (a point-sharded solve sums only the latter
    over its ranks, l.1127-1130)."""
    q = rot.quat_normalize(rot.quat_multiply(quat_exp(dp[:, :3]), quat))
    cand = (q, t + dp[:, 3:], cam_params + dc, points + dx)
    cam_part = (dp * red.gp).sum() + (dc * red.gc).sum() + lam * (
        (red.diag_pose * dp * dp).sum() + (red.diag_cam * dc * dc).sum())
    pt_part = (dx * red.gx).sum() + lam * (red.diag_pt * dx * dx).sum()
    if split:
        return cand, 0.5 * torch.stack([cam_part, pt_part]).double()
    return cand, (0.5 * (cam_part + pt_part)).double()


def lm_accept_plain(lam, S, new_cost, pred, state, cand, min_lambda: float, max_lambda: float,
                    function_tolerance: float, done_flag) -> None:
    """K35 accept, in place: the gain ratio, Nielsen's damping rule and the
    state selection of l.1147-1153, the while_loop's test (l.1195-1199),
    the iteration count; nothing changes once ``done`` is set."""
    active = S[4] == 0
    nu, cost, last = S[0], S[1], S[2]
    nc, pr = new_cost.double().reshape(()), pred.double().reshape(())
    lam64 = lam.double()
    rho = (cost - nc) / torch.clamp(pr, min=1e-30)
    acc = (nc < cost) & (pr > 0)
    shrink = torch.clamp(1.0 - (2.0 * rho - 1.0) ** 3, min=1.0 / 3.0)
    new_lam = torch.where(acc, torch.clamp(lam64 * shrink, min_lambda, max_lambda),
                          torch.clamp(lam64 * nu, max=max_lambda)).to(lam.dtype)
    rel = torch.abs(last - nc) / torch.clamp(nc, min=1e-30)
    done = (acc & (rel < function_tolerance)) | (~acc & (new_lam.double() >= max_lambda))
    one, zero = torch.ones_like(cost), torch.zeros_like(cost)
    new_S = torch.stack([
        torch.where(acc, 2.0 * one, 2.0 * nu), torch.where(acc, nc, cost),
        torch.where(acc, nc, last), S[3] + 1, torch.where(done, one, zero),
        torch.where(acc, one, zero), torch.where(acc, one, zero), nc, pr])
    frozen = S.clone()
    frozen[6] = 0.0
    take = active & acc
    for s, c in zip(state, cand):
        s.copy_(torch.where(take, c, s))
    lam.copy_(torch.where(active, new_lam, lam))
    S.copy_(torch.where(active, new_S, frozen))
    done_flag.copy_(S[4:5] != 0)


def _pose_from_essential_plain(E, x1, x2, mask):
    """One problem of K36 (a): the (R, t) of E's four decompositions with
    the most masked rows in front of both cameras (the first on a tie, as
    argmax), its triangulated points, count and mask."""
    R1, R2, t = decompose_essential_matrix(E)
    eye34 = torch.eye(3, 4, dtype=E.dtype, device=E.device)
    best = None
    for R, tt in ((R1, t), (R2, t), (R1, -t), (R2, -t)):
        proj2 = torch.cat([R, tt[:, None]], dim=1)
        X = triangulate_point_dlt(eye34, proj2, x1, x2)
        d1 = calc_depth(eye34, X)
        d2 = calc_depth(proj2, X)
        max_depth = 1000.0 * torch.linalg.vector_norm(tt)
        ok = (d1 > 1e-12) & (d1 < max_depth) & (d2 > 1e-12) & (d2 < max_depth) & mask
        count = ok.sum()
        if best is None or bool(count > best[3]):
            best = (R, tt, X, count, ok)
    return best


def poses_from_essentials_plain(E, x1, x2, mask, offsets):
    """K36 (a): colmap_tpu's pose_from_essential_matrix (essential.py:94)
    for each problem. E (B, 3, 3); x1, x2 (rows, 2) and mask (rows,) bool in
    CSR order by ``offsets``. Returns R (B, 3, 3), t (B, 3), points (rows,
    3), counts (B,), valid mask (rows,)."""
    outs = [_pose_from_essential_plain(E[k], x1[lo:hi], x2[lo:hi], mask[lo:hi])
            for k, (lo, hi) in enumerate(zip(offsets[:-1], offsets[1:]))]
    if not outs:
        z = x1.new_zeros
        return (z(0, 3, 3), z(0, 3), z(0, 3), torch.zeros(0, dtype=torch.int64, device=x1.device),
                torch.zeros(0, dtype=torch.bool, device=x1.device))
    R, t, X, count, ok = zip(*outs)
    return (torch.stack(R), torch.stack(t), torch.cat(X), torch.stack(count), torch.cat(ok))


def _tangent_basis(t):
    """Two unit vectors orthogonal to unit t."""
    eye = torch.eye(3, dtype=t.dtype, device=t.device)
    ref = torch.where(torch.abs(t[0]) < 0.9, eye[0], eye[1])
    b1 = torch.linalg.cross(t, ref)
    b1 = b1 / torch.clamp(torch.linalg.vector_norm(b1), min=1e-12)
    return b1, torch.linalg.cross(t, b1)


def _sampson_residuals(quat, t, x1, x2):
    """Signed Sampson residuals of E = [t]x R(quat) on rows x1, x2 (N, 2)
    (relative_pose.py _sampson_residuals)."""
    E = cross_product_matrix(t) @ rot.quat_to_rotmat(quat)
    ones = torch.ones_like(x1[..., :1])
    p1 = torch.cat([x1, ones], dim=-1)
    p2 = torch.cat([x2, ones], dim=-1)
    Ex1 = p1 @ E.T
    Etx2 = p2 @ E
    x2tEx1 = (p2 * Ex1).sum(-1)
    denom = torch.sqrt(torch.clamp(
        Ex1[..., 0] ** 2 + Ex1[..., 1] ** 2 + Etx2[..., 0] ** 2 + Etx2[..., 1] ** 2, min=1e-30))
    return x2tEx1 / denom


def _perturb(delta, quat, t, b1, b2):
    dq = rot.quat_normalize(torch.cat([torch.ones_like(delta[:1]), 0.5 * delta[:3]]))
    q = rot.quat_multiply(dq, quat)
    tt = t + delta[3] * b1 + delta[4] * b2
    return q, tt / torch.clamp(torch.linalg.vector_norm(tt), min=1e-12)


def _refine_one_plain(quat, t, x1, x2, weights, num_iterations: int):
    t = t / torch.clamp(torch.linalg.vector_norm(t), min=1e-12)
    sw = torch.sqrt(weights)
    lam = 1e-4
    eye5 = torch.eye(5, dtype=x1.dtype, device=x1.device)
    for _ in range(num_iterations):
        b1, b2 = _tangent_basis(t)

        def residual_fn(delta, quat=quat, t=t, b1=b1, b2=b2):
            q, tt = _perturb(delta, quat, t, b1, b2)
            return _sampson_residuals(q, tt, x1, x2) * sw

        zero = torch.zeros(5, dtype=x1.dtype, device=x1.device)
        r = residual_fn(zero)
        J = torch.func.jacfwd(residual_fn)(zero)  # (N, 5)
        H = J.T @ J
        delta = torch.linalg.solve(H + lam * torch.diag(torch.diag(H)) + 1e-12 * eye5, -J.T @ r)
        q_new, t_new = _perturb(delta, quat, t, b1, b2)
        q_new = rot.quat_normalize(q_new)
        new_cost = float((residual_fn(zero, q_new, t_new, *_tangent_basis(t_new)) ** 2).sum())
        if new_cost < float((r**2).sum()):
            quat, t, lam = q_new, t_new, max(lam / 3.0, 1e-10)
        else:
            lam = min(lam * 5.0, 1e6)
    r = _sampson_residuals(quat, t, x1, x2)
    rms = torch.sqrt((weights * r * r).sum() / torch.clamp(weights.sum(), min=1e-12))
    return quat, t, rms


def refine_relative_poses_plain(quat, t, x1, x2, weights, offsets, num_iterations: int = 15):
    """K36 (b): colmap_tpu's refine_relative_pose (relative_pose.py:55),
    LM on the Sampson error over (R, unit t), for each candidate: quat
    (K, 4), t (K, 3), rows in CSR order by ``offsets``. Returns quat (K, 4),
    unit t (K, 3), rms (K,)."""
    outs = [_refine_one_plain(quat[k], t[k], x1[lo:hi], x2[lo:hi], weights[lo:hi],
                              num_iterations)
            for k, (lo, hi) in enumerate(zip(offsets[:-1], offsets[1:]))]
    q, tt, rms = zip(*outs)
    return torch.stack(q), torch.stack(tt), torch.stack(rms)


def _poses_from_essentials5(E, x1, x2):
    """Cheirality of every essential matrix E (..., 3, 3) on its own five
    points x1, x2 (..., 5, 2): the (R, t) of the four decompositions with
    the most points in front of both cameras (the first on a tie), that
    count, and whether E is finite."""
    finite = torch.isfinite(E).flatten(-2).all(-1)
    E = torch.where(finite[..., None, None], E, torch.eye(3, dtype=E.dtype, device=E.device))
    R1, R2, t = decompose_essential_matrix(E)
    Rs = torch.stack([R1, R2, R1, R2], dim=-3)  # (..., 4, 3, 3)
    ts = torch.stack([t, t, -t, -t], dim=-2)  # (..., 4, 3)
    proj2 = torch.cat([Rs, ts[..., None]], dim=-1)[..., None, :, :]  # (..., 4, 1, 3, 4)
    eye34 = torch.eye(3, 4, dtype=E.dtype, device=E.device)
    X = triangulate_point_dlt(eye34, proj2, x1[..., None, :, :], x2[..., None, :, :])
    d1, d2 = calc_depth(eye34, X), calc_depth(proj2, X)
    ok = (d1 > 1e-12) & (d1 < 1000.0) & (d2 > 1e-12) & (d2 < 1000.0)  # |t| = 1
    count = ok.sum(-1)  # (..., 4)
    best = torch.argmax(count, dim=-1)  # the first of equal counts
    R = torch.take_along_dim(Rs, best[..., None, None, None], dim=-3)[..., 0, :, :]
    t = torch.take_along_dim(ts, best[..., None, None], dim=-2)[..., 0, :]
    return R, t, count.amax(-1), finite


def structure_less_models_plain(uv, uv_w, cam_idx, Rw, tw, cams, idx5, r1):
    """The models of K37's samples (colmap_tpu's solve_one,
    generalized_pose.py:593-634): essential matrices of each sample's five
    rows (new camera <- its registered camera), cheirality on those rows,
    the scale from row r1's epipolar constraint against its camera. uv,
    uv_w (N, 2); cam_idx (N,); Rw (C, 3, 3), tw (C, 3); cams (K,), idx5
    (K, 5), r1 (K,). Returns (K * 10, 3, 4), NaN where a slot holds none."""
    idx5, r1, cams = idx5.long(), r1.long(), cams.long()
    x_w, x_n = uv_w[idx5], uv[idx5]  # (K, 5, 2)
    Es = essential_five_point(x_w, x_n)  # (K, 10, 3, 3): new <- registered camera
    R_rel, t_dir, n_front, finite = _poses_from_essentials5(Es, x_w[:, None], x_n[:, None])
    valid = finite & (n_front >= 4)
    # cam_from_world(s) = (R_rel, s t_dir) o (Rc, tc); the extra row's
    # epipolar constraint against its camera is linear in s:
    # x2' [a + s b]x R_ns x1 = 0.
    Rc, tc = Rw[cams][:, None], tw[cams][:, None]
    R_new = R_rel @ Rc
    t_base = (R_rel @ tc[..., None])[..., 0]
    cs = cam_idx[r1].long()
    Rs2, ts2 = Rw[cs][:, None], tw[cs][:, None]
    R_ns = R_new @ Rs2.transpose(-1, -2)
    a = t_base - (R_ns @ ts2[..., None])[..., 0]
    ones = torch.ones_like(uv[:, :1])
    x1h, x2h = torch.cat([uv_w, ones], dim=1), torch.cat([uv, ones], dim=1)
    Rx1 = (R_ns @ x1h[r1][:, None, :, None])[..., 0]
    x2s = x2h[r1][:, None]
    c0 = torch.sum(x2s * torch.linalg.cross(a, Rx1), dim=-1)
    c1 = torch.sum(x2s * torch.linalg.cross(t_dir, Rx1), dim=-1)
    s = -c0 / torch.where(torch.abs(c1) < 1e-12, 1e-12, c1)
    t_new = t_base + s[..., None] * t_dir
    ok = valid & (torch.abs(c1) > 1e-10) & (s > 1e-8) & (cs != cams)[:, None]
    models = torch.cat([R_new, t_new[..., None]], dim=-1)
    return torch.where(ok[..., None, None], models, math.nan).reshape(-1, 3, 4)


def structure_less_residuals_plain(models, uv, uv_w, cam_idx, Rw, tw, focal):
    """(M, N) squared generalized Sampson errors in pixels of models
    cam_from_world = [R | t] (M, 3, 4), each row against its own registered
    camera (generalized_pose.py:640-660)."""
    Rwn, twn = Rw[cam_idx.long()], tw[cam_idx.long()]
    ones = torch.ones_like(uv[:, :1])
    x1h, x2h = torch.cat([uv_w, ones], dim=1), torch.cat([uv, ones], dim=1)
    R_rel = torch.einsum("mab,ncb->mnac", models[..., :3], Rwn)
    t_rel = models[:, None, :, 3] - torch.einsum("mnab,nb->mna", R_rel, twn)
    E = cross_product_matrix(t_rel) @ R_rel
    Ex1 = torch.einsum("mnij,nj->mni", E, x1h)
    Etx2 = torch.einsum("mnji,nj->mni", E, x2h)
    num = torch.sum(x2h * Ex1, dim=-1) ** 2
    den = Ex1[..., 0] ** 2 + Ex1[..., 1] ** 2 + Etx2[..., 0] ** 2 + Etx2[..., 1] ** 2
    return num / torch.clamp(den, min=1e-12) * focal**2


def structure_less_score_plain(uv, uv_w, cam_idx, Rw, tw, focal, cams, idx5, r1, max_sq):
    """K37 score: the samples' models, each model's support (0 for a NaN
    model) and the batch's packed best (1,) int64."""
    models = structure_less_models_plain(uv, uv_w, cam_idx, Rw, tw, cams, idx5, r1)
    res = structure_less_residuals_plain(models, uv, uv_w, cam_idx, Rw, tw, focal)
    counts = (res <= max_sq).sum(-1).to(torch.int32)
    counts = torch.where(torch.isfinite(models.flatten(1)).all(1), counts, 0)
    return models, counts, pack_best(counts)


def structure_less_inliers_plain(uv, uv_w, cam_idx, Rw, tw, focal, model, max_sq):
    """K37 inliers: the rows of one model (3, 4) within max_sq px²."""
    res = structure_less_residuals_plain(model[None], uv, uv_w, cam_idx, Rw, tw, focal)[0]
    return (res <= max_sq) & torch.isfinite(model).all()


# ---------------------------------------------------------------------------
# CUDA wrappers.
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_D = ctypes.c_double
_F = ctypes.c_float

# Argument types of the C entries: sizes, then tensor pointers in the order
# the wrappers pass them, then scalars, the SM count and the stream.
_SIGNATURES = {
    "ba_pcg_setup_f32": [_I, _I, _I] + [_P] * 12 + [_P],
    "ba_pcg_step_f32": [_I, _I, _I] + [_P] * 11 + [_P],
    "ba_pcg_setup_diag_f32": [_I] + [_P] * 7 + [_P],
    "ba_lm_candidate_f32": [_I, _I, _LL] + [_P] * 21 + [_I, _P],
    "ba_lm_accept_f32": [_I, _I, _LL] + [_P] * 4 + [_D, _D, _D] + [_P] * 9 + [_I, _P],
    "relative_pose_cheirality_f32": [_I] + [_P] * 10 + [_P],
    "relative_pose_refine_f32": [_I, _I] + [_P] * 9 + [_P],
    "structure_less_score_f32": [_I, _I, _F] + [_P] * 12 + [_P],
    "structure_less_inliers_f32": [_I, _F] + [_P] * 8 + [_P],
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


def _num_sms(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


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


f32, f64, i32, u8 = torch.float32, torch.float64, torch.int32, torch.uint8


# K34 -----------------------------------------------------------------------


def pcg_setup(Hcc_pose, diag_pose, diag_cam, bp, bc, lam, block_jacobi: bool) -> PCGState:
    """K34 set-up. See pcg_setup_plain for the function."""
    if bp.device.type == "cpu":
        return pcg_setup_plain(Hcc_pose, diag_pose, diag_cam, bp, bc, lam, block_jacobi)
    dev = _require_cuda(bp)
    F, (C, P) = bp.shape[0], bc.shape
    n = 6 * F + C * P
    for name, x, shape in (("Hcc_pose", Hcc_pose, (F, 6, 6)), ("diag_pose", diag_pose, (F, 6)),
                           ("diag_cam", diag_cam, (C, P)), ("bp", bp, (F, 6)), ("bc", bc, (C, P)),
                           ("lam", lam, ())):
        _check(name, x, f32, shape, dev)
    e = functools.partial(torch.empty, dtype=f32, device=dev)
    st = PCGState(e(36 * F + C * P), e(n), e(n), e(n), e(n), torch.empty(1, dtype=f64, device=dev))
    _call("ba_pcg_setup_f32", F, C * P, int(bool(block_jacobi)),
          *map(_ptr, (lam, Hcc_pose, diag_pose, diag_cam, bp, bc, *st)), _stream(dev))
    LAUNCHES["ba_pcg"] += 1
    SHAPES.add("ba_pcg", "setup", (F, C * P), pcg_setup,
               (Hcc_pose, diag_pose, diag_cam, bp, bc, lam, block_jacobi))
    return st


def pcg_setup_diag(M, b) -> PCGState:
    """K34 set-up (c): M and b flat float32 (n,) on the card; the state's M
    is M itself. See pcg_setup_diag_plain for the function."""
    if b.device.type == "cpu":
        return pcg_setup_diag_plain(M, b)
    dev = _require_cuda(b)
    n = b.shape[0]
    _check("M", M, f32, (n,), dev)
    _check("b", b, f32, (n,), dev)
    e = functools.partial(torch.empty, dtype=f32, device=dev)
    st = PCGState(M, e(n), e(n), e(n), e(n), torch.empty(1, dtype=f64, device=dev))
    _call("ba_pcg_setup_diag_f32", n, *map(_ptr, (M, b, *st[1:])), _stream(dev))
    LAUNCHES["ba_pcg"] += 1
    SHAPES.add("ba_pcg", "setup_diag", (n,), pcg_setup_diag, (M, b))
    return st


def _opt_ptr(x):
    return _P(0) if x is None else _ptr(x)


# K34's step runs as one warp up to STEP_WARP_FRAMES frames (one a lane) and
# 32 x max(STEP_WARP_CAMS) camera entries (1, 2 or 4 a lane, the kernel's
# instances); as one block of 1024 threads above. On the H100 the warp is
# faster than the block up to there; two frames a lane, at 64 frames, was
# slower (PERF.md, K34's row).
STEP_WARP_FRAMES, STEP_WARP_CAMS = 32, (1, 2, 4)


def pcg_step_plan(F: int, CP: int) -> int:
    """K34 step's launch plan for F frames and CP camera entries: camera
    entries a lane of the one-warp step, the smallest instance that holds
    them, or 0 for the block."""
    if F > STEP_WARP_FRAMES:
        return 0
    return next((k for k in STEP_WARP_CAMS if CP <= 32 * k), 0)


def pcg_step(st: PCGState, Ap_p, Ap_c, lam, diag_pose, diag_cam) -> PCGState:
    """K34 step: updates ``st`` (and Ap) in place on the card and returns it.
    With diag_pose, diag_cam (and lam) None the step adds no damping (the
    rig's). See pcg_step_plain for the function."""
    if Ap_p.device.type == "cpu":
        return pcg_step_plain(st, Ap_p, Ap_c, lam, diag_pose, diag_cam)
    plan = pcg_step_plan(Ap_p.shape[0], Ap_c.numel())
    return pcg_step_planned(st, Ap_p, Ap_c, lam, diag_pose, diag_cam, plan)


def pcg_step_planned(st: PCGState, Ap_p, Ap_c, lam, diag_pose, diag_cam, plan) -> PCGState:
    """K34 step on the card by the given plan: pcg_step_plan's, or 0, the
    block, at any size (chip_smoke.py times the two plans side by side)."""
    F, (C, P) = Ap_p.shape[0], Ap_c.shape
    n = 6 * F + C * P
    if plan and not (plan in STEP_WARP_CAMS and F <= STEP_WARP_FRAMES and C * P <= 32 * plan):
        raise ValueError(f"K34 step: no one-warp instance {plan} for F {F}, CP {C * P}")
    dev = _require_cuda(Ap_p)
    checks = [("Ap_p", Ap_p, (F, 6)), ("Ap_c", Ap_c, (C, P)), ("M", st.M, (36 * F + C * P,)),
              ("x", st.x, (n,)), ("r", st.r, (n,)), ("z", st.z, (n,)), ("p", st.p, (n,))]
    if diag_cam is not None:
        checks += [("lam", lam, ()), ("diag_pose", diag_pose, (F, 6)),
                   ("diag_cam", diag_cam, (C, P))]
    for name, x, shape in checks:
        _check(name, x, f32, shape, dev)
    _check("rz", st.rz, f64, (1,), dev)
    damped = diag_cam is not None
    _call("ba_pcg_step_f32", F, C * P, plan,
          *map(_opt_ptr, (lam if damped else None, diag_pose if damped else None, diag_cam)),
          *map(_ptr, (st.M, Ap_p, Ap_c, st.x, st.r, st.z, st.p, st.rz)), _stream(dev))
    LAUNCHES["ba_pcg"] += 1
    SHAPES.add("ba_pcg", "step", (F, C * P, damped), pcg_step,
               (st, Ap_p, Ap_c, lam, diag_pose, diag_cam))
    return st


# K35 -----------------------------------------------------------------------


def _state_shapes(quat, cam_params, points):
    return ((quat.shape[0], 4), (quat.shape[0], 3), tuple(cam_params.shape), (points.shape[0], 3))


def lm_candidate(quat, t, cam_params, points, dp, dc, dx, red, lam, split: bool = False):
    """K35 candidate. See lm_candidate_plain for the function."""
    if points.device.type == "cpu":
        return lm_candidate_plain(quat, t, cam_params, points, dp, dc, dx, red, lam, split)
    dev = _require_cuda(points)
    F, N = quat.shape[0], points.shape[0]
    C, P = cam_params.shape
    shapes = _state_shapes(quat, cam_params, points)
    for name, x, shape in zip(("quat", "t", "cam_params", "points"),
                              (quat, t, cam_params, points), shapes):
        _check(name, x, f32, shape, dev)
    for name, x, shape in (("dp", dp, (F, 6)), ("dc", dc, (C, P)), ("dx", dx, (N, 3)),
                           ("gp", red.gp, (F, 6)), ("gc", red.gc, (C, P)), ("gx", red.gx, (N, 3)),
                           ("diag_pose", red.diag_pose, (F, 6)),
                           ("diag_cam", red.diag_cam, (C, P)), ("diag_pt", red.diag_pt, (N, 3)),
                           ("lam", lam, ())):
        _check(name, x, f32, shape, dev)
    cand = tuple(torch.empty(s, dtype=f32, device=dev) for s in shapes)
    sms = _num_sms(dev)
    partial = torch.empty(max(1, 4 * sms), dtype=f64, device=dev)
    pred = torch.empty(2 if split else (), dtype=f64, device=dev)
    _call("ba_lm_candidate_f32", F, C * P, N,
          *map(_ptr, (lam, quat, t, cam_params, points, dp, dc, dx, red.gp, red.gc, red.gx,
                      red.diag_pose, red.diag_cam, red.diag_pt, *cand, partial, pred)),
          _P(pred.data_ptr() + 8) if split else _P(0), _I(sms), _stream(dev))
    LAUNCHES["ba_lm_update"] += 1
    return cand, pred


def lm_accept(lam, S, new_cost, pred, state, cand, min_lambda: float, max_lambda: float,
              function_tolerance: float, done_flag) -> None:
    """K35 accept, in place on lam, S, done_flag and the state tensors
    (quat, t, cam_params, points). See lm_accept_plain for the function."""
    if S.device.type == "cpu":
        return lm_accept_plain(lam, S, new_cost, pred, state, cand, min_lambda, max_lambda,
                               function_tolerance, done_flag)
    dev = _require_cuda(S)
    quat, _, cam_params, points = state
    shapes = _state_shapes(quat, cam_params, points)
    for k, (x, c, shape) in enumerate(zip(state, cand, shapes)):
        _check(f"state[{k}]", x, f32, shape, dev)
        _check(f"cand[{k}]", c, f32, shape, dev)
    _check("lam", lam, f32, (), dev)
    _check("S", S, f64, (len(LM_FIELDS),), dev)
    _check("new_cost", new_cost, f64, (), dev)
    _check("pred", pred, f64, (), dev)
    _check("done_flag", done_flag, u8, (1,), dev)
    C, P = cam_params.shape
    _call("ba_lm_accept_f32", quat.shape[0], C * P, points.shape[0],
          *map(_ptr, (lam, S, new_cost, pred)), _D(min_lambda), _D(max_lambda),
          _D(function_tolerance), *map(_ptr, (done_flag, *state, *cand)),
          _I(_num_sms(dev)), _stream(dev))
    LAUNCHES["ba_lm_update"] += 1


# K36 -----------------------------------------------------------------------


def _offsets(offsets, rows, dev):
    offs = [int(o) for o in offsets]
    if offs[0] != 0 or offs[-1] != rows or any(b < a for a, b in zip(offs, offs[1:])):
        raise ValueError(f"offsets {offs[:4]}... do not split {rows} rows")
    return offs, torch.tensor(offs, dtype=i32).to(dev)


def poses_from_essentials(E, x1, x2, mask, offsets):
    """K36 (a). See poses_from_essentials_plain for the function; on the
    card R, t, points are float32, counts int32, the mask bool."""
    if x1.device.type == "cpu":
        return poses_from_essentials_plain(E, x1, x2, mask, [int(o) for o in offsets])
    dev = _require_cuda(x1)
    rows, B = x1.shape[0], E.shape[0]
    offs, offs_t = _offsets(offsets, rows, dev)
    if len(offs) != B + 1:
        raise ValueError(f"{len(offs)} offsets for {B} problems")
    E = E.contiguous()
    for name, x, shape in (("E", E, (B, 3, 3)), ("x1", x1, (rows, 2)), ("x2", x2, (rows, 2))):
        _check(name, x, f32, shape, dev)
    _check("mask", mask, torch.bool, (rows,), dev)
    e = functools.partial(torch.empty, dtype=f32, device=dev)
    R, t, X = e(B, 3, 3), e(B, 3), e(rows, 3)
    count = torch.empty(B, dtype=i32, device=dev)
    ok = torch.empty(rows, dtype=torch.bool, device=dev)
    _call("relative_pose_cheirality_f32", B, *map(_ptr, (offs_t, E, x1, x2, mask, R, t, X, count,
                                                          ok)), _stream(dev))
    LAUNCHES["relative_pose"] += 1
    return R, t, X, count, ok


def refine_relative_poses(quat, t, x1, x2, weights, offsets, num_iterations: int = 15):
    """K36 (b). See refine_relative_poses_plain for the function."""
    if x1.device.type == "cpu":
        return refine_relative_poses_plain(quat, t, x1, x2, weights, [int(o) for o in offsets],
                                           num_iterations)
    dev = _require_cuda(x1)
    rows, K = x1.shape[0], quat.shape[0]
    offs, offs_t = _offsets(offsets, rows, dev)
    if len(offs) != K + 1:
        raise ValueError(f"{len(offs)} offsets for {K} candidates")
    quat, t = quat.contiguous(), t.contiguous()
    for name, x, shape in (("quat", quat, (K, 4)), ("t", t, (K, 3)), ("x1", x1, (rows, 2)),
                           ("x2", x2, (rows, 2)), ("weights", weights, (rows,))):
        _check(name, x, f32, shape, dev)
    e = functools.partial(torch.empty, dtype=f32, device=dev)
    q_out, t_out, rms = e(K, 4), e(K, 3), e(K)
    _call("relative_pose_refine_f32", K, int(num_iterations),
          *map(_ptr, (offs_t, x1, x2, weights, quat, t, q_out, t_out, rms)), _stream(dev))
    LAUNCHES["relative_pose"] += 1
    return q_out, t_out, rms


# K37 -----------------------------------------------------------------------


def _k37_checks(uv, uv_w, cam_idx, Rw, tw, focal):
    dev = _require_cuda(uv)
    n, C = uv.shape[0], Rw.shape[0]
    for name, x, shape in (("uv", uv, (n, 2)), ("uv_w", uv_w, (n, 2)), ("Rw", Rw, (C, 3, 3)),
                           ("tw", tw, (C, 3)), ("focal", focal, (n,))):
        _check(name, x, f32, shape, dev)
    _check("cam_idx", cam_idx, i32, (n,), dev)
    return dev, n


def structure_less_score(uv, uv_w, cam_idx, Rw, tw, focal, cams, idx5, r1, max_sq: float):
    """K37 score: one launch for a batch of K samples (cams (K,), idx5
    (K, 5), r1 (K,) int32, drawn by the host). Returns models (K * 10, 3, 4),
    counts (K * 10,) int32 and the packed best (1,) int64. See
    structure_less_score_plain for the function."""
    if uv.device.type == "cpu":
        return structure_less_score_plain(uv, uv_w, cam_idx, Rw, tw, focal, cams, idx5, r1,
                                          max_sq)
    dev, n = _k37_checks(uv, uv_w, cam_idx, Rw, tw, focal)
    K = cams.shape[0]
    _check("cams", cams, i32, (K,), dev)
    _check("idx5", idx5, i32, (K, 5), dev)
    _check("r1", r1, i32, (K,), dev)
    models = torch.empty(K * 10, 3, 4, dtype=f32, device=dev)
    counts = torch.empty(K * 10, dtype=i32, device=dev)
    best = torch.zeros(1, dtype=torch.int64, device=dev)
    _call("structure_less_score_f32", n, K, float(max_sq),
          *map(_ptr, (uv, uv_w, cam_idx, Rw, tw, focal, cams, idx5, r1, models, counts, best)),
          _stream(dev))
    LAUNCHES["structure_less_ransac"] += 1
    return models, counts, best


def structure_less_inliers(uv, uv_w, cam_idx, Rw, tw, focal, model, max_sq: float):
    """K37 inliers: the inlier mask (N,) bool of one model (3, 4). See
    structure_less_inliers_plain for the function."""
    if uv.device.type == "cpu":
        return structure_less_inliers_plain(uv, uv_w, cam_idx, Rw, tw, focal, model, max_sq)
    dev, n = _k37_checks(uv, uv_w, cam_idx, Rw, tw, focal)
    model = model.contiguous()
    _check("model", model, f32, (3, 4), dev)
    inl = torch.empty(n, dtype=torch.bool, device=dev)
    _call("structure_less_inliers_f32", n, float(max_sq),
          *map(_ptr, (uv, uv_w, cam_idx, Rw, tw, focal, model, inl)), _stream(dev))
    LAUNCHES["structure_less_ransac"] += 1
    return inl
