"""Bundle-adjustment kernels: wrappers, plain PyTorch versions, launch counts.

Four CUDA kernels carry the packed Levenberg-Marquardt solver of
``estimators/bundle_adjustment.py`` (sources in ``colmap_tpu_torch/csrc``):

    K1 ba_obs_jacobians         obs_jacobians, obs_cost, obs_cost64
    K2 ba_lm_reduce             lm_reduce
    K3 ba_schur_matvec          schur_matvec, back_substitute
    K4 ba_dense_schur_assemble  dense_schur_assemble
    K54 ba_covariance_assemble  covariance_assemble (float64 S of the covariance)

and K34 (PCG) and K35 (the LM update) of ``kernels/solver.py`` run the
rest of the solve on the card.

Each wrapper runs the plain version when its tensors lie on the CPU and
launches the kernel when they lie on a CUDA device; on a CUDA tensor it
launches or raises, it never falls back. ``LAUNCHES`` counts kernel launches
by kernel name (a wrapper adds one where it launches, nowhere else; a
replay of the LM loop's CUDA graph adds the launches the graph holds, and
recording it adds none).
``KERNELS`` bundles the wrappers, which the solver runs, and ``PLAIN`` the
plain versions, which only the solver's private loop takes, so that a
check on the card can run the same solve through both. The damping lam is
a 0-d tensor on the problem's device, which K2 reads there.

Layouts (point-major, as ``pack_problem`` builds them; Opm = N * capp):
    r (Opm, 2), Jp (Opm, 2, 6), Jc (Opm, 2, P), Jx (Opm, 2, 3),
    frame_pm / cam_pm (N, capp) int32 frame / camera id per slot.
K1 also takes any observation layout: it reads the point id of each slot.

Mixed camera models: ``model_id`` is then the sorted tuple of the models
present and cam_params (C, Pmax + 1) holds rows padded to the widest model
with a trailing model-position column (sensor/models.py
pack_mixed_params). K1 runs once per model over that model's slots
(``model_groups``, a CSR order by model) into one set of outputs, Jc
(O, 2, Pmax + 1) with zeros in the columns a slot's model does not have;
K2-K4 take P = Pmax + 1 as they take any P. The groups do not change
during a solve: the solver builds them once and passes them as ``groups``
(without it each call builds them: an argsort and a host read).

Sum order: K3 reduces frame and camera sums with atomics, so the order of
those sums, and their last bits, vary from run to run. K2 sums each frame's
and each camera's slots in a fixed order (``slot_order``, built once a
solve by pack_problem): its outputs have the same bits run to run.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from colmap_tpu_torch.estimators.ba_residual import make_residual_fn, robust_cost, robust_weight
from colmap_tpu_torch.geometry import rotation as rot
from colmap_tpu_torch.kernels import solver
from colmap_tpu_torch.kernels.tally import ShapeTally
from colmap_tpu_torch.sensor import models as camera_models

LAUNCHES = {
    "ba_obs_jacobians": 0,
    "ba_lm_reduce": 0,
    "ba_schur_matvec": 0,
    "ba_dense_schur_assemble": 0,
    "ba_covariance_assemble": 0,
}
# Launch shapes of the kernels above, counted where LAUNCHES is (kernels/tally.py).
SHAPES = ShapeTally()

# Camera models that csrc/camera_models.cuh implements: all 18.
CUDA_MODELS = frozenset(range(18))
LOSSES = {"trivial": 0, "huber": 1, "cauchy": 2}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    SHAPES.reset()


# ---------------------------------------------------------------------------
# Plain versions.
# ---------------------------------------------------------------------------


class LMReduction(NamedTuple):
    """Per-step sums of K2 (``lm_reduce``)."""

    gp: torch.Tensor  # (F, 6)  -Σ Jpᵀ r
    gc: torch.Tensor  # (C, P)  -Σ Jcᵀ r
    bp: torch.Tensor  # (F, 6)  reduced RHS  gp - Σ Jpᵀ v
    bc: torch.Tensor  # (C, P)
    diag_pose: torch.Tensor  # (F, 6)  Σ Jp²
    diag_cam: torch.Tensor  # (C, P)
    Hcc_pose: torch.Tensor  # (F, 6, 6)  Σ JpᵀJp
    gx: torch.Tensor  # (N, 3)  -Σ Jxᵀ r
    Hpp_inv: torch.Tensor  # (N, 3, 3)  (Hpp + λ diag(Hpp) + 1e-12)⁻¹
    diag_pt: torch.Tensor  # (N, 3)  diag(Hpp)


def _residual_jacobians(quat, t, cam_params, points, fids, cids, pids, xy, model_id):
    f = make_residual_fn(model_id)

    def with_aux(*args):
        r = f(*args)
        return r, r

    P = cam_params.shape[1]
    z = quat.new_zeros
    jac = torch.func.jacfwd(with_aux, argnums=(0, 1, 2), has_aux=True)
    (Jp, Jc, Jx), r = torch.func.vmap(jac, in_dims=(None, None, None, 0, 0, 0, 0, 0))(
        z(6), z(P), z(3), quat[fids], t[fids], cam_params[cids], points[pids], xy
    )
    return r, Jp, Jc, Jx


def model_groups(model_id, cam_params, obs_cam):
    """[(model id, slots)]: one group of all slots (slots None) for one
    model; for a tuple of models, each model present with the int32 ids of
    its slots in order (a CSR order by the model-position column). A
    solve builds them once and hands them to K1 and K24 as ``groups``."""
    if not isinstance(model_id, tuple):
        return [(int(model_id), None)]
    pos = torch.round(cam_params[:, -1]).long()[obs_cam.long()]
    order = torch.argsort(pos, stable=True).to(torch.int32)
    counts = torch.bincount(pos, minlength=len(model_id)).tolist()
    groups, start = [], 0
    for m, c in zip(model_id, counts):
        if c:
            groups.append((int(m), order[start:start + c]))
        start += c
    return groups


def _groups(groups, model_id, cam_params, obs_cam):
    return model_groups(model_id, cam_params, obs_cam) if groups is None else groups


def _row_width(model_id) -> int:
    """Columns of a parameter row: P, or Pmax + 1 for a tuple of models."""
    if isinstance(model_id, tuple):
        return max(camera_models.model_num_params(m) for m in model_id) + 1
    return camera_models.model_num_params(model_id)


def obs_jacobians_plain(quat, t, cam_params, points, obs_frame, obs_cam, obs_point,
                        obs_xy, obs_w, pose_mask, cam_mask, point_mask,
                        model_id, loss: str, loss_scale: float, groups=None):
    """Weighted residuals and Jacobian blocks per observation (K1's function).

    jacfwd + vmap over the residual, as colmap_tpu's _obs_jacobians_packed;
    then the robust IRLS weight times obs_w, zeroing of non-finite rows,
    √w scaling and the variability masks (pose_mask (F, 6) rotation and
    translation columns, cam_mask (C, P), point_mask (N,)).
    Returns r (O, 2), Jp (O, 2, 6), Jc (O, 2, P), Jx (O, 2, 3). A tuple of
    models runs each model on its slots (``groups``, as model_groups
    gives them), as K1 does.
    """
    if isinstance(model_id, tuple):
        O, W = obs_xy.shape[0], cam_params.shape[1]
        z = obs_xy.new_zeros
        r, Jp, Jc, Jx = z(O, 2), z(O, 2, 6), z(O, 2, W), z(O, 2, 3)
        for m, slots in _groups(groups, model_id, cam_params, obs_cam):
            P, s = camera_models.model_num_params(m), slots.long()
            out = obs_jacobians_plain(quat, t, cam_params[:, :P], points, obs_frame[s],
                                      obs_cam[s], obs_point[s], obs_xy[s], obs_w[s], pose_mask,
                                      cam_mask[:, :P], point_mask, m, loss, loss_scale)
            r[s], Jp[s], Jx[s] = out[0], out[1], out[3]
            Jc[s, :, :P] = out[2]
        return r, Jp, Jc, Jx
    r, Jp, Jc, Jx = _residual_jacobians(
        quat, t, cam_params, points, obs_frame, obs_cam, obs_point, obs_xy, model_id
    )
    O = r.shape[0]
    w = robust_weight((r * r).sum(-1), loss, loss_scale) * obs_w
    finite = (
        torch.isfinite(r).all(-1)
        & torch.isfinite(Jp.reshape(O, -1)).all(-1)
        & torch.isfinite(Jc.reshape(O, -1)).all(-1)
        & torch.isfinite(Jx.reshape(O, -1)).all(-1)
    )
    w = torch.where(finite, w, 0.0)
    sw = torch.sqrt(w)[:, None]
    keep = finite[:, None, None]
    r = torch.where(finite[:, None], r, 0.0) * sw
    Jp = torch.where(keep, Jp, 0.0) * sw[..., None] * pose_mask[obs_frame][:, None, :]
    Jc = torch.where(keep, Jc, 0.0) * sw[..., None] * cam_mask[obs_cam][:, None, :]
    Jx = torch.where(keep, Jx, 0.0) * sw[..., None] * point_mask[obs_point][:, None, None]
    return r, Jp, Jc, Jx


def obs_cost_plain(quat, t, cam_params, points, obs_frame, obs_cam, obs_point,
                   obs_xy, obs_w, model_id, loss: str, loss_scale: float, groups=None):
    """½ Σ ρ(‖r‖²)·w over all observations, non-finite terms dropped (K1 cost mode)."""
    if isinstance(model_id, tuple):
        total = obs_xy.new_zeros(())
        for m, slots in _groups(groups, model_id, cam_params, obs_cam):
            s = slots.long()
            total = total + obs_cost_plain(
                quat, t, cam_params[:, :camera_models.model_num_params(m)], points,
                obs_frame[s], obs_cam[s], obs_point[s], obs_xy[s], obs_w[s], m, loss, loss_scale)
        return total
    Xc = rot.quat_rotate(quat[obs_frame], points[obs_point]) + t[obs_frame]
    proj, _ = camera_models.img_from_cam(
        model_id, cam_params[obs_cam], Xc, check_cheirality=False
    )
    r = proj - obs_xy
    sq = (r * r).sum(-1)
    sq = torch.where(torch.isfinite(sq), sq, 0.0)
    return 0.5 * (robust_cost(sq, loss, loss_scale) * obs_w).sum()


def inv3x3_spd(A, eps=1e-12):
    """Batched closed-form inverse of (damped) SPD 3x3 blocks (adjugate/det)."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f_ = A[..., 1, 1], A[..., 1, 2], A[..., 2, 2]
    co00 = d * f_ - e * e
    co01 = c * e - b * f_
    co02 = b * e - c * d
    co11 = a * f_ - c * c
    co12 = b * c - a * e
    co22 = a * d - b * b
    det = a * co00 + b * co01 + c * co02
    inv_det = torch.where(torch.abs(det) > eps, 1.0 / det, 0.0)
    inv = torch.stack(
        [co00, co01, co02, co01, co11, co12, co02, co12, co22], dim=-1
    ).reshape(A.shape)
    return inv * inv_det[..., None, None]


# K2's launch plan (csrc/ba_reduce.cu): blocks of REDUCE_THREADS threads;
# an item block sums up to ``reduce_chunk`` slots of one frame or camera
# (REDUCE_CHUNK_SMALL below REDUCE_CHUNK_SWITCH real slots, where more and
# shorter items finish sooner, REDUCE_CHUNK above, where they would re-read
# more points); the item blocks recompute each slot's y = Hpp^-1 gx up to
# REDUCE_RECOMPUTE_MAX_CAPP slots a point, and above it read the y that the
# point blocks write in a first launch (chosen by measurement on an NVIDIA
# H100 80GB HBM3 at 700 W; PERF.md §6).
REDUCE_THREADS = 256
REDUCE_CHUNK, REDUCE_CHUNK_SMALL, REDUCE_CHUNK_SWITCH = 1024, 256, 32768
REDUCE_RECOMPUTE_MAX_CAPP = 2
REDUCE_ITEM_FIELDS = 8


def reduce_chunk(num_slots: int) -> int:
    """Slots an item of K2 sums, for a problem of ``num_slots`` real slots."""
    return REDUCE_CHUNK_SMALL if num_slots < REDUCE_CHUNK_SWITCH else REDUCE_CHUNK


class SlotOrder(NamedTuple):
    """K2's sums by frame and by camera (``slot_order``), on the device.

    ``tickets`` is state on the device that a call changes and leaves as it
    found it (the last item of a segment resets the segment's ticket to 0):
    a call of K2 with an order is not reentrant. Two calls in flight with
    one order on different streams, or a call cut between a ticket's
    increment and its reset, would corrupt every later sum of the problem;
    the solvers make one call at a time on one stream."""

    slots: torch.Tensor  # (2M,) int32: the M real slots frame by frame, then camera by camera
    # (W, 8) int32 items: segment (frame f, or camera F + c), first and
    # one-past-last entry of ``slots``, its partial row (-1 where the
    # segment is one item), the segment's first partial row, its items,
    # its ticket, 0.
    items: torch.Tensor
    tickets: torch.Tensor  # (max(1, Q),) int32 zeros: one a segment of several items
    num_partials: int
    num_frames: int
    num_cams: int
    num_slots: int  # N * capp, the packed problem's slots (M of them real)
    num_real: int  # M


def slot_order_arrays(frame_pm, cam_pm, real, num_frames: int, num_cams: int, chunk=None):
    """(slots, items, partials, tickets) of ``SlotOrder`` as numpy arrays
    from the point-major frame and camera ids (Opm,) and the mask of real
    slots (Opm,) bool: the real slots in a stable order by frame, then by
    camera; each segment split into items of ``chunk`` slots (by default
    ``reduce_chunk`` of the real slots; one item where it has none)."""
    ids = np.flatnonzero(real)
    chunk = reduce_chunk(len(ids)) if chunk is None else chunk
    F, C = int(num_frames), int(num_cams)
    f, c = np.asarray(frame_pm)[ids], np.asarray(cam_pm)[ids]
    slots = np.concatenate([ids[np.argsort(f, kind="stable")],
                            ids[np.argsort(c, kind="stable")]]).astype(np.int32)
    counts = np.concatenate([np.bincount(f, minlength=F), np.bincount(c, minlength=C)])
    starts = np.cumsum(counts) - counts
    n_items = np.maximum(1, -(-counts // chunk))
    seg = np.repeat(np.arange(F + C), n_items)
    k = np.arange(len(seg)) - np.repeat(np.cumsum(n_items) - n_items, n_items)
    begin = starts[seg] + k * chunk
    end = np.minimum(begin + chunk, starts[seg] + counts[seg])
    multi = n_items[seg] > 1
    part = np.where(multi, np.cumsum(multi) - 1, -1)
    ticket = (np.cumsum(n_items > 1) - 1)[seg]
    items = np.stack([seg, begin, end, part, np.where(multi, part - k, -1), n_items[seg],
                      np.where(multi, ticket, -1), np.zeros_like(seg)], axis=1)
    return slots, items.astype(np.int32), int(multi.sum()), int((n_items > 1).sum())


def slot_order(frame_pm, cam_pm, real, num_frames: int, num_cams: int, device) -> SlotOrder:
    """K2's ``SlotOrder`` of a packed problem (``slot_order_arrays``) on ``device``."""
    slots, items, partials, tickets = slot_order_arrays(frame_pm, cam_pm, real, num_frames,
                                                        num_cams)
    return SlotOrder(torch.from_numpy(slots).to(device), torch.from_numpy(items).to(device),
                     torch.zeros(max(1, tickets), dtype=torch.int32, device=device), partials,
                     int(num_frames), int(num_cams), len(real), len(slots) // 2)


class ReducePlan(NamedTuple):
    recompute: bool  # the item blocks recompute y (else the point blocks write it)
    point_blocks: int
    item_blocks: int
    launches: int  # device launches of a call: graph nodes a replay holds for it


def lm_reduce_plan(num_points: int, capp: int, num_items: int) -> ReducePlan:
    """K2's launches for N points of capp slots and an order of
    ``num_items`` items, as ba_lm_reduce_f32 makes them."""
    recompute = capp <= REDUCE_RECOMPUTE_MAX_CAPP
    G = 1
    while G < capp and G < 32:
        G *= 2
    per_block = (REDUCE_THREADS // 32) * (32 // G)
    point_blocks = -(-int(num_points) // per_block)
    if recompute:
        launches = int(point_blocks + num_items > 0)
    else:
        launches = int(point_blocks > 0) + int(num_items > 0)
    return ReducePlan(recompute, point_blocks, int(num_items), launches)


def _segment_sum(contrib, ids, n):
    return contrib.new_zeros((n,) + contrib.shape[1:]).index_add_(0, ids, contrib)


def lm_reduce_plain(r, Jp, Jc, Jx, frame_pm, cam_pm, num_frames: int,
                    num_cams: int, lam, order=None) -> LMReduction:
    """One LM step's reductions over the point-major slots (K2's function);
    lam is a 0-d tensor. ``order``, K2's slot order, is not needed here."""
    N, capp = frame_pm.shape
    fids, cids = frame_pm.reshape(-1), cam_pm.reshape(-1)
    F, C = num_frames, num_cams
    gp = -_segment_sum((Jp * r[..., None]).sum(1), fids, F)
    gc = -_segment_sum((Jc * r[..., None]).sum(1), cids, C)
    Hcc_pose = _segment_sum((Jp[..., :, None] * Jp[..., None, :]).sum(1), fids, F)
    diag_pose = torch.diagonal(Hcc_pose, dim1=-2, dim2=-1).clone()
    diag_cam = _segment_sum((Jc * Jc).sum(1), cids, C)
    Jx_pm = Jx.reshape(N, capp * 2, 3)
    gx = -(Jx_pm * r.reshape(N, capp * 2, 1)).sum(1)
    Hpp = (Jx_pm[..., :, None] * Jx_pm[..., None, :]).sum(1)
    diag_pt = torch.diagonal(Hpp, dim1=-2, dim2=-1).clone()
    Hpp_inv = inv3x3_spd(Hpp + torch.diag_embed(lam * diag_pt + 1e-12))
    y = (Hpp_inv * gx[:, None, :]).sum(-1)
    v = (Jx.reshape(N, capp, 2, 3) * y[:, None, None, :]).sum(-1).reshape(-1, 2)
    bp = gp - _segment_sum((Jp * v[..., None]).sum(1), fids, F)
    bc = gc - _segment_sum((Jc * v[..., None]).sum(1), cids, C)
    return LMReduction(gp, gc, bp, bc, diag_pose, diag_cam, Hcc_pose, gx, Hpp_inv, diag_pt)


def _point_side(Jp, Jc, Jx, frame_pm, cam_pm, xp, xc):
    """u = Jp·xp[f] + Jc·xc[c] per slot and w = Σ Jxᵀu per point."""
    N, capp = frame_pm.shape
    u = (Jp * xp[frame_pm.reshape(-1)][:, None, :]).sum(-1) + (
        Jc * xc[cam_pm.reshape(-1)][:, None, :]
    ).sum(-1)
    w = (Jx.reshape(N, capp * 2, 3) * u.reshape(N, capp * 2, 1)).sum(1)
    return u, w


def schur_matvec_plain(Jp, Jc, Jx, frame_pm, cam_pm, Hpp_inv, xp, xc):
    """(H_cc - H_cp H_pp⁻¹ H_pc) x for the reduced camera system (K3's function).

    The λD·x term is the caller's. Returns (out_p (F, 6), out_c (C, P)).
    """
    N, capp = frame_pm.shape
    u, w = _point_side(Jp, Jc, Jx, frame_pm, cam_pm, xp, xc)
    y = (Hpp_inv * w[:, None, :]).sum(-1)
    v = (Jx.reshape(N, capp, 2, 3) * y[:, None, None, :]).sum(-1).reshape(-1, 2)
    z = u - v
    out_p = _segment_sum((Jp * z[..., None]).sum(1), frame_pm.reshape(-1), xp.shape[0])
    out_c = _segment_sum((Jc * z[..., None]).sum(1), cam_pm.reshape(-1), xc.shape[0])
    return out_p, out_c


def back_substitute_plain(Jp, Jc, Jx, frame_pm, cam_pm, Hpp_inv, gx, dp, dc):
    """dx = H_pp⁻¹ (g_x - H_pc [dp; dc]) per point (K3's back-substitution mode)."""
    _, w = _point_side(Jp, Jc, Jx, frame_pm, cam_pm, dp, dc)
    return (Hpp_inv * (gx - w)[:, None, :]).sum(-1)


def _camera_rows(frame_pm, cam_pm, F: int, P: int):
    """(Opm, 6+P) row of the reduced system for each slot's pose and camera entries."""
    fids = frame_pm.reshape(-1, 1).long()
    cids = cam_pm.reshape(-1, 1).long()
    ar = torch.arange(6 + P, device=fids.device)
    return torch.where(ar < 6, 6 * fids + ar, 6 * F + cids * P + (ar - 6))


def dense_schur_assemble_plain(Jp, Jc, Jx, frame_pm, cam_pm, Hpp_inv, lam_diag,
                               num_frames: int, diagonal: bool = True):
    """S = H_cc - Σ_points W Hpp⁻¹ Wᵀ + diag(lam_diag + 1e-10), dense D×D (K4's function);
    without ``diagonal`` the last term is left out (one rank's part of a
    point-sharded solve's S, which adds it after the sum over ranks).

    W holds a point's (pose, camera) x point coupling blocks Jᵀ Jx per slot;
    H_cc adds each slot's [Jp Jc]ᵀ[Jp Jc]: pose 6×6 on the frame diagonal,
    pose-camera and camera-camera blocks. D = 6F + C·P. Only slot pairs of
    one point whose [Jp | Jc] rows are not zero add anything, so the work
    follows each point's real track length, not capp.
    """
    capp = frame_pm.shape[1]
    P = Jc.shape[-1]
    D = lam_diag.shape[0]
    K = 6 + P
    S = torch.zeros(D, D, dtype=Jp.dtype, device=Jp.device)
    rows = _camera_rows(frame_pm, cam_pm, num_frames, P)  # (Opm, K)
    J = torch.cat([Jp, Jc], dim=-1)  # (Opm, 2, K)
    Hcc = (J[..., :, None] * J[..., None, :]).sum(1)  # (Opm, K, K)
    S.index_put_((rows[:, :, None].expand(-1, K, K), rows[:, None, :].expand(-1, K, K)),
                 Hcc, accumulate=True)
    real = (J != 0).flatten(1).any(1).nonzero()[:, 0]  # slot ids, point-major
    pt = real // capp
    W = (J[real, :, :, None] * Jx[real, :, None, :]).sum(1)  # (M, K, 3)
    Z = W @ Hpp_inv[pt]  # W Hpp⁻¹
    # Every ordered pair (i, j) of real slots of one point, as indices into `real`.
    cnt = torch.bincount(pt, minlength=frame_pm.shape[0])
    reps = cnt[pt]
    i = torch.repeat_interleave(torch.arange(len(real), device=J.device), reps)
    offs = torch.arange(len(i), device=J.device) - torch.repeat_interleave(
        torch.cumsum(reps, 0) - reps, reps)
    j = (torch.cumsum(cnt, 0) - cnt)[pt[i]] + offs
    pair_chunk = max(1, (1 << 22) // (K * K))  # bounds the (chunk, K, K) temporaries
    for s in range(0, len(i), pair_chunk):
        a, b = i[s:s + pair_chunk], j[s:s + pair_chunk]
        blk = Z[a] @ W[b].transpose(-1, -2)
        ra, rb = rows[real[a]], rows[real[b]]
        S.index_put_((ra[:, :, None].expand(-1, K, K), rb[:, None, :].expand(-1, K, K)),
                     -blk, accumulate=True)
    if diagonal:
        S.diagonal().add_(lam_diag + 1e-10)
    return S


def covariance_assemble_plain(Jp, Jc, Jx, frame_pm, cam_pm, lam: float, num_frames: int,
                              num_cams: int, dtype=torch.float64):
    """S = H_cc - Σ_points W (H_pp + diag(lam diag(H_pp) + 1e-12))⁻¹ Wᵀ + lam diag(H_cc),
    dense D×D in ``dtype`` (K54's function): colmap_tpu's S of
    estimate_ba_covariance (covariance.py:57, the vmap of _schur_matvec over
    the identity with _build_schur's operators) from the point-major
    Jacobians, which are first cast to ``dtype``. Nothing else is added to
    the diagonal, so a row whose Jacobian column is masked stays exactly 0.
    """
    Jp, Jc, Jx = (x.to(dtype) for x in (Jp, Jc, Jx))
    N, capp = frame_pm.shape
    F, C, P = int(num_frames), int(num_cams), Jc.shape[-1]
    Jx_pm = Jx.reshape(N, capp * 2, 3)
    Hpp = (Jx_pm[..., :, None] * Jx_pm[..., None, :]).sum(1)
    damp = lam * torch.diagonal(Hpp, dim1=-2, dim2=-1) + 1e-12
    Hpp_inv = inv3x3_spd(Hpp + torch.diag_embed(damp))
    diag = torch.cat([
        _segment_sum((Jp * Jp).sum(1), frame_pm.reshape(-1), F).reshape(-1),
        _segment_sum((Jc * Jc).sum(1), cam_pm.reshape(-1), C).reshape(-1)])
    S = dense_schur_assemble_plain(Jp, Jc, Jx, frame_pm, cam_pm, Hpp_inv, diag, F,
                                   diagonal=False)
    S.diagonal().add_(lam * diag)
    return S


# ---------------------------------------------------------------------------
# CUDA wrappers.
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_F = ctypes.c_float

# Argument types of the C entries: sizes, then tensor pointers in the order
# the wrappers pass them, then (except K1) the SM count, then the stream.
_SIGNATURES = {
    "ba_obs_jacobians_f32": [_I, _I, _I, _F, _LL, _I, _I, _P] + [_P] * 17 + [_P],
    "ba_lm_reduce_f32": [_LL, _I, _I, _I, _I] + [_P] * 7 + [_I] + [_P] * 13 + [_P],
    "ba_schur_matvec_f32": [_I, _LL, _I, _I, _I, _I] + [_P] * 10 + [_I, _P],
    "ba_dense_schur_assemble_f32": [_LL, _I, _I, _I, _I] + [_P] * 8 + [_I, _P],
    "ba_covariance_assemble_f64": [_LL, _I, _I, _I, _I, ctypes.c_double] + [_P] * 6 + [_I, _P],
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
    return _P(x.data_ptr()) if x is not None else _P(0)


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


def _check_model(model_id):
    for m in model_id if isinstance(model_id, tuple) else (model_id,):
        if int(m) not in CUDA_MODELS:
            raise ValueError(f"no camera model with id {m}")


def _k1_checks(quat, t, cam_params, points, obs_frame, obs_cam, obs_point, obs_xy,
               obs_w, model_id, loss):
    dev = _require_cuda(points)
    _check_model(model_id)
    if loss not in LOSSES:
        raise ValueError(loss)
    F, C, P, N, O = quat.shape[0], cam_params.shape[0], cam_params.shape[1], points.shape[0], obs_xy.shape[0]
    f32, i32 = torch.float32, torch.int32
    for name, x, dt, shape in (
        ("quat", quat, f32, (F, 4)), ("t", t, f32, (F, 3)),
        ("cam_params", cam_params, f32, (C, P)), ("points", points, f32, (N, 3)),
        ("obs_frame", obs_frame, i32, (O,)), ("obs_cam", obs_cam, i32, (O,)),
        ("obs_point", obs_point, i32, (O,)), ("obs_xy", obs_xy, f32, (O, 2)),
        ("obs_w", obs_w, f32, (O,)),
    ):
        _check(name, x, dt, shape, dev)
    if P != _row_width(model_id):
        raise ValueError(f"cam_params has {P} columns for model {model_id}")
    return dev, F, C, P, N, O


def _k1_launches(mode, quat, t, cam_params, points, obs_frame, obs_cam, obs_point, obs_xy, obs_w,
                 masks, outs, cost, model_id, loss, loss_scale, groups):
    """One K1 launch per model group; every launch writes its slots of the
    shared outputs (or adds into ``cost``)."""
    dev, W, O = points.device, cam_params.shape[1], obs_xy.shape[0]
    for m, slots in _groups(groups, model_id, cam_params, obs_cam):
        n = O if slots is None else slots.shape[0]
        _call("ba_obs_jacobians_f32", m, mode, LOSSES[loss], float(loss_scale), n,
              camera_models.model_num_params(m), W, _ptr(slots),
              *map(_ptr, (quat, t, cam_params, points, obs_frame, obs_cam, obs_point, obs_xy,
                          obs_w, *masks, *outs, cost)),
              _stream(dev))
        LAUNCHES["ba_obs_jacobians"] += 1
        SHAPES.add("ba_obs_jacobians", "cost" if mode else "jacobians",
                   (n, points.shape[0], quat.shape[0], cam_params.shape[0], W), _k1_launches,
                   (mode, quat, t, cam_params, points, obs_frame, obs_cam, obs_point, obs_xy,
                    obs_w, masks, outs, cost, model_id, loss, loss_scale, [(m, slots)]))


def obs_jacobians(quat, t, cam_params, points, obs_frame, obs_cam, obs_point,
                  obs_xy, obs_w, pose_mask, cam_mask, point_mask,
                  model_id, loss: str, loss_scale: float, groups=None):
    """K1, Jacobian mode. See obs_jacobians_plain for the function."""
    if points.device.type == "cpu":
        return obs_jacobians_plain(quat, t, cam_params, points, obs_frame, obs_cam,
                                   obs_point, obs_xy, obs_w, pose_mask, cam_mask,
                                   point_mask, model_id, loss, loss_scale, groups)
    dev, F, C, P, N, O = _k1_checks(quat, t, cam_params, points, obs_frame, obs_cam,
                                    obs_point, obs_xy, obs_w, model_id, loss)
    _check("pose_mask", pose_mask, torch.float32, (F, 6), dev)
    _check("cam_mask", cam_mask, torch.float32, (C, P), dev)
    _check("point_mask", point_mask, torch.float32, (N,), dev)
    r = torch.empty(O, 2, dtype=torch.float32, device=dev)
    Jp = torch.empty(O, 2, 6, dtype=torch.float32, device=dev)
    Jc = torch.empty(O, 2, P, dtype=torch.float32, device=dev)
    Jx = torch.empty(O, 2, 3, dtype=torch.float32, device=dev)
    _k1_launches(0, quat, t, cam_params, points, obs_frame, obs_cam, obs_point, obs_xy, obs_w,
                 (pose_mask, cam_mask, point_mask), (r, Jp, Jc, Jx), None, model_id, loss,
                 loss_scale, groups)
    return r, Jp, Jc, Jx


def obs_cost(quat, t, cam_params, points, obs_frame, obs_cam, obs_point, obs_xy,
             obs_w, model_id, loss: str, loss_scale: float, groups=None):
    """K1, cost mode: ½ Σ ρ(‖r‖²)·w as a 0-d tensor. See obs_cost_plain."""
    if points.device.type == "cpu":
        return obs_cost_plain(quat, t, cam_params, points, obs_frame, obs_cam,
                              obs_point, obs_xy, obs_w, model_id, loss, loss_scale, groups)
    # Block sums are added in float64; the cost comes back in float32.
    return obs_cost64(quat, t, cam_params, points, obs_frame, obs_cam, obs_point, obs_xy, obs_w,
                      model_id, loss, loss_scale, groups).to(torch.float32)


def obs_cost64_plain(quat, t, cam_params, points, obs_frame, obs_cam, obs_point, obs_xy,
                     obs_w, model_id, loss: str, loss_scale: float, groups=None):
    """obs_cost_plain as a 0-d float64 tensor."""
    return obs_cost_plain(quat, t, cam_params, points, obs_frame, obs_cam, obs_point, obs_xy,
                          obs_w, model_id, loss, loss_scale, groups).double()


def obs_cost64(quat, t, cam_params, points, obs_frame, obs_cam, obs_point, obs_xy,
               obs_w, model_id, loss: str, loss_scale: float, groups=None):
    """K1, cost mode, as its float64 sum (the LM loop's costs)."""
    if points.device.type == "cpu":
        return obs_cost64_plain(quat, t, cam_params, points, obs_frame, obs_cam, obs_point,
                                obs_xy, obs_w, model_id, loss, loss_scale, groups)
    _k1_checks(quat, t, cam_params, points, obs_frame, obs_cam, obs_point, obs_xy, obs_w,
               model_id, loss)
    cost = torch.zeros((), dtype=torch.float64, device=points.device)
    _k1_launches(1, quat, t, cam_params, points, obs_frame, obs_cam, obs_point, obs_xy, obs_w,
                 (None, None, None), (None, None, None, None), cost, model_id, loss, loss_scale,
                 groups)
    return cost


def _j_checks(Jp, Jc, Jx, frame_pm, cam_pm):
    dev = _require_cuda(Jp)
    N, capp = frame_pm.shape
    O, P = N * capp, Jc.shape[-1]
    f32, i32 = torch.float32, torch.int32
    for name, x, dt, shape in (
        ("Jp", Jp, f32, (O, 2, 6)), ("Jc", Jc, f32, (O, 2, P)), ("Jx", Jx, f32, (O, 2, 3)),
        ("frame_pm", frame_pm, i32, (N, capp)), ("cam_pm", cam_pm, i32, (N, capp)),
    ):
        _check(name, x, dt, shape, dev)
    return dev, N, capp, P


def lm_reduce(r, Jp, Jc, Jx, frame_pm, cam_pm, num_frames: int, num_cams: int,
              lam, order=None) -> LMReduction:
    """K2. See lm_reduce_plain for the function; lam is a 0-d float32 tensor
    on the card, read there by the kernel; ``order`` the problem's
    ``SlotOrder`` (pack_problem's maps.order), which the kernel needs. Not
    reentrant for one order: a call uses and resets its tickets
    (``SlotOrder``)."""
    if Jp.device.type == "cpu":
        return lm_reduce_plain(r, Jp, Jc, Jx, frame_pm, cam_pm, num_frames, num_cams, lam)
    dev, N, capp, P = _j_checks(Jp, Jc, Jx, frame_pm, cam_pm)
    _check("r", r, torch.float32, (N * capp, 2), dev)
    _check("lam", lam, torch.float32, (), dev)
    F, C = int(num_frames), int(num_cams)
    if order is None or (order.num_frames, order.num_cams, order.num_slots) != (F, C, N * capp):
        raise ValueError(f"K2 takes the slot order of a problem of {F} frames, {C} cameras and "
                         f"{N * capp} slots (pack_problem's maps.order)")
    W = order.items.shape[0]
    _check("order.items", order.items, torch.int32, (W, REDUCE_ITEM_FIELDS), dev)
    if order.num_real > N * capp:
        raise ValueError(f"the order has {order.num_real} real slots of {N * capp}")
    _check("order.slots", order.slots, torch.int32, (2 * order.num_real,), dev)
    plan = lm_reduce_plan(N, capp, W)
    e = functools.partial(torch.empty, dtype=torch.float32, device=dev)
    out = LMReduction(
        gp=e(F, 6), gc=e(C, P), bp=e(F, 6), bc=e(C, P), diag_pose=e(F, 6),
        diag_cam=e(C, P), Hcc_pose=e(F, 6, 6), gx=e(N, 3), Hpp_inv=e(N, 3, 3),
        diag_pt=e(N, 3),
    )
    partials = e(order.num_partials, max(33, 3 * P)) if order.num_partials else None
    y = None if plan.recompute else e(N, 3)
    _call("ba_lm_reduce_f32", N, capp, F, C, P,
          *map(_ptr, (lam, r, Jp, Jc, Jx, order.slots, order.items)), W,
          *map(_ptr, (order.tickets, partials, y, *out)), _stream(dev))
    LAUNCHES["ba_lm_reduce"] += 1
    SHAPES.add("ba_lm_reduce", "reduce", (N, capp, F, C, P), lm_reduce,
               (r, Jp, Jc, Jx, frame_pm, cam_pm, num_frames, num_cams, lam, order))
    return out


def _k3(mode, Jp, Jc, Jx, frame_pm, cam_pm, Hpp_inv, xp, xc, gx):
    dev, N, capp, P = _j_checks(Jp, Jc, Jx, frame_pm, cam_pm)
    F, C = xp.shape[0], xc.shape[0]
    _check("Hpp_inv", Hpp_inv, torch.float32, (N, 3, 3), dev)
    _check("xp", xp, torch.float32, (F, 6), dev)
    _check("xc", xc, torch.float32, (C, P), dev)
    if mode == 0:
        out = torch.zeros(6 * F + P * C, dtype=torch.float32, device=dev)
    else:
        _check("gx", gx, torch.float32, (N, 3), dev)
        out = torch.empty(N, 3, dtype=torch.float32, device=dev)
    _call("ba_schur_matvec_f32", mode, N, capp, F, C, P,
          *map(_ptr, (Jp, Jc, Jx, frame_pm, cam_pm, Hpp_inv, xp, xc, gx, out)),
          _I(_num_sms(dev)), _stream(dev))
    LAUNCHES["ba_schur_matvec"] += 1
    SHAPES.add("ba_schur_matvec", "back_substitute" if mode else "matvec", (N, capp, F, C, P),
               _k3, (mode, Jp, Jc, Jx, frame_pm, cam_pm, Hpp_inv, xp, xc, gx))
    return out


def schur_matvec(Jp, Jc, Jx, frame_pm, cam_pm, Hpp_inv, xp, xc):
    """K3, matvec mode. See schur_matvec_plain for the function."""
    if Jp.device.type == "cpu":
        return schur_matvec_plain(Jp, Jc, Jx, frame_pm, cam_pm, Hpp_inv, xp, xc)
    out = _k3(0, Jp, Jc, Jx, frame_pm, cam_pm, Hpp_inv, xp.contiguous(), xc.contiguous(), None)
    F = xp.shape[0]
    return out[: 6 * F].view(F, 6), out[6 * F:].view(xc.shape)


def back_substitute(Jp, Jc, Jx, frame_pm, cam_pm, Hpp_inv, gx, dp, dc):
    """K3, back-substitution mode. See back_substitute_plain for the function."""
    if Jp.device.type == "cpu":
        return back_substitute_plain(Jp, Jc, Jx, frame_pm, cam_pm, Hpp_inv, gx, dp, dc)
    return _k3(1, Jp, Jc, Jx, frame_pm, cam_pm, Hpp_inv, dp.contiguous(), dc.contiguous(), gx)


def dense_schur_assemble(Jp, Jc, Jx, frame_pm, cam_pm, Hpp_inv, lam_diag,
                         num_frames: int, diagonal: bool = True):
    """K4. See dense_schur_assemble_plain for the function."""
    if Jp.device.type == "cpu":
        return dense_schur_assemble_plain(Jp, Jc, Jx, frame_pm, cam_pm, Hpp_inv,
                                          lam_diag, num_frames, diagonal)
    dev, N, capp, P = _j_checks(Jp, Jc, Jx, frame_pm, cam_pm)
    D = lam_diag.shape[0]
    F = int(num_frames)
    C = (D - 6 * F) // P
    if 6 * F + C * P != D:
        raise ValueError(f"lam_diag has {D} entries; expected 6F + C*P")
    _check("Hpp_inv", Hpp_inv, torch.float32, (N, 3, 3), dev)
    _check("lam_diag", lam_diag, torch.float32, (D,), dev)
    S = torch.zeros(D, D, dtype=torch.float32, device=dev)
    _call("ba_dense_schur_assemble_f32", N, capp, F, C, P,
          *map(_ptr, (Jp, Jc, Jx, frame_pm, cam_pm, Hpp_inv, lam_diag if diagonal else None, S)),
          _I(_num_sms(dev)), _stream(dev))
    LAUNCHES["ba_dense_schur_assemble"] += 1
    return S


def covariance_assemble(Jp, Jc, Jx, frame_pm, cam_pm, lam: float, num_frames: int,
                        num_cams: int):
    """K54: the covariance's S in float64 from K1's float32 Jacobians. See
    covariance_assemble_plain for the function (run in float64 on the CPU)."""
    if Jp.device.type == "cpu":
        return covariance_assemble_plain(Jp, Jc, Jx, frame_pm, cam_pm, lam, num_frames, num_cams)
    dev, N, capp, P = _j_checks(Jp, Jc, Jx, frame_pm, cam_pm)
    F, C = int(num_frames), int(num_cams)
    D = 6 * F + C * P
    S = torch.zeros(D, D, dtype=torch.float64, device=dev)
    _call("ba_covariance_assemble_f64", N, capp, F, C, P, float(lam),
          *map(_ptr, (Jp, Jc, Jx, frame_pm, cam_pm, S)), _I(_num_sms(dev)), _stream(dev))
    LAUNCHES["ba_covariance_assemble"] += 1
    return S


class BAKernels(NamedTuple):
    obs_jacobians: object
    obs_cost: object
    obs_cost64: object
    lm_reduce: object
    schur_matvec: object
    back_substitute: object
    dense_schur_assemble: object
    pcg_setup: object
    pcg_step: object
    lm_candidate: object
    lm_accept: object
    covariance_assemble: object


KERNELS = BAKernels(obs_jacobians, obs_cost, obs_cost64, lm_reduce, schur_matvec,
                    back_substitute, dense_schur_assemble, solver.pcg_setup, solver.pcg_step,
                    solver.lm_candidate, solver.lm_accept, covariance_assemble)
PLAIN = BAKernels(obs_jacobians_plain, obs_cost_plain, obs_cost64_plain, lm_reduce_plain,
                  schur_matvec_plain, back_substitute_plain, dense_schur_assemble_plain,
                  solver.pcg_setup_plain, solver.pcg_step_plain, solver.lm_candidate_plain,
                  solver.lm_accept_plain, covariance_assemble_plain)
