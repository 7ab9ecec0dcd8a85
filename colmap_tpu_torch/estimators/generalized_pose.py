"""Structure-less absolute pose: a new camera from 2D-2D correspondences.

Counterpart of ``estimate_structure_less_absolute_pose`` in
colmap_tpu/estimators/generalized_pose.py (reference behavior:
EstimateStructureLessAbsolutePose, estimators/generalized_pose.cc, as the
incremental mapper's fallback when an image has too few 2D-3D
correspondences, incremental_mapper.cc:673-870). The rest of that module
(generalized absolute and relative pose for rigs) is not ported yet.

5 + 1 RANSAC: five correspondences to one registered camera give the
essential matrices new <- that camera (Nistér), cheirality picks (R, t
direction) of each; one correspondence to another registered camera fixes
the scale of t from its epipolar constraint. A model is scored by the
generalized Sampson error of every correspondence against its own camera.
The hypotheses run as batched torch ops on the mapper's device; samples
come from a seeded CPU ``torch.Generator`` and the host reads one best
support per batch.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from colmap_tpu_torch.estimators.solvers.epipolar import essential_five_point
from colmap_tpu_torch.geometry import rotation as rot
from colmap_tpu_torch.geometry.essential import (
    calc_depth,
    cross_product_matrix,
    decompose_essential_matrix,
    triangulate_point_dlt,
)
from colmap_tpu_torch.kernels import sfm as K
from colmap_tpu_torch.scene.types import Camera, Pose
from colmap_tpu_torch.utils.dtypes import floatx


@dataclasses.dataclass(frozen=True)
class StructureLessAbsolutePoseOptions:
    """reference: StructureLessAbsolutePoseEstimationOptions
    (incremental_mapper.cc:763-773): Sampson scoring, stricter error."""

    max_error_px: float = 6.0
    confidence: float = 0.9999
    min_num_trials: int = 100
    max_num_trials: int = 5000
    batch_size: int = 16


def _unproject(camera: Camera, xy: np.ndarray, device, dtype) -> torch.Tensor:
    params = torch.as_tensor(np.asarray(camera.params), dtype=dtype).to(device)
    uv, _ = K.cam_from_img(int(camera.model_id), params,
                           torch.as_tensor(xy, dtype=dtype).to(device).contiguous())
    return uv


def _poses_from_essentials(E, x1, x2):
    """Cheirality of every essential matrix E (..., 3, 3) on its own five
    points x1, x2 (..., 5, 2): the (R, t) of the four decompositions with
    the most points in front of both cameras (the first on a tie), and that
    count."""
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


def _sampson_sq_px(R, t, Rw, tw, cam_idx, x1h, x2h, focal):
    """(M, N) squared generalized Sampson errors in pixels of models
    cam_from_world = [R | t] (M, 3, 3), (M, 3), each correspondence against
    its own registered camera; models in chunks of at most 2^22 / N."""
    Rwn, twn = Rw[cam_idx], tw[cam_idx]
    out = []
    step = max(1, (1 << 22) // max(x1h.shape[0], 1))
    for i in range(0, R.shape[0], step):
        R_rel = torch.einsum("mab,ncb->mnac", R[i:i + step], Rwn)
        t_rel = t[i:i + step, None, :] - torch.einsum("mnab,nb->mna", R_rel, twn)
        E = cross_product_matrix(t_rel) @ R_rel
        Ex1 = torch.einsum("mnij,nj->mni", E, x1h)
        Etx2 = torch.einsum("mnji,nj->mni", E, x2h)
        num = torch.sum(x2h * Ex1, dim=-1) ** 2
        den = Ex1[..., 0] ** 2 + Ex1[..., 1] ** 2 + Etx2[..., 0] ** 2 + Etx2[..., 1] ** 2
        out.append(num / torch.clamp(den, min=1e-12) * focal**2)
    return torch.cat(out)


def estimate_structure_less_absolute_pose(
    points2D: np.ndarray,
    world_points2D: np.ndarray,
    world_camera_idxs: np.ndarray,
    world_cams_from_world: Sequence[Pose],
    world_cameras: Sequence[Camera],
    camera: Camera,
    options: Optional[StructureLessAbsolutePoseOptions] = None,
    seed: int = 0,
    device=None,
) -> Tuple[Optional[Pose], np.ndarray]:
    """cam_from_world of a new camera from its 2D-2D correspondences to
    registered images (no triangulated structure needed). Returns
    (cam_from_world | None, inlier_mask)."""
    options = options or StructureLessAbsolutePoseOptions()
    n = len(points2D)
    world_camera_idxs = np.asarray(world_camera_idxs, dtype=np.int64)
    C = len(world_cameras)
    if n < 6 or C < 2:
        return None, np.zeros(n, dtype=bool)
    device = torch.device(device or "cuda")
    dt = floatx(device)
    uv = _unproject(camera, np.asarray(points2D, dtype=np.float64), device, dt)
    uv_w = torch.zeros((n, 2), dtype=dt, device=device)
    focal_w = np.zeros(n)
    for ci, cam in enumerate(world_cameras):
        sel = np.nonzero(world_camera_idxs == ci)[0]
        if len(sel):
            uv_w[torch.as_tensor(sel, device=device)] = _unproject(
                cam, np.asarray(world_points2D, dtype=np.float64)[sel], device, dt)
            focal_w[sel] = cam.mean_focal_length()
    focal = torch.as_tensor(np.sqrt(focal_w * camera.mean_focal_length()), dtype=dt).to(device)
    Rw = torch.as_tensor(np.stack([p.rotmat() for p in world_cams_from_world]), dtype=dt)
    tw = torch.as_tensor(np.stack([p.t for p in world_cams_from_world]), dtype=dt)
    Rw, tw = Rw.to(device), tw.to(device)

    # Correspondences grouped by world camera; cameras with fewer than five
    # are never the camera of the five-point sample.
    order = np.argsort(world_camera_idxs, kind="stable")
    counts = np.bincount(world_camera_idxs, minlength=C)
    offsets = np.concatenate([[0], np.cumsum(counts)])
    cam_probs = (counts >= 5).astype(np.float64)
    if cam_probs.sum() == 0:
        return None, np.zeros(n, dtype=bool)
    gen = torch.Generator().manual_seed(int(seed))
    probs_t = torch.as_tensor(cam_probs / cam_probs.sum())
    counts_t, offsets_t = torch.as_tensor(counts), torch.as_tensor(offsets)
    order_t, cam_idx_cpu = torch.as_tensor(order), torch.as_tensor(world_camera_idxs)
    cam_idx = cam_idx_cpu.to(device)
    x1h = torch.cat([uv_w, torch.ones_like(uv_w[:, :1])], dim=1)
    x2h = torch.cat([uv, torch.ones_like(uv[:, :1])], dim=1)
    max_sq = float(options.max_error_px) ** 2
    B = options.batch_size

    def hypotheses():
        """(B * 10, 3, 3) rotations and (B * 10, 3) translations, NaN where
        a slot holds no valid model."""
        cams = torch.multinomial(probs_t, B, replacement=True, generator=gen)
        r5 = torch.randint(0, 1 << 30, (B, 5), generator=gen) % counts_t[cams][:, None]
        idx5 = order_t[offsets_t[cams][:, None] + r5].to(device)
        r1 = torch.randint(0, n, (B,), generator=gen)
        scale_ok = (cam_idx_cpu[r1] != cams).to(device)
        cams, r1 = cams.to(device), r1.to(device)
        x_w, x_n = uv_w[idx5], uv[idx5]  # (B, 5, 2)
        Es = essential_five_point(x_w, x_n)  # (B, 10, 3, 3): new <- world camera
        R_rel, t_dir, n_front, finite = _poses_from_essentials(
            Es, x_w[:, None], x_n[:, None])
        valid = finite & (n_front >= 4)
        # cam_from_world(s) = (R_rel, s t_dir) o (Rc, tc); the extra
        # correspondence's epipolar constraint against its camera is linear
        # in s: x2' [a + s b]x R_ns x1 = 0.
        Rc, tc = Rw[cams][:, None], tw[cams][:, None]
        R_new = R_rel @ Rc
        t_base = (R_rel @ tc[..., None])[..., 0]
        Rs2, ts2 = Rw[cam_idx[r1]][:, None], tw[cam_idx[r1]][:, None]
        R_ns = R_new @ Rs2.transpose(-1, -2)
        a = t_base - (R_ns @ ts2[..., None])[..., 0]
        Rx1 = (R_ns @ x1h[r1][:, None, :, None])[..., 0]
        x2s = x2h[r1][:, None]
        c0 = torch.sum(x2s * torch.linalg.cross(a, Rx1), dim=-1)
        c1 = torch.sum(x2s * torch.linalg.cross(t_dir, Rx1), dim=-1)
        s = -c0 / torch.where(torch.abs(c1) < 1e-12, 1e-12, c1)
        t_new = t_base + s[..., None] * t_dir
        ok = valid & (torch.abs(c1) > 1e-10) & (s > 1e-8) & scale_ok[:, None]
        nan = torch.full_like(t_new, math.nan)
        return (torch.where(ok[..., None, None], R_new, nan[..., None]).reshape(-1, 3, 3),
                torch.where(ok[..., None], t_new, nan).reshape(-1, 3))

    def score_batch():
        R, t = hypotheses()
        support = (_sampson_sq_px(R, t, Rw, tw, cam_idx, x1h, x2h, focal) <= max_sq).sum(-1)
        model_ok = torch.isfinite(R).flatten(1).all(1) & torch.isfinite(t).all(1)
        support = torch.where(model_ok, support, 0)
        best = int(torch.argmax(support))
        return R[best], t[best], int(support[best])

    R_best, t_best, support = score_batch()
    trials = B
    nom = math.log(max(1.0 - options.confidence, 1e-30))
    while trials < options.max_num_trials:
        ratio = support / n
        denom = math.log(max(1.0 - ratio**6, 1e-30))
        dyn = 3.0 * nom / denom if denom < -1e-12 else math.inf
        if trials >= options.min_num_trials and trials >= dyn:
            break
        R, t, s = score_batch()
        if s > support:
            R_best, t_best, support = R, t, s
        trials += B
    if not (torch.isfinite(R_best).all() and torch.isfinite(t_best).all()):
        return None, np.zeros(n, dtype=bool)
    inliers = _sampson_sq_px(R_best[None], t_best[None], Rw, tw, cam_idx, x1h, x2h,
                             focal)[0] <= max_sq
    if int(inliers.sum()) < 6:
        return None, np.zeros(n, dtype=bool)
    R64 = R_best.double().cpu()
    return Pose(rot.rotmat_to_quat(R64).numpy(), t_best.double().cpu().numpy()), \
        inliers.cpu().numpy()
