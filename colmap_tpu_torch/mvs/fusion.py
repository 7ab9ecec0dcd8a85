"""Depth-map fusion into a consistent point cloud (colmap_tpu/mvs/fusion.py).

reference behavior: src/colmap/mvs/fusion.{h,cc} — StereoFusion fuses
supporting observations (reproj error / depth ratio / normal angle
thresholds, fusion.h:47-151). As colmap_tpu: every pixel of an image is
reprojected into each other depth map at once, a pixel's supporting
back-projections are averaged, and the pixels that supported a fused point
are marked used, image by image in input order.

colmap_tpu computes this in numpy on the host; the port runs each image's
reprojection into the others as torch ops on the device it is given, in
float64 (the rounding of reprojected pixels decides the lookups), and
builds the visibility lists and the ``.vis`` file with array ops. The
points, normals and ``.vis`` bytes are colmap_tpu's.
"""

from __future__ import annotations

import dataclasses
import struct
from typing import List, Optional, Tuple

import numpy as np
import torch

from colmap_tpu_torch.utils.dtypes import resolve_device


@dataclasses.dataclass
class FusionOptions:
    """reference: mvs/fusion.h StereoFusionOptions."""

    max_reproj_error: float = 2.0
    max_depth_error: float = 0.01  # relative
    max_normal_error_deg: float = 10.0
    min_num_consistent: int = 2
    voxel_size_factor: float = 0.5  # dedup voxel = factor * mean depth / f


class FusionImage:
    """Per-image data for fusion: pose, intrinsics, depth/normal maps."""

    def __init__(self, image_id, K, R, t, depth, normal, color=None):
        self.image_id = image_id
        self.K = np.asarray(K, dtype=np.float64)
        self.R = np.asarray(R, dtype=np.float64)  # cam_from_world rotation
        self.t = np.asarray(t, dtype=np.float64)
        self.depth = np.asarray(depth, dtype=np.float32)
        self.normal = np.asarray(normal, dtype=np.float32)
        self.color = color  # optional (H, W) or (H, W, 3)


class Visibility:
    """The fused points' visibility lists, packed: point i sees
    ``ids[offsets[i]:offsets[i + 1]]`` (image ids, uint32), its own image
    first. Indexing and iteration give lists of ints, as colmap_tpu's list
    of lists does."""

    def __init__(self, offsets: np.ndarray, ids: np.ndarray):
        self.offsets = np.asarray(offsets, dtype=np.int64)
        self.ids = np.asarray(ids, dtype=np.uint32)

    def __len__(self) -> int:
        return len(self.offsets) - 1

    def __getitem__(self, i) -> List[int]:
        return self.ids[self.offsets[i]:self.offsets[i + 1]].tolist()

    def __iter__(self):
        return (self[i] for i in range(len(self)))

    def tolist(self) -> List[List[int]]:
        return list(self)


def _backproject(K, R, t, depth):
    """Depth map (H, W) -> world points (H, W, 3): Rᵀ (d K⁻¹ (x, y, 1) - t)."""
    H, W = depth.shape
    ys, xs = torch.meshgrid(torch.arange(H, device=depth.device),
                            torch.arange(W, device=depth.device), indexing="ij")
    pix = torch.stack([xs, ys, torch.ones_like(xs)], dim=-1).to(torch.float64)
    rays = pix @ torch.linalg.inv(K).T
    return (rays * depth[..., None] - t) @ R


def fuse_depth_maps(
    images: List[FusionImage], options: Optional[FusionOptions] = None, device="cuda",
) -> Tuple[np.ndarray, np.ndarray, Visibility]:
    """Fuse consistent depth estimates into a point cloud.

    Returns (points (N, 3), normals (N, 3), visibility lists per point).
    """
    if options is None:
        options = FusionOptions()
    dev = resolve_device(device)
    f64 = torch.float64

    def t(a, dtype=f64):
        return torch.as_tensor(a, device=dev).to(dtype)

    cams = {fi.image_id: (t(fi.K), t(fi.R), t(fi.t)) for fi in images}
    depths = {fi.image_id: t(fi.depth, torch.float32) for fi in images}
    world_pts = {i: _backproject(*cams[i], depths[i]) for i in cams}
    # Normal in world frame: Rᵀ n_cam.
    world_nrm = {fi.image_id: t(fi.normal) @ cams[fi.image_id][1] for fi in images}
    used = {i: torch.zeros(d.shape, dtype=torch.bool, device=dev) for i, d in depths.items()}
    cos_thresh = float(np.cos(np.deg2rad(options.max_normal_error_deg)))

    fused_points, fused_normals, vis_ids, vis_counts = [], [], [], []
    for fi in images:
        depth = depths[fi.image_id]
        H, W = depth.shape
        valid = depth > 0
        X = world_pts[fi.image_id]
        Nrm = world_nrm[fi.image_id]
        support = torch.zeros((H, W), dtype=torch.int32, device=dev)
        support_pts = torch.zeros((H, W, 3), dtype=f64, device=dev)
        support_nrm = torch.zeros((H, W, 3), dtype=f64, device=dev)
        others = []
        for fj in images:
            if fj.image_id == fi.image_id:
                continue
            Kj, Rj, tj = cams[fj.image_id]
            dmap = depths[fj.image_id]
            Xc = X @ Rj.T + tj  # camera frame of j
            z = Xc[..., 2]
            p = Xc @ Kj.T
            u = p[..., 0] / p[..., 2]
            v = p[..., 1] / p[..., 2]
            Hj, Wj = dmap.shape
            inb = (z > 0) & (u >= 0) & (u < Wj - 1) & (v >= 0) & (v < Hj - 1) & valid

            def index(c, n):
                c = torch.nan_to_num(c, nan=0.0, posinf=0.0, neginf=0.0)
                return torch.clamp(torch.round(c), 0, n - 1).to(torch.int64)

            ui, vi = index(u, Wj), index(v, Hj)
            dj = dmap[vi, ui].to(f64)
            ok = inb & (dj > 0)
            # Relative depth agreement.
            ok &= torch.abs(dj - z) <= options.max_depth_error * torch.clamp(z, min=1e-8)
            # Normal agreement (world frame).
            nj = world_nrm[fj.image_id][vi, ui]
            ok &= torch.abs(torch.sum(Nrm * nj, dim=-1)) >= cos_thresh
            support += ok.to(torch.int32)
            support_pts += torch.where(ok[..., None], world_pts[fj.image_id][vi, ui], 0.0)
            support_nrm += torch.where(ok[..., None], nj, 0.0)
            others.append((fj.image_id, ok, vi, ui))

        keep = valid & (support >= options.min_num_consistent - 1) & ~used[fi.image_id]
        n_sup = (support[keep][:, None] + 1).to(f64)
        fused_points.append((X[keep] + support_pts[keep]) / n_sup)
        nrm = Nrm[keep] + support_nrm[keep]
        fused_normals.append(nrm / torch.clamp(torch.linalg.vector_norm(nrm, dim=-1, keepdim=True),
                                               min=1e-12))

        # Mark supporting pixels as consumed so each surface point fuses once.
        for fj_id, ok, vi, ui in others:
            m = ok & keep
            used[fj_id][vi[m], ui[m]] = True
        used[fi.image_id][keep] = True

        # Visibility: the image itself, then each supporting image in order.
        n = int(keep.sum())
        seen = torch.ones((n, 1 + len(others)), dtype=torch.bool, device=dev)
        ids = torch.full((n, 1 + len(others)), int(fi.image_id), dtype=torch.int64, device=dev)
        for k, (fj_id, ok, _, _) in enumerate(others):
            seen[:, k + 1] = ok[keep]
            ids[:, k + 1] = int(fj_id)
        vis_ids.append(ids[seen])
        vis_counts.append(seen.sum(dim=1))

    if not fused_points:
        return np.zeros((0, 3)), np.zeros((0, 3)), Visibility(np.zeros(1), np.zeros(0))
    counts = torch.cat(vis_counts).cpu().numpy()
    offsets = np.concatenate([[0], np.cumsum(counts)])
    return (torch.cat(fused_points).cpu().numpy(), torch.cat(fused_normals).cpu().numpy(),
            Visibility(offsets, torch.cat(vis_ids).cpu().numpy()))


def write_fused_vis(path, visibility):
    """Write fused.ply.vis: per-point visible image indices.

    reference format (mvs/fusion.cc WritePointsVisibility): uint64 count,
    then per point uint32 n + n x uint32 image indices. ``visibility`` is a
    Visibility or a list of lists; the file is written from one buffer.
    """
    if not isinstance(visibility, Visibility):
        lists = [np.asarray(ids, dtype=np.uint32).reshape(-1) for ids in visibility]
        counts = np.array([len(ids) for ids in lists], dtype=np.int64)
        visibility = Visibility(np.concatenate([[0], np.cumsum(counts)]),
                                np.concatenate(lists) if lists else np.zeros(0))
    offsets = visibility.offsets
    n = len(visibility)
    counts = np.diff(offsets)
    buf = np.empty(n + len(visibility.ids), dtype="<u4")
    heads = offsets[:-1] + np.arange(n)  # each record: its count, then its ids
    buf[heads] = counts
    body = np.ones(len(buf), dtype=bool)
    body[heads] = False
    buf[body] = visibility.ids
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", n))
        f.write(buf.tobytes())


def read_fused_vis(path):
    """Read fused.ply.vis -> list of uint32 arrays."""
    with open(path, "rb") as f:
        raw = f.read()
    (n,) = struct.unpack_from("<Q", raw, 0)
    data = np.frombuffer(raw, dtype="<u4", offset=8)
    out, pos = [], 0
    for _ in range(n):
        m = int(data[pos])
        out.append(data[pos + 1:pos + 1 + m].astype(np.uint32))
        pos += 1 + m
    return out
