"""Synthetic inputs of spherical (360-degree) pairs, made from a numpy seed.

As kernels/matching_cases.py does for K10-K12: cases of rays for K32 and K33
at the shapes the verification blocks give them, with outliers, padding rows
and degenerate samples; colmap_tpu's equirectangular test pairs; and a
database of 360-degree frames for the matcher. A consumer 360-degree
camera's still is 5760 x 2880; its 4 px verification threshold is
4 * 2π / 5760 = 4.4e-3 rad.
"""

from __future__ import annotations

import numpy as np
import torch

from colmap_tpu_torch.kernels.sfm_cases import _rotation, _t
from colmap_tpu_torch.sensor import models as camera_models

EQUIRECT = int(camera_models.CameraModelId.EQUIRECTANGULAR)
WIDTH, HEIGHT = 5760, 2880
MAX_SQ_RAD = (4.0 * 2.0 * np.pi / WIDTH) ** 2


def project(X, width, height):
    """Equirectangular pixels (n, 2) of camera-frame points (n, 3)."""
    xy, _ = camera_models.img_from_cam(EQUIRECT, torch.tensor([float(width), float(height)],
                                                              dtype=torch.float64),
                                       torch.as_tensor(X, dtype=torch.float64),
                                       check_cheirality=False)
    return xy.numpy()


def rays(xy, width, height):
    """Unit bearing rays (n, 3) of equirectangular pixels (n, 2), float64."""
    r, _ = camera_models.cam_ray_from_img(EQUIRECT, torch.tensor([float(width), float(height)],
                                                                 dtype=torch.float64),
                                          torch.as_tensor(xy, dtype=torch.float64))
    return r.numpy()


def _scene(rng, n):
    """n points in a shell 2-8 units around the origin."""
    X = rng.standard_normal((n, 3))
    X /= np.linalg.norm(X, axis=1, keepdims=True)
    return X * rng.uniform(2.0, 8.0, (n, 1))


def ray_case(kind, n, k, seed, device, outliers=0.3, valid=None, noise_px=0.25):
    """K32 ("E": a pair with translation, m = 5) or K33 ("H": a pure
    rotation, m = 4) on one 5760 x 2880 pair: rays x1, x2 (n, 3) of pixels
    with ``noise_px`` of noise, mask (n,), samples (k, m) int32 and max_sq
    (the 4 px threshold, rad²), and the truth R, t. A fraction ``outliers`` of the matches lands on a
    random pixel; rows at or beyond ``valid`` (default n - 3) are padding;
    samples 0 and 1 repeat a row (degenerate)."""
    rng = np.random.default_rng(seed)
    m = {"E": 5, "H": 4}[kind]
    valid = n - 3 if valid is None else valid
    R = _rotation(rng, 0.6)
    t = np.array([0.8, 0.2, 0.3]) if kind == "E" else np.zeros(3)
    X = _scene(rng, n)
    x1 = project(X, WIDTH, HEIGHT) + rng.normal(0, noise_px, (n, 2))
    x2 = project(X @ R.T + t, WIDTH, HEIGHT) + rng.normal(0, noise_px, (n, 2))
    bad = rng.random(n) < outliers
    x2[bad] = rng.uniform(0, [WIDTH, HEIGHT], (int(bad.sum()), 2))
    r1, r2 = rays(x1, WIDTH, HEIGHT), rays(x2, WIDTH, HEIGHT)
    mask = np.arange(n) < valid
    r1[~mask] = 0.0
    r2[~mask] = 0.0
    samples = rng.integers(0, valid, (k, m))
    samples[0] = 3
    samples[1, -1] = samples[1, 0]
    return dict(x1=_t(r1, device), x2=_t(r2, device), mask=_t(mask, device, torch.bool),
                samples=_t(samples, device, torch.int32), max_sq=MAX_SQ_RAD, R=R, t=t)


def ray_block_case(kind, b, n, k, seed, device):
    """A block of ``b`` pairs of ``ray_case`` with different valid counts (n
    down to about n / 2) and outlier shares (0.1-0.5): x1, x2 (b, n, 3),
    mask (b, n), samples (b, k, m) and max_sq (b,), one threshold per pair
    (1-1.7 times the 4 px one)."""
    cases = [ray_case(kind, n, k, seed + 17 * i, device, outliers=0.1 + 0.4 * i / max(b - 1, 1),
                      valid=n - (i * n) // (2 * b)) for i in range(b)]
    out = {key: torch.stack([c[key] for c in cases]) for key in ("x1", "x2", "mask", "samples")}
    out["max_sq"] = _t(MAX_SQ_RAD * (1.0 + 0.1 * np.arange(b)), device)
    return out


# Of a ray pair's three rows of [r2]_x, the two K33's solve keeps, by the
# axis k* = argmax_k |r2_k| it drops.
_KEPT = torch.tensor([[1, 2], [0, 2], [0, 1]])


def ray_dlt_rows8(r1, r2):
    """K33's 4-ray system in float64: of each ray pair's three rows c_k (x)
    r1 of [r2]_x H r1 = 0 (c_k the rows of [r2]_x), the two other than k* =
    argmax_k |r2_k| (the first on ties), in the order of k, pair by pair.
    r1, r2 (..., 4, 3); returns (..., 8, 9). Since r2^T [r2]_x = 0 these
    rows span the space of all 12, so their null vector is the 4-ray DLT's
    (homography_ray_dlt)."""
    x2, y2, z2 = r2.unbind(-1)
    z = torch.zeros_like(z2)
    cross = torch.stack([torch.stack([z, -z2, y2], -1), torch.stack([z2, z, -x2], -1),
                         torch.stack([-y2, x2, z], -1)], -2)  # (..., 4, 3, 3)
    keep = _KEPT.to(r2.device)[r2.abs().argmax(-1)]  # (..., 4, 2)
    rows = torch.gather(cross, -2, keep[..., None].expand(keep.shape + (3,)))
    return (rows[..., None] * r1[..., None, None, :]).reshape(r1.shape[:-2] + (8, 9))


def ray_dlt8(r1, r2):
    """The null vector of ray_dlt_rows8 (its last right singular vector), as
    a (..., 3, 3) homography of unit Frobenius norm: the function K33's
    solve computes, in float64."""
    h = torch.linalg.svd(ray_dlt_rows8(r1, r2))[2][..., -1, :]
    return (h / h.norm(dim=-1, keepdim=True)).reshape(h.shape[:-1] + (3, 3))


def axis_samples(r2, mask, per_group, seed):
    """Samples (7 per_group, 4) int32 of valid rows, by the axis k and sign s
    of each ray's largest component of r2: per_group samples of 4 rays of
    each of the 6 groups (k, s), then per_group samples whose rays come from
    the groups (0, +), (1, -), (2, +) and one drawn at random."""
    rng = np.random.default_rng(seed)
    r = r2.detach().cpu().double().numpy()
    ok = mask.detach().cpu().numpy().astype(bool)
    axis = np.abs(r).argmax(1)
    sign = r[np.arange(len(r)), axis] > 0
    groups = [np.flatnonzero(ok & (axis == k) & (sign == s)) for k in range(3) for s in (True,
                                                                                       False)]
    out = [rng.choice(g, 4, replace=False) for g in groups for _ in range(per_group)]
    for _ in range(per_group):
        picks = [groups[0], groups[3], groups[4], groups[int(rng.integers(6))]]
        out.append(np.array([rng.choice(g) for g in picks]))
    return torch.as_tensor(np.stack(out), dtype=torch.int32, device=r2.device)


def spherical_pair(rng, R, t, n=300, outlier_ratio=0.15, width=2048, height=1024):
    """colmap_tpu's equirectangular test pair (tests/test_ransac_two_view.py
    _spherical_pair): n points in a shell 2-8 units around camera 1 seen by
    a camera at cam2_from_cam1 (R, t), a share of the second keypoints
    moved to random pixels. Returns (camera, x1, x2, matches, outlier rows)."""
    from colmap_tpu_torch.scene.types import Camera

    cam = Camera.create(1, EQUIRECT, 0.0, width, height)
    X = rng.standard_normal((n, 3))
    X /= np.linalg.norm(X, axis=1, keepdims=True)
    X *= rng.uniform(2.0, 8.0, (n, 1))
    x1 = project(X, width, height)
    x2 = project(X @ R.T + t, width, height)
    n_out = int(n * outlier_ratio)
    out_idx = rng.choice(n, n_out, replace=False)
    x2[out_idx] = rng.uniform([0, 0], [width, height], (n_out, 2))
    matches = np.stack([np.arange(n)] * 2, 1).astype(np.uint32)
    return cam, x1, x2, matches, out_idx


def frames(num_frames, seed):
    """cam_from_world (R, t) of 360-degree frames: centers on a circle of
    radius 1.5 (neighbours 2π · 1.5 / num_frames apart), random
    orientations; frame 1 shares frame 0's center (a rotation-only pair)."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(num_frames):
        a = 2.0 * np.pi * (0 if i == 1 else i) / num_frames
        center = np.array([1.5 * np.cos(a), 0.2 * np.sin(3 * a), 1.5 * np.sin(a)])
        R = _rotation(rng)
        out.append((R, -R @ center))
    return out


def write_database(path, num_frames, num_points, seed, width=WIDTH, height=HEIGHT,
                   outlier_ratio=0.03, noise_px=0.25):
    """A database of ``num_frames`` EQUIRECTANGULAR frames (one camera) of
    ``num_points`` points in a shell 4-10 units around the origin, every
    point a keypoint of every frame with its own descriptor (one per point,
    as the synthetic generator writes them) and ``noise_px`` of Gaussian
    noise (a detector's localisation error). With noise, a pure rotation
    is PLANAR after pose recovery as often as PANORAMIC: its H is a rotation
    only to the noise's accuracy, in colmap_tpu as in the port. In each frame a share ``outlier_ratio`` of the keypoints is moved to a
    random pixel: a match of such a keypoint is a planted outlier. Returns
    (frames [(R, t)], outliers {image_id: bool (num_points,)}); image i + 1
    is frame i, keypoint j is point j."""
    from colmap_tpu_torch.scene.database import Database
    from colmap_tpu_torch.scene.types import Camera

    rng = np.random.default_rng(seed)
    X = rng.standard_normal((num_points, 3))
    X /= np.linalg.norm(X, axis=1, keepdims=True)
    X *= rng.uniform(4.0, 10.0, (num_points, 1))
    desc = rng.integers(0, 256, (num_points, 128), dtype=np.int64).astype(np.uint8)
    poses = frames(num_frames, seed + 1)
    db = Database(path)
    cam = Camera.create(1, EQUIRECT, 0.0, width, height)
    db.write_camera(cam)
    outliers = {}
    for i, (R, t) in enumerate(poses):
        image_id = i + 1
        db.write_image(f"pano{i:03d}.png", cam.camera_id, image_id=image_id)
        xy = project(X @ R.T + t, width, height) + rng.normal(0, noise_px, (num_points, 2))
        bad = rng.random(num_points) < outlier_ratio
        xy[bad] = rng.uniform([0, 0], [width, height], (int(bad.sum()), 2))
        xy = np.clip(xy, 0.0, [width - 1e-3, height - 1e-3])
        db.write_keypoints(image_id, xy)
        db.write_descriptors(image_id, desc)
        outliers[image_id] = bad
    db.commit()
    db.close()
    return poses, outliers
