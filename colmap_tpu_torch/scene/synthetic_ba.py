"""Synthetic bundle-adjustment problem generator (array-level, fast).

Counterpart of colmap_tpu/scene/synthetic_ba.py: the same numpy Generator
stream gives the same arrays for the same seed. Generates BAProblem tensors
directly (reference fixtures: benchmark/runtime/bundle_adjustment.cc:61-196
build synthetic problems of N frames x M points with noise).
"""

from __future__ import annotations

import numpy as np
import torch

from colmap_tpu_torch.estimators.bundle_adjustment import BAProblem
from colmap_tpu_torch.geometry import rotation as rot
from colmap_tpu_torch.scene.types import Pose
from colmap_tpu_torch.sensor import models as camera_models
from colmap_tpu_torch.utils.dtypes import resolve_device


def synthetic_ba_problem(
    num_frames: int = 50,
    num_points: int = 2000,
    obs_per_point: int = 6,
    model_id: int = int(camera_models.CameraModelId.SIMPLE_RADIAL),
    pixel_noise: float = 0.5,
    pose_noise: float = 0.02,
    point_noise: float = 0.02,
    seed: int = 0,
    dtype=torch.float32,
    device=None,
):
    """Cameras on a sphere of radius 5 looking at unit-sphere points.

    Returns (problem, gt_problem, model_id) on ``device`` (default cuda).
    The data is made on the host in ``dtype`` and moved once.
    """
    device = resolve_device(device)
    rng = np.random.default_rng(seed)

    # Ground-truth scene.
    pts = rng.standard_normal((num_points, 3))
    pts /= np.linalg.norm(pts, axis=1, keepdims=True)
    pts *= rng.uniform(0.5, 1.0, (num_points, 1))

    view_dirs = rng.standard_normal((num_frames, 3))
    view_dirs /= np.linalg.norm(view_dirs, axis=1, keepdims=True)
    centers = 5.0 * view_dirs

    # cam_from_world: rotation taking -view_dir to +z.
    quats = np.zeros((num_frames, 4))
    for i in range(num_frames):
        a = -view_dirs[i]
        b = np.array([0.0, 0.0, 1.0])
        c = np.cross(a, b)
        w = 1.0 + float(a @ b)
        q = np.array([w, *c]) if w > 1e-8 else np.array([0.0, 1.0, 0.0, 0.0])
        quats[i] = q / np.linalg.norm(q)
    ts = np.zeros((num_frames, 3))
    for i in range(num_frames):
        ts[i] = Pose(quats[i], np.zeros(3)).apply(-centers[i][None])[0]

    if model_id == int(camera_models.CameraModelId.SIMPLE_RADIAL):
        params = np.array([[1280.0, 512.0, 384.0, 0.02]])
    elif model_id == int(camera_models.CameraModelId.PINHOLE):
        params = np.array([[1280.0, 1280.0, 512.0, 384.0]])
    else:
        params = camera_models.initialize_params(model_id, 1280.0, 1024, 768)[None]

    # Observations: each point seen by obs_per_point random frames.
    obs_point = np.repeat(np.arange(num_points), obs_per_point)
    obs_frame = rng.integers(0, num_frames, num_points * obs_per_point)
    obs_cam = np.zeros_like(obs_frame)

    def host(a, dt=dtype):
        return torch.as_tensor(np.asarray(a), dtype=dt)

    # Project with the GT state (in dtype, on the host) to get measurements.
    gt = BAProblem(
        quat=host(quats), t=host(ts), cam_params=host(params), points=host(pts),
        obs_frame=host(obs_frame, torch.int32), obs_cam=host(obs_cam, torch.int32),
        obs_point=host(obs_point, torch.int32),
        obs_xy=torch.zeros(len(obs_frame), 2, dtype=dtype),
        obs_w=torch.ones(len(obs_frame), dtype=dtype),
    )
    fr, pt = gt.obs_frame.long(), gt.obs_point.long()
    Xc = rot.quat_rotate(gt.quat[fr], gt.points[pt]) + gt.t[fr]
    xy, valid = camera_models.img_from_cam(model_id, gt.cam_params[0], Xc)
    xy_noisy = xy + host(rng.normal(0, pixel_noise, (len(obs_frame), 2)))
    gt = gt._replace(obs_xy=xy, obs_w=valid.to(dtype))

    # Noisy initial state.
    quats_n = quats + rng.normal(0, pose_noise * 0.2, quats.shape)
    quats_n /= np.linalg.norm(quats_n, axis=1, keepdims=True)
    ts_n = ts + rng.normal(0, pose_noise, ts.shape)
    pts_n = pts + rng.normal(0, point_noise, pts.shape)
    problem = gt._replace(quat=host(quats_n), t=host(ts_n), points=host(pts_n),
                          obs_xy=xy_noisy)
    to = lambda p: BAProblem(*(x.to(device) for x in p))  # noqa: E731
    return to(problem), to(gt), model_id
