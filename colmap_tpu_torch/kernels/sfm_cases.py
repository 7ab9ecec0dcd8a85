"""Synthetic inputs for the mapper kernels K5-K9, made from a numpy seed.

Each case builds the tensors one kernel takes at the shapes the incremental
mapper gives it, with the hard parts in them: distortion (K5), outliers and
degenerate minimal samples (K6, K7), outlier views and two-view tracks (K8),
ragged tracks of 2-32 views and points behind a camera (K9). chip_smoke.py
and the card tests hold each kernel against its plain version on them.
Arrays are made in float64 with numpy and handed over at the requested
dtype and device, so the kernel and its plain version see the same inputs.
"""

from __future__ import annotations

import numpy as np
import torch

from colmap_tpu_torch.geometry import rotation as rot
from colmap_tpu_torch.sensor import models as camera_models

# The camera of the mapper scenes: SIMPLE_RADIAL, 1024 x 768, f = 1280.
FOCAL = 1280.0
WIDTH, HEIGHT = 1024, 768


def _t(a, device, dtype=torch.float32):
    return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype).to(device)


def _rotation(rng, max_angle=np.pi):
    axis = rng.normal(size=3)
    axis /= np.linalg.norm(axis)
    a = rng.uniform(-max_angle, max_angle)
    K = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]])
    return np.eye(3) + np.sin(a) * K + (1 - np.cos(a)) * K @ K


def _look_at(center, target=np.zeros(3)):
    """cam_from_world (R, t) of a camera at ``center`` looking at ``target``."""
    fwd = target - center
    fwd /= np.linalg.norm(fwd)
    right = np.cross(fwd, [0.0, 1.0, 0.0])
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)
    R = np.stack([right, down, fwd])
    return R, -R @ center


def _quat(R):
    return rot.rotmat_to_quat(torch.from_numpy(R)).numpy()


def camera_params(model_id):
    """Parameters of model ``model_id`` with distortion where it has some."""
    p = camera_models.initialize_params(model_id, FOCAL, WIDTH, HEIGHT)
    extra = {2: [0.05], 3: [0.05, -0.02], 4: [0.05, -0.02, 0.001, -0.002]}.get(int(model_id), [])
    for i, v in zip(camera_models.extra_params_idxs(model_id), extra):
        p[i] = v
    return p


def camera_map_case(model_id, n, seed, device):
    """K5: params (P,), camera-frame points uvw (n, 3) in front of the
    camera, pixels xy (n, 2) inside the image."""
    rng = np.random.default_rng(seed)
    uvw = np.stack([rng.uniform(-0.4, 0.4, n), rng.uniform(-0.3, 0.3, n),
                    rng.uniform(0.5, 3.0, n)], axis=1)
    uvw[:, :2] *= uvw[:, 2:]
    xy = np.stack([rng.uniform(0, WIDTH, n), rng.uniform(0, HEIGHT, n)], axis=1)
    return _t(camera_params(model_id), device), _t(uvw, device), _t(xy, device)


def p3p_case(n, k, seed, device, outliers=0.3):
    """K6: X, rays (n, 3), uv (n, 2), mask (n,), samples (k, 3) int32 and
    max_sq (12 px at f = 1280, squared). A fraction ``outliers`` of the rows
    observe a random point; the last 3 rows are padding; samples 0 and 1
    repeat a row (degenerate)."""
    rng = np.random.default_rng(seed)
    R = _rotation(rng)
    t = np.array([0.1, -0.2, 5.0])
    X = rng.uniform(-1.5, 1.5, (n, 3))
    Xc = X @ R.T + t
    uv = Xc[:, :2] / Xc[:, 2:]
    bad = rng.random(n) < outliers
    uv[bad] = rng.uniform(-0.4, 0.4, (int(bad.sum()), 2))
    rays = np.concatenate([uv, np.ones((n, 1))], axis=1)
    rays /= np.linalg.norm(rays, axis=1, keepdims=True)
    mask = np.ones(n, dtype=bool)
    mask[-3:] = False
    samples = rng.integers(0, n - 3, (k, 3))
    samples[0] = [5, 5, 5]
    samples[1] = [1, 2, 1]
    return dict(X=_t(X, device), rays=_t(rays, device), uv=_t(uv, device),
                mask=_t(mask, device, torch.bool), samples=_t(samples, device, torch.int32),
                max_sq=(12.0 / FOCAL) ** 2, R=R, t=t)


def essential_case(n, k, seed, device, outliers=0.3):
    """K7: normalized matches x1, x2 (n, 2), mask (n,), samples (k, 5) int32
    and max_sq (4 px at f = 1280, squared). A fraction ``outliers`` of the
    matches are random; samples 0 and 1 repeat a row (degenerate)."""
    rng = np.random.default_rng(seed)
    R1, t1 = _look_at(np.array([0.0, 0.0, -5.0]))
    R2, t2 = _look_at(np.array([1.5, 0.3, -4.8]))
    X = rng.uniform(-1.0, 1.0, (n, 3))
    x1 = X @ R1.T + t1
    x2 = X @ R2.T + t2
    x1 = x1[:, :2] / x1[:, 2:]
    x2 = x2[:, :2] / x2[:, 2:]
    bad = rng.random(n) < outliers
    x2[bad] = rng.uniform(-0.3, 0.3, (int(bad.sum()), 2))
    samples = rng.integers(0, n, (k, 5))
    samples[0] = [3, 3, 3, 3, 3]
    samples[1] = [0, 1, 2, 3, 0]
    return dict(x1=_t(x1, device), x2=_t(x2, device), mask=_t(np.ones(n, bool), device, torch.bool),
                samples=_t(samples, device, torch.int32), max_sq=(4.0 / FOCAL) ** 2)


def tracks_case(b, seed, device, views=8):
    """K8: R (b, 8, 3, 3), t (b, 8, 3), x (b, 8, 2), mask (b, 8) for tracks
    of 2-8 views of cameras on a sphere of radius 5; a fifth of the tracks
    have one outlier view (0.05 off) and a tenth have two views only."""
    rng = np.random.default_rng(seed)
    cams = []
    for _ in range(40):
        c = rng.normal(size=3)
        cams.append(_look_at(5.0 * c / np.linalg.norm(c)))
    R = np.zeros((b, views, 3, 3))
    R[:] = np.eye(3)
    t = np.zeros((b, views, 3))
    x = np.zeros((b, views, 2))
    mask = np.zeros((b, views), dtype=bool)
    for i in range(b):
        X = rng.uniform(-1, 1, 3)
        nv = 2 if rng.random() < 0.1 else int(rng.integers(3, views + 1))
        for v, c in enumerate(rng.choice(len(cams), nv, replace=False)):
            Rc, tc = cams[c]
            Xc = Rc @ X + tc
            R[i, v], t[i, v], x[i, v], mask[i, v] = Rc, tc, Xc[:2] / Xc[2], True
        if nv > 2 and rng.random() < 0.2:
            x[i, int(rng.integers(nv))] += 0.05
    return dict(R=_t(R, device), t=_t(t, device), x=_t(x, device),
                mask=_t(mask, device, torch.bool), min_angle=np.deg2rad(1.5),
                max_err=np.deg2rad(2.0))


def filter_case(p, seed, device, model_id=2, views=32):
    """K9: quat/t (p, 32, 4/3), params (p, 32, P), xyz (p, 3), obs_xy
    (p, 32, 2), valid (p, 32) for points seen by 2-32 of 40 cameras around
    them, with 0.5 px noise, a twentieth of the observations 10 px off and a
    fiftieth of the slots given a camera turned away (negative depth)."""
    rng = np.random.default_rng(seed)
    params = camera_params(model_id)
    cams = []
    for i in range(40):
        a = 2 * np.pi * i / 40
        cams.append(_look_at(np.array([5 * np.cos(a), 0.5 * np.sin(3 * a), 5 * np.sin(a)])))
    flip = np.diag([-1.0, 1.0, -1.0])
    quat = np.zeros((p, views, 4))
    quat[..., 0] = 1.0
    tvec = np.zeros((p, views, 3))
    prm = np.zeros((p, views, len(params)))
    prm[..., 0] = 1.0
    xyz = rng.uniform(-1, 1, (p, 3))
    obs = np.zeros((p, views, 2))
    valid = np.zeros((p, views), dtype=bool)
    for i in range(p):
        nv = int(rng.integers(2, views + 1))
        for v, c in enumerate(rng.choice(len(cams), nv, replace=False)):
            Rc, tc = cams[c]
            if rng.random() < 0.02:
                Rc, tc = flip @ Rc, flip @ tc
            xy, _ = camera_models.img_from_cam(model_id, torch.from_numpy(params),
                                               torch.from_numpy(Rc @ xyz[i] + tc),
                                               check_cheirality=False)
            noise = 10.0 if rng.random() < 0.05 else 0.5
            quat[i, v], tvec[i, v], prm[i, v] = _quat(Rc), tc, params
            obs[i, v] = xy.numpy() + rng.normal(0, noise, 2)
            valid[i, v] = True
    return dict(quat=_t(quat, device), t=_t(tvec, device), cam_params=_t(prm, device),
                xyz=_t(xyz, device), obs_xy=_t(obs, device), valid=_t(valid, device, torch.bool))


def as_double(case):
    """The case with its float tensors in float64 (the plain reference)."""
    return {k: (v.double() if torch.is_tensor(v) and v.is_floating_point() else v)
            for k, v in case.items()}
