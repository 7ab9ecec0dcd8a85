"""Synthetic inputs for K34's step, K36 and K37, made from a numpy seed.

Each case builds the tensors one kernel takes at the shapes the mapper
gives it: a PCG state of F frames and CP camera entries, two-view problems
in CSR order (the initial pair's seeds, the pose graph's edges) with noise,
outliers and padded rows, and structure-less
registration problems (a new camera against registered ones) with injected
samples. chip_smoke.py and the card tests hold each kernel against its plain
version on them. Arrays are made in float64 with numpy and handed over at
the requested dtype and device, so the kernel and its plain version see the
same inputs.
"""

from __future__ import annotations

import numpy as np
import torch

from colmap_tpu_torch.kernels.sfm_cases import _quat, _rotation, _t
from colmap_tpu_torch.kernels.solver import PCGState


def _skew(v):
    return np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]])


def pcg_vectors(F, CP, damped, seed, device):
    """A K34 step's inputs: the state (M of inverted SPD 6x6 blocks and
    positive camera entries; x, r, p; z = M r and rz = r.z), Ap = (a
    positive diagonal) p + noise as (F, 6) and (CP, 1), and the damping
    (lam 1e-3, diag_pose (F, 6), diag_cam (CP, 1)), or three None where
    undamped (the rig's step). float32 vectors, rz float64."""
    rng = np.random.default_rng(seed)
    n = 6 * F + CP
    G = rng.standard_normal((F, 6, 6))
    blocks = np.linalg.inv(G @ G.transpose(0, 2, 1) + np.eye(6))
    M = np.concatenate([blocks.reshape(-1), rng.uniform(0.5, 2.0, CP)])
    r, p = rng.standard_normal(n), rng.standard_normal(n)
    z = np.concatenate([(blocks @ r[:6 * F].reshape(F, 6, 1)).reshape(-1), M[36 * F:] * r[6 * F:]])
    Ap = rng.uniform(0.5, 2.0, n) * p + 0.1 * rng.standard_normal(n)
    st = PCGState(_t(M, device), _t(rng.standard_normal(n), device), _t(r, device),
                  _t(z, device), _t(p, device), _t([float(r @ z)], device, torch.float64))
    damping = ((torch.tensor(1e-3, device=device), _t(rng.uniform(0.5, 2.0, (F, 6)), device),
                _t(rng.uniform(0.5, 2.0, (CP, 1)), device)) if damped else (None, None, None))
    Ap = (_t(Ap[:6 * F].reshape(F, 6), device), _t(Ap[6 * F:].reshape(CP, 1), device))
    return st, Ap, damping


def relative_pose_case(sizes, seed, device, noise=1e-3, outliers=0.1, dtype=torch.float32):
    """Two-view problems with len(sizes) pairs of sizes[k] rows in CSR order:
    normalized points of a random relative pose (rotation up to 0.3 rad, a
    unit baseline in any direction) with ``noise`` and a share of outlier
    rows, the last 5% of each pair masked out. Also a start for the
    refinement per pair (the true pose, rotated by 0.01 rad, its
    translation moved by 0.05) and inlier weights (1 on inliers, 0 on
    outliers). Returns a dict of tensors and ``offsets`` (a list)."""
    rng = np.random.default_rng(seed)
    x1s, x2s, masks, ws, Es, qs, ts = [], [], [], [], [], [], []
    for n in sizes:
        R = _rotation(rng, 0.3)
        t = rng.normal(size=3)
        t /= np.linalg.norm(t)
        X = rng.uniform(-1, 1, (n, 3)) + np.array([0, 0, 6.0])
        x1 = X[:, :2] / X[:, 2:]
        X2 = X @ R.T + t
        x2 = X2[:, :2] / X2[:, 2:] + noise * rng.normal(size=(n, 2))
        bad = rng.random(n) < outliers
        x2[bad] = rng.uniform(-0.2, 0.2, (bad.sum(), 2))
        mask = np.arange(n) < n - max(1, n // 20)
        x1s.append(x1)
        x2s.append(x2)
        masks.append(mask)
        ws.append((~bad).astype(np.float64))
        Es.append(_skew(t) @ R)
        qs.append(_quat(_rotation(rng, 0.01) @ R))
        ts.append(t + 0.05 * rng.normal(size=3))
    offsets = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64).tolist()
    return dict(E=_t(np.stack(Es), device, dtype), x1=_t(np.concatenate(x1s), device, dtype),
                x2=_t(np.concatenate(x2s), device, dtype),
                mask=torch.as_tensor(np.concatenate(masks)).to(device),
                weights=_t(np.concatenate(ws), device, dtype), q0=_t(np.stack(qs), device, dtype),
                t0=_t(np.stack(ts), device, dtype), offsets=offsets)


def structure_less_case(n, num_cams, k, seed, device, outliers=0.2, dtype=torch.float32):
    """Structure-less registration: a new camera (f = 1280 px, 1024 x 768)
    seeing n points, each matched to one of ``num_cams`` registered cameras around
    it, 0.5 px of noise and a share of outlier rows; and k injected samples
    (a camera with at least five rows, five of its inlier rows, a scale row
    on another camera; the first k / 8 scale rows on the sample's own
    camera, which the model rejects). Returns a dict of tensors: uv, uv_w
    (n, 2) normalized, cam_idx (n,) int32, Rw (C, 3, 3), tw (C, 3), focal
    (n,), cams (k,), idx5 (k, 5), r1 (k,) int32."""
    rng = np.random.default_rng(seed)
    f = 1280.0
    # Points at depth 5-7 over the field of view of a 1024 x 768 image at f.
    X = rng.uniform([-2.4, -1.8, 5.0], [2.4, 1.8, 7.0], (n, 3))

    def pose(i):
        R = _rotation(rng, 0.2)
        c = rng.normal(0, 0.6, 3)
        return R, -R @ c

    world = [pose(i) for i in range(num_cams)]
    Rn, tn = pose(-1)

    def project(R, t):
        P = X @ R.T + t
        return P[:, :2] / P[:, 2:]

    cam_idx = rng.integers(0, num_cams, n)
    uv = project(Rn, tn) + rng.normal(0, 0.5 / f, (n, 2))
    bad = rng.random(n) < outliers
    uv[bad] = rng.uniform(-0.3, 0.3, (bad.sum(), 2))
    proj_w = [project(R, t) for R, t in world]
    uv_w = np.stack([proj_w[c][i] for i, c in enumerate(cam_idx)])
    cams = rng.integers(0, num_cams, k)
    idx5 = np.stack([rng.choice(np.flatnonzero((cam_idx == c) & ~bad), 5, replace=False)
                     for c in cams])
    r1 = np.array([rng.choice(np.flatnonzero((cam_idx != c) & ~bad)) for c in cams])
    r1[: k // 8] = idx5[: k // 8, 0]
    i32 = torch.int32
    return dict(uv=_t(uv, device, dtype), uv_w=_t(uv_w, device, dtype),
                cam_idx=_t(cam_idx, device, i32),
                Rw=_t(np.stack([R for R, _ in world]), device, dtype),
                tw=_t(np.stack([t for _, t in world]), device, dtype),
                focal=_t(np.full(n, f), device, dtype), cams=_t(cams, device, i32),
                idx5=_t(idx5, device, i32), r1=_t(r1, device, i32))


STRUCTURE_LESS_ARGS = ("uv", "uv_w", "cam_idx", "Rw", "tw", "focal")
SAMPLE_ARGS = ("cams", "idx5", "r1")


def as_double(case):
    """The case with its floating tensors in float64 (the plain versions'
    reference on the same inputs)."""
    return {k: (v.double() if torch.is_tensor(v) and v.is_floating_point() else v)
            for k, v in case.items()}
