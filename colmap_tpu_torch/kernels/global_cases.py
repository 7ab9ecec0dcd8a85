"""Check cases of the global-SfM kernels K21-K23, made with numpy from a seed.

Each case function returns numpy arrays; the tests and chip_smoke.py hand the same
arrays to the kernels and to their plain versions (and, in the CPU tests, to
colmap_tpu). Sizes are the caller's: the card checks run them at the scale
global SfM users run (1DSfM-like view graphs), the tests at a few dozen
nodes.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from colmap_tpu_torch.estimators.rotation_averaging import _qmul


def random_quats(rng, n):
    q = rng.standard_normal((n, 4))
    return q / np.linalg.norm(q, axis=1, keepdims=True)


def quat_rotate(q, v):
    """Rotate (n, 3) vectors by (n, 4) unit quaternions, numpy."""
    w, u = q[:, :1], q[:, 1:]
    uv = np.cross(u, v)
    return v + 2.0 * (w * uv + np.cross(u, uv))


class RotationCase(NamedTuple):
    gt: np.ndarray  # (N, 4) cam_from_world
    edges: np.ndarray  # (E, 2)
    rel_quats: np.ndarray  # (E, 4) q_j = q_rel ⊗ q_i, noisy, some replaced
    outliers: np.ndarray  # (E,) bool


def rotation_case(num_nodes: int, num_edges: int, seed: int, noise_deg=2.0,
                  outlier_frac=0.05) -> RotationCase:
    """A ring over the nodes plus random pairs (num_edges in all); each
    relative rotation perturbed by a rotation of N(0, noise_deg) degrees
    about a random axis, and a share ``outlier_frac`` replaced by random
    rotations."""
    rng = np.random.default_rng(seed)
    gt = random_quats(rng, num_nodes)
    ring = np.stack([np.arange(num_nodes), (np.arange(num_nodes) + 1) % num_nodes], 1)
    extra = num_edges - num_nodes
    i = rng.integers(0, num_nodes, extra)
    j = (i + rng.integers(1, num_nodes, extra)) % num_nodes
    edges = np.concatenate([ring, np.stack([i, j], 1)]).astype(np.int32)
    E = len(edges)
    rel = np.stack([_qmul(gt[b], gt[a] * np.array([1.0, -1, -1, -1])) for a, b in edges])
    axis = rng.standard_normal((E, 3))
    axis /= np.linalg.norm(axis, axis=1, keepdims=True)
    ang = np.deg2rad(rng.normal(0.0, noise_deg, E))
    dq = np.concatenate([np.cos(ang / 2)[:, None], np.sin(ang / 2)[:, None] * axis], 1)
    rel = np.stack([_qmul(dq[k], rel[k]) for k in range(E)])
    outliers = rng.random(E) < outlier_frac
    rel[outliers] = random_quats(rng, int(outliers.sum()))
    rel /= np.linalg.norm(rel, axis=1, keepdims=True)
    return RotationCase(gt, edges, rel, outliers)


def gravity_of(gt, g_world=(0.0, 1.0, 0.0)):
    """Each camera's gravity direction R_i g_world, (N, 3)."""
    return quat_rotate(gt, np.broadcast_to(np.asarray(g_world, dtype=np.float64), (len(gt), 3)))


def rotation_errors_deg(est, gt):
    """Angle of gt_i⁻¹ ⊗ est_i against node 0's (the right-multiplied
    world gauge), degrees."""
    err = np.stack([_qmul(g * np.array([1.0, -1, -1, -1]), e) for g, e in zip(gt, est)])
    err /= np.linalg.norm(err, axis=1, keepdims=True)
    c = np.abs(err @ err[0])
    return np.rad2deg(2 * np.arccos(np.clip(c, 0.0, 1.0)))


class PositioningCase(NamedTuple):
    centers: np.ndarray  # (C, 3)
    points: np.ndarray  # (P, 3)
    obs_cam: np.ndarray  # (O,)
    obs_point: np.ndarray  # (O,)
    dirs: np.ndarray  # (O, 3) unit bearings, camera toward point


def positioning_case(num_cams: int, num_points: int, track: int, seed: int,
                     noise_rad=1e-3) -> PositioningCase:
    """Centres 10·N(0, 1), points 3·N(0, 1), each point seen by ``track``
    distinct cameras, bearings with N(0, noise_rad) angular noise."""
    rng = np.random.default_rng(seed)
    centers = 10.0 * rng.standard_normal((num_cams, 3))
    points = 3.0 * rng.standard_normal((num_points, 3))
    offs = rng.integers(1, num_cams, (num_points, track - 1))
    while True:  # redraw the rows that repeat a camera
        s = np.sort(offs, axis=1)
        bad = (s[:, 1:] == s[:, :-1]).any(1)
        if not bad.any():
            break
        offs[bad] = rng.integers(1, num_cams, (int(bad.sum()), track - 1))
    c0 = rng.integers(0, num_cams, num_points)
    cams = (c0[:, None] + np.concatenate([np.zeros((num_points, 1), np.int64), offs], 1))
    obs_cam = (cams % num_cams).reshape(-1).astype(np.int32)
    obs_point = np.repeat(np.arange(num_points), track).astype(np.int32)
    d = points[obs_point] - centers[obs_cam]
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d += noise_rad * rng.standard_normal(d.shape)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return PositioningCase(centers, points, obs_cam, obs_point, d)


def similarity_aligned(src, dst):
    """src mapped onto dst by the least-squares similarity (Umeyama)."""
    mu_s, mu_d = src.mean(0), dst.mean(0)
    xs, xd = src - mu_s, dst - mu_d
    U, S, Vt = np.linalg.svd(xd.T @ xs / len(src))
    D = np.eye(3)
    D[2, 2] = np.sign(np.linalg.det(U @ Vt))
    R = U @ D @ Vt
    s = np.trace(np.diag(S) @ D) / (xs ** 2).sum(1).mean()
    return s * xs @ R.T + mu_d


class CalibrationCase(NamedTuple):
    true_focals: np.ndarray  # (n,)
    priors: np.ndarray  # (n,)
    pps: np.ndarray  # (n, 2)
    e1: np.ndarray  # (E,)
    e2: np.ndarray  # (E,)
    Fs: np.ndarray  # (E, 3, 3)


def calibration_case(num_cams: int, num_edges: int, seed: int, prior_error=0.25) -> CalibrationCase:
    """Fundamental matrices of random relative poses (rotations of 0.2-0.6
    rad, unit translations) between random camera pairs; focals in
    [800, 1600] px, priors off by up to ``prior_error``."""
    rng = np.random.default_rng(seed)
    f = rng.uniform(800.0, 1600.0, num_cams)
    pps = np.stack([rng.uniform(350, 550, num_cams), rng.uniform(250, 400, num_cams)], 1)
    priors = f * (1.0 + rng.uniform(-prior_error, prior_error, num_cams))
    e1 = rng.integers(0, num_cams, num_edges).astype(np.int32)
    e2 = ((e1 + rng.integers(1, num_cams, num_edges)) % num_cams).astype(np.int32)
    Fs = []
    for a, b in zip(e1, e2):
        axis = rng.standard_normal(3)
        axis /= np.linalg.norm(axis)
        ang = rng.uniform(0.2, 0.6)
        q = np.concatenate([[np.cos(ang / 2)], np.sin(ang / 2) * axis])
        t = rng.standard_normal(3)
        t /= np.linalg.norm(t)
        w, x, y, z = q
        R = np.array([[1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
                      [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
                      [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]])
        E = np.array([[0, -t[2], t[1]], [t[2], 0, -t[0]], [-t[1], t[0], 0]]) @ R
        Ka = np.array([[f[a], 0, pps[a, 0]], [0, f[a], pps[a, 1]], [0, 0, 1.0]])
        Kb = np.array([[f[b], 0, pps[b, 0]], [0, f[b], pps[b, 1]], [0, 0, 1.0]])
        Fs.append(np.linalg.inv(Kb).T @ E @ np.linalg.inv(Ka))
    return CalibrationCase(f, priors, pps, e1, e2, np.stack(Fs))


def calibration_near_ties(graph, x, gap=1e-4):
    """(n,) bool: cameras on an edge whose (σ0 − σ1) / σ0 < gap at the
    log-scales x (float64), where the singular vectors, and with them the
    kernel's gradient terms, are not unique to float32's resolution."""
    from colmap_tpu_torch.kernels.global_sfm import calibration_matrices

    x = x.double()
    K1 = calibration_matrices(graph, x, graph.e1)
    K2 = calibration_matrices(graph, x, graph.e2)
    s = torch.linalg.svdvals(K2.transpose(-1, -2) @ graph.Fs @ K1)
    near = (s[:, 0] - s[:, 1]) / s[:, 0] < gap
    out = torch.zeros(graph.f0.shape[0], dtype=torch.bool, device=x.device)
    out[graph.e1[near].long()] = True
    out[graph.e2[near].long()] = True
    return out


def write_calibrator_database(path):
    """A database for ``view_graph_calibrator`` (colmap_tpu's
    tests/test_cli_tools3.py:118-160 with the port's classes): two PINHOLE
    cameras 25% off their true focals (800 and 1100 px), three images each,
    and an UNCALIBRATED F between every pair of images from random relative
    poses (seed 7). Returns the true focals, by camera."""
    from colmap_tpu_torch.geometry import rotation as rot
    from colmap_tpu_torch.geometry.essential import essential_from_pose
    from colmap_tpu_torch.scene.database import Database
    from colmap_tpu_torch.scene.types import Camera, TwoViewGeometry, TwoViewGeometryConfig

    rng = np.random.default_rng(7)
    db = Database(path)
    true_focals = [800.0, 1100.0]
    img_ids = []
    for k, f in enumerate(true_focals):
        cid = db.write_camera(Camera.create(k + 1, 1, f * 1.25, 800, 600))
        for j in range(3):
            img_ids.append((db.write_image(f"im{k}_{j}.png", cid), k))
    for iid, _ in img_ids:
        db.write_keypoints(iid, np.zeros((1, 4)))
    for a in range(len(img_ids)):
        for b in range(a + 1, len(img_ids)):
            (ia, ka), (ib, kb) = img_ids[a], img_ids[b]
            q = rot.quat_from_axis_angle(torch.as_tensor(rng.standard_normal(3)),
                                         rng.uniform(0.2, 0.6))
            t = rng.standard_normal(3)
            E = essential_from_pose(q, torch.as_tensor(t / np.linalg.norm(t))).numpy()
            Ka = np.array([[true_focals[ka], 0, 400], [0, true_focals[ka], 300], [0, 0, 1]])
            Kb = np.array([[true_focals[kb], 0, 400], [0, true_focals[kb], 300], [0, 0, 1]])
            db.write_two_view_geometry(ia, ib, TwoViewGeometry(
                config=int(TwoViewGeometryConfig.UNCALIBRATED),
                F=np.linalg.inv(Kb).T @ E @ np.linalg.inv(Ka),
                inlier_matches=np.zeros((20, 2), dtype=np.uint32)))
    db.commit()
    db.close()
    return {k + 1: f for k, f in enumerate(true_focals)}
