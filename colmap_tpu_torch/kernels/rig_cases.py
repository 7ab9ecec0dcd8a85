"""Inputs of the rig kernels (K24-K27) for the CPU tests, the card tests and
``chip_smoke.py``, made from a numpy seed.

``rig_ba_problem`` is the packed-BA headline problem of ``scene.synthetic_ba``
grouped into a rig: frames on a radius-5 sphere looking at points in the
unit ball, G sensors (sensor 0 the reference, the others turned about z and
offset by a baseline), one camera per sensor, each point seen by
``obs_per_point`` random (frame, sensor) pairs. ``gen_abs_case`` is one rig
frame's 2D-3D correspondences for the generalized absolute pose, with
outliers, and ``ransac_agreement`` the check K27 and its float64 plain
version are held to on injected samples. ``lm_step_inputs`` runs one rig LM
step up to K38 (the inputs of K34's set-up (c) and step, and of K38), and
``refine_case`` is a perturbed start for K40's refinement with the outliers
kept in. ``write_rig_config`` writes the ``rig_configurator`` JSON of a
synthetic scene's true rig. ``gen_rel_case`` is a pair of rig frames' 2D-2D
correspondences for the generalized relative pose (K48), with planted
outliers, and ``gen_rel_samples`` its injected 17-row samples.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from colmap_tpu_torch.estimators.bundle_adjustment_rig import RigBAProblem
from colmap_tpu_torch.geometry import rotation as rot
from colmap_tpu_torch.kernels.rig import GenAbsData, gen_abs_residuals
from colmap_tpu_torch.scene.types import Pose, SensorType
from colmap_tpu_torch.sensor import models as camera_models


def _look_at_origin(centers):
    """cam_from_world quaternions (n, 4) taking -centre to +z."""
    quats = np.zeros((len(centers), 4))
    for i, c in enumerate(centers):
        a = -c / np.linalg.norm(c)
        w = 1.0 + float(a[2])
        q = np.array([w, a[1], -a[0], 0.0]) if w > 1e-8 else np.array([0.0, 1.0, 0.0, 0.0])
        quats[i] = q / np.linalg.norm(q)
    return quats


def _params(model_id: int, num_cams: int):
    if model_id == int(camera_models.CameraModelId.SIMPLE_RADIAL):
        row = np.array([1280.0, 512.0, 384.0, 0.02])
    else:
        row = camera_models.initialize_params(model_id, 1280.0, 1024, 768)
        if len(row) > 4:  # small distortion so that the extra parameters are loaded
            row = row + np.r_[np.zeros(4), 1e-3 * np.arange(1, len(row) - 3)]
    return np.tile(row, (num_cams, 1))


def sensor_poses(num_sensors: int, rng, baseline: float = 0.1, yaw_deg: float = 10.0):
    """sensor_from_rig (G, 4), (G, 3): the reference sensor, then sensors
    turned about z and offset by about ``baseline``."""
    q = np.zeros((num_sensors, 4))
    q[0, 0] = 1.0
    t = np.zeros((num_sensors, 3))
    for g in range(1, num_sensors):
        ang = np.deg2rad(rng.uniform(-yaw_deg, yaw_deg))
        q[g] = [np.cos(ang / 2), 0.0, 0.0, np.sin(ang / 2)]
        t[g] = rng.normal(0.0, baseline, 3)
    return q, t


def rig_ba_problem(num_frames: int = 50, num_sensors: int = 4, num_points: int = 50000,
                   obs_per_point: int = 6,
                   model_id: int = int(camera_models.CameraModelId.SIMPLE_RADIAL),
                   pixel_noise: float = 0.5, pose_noise: float = 0.02,
                   sensor_noise: float = 0.01, point_noise: float = 0.02, seed: int = 0,
                   dtype=torch.float32, device="cpu"):
    """Returns (problem, gt, model_id) on ``device``: the noisy initial
    state with noisy measurements, and the true state with exact ones."""
    rng = np.random.default_rng(seed)
    pts = rng.standard_normal((num_points, 3))
    pts /= np.linalg.norm(pts, axis=1, keepdims=True)
    pts *= rng.uniform(0.5, 1.0, (num_points, 1))
    dirs = rng.standard_normal((num_frames, 3))
    centers = 5.0 * dirs / np.linalg.norm(dirs, axis=1, keepdims=True)
    quats = _look_at_origin(centers)
    ts = np.stack([Pose(q, np.zeros(3)).apply(-c[None])[0] for q, c in zip(quats, centers)])
    sq, st = sensor_poses(num_sensors, rng)
    params = _params(model_id, num_sensors)
    obs_point = np.repeat(np.arange(num_points), obs_per_point)
    O = len(obs_point)
    obs_frame = rng.integers(0, num_frames, O)
    obs_sensor = rng.integers(0, num_sensors, O)

    def host(a, dt=dtype):
        return torch.as_tensor(np.asarray(a), dtype=dt)

    ids = dict(obs_frame=host(obs_frame, torch.int32), obs_sensor=host(obs_sensor, torch.int32),
               obs_cam=host(obs_sensor, torch.int32), obs_point=host(obs_point, torch.int32))
    gt = RigBAProblem(quat=host(quats), t=host(ts), sensor_quat=host(sq), sensor_t=host(st),
                      cam_params=host(params), points=host(pts),
                      obs_xy=torch.zeros(O, 2, dtype=dtype), obs_w=torch.ones(O, dtype=dtype),
                      **ids)
    f, s, p = gt.obs_frame.long(), gt.obs_sensor.long(), gt.obs_point.long()
    Xc = rot.quat_rotate(gt.sensor_quat[s], rot.quat_rotate(gt.quat[f], gt.points[p]) + gt.t[f])
    Xc = Xc + gt.sensor_t[s]
    xy, valid = camera_models.img_from_cam(model_id, gt.cam_params[s], Xc)
    gt = gt._replace(obs_xy=xy, obs_w=valid.to(dtype))
    quats_n = quats + rng.normal(0, pose_noise * 0.2, quats.shape)
    sq_n = sq + np.r_[np.zeros((1, 4)), rng.normal(0, sensor_noise * 0.2, (num_sensors - 1, 4))]
    st_n = st + np.r_[np.zeros((1, 3)), rng.normal(0, sensor_noise, (num_sensors - 1, 3))]
    problem = gt._replace(
        quat=host(quats_n / np.linalg.norm(quats_n, axis=1, keepdims=True)),
        t=host(ts + rng.normal(0, pose_noise, ts.shape)),
        sensor_quat=host(sq_n / np.linalg.norm(sq_n, axis=1, keepdims=True)),
        sensor_t=host(st_n),
        points=host(pts + rng.normal(0, point_noise, pts.shape)),
        obs_xy=xy + host(rng.normal(0, pixel_noise, (O, 2))),
    )

    def to(prob):
        return RigBAProblem(*(x.to(device) for x in prob))

    return to(problem), to(gt), model_id


def with_empty_sensor(problem: RigBAProblem) -> RigBAProblem:
    """The problem with one more sensor row and one more camera row that no
    observation uses (a sensor held constant, a camera without images)."""
    p = problem
    return p._replace(
        sensor_quat=torch.cat([p.sensor_quat, p.sensor_quat[:1]]),
        sensor_t=torch.cat([p.sensor_t, p.sensor_t[:1] + 0.1]),
        cam_params=torch.cat([p.cam_params, p.cam_params[:1]]))


def gen_abs_case(n: int, num_cams: int = 4, outlier_ratio: float = 0.3, seed: int = 0,
                 world_scale: float = 1.0, baseline: float = 0.05, focal: float = 1280.0,
                 dtype=torch.float64, device="cpu"):
    """One rig frame's correspondences: ``n`` rows over ``num_cams`` cameras
    of a rig with baselines of about ``baseline`` (the synthetic generator's
    0.05 stddev) at distance 5 from points in the unit ball, the world
    shrunk by ``world_scale`` (a monocular model's arbitrary scale), and a
    share of the rows replaced by random observations. Returns (data,
    rig_from_world (3, 4) of the metric world, the true inlier mask)."""
    rng = np.random.default_rng(seed)
    sq, st = sensor_poses(num_cams, rng, baseline=baseline, yaw_deg=20.0)
    c = rng.standard_normal(3)
    c = 5.0 * c / np.linalg.norm(c)
    q = _look_at_origin(c[None])[0]
    R = rot.quat_to_rotmat(torch.as_tensor(q)).numpy()
    t = -R @ c
    cam = rng.integers(0, num_cams, n)
    X = rng.standard_normal((n, 3))
    X *= rng.uniform(0.2, 1.0, (n, 1)) / np.linalg.norm(X, axis=1, keepdims=True)
    Xr = X @ R.T + t
    cam_q, cam_t = sq[cam], st[cam]
    Xc = rot.quat_rotate(torch.as_tensor(cam_q), torch.as_tensor(Xr)).numpy() + cam_t
    uv = Xc[:, :2] / Xc[:, 2:]
    outlier = rng.random(n) < outlier_ratio
    uv[outlier] = rng.uniform(-0.3, 0.3, (int(outlier.sum()), 2))
    q_inv = rot.quat_conjugate(torch.as_tensor(cam_q))
    bearing = np.concatenate([uv, np.ones((n, 1))], 1)
    bearing /= np.linalg.norm(bearing, axis=1, keepdims=True)

    def dev(a):
        return torch.as_tensor(np.asarray(a, dtype=np.float64), dtype=dtype).to(device)

    centers = -rot.quat_rotate(q_inv, torch.as_tensor(cam_t)).numpy()
    dirs = rot.quat_rotate(q_inv, torch.as_tensor(bearing)).numpy()
    data = GenAbsData(dev(X / world_scale), dev(centers), dev(dirs), dev(uv), dev(cam_q),
                      dev(cam_t), dev(np.full(n, focal)),
                      torch.ones(n, dtype=torch.bool, device=device))
    return data, np.concatenate([R, t[:, None]], 1), ~outlier


def injected_samples(n: int, k: int, seed: int, inliers=None, device="cpu"):
    """(k, 6) int32 sample rows: half drawn from the true inliers (when
    given), the rest uniformly."""
    rng = np.random.default_rng(seed)
    s = rng.integers(0, n, (k, 6))
    if inliers is not None:
        idx = np.flatnonzero(inliers)
        s[: k // 2] = rng.choice(idx, (k // 2, 6))
    return torch.as_tensor(s, dtype=torch.int32).to(device)


def ransac_agreement(counts, best, models64, counts64, best64, data64: GenAbsData, max_sq,
                     margin: float = 1e-3):
    """How K27's batch agrees with its float64 plain version on the same
    samples. A row counts as near where its float64 residual lies within
    ``margin`` of the threshold (relative): the float32 scoring may put it on
    either side. Returns (count_ok, best_ok, near_max, tie): every model's
    count within its near rows of the float64 count; the same best index,
    or a near-tie between the two best models decided from the float64
    arithmetic (their float64 supports within the near rows of either)."""
    res = gen_abs_residuals(models64, data64)
    near = ((res - max_sq).abs() <= margin * max_sq) & data64.mask[None]
    near_n = near.sum(-1)
    finite = torch.isfinite(models64.flatten(1)).all(-1)
    near_n = torch.where(finite, near_n, 0)
    count_ok = bool(((counts.long() - counts64.long()).abs() <= near_n).all())
    (_, ik), (cp, ip) = best, best64
    tie = ip != ik and abs(int(counts64[ik]) - cp) <= int(near_n[ik]) + int(near_n[ip])
    best_ok = ik == ip or tie
    return count_ok, best_ok, int(near_n.max()), tie


def lm_step_inputs(problem: RigBAProblem, model_id, options, masks, lam, kernels):
    """One rig LM step's tensors up to K38, through ``kernels`` (rig.KERNELS
    or rig.PLAIN): K24's Jacobians, K25's reduction at ``lam`` (a 0-d tensor),
    PCG's step x (R, W) (K34, K26) and the point step dx (K26). Returns a
    dict with those and the observations and layout."""
    from colmap_tpu_torch.estimators import bundle_adjustment_rig as rba

    om, obs, layout = rba._obs_masks(masks, options), rba._obs(problem), rba._layout(problem)
    jac = kernels.obs_jacobians(*problem[:6], obs, *om, model_id, options.loss,
                                options.loss_scale)
    red = kernels.lm_reduce(jac, obs, layout, lam)
    x = rba._pcg(kernels, jac, obs, layout, red, options.pcg_iterations)
    dx = kernels.back_substitute(jac, obs, layout, red.Hpp_inv, red.gx, x)
    return dict(obs=obs, layout=layout, jac=jac, red=red, x=x, dx=dx)


def refine_case(n: int, seed: int, device="cpu", angle: float = 0.05, shift: float = 0.05):
    """K40's inputs on gen_abs_case's rig (float64, 30% outliers, all rows
    weighted 1, so the Cauchy loss meets the outliers): the rows (X, uv,
    cam_q, cam_t, focal, w_in), a start pose (q0, t0) turned by ``angle``
    rad and moved by ``shift`` from the truth, and the true (3, 4) pose."""
    data, Rt, _ = gen_abs_case(n, seed=seed, device=device)
    rng = np.random.default_rng(seed + 1)
    q_true = rot.rotmat_to_quat(torch.as_tensor(Rt[:, :3]))
    axis = rng.standard_normal(3)
    dq = rot.quat_from_axis_angle(torch.as_tensor(axis / np.linalg.norm(axis)), angle)
    q0 = rot.quat_multiply(dq, q_true).to(device)
    t0 = torch.as_tensor(Rt[:, 3] + shift * rng.standard_normal(3)).to(device)
    rows = (data.X, data.uv, data.cam_q, data.cam_t, data.focal,
            torch.ones(n, dtype=torch.float64, device=device))
    return rows, q0, t0, Rt


def write_rig_config(gt, path):
    """The rig_configurator JSON of a synthetic scene's first rig: one camera
    per image-name prefix (the generator names images
    camera<id>_frame<k>.png), its true sensor_from_rig for every camera but
    the reference."""
    rig = gt.rigs[min(gt.rigs)]
    cams = []
    for cid in sorted(gt.cameras):
        cc = {"image_prefix": f"camera{cid:06d}_"}
        sensor = (int(SensorType.CAMERA), cid)
        if rig.is_ref_sensor(sensor):
            cc["ref_sensor"] = True
        else:
            pose = rig.sensor_from_rig(sensor)
            cc["cam_from_rig_rotation"] = [float(v) for v in pose.quat]
            cc["cam_from_rig_translation"] = [float(v) for v in pose.t]
        cams.append(cc)
    with open(path, "w") as f:
        json.dump([{"cameras": cams}], f)


def gen_rel_case(n: int, num_cams: int = 4, outlier_ratio: float = 0.25, seed: int = 0,
                 sensors=None, baseline: float = 0.3, focal: float = 1280.0,
                 width: int = 1024, height: int = 768):
    """Two rig frames' correspondences for the generalized relative pose:
    ``n`` points 5-12 in front of rig 1 (tests/test_generalized_pose.py's
    scene), each seen by a random camera of each frame of a ``num_cams``
    rig (``sensors`` = (q, t) sensor_from_rig, or sensor_poses with
    ``baseline``), PINHOLE cameras of ``focal`` px; a share of the rows'
    second observations replaced by random pixels. Returns a dict with
    points2D1, points2D2 (n, 2) pixels, camera_idxs1, camera_idxs2,
    cams_from_rig (Poses), cameras, rel (rig2_from_rig1 Pose) and inliers
    (n,) bool."""
    from colmap_tpu_torch.scene.types import Camera

    rng = np.random.default_rng(seed)
    sq, st = sensors if sensors is not None else sensor_poses(num_cams, rng, baseline, 20.0)
    num_cams = len(sq)
    axis = rng.normal(size=3)
    axis /= np.linalg.norm(axis)
    ang = rng.uniform(0.05, 0.5)
    rel = Pose(np.concatenate([[np.cos(ang / 2)], np.sin(ang / 2) * axis]),
               rng.normal(size=3) * 0.8)
    cameras = [Camera(c, int(camera_models.CameraModelId.PINHOLE), width, height,
                      np.array([focal, focal, width / 2.0, height / 2.0]))
               for c in range(num_cams)]
    cams = [Pose(np.asarray(sq[c], dtype=np.float64), np.asarray(st[c], dtype=np.float64))
            for c in range(num_cams)]
    rows = []
    while sum(len(r[0]) for r in rows) < n:
        m = 2 * n
        X = np.concatenate([rng.uniform(-3, 3, (m, 2)), rng.uniform(5, 12, (m, 1))], 1)
        i1, i2 = rng.integers(0, num_cams, m), rng.integers(0, num_cams, m)
        X1 = np.stack([cams[c].apply(X[k:k + 1])[0] for k, c in enumerate(i1)])
        X2 = np.stack([cams[c].compose(rel).apply(X[k:k + 1])[0] for k, c in enumerate(i2)])
        ok = (X1[:, 2] > 0.5) & (X2[:, 2] > 0.5)
        rows.append((X1[ok], X2[ok], i1[ok], i2[ok]))
    X1, X2, i1, i2 = (np.concatenate(a)[:n] for a in zip(*rows))
    pp = np.array([width / 2.0, height / 2.0])
    p1 = X1[:, :2] / X1[:, 2:] * focal + pp
    p2 = X2[:, :2] / X2[:, 2:] * focal + pp
    outlier = rng.random(n) < outlier_ratio
    p2[outlier] = rng.uniform([0, 0], [width, height], (int(outlier.sum()), 2))
    return dict(points2D1=p1, points2D2=p2, camera_idxs1=i1, camera_idxs2=i2,
                cams_from_rig=cams, cameras=cameras, rel=rel, inliers=~outlier)


def gen_rel_samples(n: int, k: int, seed: int, inliers=None, device="cpu"):
    """(k, 17) int32 sample rows: half drawn from the true inliers (when
    given), the rest uniformly."""
    rng = np.random.default_rng(seed)
    s = rng.integers(0, n, (k, 17))
    if inliers is not None:
        s[: k // 2] = rng.choice(np.flatnonzero(inliers), (k // 2, 17))
    return torch.as_tensor(s, dtype=torch.int32).to(device)


def gen_rel_tensors(case, device, dtype):
    """GenRelData of a gen_rel_case on ``device``, observations in ``dtype``."""
    from colmap_tpu_torch.estimators.generalized_pose import gen_rel_data

    return gen_rel_data(case["points2D1"], case["points2D2"], case["camera_idxs1"],
                        case["camera_idxs2"], case["cams_from_rig"], case["cameras"], device,
                        dtype)


# A 17-row sample whose A^T A has a relative eigen gap (lambda_2 - lambda_1)
# / lambda_max below DEGENERATE_GAP has a two-dimensional nullspace in
# float64 (for example rows from too few camera pairs, an axial layout):
# every solver, colmap_tpu's eigh included, returns an arbitrary vector of
# it. Elsewhere two float64 eigensolvers agree within the Davis-Kahan bound
# SOLVE_EPS / gap on the eigenvector (SOLVE_EPS ~ 18 x 2 x float64 eps).
DEGENERATE_GAP, SOLVE_EPS = 1e-14, 4e-15


def g17_gaps(rays, samples):
    """The relative eigen gap of each sample's A^T A (K,), float64."""
    from colmap_tpu_torch.kernels.rig import _rays

    d1, m1, d2, m2 = _rays(rays[samples.long()].double())
    cE = torch.einsum("...ni,...nj->...nij", d2, d1).flatten(-2)
    cR = (torch.einsum("...ni,...nj->...nij", d2, m1)
          + torch.einsum("...ni,...nj->...nij", m2, d1)).flatten(-2)
    A = torch.cat([cE, cR], -1)
    w = torch.linalg.eigvalsh(A.transpose(-1, -2) @ A)
    return (w[:, 1] - w[:, 0]) / w[:, -1]


def gen_rel_agreement(counts, best, models, models64, counts64, best64, data64, samples,
                      max_sq, margin: float = 1e-3, tol: float = 1e-6):
    """How K48's batch agrees with its float64 plain version on the same
    samples, on the samples that are not degenerate: every count within its
    near rows (float64 residual within ``margin`` of the threshold) of the
    float64 count; the same best index, or a near-tie decided from the
    float64 arithmetic; each near-best model (90% of the best support)
    within ``tol`` + SOLVE_EPS / gap of the float64 model. Returns a dict
    with the checks, the largest model error and the degenerate count."""
    from colmap_tpu_torch.kernels.rig import gen_rel_residuals

    gap = g17_gaps(data64.rays, samples).to(counts64.device)
    ok = gap >= DEGENERATE_GAP
    res = gen_rel_residuals(models64, data64)
    near = ((res - max_sq).abs() <= margin * max_sq) & data64.mask[None]
    near_n = torch.where(torch.isfinite(models64.flatten(1)).all(-1), near.sum(-1), 0)
    diff = (counts.long() - counts64.long()).abs()
    count_ok = bool((diff <= near_n)[ok].all())
    (_, ik), (cp, ip) = best, best64
    tie = ip != ik and abs(int(counts64[ik]) - cp) <= int(near_n[ik]) + int(near_n[ip])
    full = (counts64 >= 0.9 * counts64[ok].max()) & ok
    err = (models.double() - models64.double()).abs().flatten(1).amax(1)
    model_ok = bool((err <= tol + SOLVE_EPS / gap)[full].all())
    return dict(count_ok=count_ok, best_ok=ik == ip or tie, model_ok=model_ok,
                near=int(near_n.max()), tie=tie, max_model_err=float(err[full].max()),
                near_best=int(full.sum()), degenerate=int((~ok).sum()),
                best_gap=float(gap[ip]))
