"""Build BAProblem and RigBAProblem tensors from a Reconstruction and write
results back.

Counterpart of colmap_tpu/estimators/ba_setup.py for single-model problems
(reference behavior: CreateDefaultBundleAdjuster + BundleAdjustmentConfig,
estimators/bundle_adjustment.h:46-233). colmap_tpu pads the counts to powers
of two to reuse compiled programs; PyTorch compiles nothing, so the port
packs the exact sizes.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from colmap_tpu_torch.estimators.bundle_adjustment import BAProblem
from colmap_tpu_torch.scene.reconstruction import Reconstruction
from colmap_tpu_torch.scene.types import INVALID_POINT3D, Pose, SensorType
from colmap_tpu_torch.utils.dtypes import floatx, resolve_device


def problem_from_reconstruction(
    recon: Reconstruction,
    image_ids: Optional[List[int]] = None,
    point_ids: Optional[List[int]] = None,
    dtype=None,
    device=None,
) -> Tuple[BAProblem, Dict]:
    """Pack (a subset of) a reconstruction into BAProblem tensors on ``device``.

    Only observations where both the image and the 3D point are selected are
    included. Returns (problem, index) where index maps rows back to ids:
    {"image_ids", "camera_ids", "point_ids", "model_id"}. ``dtype`` defaults
    to floatx(device).
    """
    device = resolve_device(device)
    dtype = dtype or floatx(device)
    if image_ids is None:
        image_ids = recon.reg_image_ids()
    image_ids = list(image_ids)
    img_row = {iid: i for i, iid in enumerate(image_ids)}

    camera_ids = sorted({recon.images[i].camera_id for i in image_ids})
    cam_row = {cid: i for i, cid in enumerate(camera_ids)}
    model_ids = sorted({int(recon.cameras[c].model_id) for c in camera_ids})
    if len(model_ids) != 1:
        raise NotImplementedError(
            f"the reconstruction mixes camera models {model_ids}; problems with "
            "mixed models are not ported yet (colmap_tpu handles them)"
        )
    model_id = model_ids[0]
    cam_params = np.stack([recon.cameras[c].params for c in camera_ids])

    if point_ids is None:
        pid_set = set()
        for iid in image_ids:
            for pid in recon.images[iid].points2D_p3d:
                if pid != INVALID_POINT3D:
                    pid_set.add(int(pid))
        point_ids = sorted(pid_set)
    point_ids = list(point_ids)
    pt_row = {pid: i for i, pid in enumerate(point_ids)}

    quat = np.stack([recon.cam_from_world(i).quat for i in image_ids])
    t = np.stack([recon.cam_from_world(i).t for i in image_ids])
    points = (np.stack([recon.points3D[p].xyz for p in point_ids])
              if point_ids else np.zeros((0, 3)))

    obs_frame, obs_cam, obs_point, obs_xy = [], [], [], []
    for iid in image_ids:
        image = recon.images[iid]
        fi = img_row[iid]
        ci = cam_row[image.camera_id]
        for p2d_idx, pid in enumerate(image.points2D_p3d):
            if pid == INVALID_POINT3D or int(pid) not in pt_row:
                continue
            obs_frame.append(fi)
            obs_cam.append(ci)
            obs_point.append(pt_row[int(pid)])
            obs_xy.append(image.points2D_xy[p2d_idx])
    n_obs = len(obs_frame)

    def dev(a, dt=dtype):
        return torch.as_tensor(np.asarray(a), dtype=dt).to(device)

    problem = BAProblem(
        quat=dev(quat),
        t=dev(t),
        cam_params=dev(cam_params),
        points=dev(points),
        obs_frame=dev(np.asarray(obs_frame, np.int32), torch.int32),
        obs_cam=dev(np.asarray(obs_cam, np.int32), torch.int32),
        obs_point=dev(np.asarray(obs_point, np.int32), torch.int32),
        obs_xy=dev(np.asarray(obs_xy, np.float64).reshape(n_obs, 2)),
        obs_w=dev(np.ones(n_obs)),
    )
    index = {
        "image_ids": image_ids,
        "camera_ids": camera_ids,
        "point_ids": point_ids,
        "model_id": int(model_id),
    }
    return problem, index


def update_reconstruction(recon: Reconstruction, problem: BAProblem, index: Dict):
    """Write optimized poses / intrinsics / points back into the scene."""
    quat = problem.quat.double().cpu().numpy()
    t = problem.t.double().cpu().numpy()
    cam_params = problem.cam_params.double().cpu().numpy()
    pts = problem.points.double().cpu().numpy()
    for row, iid in enumerate(index["image_ids"]):
        recon.set_cam_from_world(iid, Pose(quat[row], t[row]).normalize())
    for row, cid in enumerate(index["camera_ids"]):
        n = len(recon.cameras[cid].params)
        recon.cameras[cid].params = cam_params[row][:n].copy()
    for row, pid in enumerate(index["point_ids"]):
        recon.points3D[pid].xyz = pts[row].copy()


def rig_problem_from_reconstruction(
    recon: Reconstruction,
    frame_ids: Optional[List[int]] = None,
    point_ids: Optional[List[int]] = None,
    dtype=None,
    device=None,
):
    """Pack a reconstruction with rigs into RigBAProblem tensors on ``device``.

    Frames carry rig_from_world; each (rig_id, sensor) pair of the selected
    frames gets one sensor_from_rig row (reference sensors are identity and
    held constant by default_masks). Returns (problem, index) with index keys
    frame_ids, sensor_keys [(rig_id, sensor)], camera_ids, point_ids,
    model_id, ref_sensor_rows (colmap_tpu's rig_problem_from_reconstruction).
    """
    from colmap_tpu_torch.estimators.bundle_adjustment_rig import RigBAProblem

    device = resolve_device(device)
    dtype = dtype or floatx(device)
    if frame_ids is None:
        frame_ids = recon.reg_frame_ids()
    frame_ids = list(frame_ids)
    frame_row = {fid: i for i, fid in enumerate(frame_ids)}

    sensor_keys: List[Tuple[int, Tuple[int, int]]] = []
    sensor_row: Dict[Tuple[int, Tuple[int, int]], int] = {}
    ref_rows: List[int] = []
    image_rows = []  # (image_id, frame row, sensor row, camera_id)
    for fid in frame_ids:
        frame = recon.frames[fid]
        rig = recon.rigs[frame.rig_id]
        for iid in frame.image_ids():
            image = recon.images[iid]
            sensor = (int(SensorType.CAMERA), image.camera_id)
            key = (frame.rig_id, sensor)
            if key not in sensor_row:
                sensor_row[key] = len(sensor_keys)
                sensor_keys.append(key)
                if rig.is_ref_sensor(sensor):
                    ref_rows.append(sensor_row[key])
            image_rows.append((iid, frame_row[fid], sensor_row[key], image.camera_id))

    camera_ids = sorted({c for (_, _, _, c) in image_rows})
    cam_row = {cid: i for i, cid in enumerate(camera_ids)}
    model_ids = sorted({int(recon.cameras[c].model_id) for c in camera_ids})
    if len(model_ids) != 1:
        raise NotImplementedError(
            f"the rig problem mixes camera models {model_ids}; problems with mixed models "
            "are not ported yet (colmap_tpu handles them)")
    cam_params = np.stack([recon.cameras[c].params for c in camera_ids])

    if point_ids is None:
        pid_set = set()
        for (iid, _, _, _) in image_rows:
            for pid in recon.images[iid].points2D_p3d:
                if pid != INVALID_POINT3D:
                    pid_set.add(int(pid))
        point_ids = sorted(pid_set)
    point_ids = list(point_ids)
    pt_row = {pid: i for i, pid in enumerate(point_ids)}

    sensor_poses = [recon.rigs[rig_id].sensor_from_rig(sensor) for rig_id, sensor in sensor_keys]
    points = (np.stack([recon.points3D[p].xyz for p in point_ids])
              if point_ids else np.zeros((0, 3)))
    obs_frame, obs_sensor, obs_cam, obs_point, obs_xy = [], [], [], [], []
    for (iid, fr, sr, cid) in image_rows:
        image = recon.images[iid]
        for p2d_idx, pid in enumerate(image.points2D_p3d):
            if pid == INVALID_POINT3D or int(pid) not in pt_row:
                continue
            obs_frame.append(fr)
            obs_sensor.append(sr)
            obs_cam.append(cam_row[cid])
            obs_point.append(pt_row[int(pid)])
            obs_xy.append(image.points2D_xy[p2d_idx])
    n_obs = len(obs_frame)

    def dev(a, dt=dtype):
        return torch.as_tensor(np.asarray(a), dtype=dt).to(device)

    def ids(a):
        return dev(np.asarray(a, np.int32), torch.int32)

    problem = RigBAProblem(
        quat=dev(np.stack([recon.frames[f].rig_from_world.quat for f in frame_ids])),
        t=dev(np.stack([recon.frames[f].rig_from_world.t for f in frame_ids])),
        sensor_quat=dev(np.stack([p.quat for p in sensor_poses])),
        sensor_t=dev(np.stack([p.t for p in sensor_poses])),
        cam_params=dev(cam_params),
        points=dev(points),
        obs_frame=ids(obs_frame),
        obs_sensor=ids(obs_sensor),
        obs_cam=ids(obs_cam),
        obs_point=ids(obs_point),
        obs_xy=dev(np.asarray(obs_xy, np.float64).reshape(n_obs, 2)),
        obs_w=dev(np.ones(n_obs)),
    )
    index = {
        "frame_ids": frame_ids,
        "sensor_keys": sensor_keys,
        "camera_ids": camera_ids,
        "point_ids": point_ids,
        "model_id": int(model_ids[0]),
        "ref_sensor_rows": ref_rows,
    }
    return problem, index


def update_reconstruction_rig(recon: Reconstruction, problem, index: Dict):
    """Write rig BA results back: frame poses, sensor_from_rig of the
    non-reference sensors, intrinsics, points."""
    quat = problem.quat.double().cpu().numpy()
    t = problem.t.double().cpu().numpy()
    squat = problem.sensor_quat.double().cpu().numpy()
    st = problem.sensor_t.double().cpu().numpy()
    cam_params = problem.cam_params.double().cpu().numpy()
    pts = problem.points.double().cpu().numpy()
    for row, fid in enumerate(index["frame_ids"]):
        recon.frames[fid].rig_from_world = Pose(quat[row], t[row]).normalize()
    for row, (rig_id, sensor) in enumerate(index["sensor_keys"]):
        rig = recon.rigs[rig_id]
        if not rig.is_ref_sensor(sensor):
            rig.sensors[tuple(sensor)] = Pose(squat[row], st[row]).normalize()
    for row, cid in enumerate(index["camera_ids"]):
        n = len(recon.cameras[cid].params)
        recon.cameras[cid].params = cam_params[row][:n].copy()
    for row, pid in enumerate(index["point_ids"]):
        recon.points3D[pid].xyz = pts[row].copy()
