"""Vectorized observation/point filtering.

Counterpart of colmap_tpu/sfm/filtering.py (reference behavior:
src/colmap/sfm/observation_manager.h:50-200, FilterPoints3D: reprojection
error, triangulation angle, negative depth). The per-observation math runs
in one launch of the CUDA kernel K9 (kernels/sfm.py) over (point x view)
arrays of up to 32 views per point.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from colmap_tpu_torch.kernels import sfm as K
from colmap_tpu_torch.scene.reconstruction import Reconstruction
from colmap_tpu_torch.sensor import models as camera_models
from colmap_tpu_torch.utils.dtypes import floatx


def filter_points3D(
    recon: Reconstruction,
    max_reproj_error: float,
    min_tri_angle_deg: float,
    point_ids: List[int] = None,
    max_views: int = 32,
    device=None,
) -> int:
    """Filter observations/points; returns the number of deleted observations.

    Drops observations with an error above the threshold or a non-positive
    depth; then points whose track fell below 2 or whose largest pairwise
    triangulation angle is below the minimum (the reference's semantics).
    """
    if point_ids is None:
        point_ids = list(recon.points3D.keys())
    point_ids = [p for p in point_ids if p in recon.points3D]
    if not point_ids:
        return 0
    model_ids = sorted({int(c.model_id) for c in recon.cameras.values()})
    if len(model_ids) != 1:
        raise NotImplementedError(
            f"the reconstruction mixes camera models {model_ids}; mixed models are not "
            "ported yet (ROADMAP queue 1)")
    model_id = model_ids[0]
    n_params = camera_models.model_num_params(model_id)

    P, V = len(point_ids), max_views
    quat = np.zeros((P, V, 4))
    quat[..., 0] = 1.0
    tvec = np.zeros((P, V, 3))
    params = np.zeros((P, V, n_params))
    params[..., 0] = 1.0
    xyz = np.zeros((P, 3))
    obs_xy = np.zeros((P, V, 2))
    valid = np.zeros((P, V), dtype=bool)
    track_refs = []
    pose_cache: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
    for i, pid in enumerate(point_ids):
        point = recon.points3D[pid]
        xyz[i] = point.xyz
        refs = []
        for v, el in enumerate(point.track[:V]):
            img = recon.images[el.image_id]
            if el.image_id not in pose_cache:
                pose = recon.cam_from_world(el.image_id)
                pose_cache[el.image_id] = (pose.quat, pose.t)
            quat[i, v], tvec[i, v] = pose_cache[el.image_id]
            params[i, v] = recon.cameras[img.camera_id].params
            obs_xy[i, v] = img.points2D_xy[el.point2D_idx]
            valid[i, v] = True
            refs.append(el)
        track_refs.append(refs)

    device = torch.device(device or "cuda")
    dt = floatx(device)

    def dev(a, dtype=dt):
        return torch.as_tensor(a, dtype=dtype).to(device)

    err, depth, min_cos = K.filter_points(model_id, dev(quat), dev(tvec), dev(params), dev(xyz),
                                          dev(obs_xy), dev(valid, torch.bool))
    err = err.double().cpu().numpy()
    depth = depth.double().cpu().numpy()
    max_angle = np.rad2deg(np.arccos(np.clip(min_cos.double().cpu().numpy(), -1, 1)))

    num_deleted = 0
    for i, pid in enumerate(point_ids):
        if pid not in recon.points3D:
            continue
        bad = [el for v, el in enumerate(track_refs[i])
               if depth[i, v] <= 0 or err[i, v] > max_reproj_error]
        for el in bad:
            if pid in recon.points3D:
                recon.delete_observation(el.image_id, el.point2D_idx)
                num_deleted += 1
        if pid not in recon.points3D:
            continue
        if len(recon.points3D[pid].track) < 2 or max_angle[i] < min_tri_angle_deg:
            num_deleted += len(recon.points3D[pid].track)
            recon.delete_point3D(pid)
    return num_deleted
