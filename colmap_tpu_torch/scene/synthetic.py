"""Synthetic dataset generator — the cornerstone of end-to-end testing.

Counterpart of colmap_tpu/scene/synthetic.py (reference behavior:
src/colmap/scene/synthetic.{h,cc}, options :41-110); the same numpy seed
writes the same database and ground truth. Projection runs in float64 torch
on the CPU.
Generates a geometrically consistent reconstruction (points on the unit
sphere, cameras on a radius-5 sphere looking at the origin, optional
multi-camera rigs) and optionally fills a database with keypoints,
descriptors, matches (EXHAUSTIVE / CHAINED / SPARSE topologies), outliers
and two-view geometries so that mapper pipelines can be validated against
known ground truth without any real images.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional

import numpy as np

from colmap_tpu_torch.scene.database import Database
from colmap_tpu_torch.scene.reconstruction import Reconstruction
from colmap_tpu_torch.scene.types import (
    Camera,
    Frame,
    Image,
    Pose,
    Rig,
    TrackElement,
    TwoViewGeometry,
    TwoViewGeometryConfig,
)
from colmap_tpu_torch.sensor import models as camera_models
from colmap_tpu_torch.utils.types import SensorType, image_pair_to_pair_id, pair_id_to_image_pair


class MatchConfig(enum.IntEnum):
    EXHAUSTIVE = 1
    CHAINED = 2
    SPARSE = 3


@dataclasses.dataclass
class SyntheticDatasetOptions:
    num_rigs: int = 2
    num_cameras_per_rig: int = 1
    num_frames_per_rig: int = 5
    num_points3D: int = 100
    track_length: int = -1
    sensor_from_rig_translation_stddev: float = 0.05
    sensor_from_rig_rotation_stddev: float = 5.0  # degrees, around z
    camera_width: int = 1024
    camera_height: int = 768
    camera_model_id: int = int(camera_models.CameraModelId.SIMPLE_RADIAL)
    camera_params: tuple = (1280.0, 512.0, 384.0, 0.05)
    camera_has_prior_focal_length: bool = False
    # Heterogeneous datasets: when set, rig r uses camera_model_ids[r %
    # len] with camera_params_list[r % len] (reference synthetic datasets
    # are single-model; mixed-model scenes exercise the per-problem model
    # mixing of bundle_adjustment_ceres.h:40-116).
    camera_model_ids: Optional[tuple] = None
    camera_params_list: Optional[tuple] = None
    num_points2D_without_point3D: int = 10
    # Gaussian noise on the 2D observations written to the database
    # (reference keeps the noise knobs inside the options struct,
    # synthetic.h:75+; add_noise() remains the post-hoc impl for models).
    point2D_stddev: float = 0.0
    inlier_match_ratio: float = 1.0
    two_view_geometry_has_relative_pose: bool = False
    match_config: MatchConfig = MatchConfig.EXHAUSTIVE
    match_sparsity: float = 0.0
    prior_position: bool = False
    prior_gravity: bool = False
    prior_gravity_in_world: tuple = (0.0, 1.0, 0.0)
    seed: Optional[int] = None


def _rotation_between(a, b):
    """Quaternion rotating direction a to b (host numpy)."""
    a = a / np.linalg.norm(a)
    b = b / np.linalg.norm(b)
    c = np.cross(a, b)
    w = 1.0 + float(np.dot(a, b))
    if w < 1e-8:
        ortho = np.array([-a[1] - a[2], a[0], a[0]])
        q = np.concatenate([[0.0], ortho])
    else:
        q = np.concatenate([[w], c])
    return q / np.linalg.norm(q)


def _calibration_matrix(camera: Camera) -> np.ndarray:
    f_idxs = camera_models.focal_length_idxs(camera.model_id)
    pp_idxs = camera_models.principal_point_idxs(camera.model_id)
    p = camera.params
    fx = p[f_idxs[0]]
    fy = p[f_idxs[1]] if len(f_idxs) > 1 else fx
    return np.array([[fx, 0, p[pp_idxs[0]]], [0, fy, p[pp_idxs[1]]], [0, 0, 1.0]])


def _essential_from_pose_np(cam2_from_cam1: Pose) -> np.ndarray:
    t = cam2_from_cam1.t / max(np.linalg.norm(cam2_from_cam1.t), 1e-30)
    tx = np.array([[0, -t[2], t[1]], [t[2], 0, -t[0]], [-t[1], t[0], 0]])
    return tx @ cam2_from_cam1.rotmat()


def synthesize_dataset(
    options: SyntheticDatasetOptions,
    database: Optional[Database] = None,
    rng: Optional[np.random.Generator] = None,
) -> Reconstruction:
    import torch

    if rng is None:
        rng = np.random.default_rng(options.seed)
    recon = Reconstruction()

    # 3D points on the unit sphere.
    point3D_ids = []
    for _ in range(options.num_points3D):
        v = rng.standard_normal(3)
        v /= np.linalg.norm(v)
        point3D_ids.append(recon.add_point3D(v, track=[]))

    total_num_images = 0
    next_unique_desc = options.num_points3D

    for rig_idx in range(options.num_rigs):
        rig = Rig(rig_id=rig_idx + 1)
        camera_ids = []
        if options.camera_model_ids:
            k = rig_idx % len(options.camera_model_ids)
            rig_model_id = int(options.camera_model_ids[k])
            rig_params = options.camera_params_list[k]
        else:
            rig_model_id = options.camera_model_id
            rig_params = options.camera_params
        for camera_idx in range(options.num_cameras_per_rig):
            camera_id = rig_idx * options.num_cameras_per_rig + camera_idx + 1
            camera = Camera(
                camera_id=camera_id,
                model_id=rig_model_id,
                width=options.camera_width,
                height=options.camera_height,
                params=np.array(rig_params, dtype=np.float64),
                has_prior_focal_length=options.camera_has_prior_focal_length,
            )
            recon.add_camera(camera)
            if database is not None:
                database.write_camera(camera)
            sensor = (int(SensorType.CAMERA), camera_id)
            if camera_idx == 0:
                rig.ref_sensor_id = sensor
            else:
                angle = np.clip(
                    rng.normal(0, options.sensor_from_rig_rotation_stddev), -180, 180
                )
                half = np.deg2rad(angle) / 2
                quat = np.array([np.cos(half), 0, 0, np.sin(half)])
                t = rng.normal(0, options.sensor_from_rig_translation_stddev, 3)
                rig.sensors[sensor] = Pose(quat, t)
            camera_ids.append(camera_id)
        recon.add_rig(rig)
        if database is not None:
            database.write_rig(rig)

        for frame_idx in range(options.num_frames_per_rig):
            # Cameras on a radius-5 sphere looking at the origin.
            view_dir = -rng.standard_normal(3)
            view_dir /= np.linalg.norm(view_dir)
            proj_center = -5.0 * view_dir
            quat = _rotation_between(view_dir, np.array([0.0, 0.0, 1.0]))
            rig_from_world = Pose(quat, Pose(quat, np.zeros(3)).apply(-proj_center[None])[0])

            frame_id = rig_idx * options.num_frames_per_rig + frame_idx + 1
            frame = Frame(frame_id=frame_id, rig_id=rig.rig_id, rig_from_world=rig_from_world)

            images = []
            for camera_id in camera_ids:
                total_num_images += 1
                image_id = total_num_images
                name = f"camera{camera_id:06d}_frame{frame_idx:06d}.png"
                image = Image(image_id=image_id, name=name, camera_id=camera_id, frame_id=frame_id)
                frame.data_ids.append((int(SensorType.CAMERA), camera_id, image_id))
                images.append(image)
                if database is not None:
                    database.write_image(name, camera_id, image_id=image_id)

            recon.add_frame(frame)
            recon.register_frame(frame_id)
            if database is not None:
                database.write_frame(frame)

            for image in images:
                camera = recon.cameras[image.camera_id]
                sensor = (int(SensorType.CAMERA), image.camera_id)
                sensor_from_rig = rig.sensor_from_rig(sensor)
                cam_from_world = sensor_from_rig.compose(rig_from_world)

                # Project all points; keep the in-bounds ones.
                xyz = np.stack([recon.points3D[pid].xyz for pid in point3D_ids])
                pts_cam = cam_from_world.apply(xyz)
                xy, valid = camera_models.img_from_cam(
                    camera.model_id, torch.as_tensor(camera.params, dtype=torch.float64),
                    torch.as_tensor(pts_cam, dtype=torch.float64),
                )
                xy = xy.numpy()
                valid = valid.numpy()
                in_bounds = (
                    valid
                    & (xy[:, 0] >= 0)
                    & (xy[:, 1] >= 0)
                    & (xy[:, 0] <= camera.width)
                    & (xy[:, 1] <= camera.height)
                )

                obs_xy = [xy[i] for i in range(len(point3D_ids)) if in_bounds[i]]
                obs_pid = [point3D_ids[i] for i in range(len(point3D_ids)) if in_bounds[i]]
                # Random 2D points without 3D points.
                for _ in range(options.num_points2D_without_point3D):
                    obs_xy.append(
                        np.array(
                            [rng.uniform(0, camera.width), rng.uniform(0, camera.height)]
                        )
                    )
                    obs_pid.append(-1)

                perm = rng.permutation(len(obs_xy))
                obs_xy = [obs_xy[i] for i in perm]
                obs_pid = [obs_pid[i] for i in perm]

                image.points2D_xy = np.array(obs_xy).reshape(-1, 2)
                if options.point2D_stddev > 0 and len(obs_xy):
                    image.points2D_xy = image.points2D_xy + rng.normal(
                        0, options.point2D_stddev, image.points2D_xy.shape
                    )
                image.points2D_p3d = np.full(len(obs_xy), -1, dtype=np.int64)
                from colmap_tpu_torch.scene.types import INVALID_POINT3D

                image.points2D_p3d[:] = INVALID_POINT3D

                if database is not None and (
                    options.prior_position or options.prior_gravity
                ):
                    # reference: synthetic.cc:497-523 — priors from the GT
                    # pose (CARTESIAN position; gravity rotated into the
                    # camera frame).
                    pos = cam_from_world.projection_center() if options.prior_position else None
                    grav = None
                    if options.prior_gravity:
                        g = cam_from_world.apply(
                            np.asarray(options.prior_gravity_in_world)[None]
                        )[0] - cam_from_world.apply(np.zeros((1, 3)))[0]
                        grav = g / np.linalg.norm(g)
                    database.write_pose_prior(
                        image.image_id, position=pos, gravity=grav,
                        coordinate_system=1,  # CARTESIAN
                    )

                if database is not None:
                    database.write_keypoints(image.image_id, image.points2D_xy)
                    # One unique deterministic descriptor per 3D point so the
                    # matcher can recover ground-truth correspondences.
                    desc = np.zeros((len(obs_xy), 128), dtype=np.uint8)
                    for i, pid in enumerate(obs_pid):
                        if pid >= 0:
                            seed = pid
                        else:
                            next_unique_desc += 1
                            seed = next_unique_desc
                        desc[i] = np.random.default_rng(seed).integers(
                            0, 256, 128, dtype=np.int64
                        )
                    database.write_descriptors(image.image_id, desc)

                recon.add_image(image)
                for p2d_idx, pid in enumerate(obs_pid):
                    if pid >= 0:
                        recon.add_observation(pid, TrackElement(image.image_id, p2d_idx))

    if database is not None:
        _synthesize_matches(options, recon, database, rng)
        database.commit()

    # Optional track-length pruning.
    if options.track_length > 0:
        for pid in list(recon.points3D):
            track = recon.points3D[pid].track
            if len(track) <= options.track_length:
                continue
            elements = list(track)
            rng.shuffle(elements)
            for el in elements[: len(elements) - options.track_length]:
                recon.delete_observation(el.image_id, el.point2D_idx)

    recon.update_point3D_errors()
    return recon


def _build_two_view_geometry(
    options, recon: Reconstruction, image_id1: int, image_id2: int
) -> TwoViewGeometry:
    image1, image2 = recon.images[image_id1], recon.images[image_id2]
    cam1 = recon.cameras[image1.camera_id]
    cam2 = recon.cameras[image2.camera_id]
    cam2_from_cam1 = recon.cam_from_world(image_id2).compose(
        recon.cam_from_world(image_id1).inverse()
    )
    g = TwoViewGeometry()
    g.E = _essential_from_pose_np(cam2_from_cam1)
    is_calibrated = cam1.has_prior_focal_length and cam2.has_prior_focal_length
    g.config = int(
        TwoViewGeometryConfig.CALIBRATED if is_calibrated else TwoViewGeometryConfig.UNCALIBRATED
    )
    K1, K2 = _calibration_matrix(cam1), _calibration_matrix(cam2)
    g.F = np.linalg.inv(K2).T @ g.E @ np.linalg.inv(K1)
    if options.two_view_geometry_has_relative_pose:
        g.cam2_from_cam1 = cam2_from_cam1

    # Inlier matches: shared point3D ids.
    p3d1 = image1.points2D_p3d
    p3d2 = image2.points2D_p3d
    from colmap_tpu_torch.scene.types import INVALID_POINT3D

    idx2_by_pid = {
        int(pid): j for j, pid in enumerate(p3d2) if pid != INVALID_POINT3D
    }
    matches = []
    for i, pid in enumerate(p3d1):
        if pid != INVALID_POINT3D and int(pid) in idx2_by_pid:
            matches.append((i, idx2_by_pid[int(pid)]))
    g.inlier_matches = np.array(matches, dtype=np.uint32).reshape(-1, 2)
    return g


def _write_pair(options, recon, database, rng, image_id1, image_id2):
    g = _build_two_view_geometry(options, recon, image_id1, image_id2)
    matches = list(map(tuple, g.inlier_matches))
    n1 = recon.images[image_id1].num_points2D()
    n2 = recon.images[image_id2].num_points2D()
    num_outliers = int(len(matches) * (1.0 - options.inlier_match_ratio))
    for _ in range(num_outliers):
        matches.append(
            (int(rng.integers(0, max(n1, 1))), int(rng.integers(0, max(n2 - 1, 1))))
        )
    rng.shuffle(matches)
    database.write_matches(
        image_id1, image_id2, np.array(matches, dtype=np.uint32).reshape(-1, 2)
    )
    database.write_two_view_geometry(image_id1, image_id2, g)


def _synthesize_matches(options, recon: Reconstruction, database: Database, rng):
    image_ids = sorted(recon.images)
    if options.match_config == MatchConfig.EXHAUSTIVE:
        pairs = [
            (a, b) for i, a in enumerate(image_ids) for b in image_ids[i + 1:]
        ]
    elif options.match_config == MatchConfig.CHAINED:
        pairs = [(image_ids[i], image_ids[i + 1]) for i in range(len(image_ids) - 1)]
    elif options.match_config == MatchConfig.SPARSE:
        # Keep a random spanning chain, drop other edges with prob sparsity.
        pairs = []
        all_pairs = [
            (a, b) for i, a in enumerate(image_ids) for b in image_ids[i + 1:]
        ]
        chain = set(
            (image_ids[i], image_ids[i + 1]) for i in range(len(image_ids) - 1)
        )
        for p in all_pairs:
            if p in chain or rng.uniform() >= options.match_sparsity:
                pairs.append(p)
    else:
        raise ValueError("invalid match config")
    for a, b in pairs:
        _write_pair(options, recon, database, rng, a, b)


def add_noise(
    recon: Reconstruction,
    rng: np.random.Generator,
    rig_from_world_translation_stddev: float = 0.0,
    rig_from_world_rotation_stddev: float = 0.0,  # degrees around z
    point3D_stddev: float = 0.0,
    point2D_stddev: float = 0.0,
):
    """reference behavior: SynthesizeNoise (synthetic.cc:675)."""
    for frame in recon.frames.values():
        if frame.rig_from_world is None:
            continue
        if rig_from_world_rotation_stddev > 0:
            angle = np.deg2rad(rng.normal(0, rig_from_world_rotation_stddev))
            half = angle / 2
            dq = np.array([np.cos(half), 0, 0, np.sin(half)])
            from colmap_tpu_torch.scene.types import _quat_mul_np

            q = _quat_mul_np(frame.rig_from_world.quat, dq)
            frame.rig_from_world.quat = q / np.linalg.norm(q)
        if rig_from_world_translation_stddev > 0:
            frame.rig_from_world.t = frame.rig_from_world.t + rng.normal(
                0, rig_from_world_translation_stddev, 3
            )
    if point3D_stddev > 0:
        for p in recon.points3D.values():
            p.xyz = p.xyz + rng.normal(0, point3D_stddev, 3)
    if point2D_stddev > 0:
        for image in recon.images.values():
            image.points2D_xy = image.points2D_xy + rng.normal(
                0, point2D_stddev, image.points2D_xy.shape
            )
