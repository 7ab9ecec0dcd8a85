"""In-memory sparse reconstruction container.

Counterpart of colmap_tpu/scene/reconstruction.py (reference behavior:
src/colmap/scene/reconstruction.h:56-197) — rigs, cameras,
frames, images, points3D with registration bookkeeping, and the statistics
and reprojection errors that bundle adjustment and model_analyzer use.
Host-side dict maps with numpy values.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from colmap_tpu_torch.scene.types import (
    INVALID_POINT3D,
    Camera,
    Frame,
    Image,
    Point3D,
    Pose,
    Rig,
    TrackElement,
)
from colmap_tpu_torch.sensor import models as camera_models
from colmap_tpu_torch.utils.types import SensorType


class Reconstruction:
    def __init__(self):
        self.rigs: Dict[int, Rig] = {}
        self.cameras: Dict[int, Camera] = {}
        self.frames: Dict[int, Frame] = {}
        self.images: Dict[int, Image] = {}
        self.points3D: Dict[int, Point3D] = {}
        self._reg_frame_ids: set[int] = set()
        self._next_point3D_id: int = 1

    # -- counts ------------------------------------------------------------
    def num_rigs(self) -> int:
        return len(self.rigs)

    def num_cameras(self) -> int:
        return len(self.cameras)

    def num_frames(self) -> int:
        return len(self.frames)

    def num_images(self) -> int:
        return len(self.images)

    def num_points3D(self) -> int:
        return len(self.points3D)

    def num_reg_frames(self) -> int:
        return len(self._reg_frame_ids)

    def reg_frame_ids(self) -> List[int]:
        return sorted(self._reg_frame_ids)

    def reg_image_ids(self) -> List[int]:
        out = []
        for frame_id in sorted(self._reg_frame_ids):
            out.extend(self.frames[frame_id].image_ids())
        return out

    # -- add/register ------------------------------------------------------
    def add_rig(self, rig: Rig):
        assert rig.rig_id not in self.rigs
        self.rigs[rig.rig_id] = rig

    def add_camera(self, camera: Camera):
        assert camera.camera_id not in self.cameras
        self.cameras[camera.camera_id] = camera

    def add_frame(self, frame: Frame):
        assert frame.frame_id not in self.frames
        self.frames[frame.frame_id] = frame

    def add_image(self, image: Image):
        assert image.image_id not in self.images
        self.images[image.image_id] = image

    def register_frame(self, frame_id: int):
        assert self.frames[frame_id].has_pose()
        self._reg_frame_ids.add(frame_id)

    # -- pose access -------------------------------------------------------
    def cam_from_world(self, image_id: int) -> Pose:
        """Composed sensor_from_rig ∘ rig_from_world for the image."""
        image = self.images[image_id]
        frame = self.frames[image.frame_id]
        rig = self.rigs[frame.rig_id]
        sensor = (int(SensorType.CAMERA), image.camera_id)
        sensor_from_rig = rig.sensor_from_rig(sensor)
        assert frame.rig_from_world is not None
        return sensor_from_rig.compose(frame.rig_from_world)

    def set_cam_from_world(self, image_id: int, cam_from_world: Pose):
        """Set the frame pose from an image pose (ref-sensor images only,
        or single-image frames with a known sensor_from_rig)."""
        image = self.images[image_id]
        frame = self.frames[image.frame_id]
        rig = self.rigs[frame.rig_id]
        sensor = (int(SensorType.CAMERA), image.camera_id)
        sensor_from_rig = rig.sensor_from_rig(sensor)
        if sensor_from_rig is None:
            raise ValueError("cannot set pose through unknown sensor_from_rig")
        frame.rig_from_world = sensor_from_rig.inverse().compose(cam_from_world)

    # -- 3D points ---------------------------------------------------------
    def add_point3D(self, xyz, track: List[TrackElement], color=None, error=-1.0) -> int:
        point3D_id = self._next_point3D_id
        self._next_point3D_id += 1
        if color is None:
            color = np.zeros(3, dtype=np.uint8)
        self.points3D[point3D_id] = Point3D(
            xyz=np.asarray(xyz, dtype=np.float64), color=color, error=error, track=list(track)
        )
        for el in track:
            image = self.images[el.image_id]
            assert image.points2D_p3d[el.point2D_idx] == INVALID_POINT3D
            image.points2D_p3d[el.point2D_idx] = point3D_id
        return point3D_id

    # -- geometry ----------------------------------------------------------
    def compute_mean_track_length(self) -> float:
        if not self.points3D:
            return 0.0
        return float(np.mean([len(p.track) for p in self.points3D.values()]))

    def compute_num_observations(self) -> int:
        return int(sum(len(p.track) for p in self.points3D.values()))

    def compute_mean_reprojection_error(self) -> float:
        errors = [p.error for p in self.points3D.values() if p.error >= 0]
        return float(np.mean(errors)) if errors else 0.0

    def update_point3D_errors(self):
        """Recompute per-point mean reprojection errors.

        reference behavior: Reconstruction::UpdatePoint3DErrors. Host-side
        bookkeeping like the rest of this container: all observations are
        gathered on the host and projected in one float64 torch call per
        camera model on the CPU.
        """
        import torch

        pids = list(self.points3D.keys())
        if not pids:
            return
        rot_cache = {}
        by_model = {}
        for pid in pids:
            point = self.points3D[pid]
            for el in point.track:
                image = self.images[el.image_id]
                camera = self.cameras[image.camera_id]
                if el.image_id not in rot_cache:
                    P34 = self.cam_from_world(el.image_id).matrix3x4()
                    rot_cache[el.image_id] = (P34[:, :3], P34[:, 3])
                R, t = rot_cache[el.image_id]
                g = by_model.setdefault(int(camera.model_id), {
                    "Xc": [], "xy": [], "params": [], "pid": []
                })
                g["Xc"].append(R @ point.xyz + t)
                g["xy"].append(image.points2D_xy[el.point2D_idx])
                g["params"].append(camera.params)
                g["pid"].append(pid)
        err_sum = {pid: 0.0 for pid in pids}
        err_cnt = {pid: 0 for pid in pids}
        for model_id, g in by_model.items():
            Xc = np.asarray(g["Xc"], dtype=np.float64)
            proj, valid = camera_models.img_from_cam(
                model_id,
                torch.from_numpy(np.asarray(g["params"], dtype=np.float64)),
                torch.from_numpy(Xc),
            )
            err = np.linalg.norm(proj.numpy() - np.asarray(g["xy"]), axis=-1)
            ok = valid.numpy() & (Xc[:, 2] > 0)
            for pid, e, o in zip(g["pid"], err, ok):
                if o:
                    err_sum[pid] += float(e)
                    err_cnt[pid] += 1
        for pid in pids:
            self.points3D[pid].error = (
                err_sum[pid] / err_cnt[pid] if err_cnt[pid] else -1.0
            )
