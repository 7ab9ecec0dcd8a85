"""In-memory sparse reconstruction container.

Counterpart of colmap_tpu/scene/reconstruction.py (reference behavior:
src/colmap/scene/reconstruction.h:56-197) — rigs, cameras,
frames, images, points3D with registration bookkeeping, point/observation add/merge/delete,
normalization, transform and statistics.
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

    def deregister_frame(self, frame_id: int):
        # Remove all observations of this frame's images.
        for image_id in self.frames[frame_id].image_ids():
            image = self.images[image_id]
            for p2d_idx in image.get_observation_points2D_idxs():
                self.delete_observation(image_id, int(p2d_idx))
        self._reg_frame_ids.discard(frame_id)

    def is_frame_registered(self, frame_id: int) -> bool:
        return frame_id in self._reg_frame_ids

    def is_image_registered(self, image_id: int) -> bool:
        img = self.images[image_id]
        return img.frame_id in self._reg_frame_ids

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

    def add_observation(self, point3D_id: int, el: TrackElement):
        image = self.images[el.image_id]
        assert image.points2D_p3d[el.point2D_idx] == INVALID_POINT3D
        image.points2D_p3d[el.point2D_idx] = point3D_id
        self.points3D[point3D_id].track.append(el)

    def delete_observation(self, image_id: int, point2D_idx: int):
        image = self.images[image_id]
        point3D_id = int(image.points2D_p3d[point2D_idx])
        if point3D_id == INVALID_POINT3D:
            return
        point = self.points3D[point3D_id]
        if len(point.track) <= 2:
            self.delete_point3D(point3D_id)
            return
        image.points2D_p3d[point2D_idx] = INVALID_POINT3D
        point.track = [
            el
            for el in point.track
            if not (el.image_id == image_id and el.point2D_idx == point2D_idx)
        ]

    def delete_point3D(self, point3D_id: int):
        point = self.points3D.pop(point3D_id)
        for el in point.track:
            self.images[el.image_id].points2D_p3d[el.point2D_idx] = INVALID_POINT3D

    def merge_points3D(self, point3D_id1: int, point3D_id2: int) -> int:
        """Merge two points, weighted by track length (scene/reconstruction.cc
        MergePoints3D behavior)."""
        p1, p2 = self.points3D[point3D_id1], self.points3D[point3D_id2]
        n1, n2 = len(p1.track), len(p2.track)
        xyz = (n1 * p1.xyz + n2 * p2.xyz) / (n1 + n2)
        color = ((n1 * p1.color.astype(np.int64) + n2 * p2.color.astype(np.int64)) // (n1 + n2)).astype(np.uint8)
        track = p1.track + p2.track
        for el in p2.track:
            self.images[el.image_id].points2D_p3d[el.point2D_idx] = INVALID_POINT3D
        self.delete_point3D(point3D_id2) if point3D_id2 in self.points3D else None
        # Rebuild p1 with merged data.
        for el in p1.track:
            self.images[el.image_id].points2D_p3d[el.point2D_idx] = INVALID_POINT3D
        del self.points3D[point3D_id1]
        merged_id = self._next_point3D_id
        self._next_point3D_id += 1
        self.points3D[merged_id] = Point3D(xyz=xyz, color=color, error=-1.0, track=track)
        for el in track:
            self.images[el.image_id].points2D_p3d[el.point2D_idx] = merged_id
        return merged_id

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
    def compute_centroid(self, min_percentile=0.0, max_percentile=1.0) -> np.ndarray:
        if not self.points3D:
            return np.zeros(3)
        xyz = np.stack([p.xyz for p in self.points3D.values()])
        lo = np.quantile(xyz, min_percentile, axis=0)
        hi = np.quantile(xyz, max_percentile, axis=0)
        mask = np.all((xyz >= lo) & (xyz <= hi), axis=1)
        return xyz[mask].mean(axis=0) if mask.any() else xyz.mean(axis=0)

    def normalize(self, fixed_scale=False, extent=10.0, min_percentile=0.1, max_percentile=0.9):
        """Center at the percentile-trimmed camera-center centroid and scale
        to the given extent (reference: Reconstruction::Normalize)."""
        centers = np.array(
            [
                self.cam_from_world(iid).projection_center()
                for iid in self.reg_image_ids()
            ]
        )
        if len(centers) == 0:
            return
        lo = np.quantile(centers, min_percentile, axis=0)
        hi = np.quantile(centers, max_percentile, axis=0)
        mask = np.all((centers >= lo) & (centers <= hi), axis=1)
        sel = centers[mask] if mask.any() else centers
        mean_center = sel.mean(axis=0)
        bbox_extent = float(np.max(hi - lo))
        scale = 1.0 if fixed_scale or bbox_extent <= 0 else extent / max(bbox_extent, 1e-12)
        self.transform(scale, Pose.identity().quat, -scale * mean_center)

    def transform(self, scale: float, quat: np.ndarray, t: np.ndarray):
        """Apply Sim3 new_from_old = (scale, quat, t) to the whole model."""
        from colmap_tpu_torch.scene.types import _quat_mul_np, _quat_rotate_np

        q = np.asarray(quat, dtype=np.float64)
        q = q / np.linalg.norm(q)
        t = np.asarray(t, dtype=np.float64)
        for point in self.points3D.values():
            point.xyz = scale * _quat_rotate_np(q, point.xyz) + t
        for frame in self.frames.values():
            if frame.rig_from_world is None:
                continue
            # rig_from_new = TransformCameraWorld(Sim3, rig_from_old).
            q_new = _quat_mul_np(frame.rig_from_world.quat, q * np.array([1.0, -1, -1, -1]))
            q_new /= np.linalg.norm(q_new)
            t_new = scale * frame.rig_from_world.t - _quat_rotate_np(q_new, t)
            frame.rig_from_world = Pose(q_new, t_new)
