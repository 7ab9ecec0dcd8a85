"""Host-side scene entity types.

reference behavior: src/colmap/scene/{camera,image,frame,point2d,point3d,
track,two_view_geometry}.h and src/colmap/sensor/rig.h. These are light
Python dataclasses used by the host orchestration layer; device compute uses
the packed struct-of-arrays form (colmap_tpu_torch.scene.arrays).

Pose conventions match the reference: image poses are ``cam_from_world``
(derived from the frame's ``rig_from_world`` composed with the rig's
``sensor_from_rig``), stored as Hamilton wxyz quaternion + translation.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Dict, List, Optional, Tuple

import numpy as np

from colmap_tpu_torch.sensor import models as camera_models
from colmap_tpu_torch.utils.types import (
    INVALID_POINT3D_ID,
    SensorType,
)

# In-memory sentinel for "no 3D point": -1 in int64 arrays (maps to the
# reference's uint64-max kInvalidPoint3DId at the I/O boundary).
INVALID_POINT3D = -1


def _quat_rotate_np(q, v):
    w, u = q[0], np.asarray(q[1:])
    uv = np.cross(u, v)
    return v + 2.0 * (w * uv + np.cross(u, uv))


def _quat_mul_np(q1, q2):
    w1, x1, y1, z1 = q1
    w2, x2, y2, z2 = q2
    return np.array(
        [
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        ]
    )


@dataclasses.dataclass
class Pose:
    """Host-side rigid transform (b_from_a): x_b = R x_a + t."""

    quat: np.ndarray  # (4,) wxyz
    t: np.ndarray  # (3,)

    @staticmethod
    def identity() -> "Pose":
        return Pose(np.array([1.0, 0, 0, 0]), np.zeros(3))

    def copy(self) -> "Pose":
        return Pose(self.quat.copy(), self.t.copy())

    def normalize(self) -> "Pose":
        return Pose(self.quat / np.linalg.norm(self.quat), self.t)

    def apply(self, pts):
        pts = np.asarray(pts)
        q = self.quat / np.linalg.norm(self.quat)
        w, u = q[0], q[1:]
        uv = np.cross(np.broadcast_to(u, pts.shape), pts)
        return pts + 2.0 * (w * uv + np.cross(np.broadcast_to(u, pts.shape), uv)) + self.t

    def inverse(self) -> "Pose":
        q = self.quat / np.linalg.norm(self.quat)
        q_inv = q * np.array([1.0, -1, -1, -1])
        return Pose(q_inv, -_quat_rotate_np(q_inv, self.t))

    def compose(self, other: "Pose") -> "Pose":
        """self ∘ other (apply other first)."""
        q = _quat_mul_np(self.quat, other.quat)
        q /= np.linalg.norm(q)
        return Pose(q, _quat_rotate_np(self.quat, other.t) + self.t)

    def rotmat(self) -> np.ndarray:
        w, x, y, z = self.quat / np.linalg.norm(self.quat)
        return np.array(
            [
                [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
                [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
                [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
            ]
        )

    def matrix3x4(self) -> np.ndarray:
        return np.concatenate([self.rotmat(), self.t[:, None]], axis=1)

    def projection_center(self) -> np.ndarray:
        return self.inverse().t

    def angle_to(self, other: "Pose") -> float:
        """Relative rotation angle in radians."""
        q1 = self.quat / np.linalg.norm(self.quat)
        q2 = other.quat / np.linalg.norm(other.quat)
        return 2.0 * np.arccos(min(1.0, abs(float(np.dot(q1, q2)))))


@dataclasses.dataclass
class Camera:
    """reference: src/colmap/scene/camera.h:48."""

    camera_id: int
    model_id: int
    width: int
    height: int
    params: np.ndarray
    has_prior_focal_length: bool = False

    @staticmethod
    def create(camera_id, model_id, focal_length, width, height) -> "Camera":
        # pycolmap parity: accept the model NAME ("SIMPLE_PINHOLE") as well
        # as the numeric/enum id (src/pycolmap binds both spellings).
        if isinstance(model_id, str):
            model_id = camera_models.MODEL_NAME_TO_ID[model_id]
        return Camera(
            camera_id=camera_id,
            model_id=int(model_id),
            width=int(width),
            height=int(height),
            params=camera_models.initialize_params(model_id, focal_length, width, height),
        )

    @property
    def model_name(self) -> str:
        return camera_models.MODEL_ID_TO_NAME[int(self.model_id)]

    def mean_focal_length(self) -> float:
        return float(camera_models.mean_focal_length(self.model_id, self.params))

    def cam_from_img_threshold(self, threshold_px: float) -> float:
        return threshold_px / self.mean_focal_length()


@dataclasses.dataclass
class Point2D:
    """reference: src/colmap/scene/point2d.h."""

    xy: np.ndarray
    point3D_id: int = INVALID_POINT3D

    def has_point3D(self) -> bool:
        return self.point3D_id != INVALID_POINT3D


@dataclasses.dataclass
class Image:
    """reference: src/colmap/scene/image.h."""

    image_id: int
    name: str
    camera_id: int
    frame_id: int = -1
    # Dense arrays instead of a list of Point2D (SoA form): (N, 2) float64
    # and (N,) int64 of point3D ids (INVALID_POINT3D when untriangulated).
    points2D_xy: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros((0, 2)))
    points2D_p3d: np.ndarray = dataclasses.field(
        default_factory=lambda: np.full(0, INVALID_POINT3D, dtype=np.int64)
    )

    def num_points2D(self) -> int:
        return len(self.points2D_xy)

    def num_points3D(self) -> int:
        return int(np.sum(self.points2D_p3d != INVALID_POINT3D))

    def set_points2D(self, xy: np.ndarray):
        self.points2D_xy = np.asarray(xy, dtype=np.float64).reshape(-1, 2)
        self.points2D_p3d = np.full(len(self.points2D_xy), INVALID_POINT3D, dtype=np.int64)

    def get_observation_points2D_idxs(self) -> np.ndarray:
        return np.nonzero(self.points2D_p3d != INVALID_POINT3D)[0]


@dataclasses.dataclass
class Rig:
    """reference: src/colmap/sensor/rig.h:49.

    ``sensors`` maps (sensor_type, sensor_id) -> optional sensor_from_rig
    pose (None = unknown, to be calibrated). The reference sensor has
    identity sensor_from_rig implicitly.
    """

    rig_id: int
    ref_sensor_id: Tuple[int, int] = (int(SensorType.CAMERA), 0)  # (type, id)
    sensors: Dict[Tuple[int, int], Optional[Pose]] = dataclasses.field(default_factory=dict)

    def num_sensors(self) -> int:
        return 1 + len(self.sensors)

    def is_ref_sensor(self, sensor_id: Tuple[int, int]) -> bool:
        return tuple(sensor_id) == tuple(self.ref_sensor_id)

    def sensor_from_rig(self, sensor_id: Tuple[int, int]) -> Optional[Pose]:
        if self.is_ref_sensor(sensor_id):
            return Pose.identity()
        return self.sensors[tuple(sensor_id)]


@dataclasses.dataclass
class Frame:
    """reference: src/colmap/scene/frame.h:44 — one rig exposure instance."""

    frame_id: int
    rig_id: int
    rig_from_world: Optional[Pose] = None
    # data ids: list of (sensor_type, sensor_id, data_id); for cameras the
    # data_id is the image_id.
    data_ids: List[Tuple[int, int, int]] = dataclasses.field(default_factory=list)

    def has_pose(self) -> bool:
        return self.rig_from_world is not None

    def image_ids(self) -> List[int]:
        return [d[2] for d in self.data_ids if d[0] == int(SensorType.CAMERA)]


@dataclasses.dataclass
class TrackElement:
    image_id: int
    point2D_idx: int


@dataclasses.dataclass
class Point3D:
    """reference: src/colmap/scene/point3d.h."""

    xyz: np.ndarray
    color: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(3, dtype=np.uint8))
    error: float = -1.0
    track: List[TrackElement] = dataclasses.field(default_factory=list)


class TwoViewGeometryConfig(enum.IntEnum):
    """reference: src/colmap/scene/two_view_geometry.h:43-69."""

    UNDEFINED = 0
    DEGENERATE = 1
    CALIBRATED = 2
    UNCALIBRATED = 3
    PLANAR = 4
    PANORAMIC = 5
    PLANAR_OR_PANORAMIC = 6
    WATERMARK = 7
    MULTIPLE = 8


@dataclasses.dataclass
class TwoViewGeometry:
    """reference: src/colmap/scene/two_view_geometry.h:41."""

    config: int = int(TwoViewGeometryConfig.UNDEFINED)
    E: Optional[np.ndarray] = None
    F: Optional[np.ndarray] = None
    H: Optional[np.ndarray] = None
    cam2_from_cam1: Optional[Pose] = None
    inlier_matches: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros((0, 2), dtype=np.uint32)
    )
    tri_angle: float = -1.0
    # Cameras with focal lengths estimated by the shared-/one-sided-focal
    # paths (reference: two_view_geometry.h:94-95 optional camera1/camera2).
    camera1: Optional["Camera"] = None
    camera2: Optional["Camera"] = None
