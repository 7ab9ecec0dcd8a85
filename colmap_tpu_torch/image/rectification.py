"""Planar stereo rectification (colmap_tpu/image/rectification.py).

reference behavior: src/colmap/image/undistortion.cc:384-490
(RectifyStereoCameras / RectifyAndUndistortStereoImages) — computes the
pair of homographies that rotate both pinhole cameras onto a common image
plane whose x-axis coincides with the baseline, plus the 4x4 disparity-to-
depth matrix Q, in float64 numpy on the host. The image warp is an inverse
map: the inverse homography on the target grid, then ``cam_from_img`` of the
target camera and ``img_from_cam`` of the source camera through the camera-
map wrappers of kernels/sfm.py (K5 on the card), and a bilinear gather as
torch ops on the caller's device (float64 on the CPU, float32 on the card).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from colmap_tpu_torch.image.undistortion import UndistortOptions, undistort_camera
from colmap_tpu_torch.kernels import sfm as camera_map
from colmap_tpu_torch.scene.types import Camera, Pose
from colmap_tpu_torch.sensor import models as camera_models
from colmap_tpu_torch.utils.dtypes import floatx, resolve_device


def _calibration_matrix(camera: Camera) -> np.ndarray:
    mid = int(camera.model_id)
    f_idxs = camera_models.focal_length_idxs(mid)
    pp_idxs = camera_models.principal_point_idxs(mid)
    p = np.asarray(camera.params, dtype=np.float64)
    fx = p[f_idxs[0]]
    fy = p[f_idxs[1]] if len(f_idxs) > 1 else fx
    K = np.eye(3)
    K[0, 0] = fx
    K[1, 1] = fy
    K[0, 2] = p[pp_idxs[0]]
    K[1, 2] = p[pp_idxs[1]]
    return K


def _axis_angle_to_rotmat(axis: np.ndarray, angle: float) -> np.ndarray:
    axis = axis / np.linalg.norm(axis)
    K = np.array(
        [[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]]
    )
    return np.eye(3) + np.sin(angle) * K + (1.0 - np.cos(angle)) * (K @ K)


def rectify_stereo_cameras(
    camera1: Camera, camera2: Camera, cam2_from_cam1: Pose
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Homographies (H1, H2) and disparity-to-depth matrix Q.

    Both cameras must be (SIMPLE_)PINHOLE. reference:
    image/undistortion.cc:384 RectifyStereoCameras.
    """
    for cam in (camera1, camera2):
        if int(cam.model_id) not in (
            int(camera_models.CameraModelId.SIMPLE_PINHOLE),
            int(camera_models.CameraModelId.PINHOLE),
        ):
            raise ValueError("rectify_stereo_cameras requires pinhole cameras")

    # Split the relative rotation evenly between the two cameras.
    q = cam2_from_cam1.quat / np.linalg.norm(cam2_from_cam1.quat)
    angle = 2.0 * np.arctan2(np.linalg.norm(q[1:]), q[0])
    if np.linalg.norm(q[1:]) < 1e-12:
        R2 = np.eye(3)
    else:
        axis = q[1:] / np.linalg.norm(q[1:])
        R2 = _axis_angle_to_rotmat(axis, -0.5 * angle)
    R1 = R2.T

    # Rotate so the translation coincides with the +-x axis.
    t = R2 @ np.asarray(cam2_from_cam1.t, dtype=np.float64)
    x_unit = np.array([1.0, 0.0, 0.0])
    if float(t @ x_unit) < 0:
        x_unit = -x_unit
    rotation_axis = np.cross(t, x_unit)
    if np.linalg.norm(rotation_axis) < np.finfo(np.float64).eps:
        R_x = np.eye(3)
    else:
        ang = np.arccos(
            np.clip(abs(float(t @ x_unit)) / (np.linalg.norm(t) or 1e-300), -1.0, 1.0)
        )
        R_x = _axis_angle_to_rotmat(rotation_axis, ang)

    R1 = R_x @ R1
    R2 = R_x @ R2
    t = R_x @ t

    # Shared intrinsics: min focal, pp x from camera1, pp y averaged.
    K1 = _calibration_matrix(camera1)
    K2 = _calibration_matrix(camera2)
    K = np.eye(3)
    K[0, 0] = K[1, 1] = min(camera1.mean_focal_length(), camera2.mean_focal_length())
    K[0, 2] = K1[0, 2]
    K[1, 2] = (K1[1, 2] + K2[1, 2]) / 2.0

    H1 = K @ R1 @ np.linalg.inv(K1)
    H2 = K @ R2 @ np.linalg.inv(K2)

    Q = np.eye(4)
    Q[3, 0] = -K[1, 2]
    Q[3, 1] = -K[0, 2]
    Q[3, 2] = K[0, 0]
    Q[2, 3] = -1.0 / t[0]
    Q[3, 3] = 0.0
    return H1, H2, Q


def warp_image_with_homography_between_cameras(
    image: np.ndarray,
    H: np.ndarray,
    source_camera: Camera,
    target_camera: Camera,
    device="cuda",
) -> np.ndarray:
    """Inverse-map warp target->source: first the (inverse) homography in
    the target pinhole frame, then projection through the distorted source
    camera. reference: image/warp.cc WarpImageWithHomographyBetweenCameras.

    ``H`` maps source-normalized pixels to target pixels (the rectifying
    homography); its inverse is evaluated on the target grid (float64 on
    the host). A uint8 image comes back as uint8 by truncation, other
    dtypes as float64 (CPU) or float32 (card).
    """
    dev = resolve_device(device)
    dtype = floatx(dev)
    h, w = target_camera.height, target_camera.width
    ys, xs = np.mgrid[0:h, 0:w]
    grid = np.stack([xs + 0.5, ys + 0.5, np.ones_like(xs, dtype=np.float64)], axis=-1)
    grid = grid.reshape(-1, 3)
    Hinv = np.linalg.inv(H)
    # Target pixel -> intermediate pinhole pixel in the target camera frame.
    mapped = grid @ Hinv.T
    mapped = mapped[:, :2] / mapped[:, 2:3]
    # Intermediate pinhole pixel -> normalized ray -> distorted source pixel.
    uv, _ = camera_map.cam_from_img(
        int(target_camera.model_id),
        torch.as_tensor(target_camera.params, dtype=dtype, device=dev),
        torch.as_tensor(mapped, dtype=dtype, device=dev))
    uvw = torch.cat([uv, torch.ones_like(uv[:, :1])], dim=1)
    src_xy, ok = camera_map.img_from_cam(
        int(source_camera.model_id),
        torch.as_tensor(source_camera.params, dtype=dtype, device=dev), uvw)
    src = src_xy - 0.5
    sx = torch.clamp(src[:, 0], 0, source_camera.width - 1.001)
    sy = torch.clamp(src[:, 1], 0, source_camera.height - 1.001)
    x0 = sx.to(torch.int64)
    y0 = sy.to(torch.int64)
    fx = sx - x0
    fy = sy - y0
    img = torch.as_tensor(np.asarray(image), device=dev).to(dtype)
    if img.dim() == 3:
        fx, fy = fx[:, None], fy[:, None]
    v00 = img[y0, x0]
    v01 = img[y0, x0 + 1]
    v10 = img[y0 + 1, x0]
    v11 = img[y0 + 1, x0 + 1]
    out = v00 * (1 - fy) * (1 - fx) + v01 * (1 - fy) * fx + v10 * fy * (1 - fx) + v11 * fy * fx
    inb = (
        ok
        & (src[:, 0] >= -0.5)
        & (src[:, 0] <= source_camera.width - 0.5)
        & (src[:, 1] >= -0.5)
        & (src[:, 1] <= source_camera.height - 0.5)
    )
    if img.dim() == 3:
        out = torch.where(inb[:, None], out, 0.0).reshape(h, w, img.shape[2])
    else:
        out = torch.where(inb, out, 0.0).reshape(h, w)
    out = out.cpu().numpy()
    return out.astype(image.dtype) if image.dtype == np.uint8 else out


def rectify_and_undistort_stereo_images(
    image1: np.ndarray,
    image2: np.ndarray,
    camera1: Camera,
    camera2: Camera,
    cam2_from_cam1: Pose,
    options: UndistortOptions = UndistortOptions(),
    device="cuda",
) -> Tuple[np.ndarray, np.ndarray, Camera, np.ndarray]:
    """Undistort + rectify a stereo pair onto one shared pinhole camera.

    reference: image/undistortion.cc:447 RectifyAndUndistortStereoImages.
    Returns (rectified1, rectified2, undistorted_camera, Q).
    """
    dev = resolve_device(device)
    undistorted_camera = undistort_camera(camera1, options, device=dev)
    H1, H2, Q = rectify_stereo_cameras(
        undistorted_camera, undistorted_camera, cam2_from_cam1
    )
    rect1 = warp_image_with_homography_between_cameras(
        image1, H1, camera1, undistorted_camera, dev
    )
    rect2 = warp_image_with_homography_between_cameras(
        image2, H2, camera2, undistorted_camera, dev
    )
    return rect1, rect2, undistorted_camera, Q
