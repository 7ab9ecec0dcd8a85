"""Image/camera undistortion (colmap_tpu/image/undistortion.py).

reference behavior: src/colmap/image/undistortion.{h,cc} — UndistortCamera
computes a distortion-free PINHOLE camera sized by the blank-pixel
constraints; UndistortImage warps via inverse mapping: one cam_from_img
(pinhole) + img_from_cam (distorted model) + bilinear gather over the whole
output grid.

Both camera maps go through the camera-map wrappers of kernels/sfm.py: on
the card they launch K5 (all 18 models), on the CPU they run the port's
sensor/models.py. The gather is torch ops on the
device the caller names; float64 on the CPU, float32 on the card.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from colmap_tpu_torch.kernels import sfm as camera_map
from colmap_tpu_torch.scene.types import Camera
from colmap_tpu_torch.sensor import models as camera_models
from colmap_tpu_torch.utils.dtypes import floatx


@dataclasses.dataclass
class UndistortOptions:
    """reference: image/undistortion.h UndistortCameraOptions."""

    blank_pixels: float = 0.0  # 0: no blank pixels (crop); 1: keep all
    min_scale: float = 0.2
    max_scale: float = 2.0
    max_image_size: int = -1


def undistort_camera(camera: Camera, options: UndistortOptions = UndistortOptions(),
                     device="cpu") -> Camera:
    """Distortion-free PINHOLE camera for the given camera.

    reference behavior: UndistortCamera (undistortion.cc) — keeps the focal
    length, re-centers the principal point, and scales the image so that
    either no blank pixels remain (blank_pixels=0) or the full original
    field is covered (blank_pixels=1).
    """
    mid = int(camera.model_id)
    if mid in (
        int(camera_models.CameraModelId.SIMPLE_PINHOLE),
        int(camera_models.CameraModelId.PINHOLE),
    ):
        f_idxs = camera_models.focal_length_idxs(mid)
        pp_idxs = camera_models.principal_point_idxs(mid)
        p = camera.params
        fx = p[f_idxs[0]]
        fy = p[f_idxs[1]] if len(f_idxs) > 1 else fx
        return Camera(
            camera_id=camera.camera_id,
            model_id=int(camera_models.CameraModelId.PINHOLE),
            width=camera.width, height=camera.height,
            params=np.array([fx, fy, p[pp_idxs[0]], p[pp_idxs[1]]]),
        )

    # Undistort the border points to find the required scaling.
    w, h = camera.width, camera.height
    n = 50
    border = np.concatenate(
        [
            np.stack([np.linspace(0.5, w - 0.5, n), np.full(n, 0.5)], axis=1),
            np.stack([np.linspace(0.5, w - 0.5, n), np.full(n, h - 0.5)], axis=1),
            np.stack([np.full(n, 0.5), np.linspace(0.5, h - 0.5, n)], axis=1),
            np.stack([np.full(n, w - 0.5), np.linspace(0.5, h - 0.5, n)], axis=1),
        ]
    )
    dtype = floatx(device)
    uv, ok = camera_map.cam_from_img(
        mid, torch.as_tensor(camera.params, dtype=dtype, device=device),
        torch.as_tensor(border, dtype=dtype, device=device))
    uv = uv.double().cpu().numpy()[ok.cpu().numpy()]
    focal = camera.mean_focal_length()
    cx, cy = w / 2.0, h / 2.0
    # Projected border in the undistorted pinhole image.
    px = uv[:, 0] * focal + cx
    py = uv[:, 1] * focal + cy
    if options.blank_pixels >= 1.0:
        # Keep everything: scale down so the whole undistorted extent fits.
        scale_x = w / max(px.max() - px.min(), 1e-6)
        scale_y = h / max(py.max() - py.min(), 1e-6)
        scale = min(scale_x, scale_y, 1.0)
    else:
        # No blank pixels: scale up so the inscribed box fills the image.
        left = max(cx - px[px < cx].min(), 1e-6) if (px < cx).any() else cx
        right = max(px[px > cx].max() - cx, 1e-6) if (px > cx).any() else cx
        top = max(cy - py[py < cy].min(), 1e-6) if (py < cy).any() else cy
        bottom = max(py[py > cy].max() - cy, 1e-6) if (py > cy).any() else cy
        scale = min(min(cx / left, cx / right), min(cy / top, cy / bottom))
        scale = max(scale, 1.0)
    scale = float(np.clip(scale, options.min_scale, options.max_scale))
    return Camera(
        camera_id=camera.camera_id,
        model_id=int(camera_models.CameraModelId.PINHOLE),
        width=w, height=h,
        params=np.array([focal * scale, focal * scale, cx, cy]),
    )


def undistort_image(image: np.ndarray, camera: Camera, undistorted_camera: Camera,
                    device="cpu") -> np.ndarray:
    """Inverse-map warp of an image into the undistorted camera.

    image: (H, W) or (H, W, C) array. A uint8 image comes back as uint8 by
    truncation, as colmap_tpu's ``astype``; other dtypes as float64 (CPU)
    or float32 (card).
    """
    h, w = undistorted_camera.height, undistorted_camera.width
    dtype = floatx(device)
    ys, xs = torch.meshgrid(torch.arange(h, dtype=dtype, device=device),
                            torch.arange(w, dtype=dtype, device=device), indexing="ij")
    grid = torch.stack([xs + 0.5, ys + 0.5], dim=-1).reshape(-1, 2)
    uv, _ = camera_map.cam_from_img(
        int(undistorted_camera.model_id),
        torch.as_tensor(undistorted_camera.params, dtype=dtype, device=device), grid)
    uvw = torch.cat([uv, torch.ones_like(uv[:, :1])], dim=1)
    src_xy, ok = camera_map.img_from_cam(
        int(camera.model_id), torch.as_tensor(camera.params, dtype=dtype, device=device), uvw)
    src = src_xy - 0.5  # back to array-index coords
    sx = torch.clamp(src[:, 0], 0, camera.width - 1.001)
    sy = torch.clamp(src[:, 1], 0, camera.height - 1.001)
    x0 = sx.to(torch.int64)
    y0 = sy.to(torch.int64)
    img = torch.as_tensor(np.asarray(image), device=device).to(dtype)
    fx = sx - x0
    fy = sy - y0
    if img.dim() == 3:
        fx, fy = fx[:, None], fy[:, None]
    v00 = img[y0, x0]
    v01 = img[y0, x0 + 1]
    v10 = img[y0 + 1, x0]
    v11 = img[y0 + 1, x0 + 1]
    out = v00 * (1 - fy) * (1 - fx) + v01 * (1 - fy) * fx + v10 * fy * (1 - fx) + v11 * fy * fx
    inb = (
        ok
        & (src[:, 0] >= -0.5) & (src[:, 0] <= camera.width - 0.5)
        & (src[:, 1] >= -0.5) & (src[:, 1] <= camera.height - 0.5)
    )
    if img.dim() == 3:
        out = torch.where(inb[:, None], out, 0.0).reshape(h, w, img.shape[2])
    else:
        out = torch.where(inb, out, 0.0).reshape(h, w)
    out = out.cpu().numpy()
    return out.astype(image.dtype) if image.dtype == np.uint8 else out
