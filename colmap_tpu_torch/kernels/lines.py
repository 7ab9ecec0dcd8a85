"""Line-detector kernel: wrapper, plain PyTorch version, launch count.

One CUDA kernel carries the device program of the line segment detector
(source in ``colmap_tpu_torch/csrc``):

    K49 line_gradients   line_gradients

It replaces colmap_tpu/image/lines.py ``_gradients``: the Scharr gradients
of an edge-padded image, their magnitude and the level-line angle wrapped
into [0, π). As the other kernel modules do, the wrapper runs the plain
version when its tensor lies on the CPU and launches the kernel when it lies
on a CUDA device; on a CUDA tensor it launches or raises, it never falls
back. ``LAUNCHES`` counts kernel launches by kernel name (the wrapper adds
one where it launches, nowhere else).
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch
import torch.nn.functional as F

from colmap_tpu_torch.kernels import sfm as S

LAUNCHES = {"line_gradients": 0}

# Scharr taps of gx (colmap_tpu lines.py:64-67); gy's are their transpose.
SCHARR_X = ((-3.0, 0.0, 3.0), (-10.0, 0.0, 10.0), (-3.0, 0.0, 3.0))


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _level_line_angle(gx, gy):
    """atan2(gy, gx) + π/2 wrapped into [0, π)."""
    angle = torch.atan2(gy, gx) + math.pi / 2.0
    angle = torch.where(angle >= math.pi, angle - math.pi, angle)
    return torch.where(angle < 0, angle + math.pi, angle)


def line_gradients_plain(img):
    """(magnitude, angle) (H, W) of an (H, W) image in its dtype: the 3 x 3
    Scharr cross-correlation of the edge-padded image (nine shifted
    slices), then sqrt(gx² + gy²) and atan2(gy, gx) + π/2 wrapped into
    [0, π) (colmap_tpu's _gradients, l.61-82)."""
    H, W = img.shape
    pad = F.pad(img[None, None], (1, 1, 1, 1), mode="replicate")[0, 0]
    gx = torch.zeros_like(img)
    gy = torch.zeros_like(img)
    for i in range(3):
        for j in range(3):
            win = pad[i:i + H, j:j + W]
            if SCHARR_X[i][j]:
                gx = gx + (SCHARR_X[i][j] / 32.0) * win
            if SCHARR_X[j][i]:
                gy = gy + (SCHARR_X[j][i] / 32.0) * win
    return torch.sqrt(gx * gx + gy * gy), _level_line_angle(gx, gy)


def line_gradients_library(img):
    """The same function through one library convolution (F.conv2d on the
    replicate-padded image, then hypot, atan2 and the wraps); timed beside
    K49 and used nowhere in the port."""
    k = torch.tensor(SCHARR_X, dtype=img.dtype, device=img.device) / 32.0
    pad = F.pad(img[None, None], (1, 1, 1, 1), mode="replicate")
    g = F.conv2d(pad, torch.stack([k, k.T])[:, None])[0]
    return torch.hypot(g[0], g[1]), _level_line_angle(g[0], g[1])


@functools.cache
def _lib():
    from colmap_tpu_torch.kernels.build import library

    lib = library()
    lib.line_gradients_f32.argtypes = [ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 4
    lib.line_gradients_f32.restype = ctypes.c_int
    return lib


def line_gradients(img):
    """K49: (magnitude, angle) of an (H, W) float32 image on the card; see
    line_gradients_plain."""
    if img.device.type == "cpu":
        return line_gradients_plain(img)
    dev = S._require_cuda(img)
    H, W = img.shape
    S._check("img", img, torch.float32, (H, W), dev)
    mag = torch.empty_like(img)
    angle = torch.empty_like(img)
    err = _lib().line_gradients_f32(H, W, *map(S._ptr, (img, mag, angle)), S._stream(dev))
    if err != 0:
        raise RuntimeError(f"line_gradients_f32 failed to launch: CUDA error {err}")
    LAUNCHES["line_gradients"] += 1
    return mag, angle
