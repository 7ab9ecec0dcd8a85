"""Keypoint layout conversions between the 2/4/6-column DB blob formats.

A copy of colmap_tpu/feature/keypoints.py (numpy only), so that the port
does not import the JAX package.

reference behavior: src/colmap/feature/types.cc — FeatureKeypoint stores a
full affine frame (x, y, a11, a12, a21, a22); the 4-parameter constructor
builds a similarity frame from (x, y, scale, orientation) and
ComputeScale{,X,Y}/ComputeOrientation recover the similarity parameters from
a frame (types.cc:137-155).
"""

from __future__ import annotations

import numpy as np


def keypoints_to_xyso(kp: np.ndarray) -> np.ndarray:
    """Normalize a (N, 2|4|6) keypoint array to (N, 4) [x, y, scale, ori].

    reference: FeatureKeypoint::ComputeScale (mean of column norms of the
    affine frame) and ComputeOrientation (atan2(a21, a11))."""
    kp = np.asarray(kp, dtype=np.float32)
    n, c = kp.shape
    if c == 4:
        return kp
    out = np.zeros((n, 4), np.float32)
    out[:, :2] = kp[:, :2]
    if c == 2:
        out[:, 2] = 1.0
        return out
    if c != 6:
        raise ValueError(f"unsupported keypoint column count {c}")
    a11, a12, a21, a22 = kp[:, 2], kp[:, 3], kp[:, 4], kp[:, 5]
    scale_x = np.sqrt(a11 * a11 + a21 * a21)
    scale_y = np.sqrt(a12 * a12 + a22 * a22)
    out[:, 2] = 0.5 * (scale_x + scale_y)
    out[:, 3] = np.arctan2(a21, a11)
    return out


def keypoints_to_frames(kp: np.ndarray) -> np.ndarray:
    """Normalize a (N, 2|4|6) keypoint array to (N, 6) affine frames.

    reference: FeatureKeypoint(x, y, scale, orientation) constructor builds
    a11 = s·cosθ, a12 = -s·sinθ, a21 = s·sinθ, a22 = s·cosθ."""
    kp = np.asarray(kp, dtype=np.float32)
    n, c = kp.shape
    if c == 6:
        return kp
    out = np.zeros((n, 6), np.float32)
    out[:, :2] = kp[:, :2]
    if c == 2:
        out[:, 2] = 1.0
        out[:, 5] = 1.0
        return out
    if c != 4:
        raise ValueError(f"unsupported keypoint column count {c}")
    s, theta = kp[:, 2], kp[:, 3]
    c_, s_ = np.cos(theta), np.sin(theta)
    out[:, 2] = s * c_
    out[:, 3] = -s * s_
    out[:, 4] = s * s_
    out[:, 5] = s * c_
    return out
