"""Typed identifiers and shared enums.

Mirrors the reference's id conventions (reference: src/colmap/util/types.h)
so that databases and sparse models interoperate byte-for-byte:

- camera_t / image_t / rig_t / frame_t / point2D_t: uint32
- point3D_t / image_pair_t / data_t: uint64
"""

from __future__ import annotations

import enum

import numpy as np

# Invalid-id sentinels (uint32 / uint64 max), matching util/types.h.
INVALID_CAMERA_ID = np.uint32(0xFFFFFFFF)
INVALID_IMAGE_ID = np.uint32(0xFFFFFFFF)
INVALID_RIG_ID = np.uint32(0xFFFFFFFF)
INVALID_FRAME_ID = np.uint32(0xFFFFFFFF)
INVALID_POINT2D_IDX = np.uint32(0xFFFFFFFF)
INVALID_POINT3D_ID = np.uint64(0xFFFFFFFFFFFFFFFF)
INVALID_IMAGE_PAIR_ID = np.uint64(0xFFFFFFFFFFFFFFFF)


class SensorType(enum.IntEnum):
    """reference: src/colmap/sensor/rig.h (SensorType enum)."""

    INVALID = -1
    CAMERA = 0
    IMU = 1
