"""Typed identifiers and shared enums.

Mirrors the reference's id conventions (reference: src/colmap/util/types.h)
so that databases and sparse models interoperate byte-for-byte:

- camera_t / image_t / rig_t / frame_t / point2D_t: uint32
- point3D_t / image_pair_t / data_t: uint64
- kMaxNumImages = INT32_MAX; pair ids pack two image ids into one uint64.
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

# reference: src/colmap/util/types.h:105 (kMaxNumImages = INT32_MAX).
MAX_NUM_IMAGES = 2147483647


class SensorType(enum.IntEnum):
    """reference: src/colmap/sensor/rig.h (SensorType enum)."""

    INVALID = -1
    CAMERA = 0
    IMU = 1


def image_pair_to_pair_id(image_id1: int, image_id2: int) -> int:
    """Pack two image ids into one uint64 pair id.

    reference: src/colmap/util/types.h:221-229 — the smaller id is the
    multiplier side so that pair ids are order-independent.
    """
    if image_id1 >= MAX_NUM_IMAGES or image_id2 >= MAX_NUM_IMAGES:
        raise ValueError("image id exceeds MAX_NUM_IMAGES")
    if image_id1 > image_id2:
        image_id1, image_id2 = image_id2, image_id1
    return MAX_NUM_IMAGES * int(image_id1) + int(image_id2)


def pair_id_to_image_pair(pair_id: int) -> tuple[int, int]:
    """Inverse of :func:`image_pair_to_pair_id`.

    reference: src/colmap/util/types.h:231-236.
    """
    image_id2 = int(pair_id) % MAX_NUM_IMAGES
    image_id1 = (int(pair_id) - image_id2) // MAX_NUM_IMAGES
    return image_id1, image_id2


def should_swap_image_pair(image_id1: int, image_id2: int) -> bool:
    """True if the match rows for this pair are stored swapped in the DB."""
    return image_id1 > image_id2
