"""Synthetic inputs for the SIFT kernels K13-K16, made from a numpy seed.

As kernels/matching_cases.py does for K10-K12: chip_smoke.py and the card
tests hold each kernel against its plain version on these inputs, and the
CPU tests run the plain versions on them.

``rendered_views`` renders a scene of the port's generator (one PINHOLE
camera, the points spread in front of it) into 8-bit gray PNGs and returns
them as arrays: the images a user's photos stand in for, at any size.
``tied_dog`` is a DoG stack on a coarse grid of values, so that extrema
touch equal neighbours (colmap_tpu's >= and <= count them) and many samples
share one |DoG|, which the selection orders by flat index.
"""

from __future__ import annotations

import os
import tempfile
from typing import List, NamedTuple

import numpy as np
import torch

from colmap_tpu_torch.utils.image_io import read_image_gray


def render_scene(out_dir: str, num_frames: int, num_points: int, width: int, height: int,
                 focal: float, seed: int = 3, patch_world: float = 0.08):
    """Render ``num_frames`` views of a ``num_points`` scene (PINHOLE,
    focal ``focal``, principal point at the centre) into ``out_dir``;
    returns (ground-truth reconstruction, file names, PINHOLE params)."""
    from colmap_tpu_torch.scene.synthetic import SyntheticDatasetOptions, synthesize_dataset
    from colmap_tpu_torch.scene.synthetic_images import render_images

    params = (focal, focal, width / 2.0, height / 2.0)
    gt = synthesize_dataset(
        SyntheticDatasetOptions(num_rigs=1, num_frames_per_rig=num_frames,
                                num_points3D=num_points, camera_model_id=1, camera_params=params,
                                camera_width=width, camera_height=height),
        None, rng=np.random.default_rng(seed))
    names = render_images(gt, out_dir, patch_world=patch_world)
    return gt, names, params


def rendered_views(num_frames: int, width: int, height: int, num_points: int = 1000,
                   seed: int = 3) -> List[np.ndarray]:
    """(H, W) uint8 views of a rendered scene (focal 1.25 width)."""
    with tempfile.TemporaryDirectory() as tmp:
        _, names, _ = render_scene(tmp, num_frames, num_points, width, height, 1.25 * width, seed)
        return [read_image_gray(os.path.join(tmp, n)) for n in names]


def tied_dog(scales: int, height: int, width: int, seed: int, device,
             dtype=torch.float64) -> torch.Tensor:
    """A (scales + 2, H, W) DoG stack of smooth random values rounded to
    multiples of 1/512, scaled so that the peak threshold cuts through
    them: plateaus of equal values, extrema that tie with a neighbour, and
    many samples of equal |DoG|."""
    from scipy.ndimage import gaussian_filter

    rng = np.random.default_rng(seed)
    d = gaussian_filter(rng.standard_normal((scales + 2, height, width)), (0.0, 1.2, 1.2))
    d = np.round(d / np.abs(d).max() * 16.0) / 512.0
    return torch.from_numpy(d).to(device=device, dtype=dtype)


class Agreement(NamedTuple):
    """How one extraction holds against a reference (``match_keypoints``)."""

    share: float  # of the reference's keypoints, those with a matching keypoint
    worst: int  # largest descriptor difference over the matched pairs, in counts
    equal: float  # share of equal descriptor entries over the matched pairs
    within2: float  # share of matched pairs whose descriptors differ by at most 2 counts


def match_keypoints(kp_ref: np.ndarray, desc_ref: np.ndarray, kp: np.ndarray, desc: np.ndarray,
                    px: float = 1e-2, rel_scale: float = 1e-3, rad: float = 1e-2) -> Agreement:
    """Hold one extraction (kp, desc) against a reference: a reference
    keypoint is matched by a keypoint within ``px`` px, ``rel_scale``
    relative scale and ``rad`` of orientation; the descriptors of the
    matched pairs are compared entry by entry. Keypoints are (N, 4)
    [x, y, scale, orientation]."""
    from scipy.spatial import cKDTree

    if len(kp_ref) == 0:
        return Agreement(1.0, 0, 1.0, 1.0)
    tree = cKDTree(kp[:, :2]) if len(kp) else None
    diffs = []
    for i, k in enumerate(kp_ref):
        cands = tree.query_ball_point(k[:2], px, p=np.inf) if tree is not None else []
        for j in cands:
            dth = abs((kp[j, 3] - k[3] + np.pi) % (2 * np.pi) - np.pi)
            if abs(kp[j, 2] - k[2]) <= rel_scale * k[2] and dth <= rad:
                diffs.append(np.abs(desc[j].astype(np.int32) - desc_ref[i].astype(np.int32)))
                break
    if not diffs:
        return Agreement(0.0, 255, 0.0, 0.0)
    diffs = np.stack(diffs)
    return Agreement(len(diffs) / len(kp_ref), int(diffs.max()), float((diffs == 0).mean()),
                     float((diffs.max(axis=1) <= 2).mean()))
