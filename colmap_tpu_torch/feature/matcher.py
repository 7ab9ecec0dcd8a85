"""Brute-force descriptor matching.

Counterpart of colmap_tpu/feature/matcher.py (reference behavior:
src/colmap/feature/matcher.{h,cc}: similarity = dot products of normalized
SIFT descriptors, ratio test on arccos "angle distances", cross check,
max_distance 0.7 rad, max_ratio 0.8, max_num_matches 32768, and guided
matching under the epipolar constraint, matcher.h:129 MatchGuided).

The device program is the CUDA kernel K10 (kernels/matching.py
``match_top2``): it forms the similarity product of every pair of a block
itself and keeps, per row, the best and second-best similarity and the
argmax, and per column the best row, so the N x M similarity never reaches
device memory. A block's descriptor sets go to the device once, as one
table padded to the largest set of the block; the kernel reads each pair's
two sets from it by index.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np
import torch

from colmap_tpu_torch.kernels import matching as K
from colmap_tpu_torch.utils.dtypes import resolve_device


@dataclasses.dataclass(frozen=True)
class MatchingOptions:
    """reference: feature/matcher.h:60-90 (SiftMatchingOptions)."""

    max_ratio: float = 0.8
    max_distance: float = 0.7  # radians of descriptor angle
    cross_check: bool = True
    max_num_matches: int = 32768
    guided_max_error: float = 4.0  # px epipolar distance for guided matching


def _table(arrays: Sequence[np.ndarray], width, dtype, device):
    """Rows of ``arrays`` padded to the longest into one (I, cap, width)
    tensor on ``device``, and their counts (I,) int32."""
    cap = max((len(a) for a in arrays), default=0)
    table = np.zeros((len(arrays), cap, width), dtype=dtype)
    for i, a in enumerate(arrays):
        table[i, : len(a)] = np.asarray(a)[:, :width]
    counts = np.asarray([len(a) for a in arrays], dtype=np.int32)
    return torch.from_numpy(table).to(device), torch.from_numpy(counts).to(device)


def _matches(idx2: np.ndarray, ok: np.ndarray, max_num_matches: int) -> np.ndarray:
    idx1 = np.nonzero(ok)[0]
    return np.stack([idx1, idx2[idx1]], axis=1).astype(np.uint32)[:max_num_matches]


def match_pairs_batched(
    descriptors: Sequence[np.ndarray],
    pair_idxs: np.ndarray,
    options: MatchingOptions = MatchingOptions(),
    device=None,
    keypoints: Sequence[np.ndarray] = None,
    Fs: np.ndarray = None,
) -> List[np.ndarray]:
    """Match a block of pairs in one K10 call.

    descriptors: (Ni, 128) uint8 arrays; pair_idxs: (B, 2) indices into that
    list. With ``keypoints`` ((Ni, >=2) arrays) and ``Fs`` (B, 3, 3) the
    matching is guided by each pair's F. Returns B arrays (Ki, 2) uint32,
    rows in ascending index of image 1, at most ``max_num_matches`` each.
    """
    pair_idxs = np.asarray(pair_idxs).reshape(-1, 2)
    if len(pair_idxs) == 0:
        return []
    device = resolve_device(device)
    desc, counts = _table(descriptors, K.DESC_DIM, np.uint8, device)
    pairs = torch.from_numpy(pair_idxs.astype(np.int32)).to(device)
    kp = F = None
    if Fs is not None:
        kp, _ = _table(keypoints, 2, np.float32, device)
        F = torch.from_numpy(np.asarray(Fs, dtype=np.float32)).to(device).contiguous()
    idx2, ok = K.match_top2(desc, counts, pairs, options, kp, F)
    idx2, ok = idx2.cpu().numpy(), ok.cpu().numpy()
    return [_matches(idx2[b], ok[b], options.max_num_matches) for b in range(len(pair_idxs))]


def match_descriptors(d1: np.ndarray, d2: np.ndarray,
                      options: MatchingOptions = MatchingOptions(), device=None) -> np.ndarray:
    """(N, 128) x (M, 128) uint8 -> (K, 2) uint32 matches."""
    if len(d1) == 0 or len(d2) == 0:
        return np.zeros((0, 2), dtype=np.uint32)
    return match_pairs_batched([d1, d2], np.array([[0, 1]]), options, device)[0]


def match_guided(d1, d2, xy1, xy2, F, options: MatchingOptions = MatchingOptions(),
                 device=None) -> np.ndarray:
    """Matches whose two keypoints lie within ``guided_max_error`` px of each
    other's epipolar lines under F (matching again after verification)."""
    if len(d1) == 0 or len(d2) == 0:
        return np.zeros((0, 2), dtype=np.uint32)
    return match_pairs_batched([d1, d2], np.array([[0, 1]]), options, device,
                               keypoints=[xy1, xy2], Fs=np.asarray(F)[None])[0]
