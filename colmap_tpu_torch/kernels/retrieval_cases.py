"""Check cases of the retrieval kernels K28-K30, made with numpy from a seed.

The card checks (``chip_smoke.py`` and ``tests/test_torch_cuda.py``) hand the
same arrays to the kernels and to their float64 plain versions:

* ``corpus``: an unordered image collection with a known neighbour
  structure. Image i draws most of its descriptors, with noise, from a
  window of a shared pool that overlaps the windows of the images near it,
  so that its true neighbours are the images nearest in index;
* ``random_tree``: a vocabulary tree whose levels spread ever less about
  their parents, and descriptors beside its leaves;
* ``plant_ties``: exact ties, two children of a node with equal
  centroids, and descriptors that reach them;
* ``agree``: kernel and float64 results equal except at marked near-ties.
"""

from __future__ import annotations

from typing import List, NamedTuple

import numpy as np


class Corpus(NamedTuple):
    descriptors: np.ndarray  # (num_images, per_image, 128) uint8
    step: int  # pool offset between consecutive images' windows
    window: int  # pool rows an image draws from


def corpus(num_images: int, per_image: int, seed: int, step: int = 300, window_steps: int = 12,
           clutter: float = 0.1, noise: float = 4.0) -> Corpus:
    """Image i draws (1 - clutter) of its descriptors without replacement
    from pool rows [i step, i step + window) with N(0, noise²) per entry,
    rounded and clipped to uint8; the rest are uniform clutter. Images i and
    j share (window_steps - |i - j|) / window_steps of their windows."""
    rng = np.random.default_rng(seed)
    window = step * window_steps
    pool = rng.integers(0, 256, ((num_images - 1) * step + window, 128), dtype=np.uint8)
    shared = int(round(per_image * (1.0 - clutter)))
    out = np.empty((num_images, per_image, 128), np.uint8)
    for i in range(num_images):
        rows = pool[i * step + rng.choice(window, shared, replace=False)].astype(np.float32)
        rows += noise * rng.standard_normal(rows.shape, dtype=np.float32)
        out[i, :shared] = np.clip(np.rint(rows), 0, 255)
        out[i, shared:] = rng.integers(0, 256, (per_image - shared, 128), dtype=np.uint8)
    return Corpus(out, step, window)


def true_neighbors(num_images: int, k: int) -> List[set]:
    """Each image's k nearest images by index distance (the lower index
    first on a tie): its true neighbours in ``corpus``."""
    out = []
    for i in range(num_images):
        others = sorted((j for j in range(num_images) if j != i), key=lambda j: (abs(i - j), j))
        out.append(set(others[:k]))
    return out


def recall(ranked, truth) -> float:
    """Share of the true neighbours among each image's retrieved ones, over
    all images: ranked {i: [image ids]}, truth [set]."""
    hits = sum(len(set(ranked[i]) & truth[i]) for i in ranked)
    return hits / sum(len(truth[i]) for i in ranked)


def random_tree(rng, branching: int, depth: int, dim: int = 128,
                spreads=(40.0, 12.0, 4.0, 1.2, 0.4)) -> List[np.ndarray]:
    """Levels (B^l, B, dim) float32: children = parent + N(0, spreads[l]²)."""
    levels, parents = [], np.full((1, dim), 128.0)
    for level in range(depth):
        kids = parents[:, None, :] + rng.normal(0.0, spreads[level], (len(parents), branching, dim))
        levels.append(kids.astype(np.float32))
        parents = kids.reshape(-1, dim)
    return levels


def near_leaves(rng, levels, n: int, noise: float = 0.05) -> np.ndarray:
    """n float32 rows beside randomly chosen leaves of the tree."""
    leaves = levels[-1].reshape(-1, levels[-1].shape[-1])
    pick = rng.integers(0, len(leaves), n)
    return (leaves[pick] + rng.normal(0.0, noise, (n, leaves.shape[1]))).astype(np.float32)


def plant_ties(rng, levels, count: int):
    """Makes ``count`` exact ties in place: at a random level and node,
    child k > j gets child j's centroid. Returns (rows, j, level, node):
    rows (count, D) at child j's centroid, a tie between j and k there. No
    tie erases a child on another one's path from the root."""
    B = levels[0].shape[1]
    plants = []

    def on_path(level, node, upper, upper_node, child):
        # Does level `level`'s node pass through child `child` of upper_node?
        d = level - upper
        return node // B ** d == upper_node and node // B ** (d - 1) % B == child

    while len(plants) < count:
        level = int(rng.integers(0, len(levels)))
        node = int(rng.integers(0, B ** level))
        j, k = (int(v) for v in sorted(rng.choice(B, 2, replace=False)))
        if any((lv, nd) == (level, node)
               or (lv < level and on_path(level, node, lv, nd, kk))
               or (level < lv and on_path(lv, nd, level, node, k))
               for lv, nd, _, kk in plants):
            continue
        levels[level][node, k] = levels[level][node, j]
        plants.append((level, node, j, k))
    # The rows reach their node through its own centroid chain, then meet the
    # tie (each level spreads less about its parent than the one above).
    rows = np.stack([levels[lv][nd, j] for lv, nd, j, _ in plants]).astype(np.float32)
    lvls, nodes, first, _ = (np.array(v) for v in zip(*plants))
    return rows, first, lvls, nodes


def agree(got: np.ndarray, want: np.ndarray, near: np.ndarray, label: str):
    """(rows, near-ties, disagreements at near-ties); raises if a row that
    is not a near-tie differs."""
    diff = got != want
    bad = diff & ~near
    if bad.any():
        i = int(np.nonzero(bad)[0][0])
        raise AssertionError(f"{label}: {int(bad.sum())} rows differ away from near-ties "
                             f"(row {i}: {got[i]} vs {want[i]})")
    return len(got), int(near.sum()), int((diff & near).sum())
