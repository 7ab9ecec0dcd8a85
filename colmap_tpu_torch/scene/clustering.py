"""Scene clustering: partition the view graph for hierarchical mapping.

A copy of colmap_tpu/scene/clustering.py (host numpy), so that the port
does not import the JAX package.

reference behavior: src/colmap/scene/scene_clustering.h:43-89 — recursive
normalized-cut partition (Metis) of the image match graph into overlapping
leaf clusters of bounded size. Metis is replaced by recursive spectral
bisection (scipy eigsh on the graph Laplacian — host-side; the graphs are
tiny relative to the reconstruction itself).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np


@dataclasses.dataclass
class SceneClusteringOptions:
    """reference: scene_clustering.h Options."""

    branching: int = 2
    image_overlap: int = 50
    leaf_max_num_images: int = 500


def _spectral_bisect(nodes: List[int], edges: Dict[Tuple[int, int], float]):
    """Split nodes into two balanced halves minimizing cut weight."""
    n = len(nodes)
    idx = {v: i for i, v in enumerate(nodes)}
    W = np.zeros((n, n))
    for (a, b), w in edges.items():
        if a in idx and b in idx:
            W[idx[a], idx[b]] += w
            W[idx[b], idx[a]] += w
    d = W.sum(axis=1)
    L = np.diag(d) - W
    # Normalized Laplacian Fiedler vector.
    with np.errstate(divide="ignore"):
        dinv = np.where(d > 0, 1.0 / np.sqrt(np.maximum(d, 1e-12)), 0.0)
    Ln = dinv[:, None] * L * dinv[None, :]
    vals, vecs = np.linalg.eigh(Ln)
    fiedler = vecs[:, 1] if n > 1 else np.zeros(n)
    order = np.argsort(fiedler)
    half = n // 2
    left = [nodes[i] for i in order[:half]]
    right = [nodes[i] for i in order[half:]]
    return left, right


def cluster_scene(
    image_ids: List[int],
    pair_weights: Dict[Tuple[int, int], float],
    options: SceneClusteringOptions = SceneClusteringOptions(),
) -> List[List[int]]:
    """Partition images into overlapping leaf clusters.

    pair_weights: {(id1, id2): num_inlier_matches}. Returns leaf clusters;
    each cluster is extended with its strongest cross-cluster neighbors
    (image_overlap) so sub-reconstructions share images for merging.
    """
    leaves: List[List[int]] = []

    def recurse(nodes: List[int]):
        if len(nodes) <= options.leaf_max_num_images:
            leaves.append(list(nodes))
            return
        left, right = _spectral_bisect(nodes, pair_weights)
        if not left or not right:
            leaves.append(list(nodes))
            return
        recurse(left)
        recurse(right)

    recurse(list(image_ids))

    # Overlap: for each leaf add the strongest external neighbors.
    leaf_sets = [set(l) for l in leaves]
    out = []
    for li, leaf in enumerate(leaves):
        inside = leaf_sets[li]
        scores: Dict[int, float] = {}
        for (a, b), w in pair_weights.items():
            if (a in inside) != (b in inside):
                ext = b if a in inside else a
                scores[ext] = scores.get(ext, 0.0) + w
        extra = sorted(scores, key=scores.get, reverse=True)[: options.image_overlap]
        out.append(leaf + extra)
    return out
