"""Reconstruction clustering: split into rigidly connected frame clusters.

Counterpart of colmap_tpu/scene/reconstruction_clustering.py (reference
behavior: src/colmap/scene/reconstruction_clustering.{h,cc}): covisibility
counts between registered frame pairs, an adaptive edge threshold (median -
MAD, floored by min_edge_weight_threshold), union-find over strong edges,
clusters ordered by size (largest = 0), clusters below min_num_reg_frames
discarded (-1). Global SfM prunes the frames outside the largest cluster.
Host Python over the points' tracks, as in colmap_tpu.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Dict, Iterable, List

import numpy as np

from colmap_tpu_torch.scene.reconstruction import Reconstruction


@dataclasses.dataclass
class ReconstructionClusteringOptions:
    """reference: reconstruction_clustering.h:40-62."""

    min_covisibility_count: int = 5
    min_edge_weight_threshold: float = 20.0
    min_num_reg_frames: int = 3


def cluster_reconstruction_frames(
    recon: Reconstruction,
    options: ReconstructionClusteringOptions = ReconstructionClusteringOptions(),
) -> Dict[int, int]:
    """frame_id -> cluster id (largest cluster = 0; -1 = discarded)."""
    nodes = set(recon.reg_frame_ids())
    if not nodes:
        return {}

    # Covisibility counts over frame pairs (tracks of length > 2).
    cov: Dict[tuple, int] = {}
    for p in recon.points3D.values():
        if len(p.track) <= 2:
            continue
        fids = [recon.images[el.image_id].frame_id for el in p.track]
        for i in range(len(fids)):
            for j in range(i + 1, len(fids)):
                if fids[i] != fids[j]:
                    key = (min(fids[i], fids[j]), max(fids[i], fids[j]))
                    cov[key] = cov.get(key, 0) + 1

    edges = {k: v for k, v in cov.items() if v >= options.min_covisibility_count}
    if not edges:
        return {f: -1 for f in nodes}

    # Adaptive threshold: median - MAD, floored (reference :166-180).
    w = np.array(list(edges.values()), dtype=np.float64)
    med = np.median(w)
    threshold = max(med - np.median(np.abs(w - med)), options.min_edge_weight_threshold)

    parent: Dict[int, int] = {f: f for f in nodes}

    def find(a):
        while parent[a] != a:
            parent[a] = parent[parent[a]]
            a = parent[a]
        return a

    for (f1, f2), weight in edges.items():
        if weight >= threshold and f1 in parent and f2 in parent:
            r1, r2 = find(f1), find(f2)
            if r1 != r2:
                parent[r2] = r1

    groups: Dict[int, List[int]] = {}
    for f in nodes:
        groups.setdefault(find(f), []).append(f)
    cluster_ids: Dict[int, int] = {}
    next_id = 0
    for cluster in sorted(groups.values(), key=len, reverse=True):
        keep = len(cluster) >= options.min_num_reg_frames
        for f in cluster:
            cluster_ids[f] = next_id if keep else -1
        next_id += keep
    return cluster_ids


def submodel_for_images(recon: Reconstruction, keep_ids: Iterable[int]) -> Reconstruction:
    """A new reconstruction restricted to the given image ids: their cameras,
    rigs and frames (registered as in ``recon``) and the points with at least
    two observations among them (colmap_tpu's cli/extra_commands.py
    ``_submodel_for_images``)."""
    keep = set(keep_ids)
    sub = Reconstruction()
    for cam in recon.cameras.values():
        sub.add_camera(cam)
    frames_needed = {recon.images[iid].frame_id for iid in keep}
    for fid in frames_needed:
        frame = recon.frames[fid]
        if frame.rig_id not in sub.rigs:
            sub.add_rig(recon.rigs[frame.rig_id])
        sub.add_frame(copy.deepcopy(frame))
    for iid in keep:
        img = copy.deepcopy(recon.images[iid])
        img.points2D_p3d = np.full(len(img.points2D_p3d), -1, dtype=np.int64)
        sub.add_image(img)
    for fid in frames_needed:
        if recon.is_frame_registered(fid):
            sub.register_frame(fid)
    for p in recon.points3D.values():
        track = [el for el in p.track if el.image_id in keep]
        if len(track) >= 2:
            sub.add_point3D(p.xyz, track, color=p.color)
    return sub


def split_reconstruction_into_clusters(
    recon: Reconstruction,
    options: ReconstructionClusteringOptions = ReconstructionClusteringOptions(),
) -> List[Reconstruction]:
    """Sub-reconstructions per rigid cluster, largest first (reference:
    controllers/reconstruction_clustering.cc splits after global SfM)."""
    cluster_ids = cluster_reconstruction_frames(recon, options)
    out = []
    for c in range(max(cluster_ids.values(), default=-1) + 1):
        frames = {f for f, cid in cluster_ids.items() if cid == c}
        out.append(submodel_for_images(
            recon, {iid for iid, img in recon.images.items() if img.frame_id in frames}))
    return out


def prune_weakly_connected_frames(
    recon: Reconstruction,
    options: ReconstructionClusteringOptions = ReconstructionClusteringOptions(),
) -> List[int]:
    """Deregister frames outside the largest cluster (reference:
    GlobalPipeline pruning stage). Returns the pruned frame ids."""
    pruned = [f for f, cid in cluster_reconstruction_frames(recon, options).items() if cid != 0]
    for f in pruned:
        recon.deregister_frame(f)
    return pruned
