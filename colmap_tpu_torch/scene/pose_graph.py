"""View graph of relative poses between verified image pairs.

Counterpart of colmap_tpu/scene/pose_graph.py (reference behavior:
src/colmap/scene/pose_graph.h:11): per-pair relative poses loaded from the
database's two_view_geometries, with the largest connected component that
global SfM keeps. Pairs without a stored pose get one by decomposing E, F
or H with the port's ``recover_poses`` (reference:
controllers/global_pipeline.cc relative-pose decomposition), on ``device``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np

from colmap_tpu_torch.scene.types import Pose, TwoViewGeometryConfig
from colmap_tpu_torch.utils.types import image_pair_to_pair_id, pair_id_to_image_pair

_POSED_CONFIGS = (
    int(TwoViewGeometryConfig.CALIBRATED),
    int(TwoViewGeometryConfig.UNCALIBRATED),
    int(TwoViewGeometryConfig.PLANAR),
    int(TwoViewGeometryConfig.PANORAMIC),
    int(TwoViewGeometryConfig.PLANAR_OR_PANORAMIC),
)


@dataclasses.dataclass
class PoseGraphEdge:
    image_id1: int
    image_id2: int
    cam2_from_cam1: Pose
    num_inliers: int = 0
    config: int = int(TwoViewGeometryConfig.CALIBRATED)


class PoseGraph:
    """Relative-pose view graph keyed by pair_id."""

    def __init__(self):
        self.edges: Dict[int, PoseGraphEdge] = {}

    def __len__(self):
        return len(self.edges)

    def add_edge(self, edge: PoseGraphEdge):
        self.edges[image_pair_to_pair_id(edge.image_id1, edge.image_id2)] = edge

    def rel_poses(self) -> Dict[int, Pose]:
        """pair_id -> cam2_from_cam1 (ids in canonical pair order)."""
        out = {}
        for pair_id, e in self.edges.items():
            a, _ = pair_id_to_image_pair(pair_id)
            out[pair_id] = e.cam2_from_cam1 if a == e.image_id1 else e.cam2_from_cam1.inverse()
        return out

    def image_ids(self) -> List[int]:
        return sorted({i for e in self.edges.values() for i in (e.image_id1, e.image_id2)})

    def largest_connected_component(self) -> "PoseGraph":
        """Subgraph over the largest connected image component (reference:
        pose_graph.cc KeepLargestConnectedComponent); of components of one
        size, the first one met in edge order."""
        parent: Dict[int, int] = {}

        def find(a):
            while parent.setdefault(a, a) != a:
                parent[a] = parent[parent[a]]
                a = parent[a]
            return a

        for e in self.edges.values():
            ra, rb = find(e.image_id1), find(e.image_id2)
            if ra != rb:
                parent[ra] = rb
        comps: Dict[int, List[int]] = {}
        for iid in list(parent):
            comps.setdefault(find(iid), []).append(iid)
        sub = PoseGraph()
        if not comps:
            return sub
        largest = set(max(comps.values(), key=len))
        for e in self.edges.values():
            if e.image_id1 in largest and e.image_id2 in largest:
                sub.add_edge(e)
        return sub

    @staticmethod
    def load(database, min_num_inliers: int = 15, decompose_missing: bool = True,
             device=None) -> "PoseGraph":
        """Build from a database's verified pairs (reference: PoseGraph::Load);
        missing poses are decomposed together on ``device`` (default cuda)."""
        from colmap_tpu_torch.estimators.two_view_geometry import recover_poses

        graph = PoseGraph()
        cameras = database.read_cameras()
        images = {iid: cid for (iid, _, cid) in database.read_images()}
        kps: Dict[int, np.ndarray] = {}
        kept, missing = [], []
        for (id1, id2, g) in database.read_all_two_view_geometries():
            if g is None or len(g.inlier_matches) < min_num_inliers or g.config not in _POSED_CONFIGS:
                continue
            if g.cam2_from_cam1 is None and decompose_missing:
                if id1 not in images or id2 not in images:
                    continue
                for iid in (id1, id2):
                    if iid not in kps:
                        kps[iid] = database.read_keypoints(iid)
                missing.append((g, cameras[images[id1]], kps[id1][:, :2], cameras[images[id2]],
                                kps[id2][:, :2]))
            kept.append((id1, id2, g))
        # The edges without a pose, decomposed together (K36, one launch per
        # block of edges).
        recover_poses(missing, device=device)
        for id1, id2, g in kept:
            if g.cam2_from_cam1 is None:
                continue
            graph.add_edge(PoseGraphEdge(image_id1=id1, image_id2=id2,
                                         cam2_from_cam1=g.cam2_from_cam1,
                                         num_inliers=len(g.inlier_matches), config=g.config))
        return graph
