"""Global reconstruction pipeline.

Counterpart of colmap_tpu/sfm/global_pipeline.py (reference behavior:
src/colmap/controllers/global_pipeline.{h,cc}): DatabaseCache → view-graph
calibration of UNCALIBRATED pairs (K23) → pose graph with E/F/H decomposed
on the fly → GlobalMapper.solve → pruning of weakly connected frames →
output. Runs on ``device`` (default cuda); ``timer`` is the mapper's
PhaseTimer, with view-graph calibration, the pose graph and pruning added.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from colmap_tpu_torch.scene.database import Database
from colmap_tpu_torch.scene.database_cache import DatabaseCache
from colmap_tpu_torch.scene.pose_graph import PoseGraph
from colmap_tpu_torch.scene.reconstruction import Reconstruction
from colmap_tpu_torch.scene.reconstruction_clustering import prune_weakly_connected_frames
from colmap_tpu_torch.scene.types import TwoViewGeometryConfig
from colmap_tpu_torch.sensor import models as camera_models
from colmap_tpu_torch.sfm.global_mapper import GlobalMapper, GlobalMapperOptions
from colmap_tpu_torch.utils import logging
from colmap_tpu_torch.utils.dtypes import resolve_device
from colmap_tpu_torch.utils.phase_timer import PhaseTimer


@dataclasses.dataclass
class GlobalPipelineOptions:
    min_num_matches: int = 15
    # View-graph calibration of focal lengths from F matrices before
    # relative-pose decomposition (reference: global_pipeline.cc runs
    # RunViewGraphCalibration first).
    view_graph_calibration: bool = True
    # Deregister frames outside the largest well-connected cluster after the
    # solve (reference: scene/reconstruction_pruning + global_pipeline.cc).
    prune_after_solve: bool = True
    mapper: GlobalMapperOptions = dataclasses.field(default_factory=GlobalMapperOptions)
    verbose: bool = False


def principal_point(camera):
    """(cx, cy) of a camera: its parameters, or the image centre for models
    without a principal point."""
    idx = camera_models.principal_point_idxs(camera.model_id)
    if len(idx) == 2:
        return float(camera.params[idx[0]]), float(camera.params[idx[1]])
    return camera.width / 2.0, camera.height / 2.0


class GlobalPipeline:
    def __init__(self, options: GlobalPipelineOptions, database: Database, device=None):
        self.options = options
        self.database = database
        self.device = resolve_device(device)
        self.timer = PhaseTimer()

    def _calibrate_view_graph(self) -> None:
        """Estimate focals from the F matrices of UNCALIBRATED pairs and write
        them to the database's cameras before pose decomposition."""
        from colmap_tpu_torch.estimators.view_graph_calibration import calibrate_view_graph

        cameras = self.database.read_cameras()
        images = {iid: cid for (iid, _, cid) in self.database.read_images()}
        edges = []
        for (id1, id2, g) in self.database.read_all_two_view_geometries():
            if (g is None or g.F is None or g.config != int(TwoViewGeometryConfig.UNCALIBRATED)
                    or len(g.inlier_matches) < self.options.min_num_matches):
                continue
            if id1 in images and id2 in images:
                c1, c2 = images[id1], images[id2]
                # Skip pairs whose two cameras already have a trustworthy prior.
                if not (cameras[c1].has_prior_focal_length
                        and cameras[c2].has_prior_focal_length):
                    edges.append((c1, c2, g.F))
        if not edges:
            return
        cam_ids = sorted(cameras.keys())
        prior_focals = {c: cameras[c].mean_focal_length() for c in cam_ids}
        pps = {c: principal_point(cameras[c]) for c in cam_ids}
        focals = calibrate_view_graph(cam_ids, prior_focals, pps, edges, device=self.device)
        for cid, f in focals.items():
            cam = cameras[cid]
            if cam.has_prior_focal_length or abs(f - prior_focals[cid]) < 1e-9:
                continue
            params = cam.params.copy()
            for k in camera_models.focal_length_idxs(cam.model_id):
                params[k] = f
            self.database.update_camera(dataclasses.replace(cam, params=params))
            if self.options.verbose:
                logging.info("VGC: camera %d focal %.2f -> %.2f", cid, prior_focals[cid], f)

    def run(self) -> Optional[Reconstruction]:
        if self.options.view_graph_calibration:
            with self.timer.phase("view_graph_calibration"):
                self._calibrate_view_graph()
        cache = DatabaseCache.create(self.database, min_num_matches=self.options.min_num_matches)
        with self.timer.phase("pose_graph"):
            graph = PoseGraph.load(self.database, min_num_inliers=self.options.min_num_matches,
                                   device=self.device).largest_connected_component()
        rel_poses = graph.rel_poses()
        if self.options.verbose:
            logging.info("Collected %d relative poses", len(rel_poses))
        recon = Reconstruction()
        mapper = GlobalMapper(cache, device=self.device, timer=self.timer)
        if not mapper.solve(recon, rel_poses, self.options.mapper):
            return None
        if self.options.prune_after_solve:
            with self.timer.phase("pruning"):
                pruned = prune_weakly_connected_frames(recon)
            if pruned and self.options.verbose:
                logging.info("Pruned %d weakly connected frames", len(pruned))
        if self.options.verbose:
            self.timer.report()
        return recon if recon.num_reg_frames() >= 2 else None
