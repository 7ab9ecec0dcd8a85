"""Load a database into memory once and build the correspondence graph.

reference behavior: src/colmap/scene/database_cache.h:49-77 — applies the
min_num_matches filter and optional image-name whitelist, instantiates
cameras/images/rigs/frames and the CorrespondenceGraph for the mappers.
"""

from __future__ import annotations

from typing import Dict, Optional, Set

import numpy as np

from colmap_tpu_torch.scene.correspondence_graph import CorrespondenceGraph
from colmap_tpu_torch.scene.database import Database
from colmap_tpu_torch.scene.types import Camera, Frame, Image, Pose, Rig, TwoViewGeometryConfig
from colmap_tpu_torch.utils.types import SensorType


class DatabaseCache:
    def __init__(self):
        self.cameras: Dict[int, Camera] = {}
        self.images: Dict[int, Image] = {}
        self.rigs: Dict[int, Rig] = {}
        self.frames: Dict[int, Frame] = {}
        self.pose_priors: Dict[int, dict] = {}
        self.correspondence_graph = CorrespondenceGraph()
        self.two_view_configs: Dict[int, int] = {}  # pair_id -> config

    @staticmethod
    def create(
        database: Database,
        min_num_matches: int = 15,
        ignore_watermarks: bool = False,
        image_names: Optional[Set[str]] = None,
    ) -> "DatabaseCache":
        cache = DatabaseCache()
        cache.cameras = database.read_cameras()

        for (image_id, name, camera_id) in database.read_images():
            if image_names and name not in image_names:
                continue
            kp = database.read_keypoints(image_id)
            image = Image(image_id=image_id, name=name, camera_id=camera_id)
            image.set_points2D(kp[:, :2] if kp.size else np.zeros((0, 2)))
            cache.images[image_id] = image

        # Rigs / frames; synthesize trivial ones when absent.
        rigs = {r.rig_id: r for r in database.read_rigs()}
        frames = {f.frame_id: f for f in database.read_frames()}
        if frames:
            cache.rigs = rigs
            cache.frames = frames
            for frame in frames.values():
                for (s_type, s_id, d_id) in frame.data_ids:
                    if s_type == int(SensorType.CAMERA) and d_id in cache.images:
                        cache.images[d_id].frame_id = frame.frame_id
        else:
            for image in cache.images.values():
                rig = Rig(
                    rig_id=image.image_id,
                    ref_sensor_id=(int(SensorType.CAMERA), image.camera_id),
                )
                frame = Frame(
                    frame_id=image.image_id,
                    rig_id=rig.rig_id,
                    data_ids=[(int(SensorType.CAMERA), image.camera_id, image.image_id)],
                )
                cache.rigs[rig.rig_id] = rig
                cache.frames[frame.frame_id] = frame
                image.frame_id = frame.frame_id

        cache.pose_priors = database.read_pose_priors()

        for image_id, image in cache.images.items():
            cache.correspondence_graph.add_image(image_id, image.num_points2D())

        from colmap_tpu_torch.utils.types import image_pair_to_pair_id

        for (id1, id2, g) in database.read_all_two_view_geometries():
            if g is None or len(g.inlier_matches) < min_num_matches:
                continue
            if ignore_watermarks and g.config == int(TwoViewGeometryConfig.WATERMARK):
                continue
            if id1 not in cache.images or id2 not in cache.images:
                continue
            cache.correspondence_graph.add_correspondences(id1, id2, g.inlier_matches)
            cache.two_view_configs[image_pair_to_pair_id(id1, id2)] = g.config
        cache.correspondence_graph.finalize()
        return cache
