"""Hierarchical mapping: cluster → reconstruct per leaf → Sim3 merge.

reference behavior: src/colmap/controllers/hierarchical_pipeline.h:42-86 —
SceneClustering partition, an IncrementalPipeline per leaf cluster (the
reference parallelizes across threads; multi-host TPU deployments run one
cluster per host group), then greedy merging of overlapping
sub-reconstructions via robust Sim3 alignment on shared images.

Counterpart of colmap_tpu/sfm/hierarchical_pipeline.py: each leaf runs the
port's incremental mapper on ``device`` (its kernels as in ``mapper``), the
clustering and the merge are host code. Under a process group
(parallel/multihost.py, torchrun with COLMAP_TPU_MULTIHOST=1) each process
reconstructs a strided slice of the leaves, and
``exchange_sub_reconstructions`` gathers every process's leaves, serialized
as zipped bin models, onto every process, which then merge the same set; in
one process it is the identity, as colmap_tpu's is.
"""

from __future__ import annotations

import dataclasses
from typing import List

from colmap_tpu_torch.estimators.alignment import align_reconstructions, apply_sim3
from colmap_tpu_torch.parallel import multihost
from colmap_tpu_torch.scene.clustering import SceneClusteringOptions, cluster_scene
from colmap_tpu_torch.scene.database import Database
from colmap_tpu_torch.scene.reconstruction import Reconstruction
from colmap_tpu_torch.sfm.incremental_pipeline import (
    IncrementalPipeline,
    IncrementalPipelineOptions,
)
from colmap_tpu_torch.utils import logging
from colmap_tpu_torch.utils.dtypes import resolve_device


@dataclasses.dataclass
class HierarchicalPipelineOptions:
    clustering: SceneClusteringOptions = dataclasses.field(
        default_factory=SceneClusteringOptions
    )
    incremental: IncrementalPipelineOptions = dataclasses.field(
        default_factory=IncrementalPipelineOptions
    )
    min_common_images_for_merge: int = 3
    verbose: bool = False


def merge_reconstructions(
    dst: Reconstruction, src: Reconstruction, min_common: int = 3
) -> bool:
    """Align src onto dst via shared images and merge entities.

    reference behavior: MergeReconstructions (estimators/alignment.cc).
    """
    sim = align_reconstructions(src, dst, min_common_images=min_common)
    if sim is None:
        return False
    import copy

    src = copy.deepcopy(src)
    apply_sim3(src, *sim)
    for iid in src.reg_image_ids():
        img2 = src.images[iid]
        if iid not in dst.images:
            if img2.camera_id not in dst.cameras:
                dst.add_camera(src.cameras[img2.camera_id])
            frame2 = src.frames[img2.frame_id]
            if frame2.rig_id not in dst.rigs:
                dst.add_rig(src.rigs[frame2.rig_id])
            if frame2.frame_id not in dst.frames:
                dst.add_frame(frame2)
            elif not dst.frames[frame2.frame_id].has_pose():
                # The frame container can already exist in dst (e.g. another
                # image of the same rig frame) while still unposed — adopt
                # the aligned pose from src before registering.
                dst.frames[frame2.frame_id].rig_from_world = (
                    frame2.rig_from_world
                )
            new_img = copy.deepcopy(img2)
            new_img.points2D_p3d[:] = -1
            dst.add_image(new_img)
            dst.register_frame(new_img.frame_id)
        elif not dst.is_image_registered(iid):
            dst.frames[dst.images[iid].frame_id].rig_from_world = (
                src.frames[img2.frame_id].rig_from_world
            )
            dst.register_frame(dst.images[iid].frame_id)
    from colmap_tpu_torch.scene.types import INVALID_POINT3D

    for pid, p in src.points3D.items():
        track = [
            el for el in p.track
            if el.image_id in dst.images
            and dst.is_image_registered(el.image_id)
            and dst.images[el.image_id].points2D_p3d[el.point2D_idx]
            == INVALID_POINT3D
        ]
        if len(track) >= 2:
            dst.add_point3D(p.xyz, track, color=p.color)
    return True


def _serialize_reconstruction(recon: Reconstruction) -> bytes:
    """One byte blob of a reconstruction: its bin model files, zipped."""
    import io
    import os
    import tempfile
    import zipfile

    from colmap_tpu_torch.scene.reconstruction_io import write_model

    with tempfile.TemporaryDirectory() as d:
        write_model(recon, d, fmt="bin")
        buf = io.BytesIO()
        with zipfile.ZipFile(buf, "w") as z:
            for name in sorted(os.listdir(d)):
                z.write(os.path.join(d, name), name)
        return buf.getvalue()


def _deserialize_reconstruction(data: bytes) -> Reconstruction:
    import io
    import tempfile
    import zipfile

    from colmap_tpu_torch.scene.reconstruction_io import read_model

    with tempfile.TemporaryDirectory() as d:
        with zipfile.ZipFile(io.BytesIO(data)) as z:
            z.extractall(d)
        return read_model(d)


def exchange_sub_reconstructions(subs: List[Reconstruction]) -> List[Reconstruction]:
    """Every process's leaf reconstructions on every process, in process
    order (each process holds its slice of the leaves; the Sim3 merge needs
    them all): serialized through the bin model format and exchanged with
    ``multihost.all_gather_bytes``. One process: the identity."""
    import pickle

    if multihost.process_count() == 1:
        return subs
    payload = pickle.dumps([_serialize_reconstruction(r) for r in subs])
    out: List[Reconstruction] = []
    for blob in multihost.all_gather_bytes(payload):
        out.extend(_deserialize_reconstruction(b) for b in pickle.loads(blob))
    return out


class HierarchicalPipeline:
    def __init__(self, options: HierarchicalPipelineOptions, database: Database, device=None):
        self.options = options
        self.database = database
        self.device = resolve_device(device)

    def run(self) -> List[Reconstruction]:
        # Build the pair-weight graph from verified geometries.
        weights = {}
        image_ids = [iid for (iid, _, _) in self.database.read_images()]
        for (id1, id2, g) in self.database.read_all_two_view_geometries():
            if g is not None and len(g.inlier_matches) > 0:
                weights[(id1, id2)] = float(len(g.inlier_matches))
        clusters = cluster_scene(image_ids, weights, self.options.clustering)
        if self.options.verbose:
            logging.info("Clustered %d images into %d leaves", len(image_ids), len(clusters))

        # Reconstruct each leaf independently: each process a strided slice
        # of the leaves (one process: all of them).
        local = {ci for ci, _ in multihost.local_work_slice(list(enumerate(clusters)))}
        subs: List[Reconstruction] = []
        for ci, cluster in enumerate(clusters):
            if ci not in local:
                continue
            names = {
                name for (iid, name, _) in self.database.read_images()
                if iid in set(cluster)
            }
            from colmap_tpu_torch.scene.database_cache import DatabaseCache
            from colmap_tpu_torch.sfm.incremental_mapper import IncrementalMapper

            cache = DatabaseCache.create(
                self.database,
                min_num_matches=self.options.incremental.min_num_matches,
                image_names=names,
            )
            pipeline = IncrementalPipeline(self.options.incremental, self.database,
                                           self.device)
            # Reuse the pipeline internals on the filtered cache.
            mapper = IncrementalMapper(cache, self.device)
            recon = Reconstruction()
            ok = pipeline._reconstruct_sub_model(mapper, recon)
            if ok:
                subs.append(recon)
                if self.options.verbose:
                    logging.info("  leaf %d: %d frames", ci, recon.num_reg_frames())

        subs = exchange_sub_reconstructions(subs)
        if not subs:
            return []
        # Greedy merge into the largest.
        subs.sort(key=lambda r: -r.num_reg_frames())
        merged = subs[0]
        rest = subs[1:]
        progress = True
        while rest and progress:
            progress = False
            for i, r in enumerate(rest):
                if merge_reconstructions(
                    merged, r, self.options.min_common_images_for_merge
                ):
                    rest.pop(i)
                    progress = True
                    break
        return [merged] + rest
