"""Incremental reconstruction pipeline driver.

reference behavior: src/colmap/controllers/incremental_pipeline.{h,cc} —
DatabaseCache load, sub-model loop, initialization with constraint
relaxation, the register/triangulate/local-BA loop, growth-ratio-triggered
global refinement, and final global BA (Reconstruct/ReconstructSubModel,
incremental_pipeline.cc:381-713). Counterpart of
colmap_tpu/sfm/incremental_pipeline.py with the same options and defaults;
the pipeline runs on an explicit device (``cuda`` unless the caller asks for
the CPU) and keeps a PhaseTimer of its phases.
"""

from __future__ import annotations

import dataclasses
from typing import List

from colmap_tpu_torch.scene.database import Database
from colmap_tpu_torch.scene.database_cache import DatabaseCache
from colmap_tpu_torch.scene.reconstruction import Reconstruction
from colmap_tpu_torch.sfm.incremental_mapper import (
    PIPELINE_BA_OPTIONS,
    IncrementalMapper,
    IncrementalMapperOptions,
)
from colmap_tpu_torch.sfm.incremental_triangulator import TriangulatorOptions
from colmap_tpu_torch.utils import logging
from colmap_tpu_torch.utils.dtypes import resolve_device
from colmap_tpu_torch.utils.phase_timer import PhaseTimer


@dataclasses.dataclass
class IncrementalPipelineOptions:
    """reference: controllers/incremental_pipeline.h:60-217."""

    min_num_matches: int = 15
    ignore_watermarks: bool = False
    max_num_models: int = 50
    min_model_size: int = 10
    ba_global_frames_ratio: float = 1.1
    ba_global_points_ratio: float = 1.1
    ba_local_num_images: int = 6
    ba_local_max_refinements: int = 2
    ba_global_max_refinements: int = 5
    init_num_trials: int = 200
    # Periodic snapshots + wall-clock budget
    # (reference: incremental_pipeline.cc:106-120, incremental_pipeline.h:192).
    snapshot_path: str = ""
    snapshot_frames_freq: int = 0
    max_runtime_minutes: float = -1.0
    # Structure-less resectioning fallback for images without enough 2D-3D
    # correspondences (reference: incremental_pipeline.h:83-86).
    structure_less_registration_fallback: bool = True
    structure_less_registration_only: bool = False
    mapper: IncrementalMapperOptions = dataclasses.field(
        default_factory=IncrementalMapperOptions
    )
    triangulator: TriangulatorOptions = dataclasses.field(
        default_factory=TriangulatorOptions
    )
    verbose: bool = False


class IncrementalPipeline:
    def __init__(self, options: IncrementalPipelineOptions, database: Database, device=None):
        self.options = options
        self.database = database
        self.device = resolve_device(device)
        self.reconstructions: List[Reconstruction] = []
        self.timer = PhaseTimer()

    def _log(self, msg):
        if self.options.verbose:
            logging.info("%s", msg)

    def run(self) -> List[Reconstruction]:
        # Whole-run wall clock (reference: Timer + PrintMinutes around
        # IncrementalPipeline::Run, incremental_pipeline.cc:382,447).
        run_timer = logging.Timer()
        run_timer.start()
        if self.options.verbose:
            logging.log_heading("Loading database")
        cache = DatabaseCache.create(
            self.database,
            min_num_matches=self.options.min_num_matches,
            ignore_watermarks=self.options.ignore_watermarks,
        )
        self._log(
            f"Loaded database: {len(cache.images)} images, "
            f"{len(cache.correspondence_graph.image_pairs())} verified pairs"
        )
        mapper = IncrementalMapper(cache, self.device)
        num_images = len(cache.images)
        for _ in range(self.options.max_num_models):
            recon = Reconstruction()
            ok = self._reconstruct_sub_model(mapper, recon)
            if ok and recon.num_reg_frames() >= 2:
                self.reconstructions.append(recon)
            # Registered images against images: colmap_tpu counts frames
            # here, so a rig scene (frames of several images) never reaches
            # its image count and reconstructs the same frames again.
            reg_total = sum(len(r.reg_image_ids()) for r in self.reconstructions)
            if reg_total >= num_images or not ok:
                break
            # Mark registered images as used (cannot seed a new model).
            if not ok:
                break
        # Sort largest first (reference: ReconstructionManager ordering).
        self.reconstructions.sort(key=lambda r: -r.num_reg_frames())
        if self.options.verbose:
            run_timer.print_minutes()
            self.timer.report()
        return self.reconstructions

    # ------------------------------------------------------------------
    def _reconstruct_sub_model(self, mapper: IncrementalMapper, recon: Reconstruction) -> bool:
        opts = self.options
        mapper.begin_reconstruction(recon)

        with self.timer.phase("init_pair_search"):
            init = mapper.find_initial_image_pair(opts.mapper)
        if init is None:
            # Relax constraints x2 (reference: incremental_pipeline.cc:418-445).
            relaxed = dataclasses.replace(
                opts.mapper,
                init_min_num_inliers=opts.mapper.init_min_num_inliers // 2,
                init_min_tri_angle_deg=opts.mapper.init_min_tri_angle_deg / 2,
            )
            init = mapper.find_initial_image_pair(relaxed)
            if init is None:
                relaxed = dataclasses.replace(
                    relaxed,
                    init_min_num_inliers=relaxed.init_min_num_inliers // 2,
                    init_min_tri_angle_deg=relaxed.init_min_tri_angle_deg / 2,
                )
                init = mapper.find_initial_image_pair(relaxed)
        if init is None:
            self._log("No good initial pair found")
            return False
        id1, id2, pose21, inliers = init
        self._log(f"Initializing with image pair ({id1}, {id2})")
        if not mapper.register_initial_image_pair(id1, id2, pose21, inliers, opts.mapper):
            return False
        # Triangulate the remaining rig images of the two initial frames
        # (reference: incremental_pipeline.cc:488-496).
        for iid in (id1, id2):
            frame = recon.frames[recon.images[iid].frame_id]
            for fiid in frame.image_ids():
                if fiid not in (id1, id2):
                    mapper.triangulate_image(fiid, opts.triangulator)
        with self.timer.phase("global_ba"):
            mapper.global_bundle_adjustment(PIPELINE_BA_OPTIONS)
        with self.timer.phase("filter"):
            mapper.filter_points(opts.mapper)

        last_global_frames = 2
        last_global_points = recon.num_points3D()

        import time as _time

        start_time = _time.time()
        last_snapshot_frames = 0
        while True:
            if (
                opts.max_runtime_minutes > 0
                and (_time.time() - start_time) / 60.0 > opts.max_runtime_minutes
            ):
                self._log("Max runtime reached")
                break
            with self.timer.phase("rank_next_images"):
                next_images = mapper.find_next_images(opts.mapper)
            if not next_images:
                break
            # reference: incremental_pipeline.cc:575-630 — structured
            # registration first, structure-less resectioning as fallback.
            if opts.structure_less_registration_only:
                structure_less_flags = (True,)
            elif opts.structure_less_registration_fallback:
                structure_less_flags = (False, True)
            else:
                structure_less_flags = (False,)
            registered_any = False
            for image_id in next_images:
                self._log(
                    f"Registering image #{image_id} "
                    f"({recon.num_reg_frames() + 1})"
                )
                reg_ok = False
                with self.timer.phase("register"):
                    for structure_less in structure_less_flags:
                        if structure_less:
                            reg_ok = mapper.register_next_structure_less_image(
                                image_id, opts.mapper
                            )
                            if reg_ok:
                                self._log(
                                    f"Registered image #{image_id} "
                                    "structure-less"
                                )
                        else:
                            reg_ok = mapper.register_next_image(
                                image_id, opts.mapper
                            )
                        if reg_ok:
                            break
                if reg_ok:
                    registered_any = True
                    # Triangulate every image of the registered frame, not
                    # just the triggering one (reference:
                    # incremental_pipeline.cc:651-655) — rig frames register
                    # all their cameras at once.
                    frame = recon.frames[recon.images[image_id].frame_id]
                    with self.timer.phase("triangulate"):
                        for fiid in frame.image_ids():
                            mapper.triangulate_image(fiid, opts.triangulator)
                    self._iterative_local_refinement(mapper, image_id)
                    if (
                        recon.num_reg_frames()
                        >= opts.ba_global_frames_ratio * last_global_frames
                        or recon.num_points3D()
                        >= opts.ba_global_points_ratio * last_global_points
                    ):
                        self._iterative_global_refinement(mapper)
                        last_global_frames = recon.num_reg_frames()
                        last_global_points = recon.num_points3D()
                    if (
                        opts.snapshot_frames_freq > 0
                        and opts.snapshot_path
                        and recon.num_reg_frames()
                        >= last_snapshot_frames + opts.snapshot_frames_freq
                    ):
                        import os as _os

                        from colmap_tpu_torch.scene.reconstruction_io import write_model

                        snap = _os.path.join(
                            opts.snapshot_path,
                            f"snapshot_{recon.num_reg_frames():06d}",
                        )
                        write_model(recon, snap, fmt="bin")
                        last_snapshot_frames = recon.num_reg_frames()
                        self._log(f"Snapshot -> {snap}")
                    break  # re-rank after each registration
            if not registered_any:
                break

        self._iterative_global_refinement(mapper)
        recon.update_point3D_errors()
        return recon.num_reg_frames() >= 2

    # ------------------------------------------------------------------
    def _iterative_local_refinement(self, mapper: IncrementalMapper, image_id: int):
        """reference behavior: IterativeLocalRefinement
        (incremental_pipeline.cc:1248): local BA + complete/merge + filter,
        repeated up to ba_local_max_refinements."""
        for _ in range(self.options.ba_local_max_refinements):
            with self.timer.phase("local_ba"):
                mapper.local_bundle_adjustment(image_id, self.options.mapper)
            image = mapper.recon.images[image_id]
            pts = set(
                int(p) for p in image.points2D_p3d if p != -1
            )
            with self.timer.phase("complete_merge"):
                changed = mapper.triangulator.complete_and_merge_tracks(
                    pts, self.options.triangulator
                )
            with self.timer.phase("filter"):
                mapper.filter_points(self.options.mapper)
            if changed == 0:
                break

    def _iterative_global_refinement(self, mapper: IncrementalMapper):
        """reference behavior: IterativeGlobalRefinement
        (incremental_pipeline.cc:1286): retriangulate + global BA + filters
        until stable (≤ ba_global_max_refinements rounds)."""
        with self.timer.phase("complete_merge"):
            mapper.triangulator.complete_and_merge_tracks(
                list(mapper.recon.points3D.keys()), self.options.triangulator
            )
        for _ in range(self.options.ba_global_max_refinements):
            with self.timer.phase("global_ba"):
                mapper.global_bundle_adjustment()
            with self.timer.phase("complete_merge"):
                changed = mapper.triangulator.complete_and_merge_tracks(
                    list(mapper.recon.points3D.keys()),
                    self.options.triangulator,
                )
            with self.timer.phase("filter"):
                changed += mapper.filter_points(self.options.mapper)
                mapper.filter_frames(self.options.mapper)
            if changed == 0:
                break
