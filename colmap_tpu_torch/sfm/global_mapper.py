"""Global (GLOMAP-style) mapper.

Counterpart of colmap_tpu/sfm/global_mapper.py (reference behavior:
src/colmap/sfm/global_mapper.{h,cc}, Solve() at global_mapper.cc:502-613):
rotation averaging (K21) → track establishment → global positioning (K22)
→ bundle adjustment with rotations fixed, then joint rounds with filtering
(K1-K4, K5) → retriangulate-and-refine rounds (K8). The unprojection and
the filter's projection run on K5 once per camera. Track establishment, the
filter's bookkeeping and the triangulator's track completion are host
Python over every observation, as in colmap_tpu; ``timer`` holds the
seconds of each phase.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from colmap_tpu_torch.estimators import bundle_adjustment as ba
from colmap_tpu_torch.estimators.ba_setup import problem_from_reconstruction, update_reconstruction
from colmap_tpu_torch.estimators.global_positioning import (
    GlobalPositioningOptions,
    solve_global_positioning,
)
from colmap_tpu_torch.estimators.rotation_averaging import (
    RotationAveragingOptions,
    estimate_rotations,
)
from colmap_tpu_torch.geometry import rotation as rot
from colmap_tpu_torch.kernels import sfm as K
from colmap_tpu_torch.scene.database_cache import DatabaseCache
from colmap_tpu_torch.scene.reconstruction import Reconstruction
from colmap_tpu_torch.scene.types import INVALID_POINT3D, Frame, Image, Pose, TrackElement
from colmap_tpu_torch.sfm.incremental_triangulator import (
    IncrementalTriangulator,
    TriangulatorOptions,
)
from colmap_tpu_torch.utils import logging
from colmap_tpu_torch.utils.dtypes import floatx, resolve_device
from colmap_tpu_torch.utils.phase_timer import PhaseTimer
from colmap_tpu_torch.utils.types import pair_id_to_image_pair
from colmap_tpu_torch.utils.union_find import union_find_labels


@dataclasses.dataclass
class GlobalMapperOptions:
    """reference: global_mapper.h:63-110."""

    min_num_view_per_track: int = 3
    max_num_view_per_track: int = 30
    keep_max_num_tracks: int = 50000
    min_triangulation_angle_deg: float = 1.0
    max_reproj_error_px: float = 4.0  # filtering after BA
    num_iterative_ba_rounds: int = 3
    # Retriangulate-and-refine rounds after the joint BA stage
    # (reference: IterativeRetriangulateAndRefine, global_mapper.cc:588-613).
    num_retriangulation_rounds: int = 2
    # World gravity direction for the stratified rotation mode (the
    # synthetic generator's prior_gravity_in_world default).
    gravity_in_world: tuple = (0.0, 1.0, 0.0)
    rotation_averaging: RotationAveragingOptions = dataclasses.field(
        default_factory=RotationAveragingOptions
    )
    positioning: GlobalPositioningOptions = dataclasses.field(
        default_factory=GlobalPositioningOptions
    )
    ba: ba.BAOptions = dataclasses.field(
        default_factory=lambda: ba.BAOptions(
            max_iterations=30, pcg_iterations=40, loss="huber", loss_scale=2.0
        )
    )
    verbose: bool = False


class GlobalMapper:
    def __init__(self, cache: DatabaseCache, device=None, timer: Optional[PhaseTimer] = None):
        self.cache = cache
        self.device = resolve_device(device)
        self.timer = timer if timer is not None else PhaseTimer()

    def _log(self, options, msg):
        if options.verbose:
            logging.info("%s", msg)

    def _dev(self, a):
        return torch.as_tensor(np.asarray(a), dtype=floatx(self.device)).to(self.device)

    # ------------------------------------------------------------------
    def solve(self, recon: Reconstruction, rel_poses: Dict[int, Pose],
              options: Optional[GlobalMapperOptions] = None) -> bool:
        """Run the full global pipeline. rel_poses: pair_id ->
        cam2_from_cam1 of the verified pairs."""
        if options is None:
            options = GlobalMapperOptions()
        if not recon.cameras:
            self._instantiate(recon)

        # 1. Rotation averaging over the view graph.
        image_ids = sorted(recon.images.keys())
        row = {iid: i for i, iid in enumerate(image_ids)}
        edges, rel_quats, weights = [], [], []
        for pair_id, pose21 in rel_poses.items():
            id1, id2 = pair_id_to_image_pair(pair_id)
            if id1 not in row or id2 not in row:
                continue
            edges.append((row[id1], row[id2]))
            rel_quats.append(pose21.quat / np.linalg.norm(pose21.quat))
            weights.append(self.cache.correspondence_graph.num_correspondences_between(id1, id2))
        if not edges:
            return False
        # Gravity priors (the database's pose_priors, camera frame) enable the
        # 1-DOF stratified rotation mode.
        gravity_cam = np.full((len(image_ids), 3), np.nan)
        for prior in self.cache.pose_priors.values():
            g, iid = prior.get("gravity"), prior.get("data_id")
            if g is not None and iid in row and np.all(np.isfinite(g)):
                gravity_cam[row[iid]] = np.asarray(g, dtype=np.float64)
        n_grav = int(np.all(np.isfinite(gravity_cam), axis=1).sum())
        self._log(options, f"Rotation averaging over {len(edges)} edges"
                  + (f" ({n_grav} gravity-stratified frames)" if n_grav else ""))
        with self.timer.phase("rotation_averaging"):
            quats = estimate_rotations(
                len(image_ids), np.asarray(edges), np.asarray(rel_quats),
                np.asarray(weights, dtype=np.float64), options=options.rotation_averaging,
                gravity_cam=gravity_cam if n_grav else None,
                gravity_in_world=options.gravity_in_world, device=self.device)

        # 2. Track establishment from the correspondence graph.
        with self.timer.phase("tracks"):
            tracks = self._establish_tracks(recon, options)
        if not tracks:
            return False

        # 3. Global positioning on world-frame bearings.
        self._log(options, f"Global positioning: {len(tracks)} tracks")
        with self.timer.phase("positioning"):
            centers, points = self._position(recon, image_ids, row, quats, tracks, options)

        for iid in image_ids:
            q = quats[row[iid]]
            t = -Pose(q, np.zeros(3)).apply(centers[row[iid]][None])[0]
            recon.set_cam_from_world(iid, Pose(q, t))
            recon.register_frame(recon.images[iid].frame_id)
        for t_idx, track in enumerate(tracks):
            elements = [TrackElement(iid, p) for (iid, p) in track
                        if recon.images[iid].points2D_p3d[p] == INVALID_POINT3D]
            if len(elements) >= 2:
                recon.add_point3D(points[t_idx], elements)

        # 4. Iterative BA: rotations fixed first, then joint rounds.
        self._log(options, "Stage-1 BA (rotations fixed)")
        with self.timer.phase("ba_stage1"):
            self._global_ba(recon, options, refine_rotations=False)
        for i in range(options.num_iterative_ba_rounds):
            self._log(options, f"Joint BA round {i + 1}")
            with self.timer.phase("ba_joint"):
                self._global_ba(recon, options, refine_rotations=True)
            with self.timer.phase("filter"):
                n = self._filter_points(recon, options)
            self._log(options, f"  filtered {n} observations")
            if n == 0:
                break

        # 5. Retriangulate-and-refine (reference: IterativeRetriangulateAndRefine).
        if options.num_retriangulation_rounds > 0:
            tri = IncrementalTriangulator(self.cache.correspondence_graph, recon,
                                          device=self.device)
            tri_opts = TriangulatorOptions(
                complete_max_reproj_error_px=options.max_reproj_error_px,
                merge_max_reproj_error_px=options.max_reproj_error_px,
            )
            for i in range(options.num_retriangulation_rounds):
                with self.timer.phase("retriangulate"):
                    n_tri = tri.retriangulate(tri_opts)
                with self.timer.phase("complete_merge"):
                    tri.complete_and_merge_tracks(list(recon.points3D.keys()), tri_opts)
                self._log(options, f"Retriangulation round {i + 1}: {n_tri} obs")
                with self.timer.phase("ba_retriangulation"):
                    self._global_ba(recon, options, refine_rotations=True)
                with self.timer.phase("filter"):
                    n = self._filter_points(recon, options)
                self._log(options, f"  filtered {n} observations")
                if n == 0 and n_tri == 0:
                    break
        recon.update_point3D_errors()
        return recon.num_reg_frames() >= 2

    def _instantiate(self, recon: Reconstruction):
        """Scene entities from the cache, every 2D point without a 3D point."""
        for cam in self.cache.cameras.values():
            recon.add_camera(dataclasses.replace(cam, params=cam.params.copy()))
        for rig in self.cache.rigs.values():
            recon.add_rig(rig)
        for frame in self.cache.frames.values():
            recon.add_frame(Frame(frame_id=frame.frame_id, rig_id=frame.rig_id,
                                  data_ids=list(frame.data_ids)))
        for image in self.cache.images.values():
            img = Image(image_id=image.image_id, name=image.name, camera_id=image.camera_id,
                        frame_id=image.frame_id)
            img.points2D_xy = image.points2D_xy.copy()
            img.points2D_p3d = np.full(image.num_points2D(), INVALID_POINT3D, dtype=np.int64)
            recon.add_image(img)

    def _position(self, recon, image_ids, row, quats, tracks, options):
        """World-frame bearings of every track observation (K5 unprojection
        once per camera, R_iᵀ d), then solve_global_positioning."""
        obs_iid = np.array([iid for track in tracks for (iid, _) in track])
        obs_p2d = np.array([p for track in tracks for (_, p) in track])
        obs_trk = np.repeat(np.arange(len(tracks)), [len(t) for t in tracks])
        obs_xy = np.stack([recon.images[iid].points2D_xy[p] for iid, p in zip(obs_iid, obs_p2d)])
        cam_of_obs = np.array([recon.images[iid].camera_id for iid in obs_iid])
        uv = np.zeros((len(obs_iid), 2))
        ok = np.zeros(len(obs_iid), dtype=bool)
        for cid in np.unique(cam_of_obs):
            cam = recon.cameras[int(cid)]
            sel = cam_of_obs == cid
            uv_c, ok_c = K.cam_from_img(cam.model_id, self._dev(cam.params), self._dev(obs_xy[sel]))
            uv[sel] = uv_c.double().cpu().numpy()
            ok[sel] = ok_c.cpu().numpy()
        d_cam = np.concatenate([uv, np.ones((len(uv), 1))], axis=1)
        d_cam /= np.linalg.norm(d_cam, axis=1, keepdims=True)
        Rs = rot.quat_to_rotmat(torch.from_numpy(quats)).numpy()  # (N, 3, 3)
        obs_row = np.array([row[iid] for iid in obs_iid])
        dirs = np.einsum("oji,oj->oi", Rs[obs_row], d_cam)  # R_iᵀ d_cam
        return solve_global_positioning(len(image_ids), len(tracks), obs_row[ok], obs_trk[ok],
                                        dirs[ok], options=options.positioning, device=self.device)

    # ------------------------------------------------------------------
    def _establish_tracks(self, recon, options) -> List[List[Tuple[int, int]]]:
        """Union-find over feature correspondences -> consistent tracks
        (reference: global_mapper.cc EstablishTracks): at least
        min_num_view_per_track views, no two observations in one image, at
        most max_num_view_per_track kept, longest tracks first."""
        graph = self.cache.correspondence_graph
        image_ids = sorted(recon.images.keys())
        offsets_by_image: Dict[int, int] = {}
        total = 0
        for iid in image_ids:
            offsets_by_image[iid] = total
            total += recon.images[iid].num_points2D()

        edges_a, edges_b = [], []
        for iid in image_ids:
            if not graph.exists_image(iid):
                continue
            offs, data_img, data_idx = graph.correspondence_arrays(iid)
            pt_idx = np.repeat(np.arange(len(offs) - 1), np.diff(offs))
            sel = data_img > iid  # each undirected edge once
            src = offsets_by_image[iid] + pt_idx[sel]
            other_base = np.array([offsets_by_image.get(int(o), -1) for o in data_img[sel]],
                                  dtype=np.int64)
            keep = other_base >= 0
            edges_a.append(src[keep].astype(np.int64))
            edges_b.append(other_base[keep] + data_idx[sel][keep])
        if not edges_a:
            return []
        ea = np.concatenate(edges_a)
        eb = np.concatenate(edges_b)
        labels = union_find_labels(total, ea, eb)

        # Group the nodes of at least one correspondence, in node order.
        touched = np.unique(np.concatenate([ea, eb]))
        groups: Dict[int, List[Tuple[int, int]]] = {}
        bounds = np.array([offsets_by_image[iid] for iid in image_ids] + [total])
        img_of = np.searchsorted(bounds, touched, side="right") - 1
        for node, img_row in zip(touched.tolist(), img_of.tolist()):
            iid = image_ids[img_row]
            groups.setdefault(int(labels[node]), []).append((iid, node - offsets_by_image[iid]))

        tracks = []
        for nodes in groups.values():
            if len(nodes) < options.min_num_view_per_track:
                continue
            by_img = dict(nodes)  # image id -> point2D index
            if len(by_img) != len(nodes):  # two observations in one image
                continue
            track = list(by_img.items())[: options.max_num_view_per_track]
            if len(track) >= options.min_num_view_per_track:
                tracks.append(track)
        tracks.sort(key=len, reverse=True)
        return tracks[: options.keep_max_num_tracks]

    # ------------------------------------------------------------------
    def _global_ba(self, recon, options, refine_rotations=True):
        reg = recon.reg_image_ids()
        if len(reg) < 2:
            return
        ba_opts = dataclasses.replace(options.ba, refine_rotations=refine_rotations)
        problem, index = problem_from_reconstruction(recon, reg, device=self.device)
        if problem.obs_xy.shape[0] < 10:
            return
        masks = ba.fix_gauge_two_frames(ba.default_masks(problem, index["model_id"], ba_opts),
                                        0, 1)
        solved, _ = ba.solve(problem, index["model_id"], ba_opts, masks)
        update_reconstruction(recon, solved, index)

    def _filter_points(self, recon, options) -> int:
        """Reprojection-error and cheirality filtering: the poses applied in
        one numpy pass, the projection on K5 once per camera."""
        obs = [(p3d_id, el.image_id, el.point2D_idx)
               for p3d_id, point in recon.points3D.items() for el in point.track]
        if not obs:
            return 0
        p3d_ids, img_ids, p2d_idx = (np.array(c) for c in zip(*obs))
        xyz = np.stack([recon.points3D[p].xyz for p in p3d_ids])
        xy = np.stack([recon.images[i].points2D_xy[p] for i, p in zip(img_ids, p2d_idx)])
        uniq_imgs, inv = np.unique(img_ids, return_inverse=True)
        Rs = np.stack([recon.cam_from_world(i).rotmat() for i in uniq_imgs])
        ts = np.stack([recon.cam_from_world(i).t for i in uniq_imgs])
        Xc = np.einsum("oij,oj->oi", Rs[inv], xyz) + ts[inv]
        cam_of = np.array([recon.images[i].camera_id for i in uniq_imgs])[inv]
        bad = Xc[:, 2] <= 0
        err = np.full(len(obs), np.inf)
        for cid in np.unique(cam_of):
            cam = recon.cameras[int(cid)]
            sel = (cam_of == cid) & ~bad
            if not sel.any():
                continue
            proj, ok = K.img_from_cam(cam.model_id, self._dev(cam.params), self._dev(Xc[sel]))
            e = np.linalg.norm(proj.double().cpu().numpy() - xy[sel], axis=1)
            e[~ok.cpu().numpy()] = np.inf
            err[sel] = e
        drop = bad | (err > options.max_reproj_error_px)
        num_filtered = 0
        for k in np.nonzero(drop)[0]:
            if int(p3d_ids[k]) in recon.points3D:
                recon.delete_observation(int(img_ids[k]), int(p2d_idx[k]))
                num_filtered += 1
        return num_filtered
