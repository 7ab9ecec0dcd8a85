"""Incremental mapper: registration state machine.

reference behavior: src/colmap/sfm/incremental_mapper.h:65 and
incremental_mapper.cc — initial pair search + registration, next-image
ranking, absolute-pose registration via 2D-3D correspondences over the
correspondence graph, local/global bundle adjustment, and observation
filtering (ObservationManager, sfm/observation_manager.h:50). Host Python
drives the loop; every heavy step (two-view RANSAC, P3P RANSAC, pose
refinement, triangulation, LM+Schur BA, filtering) is a batched device call.

Counterpart of colmap_tpu/sfm/incremental_mapper.py on an explicit device:
the initial pair's essential RANSAC runs in K7, registration's P3P RANSAC in
K6, camera maps in K5, new tracks in K8, point filtering in K9, and every BA
of single-sensor frames (init, local, global, pose refinement) in the packed
LM solver over K1-K4 (kernels/); structure-less registration runs as torch
ops (estimators/generalized_pose.py). Frames of several cameras register
through the generalized absolute pose (K27) and, once the model holds one,
every local and global BA is the rig BA over K24-K26
(estimators/bundle_adjustment_rig.py). Mixed camera models are not ported
yet (ROADMAP queue 1) and raise NotImplementedError.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from colmap_tpu_torch.estimators import bundle_adjustment as ba
from colmap_tpu_torch.estimators import bundle_adjustment_rig as rba
from colmap_tpu_torch.estimators.ba_setup import (
    problem_from_reconstruction,
    rig_problem_from_reconstruction,
    update_reconstruction,
    update_reconstruction_rig,
)
from colmap_tpu_torch.estimators.generalized_pose import (
    GeneralizedAbsolutePoseOptions,
    estimate_generalized_absolute_pose,
    refine_generalized_absolute_pose,
    refit_generalized_absolute_pose,
)
from colmap_tpu_torch.estimators.pose import (
    AbsolutePoseOptions,
    RefinePoseOptions,
    estimate_absolute_pose,
    refine_absolute_pose,
)
from colmap_tpu_torch.estimators.relative_pose import refine_relative_pose
from colmap_tpu_torch.estimators.two_view_geometry import _ransac_e
from colmap_tpu_torch.geometry import rotation as rot
from colmap_tpu_torch.geometry.essential import (
    cross_product_matrix,
    pose_from_essential_matrix,
    sampson_error,
    triangulate_point_dlt,
)
from colmap_tpu_torch.geometry.triangulation import triangulation_angle
from colmap_tpu_torch.kernels import sfm as K
from colmap_tpu_torch.optim.ransac import RansacOptions
from colmap_tpu_torch.scene.database_cache import DatabaseCache
from colmap_tpu_torch.scene.reconstruction import Reconstruction
from colmap_tpu_torch.scene.types import (
    INVALID_POINT3D,
    Camera,
    Frame,
    Image,
    Pose,
    Rig,
    SensorType,
    TrackElement,
)
from colmap_tpu_torch.sensor import models as camera_models
from colmap_tpu_torch.sfm.incremental_triangulator import IncrementalTriangulator, TriangulatorOptions
from colmap_tpu_torch.sfm.filtering import filter_points3D
from colmap_tpu_torch.utils.dtypes import floatx


# One solver envelope for every pipeline BA call (init / local / global),
# colmap_tpu's: PCG with a Cauchy loss; the loop exits early on
# function_tolerance, so a generous max_iterations costs nothing.
PIPELINE_BA_OPTIONS = ba.BAOptions(
    max_iterations=50, pcg_iterations=30, loss="cauchy", loss_scale=1.0,
    solver_type="pcg",
)


@dataclasses.dataclass
class IncrementalMapperOptions:
    """reference: incremental_mapper.h Options + incremental_pipeline.h."""

    init_min_num_inliers: int = 100
    init_max_error: float = 4.0
    init_max_forward_motion: float = 0.95
    init_min_tri_angle_deg: float = 16.0
    abs_pose_max_error: float = 12.0
    abs_pose_min_num_inliers: int = 30
    abs_pose_min_inlier_ratio: float = 0.25
    filter_max_reproj_error: float = 4.0
    filter_min_tri_angle_deg: float = 1.5
    max_reg_trials: int = 3
    local_ba_num_images: int = 6
    min_focal_length_ratio: float = 0.1
    max_focal_length_ratio: float = 10.0
    max_extra_param: float = 1.0
    seed: int = 0


class IncrementalMapper:
    def __init__(self, cache: DatabaseCache, device=None):
        self.cache = cache
        self.device = torch.device(device or "cuda")
        self.dtype = floatx(self.device)
        self.recon: Optional[Reconstruction] = None
        self.triangulator: Optional[IncrementalTriangulator] = None
        self.num_reg_trials: Dict[int, int] = {}
        self.num_structure_less_reg_trials: Dict[int, int] = {}
        self.num_reg_images_per_camera: Dict[int, int] = {}
        self.filtered_frames: Set[int] = set()
        self.existing_frame_ids: Set[int] = set()

    # ------------------------------------------------------------------
    def begin_reconstruction(self, recon: Reconstruction):
        self.recon = recon
        if not recon.cameras:
            for cid, cam in self.cache.cameras.items():
                recon.add_camera(dataclasses.replace(cam, params=cam.params.copy()))
            for rid, rig in self.cache.rigs.items():
                recon.add_rig(rig)
            for fid, frame in self.cache.frames.items():
                recon.add_frame(
                    Frame(frame_id=frame.frame_id, rig_id=frame.rig_id,
                          data_ids=list(frame.data_ids))
                )
            for iid, image in self.cache.images.items():
                img = Image(
                    image_id=image.image_id, name=image.name,
                    camera_id=image.camera_id, frame_id=image.frame_id,
                )
                img.points2D_xy = image.points2D_xy.copy()
                img.points2D_p3d = np.full(
                    image.num_points2D(), INVALID_POINT3D, dtype=np.int64
                )
                recon.add_image(img)
        self.existing_frame_ids = set(recon.reg_frame_ids())
        self.triangulator = IncrementalTriangulator(
            self.cache.correspondence_graph, recon, self.device
        )

    def _dev(self, a, dtype=None):
        return torch.as_tensor(np.asarray(a), dtype=dtype or self.dtype).to(self.device)

    # ------------------------------------------------------------------
    def find_initial_image_pair(
        self, options: IncrementalMapperOptions
    ) -> Optional[Tuple[int, int, Pose, np.ndarray]]:
        """Rank pairs by correspondence count; verify geometry + tri angle.

        reference behavior: FindInitialImagePair + EstimateInitialTwoViewGeometry
        (incremental_mapper.cc:154).
        """
        graph = self.cache.correspondence_graph
        pairs = sorted(graph.image_pairs(), key=lambda p: -p[2])
        for (id1, id2, n_corr) in pairs:
            if n_corr < options.init_min_num_inliers:
                continue
            if self.recon.is_image_registered(id1) or self.recon.is_image_registered(id2):
                continue
            # Same-frame pairs cannot seed two distinct frame poses
            # (the rig baseline already fixes their relative geometry).
            if (
                self.recon.images[id1].frame_id
                == self.recon.images[id2].frame_id
            ):
                continue
            result = self._estimate_initial_geometry(id1, id2, options)
            if result is not None:
                return (id1, id2) + result
        return None

    def _estimate_initial_geometry(self, id1, id2, options):
        """Direct essential-matrix estimation for the initial pair.

        reference behavior: EstimateInitialTwoViewGeometry
        (incremental_mapper.cc) estimates E with RANSAC, recovers the pose
        with cheirality, and checks inliers / triangulation angle / forward
        motion — without the E-vs-F-vs-H classification used at matching
        time.
        """
        image1 = self.recon.images[id1]
        image2 = self.recon.images[id2]
        cam1 = self.recon.cameras[image1.camera_id]
        cam2 = self.recon.cameras[image2.camera_id]
        matches = self._matches_between(id1, id2)
        if len(matches) < options.init_min_num_inliers:
            return None

        x1n, ok1 = K.cam_from_img(cam1.model_id, self._dev(cam1.params),
                                  self._dev(image1.points2D_xy[matches[:, 0]]))
        x2n, ok2 = K.cam_from_img(cam2.model_id, self._dev(cam2.params),
                                  self._dev(image2.points2D_xy[matches[:, 1]]))
        mask = ok1 & ok2
        thresh_n = 0.5 * (
            cam1.cam_from_img_threshold(options.init_max_error)
            + cam2.cam_from_img_threshold(options.init_max_error)
        )
        ransac_opts = RansacOptions(
            confidence=0.999, min_num_trials=100, max_num_trials=10000,
            min_inlier_ratio=0.25, batch_size=128,
        )
        # Narrow-FOV two-view geometry admits twisted-pair-like ambiguities
        # where a wrong pose has full epipolar support but only ~half its
        # points in front of both cameras. Run RANSAC from a few seeds,
        # Sampson-refine each candidate, and select by the number of
        # CHEIRALITY-VALID inliers (the reference's init check, which counts
        # triangulated points, is the same discriminator).
        best = None
        for trial_seed in range(3):
            gen = torch.Generator().manual_seed(options.seed + 7919 * trial_seed)
            res = _ransac_e(gen, x1n, x2n, mask, thresh_n, ransac_opts)
            if not res.success:
                continue
            R, t, _, _, _ = pose_from_essential_matrix(res.model, x1n, x2n, mask=res.inlier_mask)
            q0 = rot.rotmat_to_quat(R)
            weights = res.inlier_mask.to(x1n.dtype)
            q_ref, t_ref, _ = refine_relative_pose(q0, t, x1n, x2n, weights)
            E_ref = cross_product_matrix(t_ref) @ rot.quat_to_rotmat(q_ref)
            inl = (sampson_error(E_ref, x1n, x2n) <= float(thresh_n) ** 2) & mask
            R2, t2, points3D, num_valid, cheir_ok = pose_from_essential_matrix(
                E_ref, x1n, x2n, mask=inl)
            score = int(num_valid)
            if best is None or score > best[0]:
                best = (score, R2, t2, points3D, cheir_ok.cpu().numpy(), inl.cpu().numpy())
        if best is None:
            return None
        score, R2, t2, points3D, cheir_ok, inl = best
        if score < options.init_min_num_inliers:
            return None

        pose21 = Pose(rot.rotmat_to_quat(R2).double().cpu().numpy(), t2.double().cpu().numpy())
        # Median triangulation angle over cheirality-valid inliers.
        c2 = self._dev(pose21.projection_center())
        angles = triangulation_angle(torch.zeros_like(c2), c2, points3D).double().cpu().numpy()
        sel = cheir_ok & inl
        if not sel.any():
            return None
        tri_angle = float(np.median(angles[sel]))
        if np.rad2deg(tri_angle) < options.init_min_tri_angle_deg:
            return None
        # Reject dominant forward motion (poorly conditioned).
        tn = pose21.t / max(np.linalg.norm(pose21.t), 1e-12)
        if abs(tn[2]) > options.init_max_forward_motion:
            return None
        return (pose21, matches[inl])

    def _matches_between(self, id1, id2) -> np.ndarray:
        """Inlier matches between two images from the correspondence graph."""
        graph = self.cache.correspondence_graph
        offsets, data_img, data_idx = graph.correspondence_arrays(id1)
        rows = []
        sel = data_img == id2
        pt_idx = np.repeat(
            np.arange(len(offsets) - 1), np.diff(offsets)
        )
        rows = np.stack([pt_idx[sel], data_idx[sel]], axis=1)
        return rows.astype(np.uint32)

    # ------------------------------------------------------------------
    def register_initial_image_pair(
        self, id1: int, id2: int, cam2_from_cam1: Pose, inlier_matches: np.ndarray,
        options: IncrementalMapperOptions,
    ) -> bool:
        """Set the first two poses and triangulate the inlier matches.

        reference behavior: RegisterInitialImagePair (incremental_mapper.cc).
        """
        recon = self.recon
        image1, image2 = recon.images[id1], recon.images[id2]
        recon.set_cam_from_world(id1, Pose.identity())
        recon.set_cam_from_world(id2, cam2_from_cam1.copy().normalize())
        recon.register_frame(image1.frame_id)
        recon.register_frame(image2.frame_id)
        self._register_frame_event(image1.frame_id)
        self._register_frame_event(image2.frame_id)
        self.num_reg_trials[id1] = self.num_reg_trials.get(id1, 0) + 1
        self.num_reg_trials[id2] = self.num_reg_trials.get(id2, 0) + 1

        cam1 = recon.cameras[image1.camera_id]
        cam2 = recon.cameras[image2.camera_id]
        pose1 = recon.cam_from_world(id1)
        pose2 = recon.cam_from_world(id2)
        xy1 = image1.points2D_xy[inlier_matches[:, 0]]
        xy2 = image2.points2D_xy[inlier_matches[:, 1]]
        uv1, ok1 = K.cam_from_img(cam1.model_id, self._dev(cam1.params), self._dev(xy1))
        uv2, ok2 = K.cam_from_img(cam2.model_id, self._dev(cam2.params), self._dev(xy2))
        Xt = triangulate_point_dlt(self._dev(pose1.matrix3x4()), self._dev(pose2.matrix3x4()),
                                   uv1, uv2)
        angles = triangulation_angle(self._dev(pose1.projection_center()),
                                     self._dev(pose2.projection_center()), Xt)
        X = Xt.double().cpu().numpy()
        angles = angles.double().cpu().numpy()
        ok1, ok2 = ok1.cpu().numpy(), ok2.cpu().numpy()
        # Depth checks in both views.
        P1, P2 = pose1.matrix3x4(), pose2.matrix3x4()
        Xh = np.concatenate([X, np.ones((len(X), 1))], axis=1)
        z1 = (Xh @ P1.T)[:, 2]
        z2 = (Xh @ P2.T)[:, 2]
        good = (
            np.asarray(ok1) & np.asarray(ok2)
            & (z1 > 0) & (z2 > 0)
            & (np.rad2deg(angles) >= options.filter_min_tri_angle_deg)
            & np.all(np.isfinite(X), axis=1)
        )
        n_created = 0
        for i in np.nonzero(good)[0]:
            p1_idx, p2_idx = int(inlier_matches[i, 0]), int(inlier_matches[i, 1])
            if (
                image1.points2D_p3d[p1_idx] != INVALID_POINT3D
                or image2.points2D_p3d[p2_idx] != INVALID_POINT3D
            ):
                continue
            recon.add_point3D(
                X[i], [TrackElement(id1, p1_idx), TrackElement(id2, p2_idx)]
            )
            n_created += 1
        if n_created < options.init_min_num_inliers // 2:
            return False
        self._metric_initial_scale(id1, id2, options)
        return True

    def _metric_initial_scale(self, id1: int, id2: int, options: IncrementalMapperOptions):
        """Bring a two-view initialization to the rig's metric scale.

        The pair's relative pose fixes the baseline at 1, while the other
        images of a calibrated rig frame sit at metric sensor offsets: left
        so, triangulating them and the first rig BA meet a model whose scale
        disagrees with its rig, and converge away from the truth (colmap_tpu
        upgrades the scale only at the next rig registration, and only by a
        factor within (0.2, 5)). Here one initial frame with several images
        and known sensors is registered again by the generalized absolute
        pose with the scale free, against the pair's points, and refit over
        all its inliers; the model is scaled by that factor about the other
        initial camera, which keeps its pose, and the frame takes the refined
        metric pose.
        """
        recon = self.recon
        for anchor, other in ((id1, id2), (id2, id1)):
            frame = recon.frames[recon.images[other].frame_id]
            if len(frame.image_ids()) > 1 and self._general_frame_ready(frame, options):
                break
        else:
            return
        cams_from_rig, cameras, pts2d, pts3d, cam_idxs, _ = self._general_frame_correspondences(
            frame)
        if len(pts2d) < options.abs_pose_min_num_inliers:
            return
        pose, inlier_mask, scale = estimate_generalized_absolute_pose(
            pts2d, pts3d, cam_idxs, cams_from_rig, cameras,
            GeneralizedAbsolutePoseOptions(max_error_px=options.abs_pose_max_error,
                                           min_inlier_ratio=options.abs_pose_min_inlier_ratio),
            seed=options.seed, estimate_scale=True, device=self.device,
        )
        if pose is None or int(inlier_mask.sum()) < options.abs_pose_min_num_inliers:
            return
        pose, scale = refit_generalized_absolute_pose(
            pts2d, pts3d, cam_idxs, cams_from_rig, cameras, inlier_mask, device=self.device)
        if pose is None or not 0.0 < scale < np.inf:
            return
        anchor_pose = recon.cam_from_world(anchor)
        recon.transform(scale, np.array([1.0, 0, 0, 0]), np.zeros(3))
        recon.set_cam_from_world(anchor, Pose(anchor_pose.quat, scale * anchor_pose.t))
        pose, ok = refine_generalized_absolute_pose(
            pose, pts2d, pts3d * scale, cam_idxs, cams_from_rig, cameras, inlier_mask,
            device=self.device)
        if ok:
            frame.rig_from_world = pose

    # ------------------------------------------------------------------
    def find_next_images(self, options: IncrementalMapperOptions) -> List[int]:
        """Rank unregistered images by number of visible triangulated points.

        reference behavior: FindNextImages (incremental_mapper_impl.cc:86-321)
        — the reference uses a visibility-pyramid uncertainty score; here the
        first-order score (count of correspondences to triangulated points)
        with the same candidate filtering.
        """
        graph = self.cache.correspondence_graph
        # Two-bucket policy (incremental_mapper_impl.cc:139-151): images
        # that were filtered out or already burned a registration trial go
        # into a second bucket behind every untried image. This is what
        # lets a shared camera collect multi-view constraints from fresh
        # images before a degenerate single-view estimate is retried.
        scores, other_scores = [], []
        for image_id, image in self.recon.images.items():
            if self.recon.is_image_registered(image_id):
                continue
            if self.num_reg_trials.get(image_id, 0) >= options.max_reg_trials:
                continue
            if not graph.exists_image(image_id):
                continue
            num_visible = self._count_visible_points(image_id)
            if num_visible > 0:
                tried = self.num_reg_trials.get(image_id, 0) > 0
                filtered = image.frame_id in self.filtered_frames
                if tried or filtered:
                    other_scores.append((num_visible, image_id))
                else:
                    scores.append((num_visible, image_id))
        scores.sort(key=lambda s: (-s[0], s[1]))
        other_scores.sort(key=lambda s: (-s[0], s[1]))
        return [iid for (_, iid) in scores + other_scores]

    def _count_visible_points(self, image_id) -> int:
        """Visibility-pyramid score of a candidate image.

        reference behavior: FindNextImages MIN_UNCERTAINTY ranking via
        VisibilityPyramid (scene/visibility_pyramid.*): points2D with
        triangulated correspondences vote into multi-resolution grids; a
        well-spread set of visible points scores higher than a clustered
        one of the same size.
        """
        graph = self.cache.correspondence_graph
        offsets, data_img, data_idx = graph.correspondence_arrays(image_id)
        reg_ids = set(self.recon.reg_image_ids())
        pt_idx = np.repeat(np.arange(len(offsets) - 1), np.diff(offsets))
        seen_pts = set()
        for iid in np.unique(data_img):
            if int(iid) not in reg_ids:
                continue
            sel = data_img == iid
            other = self.recon.images[int(iid)]
            tri = other.points2D_p3d[data_idx[sel]] != INVALID_POINT3D
            for p in pt_idx[sel][tri]:
                seen_pts.add(int(p))
        if not seen_pts:
            return 0
        image = self.recon.images[image_id]
        camera = self.recon.cameras[image.camera_id]
        xy = image.points2D_xy[sorted(seen_pts)]
        score = 0
        for level in range(1, 7):
            grid = 1 << level
            cx = np.clip((xy[:, 0] / max(camera.width, 1) * grid).astype(int), 0, grid - 1)
            cy = np.clip((xy[:, 1] / max(camera.height, 1) * grid).astype(int), 0, grid - 1)
            cells = set(zip(cx.tolist(), cy.tolist()))
            score += len(cells) * (1 << level)
        return score

    # ------------------------------------------------------------------

    def _register_frame_event(self, frame_id: int):
        """Track per-camera registration counts (reference:
        RegisterFrameEvent, incremental_mapper.cc)."""
        for iid in self.recon.frames[frame_id].image_ids():
            cid = self.recon.images[iid].camera_id
            self.num_reg_images_per_camera[cid] = (
                self.num_reg_images_per_camera.get(cid, 0) + 1
            )

    def _deregister_frame_event(self, frame_id: int):
        """Mirror of _register_frame_event for frame removal (reference:
        DeRegisterFrameEvent, incremental_mapper.cc) — keeps
        num_reg_images_per_camera consistent so the reset-on-retry policy in
        register_next_image can fire."""
        for iid in self.recon.frames[frame_id].image_ids():
            cid = self.recon.images[iid].camera_id
            n = self.num_reg_images_per_camera.get(cid, 0)
            self.num_reg_images_per_camera[cid] = max(n - 1, 0)

    def _collect_2d3d_for_image(self, image_id: int) -> Tuple[List[int], List[int]]:
        """2D-3D correspondences through the correspondence graph
        (reference: RegisterNextImage correspondence collection,
        incremental_mapper.cc:296-336)."""
        recon = self.recon
        graph = self.cache.correspondence_graph
        p2d_idxs, p3d_ids = [], []
        corr_p3d_seen: Dict[int, Set[int]] = {}
        offsets, data_img, data_idx = graph.correspondence_arrays(image_id)
        pt_idx = np.repeat(np.arange(len(offsets) - 1), np.diff(offsets))
        for (p, oid, oidx) in zip(pt_idx, data_img, data_idx):
            oid = int(oid)
            if not recon.is_image_registered(oid):
                continue
            p3d = int(recon.images[oid].points2D_p3d[int(oidx)])
            if p3d == INVALID_POINT3D:
                continue
            seen = corr_p3d_seen.setdefault(int(p), set())
            if p3d in seen:
                continue
            seen.add(p3d)
            p2d_idxs.append(int(p))
            p3d_ids.append(p3d)
        return p2d_idxs, p3d_ids

    def register_next_image(self, image_id: int, options: IncrementalMapperOptions) -> bool:
        """2D-3D correspondences -> P3P LO-RANSAC -> LM refine -> continue
        tracks (reference: RegisterNextImage, incremental_mapper.cc:233-490).
        Frames with several cameras whose focal lengths are sound and whose
        sensor_from_rig are known go to generalized rig registration
        (incremental_mapper.cc:253-270).
        """
        recon = self.recon
        image = recon.images[image_id]
        frame = recon.frames[image.frame_id]
        if len(frame.image_ids()) > 1 and self._general_frame_ready(frame, options):
            return self.register_next_general_frame(frame, options)

        self.num_reg_trials[image_id] = self.num_reg_trials.get(image_id, 0) + 1
        camera = recon.cameras[image.camera_id]

        # Camera-parameter recovery policy (incremental_mapper.cc:372-429):
        # if this camera was not refined by any currently registered image,
        # its params may carry damage from an earlier filtered registration
        # — reset them to the database values. Likewise reset any bogus
        # camera of this frame so re-estimation starts clean.
        if self.num_reg_images_per_camera.get(camera.camera_id, 0) == 0:
            camera.params = self.cache.cameras[camera.camera_id].params.copy()
        for iid in frame.image_ids():
            cam_i = recon.cameras[recon.images[iid].camera_id]
            if camera_models.has_bogus_params(
                cam_i.model_id, cam_i.params, cam_i.width, cam_i.height,
                options.min_focal_length_ratio,
                options.max_focal_length_ratio, options.max_extra_param,
            ):
                cam_i.params = self.cache.cameras[cam_i.camera_id].params.copy()

        p2d_idxs, p3d_ids = self._collect_2d3d_for_image(image_id)

        if len(p2d_idxs) < options.abs_pose_min_num_inliers:
            return False

        points2D = image.points2D_xy[p2d_idxs]
        points3D = np.stack([recon.points3D[p].xyz for p in p3d_ids])

        pose_opts = AbsolutePoseOptions(
            max_error_px=options.abs_pose_max_error,
            min_inlier_ratio=options.abs_pose_min_inlier_ratio,
        )
        pose, inlier_mask, _ = estimate_absolute_pose(
            camera, points2D, points3D, pose_opts, seed=options.seed, device=self.device
        )
        if pose is None or int(inlier_mask.sum()) < options.abs_pose_min_num_inliers:
            return False

        pose, camera_new, ok = refine_absolute_pose(
            camera, pose, points2D, points3D, inlier_mask,
            RefinePoseOptions(loss="cauchy", loss_scale=1.0), device=self.device,
        )
        if not ok:
            return False
        recon.cameras[image.camera_id].params = camera_new.params

        recon.set_cam_from_world(image_id, pose)
        recon.register_frame(image.frame_id)
        self._register_frame_event(image.frame_id)

        # Continue tracks with verified inliers (one batched reproj call).
        jobs = []
        for i in np.nonzero(inlier_mask)[0]:
            p2d_idx, p3d_id = p2d_idxs[i], p3d_ids[i]
            if image.points2D_p3d[p2d_idx] != INVALID_POINT3D:
                continue
            if p3d_id not in recon.points3D:
                continue
            jobs.append((p2d_idx, p3d_id))
        if jobs:
            errs = self.triangulator._reproj_errors_px(
                recon.cameras[image.camera_id], pose,
                np.stack([recon.points3D[p].xyz for (_i, p) in jobs]),
                np.stack([image.points2D_xy[i] for (i, _p) in jobs]),
            )
            for (p2d_idx, p3d_id), err in zip(jobs, errs):
                # A 2D point may be an inlier of several 3D points (its
                # correspondences lie in different tracks): the first that
                # reprojects within the threshold takes it, as the
                # reference's HasPoint3D check at insertion does
                # (incremental_mapper.cc:463-474).
                if (err <= options.filter_max_reproj_error
                        and image.points2D_p3d[p2d_idx] == INVALID_POINT3D):
                    recon.add_observation(
                        p3d_id, TrackElement(image_id, p2d_idx)
                    )
        return True

    # ------------------------------------------------------------------
    def _general_frame_ready(self, frame: Frame, options: IncrementalMapperOptions) -> bool:
        """Every camera of the frame has a prior focal length or one refined
        by a registered image, none is bogus, and every sensor_from_rig is
        known."""
        recon = self.recon
        rig = recon.rigs[frame.rig_id]
        for iid in frame.image_ids():
            cam = recon.cameras[recon.images[iid].camera_id]
            if not cam.has_prior_focal_length and self.num_reg_images_per_camera.get(
                    cam.camera_id, 0) == 0:
                return False
            if camera_models.has_bogus_params(
                cam.model_id, cam.params, cam.width, cam.height,
                options.min_focal_length_ratio, options.max_focal_length_ratio,
                options.max_extra_param,
            ):
                return False
            if rig.sensor_from_rig((int(SensorType.CAMERA), cam.camera_id)) is None:
                return False
        return True

    def _general_frame_correspondences(self, frame: Frame):
        """The 2D-3D correspondences of all the frame's images: (cams_from_rig,
        cameras, points2D (n, 2), points3D (n, 3), camera index of each row
        (n,), [(image_id, point2D_idx, point3D_id)])."""
        recon = self.recon
        rig = recon.rigs[frame.rig_id]
        cams_from_rig, cameras = [], []
        pts2d, pts3d, cam_idxs, corrs = [], [], [], []
        for k, iid in enumerate(frame.image_ids()):
            image = recon.images[iid]
            cams_from_rig.append(rig.sensor_from_rig((int(SensorType.CAMERA), image.camera_id)))
            cameras.append(recon.cameras[image.camera_id])
            for p2d_idx, p3d_id in zip(*self._collect_2d3d_for_image(iid)):
                pts2d.append(image.points2D_xy[p2d_idx])
                pts3d.append(recon.points3D[p3d_id].xyz)
                cam_idxs.append(k)
                corrs.append((iid, p2d_idx, p3d_id))
        return (cams_from_rig, cameras, np.asarray(pts2d).reshape(-1, 2),
                np.asarray(pts3d).reshape(-1, 3), np.asarray(cam_idxs, dtype=np.int64), corrs)

    def register_next_general_frame(
        self, frame: Frame, options: IncrementalMapperOptions
    ) -> bool:
        """Generalized (multi-camera) rig registration: 2D-3D correspondences
        of all the frame's images -> gDLT LO-RANSAC (K27) -> rig-tangent LM
        refinement -> continued tracks.

        reference: RegisterNextGeneralFrame (incremental_mapper.cc:492-672,
        GP3P via EstimateGeneralizedAbsolutePose at :608).
        """
        recon = self.recon
        for iid in frame.image_ids():
            self.num_reg_trials[iid] = self.num_reg_trials.get(iid, 0) + 1
        cams_from_rig, cameras, pts2d, pts3d, cam_idxs, corrs = (
            self._general_frame_correspondences(frame))
        if len(pts2d) < options.abs_pose_min_num_inliers:
            return False
        # The world scale is estimated with the pose: a monocular-seeded model
        # has an arbitrary scale that conflicts with the metric rig baselines,
        # so the first rig registration upgrades the model to the rig's scale.
        pose, inlier_mask, scale = estimate_generalized_absolute_pose(
            pts2d, pts3d, cam_idxs, cams_from_rig, cameras,
            GeneralizedAbsolutePoseOptions(max_error_px=options.abs_pose_max_error,
                                           min_inlier_ratio=options.abs_pose_min_inlier_ratio),
            seed=options.seed, estimate_scale=True, device=self.device,
        )
        if pose is None or int(inlier_mask.sum()) < options.abs_pose_min_num_inliers:
            return False
        if 0.2 < scale < 5.0 and abs(scale - 1.0) > 1e-6:
            recon.transform(scale, np.array([1.0, 0, 0, 0]), np.zeros(3))
            pts3d = pts3d * scale
        pose, ok = refine_generalized_absolute_pose(
            pose, pts2d, pts3d, cam_idxs, cams_from_rig, cameras, inlier_mask,
            device=self.device)
        if not ok:
            return False

        frame.rig_from_world = pose
        recon.register_frame(frame.frame_id)
        self._register_frame_event(frame.frame_id)

        # Continue tracks with the inliers, image by image, each group
        # checked in one batched reprojection call.
        by_image: Dict[int, List[Tuple[int, int]]] = {}
        for i in np.nonzero(inlier_mask)[0]:
            iid, p2d_idx, p3d_id = corrs[i]
            if recon.images[iid].points2D_p3d[p2d_idx] != INVALID_POINT3D:
                continue
            if p3d_id not in recon.points3D:
                continue
            by_image.setdefault(iid, []).append((p2d_idx, p3d_id))
        for iid, jobs in by_image.items():
            image = recon.images[iid]
            errs = self.triangulator._reproj_errors_px(
                recon.cameras[image.camera_id], recon.cam_from_world(iid),
                np.stack([recon.points3D[p].xyz for (_i, p) in jobs]),
                np.stack([image.points2D_xy[i] for (i, _p) in jobs]),
            )
            for (p2d_idx, p3d_id), err in zip(jobs, errs):
                if err <= options.filter_max_reproj_error:
                    recon.add_observation(p3d_id, TrackElement(iid, p2d_idx))
        return True

    # ------------------------------------------------------------------
    def register_next_structure_less_image(
        self, image_id: int, options: IncrementalMapperOptions
    ) -> bool:
        """Structure-less resectioning from 2D-2D correspondences to
        registered images (Zheng & Wu; estimators/generalized_pose.py).

        reference: RegisterNextStructureLessImage
        (incremental_mapper.cc:673-870) — requires 2x the inliers of the
        structured path because each 2D-2D correspondence contributes one
        epipolar constraint instead of two reprojection constraints.
        """
        from colmap_tpu_torch.estimators.generalized_pose import (
            StructureLessAbsolutePoseOptions,
            estimate_structure_less_absolute_pose,
        )

        recon = self.recon
        if recon.num_reg_frames() < 2:
            return False
        self.num_structure_less_reg_trials[image_id] = (
            self.num_structure_less_reg_trials.get(image_id, 0) + 1
        )
        image = recon.images[image_id]
        camera = recon.cameras[image.camera_id]
        min_num_inliers = 2 * options.abs_pose_min_num_inliers
        # Correspondences to registered images whose camera is sound.
        offsets, data_img, data_idx = self.cache.correspondence_graph.correspondence_arrays(
            image_id)
        pt_idx = np.repeat(np.arange(len(offsets) - 1), np.diff(offsets))
        pts_new, pts_w, w_cam_idxs = [], [], []
        world_poses, world_cams = [], []
        world_image_to_idx: Dict[int, int] = {}
        for p, oid, oidx in zip(pt_idx, map(int, data_img), data_idx):
            if not recon.is_image_registered(oid):
                continue
            w_image = recon.images[oid]
            w_camera = recon.cameras[w_image.camera_id]
            if camera_models.has_bogus_params(
                w_camera.model_id, w_camera.params, w_camera.width, w_camera.height,
                options.min_focal_length_ratio, options.max_focal_length_ratio,
                options.max_extra_param,
            ):
                continue
            if oid not in world_image_to_idx:
                world_image_to_idx[oid] = len(world_poses)
                world_poses.append(recon.cam_from_world(oid))
                world_cams.append(w_camera)
            pts_new.append(image.points2D_xy[int(p)])
            pts_w.append(w_image.points2D_xy[int(oidx)])
            w_cam_idxs.append(world_image_to_idx[oid])
        if len(pts_new) < min_num_inliers or len(world_poses) < 2:
            return False
        pose, inlier_mask = estimate_structure_less_absolute_pose(
            np.asarray(pts_new), np.asarray(pts_w), np.asarray(w_cam_idxs), world_poses,
            world_cams, camera,
            # Sampson scoring: a stricter threshold than the 2D-3D path
            # (reference: incremental_mapper.cc:765).
            StructureLessAbsolutePoseOptions(max_error_px=0.5 * options.abs_pose_max_error),
            seed=options.seed, device=self.device,
        )
        if pose is None or int(inlier_mask.sum()) < min_num_inliers:
            return False
        recon.set_cam_from_world(image_id, pose)
        recon.register_frame(image.frame_id)
        self._register_frame_event(image.frame_id)
        return True

    # ------------------------------------------------------------------
    def triangulate_image(self, image_id: int, tri_options: TriangulatorOptions) -> int:
        return self.triangulator.triangulate_image(image_id, tri_options)

    # ------------------------------------------------------------------
    def local_bundle_adjustment(
        self, image_id: int, options: IncrementalMapperOptions,
        ba_options: Optional[ba.BAOptions] = None,
    ):
        """BA over the most-connected neighborhood of an image.

        reference behavior: AdjustLocalBundle + FindLocalBundle
        (incremental_mapper.h:325).
        """
        local_ids = self._find_local_bundle(image_id, options)
        if len(local_ids) < 2:
            return
        if ba_options is None:
            ba_options = PIPELINE_BA_OPTIONS
        if self._has_nontrivial_rigs():
            self._rig_local_bundle_adjustment(local_ids, ba_options)
            return
        image_set = list(local_ids)
        problem, index = problem_from_reconstruction(self.recon, image_set, device=self.device)
        if problem.obs_xy.shape[0] < 10 or problem.points.shape[0] < 4:
            return
        masks = ba.default_masks(problem, index["model_id"], ba_options)
        # Fix all images outside the local set plus the two oldest in-set
        # images when the model is larger than the local set (gauge).
        reg_all = self.recon.reg_image_ids()
        if len(reg_all) > len(image_set):
            # points observed by out-of-set images act as anchors; also fix
            # the earliest registered in-set image.
            row = index["image_ids"].index(min(image_set))
        else:
            masks = ba.fix_gauge_two_frames(masks, 0, 1)
            row = 1
        fm, ftm = masks.frame_mask.clone(), masks.frame_trans_mask.clone()
        fm[row] = 0.0
        ftm[row] = 0.0
        masks = masks._replace(frame_mask=fm, frame_trans_mask=ftm)
        solved, _ = ba.solve_packed(problem, index["model_id"], ba_options, masks)
        update_reconstruction(self.recon, solved, index)

    def _find_local_bundle(self, image_id: int, options) -> List[int]:
        """Most-connected registered images by shared 3D points."""
        recon = self.recon
        image = recon.images[image_id]
        shared: Dict[int, int] = {}
        for p3d_id in image.points2D_p3d:
            if p3d_id == INVALID_POINT3D:
                continue
            for el in recon.points3D[int(p3d_id)].track:
                if el.image_id != image_id:
                    shared[el.image_id] = shared.get(el.image_id, 0) + 1
        ranked = sorted(shared, key=shared.get, reverse=True)
        local = [image_id] + ranked[: options.local_ba_num_images - 1]
        return local

    def _has_nontrivial_rigs(self) -> bool:
        return any(
            len(self.recon.frames[fid].image_ids()) > 1
            for fid in self.recon.reg_frame_ids()
        )

    def _rig_ba(self, frame_ids: List[int], ba_options: ba.BAOptions,
                const_frames: Optional[List[int]] = None):
        """Rig-aware BA over frames: every sensor_from_rig held constant (the
        calibrated baselines fix the metric scale), the first frame fixed
        (the gauge), ``const_frames`` fixed too; frame poses and points
        refined. reference: rig-aware CeresBundleAdjuster with constant
        sensor_from_rig (estimators/bundle_adjustment_ceres.cc)."""
        recon = self.recon
        problem, index = rig_problem_from_reconstruction(recon, frame_ids, device=self.device)
        if problem.obs_xy.shape[0] < 10 or problem.points.shape[0] < 4:
            return
        model_id = index["model_id"]
        const_rows = None
        if const_frames:
            const_rows = [index["frame_ids"].index(f) for f in const_frames
                          if f in index["frame_ids"]]
        masks = rba.default_masks(problem, model_id, ba_options,
                                  ref_sensors=index["ref_sensor_rows"], const_frames=const_rows)
        fm, ftm = masks.frame_mask.clone(), masks.frame_trans_mask.clone()
        fm[0] = 0.0
        ftm[0] = 0.0
        masks = masks._replace(frame_mask=fm, frame_trans_mask=ftm,
                               sensor_mask=torch.zeros_like(masks.sensor_mask))
        solved, _ = rba.solve(problem, model_id, ba_options, masks)
        update_reconstruction_rig(recon, solved, index)

    def _rig_local_frames(self, local_ids: List[int]):
        """The registered frames of the local bundle's images, and the
        smallest of them as the constant frame when the model holds more
        frames (colmap_tpu's _rig_local_bundle_adjustment)."""
        recon = self.recon
        frame_ids = sorted({recon.images[iid].frame_id for iid in local_ids})
        frame_ids = [f for f in frame_ids if recon.is_frame_registered(f)]
        const = [min(frame_ids)] if frame_ids and recon.num_reg_frames() > len(frame_ids) else None
        return frame_ids, const

    def _rig_local_bundle_adjustment(self, local_ids: List[int], ba_options: ba.BAOptions):
        frame_ids, const_frames = self._rig_local_frames(local_ids)
        if frame_ids:
            self._rig_ba(frame_ids, ba_options, const_frames=const_frames)

    def global_bundle_adjustment(self, ba_options: Optional[ba.BAOptions] = None):
        """reference behavior: AdjustGlobalBundle."""
        recon = self.recon
        reg = recon.reg_image_ids()
        if len(reg) < 2:
            return
        if ba_options is None:
            ba_options = PIPELINE_BA_OPTIONS
        if self._has_nontrivial_rigs():
            self._rig_ba(list(recon.reg_frame_ids()), ba_options)
            return
        problem, index = problem_from_reconstruction(recon, reg, device=self.device)
        if problem.obs_xy.shape[0] < 10:
            return
        masks = ba.default_masks(problem, index["model_id"], ba_options)
        masks = ba.fix_gauge_two_frames(masks, 0, 1)
        solved, _ = ba.solve_packed(problem, index["model_id"], ba_options, masks)
        update_reconstruction(recon, solved, index)

    # ------------------------------------------------------------------
    def filter_points(self, options: IncrementalMapperOptions) -> int:
        """Remove 3D points with large error / small angle / negative depth.

        reference behavior: ObservationManager::FilterPoints3D
        (observation_manager.h:50-200); vectorized in sfm/filtering.py over K9.
        """
        return filter_points3D(
            self.recon,
            max_reproj_error=options.filter_max_reproj_error,
            min_tri_angle_deg=options.filter_min_tri_angle_deg,
            device=self.device,
        )

    def filter_frames(self, options: IncrementalMapperOptions) -> List[int]:
        """Deregister frames with too few observations or bogus params.

        reference behavior: ObservationManager::FilterFrames.
        """
        recon = self.recon
        filtered = []
        for frame_id in recon.reg_frame_ids():
            if frame_id in self.existing_frame_ids:
                continue
            n_p3d = sum(
                recon.images[iid].num_points3D() for iid in recon.frames[frame_id].image_ids()
            )
            bogus = False
            for iid in recon.frames[frame_id].image_ids():
                cam = recon.cameras[recon.images[iid].camera_id]
                if camera_models.has_bogus_params(
                    cam.model_id, cam.params, cam.width, cam.height,
                    options.min_focal_length_ratio, options.max_focal_length_ratio,
                    options.max_extra_param,
                ):
                    bogus = True
            if n_p3d < 3 or bogus:
                recon.deregister_frame(frame_id)
                self._deregister_frame_event(frame_id)
                filtered.append(frame_id)
                self.filtered_frames.add(frame_id)
        return filtered
