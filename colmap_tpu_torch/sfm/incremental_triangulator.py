"""Incremental triangulation over the correspondence graph.

reference behavior: src/colmap/sfm/incremental_triangulator.h:43-190 —
per-image Find/Create/Continue/Merge/Complete operations. The decision logic
(which tracks to extend or create) stays on host over the CSR graph; the
numeric work — multi-view DLT, reprojection and angle checks — is batched
per image into single device calls (triangulate candidates padded to a fixed
view count). Counterpart of colmap_tpu/sfm/incremental_triangulator.py: the
camera maps run in the CUDA kernel K5 and the triangulation of new tracks,
robust or not, in K8 (kernels/sfm.py), on the triangulator's device.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from colmap_tpu_torch.estimators.triangulation import TriangulationOptions, estimate_triangulation
from colmap_tpu_torch.kernels import sfm as K
from colmap_tpu_torch.scene.correspondence_graph import CorrespondenceGraph
from colmap_tpu_torch.scene.reconstruction import Reconstruction
from colmap_tpu_torch.scene.types import INVALID_POINT3D, Pose, TrackElement
from colmap_tpu_torch.utils.dtypes import floatx


@dataclasses.dataclass
class TriangulatorOptions:
    """reference: incremental_triangulator.h Options."""

    max_transitivity: int = 1
    create_max_angle_error_deg: float = 2.0
    continue_max_angle_error_deg: float = 2.0
    merge_max_reproj_error_px: float = 4.0
    complete_max_reproj_error_px: float = 4.0
    min_angle_deg: float = 1.5
    ignore_two_view_tracks: bool = True
    min_focal_length_ratio: float = 0.1
    max_focal_length_ratio: float = 10.0
    max_extra_param: float = 1.0
    # RANSAC over view pairs at creation (reference:
    # estimators/triangulation.h EstimateTriangulation); plain N-view DLT
    # when disabled.
    robust_creation: bool = True


class IncrementalTriangulator:
    def __init__(self, graph: CorrespondenceGraph, recon: Reconstruction, device=None):
        self.graph = graph
        self.recon = recon
        self.device = torch.device(device or "cuda")
        self.dtype = floatx(self.device)

    def _dev(self, a):
        return torch.as_tensor(np.asarray(a), dtype=self.dtype).to(self.device).contiguous()

    # ------------------------------------------------------------------
    def _cam_data(self, image_id):
        image = self.recon.images[image_id]
        camera = self.recon.cameras[image.camera_id]
        pose = self.recon.cam_from_world(image_id)
        return image, camera, pose

    def _normalized(self, camera, xy):
        """Pixel coordinates -> the z = 1 plane, through K5."""
        uv, ok = K.cam_from_img(camera.model_id, self._dev(camera.params), self._dev(xy))
        return uv.double().cpu().numpy(), ok.cpu().numpy()

    def _reproj_error_px(self, camera, pose: Pose, X, xy) -> float:
        return float(self._reproj_errors_px(
            camera, pose, np.asarray(X)[None], np.asarray(xy)[None]
        )[0])

    def _reproj_errors_px(self, camera, pose: Pose, Xs, xys) -> np.ndarray:
        """Reprojection errors of world points Xs in one image: one K5 call
        for all candidate observations (inf behind the camera)."""
        n = len(Xs)
        if n == 0:
            return np.zeros(0, dtype=np.float64)
        Xc = pose.apply(np.asarray(Xs, dtype=np.float64))
        proj, valid = K.img_from_cam(camera.model_id, self._dev(camera.params), self._dev(Xc))
        err = np.linalg.norm(proj.double().cpu().numpy() - np.asarray(xys), axis=-1)
        err[(~valid.cpu().numpy()) | (Xc[:, 2] <= 0)] = np.inf
        return err

    def _reproj_errors_mixed(self, items) -> np.ndarray:
        """Reprojection errors for observations under different cameras and
        poses: one K5 call per camera model with per-row parameters.

        items: sequence of (image_id, p2d_idx, X (3,)).
        """
        out = np.full(len(items), np.inf, dtype=np.float64)
        by_model: Dict[int, List[int]] = {}
        for idx, (iid, _p2d, _X) in enumerate(items):
            cam = self.recon.cameras[self.recon.images[iid].camera_id]
            by_model.setdefault(int(cam.model_id), []).append(idx)
        for model_id, idxs in by_model.items():
            n = len(idxs)
            Xc = np.zeros((n, 3))
            xys = np.zeros((n, 2))
            P = len(self.recon.cameras[self.recon.images[items[idxs[0]][0]].camera_id].params)
            params = np.zeros((n, P))
            for row, idx in enumerate(idxs):
                iid, p2d_idx, X = items[idx]
                img = self.recon.images[iid]
                Xc[row] = self.recon.cam_from_world(iid).apply(np.asarray(X)[None])[0]
                xys[row] = img.points2D_xy[p2d_idx]
                params[row] = self.recon.cameras[img.camera_id].params
            proj, valid = K.img_from_cam(model_id, self._dev(params), self._dev(Xc))
            err = np.linalg.norm(proj.double().cpu().numpy() - xys, axis=-1)
            err[(~valid.cpu().numpy()) | (Xc[:, 2] <= 0)] = np.inf
            out[idxs] = err
        return out

    # ------------------------------------------------------------------
    def triangulate_image(self, image_id: int, options: Optional[TriangulatorOptions] = None) -> int:
        """Triangulate/extend tracks for all observations of an image.

        Returns number of observations added (reference:
        IncrementalTriangulator::TriangulateImage).
        """
        if options is None:
            options = TriangulatorOptions()
        image, camera, pose = self._cam_data(image_id)
        num_tris = 0

        # Gather correspondences to registered images for every point2D.
        continue_jobs = []  # (p2d_idx, point3D_id)
        create_jobs = []  # (p2d_idx, [(other_image_id, other_idx), ...])
        for p2d_idx in range(image.num_points2D()):
            if image.points2D_p3d[p2d_idx] != INVALID_POINT3D:
                continue
            corrs = self.graph.find_transitive_correspondences(
                image_id, p2d_idx, options.max_transitivity
            )
            reg_corrs = [
                (int(oid), int(oidx))
                for (oid, oidx) in corrs
                if self.recon.is_image_registered(int(oid))
            ]
            if not reg_corrs:
                continue
            # Existing 3D points among correspondences -> continue tracks.
            p3d_ids = [
                int(self.recon.images[oid].points2D_p3d[oidx])
                for (oid, oidx) in reg_corrs
            ]
            with_p3d = [p for p in p3d_ids if p != INVALID_POINT3D]
            if with_p3d:
                # Most frequent candidate.
                vals, counts = np.unique(with_p3d, return_counts=True)
                continue_jobs.append((p2d_idx, int(vals[np.argmax(counts)])))
            else:
                create_jobs.append(
                    (p2d_idx, [rc for rc, p in zip(reg_corrs, p3d_ids) if p == INVALID_POINT3D])
                )

        # Continue tracks: check reprojection errors of the candidate
        # points in ONE batched device call.
        live_jobs = [
            (p2d_idx, p3d_id) for (p2d_idx, p3d_id) in continue_jobs
            if p3d_id in self.recon.points3D
        ]
        if live_jobs:
            Xs = np.stack([
                self.recon.points3D[p].xyz for (_i, p) in live_jobs
            ])
            xys = np.stack([
                image.points2D_xy[i] for (i, _p) in live_jobs
            ])
            errs = self._reproj_errors_px(camera, pose, Xs, xys)
            for (p2d_idx, p3d_id), err in zip(live_jobs, errs):
                if err <= options.merge_max_reproj_error_px:
                    self.recon.add_observation(
                        p3d_id, TrackElement(image_id, p2d_idx)
                    )
                    num_tris += 1

        # Create new tracks by multi-view triangulation.
        num_tris += self._create_points(image_id, create_jobs, options)
        return num_tris

    def _create_points(self, image_id, create_jobs, options) -> int:
        if not create_jobs:
            return 0
        image, camera, pose = self._cam_data(image_id)
        uv_ref, ok_ref = self._normalized(camera, image.points2D_xy)
        proj_ref = pose.matrix3x4()
        center_ref = pose.projection_center()

        # Normalize every partner image's keypoints once per call (one K5
        # launch per image, not one per (row, view)).
        norm_cache: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}

        def _norm_of(oid):
            if oid not in norm_cache:
                oimg = self.recon.images[oid]
                ocam = self.recon.cameras[oimg.camera_id]
                norm_cache[oid] = self._normalized(ocam, oimg.points2D_xy)
            return norm_cache[oid]

        MAX_V = 8  # views per triangulation batch row (incl. reference)
        rows = []  # (p2d_idx, elements, proj_mats (V,3,4), uvs (V,2), mask (V,))
        for (p2d_idx, corrs) in create_jobs:
            if not ok_ref[p2d_idx]:
                continue
            elements = [TrackElement(image_id, p2d_idx)]
            projs = [proj_ref]
            uvs = [uv_ref[p2d_idx]]
            centers = [center_ref]
            for (oid, oidx) in corrs[: MAX_V - 1]:
                oimg, ocam, opose = self._cam_data(oid)
                # Skip if that observation already got a 3D point meanwhile.
                if oimg.points2D_p3d[oidx] != INVALID_POINT3D:
                    continue
                ouv_all, ook_all = _norm_of(oid)
                ouv, ook = ouv_all[oidx][None], ook_all[oidx][None]
                if not ook[0]:
                    continue
                elements.append(TrackElement(oid, oidx))
                projs.append(opose.matrix3x4())
                uvs.append(ouv[0])
                centers.append(opose.projection_center())
            if len(elements) < 2:
                continue
            if options.ignore_two_view_tracks and len(elements) < 3:
                # Two-view tracks optionally ignored at creation
                # (reference default keeps them off).
                continue
            rows.append((p2d_idx, elements, projs, uvs, centers))

        if not rows:
            return 0

        # Pad to fixed view count and batch the triangulation on device.
        B = len(rows)
        proj_arr = np.zeros((B, MAX_V, 3, 4))
        uv_arr = np.zeros((B, MAX_V, 2))
        mask_arr = np.zeros((B, MAX_V))
        for b, (_, elements, projs, uvs, centers) in enumerate(rows):
            v = len(projs)
            proj_arr[b, :v] = np.stack(projs)
            uv_arr[b, :v] = np.stack(uvs)
            mask_arr[b, :v] = 1.0
        robust_inl = None
        if options.robust_creation:
            out = estimate_triangulation(
                self._dev(proj_arr[:, :, :, :3]), self._dev(proj_arr[:, :, :, 3]),
                self._dev(uv_arr), self._dev(mask_arr) > 0,
                TriangulationOptions(min_tri_angle_deg=options.min_angle_deg,
                                     max_angular_error_deg=options.create_max_angle_error_deg),
            )
            X = out["xyz"].double().cpu().numpy()
            robust_inl = out["inlier_mask"].cpu().numpy()
            robust_ok = out["success"].cpu().numpy()
        else:
            X = K.triangulate_multi_view_tracks(
                self._dev(proj_arr[:, :, :, :3]), self._dev(proj_arr[:, :, :, 3]),
                self._dev(uv_arr), self._dev(mask_arr) > 0,
            ).double().cpu().numpy()

        num_created = 0
        for b, (p2d_idx, elements, projs, uvs, centers) in enumerate(rows):
            Xb = X[b]
            if not np.all(np.isfinite(Xb)):
                continue
            if robust_inl is not None:
                if not robust_ok[b]:
                    continue
                # Drop observations rejected by the pairwise RANSAC.
                kept = [
                    (el, proj, uv, center)
                    for v, (el, proj, uv, center) in enumerate(
                        zip(elements, projs, uvs, centers)
                    )
                    if robust_inl[b, v]
                ]
                if len(kept) < 2:
                    continue
                elements = [k[0] for k in kept]
                projs = [k[1] for k in kept]
                uvs = [k[2] for k in kept]
                centers = [k[3] for k in kept]
            # Cheirality + reprojection + angle checks per element.
            ok_elements = []
            for el, proj, uv, center in zip(elements, projs, uvs, centers):
                Xc = proj @ np.concatenate([Xb, [1.0]])
                if Xc[2] <= 0:
                    continue
                err = np.linalg.norm(Xc[:2] / Xc[2] - uv)
                ecam = self.recon.cameras[self.recon.images[el.image_id].camera_id]
                err_px = err * ecam.mean_focal_length()
                if err_px <= options.complete_max_reproj_error_px:
                    ok_elements.append((el, center))
            if len(ok_elements) < 2 or (
                options.ignore_two_view_tracks and len(ok_elements) < 3
            ):
                continue
            # Pairwise max triangulation angle must exceed the minimum.
            # Host numpy: a device call per (i, j) pair cost ~V^2 dispatches
            # per created point.
            centers_ok = np.stack([c for (_, c) in ok_elements])
            rays = Xb[None, :] - centers_ok
            rays /= np.maximum(
                np.linalg.norm(rays, axis=-1, keepdims=True), 1e-30
            )
            cosang = np.clip(rays @ rays.T, -1.0, 1.0)
            ang = np.arccos(cosang)
            # Triangulation angle is the acute angle (triangulation.cc).
            ang = np.minimum(ang, np.pi - ang)
            max_angle = float(np.max(ang))
            if np.rad2deg(max_angle) < options.min_angle_deg:
                continue
            # Some elements may have been claimed by an earlier row.
            free = [
                el for (el, _) in ok_elements
                if self.recon.images[el.image_id].points2D_p3d[el.point2D_idx]
                == INVALID_POINT3D
            ]
            if len(free) < 2:
                continue
            self.recon.add_point3D(Xb, free)
            num_created += len(free)
        return num_created

    # ------------------------------------------------------------------
    def complete_and_merge_tracks(
        self, point3D_ids, options: Optional[TriangulatorOptions] = None
    ) -> int:
        """Complete tracks transitively and merge compatible ones.

        reference behavior: CompleteTracks/MergeTracks
        (incremental_triangulator.cc). Unlike the reference's per-point
        loops (cheap on a CPU), all reprojection checks are batched ACROSS
        points into global BFS waves / merge rounds — the per-point form
        cost 2-3 device round-trips per point per refinement round,
        tens of thousands per mapping run."""
        if options is None:
            options = TriangulatorOptions()
        num_changes = self.complete_tracks_batch(point3D_ids, options)
        num_changes += self.merge_tracks_batch(point3D_ids, options)
        return num_changes

    def complete_tracks_batch(
        self, point3D_ids, options: Optional[TriangulatorOptions] = None
    ) -> int:
        """Transitive track completion, batched across all points: each BFS
        wave gathers the candidate observations of EVERY live track and
        checks them in one (per camera model) reprojection call."""
        if options is None:
            options = TriangulatorOptions()
        recon = self.recon
        num_added = 0
        frontier: List[Tuple[int, int, int]] = []  # (p3d_id, image_id, p2d_idx)
        seen = set()
        for p3d_id in point3D_ids:
            if p3d_id not in recon.points3D:
                continue
            for el in recon.points3D[p3d_id].track:
                frontier.append((p3d_id, el.image_id, el.point2D_idx))
                seen.add((p3d_id, el.image_id, el.point2D_idx))
        while frontier:
            wave: List[Tuple[int, int, int]] = []
            for (pid, iid, idx) in frontier:
                if pid not in recon.points3D:
                    continue
                for (oid, oidx) in self.graph.find_correspondences(iid, idx):
                    oid, oidx = int(oid), int(oidx)
                    if (pid, oid, oidx) in seen:
                        continue
                    seen.add((pid, oid, oidx))
                    if not recon.is_image_registered(oid):
                        continue
                    if recon.images[oid].points2D_p3d[oidx] != INVALID_POINT3D:
                        continue
                    wave.append((pid, oid, oidx))
            frontier = []
            if not wave:
                break
            items = [
                (oid, oidx, recon.points3D[pid].xyz)
                for (pid, oid, oidx) in wave if pid in recon.points3D
            ]
            live = [w for w in wave if w[0] in recon.points3D]
            errs = self._reproj_errors_mixed(items)
            for (pid, oid, oidx), err in zip(live, errs):
                if err > options.complete_max_reproj_error_px:
                    continue
                if pid not in recon.points3D:
                    continue
                # Another point may have claimed this observation within
                # the same wave; first acceptance wins.
                if recon.images[oid].points2D_p3d[oidx] != INVALID_POINT3D:
                    continue
                recon.add_observation(pid, TrackElement(oid, oidx))
                frontier.append((pid, oid, oidx))
                num_added += 1
        return num_added

    def merge_tracks_batch(
        self, point3D_ids, options: Optional[TriangulatorOptions] = None,
        max_rounds: int = 5,
    ) -> int:
        """Track merging, batched across points: each round gathers every
        candidate partner pair, checks ALL merged-track reprojections in
        one call, then greedily applies non-conflicting merges (strongest
        correspondence support first — the reference's per-point candidate
        order)."""
        if options is None:
            options = TriangulatorOptions()
        recon = self.recon
        num_merged = 0
        ids = [p for p in point3D_ids if p in recon.points3D]
        for _round in range(max_rounds):
            # Candidate partner pairs with correspondence support counts.
            pair_votes: Dict[Tuple[int, int], int] = {}
            for p3d_id in ids:
                if p3d_id not in recon.points3D:
                    continue
                for el in recon.points3D[p3d_id].track:
                    for (oid, oidx) in self.graph.find_correspondences(
                        el.image_id, el.point2D_idx
                    ):
                        oid, oidx = int(oid), int(oidx)
                        if not recon.is_image_registered(oid):
                            continue
                        other = int(recon.images[oid].points2D_p3d[oidx])
                        if other == INVALID_POINT3D or other == p3d_id:
                            continue
                        key = (min(p3d_id, other), max(p3d_id, other))
                        pair_votes[key] = pair_votes.get(key, 0) + 1
            if not pair_votes:
                break
            pairs = sorted(pair_votes, key=pair_votes.get, reverse=True)
            # One batched check over every candidate pair's merged track.
            items: List[Tuple[int, int, np.ndarray]] = []
            spans: List[Tuple[int, int]] = []  # (start, stop) per pair
            merged_xyzs = []
            for (a, b) in pairs:
                p1, p2 = recon.points3D[a], recon.points3D[b]
                n1, n2 = len(p1.track), len(p2.track)
                mx = (n1 * p1.xyz + n2 * p2.xyz) / (n1 + n2)
                start = len(items)
                for pt in (p1, p2):
                    for el in pt.track:
                        items.append((el.image_id, el.point2D_idx, mx))
                spans.append((start, len(items)))
                merged_xyzs.append(mx)
            errs = self._reproj_errors_mixed(items)
            touched = set()
            any_merge = False
            for (a, b), (start, stop) in zip(pairs, spans):
                if a in touched or b in touched:
                    continue
                if a not in recon.points3D or b not in recon.points3D:
                    continue
                if np.all(errs[start:stop]
                          <= options.merge_max_reproj_error_px):
                    n = (len(recon.points3D[a].track)
                         + len(recon.points3D[b].track))
                    recon.merge_points3D(a, b)
                    touched.add(a)
                    touched.add(b)
                    num_merged += n
                    any_merge = True
            if not any_merge:
                break
        return num_merged

    def _complete_track(self, p3d_id, options) -> int:
        point = self.recon.points3D[p3d_id]
        num_added = 0
        queue = list(point.track)
        seen = set((el.image_id, el.point2D_idx) for el in queue)
        # Wave-batched BFS: gather every candidate of the current queue,
        # check all reprojection errors in one (per-model) device call,
        # then expand from the accepted ones.
        while queue:
            wave = []
            for el in queue:
                for (oid, oidx) in self.graph.find_correspondences(
                    el.image_id, el.point2D_idx
                ):
                    oid, oidx = int(oid), int(oidx)
                    if (oid, oidx) in seen:
                        continue
                    seen.add((oid, oidx))
                    if not self.recon.is_image_registered(oid):
                        continue
                    oimg = self.recon.images[oid]
                    if oimg.points2D_p3d[oidx] != INVALID_POINT3D:
                        continue
                    wave.append((oid, oidx, point.xyz))
            queue = []
            if not wave:
                break
            errs = self._reproj_errors_mixed(wave)
            for (oid, oidx, _X), err in zip(wave, errs):
                if err <= options.complete_max_reproj_error_px:
                    self.recon.add_observation(p3d_id, TrackElement(oid, oidx))
                    queue.append(TrackElement(oid, oidx))
                    num_added += 1
        return num_added

    def _merge_track(self, p3d_id, options) -> int:
        point = self.recon.points3D[p3d_id]
        # Find candidate partner points through correspondences.
        candidates = {}
        for el in point.track:
            for (oid, oidx) in self.graph.find_correspondences(el.image_id, el.point2D_idx):
                oid, oidx = int(oid), int(oidx)
                if not self.recon.is_image_registered(oid):
                    continue
                other_p3d = int(self.recon.images[oid].points2D_p3d[oidx])
                if other_p3d != INVALID_POINT3D and other_p3d != p3d_id:
                    candidates[other_p3d] = candidates.get(other_p3d, 0) + 1
        for other_id in sorted(candidates, key=candidates.get, reverse=True):
            if other_id not in self.recon.points3D or p3d_id not in self.recon.points3D:
                break
            p1 = self.recon.points3D[p3d_id]
            p2 = self.recon.points3D[other_id]
            n1, n2 = len(p1.track), len(p2.track)
            merged_xyz = (n1 * p1.xyz + n2 * p2.xyz) / (n1 + n2)
            # Accept merge only if all observations stay within threshold
            # (one batched reprojection call over both tracks).
            items = [
                (el.image_id, el.point2D_idx, merged_xyz)
                for pt in (p1, p2) for el in pt.track
            ]
            errs = self._reproj_errors_mixed(items)
            ok = bool(np.all(errs <= options.merge_max_reproj_error_px))
            if ok:
                self.recon.merge_points3D(p3d_id, other_id)
                return n1 + n2
        return 0

    # ------------------------------------------------------------------
    def retriangulate(self, options: Optional[TriangulatorOptions] = None) -> int:
        """Re-attempt triangulation for under-reconstructed image pairs
        (reference: Retriangulate, incremental_triangulator.h:141)."""
        if options is None:
            options = TriangulatorOptions()
        num_tris = 0
        for image_id in self.recon.reg_image_ids():
            num_tris += self.triangulate_image(image_id, options)
        return num_tris
