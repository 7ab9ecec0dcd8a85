"""pycolmap-compatible API surface of the port.

Counterpart of colmap_tpu/pycolmap_compat.py (reference behavior:
src/pycolmap, pycolmap/main.cc:34-75; pipeline functions in
pycolmap/pipeline/*.cc): the same top-level function names and classes, so
that a script written against pycolmap runs on the card with
``import colmap_tpu_torch.pycolmap_compat as pycolmap``. Functions that do
device work take ``device`` (default ``cuda``; a CUDA request without a
card raises) and run the port's kernels: the two-view RANSACs (K7, K11,
K12), pose recovery (K36), absolute pose (K6), triangulation (K8), the
generalized poses (K27, K40, K48) and the pipelines' kernels.
``set_random_seed`` sets the seed of the generators the estimators here
draw their samples from. colmap_tpu pads rows to buckets for the TPU's
compiles; the port does not.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch

# Core data types re-exported under pycolmap's names.
from colmap_tpu_torch.scene.database import Database  # noqa: F401
from colmap_tpu_torch.scene.reconstruction import Reconstruction as _Reconstruction
from colmap_tpu_torch.scene.reconstruction_io import read_model, write_model
from colmap_tpu_torch.scene.types import (  # noqa: F401
    Camera,
    Frame,
    Image,
    Point3D,
    Pose,
    Rig,
    TrackElement,
    TwoViewGeometry,
)
from colmap_tpu_torch.sensor.models import CameraModelId  # noqa: F401
from colmap_tpu_torch.utils.dtypes import floatx, resolve_device

_IMAGE_EXTENSIONS = (".png", ".jpg", ".jpeg", ".bmp", ".tif", ".tiff")


class Reconstruction(_Reconstruction):
    """pycolmap.Reconstruction-compatible constructor, read and write."""

    def __init__(self, path: Optional[str] = None):
        super().__init__()
        if path is not None:
            self.read(path)

    def read(self, path: str):
        self.__dict__.update(read_model(path).__dict__)

    def write(self, path: str):
        write_model(self, path, fmt="bin")

    def write_text(self, path: str):
        write_model(self, path, fmt="txt")


def extract_features(database_path: str, image_path: str, image_names: Optional[list] = None,
                     camera_model: str = "SIMPLE_RADIAL", device=None, **kwargs):
    """reference: pycolmap.extract_features (pipeline/extract_features.cc)."""
    from colmap_tpu_torch.controllers.feature_pipeline import (
        ImageReaderOptions,
        run_feature_extraction,
    )

    db = Database(database_path)
    ids = run_feature_extraction(db, image_path, image_names,
                                 ImageReaderOptions(camera_model=camera_model), device=device)
    db.close()
    return ids


def match_exhaustive(database_path: str, device=None, **kwargs):
    """reference: pycolmap.match_exhaustive."""
    from colmap_tpu_torch.controllers.feature_pipeline import run_exhaustive_matching

    db = Database(database_path)
    n = run_exhaustive_matching(db, device=device)
    db.close()
    return n


def match_sequential(database_path: str, device=None, **kwargs):
    from colmap_tpu_torch.controllers.feature_pipeline import run_sequential_matching

    db = Database(database_path)
    n = run_sequential_matching(db, device=device)
    db.close()
    return n


def verify_matches(database_path: str, pairs, device=None, **kwargs):
    """reference: pycolmap.verify_matches."""
    from colmap_tpu_torch.controllers.feature_pipeline import run_matches_import

    db = Database(database_path)
    n = run_matches_import(db, pairs, device=device)
    db.close()
    return n


def incremental_mapping(database_path: str, image_path: str = "",
                        output_path: Optional[str] = None, options=None,
                        device=None) -> Dict[int, Reconstruction]:
    """reference: pycolmap.incremental_mapping (pipeline/sfm.cc)."""
    from colmap_tpu_torch.sfm.incremental_pipeline import (
        IncrementalPipeline,
        IncrementalPipelineOptions,
    )

    db = Database(database_path)
    models = IncrementalPipeline(options or IncrementalPipelineOptions(), db, device).run()
    out: Dict[int, Reconstruction] = {}
    for i, m in enumerate(models):
        r = Reconstruction()
        r.__dict__.update(m.__dict__)
        out[i] = r
        if output_path is not None:
            write_model(m, os.path.join(output_path, str(i)), fmt="bin")
    db.close()
    return out


def global_mapping(database_path: str, image_path: str = "", output_path: Optional[str] = None,
                   options=None, device=None):
    """GLOMAP-style mapping (reference: global_mapper pipeline)."""
    from colmap_tpu_torch.sfm.global_pipeline import GlobalPipeline, GlobalPipelineOptions

    db = Database(database_path)
    recon = GlobalPipeline(options or GlobalPipelineOptions(), db, device=device).run()
    db.close()
    if recon is not None and output_path is not None:
        write_model(recon, os.path.join(output_path, "0"), fmt="bin")
    return recon


def bundle_adjustment(reconstruction, options=None, device=None):
    """reference: pycolmap.bundle_adjustment."""
    from colmap_tpu_torch.estimators import bundle_adjustment as ba
    from colmap_tpu_torch.estimators.ba_setup import (
        problem_from_reconstruction,
        update_reconstruction,
    )

    problem, index = problem_from_reconstruction(reconstruction,
                                                 device=resolve_device(device))
    opts = options or ba.BAOptions()
    masks = ba.fix_gauge_two_frames(ba.default_masks(problem, index["model_id"], opts), 0, 1)
    solved, summary = ba.solve(problem, index["model_id"], opts, masks)
    update_reconstruction(reconstruction, solved, index)
    reconstruction.update_point3D_errors()
    return summary


def triangulate_points(reconstruction, database_path: str, device=None, **kwargs):
    """reference: pycolmap.triangulate_points."""
    from colmap_tpu_torch.scene.database_cache import DatabaseCache
    from colmap_tpu_torch.sfm.incremental_triangulator import (
        IncrementalTriangulator,
        TriangulatorOptions,
    )

    db = Database(database_path)
    cache = DatabaseCache.create(db)
    tri = IncrementalTriangulator(cache.correspondence_graph, reconstruction,
                                  resolve_device(device))
    n = tri.retriangulate(TriangulatorOptions())
    db.close()
    return n


def estimate_and_refine_absolute_pose(points2D, points3D, camera, device=None, **kwargs):
    """reference: pycolmap.estimate_and_refine_absolute_pose."""
    from colmap_tpu_torch.estimators.pose import estimate_absolute_pose as _est
    from colmap_tpu_torch.estimators.pose import refine_absolute_pose as _ref

    device = resolve_device(device)
    pose, inliers, _ = _est(camera, points2D, points3D, device=device)
    if pose is None:
        return None
    pose, camera, ok = _ref(camera, pose, points2D, points3D, inliers, device=device)
    return {"cam_from_world": pose, "num_inliers": int(inliers.sum()), "inlier_mask": inliers}


def _generator():
    return torch.Generator().manual_seed(_default_seed)


def _ransac_dict(res, key, n):
    if not bool(res.success):
        return None
    return {key: res.model.double().cpu().numpy(), "num_inliers": int(res.num_inliers),
            "inlier_mask": res.inlier_mask.cpu().numpy()[:n]}


def estimate_essential_matrix(points1, points2, camera1, camera2, device=None, **kwargs):
    """reference: pycolmap.estimate_essential_matrix (5-point LO-RANSAC, K7)."""
    from colmap_tpu_torch.estimators.two_view_geometry import _normalized, _ransac_e
    from colmap_tpu_torch.optim.ransac import RansacOptions

    device = resolve_device(device)
    n = len(points1)
    x1n = _normalized(camera1, np.asarray(points1, dtype=np.float64), device)
    x2n = _normalized(camera2, np.asarray(points2, dtype=np.float64), device)
    mask = torch.ones(n, dtype=torch.bool, device=device)
    th = 0.5 * (camera1.cam_from_img_threshold(4.0) + camera2.cam_from_img_threshold(4.0))
    return _ransac_dict(_ransac_e(_generator(), x1n, x2n, mask, float(th), RansacOptions()),
                        "E", n)


def align_reconstructions(src, tgt, **kwargs):
    from colmap_tpu_torch.estimators.alignment import align_reconstructions as _align

    return _align(src, tgt)


def compare_reconstructions(recon1, recon2, **kwargs):
    from colmap_tpu_torch.estimators.alignment import compare_reconstructions as _cmp

    return _cmp(recon1, recon2)


def match_spatial(database_path: str, device=None, **kwargs):
    """reference: pycolmap.match_spatial (prior-position kNN pairs, then
    match and verify; pycolmap/pipeline/match_features.cc)."""
    from colmap_tpu_torch.cli.main import _prior_positions_enu
    from colmap_tpu_torch.controllers.feature_pipeline import run_matches_import
    from colmap_tpu_torch.feature.pairing import SpatialPairingOptions, spatial_pairs

    db = Database(database_path)
    ids, pos = _prior_positions_enu(db)
    if len(ids) < 2:
        db.close()
        return 0
    opts = SpatialPairingOptions(max_num_neighbors=kwargs.get("max_num_neighbors", 50),
                                 max_distance=kwargs.get("max_distance", 100.0),
                                 ignore_z=kwargs.get("ignore_z", True))
    n = run_matches_import(db, spatial_pairs(ids, pos, opts), device=device)
    db.close()
    return n


def match_vocabtree(database_path: str, vocab_tree_path: str = "", device=None, **kwargs):
    """reference: pycolmap.match_vocabtree (retrieval pairs, then match and
    verify)."""
    from colmap_tpu_torch.cli.main import _load_or_train_index, _read_all_descriptors
    from colmap_tpu_torch.controllers.feature_pipeline import run_matches_import
    from colmap_tpu_torch.utils.types import image_pair_to_pair_id

    device = resolve_device(device)
    db = Database(database_path)
    desc = _read_all_descriptors(db, max_per_image=kwargs.get("max_num_features", None))
    index = _load_or_train_index(vocab_tree_path or None, desc, device)
    pairs, seen = [], set()
    num_images = kwargs.get("num_images", 10)
    for iid, d in desc.items():
        for r in index.query(d, num_images, exclude_image_id=iid):
            key = image_pair_to_pair_id(iid, r.image_id)
            if key not in seen:
                seen.add(key)
                pairs.append((min(iid, r.image_id), max(iid, r.image_id)))
    n = run_matches_import(db, pairs, device=device)
    db.close()
    return n


def match_image_pairs(database_path: str, pairs, device=None, **kwargs):
    """reference: pycolmap.match_image_pairs: match and verify an explicit
    pair list (names or ids)."""
    from colmap_tpu_torch.controllers.feature_pipeline import run_matches_import

    db = Database(database_path)
    name_to_id = {name: iid for (iid, name, _) in db.read_images()}
    id_pairs = [(int(name_to_id.get(a, a)), int(name_to_id.get(b, b))) for a, b in pairs]
    n = run_matches_import(db, id_pairs, device=device)
    db.close()
    return n


def _all_matched_pairs(db):
    from colmap_tpu_torch.utils.types import pair_id_to_image_pair

    return [pair_id_to_image_pair(pid) for (pid, _m) in db.read_all_matches()]


def geometric_verification(database_path: str, pairs=None, device=None, **kwargs):
    """reference: pycolmap.geometric_verification: verify existing matches
    again into two_view_geometries."""
    from colmap_tpu_torch.controllers.feature_pipeline import run_matches_import

    db = Database(database_path)
    n = run_matches_import(db, _all_matched_pairs(db) if pairs is None else pairs,
                           device=device)
    db.close()
    return n


def guided_geometric_verification(database_path: str, pairs=None, device=None, **kwargs):
    """reference: pycolmap.guided_geometric_verification."""
    from colmap_tpu_torch.controllers.feature_pipeline import (
        MatchingPipelineOptions,
        run_matches_import,
    )

    db = Database(database_path)
    n = run_matches_import(db, _all_matched_pairs(db) if pairs is None else pairs,
                           MatchingPipelineOptions(guided_matching=True), device=device)
    db.close()
    return n


def hierarchical_mapping(database_path: str, image_path: str = "",
                         output_path: Optional[str] = None, device=None, **kwargs):
    """reference: pycolmap.hierarchical_mapping."""
    from colmap_tpu_torch.sfm.hierarchical_pipeline import (
        HierarchicalPipeline,
        HierarchicalPipelineOptions,
    )

    db = Database(database_path)
    recons = HierarchicalPipeline(HierarchicalPipelineOptions(), db, device=device).run()
    db.close()
    if output_path is not None:
        os.makedirs(output_path, exist_ok=True)
        for i, recon in enumerate(recons):
            write_model(recon, os.path.join(output_path, str(i)), fmt="bin")
    return {i: r for i, r in enumerate(recons)}


def import_images(database_path: str, image_path: str, camera_mode=None, image_names=None,
                  **kwargs):
    """reference: pycolmap.import_images: image rows (and cameras from
    EXIF) in the database, without features."""
    from colmap_tpu_torch.controllers.feature_pipeline import ImageReaderOptions

    db = Database(database_path)
    if image_names is None:
        image_names = sorted(f for f in os.listdir(image_path)
                             if f.lower().endswith(_IMAGE_EXTENSIONS))
    opts = ImageReaderOptions()
    image_ids = []
    shared_camera_id = None
    for name in image_names:
        cam = infer_camera_from_image(os.path.join(image_path, name), options=opts)
        if camera_mode in (None, "SINGLE") and shared_camera_id is not None:
            camera_id = shared_camera_id
        else:
            camera_id = db.write_camera(cam, use_camera_id=False)
            if camera_mode in (None, "SINGLE"):
                shared_camera_id = camera_id
        image_ids.append(db.write_image(name, camera_id))
    db.commit()
    db.close()
    return image_ids


def infer_camera_from_image(image_path: str, options=None):
    """reference: pycolmap.infer_camera_from_image: camera model and focal
    prior from EXIF (or the default focal factor)."""
    from colmap_tpu_torch.controllers.feature_pipeline import ImageReaderOptions
    from colmap_tpu_torch.sensor import models as cm
    from colmap_tpu_torch.sensor.specs import focal_length_px_from_exif
    from colmap_tpu_torch.utils.exif import read_exif
    from colmap_tpu_torch.utils.image_io import read_image

    opts = options or ImageReaderOptions()
    img = read_image(image_path)
    height, width = img.shape[:2]
    focal, has_prior = focal_length_px_from_exif(read_exif(image_path), width, height,
                                                 opts.default_focal_length_factor)
    cam = Camera.create(0, cm.MODEL_NAME_TO_ID[opts.camera_model], focal, width, height)
    cam.has_prior_focal_length = has_prior
    return cam


def calibrate_view_graph(database_path: str, device=None, **kwargs):
    """reference: pycolmap.calibrate_view_graph (focal lengths over the
    UNCALIBRATED pairs' F matrices, K23)."""
    from colmap_tpu_torch.estimators.view_graph_calibration import calibrate_view_graph as _cal
    from colmap_tpu_torch.sensor import models as cm

    db = Database(database_path)
    cameras = db.read_cameras()
    images = {iid: cid for (iid, _, cid) in db.read_images()}
    edges = [(images[id1], images[id2], g.F)
             for (id1, id2, g) in db.read_all_two_view_geometries()
             if g is not None and g.F is not None and id1 in images and id2 in images]
    camera_ids = sorted(cameras.keys())
    prior_focals = {cid: float(cm.mean_focal_length(cameras[cid].model_id, cameras[cid].params))
                    for cid in camera_ids}
    pps = {}
    for cid in camera_ids:
        pp = cm.principal_point_idxs(int(cameras[cid].model_id))
        pps[cid] = (float(cameras[cid].params[pp[0]]), float(cameras[cid].params[pp[1]]))
    out = _cal(camera_ids, prior_focals, pps, edges, device=resolve_device(device))
    db.close()
    return out


def undistort_images(output_path: str, input_path: str, image_path: str, device=None,
                     **kwargs):
    """reference: pycolmap.undistort_images (COLMAP-layout MVS workspace)."""
    import argparse

    from colmap_tpu_torch.cli.main import _cmd_image_undistorter

    return _cmd_image_undistorter(argparse.Namespace(
        image_path=image_path, input_path=input_path, output_path=output_path,
        output_type=kwargs.get("output_type", "COLMAP"), device=device))


def patch_match_stereo(workspace_path: str, device=None, **kwargs):
    """reference: pycolmap.patch_match_stereo."""
    from colmap_tpu_torch.mvs.workspace import run_patch_match_workspace
    from colmap_tpu_torch.utils.image_io import read_image_gray

    recon = read_model(os.path.join(workspace_path, "sparse"))
    images = {}
    for iid in recon.reg_image_ids():
        p = os.path.join(workspace_path, "images", recon.images[iid].name)
        if os.path.exists(p):
            images[iid] = read_image_gray(p).astype(np.float32) / 255.0
    return run_patch_match_workspace(
        recon, images, workspace_path,
        geom_consistency=kwargs.get("geom_consistency", False),
        write_consistency_graph=kwargs.get("write_consistency_graph", False),
        device=resolve_device(device))


def stereo_fusion(output_path: str, workspace_path: str, device=None, **kwargs):
    """reference: pycolmap.stereo_fusion."""
    from colmap_tpu_torch.mvs.workspace import run_fusion_workspace

    recon = read_model(os.path.join(workspace_path, "sparse"))
    pts, normals, vis = run_fusion_workspace(recon, workspace_path, output_path,
                                             device=resolve_device(device))
    return {"num_points": len(pts)}


def poisson_meshing(input_path: str, output_path: str, device=None, **kwargs):
    """reference: pycolmap.poisson_meshing (fused PLY -> mesh)."""
    from colmap_tpu_torch.mvs.meshing import poisson_mesh
    from colmap_tpu_torch.utils.ply import read_ply, write_ply_mesh

    cloud = read_ply(input_path)
    verts, faces, _colors = poisson_mesh(cloud["points"], cloud.get("normals"),
                                         device=resolve_device(device))
    write_ply_mesh(output_path, verts, faces)
    return {"num_vertices": len(verts), "num_faces": len(faces)}


def set_random_seed(seed: int):
    """reference: pycolmap.set_random_seed: the seed of the generators that
    the estimators here draw their samples from, and torch's default one."""
    global _default_seed
    _default_seed = int(seed)
    torch.manual_seed(_default_seed)


_default_seed = 0


# ---------------------------------------------------------------------------
# Class surface and estimator bindings (reference: src/pycolmap/main.cc:34-75
# binds every layer; these re-export the port's classes under the pycolmap
# names and wrap the RANSACs with pycolmap's dict returns).

from colmap_tpu_torch.geometry.rigid3 import Rigid3 as Rigid3d  # noqa: F401,E402
from colmap_tpu_torch.geometry.rigid3 import Sim3 as Sim3d  # noqa: F401,E402
from colmap_tpu_torch.optim.ransac import RansacOptions as RANSACOptions  # noqa: F401,E402
from colmap_tpu_torch.scene.correspondence_graph import (  # noqa: F401,E402
    CorrespondenceGraph,
)
from colmap_tpu_torch.scene.database_cache import DatabaseCache  # noqa: F401,E402
from colmap_tpu_torch.scene.types import TwoViewGeometryConfig  # noqa: F401,E402
from colmap_tpu_torch.sfm.incremental_mapper import IncrementalMapper  # noqa: F401,E402
from colmap_tpu_torch.sfm.incremental_pipeline import (  # noqa: F401,E402
    IncrementalPipelineOptions,
)


def _pair(points1, points2, device):
    n = len(points1)
    dt = floatx(device)
    x1 = torch.as_tensor(np.asarray(points1, np.float64), dtype=dt).to(device).contiguous()
    x2 = torch.as_tensor(np.asarray(points2, np.float64), dtype=dt).to(device).contiguous()
    return n, x1, x2, torch.ones(n, dtype=torch.bool, device=device)


def estimate_fundamental_matrix(points1, points2, options=None, device=None):
    """reference: pycolmap.estimate_fundamental_matrix (7-point LO-RANSAC, K11)."""
    from colmap_tpu_torch.estimators.two_view_geometry import _ransac_f
    from colmap_tpu_torch.optim.ransac import RansacOptions

    n, x1, x2, mask = _pair(points1, points2, resolve_device(device))
    return _ransac_dict(_ransac_f(_generator(), x1, x2, mask, options or RansacOptions()), "F", n)


def estimate_homography_matrix(points1, points2, options=None, device=None):
    """reference: pycolmap.estimate_homography_matrix (4-point LO-RANSAC, K12)."""
    from colmap_tpu_torch.estimators.two_view_geometry import _ransac_h
    from colmap_tpu_torch.optim.ransac import RansacOptions

    n, x1, x2, mask = _pair(points1, points2, resolve_device(device))
    return _ransac_dict(_ransac_h(_generator(), x1, x2, mask, options or RansacOptions()), "H", n)


def estimate_absolute_pose(points2D, points3D, camera, options=None, device=None):
    """reference: pycolmap.estimate_absolute_pose (P3P RANSAC, K6; no refine)."""
    from colmap_tpu_torch.estimators.pose import AbsolutePoseOptions
    from colmap_tpu_torch.estimators.pose import estimate_absolute_pose as _est

    est_options = None
    if options is not None:
        # pycolmap's RANSACOptions translated into the estimator's options.
        est_options = AbsolutePoseOptions(
            max_error_px=options.max_error, min_inlier_ratio=options.min_inlier_ratio,
            confidence=options.confidence, min_num_trials=options.min_num_trials,
            max_num_trials=options.max_num_trials)
    pose, inliers, _focal = _est(camera, points2D, points3D, est_options,
                                 device=resolve_device(device))
    if pose is None:
        return None
    return {"cam_from_world": pose, "num_inliers": int(inliers.sum()), "inlier_mask": inliers}


def refine_absolute_pose(cam_from_world, points2D, points3D, camera, inlier_mask=None,
                         device=None):
    """reference: pycolmap.refine_absolute_pose (LM on the inliers)."""
    from colmap_tpu_torch.estimators.pose import refine_absolute_pose as _ref

    if inlier_mask is None:
        inlier_mask = np.ones(len(points2D), dtype=bool)
    pose, camera, ok = _ref(camera, cam_from_world, points2D, points3D, inlier_mask,
                            device=resolve_device(device))
    return {"cam_from_world": pose, "success": bool(ok)}


def estimate_generalized_absolute_pose(points2D, points3D, camera_idxs, cams_from_rig, cameras,
                                       options=None, device=None):
    """reference: pycolmap.estimate_generalized_absolute_pose (gDLT, K27 and K40)."""
    from colmap_tpu_torch.estimators.generalized_pose import (
        estimate_generalized_absolute_pose as _est,
    )

    return _est(points2D, points3D, camera_idxs, cams_from_rig, cameras,
                device=resolve_device(device))


def estimate_generalized_relative_pose(points2D1, points2D2, camera_idxs1, camera_idxs2,
                                       cams_from_rig, cameras, options=None, device=None):
    """reference: pycolmap.estimate_generalized_relative_pose (17-point GEC,
    K48)."""
    from colmap_tpu_torch.estimators.generalized_pose import (
        estimate_generalized_relative_pose as _est,
    )

    return _est(points2D1, points2D2, camera_idxs1, camera_idxs2, cams_from_rig, cameras,
                device=resolve_device(device))


def estimate_triangulation(points2D, cams_from_world, cameras, options=None, device=None):
    """reference: pycolmap.estimate_triangulation (RANSAC over view pairs, K8).

    points2D (V, 2) pixel observations, one a view; returns the robust 3D
    point and the inlier mask of the views.
    """
    from colmap_tpu_torch.estimators.two_view_geometry import _normalized
    from colmap_tpu_torch.estimators.triangulation import TriangulationOptions
    from colmap_tpu_torch.estimators.triangulation import estimate_triangulation as _est

    device = resolve_device(device)
    dt = floatx(device)
    V = len(points2D)
    R = np.stack([p.rotmat() if hasattr(p, "rotmat") else np.asarray(p)[:3, :3]
                  for p in cams_from_world])
    t = np.stack([np.asarray(p.t) if hasattr(p, "t") else np.asarray(p)[:3, 3]
                  for p in cams_from_world])
    xn = torch.cat([_normalized(cameras[v], np.asarray(points2D[v], np.float64)[None], device)
                    for v in range(V)])

    def dev(a):
        return torch.as_tensor(a, dtype=dt).to(device)[None].contiguous()

    res = _est(dev(R), dev(t), xn.to(dt)[None].contiguous(),
               torch.ones(1, V, dtype=torch.bool, device=device),
               options or TriangulationOptions())
    if not bool(res["success"][0]):
        return None
    return {"xyz": res["xyz"][0].double().cpu().numpy(),
            "inlier_mask": res["inlier_mask"][0].cpu().numpy()}


def estimate_two_view_geometry(camera1, points1, camera2, points2, matches=None, options=None,
                               device=None):
    """reference: pycolmap.estimate_two_view_geometry (the whole decision tree)."""
    from colmap_tpu_torch.estimators.two_view_geometry import TwoViewGeometryOptions
    from colmap_tpu_torch.estimators.two_view_geometry import (
        estimate_two_view_geometry as _est,
    )

    if matches is None:
        n = min(len(points1), len(points2))
        matches = np.stack([np.arange(n), np.arange(n)], axis=1)
    return _est(camera1, np.asarray(points1), camera2, np.asarray(points2), np.asarray(matches),
                options or TwoViewGeometryOptions(), device=resolve_device(device))


def estimate_two_view_geometry_pose(camera1, points1, camera2, points2, g, device=None):
    """reference: pycolmap.estimate_two_view_geometry_pose: the relative pose
    of an already classified TwoViewGeometry (K36)."""
    from colmap_tpu_torch.estimators.two_view_geometry import recover_poses

    recover_poses([(g, camera1, np.asarray(points1), camera2, np.asarray(points2))],
                  device=resolve_device(device))
