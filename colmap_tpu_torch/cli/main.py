"""Command-line interface of the port (the ported subset of colmap_tpu's).

reference behavior: src/colmap/exe/colmap.cc. Same command names and flags
as ``python -m colmap_tpu.cli.main``, plus ``--device`` (default ``cuda``;
``cpu`` runs the plain PyTorch versions of the kernels). Ported commands:

    database_creator    create an empty database
    feature_extractor   SIFT keypoints and descriptors of a folder of images
    exhaustive_matcher  match and verify every image pair of a database
    sequential_matcher  match and verify pairs within --overlap in name order
    matches_importer    match and verify the pairs of a list file
    spatial_matcher     match and verify pairs of nearby pose priors (GPS)
    transitive_matcher  match and verify the pairs that close A-B, B-C
    geometric_verifier  verify again every pair that has matches
    rig_configurator    group a database's images into rigs and frames
    mapper            incremental SfM: database -> sparse model(s)
    global_mapper     global SfM: database -> one sparse model
    rotation_averager   global rotations of a database's view graph -> model
    view_graph_calibrator  focal lengths from F matrices -> database cameras
    bundle_adjuster   read a model, run bundle adjustment, write the model
    model_analyzer    print a model's statistics
    image_undistorter   undistort a model's images into a dense workspace
                        (--output_type COLMAP; PMVS and CMP-MVS raise)
    patch_match_stereo  depth and normal maps of every workspace image
    stereo_fusion       fuse the depth maps into a point cloud (PLY + .vis)

Commands return what they built (``main`` passes it on), so a caller that
drives the CLI in-process can read it: ``mapper`` and ``global_mapper``
return their pipeline, whose ``timer`` holds the time by phase.

Run as ``python -m colmap_tpu_torch.cli.main <command> ...``.
"""

from __future__ import annotations

import argparse
import os


def _cmd_database_creator(args):
    from colmap_tpu_torch.scene.database import Database

    Database(args.database_path).close()
    print(f"Created database at {args.database_path}")


def _cmd_rig_configurator(args):
    """Group the database's images into rigs and frames by filename prefix,
    from a rig configuration JSON (reference: rig_configurator, exe/rig.cc;
    colmap_tpu's command, cli/extra_commands.py:664-733). Each rig lists its
    cameras with an ``image_prefix``, one ``ref_sensor``, and the others'
    ``cam_from_rig_rotation`` (wxyz) and ``cam_from_rig_translation``; the
    images whose names share the part after their prefix form one frame.
    ``--device`` is taken for parity with the other commands and not used."""
    import json

    import numpy as np

    from colmap_tpu_torch.scene.database import Database
    from colmap_tpu_torch.scene.types import Frame, Pose, Rig, SensorType

    with open(args.rig_config_path) as f:
        config = json.load(f)
    camera = int(SensorType.CAMERA)
    db = Database(args.database_path, must_exist=True)
    images = db.read_images()  # (image_id, name, camera_id)
    next_rig_id, next_frame_id, n_frames = 1, 1, 0
    for rig_cfg in config:
        cam_cfgs = rig_cfg["cameras"]
        ref_idx = max((ci for ci, cc in enumerate(cam_cfgs) if cc.get("ref_sensor")), default=0)
        groups = {}  # name suffix -> {camera config index: (image_id, camera_id)}
        prefix_cam = {}
        for iid, name, cid in images:
            for ci, cc in enumerate(cam_cfgs):
                if name.startswith(cc["image_prefix"]):
                    groups.setdefault(name[len(cc["image_prefix"]):], {})[ci] = (iid, cid)
                    prefix_cam[ci] = cid
                    break
        if not groups or ref_idx not in prefix_cam:
            continue
        rig = Rig(rig_id=next_rig_id, ref_sensor_id=(camera, prefix_cam[ref_idx]))
        for ci, cc in enumerate(cam_cfgs):
            if ci == ref_idx or ci not in prefix_cam:
                continue
            pose = None
            if "cam_from_rig_rotation" in cc:
                pose = Pose(np.asarray(cc["cam_from_rig_rotation"], dtype=np.float64),
                            np.asarray(cc.get("cam_from_rig_translation", [0, 0, 0]),
                                       dtype=np.float64))
            rig.sensors[(camera, prefix_cam[ci])] = pose
        db.write_rig(rig)
        next_rig_id += 1
        for suffix in sorted(groups):
            db.write_frame(Frame(frame_id=next_frame_id, rig_id=rig.rig_id, data_ids=[
                (camera, cid, iid) for _, (iid, cid) in sorted(groups[suffix].items())]))
            next_frame_id += 1
            n_frames += 1
    db.commit()
    print(f"Configured {next_rig_id - 1} rigs, {n_frames} frames")
    db.close()
    return next_rig_id - 1, n_frames


def _cmd_feature_extractor(args):
    from colmap_tpu_torch.controllers.feature_pipeline import (
        ImageReaderOptions,
        run_feature_extraction,
    )
    from colmap_tpu_torch.feature.sift import SiftOptions
    from colmap_tpu_torch.scene.database import Database
    from colmap_tpu_torch.utils.dtypes import resolve_device

    if args.descriptor_type != "sift":
        raise NotImplementedError(
            f"--descriptor_type {args.descriptor_type} is not ported yet (ROADMAP queue 1 item 14)")
    device = resolve_device(args.device)
    db = Database(args.database_path)
    reader = ImageReaderOptions(
        camera_model=args.camera_model, single_camera=not args.per_image_camera,
        camera_params=args.camera_params, mask_path=args.mask_path,
        camera_mask_path=args.camera_mask_path, extractor_type=args.descriptor_type)
    ids = run_feature_extraction(db, args.image_path, reader_options=reader,
                                 sift_options=SiftOptions(max_num_features=args.max_num_features),
                                 device=device)
    print(f"Extracted features for {len(ids)} images")
    db.close()
    return ids


def _open_for_matching(args):
    from colmap_tpu_torch.scene.database import Database
    from colmap_tpu_torch.utils.dtypes import resolve_device

    return Database(args.database_path, must_exist=True), resolve_device(args.device)


def _cmd_exhaustive_matcher(args):
    from colmap_tpu_torch.controllers.feature_pipeline import run_exhaustive_matching

    db, device = _open_for_matching(args)
    n = run_exhaustive_matching(db, device=device)
    print(f"Verified {n} image pairs")
    db.close()
    return n


def _cmd_sequential_matcher(args):
    from colmap_tpu_torch.controllers.feature_pipeline import run_sequential_matching
    from colmap_tpu_torch.feature.pairing import SequentialPairingOptions

    db, device = _open_for_matching(args)
    n = run_sequential_matching(db, pairing=SequentialPairingOptions(overlap=args.overlap),
                                device=device)
    print(f"Verified {n} image pairs")
    db.close()
    return n


def _cmd_matches_importer(args):
    from colmap_tpu_torch.controllers.feature_pipeline import run_matches_import
    from colmap_tpu_torch.feature.pairing import imported_pairs

    db, device = _open_for_matching(args)
    name_to_id = {name: iid for (iid, name, _) in db.read_images()}
    pairs = imported_pairs(args.match_list_path, name_to_id)
    n = run_matches_import(db, pairs, device=device)
    print(f"Verified {n} of {len(pairs)} imported pairs")
    db.close()
    return n


def _prior_positions_enu(database):
    """Image ids and prior positions in a metric frame: WGS84 priors
    (coordinate_system 0) become ENU about the first one (reference:
    SpatialPairGenerator's GPSTransform, controllers/pairing.cc)."""
    import numpy as np

    from colmap_tpu_torch.geometry.gps import ellipsoid_to_enu

    ids, pos, systems = [], [], []
    for prior in database.read_pose_priors().values():
        if prior["position"] is None:
            continue
        ids.append(prior["data_id"])
        pos.append(prior["position"])
        systems.append(prior["coordinate_system"])
    if not ids:
        return [], np.zeros((0, 3))
    pos = np.asarray(pos, dtype=np.float64)
    if all(c == 0 for c in systems):
        ref = pos[0]
        pos = np.stack([np.asarray(ellipsoid_to_enu(p[0], p[1], p[2], *ref)).reshape(3)
                        for p in pos])
    return ids, pos


def _cmd_spatial_matcher(args):
    from colmap_tpu_torch.controllers.feature_pipeline import run_matches_import
    from colmap_tpu_torch.feature.pairing import SpatialPairingOptions, spatial_pairs

    db, device = _open_for_matching(args)
    ids, pos = _prior_positions_enu(db)
    if len(ids) < 2:
        db.close()
        raise SystemExit("Not enough pose priors for spatial matching")
    pairs = spatial_pairs(ids, pos, SpatialPairingOptions(
        max_num_neighbors=args.max_num_neighbors, max_distance=args.max_distance,
        ignore_z=args.ignore_z))
    n = run_matches_import(db, pairs, device=device)
    print(f"Verified {n} of {len(pairs)} spatial pairs")
    db.close()
    return n


def _cmd_transitive_matcher(args):
    from colmap_tpu_torch.controllers.feature_pipeline import run_matches_import
    from colmap_tpu_torch.feature.pairing import TransitivePairingOptions, transitive_pairs

    db, device = _open_for_matching(args)
    pairs = transitive_pairs(db, TransitivePairingOptions(num_iterations=args.num_iterations))
    n = run_matches_import(db, pairs, device=device)
    print(f"Verified {n} of {len(pairs)} transitive pairs")
    db.close()
    return n


def _cmd_geometric_verifier(args):
    from colmap_tpu_torch.controllers.feature_pipeline import (
        MatchingPipelineOptions,
        run_matches_import,
    )
    from colmap_tpu_torch.utils.types import pair_id_to_image_pair

    db, device = _open_for_matching(args)
    pairs = [pair_id_to_image_pair(pid) for pid, m in db.read_all_matches() if len(m) > 0]
    n = run_matches_import(db, pairs, MatchingPipelineOptions(guided_matching=args.guided_matching),
                           device=device)
    print(f"Verified {n} of {len(pairs)} matched pairs")
    db.close()
    return n


def _cmd_mapper(args):
    from colmap_tpu_torch.scene.database import Database
    from colmap_tpu_torch.scene.reconstruction_io import write_model
    from colmap_tpu_torch.sfm.incremental_pipeline import (
        IncrementalPipeline,
        IncrementalPipelineOptions,
    )
    from colmap_tpu_torch.utils.dtypes import resolve_device

    device = resolve_device(args.device)
    db = Database(args.database_path, must_exist=True)
    options = IncrementalPipelineOptions(verbose=not args.quiet)
    pipeline = IncrementalPipeline(options, db, device=device)
    models = pipeline.run()
    os.makedirs(args.output_path, exist_ok=True)
    for i, recon in enumerate(models):
        out = os.path.join(args.output_path, str(i))
        write_model(recon, out, fmt="bin")
        print(
            f"Model {i}: {recon.num_reg_frames()} frames, "
            f"{recon.num_points3D()} points -> {out}"
        )
    db.close()
    return pipeline


def _cmd_global_mapper(args):
    from colmap_tpu_torch.scene.database import Database
    from colmap_tpu_torch.scene.reconstruction_io import write_model
    from colmap_tpu_torch.sfm.global_pipeline import GlobalPipeline, GlobalPipelineOptions
    from colmap_tpu_torch.utils.dtypes import resolve_device

    device = resolve_device(args.device)
    db = Database(args.database_path, must_exist=True)
    pipeline = GlobalPipeline(GlobalPipelineOptions(verbose=not args.quiet), db, device=device)
    recon = pipeline.run()
    db.close()
    if recon is None:
        raise SystemExit("Global mapping failed")
    os.makedirs(args.output_path, exist_ok=True)
    out = os.path.join(args.output_path, "0")
    write_model(recon, out, fmt="bin")
    print(f"Model: {recon.num_reg_frames()} frames, {recon.num_points3D()} points -> {out}")
    return pipeline


def collect_relative_poses(database, min_num_matches: int = 15, device=None):
    """pair_id -> relative Pose via the PoseGraph (scene/pose_graph.py)."""
    from colmap_tpu_torch.scene.pose_graph import PoseGraph

    return PoseGraph.load(database, min_num_inliers=min_num_matches, device=device).rel_poses()


def _cmd_rotation_averager(args):
    """Global rotation averaging over the view graph, written as a model of
    registered frames at the averaged rotations and zero translations
    (reference: rotation_averager, controllers/rotation_averaging.*)."""
    import numpy as np

    from colmap_tpu_torch.estimators.rotation_averaging import estimate_rotations
    from colmap_tpu_torch.scene.database import Database
    from colmap_tpu_torch.scene.database_cache import DatabaseCache
    from colmap_tpu_torch.scene.reconstruction import Reconstruction
    from colmap_tpu_torch.scene.reconstruction_io import write_model
    from colmap_tpu_torch.scene.types import Pose
    from colmap_tpu_torch.utils.dtypes import resolve_device
    from colmap_tpu_torch.utils.types import pair_id_to_image_pair

    device = resolve_device(args.device)
    db = Database(args.database_path, must_exist=True)
    rel_poses = collect_relative_poses(db, args.min_num_matches, device=device)
    if not rel_poses:
        db.close()
        raise SystemExit("No relative poses in database; run a matcher first")
    cache = DatabaseCache.create(db, min_num_matches=args.min_num_matches)
    image_ids = sorted(cache.images.keys())
    row = {iid: i for i, iid in enumerate(image_ids)}
    edges, rel_quats = [], []
    for pair_id, pose in rel_poses.items():
        a, b = pair_id_to_image_pair(pair_id)
        if a in row and b in row:
            edges.append((row[a], row[b]))
            rel_quats.append(pose.quat)
    quats = estimate_rotations(len(image_ids), np.asarray(edges), np.asarray(rel_quats),
                               device=device)
    recon = Reconstruction()
    for cam in cache.cameras.values():
        recon.add_camera(cam)
    for rig in cache.rigs.values():
        recon.add_rig(rig)
    for frame in cache.frames.values():
        recon.add_frame(frame)
    for image in cache.images.values():
        recon.add_image(image)
    for iid in image_ids:
        frame_id = cache.images[iid].frame_id
        recon.frames[frame_id].rig_from_world = Pose(np.asarray(quats[row[iid]]), np.zeros(3))
        recon.register_frame(frame_id)
    os.makedirs(args.output_path, exist_ok=True)
    write_model(recon, args.output_path, fmt="bin")
    print(f"Averaged rotations for {len(image_ids)} images -> {args.output_path}")
    db.close()
    return recon


def _cmd_view_graph_calibrator(args):
    """Focal lengths from the F matrices over the view graph, written to the
    database's cameras (reference: view_graph_calibrator,
    estimators/view_graph_calibration.*)."""
    from colmap_tpu_torch.estimators.view_graph_calibration import calibrate_view_graph
    from colmap_tpu_torch.scene.database import Database
    from colmap_tpu_torch.sensor import models as camera_models
    from colmap_tpu_torch.sfm.global_pipeline import principal_point
    from colmap_tpu_torch.utils.dtypes import resolve_device

    device = resolve_device(args.device)
    db = Database(args.database_path, must_exist=True)
    cameras = db.read_cameras()
    images = {iid: cid for (iid, _, cid) in db.read_images()}
    edges = [(images[id1], images[id2], g.F)
             for (id1, id2, g) in db.read_all_two_view_geometries()
             if g is not None and g.F is not None and id1 in images and id2 in images]
    camera_ids = sorted(cameras.keys())
    prior_focals = {cid: float(camera_models.mean_focal_length(cameras[cid].model_id,
                                                               cameras[cid].params))
                    for cid in camera_ids}
    pps = {cid: principal_point(cameras[cid]) for cid in camera_ids}
    focals = calibrate_view_graph(camera_ids, prior_focals, pps, edges, device=device)
    for cid, f in focals.items():
        cam = cameras[cid]
        for i in camera_models.focal_length_idxs(cam.model_id):
            cam.params[i] = float(f)
        db.update_camera(cam)
    db.commit()
    for cid in camera_ids:
        print(f"camera {cid}: focal {prior_focals[cid]:.2f} -> {focals[cid]:.2f}")
    db.close()
    return focals


def _cmd_bundle_adjuster(args):
    from colmap_tpu_torch.estimators import bundle_adjustment as ba
    from colmap_tpu_torch.estimators.ba_setup import (
        problem_from_reconstruction,
        update_reconstruction,
    )
    from colmap_tpu_torch.scene.reconstruction_io import read_model, write_model

    recon = read_model(args.input_path)
    problem, index = problem_from_reconstruction(recon, device=args.device)
    options = ba.BAOptions(max_iterations=args.max_num_iterations)
    masks = ba.default_masks(problem, index["model_id"], options)
    masks = ba.fix_gauge_two_frames(masks, 0, 1)
    solved, summary = ba.solve(problem, index["model_id"], options, masks)
    update_reconstruction(recon, solved, index)
    recon.update_point3D_errors()
    write_model(recon, args.output_path, fmt="bin")
    print(
        f"BA: cost {summary['initial_cost']:.4e} -> {summary['final_cost']:.4e} "
        f"in {summary['num_iterations']} iterations"
    )


def _cmd_model_analyzer(args):
    from colmap_tpu_torch.scene.reconstruction_io import read_model

    recon = read_model(args.path)
    recon.update_point3D_errors()
    n_obs = recon.compute_num_observations()
    print(f"Cameras: {recon.num_cameras()}")
    print(f"Images: {recon.num_images()}")
    print(f"Registered frames: {recon.num_reg_frames()}")
    print(f"Points: {recon.num_points3D()}")
    print(f"Observations: {n_obs}")
    print(f"Mean track length: {recon.compute_mean_track_length():.6f}")
    print(
        "Mean observations per registered image: "
        f"{n_obs / max(recon.num_reg_frames(), 1):.6f}"
    )
    print(f"Mean reprojection error: {recon.compute_mean_reprojection_error():.6f}px")


def _write_image(path, img):
    """PNG, PGM or PPM by the file's extension; another format through PIL
    where it is installed."""
    from colmap_tpu_torch.utils.image_io import write_png, write_pnm

    ext = os.path.splitext(path)[1].lower()
    if ext == ".png":
        write_png(path, img)
    elif ext in (".pgm", ".ppm"):
        write_pnm(path, img)
    else:
        try:
            from PIL import Image
        except ImportError:
            raise ValueError(f"{path}: writing {ext} images needs PIL, which is not installed "
                             "(PNG, PGM and PPM are written without it)") from None
        Image.fromarray(img).save(path)


def _cmd_image_undistorter(args):
    import numpy as np

    from colmap_tpu_torch.image.undistortion import undistort_camera, undistort_image
    from colmap_tpu_torch.scene.reconstruction_io import read_model, write_model
    from colmap_tpu_torch.utils.dtypes import resolve_device
    from colmap_tpu_torch.utils.image_io import read_image

    if args.output_type != "COLMAP":
        raise NotImplementedError(
            f"--output_type {args.output_type} is not ported yet (ROADMAP queue 1 item 13)")
    device = resolve_device(args.device)
    recon = read_model(args.input_path)
    os.makedirs(os.path.join(args.output_path, "images"), exist_ok=True)
    new_cams = {cid: undistort_camera(cam, device=device) for cid, cam in recon.cameras.items()}
    n = 0
    for iid in recon.reg_image_ids():
        image = recon.images[iid]
        src = os.path.join(args.image_path, image.name)
        if not os.path.exists(src):
            continue
        out = undistort_image(read_image(src), recon.cameras[image.camera_id],
                              new_cams[image.camera_id], device=device)
        dst = os.path.join(args.output_path, "images", image.name)
        os.makedirs(os.path.dirname(dst), exist_ok=True)
        _write_image(dst, out.astype(np.uint8))
        n += 1
    for cid in recon.cameras:
        recon.cameras[cid] = new_cams[cid]
    write_model(recon, os.path.join(args.output_path, "sparse"), fmt="bin")
    print(f"Undistorted {n} images -> {args.output_path}")
    return n


def _cmd_patch_match_stereo(args):
    from colmap_tpu_torch.mvs.workspace import CachedWorkspace, run_patch_match_workspace
    from colmap_tpu_torch.scene.reconstruction_io import read_model
    from colmap_tpu_torch.utils.dtypes import resolve_device

    device = resolve_device(args.device)
    ws = args.workspace_path
    recon = read_model(os.path.join(ws, "sparse"))
    # Memory-bounded streaming of image pages (reference: Workspace
    # cache_size GB option, mvs/workspace.h:46-136).
    images = CachedWorkspace(ws, cache_size_gb=args.cache_size).image_map(recon)
    problems = run_patch_match_workspace(
        recon, images, ws, geom_consistency=args.geom_consistency,
        write_consistency_graph=args.write_consistency_graph, device=device)
    print(f"PatchMatch: processed {len(problems)} reference images")
    return problems


def _cmd_stereo_fusion(args):
    from colmap_tpu_torch.mvs.workspace import run_fusion_workspace
    from colmap_tpu_torch.scene.reconstruction_io import read_model
    from colmap_tpu_torch.utils.dtypes import resolve_device

    device = resolve_device(args.device)
    ws = args.workspace_path
    recon = read_model(os.path.join(ws, "sparse"))
    pts, normals, vis = run_fusion_workspace(recon, ws, args.output_path, device=device)
    print(f"Fused {len(pts)} points -> {args.output_path}")
    return pts, normals, vis


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="colmap_tpu_torch",
        description="PyTorch/CUDA SfM with COLMAP-compatible data formats",
    )
    sub = p.add_subparsers(dest="command", required=True)
    device_help = "torch device to run on; cuda raises if no card is present"

    c = sub.add_parser("database_creator")
    c.add_argument("--database_path", required=True)
    c.set_defaults(fn=_cmd_database_creator)

    c = sub.add_parser("feature_extractor")
    c.add_argument("--database_path", required=True)
    c.add_argument("--image_path", required=True)
    c.add_argument("--camera_model", default="SIMPLE_RADIAL")
    c.add_argument("--camera_params", default=None)
    c.add_argument("--per_image_camera", action="store_true")
    c.add_argument("--max_num_features", type=int, default=8192)
    c.add_argument("--mask_path", default=None)
    c.add_argument("--camera_mask_path", default=None)
    c.add_argument("--descriptor_type", default="sift", choices=["sift", "aliked"])
    c.add_argument("--aliked_weights_path", default=None)
    c.add_argument("--device", default="cuda", help=device_help)
    c.set_defaults(fn=_cmd_feature_extractor)

    c = sub.add_parser("exhaustive_matcher")
    c.add_argument("--database_path", required=True)
    c.add_argument("--device", default="cuda", help=device_help)
    c.set_defaults(fn=_cmd_exhaustive_matcher)

    c = sub.add_parser("sequential_matcher")
    c.add_argument("--database_path", required=True)
    c.add_argument("--overlap", type=int, default=10)
    c.add_argument("--device", default="cuda", help=device_help)
    c.set_defaults(fn=_cmd_sequential_matcher)

    c = sub.add_parser("matches_importer")
    c.add_argument("--database_path", required=True)
    c.add_argument("--match_list_path", required=True)
    c.add_argument("--device", default="cuda", help=device_help)
    c.set_defaults(fn=_cmd_matches_importer)

    c = sub.add_parser("spatial_matcher")
    c.add_argument("--database_path", required=True)
    c.add_argument("--max_num_neighbors", type=int, default=50)
    c.add_argument("--max_distance", type=float, default=100.0)
    c.add_argument("--ignore_z", action="store_true", default=True)
    c.add_argument("--device", default="cuda", help=device_help)
    c.set_defaults(fn=_cmd_spatial_matcher)

    c = sub.add_parser("transitive_matcher")
    c.add_argument("--database_path", required=True)
    c.add_argument("--num_iterations", type=int, default=3)
    c.add_argument("--device", default="cuda", help=device_help)
    c.set_defaults(fn=_cmd_transitive_matcher)

    c = sub.add_parser("geometric_verifier")
    c.add_argument("--database_path", required=True)
    c.add_argument("--guided_matching", action="store_true")
    c.add_argument("--device", default="cuda", help=device_help)
    c.set_defaults(fn=_cmd_geometric_verifier)

    c = sub.add_parser("rig_configurator")
    c.add_argument("--database_path", required=True)
    c.add_argument("--rig_config_path", required=True)
    c.add_argument("--device", default="cuda", help=device_help)
    c.set_defaults(fn=_cmd_rig_configurator)

    c = sub.add_parser("mapper")
    c.add_argument("--database_path", required=True)
    c.add_argument("--image_path", default=None)
    c.add_argument("--output_path", required=True)
    c.add_argument("--quiet", action="store_true")
    c.add_argument("--device", default="cuda", help=device_help)
    c.set_defaults(fn=_cmd_mapper)

    c = sub.add_parser("global_mapper")
    c.add_argument("--database_path", required=True)
    c.add_argument("--image_path", default=None)
    c.add_argument("--output_path", required=True)
    c.add_argument("--quiet", action="store_true")
    c.add_argument("--device", default="cuda", help=device_help)
    c.set_defaults(fn=_cmd_global_mapper)

    c = sub.add_parser("rotation_averager")
    c.add_argument("--database_path", required=True)
    c.add_argument("--output_path", required=True)
    c.add_argument("--min_num_matches", type=int, default=15)
    c.add_argument("--device", default="cuda", help=device_help)
    c.set_defaults(fn=_cmd_rotation_averager)

    c = sub.add_parser("view_graph_calibrator")
    c.add_argument("--database_path", required=True)
    c.add_argument("--device", default="cuda", help=device_help)
    c.set_defaults(fn=_cmd_view_graph_calibrator)

    c = sub.add_parser("bundle_adjuster")
    c.add_argument("--input_path", required=True)
    c.add_argument("--output_path", required=True)
    c.add_argument("--max_num_iterations", type=int, default=100)
    c.add_argument("--device", default="cuda", help=device_help)
    c.set_defaults(fn=_cmd_bundle_adjuster)

    c = sub.add_parser("model_analyzer")
    c.add_argument("--path", required=True)
    c.set_defaults(fn=_cmd_model_analyzer)

    c = sub.add_parser("image_undistorter")
    c.add_argument("--image_path", required=True)
    c.add_argument("--input_path", required=True)
    c.add_argument("--output_path", required=True)
    c.add_argument("--output_type", default="COLMAP", choices=["COLMAP", "PMVS", "CMP-MVS"])
    c.add_argument("--device", default="cuda", help=device_help)
    c.set_defaults(fn=_cmd_image_undistorter)

    c = sub.add_parser("patch_match_stereo")
    c.add_argument("--workspace_path", required=True)
    c.add_argument("--geom_consistency", action="store_true",
                   help="second pass with geometric-consistency cost")
    c.add_argument("--write_consistency_graph", action="store_true",
                   help="write per-pixel consistent-view lists "
                        "(reference: --PatchMatchStereo.write_consistency_graph)")
    c.add_argument("--cache_size", type=float, default=32.0,
                   help="image page cache budget in GB "
                        "(reference: --PatchMatchStereo.cache_size)")
    c.add_argument("--device", default="cuda", help=device_help)
    c.set_defaults(fn=_cmd_patch_match_stereo)

    c = sub.add_parser("stereo_fusion")
    c.add_argument("--workspace_path", required=True)
    c.add_argument("--output_path", required=True)
    c.add_argument("--device", default="cuda", help=device_help)
    c.set_defaults(fn=_cmd_stereo_fusion)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    main()
