"""Command-line interface of the port: every command of colmap_tpu's.

reference behavior: src/colmap/exe/colmap.cc. Same command names and flags
as ``python -m colmap_tpu.cli.main``, plus ``--device`` on the commands that
do device work (default ``cuda``; ``cpu`` runs the plain PyTorch versions of
the kernels); commands that only rewrite files stay on the host, as in
colmap_tpu. As colmap_tpu's, the commands are split over this module,
cli/extra_commands.py and cli/extra_commands2.py. Commands of this module:

    database_creator    create an empty database
    feature_extractor   SIFT keypoints and descriptors of a folder of images
    exhaustive_matcher  match and verify every image pair of a database
    sequential_matcher  match and verify pairs within --overlap in name order
    matches_importer    match and verify the pairs of a list file
    spatial_matcher     match and verify pairs of nearby pose priors (GPS)
    transitive_matcher  match and verify the pairs that close A-B, B-C
    geometric_verifier  verify again every pair that has matches
    vocab_tree_builder  train a flat or tree vocabulary on a database's descriptors
    vocab_tree_matcher  match and verify each image's retrieved neighbours
    vocab_tree_retriever  print each image's retrieved neighbours and scores
    rig_configurator    group a database's images into rigs and frames
    mapper            incremental SfM: database -> sparse model(s)
    global_mapper     global SfM: database -> one sparse model
    rotation_averager   global rotations of a database's view graph -> model
    view_graph_calibrator  focal lengths from F matrices -> database cameras
    bundle_adjuster   read a model, run bundle adjustment, write the model
    model_analyzer    print a model's statistics
    image_undistorter   undistort a model's images into a dense workspace
                        (--output_type COLMAP, PMVS or CMP-MVS)
    patch_match_stereo  depth and normal maps of every workspace image
    stereo_fusion       fuse the depth maps into a point cloud (PLY + .vis)
    poisson_mesher      oriented cloud -> mesh (spectral Poisson on the card)
    delaunay_mesher     fused cloud + visibility -> mesh (host scipy)
    advancing_front_mesher  cloud -> mesh by an advancing front (host scipy)
    mesh_simplifier     quadric edge collapse (native/mesh_ops.cpp)
    mesh_texturer       view selection and a texture atlas -> OBJ + MTL + PNG
    image_rectifier     rectify and undistort stereo pairs of a model
    image_undistorter_standalone  undistort images listed with their cameras
    automatic_reconstructor  images -> sparse (and with --dense, dense) model
    point_triangulator  re-triangulate a model's images from a database
    model_converter     BIN, TXT, PLY, NVM, Bundler, VRML, R3D or CAM export
    model_aligner       Sim3-align a model to a reference model
    model_merger        merge two models that share images
    color_extractor     point colours from the images
    model_transformer   apply a Sim3 from a file
    model_cropper       drop points outside a box
    point_filtering     filter points by error, angle and track length
    project_generator   write a project.ini of the option tree
    database_merger     merge two databases into a third
    pose_prior_mapper   mapper, then alignment to the images' prior positions

cli/extra_commands.py adds hierarchical_mapper, image_registrator,
model_comparer, model_splitter, model_clusterer, image_deleter,
image_filterer, database_cleaner, model_orientation_aligner and gui;
cli/extra_commands2.py feature_importer and guided_geometric_verifier.

Commands return what they built (``main`` passes it on), so a caller that
drives the CLI in-process can read it: ``mapper`` and ``global_mapper``
return their pipeline, whose ``timer`` holds the time by phase.

Run as ``python -m colmap_tpu_torch.cli.main <command> ...``.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np


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

    device = resolve_device(args.device)
    db = Database(args.database_path)
    reader = ImageReaderOptions(
        camera_model=args.camera_model, single_camera=not args.per_image_camera,
        camera_params=args.camera_params, mask_path=args.mask_path,
        camera_mask_path=args.camera_mask_path, extractor_type=args.descriptor_type,
        aliked_weights_path=args.aliked_weights_path)
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


def _read_all_descriptors(db, max_per_image=None):
    out = {}
    for (iid, _, _) in db.read_images():
        d = db.read_descriptors(iid)
        if max_per_image and len(d) > max_per_image:
            d = d[:max_per_image]
        out[iid] = d
    return out


def _npz_path(path):
    """np.savez appends .npz when missing; normalize so builder and loader
    agree on the on-disk name."""
    return path if path.endswith(".npz") else path + ".npz"


def _cmd_vocab_tree_builder(args):
    """Writes ``level_<i>`` arrays (a tree, --depth > 1) or ``vocabulary``
    (flat) in float32, the .npz layout colmap_tpu reads and writes."""
    import numpy as np
    import torch

    from colmap_tpu_torch.retrieval.visual_index import build_vocabulary, build_vocabulary_tree
    from colmap_tpu_torch.scene.database import Database
    from colmap_tpu_torch.utils.dtypes import resolve_device

    device = resolve_device(args.device)
    args.vocab_tree_path = _npz_path(args.vocab_tree_path)
    db = Database(args.database_path, must_exist=True)
    desc = _read_all_descriptors(db, max_per_image=args.max_features_per_image)
    db.close()
    all_desc = np.concatenate([d for d in desc.values() if len(d)])
    rng = np.random.default_rng(0)
    if len(all_desc) > args.max_num_descriptors:
        all_desc = all_desc[rng.choice(len(all_desc), args.max_num_descriptors, replace=False)]
    if args.depth > 1:
        tree = build_vocabulary_tree(all_desc, branching=args.branching, depth=args.depth,
                                     device=device)
        np.savez(args.vocab_tree_path, **{f"level_{i}": lv.to(torch.float32).cpu().numpy()
                                          for i, lv in enumerate(tree.levels)})
        print(f"Built hierarchical vocabulary ({args.branching}^{args.depth} = "
              f"{tree.num_words} words) -> {args.vocab_tree_path}")
        return tree
    vocab = build_vocabulary(all_desc, num_words=args.num_words, device=device)
    np.savez(args.vocab_tree_path, vocabulary=vocab.to(torch.float32).cpu().numpy())
    print(f"Built vocabulary of {args.num_words} words -> {args.vocab_tree_path}")
    return vocab


def _load_or_train_index(vocab_tree_path, desc_by_image, device):
    """The index of a built vocabulary file (a tree or a flat vocabulary),
    with every image added. Without one, the shipped small tree, with a
    warning, as colmap_tpu does."""
    import numpy as np

    from colmap_tpu_torch.retrieval.visual_index import (
        VisualIndex,
        default_vocab_tree_path,
        load_vocab_tree,
    )

    if vocab_tree_path and not os.path.exists(vocab_tree_path):
        # The builder writes <path>.npz when the suffix is missing.
        if os.path.exists(_npz_path(vocab_tree_path)):
            vocab_tree_path = _npz_path(vocab_tree_path)
    if vocab_tree_path and os.path.exists(vocab_tree_path):
        data = np.load(vocab_tree_path)
        vocab = (load_vocab_tree(vocab_tree_path, device) if "level_0" in data
                 else data["vocabulary"])
        index = VisualIndex(vocab, device=device)
    else:
        from colmap_tpu_torch.utils import logging

        if vocab_tree_path:
            logging.warning("vocab tree file %s not found; falling back to the shipped small "
                            "tree", vocab_tree_path)
        index = VisualIndex(load_vocab_tree(default_vocab_tree_path(), device), device=device)
    for iid, d in desc_by_image.items():
        index.add(iid, d)
    return index


def _cmd_vocab_tree_matcher(args):
    from colmap_tpu_torch.controllers.feature_pipeline import run_matches_import
    from colmap_tpu_torch.utils.types import image_pair_to_pair_id

    db, device = _open_for_matching(args)
    desc = _read_all_descriptors(db, max_per_image=args.max_features_per_image)
    index = _load_or_train_index(args.vocab_tree_path, desc, device)
    pairs, seen = [], set()
    for iid, d in desc.items():
        for r in index.query(d, args.num_images, exclude_image_id=iid):
            key = image_pair_to_pair_id(iid, r.image_id)
            if key not in seen:
                seen.add(key)
                pairs.append((min(iid, r.image_id), max(iid, r.image_id)))
    n = run_matches_import(db, pairs, device=device)
    print(f"Verified {n} of {len(pairs)} vocab-tree pairs")
    db.close()
    return n


def _cmd_vocab_tree_retriever(args):
    """Returns {image_id: [QueryResult]}."""
    db, device = _open_for_matching(args)
    names = {iid: name for (iid, name, _) in db.read_images()}
    desc = _read_all_descriptors(db, max_per_image=args.max_features_per_image)
    db.close()
    index = _load_or_train_index(args.vocab_tree_path, desc, device)
    out = {}
    for iid, d in desc.items():
        out[iid] = index.query(d, args.num_images, exclude_image_id=iid)
        for r in out[iid]:
            print(f"{names[iid]} {names[r.image_id]} {r.score:.4f}")
    return out


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


def _cmd_image_undistorter(args):
    import numpy as np

    from colmap_tpu_torch.image.undistortion import undistort_camera, undistort_image
    from colmap_tpu_torch.scene.reconstruction_io import read_model, write_model
    from colmap_tpu_torch.utils.dtypes import resolve_device
    from colmap_tpu_torch.utils.image_io import read_image, write_image

    device = resolve_device(args.device)
    recon = read_model(args.input_path)
    if args.output_type == "PMVS":
        from colmap_tpu_torch.cli.export import export_pmvs

        ids = export_pmvs(recon, args.image_path, args.output_path, device=device)
        print(f"PMVS workspace -> {args.output_path}")
        return len(ids)
    if args.output_type == "CMP-MVS":
        from colmap_tpu_torch.cli.export import export_cmp_mvs

        ids = export_cmp_mvs(recon, args.image_path, args.output_path, device=device)
        print(f"CMP-MVS workspace -> {args.output_path}")
        return len(ids)
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
        write_image(dst, out.astype(np.uint8))
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


def _cmd_poisson_mesher(args):
    import sys

    from colmap_tpu_torch.mvs.meshing import PoissonMeshingOptions, poisson_mesh
    from colmap_tpu_torch.utils.dtypes import resolve_device
    from colmap_tpu_torch.utils.ply import read_ply, write_ply_mesh

    device = resolve_device(args.device)
    data = read_ply(args.input_path)
    if "normals" not in data:
        print("Input PLY has no normals; Poisson meshing requires oriented points")
        sys.exit(1)
    options = PoissonMeshingOptions(depth=args.depth, point_weight=args.point_weight,
                                    trim=args.trim)
    verts, faces, colors = poisson_mesh(data["points"], data["normals"], data.get("colors"),
                                        options, device=device)
    write_ply_mesh(args.output_path, verts, faces, colors)
    print(f"Meshed {len(verts)} vertices, {len(faces)} faces -> {args.output_path}")
    return verts, faces, colors


def _cmd_delaunay_mesher(args):
    import sys

    import numpy as np

    from colmap_tpu_torch.mvs.fusion import read_fused_vis
    from colmap_tpu_torch.mvs.meshing import DelaunayMeshingOptions, delaunay_meshing
    from colmap_tpu_torch.scene.reconstruction_io import read_model
    from colmap_tpu_torch.utils.dtypes import resolve_device
    from colmap_tpu_torch.utils.ply import read_ply, write_ply_mesh

    resolve_device(args.device)  # host scipy, as colmap_tpu
    ws = args.input_path
    fused = os.path.join(ws, "fused.ply")
    if not os.path.exists(fused):
        print(f"Missing {fused}; run stereo_fusion first")
        sys.exit(1)
    data = read_ply(fused)
    vis_path = fused + ".vis"
    vis = (read_fused_vis(vis_path) if os.path.exists(vis_path)
           else [np.zeros(0, np.uint32)] * len(data["points"]))
    recon = read_model(os.path.join(ws, "sparse"))
    centers = {iid: np.asarray(recon.cam_from_world(iid).inverse().t)
               for iid in recon.reg_image_ids()}
    options = DelaunayMeshingOptions(quality_regularization=args.quality_regularization)
    verts, faces = delaunay_meshing(data["points"], vis, centers, options)
    write_ply_mesh(args.output_path, verts, faces)
    print(f"Meshed {len(verts)} vertices, {len(faces)} faces -> {args.output_path}")
    return verts, faces


def _cmd_advancing_front_mesher(args):
    from colmap_tpu_torch.mvs.meshing import AdvancingFrontMeshingOptions, advancing_front_mesh
    from colmap_tpu_torch.utils.dtypes import resolve_device
    from colmap_tpu_torch.utils.ply import read_ply, write_ply_mesh

    resolve_device(args.device)  # host scipy, as colmap_tpu
    data = read_ply(args.input_path)
    options = AdvancingFrontMeshingOptions(radius_ratio_bound=args.radius_ratio_bound)
    verts, faces = advancing_front_mesh(data["points"], options)
    write_ply_mesh(args.output_path, verts, faces, data.get("colors"))
    print(f"Meshed {len(verts)} vertices, {len(faces)} faces -> {args.output_path}")
    return verts, faces


def _cmd_mesh_texturer(args):
    from colmap_tpu_torch.mvs.texturing import TextureMappingOptions, texture_mesh, write_obj
    from colmap_tpu_torch.mvs.workspace import _pinhole_K
    from colmap_tpu_torch.scene.reconstruction_io import read_model
    from colmap_tpu_torch.utils.dtypes import resolve_device
    from colmap_tpu_torch.utils.image_io import read_image, to_rgb
    from colmap_tpu_torch.utils.ply import read_ply_mesh

    device = resolve_device(args.device)
    m = read_ply_mesh(args.input_path)
    recon = read_model(args.sparse_path)
    views, images = [], {}
    for iid in recon.reg_image_ids():
        img = recon.images[iid]
        cam = recon.cameras[img.camera_id]
        pose = recon.cam_from_world(iid)
        ipath = os.path.join(args.image_path, img.name)
        if not os.path.exists(ipath):
            continue
        images[iid] = to_rgb(read_image(ipath))
        views.append({"K": _pinhole_K(cam), "R": pose.rotmat(), "t": pose.t.copy(),
                      "width": cam.width, "height": cam.height, "image_key": iid})
    options = TextureMappingOptions(patch_size=args.patch_size)
    atlas, uvs, labels = texture_mesh(m["vertices"], m["faces"], views, images, options,
                                      device=device)
    write_obj(args.output_path, m["vertices"], m["faces"], uvs, atlas)
    n_tex = int((labels >= 0).sum())
    print(f"Textured {n_tex}/{len(m['faces'])} faces -> {args.output_path}")
    return atlas, uvs, labels


def _cmd_mesh_simplifier(args):
    from colmap_tpu_torch.mvs.simplification import simplify_mesh
    from colmap_tpu_torch.utils.dtypes import resolve_device
    from colmap_tpu_torch.utils.ply import read_ply_mesh, write_ply_mesh

    resolve_device(args.device)  # quadric collapse on the host, as colmap_tpu
    m = read_ply_mesh(args.input_path)
    verts, faces = simplify_mesh(m["vertices"], m["faces"], args.factor)
    write_ply_mesh(args.output_path, verts, faces)
    print(f"Simplified {len(m['faces'])} -> {len(faces)} faces "
          f"({len(verts)} vertices) -> {args.output_path}")
    return verts, faces


def _undistort_options(args):
    from colmap_tpu_torch.image.undistortion import UndistortOptions

    return UndistortOptions(blank_pixels=args.blank_pixels, min_scale=args.min_scale,
                            max_scale=args.max_scale, max_image_size=args.max_image_size)


def _cmd_image_rectifier(args):
    import numpy as np

    from colmap_tpu_torch.image.rectification import rectify_and_undistort_stereo_images
    from colmap_tpu_torch.scene.reconstruction_io import read_model
    from colmap_tpu_torch.utils.dtypes import resolve_device
    from colmap_tpu_torch.utils.image_io import read_image, write_image

    device = resolve_device(args.device)
    recon = read_model(args.input_path)
    name_to_id = {img.name: iid for iid, img in recon.images.items()}
    with open(args.stereo_pairs_list) as f:
        pairs = [ln.split() for ln in f if ln.strip()]
    options = _undistort_options(args)
    n = 0
    for name1, name2 in pairs:
        if name1 not in name_to_id or name2 not in name_to_id:
            print(f"SKIP: pair {name1} {name2} not in reconstruction")
            continue
        id1, id2 = name_to_id[name1], name_to_id[name2]
        img1 = read_image(os.path.join(args.image_path, name1))
        img2 = read_image(os.path.join(args.image_path, name2))
        cam1 = recon.cameras[recon.images[id1].camera_id]
        cam2 = recon.cameras[recon.images[id2].camera_id]
        cam2_from_cam1 = recon.cam_from_world(id2).compose(recon.cam_from_world(id1).inverse())
        r1, r2, _, Q = rectify_and_undistort_stereo_images(img1, img2, cam1, cam2,
                                                           cam2_from_cam1, options, device)
        stem = f"{os.path.splitext(name1)[0]}-{os.path.splitext(name2)[0]}"
        outdir = os.path.join(args.output_path, stem)
        os.makedirs(outdir, exist_ok=True)
        write_image(os.path.join(outdir, os.path.basename(name1)), np.asarray(r1, dtype=np.uint8))
        write_image(os.path.join(outdir, os.path.basename(name2)), np.asarray(r2, dtype=np.uint8))
        np.savetxt(os.path.join(outdir, "Q.txt"), Q)
        n += 1
    print(f"Rectified {n} stereo pairs -> {args.output_path}")
    return n


def _cmd_image_undistorter_standalone(args):
    import numpy as np

    from colmap_tpu_torch.image.undistortion import undistort_camera, undistort_image
    from colmap_tpu_torch.scene.types import Camera
    from colmap_tpu_torch.sensor import models as camera_models
    from colmap_tpu_torch.utils.dtypes import resolve_device
    from colmap_tpu_torch.utils.image_io import read_image, write_image

    device = resolve_device(args.device)
    options = _undistort_options(args)
    os.makedirs(args.output_path, exist_ok=True)
    n = 0
    # Input line format (reference: exe/image.cc:465-468):
    #   image_name CAMERA_MODEL camera_params...
    with open(args.input_file) as f:
        for ln in f:
            parts = ln.split()
            if not parts:
                continue
            name, model_name = parts[0], parts[1]
            img = read_image(os.path.join(args.image_path, name))
            h, w = img.shape[:2]
            cam = Camera(camera_id=1, model_id=camera_models.MODEL_NAME_TO_ID[model_name],
                         width=w, height=h, params=np.array([float(v) for v in parts[2:]]))
            ucam = undistort_camera(cam, options, device=device)
            out = undistort_image(img, cam, ucam, device=device)
            dst = os.path.join(args.output_path, name)
            os.makedirs(os.path.dirname(dst) or ".", exist_ok=True)
            write_image(dst, np.asarray(out, dtype=np.uint8))
            n += 1
    print(f"Undistorted {n} images -> {args.output_path}")
    return n


def _cmd_point_triangulator(args):
    """Re-triangulate every registered image of a model from the database's
    correspondences, keeping the poses (reference: point_triangulator)."""
    from colmap_tpu_torch.scene.database import Database
    from colmap_tpu_torch.scene.database_cache import DatabaseCache
    from colmap_tpu_torch.scene.reconstruction_io import read_model, write_model
    from colmap_tpu_torch.sfm.incremental_triangulator import (
        IncrementalTriangulator,
        TriangulatorOptions,
    )
    from colmap_tpu_torch.utils.dtypes import resolve_device

    device = resolve_device(args.device)
    db = Database(args.database_path, must_exist=True)
    recon = read_model(args.input_path)
    cache = DatabaseCache.create(db)
    triangulator = IncrementalTriangulator(cache.correspondence_graph, recon, device)
    n = triangulator.retriangulate(TriangulatorOptions())
    recon.update_point3D_errors()
    write_model(recon, args.output_path, fmt="bin")
    print(f"Triangulated {n} observations")
    db.close()
    return n


def _cmd_model_converter(args):
    from colmap_tpu_torch.scene import exporters
    from colmap_tpu_torch.scene.reconstruction_io import read_model, write_model

    recon = read_model(args.input_path)
    kind = args.output_type
    if kind in ("BIN", "bin"):
        write_model(recon, args.output_path, fmt="bin")
    elif kind in ("TXT", "txt"):
        write_model(recon, args.output_path, fmt="txt")
    elif kind in ("PLY", "ply"):
        from colmap_tpu_torch.utils.ply import write_ply

        pts = (np.stack([p.xyz for p in recon.points3D.values()]) if recon.points3D
               else np.zeros((0, 3)))
        colors = (np.stack([p.color for p in recon.points3D.values()]) if recon.points3D
                  else None)
        write_ply(args.output_path, pts, colors=colors)
    elif kind in ("NVM", "nvm"):
        exporters.write_nvm(recon, args.output_path)
    elif kind in ("Bundler", "bundler"):
        exporters.write_bundler(recon, args.output_path)
    elif kind in ("VRML", "vrml"):
        base = os.path.splitext(args.output_path)[0]
        exporters.write_vrml(recon, base + ".images.wrl", base + ".points3D.wrl")
    elif kind in ("R3D", "r3d", "Recon3D"):
        exporters.write_recon3d(recon, args.output_path)
    elif kind in ("CAM", "cam"):
        exporters.write_cam_files(recon, args.output_path)
    else:
        print(f"Unknown output type {kind}")
        sys.exit(1)
    print(f"Converted model -> {args.output_path}")


def _cmd_model_aligner(args):
    from colmap_tpu_torch.estimators.alignment import align_reconstructions, apply_sim3
    from colmap_tpu_torch.scene.reconstruction_io import read_model, write_model

    recon = read_model(args.input_path)
    ref = read_model(args.ref_model_path)
    sim = align_reconstructions(recon, ref)
    if sim is None:
        print("Alignment failed: not enough common images")
        sys.exit(1)
    apply_sim3(recon, *sim)
    write_model(recon, args.output_path, fmt="bin")
    print(f"Aligned model (scale {sim[0]:.6f}) -> {args.output_path}")
    return sim


def _cmd_model_merger(args):
    from colmap_tpu_torch.estimators.alignment import align_reconstructions, apply_sim3
    from colmap_tpu_torch.scene.reconstruction_io import read_model, write_model

    recon1 = read_model(args.input_path1)
    recon2 = read_model(args.input_path2)
    sim = align_reconstructions(recon2, recon1)
    if sim is None:
        print("Merge failed: models share too few images")
        sys.exit(1)
    apply_sim3(recon2, *sim)
    # Merge entities of recon2 into recon1 (disjoint ids assumed for points).
    for iid in recon2.reg_image_ids():
        if iid not in recon1.images or not recon1.is_image_registered(iid):
            img2 = recon2.images[iid]
            if iid not in recon1.images:
                if img2.camera_id not in recon1.cameras:
                    recon1.add_camera(recon2.cameras[img2.camera_id])
                frame2 = recon2.frames[img2.frame_id]
                if frame2.rig_id not in recon1.rigs:
                    recon1.add_rig(recon2.rigs[frame2.rig_id])
                if frame2.frame_id not in recon1.frames:
                    recon1.add_frame(frame2)
                recon1.add_image(img2)
            recon1.register_frame(recon2.images[iid].frame_id)
    for p in recon2.points3D.values():
        track = [el for el in p.track if el.image_id in recon1.images
                 and recon1.images[el.image_id].points2D_p3d[el.point2D_idx] == -1]
        if len(track) >= 2:
            recon1.add_point3D(p.xyz, track, color=p.color)
    write_model(recon1, args.output_path, fmt="bin")
    print(f"Merged -> {args.output_path}: {recon1.num_reg_frames()} frames, "
          f"{recon1.num_points3D()} points")


def _cmd_color_extractor(args):
    """Each point's colour, the mean of its observations' pixels (nearest
    pixel), from the images; read with utils/image_io.py."""
    from colmap_tpu_torch.scene.reconstruction_io import read_model, write_model
    from colmap_tpu_torch.utils.image_io import read_image, to_rgb

    recon = read_model(args.input_path)
    loaded = {}
    for p in recon.points3D.values():
        votes = []
        for el in p.track:
            image = recon.images[el.image_id]
            if el.image_id not in loaded:
                path = os.path.join(args.image_path, image.name)
                loaded[el.image_id] = to_rgb(read_image(path)) if os.path.exists(path) else None
            img = loaded[el.image_id]
            if img is None:
                continue
            x, y = image.points2D_xy[el.point2D_idx]
            xi = int(np.clip(round(x), 0, img.shape[1] - 1))
            yi = int(np.clip(round(y), 0, img.shape[0] - 1))
            votes.append(img[yi, xi])
        if votes:
            p.color = np.mean(votes, axis=0).astype(np.uint8)
    write_model(recon, args.output_path, fmt="bin")
    print(f"Extracted colors -> {args.output_path}")


def _cmd_model_transformer(args):
    from colmap_tpu_torch.scene.reconstruction_io import read_model, write_model

    recon = read_model(args.input_path)
    # Transform file: one line "scale qw qx qy qz tx ty tz".
    with open(args.transform_path) as f:
        vals = [float(v) for v in f.read().split()]
    recon.transform(vals[0], np.array(vals[1:5]), np.array(vals[5:8]))
    write_model(recon, args.output_path, fmt="bin")
    print(f"Transformed -> {args.output_path}")


def _cmd_model_cropper(args):
    from colmap_tpu_torch.scene.reconstruction_io import read_model, write_model

    recon = read_model(args.input_path)
    bounds = [float(v) for v in args.boundary.split(",")]
    lo, hi = np.array(bounds[:3]), np.array(bounds[3:6])
    for pid in list(recon.points3D.keys()):
        xyz = recon.points3D[pid].xyz
        if np.any(xyz < lo) or np.any(xyz > hi):
            recon.delete_point3D(pid)
    write_model(recon, args.output_path, fmt="bin")
    print(f"Cropped to {recon.num_points3D()} points -> {args.output_path}")


def _cmd_point_filtering(args):
    """filter_points3D (K9 on ``--device``), then the track-length cut."""
    from colmap_tpu_torch.scene.reconstruction_io import read_model, write_model
    from colmap_tpu_torch.sfm.filtering import filter_points3D
    from colmap_tpu_torch.utils.dtypes import resolve_device

    device = resolve_device(args.device)
    recon = read_model(args.input_path)
    n = filter_points3D(recon, max_reproj_error=args.max_reproj_error,
                        min_tri_angle_deg=args.min_tri_angle, device=device)
    for pid in list(recon.points3D.keys()):
        if len(recon.points3D[pid].track) < args.min_track_len:
            recon.delete_point3D(pid)
    write_model(recon, args.output_path, fmt="bin")
    print(f"Filtered {n} observations -> {args.output_path}")
    return n


def _cmd_project_generator(args):
    from colmap_tpu_torch.controllers.option_manager import OptionManager

    om = OptionManager(database_path=args.database_path or "", image_path=args.image_path or "")
    om.write(args.output_path)
    print(f"Wrote project file -> {args.output_path}")


def _cmd_database_merger(args):
    import dataclasses

    from colmap_tpu_torch.scene.database import Database
    from colmap_tpu_torch.utils.types import pair_id_to_image_pair

    db1 = Database(args.database_path1)
    db2 = Database(args.database_path2)
    out = Database(args.merged_database_path)
    for db in (db1, db2):
        cam_map = {cid: out.write_camera(dataclasses.replace(cam, camera_id=0),
                                         use_camera_id=False)
                   for cid, cam in db.read_cameras().items()}
        local = {}
        for iid, name, cid in db.read_images():
            new_id = out.write_image(name, cam_map[cid])
            local[iid] = new_id
            kp = db.read_keypoints(iid)
            if len(kp):
                out.write_keypoints(new_id, kp)
            desc = db.read_descriptors(iid)
            if len(desc):
                out.write_descriptors(new_id, desc)
        for pair_id, m in db.read_all_matches():
            a, b = pair_id_to_image_pair(pair_id)
            if a in local and b in local:
                out.write_matches(local[a], local[b], m)
        for a, b, g in db.read_all_two_view_geometries():
            if g is not None and a in local and b in local:
                out.write_two_view_geometry(local[a], local[b], g)
    out.commit()
    print(f"Merged -> {args.merged_database_path}: {out.num_images()} images")
    db1.close()
    db2.close()
    out.close()


def _cmd_pose_prior_mapper(args):
    """The mapper on ``--device``, then each model's robust Sim3 alignment
    to its images' prior positions (reference: pose_prior_mapper,
    exe/sfm.cc)."""
    from colmap_tpu_torch.estimators.alignment import align_reconstruction_to_pose_priors
    from colmap_tpu_torch.scene.database import Database
    from colmap_tpu_torch.scene.reconstruction_io import write_model
    from colmap_tpu_torch.sfm.incremental_pipeline import (
        IncrementalPipeline,
        IncrementalPipelineOptions,
    )
    from colmap_tpu_torch.utils.dtypes import resolve_device

    device = resolve_device(args.device)
    db = Database(args.database_path, must_exist=True)
    priors = {prior["data_id"]: prior["position"] for prior in db.read_pose_priors().values()
              if prior["position"] is not None}
    models = IncrementalPipeline(IncrementalPipelineOptions(), db, device=device).run()
    os.makedirs(args.output_path, exist_ok=True)
    for i, recon in enumerate(models):
        align_reconstruction_to_pose_priors(recon, priors,
                                            robust_max_error=args.prior_position_max_error)
        out = os.path.join(args.output_path, str(i))
        write_model(recon, out, fmt="bin")
        print(f"Model {i}: {recon.num_reg_frames()} frames -> {out}")
    db.close()
    return models


def _cmd_automatic_reconstructor(args):
    from colmap_tpu_torch.controllers.automatic import (
        AutomaticReconstructionOptions,
        DataType,
        Quality,
        run_automatic_reconstruction,
    )

    options = AutomaticReconstructionOptions(
        workspace_path=args.workspace_path,
        image_path=args.image_path,
        data_type=DataType(args.data_type),
        quality=Quality(args.quality),
        camera_model=args.camera_model,
        single_camera=not args.per_image_camera,
        dense=args.dense,
    )
    models = run_automatic_reconstruction(options, device=args.device)
    print(f"Reconstructed {len(models)} model(s) -> {args.workspace_path}")
    return models


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="colmap_tpu_torch",
        description="PyTorch/CUDA SfM with COLMAP-compatible data formats",
    )
    p.add_argument("--log_level", type=int, default=0,
                   help="VLOG verbosity: 0 info, 1/2 increasing detail "
                        "(reference: glog --v)")
    p.add_argument("--profile_dir", default="",
                   help="trace the command with torch.profiler (CPU, and CUDA when the "
                        "command runs on the card) into this directory")
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

    c = sub.add_parser("vocab_tree_builder")
    c.add_argument("--database_path", required=True)
    c.add_argument("--vocab_tree_path", required=True)
    c.add_argument("--num_words", type=int, default=1024)
    c.add_argument("--branching", type=int, default=10)
    c.add_argument("--depth", type=int, default=1,
                   help="depth > 1 builds a hierarchical k-means tree with "
                        "branching**depth effective words")
    c.add_argument("--max_num_descriptors", type=int, default=200000)
    c.add_argument("--max_features_per_image", type=int, default=2000)
    c.add_argument("--device", default="cuda", help=device_help)
    c.set_defaults(fn=_cmd_vocab_tree_builder)

    for name, fn in (("vocab_tree_matcher", _cmd_vocab_tree_matcher),
                     ("vocab_tree_retriever", _cmd_vocab_tree_retriever)):
        c = sub.add_parser(name)
        c.add_argument("--database_path", required=True)
        c.add_argument("--vocab_tree_path", default=None)
        c.add_argument("--num_images", type=int, default=10)
        c.add_argument("--max_features_per_image", type=int, default=2000)
        c.add_argument("--device", default="cuda", help=device_help)
        c.set_defaults(fn=fn)

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

    c = sub.add_parser("poisson_mesher")
    c.add_argument("--input_path", required=True, help="fused.ply with normals")
    c.add_argument("--output_path", required=True)
    c.add_argument("--depth", type=int, default=8)
    c.add_argument("--point_weight", type=float, default=1.0)
    c.add_argument("--trim", type=float, default=3.0)
    c.add_argument("--device", default="cuda", help=device_help)
    c.set_defaults(fn=_cmd_poisson_mesher)

    c = sub.add_parser("delaunay_mesher")
    c.add_argument("--input_path", required=True,
                   help="dense workspace with fused.ply(.vis) and sparse/")
    c.add_argument("--output_path", required=True)
    c.add_argument("--quality_regularization", type=float, default=1.0)
    c.add_argument("--device", default="cuda", help=device_help)
    c.set_defaults(fn=_cmd_delaunay_mesher)

    c = sub.add_parser("mesh_texturer")
    c.add_argument("--input_path", required=True, help="mesh PLY")
    c.add_argument("--sparse_path", required=True)
    c.add_argument("--image_path", required=True)
    c.add_argument("--output_path", required=True, help="output OBJ")
    c.add_argument("--patch_size", type=int, default=16)
    c.add_argument("--device", default="cuda", help=device_help)
    c.set_defaults(fn=_cmd_mesh_texturer)

    c = sub.add_parser("mesh_simplifier")
    c.add_argument("--input_path", required=True)
    c.add_argument("--output_path", required=True)
    c.add_argument("--factor", type=float, default=0.1, help="fraction of faces to keep")
    c.add_argument("--device", default="cuda", help=device_help)
    c.set_defaults(fn=_cmd_mesh_simplifier)

    c = sub.add_parser("image_rectifier")
    c.add_argument("--image_path", required=True)
    c.add_argument("--input_path", required=True)
    c.add_argument("--output_path", required=True)
    c.add_argument("--stereo_pairs_list", required=True)
    c.add_argument("--blank_pixels", type=float, default=0.0)
    c.add_argument("--min_scale", type=float, default=0.2)
    c.add_argument("--max_scale", type=float, default=2.0)
    c.add_argument("--max_image_size", type=int, default=-1)
    c.add_argument("--device", default="cuda", help=device_help)
    c.set_defaults(fn=_cmd_image_rectifier)

    c = sub.add_parser("image_undistorter_standalone")
    c.add_argument("--image_path", required=True)
    c.add_argument("--input_file", required=True)
    c.add_argument("--output_path", required=True)
    c.add_argument("--blank_pixels", type=float, default=0.0)
    c.add_argument("--min_scale", type=float, default=0.2)
    c.add_argument("--max_scale", type=float, default=2.0)
    c.add_argument("--max_image_size", type=int, default=-1)
    c.add_argument("--device", default="cuda", help=device_help)
    c.set_defaults(fn=_cmd_image_undistorter_standalone)

    c = sub.add_parser("advancing_front_mesher")
    c.add_argument("--input_path", required=True)
    c.add_argument("--output_path", required=True)
    c.add_argument("--radius_ratio_bound", type=float, default=5.0)
    c.add_argument("--device", default="cuda", help=device_help)
    c.set_defaults(fn=_cmd_advancing_front_mesher)

    c = sub.add_parser("automatic_reconstructor")
    c.add_argument("--workspace_path", required=True)
    c.add_argument("--image_path", required=True)
    c.add_argument("--data_type", default="individual",
                   choices=["individual", "video", "internet"])
    c.add_argument("--quality", default="high", choices=["low", "medium", "high", "extreme"])
    c.add_argument("--camera_model", default="SIMPLE_RADIAL")
    c.add_argument("--per_image_camera", action="store_true")
    c.add_argument("--dense", action="store_true")
    c.add_argument("--device", default="cuda", help=device_help)
    c.set_defaults(fn=_cmd_automatic_reconstructor)

    c = sub.add_parser("point_triangulator")
    c.add_argument("--database_path", required=True)
    c.add_argument("--input_path", required=True)
    c.add_argument("--output_path", required=True)
    c.add_argument("--device", default="cuda", help=device_help)
    c.set_defaults(fn=_cmd_point_triangulator)

    c = sub.add_parser("model_converter")
    c.add_argument("--input_path", required=True)
    c.add_argument("--output_path", required=True)
    c.add_argument("--output_type", required=True)
    c.set_defaults(fn=_cmd_model_converter)

    c = sub.add_parser("model_aligner")
    c.add_argument("--input_path", required=True)
    c.add_argument("--ref_model_path", required=True)
    c.add_argument("--output_path", required=True)
    c.set_defaults(fn=_cmd_model_aligner)

    c = sub.add_parser("model_merger")
    c.add_argument("--input_path1", required=True)
    c.add_argument("--input_path2", required=True)
    c.add_argument("--output_path", required=True)
    c.set_defaults(fn=_cmd_model_merger)

    c = sub.add_parser("color_extractor")
    c.add_argument("--image_path", required=True)
    c.add_argument("--input_path", required=True)
    c.add_argument("--output_path", required=True)
    c.set_defaults(fn=_cmd_color_extractor)

    c = sub.add_parser("model_transformer")
    c.add_argument("--input_path", required=True)
    c.add_argument("--output_path", required=True)
    c.add_argument("--transform_path", required=True)
    c.set_defaults(fn=_cmd_model_transformer)

    c = sub.add_parser("model_cropper")
    c.add_argument("--input_path", required=True)
    c.add_argument("--output_path", required=True)
    c.add_argument("--boundary", required=True, help="x0,y0,z0,x1,y1,z1")
    c.set_defaults(fn=_cmd_model_cropper)

    c = sub.add_parser("point_filtering")
    c.add_argument("--input_path", required=True)
    c.add_argument("--output_path", required=True)
    c.add_argument("--max_reproj_error", type=float, default=4.0)
    c.add_argument("--min_tri_angle", type=float, default=1.5)
    c.add_argument("--min_track_len", type=int, default=2)
    c.add_argument("--device", default="cuda", help=device_help)
    c.set_defaults(fn=_cmd_point_filtering)

    c = sub.add_parser("project_generator")
    c.add_argument("--database_path", default="")
    c.add_argument("--image_path", default="")
    c.add_argument("--output_path", required=True)
    c.set_defaults(fn=_cmd_project_generator)

    c = sub.add_parser("database_merger")
    c.add_argument("--database_path1", required=True)
    c.add_argument("--database_path2", required=True)
    c.add_argument("--merged_database_path", required=True)
    c.set_defaults(fn=_cmd_database_merger)

    c = sub.add_parser("pose_prior_mapper")
    c.add_argument("--database_path", required=True)
    c.add_argument("--output_path", required=True)
    c.add_argument("--prior_position_max_error", type=float, default=5.0)
    c.add_argument("--device", default="cuda", help=device_help)
    c.set_defaults(fn=_cmd_pose_prior_mapper)

    from colmap_tpu_torch.cli.extra_commands import register as register_extra
    from colmap_tpu_torch.cli.extra_commands2 import register as register_extra2

    register_extra(sub, device_help)
    register_extra2(sub, device_help)
    return p


def _profiled(args):
    """Run the command under torch.profiler and write its Chrome trace into
    ``--profile_dir`` (colmap_tpu writes a jax.profiler trace there)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from colmap_tpu_torch.utils import logging

    activities = [ProfilerActivity.CPU]
    if torch.device(getattr(args, "device", "cpu")).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(args.profile_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        out = args.fn(args)
    path = os.path.join(args.profile_dir, f"{args.command}.pt.trace.json")
    prof.export_chrome_trace(path)
    logging.info("Profile written to %s", path)
    return out


def main(argv=None):
    args = build_parser().parse_args(argv)
    from colmap_tpu_torch.parallel import multihost
    from colmap_tpu_torch.utils import logging

    logging.set_verbosity(args.log_level)
    # Join a process group when launched under torchrun with
    # COLMAP_TPU_MULTIHOST=1 (a no-op otherwise), as colmap_tpu joins its cluster.
    multihost.initialize()
    if args.profile_dir:
        return _profiled(args)
    return args.fn(args)


if __name__ == "__main__":
    main()
