"""CLI commands, second module: mappers, model and database tools.

Counterpart of colmap_tpu/cli/extra_commands.py (reference behavior:
src/colmap/exe/colmap.cc:92-159): hierarchical_mapper, image_registrator,
model_comparer, model_splitter, model_clusterer, image_deleter,
image_filterer, database_cleaner, model_orientation_aligner and gui, with
colmap_tpu's names, arguments and file formats. The commands colmap_tpu
keeps in this module that the port had already (the spatial, transitive and
vocabulary-tree matchers, the vocabulary tree's builder and retriever,
geometric_verifier, rotation_averager, view_graph_calibrator,
rig_configurator) stay in cli/main.py. ``hierarchical_mapper``,
``image_registrator`` and ``model_orientation_aligner`` take ``--device``;
the others only read and write files and stay on the host.
"""

from __future__ import annotations

import copy
import os
import sys

import numpy as np


def _write_models(models, output_path):
    from colmap_tpu_torch.scene.reconstruction_io import write_model

    os.makedirs(output_path, exist_ok=True)
    for i, recon in enumerate(models):
        out = os.path.join(output_path, str(i))
        write_model(recon, out, fmt="bin")
        print(f"Model {i}: {recon.num_reg_frames()} frames, "
              f"{recon.num_points3D()} points -> {out}")


def _cmd_hierarchical_mapper(args):
    from colmap_tpu_torch.parallel import multihost
    from colmap_tpu_torch.scene.clustering import SceneClusteringOptions
    from colmap_tpu_torch.scene.database import Database
    from colmap_tpu_torch.sfm.hierarchical_pipeline import (
        HierarchicalPipeline,
        HierarchicalPipelineOptions,
    )

    db = Database(args.database_path, must_exist=True)
    options = HierarchicalPipelineOptions(
        clustering=SceneClusteringOptions(leaf_max_num_images=args.leaf_max_num_images,
                                          image_overlap=args.image_overlap),
        verbose=not args.quiet)
    models = HierarchicalPipeline(options, db, device=args.device).run()
    if multihost.process_index() == 0:  # every process merged the same models
        _write_models(models, args.output_path)
    db.close()
    return models


def _cmd_image_registrator(args):
    """Register additional images into an existing model without changing
    the model's structure (reference: image_registrator, exe/sfm.cc)."""
    from colmap_tpu_torch.scene.database import Database
    from colmap_tpu_torch.scene.database_cache import DatabaseCache
    from colmap_tpu_torch.scene.reconstruction_io import read_model, write_model
    from colmap_tpu_torch.scene.types import INVALID_POINT3D, Frame, Image
    from colmap_tpu_torch.sfm.incremental_mapper import (
        IncrementalMapper,
        IncrementalMapperOptions,
    )
    from colmap_tpu_torch.utils.dtypes import resolve_device

    device = resolve_device(args.device)
    db = Database(args.database_path, must_exist=True)
    recon = read_model(args.input_path)
    cache = DatabaseCache.create(db)
    # Unregistered images are not serialized in images.bin; bring them in
    # from the database so they become registration candidates.
    for iid, image in cache.images.items():
        if iid in recon.images:
            continue
        if image.camera_id not in recon.cameras:
            recon.add_camera(cache.cameras[image.camera_id])
        frame = cache.frames[image.frame_id]
        if frame.rig_id not in recon.rigs:
            recon.add_rig(cache.rigs[frame.rig_id])
        if frame.frame_id not in recon.frames:
            recon.add_frame(Frame(frame_id=frame.frame_id, rig_id=frame.rig_id,
                                  data_ids=list(frame.data_ids)))
        img = Image(image_id=image.image_id, name=image.name, camera_id=image.camera_id,
                    frame_id=image.frame_id)
        img.points2D_xy = image.points2D_xy.copy()
        img.points2D_p3d = np.full(image.num_points2D(), INVALID_POINT3D, dtype=np.int64)
        recon.add_image(img)
    mapper = IncrementalMapper(cache, device)
    mapper.begin_reconstruction(recon)
    options = IncrementalMapperOptions()
    n_registered = 0
    for _ in range(len(cache.images)):
        candidates = [iid for iid in mapper.find_next_images(options)
                      if not recon.is_image_registered(iid)]
        if not candidates:
            break
        ok = False
        for iid in candidates[:args.max_trials_per_round]:
            if mapper.register_next_image(iid, options):
                n_registered += 1
                ok = True
                break
        if not ok:
            break
    write_model(recon, args.output_path, fmt="bin")
    print(f"Registered {n_registered} additional images -> {args.output_path}")
    db.close()
    return n_registered


def _cmd_model_comparer(args):
    from colmap_tpu_torch.estimators.alignment import compare_reconstructions
    from colmap_tpu_torch.scene.reconstruction_io import read_model

    stats = compare_reconstructions(read_model(args.input_path1), read_model(args.input_path2))
    print(f"Common images: {stats.get('num_common_images', 0)}")
    if stats.get("num_common_images", 0) > 0:
        print(f"Mean rotation error: {np.mean(stats['rotation_errors_deg']):.6f} deg")
        print(f"Max rotation error: {np.max(stats['rotation_errors_deg']):.6f} deg")
        print(f"Mean center error: {np.mean(stats['center_errors']):.6f}")
        print(f"Max center error: {np.max(stats['center_errors']):.6f}")
    return stats


def _submodel_for_images(recon, keep_ids):
    """New reconstruction restricted to the given registered image ids."""
    from colmap_tpu_torch.scene.reconstruction import Reconstruction

    keep = set(keep_ids)
    sub = Reconstruction()
    for cam in recon.cameras.values():
        sub.add_camera(cam)
    frames_needed = {recon.images[iid].frame_id for iid in keep}
    for fid in frames_needed:
        frame = recon.frames[fid]
        if frame.rig_id not in sub.rigs:
            sub.add_rig(recon.rigs[frame.rig_id])
        sub.add_frame(copy.deepcopy(frame))
    for iid in keep:
        img = copy.deepcopy(recon.images[iid])
        img.points2D_p3d = np.full(len(img.points2D_p3d), -1, dtype=np.int64)
        sub.add_image(img)
    for fid in frames_needed:
        if recon.is_frame_registered(fid):
            sub.register_frame(fid)
    for p in recon.points3D.values():
        track = [el for el in p.track if el.image_id in keep]
        if len(track) >= 2:
            sub.add_point3D(p.xyz, track, color=p.color)
    return sub


def _cmd_model_splitter(args):
    """Split a model into spatial tiles (reference: model_splitter,
    exe/model.cc: parts with overlap)."""
    from colmap_tpu_torch.scene.reconstruction_io import read_model, write_model

    recon = read_model(args.input_path)
    if recon.num_points3D() == 0:
        print("Empty model")
        sys.exit(1)
    pts = np.stack([p.xyz for p in recon.points3D.values()])
    lo, hi = pts.min(axis=0), pts.max(axis=0)
    n = args.num_parts
    axis = int(np.argmax(hi - lo))
    edges = np.linspace(lo[axis], hi[axis], n + 1)
    overlap = args.overlap_ratio * (edges[1] - edges[0])
    os.makedirs(args.output_path, exist_ok=True)
    for k in range(n):
        lo_k, hi_k = edges[k] - overlap, edges[k + 1] + overlap
        img_ids = set()
        for p in recon.points3D.values():
            if lo_k <= p.xyz[axis] <= hi_k:
                img_ids.update(el.image_id for el in p.track)
        img_ids = {i for i in img_ids if recon.is_image_registered(i)}
        if not img_ids:
            continue
        sub = _submodel_for_images(recon, img_ids)
        for pid in list(sub.points3D.keys()):  # crop the points to the tile
            if not (lo_k <= sub.points3D[pid].xyz[axis] <= hi_k):
                sub.delete_point3D(pid)
        out = os.path.join(args.output_path, str(k))
        write_model(sub, out, fmt="bin")
        print(f"Part {k}: {sub.num_reg_frames()} frames, {sub.num_points3D()} points -> {out}")


def _cmd_model_clusterer(args):
    """Cluster a model's images by covisibility and write each cluster's
    submodel (reference: model_clusterer)."""
    from colmap_tpu_torch.scene.clustering import SceneClusteringOptions, cluster_scene
    from colmap_tpu_torch.scene.reconstruction_io import read_model, write_model

    recon = read_model(args.input_path)
    reg = sorted(recon.reg_image_ids())
    weights = {}
    for p in recon.points3D.values():
        track_ids = sorted({el.image_id for el in p.track})
        for i in range(len(track_ids)):
            for j in range(i + 1, len(track_ids)):
                key = (track_ids[i], track_ids[j])
                weights[key] = weights.get(key, 0.0) + 1.0
    clusters = cluster_scene(reg, weights,
                             SceneClusteringOptions(leaf_max_num_images=args.leaf_max_num_images))
    os.makedirs(args.output_path, exist_ok=True)
    for k, cluster in enumerate(clusters):
        sub = _submodel_for_images(recon, cluster)
        out = os.path.join(args.output_path, str(k))
        write_model(sub, out, fmt="bin")
        print(f"Cluster {k}: {sub.num_reg_frames()} frames, {sub.num_points3D()} points -> {out}")
    return clusters


def _cmd_image_deleter(args):
    """Delete images from a model (reference: image_deleter, exe/image.cc)."""
    from colmap_tpu_torch.scene.reconstruction_io import read_model, write_model

    recon = read_model(args.input_path)
    to_delete = set()
    if args.image_names_path:
        with open(args.image_names_path) as f:
            names = {line.strip() for line in f if line.strip()}
        to_delete |= {iid for iid, img in recon.images.items() if img.name in names}
    if args.image_ids_path:
        with open(args.image_ids_path) as f:
            to_delete |= {int(line) for line in f if line.strip()}
    keep = [iid for iid in recon.reg_image_ids() if iid not in to_delete]
    write_model(_submodel_for_images(recon, keep), args.output_path, fmt="bin")
    print(f"Deleted {len(to_delete)} images -> {args.output_path}")


def _cmd_image_filterer(args):
    """Remove weakly constrained images (reference: image_filterer,
    exe/image.cc: min_num_observations)."""
    from colmap_tpu_torch.scene.reconstruction_io import read_model, write_model

    recon = read_model(args.input_path)
    keep = [iid for iid in recon.reg_image_ids()
            if int(np.sum(np.asarray(recon.images[iid].points2D_p3d) >= 0))
            >= args.min_num_observations]
    write_model(_submodel_for_images(recon, keep), args.output_path, fmt="bin")
    print(f"Kept {len(keep)} of {recon.num_reg_frames()} images -> {args.output_path}")


def _cmd_database_cleaner(args):
    """Clear database tables (reference: database_cleaner, exe/database.cc:
    types all, images, features, matches)."""
    from colmap_tpu_torch.scene.database import Database

    db = Database(args.database_path, must_exist=True)
    t = args.type
    cur = db.conn
    if t in ("matches", "features", "images", "all"):
        cur.execute("DELETE FROM two_view_geometries")
        cur.execute("DELETE FROM matches")
    if t in ("features", "images", "all"):
        cur.execute("DELETE FROM descriptors")
        cur.execute("DELETE FROM keypoints")
    if t in ("images", "all"):
        cur.execute("DELETE FROM pose_priors")
        cur.execute("DELETE FROM frames")
        cur.execute("DELETE FROM frame_data")
        cur.execute("DELETE FROM images")
    if t == "all":
        cur.execute("DELETE FROM cameras")
        cur.execute("DELETE FROM rig_sensors")
        cur.execute("DELETE FROM rigs")
    db.commit()
    print(f"Cleaned database ({t})")
    db.close()


def _cmd_model_orientation_aligner(args):
    """Align the model's axes to an estimated world frame (reference:
    model_orientation_aligner, exe/model.cc, methods MANHATTAN-WORLD and
    IMAGE-ORIENTATION; PRINCIPAL-PLANE and ENU from AlignToPrincipalPlane and
    AlignToENUPlane). MANHATTAN-WORLD reads the images with
    utils/image_io.py (``read_image_gray`` standing for PIL's
    ``convert("L")``) and runs the line detector's gradients (K49) on
    ``--device``; ``--max_image_size`` is taken and, as in colmap_tpu, not
    read by the estimator."""
    import torch

    from colmap_tpu_torch.estimators import coordinate_frame as cf
    from colmap_tpu_torch.estimators.gravity_refinement import gravity_aligned_rotation
    from colmap_tpu_torch.geometry import rotation as rot
    from colmap_tpu_torch.scene.reconstruction_io import read_model, write_model
    from colmap_tpu_torch.utils.dtypes import resolve_device
    from colmap_tpu_torch.utils.image_io import read_image_gray

    recon = read_model(args.input_path)
    method = args.method.upper()
    if method == "MANHATTAN-WORLD":
        device = resolve_device(args.device)
        if not args.image_path:
            print("--image_path required for MANHATTAN-WORLD")
            sys.exit(1)
        images = {}
        for iid in recon.reg_image_ids():
            p = os.path.join(args.image_path, recon.images[iid].name)
            if os.path.exists(p):
                images[iid] = read_image_gray(p).astype(np.float32)
        frame = cf.estimate_manhattan_world_frame(
            recon, images, cf.ManhattanWorldFrameOptions(max_image_size=args.max_image_size),
            device=device)
        if not np.isfinite(frame).all() or abs(np.linalg.det(frame)) < 0.5:
            print("Manhattan frame estimation failed")
            sys.exit(1)
        cf.align_to_orientation_frame(recon, frame)
        result = frame
    elif method == "IMAGE-ORIENTATION":
        gravity = cf.estimate_gravity_from_image_orientation(recon)
        if np.linalg.norm(gravity) < 0.5:
            print("Gravity estimation failed")
            sys.exit(1)
        # Rotate the estimated downward axis onto +y (COLMAP convention: y
        # points down in world space after orientation alignment).
        R = gravity_aligned_rotation(gravity)
        recon.transform(1.0, rot.rotmat_to_quat(torch.as_tensor(R)).numpy(), np.zeros(3))
        result = gravity
    elif method == "PRINCIPAL-PLANE":
        result = cf.align_to_principal_plane(recon)
    elif method == "ENU":
        result = cf.align_to_enu_plane(recon)
    else:
        print(f"Unknown method {args.method}")
        sys.exit(1)
    write_model(recon, args.output_path, fmt="bin")
    print(f"Aligned model ({method}) -> {args.output_path}")
    return result


def _cmd_gui(args):
    print("colmap_tpu_torch is a headless framework; the Qt GUI is not available."
          " Use the CLI commands or the pycolmap-compatible Python API.")
    sys.exit(1)


def register(sub, device_help):
    c = sub.add_parser("gui")
    c.set_defaults(fn=_cmd_gui)

    c = sub.add_parser("hierarchical_mapper")
    c.add_argument("--database_path", required=True)
    c.add_argument("--output_path", required=True)
    c.add_argument("--leaf_max_num_images", type=int, default=500)
    c.add_argument("--image_overlap", type=int, default=50)
    c.add_argument("--quiet", action="store_true")
    c.add_argument("--device", default="cuda", help=device_help)
    c.set_defaults(fn=_cmd_hierarchical_mapper)

    c = sub.add_parser("image_registrator")
    c.add_argument("--database_path", required=True)
    c.add_argument("--input_path", required=True)
    c.add_argument("--output_path", required=True)
    c.add_argument("--max_trials_per_round", type=int, default=10)
    c.add_argument("--device", default="cuda", help=device_help)
    c.set_defaults(fn=_cmd_image_registrator)

    c = sub.add_parser("model_comparer")
    c.add_argument("--input_path1", required=True)
    c.add_argument("--input_path2", required=True)
    c.set_defaults(fn=_cmd_model_comparer)

    c = sub.add_parser("model_splitter")
    c.add_argument("--input_path", required=True)
    c.add_argument("--output_path", required=True)
    c.add_argument("--num_parts", type=int, default=2)
    c.add_argument("--overlap_ratio", type=float, default=0.05)
    c.set_defaults(fn=_cmd_model_splitter)

    c = sub.add_parser("model_clusterer")
    c.add_argument("--input_path", required=True)
    c.add_argument("--output_path", required=True)
    c.add_argument("--leaf_max_num_images", type=int, default=500)
    c.set_defaults(fn=_cmd_model_clusterer)

    c = sub.add_parser("image_deleter")
    c.add_argument("--input_path", required=True)
    c.add_argument("--output_path", required=True)
    c.add_argument("--image_names_path", default=None)
    c.add_argument("--image_ids_path", default=None)
    c.set_defaults(fn=_cmd_image_deleter)

    c = sub.add_parser("image_filterer")
    c.add_argument("--input_path", required=True)
    c.add_argument("--output_path", required=True)
    c.add_argument("--min_num_observations", type=int, default=10)
    c.set_defaults(fn=_cmd_image_filterer)

    c = sub.add_parser("database_cleaner")
    c.add_argument("--database_path", required=True)
    c.add_argument("--type", required=True, choices=["all", "images", "features", "matches"])
    c.set_defaults(fn=_cmd_database_cleaner)

    c = sub.add_parser("model_orientation_aligner")
    c.add_argument("--input_path", required=True)
    c.add_argument("--output_path", required=True)
    c.add_argument("--image_path", default=None)
    c.add_argument("--method", default="MANHATTAN-WORLD",
                   choices=["MANHATTAN-WORLD", "IMAGE-ORIENTATION", "PRINCIPAL-PLANE", "ENU",
                            "manhattan-world", "image-orientation", "principal-plane", "enu"])
    c.add_argument("--max_image_size", type=int, default=1024)
    c.add_argument("--device", default="cuda", help=device_help)
    c.set_defaults(fn=_cmd_model_orientation_aligner)
