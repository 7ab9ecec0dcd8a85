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
    mapper            incremental SfM: database -> sparse model(s)
    bundle_adjuster   read a model, run bundle adjustment, write the model
    model_analyzer    print a model's statistics

Commands return what they built (``main`` passes it on), so a caller that
drives the CLI in-process can read it: ``mapper`` returns its pipeline,
whose ``timer`` holds the time by phase.

Run as ``python -m colmap_tpu_torch.cli.main <command> ...``.
"""

from __future__ import annotations

import argparse
import os


def _cmd_database_creator(args):
    from colmap_tpu_torch.scene.database import Database

    Database(args.database_path).close()
    print(f"Created database at {args.database_path}")


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

    c = sub.add_parser("mapper")
    c.add_argument("--database_path", required=True)
    c.add_argument("--image_path", default=None)
    c.add_argument("--output_path", required=True)
    c.add_argument("--quiet", action="store_true")
    c.add_argument("--device", default="cuda", help=device_help)
    c.set_defaults(fn=_cmd_mapper)

    c = sub.add_parser("bundle_adjuster")
    c.add_argument("--input_path", required=True)
    c.add_argument("--output_path", required=True)
    c.add_argument("--max_num_iterations", type=int, default=100)
    c.add_argument("--device", default="cuda", help=device_help)
    c.set_defaults(fn=_cmd_bundle_adjuster)

    c = sub.add_parser("model_analyzer")
    c.add_argument("--path", required=True)
    c.set_defaults(fn=_cmd_model_analyzer)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    main()
