"""Command-line interface of the port (the ported subset of colmap_tpu's).

reference behavior: src/colmap/exe/colmap.cc. Same command names and flags
as ``python -m colmap_tpu.cli.main``, plus ``--device`` (default ``cuda``;
``cpu`` runs the plain PyTorch versions of the kernels). Ported commands:

    database_creator    create an empty database
    exhaustive_matcher  match and verify every image pair of a database
    sequential_matcher  match and verify pairs within --overlap in name order
    matches_importer    match and verify the pairs of a list file
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
