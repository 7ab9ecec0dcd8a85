"""colmap_tpu_torch's sparse-model tools and the rest of the CLI against
colmap_tpu on the CPU, at the sizes of tests/test_cli_tools*.py.

The two CLIs register the same 52 commands with the same arguments (the
port adds ``--device`` where a command does device work). Every file tool
runs in both packages on the same inputs and the outputs are read back and
compared: models within 1e-9 (the same float64 host code), the exports
byte for byte, databases table by table, printed lines equal. The commands
that map or register (point_triangulator, image_registrator,
pose_prior_mapper, hierarchical_mapper, automatic_reconstructor,
guided_geometric_verifier) run the port with ``--device cpu``:
point_triangulator against colmap_tpu's command, the others against the
ground truth at colmap_tpu's own test gates. The modules behind them
(exporters, clustering, the hierarchical merge, the option manager, the
reconstruction manager, pruning, the Umeyama solver and the pose-prior
alignment) are held against colmap_tpu's directly.
"""

import argparse
import copy
import filecmp
import os
import sqlite3

import numpy as np
import pytest

from colmap_tpu.cli.main import build_parser as ref_parser
from colmap_tpu.cli.main import main as ref_main
from colmap_tpu.scene.reconstruction_io import read_model as ref_read
from colmap_tpu.scene.reconstruction_io import write_model as ref_write
from colmap_tpu.scene.synthetic import SyntheticDatasetOptions as RSynOpts
from colmap_tpu.scene.synthetic import synthesize_dataset as ref_synthesize

from colmap_tpu_torch.cli.main import build_parser as port_parser
from colmap_tpu_torch.cli.main import main as port_main
from colmap_tpu_torch.convert import convert_reconstruction
from colmap_tpu_torch.scene.database import Database
from colmap_tpu_torch.scene.reconstruction_io import read_model, write_model
from colmap_tpu_torch.scene.synthetic import SyntheticDatasetOptions, synthesize_dataset


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("tools_model")
    ref_write(ref_synthesize(RSynOpts(num_rigs=1, num_frames_per_rig=6, num_points3D=80,
                                      seed=5)), str(d), fmt="bin")
    return str(d)


@pytest.fixture(scope="module")
def db_and_gt(tmp_path_factory):
    d = tmp_path_factory.mktemp("tools_db")
    path = str(d / "database.db")
    db = Database(path)
    gt = synthesize_dataset(SyntheticDatasetOptions(num_rigs=1, num_frames_per_rig=8,
                                                    num_points3D=120, seed=11), database=db)
    db.commit()
    db.close()
    write_model(gt, str(d / "gt"), fmt="bin")
    return path, str(d / "gt")


def _same_model(a, b, tol=1e-9):
    assert sorted(a.reg_image_ids()) == sorted(b.reg_image_ids())
    assert sorted(a.cameras) == sorted(b.cameras) and sorted(a.images) == sorted(b.images)
    for iid in a.reg_image_ids():
        pa, pb = a.cam_from_world(iid), b.cam_from_world(iid)
        assert np.abs(pa.rotmat() - pb.rotmat()).max() <= tol
        assert np.abs(pa.t - pb.t).max() <= tol * max(1.0, np.abs(pb.t).max())
    assert sorted(a.points3D) == sorted(b.points3D)
    for pid, p in a.points3D.items():
        q = b.points3D[pid]
        assert np.abs(p.xyz - q.xyz).max() <= tol * max(1.0, np.abs(q.xyz).max())
        assert np.array_equal(np.asarray(p.color), np.asarray(q.color))
        assert [(e.image_id, e.point2D_idx) for e in p.track] == \
            [(e.image_id, e.point2D_idx) for e in q.track]


def _both(args, tmp_path, name="out", device=True):
    """Run a command in both packages with --output_path tmp/{ref,port}/name."""
    ref_out, port_out = str(tmp_path / "ref" / name), str(tmp_path / "port" / name)
    os.makedirs(os.path.dirname(ref_out), exist_ok=True)
    os.makedirs(os.path.dirname(port_out), exist_ok=True)
    ref_main(args + ["--output_path", ref_out])
    port_main(args + ["--output_path", port_out] + (["--device", "cpu"] if device else []))
    return ref_out, port_out


def _subcommands(parser):
    sub = next(a for a in parser._actions if isinstance(a, argparse._SubParsersAction))
    return {name: {o for act in p._actions for o in act.option_strings} - {"-h", "--help"}
            for name, p in sub.choices.items()}


def _top_level_options(parser):
    return {o for act in parser._actions for o in act.option_strings} - {"-h", "--help"}


def test_the_two_clis_register_the_same_commands_and_arguments():
    ref, port = _subcommands(ref_parser()), _subcommands(port_parser())
    assert set(ref) == set(port) and len(ref) == 52
    for name in ref:
        assert port[name] - {"--device"} == ref[name], name
    assert _top_level_options(port_parser()) == _top_level_options(ref_parser())


def test_top_level_log_level_and_profile_dir(tmp_path):
    """``--log_level`` sets the verbosity and ``--profile_dir`` writes a
    torch.profiler trace of the command (both before the command, as in
    colmap_tpu)."""
    import json

    from colmap_tpu_torch.utils import logging

    port_main(["--log_level", "1", "database_creator", "--database_path",
               str(tmp_path / "a.db")])
    assert os.path.exists(tmp_path / "a.db") and logging.get_verbosity() == 1
    port_main(["--log_level", "0", "--profile_dir", str(tmp_path / "prof"), "database_creator",
               "--database_path", str(tmp_path / "b.db")])
    assert logging.get_verbosity() == 0 and os.path.exists(tmp_path / "b.db")
    (trace,) = os.listdir(tmp_path / "prof")
    assert trace == "database_creator.pt.trace.json"
    assert json.loads((tmp_path / "prof" / trace).read_text())["traceEvents"]


@pytest.mark.parametrize("kind", ["BIN", "TXT", "PLY", "NVM", "Bundler", "VRML", "R3D", "CAM"])
def test_model_converter_matches_colmap_tpu(kind, model_dir, tmp_path):
    name = {"PLY": "m.ply", "NVM": "m.nvm", "Bundler": "m.out", "VRML": "m.wrl"}.get(kind, "m")
    ref, port = _both(["model_converter", "--input_path", model_dir, "--output_type", kind],
                      tmp_path, name, device=False)
    if kind == "PLY":
        from colmap_tpu.utils.ply import read_ply as ref_read_ply

        from colmap_tpu_torch.utils.ply import read_ply

        a, b = read_ply(port), ref_read_ply(ref)
        assert np.array_equal(a["points"], b["points"]) and np.array_equal(a["colors"],
                                                                           b["colors"])
        return
    if kind == "VRML":
        pairs = [(ref[:-4] + s, port[:-4] + s) for s in (".images.wrl", ".points3D.wrl")]
    elif os.path.isdir(ref):
        pairs = [(os.path.join(r, f), os.path.join(r.replace(ref, port), f))
                 for r, _, fs in os.walk(ref) for f in fs]
    else:
        pairs = [(ref, port)]
    assert pairs
    for a, b in pairs:
        assert filecmp.cmp(a, b, shallow=False), (a, b)


def _split(model_dir, tmp_path):
    """Two overlapping parts of the model (images 1-4 and 2-6), the second
    moved by a Sim3, written by colmap_tpu."""
    from colmap_tpu.cli.extra_commands import _submodel_for_images

    recon = ref_read(model_dir)
    ids = sorted(recon.reg_image_ids())
    a, b = _submodel_for_images(recon, ids[:4]), _submodel_for_images(recon, ids[1:])
    b.transform(1.7, np.array([0.9, 0.1, 0.2, 0.1]) / np.linalg.norm([0.9, 0.1, 0.2, 0.1]),
                np.array([3.0, -1.0, 2.0]))
    pa, pb = str(tmp_path / "a"), str(tmp_path / "b")
    ref_write(a, pa, fmt="bin")
    ref_write(b, pb, fmt="bin")
    return pa, pb


@pytest.mark.parametrize("command", ["model_aligner", "model_merger", "model_transformer",
                                     "model_cropper"])
def test_model_tools_match_colmap_tpu(command, model_dir, tmp_path):
    if command == "model_aligner":
        _, moved = _split(model_dir, tmp_path)
        args = ["--input_path", moved, "--ref_model_path", model_dir]
    elif command == "model_merger":
        a, b = _split(model_dir, tmp_path)
        args = ["--input_path1", a, "--input_path2", b]
    elif command == "model_transformer":
        tf = tmp_path / "tf.txt"
        tf.write_text("2.0 0.9 0.1 0.2 0.1 1.0 2.0 3.0")
        args = ["--input_path", model_dir, "--transform_path", str(tf)]
    else:
        args = ["--input_path", model_dir, "--boundary=-1,-1,-1,0,1,1"]
    ref, port = _both([command, *args], tmp_path, device=False)
    _same_model(read_model(port), ref_read(ref))


def test_point_filtering_matches_colmap_tpu(model_dir, tmp_path):
    recon = ref_read(model_dir)
    rng = np.random.default_rng(0)
    for pid in sorted(recon.points3D)[::5]:  # move every fifth point off its rays
        recon.points3D[pid].xyz = recon.points3D[pid].xyz + rng.normal(0, 0.05, 3)
    src = str(tmp_path / "noisy")
    ref_write(recon, src, fmt="bin")
    ref, port = _both(["point_filtering", "--input_path", src, "--max_reproj_error", "2.0",
                       "--min_track_len", "3"], tmp_path)
    a, b = read_model(port), ref_read(ref)
    assert 0 < a.num_points3D() < recon.num_points3D()
    _same_model(a, b)


def test_color_extractor_matches_colmap_tpu(model_dir, tmp_path):
    from colmap_tpu_torch.utils.image_io import write_png

    recon = ref_read(model_dir)
    img_dir = tmp_path / "images"
    img_dir.mkdir()
    rng = np.random.default_rng(1)
    for image in recon.images.values():
        cam = recon.cameras[image.camera_id]
        write_png(str(img_dir / image.name),
                  rng.integers(0, 256, (cam.height, cam.width, 3), dtype=np.uint8))
    ref, port = _both(["color_extractor", "--input_path", model_dir, "--image_path",
                       str(img_dir)], tmp_path, device=False)
    a, b = read_model(port), ref_read(ref)
    assert any(np.asarray(p.color).any() for p in a.points3D.values())
    _same_model(a, b)


def test_project_generator_matches_colmap_tpu(tmp_path):
    ref, port = _both(["project_generator", "--database_path", "/a/db.db", "--image_path",
                       "/a/images"], tmp_path, device=False)
    import configparser

    a, b = configparser.ConfigParser(), configparser.ConfigParser()
    a.read(port)
    b.read(ref)
    assert a.sections() == b.sections()
    assert dict(a["root"]) == dict(b["root"])
    for section in b.sections():
        assert set(a[section]) == set(b[section]), section
    from colmap_tpu_torch.controllers.option_manager import OptionManager

    om = OptionManager.read(port)
    om.apply_flags({"Mapper.min_num_matches": "20", "SiftExtraction.max_num_features": "100"})
    assert om.mapper.min_num_matches == 20 and om.sift.max_num_features == 100
    assert om.database_path == "/a/db.db"


def _tables(path):
    conn = sqlite3.connect(path)
    out = {}
    for (t,) in conn.execute("SELECT name FROM sqlite_master WHERE type='table'"):
        out[t] = sorted(conn.execute(f"SELECT * FROM {t}").fetchall(), key=repr)
    conn.close()
    return out


def _two_databases(tmp_path):
    paths = []
    for seed in (1, 2):
        path = str(tmp_path / f"s{seed}.db")
        db = Database(path)
        synthesize_dataset(SyntheticDatasetOptions(num_rigs=1, num_frames_per_rig=3,
                                                   num_points3D=20, seed=seed), database=db)
        db.conn.execute("UPDATE images SET name = ? || name", (f"s{seed}_",))
        db.commit()
        db.close()
        paths.append(path)
    return paths


def test_database_merger_matches_colmap_tpu(tmp_path):
    p1, p2 = _two_databases(tmp_path)
    args = ["database_merger", "--database_path1", p1, "--database_path2", p2]
    ref_main(args + ["--merged_database_path", str(tmp_path / "ref.db")])
    port_main(args + ["--merged_database_path", str(tmp_path / "port.db")])
    a, b = _tables(str(tmp_path / "port.db")), _tables(str(tmp_path / "ref.db"))
    assert a == b and len(a["images"]) == 6 and len(a["matches"]) == 6


@pytest.mark.parametrize("kind", ["matches", "features", "images", "all"])
def test_database_cleaner_matches_colmap_tpu(kind, db_and_gt, tmp_path):
    import shutil

    ref, port = str(tmp_path / "ref.db"), str(tmp_path / "port.db")
    shutil.copy(db_and_gt[0], ref)
    shutil.copy(db_and_gt[0], port)
    ref_main(["database_cleaner", "--database_path", ref, "--type", kind])
    port_main(["database_cleaner", "--database_path", port, "--type", kind])
    a, b = _tables(port), _tables(ref)
    assert a == b and not a["matches"]


def test_model_comparer_matches_colmap_tpu(model_dir, tmp_path, capsys):
    _, moved = _split(model_dir, tmp_path)
    ref_main(["model_comparer", "--input_path1", moved, "--input_path2", model_dir])
    ref = capsys.readouterr().out
    stats = port_main(["model_comparer", "--input_path1", moved, "--input_path2", model_dir])
    assert capsys.readouterr().out == ref
    assert stats["num_common_images"] == 5


@pytest.mark.parametrize("command", ["model_splitter", "model_clusterer", "image_deleter",
                                     "image_filterer"])
def test_model_part_tools_match_colmap_tpu(command, model_dir, tmp_path):
    recon = ref_read(model_dir)
    if command == "model_splitter":
        args = ["--num_parts", "2"]
    elif command == "model_clusterer":
        args = ["--leaf_max_num_images", "4"]
    elif command == "image_deleter":
        names = tmp_path / "names.txt"
        names.write_text("\n".join(recon.images[i].name for i in sorted(recon.reg_image_ids())[:2]))
        ids = tmp_path / "ids.txt"
        ids.write_text(f"{sorted(recon.reg_image_ids())[-1]}\n")
        args = ["--image_names_path", str(names), "--image_ids_path", str(ids)]
    else:  # a longer focal length: each image sees part of the points
        recon = ref_synthesize(RSynOpts(num_rigs=1, num_frames_per_rig=6, num_points3D=200,
                                        seed=5, camera_params=(2500.0, 512.0, 384.0, 0.05)))
        model_dir = str(tmp_path / "partial")
        ref_write(recon, model_dir, fmt="bin")
        counts = sorted(int((np.asarray(recon.images[i].points2D_p3d) >= 0).sum())
                        for i in recon.reg_image_ids())
        args = ["--min_num_observations", str(counts[len(counts) // 2])]
    ref, port = _both([command, "--input_path", model_dir, *args], tmp_path, device=False)
    if command in ("model_splitter", "model_clusterer"):
        parts = sorted(os.listdir(ref))
        assert parts == sorted(os.listdir(port)) and len(parts) >= 2
        for p in parts:
            _same_model(read_model(os.path.join(port, p)), ref_read(os.path.join(ref, p)))
    else:
        a = read_model(port)
        assert 0 < a.num_reg_frames() < recon.num_reg_frames()
        _same_model(a, ref_read(ref))


def test_feature_importer_matches_colmap_tpu(tmp_path):
    from colmap_tpu_torch.utils.image_io import write_png

    img_dir, feat_dir = tmp_path / "images", tmp_path / "feats"
    img_dir.mkdir()
    feat_dir.mkdir()
    rng = np.random.default_rng(0)
    for name, (h, w) in (("a.png", (60, 80)), ("b.png", (50, 90))):
        write_png(str(img_dir / name), rng.integers(0, 255, size=(h, w), dtype=np.uint8))
        kp = rng.uniform(0, 50, size=(5, 4))
        desc = rng.integers(0, 256, size=(5, 128))
        with open(feat_dir / (name + ".txt"), "w") as f:
            f.write("5 128\n")
            for i in range(5):
                f.write(" ".join(f"{v:.3f}" for v in kp[i]) + " "
                        + " ".join(str(int(v)) for v in desc[i]) + "\n")
    for extra in ([], ["--per_image_camera"]):
        tag = "per_image" if extra else "single"
        args = ["feature_importer", "--image_path", str(img_dir), "--import_path",
                str(feat_dir), *extra]
        ref_main(args + ["--database_path", str(tmp_path / f"ref_{tag}.db")])
        port_main(args + ["--database_path", str(tmp_path / f"port_{tag}.db")])
        a, b = _tables(str(tmp_path / f"port_{tag}.db")), _tables(str(tmp_path / f"ref_{tag}.db"))
        assert a == b and len(a["images"]) == 2 and len(a["keypoints"]) == 2


def test_gui_exits_as_colmap_tpu(capsys):
    with pytest.raises(SystemExit) as ref:
        ref_main(["gui"])
    with pytest.raises(SystemExit) as port:
        port_main(["gui"])
    assert ref.value.code == port.value.code == 1
    assert "headless" in capsys.readouterr().out


def _without_points(gt_dir, tmp_path):
    from colmap_tpu_torch.scene.types import INVALID_POINT3D

    recon = read_model(gt_dir)
    for pid in list(recon.points3D):
        recon.delete_point3D(pid)
    for image in recon.images.values():
        image.points2D_p3d[:] = INVALID_POINT3D
    out = str(tmp_path / "poses")
    write_model(recon, out, fmt="bin")
    return out


def test_point_triangulator_matches_colmap_tpu(db_and_gt, tmp_path):
    src = _without_points(db_and_gt[1], tmp_path)
    ref, port = _both(["point_triangulator", "--database_path", db_and_gt[0], "--input_path",
                       src], tmp_path)
    a, b = read_model(port), ref_read(ref)
    gt = read_model(db_and_gt[1])
    assert a.num_points3D() == b.num_points3D() >= 0.9 * gt.num_points3D()
    tracks = lambda r: sorted(sorted((e.image_id, e.point2D_idx) for e in p.track)  # noqa: E731
                              for p in r.points3D.values())
    assert tracks(a) == tracks(b)
    pa = np.stack([p.xyz for _, p in sorted(a.points3D.items(), key=lambda kv: kv[1].track[0].image_id * 10**6 + kv[1].track[0].point2D_idx)])  # noqa: E501
    pb = np.stack([p.xyz for _, p in sorted(b.points3D.items(), key=lambda kv: kv[1].track[0].image_id * 10**6 + kv[1].track[0].point2D_idx)])  # noqa: E501
    assert np.abs(pa - pb).max() < 1e-6


def test_image_registrator_on_the_cpu_path(db_and_gt, tmp_path):
    from colmap_tpu_torch.estimators.alignment import compare_reconstructions

    gt = read_model(db_and_gt[1])
    partial = copy.deepcopy(gt)
    for iid in sorted(gt.reg_image_ids())[-2:]:
        partial.deregister_frame(partial.images[iid].frame_id)
    src = str(tmp_path / "partial")
    write_model(partial, src, fmt="bin")
    n = port_main(["image_registrator", "--database_path", db_and_gt[0], "--input_path", src,
                   "--output_path", str(tmp_path / "out"), "--device", "cpu"])
    recon = read_model(str(tmp_path / "out"))
    stats = compare_reconstructions(recon, gt)
    assert n == 2 and stats["num_common_images"] == gt.num_reg_frames()
    assert np.max(stats["rotation_errors_deg"]) < 0.1


def test_pose_prior_mapper_on_the_cpu_path(tmp_path):
    db_path = str(tmp_path / "db.db")
    db = Database(db_path)
    gt = synthesize_dataset(SyntheticDatasetOptions(
        num_rigs=1, num_frames_per_rig=6, num_points3D=80, seed=9,
        camera_has_prior_focal_length=True, prior_position=True), database=db)
    db.close()
    models = port_main(["pose_prior_mapper", "--database_path", db_path, "--output_path",
                        str(tmp_path / "sparse"), "--device", "cpu"])
    recon = read_model(str(tmp_path / "sparse" / "0"))
    assert len(models) == 1 and recon.num_reg_frames() == 6
    errs = [np.linalg.norm(recon.cam_from_world(i).projection_center()
                           - gt.cam_from_world(i).projection_center())
            for i in recon.reg_image_ids()]
    assert max(errs) < 1e-3  # in the priors' (the truth's) frame, no further alignment


def test_hierarchical_mapper_on_the_cpu_path(db_and_gt, tmp_path):
    from colmap_tpu_torch.estimators.alignment import compare_reconstructions

    models = port_main(["hierarchical_mapper", "--database_path", db_and_gt[0],
                        "--output_path", str(tmp_path / "hier"), "--leaf_max_num_images", "5",
                        "--image_overlap", "2", "--quiet", "--device", "cpu"])
    recon = read_model(str(tmp_path / "hier" / "0"))
    assert models[0].num_reg_frames() == recon.num_reg_frames() == 8
    stats = compare_reconstructions(recon, read_model(db_and_gt[1]))
    assert stats["max_rotation_error_deg"] < 1e-2 and stats["max_center_error"] < 1e-3


def test_guided_geometric_verifier_on_the_cpu_path(tmp_path):
    db_path = str(tmp_path / "db.db")
    db = Database(db_path)
    synthesize_dataset(SyntheticDatasetOptions(num_rigs=1, num_frames_per_rig=5,
                                               num_points3D=80, seed=7), database=db)
    db.conn.execute("DELETE FROM two_view_geometries")
    db.commit()
    db.close()
    n = port_main(["guided_geometric_verifier", "--database_path", db_path, "--device", "cpu"])
    db = Database(db_path, must_exist=True)
    assert n == 10 and db.num_verified_pairs() == 10
    db.close()


def test_automatic_reconstructor_on_the_cpu_path(tmp_path):
    from colmap_tpu_torch.estimators.alignment import compare_reconstructions
    from colmap_tpu_torch.kernels.sift_cases import render_scene

    # The focal length is the extractor's guess, 1.2 x the larger side.
    gt, names, params = render_scene(str(tmp_path / "images"), 4, 300, 640, 480, 768.0)
    models = port_main(["automatic_reconstructor", "--workspace_path", str(tmp_path / "ws"),
                        "--image_path", str(tmp_path / "images"), "--quality", "low",
                        "--camera_model", "PINHOLE", "--device", "cpu"])
    assert models and os.path.exists(str(tmp_path / "ws" / "sparse" / "0" / "cameras.bin"))
    stats = compare_reconstructions(models[0], gt)
    assert stats["num_common_images"] >= len(names) - 1
    assert stats["max_rotation_error_deg"] < 5.0  # colmap_tpu's test gate


def test_clustering_merge_manager_and_pruning_match_colmap_tpu(tmp_path):
    from colmap_tpu.estimators.alignment import align_reconstruction_to_pose_priors as ref_align
    from colmap_tpu.scene.clustering import SceneClusteringOptions as RClusterOpts
    from colmap_tpu.scene.clustering import cluster_scene as ref_cluster
    from colmap_tpu.scene.reconstruction_pruning import find_redundant_points3D as ref_prune
    from colmap_tpu.sfm.hierarchical_pipeline import merge_reconstructions as ref_merge

    from colmap_tpu_torch.estimators.alignment import align_reconstruction_to_pose_priors
    from colmap_tpu_torch.estimators.solvers.similarity import umeyama
    from colmap_tpu_torch.scene.clustering import SceneClusteringOptions, cluster_scene
    from colmap_tpu_torch.scene.reconstruction_manager import ReconstructionManager
    from colmap_tpu_torch.scene.reconstruction_pruning import find_redundant_points3D
    from colmap_tpu_torch.sfm.hierarchical_pipeline import merge_reconstructions

    rng = np.random.default_rng(0)
    ids = list(range(1, 21))
    weights = {(a, b): float(rng.integers(1, 100)) for a in ids for b in ids
               if a < b and (b - a < 4 or rng.random() < 0.1)}
    assert cluster_scene(ids, weights, SceneClusteringOptions(leaf_max_num_images=6,
                                                              image_overlap=3)) == \
        ref_cluster(ids, weights, RClusterOpts(leaf_max_num_images=6, image_overlap=3))
    full = ref_synthesize(RSynOpts(num_rigs=1, num_frames_per_rig=8, num_points3D=60, seed=21))
    a, b = copy.deepcopy(full), copy.deepcopy(full)
    for fid in (7, 8):
        a.deregister_frame(fid)
    for fid in (1, 2):
        b.deregister_frame(fid)
    b.transform(1.7, np.array([0.9, 0.1, 0.2, 0.1]) / np.linalg.norm([0.9, 0.1, 0.2, 0.1]),
                np.array([3.0, -1.0, 2.0]))
    pa, pb = convert_reconstruction(a), convert_reconstruction(b)
    assert ref_merge(a, b) and merge_reconstructions(pa, pb)
    _same_model(pa, a)
    assert sorted(find_redundant_points3D(0.05, pa)) == sorted(ref_prune(0.05, a))
    mgr = ReconstructionManager()
    mgr.append(pa)
    mgr.add()
    mgr.write(str(tmp_path / "models"))
    back = ReconstructionManager()
    assert back.read_all(str(tmp_path / "models")) == 2 and len(back) == 2
    _same_model(back.get(0), ref_read(str(tmp_path / "models" / "0")))
    # Umeyama with weights, and the robust pose-prior alignment (same triplets).
    src, dst = rng.normal(size=(10, 3)), rng.normal(size=(10, 3))
    w = rng.uniform(0.5, 2.0, 10)
    from colmap_tpu.estimators.solvers.similarity import umeyama as ref_umeyama

    for got, ref in zip(umeyama(src, dst, w), ref_umeyama(src, dst, w)):
        np.testing.assert_allclose(got, np.asarray(ref), atol=1e-12)
    priors = {iid: full.cam_from_world(iid).projection_center() * 2.0 + 1.0
              for iid in full.reg_image_ids()}
    priors[1] = priors[1] + 50.0  # one bad prior
    ra, pa2 = copy.deepcopy(full), convert_reconstruction(full)
    ref_sim = ref_align(ra, priors, robust_max_error=1.0)
    sim = align_reconstruction_to_pose_priors(pa2, priors, robust_max_error=1.0)
    assert abs(sim[0] - ref_sim[0]) < 1e-9 and abs(sim[0] - 2.0) < 1e-9
    np.testing.assert_allclose(sim[1], np.asarray(ref_sim[1]), atol=1e-9)
    _same_model(pa2, ra)
