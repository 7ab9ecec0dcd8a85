"""colmap_tpu_torch stands alone: it runs with jax, colmap_tpu and PIL absent.

The machine the port runs on has PyTorch, numpy and scipy, and neither JAX
nor PIL. A child process blocks those three packages with a sys.meta_path
finder, imports every module of colmap_tpu_torch, renders two small views
with the port's renderer and extracts their features with
``feature_extractor --device cpu``, then runs the dense modules on a small
plane case: PatchMatch with the consistency filter, the map, graph, PLY and
.vis files, the workspace's PNG bitmaps and fusion; then ``global_mapper``
on a four-frame scene and ``view_graph_calibrator``, both with
``--device cpu``; then the rig BA solve and a batch of the generalized
absolute pose's RANSAC on small cases; then ``vocab_tree_builder`` and
``vocab_tree_matcher`` with ``--device cpu`` on the extracted database; then
a batch of the spherical homography RANSAC (K33's plain version) on rays of
a 360-degree pair and the packing of a problem that mixes camera models;
then rig registration's refinement and refit (K40's plain versions); then
the options' modules: the combination sampler, the SPRT (K47's plain
version), DEGENSAC's hypotheses (K46's) and affine-covariant SIFT (K45's);
then the meshing slice on small cases: poisson_mesh (K41-K44's plain versions),
Delaunay meshing and the advancing front, the quadric simplifier (built
with g++ from native/mesh_ops.cpp), texturing, rectification and a CMP-MVS
export; then the sparse-model tools: the line detector (K49's plain
version), the generalized relative pose (K48's), and model_converter,
model_orientation_aligner, project_generator and hierarchical_mapper with
``--device cpu``. An audit hook records every file the child opens, every library it
loads and every process it starts: none lies under colmap_tpu/. A second
test reads every line of the port and of chip_smoke.py for an import of
jax or colmap_tpu.
"""

import os
import subprocess
import sys
import textwrap

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CHILD = textwrap.dedent("""
    import importlib, importlib.abc, os, pkgutil, sys

    BLOCKED = ("jax", "jaxlib", "colmap_tpu", "PIL")

    class Block(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in BLOCKED:
                raise ImportError(f"{name} is blocked")
            return None

    sys.meta_path.insert(0, Block())
    REFERENCE = os.path.join(os.getcwd(), "colmap_tpu") + os.sep
    TOUCHED = []

    def audit(event, args):
        if event in ("open", "ctypes.dlopen", "subprocess.Popen", "os.listdir"):
            for a in (args[:2] if event == "subprocess.Popen" else args[:1]):
                for x in (a if isinstance(a, (list, tuple)) else [a]):
                    if isinstance(x, (str, bytes, os.PathLike)):
                        x = os.path.abspath(os.fsdecode(x))
                        if x.startswith(REFERENCE):
                            TOUCHED.append((event, x))

    sys.addaudithook(audit)
    import colmap_tpu_torch

    names = [m.name for m in pkgutil.walk_packages(colmap_tpu_torch.__path__,
                                                   "colmap_tpu_torch.")]
    for name in names:
        importlib.import_module(name)
    leaked = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
    assert not leaked, leaked

    import numpy as np
    import torch
    from colmap_tpu_torch.cli import main as cli
    from colmap_tpu_torch.scene.database import Database
    from colmap_tpu_torch.scene.synthetic import SyntheticDatasetOptions, synthesize_dataset
    from colmap_tpu_torch.scene.synthetic_images import render_images

    root = sys.argv[1]
    gt = synthesize_dataset(SyntheticDatasetOptions(
        num_rigs=1, num_frames_per_rig=2, num_points3D=120, camera_model_id=1,
        camera_params=(200.0, 200.0, 80.0, 60.0), camera_width=160, camera_height=120),
        None, rng=np.random.default_rng(3))
    views = render_images(gt, os.path.join(root, "images"), patch_world=0.08)
    db_path = os.path.join(root, "db.db")
    ids = cli.main(["feature_extractor", "--database_path", db_path, "--image_path",
                    os.path.join(root, "images"), "--device", "cpu"])
    db = Database(db_path, must_exist=True)
    counts = [len(db.read_keypoints(i)) for i in ids]
    db.close()
    assert len(views) == 2 and len(ids) == 2 and min(counts) > 10, counts
    print("MODULES", len(names), "KEYPOINTS", counts)

    from colmap_tpu_torch.kernels import mvs_cases
    from colmap_tpu_torch.mvs import patch_match, fusion, workspace
    from colmap_tpu_torch.mvs.consistency_graph import ConsistencyGraph
    from colmap_tpu_torch.mvs.depth_map import read_map, write_map
    from colmap_tpu_torch.utils.image_io import write_png
    from colmap_tpu_torch.utils.ply import read_ply, write_ply

    case = mvs_cases.plane_case(20, 24, 2, seed=1)
    problem = mvs_cases.tensors(case, "cpu", torch.float32, geometric=True)[0]
    opts = patch_match.PatchMatchOptions(depth_min=2.0, depth_max=10.0, num_iterations=1)
    depth, normal, _, mask = patch_match.patch_match(problem, opts, return_consistency=True)
    write_map(os.path.join(root, "d.bin"), depth.numpy())
    assert (read_map(os.path.join(root, "d.bin")) == depth.numpy()).all()
    ConsistencyGraph.from_mask(mask.numpy(), [0, 1]).write(os.path.join(root, "g.bin"))
    os.makedirs(os.path.join(root, "ws", "images"))
    write_png(os.path.join(root, "ws", "images", "a.png"), np.zeros((4, 5, 3), np.uint8))
    assert workspace.CachedWorkspace(os.path.join(root, "ws")).get_bitmap("a.png").shape == (4, 5)
    K = case.problem["K_ref"]
    imgs = [fusion.FusionImage(i, K, np.eye(3), np.array([0.1 * i, 0, 0]), case.gt_depth,
                               np.tile([0.0, 0.0, -1.0], case.gt_depth.shape + (1,)))
            for i in (1, 2)]
    pts, nrm, vis = fusion.fuse_depth_maps(imgs, device="cpu")
    write_ply(os.path.join(root, "f.ply"), pts, nrm)
    fusion.write_fused_vis(os.path.join(root, "f.ply.vis"), vis)
    assert len(read_ply(os.path.join(root, "f.ply"))["points"]) == len(pts) > 0
    print("DENSE", int((depth > 0).sum()), len(pts))

    gdb = os.path.join(root, "global.db")
    synthesize_dataset(SyntheticDatasetOptions(
        num_rigs=1, num_frames_per_rig=4, num_points3D=60, camera_has_prior_focal_length=True,
        two_view_geometry_has_relative_pose=False), Database(gdb), rng=np.random.default_rng(3))
    pipe = cli.main(["global_mapper", "--database_path", gdb, "--output_path",
                     os.path.join(root, "global"), "--device", "cpu", "--quiet"])
    from colmap_tpu_torch.kernels import global_cases
    global_cases.write_calibrator_database(os.path.join(root, "vgc.db"))
    focals = cli.main(["view_graph_calibrator", "--database_path", os.path.join(root, "vgc.db"),
                       "--device", "cpu"])
    print("GLOBAL", sum(pipe.timer.calls.values()), len(focals))

    from colmap_tpu_torch.estimators import bundle_adjustment as ba
    from colmap_tpu_torch.estimators import bundle_adjustment_rig as rba
    from colmap_tpu_torch.geometry.rigid3 import Rigid3
    from colmap_tpu_torch.kernels import rig, rig_cases

    p, gt, mid = rig_cases.rig_ba_problem(4, 2, 80, 4, seed=1, dtype=torch.float64)
    opts = ba.BAOptions(max_iterations=3, pcg_iterations=10, loss="cauchy")
    solved, summary = rba.solve(p, mid, opts, rba.fix_gauge_two_frames(
        rba.default_masks(p, mid, opts), 0, 1))
    assert summary["final_cost"] < summary["initial_cost"]
    data, Rt, inl = rig_cases.gen_abs_case(60, seed=2)
    samples = rig_cases.injected_samples(60, 8, 3, inl)
    models, counts, best = rig.gen_abs_propose_score(data, samples, 144.0, True)
    assert int(counts.max()) == int(inl.sum())
    assert Rigid3(p.quat, p.t).inverse().compose(Rigid3(p.quat, p.t)).t.abs().max() < 1e-12
    print("RIG", summary["num_iterations"], int(counts.max()))

    rows, q0, t0, _ = rig_cases.refine_case(100, 3)
    q, t = rig.gen_abs_refine(*rows, q0, t0)
    model, ok = rig.gen_abs_refit(data.X, data.centers, data.dirs,
                                  torch.as_tensor(inl, dtype=torch.float64), True)
    assert bool(ok[0]) and abs(float(q.norm()) - 1.0) < 1e-9
    print("SOLVERS", float(model[0, 4]))

    tree = os.path.join(root, "tree.npz")
    cli.main(["vocab_tree_builder", "--database_path", db_path, "--vocab_tree_path", tree,
              "--depth", "2", "--branching", "4", "--device", "cpu"])
    n = cli.main(["vocab_tree_matcher", "--database_path", db_path, "--vocab_tree_path", tree,
                  "--device", "cpu"])
    db = Database(db_path, must_exist=True)
    assert len(db.read_all_matches()) == 1 and n in (0, 1)
    db.close()
    print("RETRIEVAL", np.load(tree)["level_1"].shape, n)

    from colmap_tpu_torch.kernels import spherical as KQ
    from colmap_tpu_torch.kernels import spherical_cases as QC
    from colmap_tpu_torch.sensor import models as M

    c = QC.ray_case("H", 64, 16, 0, "cpu")
    _, counts, _ = KQ.spherical_h_propose_score(c["x1"].double(), c["x2"].double(), c["mask"],
                                                c["samples"], c["max_sq"])
    mid, rows = M.pack_mixed_params([[900.0, 32, 24, 0.1], [900.0, 900, 32, 24, 0, 0, 0, 0]],
                                    [2, 5])
    assert mid == (2, 5) and rows.shape == (2, 9) and int(counts.max()) > 30
    print("CAMERAS", int(counts.max()))

    from colmap_tpu_torch.estimators import degensac
    from colmap_tpu_torch.feature.sift import SiftOptions, extract_sift
    from colmap_tpu_torch.kernels import matching_cases as MTC
    from colmap_tpu_torch.optim import samplers, sprt

    combos = samplers.all_combinations(6, 3)
    acc, num = sprt.sprt_evaluate(torch.tensor([[0.0] * 50, [9.0] * 50]),
                                  torch.ones(50, dtype=torch.bool), 1.0)
    c = MTC.two_view_case("H", 120, 2, 1, "cpu", outliers=0.0, valid=120)
    x1, x2 = c["x1"].double(), c["x2"].double()
    Fs, sup, _ = degensac.KM.degensac_propose_score(
        x1, x2, c["mask"], torch.eye(3, dtype=torch.float64), torch.tensor([0, 1]),
        torch.tensor([2, 2]), 16.0)
    noise = (np.random.default_rng(0).random((64, 80)) * 255).astype(np.uint8)
    kp, _ = extract_sift(noise, SiftOptions(estimate_affine_shape=True), device="cpu")
    assert combos.shape == (20, 3) and bool(acc[0]) and not bool(acc[1]) and kp.shape[1] == 6
    print("OPTIONS", len(combos), int(num[1]), int(sup.max()), len(kp))

    from colmap_tpu_torch.cli.export import export_cmp_mvs
    from colmap_tpu_torch.image.rectification import rectify_stereo_cameras
    from colmap_tpu_torch.kernels import meshing_cases as MC
    from colmap_tpu_torch.mvs import meshing, simplification, texturing
    from colmap_tpu_torch.scene.reconstruction_io import read_model

    pts, nrm = MC.sphere(1500, seed=1)
    v, f, _ = meshing.poisson_mesh(pts, nrm, options=meshing.PoissonMeshingOptions(depth=4),
                                   device="cpu")
    sv, sf = simplification.simplify_mesh(v, f, 0.3)
    cams = {1: np.array([3.0, 0, 0]), 2: np.array([-3.0, 0, 0])}
    _, df = meshing.delaunay_meshing(pts[:200], MC.visibility(pts[:200], cams), cams)
    _, af = meshing.advancing_front_mesh(pts[:200])
    view = {"K": np.array([[50.0, 0, 32], [0, 50, 24], [0, 0, 1]]), "R": np.eye(3),
            "t": np.array([0.0, 0, 3]), "width": 64, "height": 48, "image_key": 1}
    atlas, uvs, lab = texturing.texture_mesh(sv, sf, [view],
                                             {1: np.zeros((48, 64, 3), np.uint8)},
                                             device="cpu")
    gmodel = read_model(os.path.join(root, "global", "0"))
    from colmap_tpu_torch.scene.types import Camera, Pose
    pin = Camera(1, 1, 64, 48, np.array([50.0, 50.0, 32.0, 24.0]))
    H1, H2, Q = rectify_stereo_cameras(pin, pin, Pose(np.array([1.0, 0, 0, 0]),
                                                      np.array([-0.5, 0.0, 0.0])))
    assert abs(Q[2, 3] - 2.0) < 1e-12
    export_cmp_mvs(gmodel, os.path.join(root, "no_images"), os.path.join(root, "cmp"),
                   device="cpu")
    assert len(df) > 0 and len(af) > 0 and len(sf) < len(f) and (lab >= 0).any()
    assert sorted(os.listdir(os.path.join(root, "cmp")))[0] == "00001_P.txt"
    print("MESH", len(f), len(sf), len(df), len(af))

    from colmap_tpu_torch import pycolmap_compat as pc
    from colmap_tpu_torch.estimators import generalized_pose
    from colmap_tpu_torch.image.lines import detect_line_segments

    img = np.zeros((80, 100), np.float32)
    img[20:22, 10:90] = 255.0
    img[10:70, 50:52] = 255.0
    segs = detect_line_segments(img, 20.0, device="cpu")
    case = rig_cases.gen_rel_case(120, seed=1)
    pose, inl = generalized_pose.estimate_generalized_relative_pose(
        case["points2D1"], case["points2D2"], case["camera_idxs1"], case["camera_idxs2"],
        case["cams_from_rig"], case["cameras"], device="cpu")
    gdir = os.path.join(root, "global", "0")
    cli.main(["model_converter", "--input_path", gdir, "--output_path",
              os.path.join(root, "m.nvm"), "--output_type", "NVM"])
    cli.main(["model_orientation_aligner", "--input_path", gdir, "--output_path",
              os.path.join(root, "aligned"), "--method", "PRINCIPAL-PLANE", "--device", "cpu"])
    cli.main(["project_generator", "--output_path", os.path.join(root, "project.ini")])
    cli.main(["hierarchical_mapper", "--database_path", gdb, "--output_path",
              os.path.join(root, "hier"), "--device", "cpu", "--quiet"])
    assert pose is not None and len(segs) >= 2 and hasattr(pc, "estimate_generalized_relative_pose")
    assert not TOUCHED, TOUCHED
    print("TOOLS", len(segs), int(inl.sum()))
""")


def test_port_runs_without_jax_colmap_tpu_and_pil(tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", CHILD, str(tmp_path)], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    assert "KEYPOINTS" in out.stdout and "DENSE" in out.stdout and "GLOBAL" in out.stdout
    assert "RIG" in out.stdout and "RETRIEVAL" in out.stdout and "CAMERAS" in out.stdout
    assert "SOLVERS" in out.stdout and "MESH" in out.stdout and "OPTIONS" in out.stdout
    assert "TOOLS" in out.stdout


def test_no_module_of_the_port_imports_jax_or_colmap_tpu():
    """No line of colmap_tpu_torch (its solver loops and kernels included)
    or of chip_smoke.py imports jax or colmap_tpu, even lazily inside a
    function."""
    import re

    pattern = re.compile(r"^\s*(import|from) (jax|jaxlib|colmap_tpu)(\.|\s|$)")
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "colmap_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    assert len(files) > 100
    hits = [f"{f}:{i + 1}" for f in files for i, line in enumerate(open(f, encoding="utf-8"))
            if pattern.match(line)]
    assert not hits, hits
