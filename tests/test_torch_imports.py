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
absolute pose's RANSAC on small cases.
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
""")


def test_port_runs_without_jax_colmap_tpu_and_pil(tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", CHILD, str(tmp_path)], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    assert "KEYPOINTS" in out.stdout and "DENSE" in out.stdout and "GLOBAL" in out.stdout
    assert "RIG" in out.stdout
