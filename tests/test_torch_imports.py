"""colmap_tpu_torch stands alone: it runs with jax, colmap_tpu and PIL absent.

The machine the port runs on has PyTorch, numpy and scipy, and neither JAX
nor PIL. A child process blocks those three packages with a sys.meta_path
finder, imports every module of colmap_tpu_torch, renders two small views
with the port's renderer and extracts their features with
``feature_extractor --device cpu``.
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
""")


def test_port_runs_without_jax_colmap_tpu_and_pil(tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", CHILD, str(tmp_path)], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    assert "KEYPOINTS" in out.stdout
