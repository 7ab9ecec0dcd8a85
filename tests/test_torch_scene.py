"""colmap_tpu_torch scene modules against colmap_tpu's, on the CPU.

Model files written by one package and read by the other must come back
byte-identical; the synthetic BA generator and the point-major packing must
give the same arrays from the same seed; per-point reprojection errors must
agree.
"""

import filecmp
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from colmap_tpu.estimators import bundle_adjustment as jba
from colmap_tpu.scene import reconstruction_io as jio
from colmap_tpu.scene.synthetic import SyntheticDatasetOptions, synthesize_dataset
from colmap_tpu.scene.synthetic_ba import synthetic_ba_problem as j_synthetic
from colmap_tpu_torch.estimators import bundle_adjustment as tba
from colmap_tpu_torch.scene import reconstruction_io as tio
from colmap_tpu_torch.scene.synthetic_ba import synthetic_ba_problem as t_synthetic

FILES = {
    "bin": ["rigs.bin", "cameras.bin", "frames.bin", "images.bin", "points3D.bin"],
    "txt": ["cameras.txt", "images.txt", "points3D.txt"],
}


@pytest.fixture(scope="module")
def jax_recon():
    opt = SyntheticDatasetOptions(num_rigs=2, num_frames_per_rig=4, num_points3D=60, seed=7)
    recon = synthesize_dataset(opt)
    recon.update_point3D_errors()
    return recon


def _same_files(a, b, names):
    for name in names:
        assert filecmp.cmp(os.path.join(a, name), os.path.join(b, name), shallow=False), name


@pytest.mark.parametrize("fmt", ["bin", "txt"])
def test_io_jax_to_port_byte_identical(jax_recon, tmp_path, fmt):
    """Written by colmap_tpu, read and written again by the port: same bytes."""
    a, b = str(tmp_path / "jax"), str(tmp_path / "port")
    jio.write_model(jax_recon, a, fmt=fmt)
    tio.write_model(tio.read_model(a), b, fmt=fmt)
    _same_files(a, b, FILES[fmt])


@pytest.mark.parametrize("fmt", ["bin", "txt"])
def test_io_port_to_jax_byte_identical(jax_recon, tmp_path, fmt):
    """Written by the port, read and written again by colmap_tpu: same bytes."""
    a, b, c = (str(tmp_path / d) for d in ("jax", "port", "back"))
    jio.write_model(jax_recon, a, fmt="bin")
    tio.write_model(tio.read_model(a), b, fmt=fmt)
    jio.write_model(jio.read_model(b), c, fmt=fmt)
    _same_files(b, c, FILES[fmt])


def test_update_point3D_errors_matches_jax(jax_recon, tmp_path):
    """Per-point mean reprojection errors agree to 1e-9 px."""
    path = str(tmp_path / "m")
    jio.write_model(jax_recon, path)
    recon_j, recon_t = jio.read_model(path), tio.read_model(path)
    rng = np.random.default_rng(0)
    for pid in sorted(recon_j.points3D):
        delta = rng.normal(0, 0.01, 3)
        recon_j.points3D[pid].xyz = recon_j.points3D[pid].xyz + delta
        recon_t.points3D[pid].xyz = recon_t.points3D[pid].xyz + delta
    recon_j.update_point3D_errors()
    recon_t.update_point3D_errors()
    for pid in recon_j.points3D:
        assert abs(recon_t.points3D[pid].error - recon_j.points3D[pid].error) <= 1e-9


def test_synthetic_and_pack_match_jax():
    """synthetic_ba_problem and pack_problem give colmap_tpu's arrays for
    seed 0 (atol 1e-12)."""
    jp, jgt, jmid = j_synthetic(12, 300, 5, seed=0, dtype=jnp.float64)
    tp, tgt, tmid = t_synthetic(12, 300, 5, seed=0, dtype=torch.float64, device="cpu")
    assert jmid == tmid
    for jprob, tprob in ((jp, tp), (jgt, tgt)):
        for name in jba.BAProblem._fields:
            np.testing.assert_allclose(getattr(tprob, name).numpy(),
                                       np.asarray(getattr(jprob, name)), rtol=0, atol=1e-12,
                                       err_msg=name)
    # Drop observations so points get ragged tracks and the packing pads.
    keep = np.random.default_rng(1).random(jp.obs_xy.shape[0]) < 0.7
    jr = jp._replace(**{n: getattr(jp, n)[keep] for n in jba.BAProblem._fields[4:]})
    tr = tp._replace(**{n: getattr(tp, n)[torch.from_numpy(keep)]
                        for n in tba.BAProblem._fields[4:]})
    jpk, jmaps, jcaps = jba.pack_problem(jr)
    tpk, tmaps, tcaps = tba.pack_problem(tr)
    assert jcaps == tcaps
    for name in jba.BAProblem._fields:
        np.testing.assert_allclose(getattr(tpk, name).numpy(), np.asarray(getattr(jpk, name)),
                                   rtol=0, atol=1e-12, err_msg=name)
    for name in jba.PackedMaps._fields:
        np.testing.assert_array_equal(getattr(tmaps, name).numpy(),
                                      np.asarray(getattr(jmaps, name)))
