"""colmap_tpu_torch's generalized relative pose and pycolmap_compat against
colmap_tpu on the CPU.

The 17-point solve (K48's plain version, ``g17_relative_pose``) against
colmap_tpu's on injected samples of a 4-camera rig pair, float64: within
1e-9 wherever colmap_tpu's eigh returns the nullspace vector with the sign
for which its rotation block projects onto the rotation (the port fixes that
sign, ROADMAP §3; where eigh returns the other sign colmap_tpu's model is
not a rotation near the truth and the port's is). ``_weighted_g17`` (K48
(c)'s plain version) within 1e-9 where colmap_tpu's sign is that one. ``estimate_generalized_relative_pose`` on
tests/test_generalized_pose.py's scene (2 cameras, noise-free) and on a
4-camera pair with 25% planted outliers: both packages meet that test's
thresholds (rotation within 0.5 deg, metric t within 0.05, >= 0.9 of the
planted inliers kept) and their inlier sets agree within 1%. The random
streams differ (jax.random against torch.Generator), so the RANSACs are
compared by inlier sets and errors (ROADMAP §3's convention).

pycolmap_compat: every public name of colmap_tpu's module exists in the
port's; ``estimate_essential_matrix`` keeps the planted inliers with E of
the true pose, and the other estimators meet
tests/test_pycolmap_bindings.py's checks, on the CPU path; a pycolmap-style
script (match_exhaustive -> incremental_mapping) maps the verify scene to
its ground truth and the model crosses to colmap_tpu through the files.
"""

import numpy as np
import pytest
import torch

import colmap_tpu.pycolmap_compat as ref_pc
from colmap_tpu.estimators import generalized_pose as RG
from colmap_tpu.scene.reconstruction_io import read_model as ref_read_model
from colmap_tpu.scene.types import Camera as RCamera
from colmap_tpu.scene.types import Pose as RPose

import colmap_tpu_torch.pycolmap_compat as pc
from colmap_tpu_torch.estimators import generalized_pose as PG
from colmap_tpu_torch.kernels import rig as KR
from colmap_tpu_torch.kernels import rig_cases as RC
from colmap_tpu_torch.scene.types import Camera, Pose


def _rays(case):
    data = RC.gen_rel_tensors(case, "cpu", torch.float64)
    return data, [data.rays[:, 3 * k:3 * k + 3].numpy() for k in range(4)]


def _jax_sign_positive(d1, m1, d2, m2):
    """Whether colmap_tpu's eigh gives the nullspace vector whose rotation
    block has det > 0 (the sign its projection needs)."""
    import jax.numpy as jnp

    cE = np.einsum("ni,nj->nij", d2, d1).reshape(-1, 9)
    cR = (np.einsum("ni,nj->nij", d2, m1) + np.einsum("ni,nj->nij", m2, d1)).reshape(-1, 9)
    A = np.concatenate([cE, cR], 1)
    u = np.asarray(jnp.linalg.eigh(jnp.asarray(A.T @ A))[1])[:, 0]
    return np.linalg.det(u[9:].reshape(3, 3)) > 0


@pytest.mark.parametrize("rows", [17, 40])
def test_g17_relative_pose_matches_colmap_tpu_on_injected_samples(rows):
    """Minimal 17-row samples within 1e-9 plus the float64 eigensolvers'
    bound SOLVE_EPS / gap (LAPACK builds differ in the last bits, and a
    17-row sample's gap is ~1e-7), 40-row samples (gaps ~1e-5) within
    1e-9."""
    import jax.numpy as jnp

    case = RC.gen_rel_case(600, seed=5)
    data, (d1, m1, d2, m2) = _rays(case)
    rng = np.random.default_rng(rows)
    inl = np.flatnonzero(case["inliers"])
    samples = torch.from_numpy(np.stack([rng.choice(inl, rows, replace=False)
                                         for _ in range(24)]))
    gaps = RC.g17_gaps(data.rays, samples)
    truth = np.concatenate([case["rel"].rotmat(), case["rel"].t[:, None]], 1)
    equal = 0
    for s, gap in zip(samples.numpy(), gaps.tolist()):
        assert gap >= RC.DEGENERATE_GAP
        ref = np.asarray(RG.g17_relative_pose(*(jnp.asarray(a[s]) for a in (d1, m1, d2, m2))))
        got = PG.g17_relative_pose(*(torch.from_numpy(a[s]) for a in (d1, m1, d2, m2))).numpy()
        assert np.abs(got - truth).max() < 1e-6
        if _jax_sign_positive(d1[s], m1[s], d2[s], m2[s]):
            tol = 1e-9 + (RC.SOLVE_EPS / gap if rows == 17 else 0.0)
            assert np.abs(got - ref).max() <= tol
            equal += 1
        else:  # colmap_tpu's projection of the negated block is not the rotation
            assert np.abs(ref - truth).max() > 1e-3
    assert equal >= 8


@pytest.mark.parametrize("seed", [11, 7])
def test_weighted_g17_matches_colmap_tpu(seed):
    """Seed 11: colmap_tpu's eigh returns the positive sign, the refits
    agree within 1e-9; seed 7: it returns the other, and only the port's
    refit is the rotation."""
    import jax.numpy as jnp

    case = RC.gen_rel_case(400, seed=seed)
    data, rays = _rays(case)
    w = case["inliers"].astype(np.float64)
    ref = np.asarray(RG._weighted_g17(*(jnp.asarray(a) for a in rays), jnp.asarray(w)))
    got = PG._weighted_g17(*(torch.from_numpy(a) for a in rays), torch.from_numpy(w)).numpy()
    model, ok = KR.gen_rel_refit_plain(data.rays, torch.from_numpy(w))
    np.testing.assert_allclose(model.numpy(), got, atol=1e-15)
    truth = np.concatenate([case["rel"].rotmat(), case["rel"].t[:, None]], 1)
    assert bool(ok[0]) and np.abs(got - truth).max() < 1e-6
    sel = w > 0
    if _jax_sign_positive(*(a[sel] for a in rays)):
        np.testing.assert_allclose(got, ref, atol=1e-9)
    else:
        assert seed == 7 and np.abs(ref - truth).max() > 1e-3


def _metric_scene(seed, ncam, n):
    from test_generalized_pose import _project, _random_pose, _rig_setup

    rng = np.random.default_rng(seed)
    cams_from_rig, cameras = _rig_setup(rng, num_cams=ncam)
    rel = _random_pose(rng, t_scale=0.8)
    X1 = np.concatenate([rng.uniform(-3, 3, (n, 2)), rng.uniform(5, 12, (n, 1))], axis=1)
    idx1, idx2 = rng.integers(0, ncam, n), rng.integers(0, ncam, n)
    p1, p2, keep = np.zeros((n, 2)), np.zeros((n, 2)), np.ones(n, dtype=bool)
    for i in range(n):
        uv1, ok1 = _project(cameras[idx1[i]], cams_from_rig[idx1[i]], X1[i:i + 1])
        uv2, ok2 = _project(cameras[idx2[i]], cams_from_rig[idx2[i]].compose(rel), X1[i:i + 1])
        p1[i], p2[i], keep[i] = uv1[0], uv2[0], ok1[0] and ok2[0]
    return dict(points2D1=p1[keep], points2D2=p2[keep], camera_idxs1=idx1[keep],
                camera_idxs2=idx2[keep], cams_from_rig=cams_from_rig, cameras=cameras,
                rel=rel, inliers=np.ones(int(keep.sum()), dtype=bool))


@pytest.mark.parametrize("scene", ["two cameras, clean", "four cameras, 25% outliers"])
def test_estimate_generalized_relative_pose_matches_colmap_tpu(scene):
    if scene.startswith("two"):
        case, max_error = _metric_scene(1, 2, 150), 2.0
        rcams, rcfr = case["cameras"], case["cams_from_rig"]
        cams = [Camera(c.camera_id, c.model_id, c.width, c.height, c.params) for c in rcams]
        cfr = [Pose(p.quat, p.t) for p in rcfr]
    else:
        case, max_error = RC.gen_rel_case(400, seed=11), 4.0
        cams, cfr = case["cameras"], case["cams_from_rig"]
        rcams = [RCamera(c.camera_id, c.model_id, c.width, c.height, c.params) for c in cams]
        rcfr = [RPose(p.quat, p.t) for p in cfr]
    args = (case["points2D1"], case["points2D2"], case["camera_idxs1"], case["camera_idxs2"])
    ref, ref_inl = RG.estimate_generalized_relative_pose(
        *args, rcfr, rcams, RG.GeneralizedRelativePoseOptions(max_error_px=max_error), seed=2)
    got, inl = PG.estimate_generalized_relative_pose(
        *args, cfr, cams, PG.GeneralizedRelativePoseOptions(max_error_px=max_error), seed=2,
        device="cpu")
    rel, planted = case["rel"], case["inliers"]
    for pose, mask in ((ref, ref_inl), (got, inl)):
        assert pose is not None
        assert np.degrees(Pose(pose.quat, pose.t).angle_to(Pose(rel.quat, rel.t))) < 0.5
        np.testing.assert_allclose(pose.t, rel.t, atol=0.05)
        assert (mask & planted).sum() >= 0.9 * planted.sum()
    assert (inl != ref_inl).sum() <= 0.01 * len(inl)


def test_pycolmap_compat_has_every_public_name():
    names = {n for n in dir(ref_pc) if not n.startswith("_")}
    missing = sorted(n for n in names if not hasattr(pc, n))
    assert not missing, missing
    assert len(names) > 60


def test_estimate_essential_matrix_on_the_cpu_path():
    """The planted inliers kept, at most two of the random outliers (the
    ones that fall within 4 px of their epipolar lines), E near that of the
    true pose (the LO refit is the linear 8-point solve over the inliers)."""
    from colmap_tpu_torch.geometry.essential import essential_from_pose

    rng = np.random.default_rng(3)
    X = rng.uniform(-1, 1, (160, 3))
    X[:, 2] += 4.0
    f, c = 500.0, np.array([320.0, 240.0])
    pose = Pose(np.array([np.cos(0.05), 0.0, np.sin(0.05), 0.0]), np.array([-0.5, 0.05, 0.02]))
    x1 = X[:, :2] / X[:, 2:] * f + c
    Xc2 = pose.apply(X)
    x2 = Xc2[:, :2] / Xc2[:, 2:] * f + c
    x2[:20] = rng.uniform(0, 600, (20, 2))
    cam = Camera.create(1, "PINHOLE", f, 640, 480)
    got = pc.estimate_essential_matrix(x1, x2, cam, cam, device="cpu")
    assert got["inlier_mask"][20:].all() and got["inlier_mask"][:20].sum() <= 2
    E = essential_from_pose(torch.from_numpy(pose.quat), torch.from_numpy(pose.t)).numpy()
    E, Eg = E / np.linalg.norm(E), got["E"] / np.linalg.norm(got["E"])
    assert min(np.abs(E - Eg).max(), np.abs(E + Eg).max()) < 0.1


def test_pycolmap_compat_estimators_on_the_cpu_path():
    """tests/test_pycolmap_bindings.py's checks, on the port."""
    rng = np.random.default_rng(0)
    H = np.array([[1.1, 0.02, 5.0], [0.01, 0.95, -3.0], [1e-4, -2e-5, 1.0]])
    x1 = rng.uniform(0, 500, (100, 2))
    x2h = np.concatenate([x1, np.ones((100, 1))], 1) @ H.T
    res = pc.estimate_homography_matrix(x1, x2h[:, :2] / x2h[:, 2:], device="cpu")
    assert res is not None and res["num_inliers"] >= 95
    np.testing.assert_allclose(res["H"] / res["H"][2, 2], H, atol=1e-2)
    rng = np.random.default_rng(1)
    X = rng.uniform(-1, 1, (120, 3))
    X[:, 2] += 4.0
    c = np.array([320.0, 240.0])
    y1 = X[:, :2] / X[:, 2:] * 500.0 + c
    Xc2 = X + np.array([-0.5, 0.05, 0.0])
    y2 = Xc2[:, :2] / Xc2[:, 2:] * 500.0 + c
    res = pc.estimate_fundamental_matrix(y1, y2, device="cpu")
    assert res is not None and res["num_inliers"] >= 110
    cam = Camera.create(1, "SIMPLE_PINHOLE", 500.0, 640, 480)
    X = np.random.default_rng(2).uniform(-1, 1, (50, 3))
    X[:, 2] += 5
    uv = (X[:, :2] / X[:, 2:]) * 500.0 + np.array([320, 240])
    res = pc.estimate_absolute_pose(uv, X, cam, device="cpu")
    assert res is not None and res["num_inliers"] >= 45
    assert pc.refine_absolute_pose(res["cam_from_world"], uv, X, cam, res["inlier_mask"],
                                   device="cpu")["success"]
    poses = [Pose.identity(), Pose(np.array([1.0, 0, 0, 0]), np.array([-1.0, 0, 0]))]
    pt = np.array([0.2, 0.1, 4.0])
    obs = [(p.rotmat() @ pt + p.t)[:2] / (p.rotmat() @ pt + p.t)[2] * 500.0 + [320, 240]
           for p in poses]
    res = pc.estimate_triangulation(np.stack(obs), poses, [cam, cam], device="cpu")
    np.testing.assert_allclose(res["xyz"], pt, atol=1e-2)
    pc.set_random_seed(4)
    a = pc.estimate_fundamental_matrix(y1, y2, device="cpu")
    pc.set_random_seed(4)
    b = pc.estimate_fundamental_matrix(y1, y2, device="cpu")
    np.testing.assert_array_equal(a["F"], b["F"])
    pc.set_random_seed(0)


def test_pycolmap_script_maps_the_verify_scene(tmp_path):
    from colmap_tpu_torch.estimators.alignment import compare_reconstructions
    from colmap_tpu_torch.scene.database import Database
    from colmap_tpu_torch.scene.synthetic import SyntheticDatasetOptions, synthesize_dataset

    db_path = str(tmp_path / "db.db")
    db = Database(db_path)
    gt = synthesize_dataset(SyntheticDatasetOptions(num_rigs=1, num_frames_per_rig=8,
                                                    num_points3D=120,
                                                    camera_has_prior_focal_length=True),
                            db, rng=np.random.default_rng(3))
    db.conn.execute("DELETE FROM matches")
    db.conn.execute("DELETE FROM two_view_geometries")
    db.commit()
    db.close()
    assert pc.match_exhaustive(db_path, device="cpu") == 28
    models = pc.incremental_mapping(db_path, device="cpu")
    recon = models[0]
    assert isinstance(recon, pc.Reconstruction) and recon.num_reg_frames() == 8
    stats = compare_reconstructions(recon, gt)
    assert stats["max_rotation_error_deg"] < 1e-2 and stats["max_center_error"] < 1e-4
    recon.write(str(tmp_path / "model"))
    back = ref_read_model(str(tmp_path / "model"))
    assert back.num_points3D() == recon.num_points3D() and back.num_reg_frames() == 8
    assert pc.Reconstruction(str(tmp_path / "model")).num_points3D() == recon.num_points3D()
