"""colmap_tpu_torch geometry and minimal solvers against colmap_tpu's, on the CPU.

The same inputs, made from a numpy seed, go through colmap_tpu's JAX
functions (float64, as the suite runs JAX) and the port's torch ones
(float64 on the CPU). Tolerances are stated per test with their reason:
where both sides run the same float64 formulas they agree to about 1e-9;
where one side takes LAPACK's SVD and the other a Jacobi eigensolver, or a
solver isolates roots by bisection, they agree to the accuracy of that
step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from colmap_tpu.estimators.relative_pose import refine_relative_pose as j_refine_rel
from colmap_tpu.estimators.solvers import epipolar as je
from colmap_tpu.estimators.solvers import p3p as jp
from colmap_tpu.geometry import essential as jess
from colmap_tpu.geometry import rotation as jrot
from colmap_tpu.geometry import triangulation as jtri
from colmap_tpu.optim import polynomial as jpoly
from colmap_tpu.optim import small_linalg as jla
from colmap_tpu.sensor import models as jm
from colmap_tpu_torch.estimators.relative_pose import pose_from_essential_matrix as t_pose_from_e
from colmap_tpu_torch.estimators.relative_pose import refine_relative_pose as t_refine_rel
from colmap_tpu_torch.estimators.solvers import epipolar as te
from colmap_tpu_torch.estimators.solvers import p3p as tp
from colmap_tpu_torch.geometry import essential as tess
from colmap_tpu_torch.geometry import rotation as trot
from colmap_tpu_torch.geometry import triangulation as ttri
from colmap_tpu_torch.optim import polynomial as tpoly
from colmap_tpu_torch.optim import small_linalg as tla
from colmap_tpu_torch.sensor import models as tm

ALL_MODELS = [int(m) for m in jm.CameraModelId if m != jm.CameraModelId.INVALID]
IDS = [jm.MODEL_ID_TO_NAME[m] for m in ALL_MODELS]


def _T(a):
    return torch.from_numpy(np.asarray(a, dtype=np.float64))


def _params(model_id, rng):
    p = jm.initialize_params(model_id, 900.0, 1024, 768)
    extra = list(jm.extra_params_idxs(model_id))
    if model_id == jm.CameraModelId.FOV:
        p[extra[0]] = 0.8
    elif model_id == jm.CameraModelId.EUCM:
        p[4], p[5] = 0.6, 1.1
    else:
        for i in extra:
            p[i] = rng.uniform(-0.03, 0.03)
    return p


@pytest.mark.parametrize("model_id", ALL_MODELS, ids=IDS)
def test_cam_from_img_matches_jax(model_id):
    # Same formulas and the same 25 Newton steps in float64: 1e-9.
    rng = np.random.default_rng(model_id)
    p = _params(model_id, rng)
    xy = np.stack([rng.uniform(0, 1024, 64), rng.uniform(0, 768, 64)], axis=1)
    uv_j, ok_j = jm.cam_from_img(model_id, jnp.asarray(p), jnp.asarray(xy))
    uv_t, ok_t = tm.cam_from_img(model_id, _T(p), _T(xy))
    np.testing.assert_array_equal(np.asarray(ok_j), ok_t.numpy())
    np.testing.assert_allclose(uv_t.numpy(), np.asarray(uv_j), atol=1e-9)
    # Per-row parameters, as the triangulator passes them.
    uv_r, _ = tm.cam_from_img(model_id, _T(np.tile(p, (64, 1))), _T(xy))
    np.testing.assert_allclose(uv_r.numpy(), np.asarray(uv_j), atol=1e-9)


@pytest.mark.parametrize("model_id", ALL_MODELS, ids=IDS)
def test_cam_ray_from_img_matches_jax(model_id):
    # Unit rays from the same unprojection: 1e-9.
    rng = np.random.default_rng(100 + model_id)
    p = _params(model_id, rng)
    xy = np.stack([rng.uniform(0, 1024, 64), rng.uniform(0, 768, 64)], axis=1)
    r_j, ok_j = jm.cam_ray_from_img(model_id, jnp.asarray(p), jnp.asarray(xy))
    r_t, ok_t = tm.cam_ray_from_img(model_id, _T(p), _T(xy))
    np.testing.assert_array_equal(np.asarray(ok_j), ok_t.numpy())
    np.testing.assert_allclose(r_t.numpy(), np.asarray(r_j), atol=1e-9)


@pytest.mark.parametrize("model_id", [0, 2, 4, 16], ids=["SIMPLE_PINHOLE", "SIMPLE_RADIAL",
                                                       "OPENCV", "EUCM"])
def test_has_bogus_params_matches_jax(model_id):
    rng = np.random.default_rng(model_id)
    base = _params(model_id, rng)
    cases = [base]
    for i, v in ((0, 50.0), (0, 50000.0), (jm.principal_point_idxs(model_id)[0], -3.0)):
        p = base.copy()
        p[i] = v
        cases.append(p)
    for p in cases:
        args = (model_id, p, 1024, 768, 0.1, 10.0, 1.0)
        assert tm.has_bogus_params(*args) == jm.has_bogus_params(*args)


def test_rotations_match_jax():
    # Closed forms in float64: 1e-12.
    rng = np.random.default_rng(0)
    axis, angle = rng.normal(size=(50, 3)), rng.uniform(-3.1, 3.1, 50)
    q_j = np.asarray(jrot.quat_from_axis_angle(jnp.asarray(axis), jnp.asarray(angle)))
    q_t = trot.quat_from_axis_angle(_T(axis), _T(angle)).numpy()
    np.testing.assert_allclose(q_t, q_j, atol=1e-12)
    R_j = np.asarray(jrot.quat_to_rotmat(jnp.asarray(q_j)))
    R_t = trot.quat_to_rotmat(_T(q_j)).numpy()
    np.testing.assert_allclose(R_t, R_j, atol=1e-12)
    np.testing.assert_allclose(trot.rotmat_to_quat(_T(R_j)).numpy(),
                               np.asarray(jrot.rotmat_to_quat(jnp.asarray(R_j))), atol=1e-12)


def test_small_linalg_matches_jax():
    # Jacobi sweeps and Householder steps in the same order: 1e-10.
    rng = np.random.default_rng(1)
    A = rng.normal(size=(6, 9, 9))
    A = A @ A.transpose(0, 2, 1)
    w_j, V_j = jla.eigh_small(jnp.asarray(A))
    w_t, V_t = tla.eigh_small(_T(A))
    np.testing.assert_allclose(w_t.numpy(), np.asarray(w_j), rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(np.abs(V_t.numpy()), np.abs(np.asarray(V_j)), atol=1e-8)
    E = rng.normal(size=(6, 3, 3))
    for a, b in zip(tla.svd3x3(_T(E)), jla.svd3x3(jnp.asarray(E))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-10)
    W = rng.normal(size=(6, 5, 9))
    np.testing.assert_allclose(tla.nullspace_small(_T(W), 4).numpy(),
                               np.asarray(jla.nullspace_small(jnp.asarray(W), 4)), atol=1e-12)


def test_solve_quartic_matches_jax():
    # Ferrari in float64 on the same coefficients: the same root mask, 1e-8.
    rng = np.random.default_rng(2)
    c = rng.normal(size=(5, 500))
    r_j, m_j = jpoly.solve_quartic(*map(jnp.asarray, c))
    r_t, m_t = tpoly.solve_quartic(*map(_T, c))
    np.testing.assert_array_equal(m_t.numpy(), np.asarray(m_j))
    np.testing.assert_allclose(np.where(m_t.numpy(), r_t.numpy(), 0),
                               np.where(np.asarray(m_j), np.asarray(r_j), 0), atol=1e-8)


def _p3p_inputs(seed, n):
    rng = np.random.default_rng(seed)
    X = rng.uniform(-1, 1, (n, 3, 3))
    R = jrot.quat_to_rotmat(jnp.asarray(rng.normal(size=4) / np.linalg.norm(rng.normal(size=4))))
    Xc = X @ np.asarray(R).T + np.array([0.2, -0.1, 5.0])
    return X, Xc / np.linalg.norm(Xc, axis=-1, keepdims=True)


def test_p3p_matches_jax():
    # Same injected samples; the solution sets (up to 4 poses, NaN where a
    # root is invalid) match slot by slot. Kabsch goes through LAPACK's SVD on
    # both sides: 1e-8.
    X, rays = _p3p_inputs(3, 40)
    R_j, t_j = jax.vmap(jp.p3p)(jnp.asarray(X), jnp.asarray(rays))
    R_t, t_t = tp.p3p(_T(X), _T(rays))
    R_j, t_j = np.asarray(R_j), np.asarray(t_j)
    np.testing.assert_array_equal(np.isnan(R_t.numpy()), np.isnan(R_j))
    np.testing.assert_allclose(R_t.numpy(), R_j, atol=1e-8, equal_nan=True)
    np.testing.assert_allclose(t_t.numpy(), t_j, atol=1e-8, equal_nan=True)


def test_kabsch_matches_jax():
    rng = np.random.default_rng(4)
    src = rng.normal(size=(30, 3))
    w = (rng.random(30) > 0.3).astype(float)
    dst = src @ np.asarray(jrot.quat_to_rotmat(jnp.asarray([0.9, 0.1, -0.3, 0.2]) /
                                               np.linalg.norm([0.9, 0.1, -0.3, 0.2]))).T + 1.0
    dst += 0.01 * rng.normal(size=dst.shape)
    for a, b in zip(tp.kabsch(_T(src), _T(dst), _T(w)),
                    jp.kabsch(jnp.asarray(src), jnp.asarray(dst), jnp.asarray(w))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-10)


def _two_views(seed, n, noise=0.0):
    rng = np.random.default_rng(seed)
    X = rng.uniform(-1, 1, (n, 3)) + np.array([0, 0, 5.0])
    R = np.asarray(jrot.quat_to_rotmat(jnp.asarray(jrot.quat_from_axis_angle(
        jnp.asarray([0.1, 1.0, 0.2]), 0.2))))
    t = np.array([-1.0, 0.1, 0.2])
    x1 = X[:, :2] / X[:, 2:]
    X2 = X @ R.T + t
    x2 = X2[:, :2] / X2[:, 2:] + noise * rng.normal(size=(n, 2))
    return x1, x2, R, t


def _same_up_to_sign(a, b, atol):
    s = np.sign(np.sum(a * b))
    np.testing.assert_allclose(a * s, b, atol=atol)


def test_essential_five_point_matches_jax():
    # The solution sets match slot by slot up to sign (E and -E are one
    # model); the roots come from bisection to 2^-60 of a grid cell on both
    # sides and the models from the same float64 steps: 1e-7.
    x1, x2, _, _ = _two_views(5, 200)
    rng = np.random.default_rng(6)
    idx = rng.integers(0, 200, (24, 5))
    E_j = np.asarray(jax.vmap(je.essential_five_point)(jnp.asarray(x1[idx]), jnp.asarray(x2[idx])))
    E_t = te.essential_five_point(_T(x1[idx]), _T(x2[idx])).numpy()
    np.testing.assert_array_equal(np.isnan(E_t[..., 0, 0]), np.isnan(E_j[..., 0, 0]))
    assert np.isfinite(E_j[..., 0, 0]).sum() >= 24
    for a, b in zip(E_t.reshape(-1, 3, 3), E_j.reshape(-1, 3, 3)):
        if np.isfinite(b).all():
            _same_up_to_sign(a, b, 1e-7)


def test_essential_eight_point_weighted_matches_jax():
    # The same Jacobi eigensolver on both sides: 1e-9.
    x1, x2, _, _ = _two_views(7, 120, noise=1e-3)
    w = (np.random.default_rng(8).random(120) > 0.2).astype(float)
    E_j = np.asarray(je.essential_eight_point(jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(w)))
    E_t = te.essential_eight_point(_T(x1), _T(x2), _T(w)).numpy()
    _same_up_to_sign(E_t, E_j, 1e-9)


def test_essential_geometry_matches_jax():
    # pose_from_essential_matrix, sampson_error and the two-view DLT: LAPACK's
    # SVD on both sides, 1e-9.
    x1, x2, R, t = _two_views(9, 100)
    E = np.asarray(jess.cross_product_matrix(jnp.asarray(t / np.linalg.norm(t)))) @ R
    mask = np.ones(100, dtype=bool)
    mask[-5:] = False
    out_j = jess.pose_from_essential_matrix(jnp.asarray(E), jnp.asarray(x1), jnp.asarray(x2),
                                            mask=jnp.asarray(mask))
    out_t = t_pose_from_e(_T(E), _T(x1), _T(x2), mask=torch.from_numpy(mask))
    for a, b in zip(out_t, out_j):
        np.testing.assert_allclose(np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64),
                                   atol=1e-9)
    np.testing.assert_allclose(out_t[0].numpy(), R, atol=1e-9)
    np.testing.assert_allclose(tess.sampson_error(_T(E), _T(x1), _T(x2 + 0.01)).numpy(),
                               np.asarray(jess.sampson_error(jnp.asarray(E), jnp.asarray(x1),
                                                             jnp.asarray(x2 + 0.01))), atol=1e-15)


def test_refine_relative_pose_matches_jax():
    # 15 LM steps on the Sampson error from the same start: the same float64
    # steps up to jacfwd's rounding, 1e-9.
    x1, x2, R, t = _two_views(10, 150, noise=2e-4)
    q0 = np.asarray(jrot.rotmat_to_quat(jnp.asarray(R)))
    q0 = q0 + np.array([0.0, 0.01, -0.01, 0.005])
    q0 /= np.linalg.norm(q0)
    w = np.ones(150)
    out_j = j_refine_rel(jnp.asarray(q0), jnp.asarray(t + 0.05), jnp.asarray(x1), jnp.asarray(x2),
                         jnp.asarray(w))
    out_t = t_refine_rel(_T(q0), _T(t + 0.05), _T(x1), _T(x2), _T(w))
    for a, b in zip(out_t, out_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-9)


def test_triangulation_matches_jax():
    # N-view DLT with LAPACK's eigh on both sides, and the law-of-cosines
    # angle: 1e-9.
    rng = np.random.default_rng(11)
    P = np.zeros((20, 6, 3, 4))
    x = np.zeros((20, 6, 2))
    X = rng.uniform(-1, 1, (20, 3))
    for v in range(6):
        R = np.asarray(jrot.quat_to_rotmat(jrot.quat_from_axis_angle(
            jnp.asarray([0.0, 1.0, 0.0]), 0.15 * v)))
        tv = np.array([0.3 * v, 0.0, 5.0])
        P[:, v] = np.concatenate([R, tv[:, None]], axis=1)
        Xc = X @ R.T + tv
        x[:, v] = Xc[:, :2] / Xc[:, 2:] + 1e-3 * rng.normal(size=(20, 2))
    mask = (rng.random((20, 6)) > 0.3).astype(float)
    mask[:, :2] = 1.0
    np.testing.assert_allclose(
        ttri.triangulate_multi_view(_T(P), _T(x), _T(mask)).numpy(),
        np.asarray(jtri.triangulate_multi_view(jnp.asarray(P), jnp.asarray(x),
                                               jnp.asarray(mask))), atol=1e-9)
    c1, c2 = rng.normal(size=(20, 3)), rng.normal(size=(20, 3))
    np.testing.assert_allclose(
        ttri.triangulation_angle(_T(c1), _T(c2), _T(X)).numpy(),
        np.asarray(jtri.triangulation_angle(jnp.asarray(c1), jnp.asarray(c2), jnp.asarray(X))),
        atol=1e-12)
    np.testing.assert_allclose(
        tess.triangulate_point_dlt(_T(P[:, 0]), _T(P[:, 1]), _T(x[:, 0]), _T(x[:, 1])).numpy(),
        np.asarray(jess.triangulate_point_dlt(jnp.asarray(P[:, 0]), jnp.asarray(P[:, 1]),
                                              jnp.asarray(x[:, 0]), jnp.asarray(x[:, 1]))),
        atol=1e-9)
