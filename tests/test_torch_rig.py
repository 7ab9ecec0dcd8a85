"""colmap_tpu_torch's rig slice against colmap_tpu, on the CPU.

The same inputs, made from a numpy seed, go through colmap_tpu (JAX in
float64, as the suite runs it) and the port (its plain versions, float64 on
the CPU): K24-K26's plain versions against the rig BA's _obs_jacobians,
_apply_masks, _build_schur, _schur_matvec and lm_step's sums, the rig
solve, gdlt_pose and K27's plain version on injected samples, the
generalized absolute pose and its refinement, the rig problem set-up,
``rig_configurator``'s tables, the local rig BA's frame set, and the port's
``mapper`` on the verify rig scene against the ground truth. Both packages
run the same float64 formulas in another summation order; each tolerance
is stated in its test. RANSAC draws its samples from jax.random in
colmap_tpu and from a torch.Generator in the port, so the estimators are
compared by outcome (pose against the truth, inlier set), never by sample
stream.
"""

import json
import shutil
import sqlite3

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from colmap_tpu.cli import main as jcli
from colmap_tpu.estimators import ba_setup as jsetup
from colmap_tpu.estimators import bundle_adjustment as jba
from colmap_tpu.estimators import bundle_adjustment_rig as jrba
from colmap_tpu.estimators import generalized_pose as jgp
from colmap_tpu.geometry import rotation as jrot
from colmap_tpu.scene import database as jdb
from colmap_tpu.scene import synthetic as jsyn
from colmap_tpu.scene import types as jtypes
from colmap_tpu.sfm import incremental_mapper as jmapper
from colmap_tpu_torch import convert
from colmap_tpu_torch.cli import main as tcli
from colmap_tpu_torch.estimators import ba_setup as tsetup
from colmap_tpu_torch.estimators import bundle_adjustment as tba
from colmap_tpu_torch.estimators import bundle_adjustment_rig as trba
from colmap_tpu_torch.estimators import generalized_pose as tgp
from colmap_tpu_torch.estimators.alignment import compare_reconstructions
from colmap_tpu_torch.geometry import rigid3
from colmap_tpu_torch.geometry import rotation as trot
from colmap_tpu_torch.kernels import rig as KR
from colmap_tpu_torch.kernels import rig_cases as RC
from colmap_tpu_torch.optim.ransac import unpack_best
from colmap_tpu_torch.scene import database as tdb
from colmap_tpu_torch.scene import synthetic as tsyn
from colmap_tpu_torch.scene import types as ttypes
from colmap_tpu_torch.scene.reconstruction_io import read_model
from colmap_tpu_torch.sfm import incremental_mapper as tmapper
from colmap_tpu_torch.sfm import incremental_pipeline as tpipe

torch.set_num_threads(1)

# The reference's end-to-end thresholds (BASELINE.md:13).
MAX_ROT_DEG, MAX_CENTER = 1e-2, 1e-4


def _close(got, ref, tol, name=""):
    """max |got - ref| <= tol * max(max |ref|, 1)."""
    got, ref = np.asarray(got, dtype=np.float64), np.asarray(ref, dtype=np.float64)
    err = np.abs(got - ref).max() if got.size else 0.0
    scale = max(np.abs(ref).max() if ref.size else 0.0, 1.0)
    assert err <= tol * scale, f"{name}: {err:.3e} > {tol:g} * {scale:.3e}"


def _to_jax(problem):
    return jrba.RigBAProblem(*(jnp.asarray(x.numpy()) for x in problem))


def _problem(model_id, seed=0, F=5, G=3, N=60, empty_sensor=False):
    """A small rig problem (float64) for the kernels' plain versions, with
    its masks: frame 0 constant, frame 1's x translation constant, sensor 0
    the reference; with ``empty_sensor`` one more sensor and camera row
    that no observation uses."""
    p, _, _ = RC.rig_ba_problem(F, G, N, 4, model_id=model_id, seed=seed, dtype=torch.float64)
    if empty_sensor:
        p = RC.with_empty_sensor(p)
    opts = tba.BAOptions(loss="cauchy", loss_scale=2.0, refine_principal_point=True)
    masks = trba.fix_gauge_two_frames(trba.default_masks(p, model_id, opts), 0, 1)
    return p, opts, masks


def _jax_options(opts):
    return jba.BAOptions(loss=opts.loss, loss_scale=opts.loss_scale,
                         refine_principal_point=opts.refine_principal_point,
                         max_iterations=opts.max_iterations, pcg_iterations=opts.pcg_iterations)


def _jax_masks(jp, model_id, jopts):
    return jrba.fix_gauge_two_frames(jrba.default_masks(jp, model_id, jopts), 0, 1)


@pytest.mark.parametrize("model_id,loss", [(0, "cauchy"), (1, "cauchy"), (2, "cauchy"),
                                           (3, "cauchy"), (4, "cauchy"), (2, "trivial")])
def test_rig_jacobians_plain_match(model_id, loss):
    # K24's plain version against _obs_jacobians + _apply_masks and
    # compute_cost: jacfwd of the same float64 residual in both packages,
    # 1e-10 of each output's scale.
    p, opts, masks = _problem(model_id, seed=model_id)
    opts = tba.BAOptions(loss=loss, loss_scale=opts.loss_scale, refine_principal_point=True)
    jp, jopts = _to_jax(p), _jax_options(opts)
    jm = _jax_masks(jp, model_id, jopts)
    r, Jf, Js, Jc, Jx = jrba._obs_jacobians(jp, model_id, jopts)
    Jf, Js, Jc, Jx = jrba._apply_masks(Jf, Js, Jc, Jx, jp, jm, jopts)
    om = trba._obs_masks(masks, opts)
    jac = KR.rig_obs_jacobians_plain(p.quat, p.t, p.sensor_quat, p.sensor_t, p.cam_params,
                                     p.points, trba._obs(p), om.pose, om.sensor, om.cam, om.point,
                                     model_id, loss, opts.loss_scale)
    for name, a, b in zip(("r", "Jf", "Js", "Jc", "Jx"), (r, Jf, Js, Jc, Jx), jac):
        _close(b.numpy(), a, 1e-10, name)
    cost_j = float(jrba.compute_cost(jp, model_id, jopts))
    cost_t = float(trba.compute_cost(p, model_id, opts))
    assert abs(cost_t - cost_j) <= 1e-10 * cost_j
    _close(trba.compute_residuals(p, model_id).numpy(), jrba.compute_residuals(jp, model_id),
           1e-10, "residuals")


def _reduction_case(empty_sensor):
    model_id = 2
    p, opts, masks = _problem(model_id, seed=7, empty_sensor=empty_sensor)
    jp, jopts = _to_jax(p), _jax_options(opts)
    jm = _jax_masks(jp, model_id, jopts)
    om = trba._obs_masks(masks, opts)
    obs = trba._obs(p)
    jac = KR.rig_obs_jacobians_plain(p.quat, p.t, p.sensor_quat, p.sensor_t, p.cam_params,
                                     p.points, obs, om.pose, om.sensor, om.cam, om.point,
                                     model_id, opts.loss, opts.loss_scale)
    r, Jf, Js, Jc, Jx = jrba._obs_jacobians(jp, model_id, jopts)
    Jf, Js, Jc, Jx = jrba._apply_masks(Jf, Js, Jc, Jx, jp, jm, jopts)
    return p, jp, jopts, obs, jac, (r, Jf, Js, Jc, Jx), trba._layout(p)


def _split(x, p):
    F, G = p.quat.shape[0], p.sensor_quat.shape[0]
    P = p.cam_params.shape[1]
    x = x.numpy()
    return x[:F, :6], x[F:F + G, :6], x[F + G:, :P]


@pytest.mark.parametrize("empty_sensor", [False, True])
def test_rig_reduce_and_matvec_plain_match(empty_sensor):
    # K25 against lm_step's gradients, _build_schur's damping and point
    # blocks, _pcg's Jacobi diagonals and the reduced right-hand side; K26
    # against _schur_matvec and the back-substitution; unused columns of
    # the camera-side tensor stay 0; with an empty sensor and camera row
    # every output of that row is 0. Float64 sums in another order: 1e-10.
    lam = 1e-3
    p, jp, jopts, obs, jac, (r, Jf, Js, Jc, Jx), layout = _reduction_case(empty_sensor)
    F, G, C = jp.quat.shape[0], jp.sensor_quat.shape[0], jp.cam_params.shape[0]
    N = jp.points.shape[0]
    red = KR.rig_lm_reduce_plain(jac, obs, layout, lam)
    ops = jrba._build_schur(jp, Jf, Js, Jc, Jx, lam, jopts)
    seg = jrba._seg
    gf = -seg((Jf * r[:, :, None]).sum(1), jp.obs_frame, F)
    gs = -seg((Js * r[:, :, None]).sum(1), jp.obs_sensor, G)
    gc = -seg((Jc * r[:, :, None]).sum(1), jp.obs_cam, C)
    gx = -seg((Jx * r[:, :, None]).sum(1), jp.obs_point, N)
    y = (ops.Hpp_inv * gx[:, None, :]).sum(-1)
    v = (Jx * y[jp.obs_point][:, None, :]).sum(-1)
    bf = gf - seg((Jf * v[:, :, None]).sum(1), jp.obs_frame, F)
    bs = gs - seg((Js * v[:, :, None]).sum(1), jp.obs_sensor, G)
    bc = gc - seg((Jc * v[:, :, None]).sum(1), jp.obs_cam, C)
    for name, got, ref in (("g", red.g, (gf, gs, gc)), ("b", red.b, (bf, bs, bc)),
                           ("lam", red.lam_diag, (ops.lam_f, ops.lam_s, ops.lam_c))):
        for k, (a, b) in enumerate(zip(_split(got, p), ref)):
            _close(a, b, 1e-10, f"{name}[{k}]")
    diag = (seg((Jf * Jf).sum(1), jp.obs_frame, F) + ops.lam_f,
            seg((Js * Js).sum(1), jp.obs_sensor, G) + ops.lam_s,
            seg((Jc * Jc).sum(1), jp.obs_cam, C) + ops.lam_c)
    for k, (a, d) in enumerate(zip(_split(red.precond, p), diag)):
        d = np.asarray(d)
        _close(a, np.where(d > 1e-12, 1.0 / np.where(d > 1e-12, d, 1.0), 0.0), 1e-10, f"M[{k}]")
    _close(red.gx.numpy(), gx, 1e-10, "gx")
    _close(red.Hpp_inv.numpy(), ops.Hpp_inv, 1e-10, "Hpp_inv")
    P = jp.cam_params.shape[1]
    for t_ in (red.g, red.b, red.diag, red.lam_diag, red.precond):
        assert not t_[:F + G, 6:].any() and not t_[F + G:, P:].any()
    if empty_sensor:
        for t_ in (red.g, red.b, red.diag, red.precond):
            assert not t_[F + G - 1].any() and not t_[-1].any()

    rng = np.random.default_rng(3)
    xf, xs, xc = rng.normal(size=(F, 6)), rng.normal(size=(G, 6)), rng.normal(size=(C, P))
    x = torch.zeros(F + G + C, KR.W, dtype=torch.float64)
    x[:F, :6], x[F:F + G, :6], x[F + G:, :P] = map(torch.from_numpy, (xf, xs, xc))
    out = KR.rig_schur_matvec_plain(jac, obs, layout, red.Hpp_inv, red.lam_diag, x)
    ref = jrba._schur_matvec(jp, ops, jnp.asarray(xf), jnp.asarray(xs), jnp.asarray(xc))
    for k, (a, b) in enumerate(zip(_split(out, p), ref)):
        _close(a, b, 1e-10, f"matvec[{k}]")
    dx = KR.rig_back_substitute_plain(jac, obs, layout, red.Hpp_inv, red.gx, x)
    u = ((Jf * jnp.asarray(xf)[jp.obs_frame][:, None, :]).sum(-1)
         + (Js * jnp.asarray(xs)[jp.obs_sensor][:, None, :]).sum(-1)
         + (Jc * jnp.asarray(xc)[jp.obs_cam][:, None, :]).sum(-1))
    w = seg((Jx * u[:, :, None]).sum(1), jp.obs_point, N)
    _close(dx.numpy(), (ops.Hpp_inv * (gx - w)[:, None, :]).sum(-1), 1e-10, "dx")


def _make_stereo_problem(rng):
    """tests/test_rig_ba.py's stereo rig, perturbed as its recovery test
    perturbs it (frames 2-5, sensor 1 and the points)."""
    import sys
    import os

    sys.path.insert(0, os.path.dirname(__file__))
    from test_rig_ba import _make_rig_problem

    problem, model_id = _make_rig_problem(rng)
    dq = 0.01 * rng.normal(size=problem.quat.shape)
    dq[:2] = 0.0
    dt = 0.02 * rng.normal(size=problem.t.shape)
    dt[:2] = 0.0
    perturbed = problem._replace(
        quat=jrot.quat_normalize(problem.quat + dq), t=problem.t + dt,
        sensor_quat=jrot.quat_normalize(
            problem.sensor_quat + jnp.asarray([[0, 0, 0, 0], [0.01, -0.005, 0.008, 0.01]])),
        sensor_t=problem.sensor_t + jnp.asarray([[0, 0, 0], [0.02, -0.01, 0.015]]),
        points=problem.points + 0.02 * rng.normal(size=problem.points.shape))
    return problem, perturbed, model_id


def test_rig_solve_matches(loss="cauchy"):
    # The port's solve and colmap_tpu's on the same perturbed stereo rig,
    # sensor 1 free: the same LM path in float64, so final costs agree to
    # 1e-6 relative (plus 1e-12 absolute: at the zero-residual optimum the
    # last steps act on rounding and the iteration counts may differ); the
    # stereo baseline is recovered to 1e-4 as test_rig_ba.py asks of
    # colmap_tpu.
    gt, perturbed, model_id = _make_stereo_problem(np.random.default_rng(1))
    jopts = jba.BAOptions(max_iterations=15, pcg_iterations=40, loss=loss)
    topts = tba.BAOptions(max_iterations=15, pcg_iterations=40, loss=loss)
    jm = jrba.fix_gauge_two_frames(jrba.default_masks(perturbed, model_id, jopts), 0, 1)
    _, sj = jrba.solve(perturbed, model_id, jopts, jm)
    tp = trba.RigBAProblem(*(torch.from_numpy(np.array(x)) for x in perturbed))
    tm = trba.fix_gauge_two_frames(trba.default_masks(tp, model_id, topts), 0, 1)
    solved, st = trba.solve(tp, model_id, topts, tm)
    assert abs(st["initial_cost"] - sj["initial_cost"]) <= 1e-9 * sj["initial_cost"]
    assert abs(st["final_cost"] - sj["final_cost"]) <= 1e-6 * sj["final_cost"] + 1e-12
    assert st["final_cost"] < 1e-6 * max(st["initial_cost"], 1.0)
    bl_gt = float(jnp.linalg.norm(gt.sensor_t[1]))
    assert abs(float(torch.linalg.vector_norm(solved.sensor_t[1])) - bl_gt) < 1e-4
    np.testing.assert_allclose(solved.sensor_quat[0].numpy(), [1, 0, 0, 0], atol=1e-12)


@pytest.mark.parametrize("estimate_scale", [False, True])
def test_gdlt_pose_matches(estimate_scale):
    # Noise-free rays of a 4-camera rig, the world shrunk by 0.37: both
    # packages' float64 gDLT give the same (3, 5) model (1e-9) and, with
    # the scale estimated, the true pose and scale to 1e-6 (the 1e-10 ridge
    # on the normal equations biases the poorly conditioned scale: baselines
    # of 0.05 at a distance of 5).
    data, Rt, inl = RC.gen_abs_case(40, outlier_ratio=0.0, seed=5, world_scale=0.37)
    mj = jgp.gdlt_pose(jnp.asarray(data.X.numpy()), jnp.asarray(data.centers.numpy()),
                       jnp.asarray(data.dirs.numpy()), estimate_scale=estimate_scale)
    mt = KR.gdlt_pose(data.X, data.centers, data.dirs, estimate_scale=estimate_scale)
    _close(mt.numpy(), mj, 1e-9, "gdlt")
    if estimate_scale:
        _close(mt[:, :4].numpy(), Rt, 1e-6, "pose")
        assert abs(float(mt[0, 4]) - 0.37) < 1e-6
    w = torch.from_numpy(np.random.default_rng(2).uniform(0.2, 1.0, 40))
    mjw = jgp.gdlt_pose(jnp.asarray(data.X.numpy()), jnp.asarray(data.centers.numpy()),
                        jnp.asarray(data.dirs.numpy()), jnp.asarray(w.numpy()), estimate_scale)
    _close(KR.gdlt_pose(data.X, data.centers, data.dirs, w, estimate_scale).numpy(), mjw, 1e-9,
           "weighted gdlt")


def _jax_residuals(models, d):
    """colmap_tpu's _gen_abs_ransac residual (l.138-153) on the same rows."""
    R, t, s = models[:, :, :3], models[:, :, 3], models[:, 0, 4]
    Xr = jnp.einsum("mij,nj->mni", R, d["X"]) * s[:, None, None] + t[:, None, :]
    Xc = jax.vmap(lambda xr: jax.vmap(jrot.quat_rotate)(d["cam_q"], xr) + d["cam_t"])(Xr)
    z = Xc[..., 2]
    behind = z < 1e-8
    proj = Xc[..., :2] / jnp.where(behind, 1.0, z)[..., None]
    err = jnp.sum((proj - d["uv"][None]) ** 2, axis=-1) * d["focal"][None] ** 2
    return jnp.where(behind, jnp.inf, err)


@pytest.mark.parametrize("world_scale", [1.0, 0.37])
def test_gen_abs_propose_score_plain_matches(world_scale):
    # K27's plain version on 64 injected samples (half all-inlier, 30%
    # outliers) against colmap_tpu's gdlt_pose vmapped over the samples and
    # its residual: the same models (1e-8), the same counts, the same best
    # index and support.
    data, _, inl = RC.gen_abs_case(200, seed=11, world_scale=world_scale)
    samples = RC.injected_samples(200, 64, 12, inl)
    max_sq = 12.0 ** 2
    models, counts, best = KR.gen_abs_propose_score_plain(data, samples, max_sq, True)
    d = {k: jnp.asarray(getattr(data, k).numpy()) for k in ("X", "centers", "dirs", "uv",
                                                             "cam_q", "cam_t", "focal")}
    s = jnp.asarray(samples.numpy())
    mj = jax.vmap(lambda i: jgp.gdlt_pose(d["X"][i], d["centers"][i], d["dirs"][i],
                                          estimate_scale=True))(s)
    cj = np.asarray(jnp.sum(_jax_residuals(mj, d) <= max_sq, axis=-1))
    finite = np.isfinite(np.asarray(mj)).reshape(64, -1).all(1)
    _close(models.numpy()[finite], np.asarray(mj)[finite], 1e-8, "models")
    np.testing.assert_array_equal(counts.numpy(), np.where(finite, cj, 0))
    support, index = unpack_best(int(best[0]))
    assert (support, index) == (int(cj.max()), int(np.argmax(cj)))
    inl_t = KR.gen_abs_inliers_plain(data, models[index], max_sq).numpy()
    np.testing.assert_array_equal(inl_t, np.asarray(_jax_residuals(mj[index][None], d)[0])
                                  <= max_sq)


def _gen_abs_inputs(world_scale, seed=21, n=150):
    """Pixel observations of gen_abs_case's rig (SIMPLE_PINHOLE, f = 1280)
    for both packages' estimators."""
    data, Rt, inl = RC.gen_abs_case(n, seed=seed, world_scale=world_scale)
    params = np.array([1280.0, 512.0, 384.0])
    xy = data.uv.numpy() * 1280.0 + params[1:]
    cam_of = {tuple(q): k for k, q in enumerate(map(tuple, np.unique(data.cam_q.numpy(), axis=0)))}
    cam_idx = np.array([cam_of[tuple(q)] for q in data.cam_q.numpy()])
    poses = {}
    for i, k in enumerate(cam_idx):
        poses[k] = (data.cam_q[i].numpy(), data.cam_t[i].numpy())
    out = {}
    for name, types in (("jax", jtypes), ("port", ttypes)):
        cams = [types.Camera(camera_id=k + 1, model_id=0, width=1024, height=768,
                             params=params.copy()) for k in range(len(poses))]
        out[name] = (cams, [types.Pose(*poses[k]) for k in range(len(poses))])
    return xy, data.X.numpy(), cam_idx, out, Rt, inl


@pytest.mark.parametrize("world_scale", [1.0, 0.37])
def test_estimate_generalized_absolute_pose_matches(world_scale):
    # Both estimators on the same 150 correspondences (30% outliers) of a
    # 4-camera rig find the same inlier set, the true one, and the truth's
    # pose and world scale to 2e-3: the LO refit replaces a model only where
    # it gains support, and on noise-free data every all-inlier sample
    # already has full support, so each estimate is one 6-point gDLT, whose
    # scale the short baselines leave about 1e-3 uncertain (colmap_tpu's is
    # 9.7e-4 off here); refine_generalized_absolute_pose then fixes the pose.
    xy, X, cam_idx, cams, Rt, inl = _gen_abs_inputs(world_scale)
    pj, inl_j, sj = jgp.estimate_generalized_absolute_pose(
        xy, X, cam_idx, cams["jax"][1], cams["jax"][0], seed=0, estimate_scale=True)
    pt, inl_t, st = tgp.estimate_generalized_absolute_pose(
        xy, X, cam_idx, cams["port"][1], cams["port"][0], seed=0, estimate_scale=True,
        device="cpu")
    for pose, s in ((pj, sj), (pt, st)):
        assert pose is not None and abs(s - world_scale) < 2e-3 * world_scale
        _close(pose.matrix3x4(), Rt, 2e-3, "pose")
    np.testing.assert_array_equal(inl_t, inl_j)
    np.testing.assert_array_equal(inl_t, inl)


def test_refine_generalized_absolute_pose_matches():
    # Both refinements from the same perturbed pose over the same inliers:
    # the same float64 LM iterations, so the refined poses agree to 1e-9,
    # and both reach the truth (1e-8).
    xy, X, cam_idx, cams, Rt, inl = _gen_abs_inputs(1.0, seed=23)
    q0 = trot.rotmat_to_quat(torch.from_numpy(Rt[:, :3])).numpy()
    dq = trot.quat_from_axis_angle(torch.tensor([0.3, -0.2, 0.9]), 0.02).numpy()
    q_init = trot.quat_multiply(torch.from_numpy(dq), torch.from_numpy(q0)).numpy()
    t_init = Rt[:, 3] + np.array([0.01, -0.02, 0.03])
    pj, okj = jgp.refine_generalized_absolute_pose(
        jtypes.Pose(q_init, t_init), xy, X, cam_idx, cams["jax"][1], cams["jax"][0], inl)
    pt, okt = tgp.refine_generalized_absolute_pose(
        ttypes.Pose(q_init, t_init), xy, X, cam_idx, cams["port"][1], cams["port"][0], inl,
        device="cpu")
    assert okj and okt
    _close(pt.matrix3x4(), pj.matrix3x4(), 1e-9, "refined")
    _close(pt.matrix3x4(), Rt, 1e-8, "truth")


def _rig_scene(seed=3, **kw):
    opt = dict(num_rigs=1, num_cameras_per_rig=2, num_frames_per_rig=5, num_points3D=80)
    opt.update(kw)
    return jsyn.synthesize_dataset(jsyn.SyntheticDatasetOptions(**opt),
                                   rng=np.random.default_rng(seed))


def test_rig_problem_from_reconstruction_matches():
    # The same reconstruction packed by both packages gives the same arrays
    # and index (frames, sensors, cameras, points, reference rows); a solve
    # written back by update_reconstruction_rig lands on the same poses,
    # sensors, intrinsics and points in both.
    jrec = _rig_scene(num_rigs=2)
    trec = convert.convert_reconstruction(jrec)
    frames = sorted(jrec.reg_frame_ids())[1:]
    jp, ji = jsetup.rig_problem_from_reconstruction(jrec, frames)
    tp, ti = tsetup.rig_problem_from_reconstruction(trec, frames, device="cpu")
    assert ti == ji
    for name, a, b in zip(trba.RigBAProblem._fields, tp, jp):
        _close(a.numpy(), np.asarray(b), 0.0, name)
    rng = np.random.default_rng(1)
    moved = tp._replace(points=tp.points + torch.from_numpy(rng.normal(0, 0.01, tp.points.shape)),
                        sensor_t=tp.sensor_t + 0.01, t=tp.t - 0.02)
    jsetup.update_reconstruction_rig(jrec, jrba.RigBAProblem(
        *(jnp.asarray(x.numpy()) for x in moved)), ji)
    tsetup.update_reconstruction_rig(trec, moved, ti)
    for fid in frames:
        _close(trec.frames[fid].rig_from_world.matrix3x4(),
               jrec.frames[fid].rig_from_world.matrix3x4(), 1e-15, "frame")
    for rid, rig in trec.rigs.items():
        for key, pose in rig.sensors.items():
            _close(pose.matrix3x4(), jrec.rigs[rid].sensors[key].matrix3x4(), 1e-15, "sensor")
    for pid, pt in trec.points3D.items():
        _close(pt.xyz, jrec.points3D[pid].xyz, 1e-15, "point")


def _drop_rigs(path):
    conn = sqlite3.connect(path)
    for table in ("rigs", "rig_sensors", "frames", "frame_data"):
        conn.execute(f"DELETE FROM {table}")
    conn.commit()
    conn.close()


def _tables(path):
    conn = sqlite3.connect(path)
    out = {t: sorted(conn.execute(f"SELECT * FROM {t}").fetchall())
           for t in ("rigs", "rig_sensors", "frames", "frame_data")}
    conn.close()
    return out


def test_rig_configurator_tables_match(tmp_path, capsys):
    # tests/test_cli_tools3.py:272's database (two PINHOLE cameras, three
    # left/right image pairs), configured by both packages' command from the
    # same JSON: the rigs, rig_sensors, frames and frame_data tables are
    # equal row for row; then a scene whose true rig is rebuilt from its
    # names.
    path = str(tmp_path / "rig.db")
    db = tdb.Database(path)
    cid1 = db.write_camera(ttypes.Camera.create(1, 1, 500.0, 640, 480))
    cid2 = db.write_camera(ttypes.Camera.create(2, 1, 500.0, 640, 480))
    for k in range(3):
        db.write_image(f"left/{k:04d}.png", cid1)
        db.write_image(f"right/{k:04d}.png", cid2)
    db.commit()
    db.close()
    config = [{"cameras": [
        {"image_prefix": "left/", "ref_sensor": True},
        {"image_prefix": "right/", "cam_from_rig_rotation": [1.0, 0.0, 0.0, 0.0],
         "cam_from_rig_translation": [0.2, 0.0, 0.0]},
    ]}]
    cfg = tmp_path / "rig_config.json"
    cfg.write_text(json.dumps(config))
    jpath = str(tmp_path / "jax.db")
    shutil.copy(path, jpath)
    jcli.main(["rig_configurator", "--database_path", jpath, "--rig_config_path", str(cfg)])
    assert tcli.main(["rig_configurator", "--database_path", path, "--rig_config_path",
                      str(cfg), "--device", "cpu"]) == (1, 3)
    assert "Configured 1 rigs, 3 frames" in capsys.readouterr().out
    assert _tables(path) == _tables(jpath)

    scene = str(tmp_path / "scene.db")
    gt = tsyn.synthesize_dataset(tsyn.SyntheticDatasetOptions(
        num_rigs=1, num_cameras_per_rig=3, num_frames_per_rig=4, num_points3D=30, seed=2),
        tdb.Database(scene))
    before = _tables(scene)
    _drop_rigs(scene)
    RC.write_rig_config(gt, tmp_path / "scene.json")
    tcli.main(["rig_configurator", "--database_path", scene, "--rig_config_path",
               str(tmp_path / "scene.json"), "--device", "cpu"])
    after = _tables(scene)
    assert after["frames"] == before["frames"] and after["frame_data"] == before["frame_data"]
    assert after["rigs"] == before["rigs"] and len(after["rig_sensors"]) == 2


def _registered_mappers(db_path, frames):
    """Both packages' mappers on the verify rig database, the given frames
    registered at their true poses."""
    from colmap_tpu.scene import database_cache as jcache
    from colmap_tpu.scene.reconstruction import Reconstruction as JReconstruction
    from colmap_tpu_torch.scene import database_cache as tcache
    from colmap_tpu_torch.scene.reconstruction import Reconstruction

    db = jdb.Database(db_path)
    gt = jsyn.synthesize_dataset(_rig_options(), db)
    db.close()
    out = []
    for pkg, cache_mod, recon_cls, db_cls, types in (
            (jmapper, jcache, JReconstruction, jdb.Database, jtypes),
            (tmapper, tcache, Reconstruction, tdb.Database, ttypes)):
        cache = cache_mod.DatabaseCache.create(db_cls(db_path, must_exist=True),
                                               min_num_matches=15)
        mapper = (pkg.IncrementalMapper(cache) if pkg is jmapper
                  else pkg.IncrementalMapper(cache, device="cpu"))
        recon = recon_cls()
        mapper.begin_reconstruction(recon)
        for fid in frames:
            pose = gt.frames[fid].rig_from_world
            recon.frames[fid].rig_from_world = types.Pose(np.array(pose.quat), np.array(pose.t))
            recon.register_frame(fid)
        out.append(mapper)
    return out


def _rig_options(**kw):
    opt = dict(num_rigs=1, num_cameras_per_rig=2, num_frames_per_rig=6, num_points3D=200,
               camera_has_prior_focal_length=True, seed=4)
    opt.update(kw)
    return jsyn.SyntheticDatasetOptions(**opt)


@pytest.mark.parametrize("frames,local", [
    ((1, 2, 3, 4, 5, 6), (5, 6, 9, 3)),  # a subset of the model: the smallest frame fixed
    ((2, 3, 5), (3, 6, 9, 10)),  # every registered frame: none fixed
    ((2, 3, 5), (3, 4, 7, 9)),  # image 7's frame 4 is not registered
])
def test_local_rig_ba_takes_frames(tmp_path, frames, local):
    # The local bundle's image ids map to their registered frames, and the
    # smallest is held constant when the model holds more frames, as
    # colmap_tpu's _rig_local_bundle_adjustment does: the frame set and the
    # constant frame handed to _rig_ba are equal in both packages (image
    # ids, which the port once passed, are not frame ids here).
    calls = []
    for mapper in _registered_mappers(str(tmp_path / "db.db"), frames):
        mapper._find_local_bundle = lambda image_id, options: list(local)
        mapper._rig_ba = lambda frame_ids, ba_options, const_frames=None: calls.append(
            (list(frame_ids), const_frames))
        options = (jmapper if isinstance(mapper, jmapper.IncrementalMapper)
                   else tmapper).IncrementalMapperOptions()
        mapper.local_bundle_adjustment(local[0], options)
    assert len(calls) == 2 and calls[0] == calls[1]
    frame_ids, const = calls[1]
    assert frame_ids == sorted({(i + 1) // 2 for i in local} & set(frames))
    assert const == ([min(frame_ids)] if len(frames) > len(frame_ids) else None)


def _verify_rig_database(tmp_path):
    """The verify rig scene (tests/test_rig_mapper.py:38-45: 1 rig x 2
    cameras x 6 frames x 200 points, seed 4), its rigs and frames emptied and
    rebuilt by rig_configurator from a JSON of the true sensor_from_rig."""
    path = str(tmp_path / "db.db")
    db = tdb.Database(path)
    gt = tsyn.synthesize_dataset(tsyn.SyntheticDatasetOptions(
        num_rigs=1, num_cameras_per_rig=2, num_frames_per_rig=6, num_points3D=200,
        camera_has_prior_focal_length=True, seed=4), db)
    db.close()
    _drop_rigs(path)
    RC.write_rig_config(gt, tmp_path / "rig.json")
    tcli.main(["rig_configurator", "--database_path", path, "--rig_config_path",
               str(tmp_path / "rig.json"), "--device", "cpu"])
    return path, gt


@pytest.mark.parametrize("seed", [3, 4])
def test_initial_pair_takes_the_rig_scale(tmp_path, seed):
    # A two-view initialization of rig frames (2 cameras, the generator's
    # baselines of 0.05 at a distance of 5) has its baseline at 1; the port
    # registers one initial frame again with the scale free, so the distance
    # between the two frames equals the truth's (1e-6 on noise-free data)
    # before the rig BA runs; colmap_tpu leaves it at 1 until the next rig
    # registration.
    from colmap_tpu_torch.scene import database_cache as tcache
    from colmap_tpu_torch.scene.reconstruction import Reconstruction

    path = str(tmp_path / "db.db")
    db = tdb.Database(path)
    gt = tsyn.synthesize_dataset(tsyn.SyntheticDatasetOptions(
        num_rigs=1, num_cameras_per_rig=2, num_frames_per_rig=6, num_points3D=200,
        camera_has_prior_focal_length=True, seed=seed), db)
    db.close()
    cache = tcache.DatabaseCache.create(tdb.Database(path, must_exist=True), min_num_matches=15)
    mapper = tmapper.IncrementalMapper(cache, device="cpu")
    recon = Reconstruction()
    mapper.begin_reconstruction(recon)
    options = tmapper.IncrementalMapperOptions()
    id1, id2, pose21, inliers = mapper.find_initial_image_pair(options)
    assert mapper.register_initial_image_pair(id1, id2, pose21, inliers, options)
    f1, f2 = (recon.images[i].frame_id for i in (id1, id2))

    def dist(r):
        return np.linalg.norm(r.frames[f1].rig_from_world.projection_center()
                              - r.frames[f2].rig_from_world.projection_center())

    assert abs(dist(recon) / dist(gt) - 1.0) < 1e-6
    assert abs(dist(recon) - 1.0) > 0.1


def test_mapper_cli_on_the_verify_rig_scene(tmp_path):
    # The slice as a whole: rig_configurator, then the port's mapper on the
    # CPU; all 6 frames (12 images) registered within the reference's
    # bounds of the ground truth.
    path, gt = _verify_rig_database(tmp_path)
    out = str(tmp_path / "sparse")
    pipe = tcli.main(["mapper", "--database_path", path, "--output_path", out,
                      "--device", "cpu", "--quiet"])
    recon = read_model(out + "/0")
    assert recon.num_reg_frames() == 6
    r = compare_reconstructions(recon, gt)
    assert r["num_common_images"] == 12
    assert r["max_rotation_error_deg"] < MAX_ROT_DEG
    assert r["max_center_error"] < MAX_CENTER
    assert pipe.timer.calls["register"] >= 4


def test_rigid3_and_rotation_helpers():
    # Rigid3 / Sim3 compose, invert and transform as their definitions say;
    # quat_angle, slerp, average_quaternions and rotation_between_vectors
    # against closed forms (1e-12).
    rng = np.random.default_rng(0)
    q = trot.quat_normalize(torch.from_numpy(rng.normal(size=(5, 4))))
    t = torch.from_numpy(rng.normal(size=(5, 3)))
    a, b = rigid3.Rigid3(q, t), rigid3.Rigid3(q.flip(0), t.flip(0))
    X = torch.from_numpy(rng.normal(size=(5, 3)))
    _close(a.compose(b).apply(X).numpy(), a.apply(b.apply(X)).numpy(), 1e-12)
    _close(a.inverse().apply(a.apply(X)).numpy(), X.numpy(), 1e-12)
    s = rigid3.Sim3(torch.full((5,), 2.5, dtype=torch.float64), q, t)
    _close(s.inverse().apply(s.apply(X)).numpy(), X.numpy(), 1e-12)
    cam = s.transform_rigid(b)
    _close(cam.apply(s.apply(X)).numpy(), 2.5 * b.apply(X).numpy(), 1e-12)
    _close(trot.quat_angle(q[0], q[0]).numpy(), 0.0, 1e-7)
    qa = trot.quat_from_axis_angle(torch.tensor([0.0, 0.0, 1.0], dtype=torch.float64), 0.6)
    _close(trot.quat_angle(qa).numpy(), 0.6, 1e-12)
    ident = trot.quat_identity((), torch.float64)
    _close(trot.quat_angle(trot.quat_slerp(ident, qa, 0.25)).numpy(), 0.15, 1e-12)
    _close(trot.average_quaternions(torch.stack([qa, -qa, qa])).numpy(), qa.numpy(), 1e-12)
    v = torch.from_numpy(rng.normal(size=(4, 3)))
    w = torch.from_numpy(rng.normal(size=(4, 3)))
    r = trot.rotation_between_vectors(v, w)
    got = trot.quat_rotate(r, v / v.norm(dim=-1, keepdim=True))
    _close(got.numpy(), (w / w.norm(dim=-1, keepdim=True)).numpy(), 1e-12)
    for fn, args in ((trot.quat_slerp, (ident, qa, 0.3)), (trot.rotation_between_vectors, (v, w))):
        jfn = getattr(jrot, fn.__name__)
        _close(fn(*args).numpy(), np.asarray(jfn(*(jnp.asarray(np.asarray(x)) for x in args))),
               1e-12, fn.__name__)


@pytest.mark.slow
def test_jax_and_port_rig_pipelines_agree(tmp_path):
    # Both packages' incremental pipelines on the verify rig scene's
    # database: all 6 frames in the largest model of each, both within the
    # reference's bounds of the truth (colmap_tpu counts registered frames
    # against images and builds the same model twice; the port once).
    from colmap_tpu.sfm.incremental_pipeline import (
        IncrementalPipeline as JPipeline,
        IncrementalPipelineOptions as JOptions,
    )

    path, gt = _verify_rig_database(tmp_path)
    jmodels = JPipeline(JOptions(min_model_size=4), jdb.Database(path, must_exist=True)).run()
    tmodels = tpipe.IncrementalPipeline(tpipe.IncrementalPipelineOptions(min_model_size=4),
                                        tdb.Database(path, must_exist=True), device="cpu").run()
    assert len(tmodels) == 1 and len(jmodels) >= 1
    jbest = max(jmodels, key=lambda m: m.num_reg_frames())
    tbest = max(tmodels, key=lambda m: m.num_reg_frames())
    assert jbest.num_reg_frames() == tbest.num_reg_frames() == 6
    for recon in (convert.convert_reconstruction(jbest), tbest):
        r = compare_reconstructions(recon, gt)
        assert r["max_rotation_error_deg"] < MAX_ROT_DEG and r["max_center_error"] < MAX_CENTER
