"""The solver loops' kernels K34-K37 (colmap_tpu_torch/kernels/solver.py)
against colmap_tpu, on the CPU in float64.

The same inputs, made from numpy seeds (colmap_tpu's synthetic generators,
carried across with colmap_tpu_torch.convert), go through the JAX
functions and through each kernel's plain version (the wrappers run it on
CPU tensors): K34 (PCG) against _packed_pcg and _pcg, K35 (the LM update)
against _apply_update and lm_step_packed, the device-resident LM loop
against lm_solve_fused_packed, K36 against pose_from_essential_matrix and
refine_relative_pose, K37 against colmap_tpu's five-point solver, pose
recovery and scale formula on injected samples; and the launch bookkeeping
of the CUDA-graph helper the solver loops share (utils/cuda_graph.py), on a
fake kernel module. Tolerances are stated in each test; sums run in another
order than JAX's.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from colmap_tpu.estimators import bundle_adjustment as jba
from colmap_tpu.estimators.relative_pose import refine_relative_pose as j_refine_rel
from colmap_tpu.estimators.solvers import epipolar as je
from colmap_tpu.geometry import essential as jess
from colmap_tpu.geometry import rotation as jrot
from colmap_tpu.scene.synthetic_ba import synthetic_ba_problem as j_synthetic
from colmap_tpu.scene.types import Pose as JPose
from colmap_tpu_torch import convert
from colmap_tpu_torch.estimators import bundle_adjustment as tba
from colmap_tpu_torch.kernels import ba as K
from colmap_tpu_torch.kernels import solver as KS


def _np(x):
    return np.asarray(x)


def _t(x):
    return torch.from_numpy(np.array(x, dtype=np.float64))


def _close(port, ref, tol, name=""):
    """max |port - ref| <= tol * max(1, max |ref|)."""
    port, ref = np.asarray(port, dtype=np.float64), np.asarray(ref, dtype=np.float64)
    assert port.shape == ref.shape, name
    scale = max(1.0, float(np.abs(ref).max(initial=0.0)))
    err = float(np.abs(port - ref).max(initial=0.0))
    assert err <= tol * scale, f"{name}: {err:.3e} > {tol:g} * {scale:.3e}"


def _port_options(opts):
    return convert.options_from_fields(dataclasses.asdict(opts))


def _problem(num_frames, num_points, seed, opts, model_id=2, num_cams=1, near=0):
    """A packed problem (JAX and port forms) with gauge masks; ``num_cams``
    cameras, and with ``near`` > 0 the points moved by 0.05 (seeded noise)
    and the first ``near`` of them to 2% of their distance from the camera
    of their first observation (LM then rejects steps)."""
    jp, _, _ = j_synthetic(num_frames, num_points, 4, model_id=model_id, seed=seed,
                           dtype=jnp.float64)
    d = {k: np.array(v) for k, v in jp._asdict().items()}
    if near:
        d["points"] = d["points"] + np.random.default_rng(0).normal(0, 0.05, d["points"].shape)
    if num_cams > 1:
        rng = np.random.default_rng(seed)
        d["cam_params"] = np.concatenate(
            [d["cam_params"] * (1.0 + 0.01 * k) for k in range(num_cams)])
        d["obs_cam"] = rng.integers(0, num_cams, len(d["obs_cam"])).astype(np.int32)
    for i in range(near):
        o = int(np.flatnonzero(d["obs_point"] == i)[0])
        f0 = d["obs_frame"][o]
        c = JPose(d["quat"][f0], d["t"][f0]).projection_center()
        d["points"][i] = c + 0.02 * (d["points"][i] - c)
    jp = jba.BAProblem(**{k: jnp.asarray(v) for k, v in d.items()})
    jpk, jmaps, _ = jba.pack_problem(jp)
    tpk = convert.problem_from_numpy({k: _np(v) for k, v in jpk._asdict().items()}, "cpu")
    tmaps = tba.PackedMaps(tpk.obs_frame.view(jmaps.frame_pm.shape),
                           tpk.obs_cam.view(jmaps.cam_pm.shape))
    jm = jba.fix_gauge_two_frames(jba.default_masks(jpk, model_id, opts), 0, 1)
    tm = convert.problem_from_numpy({k: _np(v) for k, v in jm._asdict().items()}, "cpu")
    return dict(model_id=model_id, jpk=jpk, jmaps=jmaps, tpk=tpk, tmaps=tmaps, jm=jm, tm=tm)


@pytest.fixture(scope="module")
def step_inputs():
    """One LM step's inputs on a two-camera Cauchy problem: JAX's reduction
    (l.1070-1097) and the port's (K1, K2 plain) at lam = 1e-3."""
    opts = jba.BAOptions(loss="cauchy", pcg_iterations=12)
    pr = _problem(6, 60, 3, opts, num_cams=2)
    jpk, jmaps, model_id = pr["jpk"], pr["jmaps"], pr["model_id"]
    r, Jp, Jc, Jx = jax.jit(jba._obs_jacobians_packed, static_argnums=(1, 2))(jpk, model_id, opts)
    om = jba._packed_obs_masks(jpk, pr["jm"], opts)
    Jp, Jc, Jx = Jp * om.pose[:, None, :], Jc * om.cam[:, None, :], Jx * om.point[:, None, None]
    lam = 1e-3
    F, C = jpk.quat.shape[0], jpk.cam_params.shape[0]
    N, capp = jmaps.frame_pm.shape
    fids, cids = jpk.obs_frame, jpk.obs_cam
    diag_pose = jba._oh_reduce((Jp * Jp).sum(1), fids, F)
    diag_cam = jba._oh_reduce((Jc * Jc).sum(1), cids, C)
    Jx_pm = Jx.reshape(N, capp, 2, 3)
    Hpp = jba._outer2(Jx.reshape(N, capp * 2, 3), Jx.reshape(N, capp * 2, 3))
    Hpp_inv = jba._inv3x3_spd(Hpp + jax.vmap(jnp.diag)(
        lam * jnp.diagonal(Hpp, axis1=-2, axis2=-1) + 1e-12))
    gx = -(Jx_pm * r.reshape(N, capp, 2)[..., None]).sum((1, 2))
    y = (Hpp_inv * gx[:, None, :]).sum(-1)
    v = (Jx_pm * y[:, None, None, :]).sum(-1).reshape(-1, 2)
    gp = -jba._oh_reduce((Jp * r[:, :, None]).sum(1), fids, F)
    gc = -jba._oh_reduce((Jc * r[:, :, None]).sum(1), cids, C)
    bp = gp - jba._oh_reduce((Jp * v[:, :, None]).sum(1), fids, F)
    bc = gc - jba._oh_reduce((Jc * v[:, :, None]).sum(1), cids, C)
    jax_ops = dict(Jp=Jp, Jc=Jc, Jx=Jx, Jx_pm=Jx_pm, Hpp_inv=Hpp_inv, diag_pose=diag_pose,
                   diag_cam=diag_cam, gp=gp, gc=gc, gx=gx, bp=bp, bc=bc)
    tpk, tmaps = pr["tpk"], pr["tmaps"]
    tom = tba._obs_masks(pr["tm"], _port_options(opts))
    J = K.obs_jacobians(*tpk, tom.pose, tom.cam, tom.point, model_id, "cauchy", 1.0)
    lam_t = torch.tensor(lam, dtype=torch.float64)
    red = K.lm_reduce(*J, tmaps.frame_pm, tmaps.cam_pm, F, C, lam_t)
    return dict(pr, opts=opts, lam=lam, lam_t=lam_t, jax=jax_ops, J=J, red=red, F=F, C=C)


@pytest.mark.parametrize("block_jacobi", [True, False], ids=["block_jacobi", "scalar_jacobi"])
def test_k34_pcg_matches_jax(step_inputs, block_jacobi):
    """K34 (plain set-up and 12 steps around K3) against _packed_pcg
    (block-Jacobi, l.986-1036) and _pcg (scalar Jacobi, l.387-432, the one
    colmap_tpu's solve runs): 1e-9 of the step's largest entry."""
    s, j = step_inputs, step_inputs["jax"]
    lam = s["lam"]
    if block_jacobi:
        ops = jba._PackedOperators(j["Jp"], j["Jc"], j["Jx_pm"], j["Hpp_inv"],
                                   lam * j["diag_pose"], lam * j["diag_cam"],
                                   s["jpk"].obs_frame, s["jpk"].obs_cam)
        jdp, jdc = jba._packed_pcg(ops, s["jmaps"], j["bp"], j["bc"], s["opts"])
    else:
        ops = jba._SchurOperators(j["Jp"], j["Jc"], j["Jx"], j["Hpp_inv"],
                                  lam * j["diag_pose"], lam * j["diag_cam"])
        jdp, jdc = jba._pcg(s["jpk"], ops, j["bp"], j["bc"], s["opts"])
    _, Jp, Jc, Jx = s["J"]
    tdp, tdc = tba._pcg(K.PLAIN, Jp, Jc, Jx, s["tmaps"], s["red"], s["lam_t"], block_jacobi,
                        s["opts"].pcg_iterations)
    scale = max(np.abs(_np(jdp)).max(), np.abs(_np(jdc)).max())
    np.testing.assert_allclose(tdp.numpy(), _np(jdp), rtol=0, atol=1e-9 * scale)
    np.testing.assert_allclose(tdc.numpy(), _np(jdc), rtol=0, atol=1e-9 * scale)
    st = KS.pcg_setup_plain(s["red"].Hcc_pose, s["red"].diag_pose, s["red"].diag_cam,
                            s["red"].bp, s["red"].bc, s["lam_t"], block_jacobi)
    assert st.M.shape == (36 * s["F"] + st.x.numel() - 6 * s["F"],)
    assert float(st.rz[0]) > 0 and torch.count_nonzero(st.x) == 0


def test_k34_step_plan():
    """K34's step plan: one warp up to 32 frames, with the smallest instance
    (1, 2 or 4 camera entries a lane) that holds CP camera entries up to
    128; the block (0) past either; the planned wrapper refuses an instance
    too small for its vectors and a tensor that is not on a CUDA device."""
    plan = KS.pcg_step_plan
    assert plan(0, 96) == 4 and plan(0, 129) == 0  # the rig's step, F = 0
    assert plan(8, 4) == plan(4, 4) == plan(8, 8) == plan(32, 32) == 1
    assert plan(32, 33) == 2 and plan(32, 65) == plan(32, 128) == 4
    assert plan(33, 4) == plan(32, 129) == plan(200, 4) == plan(4200, 8) == 0
    for F in range(0, 40):
        for CP in (1, 31, 32, 33, 64, 65, 96, 97, 128, 129):
            k = plan(F, CP)
            if F > 32 or CP > 128:
                assert k == 0
                continue
            assert k in KS.STEP_WARP_CAMS and CP <= 32 * k and (k == 1 or CP > 16 * k)
    m = dict(device="meta")
    z = torch.zeros
    st = KS.PCGState(z(36 * 20 + 4, **m), *(z(124, **m) for _ in range(4)),
                     z(1, dtype=torch.float64, **m))
    with pytest.raises(ValueError, match="no kernel for device"):
        KS.pcg_step(st, z(20, 6, **m), z(1, 4, **m), None, None, None)
    with pytest.raises(ValueError, match="no kernel for device"):
        KS.pcg_step_planned(st, z(20, 6, **m), z(1, 4, **m), None, None, None, 0)
    big = KS.PCGState(z(36 * 40 + 4, **m), *(z(244, **m) for _ in range(4)),
                      z(1, dtype=torch.float64, **m))
    for small, state, F in ((1, big, 40), (3, st, 20), (8, st, 20)):
        with pytest.raises(ValueError, match="no one-warp instance"):
            KS.pcg_step_planned(state, z(F, 6, **m), z(1, 4, **m), None, None, None, small)


def test_k35_candidate_matches_jax(step_inputs):
    """K35's candidate (plain) against _apply_update (l.435) and the
    predicted decrease of l.1137-1146 on a random step: 1e-12."""
    s, j = step_inputs, step_inputs["jax"]
    rng = np.random.default_rng(9)
    F, C = s["F"], s["C"]
    N = s["jpk"].points.shape[0]
    P = s["jpk"].cam_params.shape[1]
    dp, dc, dx = (1e-2 * rng.standard_normal(shape) for shape in ((F, 6), (C, P), (N, 3)))
    jnew = jba._apply_update(s["jpk"], jnp.asarray(dp), jnp.asarray(dc), jnp.asarray(dx))
    lam = s["lam"]
    diag_pt = (j["Jx_pm"] * j["Jx_pm"]).sum((1, 2))
    jpred = 0.5 * (jnp.sum(dp * j["gp"]) + jnp.sum(dc * j["gc"])
                   + jnp.sum(dx * j["gx"]) + lam * jnp.sum(diag_pt * dx * dx)
                   + lam * (jnp.sum(j["diag_pose"] * dp * dp) + jnp.sum(j["diag_cam"] * dc * dc)))
    p = s["tpk"]
    cand, pred = KS.lm_candidate_plain(p.quat, p.t, p.cam_params, p.points, _t(dp), _t(dc),
                                       _t(dx), s["red"], s["lam_t"])
    for name, a, b in zip(("quat", "t", "cam_params", "points"), cand,
                          (jnew.quat, jnew.t, jnew.cam_params, jnew.points)):
        _close(a.numpy(), _np(b), 1e-12, name)
    assert pred.dtype == torch.float64
    assert abs(float(pred) - float(jpred)) <= 1e-12 * abs(float(jpred))


def test_k35_lm_steps_match_jax():
    """lm_step_packed (K1-K3, K34, K35 plain) against colmap_tpu's over 7
    steps on a problem with 12 points at 2% of their distance from a camera:
    two accepted steps, then rejected ones until lam saturates at
    max_lambda = 1e-6. lam, nu and accepted equal; cost and new_cost within
    1e-9 relative."""
    opts = jba.BAOptions(loss="trivial", solver_type="pcg", pcg_iterations=10, max_lambda=1e-6)
    pr = _problem(6, 60, 7, opts, near=12)
    jprob, tprob = pr["jpk"], pr["tpk"]
    jlam, jnu, lam, nu = 1e-12, 2.0, 1e-12, 2.0
    accepted = []
    for _ in range(7):
        jout = jba.lm_step_packed(jprob, pr["jmaps"], pr["model_id"], opts, pr["jm"],
                                  jnp.asarray(jlam), jnp.asarray(jnu))
        tout = tba.lm_step_packed(tprob, pr["tmaps"], pr["model_id"], _port_options(opts),
                                  pr["tm"], lam, nu)
        assert (tout[1], tout[2], tout[5]) == (float(jout[1]), float(jout[2]), bool(jout[5]))
        for k in (3, 4):
            assert abs(tout[k] - float(jout[k])) <= 1e-9 * abs(float(jout[k]))
        accepted.append(tout[5])
        jprob, jlam, jnu = jout[0], jout[1], jout[2]
        tprob, lam, nu = tout[0], tout[1], tout[2]
    assert accepted[:2] == [True, True] and not any(accepted[2:])
    assert lam == opts.max_lambda


@pytest.mark.parametrize("case", ["pcg", "dense_schur", "pcg_saturating"])
def test_device_loop_matches_jax(case, monkeypatch):
    """The device-resident loop (_lm_loop: K1-K4, K34, K35, the done flag)
    on the CPU against lm_solve_fused_packed: the same iteration count and
    the final cost within 1e-9 relative, stopping on the function tolerance
    (10 frames x 300 points) or on lam saturation (the problem of
    test_k35_lm_steps_match_jax). colmap_tpu's dense path builds its Schur
    matrix from bfloat16 operands by default (l.1561-1569), which moves
    its steps by ~1e-3; it runs here with use_bf16=False, as in
    test_torch_ba.py's K4 test, through a fresh jit of the fused solve."""
    solver = "pcg" if case.startswith("pcg") else "dense_schur"
    if case == "pcg_saturating":
        opts = jba.BAOptions(max_iterations=30, pcg_iterations=10, solver_type=solver,
                             max_lambda=1e-6)
        pr = _problem(6, 60, 7, opts, near=12)
    else:
        opts = jba.BAOptions(max_iterations=30, pcg_iterations=20, solver_type=solver)
        pr = _problem(10, 300, 11, opts)
    jsolve = jba.lm_solve_fused_packed
    if solver == "dense_schur":
        monkeypatch.setattr(jba, "_dense_schur_solve",
                            functools.partial(jba._dense_schur_solve, use_bf16=False))
        jsolve = jax.jit(jba._lm_solve_fused_packed, static_argnums=(2, 3))
    _, jcost, jits = jsolve(pr["jpk"], pr["jmaps"], pr["model_id"], opts, pr["jm"])
    out, tcost, tits = tba.lm_solve_fused_packed(pr["tpk"], pr["tmaps"], pr["model_id"],
                                                 _port_options(opts), pr["tm"])
    assert tits == int(jits) and 1 < tits < opts.max_iterations
    assert abs(tcost - float(jcost)) <= 1e-9 * float(jcost)
    assert torch.equal(pr["tpk"].quat, convert.problem_from_numpy(
        {k: _np(v) for k, v in pr["jpk"]._asdict().items()}, "cpu").quat)  # input untouched


def test_lm_iterations_after_done_are_frozen():
    """Once K35 sets done, further iterations (the rest of a chunk between
    two reads of the flag) leave the state, lam and the scalars bit for
    bit as they were."""
    opts = tba.BAOptions(max_iterations=40, pcg_iterations=20, function_tolerance=1e-4)
    pr = _problem(8, 120, 5, jba.BAOptions())
    p, maps, model_id = pr["tpk"], pr["tmaps"], pr["model_id"]
    state, sc, groups = tba._start(p, model_id, opts, opts.initial_lambda, 2.0, K.KERNELS)
    obs_masks = tba._obs_masks(pr["tm"], opts)

    def step():
        tba._lm_iteration(state, maps, model_id, opts, obs_masks, sc, K.KERNELS, False, True,
                          groups)

    for _ in range(opts.max_iterations):
        step()
        if sc.done.item():
            break
    assert sc.done.item() == 1 and 1 < sc.S[3].item() < opts.max_iterations
    before = [x.clone() for x in (state.quat, state.t, state.cam_params, state.points,
                                  sc.lam, sc.S)]
    for _ in range(3):
        step()
    after = (state.quat, state.t, state.cam_params, state.points, sc.lam, sc.S)
    for name, a, b in zip(("quat", "t", "cam_params", "points", "lam", "S"), before, after):
        if name == "S":  # the copy flag is cleared; nothing else moves
            a[6] = 0.0
        assert torch.equal(a, b), name


def _two_view_problem(seed, n, R, t, noise=0.0):
    rng = np.random.default_rng(seed)
    X = rng.uniform(-1, 1, (n, 3)) + np.array([0, 0, 5.0])
    x1 = X[:, :2] / X[:, 2:]
    X2 = X @ R.T + t
    x2 = X2[:, :2] / X2[:, 2:] + noise * rng.normal(size=(n, 2))
    return x1, x2


def _rotation(axis, angle):
    return np.asarray(jrot.quat_to_rotmat(jrot.quat_from_axis_angle(jnp.asarray(axis), angle)))


# Relative poses whose E's decompositions win at different candidates.
POSES = [((0.1, 1.0, 0.2), 0.2, (-1.0, 0.1, 0.2)), ((1.0, 0.2, 0.0), -0.3, (0.8, -0.4, 0.3)),
         ((0.0, 0.3, 1.0), 0.5, (0.2, 1.0, -0.1)), ((0.5, -1.0, 0.3), -0.15, (-0.3, -0.2, -1.0))]


def test_k36_cheirality_matches_jax():
    """K36's cheirality entry (plain) on four problems in CSR order against
    pose_from_essential_matrix per problem: R, t, points, count and mask to
    1e-9 (LAPACK's SVD on both sides). The first problem's last rows are
    masked out (padding), and the winners span at least two of the four
    candidates (the twisted pairs (R2, .) win too)."""
    xs, Es, masks = [], [], []
    for k, (axis, angle, tt) in enumerate(POSES):
        R, tt = _rotation(axis, angle), np.asarray(tt)
        x1, x2 = _two_view_problem(20 + k, 60, R, tt, noise=1e-3)
        Es.append(np.asarray(jess.cross_product_matrix(jnp.asarray(tt / np.linalg.norm(tt)))) @ R)
        mask = np.ones(len(x1), dtype=bool)
        if k == 0:
            mask[-7:] = False
        xs.append((x1, x2))
        masks.append(mask)
    offsets = np.concatenate([[0], np.cumsum([len(x1) for x1, _ in xs])]).tolist()
    out = KS.poses_from_essentials(_t(np.stack(Es)), _t(np.concatenate([a for a, _ in xs])),
                                   _t(np.concatenate([b for _, b in xs])),
                                   torch.from_numpy(np.concatenate(masks)), offsets)
    winners = set()
    for k, E in enumerate(Es):
        lo, hi = offsets[k], offsets[k + 1]
        ref = jax.jit(jess.pose_from_essential_matrix)(
            jnp.asarray(E), jnp.asarray(xs[k][0]), jnp.asarray(xs[k][1]), jnp.asarray(masks[k]))
        got = (out[0][k], out[1][k], out[2][lo:hi], out[3][k], out[4][lo:hi])
        for name, a, b in zip(("R", "t", "X", "count", "ok"), got, ref):
            np.testing.assert_allclose(np.asarray(a, dtype=np.float64),
                                       np.asarray(b, dtype=np.float64), atol=1e-9, err_msg=name)
        R1, R2, t = (_np(x) for x in jess.decompose_essential_matrix(jnp.asarray(E)))
        cands = [(R1, t), (R2, t), (R1, -t), (R2, -t)]
        winners.add(next(i for i, (Rc, tc) in enumerate(cands)
                         if np.allclose(Rc, _np(ref[0])) and np.allclose(tc, _np(ref[1]))))
        assert int(out[3][k]) == int(masks[k].sum())
    assert len(winners) >= 2


def test_k36_refine_matches_jax():
    """K36's refinement entry (plain) on three candidates in one call (two
    pairs, different starts and inlier weights) against refine_relative_pose
    per candidate: 1e-9."""
    cands, xs = [], []
    for k, (axis, angle, tt) in enumerate(POSES[:3]):
        R, tt = _rotation(axis, angle), np.asarray(tt)
        x1, x2 = _two_view_problem(40 + k, 150, R, tt, noise=2e-4)
        q0 = np.asarray(jrot.rotmat_to_quat(jnp.asarray(R))) + np.array([0.0, 0.01, -0.01, 0.005])
        w = (np.random.default_rng(k).random(150) > 0.1 * k).astype(float)
        cands.append((q0 / np.linalg.norm(q0), tt + 0.05, w))
        xs.append((x1, x2))
    offsets = [0, 150, 300, 450]
    q, t, rms = KS.refine_relative_poses(
        _t([c[0] for c in cands]), _t([c[1] for c in cands]),
        _t(np.concatenate([x[0] for x in xs])), _t(np.concatenate([x[1] for x in xs])),
        _t(np.concatenate([c[2] for c in cands])), offsets)
    for k, (q0, t0, w) in enumerate(cands):
        jq, jt, jrms = j_refine_rel(jnp.asarray(q0), jnp.asarray(t0), jnp.asarray(xs[k][0]),
                                    jnp.asarray(xs[k][1]), jnp.asarray(w))
        for name, a, b in zip(("q", "t", "rms"), (q[k], t[k], rms[k]), (jq, jt, jrms)):
            np.testing.assert_allclose(a.numpy(), _np(b), atol=1e-9, err_msg=name)


def _structure_less_scene(seed=4, n=600):
    """tests/test_torch_sfm.py's structure-less scene: a new camera against
    three registered ones, 0.5 px noise, 20% outliers, f = 800."""
    rng = np.random.default_rng(seed)
    X = rng.uniform(-1, 1, (n, 3)) + np.array([0, 0, 5.0])
    f = 800.0

    def pose(angle, t):
        axis = np.array([0.3, 1.0, 0.1]) / np.linalg.norm([0.3, 1.0, 0.1])
        return JPose(np.concatenate([[np.cos(angle / 2)], np.sin(angle / 2) * axis]),
                     np.asarray(t, dtype=np.float64))

    def project(p):
        P = p.apply(X)
        return P[:, :2] / P[:, 2:]

    world = [pose(0.0, [0, 0, 0]), pose(0.15, [-0.8, 0.1, 0.1]), pose(-0.12, [0.7, -0.1, 0.05])]
    cam_idx = np.arange(n) % 3
    uv = project(pose(0.08, [0.4, 0.2, -0.1])) + rng.normal(0, 0.5 / f, (n, 2))
    bad = rng.random(n) < 0.2
    uv[bad] = rng.uniform(-0.4, 0.4, (bad.sum(), 2))
    uv_w = np.stack([project(world[c])[i] for i, c in enumerate(cam_idx)])
    Rw = np.stack([p.rotmat() for p in world])
    tw = np.stack([p.t for p in world])
    return (uv, uv_w, cam_idx, Rw, tw, np.full(n, f)), bad


def _jax_structure_less_models(uv, uv_w, cam_idx, Rw, tw, cams, idx5, r1):
    """colmap_tpu's solve_one (generalized_pose.py:593-634): its five-point
    solver and pose_from_essential_matrix, the scale formula in float64."""
    Es = np.asarray(jax.jit(jax.vmap(je.essential_five_point))(jnp.asarray(uv_w[idx5]),
                                                               jnp.asarray(uv[idx5])))

    def pose_of(E, x_w, x_n):
        R, t, _, count, _ = jess.pose_from_essential_matrix(E, x_w, x_n,
                                                            mask=jnp.ones(5, dtype=bool))
        return R, t, count

    pose = jax.jit(jax.vmap(jax.vmap(pose_of, in_axes=(0, None, None))))
    Rs, ts, counts = (np.asarray(x) for x in pose(jnp.asarray(Es), jnp.asarray(uv_w[idx5]),
                                                   jnp.asarray(uv[idx5])))
    models = np.full((len(cams), 10, 3, 4), np.nan)
    for k in range(len(cams)):
        c, s_ = cams[k], r1[k]
        x1s, x2s = np.append(uv_w[s_], 1.0), np.append(uv[s_], 1.0)
        for m in range(10):
            if not (np.isfinite(Es[k, m]).all() and counts[k, m] >= 4):
                continue
            R_new = Rs[k, m] @ Rw[c]
            t_base = Rs[k, m] @ tw[c]
            R_ns = R_new @ Rw[cam_idx[s_]].T
            a = t_base - R_ns @ tw[cam_idx[s_]]
            Rx1 = R_ns @ x1s
            c0, c1 = x2s @ np.cross(a, Rx1), x2s @ np.cross(ts[k, m], Rx1)
            s = -c0 / (1e-12 if abs(c1) < 1e-12 else c1)
            if abs(c1) > 1e-10 and s > 1e-8 and cam_idx[s_] != c:
                models[k, m] = np.concatenate([R_new, (t_base + s * ts[k, m])[:, None]], axis=1)
    return models.reshape(-1, 3, 4)


def _jax_sampson_px(models, uv, uv_w, cam_idx, Rw, tw, focal):
    """generalized_pose.py per_model (l.640-660) in float64 numpy."""
    x1h = np.concatenate([uv_w, np.ones((len(uv), 1))], axis=1)
    x2h = np.concatenate([uv, np.ones((len(uv), 1))], axis=1)
    out = []
    for M in models:
        R_rel = np.einsum("ab,ncb->nac", M[:, :3], Rw[cam_idx])
        t_rel = M[:, 3] - np.einsum("nab,nb->na", R_rel, tw[cam_idx])
        E = np.asarray(jess.cross_product_matrix(jnp.asarray(t_rel))) @ R_rel
        Ex1 = np.einsum("nij,nj->ni", E, x1h)
        Etx2 = np.einsum("nji,nj->ni", E, x2h)
        num = np.sum(x2h * Ex1, axis=1) ** 2
        den = Ex1[:, 0] ** 2 + Ex1[:, 1] ** 2 + Etx2[:, 0] ** 2 + Etx2[:, 1] ** 2
        out.append(num / np.maximum(den, 1e-12) * focal**2)
    return np.stack(out)


def test_k37_score_matches_jax_on_injected_samples():
    """K37's score entry (plain) on 16 injected samples (some scale rows on
    the sample's own camera, which colmap_tpu rejects) against colmap_tpu's
    five-point solver, pose_from_essential_matrix and scale formula: the
    same valid slots, models within 1e-6, support counts equal, the packed
    best that of the first largest count; the inlier entry equals the
    residual test of the best model."""
    (uv, uv_w, cam_idx, Rw, tw, focal), bad = _structure_less_scene()
    rng = np.random.default_rng(12)
    cams = rng.integers(0, 3, 16)
    idx5 = np.stack([rng.choice(np.flatnonzero((cam_idx == c) & ~bad), 5, replace=False)
                     for c in cams])
    r1 = rng.choice(np.flatnonzero(~bad), 16)
    r1[:3] = idx5[:3, 0]  # scale rows on the sample's own camera
    max_sq = 36.0
    args = tuple(_t(x) for x in (uv, uv_w)) + (torch.from_numpy(cam_idx.astype(np.int32)),
                                               _t(Rw), _t(tw), _t(focal))
    models, counts, best = KS.structure_less_score(
        *args, *(torch.from_numpy(x.astype(np.int32)) for x in (cams, idx5, r1)), max_sq)
    ref = _jax_structure_less_models(uv, uv_w, cam_idx, Rw, tw, cams, idx5, r1)
    valid = np.isfinite(ref).all((1, 2))
    assert valid.sum() >= 16 and not valid[:30].any()
    np.testing.assert_array_equal(torch.isfinite(models).all(-1).all(-1).numpy(), valid)
    np.testing.assert_allclose(models.numpy()[valid], ref[valid], atol=1e-6)
    support = (_jax_sampson_px(ref[valid], uv, uv_w, cam_idx, Rw, tw, focal) <= max_sq).sum(1)
    np.testing.assert_array_equal(counts.numpy()[valid], support)
    assert (counts.numpy()[~valid] == 0).all()
    top = int(np.argmax(counts.numpy()))
    assert int(best[0]) == (int(counts[top]) << 32) | (0xFFFFFFFF - top)
    inl = KS.structure_less_inliers(*args, models[top], max_sq)
    res = _jax_sampson_px(ref[top][None], uv, uv_w, cam_idx, Rw, tw, focal)[0]
    np.testing.assert_array_equal(inl.numpy(), res <= max_sq)


def test_solver_wrappers_never_fall_back_off_the_cpu():
    """A tensor neither on the CPU nor on a CUDA device gets no plain
    version: K34-K37's wrappers raise."""
    m = dict(device="meta")
    z = torch.zeros
    with pytest.raises(ValueError, match="no kernel for device"):
        KS.pcg_setup(z(1, 6, 6, **m), z(1, 6, **m), z(1, 4, **m), z(1, 6, **m), z(1, 4, **m),
                     z((), **m), True)
    with pytest.raises(ValueError, match="no kernel for device"):
        KS.lm_accept(z((), **m), z(9, dtype=torch.float64, **m), None, None, (), (), 0, 1, 0,
                     None)
    with pytest.raises(ValueError, match="no kernel for device"):
        KS.poses_from_essentials(z(1, 3, 3, **m), z(4, 2, **m), z(4, 2, **m),
                                 z(4, dtype=torch.bool, **m), [0, 4])
    with pytest.raises(ValueError, match="no kernel for device"):
        KS.structure_less_inliers(z(4, 2, **m), z(4, 2, **m), z(4, dtype=torch.int32, **m),
                                  z(2, 3, 3, **m), z(2, 3, **m), z(4, **m), z(3, 4, **m), 1.0)


def test_graph_recording_moves_launch_counts_to_each_replay():
    # utils/cuda_graph.py's bookkeeping, which the packed and rig LM loops
    # and both global CG loops share, with a fake kernel module and a graph
    # that records nothing: recording runs the step between capture_begin
    # (thread-local mode) and capture_end and takes back the launches it
    # counted; each replay adds them again; a disabled StepGraph runs its
    # step eagerly every time.
    from colmap_tpu_torch.utils import cuda_graph

    class FakeKernels:
        LAUNCHES = {"k_a": 0, "k_b": 5}

    class NoOpGraph:
        def __init__(self):
            self.events = []

        def capture_begin(self, capture_error_mode=None):
            self.events.append(("begin", capture_error_mode))

        def capture_end(self):
            self.events.append("end")

        def replay(self):
            self.events.append("replay")

    def step():
        FakeKernels.LAUNCHES["k_a"] += 3
        return "out"

    graph = NoOpGraph()
    replay, out, seconds = cuda_graph.record(step, graph, (FakeKernels,))
    assert out == "out" and seconds >= 0.0
    assert FakeKernels.LAUNCHES == {"k_a": 0, "k_b": 5}
    assert graph.events == [("begin", "thread_local"), "end"]
    replay()
    replay()
    assert FakeKernels.LAUNCHES == {"k_a": 6, "k_b": 5}
    assert graph.events[2:] == ["replay", "replay"]
    eager = cuda_graph.StepGraph(step, torch.device("cpu"), (FakeKernels,), False)
    assert eager() == eager() == "out"
    assert eager.replay is None and FakeKernels.LAUNCHES["k_a"] == 12
