"""colmap_tpu_torch bundle adjustment against colmap_tpu's, on the CPU in float64.

The same problem, made from a numpy seed by colmap_tpu's generator and
carried across with colmap_tpu_torch.convert, goes through the JAX functions
and through the port: each kernel's plain version (the wrappers run it on
CPU tensors) against the JAX intermediates it replaces, then the packed
solvers, ``solve`` and the bundle_adjuster CLI. Sums are taken in another
order than in JAX, so kernel-level tolerances are stated relative to the
largest entry of each array.
"""

import ast
import dataclasses
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from colmap_tpu.cli.main import main as jax_cli
from colmap_tpu.estimators import bundle_adjustment as jba
from colmap_tpu.scene import reconstruction_io as jio
from colmap_tpu.scene.synthetic import SyntheticDatasetOptions, synthesize_dataset
from colmap_tpu.scene.synthetic_ba import synthetic_ba_problem as j_synthetic
from colmap_tpu_torch import convert
from colmap_tpu_torch.cli.main import main as port_cli
from colmap_tpu_torch.estimators import bundle_adjustment as tba
from colmap_tpu_torch.estimators.ba_setup import problem_from_reconstruction
from colmap_tpu_torch.kernels import ba as K
from colmap_tpu_torch.scene import reconstruction_io as tio
from colmap_tpu_torch.utils.dtypes import resolve_device

REPO = pathlib.Path(__file__).resolve().parent.parent
LOSSES = ["trivial", "huber", "cauchy"]


def _np(x):
    return np.asarray(x)


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(port, ref, tol, name=""):
    """max |port - ref| <= tol * max(1, max |ref|)."""
    port, ref = np.asarray(port), np.asarray(ref)
    assert port.shape == ref.shape, name
    scale = max(1.0, float(np.abs(ref).max(initial=0.0)))
    err = float(np.abs(port - ref).max(initial=0.0))
    assert err <= tol * scale, f"{name}: {err:.3e} > {tol:g} * {scale:.3e}"


def _port_options(opts):
    return convert.options_from_fields(dataclasses.asdict(opts))


def _problem(model_id, seed, num_cams=1, long_track=0):
    """A small packed problem with one point behind a camera, one NaN
    measurement, (optionally) several cameras and (optionally) point 1 seen
    ``long_track`` more times; JAX and port forms."""
    jp, _, _ = j_synthetic(6, 40, 4, model_id=model_id, seed=seed, dtype=jnp.float64)
    d = {k: np.array(v) for k, v in jp._asdict().items()}
    f0 = d["obs_frame"][0]
    R = np.asarray(jax.device_get(jp.quat[f0]))
    from colmap_tpu.scene.types import Pose

    center = Pose(R, d["t"][f0]).projection_center()
    d["points"][0] = 2.0 * center - d["points"][0]  # behind frame f0
    d["obs_xy"][5] = np.nan
    rng = np.random.default_rng(seed)
    if num_cams > 1:
        d["cam_params"] = np.concatenate(
            [d["cam_params"] * (1.0 + 0.01 * k) for k in range(num_cams)])
        d["obs_cam"] = rng.integers(0, num_cams, len(d["obs_cam"])).astype(np.int32)
    if long_track:
        o = int(np.flatnonzero(d["obs_point"] == 1)[0])
        extra = {k: np.repeat(v[o:o + 1], long_track, axis=0) for k, v in d.items()
                 if k.startswith("obs_")}
        extra["obs_frame"] = (np.arange(long_track) % len(d["quat"])).astype(np.int32)
        extra["obs_xy"] = extra["obs_xy"] + rng.normal(0.0, 2.0, (long_track, 2))
        for k, v in extra.items():
            d[k] = np.concatenate([d[k], v])
    jp = jba.BAProblem(**{k: jnp.asarray(v) for k, v in d.items()})
    jpk, jmaps, _ = jba.pack_problem(jp)
    tpk = convert.problem_from_numpy({k: _np(v) for k, v in jpk._asdict().items()}, "cpu")
    tmaps = tba.PackedMaps(tpk.obs_frame.view(jmaps.frame_pm.shape),
                           tpk.obs_cam.view(jmaps.cam_pm.shape))
    return jpk, jmaps, tpk, tmaps


def _masks(jpk, model_id, opts):
    jm = jba.default_masks(jpk, model_id, opts, const_points=[3])
    jm = jba.fix_gauge_two_frames(jm, 0, 1)
    tm = convert.problem_from_numpy({k: _np(v) for k, v in jm._asdict().items()}, "cpu")
    return jm, tm


def _jax_jacobians(jpk, jm, model_id, opts):
    r, Jp, Jc, Jx = jba._obs_jacobians_packed(jpk, model_id, opts)
    om = jba._packed_obs_masks(jpk, jm, opts)
    return r, Jp * om.pose[:, None, :], Jc * om.cam[:, None, :], Jx * om.point[:, None, None]


@pytest.mark.parametrize("loss", LOSSES)
@pytest.mark.parametrize("model_id", range(5))
def test_k1_obs_jacobians_matches_jax(model_id, loss):
    """K1 (plain) vs _obs_jacobians_packed with the masks applied: atol 1e-9.
    The problem holds a point behind a camera (the residual skips the
    cheirality test) and a NaN measurement (the finite mask zeroes its row)."""
    jpk, _, tpk, _ = _problem(model_id, seed=10 + model_id)
    opts = jba.BAOptions(loss=loss, loss_scale=2.0, refine_principal_point=model_id % 2 == 0)
    jm, tm = _masks(jpk, model_id, opts)
    jr = _jax_jacobians(jpk, jm, model_id, opts)
    om = tba._obs_masks(tm, _port_options(opts))
    p = tpk
    tr = K.obs_jacobians(p.quat, p.t, p.cam_params, p.points, p.obs_frame, p.obs_cam,
                         p.obs_point, p.obs_xy, p.obs_w, om.pose, om.cam, om.point,
                         model_id, loss, 2.0)
    for name, a, b in zip(("r", "Jp", "Jc", "Jx"), tr, jr):
        np.testing.assert_allclose(a.numpy(), _np(b), rtol=0, atol=1e-9, err_msg=name)
    assert np.all(tr[0].numpy()[jpk.obs_xy.shape[0] and np.isnan(_np(jpk.obs_xy)).any(1)] == 0)
    jcost = float(jba.compute_cost_packed(jpk, model_id, opts))
    tcost = float(tba.compute_cost_packed(tpk, model_id, _port_options(opts)))
    assert abs(tcost - jcost) <= 1e-9 * max(1.0, abs(jcost))


def _reduced(long_track=0):
    """JAX intermediates of one LM step (l.1070-1097 of bundle_adjustment.py)
    on a two-camera problem, and the port's inputs."""
    model_id, lam = 2, 1e-3
    jpk, jmaps, tpk, tmaps = _problem(model_id, seed=3, num_cams=2, long_track=long_track)
    opts = jba.BAOptions(loss="cauchy")
    jm, _ = _masks(jpk, model_id, opts)
    r, Jp, Jc, Jx = _jax_jacobians(jpk, jm, model_id, opts)
    F, C = jpk.quat.shape[0], jpk.cam_params.shape[0]
    N, capp = jmaps.frame_pm.shape
    fids, cids = jpk.obs_frame, jpk.obs_cam
    gp = -jba._oh_reduce((Jp * r[:, :, None]).sum(1), fids, F)
    gc = -jba._oh_reduce((Jc * r[:, :, None]).sum(1), cids, C)
    diag_pose = jba._oh_reduce((Jp * Jp).sum(1), fids, F)
    diag_cam = jba._oh_reduce((Jc * Jc).sum(1), cids, C)
    Jx_pm = Jx.reshape(N, capp, 2, 3)
    gx = -(Jx_pm * r.reshape(N, capp, 2)[..., None]).sum((1, 2))
    Hpp = jba._outer2(Jx.reshape(N, capp * 2, 3), Jx.reshape(N, capp * 2, 3))
    diag_pt = jnp.diagonal(Hpp, axis1=-2, axis2=-1)
    Hpp_inv = jba._inv3x3_spd(Hpp + jax.vmap(jnp.diag)(lam * diag_pt + 1e-12))
    y = (Hpp_inv * gx[:, None, :]).sum(-1)
    v = (Jx_pm * y[:, None, None, :]).sum(-1).reshape(-1, 2)
    bp = gp - jba._oh_reduce((Jp * v[:, :, None]).sum(1), fids, F)
    bc = gc - jba._oh_reduce((Jc * v[:, :, None]).sum(1), cids, C)
    Hcc_pose = jba._oh_reduce(jba._outer2(Jp, Jp).reshape(-1, 36), fids, F).reshape(F, 6, 6)
    jax_red = dict(gp=gp, gc=gc, bp=bp, bc=bc, diag_pose=diag_pose, diag_cam=diag_cam,
                   Hcc_pose=Hcc_pose, gx=gx, Hpp_inv=Hpp_inv, diag_pt=diag_pt)
    J = tuple(_t(x) for x in (r, Jp, Jc, Jx))
    return dict(model_id=model_id, lam=lam, jpk=jpk, jmaps=jmaps, tmaps=tmaps, F=F, C=C,
                jax_J=(r, Jp, Jc, Jx), J=J, jax_red=jax_red,
                red=K.lm_reduce(*J, tmaps.frame_pm, tmaps.cam_pm, F, C,
                                torch.tensor(lam, dtype=torch.float64)))


@pytest.fixture(scope="module")
def reduced():
    return _reduced()


def test_k2_lm_reduce_matches_jax(reduced):
    """K2 (plain) vs the JAX step's sums: 1e-9 of each array's largest entry."""
    for name in K.LMReduction._fields:
        _close(getattr(reduced["red"], name).numpy(), _np(reduced["jax_red"][name]), 1e-9, name)


def test_k3_schur_matvec_matches_jax(reduced):
    """K3 (plain) vs _packed_matvec and the back-substitution (l.1113-1120):
    1e-9 of each array's largest entry."""
    jr, lam = reduced["jax_red"], reduced["lam"]
    r, Jp, Jc, Jx = reduced["jax_J"]
    jmaps, jpk = reduced["jmaps"], reduced["jpk"]
    N, capp = jmaps.frame_pm.shape
    rng = np.random.default_rng(5)
    xp = rng.standard_normal((reduced["F"], 6))
    xc = rng.standard_normal((reduced["C"], Jc.shape[-1])) * 1e-3
    ops = jba._PackedOperators(Jp, Jc, Jx.reshape(N, capp, 2, 3), jr["Hpp_inv"],
                               lam * jr["diag_pose"], lam * jr["diag_cam"],
                               jpk.obs_frame, jpk.obs_cam)
    jp_out, jc_out = jba._packed_matvec(ops, jmaps, jnp.asarray(xp), jnp.asarray(xc))
    tm, red = reduced["tmaps"], reduced["red"]
    tp_out, tc_out = K.schur_matvec(*reduced["J"][1:], tm.frame_pm, tm.cam_pm, red.Hpp_inv,
                                    _t(xp), _t(xc))
    _close(tp_out.numpy() + lam * red.diag_pose.numpy() * xp, _np(jp_out), 1e-9, "out_p")
    _close(tc_out.numpy() + lam * red.diag_cam.numpy() * xc, _np(jc_out), 1e-9, "out_c")

    u = (Jp * jba._oh_fetch(jnp.asarray(xp), jpk.obs_frame)[:, None, :]).sum(-1) + (
        Jc * jba._oh_fetch(jnp.asarray(xc), jpk.obs_cam)[:, None, :]).sum(-1)
    w = (Jx.reshape(N, capp, 2, 3) * u.reshape(N, capp, 2)[..., None]).sum((1, 2))
    jdx = (jr["Hpp_inv"] * (jr["gx"] - w)[:, None, :]).sum(-1)
    tdx = K.back_substitute(*reduced["J"][1:], tm.frame_pm, tm.cam_pm, red.Hpp_inv, red.gx,
                            _t(xp), _t(xc))
    _close(tdx.numpy(), _np(jdx), 1e-9, "dx")


def _dense_reference(reduced):
    """S + λ-damping and its solution from the textbook formula in float64
    numpy: J stacked densely over (poses, cameras, points), H = JᵀJ,
    S = H_cc - H_cp H_pp⁻¹ H_pc with the damped 3x3 point blocks."""
    r, Jp, Jc, Jx = (_np(x) for x in reduced["jax_J"])
    jpk, lam, F, C = reduced["jpk"], reduced["lam"], reduced["F"], reduced["C"]
    P = Jc.shape[-1]
    N = jpk.points.shape[0]
    D = 6 * F + C * P
    fids, cids, pids = (_np(x) for x in (jpk.obs_frame, jpk.obs_cam, jpk.obs_point))
    J = np.zeros((2 * len(fids), D + 3 * N))
    for s, (f, c, p) in enumerate(zip(fids, cids, pids)):
        J[2 * s:2 * s + 2, 6 * f:6 * f + 6] = Jp[s]
        J[2 * s:2 * s + 2, 6 * F + P * c:6 * F + P * c + P] = Jc[s]
        J[2 * s:2 * s + 2, D + 3 * p:D + 3 * p + 3] = Jx[s]
    H = J.T @ J
    Hpp_inv = np.zeros((3 * N, 3 * N))
    for p in range(N):
        blk = H[D + 3 * p:D + 3 * p + 3, D + 3 * p:D + 3 * p + 3]
        blk = blk + np.diag(lam * np.diag(blk) + 1e-12)
        if abs(np.linalg.det(blk)) > 1e-12:
            Hpp_inv[3 * p:3 * p + 3, 3 * p:3 * p + 3] = np.linalg.inv(blk)
    Hcp = H[:D, D:]
    S = H[:D, :D] - Hcp @ Hpp_inv @ Hcp.T
    S += np.diag(lam * np.diag(H[:D, :D]) + 1e-10)
    g = -J.T @ r.reshape(-1)
    b = g[:D] - Hcp @ Hpp_inv @ g[D:]
    return S, np.linalg.solve(S, b)


def test_k4_dense_schur_matches_jax(reduced):
    """K4 (plain) + Cholesky against the float64 Schur complement and its
    solution (1e-9 of the largest S entry, 1e-8 of the largest step entry),
    and against _dense_schur_solve(use_bf16=False), which accumulates
    S_corr in float32 (bundle_adjustment.py:1561-1569): 1e-4 of the largest
    step entry."""
    _check_k4(reduced)


def test_k4_dense_schur_long_track_matches_jax():
    """As test_k4_dense_schur_matches_jax, with point 1 seen 40 more times
    (capp 44 while most points have 4 observations): the pairs of one
    point's real slots are all summed, and padding adds nothing."""
    red = _reduced(long_track=40)
    assert red["tmaps"].frame_pm.shape[1] >= 44
    _check_k4(red)


def _check_k4(reduced):
    jr, lam = reduced["jax_red"], reduced["lam"]
    r, Jp, Jc, Jx = reduced["jax_J"]
    tm, red = reduced["tmaps"], reduced["red"]
    lam_diag = torch.cat([lam * red.diag_pose.reshape(-1), lam * red.diag_cam.reshape(-1)])
    S = K.dense_schur_assemble(*reduced["J"][1:], tm.frame_pm, tm.cam_pm, red.Hpp_inv,
                               lam_diag, reduced["F"])
    tdp, tdc = tba._dense_schur_solve(S, red.bp, red.bc)
    d = np.concatenate([tdp.numpy().reshape(-1), tdc.numpy().reshape(-1)])
    S_ref, d_ref = _dense_reference(reduced)
    _close(S.numpy(), S_ref, 1e-9, "S")
    np.testing.assert_allclose(d, d_ref, rtol=0, atol=1e-8 * np.abs(d_ref).max())

    jdp, jdc = jba._dense_schur_solve(
        reduced["jpk"], reduced["jmaps"], Jp, Jc, Jx, jr["Hpp_inv"], lam * jr["diag_pose"],
        lam * jr["diag_cam"], jr["bp"], jr["bc"], use_bf16=False)
    d_jax = np.concatenate([_np(jdp).reshape(-1), _np(jdc).reshape(-1)])
    np.testing.assert_allclose(d, d_jax, rtol=0, atol=1e-4 * np.abs(d_jax).max())


@pytest.fixture(scope="module")
def slice_problem():
    jp, _, model_id = j_synthetic(30, 2000, 6, seed=0, dtype=jnp.float64)
    tp = convert.problem_from_numpy({k: _np(v) for k, v in jp._asdict().items()}, "cpu")
    return jp, tp, model_id


@pytest.mark.parametrize("entry", ["solve_packed/dense_schur", "solve_packed/pcg", "solve"])
def test_solvers_match_jax(slice_problem, entry):
    """The whole slice, 30 frames x 2000 points: final cost rtol 1e-6,
    parameters atol 1e-6 (camera parameters also rtol 1e-6: the focal length
    is 1280 px and colmap_tpu's dense Schur path builds Q in bfloat16), the
    same number of LM iterations."""
    jp, tp, model_id = slice_problem
    solver = entry.split("/")[-1] if "/" in entry else "auto"
    opts = jba.BAOptions(max_iterations=10, pcg_iterations=20, solver_type=solver)
    jm = jba.fix_gauge_two_frames(jba.default_masks(jp, model_id, opts), 0, 1)
    tm = convert.problem_from_numpy({k: _np(v) for k, v in jm._asdict().items()}, "cpu")
    if entry == "solve":
        js, jsum = jba.solve(jp, model_id, opts, jm)
        ts, tsum = tba.solve(tp, model_id, _port_options(opts), tm)
    else:
        js, jsum = jba.solve_packed(jp, model_id, opts, jm, bucket_shapes=False)
        ts, tsum = tba.solve_packed(tp, model_id, _port_options(opts), tm)
    assert tsum["num_iterations"] == jsum["num_iterations"]
    for key in ("initial_cost", "final_cost"):
        assert abs(tsum[key] - jsum[key]) <= 1e-6 * jsum[key], key
    assert tsum["final_cost"] < 0.01 * tsum["initial_cost"]
    out = convert.problem_to_numpy(ts)
    for name in ("quat", "t", "cam_params", "points"):
        np.testing.assert_allclose(out[name], _np(getattr(js, name)),
                                   rtol=1e-6 if name == "cam_params" else 0, atol=1e-6,
                                   err_msg=name)


def test_bundle_adjuster_cli_matches_jax(tmp_path, capsys):
    """Both CLIs on the verify-recipe scene with perturbed poses and points
    and 0.5 px measurement noise: the same printed summary (4 significant
    digits) and models within 1e-6."""
    opt = SyntheticDatasetOptions(num_rigs=1, num_cameras_per_rig=1, num_frames_per_rig=8,
                                  num_points3D=120, seed=3)
    recon = synthesize_dataset(opt)
    rng = np.random.default_rng(3)
    for point in recon.points3D.values():
        point.xyz = point.xyz + rng.normal(0, 0.01, 3)
    for frame in recon.frames.values():
        frame.rig_from_world.t = frame.rig_from_world.t + rng.normal(0, 0.01, 3)
    for image in recon.images.values():
        image.points2D_xy = image.points2D_xy + rng.normal(0, 0.5, image.points2D_xy.shape)
    src = str(tmp_path / "in")
    jio.write_model(recon, src)
    capsys.readouterr()
    jax_cli(["bundle_adjuster", "--input_path", src, "--output_path", str(tmp_path / "jax")])
    jline = capsys.readouterr().out.strip().splitlines()[-1]
    port_cli(["bundle_adjuster", "--input_path", src, "--output_path", str(tmp_path / "port"),
              "--device", "cpu"])
    tline = capsys.readouterr().out.strip().splitlines()[-1]
    assert jline.startswith("BA: cost ") and tline == jline
    rj, rt = jio.read_model(str(tmp_path / "jax")), tio.read_model(str(tmp_path / "port"))
    assert sorted(rj.reg_image_ids()) == sorted(rt.reg_image_ids())
    for iid in rj.reg_image_ids():
        np.testing.assert_allclose(rt.cam_from_world(iid).quat, rj.cam_from_world(iid).quat,
                                   atol=1e-6)
        np.testing.assert_allclose(rt.cam_from_world(iid).t, rj.cam_from_world(iid).t,
                                   atol=1e-6)
    for pid, point in rj.points3D.items():
        np.testing.assert_allclose(rt.points3D[pid].xyz, point.xyz, atol=1e-6)
        assert abs(rt.points3D[pid].error - point.error) <= 1e-6


def _imports(path):
    names = []
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.append(node.module)
    return names


def test_port_imports_neither_jax_nor_colmap_tpu():
    """The package, chip_smoke.py and the card's test file (run there
    without JAX) import neither JAX nor colmap_tpu."""
    files = sorted((REPO / "colmap_tpu_torch").rglob("*.py")) + [
        REPO / "chip_smoke.py", REPO / "tests" / "test_torch_cuda.py"]
    assert len(files) > 10
    for path in files:
        for name in _imports(path):
            root = name.split(".")[0]
            assert root not in ("jax", "jaxlib", "colmap_tpu"), f"{path}: imports {name}"


def test_cuda_request_without_cuda_raises(monkeypatch, tmp_path):
    """No silent drop to the CPU: entry points default to cuda and raise."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    from colmap_tpu_torch.scene.synthetic_ba import synthetic_ba_problem

    with pytest.raises(RuntimeError, match="CUDA was requested"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA was requested"):
        synthetic_ba_problem(4, 20, 3)
    recon = synthesize_dataset(SyntheticDatasetOptions(num_rigs=1, num_frames_per_rig=3,
                                                       num_points3D=20, seed=1))
    jio.write_model(recon, str(tmp_path / "m"))
    with pytest.raises(RuntimeError, match="CUDA was requested"):
        port_cli(["bundle_adjuster", "--input_path", str(tmp_path / "m"),
                  "--output_path", str(tmp_path / "o")])


def test_wrappers_never_fall_back_off_the_cpu():
    """A tensor that is neither on the CPU nor on a CUDA device gets no plain
    version: the wrapper raises."""
    J = (torch.zeros(4, 2, device="meta"), torch.zeros(4, 2, 6, device="meta"),
         torch.zeros(4, 2, 4, device="meta"), torch.zeros(4, 2, 3, device="meta"))
    ids = torch.zeros(2, 2, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        K.lm_reduce(*J, ids, ids, 1, 1, torch.tensor(1e-3, device="meta"))
    with pytest.raises(ValueError, match="no kernel for device"):
        K.schur_matvec(*J[1:], ids, ids, torch.zeros(2, 3, 3, device="meta"),
                       torch.zeros(1, 6, device="meta"), torch.zeros(1, 4, device="meta"))


def test_mixed_camera_models_raise(tmp_path):
    opt = SyntheticDatasetOptions(num_rigs=2, num_frames_per_rig=2, num_points3D=20, seed=2,
                                  camera_model_ids=(0, 2),
                                  camera_params_list=((1000.0, 512.0, 384.0),
                                                      (1000.0, 512.0, 384.0, 0.01)))
    # Mixed models no longer raise: the port packs them as colmap_tpu does
    # (the tuple of models, rows padded to the widest model plus the model
    # position), and the masks keep the padding and that column constant.
    recon = synthesize_dataset(opt)
    jio.write_model(recon, str(tmp_path / "m"))
    from colmap_tpu.estimators.ba_setup import problem_from_reconstruction as jproblem

    jp, jindex = jproblem(recon, bucket=False)
    tp, tindex = problem_from_reconstruction(tio.read_model(str(tmp_path / "m")), device="cpu")
    assert tindex["model_id"] == jindex["model_id"] == (0, 2)
    np.testing.assert_array_equal(tp.cam_params.numpy(), _np(jp.cam_params))
    masks = tba.default_masks(tp, tindex["model_id"], tba.BAOptions())
    np.testing.assert_array_equal(masks.cam_mask.numpy(), _np(jba.default_masks(
        jp, jindex["model_id"], jba.BAOptions()).cam_mask))


def test_convert_round_trip():
    jpk, _, tpk, _ = _problem(4, seed=2)
    back = convert.problem_to_numpy(tpk)
    for name, value in jpk._asdict().items():
        np.testing.assert_array_equal(back[name], _np(value))
    assert tpk.obs_frame.dtype == torch.int32 and tpk.points.dtype == torch.float64
    with pytest.raises(ValueError, match="unknown BAOptions"):
        convert.options_from_fields({"max_iterations": 3, "bucket": True})
