"""colmap_tpu_torch CUDA kernels against their plain versions, on a card.

These tests need a CUDA card and the CUDA toolkit and skip without them.
The file imports neither JAX nor colmap_tpu, so on a machine without JAX
it runs without the suite's conftest:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -p no:cacheprovider

Each float32 kernel is held against its plain version run in float64 on
the same inputs. K1 agrees to 1e-5 of each output's largest entry. K2-K4
sum frame and camera terms with atomics, so the order of those float32
sums, and their last bits, vary from run to run: they are held to 1e-4.
The mapper kernels run on the cases of colmap_tpu_torch/kernels/sfm_cases.py
at small sizes: K5 (one projection or 25 Newton steps) to 1e-5; K6 and K7
count each model's inliers as a float64 count of the same model does, up to
rows within 2% of the threshold, and refit to the same support; K8 (float32
Jacobi on the 4x4 normal equations against a float64 SVD), with and without
RANSAC over view pairs, to 1e-3; K9 to 1e-4. The matching kernels run on the
cases of colmap_tpu_torch/kernels/matching_cases.py: K10 gives the plain
version's matches on every row whose arccos tests lie further than 1e-5 rad
from their thresholds (float32 similarities against float64); K11 and K12
count and refit as K6 and K7 do; a block of pairs through K7, K11 and K12
gives each pair exactly what the one-pair entry gives it. The PatchMatch
kernels K17-K20 run on colmap_tpu_torch/kernels/mvs_cases.py's plane case
(their tolerances are stated above their tests). The rig kernels K24-K27 run
on colmap_tpu_torch/kernels/rig_cases.py: K24 to 1e-5 (1e-4 under Cauchy),
K25 and K26 (float32 sums in a fixed order, the same in every run) to 1e-4,
K27 counts each model's inliers within its rows near the threshold and
picks the float64 version's best sample or a near-tie. The retrieval kernels
K28-K31 run on colmap_tpu_torch/kernels/retrieval_cases.py (their tolerances
are stated above their tests). Camera models 5-17 run through K5 (three
modes, and a 185-degree lens's whole image), K1 and K9, a problem that mixes
models through K1, K9 and K24 once per model, and the spherical RANSACs K32
and K33 on colmap_tpu_torch/kernels/spherical_cases.py (tolerances stated
above their tests). The solver kernels K34-K40 (the packed and rig LM
loops, global SfM's CG, relative poses, structure-less and generalized
pose refinement), the spectral Poisson kernels K41-K44 and the option
kernels (K45 affine shapes with K15 and K16 on affine frames, K46
DEGENSAC, K47 SPRT, the MSAC mode of K7, K11, K12, K32 and K33) and the
learned-feature kernels K50-K53 (ALIKED's convolutions, detection and
sparse SDDH, LightGlue's attention and log-assignment) and K54 (the BA
covariance's float64 S) are held as stated above their tests; the
point-sharded solve runs in an NCCL group of one rank.
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


def _close(got, ref, tol, name):
    """max |got - ref| <= tol * max |ref|."""
    err = (got.double() - ref.double()).abs().max().item()
    scale = max(ref.double().abs().max().item(), 1e-30)
    assert err <= tol * scale, f"{name}: {err:.3e} > {tol:g} * {scale:.3e}"


def _f64(*xs):
    return [x.double() if x.is_floating_point() else x for x in xs]


def _setup(num_frames, num_points, track=0):
    """A synthetic problem on the card, packed, with two-frame gauge masks.
    With ``track`` > 0 its point 0 is also seen by frames 0..track-1."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from colmap_tpu_torch.estimators import bundle_adjustment as ba
    from colmap_tpu_torch.geometry import rotation as rot
    from colmap_tpu_torch.scene.synthetic_ba import synthetic_ba_problem
    from colmap_tpu_torch.sensor.models import img_from_cam

    problem, _, model_id = synthetic_ba_problem(num_frames, num_points, 6, seed=1,
                                                device="cuda")
    if track:
        p = problem
        frames = torch.arange(track, device="cuda")
        Xc = rot.quat_rotate(p.quat[frames], p.points[0].expand(track, 3)) + p.t[frames]
        xy, _ = img_from_cam(model_id, p.cam_params[0], Xc)
        zeros = torch.zeros(track, dtype=torch.int32, device="cuda")
        problem = p._replace(
            obs_frame=torch.cat([p.obs_frame, frames.to(torch.int32)]),
            obs_cam=torch.cat([p.obs_cam, zeros]), obs_point=torch.cat([p.obs_point, zeros]),
            obs_xy=torch.cat([p.obs_xy, xy + 0.5]),
            obs_w=torch.cat([p.obs_w, torch.ones_like(xy[:, 0])]))
    opts = ba.BAOptions(max_iterations=3, pcg_iterations=10)
    masks = ba.fix_gauge_two_frames(ba.default_masks(problem, model_id, opts), 0, 1)
    packed, maps, _ = ba.pack_problem(problem)
    return packed, maps, model_id, opts, masks


@pytest.fixture
def problem():
    return _setup(20, 2000)


@pytest.mark.parametrize("shape", [(20, 2000, 0), (800, 2000, 700)],
                         ids=["20x2000", "800_frames_long_track"])
def test_kernels_match_plain_on_cuda(shape):
    """K1-K4 against their plain versions (float64) on a 20 x 2000 problem,
    and on 800 frames with one track of 706 observations: there K2 adds its
    frame table (above its shared-memory limit) straight into global memory,
    and K4 tiles the long point's slots."""
    from colmap_tpu_torch.estimators import bundle_adjustment as ba
    from colmap_tpu_torch.kernels import ba as K

    pk, maps, model_id, opts, masks = _setup(*shape)
    om = ba._obs_masks(masks, opts)
    args = (pk.quat, pk.t, pk.cam_params, pk.points, pk.obs_frame, pk.obs_cam, pk.obs_point,
            pk.obs_xy, pk.obs_w, om.pose, om.cam, om.point)
    J = K.obs_jacobians(*args, model_id, "trivial", 1.0)
    ref = K.obs_jacobians_plain(*_f64(*args), model_id, "trivial", 1.0)
    for name, a, b in zip(("r", "Jp", "Jc", "Jx"), J, ref):
        _close(a, b, 1e-5, f"K1 {name}")
    F, C = pk.quat.shape[0], pk.cam_params.shape[0]
    fpm, cpm = maps.frame_pm, maps.cam_pm
    lam = torch.tensor(1e-3, device="cuda")
    red = K.lm_reduce(*J, fpm, cpm, F, C, lam)
    ref = K.lm_reduce_plain(*_f64(*J), fpm, cpm, F, C, lam.double())
    for name, a, b in zip(K.LMReduction._fields, red, ref):
        _close(a, b, 1e-4, f"K2 {name}")
    g = torch.Generator(device="cuda").manual_seed(0)
    xp = torch.randn(F, 6, device="cuda", generator=g)
    xc = torch.randn(C, J[2].shape[-1], device="cuda", generator=g) * 1e-3
    ops = (J[1], J[2], J[3], fpm, cpm, red.Hpp_inv)
    for name, a, b in zip(("out_p", "out_c"), K.schur_matvec(*ops, xp, xc),
                          K.schur_matvec_plain(*_f64(*ops, xp, xc))):
        _close(a, b, 1e-4, f"K3 {name}")
    _close(K.back_substitute(*ops, red.gx, xp, xc),
           K.back_substitute_plain(*_f64(*ops, red.gx, xp, xc)), 1e-4, "K3 dx")
    lam_diag = torch.cat([1e-3 * red.diag_pose.reshape(-1), 1e-3 * red.diag_cam.reshape(-1)])
    _close(K.dense_schur_assemble(*ops, lam_diag, F),
           K.dense_schur_assemble_plain(*_f64(*ops, lam_diag), F), 1e-4, "K4 S")


# K3 at the shapes the weighing found heaviest (the mapper's local BAs: a few
# frames, hundreds of points, one camera of P 4 or 8), and on each of its
# other paths: three cameras (no warp shares one camera: the lanes add
# their own terms), 300 frames (a table of 1804 floats: one a block), 4200
# frames (100 KB: straight into the output) and a track of 40 slots (lanes
# take two trips). The matvec and the back-substitution to 1e-4 of their
# plain versions in float64, as test_kernels_match_plain_on_cuda holds K3.
@pytest.mark.parametrize("F, N, model_id, cameras, track", [
    (5, 800, 4, 1, 0), (5, 120, 2, 1, 0), (3, 700, 4, 1, 0), (9, 2700, 2, 1, 0),
    (12, 900, 2, 3, 0), (300, 2000, 2, 1, 0), (4200, 1000, 2, 1, 0), (48, 500, 2, 1, 40)],
    ids=["5x800_p8", "5x120_p4", "3x700_p8", "9x2700_p4", "three_cameras", "300_frames",
         "4200_frames", "track_40"])
def test_schur_matvec_weighed_shapes_match_plain_on_cuda(F, N, model_id, cameras, track):
    from colmap_tpu_torch.estimators import bundle_adjustment as ba
    from colmap_tpu_torch.kernels import ba as K
    from colmap_tpu_torch.scene.synthetic_ba import synthetic_ba_problem

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    if track:
        pk, maps, model_id, opts, masks = _setup(F, N, track)
    else:
        problem, _, _ = synthetic_ba_problem(F, N, min(F, 6), model_id=model_id, seed=4,
                                             device="cuda")
        if cameras > 1:
            problem = problem._replace(
                cam_params=problem.cam_params.repeat(cameras, 1),
                obs_cam=(problem.obs_frame % cameras).to(torch.int32))
        opts = ba.BAOptions()
        masks = ba.fix_gauge_two_frames(ba.default_masks(problem, model_id, opts), 0, 1)
        pk, maps, _ = ba.pack_problem(problem)
    om = ba._obs_masks(masks, opts)
    J = K.obs_jacobians(pk.quat, pk.t, pk.cam_params, pk.points, pk.obs_frame, pk.obs_cam,
                        pk.obs_point, pk.obs_xy, pk.obs_w, om.pose, om.cam, om.point, model_id,
                        "trivial", 1.0)
    C = pk.cam_params.shape[0]
    red = K.lm_reduce(*J, maps.frame_pm, maps.cam_pm, F, C, torch.tensor(1e-3, device="cuda"))
    g = torch.Generator(device="cuda").manual_seed(0)
    xp = torch.randn(F, 6, device="cuda", generator=g)
    xc = torch.randn(C, J[2].shape[-1], device="cuda", generator=g) * 1e-3
    ops = (J[1], J[2], J[3], maps.frame_pm, maps.cam_pm, red.Hpp_inv)
    K.reset_launches()
    got = K.schur_matvec(*ops, xp, xc)
    dx = K.back_substitute(*ops, red.gx, xp, xc)
    for name, a, b in zip(("out_p", "out_c"), got, K.schur_matvec_plain(*_f64(*ops, xp, xc))):
        _close(a, b, 1e-4, f"K3 {name}")
    _close(dx, K.back_substitute_plain(*_f64(*ops, red.gx, xp, xc)), 1e-4, "K3 dx")
    N_, capp = maps.frame_pm.shape
    P = J[2].shape[-1]
    assert K.LAUNCHES["ba_schur_matvec"] == 2
    assert K.SHAPES.counts == {("ba_schur_matvec", "matvec", N_, capp, F, C, P): 1,
                               ("ba_schur_matvec", "back_substitute", N_, capp, F, C, P): 1}


@pytest.mark.parametrize("solver", ["dense_schur", "pcg"])
def test_solve_matches_plain_on_cuda(problem, solver):
    """Three LM iterations through the kernels and through the plain
    versions on the card: final costs within 1e-3 relative."""
    import dataclasses

    from colmap_tpu_torch.estimators import bundle_adjustment as ba
    from colmap_tpu_torch.kernels import ba as K

    pk, maps, model_id, opts, masks = problem
    opts = dataclasses.replace(opts, solver_type=solver)
    K.reset_launches()
    _, cost, _ = ba.lm_solve_fused_packed(pk, maps, model_id, opts, masks)
    assert K.LAUNCHES["ba_dense_schur_assemble" if solver == "dense_schur"
                      else "ba_schur_matvec"] > 0
    _, cost_plain, _ = ba._lm_loop(pk, maps, model_id, opts, masks, ba._use_dense(pk, opts),
                                   True, kernels=K.PLAIN)
    assert abs(cost - cost_plain) <= 1e-3 * cost_plain


@pytest.mark.parametrize("shape", [(20, 2000, 0), (800, 2000, 700)],
                         ids=["20x2000", "800_frames_long_track"])
def test_k54_covariance_assemble_matches_plain_on_cuda(shape):
    """K54 against its plain version in float64 on the same float32 K1
    Jacobians (two-frame gauge, so the fixed rows are exactly 0 in both):
    within 1e-10 of S's largest entry (float64 sums in the atomics' order;
    H_cc - S_corr cancels, so the terms are larger than S). Then
    estimate_ba_covariance on the card: finite, zero on the gauge rows."""
    from colmap_tpu_torch.estimators import bundle_adjustment as ba
    from colmap_tpu_torch.estimators.covariance import estimate_ba_covariance
    from colmap_tpu_torch.kernels import ba as K

    pk, maps, model_id, opts, masks = _setup(*shape)
    om = ba._obs_masks(masks, opts)
    _, Jp, Jc, Jx = K.obs_jacobians(pk.quat, pk.t, pk.cam_params, pk.points, pk.obs_frame,
                                    pk.obs_cam, pk.obs_point, pk.obs_xy, pk.obs_w, om.pose,
                                    om.cam, om.point, model_id, "trivial", 1.0)
    F, C = pk.quat.shape[0], pk.cam_params.shape[0]
    args = (Jp, Jc, Jx, maps.frame_pm, maps.cam_pm, 1e-8, F, C)
    K.reset_launches()
    S = K.covariance_assemble(*args)
    assert K.LAUNCHES["ba_covariance_assemble"] == 1 and S.dtype == torch.float64
    ref = K.covariance_assemble_plain(*args)
    _close(S, ref, 1e-10, "K54 S")
    fixed = torch.cat([torch.cat([masks.frame_mask[:, None].expand(-1, 3),
                                  masks.frame_trans_mask], 1).reshape(-1),
                       masks.cam_mask.reshape(-1)]) == 0
    assert (S[fixed] == 0).all() and (S[:, fixed] == 0).all() and (ref[fixed] == 0).all()
    if shape[0] == 20:
        cov = estimate_ba_covariance(pk, model_id, opts, masks)
        assert np.isfinite(cov["pose_covs"]).all() and (cov["pose_covs"][0] == 0).all()
        assert (cov["pose_covs"][1][3] == 0).all()


def test_sharded_solve_in_a_world_size_one_nccl_group_on_cuda(problem):
    """solve_sharded_packed in an NCCL group of one rank against
    solve_packed: the same iterations, the cost within 1e-6 relative."""
    import dataclasses

    from colmap_tpu_torch.estimators import bundle_adjustment as ba
    from colmap_tpu_torch.parallel import dist_cases, multihost, sharded_ba

    pk, maps, model_id, opts, masks = problem
    opts = dataclasses.replace(opts, solver_type="pcg", max_iterations=5)
    multihost.initialize(f"tcp://127.0.0.1:{dist_cases.free_port()}", 1, 0, backend="nccl")
    try:
        out, summary = sharded_ba.solve_sharded_packed(pk, model_id, opts, masks)
    finally:
        multihost.shutdown()
    ref, ref_summary = ba.solve_packed(pk, model_id, opts, masks)
    assert summary["num_iterations"] == ref_summary["num_iterations"]
    assert abs(summary["final_cost"] - ref_summary["final_cost"]) <= (
        1e-6 * ref_summary["final_cost"])


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.parametrize("model_id", range(5))
def test_camera_map_matches_plain_on_cuda(model_id):
    """K5, project and unproject (shared and per-row parameters)."""
    _need_card()
    from colmap_tpu_torch.kernels import sfm as K
    from colmap_tpu_torch.kernels import sfm_cases as C
    from colmap_tpu_torch.sensor import models as M

    p, uvw, xy = C.camera_map_case(model_id, 300, model_id, "cuda")
    got, ok = K.img_from_cam(model_id, p, uvw)
    ref, ok_ref = M.img_from_cam(model_id, p.double(), uvw.double())
    _close(got, ref, 1e-5, "K5 project")
    assert torch.equal(ok, ok_ref)
    ref, _ = M.cam_from_img(model_id, p.double(), xy.double())
    _close(K.cam_from_img(model_id, p, xy)[0], ref, 1e-5, "K5 unproject")
    _close(K.cam_from_img(model_id, p.expand(300, -1).contiguous(), xy)[0], ref, 1e-5,
           "K5 unproject, per-row parameters")


def test_camera_map_raises_for_models_without_cuda():
    """Every model 0-17 has a CUDA camera map; an id outside them raises."""
    _need_card()
    from colmap_tpu_torch.kernels import sfm as K

    xy = torch.zeros(4, 2, device="cuda")
    assert K.CUDA_MODELS == frozenset(range(18))
    with pytest.raises(ValueError):
        K.cam_from_img(18, torch.ones(8, device="cuda"), xy)


def _rows_close(got, ref, tol, name):
    """Per row: max |got - ref| <= tol * max(|ref| of the row, 1)."""
    err = (got.double() - ref.double()).abs().amax(-1)
    scale = torch.clamp(ref.double().abs().amax(-1), min=1.0)
    worst = float((err / scale).max()) if err.numel() else 0.0
    assert worst <= tol, f"{name}: {worst:.3e} > {tol:g}"


@pytest.mark.parametrize("model_id", range(5, 18))
def test_camera_maps_of_models_5_17_match_plain_on_cuda(model_id):
    """K5's three modes for models 5-17 against the float64 plain versions:
    project 1e-5, unproject and ray 1e-4 of each row's scale (25 float32
    Newton steps), validity equal; over a 185-degree lens's whole image
    (sfm_cases.wide_grid_case) the same validity, rays within 1e-4 and z = 1
    points within 1e-4 of their row where the float64 ray lies more than 1
    degree from 90 degrees off axis (the lift diverges there)."""
    _need_card()
    from colmap_tpu_torch.kernels import sfm as K
    from colmap_tpu_torch.kernels import sfm_cases as C
    from colmap_tpu_torch.sensor import models as M

    p, uvw, xy = C.camera_map_case(model_id, 300, model_id, "cuda")
    got, ok = K.img_from_cam(model_id, p, uvw)
    ref, ok_ref = M.img_from_cam(model_id, p.double(), uvw.double())
    assert torch.equal(ok, ok_ref)
    _rows_close(got[ok_ref], ref[ok_ref], 1e-5, "K5 project")
    grids = [(p, xy)]
    if model_id in C.WIDE_MODELS:
        grids.append(C.wide_grid_case(model_id, 61, "cuda"))
    for prm, pix in grids:
        ray, ok_r = K.cam_ray_from_img(model_id, prm, pix)
        ray_ref, ok_rr = M.cam_ray_from_img(model_id, prm.double(), pix.double())
        assert torch.equal(ok_r, ok_rr)
        away = (ray_ref[:, 2].abs() > np.sin(np.deg2rad(1.0))) & ok_rr
        _rows_close(ray[away], ray_ref[away], 1e-4, "K5 ray")
        uv, ok_u = K.cam_from_img(model_id, prm, pix)
        uv_ref, ok_ur = M.cam_from_img(model_id, prm.double(), pix.double())
        assert torch.equal(ok_u, ok_ur)
        _rows_close(uv[away], uv_ref[away], 1e-4, "K5 unproject")
        rows, _ = K.cam_from_img(model_id, prm.expand(pix.shape[0], -1).contiguous(), pix)
        assert torch.equal(rows, uv)


@pytest.mark.parametrize("model_id", range(5, 18))
def test_obs_jacobians_of_models_5_17_match_plain_on_cuda(model_id):
    """K1 for models 5-17 (Dual<3 + P>, up to 19 directions) against its
    float64 plain version on a 20 x 2000 problem with the cases' distortion:
    r, Jp, Jc, Jx to 1e-4 of each block's scale (float32 through up to 12
    distortion terms), the cost to 1e-5; K9 on its case to 1e-4 (errors in
    front of the camera: behind it the filter deletes an observation by its
    depth, and the division models, without a cheirality test, project such
    points 1e5-1e6 px off, where a float32 residual keeps ~0.1 px)."""
    _need_card()
    from colmap_tpu_torch.estimators import bundle_adjustment as ba
    from colmap_tpu_torch.kernels import ba as K
    from colmap_tpu_torch.kernels import sfm as KS
    from colmap_tpu_torch.kernels import sfm_cases as C
    from colmap_tpu_torch.scene.synthetic_ba import synthetic_ba_problem

    p, _, _ = synthetic_ba_problem(20, 2000, 6, model_id=model_id, seed=1, device="cuda")
    p = p._replace(cam_params=torch.as_tensor(C.camera_params(model_id), dtype=torch.float32,
                                              device="cuda")[None].contiguous())
    opts = ba.BAOptions(loss="cauchy", loss_scale=2.0)
    om = ba._obs_masks(ba.default_masks(p, model_id, opts), opts)
    args = (p.quat, p.t, p.cam_params, p.points, p.obs_frame, p.obs_cam, p.obs_point, p.obs_xy,
            p.obs_w)
    J = K.obs_jacobians(*args, *om, model_id, opts.loss, opts.loss_scale)
    ref = K.obs_jacobians_plain(*_f64(*args), *_f64(*om), model_id, opts.loss, opts.loss_scale)
    for name, a, b in zip(("r", "Jp", "Jc", "Jx"), J, ref):
        _close(a, b, 1e-4, f"K1 {name}")
    _close(K.obs_cost(*args, model_id, opts.loss, opts.loss_scale),
           K.obs_cost_plain(*_f64(*args), model_id, opts.loss, opts.loss_scale), 1e-5, "K1 cost")
    c = C.filter_case(200, 1, "cuda", model_id=model_id)
    d = C.as_double(c)
    keys = ("quat", "t", "cam_params", "xyz", "obs_xy", "valid")
    err, depth, mc = KS.filter_points(model_id, *(c[k] for k in keys))
    err_p, depth_p, mc_p = KS.filter_points_plain(model_id, *(d[k] for k in keys))
    fin = torch.isfinite(err_p)
    assert torch.equal(torch.isfinite(err), fin)
    front = fin & (depth_p > 0)
    _close(err[front], err_p[front], 1e-4, "K9 errors")
    _close(depth, depth_p, 1e-4, "K9 depths")


def test_mixed_models_match_plain_on_cuda():
    """A problem of SIMPLE_RADIAL and OPENCV_FISHEYE cameras (rows padded to
    9 columns): K1 launched once per model against the float64 plain path
    (1e-5; Jc's padded columns exactly 0), a solve through the kernels
    against the plain one (1e-3), K9 per model (1e-4), and K24 per model on a
    mixed rig problem (1e-4)."""
    _need_card()
    from colmap_tpu_torch.estimators import bundle_adjustment as ba
    from colmap_tpu_torch.estimators import bundle_adjustment_rig as rba
    from colmap_tpu_torch.kernels import ba as K
    from colmap_tpu_torch.kernels import rig as KR
    from colmap_tpu_torch.kernels import rig_cases as RC
    from colmap_tpu_torch.kernels import sfm as KS
    from colmap_tpu_torch.kernels import sfm_cases as C
    from colmap_tpu_torch.scene.synthetic_ba import synthetic_ba_problem
    from colmap_tpu_torch.sensor import models as M

    mixed = (2, 5)
    _, rows = M.pack_mixed_params([C.camera_params(2), C.camera_params(5)], [2, 5])
    p, _, _ = synthetic_ba_problem(20, 2000, 6, seed=2, device="cuda")
    cams = torch.as_tensor(rows, dtype=torch.float32, device="cuda")
    p = p._replace(cam_params=cams, obs_cam=(p.obs_frame % 2).to(torch.int32))
    opts = ba.BAOptions(max_iterations=3, pcg_iterations=10)
    masks = ba.fix_gauge_two_frames(ba.default_masks(p, mixed, opts), 0, 1)
    pk, maps, _ = ba.pack_problem(p)
    om = ba._obs_masks(masks, opts)
    args = (pk.quat, pk.t, pk.cam_params, pk.points, pk.obs_frame, pk.obs_cam, pk.obs_point,
            pk.obs_xy, pk.obs_w)
    K.reset_launches()
    J = K.obs_jacobians(*args, *om, mixed, "trivial", 1.0)
    assert K.LAUNCHES["ba_obs_jacobians"] == 2
    ref = K.obs_jacobians_plain(*_f64(*args), *_f64(*om), mixed, "trivial", 1.0)
    for name, a, b in zip(("r", "Jp", "Jc", "Jx"), J, ref):
        _close(a, b, 1e-5, f"mixed K1 {name}")
    simple = (pk.cam_params[pk.obs_cam.long(), -1] == 0)
    assert bool((J[2][simple][:, :, 4:] == 0).all()) and bool((J[2][..., -1] == 0).all())
    _, cost, _ = ba.lm_solve_fused_packed(pk, maps, mixed, opts, masks)
    _, cost_plain, _ = ba._lm_loop(pk, maps, mixed, opts, masks, ba._use_dense(pk, opts), True,
                                   kernels=K.PLAIN)
    assert abs(cost - cost_plain) <= 1e-3 * cost_plain
    c = C.filter_case(200, 1, "cuda", model_id=2)
    pick = torch.as_tensor(np.random.default_rng(3).integers(0, 2, tuple(c["valid"].shape)),
                           device="cuda")
    c["cam_params"] = cams[pick].contiguous()
    d = C.as_double(c)
    keys = ("quat", "t", "cam_params", "xyz", "obs_xy", "valid")
    err, depth, mc = KS.filter_points(mixed, *(c[k] for k in keys))
    err_p, depth_p, mc_p = KS.filter_points_plain(mixed, *(d[k] for k in keys))
    fin = torch.isfinite(err_p)
    assert torch.equal(torch.isfinite(err), fin)
    _close(err[fin], err_p[fin], 1e-4, "mixed K9 errors")
    _close(depth, depth_p, 1e-4, "mixed K9 depths")
    _close(mc, mc_p, 1e-4, "mixed K9 min |cos|")
    rp, _, _ = RC.rig_ba_problem(6, 2, 400, 4, seed=4, device="cuda")
    rp = rp._replace(cam_params=cams.clone())
    rmasks = rba.fix_gauge_two_frames(rba.default_masks(rp, mixed, opts), 0, 1)
    rom = rba._obs_masks(rmasks, opts)
    jac = KR.rig_obs_jacobians(*rp[:6], rba._obs(rp), *rom, mixed, "trivial", 1.0)
    p64 = type(rp)(*_f64(*rp))
    jref = KR.rig_obs_jacobians_plain(*p64[:6], rba._obs(p64), *_f64(*rom), mixed, "trivial",
                                      1.0)
    for name, a, b in zip(KR.RigJacobians._fields, jac, jref):
        _close(a, b, 1e-4, f"mixed K24 {name}")
    _, rcost, _ = rba._lm_loop(rp, mixed, opts, rmasks)
    _, rcost_p, _ = rba._lm_loop(rp, mixed, opts, rmasks, kernels=KR.PLAIN)
    assert abs(rcost - rcost_p) <= 1e-3 * rcost_p


def _counts_match(counts, models, residuals, mask, max_sq):
    fin = torch.isfinite(models.flatten(1)).all(1)
    res = torch.where(mask, residuals(models[fin].double()), torch.inf)
    border = ((res - max_sq).abs() <= 0.02 * max_sq).sum(-1)
    assert bool(((counts[fin] - (res <= max_sq).sum(-1)).abs() <= border).all())
    assert bool((counts[~fin] == 0).all())


def test_p3p_ransac_matches_plain_on_cuda():
    """K6: scoring, inlier mask and refit."""
    _need_card()
    from colmap_tpu_torch.kernels import sfm as K
    from colmap_tpu_torch.kernels import sfm_cases as C
    from colmap_tpu_torch.optim.ransac import unpack_best

    c = C.p3p_case(400, 32, 1, "cuda")
    d = C.as_double(c)
    models, counts, best = K.p3p_propose_score(c["X"], c["rays"], c["uv"], c["mask"],
                                               c["samples"], c["max_sq"])
    _counts_match(counts, models, lambda m: K.p3p_residuals(m, d["X"], d["uv"]), d["mask"],
                  d["max_sq"])
    support, idx = unpack_best(int(best.item()))
    assert support == int(counts.max()) and counts[idx] == support
    model = models[idx]
    assert torch.equal(K.p3p_inliers(c["X"], c["uv"], c["mask"], model, c["max_sq"]),
                       K.p3p_inliers_plain(d["X"], d["uv"], d["mask"], model.double(),
                                           d["max_sq"]))
    start = model.clone()
    start[:, 3] += 0.03
    n0 = int(K.p3p_inliers_plain(d["X"], d["uv"], d["mask"], start.double(), d["max_sq"]).sum())
    got, n_got = K.p3p_refit(c["X"], c["uv"], c["mask"], start, c["max_sq"], n0)
    ref, n_ref = K.p3p_refit_plain(d["X"], d["uv"], d["mask"], start.double(), d["max_sq"], n0)
    assert n_got == n_ref
    _close(got, ref, 1e-3, "K6 refit")


def test_essential_ransac_matches_plain_on_cuda():
    """K7: scoring, inlier mask and refit."""
    _need_card()
    from colmap_tpu_torch.geometry.essential import sampson_error
    from colmap_tpu_torch.kernels import sfm as K
    from colmap_tpu_torch.kernels import sfm_cases as C
    from colmap_tpu_torch.optim.ransac import unpack_best

    c = C.essential_case(400, 32, 1, "cuda")
    d = C.as_double(c)
    models, counts, best = K.essential_propose_score(c["x1"], c["x2"], c["mask"], c["samples"],
                                                     c["max_sq"])
    _counts_match(counts, models,
                  lambda m: sampson_error(m[:, None], d["x1"][None], d["x2"][None]),
                  d["mask"], d["max_sq"])
    support, idx = unpack_best(int(best.item()))
    assert support == int(counts.max()) and counts[idx] == support
    model = models[idx]
    assert torch.equal(K.essential_inliers(c["x1"], c["x2"], c["mask"], model, c["max_sq"]),
                       K.essential_inliers_plain(d["x1"], d["x2"], d["mask"], model.double(),
                                                 d["max_sq"]))
    start = model + 0.003
    n0 = int(K.essential_inliers_plain(d["x1"], d["x2"], d["mask"], start.double(),
                                       d["max_sq"]).sum())
    got, n_got = K.essential_refit(c["x1"], c["x2"], c["mask"], start, c["max_sq"], n0)
    ref, n_ref = K.essential_refit_plain(d["x1"], d["x2"], d["mask"], start.double(),
                                         d["max_sq"], n0)
    assert n_got == n_ref
    _close(got * torch.sign((got.double() * ref).sum()), ref, 1e-3, "K7 refit")


def test_triangulate_tracks_matches_plain_on_cuda():
    """K8 on tracks with outlier views and two-view tracks."""
    _need_card()
    from colmap_tpu_torch.kernels import sfm as K
    from colmap_tpu_torch.kernels import sfm_cases as C

    c = C.tracks_case(300, 1, "cuda")
    d = C.as_double(c)
    keys = ("R", "t", "x", "mask", "min_angle", "max_err")
    xyz, inl, ok = K.triangulate_tracks(*(c[k] for k in keys))
    xyz_p, inl_p, ok_p = K.triangulate_tracks_plain(*(d[k] for k in keys))
    assert torch.equal(ok, ok_p) and torch.equal(inl[ok_p], inl_p[ok_p])
    _close(xyz[ok_p], xyz_p[ok_p], 1e-3, "K8 xyz")


def test_multi_view_tracks_matches_plain_on_cuda():
    """K8 without RANSAC: the N-view point of every track over its valid views."""
    _need_card()
    from colmap_tpu_torch.kernels import sfm as K
    from colmap_tpu_torch.kernels import sfm_cases as C

    c = C.tracks_case(300, 1, "cuda")
    d = C.as_double(c)
    keys = ("R", "t", "x", "mask")
    xyz = K.triangulate_multi_view_tracks(*(c[k] for k in keys))
    _close(xyz, K.triangulate_multi_view_tracks_plain(*(d[k] for k in keys)), 1e-3, "K8 N-view xyz")


def test_filter_points_matches_plain_on_cuda():
    """K9 on points of 2-32 views with outliers and negative depths."""
    _need_card()
    from colmap_tpu_torch.kernels import sfm as K
    from colmap_tpu_torch.kernels import sfm_cases as C

    c = C.filter_case(200, 1, "cuda")
    d = C.as_double(c)
    keys = ("quat", "t", "cam_params", "xyz", "obs_xy", "valid")
    err, depth, mc = K.filter_points(2, *(c[k] for k in keys))
    err_p, depth_p, mc_p = K.filter_points_plain(2, *(d[k] for k in keys))
    fin = torch.isfinite(err_p)
    assert torch.equal(torch.isfinite(err), fin)
    _close(err[fin], err_p[fin], 1e-4, "K9 errors")
    _close(depth, depth_p, 1e-4, "K9 depths")
    _close(mc, mc_p, 1e-4, "K9 min |cos|")


@pytest.mark.parametrize("guided", [False, True], ids=["plain", "guided"])
def test_match_top2_matches_plain_on_cuda(guided):
    """K10 on 6 pairs of 4 images of up to 700 descriptors (row and column
    tiles with ragged edges, unequal counts)."""
    _need_card()
    from colmap_tpu_torch.feature.matcher import MatchingOptions
    from colmap_tpu_torch.kernels import matching as KM
    from colmap_tpu_torch.kernels import matching_cases as C

    c = C.descriptor_case(4, 700, 1, "cuda")
    extra = dict(keypoints=c["keypoints"], F=c["F"]) if guided else {}
    opts = MatchingOptions()
    KM.reset_launches()
    idx, ok, best = KM.match_top2(c["desc"], c["counts"], c["pairs"], opts, details=True, **extra)
    assert KM.LAUNCHES["match_top2"] == 2
    if guided:
        extra["F"] = extra["F"].double()
    idx_p, ok_p, margin, best_p = KM.match_top2_plain(c["desc"], c["counts"], c["pairs"], opts,
                                                      dtype=torch.float64, details=True, **extra)
    clear = margin > 1e-5
    assert torch.equal(ok[clear], ok_p[clear]) and int(ok_p.sum()) > 1000
    both = ok & ok_p
    assert torch.equal(idx[both], idx_p[both])
    fin = torch.isfinite(best_p)
    fin &= torch.arange(700, device="cuda")[None] < c["counts"][c["pairs"][:, 0].long()][:, None]
    _close(best[fin], best_p[fin], 1e-5, "K10 best similarity")
    for flag in (False, True):  # the wrapper's plain two-output form, with and without the cross check
        o = MatchingOptions(cross_check=flag)
        ok_k = KM.match_top2(c["desc"], c["counts"], c["pairs"], o, **{
            k: (v.float() if k == "F" else v) for k, v in extra.items()})[1]
        ok_r = KM.match_top2_plain(c["desc"], c["counts"], c["pairs"], o, dtype=torch.float64,
                                   **extra)[1]
        assert int((ok_k != ok_r).sum()) <= int((~clear).sum())


def _two_view_family(kind):
    from colmap_tpu_torch.estimators.solvers.epipolar import homography_transfer_error
    from colmap_tpu_torch.geometry.essential import sampson_error, squared_epipolar_line_distance
    from colmap_tpu_torch.kernels import matching as KM
    from colmap_tpu_torch.kernels import sfm as K

    return {
        "E": (sampson_error, K.essential_propose_score, K.essential_refit, K.essential_inliers,
              K.essential_refit_plain, K.essential_inliers_plain),
        "F": (squared_epipolar_line_distance, KM.fundamental_propose_score, KM.fundamental_refit,
              KM.fundamental_inliers, KM.fundamental_refit_plain, KM.fundamental_inliers_plain),
        "H": (homography_transfer_error, KM.homography_propose_score, KM.homography_refit,
              KM.homography_inliers, KM.homography_refit_plain, KM.homography_inliers_plain),
    }[kind]


@pytest.mark.parametrize("kind", ["F", "H"])
def test_two_view_ransac_matches_plain_on_cuda(kind):
    """K11, K12: scoring, inlier mask, refit and (K11) the fit alone."""
    _need_card()
    from colmap_tpu_torch.kernels import matching as KM
    from colmap_tpu_torch.kernels import matching_cases as C
    from colmap_tpu_torch.optim.ransac import unpack_best

    residual, propose, refit, inliers, refit_p, inliers_p = _two_view_family(kind)
    c = C.two_view_case(kind, 600, 48, 1, "cuda")
    d = C.as_double(c)
    models, counts, best = propose(c["x1"], c["x2"], c["mask"], c["samples"], c["max_sq"])
    _counts_match(counts, models, lambda m: residual(m[:, None], d["x1"][None], d["x2"][None]),
                  d["mask"], d["max_sq"])
    support, idx = unpack_best(int(best.item()))
    assert support == int(counts.max()) and counts[idx] == support and support > 300
    model = models[idx]
    got = inliers(c["x1"], c["x2"], c["mask"], model, c["max_sq"])
    ref = inliers_p(d["x1"], d["x2"], d["mask"], model.double(), d["max_sq"])
    border = (residual(model.double(), d["x1"], d["x2"]) - d["max_sq"]).abs() <= 0.02 * d["max_sq"]
    assert not bool(((got != ref) & ~border).any())
    start = models[int(torch.argmin((counts - support // 2).abs()))]
    if kind == "H":
        start = model.clone()
        start[0, 1] += 0.01 * model[0, 0]
    n0 = int(inliers_p(d["x1"], d["x2"], d["mask"], start.double(), d["max_sq"]).sum())
    got, n_got = refit(c["x1"], c["x2"], c["mask"], start, c["max_sq"], n0)
    ref, n_ref = refit_p(d["x1"], d["x2"], d["mask"], start.double(), d["max_sq"], n0)
    assert abs(n_got - n_ref) <= 1 and n_ref > n0
    _close(got * torch.sign((got.double() * ref).sum()), ref, 1e-3, f"{kind} refit")
    if kind == "F":
        fit = KM.fundamental_fit(c["x1"], c["x2"], ref_mask := inliers_p(
            d["x1"], d["x2"], d["mask"], ref, d["max_sq"]))
        fit_p = KM.fundamental_fit_plain(d["x1"], d["x2"], ref_mask)
        _close(fit * torch.sign((fit.double() * fit_p).sum()), fit_p, 1e-3, "K11 fit only")


@pytest.mark.parametrize("kind", ["E", "F", "H"])
def test_pair_axis_equals_one_pair_entries_on_cuda(kind):
    """A block of 9 pairs with different valid counts, outlier shares and (E)
    thresholds, one of them not active: every entry gives each pair exactly
    what the one-pair entry gives."""
    _need_card()
    from colmap_tpu_torch.kernels import matching_cases as C
    from colmap_tpu_torch.optim.ransac import unpack_best

    _, propose, refit, inliers, _, _ = _two_view_family(kind)
    B = 9
    c = C.two_view_block_case(kind, B, 500, 16, 2, "cuda")
    sq = c["max_sq"]
    active = torch.ones(B, dtype=torch.bool, device="cuda")
    active[4] = False
    mb, cb, bb = propose(c["x1"], c["x2"], c["mask"], c["samples"], sq, active)
    assert int(bb[4]) == 0
    picks = [unpack_best(int(v)) for v in bb.tolist()]
    idx = torch.tensor([0 if b == 4 else p[1] for b, p in enumerate(picks)], device="cuda")
    start = torch.nan_to_num(mb[torch.arange(B, device="cuda"), idx])
    counts = torch.tensor([p[0] for p in picks], dtype=torch.int32, device="cuda")
    rb, nb = refit(c["x1"], c["x2"], c["mask"], start, sq, counts)
    ib = inliers(c["x1"], c["x2"], c["mask"], rb, sq)
    for b in range(B):
        s1 = float(sq[b]) if torch.is_tensor(sq) else sq
        one = (c["x1"][b], c["x2"][b], c["mask"][b])
        r1, n1 = refit(*one, start[b], s1, int(counts[b]))
        assert torch.equal(r1, rb[b]) and n1 == int(nb[b])
        assert torch.equal(inliers(*one, rb[b], s1), ib[b])
        if b != 4:
            m1, c1, b1 = propose(*one, c["samples"][b], s1)
            assert int(b1) == int(bb[b]) and torch.equal(c1, cb[b])
            assert torch.equal(torch.nan_to_num(m1), torch.nan_to_num(mb[b]))


def test_matcher_and_verification_through_the_command_on_cuda(tmp_path):
    """exhaustive_matcher on cuda on the 8-frame scene stripped to features:
    every pair's matches are the generator's and verify as CALIBRATED."""
    _need_card()
    import numpy as np

    from colmap_tpu_torch.cli import main as cli
    from colmap_tpu_torch.kernels import matching as KM
    from colmap_tpu_torch.scene.database import Database
    from colmap_tpu_torch.scene.synthetic import SyntheticDatasetOptions, synthesize_dataset

    path = str(tmp_path / "db.db")
    db = Database(path)
    synthesize_dataset(SyntheticDatasetOptions(num_rigs=1, num_frames_per_rig=8, num_points3D=120,
                                               camera_has_prior_focal_length=True), db,
                       rng=np.random.default_rng(3))
    truth = {(a, b): db.read_matches(a, b) for a in range(1, 9) for b in range(a + 1, 9)}
    db.conn.execute("DELETE FROM matches")
    db.conn.execute("DELETE FROM two_view_geometries")
    db.commit()
    db.close()
    KM.reset_launches()
    assert cli.main(["exhaustive_matcher", "--database_path", path]) == 28
    # Every matching kernel but DEGENSAC's K46, which only use_degensac runs.
    assert all(v > 0 for k, v in KM.LAUNCHES.items() if k != "degensac"), KM.LAUNCHES
    db = Database(path, must_exist=True)
    for (a, b), gen in truth.items():
        gen = {tuple(r) for r in gen.tolist()}
        assert {tuple(r) for r in db.read_matches(a, b).tolist()} == gen
        g = db.read_two_view_geometry(a, b)
        assert g.config == 2 and {tuple(r) for r in g.inlier_matches.tolist()} == gen
    # Guided matching: K10's guided mode, then the one-pair path of the
    # verification on the card; a pair alone gives what its block gave.
    from colmap_tpu_torch.controllers.feature_pipeline import (
        MatchingPipelineOptions,
        run_matches_import,
    )
    from colmap_tpu_torch.estimators.two_view_geometry import estimate_two_view_geometry

    block = db.read_two_view_geometry(3, 7)
    assert run_matches_import(db, [(3, 7)], MatchingPipelineOptions(guided_matching=True)) == 1
    guided = db.read_two_view_geometry(3, 7)
    assert {tuple(r) for r in guided.inlier_matches.tolist()} == {
        tuple(r) for r in truth[(3, 7)].tolist()}
    cameras, images = db.read_cameras(), {i: c for i, _, c in db.read_images()}
    alone = estimate_two_view_geometry(
        cameras[images[3]], db.read_keypoints(3)[:, :2], cameras[images[7]],
        db.read_keypoints(7)[:, :2], db.read_matches(3, 7))
    assert alone.config == block.config
    assert np.array_equal(alone.inlier_matches, block.inlier_matches)
    assert np.allclose(alone.E, block.E, atol=1e-6) and np.allclose(alone.F, block.F, atol=1e-6)
    db.close()


# SIFT (K13-K16) --------------------------------------------------------------


def _sift_octave():
    """A rendered 320 x 240 view on the card: the image, its upsampled and
    blurred base, and octave 0's stack and DoG from the kernels."""
    _need_card()
    from colmap_tpu_torch.feature.sift import SiftOptions
    from colmap_tpu_torch.kernels import sift as KS
    from colmap_tpu_torch.kernels import sift_cases as SC

    opts = SiftOptions()
    img = torch.from_numpy(SC.rendered_views(1, 320, 240, num_points=300)[0]).to("cuda")
    img = img.float() / 255.0
    base = KS.blur(KS.upsample2(img), opts.sigma0)
    gauss, dog = KS.build_octave(base, opts)
    torch.cuda.synchronize()
    return opts, img, base, gauss, dog


def test_sift_pyramid_matches_plain_on_cuda():
    """K13: upsample, blur, every level and DoG of an octave and the
    downsample against the plain versions in float64, level by level on
    the same input, to 1e-5 of each level's largest entry."""
    from colmap_tpu_torch.kernels import sift as KS

    opts, img, base, gauss, dog = _sift_octave()
    _close(KS.upsample2(img), KS.upsample2_plain(img.double()), 1e-6, "upsample2")
    up = KS.upsample2(img)
    _close(KS.blur(up, opts.sigma0), KS.blur_plain(up.double(), opts.sigma0), 1e-5, "base blur")
    for s, sigma in enumerate(KS.octave_sigmas(opts)):
        ref = KS.blur_plain(gauss[s].double(), sigma)
        _close(gauss[s + 1], ref, 1e-5, f"level {s + 1}")
        _close(dog[s], gauss[s + 1].double() - gauss[s].double(), 1e-6, f"dog {s}")
    assert torch.equal(KS.downsample2(gauss[3]), gauss[3][::2, ::2])


def test_sift_extrema_matches_plain_on_cuda():
    """K14 against the plain version in float64 on the same DoG: the same
    extrema except at samples within 1e-6 of the threshold, the refined
    rows to 1e-4 of each column's scale; on a DoG of tied values the same
    extrema and the same selection (lax.top_k's order); a capacity too small
    makes the wrapper run again and lose nothing."""
    from colmap_tpu_torch.kernels import sift as KS
    from colmap_tpu_torch.kernels import sift_cases as SC

    opts, _, _, _, dog = _sift_octave()
    got = KS.detect_extrema(dog, opts)
    ref = KS.detect_extrema_plain(dog.double(), opts)
    thr = 0.8 * opts.peak_threshold
    flat = dog[1:-1].reshape(-1).double().abs()
    gk, rk = set(got.flat.tolist()), set(ref.flat.tolist())
    near = {i for i in gk ^ rk if abs(float(flat[i]) - thr) <= 1e-6}
    assert gk ^ rk == near and len(rk) > 100
    order_g, order_r = torch.argsort(got.flat), torch.argsort(ref.flat)
    common = torch.isin(got.flat[order_g], ref.flat[order_r])
    g_rows = got.rows[order_g][common]
    r_rows = ref.rows[order_r][torch.isin(ref.flat[order_r], got.flat[order_g])]
    for j, name in enumerate(("x", "y", "s", "sigma", "response")):
        _close(g_rows[:, j], r_rows[:, j], 1e-4, name)

    tied = SC.tied_dog(3, 96, 128, 0, "cuda", torch.float32)
    got = KS.detect_extrema(tied, opts, capacity=16)
    ref = KS.detect_extrema_plain(tied.double(), opts)
    assert len(got.flat) == len(ref.flat) > 16
    for cap in (8, 64, 4096):
        sel_g = got.flat[KS.select_candidates(got._replace(keep=torch.ones_like(got.keep)), cap)]
        sel_r = ref.flat[KS.select_candidates(ref._replace(keep=torch.ones_like(ref.keep)), cap)]
        assert torch.equal(sel_g, sel_r)


def test_sift_orientations_and_descriptors_match_plain_on_cuda():
    """K15 and K16 against the plain versions in float64 on the selected
    keypoints of octave 0: the same ok rows and theta to 1e-3 rad except at
    keypoints whose histogram ties within 1e-5; descriptors (fed K15's
    theta) within 1 count; with upright, L2 and DSP too."""
    from colmap_tpu_torch.feature.sift import SiftOptions
    from colmap_tpu_torch.kernels import sift as KS
    from colmap_tpu_torch.kernels import sift_cases as SC

    opts, _, _, gauss, dog = _sift_octave()
    ext = KS.detect_extrema(dog, opts)
    sel = KS.select_candidates(ext, opts.max_candidates_per_octave)
    x, y, lvl, sigma, resp = KS.selected_keypoints(ext, sel)
    g64 = gauss.double()
    for o in (opts, SiftOptions(upright=True), SiftOptions(normalization="L2"),
              SiftOptions(domain_size_pooling=True)):
        theta, ok = KS.orientations(gauss, x, y, lvl, sigma, o)
        theta_p, ok_p = KS.orientations_plain(g64, x.double(), y.double(), lvl, sigma.double(), o)
        hist = KS.orientation_histograms_plain(g64, x.double(), y.double(), lvl, sigma.double())
        top = torch.sort(hist, dim=1, descending=True).values
        clear = ((top[:, 0] - top[:, 1]).abs() > 1e-5 * top[:, 0]) | o.upright
        agree = (ok == ok_p).all(dim=1)
        assert bool(agree[clear].float().mean() > 0.99), "ok rows differ"
        both = ok & ok_p & agree[:, None] & clear[:, None]
        dth = torch.remainder(theta.double() - theta_p + torch.pi, 2 * torch.pi) - torch.pi
        assert float(dth[both].abs().max()) <= 1e-3
        data, desc = KS.descriptors(gauss, x, y, lvl, sigma, resp, theta, ok, o)
        data_p, _, desc_p = KS.descriptors_plain(g64, x.double(), y.double(), lvl, sigma.double(),
                                                 resp.double(), theta.double(), o)
        rows = ok.reshape(-1)
        diff = (desc[rows].int() - desc_p[rows].int()).abs()
        assert int(diff.max()) <= 1 and rows.sum() > 50
        _close(data[rows], data_p[rows], 1e-5, "descriptor rows")


def test_feature_extractor_command_on_cuda(tmp_path):
    """feature_extractor on cuda launches K13-K16 and writes what the
    plain extraction (CPU, float32) gives: >= 97% of its keypoints within
    1e-2 px, 1e-3 relative scale and 1e-2 rad, descriptors within 2 counts."""
    _need_card()
    from colmap_tpu_torch.cli import main as cli
    from colmap_tpu_torch.feature.sift import extract_sift
    from colmap_tpu_torch.kernels import sift as KS
    from colmap_tpu_torch.kernels import sift_cases as SC
    from colmap_tpu_torch.scene.database import Database
    from colmap_tpu_torch.utils.image_io import read_image_gray

    SC.render_scene(str(tmp_path / "images"), 2, 300, 320, 240, 400.0)
    KS.reset_launches()
    path = str(tmp_path / "db.db")
    assert len(cli.main(["feature_extractor", "--database_path", path, "--image_path",
                         str(tmp_path / "images")])) == 2
    # Every SIFT kernel but K45, which only estimate_affine_shape runs.
    assert all(v > 0 for k, v in KS.LAUNCHES.items() if k != "sift_affine_shape"), KS.LAUNCHES
    db = Database(path, must_exist=True)
    for iid, name, _ in db.read_images():
        kp, desc = db.read_keypoints(iid), db.read_descriptors(iid)
        kp_p, desc_p = extract_sift(read_image_gray(str(tmp_path / "images" / name)),
                                    device="cpu")
        assert abs(len(kp) - len(kp_p)) <= 0.03 * len(kp_p)
        share, worst, _, _ = SC.match_keypoints(kp_p, desc_p, kp, desc)
        assert share >= 0.97 and worst <= 2, (share, worst)
    db.close()


# PatchMatch kernels K17-K20 on colmap_tpu_torch/kernels/mvs_cases.py's plane
# case at 96 x 64 with three source views, each float32 kernel against its
# plain version in float64 on the same inputs. A cost jumps where a window
# tap crosses a source's border (and at the other near-ties that
# mvs_cases' cost_ties and geom_ties mark); rounding decides there, so the
# costs are held to 1e-4 of their largest entry away from ties within 1e-3
# px or next to a depth step of 2%, and K18's choice away from choice_ties.
# K19 takes its angles in float64 and K20 carries its messages as odds:
# both to 1e-5.


def _pm_case(geometric):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from colmap_tpu_torch.kernels import mvs_cases as C
    from colmap_tpu_torch.mvs.patch_match import PatchMatchOptions

    case = C.plane_case(64, 96, 3, seed=5)
    return (C.tensors(case, "cuda", torch.float32, geometric),
            C.tensors(case, "cuda", torch.float64, geometric),
            PatchMatchOptions(depth_min=2.0, depth_max=10.0))


@pytest.mark.parametrize("geometric", [False, True], ids=["photometric", "geometric"])
def test_pm_cost_matches_plain_on_cuda(geometric):
    """K17 against costs_plain, away from near-ties."""
    from colmap_tpu_torch.kernels import mvs as K

    (p, d, n, _, _), (p64, d64, n64, _, _), opts = _pm_case(geometric)
    K.reset_launches()
    got = K.costs(p, d, n, opts)
    torch.cuda.synchronize()
    assert K.LAUNCHES["pm_cost"] == 1
    from colmap_tpu_torch.kernels import mvs_cases as C

    ref = K.costs_plain(p64, d64, n64, opts)
    tie = C.cost_ties(p64, d64, n64, opts, 1e-3) | C.geom_ties(p64, d64, 1e-3, 0.02)
    assert tie.double().mean() < 0.01
    _close(got[~tie], ref[~tie], 1e-4, "K17")


def test_pm_view_weights_and_selection_match_plain_on_cuda():
    """K19's weights and K20 along H and W against their plain versions."""
    from colmap_tpu_torch.kernels import mvs as K

    (p, d, n, sel, _), (p64, d64, n64, sel64, _), opts = _pm_case(True)
    w = K.view_weights(p, d, n, sel, opts)
    err = (w.double() - K.view_weights_plain(p64, d64, n64, sel64, opts)).abs().max().item()
    assert err <= 1e-5, f"K19 weights: {err:.3e}"
    ca = K.costs_plain(p64, d64, n64, opts)
    for axis in (0, 1):
        got = K.update_sel_prob(ca.float(), sel, axis, 0.4, opts)
        err = (got.double() - K.update_sel_prob_plain(ca, sel64, axis, 0.4, opts)).abs().max()
        assert err.item() <= 1e-5, f"K20 axis {axis}: {err.item():.3e}"


@pytest.mark.parametrize("view_selection", [True, False], ids=["weights", "best_half"])
def test_pm_iteration_matches_plain_on_cuda(view_selection):
    """K18 at both parities: the plain version's choice at every pixel away
    from choice_ties (at least 99.9% of all pixels), its depth and normal
    there, and its costs at those of them that are not ties."""
    import dataclasses

    from colmap_tpu_torch.kernels import mvs as K
    from colmap_tpu_torch.kernels import mvs_cases as C

    (p, d, n, sel, dr), (p64, d64, n64, sel64, dr64), opts = _pm_case(True)
    opts = dataclasses.replace(opts, view_selection=view_selection)
    ca = K.costs_plain(p64, d64, n64, opts)
    w64 = K.view_weights_plain(p64, d64, n64, sel64, opts) if view_selection else None
    cost = K.aggregate(ca, w64)
    for parity in (0, 1):
        got = K.iteration(p, d, n, cost.float(), ca.float(), None if w64 is None else w64.float(),
                          dr, parity, 0.5, opts)
        ref = K.iteration_plain(p64, d64, n64, cost, ca, w64, dr64, parity, 0.5, opts)
        ties = C.choice_ties(p64, d64, n64, cost, w64, dr64, parity, 0.5, opts, 1e-3, 1e-4, 0.02)
        same = (((got[0].double() - ref[0]).abs() <= 1e-5 * ref[0])
                & ((got[1].double() - ref[1]).abs().amax(-1) <= 1e-4))
        assert bool(same[~ties].all()), f"parity {parity}: {int((~same & ~ties).sum())} differ"
        assert same.double().mean() >= 0.999
        agree = same & ~ties
        _close(got[2][agree], ref[2][agree], 1e-4, "K18 cost")
        _close(got[3][:, agree], ref[3][:, agree], 1e-4, "K18 cost_all")


@pytest.mark.parametrize("view_selection", [True, False], ids=["weights", "best_half"])
def test_pm_consistency_filter_matches_plain_on_cuda(view_selection):
    """K19's filter mode: the same masks and kept maps away from pixels
    within 1e-5 of a threshold (1e-2 px for the geometric error)."""
    import dataclasses

    from colmap_tpu_torch.kernels import mvs as K
    from colmap_tpu_torch.kernels import mvs_cases as C

    (p, d, n, sel, _), (p64, d64, n64, sel64, _), opts = _pm_case(True)
    opts = dataclasses.replace(opts, view_selection=view_selection)
    ca = K.costs_plain(p64, d64, n64, opts)
    df, nf, mask = K.consistency_filter(p, d, n, ca.float(), sel, opts)
    df64, nf64, mask64 = K.consistency_filter_plain(p64, d64, n64, ca, sel64, opts)
    ok = ~C.filter_ties(p64, d64, n64, ca, sel64, opts, 1e-5, 1e-3, 0.02, 1e-2)
    assert bool(mask64.any())
    assert torch.equal(mask[:, ok], mask64[:, ok])
    _close(df[ok], df64[ok], 1e-6, "K19 depth")
    _close(nf[ok], nf64[ok], 1e-6, "K19 normal")


@pytest.mark.parametrize("view_selection", [True, False], ids=["weights", "best_half"])
@pytest.mark.parametrize("geometric", [False, True], ids=["photometric", "geometric"])
def test_pm_iteration_keeps_the_plane_where_no_source_sees_the_window(view_selection,
                                                                     geometric):
    """K18 where every source looks away: each view of every candidate
    returns the no-view cost (2.0, plus the clamped geometric term), every
    plane costs the same in exact arithmetic, and the float64 plain version
    keeps the incumbent; so must the kernel, at every pixel, under random
    normalised weights whose float32 sums round otherwise."""
    import dataclasses

    from colmap_tpu_torch.kernels import mvs as K

    (p, d, n, _, dr), (p64, d64, n64, _, dr64), opts = _pm_case(geometric)
    away = torch.tensor([1e3, 0.0, 0.0], device="cuda")
    p, p64 = p._replace(t_rel=p.t_rel + away), p64._replace(t_rel=p64.t_rel + away.double())
    opts = dataclasses.replace(opts, view_selection=view_selection)
    ca = K.costs_plain(p64, d64, n64, opts)
    assert bool((ca == ca.flatten()[0]).all()), "a source sees a window"
    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    w64 = None
    if view_selection:
        w64 = torch.rand(ca.shape, generator=gen, device="cuda", dtype=torch.float64) + 0.05
        w64 = w64 / w64.sum(0, keepdim=True)
    cost = K.aggregate(ca, w64)
    for parity in (0, 1):
        got = K.iteration(p, d, n, cost.float(), ca.float(), None if w64 is None else w64.float(),
                          dr, parity, 0.5, opts)
        ref = K.iteration_plain(p64, d64, n64, cost, ca, w64, dr64, parity, 0.5, opts)
        assert torch.equal(ref[0], d64) and torch.equal(ref[1], n64)
        moved = int(((got[0] != d) | (got[1] != n).any(-1)).sum())
        assert moved == 0, f"parity {parity}: {moved} planes moved"


# K18's launch plans beyond the 64 x 96, three-view case above: odd sides
# (the last tile's rows and columns, the parity's wrap), a window of radius
# 3 and step 2 (the generic instantiation), one view and nine (the second
# view bucket), two and four views (best-half over an even count), and
# 1001 columns, whose 4004-byte rows miss any texture pitch alignment.
# Each is held as test_pm_iteration_matches_plain_on_cuda holds the default.
@pytest.mark.parametrize("view_selection", [True, False], ids=["weights", "best_half"])
@pytest.mark.parametrize("H, W, views, radius, step", [
    (63, 97, 3, 2, 1), (64, 96, 3, 3, 2), (40, 64, 1, 2, 1), (40, 64, 9, 2, 1),
    (40, 64, 2, 2, 1), (40, 64, 4, 3, 2), (24, 1001, 2, 2, 1)],
    ids=["odd_sides", "r3_step2", "one_view", "nine_views", "two_views", "four_views_r3",
         "w1001"])
def test_pm_iteration_plans_match_plain_on_cuda(H, W, views, radius, step, view_selection):
    import dataclasses

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from colmap_tpu_torch.kernels import mvs as K
    from colmap_tpu_torch.kernels import mvs_cases as C
    from colmap_tpu_torch.mvs.patch_match import PatchMatchOptions

    case = C.plane_case(H, W, views, seed=11)
    p, d, n, sel, dr = C.tensors(case, "cuda", torch.float32, True)
    p64, d64, n64, sel64, dr64 = C.tensors(case, "cuda", torch.float64, True)
    opts = PatchMatchOptions(depth_min=2.0, depth_max=10.0, window_radius=radius,
                             window_step=step, view_selection=view_selection)
    plan = K.iteration_plan(views, radius, step)
    assert plan.fixed_window == ((radius, step) == (2, 1))
    assert plan.bucket == (8 if views <= 8 else 16)
    ca = K.costs_plain(p64, d64, n64, opts)
    w64 = K.view_weights_plain(p64, d64, n64, sel64, opts) if view_selection else None
    cost = K.aggregate(ca, w64)
    K.reset_launches()
    for parity in (0, 1):
        got = K.iteration(p, d, n, cost.float(), ca.float(), None if w64 is None else w64.float(),
                          dr, parity, 0.5, opts)
        ref = K.iteration_plain(p64, d64, n64, cost, ca, w64, dr64, parity, 0.5, opts)
        ties = C.choice_ties(p64, d64, n64, cost, w64, dr64, parity, 0.5, opts, 1e-3, 1e-4, 0.02)
        same = (((got[0].double() - ref[0]).abs() <= 1e-5 * ref[0])
                & ((got[1].double() - ref[1]).abs().amax(-1) <= 1e-4))
        assert bool(same[~ties].all()), f"parity {parity}: {int((~same & ~ties).sum())} differ"
        assert same.double().mean() >= 0.99
        agree = same & ~ties
        _close(got[2][agree], ref[2][agree], 1e-4, "K18 cost")
        _close(got[3][:, agree], ref[3][:, agree], 1e-4, "K18 cost_all")
        inactive = (torch.arange(H, device="cuda")[:, None]
                    + torch.arange(W, device="cuda")[None]) % 2 != parity
        assert torch.equal(got[0][inactive], d[inactive])
        assert torch.equal(got[3][:, inactive], ca.float()[:, inactive])
    assert K.LAUNCHES["pm_iteration"] == 2
    assert K.SHAPES.counts == {("pm_iteration", "weights" if view_selection else "best_half",
                                views, H, W, (2 * radius // step + 1) ** 2, 1): 2}


def test_pm_iteration_sources_are_made_once_a_problem_on_cuda():
    """K18's textures are made at a problem's first half-iteration and
    reused until its source images change, in place or for another
    tensor."""
    from colmap_tpu_torch.kernels import mvs as K

    (p, d, n, _, dr), _, opts = _pm_case(False)
    ca = K.costs(p, d, n, opts)
    cost = K.aggregate(ca, None)
    first = K.iteration(p, d, n, cost, ca, None, dr, 0, 0.5, opts)
    made = K._SOURCES["set"]
    again = K.iteration(p, d, n, cost, ca, None, dr, 0, 0.5, opts)
    assert K._SOURCES["set"] is made
    for a, b in zip(first, again):
        assert torch.equal(a, b)
    p.src_images.mul_(0.5)  # in place: the copy is made again
    K.iteration(p, d, n, cost, ca, None, dr, 0, 0.5, opts)
    assert K._SOURCES["set"] is not made and not made.free.alive
    other = p._replace(src_images=p.src_images.clone())
    K.iteration(other, d, n, cost, ca, None, dr, 0, 0.5, opts)
    assert K._SOURCES["set"].key[0] == other.src_images.data_ptr()


def test_launch_shapes_follow_launches_and_graph_replays_on_cuda():
    """A wrapper's launch shape is counted with its launch; a captured step
    moves its shapes to the replays, as its launches; a call is kept at a
    shape class only outside a capture."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from colmap_tpu_torch.kernels import solver as KS
    from colmap_tpu_torch.utils import cuda_graph

    n = 1000
    M = torch.rand(n, device="cuda") + 1.0
    b = torch.rand(n, device="cuda")
    KS.reset_launches()
    KS.SHAPES.reset_samples()
    KS.SHAPES.sampling = True
    try:
        KS.pcg_setup_diag(M, b)
        assert KS.SHAPES.counts == {("ba_pcg", "setup_diag", n): 1}
        assert list(KS.SHAPES.samples) == [("ba_pcg", "setup_diag", 1024)]
        KS.SHAPES.reset_samples()
        replay, _, _, _ = cuda_graph.capture(lambda: KS.pcg_setup_diag(M, b),
                                             torch.device("cuda"), (KS,))
        assert KS.LAUNCHES["ba_pcg"] == 1 and KS.SHAPES.counts[("ba_pcg", "setup_diag", n)] == 1
        assert not KS.SHAPES.samples
        replay()
        replay()
        torch.cuda.synchronize()
        assert KS.LAUNCHES["ba_pcg"] == 3 and KS.SHAPES.counts[("ba_pcg", "setup_diag", n)] == 3
    finally:
        KS.SHAPES.sampling = False
        KS.SHAPES.reset_samples()


# K21-K23 against their float64 plain versions on the same float32 inputs, on
# colmap_tpu_torch/kernels/global_cases.py's cases at small sizes. Each sum is
# a gather in a fixed order (no atomics); K21 in float32 to 1e-5 of each
# output's largest entry, K22 (3x3 inverses of float32 point blocks) to
# 1e-4; K23's per-edge arithmetic runs in float64: its loss to 1e-5, its
# gradient to 1e-4 away from cameras on near-degenerate edges.


def _ra_case(gravity):
    _need_card()
    from colmap_tpu_torch.kernels import global_cases as C
    from colmap_tpu_torch.kernels import global_sfm as G

    case = C.rotation_case(60, 400, seed=2)
    rng = np.random.default_rng(3)
    quats = C.random_quats(rng, 60)
    free = np.ones(60)
    free[0] = 0.0
    proj = None
    if gravity:
        g = np.array([0.0, 1.0, 0.0])
        proj = np.tile(np.eye(3), (60, 1, 1))
        proj[::2] = np.outer(g, g)

    def graph(dt):
        t = lambda a: torch.as_tensor(a, dtype=dt, device="cuda")  # noqa: E731
        return G.ra_graph(60, torch.as_tensor(case.edges, device="cuda"), t(case.rel_quats),
                          t(free), None if proj is None else t(proj))

    q32 = torch.as_tensor(quats, dtype=torch.float32, device="cuda")
    return G, graph(torch.float32), graph(torch.float64), q32


@pytest.mark.parametrize("gravity", [False, True], ids=["free", "gravity"])
@pytest.mark.parametrize("use_l1", [True, False], ids=["l1", "geman_mcclure"])
def test_rotation_averaging_kernel_matches_plain_on_cuda(use_l1, gravity):
    """K21's three entries."""
    G, g32, g64, q32 = _ra_case(gravity)
    G.reset_launches()
    step = G.ra_edge_pass(g32, q32, use_l1, np.deg2rad(5.0))
    ref = G.ra_edge_pass_plain(g64, q32.double(), use_l1, np.deg2rad(5.0))
    for name in ("ew", "b", "deg", "cost"):
        _close(getattr(step, name), getattr(ref, name), 1e-5, f"K21 {name}")
    x = torch.randn(60, 3, device="cuda")
    _close(G.ra_matvec(g32, step.ew, x), G.ra_matvec_plain(g64, step.ew.double(), x.double()),
           1e-5, "K21 matvec")
    delta = 0.1 * torch.randn(60, 3, device="cuda")
    _close(G.ra_update(q32, delta), G.ra_update_plain(q32.double(), delta.double()), 1e-5,
           "K21 update")
    torch.cuda.synchronize()
    assert G.LAUNCHES["rotation_averaging"] == 3


def test_global_positioning_kernel_matches_plain_on_cuda():
    """K22's setup, Schur matvec and back-substitution."""
    _need_card()
    from colmap_tpu_torch.kernels import global_cases as C
    from colmap_tpu_torch.kernels import global_sfm as G

    case = C.positioning_case(30, 400, 5, seed=4)
    rng = np.random.default_rng(5)

    def prob(dt):
        t = lambda a: torch.as_tensor(a, dtype=dt, device="cuda")  # noqa: E731
        return G.gp_problem(t(case.dirs), t(case.obs_cam).int(), t(case.obs_point).int(),
                            t(np.ones(len(case.dirs))), 7, 100.0, 30, 400, 0.1)

    p32, p64 = prob(torch.float32), prob(torch.float64)
    p64 = p64._replace(eps_rel=p32.eps_rel, anchor_dir=p32.anchor_dir)
    c = torch.as_tensor(rng.standard_normal((30, 3)), dtype=torch.float32, device="cuda")
    X = torch.as_tensor(rng.standard_normal((400, 3)), dtype=torch.float32, device="cuda")
    G.reset_launches()
    sys = G.gp_setup(p32, c, X)
    ref = G.gp_setup_plain(p64, c.double(), X.double())
    for name in G.GPSystem._fields:
        _close(getattr(sys, name), getattr(ref, name), 1e-4, f"K22 {name}")
    xc = torch.randn(30, 3, device="cuda")
    sys64 = G.GPSystem(*(t.double() for t in sys))
    _close(G.gp_schur_matvec(p32, sys, xc), G.gp_schur_matvec_plain(p64, sys64, xc.double()),
           1e-4, "K22 matvec")
    got = G.gp_back_substitute(p32, sys, xc, c, X)
    want = G.gp_back_substitute_plain(p64, sys64, xc.double(), c.double(), X.double())
    _close(got[0], want[0], 1e-5, "K22 centers")
    _close(got[1] - X, want[1] - X.double(), 1e-4, "K22 point steps")
    torch.cuda.synchronize()
    assert G.LAUNCHES["global_positioning"] == 3


def test_view_graph_calibration_kernel_matches_plain_on_cuda():
    """K23's loss and gradient, and its autograd form."""
    _need_card()
    from colmap_tpu_torch.kernels import global_cases as C
    from colmap_tpu_torch.kernels import global_sfm as G

    case = C.calibration_case(10, 60, seed=6)
    graph = G.vgc_graph(*(torch.as_tensor(a, device="cuda") for a in
                          (case.Fs, case.e1, case.e2, case.priors, case.pps)))
    for x in (torch.zeros(10, device="cuda"),
              torch.as_tensor(np.log(case.true_focals / case.priors), dtype=torch.float32,
                              device="cuda") + 0.01 * torch.randn(10, device="cuda")):
        G.reset_launches()
        loss, grad = G.vgc_loss_grad(graph, x)
        x64 = x.double().requires_grad_()
        ref = G.vgc_loss_plain(graph, x64)
        (ref_g,) = torch.autograd.grad(ref, x64)
        _close(loss, ref.detach(), 1e-5, "K23 loss")
        near = C.calibration_near_ties(graph, x)
        _close(grad[~near], ref_g[~near], 1e-4, "K23 gradient")
        xg = x.clone().requires_grad_()
        (g2,) = torch.autograd.grad(G.vgc_loss(graph, xg) * 2.0, xg)
        _close(g2, 2.0 * grad, 1e-7, "K23 backward")
        torch.cuda.synchronize()
        assert G.LAUNCHES["view_graph_calibration"] == 2


def _rig_case(model_id, empty_sensor):
    from colmap_tpu_torch.estimators import bundle_adjustment as ba
    from colmap_tpu_torch.estimators import bundle_adjustment_rig as rba
    from colmap_tpu_torch.kernels import rig_cases as RC

    p, _, _ = RC.rig_ba_problem(8, 3, 300, 5, model_id=model_id, seed=model_id, device="cuda")
    if empty_sensor:
        p = RC.with_empty_sensor(p)
    opts = ba.BAOptions(loss="cauchy", refine_principal_point=True)
    masks = rba.default_masks(p, model_id, opts, const_frames=[2])
    masks = rba.fix_gauge_two_frames(masks, 0, 1)
    return p, opts, rba._obs_masks(masks, opts), rba._obs(p), rba._layout(p)


@pytest.mark.parametrize("model_id", range(5))
def test_rig_ba_kernels_match_plain_on_cuda(model_id):
    """K24-K26 against their float64 plain versions: models 0-4, Cauchy, a
    constant frame, the reference sensor and (model 2) an empty sensor and
    camera row; the reductions are the same in two runs."""
    _need_card()
    from colmap_tpu_torch.kernels import rig as KR

    p, opts, om, obs, layout = _rig_case(model_id, empty_sensor=model_id == 2)
    p64 = type(p)(*_f64(*p))
    om64 = type(om)(*_f64(*om))
    args = (model_id, opts.loss, opts.loss_scale)
    KR.reset_launches()
    jac = KR.rig_obs_jacobians(*p[:6], obs, *om, *args)
    ref = KR.rig_obs_jacobians_plain(*p64[:6], type(obs)(*_f64(*obs)), *om64, *args)
    for name, a, b in zip(KR.RigJacobians._fields, jac, ref):
        _close(a, b, 1e-4, f"K24 {name}")
    _close(KR.rig_obs_cost(*p[:6], obs, *args),
           KR.rig_obs_cost_plain(*p64[:6], type(obs)(*_f64(*obs)), *args), 1e-5, "K24 cost")
    jac64 = KR.RigJacobians(*_f64(*jac))
    red = KR.rig_lm_reduce(jac, obs, layout, 1e-3)
    red64 = KR.rig_lm_reduce_plain(jac64, obs, layout, 1e-3)
    for name in KR.RigReduction._fields:
        _close(getattr(red, name), getattr(red64, name), 1e-4, f"K25 {name}")
    again = KR.rig_lm_reduce(jac, obs, layout, 1e-3)
    for a, b in zip(red, again):
        assert torch.equal(a, b)
    x = torch.randn(layout.num_frames + layout.num_sensors + layout.num_cams, KR.W,
                    device="cuda") * (red.diag != 0)
    red64 = KR.RigReduction(*_f64(*red))
    out = KR.rig_schur_matvec(jac, obs, layout, red.Hpp_inv, red.lam_diag, x)
    _close(out, KR.rig_schur_matvec_plain(jac64, obs, layout, red64.Hpp_inv, red64.lam_diag,
                                          x.double()), 1e-4, "K26 matvec")
    assert torch.equal(out, KR.rig_schur_matvec(jac, obs, layout, red.Hpp_inv, red.lam_diag, x))
    _close(KR.rig_back_substitute(jac, obs, layout, red.Hpp_inv, red.gx, x),
           KR.rig_back_substitute_plain(jac64, obs, layout, red64.Hpp_inv, red64.gx,
                                        x.double()), 1e-4, "K26 back-substitution")
    torch.cuda.synchronize()
    assert KR.LAUNCHES == {"rig_ba_jacobians": 2, "rig_ba_reduce": 2, "rig_ba_matvec": 3,
                           "gen_abs_ransac": 0, "rig_lm_update": 0, "gen_abs_refine": 0,
                           "gen_rel_ransac": 0}


def test_rig_solve_matches_plain_on_cuda():
    """rig BA solve, 5 LM iterations, through K24-K26 and through the
    float64 plain versions on the card: final costs within 1e-3."""
    _need_card()
    from colmap_tpu_torch.estimators import bundle_adjustment as ba
    from colmap_tpu_torch.estimators import bundle_adjustment_rig as rba
    from colmap_tpu_torch.kernels import rig as KR
    from colmap_tpu_torch.kernels import rig_cases as RC

    p, _, model_id = RC.rig_ba_problem(10, 3, 500, 5, seed=3, device="cuda")
    opts = ba.BAOptions(max_iterations=5, pcg_iterations=20, loss="cauchy",
                        function_tolerance=0.0)
    masks = rba.fix_gauge_two_frames(rba.default_masks(p, model_id, opts), 0, 1)
    _, cost, _ = rba._lm_loop(p, model_id, opts, masks)
    p64 = type(p)(*_f64(*p))
    masks64 = type(masks)(*_f64(*masks))
    _, cost64, _ = rba._lm_loop(p64, model_id, opts, masks64, kernels=KR.PLAIN)
    assert abs(cost - cost64) <= 1e-3 * cost64


@pytest.mark.parametrize("world_scale", [1.0, 0.37])
def test_gen_abs_ransac_matches_plain_on_cuda(world_scale):
    """K27 on 256 injected samples against its float64 plain version: every
    count within the rows near the threshold, the same best sample or a
    near-tie, all-inlier models to 1e-3, inlier masks equal off the near
    rows."""
    _need_card()
    from colmap_tpu_torch.kernels import rig as KR
    from colmap_tpu_torch.kernels import rig_cases as RC
    from colmap_tpu_torch.optim.ransac import unpack_best

    data64, _, inl = RC.gen_abs_case(500, seed=9, world_scale=world_scale, device="cuda")
    data = KR.GenAbsData(*(t.float() if t.is_floating_point() else t for t in data64))
    samples = RC.injected_samples(500, 256, 10, inl, device="cuda")
    max_sq = 144.0
    KR.reset_launches()
    m, c, b = KR.gen_abs_propose_score(data, samples, max_sq, True)
    m64, c64, b64 = KR.gen_abs_propose_score_plain(data64, samples, max_sq, True)
    count_ok, best_ok, near, tie = RC.ransac_agreement(
        c, unpack_best(int(b[0])), m64, c64, unpack_best(int(b64[0])), data64, max_sq)
    assert count_ok and best_ok, (near, tie)
    full = c64 >= 0.9 * c64.max()
    _close(m[full], m64[full], 1e-3, "K27 models")
    best = unpack_best(int(b64[0]))[1]
    inl_k = KR.gen_abs_inliers(data, m64[best].float(), max_sq)
    res = KR.gen_abs_residuals(m64[best][None], data64)[0]
    far = (res - max_sq).abs() > 1e-3 * max_sq
    assert torch.equal(inl_k[far], (res <= max_sq)[far])
    torch.cuda.synchronize()
    assert KR.LAUNCHES["gen_abs_ransac"] == 2


# K28-K31 against their float64 plain versions on the same float32 inputs, on
# colmap_tpu_torch/kernels/retrieval_cases.py's cases. K28 and K30 take
# Σ (x - c)² directly in float32: every index equals the float64 one except
# at near-ties (best two float64 distances within 1e-5 of the best), each
# chosen centroid within 1e-5 of the nearest's float64 distance, and on
# planted exact ties (two equal centroids) the lowest index wins. K29 sums
# in float64 in a fixed order: within half a float32 ulp of the float64 mean
# (2e-7 of the scale), the same counts, and the same bits in two runs. K31
# sums float32 products in k order: within 1e-5 of the scale.


def _retrieval_rows(n, seed):
    rng = np.random.default_rng(seed)
    return rng, rng.integers(0, 256, (n, 128)).astype(np.float32)


def test_retrieval_assign_flat_matches_plain_on_cuda():
    """K28 on 20 000 uint8-valued rows and 1024 words, word 900 a copy of
    word 5 and 50 rows at word 5."""
    _need_card()
    from colmap_tpu_torch.kernels import retrieval as KT
    from colmap_tpu_torch.kernels import retrieval_cases as TC

    rng, x = _retrieval_rows(20000, 11)
    vocab = (x[rng.choice(20000, 1024, replace=False)]
             + rng.normal(0, 8.0, (1024, 128))).astype(np.float32)
    vocab[900] = vocab[5]
    x[:50] = vocab[5]
    xt, vt = torch.as_tensor(x, device="cuda"), torch.as_tensor(vocab, device="cuda")
    KT.reset_launches()
    got = KT.assign(xt, vt).cpu().numpy()
    want, near = (t.cpu().numpy() for t in KT.nearest64(xt, vt))
    TC.agree(got, want, near, "K28 flat")
    assert float(KT.excess64(xt, vt, torch.as_tensor(got, device="cuda"))[1].max()) <= KT.NEAR_TIE
    assert (got[:50] == 5).all() and (want[:50] == 5).all()
    torch.cuda.synchronize()
    assert KT.LAUNCHES["retrieval_assign"] == 1


def test_retrieval_level_step_matches_plain_on_cuda():
    """K28 and K29 over one tree level's segments: 512 nodes x 8 children,
    rows of 400 nodes (other nodes and some children empty), node 7's
    children 2 and 6 equal."""
    _need_card()
    from colmap_tpu_torch.kernels import retrieval as KT
    from colmap_tpu_torch.kernels import retrieval_cases as TC

    rng, x = _retrieval_rows(30000, 12)
    nodes = rng.integers(0, 400, 30000).astype(np.int32)
    cents = rng.integers(0, 256, (512 * 8, 128)).astype(np.float32)
    cents[7 * 8 + 6] = cents[7 * 8 + 2]
    x[nodes == 7] = cents[7 * 8 + 2]
    xt, ct = torch.as_tensor(x, device="cuda"), torch.as_tensor(cents, device="cuda")
    gt = torch.as_tensor(nodes, device="cuda")
    KT.reset_launches()
    child = KT.assign(xt, ct, gt, 8)
    want, near = (t.cpu().numpy() for t in KT.nearest64(xt, ct, gt, 8))
    TC.agree(child.cpu().numpy(), want, near, "K28 grouped")
    assert float(KT.excess64(xt, ct, child, gt, 8)[1].max()) <= KT.NEAR_TIE
    assert (child.cpu().numpy()[nodes == 7] == 2).all()
    seg = gt.long() * 8 + child.long()
    new, counts = KT.update(xt, seg, ct)
    new2, counts2 = KT.update(xt, seg, ct)
    ref, ref_counts = KT.update_plain(xt, seg, ct.double())
    _close(new, ref, 2e-7, "K29 centroids")
    assert torch.equal(counts, ref_counts) and torch.equal(new, new2) and torch.equal(counts, counts2)
    empty = counts == 0
    assert empty[400 * 8:].all() and torch.equal(new[empty], ct[empty])
    torch.cuda.synchronize()
    assert KT.LAUNCHES["retrieval_assign"] == 1 and KT.LAUNCHES["retrieval_update"] == 2


def _descend_both(KT, TC, xt, flat, B, L, label):
    """K30 in both regimes against descend64 on at least
    DESCEND_SORTED_MIN_ROWS rows: all of them in one call (sorted passes)
    and in calls of fewer rows (a warp a row), each twice; equal but at
    near-ties, the choices within NEAR_TIE of the nearest, and the two
    regimes' leaves the same bits (their arithmetic is one). Returns the
    leaves and float64's (numpy) and the number of calls made."""
    n, D = xt.shape
    chunks = xt.split(KT.DESCEND_SORTED_MIN_ROWS - 1)
    assert KT._descend_plan(n, B, L, D).regime == "sorted"
    assert all(KT._descend_plan(len(c), B, L, D).regime == "direct" for c in chunks)
    want, near = (t.cpu().numpy() for t in KT.descend64(xt, flat, B, L))
    runs = {"sorted": lambda: KT.descend(xt, flat, B, L),
            "direct": lambda: torch.cat([KT.descend(c, flat, B, L) for c in chunks])}
    out = {}
    for regime, run in runs.items():
        got = run()
        assert torch.equal(got, run()), f"K30 {label}, {regime}: two runs differ"
        TC.agree(got.cpu().numpy(), want, near, f"K30 {label}, {regime}")
        assert float(KT.descend_excess64(xt, flat, B, L, got)[1].max()) <= KT.NEAR_TIE
        out[regime] = got
    assert torch.equal(out["direct"], out["sorted"]), f"K30 {label}: the regimes differ"
    return out["sorted"].cpu().numpy(), want, 2 * (1 + len(chunks))


def test_retrieval_descend_matches_plain_on_cuda():
    """K30 on a branching-8, depth-5 tree (32 768 leaves) with 40 planted
    exact ties, on DESCEND_SORTED_MIN_ROWS rows beside its leaves and the
    planted rows, in both regimes (sorted passes over all rows, a warp a
    row in calls of fewer), which give the same bits."""
    _need_card()
    from colmap_tpu_torch.kernels import retrieval as KT
    from colmap_tpu_torch.kernels import retrieval_cases as TC

    rng = np.random.default_rng(13)
    levels = TC.random_tree(rng, 8, 5)
    tied, first, lvl, node = TC.plant_ties(rng, levels, 40)
    n = KT.DESCEND_SORTED_MIN_ROWS
    x = np.concatenate([TC.near_leaves(rng, levels, n), tied])
    flat = torch.cat([torch.as_tensor(lv, device="cuda").reshape(-1, 128) for lv in levels])
    xt = torch.as_tensor(x, device="cuda")
    KT.reset_launches()
    got, want, calls = _descend_both(KT, TC, xt, flat, 8, 5, "8^5")
    assert (got[n:] == want[n:]).all()
    at_node = want[n:] // 8 ** (5 - lvl) == node
    assert at_node.sum() >= 30
    digit = want[n:] // 8 ** (4 - lvl) % 8
    assert (digit[at_node] == first[at_node]).all()
    torch.cuda.synchronize()
    assert KT.LAUNCHES["retrieval_descend"] == calls
    assert KT.DESCEND_CALLS == {"direct": calls - 2, "sorted": 2}
    assert KT.DESCEND_ROWS == {"direct": 2 * len(x), "sorted": 2 * len(x)}


@pytest.mark.parametrize("case", ["b10", "d64", "l1", "l2", "skewed", "wide", "none"])
def test_retrieval_descend_regime_cases_on_cuda(case):
    """K30's two regimes against descend64 (DESCEND_SORTED_MIN_ROWS rows,
    all in one call and in calls of fewer): B = 10 at depth 4 with planted
    ties (chunks of 8 and 2 children); D = 64; depth 1 and 2 (one sorted
    pass); every row beside one leaf (one node holds all rows at every
    level: a skewed bucket); B = 32 at depth 2 (B + B² rows exceed the
    shared-memory budget: passes of one level); no rows (no launch)."""
    _need_card()
    from colmap_tpu_torch.kernels import retrieval as KT
    from colmap_tpu_torch.kernels import retrieval_cases as TC

    B, L, D = {"b10": (10, 4, 128), "d64": (8, 3, 64), "l1": (8, 1, 128), "l2": (8, 2, 128),
               "skewed": (8, 4, 128), "wide": (32, 2, 128), "none": (8, 3, 128)}[case]
    n = KT.DESCEND_SORTED_MIN_ROWS
    rng = np.random.default_rng(30)
    levels = TC.random_tree(rng, B, L, dim=D)
    rows = [TC.near_leaves(rng, levels, n)]
    if case == "b10":
        rows.append(TC.plant_ties(rng, levels, 30)[0])
    elif case == "skewed":
        leaf = levels[-1].reshape(-1, D)[1234]
        rows = [(leaf + rng.normal(0.0, 0.05, (n, D))).astype(np.float32)]
    elif case == "none":
        rows = [np.zeros((0, D), np.float32)]
    x = torch.as_tensor(np.concatenate(rows), device="cuda")
    flat = torch.cat([torch.as_tensor(lv, device="cuda").reshape(-1, D) for lv in levels])
    plan = KT._descend_plan(x.shape[0], B, L, D)
    assert plan.passes == {"b10": ((0, 2), (2, 4)), "d64": ((0, 2), (2, 3)), "l1": ((0, 1),),
                           "l2": ((0, 2),), "skewed": ((0, 2), (2, 4)),
                           "wide": ((0, 1), (1, 2)), "none": ()}[case]
    KT.reset_launches()
    if case == "none":
        assert KT.descend(x, flat, B, L).shape == (0,)
        assert KT.LAUNCHES["retrieval_descend"] == 0
        return
    got, want, calls = _descend_both(KT, TC, x, flat, B, L, case)
    if case == "skewed":
        assert (want == 1234).all() and (got == 1234).all()
    torch.cuda.synchronize()
    assert KT.LAUNCHES["retrieval_descend"] == calls


def test_retrieval_gram_matches_plain_on_cuda():
    """K31 on a sparse 300 x 5000 W (neither a multiple of the 32-wide tiles)
    with rows 7 and 250 equal: within 1e-5 of the scale, exactly symmetric,
    the same bits in two runs, rows 7 and 250 of S equal."""
    _need_card()
    from colmap_tpu_torch.kernels import retrieval as KT

    rng = np.random.default_rng(14)
    w = rng.random((300, 5000)) * (rng.random((300, 5000)) < 0.06)
    w[250] = w[7]
    w /= np.linalg.norm(w, axis=1, keepdims=True)
    wt = torch.as_tensor(w, dtype=torch.float32, device="cuda")
    KT.reset_launches()
    got, again = KT.gram(wt), KT.gram(wt)
    _close(got, KT.gram_plain(wt.double()), 1e-5, "K31")
    assert torch.equal(got, again) and torch.equal(got, got.T)
    assert torch.equal(got[7], got[250])
    torch.cuda.synchronize()
    assert KT.LAUNCHES["retrieval_gram"] == 2


def _gram_case(case):
    """W (float32, rows L2-normalized) for K31's cases: "stop_word" a
    300 x 5000 W with word 0 in every row (a list of length n) and row 11
    all zero; "odd" 333 x 4097 (no tile's multiple); "wide_n" 5000 x 2000,
    beyond one block's 4096-image accumulator; "scaled" the stop-word W
    times 1e3 (a smaller 2^F); "dense" 300 x 64 and "dense_chosen" 600 x
    1024, every entry nonzero (the dense regime, by shape and as the card
    chooses it)."""
    rng = np.random.default_rng(31)
    n, K, p = {"stop_word": (300, 5000, 0.06), "odd": (333, 4097, 0.05),
               "wide_n": (5000, 2000, 0.02), "scaled": (300, 5000, 0.06),
               "dense": (300, 64, 1.0), "dense_chosen": (600, 1024, 1.0)}[case]
    w = rng.random((n, K)) * (rng.random((n, K)) < p) + (1e-3 if p == 1.0 else 0.0)
    if case in ("stop_word", "scaled"):
        w[:, 0] = rng.uniform(0.2, 1.0, n)
        w[11] = 0.0
    w /= np.maximum(np.linalg.norm(w, axis=1, keepdims=True), 1e-12)
    return w * (1e3 if case == "scaled" else 1.0)


@pytest.mark.parametrize("case", ["stop_word", "odd", "wide_n", "scaled", "dense", "dense_chosen"])
def test_retrieval_gram_cases_on_cuda(case):
    """K31 on its edge cases: within 1e-5 of float64, exactly symmetric,
    the same bits in two runs; on the sparse cases the bits of the integer
    model (gram_fixed_plain) where it is cheap to form, and an all-zero row
    gives a zero row and column."""
    _need_card()
    from colmap_tpu_torch.kernels import retrieval as KT

    wt = torch.as_tensor(_gram_case(case), dtype=torch.float32, device="cuda")
    KT.reset_launches()
    got, again = KT.gram(wt), KT.gram(wt)
    _close(got, KT.gram_plain(wt.double()), 1e-5, f"K31 {case}")
    assert torch.equal(got, again) and torch.equal(got, got.T)
    if case in ("stop_word", "odd", "scaled"):
        assert torch.equal(got, KT.gram_fixed_plain(wt))
    if case in ("stop_word", "scaled"):
        assert (got[11] == 0).all()
    torch.cuda.synchronize()
    assert KT.LAUNCHES["retrieval_gram"] == 2


@pytest.mark.parametrize("density", [0.01, 1.0])
def test_retrieval_gram_beyond_int_entries_on_cuda(density):
    """K31 on a 2048 x (2^20 + 1) W, 2^31 + 2048 entries (8.6 GB), made on
    the card: 1% nonzero with a stop word (the inverted file, its counts
    and fills indexed past 2^31) and all nonzero (more nonzeros than the
    lists hold, so the card runs the dense kernel). Within 1e-5 of float64
    (summed over slices of K), exactly symmetric, the same bits twice."""
    _need_card()
    from colmap_tpu_torch.kernels import retrieval as KT

    n, K = 2048, (1 << 20) + 1
    g = torch.Generator(device="cuda").manual_seed(31)
    w = torch.rand(n, K, device="cuda", generator=g)
    if density < 1.0:
        w.masked_fill_(w >= density, 0.0)
        w[:, 0] = 0.5
    else:
        w.add_(1e-3)
    w.div_(w.norm(dim=1, keepdim=True))
    KT.reset_launches()
    got, again = KT.gram(w), KT.gram(w)
    assert torch.equal(got, again) and torch.equal(got, got.T)
    ref = torch.zeros(n, n, dtype=torch.float64, device="cuda")
    for k0 in range(0, K, 1 << 18):
        part = w[:, k0:k0 + (1 << 18)].double()
        ref += part @ part.T
        del part
    _close(got, ref, 1e-5, f"K31 n K > 2^31, {density:g} nonzero")
    torch.cuda.synchronize()
    assert KT.LAUNCHES["retrieval_gram"] == 2


def test_query_ranks_a_duplicate_as_on_the_cpu_on_cuda():
    """An index on cuda and on the CPU over one flat vocabulary, image 6 a
    copy of image 2 added after it: the same ids in the same order, scores
    within 1e-12, images 2 and 6 tied to the bit with 2 first, in every one
    of three runs."""
    _need_card()
    from colmap_tpu_torch.kernels import retrieval as KT
    from colmap_tpu_torch.retrieval.visual_index import VisualIndex

    rng = np.random.default_rng(15)
    centers = rng.uniform(0, 255, (40, 128))
    images = {i: np.clip(np.rint(centers[rng.choice(10 * (i % 3) + np.arange(12), 300)]
                                 + rng.normal(0, 3.0, (300, 128))), 0, 255).astype(np.float32)
              for i in range(1, 6)}
    images[6] = images[2].copy()
    vocab = (centers + rng.normal(0, 2.0, (40, 128))).astype(np.float32)
    every = np.concatenate(list(images.values()))
    assert not KT.nearest64(torch.as_tensor(every), torch.as_tensor(vocab))[1].any()
    cpu, gpu = VisualIndex(vocab, device="cpu"), VisualIndex(vocab, device="cuda")
    for iid in sorted(images):
        cpu.add(iid, images[iid])
        gpu.add(iid, images[iid])
    for q in (1, 2, 4):
        want = cpu.query(images[q], num_images=6)
        for _ in range(3):
            got = gpu.query(images[q], num_images=6)
            assert [r.image_id for r in got] == [r.image_id for r in want]
            for g, w in zip(got, want):
                assert abs(g.score - w.score) <= 1e-12 * abs(w.score)
            ranks = [r.image_id for r in got]
            assert got[ranks.index(2)].score == got[ranks.index(6)].score
            assert ranks.index(2) < ranks.index(6)



@pytest.mark.parametrize("kind", ["E", "H"])
def test_spherical_ransac_matches_plain_on_cuda(kind):
    """K32 (E) and K33 (H) on 5760 x 2880 rays: each kernel model's support
    equals a float64 count of the same model up to rows within 2% of the
    threshold, the inlier mask equals the plain one off the threshold, the
    refit reaches the plain refit's support (within one row) and model
    (1e-3); a block of 7 pairs (one not active) gives each pair what the
    one-pair entries give it."""
    _need_card()
    from colmap_tpu_torch.geometry.spherical import (angular_sampson_error,
                                                     homography_ray_angular_error)
    from colmap_tpu_torch.kernels import spherical as KQ
    from colmap_tpu_torch.kernels import spherical_cases as Q
    from colmap_tpu_torch.kernels.sfm_cases import as_double
    from colmap_tpu_torch.optim.ransac import unpack_best

    residual = angular_sampson_error if kind == "E" else homography_ray_angular_error
    name = "spherical_e" if kind == "E" else "spherical_h"
    propose, refit, inliers = (getattr(KQ, f"{name}_{e}") for e in ("propose_score", "refit",
                                                                   "inliers"))
    refit_p, inliers_p = getattr(KQ, f"{name}_refit_plain"), getattr(KQ, f"{name}_inliers_plain")
    c = Q.ray_case(kind, 600, 48, 1, "cuda")
    d = as_double(c)
    models, counts, best = propose(c["x1"], c["x2"], c["mask"], c["samples"], c["max_sq"])
    _counts_match(counts, models, lambda m: residual(m[:, None], d["x1"][None], d["x2"][None]),
                  d["mask"], d["max_sq"])
    support, idx = unpack_best(int(best.item()))
    assert support == int(counts.max()) and counts[idx] == support and support > 300
    model = models[idx]
    got = inliers(c["x1"], c["x2"], c["mask"], model, c["max_sq"])
    ref = inliers_p(d["x1"], d["x2"], d["mask"], model.double(), d["max_sq"])
    border = (residual(model.double(), d["x1"], d["x2"]) - d["max_sq"]).abs() <= 0.02 * d["max_sq"]
    assert not bool(((got != ref) & ~border).any())
    start = model.clone()
    start[0, 1] += 0.01 * model.abs().max()
    n0 = int(inliers_p(d["x1"], d["x2"], d["mask"], start.double(), d["max_sq"]).sum())
    got, n_got = refit(c["x1"], c["x2"], c["mask"], start, c["max_sq"], n0)
    ref, n_ref = refit_p(d["x1"], d["x2"], d["mask"], start.double(), d["max_sq"], n0)
    assert abs(n_got - n_ref) <= 1
    _close(got * torch.sign((got.double() * ref).sum()), ref, 1e-3, f"{kind} refit")
    B = 7
    c = Q.ray_block_case(kind, B, 500, 16, 2, "cuda")
    sq = c["max_sq"]
    active = torch.ones(B, dtype=torch.bool, device="cuda")
    active[3] = False
    mb, cb, bb = propose(c["x1"], c["x2"], c["mask"], c["samples"], sq, active)
    assert int(bb[3]) == 0
    picks = [unpack_best(int(v)) for v in bb.tolist()]
    idx = torch.tensor([0 if b == 3 else p[1] for b, p in enumerate(picks)], device="cuda")
    start = torch.nan_to_num(mb[torch.arange(B, device="cuda"), idx])
    cnt = torch.tensor([p[0] for p in picks], dtype=torch.int32, device="cuda")
    rb, nb = refit(c["x1"], c["x2"], c["mask"], start, sq, cnt)
    ib = inliers(c["x1"], c["x2"], c["mask"], rb, sq)
    for b in range(B):
        one = (c["x1"][b], c["x2"][b], c["mask"][b])
        r1, n1 = refit(*one, start[b], float(sq[b]), int(cnt[b]))
        assert torch.equal(r1, rb[b]) and n1 == int(nb[b])
        assert torch.equal(inliers(*one, rb[b], float(sq[b])), ib[b])
        if b != 3:
            m1, c1, b1 = propose(*one, c["samples"][b], float(sq[b]))
            assert int(b1) == int(bb[b]) and torch.equal(c1, cb[b])
            assert torch.equal(torch.nan_to_num(m1), torch.nan_to_num(mb[b]))


def test_spherical_h_solve_cases_on_cuda():
    """K33's solve (8 of the 12 DLT rows, Householder QR in float32) on
    3000 rays of a rotation: samples whose r2 rays have their largest
    component on each axis with either sign (alone and mixed), the case's
    degenerate samples (a repeated row) and near-degenerate ones (a ray and
    its three nearest neighbours). Each model of a sample whose 8 x 9 system
    has sigma_8 >= 1e-2 sigma_1 equals float64 homography_ray_dlt's up to
    sign within 1e-3 of its scale; every support, in the count and the MSAC
    mode, equals a float64 count of the kernel's own model up to rows within
    2% of the threshold, and the near-best MSAC scores (>= 90% of the best)
    a float64 score within 5e-4; a block of 5 pairs with pair 2 inactive
    gives each active pair what the one-pair entry gives it."""
    _need_card()
    from colmap_tpu_torch.estimators.solvers.epipolar import homography_ray_dlt
    from colmap_tpu_torch.geometry.spherical import homography_ray_angular_error
    from colmap_tpu_torch.kernels import spherical as KQ
    from colmap_tpu_torch.kernels import spherical_cases as Q
    from colmap_tpu_torch.kernels.sfm_cases import as_double
    from colmap_tpu_torch.optim.ransac import score_models, unpack_best

    c = Q.ray_case("H", 3000, 8, 5, "cuda")
    d = as_double(c)
    valid = torch.nonzero(c["mask"]).flatten()
    r1v = d["x1"][valid]
    near = []
    for i in valid[::200][:16]:
        ang = (r1v @ d["x1"][i]).neg()
        near.append(valid[torch.argsort(ang)[:4]])
    samples = torch.cat([c["samples"], Q.axis_samples(c["x2"], c["mask"], 8, 6),
                         torch.stack(near).to(torch.int32)])
    res = lambda m: torch.where(d["mask"], homography_ray_angular_error(  # noqa: E731
        m[:, None], d["x1"][None], d["x2"][None]), torch.inf)
    s1, s2 = d["x1"][samples.long()], d["x2"][samples.long()]
    ref = homography_ray_dlt(s1, s2)
    sv = torch.linalg.svdvals(Q.ray_dlt_rows8(s1, s2))
    good = sv[:, 7] >= 1e-2 * sv[:, 0]
    assert int(good.sum()) >= 50
    for msac in (False, True):
        out = KQ.spherical_h_propose_score(c["x1"], c["x2"], c["mask"], samples, c["max_sq"],
                                           msac=msac)
        mk, ck, bk = out[:3]
        m64 = mk.double()
        sign = torch.sign((m64 * ref).sum((-2, -1)))[:, None, None]
        _close((m64 * sign)[good], ref[good], 1e-3, f"K33 models (msac {msac})")
        _counts_match(ck, mk, res, d["mask"], d["max_sq"])
        if msac:
            sk = out[3]
            _, s64 = score_models(m64, res(m64), d["mask"], d["max_sq"], True)
            top = s64 >= 0.9 * s64.max()
            assert bool(((sk.double() - s64).abs() <= 5e-4 * s64)[top].all())
        else:
            support, idx = unpack_best(int(bk.item()))
            assert support == int(ck.max()) and int(ck[idx]) == support
    B = 5
    blk = Q.ray_block_case("H", B, 2000, 4, 7, "cuda")
    blk["samples"] = torch.stack([Q.axis_samples(blk["x2"][b], blk["mask"][b], 2, b)
                                  for b in range(B)])
    active = torch.ones(B, dtype=torch.bool, device="cuda")
    active[2] = False
    for msac in (False, True):
        out = KQ.spherical_h_propose_score(blk["x1"], blk["x2"], blk["mask"], blk["samples"],
                                           blk["max_sq"], active, msac=msac)
        assert int(out[2][2]) == 0
        for b in (0, 1, 3, 4):
            one = KQ.spherical_h_propose_score(blk["x1"][b], blk["x2"][b], blk["mask"][b],
                                               blk["samples"][b], float(blk["max_sq"][b]),
                                               msac=msac)
            assert int(one[2]) == int(out[2][b])
            assert all(torch.equal(torch.nan_to_num(x), torch.nan_to_num(y[b]))
                       for x, y in zip((one[0], one[1], *one[3:]), (out[0], out[1], *out[3:])))


# K34-K37 (kernels/solver.py). K34 (float32 vectors and 6x6 blocks, float64
# dots) and K35's candidate (one float32 update per entry) are held to 1e-4
# and 1e-5 of each output's scale against float64 on the same inputs; K35's
# accept to the same decisions. The device-resident loop runs no host read
# inside a chunk (torch.cuda.set_sync_debug_mode("error")) and ends within
# 1e-4 of the loop through the plain versions, its iterations after done
# frozen. K36 (float64 arithmetic) to 1e-5, with at most 0.1% of the rows
# flipping their cheirality; K37 counts each of its models' inliers as a
# float64 count of the same model does, up to rows within 2% of the
# threshold.


def test_pcg_and_lm_update_match_plain_on_cuda(problem):
    """K34's set-up (both modes) and step, K35's candidate and accept."""
    from colmap_tpu_torch.estimators import bundle_adjustment as ba
    from colmap_tpu_torch.kernels import ba as K
    from colmap_tpu_torch.kernels import solver as KS

    pk, maps, model_id, opts, masks = problem
    om = ba._obs_masks(masks, opts)
    J = K.obs_jacobians(*pk, om.pose, om.cam, om.point, model_id, "trivial", 1.0)
    F, (C, P) = pk.quat.shape[0], pk.cam_params.shape
    lam = torch.tensor(1e-3, device="cuda")
    red = K.lm_reduce(*J, maps.frame_pm, maps.cam_pm, F, C, lam)
    red64 = K.LMReduction(*_f64(*red))
    for bj in (True, False):
        st = KS.pcg_setup(red.Hcc_pose, red.diag_pose, red.diag_cam, red.bp, red.bc, lam, bj)
        ref = KS.pcg_setup_plain(*[getattr(red64, n) for n in ("Hcc_pose", "diag_pose",
                                                              "diag_cam", "bp", "bc")],
                                 lam.double(), bj)
        for name, a, b in zip(KS.PCGState._fields, st, ref):
            _close(a, b, 1e-4, f"K34 set-up {name}")
        Ap = K.schur_matvec(*J[1:], maps.frame_pm, maps.cam_pm, red.Hpp_inv,
                            st.p[:6 * F].view(F, 6), st.p[6 * F:].view(C, P))
        ref = KS.pcg_step_plain(KS.PCGState(*_f64(*st)), *_f64(*Ap), lam.double(),
                                red64.diag_pose, red64.diag_cam)
        st = KS.pcg_step(st, *Ap, lam, red.diag_pose, red.diag_cam)
        for name, a, b in zip(KS.PCGState._fields, st, ref):
            _close(a, b, 1e-4, f"K34 step {name}")
    dp, dc = st.x[:6 * F].view(F, 6), st.x[6 * F:].view(C, P)
    dx = K.back_substitute(*J[1:], maps.frame_pm, maps.cam_pm, red.Hpp_inv, red.gx, dp, dc)
    params = tuple(pk[:4])
    cand, pred = KS.lm_candidate(*params, dp, dc, dx, red, lam)
    cand64, pred64 = KS.lm_candidate_plain(*_f64(*params, dp, dc, dx), red64, lam.double())
    for name, a, b in zip(("quat", "t", "cam", "points", "pred"), (*cand, pred),
                          (*cand64, pred64)):
        _close(a, b, 1e-5, f"K35 candidate {name}")
    new_cost = K.obs_cost64(*cand, *pk[4:], model_id, "trivial", 1.0)
    S = torch.zeros(9, dtype=torch.float64, device="cuda")
    S[0], S[1:3] = 2.0, K.obs_cost64(*pk, model_id, "trivial", 1.0)
    S64, lam64 = S.clone(), lam.double()
    state, state64 = tuple(x.clone() for x in params), tuple(_f64(*params))
    flags = [torch.zeros(1, dtype=torch.uint8, device="cuda") for _ in range(2)]
    KS.lm_accept(lam, S, new_cost, pred, state, cand, 1e-10, 1e10, 1e-6, flags[0])
    KS.lm_accept_plain(lam64, S64, new_cost, pred, state64, cand64, 1e-10, 1e10, 1e-6, flags[1])
    assert torch.equal(S[[0, 3, 4, 5, 6]], S64[[0, 3, 4, 5, 6]]) and bool(S[5] == 1)
    assert torch.equal(flags[0], flags[1])
    _close(lam, lam64, 1e-6, "K35 lam")
    for a, b in zip(state, state64):
        _close(a, b, 1e-5, "K35 state")


@pytest.mark.parametrize("solver", ["dense_schur", "pcg"])
def test_device_loop_reads_no_host_inside_a_chunk_on_cuda(problem, solver):
    """The LM loop on the card: one graph replay chunk and one eager chunk
    under sync debug mode "error"; once the function tolerance sets done,
    a replay and an eager iteration change nothing; a solve of 8
    iterations without a tolerance ends within 1e-4 of the plain loop's
    cost, in as many iterations."""
    import dataclasses

    from colmap_tpu_torch.estimators import bundle_adjustment as ba
    from colmap_tpu_torch.kernels import ba as K
    from colmap_tpu_torch.kernels import solver as KS
    from colmap_tpu_torch.utils import cuda_graph

    pk, maps, model_id, opts, masks = problem
    opts = dataclasses.replace(opts, solver_type=solver, max_iterations=30)
    state, sc, groups = ba._start(pk, model_id, opts, 1e-4, 2.0, K.KERNELS)
    om = ba._obs_masks(masks, opts)

    def step():
        ba._lm_iteration(state, maps, model_id, opts, om, sc, K.KERNELS, solver != "pcg", True,
                         groups)

    step()
    replay, _, _, _ = cuda_graph.capture(step, torch.device("cuda"), (K, KS))
    torch.cuda.set_sync_debug_mode("error")
    try:
        replay()
        replay()
        step()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    while not sc.done.item() and sc.S[3].item() < opts.max_iterations:
        replay()
    assert sc.done.item() == 1
    before = [x.clone() for x in (*state[:4], sc.lam, sc.S)]
    before[-1][6] = 0.0  # the copy flag is cleared; nothing else moves
    replay()
    step()
    for a, b in zip(before, (*state[:4], sc.lam, sc.S)):
        assert torch.equal(a, b)
    # Without a function tolerance: near the optimum float32 sums decide its
    # test either way, so the two loops' iteration counts could differ.
    opts = dataclasses.replace(opts, max_iterations=8, function_tolerance=0.0)
    _, cost, iters = ba.lm_solve_fused_packed(pk, maps, model_id, opts, masks)
    _, cost_p, iters_p = ba._lm_loop(pk, maps, model_id, opts, masks, solver != "pcg", True,
                                     kernels=K.PLAIN)
    assert abs(cost - cost_p) <= 1e-4 * cost_p and iters == iters_p == 8


def test_relative_pose_matches_plain_on_cuda():
    """K36: cheirality on 3 x 2048 rows and 50 edges x 200 rows, and the
    refinement on the 3 pairs, against float64."""
    _need_card()
    from colmap_tpu_torch.kernels import solver as KS
    from colmap_tpu_torch.kernels import solver_cases as SC

    for sizes in ([2048] * 3, [200] * 50):
        c = SC.relative_pose_case(sizes, 4, "cuda")
        d = SC.as_double(c)
        out = KS.poses_from_essentials(c["E"], c["x1"], c["x2"], c["mask"], c["offsets"])
        ref = KS.poses_from_essentials_plain(d["E"], d["x1"], d["x2"], d["mask"], c["offsets"])
        _close(out[0], ref[0], 1e-5, "K36 R")
        _close(out[1], ref[1], 1e-5, "K36 t")
        assert int((out[4] != ref[4]).sum()) <= 1e-3 * out[4].numel()
        assert int((out[3].long() - ref[3]).abs().max()) <= 1e-3 * out[4].numel()
    c = SC.relative_pose_case([2048] * 3, 5, "cuda")
    d = SC.as_double(c)
    got = KS.refine_relative_poses(c["q0"], c["t0"], c["x1"], c["x2"], c["weights"],
                                   c["offsets"])
    ref = KS.refine_relative_poses_plain(d["q0"], d["t0"], d["x1"], d["x2"], d["weights"],
                                         c["offsets"])
    for name, a, b in zip(("q", "t", "rms"), got, ref):
        _close(a, b, 1e-4, f"K36 refine {name}")


def test_structure_less_ransac_matches_plain_on_cuda():
    """K37: each model's support equals a float64 count of the same model up
    to rows within 2% of the threshold, NaN models score 0, the packed best
    is the first largest count; the inlier entry likewise."""
    _need_card()
    from colmap_tpu_torch.kernels import solver as KS
    from colmap_tpu_torch.kernels import solver_cases as SC
    from colmap_tpu_torch.optim.ransac import unpack_best

    c = SC.structure_less_case(1000, 5, 16, 6, "cuda")
    d = SC.as_double(c)
    a = [c[k] for k in SC.STRUCTURE_LESS_ARGS]
    a64 = [d[k] for k in SC.STRUCTURE_LESS_ARGS]
    models, counts, best = KS.structure_less_score(*a, *(c[k] for k in SC.SAMPLE_ARGS), 36.0)
    fin = torch.isfinite(models.flatten(1)).all(1)
    assert int(fin.sum()) >= 10 and not bool(fin[:20].any())
    res = KS.structure_less_residuals_plain(models[fin].double(), *a64)
    border = ((res - 36.0).abs() <= 0.72).sum(-1)
    assert bool(((counts[fin] - (res <= 36.0).sum(-1)).abs() <= border).all())
    assert bool((counts[~fin] == 0).all())
    support, idx = unpack_best(int(best.item()))
    assert support == int(counts.max()) and int(counts[idx]) == support
    inl = KS.structure_less_inliers(*a, models[idx], 36.0)
    r = KS.structure_less_residuals_plain(models[idx][None].double(), *a64)[0]
    assert bool(((inl != (r <= 36.0)) <= ((r - 36.0).abs() <= 0.72)).all())


# K34 (c), K38, K39, K40 and K37 in float64 (this slice). K34 (c) and its
# step on the rig's flattened camera side to 1e-4 of each vector's scale,
# padding columns exactly 0; K38's candidate to 1e-5, its accept to the same
# decisions, a rejected step leaving the state bit for bit; the rig loop
# with no host read inside a replay or an eager iteration, frozen after
# done, and within 1e-4 of the plain loop; K39 (both modes) to 1e-4 over 40
# steps; one IRLS round through each CG graph to 1e-5 of the eager round;
# K40 (a) and (b) to 1e-9 (float64 against float64); K37's models within
# 1e-6 of float64 for every near-best model.


def _rig_lm_case():
    _need_card()
    from colmap_tpu_torch.estimators import bundle_adjustment as ba
    from colmap_tpu_torch.estimators import bundle_adjustment_rig as rba
    from colmap_tpu_torch.kernels import rig_cases as RC

    p, _, model_id = RC.rig_ba_problem(10, 3, 500, 5, seed=3, device="cuda")
    opts = ba.BAOptions(max_iterations=20, pcg_iterations=15, loss="cauchy")
    masks = rba.fix_gauge_two_frames(rba.default_masks(p, model_id, opts), 0, 1)
    return p, model_id, opts, masks


def test_rig_pcg_and_lm_update_match_plain_on_cuda():
    """K34's set-up (c) and step (F = 0, no damping term) on the rig's
    camera side, K38's candidate and accept (accepted, then rejected)."""
    from colmap_tpu_torch.kernels import rig as KR
    from colmap_tpu_torch.kernels import rig_cases as RC
    from colmap_tpu_torch.kernels import solver as KS

    p, model_id, opts, masks = _rig_lm_case()
    lam = torch.tensor(1e-3, device="cuda")
    c = RC.lm_step_inputs(p, model_id, opts, masks, lam, KR.KERNELS)
    red, R, W = c["red"], *c["red"].b.shape
    red64 = KR.RigReduction(*_f64(*red))
    st = KS.pcg_setup_diag(red.precond.reshape(-1), red.b.reshape(-1))
    ref = KS.pcg_setup_diag_plain(red64.precond.reshape(-1), red64.b.reshape(-1))
    for name, a, b in zip(KS.PCGState._fields, st, ref):
        _close(a, b, 1e-4, f"K34 (c) {name}")
    pad = red.precond == 0
    for _ in range(5):
        Ap = KR.rig_schur_matvec(c["jac"], c["obs"], c["layout"], red.Hpp_inv, red.lam_diag,
                                 st.p.view(R, W))
        ref = KS.pcg_step_plain(KS.PCGState(*_f64(*st)), torch.zeros(0, 6, device="cuda"),
                                Ap.double(), None, None, None)
        st = KS.pcg_step(st, torch.zeros(0, 6, device="cuda"), Ap, None, None, None)
        for name, a, b in zip(KS.PCGState._fields, st, ref):
            _close(a, b, 1e-4, f"K34 rig step {name}")
        for v in (st.x, st.r, st.z, st.p):
            assert bool((v.view(R, W)[pad] == 0).all())
    params = tuple(p[:6])
    cand, pred = KR.rig_lm_candidate(params, c["x"], c["dx"], red, lam)
    cand64, pred64 = KR.rig_lm_candidate_plain(tuple(_f64(*params)), c["x"].double(),
                                               c["dx"].double(), red64, lam.double())
    for k, (a, b) in enumerate(zip((*cand, pred), (*cand64, pred64))):
        _close(a, b, 1e-5, f"K38 candidate {k}")
    obs, rest = c["obs"], (model_id, opts.loss, opts.loss_scale)
    new_cost = KR.rig_obs_cost64(*cand, obs, *rest)
    S = torch.zeros(9, dtype=torch.float64, device="cuda")
    S[0], S[1:3] = 2.0, KR.rig_obs_cost64(*params, obs, *rest)
    S64, lam64 = S.clone(), lam.double()
    state, state64 = tuple(x.clone() for x in params), tuple(_f64(*params))
    flags = [torch.zeros(1, dtype=torch.uint8, device="cuda") for _ in range(2)]
    KR.rig_lm_accept(lam, S, new_cost, pred, state, cand, 1e-10, 1e10, 1e-6, flags[0])
    KR.rig_lm_accept_plain(lam64, S64, new_cost, pred, state64, cand64, 1e-10, 1e10, 1e-6,
                           flags[1])
    assert torch.equal(S[[0, 3, 4, 5, 6]], S64[[0, 3, 4, 5, 6]]) and bool(S[5] == 1)
    _close(lam, lam64, 1e-6, "K38 lam")
    for a, b in zip(state, state64):
        _close(a, b, 1e-5, "K38 state")
    # The same candidate again from the accepted state: its cost is no
    # longer lower, so the step is rejected and the state stays bit for bit.
    before = [x.clone() for x in state]
    KR.rig_lm_accept(lam, S, S[1].clone(), pred, state, cand, 1e-10, 1e10, 1e-6, flags[0])
    assert bool(S[5] == 0) and S[0].item() == 4.0
    for a, b in zip(before, state):
        assert torch.equal(a, b)


# (F, CP, damped): the weighing's heaviest classes (F 8 CP 4, F 4 CP 4, F 8
# CP 8), the one-warp plan's edges (32 frames; 32 and 128 camera entries),
# the first sizes past its bound (33 frames; 129 camera entries), the rig's
# undamped step (F = 0) on both plans, the BA headline (200 frames) and the
# 4200-frame check problem.
K34_STEP_CASES = [(8, 4, True), (4, 4, True), (8, 8, True), (32, 32, True), (32, 128, True),
                  (33, 4, True), (32, 129, True), (0, 96, False), (0, 1000, False),
                  (200, 4, True), (4200, 8, True)]


@pytest.mark.parametrize("F,CP,damped", K34_STEP_CASES,
                         ids=[f"F{F}_CP{CP}" + ("" if d else "_undamped")
                              for F, CP, d in K34_STEP_CASES])
def test_pcg_step_plans_match_plain_on_cuda(F, CP, damped):
    """K34's step by its plan (one warp up to 32 frames and 128 camera
    entries, the block above), and by the block where the plan is a warp,
    against pcg_step_plain in float64 on the same inputs to 1e-4 of each
    output's scale; a second run from the same state gives the same bits
    (fixed-order sums, no atomics)."""
    _need_card()
    from colmap_tpu_torch.kernels import solver as KS
    from colmap_tpu_torch.kernels.solver_cases import pcg_vectors

    st0, Ap0, (lam, dpose, dcam) = pcg_vectors(F, CP, damped, F + CP, "cuda")
    ref = KS.pcg_step_plain(KS.PCGState(*_f64(*st0)), *_f64(*Ap0),
                            *(None if v is None else v.double() for v in (lam, dpose, dcam)))
    plan = KS.pcg_step_plan(F, CP)
    assert (plan != 0) == (F <= 32 and CP <= 128)
    runs = []
    for pl in [plan, 0] if plan else [plan]:
        for _ in range(2):
            st = KS.PCGState(*(v.clone() for v in st0))
            Ap = tuple(a.clone() for a in Ap0)
            KS.pcg_step_planned(st, *Ap, lam, dpose, dcam, pl)
            runs.append((pl, torch.cat([v.reshape(-1).double() for v in (*st, *Ap)])))
            for name, a, b in zip(KS.PCGState._fields, st, ref):
                _close(a, b, 1e-4, f"K34 step {pl} {name}")
            if damped:
                ref_Ap = torch.cat([Ap0[0].reshape(-1), Ap0[1].reshape(-1)]).double()
                ref_Ap = ref_Ap + lam.double() * torch.cat(
                    [dpose.reshape(-1), dcam.reshape(-1)]).double() * st0.p.double()
                _close(torch.cat([Ap[0].reshape(-1), Ap[1].reshape(-1)]), ref_Ap, 1e-5,
                       f"K34 step {pl} Ap")
            else:
                assert all(torch.equal(a, b) for a, b in zip(Ap, Ap0))
    for (pa, a), (pb, b) in zip(runs[::2], runs[1::2]):
        assert pa == pb and torch.equal(a, b), f"K34 step {pa}: two runs differ"


@pytest.mark.parametrize("shape", [(8, 800, 2), (4, 500, 2), (8, 800, 4)],
                         ids=["F8_CP4", "F4_CP4", "F8_CP8"])
def test_pcg_graph_replay_matches_eager_on_cuda(shape):
    """The weighing's heaviest classes on synthetic problems (F frames, N
    points, SIMPLE_RADIAL or OPENCV): after K34's set-up and one K3
    product, the step against pcg_step_plain in float64 (1e-4); 5 PCG
    iterations (K3 + K34) replayed from a CUDA graph against the same
    iterations run eagerly from the same state (1e-4: K3's float atomics
    change their order from run to run); 10 steps alone on one product, a
    graph replay against eager launches, to the bit."""
    _need_card()
    from colmap_tpu_torch.estimators import bundle_adjustment as ba
    from colmap_tpu_torch.kernels import ba as K
    from colmap_tpu_torch.kernels import solver as KS
    from colmap_tpu_torch.scene.synthetic_ba import synthetic_ba_problem

    F, N, model_id = shape
    problem, _, _ = synthetic_ba_problem(F, N, min(F, 6), model_id=model_id, seed=0,
                                         device="cuda")
    opts = ba.BAOptions()
    masks = ba.fix_gauge_two_frames(ba.default_masks(problem, model_id, opts), 0, 1)
    pk, maps, _ = ba.pack_problem(problem)
    om = ba._obs_masks(masks, opts)
    J = K.obs_jacobians(*pk, om.pose, om.cam, om.point, model_id, opts.loss, opts.loss_scale)
    C, P = pk.cam_params.shape
    lam = torch.tensor(1e-3, device="cuda")
    red = K.lm_reduce(*J, maps.frame_pm, maps.cam_pm, F, C, lam)
    red64 = K.LMReduction(*_f64(*red))
    assert KS.pcg_step_plan(F, C * P) != 0

    def product(s):
        return K.schur_matvec(*J[1:], maps.frame_pm, maps.cam_pm, red.Hpp_inv,
                              s.p[:6 * F].view(F, 6), s.p[6 * F:].view(C, P))

    st0 = KS.pcg_setup(red.Hcc_pose, red.diag_pose, red.diag_cam, red.bp, red.bc, lam, True)
    Ap0 = product(st0)
    ref = KS.pcg_step_plain(KS.PCGState(*_f64(*st0)), *_f64(*Ap0), lam.double(),
                            red64.diag_pose, red64.diag_cam)
    st = KS.pcg_step(KS.PCGState(*(v.clone() for v in st0)), *(a.clone() for a in Ap0), lam,
                     red.diag_pose, red.diag_cam)
    for name, a, b in zip(KS.PCGState._fields, st, ref):
        _close(a, b, 1e-4, f"K34 step {shape} {name}")

    def fresh():
        return KS.PCGState(*(v.clone() for v in st0))

    def iterate(s):
        for _ in range(5):
            KS.pcg_step(s, *product(s), lam, red.diag_pose, red.diag_cam)

    def steps(s, Ap):
        for _ in range(10):
            KS.pcg_step(s, *Ap, lam, red.diag_pose, red.diag_cam)

    for body, args, tol in ((iterate, (), 1e-4), (steps, (Ap0,), 0.0)):
        eager = fresh()
        body(eager, *(tuple(a.clone() for a in x) for x in args))
        graphed = fresh()
        held = [tuple(a.clone() for a in x) for x in args]
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            warm = fresh()
            body(warm, *(tuple(a.clone() for a in x) for x in args))
        torch.cuda.current_stream().wait_stream(side)
        g = torch.cuda.CUDAGraph()
        start = [v.clone() for v in graphed]
        start_held = [tuple(a.clone() for a in x) for x in held]
        with torch.cuda.graph(g):
            body(graphed, *held)
        for v, s0 in zip(graphed, start):  # the capture ran nothing: replay from the start
            v.copy_(s0)
        for x, x0 in zip(held, start_held):
            for a, a0 in zip(x, x0):
                a.copy_(a0)
        g.replay()
        torch.cuda.synchronize()
        for name, a, b in zip(KS.PCGState._fields, graphed, eager):
            if tol:
                _close(a, b, tol, f"{body.__name__} {shape} {name}: graph against eager")
            else:
                assert torch.equal(a, b), f"{body.__name__} {shape} {name}: graph against eager"


def test_rig_device_loop_reads_no_host_on_cuda():
    """The rig LM loop: a graph replay and an eager iteration under sync
    debug mode "error"; frozen after done; a solve of 8 iterations without
    a tolerance within 1e-4 of the plain loop's cost."""
    import dataclasses

    from colmap_tpu_torch.estimators import bundle_adjustment as ba
    from colmap_tpu_torch.estimators import bundle_adjustment_rig as rba
    from colmap_tpu_torch.kernels import rig as KR
    from colmap_tpu_torch.kernels import solver as KS
    from colmap_tpu_torch.kernels.ba import model_groups
    from colmap_tpu_torch.utils import cuda_graph

    p, model_id, opts, masks = _rig_lm_case()
    om, layout = rba._obs_masks(masks, opts), rba._layout(p)
    groups = model_groups(model_id, p.cam_params, p.obs_cam)
    state = p._replace(**{k: getattr(p, k).clone() for k in
                          ("quat", "t", "sensor_quat", "sensor_t", "cam_params", "points")})
    cost = KR.rig_obs_cost64(*state[:6], rba._obs(state), model_id, opts.loss, opts.loss_scale)
    sc = ba._lm_scalars(cost, opts.initial_lambda, 2.0, torch.float32)

    def step():
        rba._lm_iteration(state, layout, model_id, opts, om, sc, KR.KERNELS, groups)

    step()
    replay, _, _, _ = cuda_graph.capture(step, torch.device("cuda"), (KR, KS))
    torch.cuda.set_sync_debug_mode("error")
    try:
        replay()
        step()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    while not sc.done.item() and sc.S[3].item() < 60:
        replay()
    assert sc.done.item() == 1
    before = [x.clone() for x in (*state[:6], sc.lam, sc.S)]
    before[-1][6] = 0.0
    replay()
    step()
    for a, b in zip(before, (*state[:6], sc.lam, sc.S)):
        assert torch.equal(a, b)
    opts = dataclasses.replace(opts, max_iterations=8, function_tolerance=0.0)
    _, cost, iters, info = rba._lm_loop(p, model_id, opts, masks, with_info=True)
    p64, m64 = type(p)(*_f64(*p)), type(masks)(*_f64(*masks))
    _, cost_p, iters_p = rba._lm_loop(p64, model_id, opts, m64, kernels=KR.PLAIN)
    assert info["graph"] and iters == iters_p == 8
    assert abs(cost - cost_p) <= 1e-4 * cost_p


@pytest.mark.parametrize("case", ["rotation", "rotation_gravity", "positioning"])
def test_global_cg_matches_plain_on_cuda(case):
    """K39 set-up and its steps (matvecs K21 (b) / K22 (b) on the card in
    float32, fed to both) against float64: 40 in rotation mode; 100 in
    positioning mode on 30 x 3 unknowns, where the freeze rule fires before
    the last step."""
    _need_card()
    from colmap_tpu_torch.kernels import global_cases as C
    from colmap_tpu_torch.kernels import global_sfm as G

    if case.startswith("rotation"):
        _, g32, _, q32 = _ra_case(case.endswith("gravity"))
        step = G.ra_edge_pass(g32, q32, False, np.deg2rad(5.0))
        mode, args = G.CG_ROTATION, (step.b, step.deg)
        matvec = lambda x: G.ra_matvec(g32, step.ew, x)  # noqa: E731
    else:
        case_ = C.positioning_case(30, 400, 5, seed=4)
        t = lambda a, dt=torch.float32: torch.as_tensor(a, dtype=dt, device="cuda")  # noqa: E731
        prob = G.gp_problem(t(case_.dirs), t(case_.obs_cam).int(), t(case_.obs_point).int(),
                            t(np.ones(len(case_.dirs))), 7, 100.0, 30, 400, 0.1)
        rng = np.random.default_rng(5)
        sys = G.gp_setup(prob, t(rng.standard_normal((30, 3))), t(rng.standard_normal((400, 3))))
        mode, args = G.CG_POSITIONING, (sys.b, sys.diag_c, prob.eps_rel)
        matvec = lambda x: G.gp_schur_matvec(prob, sys, x)  # noqa: E731
    st = G.cg_setup(mode, *args)
    ref = G.cg_setup_plain(mode, *(_f64(*args[:2])), *args[2:])
    for name, a, b in zip(G.CGState._fields, st, ref):
        _close(a, b, 1e-5, f"K39 set-up {name}")
    # r, z and p shrink as CG converges, and r - alpha Ap cancels: each is
    # held to its set-up scale.
    scale = {n: float(getattr(ref, n).abs().max()) for n in ("r", "z", "p")}
    frozen = False
    for _ in range(40 if mode == G.CG_ROTATION else 100):
        Ap = matvec(st.p)
        ref = G.cg_step_plain(mode, G.CGState(*_f64(*st)), Ap.double())
        st = G.cg_step(mode, st, Ap)
        for name, a, b in zip(G.CGState._fields, st, ref):
            err = float((a.double() - b).abs().max())
            assert err <= 1e-4 * max(float(b.abs().max()), scale.get(name, 0.0)), name
        frozen = frozen or not bool(st.scal[0] > 1e-12 * st.scal[1])
    assert frozen or mode == G.CG_ROTATION


def test_global_cg_graphs_match_eager_rounds_on_cuda():
    """One rotation-averaging iteration and one positioning round with the
    CG replayed from a graph (no host read inside the replay) against the
    same rounds run eagerly."""
    _need_card()
    from colmap_tpu_torch.estimators import global_positioning as GP
    from colmap_tpu_torch.estimators import rotation_averaging as RA
    from colmap_tpu_torch.kernels import global_cases as C
    from colmap_tpu_torch.kernels import global_sfm as G
    from colmap_tpu_torch.utils import cuda_graph

    dev = torch.device("cuda")
    _, g32, _, q32 = _ra_case(False)
    buf = G.ra_step_buffers(60, g32.edges.shape[0], dev)
    cg = cuda_graph.StepGraph(lambda: RA.solve_tangent_cg(g32, buf, 50), dev, (G,), True)
    for _ in range(2):
        G.ra_edge_pass(g32, q32, False, 0.1, out=buf)
        cg()
    torch.cuda.set_sync_debug_mode("error")
    try:
        x = cg()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    _close(x, RA.solve_tangent_cg(g32, G.ra_edge_pass(g32, q32, False, 0.1), 50), 1e-5,
           "rotation CG graph")
    case = C.positioning_case(30, 400, 5, seed=4)
    t = lambda a, dt=torch.float32: torch.as_tensor(a, dtype=dt, device="cuda")  # noqa: E731
    prob = G.gp_problem(t(case.dirs), t(case.obs_cam).int(), t(case.obs_point).int(),
                        t(np.ones(len(case.dirs))), 7, 100.0, 30, 400, 0.1)
    rng = np.random.default_rng(5)
    c0, X0 = t(rng.standard_normal((30, 3))), t(rng.standard_normal((400, 3)))
    gbuf = G.gp_system_buffers(prob)
    gcg = cuda_graph.StepGraph(lambda: GP._cg(prob, gbuf, 100, G.KERNELS), dev, (G,), True)
    for _ in range(2):
        GP._irls_round(prob, c0, X0, 100, G.KERNELS, gcg, gbuf)
    (c1, X1), cost = GP._irls_round(prob, c0, X0, 100, G.KERNELS, gcg, gbuf)
    (c2, X2), cost2 = GP._irls_round(prob, c0, X0, 100)
    assert gcg.replay is not None
    _close(c1, c2, 1e-5, "positioning centres")
    _close(X1, X2, 1e-5, "positioning points")
    assert float(cost) == float(cost2)


def test_gen_abs_refine_and_refit_match_plain_on_cuda():
    """K40 (a) against its plain version (30% outliers under the Cauchy
    loss) and K40 (b) with and without the scale, float64 on both sides."""
    _need_card()
    from colmap_tpu_torch.kernels import rig as KR
    from colmap_tpu_torch.kernels import rig_cases as RC

    rows, q0, t0, _ = RC.refine_case(2000, 3, device="cuda")
    q, t = KR.gen_abs_refine(*rows, q0, t0)
    cpu = [x.cpu() for x in (*rows, q0, t0)]
    q64, t64 = KR.gen_abs_refine_plain(*cpu)
    _close(q.cpu(), q64, 1e-9, "K40 refine q")
    _close(t.cpu(), t64, 1e-9, "K40 refine t")
    data, _, inl = RC.gen_abs_case(2000, seed=4, world_scale=0.37, device="cuda")
    w = torch.as_tensor(inl, dtype=torch.float64, device="cuda")
    for scale in (False, True):
        m, ok = KR.gen_abs_refit(data.X, data.centers, data.dirs, w, scale)
        m64, ok64 = KR.gen_abs_refit_plain(data.X.cpu(), data.centers.cpu(), data.dirs.cpu(),
                                           w.cpu(), scale)
        assert bool(ok) and bool(ok64)
        _close(m.cpu(), m64, 1e-9, f"K40 refit (scale {scale})")


def test_structure_less_ransac_agrees_with_float64_on_cuda():
    """K37's five-point solve in float64: every plain model with at least
    90% of the best support has a kernel solution of its sample within
    1e-6 of it (relative to its largest entry)."""
    _need_card()
    from colmap_tpu_torch.kernels import solver as KS
    from colmap_tpu_torch.kernels import solver_cases as SC

    c = SC.structure_less_case(1000, 5, 32, 7, "cuda")
    d = SC.as_double(c)
    a = [c[k] for k in SC.STRUCTURE_LESS_ARGS]
    a64 = [d[k] for k in SC.STRUCTURE_LESS_ARGS]
    smp = [c[k] for k in SC.SAMPLE_ARGS]
    mk, _, _ = KS.structure_less_score(*a, *smp, 36.0)
    mp, cp, _ = KS.structure_less_score_plain(*a64, *smp, 36.0)
    near = torch.nonzero(cp >= 0.9 * cp.max()).flatten().tolist()
    assert near
    for i in near:
        lo = (i // 10) * 10
        gap = torch.nan_to_num((mk[lo:lo + 10].double() - mp[i]).abs().flatten(1).amax(1),
                               nan=float("inf"))
        assert float(gap.min()) <= 1e-6 * float(mp[i].abs().max()), f"model {i}"


# The spectral Poisson kernels K41-K44 on colmap_tpu_torch/kernels/
# meshing_cases.py at N = 64 (a sphere, samples on the clip border, a voxel
# of 100 contributions), each against its plain version on the same float32
# inputs and run twice for the same bits. K41 (a), K42 and K44 (b) round
# every float32 operation as their plain versions do: equal. K41 (b) sums
# in float64 in the sorted order, as index_add_ over the sorted keys does on
# the CPU: equal to the CPU's plain version. K43's cosines come from two
# libraries: 1e-6 of the spectrum's largest entry. K44 (a) sums in float64
# in another order than its plain version: 1e-6 relative.

def _poisson_inputs(case):
    _need_card()
    from colmap_tpu_torch.kernels import meshing_cases as C

    N = 64
    if case == "sphere":
        pts, nrm = C.sphere(20000, seed=1)
        p01 = C.normalize(pts)[0]
    elif case == "clip_border":
        p01, nrm = C.clip_border(20000, seed=2)
    else:
        p01, nrm = C.crowded_voxel(20000, N, crowd=100, seed=3)
    t = lambda a: torch.as_tensor(a, dtype=torch.float32, device="cuda").contiguous()  # noqa
    return t(p01), t(nrm), torch.ones(len(p01), device="cuda"), N


def _twice(fn):
    a, b = fn(), fn()
    torch.cuda.synchronize()
    for x, y in zip(a if isinstance(a, tuple) else (a,), b if isinstance(b, tuple) else (b,)):
        assert torch.equal(x, y), "two runs differ"
    return a


def _spectral_orders(KM, spec, want):
    """K43 on spec laid out in each of the six storage orders (a row of the
    fastest axis of odd length N/2 + 1 or N where they are fastest, a base
    on an odd bin): within K43_RTOL (1e-6) of the plain version, the same
    bits twice, and the bits of `want` (K43 on spec as rfftn gives it)."""
    import itertools

    ref = torch.view_as_real(KM.spectral_divide_plain(spec, 1.0))
    for perm in itertools.permutations(range(3)):  # perm[0] outermost in storage
        for shift in (0, 1):  # shift 1: the base one complex bin past an aligned one
            store = torch.empty(spec.numel() + shift, dtype=spec.dtype, device=spec.device)
            laid = store[shift:].view([spec.shape[a] for a in perm]).permute(
                [perm.index(a) for a in range(3)])
            got = _twice(lambda: KM.spectral_divide_(laid.copy_(spec), 1.0))
            _close(torch.view_as_real(got), ref, 1e-6, f"K43, storage order {perm}")
            assert torch.equal(got, want), f"K43, storage order {perm}: other bits"


def test_poisson_spectral_odd_n_on_cuda():
    """K43 at N = 33 (every axis odd) and N = 32, on a random spectrum, in
    each storage order."""
    _need_card()
    from colmap_tpu_torch.kernels import meshing as KM

    for N in (33, 32):
        g = torch.Generator().manual_seed(N)
        spec = torch.fft.rfftn(torch.randn(N, N, N, generator=g).cuda())
        got = _twice(lambda: KM.spectral_divide_(spec.clone(), 1.0))
        _close(torch.view_as_real(got),
               torch.view_as_real(KM.spectral_divide_plain(spec, 1.0)), 1e-6, f"K43 N {N}")
        _spectral_orders(KM, spec, got)


@pytest.mark.parametrize("case", ["sphere", "clip_border", "crowded_voxel"])
def test_poisson_splat_matches_plain_on_cuda(case):
    """K41 (a) equal to its plain version; K41 (b) equal to the plain sums
    taken on the CPU in sorted order."""
    from colmap_tpu_torch.kernels import meshing as KM

    x, n, w, N = _poisson_inputs(case)
    KM.reset_launches()
    keys, wk = _twice(lambda: KM.splat_corners(x, w, N))
    kp, wp = KM.splat_corners_plain(x, w, N)
    assert torch.equal(keys, kp) and torch.equal(wk, wp)
    ks, perm = torch.sort(keys, stable=True)
    grid = _twice(lambda: KM.splat_sum(ks, perm, wk, n, N))
    ref = KM.splat_sum_plain(ks.cpu(), perm.cpu(), wk.cpu(), n.cpu(), N)
    assert torch.equal(grid.cpu(), ref)
    assert KM.LAUNCHES["poisson_splat"] == 4


def test_poisson_stencil_spectral_and_iso_match_plain_on_cuda():
    """K42 (a) along x, y, z and (b), K43 and K44 (a), (b) against their
    plain versions; the whole indicator equals itself twice and agrees with
    the plain path in float64 to 1e-5 of its largest magnitude."""
    from colmap_tpu_torch.kernels import meshing as KM

    x, n, w, N = _poisson_inputs("sphere")
    grid = KM.splat(x, n, w, N)
    for axis in (0, 1, 2):
        out = _twice(lambda: KM.blur(grid, axis))
        assert torch.equal(out, KM.blur_plain(grid, axis))
        grid = out
    div = _twice(lambda: KM.divergence(grid))
    assert torch.equal(div, KM.divergence_plain(grid))
    spec = torch.fft.rfftn(div)
    ref = KM.spectral_divide_plain(spec, 1.0)
    got = _twice(lambda: KM.spectral_divide_(spec.clone(), 1.0))
    _close(torch.view_as_real(got), torch.view_as_real(ref), 1e-6, "K43")
    _spectral_orders(KM, spec, got)
    chi = torch.fft.irfftn(got, s=(N, N, N))
    iso = _twice(lambda: KM.iso_level(chi, x, w))
    iso64 = KM.iso_level_plain(chi.double(), x.double(), w.double())
    assert abs(float(iso) - float(iso64)) <= 1e-6 * abs(float(iso64))
    shifted = KM.shift_(chi.clone(), iso)
    assert torch.equal(shifted, chi - iso)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")  # no host read from the splat to the shift
    try:
        a, W = KM.poisson_indicator(x, n, w, N, 1.0)
        a2, W2 = KM.poisson_indicator(x, n, w, N, 1.0)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert torch.equal(a, a2) and torch.equal(W, W2), "two runs differ"
    a64, W64 = KM.poisson_indicator(x.cpu().double(), n.cpu().double(), w.cpu().double(), N,
                                    1.0)
    _close(a.cpu(), a64, 1e-5, "chi - iso")
    _close(W.cpu(), W64, 1e-6, "W_s")


# ---------------------------------------------------------------------------
# Options of the front end and of RANSAC (K45-K47, the MSAC mode, shapes).
# ---------------------------------------------------------------------------


def _msac_family(kind):
    """(residual, propose, refit, refit_plain, case) of an MSAC-mode family:
    K7, K11, K12 on pixel or normalized pairs, K32, K33 on 360-degree rays."""
    from colmap_tpu_torch.geometry.spherical import (angular_sampson_error,
                                                     homography_ray_angular_error)
    from colmap_tpu_torch.kernels import matching_cases as C
    from colmap_tpu_torch.kernels import spherical as KQ
    from colmap_tpu_torch.kernels import spherical_cases as Q

    if kind in ("E", "F", "H"):
        residual, propose, refit, _, refit_p, _ = _two_view_family(kind)
        return residual, propose, refit, refit_p, C.two_view_case(kind, 600, 48, 1, "cuda"), \
            lambda: C.two_view_block_case(kind, 9, 500, 16, 2, "cuda")
    name = {"sphere_E": "spherical_e", "sphere_H": "spherical_h"}[kind]
    residual = angular_sampson_error if kind == "sphere_E" else homography_ray_angular_error
    k = kind[-1]
    return (residual, getattr(KQ, f"{name}_propose_score"), getattr(KQ, f"{name}_refit"),
            getattr(KQ, f"{name}_refit_plain"), Q.ray_case(k, 600, 48, 1, "cuda"),
            lambda: Q.ray_block_case(k, 9, 500, 16, 2, "cuda"))


@pytest.mark.parametrize("kind", ["E", "F", "H", "sphere_E", "sphere_H"])
def test_msac_mode_matches_plain_on_cuda(kind):
    """The MSAC mode of K7, K11, K12, K32 and K33: the score of each
    near-best kernel model (at least 90% of the best float64 score) within
    1e-5 of a float64 score of the same model (the score is continuous at
    the threshold; K33's float32 |h - q|^2 of unit rays holds ~1e-4 of a
    residual at a 4 px threshold, so 5e-4 there; a degenerate model's
    float32 residuals may be off on single rows, so all models are held to
    1e-3 of the best score only),
    counts as in the default mode, the packed best the first of the largest
    score; from a model that keeps part of the support, the refit's score
    within 1e-4 (K33: 5e-4) of the plain refit's; a block of 9 pairs gives
    each pair what the one-pair entries give it."""
    _need_card()
    from colmap_tpu_torch.optim.ransac import score_models

    residual, propose, refit, refit_p, c, block_case = _msac_family(kind)
    from colmap_tpu_torch.kernels.sfm_cases import as_double

    d = as_double(c)
    models, counts, best, scores = propose(c["x1"], c["x2"], c["mask"], c["samples"],
                                           c["max_sq"], msac=True)
    m64 = models.double()
    res = residual(m64[:, None], d["x1"][None], d["x2"][None])
    _, want_s = score_models(m64, res, d["mask"], d["max_sq"], True)
    top = want_s >= 0.9 * want_s.max()
    rel = (scores.double() - want_s).abs() / want_s.clamp(min=1e-30)
    tol = 5e-4 if kind == "sphere_H" else 1e-5
    assert float(rel[top].max()) <= tol, f"{kind}: near-best MSAC scores {float(rel[top].max())}"
    _close(scores, want_s, 1e-3, f"{kind} MSAC scores")
    _counts_match(counts, models, lambda m: residual(m[:, None], d["x1"][None], d["x2"][None]),
                  d["mask"], d["max_sq"])
    idx = 0xFFFFFFFF - (int(best) & 0xFFFFFFFF)
    assert idx == int(torch.argmax(scores)) and float(scores[idx]) > 0
    assert (int(best) >> 32) == int(scores[idx].view(torch.int32)) & 0xFFFFFFFF
    # A start that keeps part of the support: for F the model whose float64
    # score is nearest half the best (a sample with an outlier in it), for H
    # the best with a shear of 1%, for the others the best with 1% of its
    # largest entry added to one entry.
    start = models[idx].clone()
    if kind == "F":
        start = models[int(torch.argmin((want_s - want_s.max() / 2).abs()))].clone()
    else:
        start[0, 1] += 0.01 * (start[0, 0] if kind == "H" else start.abs().max())
    r0 = residual(start.double()[None, None], d["x1"][None], d["x2"][None])[0]
    n0, s0 = score_models(start.double()[None], r0, d["mask"], d["max_sq"], True)
    got, n_got, s_got = refit(c["x1"], c["x2"], c["mask"], start, c["max_sq"], int(n0[0]),
                              float(s0[0]))
    ref, n_ref, s_ref = refit_p(d["x1"], d["x2"], d["mask"], start.double(), d["max_sq"],
                                int(n0[0]), float(s0[0]))
    assert s_ref > float(s0[0]) and abs(s_got - s_ref) <= max(1e-4, tol) * s_ref
    assert abs(n_got - n_ref) <= 2
    b = block_case()
    sq = b["max_sq"]
    mb, cb, bb, sb = propose(b["x1"], b["x2"], b["mask"], b["samples"], sq, msac=True)
    for p in range(9):
        s1 = float(sq[p]) if torch.is_tensor(sq) else sq
        m1, c1, b1, sc1 = propose(b["x1"][p], b["x2"][p], b["mask"][p], b["samples"][p], s1,
                                  msac=True)
        assert int(b1) == int(bb[p]) and torch.equal(c1, cb[p]) and torch.equal(sc1, sb[p])
        assert torch.equal(torch.nan_to_num(m1), torch.nan_to_num(mb[p]))


def _plane_parallax_case(n, plane_share, k, seed):
    """Pixel matches of a pair with a dominant plane (H fitted on it, float32
    on the card) and k pairs of off-plane rows."""
    from colmap_tpu_torch.estimators.solvers.epipolar import homography_dlt
    from colmap_tpu_torch.kernels import matching_cases as C

    p = C.two_view_case("H", n, 2, seed, "cpu", outliers=0.0, valid=n)
    g = C.two_view_case("F", n, 2, seed + 1, "cpu", outliers=0.0, valid=n)
    m = int(n * plane_share)
    x1 = torch.cat([p["x1"][:m], g["x1"][m:]]).double()
    x2 = torch.cat([p["x2"][:m], g["x2"][m:]]).double()
    H = homography_dlt(x1[:m], x2[:m])
    rng = np.random.default_rng(seed)
    ia = torch.from_numpy(rng.integers(m, n, k)).to(torch.int32)
    ib = torch.from_numpy(rng.integers(m, n, k)).to(torch.int32)
    ib[0] = ia[0]  # a degenerate pair scores 0
    return x1, x2, H, ia, ib


def test_degensac_kernel_matches_plain_on_cuda():
    """K46: each near-best hypothesis (at least 90% of the best float64
    support) within 1e-4 of the float64 plain version's up to sign (the
    epipole of two nearly parallel parallax lines has no stable sign) and
    with the support of a float64 count of the kernel's model up to rows
    within 2% of the threshold, 0 for ia = ib, the packed best the first of the
    largest; degensac_recover_f on the card (K46, K11's refit and inliers)
    against the float64 CPU path on the same positions: the same recovered
    flag, counts within 2 rows, F within 1e-3."""
    _need_card()
    from colmap_tpu_torch.estimators import degensac as D
    from colmap_tpu_torch.geometry.essential import squared_epipolar_line_distance
    from colmap_tpu_torch.kernels import matching as KM
    from colmap_tpu_torch.optim.ransac import RansacOptions, unpack_best

    x1, x2, H, ia, ib = _plane_parallax_case(2000, 0.8, 256, 3)
    mask = torch.ones(len(x1), dtype=torch.bool)
    cu = [t.cuda() for t in (x1.float(), x2.float(), mask, H.float(), ia, ib)]
    Fs, counts, best = KM.degensac_propose_score(*cu, 16.0)
    Fp, cp, _ = KM.degensac_propose_score_plain(x1, x2, mask, H, ia, ib, 16.0)
    near = cp >= 0.9 * cp.max()
    got = Fs.cpu().double()[near]
    _close(got * torch.sign((got * Fp[near]).flatten(1).sum(1))[:, None, None], Fp[near], 1e-4,
           "K46 near-best hypotheses")
    assert int(counts[0]) == 0
    near = near.cuda()  # a degenerate hypothesis's float32 residuals may be off on any row
    _counts_match(counts[near], Fs[near], lambda m: squared_epipolar_line_distance(
        m[:, None], x1.cuda()[None], x2.cuda()[None]), mask.cuda(), 16.0)
    support, idx = unpack_best(int(best))
    assert support == int(counts.max()) and idx == int(torch.argmax(counts)) and support > 1900
    h_inl = torch.zeros_like(mask)
    h_inl[:1600] = True
    F_bad = torch.tensor([[0.0, -1.0, 0.2], [1.0, 0.0, -0.3], [-0.2, 0.3, 0.0]],
                         dtype=torch.float64) @ H
    f_inl = squared_epipolar_line_distance(F_bad, x1, x2) <= 16.0
    pos = torch.from_numpy(np.random.default_rng(5).integers(0, 400, (2, 256)))
    opts = RansacOptions(max_error=4.0)
    out_c = D.degensac_recover_f(None, *cu[:3], F_bad.float().cuda(), f_inl.cuda(), cu[3],
                                 h_inl.cuda(), opts, positions=pos.cuda())
    out_p = D.degensac_recover_f(None, x1, x2, mask, F_bad, f_inl, H, h_inl, opts,
                                 positions=pos)
    assert out_c[3] == out_p[3] and out_p[3]
    assert abs(out_c[1] - out_p[1]) <= 2 and abs(int(out_c[2].sum()) - out_c[1]) <= 2
    Fc, Fp = out_c[0].double().cpu(), out_p[0]
    _close(Fc * torch.sign((Fc * Fp).sum()), Fp, 1e-3, "recovered F")


def test_sprt_kernel_matches_plain_on_cuda():
    """K47 against the float64 plain version on 256 hypotheses x 4000 rows
    (inlier shares 0-60%, a partial mask): accepted and num_evaluated equal
    wherever no running sum lies within 1e-9 of log A."""
    _need_card()
    import math

    from colmap_tpu_torch.kernels import sprt as KP
    from colmap_tpu_torch.optim.sprt import SPRTOptions, decision_threshold

    rng = np.random.default_rng(0)
    M, N = 256, 4000
    share = rng.uniform(0.0, 0.6, (M, 1))
    res = np.where(rng.random((M, N)) < share, rng.uniform(0, 0.9, (M, N)),
                   rng.uniform(1.1, 9.0, (M, N))).astype(np.float32)
    mask = rng.random(N) < 0.95
    o = SPRTOptions()
    args = (1.0, math.log(decision_threshold(o)), math.log(o.delta / o.epsilon),
            math.log((1 - o.delta) / (1 - o.epsilon)))
    acc, num = KP.sprt(torch.from_numpy(res).cuda(), torch.from_numpy(mask).cuda(), *args)
    acc_p, num_p = KP.sprt_plain(torch.from_numpy(res).double(), torch.from_numpy(mask), *args)
    cum = torch.cumsum(KP.sprt_steps(torch.from_numpy(res), torch.from_numpy(mask), 1.0,
                                     args[2], args[3]), -1)
    clear = ((cum - args[1]).abs() > 1e-9).all(-1)
    assert bool(clear.float().mean() > 0.99) and 0 < int(acc_p.sum()) < M
    assert torch.equal(acc.cpu()[clear], acc_p[clear])
    assert torch.equal(num.cpu()[clear], num_p[clear])


@pytest.mark.parametrize("n, fields, masked", [
    (8197, {}, False), (1, {}, False), (2047, {}, False),
    (8197, dict(delta=0.3, epsilon=0.1), False), (2047, dict(delta=0.3, epsilon=0.1), False),
    (8197, {}, True)], ids=["8197", "1", "2047", "8197-delta-above-epsilon",
                            "2047-delta-above-epsilon", "8197-all-masked"])
def test_sprt_block_kernel_cases_on_cuda(n, fields, masked):
    """K47's tiles against the float64 plain version on 96 hypotheses (odd
    N: rows start at every 4-byte offset of a 16-byte line): a row count
    not a multiple of the 2048-row tile, one row, delta > epsilon (inliers
    raise the ratio), every row masked; accepted and num_evaluated equal
    wherever no running sum lies within 1e-9 of log A; one launch."""
    _need_card()
    import math

    from colmap_tpu_torch.kernels import sprt as KP
    from colmap_tpu_torch.optim.sprt import SPRTOptions, decision_threshold

    rng = np.random.default_rng(n)
    M = 96
    share = rng.uniform(0.0, 0.6, (M, 1))
    res = np.where(rng.random((M, n)) < share, rng.uniform(0, 0.9, (M, n)),
                   rng.uniform(1.1, 9.0, (M, n))).astype(np.float32)
    mask = np.zeros(n, bool) if masked else rng.random(n) < 0.95
    o = SPRTOptions(**fields)
    args = (1.0, math.log(decision_threshold(o)), math.log(o.delta / o.epsilon),
            math.log((1 - o.delta) / (1 - o.epsilon)))
    KP.reset_launches()
    acc, num = KP.sprt(torch.from_numpy(res).cuda(), torch.from_numpy(mask).cuda(), *args)
    assert KP.LAUNCHES["sprt"] == 1
    acc_p, num_p = KP.sprt_plain(torch.from_numpy(res).double(), torch.from_numpy(mask), *args)
    cum = torch.cumsum(KP.sprt_steps(torch.from_numpy(res), torch.from_numpy(mask), 1.0,
                                     args[2], args[3]), -1)
    clear = ((cum - args[1]).abs() > 1e-9).all(-1)
    assert bool(clear.float().mean() > 0.95)
    assert torch.equal(acc.cpu()[clear], acc_p[clear])
    assert torch.equal(num.cpu()[clear], num_p[clear])
    if masked or n == 1:
        assert bool(acc.all()) and bool((num == n).all())
    elif fields:
        assert 0 < int(acc_p.sum()) < M


def test_affine_shapes_and_frames_match_plain_on_cuda():
    """K45 against the float64 plain version on octave 0's keypoints of a
    rendered view: shapes within 1e-3 except where the float64 iteration's
    largest entry lies within 1e-3 of the |A| < 8 guard; K15 and K16 on the
    kernel's shapes: the same ok rows, theta within 1e-3 rad except at
    histogram ties within 1e-5, descriptors within 1 count; extract_sift
    with estimate_affine_shape on the card keeps a count within 1% of the
    CPU path's."""
    from colmap_tpu_torch.feature.sift import SiftOptions, extract_sift
    from colmap_tpu_torch.kernels import sift as KS

    _, img, _, gauss, dog = _sift_octave()
    opts = SiftOptions(estimate_affine_shape=True)
    ext = KS.detect_extrema(dog, opts)
    sel = KS.select_candidates(ext, opts.max_candidates_per_octave)
    x, y, lvl, sigma, resp = KS.selected_keypoints(ext, sel)
    g64 = gauss.double()
    shapes = KS.affine_shapes(gauss, x, y, lvl, sigma, opts)
    ref = KS.affine_shapes_plain(g64, x.double(), y.double(), lvl, sigma.double(), opts)
    guard = (ref.abs().amax((1, 2)) - 8.0).abs() > 1e-3
    err = (shapes.double() - ref).abs().amax((1, 2))
    assert bool((err[guard] <= 1e-3).all()) and len(sel) > 50
    theta, ok = KS.orientations(gauss, x, y, lvl, sigma, opts, shapes)
    s64 = shapes.double()
    theta_p, ok_p = KS.orientations_plain(g64, x.double(), y.double(), lvl, sigma.double(), opts,
                                          s64)
    hist = KS.orientation_histograms_plain(g64, x.double(), y.double(), lvl, sigma.double(), s64)
    top = torch.sort(hist, dim=1, descending=True).values
    clear = (top[:, 0] - top[:, 1]).abs() > 1e-5 * top[:, 0]
    agree = (ok == ok_p).all(dim=1)
    assert bool(agree[clear].float().mean() > 0.99)
    both = ok & ok_p & agree[:, None] & clear[:, None]
    dth = torch.remainder(theta.double() - theta_p + torch.pi, 2 * torch.pi) - torch.pi
    assert float(dth[both].abs().max()) <= 1e-3
    data, desc = KS.descriptors(gauss, x, y, lvl, sigma, resp, theta, ok, opts, shapes)
    data_p, _, desc_p = KS.descriptors_plain(g64, x.double(), y.double(), lvl, sigma.double(),
                                             resp.double(), theta.double(), opts, s64)
    rows = ok.reshape(-1)
    assert int((desc[rows].int() - desc_p[rows].int()).abs().max()) <= 1
    _close(data[rows], data_p[rows], 1e-5, "affine descriptor rows")
    view = (img.cpu().numpy() * 255).astype(np.uint8)
    kc, _ = extract_sift(view, opts, device="cuda")
    kp, _ = extract_sift(view, opts, device="cpu")
    assert kc.shape[1] == 6 and abs(len(kc) - len(kp)) <= 0.01 * len(kp)


# K48 and K49 against their plain versions. K48: a batch of injected
# 17-row samples of a 4-camera rig pair (25% outliers) scored in float32
# against the float64 plain version, on the samples that are not degenerate
# (rig_cases.gen_rel_agreement): every count within the rows near the
# threshold, the same best sample or a near-tie, the near-best models (90%
# of the best support) within 1e-6 plus the float64 eigensolve's bound
# SOLVE_EPS / gap; the inlier entry equal off the near rows; the refit (both
# float64) within 1e-9. K49 on an integer-valued image (its Scharr sums are exact in
# float32 in any order): magnitudes within 1e-6 relative, angles within
# 1e-5 rad modulo pi.


def test_gen_rel_ransac_matches_plain_on_cuda():
    _need_card()
    from colmap_tpu_torch.kernels import rig as KR
    from colmap_tpu_torch.kernels import rig_cases as RC
    from colmap_tpu_torch.optim.ransac import unpack_best

    case = RC.gen_rel_case(2000, seed=5)
    data = RC.gen_rel_tensors(case, "cuda", torch.float32)
    data64 = KR.GenRelData(data.rays, *(t.double() if t.is_floating_point() else t
                                        for t in data[1:]))
    samples = RC.gen_rel_samples(2000, 64, 3, case["inliers"], device="cuda")
    max_sq = 16.0
    KR.reset_launches()
    m, c, b = KR.gen_rel_propose_score(data, samples, max_sq)
    m64, c64, b64 = KR.gen_rel_propose_score_plain(data64, samples, max_sq)
    agree = RC.gen_rel_agreement(c, unpack_best(int(b[0])), m, m64, c64,
                                 unpack_best(int(b64[0])), data64, samples, max_sq)
    assert agree["count_ok"] and agree["best_ok"] and agree["model_ok"], agree
    best = unpack_best(int(b64[0]))[1]
    inl = KR.gen_rel_inliers(data, m64[best].float(), max_sq)
    res = KR.gen_rel_residuals(m64[best][None], data64)[0]
    far = (res - max_sq).abs() > 1e-3 * max_sq
    assert torch.equal(inl[far], (res <= max_sq)[far])
    w = (res <= max_sq).double()
    model, ok = KR.gen_rel_refit(data.rays, w)
    model_p, ok_p = KR.gen_rel_refit_plain(data.rays, w)
    assert bool(ok[0]) and bool(ok_p[0])
    assert float((model - model_p).abs().max()) <= 1e-9
    torch.cuda.synchronize()
    assert KR.LAUNCHES["gen_rel_ransac"] == 3


def test_line_gradients_matches_plain_on_cuda():
    _need_card()
    from colmap_tpu_torch.kernels import lines as KL

    img = torch.from_numpy(np.random.default_rng(2).integers(0, 256, (481, 643)).astype(
        np.float32))
    KL.reset_launches()
    mag, ang = KL.line_gradients(img.cuda())
    mag_p, ang_p = KL.line_gradients_plain(img.double())
    rel = (mag.double().cpu() - mag_p).abs() / mag_p.clamp(min=1e-12)
    assert float(rel[mag_p > 0].max()) <= 1e-6
    d = torch.remainder(ang.double().cpu() - ang_p + torch.pi / 2, torch.pi) - torch.pi / 2
    assert float(d[mag_p > 0].abs().max()) <= 1e-5
    assert KL.LAUNCHES["line_gradients"] == 1


# K50-K53 (ALIKED and LightGlue): each float32 kernel against its plain
# version in float64 on the same inputs, within 1e-5 of each output's
# largest entry (float32 sums of up to 1152 products); K51's keypoint order
# exactly, its positions within 1e-5 px; K53 (b)'s match list exactly (the
# random scores have no near-ties).


@pytest.mark.parametrize("k,pool,act,cout", [(3, False, 1, 16), (3, True, 1, 32), (1, False, 0, 32),
                                             (3, False, 2, 1), (3, False, 1, 8), (1, True, 1, 4)])
def test_aliked_conv_matches_plain_on_cuda(k, pool, act, cout):
    _need_card()
    from colmap_tpu_torch.kernels import aliked as KA

    g = torch.Generator().manual_seed(cout + 10 * k)
    x = torch.randn((13, 67, 93), generator=g)
    w = torch.randn((cout, 13, k, k), generator=g) * 0.3
    b = torch.randn(cout, generator=g)
    KA.reset_launches()
    big = torch.full((cout + 8, 33 if pool else 67, 46 if pool else 93), 7.0, device="cuda")
    out = KA.conv(x.cuda(), w.cuda(), b.cuda(), act, pool, out=big[4:4 + cout])
    ref = KA.conv_plain(x.double(), w.double(), b.double(), act, pool)
    _close(out.cpu(), ref, 1e-5, "K50 (a)")
    assert bool((big[:4] == 7.0).all()) and bool((big[4 + cout:] == 7.0).all())
    src = torch.randn((32, 17, 23), generator=g)
    feat = torch.zeros((64, 67, 93), device="cuda")
    KA.upsample_selu(src.cuda(), feat[32:])
    _close(feat[32:].cpu(), KA.upsample_selu_plain(src.double(), (67, 93)), 1e-5, "K50 (b)")
    assert KA.LAUNCHES["aliked_conv"] == 2


def test_aliked_dkd_matches_plain_on_cuda():
    _need_card()
    from colmap_tpu_torch.kernels import aliked as KA

    g = torch.Generator().manual_seed(5)
    score = torch.sigmoid(3.0 * torch.nn.functional.avg_pool2d(
        torch.randn((1, 1, 97, 131), generator=g), 3, 1, 1)[0, 0] + 0.5)
    score[10:14, 20:25] = 1.0  # a saturated plateau: every pixel of it is a peak, tied
    score[50, 60] = score[70, 80] = 0.9  # exact ties between separate peaks
    KA.reset_launches()
    xy, sc = KA.dkd(score.cuda(), 300, 2, 0.2)
    xy_p, sc_p = KA.dkd_plain(score, 300, 2, 0.2)
    assert torch.equal(sc.cpu(), sc_p)
    assert float((xy.cpu() - xy_p).abs().max()) <= 1e-5
    xy_all, _ = KA.dkd(score.cuda(), 10 ** 6, 2, 0.2)
    xy_all_p, _ = KA.dkd_plain(score, 10 ** 6, 2, 0.2)
    assert len(xy_all) == len(xy_all_p) > 300
    assert float((xy_all.cpu() - xy_all_p).abs().max()) <= 1e-5
    assert KA.LAUNCHES["aliked_dkd"] == 2


def _dkd_case(case):
    """(score map, K) for K51's select: "plateau" a saturated 4 x 5 plateau
    (each pixel a peak, tied at 1.0) holding the K-th key; "exact" K equal to the
    number of candidates; "fewer" more K than candidates; "sort_runs" a
    1200 x 1600 map whose 20 000 kept keys fill ten 2048-key sort runs
    and four merges; "band" 24 000 grid peaks within 64 ulps of 0.75 (their keys
    share the first three bytes), the cut inside a tie."""
    g = torch.Generator().manual_seed(51)
    if case in ("band", "sort_runs"):
        H, W = (600, 640) if case == "band" else (1200, 1600)
    else:
        H, W = 97, 131
    score = torch.sigmoid(3.0 * torch.nn.functional.avg_pool2d(
        torch.randn((1, 1, H, W), generator=g), 3, 1, 1)[0, 0] + 0.5)
    if case == "plateau":
        score[10:14, 20:25] = 1.0
        return score, 13
    n_cand = len(_plain_candidates(score))
    if case == "exact":
        return score, n_cand
    if case == "fewer":
        return score, n_cand + 100
    if case == "sort_runs":
        return score, 20000
    score[:] = 0.1
    ulp = float(np.spacing(np.float32(0.75)))
    steps = torch.randint(0, 64, (H // 4, W // 4), generator=g).float()
    steps[3, 5:60] = 63.0
    score[::4, ::4] = 0.75 + steps * ulp
    return score, int((steps == 63).sum()) - 20


def _plain_candidates(score):
    """The scores of every candidate of score (dkd_plain with K = H W)."""
    from colmap_tpu_torch.kernels import aliked as KA

    return KA.dkd_plain(score, score.numel(), 2, 0.2)[1]


@pytest.mark.parametrize("case", ["plateau", "exact", "fewer", "sort_runs", "band"])
def test_aliked_dkd_select_cases_on_cuda(case):
    """K51's radix select, sort and merge on its edge cases: the same list
    of keypoints in the same order as dkd_plain (scores equal), positions
    within 1e-5 px beyond one float32 ulp (chip_smoke.py's K51_PX rule), one
    launch a call."""
    _need_card()
    from colmap_tpu_torch.kernels import aliked as KA

    score, k = _dkd_case(case)
    KA.reset_launches()
    xy, sc = KA.dkd(score.cuda(), k, 2, 0.2)
    xy_p, sc_p = KA.dkd_plain(score, k, 2, 0.2)
    assert len(sc) == len(sc_p) > 0 and torch.equal(sc.cpu(), sc_p)
    # x + dx is rounded to float32: beyond 1024 px one ulp (1.2e-4) exceeds
    # 1e-5, so positions are held within 1e-5 beyond one ulp there.
    ulp = torch.nextafter(xy_p.abs(), torch.full_like(xy_p, torch.inf)) - xy_p.abs()
    assert float(((xy.cpu() - xy_p).abs() - ulp).clamp(min=0).max()) <= 1e-5
    assert KA.LAUNCHES["aliked_dkd"] == 1


def test_aliked_sddh_matches_dense_plain_on_cuda():
    _need_card()
    from colmap_tpu_torch.kernels import aliked as KA

    g = torch.Generator().manual_seed(9)
    C, H, W, M = 128, 37, 45, 16
    feat = torch.nn.functional.selu(torch.randn((C, H, W), generator=g))
    xy = torch.rand((41, 2), generator=g) * torch.tensor([W - 1.0, H - 1.0])
    xy[:6] = torch.tensor([[0.0, 0.0], [W - 1.0, H - 1.0], [0.4, H - 1.0], [W - 1.0, 0.6],
                           [1.5, 2.5], [W - 2.2, 1.0]])
    w1 = torch.randn((C, C, 3, 3), generator=g) * (2.0 / (9 * C)) ** 0.5
    w2 = torch.randn((2 * M, C, 3, 3), generator=g) * (2.0 / (9 * C)) ** 0.5
    b1, b2 = torch.randn(C, generator=g) * 0.1, torch.randn(2 * M, generator=g) * 0.1
    w = torch.randn((C, C, 1, 1), generator=g) * (2.0 / C) ** 0.5
    b = torch.randn(C, generator=g) * 0.1
    agg = torch.randn((M, C, C), generator=g) * (1.0 / C) ** 0.5
    KA.reset_launches()
    cu = [t.cuda() for t in (feat, xy, w1, b1, w2, b2)]
    off = KA.sddh_offsets(*cu)
    off_p = KA.sddh_offsets_plain(*(t.double() for t in (feat, xy, w1, b1, w2, b2)))
    _close(off.cpu(), off_p, 1e-5, "K52 (a)")
    desc = KA.sddh_describe(cu[0], cu[1], off, w.cuda(), b.cuda(), agg.cuda())
    desc_p = KA.sddh_describe_plain(feat.double(), xy.double(), off.double().cpu(), w.double(),
                                    b.double(), agg.double())
    _close(desc.cpu(), desc_p, 1e-5, "K52 (b)")
    assert KA.LAUNCHES["aliked_sddh"] == 2


def test_lightglue_attention_matches_plain_on_cuda():
    _need_card()
    from colmap_tpu_torch.feature.lightglue import rotary_encode
    from colmap_tpu_torch.kernels import lightglue as KLG

    g = torch.Generator().manual_seed(3)
    n1, n2, heads = 150, 77, 4
    qkv = torch.randn((n1, 3 * 256), generator=g)
    kpts = torch.rand((n1, 2), generator=g) * 2 - 1
    cos, sin = rotary_encode(kpts, 256, heads)
    mask = torch.rand(n1, generator=g) > 0.2
    KLG.reset_launches()
    c = qkv.cuda()
    out = KLG.attention(c[:, :256], c[:, 256:512], c[:, 512:], mask.cuda(), mask.cuda(), heads,
                        cos.cuda(), sin.cuda())
    ref = KLG.attention_plain(*(t.double() for t in (qkv[:, :256], qkv[:, 256:512], qkv[:, 512:])),
                              mask, mask, heads, cos.double(), sin.double())
    _close(out.cpu(), ref, 1e-5, "K53 (a) self")
    kv = torch.randn((n2, 512), generator=g)
    mask2 = torch.zeros(n2, dtype=torch.bool)  # every key masked: the softmax averages them
    mask2[:5] = torch.rand(5, generator=g) > 2.0
    for m2 in (mask2, torch.rand(n2, generator=g) > 0.3):
        out = KLG.attention(c[:, :256], kv[:, :256].cuda(), kv[:, 256:].cuda(), mask.cuda(),
                            m2.cuda(), heads)
        ref = KLG.attention_plain(qkv[:, :256].double(), kv[:, :256].double(),
                                  kv[:, 256:].double(), mask, m2, heads)
        _close(out.cpu(), ref, 1e-5, "K53 (a) cross")
    assert KLG.LAUNCHES["lightglue_attention"] == 3


ATTENTION_CARD_CASES = {
    # (nq, nk, the rotation, the key mask, masked queries)
    "self-2085-rotary": (2085, 2085, True, "random", False),
    "cross-1x1500": (1, 1500, False, "random", False),
    "cross-1500x1": (1500, 1, False, "all", False),
    "all-keys-masked-split": (64, 1500, False, "none", False),
    "masked-queries": (300, 300, True, "random", True),
}


@pytest.mark.parametrize("case", list(ATTENTION_CARD_CASES))
def test_lightglue_attention_tensor_core_cases_on_cuda(case):
    """K53 (a) (3xTF32 tiles, the rotation pre-pass, the split keys and
    their merge) within 1e-5 of float64 plain, on q, k, v column blocks of
    a (n, 768) product: self-attention with the rotation at 2085 (a ragged
    last tile of queries and keys), one query against 1500 keys and 1500
    queries against one key, every key masked where the plan splits the
    keys (each row the mean of v), a fifth of the queries masked (rows of
    0); one launch a call."""
    _need_card()
    from colmap_tpu_torch.feature.lightglue import rotary_encode
    from colmap_tpu_torch.kernels import lightglue as KLG

    nq, nk, rotary, keys, masked_q = ATTENTION_CARD_CASES[case]
    heads = 4
    g = torch.Generator().manual_seed(nq + nk)
    a = torch.randn((nq, 768), generator=g)
    b = a if rotary else torch.randn((nk, 768), generator=g)
    mask_q = torch.ones(nq, dtype=torch.bool)
    if masked_q:
        mask_q[torch.randperm(nq, generator=g)[:nq // 5]] = False
    mask_k = {"random": torch.rand(nk, generator=g) > 0.3,
              "all": torch.ones(nk, dtype=torch.bool),
              "none": torch.zeros(nk, dtype=torch.bool)}[keys]
    cos = sin = None
    if rotary:
        cos, sin = rotary_encode(torch.rand((nq, 2), generator=g) * 2 - 1, 256, heads)
    plan = KLG.attention_plan(heads, nq, nk)
    if keys == "none":
        assert plan["splits"] > 1
    KLG.reset_launches()
    ac, bc = a.cuda(), b.cuda()
    out = KLG.attention(ac[:, :256], bc[:, 256:512], bc[:, 512:], mask_q.cuda(), mask_k.cuda(),
                        heads, None if cos is None else cos.cuda(),
                        None if sin is None else sin.cuda())
    assert KLG.LAUNCHES["lightglue_attention"] == 1
    ref = KLG.attention_plain(a[:, :256].double(), b[:, 256:512].double(), b[:, 512:].double(),
                              mask_q, mask_k, heads, None if cos is None else cos.double(),
                              None if sin is None else sin.double())
    out = out.cpu()
    _close(out, ref, 1e-5, f"K53 (a) {case}, {plan['splits']} splits")
    assert not out[~mask_q].any()
    if keys == "none":
        _close(out[mask_q], b[:, 512:].double().mean(0).expand(int(mask_q.sum()), -1), 1e-5,
               "K53 (a), every key masked")


def test_lightglue_assignment_matches_plain_on_cuda():
    _need_card()
    from colmap_tpu_torch.kernels import lightglue as KLG

    g = torch.Generator().manual_seed(4)
    n1, n2 = 130, 97
    sim = torch.randn((n1, n2), generator=g) * 4
    sim[torch.arange(60), torch.arange(60)] += 12.0  # sixty strong mutual matches
    mask1 = torch.rand(n1, generator=g) > 0.1
    mask2 = torch.rand(n2, generator=g) > 0.1
    m1, m2 = torch.rand(n1, generator=g), torch.rand(n2, generator=g)
    KLG.reset_launches()
    for thr in (0.0, 0.1):
        matches, scores = KLG.log_assignment(sim.cuda(), mask1.cuda(), mask2.cuda(), m1.cuda(),
                                             m2.cuda(), thr, want_scores=True)
        scores_p = KLG.log_assignment_plain(sim.double(), mask1, mask2, m1.double(), m2.double())
        valid = mask1[:, None] & mask2[None, :]
        err = (scores.cpu().double() - scores_p)[valid].abs().max()
        assert float(err) <= 1e-5 * float(scores_p[valid].abs().max())
        ref = KLG.extract_matches_plain(scores_p, mask1, mask2, thr)
        assert torch.equal(matches.cpu().long(), ref)
        assert len(ref) > 20
    assert KLG.LAUNCHES["lightglue_attention"] == 2
