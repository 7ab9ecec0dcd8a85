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
(their tolerances are stated above their tests).
"""

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
    red = K.lm_reduce(*J, fpm, cpm, F, C, 1e-3)
    ref = K.lm_reduce_plain(*_f64(*J), fpm, cpm, F, C, 1e-3)
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
    _need_card()
    from colmap_tpu_torch.kernels import sfm as K

    xy = torch.zeros(4, 2, device="cuda")
    with pytest.raises(NotImplementedError):
        K.cam_from_img(5, torch.ones(8, device="cuda"), xy)


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
    assert all(v > 0 for v in KM.LAUNCHES.values())
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
    assert all(v > 0 for v in KS.LAUNCHES.values()), KS.LAUNCHES
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
