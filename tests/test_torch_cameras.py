"""colmap_tpu_torch's camera models 5-17, mixed models and spherical pairs
against colmap_tpu, on the CPU.

The same inputs, made from a numpy seed, go through colmap_tpu (JAX in
float64, as the suite runs it) and the port (its plain versions, float64 on
the CPU): the three camera maps of models 5-17 on random points and over a
wide lens's whole image, K1's plain Jacobians against jax.jacfwd of
colmap_tpu's residual for each model, the mixed-model BA problem (packing,
masks, cost, solve), mixed filtering, a mixed rig BA solve, the port's mapper
on colmap_tpu's mixed scene, the ray solvers, the angular residuals, the
plain versions of K32 and K33 inside their RANSACs, and spherical two-view
geometry on colmap_tpu's equirectangular pairs, one pair and through
``exhaustive_matcher``. RANSAC draws its samples from jax.random in
colmap_tpu and from a torch.Generator in the port, so the RANSACs are
compared by outcome (inlier sets, models against the truth), never by
sample stream. Each tolerance is stated in its test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from colmap_tpu.estimators import ba_setup as jsetup
from colmap_tpu.estimators import bundle_adjustment as jba
from colmap_tpu.estimators import bundle_adjustment_rig as jrba
from colmap_tpu.estimators import spherical as jsph
from colmap_tpu.estimators import two_view_geometry as jtvg
from colmap_tpu.estimators.solvers import epipolar as jepi
from colmap_tpu.scene import synthetic as jsyn
from colmap_tpu.scene import types as jtypes
from colmap_tpu.scene.database import Database as JDatabase
from colmap_tpu.sensor import models as jm
from colmap_tpu.sfm import filtering as jfilter
from colmap_tpu_torch import convert
from colmap_tpu_torch.cli import main as tcli
from colmap_tpu_torch.estimators import ba_setup as tsetup
from colmap_tpu_torch.estimators import bundle_adjustment as tba
from colmap_tpu_torch.estimators import bundle_adjustment_rig as trba
from colmap_tpu_torch.estimators import spherical as tsph
from colmap_tpu_torch.estimators import two_view_geometry as ttvg
from colmap_tpu_torch.estimators.alignment import compare_reconstructions
from colmap_tpu_torch.estimators.solvers import epipolar as tepi
from colmap_tpu_torch.geometry import rotation as trot
from colmap_tpu_torch.kernels import ba as KB
from colmap_tpu_torch.kernels import sfm as KS
from colmap_tpu_torch.kernels import sfm_cases as SC
from colmap_tpu_torch.kernels import spherical_cases as QC
from colmap_tpu_torch.scene.database import Database as TDatabase
from colmap_tpu_torch.scene.reconstruction_io import read_model
from colmap_tpu_torch.scene.synthetic import SyntheticDatasetOptions, synthesize_dataset
from colmap_tpu_torch.scene.synthetic_ba import synthetic_ba_problem
from colmap_tpu_torch.scene.types import TwoViewGeometryConfig
from colmap_tpu_torch.sensor import models as tm

torch.set_num_threads(1)

NEW_MODELS = list(range(5, 18))
NAMES = [tm.MODEL_ID_TO_NAME[m] for m in NEW_MODELS]
# colmap_tpu's mixed scene (tests/test_mixed_camera_models.py:23).
MIXED = dict(camera_model_ids=(2, 5), camera_params_list=(
    (1280.0, 512.0, 384.0, 0.02), (900.0, 900.0, 512.0, 384.0, 0.01, -0.005, 0.001, 0.0)))
MAX_ROT_DEG, MAX_CENTER = 1e-2, 1e-4  # the reference thresholds (BASELINE.md:13)


def _close(got, ref, tol, name=""):
    """max |got - ref| <= tol * max(max |ref|, 1)."""
    got, ref = np.asarray(got, dtype=np.float64), np.asarray(ref, dtype=np.float64)
    err = np.abs(got - ref).max() if got.size else 0.0
    scale = max(np.abs(ref).max() if ref.size else 0.0, 1.0)
    assert err <= tol * scale, f"{name}: {err:.3e} > {tol:g} * {scale:.3e}"


def _t(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.float64)


@pytest.mark.parametrize("model_id", NEW_MODELS, ids=NAMES)
def test_camera_maps_match_jax(model_id):
    """img_from_cam (both cheirality modes), cam_from_img and cam_ray_from_img
    on points around the camera and over a 185-degree lens's whole image
    (sfm_cases.wide_grid_case): values to 1e-9 of their scale, validity
    masks equal."""
    p, uvw, xy = SC.camera_map_case(model_id, 200, model_id, "cpu")
    p, uvw, xy = p.double(), uvw.double(), xy.double()
    uvw[:5] *= -1.0
    for cheirality in (True, False):
        txy, tok = tm.img_from_cam(model_id, p, uvw, check_cheirality=cheirality)
        jxy, jok = jm.img_from_cam(model_id, jnp.asarray(p.numpy()), jnp.asarray(uvw.numpy()),
                                   check_cheirality=cheirality)
        _close(txy, jxy, 1e-9, "img_from_cam")
        np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    grids = [(p, xy)]
    if model_id in SC.WIDE_MODELS:
        gp, gxy = SC.wide_grid_case(model_id, 41, "cpu")
        grids.append((gp.double(), gxy.double()))
    for params, pix in grids:
        for tfn, jfn in ((tm.cam_from_img, jm.cam_from_img),
                         (tm.cam_ray_from_img, jm.cam_ray_from_img)):
            tout, tok = tfn(model_id, params, pix)
            jout, jok = jfn(model_id, jnp.asarray(params.numpy()), jnp.asarray(pix.numpy()))
            np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
            ok = tok.numpy()
            _close(tout.numpy()[ok], np.asarray(jout)[ok], 1e-9, tfn.__name__)


@pytest.mark.parametrize("model_id", NEW_MODELS, ids=NAMES)
def test_obs_jacobians_plain_match_jacfwd(model_id):
    """K1's plain version (torch.func.jacfwd) against jax.jacfwd of
    colmap_tpu's residual (_obs_jacobians), masks all 1: r, Jp, Jc, Jx to
    1e-9 of each block's scale."""
    p, _, _ = synthetic_ba_problem(4, 30, 4, model_id=model_id, seed=model_id,
                                   dtype=torch.float64, device="cpu")
    p = p._replace(cam_params=_t(SC.camera_params(model_id))[None])
    F, N, P = p.quat.shape[0], p.points.shape[0], p.cam_params.shape[1]
    opts = tba.BAOptions(loss="cauchy", loss_scale=2.0)
    ones = torch.ones
    got = KB.obs_jacobians_plain(p.quat, p.t, p.cam_params, p.points, p.obs_frame.long(),
                                 p.obs_cam.long(), p.obs_point.long(), p.obs_xy, p.obs_w,
                                 ones(F, 6, dtype=torch.float64), ones(1, P, dtype=torch.float64),
                                 ones(N, dtype=torch.float64), model_id, opts.loss,
                                 opts.loss_scale)
    jp = jba.BAProblem(*(jnp.asarray(x.numpy()) for x in p))
    ref = jba._obs_jacobians(jp, model_id, jba.BAOptions(loss="cauchy", loss_scale=2.0))
    for name, a, b in zip(("r", "Jp", "Jc", "Jx"), got, ref):
        _close(a, b, 1e-9, f"{name} of model {model_id}")


def _mixed_scenes(seed=3, **options):
    """colmap_tpu's mixed scene from both packages' generators (the same
    numpy seed writes the same scene)."""
    opt = dict(num_rigs=2, num_cameras_per_rig=1, num_frames_per_rig=4, num_points3D=120,
               camera_has_prior_focal_length=True, **MIXED)
    opt.update(options)
    jrec = jsyn.synthesize_dataset(jsyn.SyntheticDatasetOptions(**opt), JDatabase(":memory:"),
                                   rng=np.random.default_rng(seed))
    trec = synthesize_dataset(SyntheticDatasetOptions(**opt), TDatabase(":memory:"),
                              rng=np.random.default_rng(seed))
    return jrec, trec


def test_mixed_problem_packs_costs_and_solves():
    """tests/test_mixed_camera_models.py:47 on the port: the same padded rows
    (OPENCV_FISHEYE's 8 + the model column) and masks as colmap_tpu, a zero
    cost at the truth, the perturbed problem's cost to 1e-9 relative of
    colmap_tpu's, and the solve to below 1e-6."""
    jrec, trec = _mixed_scenes()
    jp, jindex = jsetup.problem_from_reconstruction(jrec, bucket=False)
    tp, tindex = tsetup.problem_from_reconstruction(trec, device="cpu")
    assert tindex["model_id"] == jindex["model_id"] == (2, 5)
    _close(tp.cam_params, jp.cam_params, 0.0, "cam_params")
    opts = tba.BAOptions(max_iterations=5, pcg_iterations=30)
    jopts = jba.BAOptions(max_iterations=5, pcg_iterations=30)
    masks = tba.fix_gauge_two_frames(tba.default_masks(tp, tindex["model_id"], opts), 0, 1)
    jmasks = jba.fix_gauge_two_frames(jba.default_masks(jp, jindex["model_id"], jopts), 0, 1)
    _close(masks.cam_mask, jmasks.cam_mask, 0.0, "cam_mask")
    assert float(tba.compute_cost(tp, tindex["model_id"], opts)) < 1e-6
    noise = 0.01 * np.random.default_rng(0).standard_normal(tuple(tp.points.shape))
    tpert = tp._replace(points=tp.points + _t(noise))
    jpert = jp._replace(points=jp.points + noise)
    ct = float(tba.compute_cost(tpert, tindex["model_id"], opts))
    cj = float(jba.compute_cost(jpert, jindex["model_id"], jopts))
    assert abs(ct - cj) <= 1e-9 * cj
    solved, summary = tba.solve_packed(tpert, tindex["model_id"], opts, masks)
    assert summary["final_cost"] < 1e-6
    tsetup.update_reconstruction(trec, solved, tindex)


def test_mixed_filtering_matches_jax():
    """K9's plain version with a tuple of models against colmap_tpu's
    _filter_kernel (errors, depths to 1e-9; the same infinite errors), and
    filter_points3D on the noise-free mixed scene deletes nothing
    (tests/test_mixed_camera_models.py:87)."""
    c = SC.filter_case(60, 1, "cpu", model_id=2)
    rows = tm.pack_mixed_params([SC.camera_params(2), SC.camera_params(5)], [2, 5])[1]
    rng = np.random.default_rng(2)
    pick = rng.integers(0, 2, c["valid"].shape)
    params = _t(rows[pick])
    keys = ("quat", "t", "xyz", "obs_xy", "valid")
    d = {k: c[k].double() if c[k].is_floating_point() else c[k] for k in keys}
    got = KS.filter_points_plain((2, 5), d["quat"], d["t"], params, d["xyz"], d["obs_xy"],
                                 d["valid"])
    ref = jfilter._filter_kernel((2, 5), *(jnp.asarray(x.numpy()) for x in (
        d["quat"], d["t"], params, d["xyz"], d["obs_xy"], d["valid"])))
    fin = np.isfinite(np.asarray(ref[0]))
    np.testing.assert_array_equal(torch.isfinite(got[0]).numpy(), fin)
    _close(got[0].numpy()[fin], np.asarray(ref[0])[fin], 1e-9, "errors")
    _close(got[1], ref[1], 1e-9, "depths")
    from colmap_tpu_torch.sfm.filtering import filter_points3D

    _, trec = _mixed_scenes()
    assert filter_points3D(trec, 4.0, 0.5, device="cpu") == 0
    assert len(trec.points3D) == 120


def test_mixed_rig_ba_matches_jax():
    """A rig problem whose two rigs (two cameras each) have SIMPLE_RADIAL and
    OPENCV_FISHEYE cameras: the port's packing equals colmap_tpu's (to 1e-12:
    the two generators round the sensors' observations differently), the
    masks equal, and three LM steps from perturbed points reach colmap_tpu's
    final cost to 1e-4 relative (each step cuts the cost by about two orders
    of magnitude, so PCG's float64 sums in another order show at ~1e-5 of the
    final cost; the initial costs agree to 1e-9)."""
    jrec, trec = _mixed_scenes(num_cameras_per_rig=2, num_frames_per_rig=3, num_points3D=80)
    jp, jindex = jsetup.rig_problem_from_reconstruction(jrec)
    tp, tindex = tsetup.rig_problem_from_reconstruction(trec, device="cpu", dtype=torch.float64)
    assert tindex["model_id"] == jindex["model_id"] == (2, 5)
    for name, a, b in zip(trba.RigBAProblem._fields, tp, jp):
        _close(a.numpy(), np.asarray(b), 1e-12, name)
    noise = 0.01 * np.random.default_rng(1).standard_normal(tuple(tp.points.shape))
    opts = tba.BAOptions(max_iterations=3, pcg_iterations=20)
    jopts = jba.BAOptions(max_iterations=3, pcg_iterations=20)
    tpert = tp._replace(points=tp.points + _t(noise))
    jpert = jp._replace(points=jp.points + noise)
    tmask = trba.fix_gauge_two_frames(trba.default_masks(tpert, (2, 5), opts), 0, 1)
    jmask = jrba.fix_gauge_two_frames(jrba.default_masks(jpert, (2, 5), jopts), 0, 1)
    _close(tmask.cam_mask, jmask.cam_mask, 0.0, "cam_mask")
    _, st = trba.solve(tpert, (2, 5), opts, tmask)
    _, sj = jrba.solve(jpert, (2, 5), jopts, jmask)
    assert abs(st["initial_cost"] - sj["initial_cost"]) <= 1e-9 * sj["initial_cost"]
    assert abs(st["final_cost"] - sj["final_cost"]) <= 1e-4 * sj["final_cost"]
    assert st["final_cost"] < 1e-6 * st["initial_cost"]


@pytest.mark.parametrize("solver", ["ba", "rig"])
def test_mixed_solve_groups_slots_once(solver, monkeypatch):
    """A mixed solve builds its per-model slot groups once, whatever the
    iteration count (each build is an argsort and a host read), and ends
    where a solve that regroups on every call ends (to 1e-12 relative)."""
    calls = []
    real = KB.model_groups

    def counted(*args):
        calls.append(1)
        return real(*args)

    _, trec = _mixed_scenes(num_cameras_per_rig=2, num_frames_per_rig=2, num_points3D=40)
    opts = tba.BAOptions(max_iterations=4, pcg_iterations=10, function_tolerance=0.0)
    if solver == "ba":
        p, index = tsetup.problem_from_reconstruction(trec, device="cpu")
        masks = tba.default_masks(p, index["model_id"], opts)
        packed, maps, _ = tba.pack_problem(p._replace(points=p.points + 0.01))
        kern = tba.ba_kernels
        run = lambda kernels: tba._lm_loop(packed, maps, index["model_id"], opts, masks, False,
                                           True, kernels=kernels)
    else:
        p, index = tsetup.rig_problem_from_reconstruction(trec, device="cpu", dtype=torch.float64)
        masks = trba.default_masks(p, index["model_id"], opts)
        p = p._replace(points=p.points + 0.01)
        kern = trba.rig_kernels
        run = lambda kernels: trba._lm_loop(p, index["model_id"], opts, masks, kernels=kernels)
    monkeypatch.setattr(KB, "model_groups", counted)
    monkeypatch.setattr(trba, "model_groups", counted)
    _, cost, iters = run(kern.PLAIN)
    assert iters == 4 and len(calls) == 1

    def regroup(fn):  # drops the solver's groups: each call builds its own
        return lambda *args: fn(*args[:-1], None)

    # The BA loop's costs are float64 sums (obs_cost64); the rig loop's obs_cost.
    costs = [f for f in ("obs_cost", "obs_cost64") if f in kern.PLAIN._fields]
    per_call = kern.PLAIN._replace(obs_jacobians=regroup(kern.PLAIN.obs_jacobians),
                                   **{f: regroup(getattr(kern.PLAIN, f)) for f in costs})
    _, cost_per_call, _ = run(per_call)
    assert len(calls) > 1 + 2 * iters
    assert abs(cost - cost_per_call) <= 1e-12 * max(cost_per_call, 1e-30)


def test_mixed_mapper_end_to_end(tmp_path):
    """The port's mapper on colmap_tpu's mixed mapper scene (2 x 4 frames x
    120 points, seed 5, tests/test_mixed_camera_models.py:97): 8/8 frames
    within 1e-2 deg and 1e-4 units of the truth."""
    opt = SyntheticDatasetOptions(num_rigs=2, num_cameras_per_rig=1, num_frames_per_rig=4,
                                  num_points3D=120, camera_has_prior_focal_length=True, **MIXED)
    db = TDatabase(str(tmp_path / "db.db"))
    gt = synthesize_dataset(opt, db, rng=np.random.default_rng(5))
    db.close()
    tcli.main(["mapper", "--database_path", str(tmp_path / "db.db"), "--output_path",
               str(tmp_path / "sparse"), "--device", "cpu", "--quiet"])
    recon = read_model(str(tmp_path / "sparse" / "0"))
    cmp = compare_reconstructions(recon, gt)
    assert recon.num_reg_frames() == 8 and cmp["num_common_images"] == 8
    assert cmp["max_rotation_error_deg"] < MAX_ROT_DEG
    assert cmp["max_center_error"] < MAX_CENTER


def test_ray_solvers_match_jax():
    """The ray solvers on samples of a noise-free pair with translation and
    of a rotation: the constraint rows r2 ⊗ r1 equal colmap_tpu's exactly
    (the 5-point elimination behind them, _essential_five_point_from_
    constraints, is held against colmap_tpu's in test_torch_geometry.py);
    on every sample of five distinct rays the 5-point solutions include the
    true E to 1e-6 (up to sign and scale; Newton-Schulz's four steps onto the
    essential manifold leave ~1e-7) and satisfy the sample's five
    constraints r2ᵀ E r1 = 0 to 1e-8 (unit E and rays); the weighted 8-point on rays and the ray DLT (4
    rays and weighted N rays) equal colmap_tpu's to 1e-9 (up to sign)."""
    ce = QC.ray_case("E", 60, 12, 0, "cpu", outliers=0.0, noise_px=0.0)
    ch = QC.ray_case("H", 60, 8, 1, "cpu", outliers=0.0, noise_px=0.0)
    r1, r2 = ce["x1"].double(), ce["x2"].double()
    np.testing.assert_array_equal(tepi._ray_constraint_matrix(r1, r2).numpy(),
                                  np.asarray(jepi._ray_constraint_matrix(jnp.asarray(r1.numpy()),
                                                                         jnp.asarray(r2.numpy()))))
    tn = ce["t"] / np.linalg.norm(ce["t"])
    truth = np.array([[0, -tn[2], tn[1]], [tn[2], 0, -tn[0]], [-tn[1], tn[0], 0]]) @ ce["R"]
    truth /= np.linalg.norm(truth)
    s = ce["samples"].long()
    s = s[torch.tensor([len(set(row.tolist())) == 5 for row in s])]  # non-degenerate samples
    assert len(s) >= 6
    got = tepi.essential_five_point_rays(r1[s], r2[s]).numpy()
    for k in range(len(s)):
        sols = [E / np.linalg.norm(E) for E in got[k] if np.isfinite(E).all()]
        assert min(np.abs(E * np.sign((E * truth).sum()) - truth).max() for E in sols) <= 1e-6
        a, b = r1[s[k]].numpy(), r2[s[k]].numpy()
        assert max(np.abs(np.einsum("ni,ij,nj->n", b, E, a)).max() for E in sols) <= 1e-8

    def signed(a, b):
        a, b = np.asarray(a), np.asarray(b)
        return a * np.sign((a * b).sum()), b

    w = (torch.arange(60) % 3 != 0).double()
    for tfn, jfn, (a1, a2) in ((tepi.essential_eight_point_rays, jepi.essential_eight_point_rays,
                                (r1, r2)),
                               (tepi.homography_ray_dlt, jepi.homography_ray_dlt,
                                (ch["x1"].double(), ch["x2"].double()))):
        _close(*signed(tfn(a1, a2, w), jfn(jnp.asarray(a1.numpy()), jnp.asarray(a2.numpy()),
                                            jnp.asarray(w.numpy()))), 1e-9, tfn.__name__)
    a1, a2 = ch["x1"][:4].double(), ch["x2"][:4].double()
    _close(*signed(tepi.homography_ray_dlt(a1, a2),
                   jepi.homography_ray_dlt(jnp.asarray(a1.numpy()), jnp.asarray(a2.numpy()))),
           1e-9, "4-ray DLT")


def test_k33_eight_rows_match_jax_ray_dlt():
    """K33's solve keeps 8 of the 4-ray DLT's 12 rows (spherical_cases
    ray_dlt_rows8): the kept rows have rank 8 and their null vector, in
    float64, equals colmap_tpu's homography_ray_dlt up to sign within 1e-9,
    on seeded samples whose r2 rays have their largest component on each
    axis with either sign (alone and mixed in a sample) and on samples whose
    r2 rays tie on their largest components."""
    c = QC.ray_case("H", 2000, 4, 7, "cpu", outliers=0.0)
    r1, r2 = c["x1"].double(), c["x2"].double()
    idx = QC.axis_samples(r2, c["mask"], 6, 3).long()
    s1, s2 = r1[idx], r2[idx]
    axes = s2.abs().argmax(-1)
    assert {(int(k), bool(v)) for k, v in zip(axes.flatten(), (
        s2.gather(-1, axes[..., None])[..., 0] > 0).flatten())} == {
            (k, v) for k in range(3) for v in (True, False)}
    ties = torch.tensor([[[1.0, 1.0, 0.2], [0.3, -1.0, 1.0], [1.0, 1.0, 1.0], [-1.0, 0.1, -1.0]],
                         [[-1.0, -1.0, 0.0], [0.0, 1.0, -1.0], [1.0, -1.0, -1.0],
                          [0.5, 0.5, 0.5]]], dtype=torch.float64)
    s1 = torch.cat([s1, r1[10:18].reshape(2, 4, 3)])
    s2 = torch.cat([s2, ties / ties.norm(dim=-1, keepdim=True)])
    assert bool((torch.linalg.svdvals(QC.ray_dlt_rows8(s1, s2))[..., 7] > 1e-6).all())
    got = QC.ray_dlt8(s1, s2).numpy()
    ref = np.asarray(jepi.homography_ray_dlt(jnp.asarray(s1.numpy()), jnp.asarray(s2.numpy())))
    sign = np.sign((got * ref).sum((-2, -1)))[:, None, None]
    _close(got * sign, ref, 1e-9, "8-row null vector")


def test_spherical_residuals_match_jax():
    """angular_sampson_error and homography_ray_angular_error against
    colmap_tpu's on the rays of a case and random models: 1e-12 of scale."""
    c = QC.ray_case("E", 200, 4, 3, "cpu")
    r1, r2 = c["x1"].double()[:197], c["x2"].double()[:197]
    M = _t(np.random.default_rng(4).standard_normal((3, 3)))
    for tfn, jfn in ((tsph.angular_sampson_error, jsph.angular_sampson_error),
                     (tsph.homography_ray_angular_error, jsph.homography_ray_angular_error)):
        _close(tfn(M, r1, r2), jfn(jnp.asarray(M.numpy()), jnp.asarray(r1.numpy()),
                                   jnp.asarray(r2.numpy())), 1e-12, tfn.__name__)


@pytest.mark.parametrize("kind", ["E", "H"])
def test_ray_ransac_plain_matches_jax(kind):
    """K32's / K33's plain versions inside the port's LO-RANSAC against
    colmap_tpu's _ransac_e_rays / _ransac_h_rays on 300 rays with 30%
    outliers and 212 padding rows (a pair with translation for E, a rotation
    for H): the inlier sets differ on at most 1% of the rows, and both models are within 1e-2
    (E up to sign, each scaled to unit Frobenius norm) of the truth."""
    c = QC.ray_case(kind, 512, 4, 5 if kind == "E" else 6, "cpu", valid=300)
    r1, r2, mask = c["x1"].double(), c["x2"].double(), c["mask"]
    thresh = float(np.sqrt(c["max_sq"]))
    # Verification's options and 512 rows: the shapes of colmap_tpu's
    # two-view path, so that its program compiles once for both tests.
    jopts = jtvg.TwoViewGeometryOptions().ransac
    opts = ttvg.TwoViewGeometryOptions().ransac

    jfn = jsph._ransac_e_rays if kind == "E" else jsph._ransac_h_rays
    tfn = tsph._ransac_e_rays if kind == "E" else tsph._ransac_h_rays
    jres = jfn(jax.random.PRNGKey(0), jnp.asarray(r1.numpy()), jnp.asarray(r2.numpy()),
               jnp.asarray(mask.numpy()), jnp.asarray(thresh), jopts)
    tres = tfn(torch.Generator().manual_seed(0), r1, r2, mask, thresh, opts)
    diff = int((tres.inlier_mask.numpy() != np.asarray(jres.inlier_mask)).sum())
    assert diff <= 3, diff
    R, t = c["R"], c["t"]
    if kind == "E":
        tn = t / np.linalg.norm(t)
        truth = np.array([[0, -tn[2], tn[1]], [tn[2], 0, -tn[0]], [-tn[1], tn[0], 0]]) @ R
    else:
        truth = R
    truth = truth / np.linalg.norm(truth)
    for model in (tres.model.numpy(), np.asarray(jres.model)):
        model = model / np.linalg.norm(model)
        assert np.abs(model * np.sign((model * truth).sum()) - truth).max() < 1e-2


def _equirect_pair(kind):
    """colmap_tpu's calibrated (seed 12) and panoramic (seed 13) pairs,
    tests/test_ransac_two_view.py:454-500."""
    if kind == "calibrated":
        a = 0.3
        R = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]])
        return QC.spherical_pair(np.random.default_rng(12), R, np.array([0.8, 0.2, 0.3])), R
    a = 0.4
    R = np.array([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0], [0, 0, 1]])
    return QC.spherical_pair(np.random.default_rng(13), R, np.zeros(3), outlier_ratio=0.1), R


@pytest.mark.parametrize("kind", ["calibrated", "panoramic"])
def test_spherical_two_view_geometry_matches_jax(kind):
    """estimate_two_view_geometry on colmap_tpu's equirectangular pairs: the
    configuration colmap_tpu gives them (CALIBRATED, PANORAMIC with tri_angle
    0), the rotation within colmap_tpu's test bounds (2e-2 calibrated, 1e-2
    panoramic), more than 80% of the true matches kept, and for the
    calibrated pair the translation direction within 5e-2 and at most 10% of
    the planted outliers among the inliers. (colmap_tpu's own test allows it
    3 of the 45 outliers, the count its draws give; the port's draws give 1-4
    of them over RANSAC seeds 0-5, the last LO refit keeping outliers that lie
    within the 4 px band.)"""
    (cam, x1, x2, matches, out_idx), R = _equirect_pair(kind)
    opts = ttvg.TwoViewGeometryOptions(compute_relative_pose=True, detect_watermark=False)
    g = ttvg.estimate_two_view_geometry(cam, x1, cam, x2, matches, opts, device="cpu")
    jcam = convert.convert_camera(cam, jtypes)
    jg = jtvg.estimate_two_view_geometry(jcam, x1, jcam, x2, matches, jtvg.TwoViewGeometryOptions(
        compute_relative_pose=True, detect_watermark=False))
    assert g.config == jg.config == int(TwoViewGeometryConfig.CALIBRATED if kind == "calibrated"
                                         else TwoViewGeometryConfig.PANORAMIC)
    R_est = trot.quat_to_rotmat(torch.as_tensor(g.cam2_from_cam1.quat)).numpy()
    assert np.abs(R_est - R).max() < (0.02 if kind == "calibrated" else 0.01)
    inl = {int(a) for a, _ in g.inlier_matches}
    assert len(inl) > 0.8 * (len(matches) - len(out_idx))
    if kind == "calibrated":
        assert len(inl & set(out_idx.tolist())) <= 0.1 * len(out_idx)
        tn = np.array([0.8, 0.2, 0.3]) / np.linalg.norm([0.8, 0.2, 0.3])
        assert min(np.abs(g.cam2_from_cam1.t - tn).max(),
                   np.abs(g.cam2_from_cam1.t + tn).max()) < 0.05
        assert g.tri_angle > 0.01
    else:
        assert g.tri_angle == 0.0


def test_exhaustive_matcher_cpu_on_an_equirectangular_database(tmp_path):
    """``exhaustive_matcher --device cpu`` on four 2048 x 1024
    EQUIRECTANGULAR frames of 200 points with 0.25 px of noise and 3%
    planted outliers (frames 0 and 1 share a center): every pair verified,
    CALIBRATED (frames with translation) or PLANAR_OR_PANORAMIC (the
    rotation-only pair, which pose recovery turns PANORAMIC, or PLANAR as
    colmap_tpu does with noise, its rotation within colmap_tpu's 0.02 of the
    truth, tests/test_ransac_two_view.py:440-500); no more than 5% of the planted outlier
    matches among the inliers (the 4 px band, ±1.2e-2 rad at this width,
    holds about 1.2% of the sphere around an epipolar great circle, and the
    rotation-only pair keeps E's inliers, whose circle is arbitrary); the
    geometry of the rotation-only pair and of one pair with translation
    equal to the one-pair path's."""
    db_path = str(tmp_path / "db.db")
    poses, outliers = QC.write_database(db_path, 4, 200, seed=7, width=2048, height=1024)
    tcli.main(["exhaustive_matcher", "--database_path", db_path, "--device", "cpu"])
    db = TDatabase(db_path, must_exist=True)
    cam = db.read_camera(1)
    kps = {i: db.read_keypoints(i)[:, :2] for i in range(1, 5)}
    planted = inliers_planted = 0
    opts = ttvg.TwoViewGeometryOptions()
    geometries = sorted(db.read_all_two_view_geometries(), key=lambda x: x[:2])
    assert len(geometries) == 6
    for i1, i2, g in geometries:
        matches = db.read_matches(i1, i2)
        bad = outliers[i1][matches[:, 0]] | outliers[i2][matches[:, 1]]
        planted += int(bad.sum())
        inl = g.inlier_matches
        inliers_planted += int((outliers[i1][inl[:, 0]] | outliers[i2][inl[:, 1]]).sum())
        expected = (TwoViewGeometryConfig.PLANAR_OR_PANORAMIC if (i1, i2) == (1, 2)
                    else TwoViewGeometryConfig.CALIBRATED)
        assert g.config == int(expected), (i1, i2, g.config)
        if (i1, i2) not in ((1, 2), (1, 3)):
            continue
        one = ttvg.estimate_two_view_geometry(cam, kps[i1], cam, kps[i2], matches, opts,
                                              device="cpu")
        assert one.config == g.config and np.array_equal(one.inlier_matches, inl)
        if (i1, i2) == (1, 2):
            tsph.recover_spherical_pose(one, cam, kps[i1], cam, kps[i2], device="cpu")
            assert one.config in (int(TwoViewGeometryConfig.PLANAR),
                                  int(TwoViewGeometryConfig.PANORAMIC))
            R = poses[1][0] @ poses[0][0].T
            R_est = trot.quat_to_rotmat(torch.as_tensor(one.cam2_from_cam1.quat)).numpy()
            assert np.abs(R_est - R).max() <= 0.02
    db.close()
    assert planted > 0 and inliers_planted <= 0.05 * planted
