"""colmap_tpu_torch's matching and verification slice against colmap_tpu, on the CPU.

The same inputs, made from a numpy seed, go through colmap_tpu (JAX, as the
suite runs it on the CPU in x64 mode) and the port (its plain versions on the
CPU). RANSAC draws its samples from jax.random in colmap_tpu and from a
torch.Generator in the port, so RANSAC is compared by outcome (configuration
and inlier set), never by sample stream. Tolerances are stated per test with
their reason.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from colmap_tpu.controllers import feature_pipeline as jpipeline
from colmap_tpu.estimators import two_view_geometry as jtvg
from colmap_tpu.estimators.solvers import epipolar as jepi
from colmap_tpu.feature import matcher as jmatcher
from colmap_tpu.feature import pairing as jpairing
from colmap_tpu.geometry import essential as jess
from colmap_tpu.optim import ransac as jransac
from colmap_tpu.scene import database as jdb
from colmap_tpu.scene import types as jtypes
from colmap_tpu_torch import convert
from colmap_tpu_torch.cli import main as tcli
from colmap_tpu_torch.controllers import feature_pipeline as tpipeline
from colmap_tpu_torch.estimators import two_view_batch as tbatch
from colmap_tpu_torch.estimators import two_view_geometry as ttvg
from colmap_tpu_torch.estimators.solvers import epipolar as tepi
from colmap_tpu_torch.feature import matcher as tmatcher
from colmap_tpu_torch.feature import pairing as tpairing
from colmap_tpu_torch.geometry import essential as tess
from colmap_tpu_torch.kernels import matching as KM
from colmap_tpu_torch.kernels import matching_cases as C
from colmap_tpu_torch.kernels import sfm as K
from colmap_tpu_torch.optim.ransac import RansacOptions, ransac, ransac_block, unpack_best
from colmap_tpu_torch.scene import database as tdb
from colmap_tpu_torch.scene import synthetic as tsyn
from colmap_tpu_torch.scene import types as ttypes
from colmap_tpu_torch.scene.reconstruction_io import read_model
from colmap_tpu_torch.estimators.alignment import compare_reconstructions

# The reference's end-to-end thresholds (BASELINE.md:13).
MAX_ROT_DEG, MAX_CENTER = 1e-2, 1e-4
CONFIG = ttypes.TwoViewGeometryConfig


def _T(a):
    return torch.from_numpy(np.array(a, dtype=np.float64))


def _up_to_sign(got, ref, tol):
    """Models (..., 3, 3) equal up to the sign of each, with the same NaN slots."""
    got, ref = np.asarray(got).reshape(-1, 9), np.asarray(ref).reshape(-1, 9)
    nan = np.isnan(ref).any(1)
    assert np.array_equal(np.isnan(got).any(1), nan)
    sign = np.sign((got[~nan] * ref[~nan]).sum(1, keepdims=True))
    np.testing.assert_allclose(got[~nan] * sign, ref[~nan], rtol=0, atol=tol)


# ---------------------------------------------------------------------------
# The matcher.
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def descriptors():
    """Three images of 257-300 descriptors with planted matches, rows that
    fail the ratio test, rows that fail the cross check, unequal counts."""
    c = C.descriptor_case(3, 300, 0, "cpu")
    counts = c["counts"].tolist()
    desc = [c["desc"][i, :n].numpy() for i, n in enumerate(counts)]
    kp = [c["keypoints"][i, :n].numpy() for i, n in enumerate(counts)]
    return c, desc, kp


def test_match_similarity_matches_jax(descriptors):
    """Same idx2 and ok per row as colmap_tpu's match_similarity on padded
    sets with masks; both compute in float32 and the planted decisions are
    far from their thresholds."""
    c, _, _ = descriptors
    opts = tmatcher.MatchingOptions()
    rows = torch.arange(c["desc"].shape[1])
    for a, b in c["pairs"].tolist():
        m1, m2 = rows < c["counts"][a], rows < c["counts"][b]
        idx_j, ok_j = jmatcher.match_similarity(
            jnp.asarray(c["desc"][a].numpy()), jnp.asarray(c["desc"][b].numpy()),
            jnp.asarray(m1.numpy()), jnp.asarray(m2.numpy()), jmatcher.MatchingOptions())
        idx_t, ok_t, _, _ = KM.match_similarity_plain(c["desc"][a], c["desc"][b], m1, m2, opts)
        ok_j = np.asarray(ok_j)
        assert np.array_equal(ok_t.numpy(), ok_j)
        assert np.array_equal(idx_t.numpy()[ok_j], np.asarray(idx_j)[ok_j])
        # The case exercises every decision: accepted rows, rows the ratio
        # test rejects and rows only the cross check rejects.
        no_cross = KM.match_similarity_plain(
            c["desc"][a], c["desc"][b], m1, m2, dataclasses.replace(opts, cross_check=False))[1]
        assert ok_j.sum() > 100 and (no_cross & ~ok_t).sum() > 5
        assert (m1 & ~no_cross).sum() > 20


def test_match_descriptors_and_batched_match_jax(descriptors):
    """Identical (K, 2) uint32 match arrays from match_descriptors and
    match_pairs_batched."""
    c, desc, _ = descriptors
    pairs = c["pairs"].numpy()
    batched_t = tmatcher.match_pairs_batched(desc, pairs, device="cpu")
    batched_j = jmatcher.match_pairs_batched(desc, pairs, capacity=512)
    for (a, b), mt, mj in zip(pairs.tolist(), batched_t, batched_j):
        assert mt.dtype == np.uint32 and np.array_equal(mt, mj)
        assert np.array_equal(tmatcher.match_descriptors(desc[a], desc[b], device="cpu"), mj)
    single_j = jmatcher.match_descriptors(desc[0], desc[1])
    assert np.array_equal(batched_t[0], single_j) and len(single_j) > 100
    cut = tmatcher.MatchingOptions(max_num_matches=7)
    assert np.array_equal(tmatcher.match_descriptors(desc[0], desc[1], cut, device="cpu"),
                          single_j[:7])
    assert tmatcher.match_descriptors(desc[0][:0], desc[1], device="cpu").shape == (0, 2)


def test_match_guided_matches_jax(descriptors):
    """Guided matching gives colmap_tpu's matches. The keypoints of planted
    matches satisfy the pair's F exactly while the near-duplicates lie at
    random keypoints, mostly outside the 4 px band: masking them lets rows
    pass that the ratio or the cross check rejected before."""
    c, desc, kp = descriptors
    for k, (a, b) in enumerate(c["pairs"].tolist()):
        F = c["F"][k].numpy()
        got = tmatcher.match_guided(desc[a], desc[b], kp[a], kp[b], F, device="cpu")
        ref = jmatcher.match_guided(desc[a], desc[b], kp[a], kp[b], F)
        assert np.array_equal(got, ref) and len(ref) > 100
        assert len(got) > len(tmatcher.match_descriptors(desc[a], desc[b], device="cpu"))


# ---------------------------------------------------------------------------
# Solvers and residuals, float64 on the same samples: 1e-8 (two
# implementations of the same float64 arithmetic; models up to sign).
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def pair_f():
    return C.two_view_case("F", 200, 24, 3, "cpu", outliers=0.2)


@pytest.fixture(scope="module")
def pair_h():
    return C.two_view_case("H", 200, 24, 4, "cpu", outliers=0.2)


def _proper(case):
    """Which samples hold no row twice (a repeated row leaves the null space
    a dimension too large, and any basis of it is as good as another)."""
    s = np.sort(case["samples"].numpy(), axis=1)
    return (np.diff(s, axis=1) != 0).all(1)


def _samples(case):
    s = case["samples"].long()[torch.from_numpy(_proper(case))]
    return case["x1"].double()[s], case["x2"].double()[s]


def test_fundamental_seven_point_matches_jax(pair_f):
    s1, s2 = _samples(pair_f)
    got = tepi.fundamental_seven_point(s1, s2)
    ref = jax.vmap(jepi.fundamental_seven_point)(jnp.asarray(s1.numpy()), jnp.asarray(s2.numpy()))
    assert got.shape == (len(s1), 3, 3, 3)
    _up_to_sign(got.numpy(), ref, 1e-8)


def test_fundamental_eight_point_matches_jax(pair_f):
    x1, x2 = pair_f["x1"].double(), pair_f["x2"].double()
    w = (torch.arange(200) % 3 != 0).double()
    for weights in (None, w):
        got = tepi.fundamental_eight_point(x1, x2, weights)
        ref = jepi.fundamental_eight_point(jnp.asarray(x1.numpy()), jnp.asarray(x2.numpy()),
                                           None if weights is None else jnp.asarray(w.numpy()))
        _up_to_sign(got.numpy(), ref, 1e-8)
        assert abs(float(torch.linalg.det(got))) < 1e-12  # rank 2


def test_homography_dlt_matches_jax(pair_h):
    s1, s2 = _samples(pair_h)
    got = tepi.homography_dlt(s1, s2)
    ref = jax.vmap(jepi.homography_dlt)(jnp.asarray(s1.numpy()), jnp.asarray(s2.numpy()))
    _up_to_sign(got.numpy(), ref, 1e-8)
    x1, x2 = pair_h["x1"].double(), pair_h["x2"].double()
    w = (torch.arange(200) % 4 != 0).double()
    got = tepi.homography_dlt(x1, x2, w)
    ref = jepi.homography_dlt(jnp.asarray(x1.numpy()), jnp.asarray(x2.numpy()),
                              jnp.asarray(w.numpy()))
    _up_to_sign(got.numpy(), ref, 1e-8)


def test_two_view_residuals_match_jax(pair_f, pair_h):
    """Relative 1e-8: pixel residuals reach 1e5."""
    x1, x2 = pair_h["x1"].double(), pair_h["x2"].double()
    H = tepi.homography_dlt(*_samples(pair_h))
    H[0, 2] = torch.tensor([0.0, 0.0, 0.0])  # w = 0 on every row: infinite errors
    got = tepi.homography_transfer_error(H[:, None], x1[None], x2[None])
    ref = np.asarray(jepi.homography_transfer_error(
        jnp.asarray(H.numpy())[:, None], jnp.asarray(x1.numpy())[None],
        jnp.asarray(x2.numpy())[None]))
    assert np.isinf(got[0].numpy()).all() and np.array_equal(np.isinf(got.numpy()), np.isinf(ref))
    fin = np.isfinite(ref)
    np.testing.assert_allclose(got.numpy()[fin], ref[fin], rtol=1e-8)
    x1, x2 = pair_f["x1"].double(), pair_f["x2"].double()
    F = tepi.fundamental_seven_point(*_samples(pair_f))[:, 0]
    got = tess.squared_epipolar_line_distance(F[:, None], x1[None], x2[None])
    ref = jess.squared_epipolar_line_distance(
        jnp.asarray(F.numpy())[:, None], jnp.asarray(x1.numpy())[None],
        jnp.asarray(x2.numpy())[None])
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-8)
    K1 = _T([[700.0, 0, 400], [0, 710.0, 300], [0, 0, 1]])
    np.testing.assert_allclose(
        tess.essential_from_fundamental(K1, F[0], K1).numpy(),
        np.asarray(jess.essential_from_fundamental(jnp.asarray(K1.numpy()),
                                                   jnp.asarray(F[0].numpy()),
                                                   jnp.asarray(K1.numpy()))), rtol=1e-12)


# ---------------------------------------------------------------------------
# K11 / K12 plain entries against the JAX solver + residual + count composed
# by hand, on injected samples (float64; counts equal, models to 1e-8).
# ---------------------------------------------------------------------------

_FAMILIES = {
    "F": dict(m=7, solve=lambda s1, s2: jax.vmap(jepi.fundamental_seven_point)(s1, s2),
              residual=jess.squared_epipolar_line_distance, refit=jepi.fundamental_eight_point,
              plain=(KM.fundamental_propose_score, KM.fundamental_refit, KM.fundamental_inliers)),
    "H": dict(m=4, solve=lambda s1, s2: jax.vmap(jepi.homography_dlt)(s1, s2),
              residual=jepi.homography_transfer_error, refit=jepi.homography_dlt,
              plain=(KM.homography_propose_score, KM.homography_refit, KM.homography_inliers)),
}


@pytest.mark.parametrize("kind", ["F", "H"])
def test_ransac_entries_match_jax_composition(kind, pair_f, pair_h):
    fam = _FAMILIES[kind]
    case = pair_f if kind == "F" else pair_h
    propose, refit, inliers = fam["plain"]
    x1, x2, mask = case["x1"].double(), case["x2"].double(), case["mask"]
    max_sq = case["max_sq"]
    jx1, jx2, jmask = jnp.asarray(x1.numpy()), jnp.asarray(x2.numpy()), jnp.asarray(mask.numpy())
    s = case["samples"].long().numpy()

    models, counts, best = propose(x1, x2, mask, case["samples"], max_sq)
    jmodels = fam["solve"](jx1[s], jx2[s]).reshape(-1, 3, 3)
    fin = np.isfinite(np.asarray(jmodels)).all((1, 2))
    res = np.asarray(fam["residual"](jmodels[:, None], jx1[None], jx2[None]))
    jcounts = np.where(fin, ((res <= max_sq) & mask.numpy()).sum(1), 0)
    keep = np.repeat(_proper(case), 3 if kind == "F" else 1)  # degenerate samples: any garbage
    assert keep.sum() >= 0.8 * len(keep) and not keep[0]
    assert np.array_equal(counts.numpy()[keep], jcounts[keep])
    _up_to_sign(models.numpy()[keep], np.asarray(jmodels)[keep], 1e-8)
    support, idx = unpack_best(int(best))
    assert support == counts.max() and idx == int(np.argmax(counts.numpy()))

    model = models[idx]
    inl = inliers(x1, x2, mask, model, max_sq)
    jres = np.asarray(fam["residual"](jnp.asarray(model.numpy()), jx1, jx2))
    assert np.array_equal(inl.numpy(), (jres <= max_sq) & mask.numpy())

    # colmap_tpu's _try_refine by hand, from a model that keeps part of the
    # best support: for F the model whose support is nearest to half the
    # best (a sample with an outlier in it), for H the best with a shear of
    # 1% (an error that grows to 8 px across the image).
    start = models[int(torch.argmin((counts - support // 2).abs()))]
    if kind == "H":
        start = model.clone()
        start[0, 1] += 0.01 * model[0, 0]
    w = inliers(x1, x2, mask, start, max_sq)
    count0 = int(w.sum())
    got, n_got = refit(x1, x2, mask, start, max_sq, count0)
    jref = fam["refit"](jx1, jx2, jnp.asarray(w.numpy().astype(np.float64)))
    n_ref = int(((np.asarray(fam["residual"](jref, jx1, jx2)) <= max_sq) & mask.numpy()).sum())
    assert n_ref > count0 and n_got == n_ref
    _up_to_sign(got.numpy(), jref, 1e-8)
    # A refit that does not raise the support is dropped.
    kept, n_kept = refit(x1, x2, mask, start, max_sq, 10**6)
    assert n_kept == 10**6 and torch.equal(kept, start)
    if kind == "F":
        rows = mask & (torch.arange(len(mask)) % 2 == 0)
        _up_to_sign(KM.fundamental_fit(x1, x2, rows).numpy(),
                    jepi.fundamental_eight_point(jx1, jx2, jnp.asarray(rows.double().numpy())),
                    1e-8)


# ---------------------------------------------------------------------------
# The pair axis.
# ---------------------------------------------------------------------------

_BLOCK_KERNELS = {
    "F": (7, KM.fundamental_propose_score, KM.fundamental_refit, KM.fundamental_inliers),
    "H": (4, KM.homography_propose_score, KM.homography_refit, KM.homography_inliers),
    "E": (5, K.essential_propose_score, K.essential_refit, K.essential_inliers),
}


@pytest.mark.parametrize("kind", ["F", "H", "E"])
def test_ransac_block_equals_per_pair_ransac(kind):
    """A pair's result in a block equals that pair run alone: the same trial
    count, support and inlier set; the models to 1e-9 (the block pads every
    pair to the longest, so the refit's sums run over a different length
    and round differently in the last bits)."""
    m, propose, refit, inliers = _BLOCK_KERNELS[kind]
    c = C.two_view_block_case(kind, 5, 160, 2, 7, "cpu")
    x1, x2, mask = c["x1"].double(), c["x2"].double(), c["mask"].clone()
    mask[4] = False  # a pair without a valid row ends after its first batch
    mask[3, 3:] = False  # fewer valid rows than a minimal sample
    sq = c["max_sq"].double() if torch.is_tensor(c["max_sq"]) else c["max_sq"]
    opts = RansacOptions(max_error=4.0, confidence=0.999, min_num_trials=64, max_num_trials=768,
                         min_inlier_ratio=0.25, batch_size=32, lo_outer_rounds=3)
    for lo in (True, False):
        block = ransac_block(
            torch.Generator().manual_seed(5), mask, m,
            lambda idxs, active: propose(x1, x2, mask, idxs, sq, active),
            lambda models: inliers(x1, x2, mask, models, sq), opts,
            local_refine=(lambda models, counts: refit(x1, x2, mask, models, sq, counts))
            if lo else None)
        assert len(set(block.num_trials.tolist())) > 1  # the pairs stop at different times
        for b in range(5):
            n = int(mask[b].sum()) if b < 3 else 160  # alone, a pair is not padded
            a1, a2, am = x1[b, :n], x2[b, :n], mask[b, :n]
            s1 = float(sq[b]) if torch.is_tensor(sq) else sq
            alone = ransac(
                torch.Generator().manual_seed(5), am, m,
                lambda idxs: propose(a1, a2, am, idxs, s1),
                lambda model: inliers(a1, a2, am, model, s1), opts,
                local_refine=(lambda model, count: refit(a1, a2, am, model, s1, count))
                if lo else None)
            assert alone.num_trials == block.num_trials[b]
            assert alone.num_inliers == block.num_inliers[b]
            assert alone.success == block.success[b]
            assert torch.equal(alone.inlier_mask, block.inlier_mask[b, :n])
            assert not bool(block.inlier_mask[b, n:].any())
            np.testing.assert_allclose(torch.nan_to_num(block.model[b]).numpy(),
                                       torch.nan_to_num(alone.model).numpy(), atol=1e-9)
        assert block.success[:3].all() and not block.success[3:].any()


# ---------------------------------------------------------------------------
# Two-view geometry by outcome (the cases of tests/test_ransac_two_view.py).
# ---------------------------------------------------------------------------


def _make_pair(rng, types, calibrated, n_points=150, outlier_ratio=0.3, t=(1.0, 0.1, 0.05),
               angle=0.15):
    f, w, h = 700.0, 800, 600
    cam1 = types.Camera.create(1, 1, f, w, h)  # PINHOLE
    cam2 = types.Camera.create(2, 1, f, w, h)
    cam1.has_prior_focal_length = cam2.has_prior_focal_length = calibrated
    pose21 = types.Pose(np.array([np.cos(angle / 2), 0.0, np.sin(angle / 2), 0.0]), np.array(t))
    X = rng.uniform(-3, 3, (n_points, 3))
    X[:, 2] = rng.uniform(4, 12, n_points)
    x1 = X[:, :2] / X[:, 2:] * f + np.array([w / 2, h / 2])
    Xc2 = pose21.apply(X)
    x2 = Xc2[:, :2] / Xc2[:, 2:] * f + np.array([w / 2, h / 2])
    ok = ((x1 > 0) & (x1 < [w, h]) & (x2 > 0) & (x2 < [w, h])).all(1)
    x1, x2 = x1[ok], x2[ok]
    n = len(x1)
    out_idx = rng.choice(n, int(n * outlier_ratio), replace=False)
    x2[out_idx] = rng.uniform(0, [w, h], (len(out_idx), 2))
    matches = np.stack([np.arange(n), np.arange(n)], axis=1).astype(np.uint32)
    return cam1, x1, cam2, x2, matches, set(out_idx.tolist()), pose21


def _pairs(types):
    """(name, expected configurations, item, outlier rows) of the four cases."""
    out = []
    for name, seed, kwargs, expect in (
            ("calibrated", 1, dict(calibrated=True), (CONFIG.CALIBRATED,)),
            ("uncalibrated", 2, dict(calibrated=False), (CONFIG.UNCALIBRATED,)),
            ("planar", 3, dict(calibrated=True, t=(0.0, 0.0, 0.0), angle=0.1, n_points=200,
                               outlier_ratio=0.0),
             (CONFIG.PLANAR_OR_PANORAMIC, CONFIG.PANORAMIC))):
        cam1, x1, cam2, x2, matches, outliers, pose = _make_pair(
            np.random.default_rng(seed), types, **kwargs)
        out.append((name, expect, (cam1, x1, cam2, x2, matches), outliers, pose))
    rng = np.random.default_rng(4)
    cam = types.Camera.create(1, 1, 700.0, 800, 600)
    noise = np.stack([np.arange(60)] * 2, axis=1).astype(np.uint32)
    out.append(("degenerate", (CONFIG.DEGENERATE,),
                (cam, rng.uniform(0, 800, (60, 2)), cam, rng.uniform(0, 800, (60, 2)), noise),
                set(), None))
    return out


def _check_outcome(g, expect, item, outliers):
    assert g.config in [int(e) for e in expect]
    if g.config == int(CONFIG.DEGENERATE):
        assert len(g.inlier_matches) == 0
        return
    inl = {int(a) for a, _ in g.inlier_matches}
    n_true = len(item[4]) - len(outliers)
    assert len(inl - outliers) > 0.9 * n_true
    if g.config == int(CONFIG.CALIBRATED):  # E leaves random matches no room; F's band does
        assert len(inl & outliers) < 0.05 * len(outliers) + 2


def test_estimate_two_view_geometry_outcomes():
    """Per pair and in a block: the expected configuration and the
    ground-truth inlier set on calibrated, uncalibrated, planar (pure
    rotation) and degenerate pairs; the relative pose of the calibrated pair
    to 1e-2 (it comes from the RANSAC's E, as in colmap_tpu's own test)."""
    cases = _pairs(ttypes)
    opts = ttvg.TwoViewGeometryOptions(compute_relative_pose=True)
    single = [ttvg.estimate_two_view_geometry(*item, opts, device="cpu")
              for _, _, item, _, _ in cases]
    batched = tbatch.estimate_two_view_geometries_batched(
        [item for _, _, item, _, _ in cases], opts, device="cpu")
    for (name, expect, item, outliers, pose), g1, gb in zip(cases, single, batched):
        _check_outcome(g1, expect, item, outliers)
        # A pair's block result is the pair's own result.
        assert gb.config == g1.config and np.array_equal(gb.inlier_matches, g1.inlier_matches)
        for a, b in ((g1.E, gb.E), (g1.F, gb.F), (g1.H, gb.H)):
            assert (a is None) == (b is None)
            if a is not None:
                np.testing.assert_allclose(a, b, atol=1e-9)
        if name == "calibrated":
            q = pose.quat / np.linalg.norm(pose.quat)
            q_est = g1.cam2_from_cam1.quat
            assert min(np.abs(q_est - q).max(), np.abs(q_est + q).max()) < 1e-2
            assert np.abs(g1.cam2_from_cam1.t - pose.t / np.linalg.norm(pose.t)).max() < 1e-2
            assert g1.tri_angle > 0.01 and g1.F is not None
        if name == "uncalibrated":
            assert g1.F is not None and g1.E is None or g1.camera1 is not None
        if name == "planar":
            assert g1.H is not None
    few = ttvg.estimate_two_view_geometry(*[x[:5] if isinstance(x, np.ndarray) else x
                                            for x in cases[3][2]], device="cpu")
    assert few.config == int(CONFIG.DEGENERATE)


def test_two_view_geometry_options_and_helpers():
    """force_H_use, the stationary filter, multiple models, the known-pose
    classification and the outlier extraction."""
    cam1, x1, cam2, x2, matches, outliers, pose = _make_pair(
        np.random.default_rng(1), ttypes, calibrated=True)
    g = ttvg.estimate_two_view_geometry(
        cam1, x1, cam2, x2, matches, ttvg.TwoViewGeometryOptions(force_H_use=True), device="cpu")
    assert g.config in (int(CONFIG.PLANAR_OR_PANORAMIC), int(CONFIG.DEGENERATE))
    known = ttvg.two_view_geometry_from_known_relative_pose(cam1, x1, cam2, x2, pose, matches,
                                                            device="cpu")
    assert known.config == int(CONFIG.CALIBRATED)
    inl = {int(a) for a, _ in known.inlier_matches}
    assert len(inl - outliers) == len(matches) - len(outliers) and len(inl & outliers) < 5
    rest = ttvg.extract_outlier_matches(matches, known.inlier_matches)
    assert len(rest) + len(known.inlier_matches) == len(matches)
    # Stationary matches (a watermark that does not move) are dropped first.
    x2s = x2.copy()
    x2s[:10] = x1[:10] + 0.5
    kept = ttvg.filter_stationary(x1, x2s, matches, 4.0)
    assert len(kept) <= len(matches) - 10 and 0 not in kept[:, 0]
    multi = ttvg.estimate_two_view_geometry(
        cam1, x1, cam2, x2, matches, ttvg.TwoViewGeometryOptions(multiple_models=True),
        device="cpu")
    assert multi.config in (int(CONFIG.CALIBRATED), int(CONFIG.MULTIPLE))
    spherical = dataclasses.replace(cam1, model_id=17, params=np.array([1024.0, 768.0]))
    assert ttvg.is_spherical(spherical) and not ttvg.is_spherical(cam1)
    # A pair with a spherical camera takes the ray path: E and H on bearing
    # rays, never an image-space F (tests/test_torch_cameras.py holds it
    # against colmap_tpu).
    g = ttvg.estimate_two_view_geometry(spherical, x1, cam2, x2, matches, device="cpu")
    assert g.F is None


def _focal_pair(seed, f1, f2, quat, t):
    """Noise-free matches of 200 points seen with focal lengths f1 and f2."""
    rng = np.random.default_rng(seed)
    X = np.concatenate([rng.uniform(-3, 3, (200, 2)), rng.uniform(6, 12, (200, 1))], axis=1)
    pose21 = ttypes.Pose(np.array(quat), np.array(t))

    def project(P, f):
        return P[:, :2] / P[:, 2:3] * f + np.array([512.0, 384.0])

    x1, x2 = project(X, f1), project(pose21.apply(X), f2)
    matches = np.stack([np.arange(len(x1))] * 2, axis=1).astype(np.uint32)
    return x1, x2, matches, pose21


def test_focal_recovery_and_degensac():
    """The cases of colmap_tpu's own tests: an uncalibrated pair of one
    camera recovers its shared focal length from F, and a pair with one
    calibrated side the other side's, both within 3% (Bougnoux and the
    essential-ness sweep on a RANSAC F); the pose from the recovered focal
    within 1 deg. With use_degensac a plane plus off-plane points still
    gives an F that explains both."""
    opts = ttvg.TwoViewGeometryOptions(compute_relative_pose=True, detect_watermark=False)
    cam = ttypes.Camera(1, 0, 1024, 768, np.array([850.0, 512.0, 384.0]))  # a wrong focal
    a = 0.25
    x1, x2, matches, pose21 = _focal_pair(0, 1100.0, 1100.0, [np.cos(a / 2), 0, np.sin(a / 2), 0],
                                          [1.2, 0.1, 0.2])
    g = ttvg.estimate_two_view_geometry(cam, x1, cam, x2, matches, opts, device="cpu")
    assert g.config == int(CONFIG.UNCALIBRATED) and g.camera1 is g.camera2 and g.E is not None
    np.testing.assert_allclose(g.camera1.mean_focal_length(), 1100.0, rtol=0.03)
    assert np.degrees(g.cam2_from_cam1.angle_to(pose21)) < 1.0
    cam1 = ttypes.Camera(1, 0, 1024, 768, np.array([900.0, 512.0, 384.0]),
                         has_prior_focal_length=True)
    cam2 = ttypes.Camera(2, 0, 1024, 768, np.array([700.0, 512.0, 384.0]))
    a = -0.2
    x1, x2, matches, _ = _focal_pair(1, 900.0, 1300.0, [np.cos(a / 2), np.sin(a / 2), 0, 0],
                                     [-0.8, 0.4, 0.1])
    g = ttvg.estimate_two_view_geometry(cam1, x1, cam2, x2, matches, opts, device="cpu")
    assert g.config == int(CONFIG.UNCALIBRATED) and g.camera1 is cam1
    np.testing.assert_allclose(g.camera2.mean_focal_length(), 1300.0, rtol=0.03)

    from colmap_tpu_torch.estimators import degensac
    from colmap_tpu_torch.optim.ransac import RansacOptions as RO

    c = C.two_view_case("H", 300, 2, 2, "cpu", outliers=0.0, valid=300)
    g3 = C.two_view_case("F", 300, 2, 2, "cpu", outliers=0.0, valid=300)
    x1 = torch.cat([c["x1"].double()[:240], g3["x1"].double()[:60]])
    x2 = torch.cat([c["x2"].double()[:240], g3["x2"].double()[:60]])
    mask = torch.ones(300, dtype=torch.bool)
    H = tepi.homography_dlt(x1[:240], x2[:240])
    h_inl = tepi.homography_transfer_error(H, x1, x2) <= 16.0
    F_bad = tess.cross_product_matrix(_T([0.3, 0.2, 1.0])) @ H  # explains the plane only
    f_inl = tess.squared_epipolar_line_distance(F_bad, x1, x2) <= 16.0
    assert degensac.is_h_degenerate(int(f_inl.sum()), int((f_inl & h_inl).sum()))
    F, n, inl, recovered = degensac.degensac_recover_f(
        torch.Generator().manual_seed(0), x1, x2, mask, F_bad, f_inl, H, h_inl, RO(max_error=4.0))
    assert recovered and n >= 295 and int(inl.sum()) == n


@pytest.mark.slow
def test_estimate_two_view_geometry_matches_jax():
    """colmap_tpu's estimate_two_view_geometry on the same pairs: the same
    configuration and, up to the rows at the threshold, the same inliers."""
    for (name, expect, item, outliers, _), (_, _, jitem, _, _) in zip(_pairs(ttypes),
                                                                       _pairs(jtypes)):
        gt = ttvg.estimate_two_view_geometry(*item, device="cpu")
        gj = jtvg.estimate_two_view_geometry(*jitem)
        assert gt.config == gj.config
        a = {tuple(r) for r in gt.inlier_matches.tolist()}
        b = {tuple(r) for r in gj.inlier_matches.tolist()}
        assert len(a ^ b) <= 0.02 * max(len(a), 1) + 1


# ---------------------------------------------------------------------------
# Pairing, options, conversion, the commands.
# ---------------------------------------------------------------------------


def test_pairing_matches_jax(tmp_path):
    ids = list(range(3, 40))
    assert list(tpairing.exhaustive_pairs(ids, tpairing.ExhaustivePairingOptions(block_size=7))) \
        == list(jpairing.exhaustive_pairs(ids, jpairing.ExhaustivePairingOptions(block_size=7)))
    for overlap, quad in ((3, True), (5, False)):
        assert tpairing.sequential_pairs(
            ids, tpairing.SequentialPairingOptions(overlap=overlap, quadratic_overlap=quad)) \
            == jpairing.sequential_pairs(
                ids, jpairing.SequentialPairingOptions(overlap=overlap, quadratic_overlap=quad))
    pos = np.random.default_rng(0).uniform(0, 50, (len(ids), 3))
    assert tpairing.spatial_pairs(ids, pos, tpairing.SpatialPairingOptions(max_num_neighbors=4)) \
        == jpairing.spatial_pairs(ids, pos, jpairing.SpatialPairingOptions(max_num_neighbors=4))
    listing = tmp_path / "pairs.txt"
    listing.write_text("# list\na.png b.png\nb.png c.png\nc.png missing.png\n\n")
    names = {"a.png": 1, "b.png": 2, "c.png": 3}
    assert tpairing.imported_pairs(str(listing), names) \
        == jpairing.imported_pairs(str(listing), names) == [(1, 2), (2, 3)]
    dbs = []
    for mod in (tdb, jdb):
        db = mod.Database(str(tmp_path / f"{mod.__name__}.db"))
        for a, b in ((1, 2), (2, 3), (3, 4), (5, 6)):
            db.write_matches(a, b, np.array([[0, 1]], dtype=np.uint32))
        dbs.append(db)
    got = tpairing.transitive_pairs(dbs[0])
    assert sorted(got) == sorted(jpairing.transitive_pairs(dbs[1])) and (1, 3) in got


def test_convert_options_and_two_view_geometry_round_trip():
    """The options of the slice and a TwoViewGeometry carry across both ways."""
    j = jpipeline.MatchingPipelineOptions(
        matching=jmatcher.MatchingOptions(max_ratio=0.7, cross_check=False),
        verification=jtvg.TwoViewGeometryOptions(
            min_num_inliers=21, use_degensac=True,
            ransac=jransac.RansacOptions(max_error=3.0, batch_size=96)),
        min_num_inliers=11, guided_matching=True)
    t = convert.convert_options(j)
    assert isinstance(t, tpipeline.MatchingPipelineOptions)
    assert isinstance(t.matching, tmatcher.MatchingOptions) and t.matching.max_ratio == 0.7
    assert isinstance(t.verification, ttvg.TwoViewGeometryOptions)
    assert isinstance(t.verification.ransac, RansacOptions)
    assert t.verification.ransac.batch_size == 96 and t.verification.min_num_inliers == 21
    back = convert.convert_options(t, jpipeline.MatchingPipelineOptions)
    assert isinstance(back.verification.ransac, jransac.RansacOptions)
    assert dataclasses.asdict(back) == dataclasses.asdict(j) == dataclasses.asdict(t)
    defaults = convert.convert_options(jtvg.TwoViewGeometryOptions())
    assert dataclasses.asdict(defaults) == dataclasses.asdict(ttvg.TwoViewGeometryOptions())

    g = jtypes.TwoViewGeometry(
        config=int(CONFIG.CALIBRATED), E=np.eye(3), F=np.arange(9.0).reshape(3, 3),
        cam2_from_cam1=jtypes.Pose(np.array([1.0, 0, 0, 0]), np.array([1.0, 2, 3])),
        inlier_matches=np.array([[0, 1], [2, 3]], dtype=np.uint32), tri_angle=0.2,
        camera1=jtypes.Camera.create(1, 1, 700.0, 800, 600))
    t = convert.convert_two_view_geometry(g)
    assert isinstance(t, ttypes.TwoViewGeometry) and isinstance(t.camera1, ttypes.Camera)
    back = convert.convert_two_view_geometry(t, jtypes)
    assert isinstance(back.cam2_from_cam1, jtypes.Pose) and back.H is None
    for a, b in ((back, g), (t, g)):
        assert a.config == b.config and a.tri_angle == b.tri_angle
        assert np.array_equal(a.inlier_matches, b.inlier_matches)
        assert np.array_equal(a.E, b.E) and np.array_equal(a.F, b.F)
        assert np.array_equal(a.cam2_from_cam1.t, b.cam2_from_cam1.t)
        assert np.array_equal(a.camera1.params, b.camera1.params)


def _feature_database(root, syn, db_mod):
    """The verify scene's database stripped to features, and what the
    generator had written: (path, ground truth, {pair: matches})."""
    path = os.path.join(root, "db.db")
    db = db_mod.Database(path)
    gt = syn.synthesize_dataset(
        syn.SyntheticDatasetOptions(num_rigs=1, num_cameras_per_rig=1, num_frames_per_rig=8,
                                    num_points3D=120, camera_has_prior_focal_length=True),
        db, rng=np.random.default_rng(3))
    ids = [iid for iid, _, _ in db.read_images()]
    truth = {(a, b): db.read_matches(a, b) for a in ids for b in ids if a < b}
    db.conn.execute("DELETE FROM matches")
    db.conn.execute("DELETE FROM two_view_geometries")
    db.commit()
    db.close()
    return path, gt, truth


def _as_set(matches):
    return {tuple(r) for r in np.asarray(matches).tolist()}


def test_matcher_commands_default_to_cuda_and_raise_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    path = str(tmp_path / "new.db")
    tcli.main(["database_creator", "--database_path", path])
    assert os.path.exists(path)
    parser = tcli.build_parser()
    for cmd, extra in (("exhaustive_matcher", []), ("sequential_matcher", ["--overlap", "2"]),
                       ("matches_importer", ["--match_list_path", path])):
        args = parser.parse_args([cmd, "--database_path", path] + extra)
        assert args.device == "cuda"
        with pytest.raises(RuntimeError, match="CUDA"):
            tcli.main([cmd, "--database_path", path] + extra)
    # matcher_type="lightglue" runs on the CPU: two images sharing 40 of
    # their features get LightGlue's matches written (2 layers, threshold 0).
    from colmap_tpu_torch.feature.lightglue import LightGlueOptions

    rng = np.random.default_rng(2)
    db = tdb.Database(path)
    cam = db.write_camera(ttypes.Camera.create(0, "SIMPLE_RADIAL", 500.0, 640, 480),
                          use_camera_id=False)
    desc = rng.integers(0, 256, (60, 128)).astype(np.uint8)
    kp = np.concatenate([rng.uniform(0, 480, (60, 2)), np.ones((60, 1)), np.zeros((60, 1))],
                        axis=1).astype(np.float32)
    for name, rows in (("a.png", slice(0, 60)), ("b.png", slice(20, 60))):
        iid = db.write_image(name, cam)
        db.write_keypoints(iid, kp[rows])
        db.write_descriptors(iid, desc[rows])
    tpipeline.run_exhaustive_matching(
        db, tpipeline.MatchingPipelineOptions(
            matcher_type="lightglue",
            lightglue_options=LightGlueOptions(num_layers=2, filter_threshold=0.0)),
        device="cpu")
    (_, matches), = db.read_all_matches()
    assert len(matches) >= 20 and (matches[:, 0] == matches[:, 1] + 20).mean() > 0.9
    db.close()


def test_matching_wrappers_never_fall_back_off_the_cpu():
    """A tensor that is neither on the CPU nor on a CUDA device gets no plain
    version: the wrappers raise."""
    desc = torch.zeros(2, 8, 128, dtype=torch.uint8, device="meta")
    counts = torch.zeros(2, dtype=torch.int32, device="meta")
    pairs = torch.zeros(1, 2, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        KM.match_top2(desc, counts, pairs, tmatcher.MatchingOptions())
    x = torch.zeros(8, 2, device="meta")
    mask = torch.zeros(8, dtype=torch.bool, device="meta")
    model = torch.zeros(3, 3, device="meta")
    for m, propose, refit, inliers in _BLOCK_KERNELS.values():
        samples = torch.zeros(4, m, dtype=torch.int32, device="meta")
        for call in (lambda: propose(x, x, mask, samples, 1.0),
                     lambda: refit(x, x, mask, model, 1.0, 0),
                     lambda: inliers(x, x, mask, model, 1.0)):
            with pytest.raises(ValueError, match="no kernel for device"):
                call()
    with pytest.raises(ValueError, match="no kernel for device"):
        KM.fundamental_fit(x, x, mask)


def test_features_to_model_through_the_commands(tmp_path, capsys):
    """The slice as a whole: features -> exhaustive_matcher --device cpu ->
    every pair's matches equal the generator's and verify as CALIBRATED with
    those inliers -> mapper --device cpu -> 8/8 frames within the reference
    thresholds (1e-2 deg, 1e-4 units)."""
    path, gt, truth = _feature_database(str(tmp_path), tsyn, tdb)
    tcli.main(["exhaustive_matcher", "--database_path", path, "--device", "cpu"])
    assert f"Verified {len(truth)} image pairs" in capsys.readouterr().out
    db = tdb.Database(path, must_exist=True)
    for (a, b), gen in truth.items():
        assert _as_set(db.read_matches(a, b)) == _as_set(gen)
        g = db.read_two_view_geometry(a, b)
        assert g.config == int(CONFIG.CALIBRATED) and g.E is not None and g.F is not None
        assert _as_set(g.inlier_matches) == _as_set(gen)
    db.close()
    out = str(tmp_path / "sparse")
    tcli.main(["mapper", "--database_path", path, "--output_path", out, "--device", "cpu",
               "--quiet"])
    cmp = compare_reconstructions(read_model(os.path.join(out, "0")), gt)
    assert cmp["num_common_images"] == 8
    assert cmp["max_rotation_error_deg"] <= MAX_ROT_DEG and cmp["max_center_error"] <= MAX_CENTER


def test_sequential_matcher_and_matches_importer(tmp_path, capsys):
    """sequential_matcher --overlap 1 verifies the 7 pairs of neighbours in
    name order (quadratic overlap adds the pairs at distance 2);
    matches_importer the pairs of its list; guided matching keeps a
    verified pair's inliers."""
    path, _, truth = _feature_database(str(tmp_path), tsyn, tdb)
    tcli.main(["sequential_matcher", "--database_path", path, "--overlap", "1", "--device", "cpu"])
    assert "Verified 13 image pairs" in capsys.readouterr().out
    db = tdb.Database(path, must_exist=True)
    assert db.num_verified_pairs() == 13 and db.read_two_view_geometry(1, 5) is None
    names = {iid: name for iid, name, _ in db.read_images()}
    listing = tmp_path / "pairs.txt"
    listing.write_text(f"{names[1]} {names[5]}\n{names[2]} {names[8]}\n")
    db.close()
    tcli.main(["matches_importer", "--database_path", path, "--match_list_path", str(listing),
               "--device", "cpu"])
    assert "Verified 2 of 2 imported pairs" in capsys.readouterr().out
    db = tdb.Database(path, must_exist=True)
    assert _as_set(db.read_two_view_geometry(1, 5).inlier_matches) == _as_set(truth[(1, 5)])
    n = tpipeline.run_matches_import(
        db, [(3, 7)], tpipeline.MatchingPipelineOptions(guided_matching=True), device="cpu")
    assert n == 1
    assert _as_set(db.read_two_view_geometry(3, 7).inlier_matches) == _as_set(truth[(3, 7)])
    db.close()


@pytest.mark.slow
def test_exhaustive_matching_matches_jax(tmp_path):
    """colmap_tpu's run_exhaustive_matching on the same features: pair by
    pair the same matches, configuration and inlier set."""
    from colmap_tpu.scene import synthetic as jsyn

    for sub in ("t", "j"):
        os.makedirs(tmp_path / sub)
    tpath, _, _ = _feature_database(str(tmp_path / "t"), tsyn, tdb)
    jpath, _, truth = _feature_database(str(tmp_path / "j"), jsyn, jdb)
    t_db, j_db = tdb.Database(tpath, must_exist=True), jdb.Database(jpath, must_exist=True)
    assert tpipeline.run_exhaustive_matching(t_db, device="cpu") \
        == jpipeline.run_exhaustive_matching(j_db) == len(truth)
    for a, b in truth:
        assert np.array_equal(t_db.read_matches(a, b), j_db.read_matches(a, b))
        gt_, gj = t_db.read_two_view_geometry(a, b), j_db.read_two_view_geometry(a, b)
        assert gt_.config == gj.config
        assert _as_set(gt_.inlier_matches) == _as_set(gj.inlier_matches)
