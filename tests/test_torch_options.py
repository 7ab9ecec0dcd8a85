"""colmap_tpu_torch's front-end and RANSAC options against colmap_tpu, on the CPU.

Options that are off by default: MSAC support and progressive sampling in
the RANSAC harness (optim/ransac.py), the combination sampler
(optim/samplers.py), the SPRT (optim/sprt.py, K47's plain version),
DEGENSAC (estimators/degensac.py, K46's plain version with K11's refit and
inliers) and affine-covariant SIFT (K45's plain version, with K15 and K16 on
affine frames). The same inputs, made from a numpy seed, go through
colmap_tpu (JAX on the CPU in x64, as tests/conftest.py sets it) and the
port's plain versions in float64. RANSAC draws from jax.random in
colmap_tpu and from a torch.Generator in the port: whole RANSACs are
compared by outcome, and single steps on injected draws or models. Each
test states its tolerance.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from colmap_tpu.estimators import degensac as jdeg
from colmap_tpu.estimators import two_view_geometry as jtvg
from colmap_tpu.estimators.solvers import epipolar as jepi
from colmap_tpu.feature import sift as J
from colmap_tpu.optim import ransac as jransac
from colmap_tpu.optim import samplers as jsamplers
from colmap_tpu.optim import sprt as jsprt
from colmap_tpu.scene import types as jtypes
from colmap_tpu_torch import convert
from colmap_tpu_torch.estimators import degensac as tdeg
from colmap_tpu_torch.estimators import two_view_batch as tbatch
from colmap_tpu_torch.estimators import two_view_geometry as ttvg
from colmap_tpu_torch.estimators.solvers import epipolar as tepi
from colmap_tpu_torch.feature import sift as T
from colmap_tpu_torch.geometry import essential as tess
from colmap_tpu_torch.kernels import matching as KM
from colmap_tpu_torch.kernels import sfm as K
from colmap_tpu_torch.kernels import sift as KS
from colmap_tpu_torch.kernels import spherical as KQ
from colmap_tpu_torch.kernels import sprt as KP
from colmap_tpu_torch.optim import ransac as tr
from colmap_tpu_torch.optim import samplers as tsamplers
from colmap_tpu_torch.optim import sprt as tsprt
from colmap_tpu_torch.scene import types as ttypes

torch.set_num_threads(1)  # one intra-op thread a worker, as the other port test files


def _T(a, dtype=torch.float64):
    return torch.from_numpy(np.array(a)).to(dtype)


# ---------------------------------------------------------------------------
# Options, samplers, SPRT.
# ---------------------------------------------------------------------------


def test_convert_options_carries_the_option_fields():
    """convert_options carries sampling, support, progressive_full_pool_trials,
    use_degensac and the SIFT shape options field for field."""
    jr = jransac.RansacOptions(sampling="progressive", support="m_estimator",
                               progressive_full_pool_trials=512)
    jo = jtvg.TwoViewGeometryOptions(use_degensac=True, ransac=jr)
    to = convert.convert_options(jo)
    assert dataclasses.asdict(to) == dataclasses.asdict(jo)
    assert isinstance(to.ransac, tr.RansacOptions) and to.ransac.support == "m_estimator"
    js = J.SiftOptions(estimate_affine_shape=True, affine_shape_iterations=3)
    assert dataclasses.asdict(convert.convert_options(js)) == dataclasses.asdict(js)


@pytest.mark.parametrize("n,m", [(5, 2), (7, 3), (9, 4), (6, 6)])
def test_all_combinations_equal_the_reference(n, m):
    got = tsamplers.all_combinations(n, m)
    assert got.dtype == np.int32
    assert np.array_equal(got, jsamplers.all_combinations(n, m))


def test_shuffled_combinations_and_the_cap_equal_the_reference():
    for seed in (0, 3):
        assert np.array_equal(
            tsamplers.shuffled_combinations(8, 3, np.random.default_rng(seed)),
            jsamplers.shuffled_combinations(8, 3, np.random.default_rng(seed)))
    with pytest.raises(ValueError, match="max_count"):
        tsamplers.all_combinations(100, 10, max_count=1000)


@pytest.mark.parametrize("fields", [{}, dict(delta=0.05, epsilon=0.4),
                                    dict(eval_time_ratio=20.0, num_models_per_sample=2.5)])
def test_decision_threshold_within_1e12(fields):
    got = tsprt.decision_threshold(tsprt.SPRTOptions(**fields))
    want = jsprt.decision_threshold(jsprt.SPRTOptions(**fields))
    assert got > 1.0 and abs(got - want) <= 1e-12


def _sprt_cases():
    """The cases of tests/test_samplers_sprt.py (a good and a bad
    hypothesis; every row masked) and a random batch with partial masks."""
    n = 500
    good = np.where(np.arange(n) % 5 < 2, 0.0, 100.0)
    cases = [(np.stack([good, np.full(n, 100.0)]), np.ones(n, bool), 1.0, {}),
             (np.full((1, 100), 100.0), np.zeros(100, bool), 1.0, {})]
    rng = np.random.default_rng(0)
    share = rng.uniform(0.0, 0.5, (40, 1))
    res = np.where(rng.random((40, 300)) < share, rng.uniform(0, 0.9, (40, 300)),
                   rng.uniform(1.1, 9, (40, 300)))
    cases.append((res, rng.random(300) < 0.9, 1.0, dict(delta=0.05, epsilon=0.3)))
    return cases


@pytest.mark.parametrize("case", range(3))
def test_sprt_evaluate_equals_the_reference(case):
    """accepted and num_evaluated equal sprt_evaluate's (float64 sums; no
    running sum of these cases lies within 1e-9 of log A)."""
    res, mask, thr, fields = _sprt_cases()[case]
    acc, num = tsprt.sprt_evaluate(_T(res), torch.from_numpy(mask), thr,
                                   tsprt.SPRTOptions(**fields))
    jacc, jnum = jsprt.sprt_evaluate(jnp.asarray(res), jnp.asarray(mask), thr,
                                     jsprt.SPRTOptions(**fields))
    assert np.array_equal(acc.numpy(), np.asarray(jacc))
    assert np.array_equal(num.numpy(), np.asarray(jnum)) and num.dtype == torch.int32
    if case == 2:
        assert 0 < int(acc.sum()) < len(acc)  # both outcomes occur


def _sprt_count_cases():
    """_sprt_cases, then delta > epsilon (log_in > 0 > log_out: inliers
    raise the ratio), every row invalid, and N = 2051 (not a multiple of
    the kernel's 2048-row tile)."""
    rng = np.random.default_rng(1)
    share = rng.uniform(0.0, 0.6, (64, 1))
    res = np.where(rng.random((64, 2051)) < share, rng.uniform(0, 0.9, (64, 2051)),
                   rng.uniform(1.1, 9, (64, 2051)))
    return _sprt_cases() + [
        (res[:, :300], rng.random(300) < 0.9, 1.0, dict(delta=0.3, epsilon=0.1)),
        (res[:, :300], np.zeros(300, bool), 1.0, {}),
        (res, rng.random(2051) < 0.95, 1.0, {}),
    ]


@pytest.mark.parametrize("case", range(6))
def test_sprt_count_model_equals_the_reference(case):
    """K47's evaluation from integer counts (sprt_count_model) against
    sprt_evaluate: the same decisions and rows on every hypothesis whose
    float64 running sum stays 1e-9 away from log A."""
    res, mask, thr, fields = _sprt_count_cases()[case]
    o = tsprt.SPRTOptions(**fields)
    args = (thr, math.log(tsprt.decision_threshold(o)), math.log(o.delta / o.epsilon),
            math.log((1 - o.delta) / (1 - o.epsilon)))
    acc, num = KP.sprt_count_model(_T(res, torch.float32), torch.from_numpy(mask), *args)
    jacc, jnum = jsprt.sprt_evaluate(jnp.asarray(res.astype(np.float32)), jnp.asarray(mask),
                                     thr, jsprt.SPRTOptions(**fields))
    step = np.where(mask, np.where(res.astype(np.float32) <= thr, args[2], args[3]), 0.0)
    clear = (np.abs(np.cumsum(step, -1) - args[1]) > 1e-9).all(-1)
    assert clear.mean() > 0.95 and num.dtype == torch.int32
    assert np.array_equal(acc.numpy()[clear], np.asarray(jacc)[clear])
    assert np.array_equal(num.numpy()[clear], np.asarray(jnum)[clear])
    if case == 3:
        assert args[2] > 0 > args[3] and 0 < int(acc.sum()) < len(acc)
    if case == 4:
        assert acc.all() and (num == res.shape[1]).all()


# ---------------------------------------------------------------------------
# MSAC and progressive sampling in the harness.
# ---------------------------------------------------------------------------


def _reference_pick(models, res, mask, max_sq, support):
    """colmap_tpu's ransac on one batch of injected models and residuals:
    the model it keeps."""
    M = models.shape[0]
    opts = jransac.RansacOptions(max_error=float(np.sqrt(max_sq)), batch_size=M,
                                 min_num_trials=M, max_num_trials=M, support=support)
    out = jransac.ransac(jax.random.PRNGKey(0), res.shape[1], 1,
                         lambda idxs: jnp.asarray(models), lambda m: jnp.asarray(res)[:m.shape[0]],
                         opts, jnp.asarray(mask))
    return np.asarray(out.model)


def _scored_batch():
    rng = np.random.default_rng(1)
    models = rng.normal(size=(12, 3))
    res = rng.uniform(0, 2.0, (12, 50)) ** 2
    mask = rng.random(50) < 0.9
    models[3] = np.nan  # a non-finite model scores 0
    res[7] = res[2]  # a tie: the first of the two wins
    res[2, 0] = 0.0  # ... unless model 2 is ahead; keep 2 and 7 equal
    res[7, 0] = 0.0
    res[[2, 7]] *= 0.3  # the best scores
    return models, res, mask


@pytest.mark.parametrize("support", ["inlier_count", "m_estimator"])
def test_score_models_picks_the_reference_best(support):
    """score_models and pack_best_scores / pack_best on injected models and
    residuals: the same best (the first of a planted tie), score and count
    as colmap_tpu's _score through its ransac."""
    models, res, mask = _scored_batch()
    max_sq = 1.0
    msac = support == "m_estimator"
    counts, scores = tr.score_models(_T(models), _T(res), torch.from_numpy(mask), max_sq, msac)
    best = tr.pack_best_scores(scores) if msac else tr.pack_best(counts)
    idx = 0xFFFFFFFF - (int(best) & 0xFFFFFFFF)
    model = _reference_pick(models, res, mask, max_sq, support)
    assert idx == 2 and np.array_equal(models[idx], model)
    assert int(counts[idx]) == int(((res[idx] <= max_sq) & mask).sum())
    assert int(counts[3]) == 0 and float(scores[3]) == 0.0
    want = np.where(mask, np.maximum(max_sq - res, 0.0), 0.0).sum(1) if msac else counts.numpy()
    np.testing.assert_allclose(scores.numpy()[np.arange(12) != 3], want[np.arange(12) != 3],
                               rtol=1e-12)
    if msac:  # the float32 bits of the best score ride in the high word
        assert (int(best) >> 32) == int(torch.tensor(float(scores[idx])).float()
                                        .view(torch.int32)) & 0xFFFFFFFF


def test_msac_nan_row_is_an_outlier_here_and_freezes_the_reference():
    """A NaN residual on a valid row: colmap_tpu's MSAC score of every finite
    model turns NaN (jnp.maximum propagates it), so its argmax takes the
    first finite model and no later score can beat NaN; the port counts the
    row as an outlier and picks the model that is best on the other rows
    (ROADMAP §3, faults of the reference)."""
    models, res, mask = _scored_batch()
    res[:, 10] = np.nan
    mask[10] = True
    model = _reference_pick(models, res, mask, 1.0, "m_estimator")
    assert np.array_equal(model, models[0])  # the first finite model, not the best
    counts, scores = tr.score_models(_T(models), _T(res), torch.from_numpy(mask), 1.0, True)
    assert torch.isfinite(scores).all()
    assert int(torch.argmax(scores)) == 2
    clean = mask.copy()
    clean[10] = False
    _, want = tr.score_models(_T(models), _T(res), torch.from_numpy(clean), 1.0, True)
    assert torch.equal(scores, want)


def test_msac_refit_equals_try_refine():
    """The MSAC refit (K11's plain version) against colmap_tpu's _try_refine
    with msac on the same model: the same kept model and count, and the
    score to 1e-9."""
    from colmap_tpu_torch.kernels import matching_cases as C

    c = C.two_view_case("H", 300, 2, 4, "cpu", outliers=0.0)
    x1, x2, mask = c["x1"].double(), c["x2"].double(), c["mask"]
    x2[200:] = _T(np.random.default_rng(4).uniform(0, 1000, (100, 2)))  # outliers
    max_sq = c["max_sq"]
    H = tepi.homography_dlt(x1[:40], x2[:40])
    start = H.clone()
    start[0, 1] += 0.01 * H[0, 0]
    res0 = tepi.homography_transfer_error(start, x1, x2)
    count0, score0 = tr.score_models(start[None], res0[None], mask, max_sq, True)
    got, n_got, s_got = KM.homography_refit(x1, x2, mask, start, max_sq, int(count0[0]),
                                            float(score0[0]))
    jx1, jx2, jm = jnp.asarray(x1.numpy()), jnp.asarray(x2.numpy()), jnp.asarray(mask.numpy())

    def residual(models):
        return jepi.homography_transfer_error(models[:, None], jx1[None], jx2[None])

    @jax.jit
    def try_refine(model, score, count):
        return jransac._try_refine(model, score, count, residual,
                                   lambda m, w: jepi.homography_dlt(jx1, jx2, w), jm, max_sq,
                                   msac=True)

    model, score, count = try_refine(jnp.asarray(start.numpy()), jnp.asarray(float(score0[0])),
                                     jnp.asarray(int(count0[0])))
    assert n_got == int(count) and n_got > int(count0[0])
    assert abs(s_got - float(score)) <= 1e-9 * float(score)
    got = got.numpy() / np.linalg.norm(got.numpy())
    want = np.asarray(model) / np.linalg.norm(np.asarray(model))
    np.testing.assert_allclose(got * np.sign((got * want).sum()), want, atol=1e-9)


def test_progressive_pool_equals_the_reference():
    """The pool of each batch: colmap_tpu's ransac with sampling
    "progressive" records its draws (positions = rows under an identity
    quality order); the largest draw of each of its 8 batches of 1024 x 4
    positions is port's progressive_pool - 1, from 4 rows up to all 300."""
    n, K, m = 300, 1024, 4
    draws = []

    def estimate(idxs):
        jax.debug.callback(lambda s: draws.append(np.asarray(s)), idxs)
        return jnp.zeros((idxs.shape[0], 2))

    opts = jransac.RansacOptions(sampling="progressive", batch_size=K, min_num_trials=8 * K,
                                 max_num_trials=8 * K, progressive_full_pool_trials=2048)
    jransac.ransac(jax.random.PRNGKey(2), n, m, estimate, lambda ms: jnp.zeros((ms.shape[0], n)),
                   opts, quality_order=jnp.arange(n, dtype=jnp.int32))
    assert len(draws) == 8
    pools = [int(tr.progressive_pool(np.array([t]), np.array([n]), m, 2048)[0])
             for t in range(0, 8 * K, K)]
    assert pools[0] == m and pools[-1] == n
    assert [int(d.max()) + 1 for d in draws] == pools
    assert tr.progressive_pool(np.array([0, 5000]), np.array([2, 1]), 7, 2048).tolist() == [2, 1]


def _line(seed=0, n=200, inliers=0.5):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, n)
    y = 0.7 * x - 0.3 + rng.normal(0, 0.01, n)
    y[int(n * inliers):] = rng.uniform(-3, 3, n - int(n * inliers))
    pts = _T(np.stack([x, y], 1))

    def propose(idxs, msac=False):
        p = pts[idxs.long()]
        slope = (p[:, 1, 1] - p[:, 0, 1]) / (p[:, 1, 0] - p[:, 0, 0])
        models = torch.stack([slope, p[:, 0, 1] - slope * p[:, 0, 0]], 1)
        res = (models[:, :1] * pts[None, :, 0] + models[:, 1:] - pts[None, :, 1]) ** 2
        counts, scores = tr.score_models(models, res, torch.ones(n, dtype=torch.bool), 0.05**2,
                                         msac)
        best = tr.pack_best_scores(scores) if msac else tr.pack_best(counts)
        return (models, counts, best, scores) if msac else (models, counts, best)

    def inliers(model):
        return (model[0] * pts[:, 0] + model[1] - pts[:, 1]) ** 2 <= 0.05**2

    return n, propose, inliers


def test_progressive_without_a_quality_order_samples_uniformly():
    """sampling="progressive" without a quality order is the uniform
    sampler, as in colmap_tpu (it raised here before): the same draws, so
    the same model and trial count; with an order it draws from the top
    rows first and still finds the line."""
    n, propose, inliers = _line()
    base = dict(max_error=0.05, batch_size=32)
    out = {}
    for sampling in ("uniform", "progressive"):
        out[sampling] = tr.ransac(torch.Generator().manual_seed(3), torch.ones(n, dtype=torch.bool),
                                  2, propose, inliers, tr.RansacOptions(sampling=sampling, **base))
    assert torch.equal(out["uniform"].model, out["progressive"].model)
    assert out["uniform"].num_trials == out["progressive"].num_trials
    prog = tr.ransac(torch.Generator().manual_seed(3), torch.ones(n, dtype=torch.bool), 2,
                     propose, inliers, tr.RansacOptions(sampling="progressive", **base),
                     quality_order=torch.arange(n))
    assert prog.success and prog.num_inliers >= 0.9 * 100
    np.testing.assert_allclose(prog.model.numpy(), [0.7, -0.3], atol=0.05)


def test_msac_line_ransac_as_the_reference_test():
    """tests/test_samplers_sprt.py's support modes on the port's harness:
    both find the line with >= 90% of its 100 inliers and slope within 0.05."""
    n, propose, inliers = _line()
    for support in ("inlier_count", "m_estimator"):
        msac = support == "m_estimator"
        res = tr.ransac(torch.Generator().manual_seed(0), torch.ones(n, dtype=torch.bool), 2,
                        lambda i: propose(i, msac), inliers,
                        tr.RansacOptions(max_error=0.05, support=support, batch_size=32))
        assert res.success and res.num_inliers >= 90
        np.testing.assert_allclose(res.model.numpy(), [0.7, -0.3], atol=0.05)
    with pytest.raises(ValueError, match="support"):
        tr.ransac(torch.Generator(), torch.ones(n, dtype=torch.bool), 2, propose, inliers,
                  tr.RansacOptions(support="ransac"))


def _clean_pair(seed, n=160, plane_share=0.0, f=700.0):
    """Noise-free pixel matches of two PINHOLE views (800 x 600); the first
    ``plane_share`` of the points lie on a plane."""
    rng = np.random.default_rng(seed)
    X = rng.uniform(-3, 3, (n, 3))
    X[:, 2] = rng.uniform(5, 10, n)
    k = int(n * plane_share)
    X[:k, 2] = 7.0 + 0.2 * X[:k, 0] - 0.1 * X[:k, 1]
    a = 0.15
    q = np.array([np.cos(a / 2), 0.0, np.sin(a / 2), 0.0])
    pose = ttypes.Pose(q, np.array([1.0, 0.1, 0.05]))
    c = np.array([400.0, 300.0])
    x1 = X[:, :2] / X[:, 2:] * f + c
    Xc = pose.apply(X)
    x2 = Xc[:, :2] / Xc[:, 2:] * f + c
    return x1, x2


def test_msac_two_view_ransac_gives_the_reference_inliers():
    """_ransac_h with support="m_estimator" on a clean planar pair: the
    port's inlier set equals colmap_tpu's (every match). (F and E in MSAC
    mode: test_block_verifier_with_msac_equals_per_pair and the card.)"""
    opts = dict(max_error=4.0, confidence=0.999, min_num_trials=32, max_num_trials=256,
                batch_size=32, support="m_estimator", lo_outer_rounds=2)
    for kind, share in (("H", 1.0),):
        x1, x2 = _clean_pair(5, plane_share=share)
        n = len(x1)
        fn = {"H": (ttvg._ransac_h, jtvg._ransac_h), "F": (ttvg._ransac_f, jtvg._ransac_f)}[kind]
        got = fn[0](torch.Generator().manual_seed(1), _T(x1), _T(x2),
                    torch.ones(n, dtype=torch.bool), tr.RansacOptions(**opts))
        want = fn[1](jax.random.PRNGKey(1), jnp.asarray(x1), jnp.asarray(x2),
                     jnp.ones(n, dtype=bool), jransac.RansacOptions(**opts))
        assert np.array_equal(got.inlier_mask.numpy(), np.asarray(want.inlier_mask))
        assert got.num_inliers == n and got.success


# ---------------------------------------------------------------------------
# DEGENSAC.
# ---------------------------------------------------------------------------


def _degenerate_case():
    """colmap_tpu's test_degensac scene in pixels: 240 matches on a plane,
    60 off it (the F RANSAC's clean pairs of kernels/matching_cases.py), an
    H fitted on the plane and an F that explains the plane only."""
    from colmap_tpu_torch.kernels import matching_cases as C

    c = C.two_view_case("H", 300, 2, 2, "cpu", outliers=0.0, valid=300)
    g = C.two_view_case("F", 300, 2, 2, "cpu", outliers=0.0, valid=300)
    x1 = torch.cat([c["x1"].double()[:240], g["x1"].double()[:60]])
    x2 = torch.cat([c["x2"].double()[:240], g["x2"].double()[:60]])
    H = tepi.homography_dlt(x1[:240], x2[:240])
    F_bad = tess.cross_product_matrix(_T([0.3, 0.2, 1.0])) @ H
    return x1, x2, H, F_bad


def test_fundamental_from_plane_and_parallax_equals_the_reference():
    x1, x2, H, _ = _degenerate_case()
    a, b = torch.arange(240, 300, 2), torch.arange(241, 300, 2)
    got = tepi.fundamental_from_plane_and_parallax(H[None], x1[a], x2[a], x1[b], x2[b])
    want = jdeg.fundamental_from_plane_and_parallax(
        jnp.asarray(H.numpy())[None], *(jnp.asarray(v[i].numpy())
                                        for i in (a, b) for v in (x1, x2)))
    assert np.abs(got.numpy() - np.asarray(want)).max() <= 1e-12
    assert tdeg.fundamental_from_plane_and_parallax is tepi.fundamental_from_plane_and_parallax


def test_degensac_recover_f_on_the_reference_draws():
    """degensac_recover_f on colmap_tpu's own draws (its key, split and
    randint, injected as positions into the off-plane pool): the same best
    hypothesis support (K46's plain version), the same recovered flag,
    count and inlier set, F within 1e-9 after normalization."""
    x1, x2, H, F_bad = _degenerate_case()
    n = len(x1)
    mask = torch.ones(n, dtype=torch.bool)
    mask[[5, 250]] = False  # invalid rows stay out of the pool and the supports
    max_sq = 16.0
    h_inl = (tepi.homography_transfer_error(H, x1, x2) <= max_sq) & mask
    f_inl = (tess.squared_epipolar_line_distance(F_bad, x1, x2) <= max_sq) & mask
    opts = tr.RansacOptions(max_error=4.0)
    key = jax.random.PRNGKey(7)
    k1, k2 = jax.random.split(key)
    n_off = int((mask & ~h_inl).sum())
    pos = torch.stack([_T(np.asarray(jax.random.randint(k, (256,), 0, max(n_off, 1))),
                          torch.int64) for k in (k1, k2)])
    F, num, inl, recovered = tdeg.degensac_recover_f(
        None, x1, x2, mask, F_bad, f_inl, H, h_inl, opts, positions=pos)
    jF, jnum, jinl, jrec = jdeg.degensac_recover_f(
        key, *(jnp.asarray(v.numpy()) for v in (x1, x2, mask, F_bad, f_inl, H, h_inl)),
        jransac.RansacOptions(max_error=4.0))
    assert recovered == bool(jrec) and recovered
    assert num == int(jnum) and np.array_equal(inl.numpy(), np.asarray(jinl))
    got, want = F.numpy() / np.linalg.norm(F.numpy()), np.asarray(jF) / np.linalg.norm(jF)
    np.testing.assert_allclose(got * np.sign((got * want).sum()), want, atol=1e-9)
    # K46's plain version: the best support of the injected hypotheses.
    rows, _ = tdeg.off_plane_pool(mask, h_inl)
    pair = rows[pos].to(torch.int32)
    _, counts, best = KM.degensac_propose_score_plain(x1, x2, mask, H, pair[0], pair[1], max_sq)
    assert int(best) >> 32 == int(counts.max()) > 0 and int(counts[pair[0] == pair[1]].sum()) == 0


def test_estimate_two_view_geometry_with_degensac_as_the_reference():
    """use_degensac on a planted plane + parallax pair (an uncalibrated
    pair, 85% of the matches on a plane: H-degenerate, so both packages run
    DEGENSAC on it): the same configuration as colmap_tpu's and F within 1e-6
    after normalization; the block verifier, which sends the pair to the
    per-pair path, gives the per-pair result."""
    x1, x2 = _clean_pair(8, n=200, plane_share=0.85)
    n = len(x1)
    matches = np.stack([np.arange(n)] * 2, 1).astype(np.uint32)
    jo = jtvg.TwoViewGeometryOptions(use_degensac=True, estimate_focals=False,
                                     detect_watermark=False)
    to = convert.convert_options(jo)
    tcam = ttypes.Camera.create(1, 1, 700.0, 800, 600)
    jcam = jtypes.Camera.create(1, 1, 700.0, 800, 600)
    g = ttvg.estimate_two_view_geometry(tcam, x1, tcam, x2, matches, to, device="cpu")
    gj = jtvg.estimate_two_view_geometry(jcam, x1, jcam, x2, matches, jo)
    assert g.config == gj.config and g.F is not None
    got, want = g.F / np.linalg.norm(g.F), gj.F / np.linalg.norm(gj.F)
    np.testing.assert_allclose(got * np.sign((got * want).sum()), want, atol=1e-6)
    gb = tbatch.estimate_two_view_geometries_batched([(tcam, x1, tcam, x2, matches)], to,
                                                     device="cpu")[0]
    assert gb.config == g.config and np.array_equal(gb.inlier_matches, g.inlier_matches)


def test_block_verifier_with_msac_equals_per_pair():
    """support="m_estimator" through the block verifier: each pair's
    configuration, inliers and models equal estimate_two_view_geometry on
    it alone (models to 1e-9, the block's padded sums)."""
    items = []
    for seed in (2, 3):
        x1, x2 = _clean_pair(seed, n=120 + 20 * seed)
        cam = ttypes.Camera.create(1, 1, 700.0, 800, 600)
        cam.has_prior_focal_length = seed == 2
        items.append((cam, x1, cam, x2, np.stack([np.arange(len(x1))] * 2, 1).astype(np.uint32)))
    opts = ttvg.TwoViewGeometryOptions(estimate_focals=False)
    opts.ransac = dataclasses.replace(opts.ransac, support="m_estimator", max_num_trials=512)
    block = tbatch.estimate_two_view_geometries_batched(items, opts, device="cpu")
    for item, gb in zip(items, block):
        g = ttvg.estimate_two_view_geometry(*item, opts, device="cpu")
        assert gb.config == g.config and np.array_equal(gb.inlier_matches, g.inlier_matches)
        assert len(g.inlier_matches) == len(item[4])
        for a, b in ((g.F, gb.F), (g.E, gb.E)):  # up to sign, as projective entities
            if a is not None:
                np.testing.assert_allclose(a * np.sign((a * b).sum()), b, atol=1e-9)


# ---------------------------------------------------------------------------
# Affine-covariant SIFT.
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def affine_octave():
    """A 60 x 80 image of smoothed, stretched noise and its octave 0 in
    float64 from the port's plain versions (equal to colmap_tpu's to 1e-10,
    tests/test_torch_sift.py), the input of both packages' shape, orientation
    and descriptor functions (colmap_tpu samples affine frames exactly)."""
    from scipy.ndimage import gaussian_filter

    img = gaussian_filter(np.random.default_rng(4).uniform(0, 1, (60, 80)), (1.0, 2.5))
    img = (img - img.min()) / (img.max() - img.min())
    opts = convert.convert_options(J.SiftOptions())
    gauss, dog = KS.build_octave_plain(KS.blur_plain(KS.upsample2_plain(_T(img)), 1.6), opts)
    return img, gauss.numpy(), dog.numpy()


def test_affine_shapes_equal_the_reference_frames(affine_octave):
    """affine_shapes_plain against colmap_tpu's affine_shape, read from its
    frames sigma A R(theta) (A = frames R(theta)^T / sigma) on the same
    keypoints: within 1e-9; the shapes have determinant 1 and are not all
    the identity; the orientations and descriptors on them match (ok rows
    equal, theta and descriptors to 1e-9)."""
    _, gauss, dog = affine_octave
    jo = J.SiftOptions(estimate_affine_shape=True)
    opts = convert.convert_options(jo)
    g = _T(gauss)
    ext = KS.detect_extrema_plain(_T(dog), opts)
    sel = KS.select_candidates(ext, opts.max_candidates_per_octave)
    x, y, lvl, sigma, resp = KS.selected_keypoints(ext, sel)
    describe = jax.jit(J._orientations_and_descriptors, static_argnames=("options",))
    out = describe(
        jnp.asarray(gauss), jnp.asarray(x.numpy()), jnp.asarray(y.numpy()),
        jnp.asarray(lvl.numpy()), jnp.asarray(sigma.numpy()), jnp.ones(len(sel), bool),
        options=jo)
    _, _, sig_j, th_j, frames_j, desc_j, ok_j = (np.asarray(a) for a in out)
    shapes = KS.affine_shapes(g, x, y, lvl, sigma, opts)
    c, s = np.cos(th_j), np.sin(th_j)
    rot_t = np.stack([np.stack([c, s], -1), np.stack([-s, c], -1)], -2)
    A_j = np.einsum("kij,kjl->kil", frames_j, rot_t) / sig_j[:, None, None]
    n_ori = opts.max_num_orientations
    A = np.repeat(shapes.numpy(), n_ori, axis=0)
    assert np.abs(A[ok_j] - A_j[ok_j]).max() <= 1e-9
    det = np.linalg.det(shapes.numpy())
    assert np.abs(det - 1).max() <= 1e-9 and np.abs(shapes.numpy() - np.eye(2)).max() > 0.1
    theta, ok = KS.orientations(g, x, y, lvl, sigma, opts, shapes)
    data, desc = KS.descriptors(g, x, y, lvl, sigma, resp, theta, ok, opts, shapes)
    okf = ok.reshape(-1).numpy()
    assert np.array_equal(okf, ok_j) and okf.sum() > 10
    assert np.abs(theta.reshape(-1).numpy()[okf] - th_j[okf]).max() <= 1e-9
    assert np.abs(data[:, 5:].numpy()[okf] - frames_j.reshape(-1, 4)[okf]).max() <= 1e-9
    _, fdesc, _ = KS.descriptors_plain(g, x, y, lvl, sigma, resp, theta, opts, shapes)
    assert np.abs(fdesc.numpy()[okf] - desc_j[okf]).max() <= 1e-9


def test_extract_sift_with_affine_shapes_equals_the_reference(affine_octave):
    """extract_sift with estimate_affine_shape in float32 against
    colmap_tpu's: (N, 6) frames, the same count, every row within 1e-3 px
    of its counterpart's position and 1e-3 of its frame's scale (the five
    Baumberg iterations carry float32 sums in another order), and
    descriptors within 1 count."""
    img = affine_octave[0].astype(np.float32)
    jo = J.SiftOptions(estimate_affine_shape=True, max_num_features=300)
    kj, dj = J.extract_sift(img, jo)
    kt, dt = T.extract_sift(img, convert.convert_options(jo), device="cpu")
    assert kt.shape[1] == 6 and kt.dtype == np.float32 and len(kt) == len(kj) > 20
    kj = np.asarray(kj)
    scale = np.maximum(np.abs(kj[:, 2:]).max(1), 1.0)
    d = np.maximum(np.abs(kt[:, None, :2] - kj[None, :, :2]).max(-1),
                   np.abs(kt[:, None, 2:] - kj[None, :, 2:]).max(-1) / scale[None])
    j = d.argmin(1)  # several rows share a position: match on the frame too
    assert d[np.arange(len(kt)), j].max() <= 1e-3 and len(set(j.tolist())) == len(kt)
    assert np.abs(dt.astype(int) - np.asarray(dj)[j].astype(int)).max() <= 1


# ---------------------------------------------------------------------------
# The wrappers on other devices.
# ---------------------------------------------------------------------------


def test_option_wrappers_never_fall_back_off_the_cpu():
    """A tensor that is neither on the CPU nor on a CUDA device gets no plain
    version: K45, K46, K47 and the MSAC entries of K7, K11, K12, K32 and K33
    raise."""
    meta = dict(device="meta")
    x, r = torch.zeros(8, 2, **meta), torch.zeros(8, 3, **meta)
    mask = torch.zeros(8, dtype=torch.bool, **meta)
    model = torch.zeros(3, 3, **meta)
    idx = torch.zeros(4, dtype=torch.int32, **meta)
    g = torch.zeros(3, 8, 8, **meta)
    kp = torch.zeros(4, **meta)
    calls = [
        lambda: KS.affine_shapes(g, kp, kp, idx, kp, T.SiftOptions()),
        lambda: KS.orientations(g, kp, kp, idx, kp, T.SiftOptions(), torch.zeros(4, 2, 2, **meta)),
        lambda: KM.degensac_propose_score(x, x, mask, model, idx, idx, 1.0),
        lambda: KP.sprt(torch.zeros(2, 8, **meta), mask, 1.0, 1.0, -1.0, 0.1),
    ]
    for m, propose, refit, pts in ((5, K.essential_propose_score, K.essential_refit, x),
                                   (7, KM.fundamental_propose_score, KM.fundamental_refit, x),
                                   (4, KM.homography_propose_score, KM.homography_refit, x),
                                   (5, KQ.spherical_e_propose_score, KQ.spherical_e_refit, r),
                                   (4, KQ.spherical_h_propose_score, KQ.spherical_h_refit, r)):
        s = torch.zeros(4, m, dtype=torch.int32, **meta)
        calls.append(lambda p=propose, s=s, q=pts: p(q, q, mask, s, 1.0, msac=True))
        calls.append(lambda f=refit, q=pts: f(q, q, mask, model, 1.0, 0, 0.5))
    for call in calls:
        with pytest.raises(ValueError, match="no kernel for device"):
            call()
