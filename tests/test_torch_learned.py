"""colmap_tpu_torch's learned features (ALIKED, LightGlue) against colmap_tpu, on the CPU.

The same inputs, made from a numpy seed, go through colmap_tpu (JAX on the
CPU in x64, as tests/conftest.py sets it) and the port's plain versions
(the wrappers of K50-K53 on CPU tensors), with colmap_tpu's parameters
carried across by ``convert.aliked_params_from_numpy`` and
``convert.lightglue_params_from_numpy`` (the two packages draw their random
weights from different generators). ALIKED runs at 64 x 80 and at the odd
size 61 x 83 (pooling floors, upsampling edges): the backbone's feature and
score maps within 1e-4 of their largest entry, DKD on colmap_tpu's score
map in exactly lax.top_k's order (ties included), SDDH within 1e-4, and the
sparse SDDH offsets (K52's algorithm) equal to the dense ones. End to end
the two extractions agree keypoint for keypoint, the order free only among
scores within ``TIE`` of each other (the score maps differ by ~1e-6).
LightGlue runs with 2 layers on sets of 48-64: colmap_tpu's x64 run
computes its rotary encoding (and all that follows) in float64, so the
port's plain version runs in float64 for the scores (within 1e-6) and
gives the same match lists in float64 and float32. Both weight importers
read one checkpoint written here with torch.save under the official names.
The pipelines (extraction with ``extractor_type="aliked"``, matching with
``matcher_type="lightglue"``) write the same database contents as
colmap_tpu's, and the port's ALIKED networks are keyed by weights path
where colmap_tpu keeps its first call's (ROADMAP §3).
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from colmap_tpu.controllers import feature_pipeline as jpipe
from colmap_tpu.feature import aliked as JA
from colmap_tpu.feature import lightglue as JL
from colmap_tpu.feature.sift import SiftOptions as JSiftOptions
from colmap_tpu.scene import database as jdb
from colmap_tpu_torch import convert
from colmap_tpu_torch.controllers import feature_pipeline as tpipe
from colmap_tpu_torch.feature import aliked as TA
from colmap_tpu_torch.feature import lightglue as TL
from colmap_tpu_torch.feature.sift import SiftOptions as TSiftOptions
from colmap_tpu_torch.kernels import aliked as KA
from colmap_tpu_torch.kernels import lightglue as KLG
from colmap_tpu_torch.scene import database as tdb
from colmap_tpu_torch.utils import image_io

torch.set_num_threads(1)  # one intra-op thread a worker, as the other port test files

# The pipelines' ALIKED cap: above the candidates of a 64 x 80 view, so the
# end-to-end comparisons have no cut at a near-tie. DKD's cut is tested on
# colmap_tpu's own score map with K = 128.
CAP = 1024
# Scores closer than this may be ordered either way by the two packages.
TIE = 1e-5
LG = dict(num_layers=2, max_num_keypoints=64, filter_threshold=0.0)


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@functools.cache
def _aliked_params(seed):
    """(colmap_tpu's params, the port's float32 copy)."""
    jp = JA.init_params(JA.AlikedOptions(), seed=seed)
    return jp, convert.aliked_params_from_numpy(_np_tree(jp), dtype=torch.float32)


def _image(shape, seed):
    return np.random.default_rng(seed).uniform(0, 1, shape).astype(np.float32)


@functools.cache
def _stages(shape):
    """colmap_tpu's eager stages on one image: (image, feat, score, xy,
    scores, valid, desc) with K = 128."""
    jp, _ = _aliked_params(1)
    img = _image(shape, shape[1])
    opts = JA.AlikedOptions(max_num_keypoints=128)
    feat, score = JA.backbone_and_score(jp, jnp.asarray(img))
    xy, scores, valid = JA._nms_keypoints(score, opts)
    desc = JA.sddh_descriptors(jp, feat, xy, opts)
    return tuple(np.array(a) for a in (img, feat, score, xy, scores, valid, desc))


SHAPES = [(64, 80), (61, 83)]


@pytest.mark.parametrize("shape", SHAPES, ids=["64x80", "61x83"])
def test_backbone_and_score_match_colmap_tpu(shape):
    img, feat, score = _stages(shape)[:3]
    t_feat, t_score = TA.backbone_and_score(_aliked_params(1)[1], torch.from_numpy(img))
    assert t_feat.shape == feat.shape and t_score.shape == score.shape
    assert _rel(t_feat, feat) <= 1e-4
    assert _rel(t_score, score) <= 1e-4


@pytest.mark.parametrize("shape", SHAPES, ids=["64x80", "61x83"])
def test_dkd_on_colmap_tpu_score_map_keeps_top_k_order(shape):
    _, _, score, xy, scores, valid = _stages(shape)[:6]
    t_xy, t_scores = KA.dkd(torch.from_numpy(score), 128, 2, 0.2)
    n = int(valid.sum())
    assert len(t_xy) == n and np.array_equal(t_scores.numpy(), scores[:n])
    assert np.abs(t_xy.numpy() - xy[:n]).max() <= 1e-5


def test_dkd_ties_follow_top_k():
    """A saturated plateau (every pixel a peak, all 1.0), exact ties between
    separate peaks, and a cut at K inside a run of ties."""
    rng = np.random.default_rng(11)
    score = rng.uniform(0.0, 0.6, (40, 52)).astype(np.float32)
    score[5:9, 10:16] = 1.0
    score[20, 30] = score[30, 40] = score[35, 5] = 0.95
    opts = JA.AlikedOptions(max_num_keypoints=30)
    xy, scores, valid = JA._nms_keypoints(jnp.asarray(score), opts)
    t_xy, t_scores = KA.dkd(torch.from_numpy(score), 30, 2, 0.2)
    assert np.asarray(valid).all() and len(t_xy) == 30
    assert np.array_equal(t_scores.numpy(), np.asarray(scores))
    assert np.abs(t_xy.numpy() - np.asarray(xy)).max() <= 1e-5


def _select_case(case):
    """(score map, K) for K51's select: "random" colmap_tpu's own score map
    at 64 x 80 (K = 128); "plateau" a saturated 4 x 6 plateau (every pixel
    a peak, tied at 1.0) with the K-th key inside it; "ties" exact ties
    between separate peaks with the cut inside the run of ties; "band"
    peaks on a grid whose scores lie within 64 ulps of 0.75 (their keys
    share the first three bytes), cut inside a tie."""
    rng = np.random.default_rng(11)
    if case == "random":
        return _stages((64, 80))[2], 128
    score = rng.uniform(0.0, 0.6, (40, 52)).astype(np.float32)
    if case == "plateau":
        score[5:9, 10:16] = 1.0
        return score, 17
    if case == "ties":
        score[20, 30] = score[30, 40] = score[35, 5] = score[2, 2] = 0.95
        return score, 2
    score[:] = 0.1
    ulp = np.spacing(np.float32(0.75))
    steps = rng.integers(0, 64, (10, 13))
    steps[4, 6] = steps[4, 7] = steps[5, 0] = steps[7, 9] = 63
    score[::4, ::4] = np.float32(0.75) + steps.astype(np.float32) * ulp
    return score, 2


@pytest.mark.parametrize("case", ["random", "plateau", "ties", "band"])
def test_radix_select_model_matches_top_k(case):
    """K51's MSB-first radix select (radix_select_model on dkd_keys) against
    jax.lax.top_k on _nms_keypoints' candidates (the same peak test, l.146-
    152): the keys <= the threshold, ascending, are top_k's first
    min(K, candidates) indices in order; with ties at the cut the select
    runs through the index bytes."""
    score, k = _select_case(case)
    H, W = score.shape
    pooled = jax.lax.reduce_window(jnp.asarray(score), -jnp.inf, jax.lax.max, (5, 5), (1, 1),
                                   "SAME")
    is_peak = np.asarray((jnp.asarray(score) >= pooled) & (jnp.asarray(score) > 0.2)).reshape(-1)
    flat = jnp.where(is_peak, jnp.asarray(score).reshape(-1), -jnp.inf)
    vals, idxs = jax.lax.top_k(flat, k)
    cand = np.nonzero(is_peak)[0]
    keys = KA.dkd_keys(score.reshape(-1)[cand], cand)
    thresh, passes = KA.radix_select_model(keys, k)
    kept = np.sort(keys[keys <= thresh])
    n = min(k, len(cand))
    assert len(kept) == n and len(cand) > k
    assert np.array_equal((kept & np.uint64(0xFFFFFFFF)).astype(np.int64), np.asarray(idxs)[:n])
    assert np.array_equal(score.reshape(-1)[kept & np.uint64(0xFFFFFFFF)], np.asarray(vals)[:n])
    if case != "random":
        assert passes >= 7  # the cut lies inside a run of equal scores
    assert KA.radix_select_model(keys, len(cand))[0] == np.uint64(2 ** 64 - 1)


@pytest.mark.parametrize("shape", SHAPES, ids=["64x80", "61x83"])
def test_sddh_matches_colmap_tpu(shape):
    _, feat, _, xy, _, valid, desc = _stages(shape)
    t_desc = KA.sddh(torch.from_numpy(feat), torch.from_numpy(xy), _aliked_params(1)[1])
    assert _rel(t_desc[valid], desc[valid]) <= 1e-4


def test_sparse_sddh_offsets_equal_dense():
    """K52 (a)'s algorithm (6 x 6 patches, both zero paddings) against the
    dense convolutions, at interior, edge and corner keypoints."""
    g = torch.Generator().manual_seed(2)
    C, H, W, M = 128, 23, 29, 16
    feat = torch.nn.functional.selu(torch.randn((C, H, W), generator=g, dtype=torch.float64))
    xy = torch.rand((40, 2), generator=g, dtype=torch.float64) * torch.tensor([W - 1.0, H - 1.0],
                                                                             dtype=torch.float64)
    xy[:6] = torch.tensor([[0.0, 0.0], [W - 1.0, H - 1.0], [0.4, H - 1.0], [W - 1.0, 0.6],
                           [1.5, 2.5], [W - 1.0005, 1.0]], dtype=torch.float64)
    w1 = torch.randn((C, C, 3, 3), generator=g, dtype=torch.float64) * 0.04
    w2 = torch.randn((2 * M, C, 3, 3), generator=g, dtype=torch.float64) * 0.04
    b1 = torch.randn(C, generator=g, dtype=torch.float64) * 0.1
    b2 = torch.randn(2 * M, generator=g, dtype=torch.float64) * 0.1
    dense = KA.sddh_offsets_plain(feat, xy, w1, b1, w2, b2)
    sparse = KA.sddh_offsets_sparse(feat, xy, w1, b1, w2, b2)
    assert float((dense - sparse).abs().max()) <= 1e-12 * float(dense.abs().max())
    assert float(dense.abs().max()) <= KA.BOUND


def _kp_runs(scores):
    """Runs of consecutive (sorted) scores closer than TIE."""
    runs, start = [], 0
    for i in range(1, len(scores) + 1):
        if i == len(scores) or abs(scores[i - 1] - scores[i]) > TIE:
            runs.append((start, i))
            start = i
    return runs


def _assert_same_keypoints(xy_j, scores_j, desc_j, xy_t, desc_t, px=1e-3):
    """The same keypoints in the same order, up to order within runs of
    near-tied scores; descriptors within 1e-4."""
    assert len(xy_j) == len(xy_t)
    for a, b in _kp_runs(np.asarray(scores_j)):
        for i in range(a, b):
            d = np.abs(xy_t[a:b] - xy_j[i]).max(axis=1)
            k = a + int(d.argmin())
            assert d.min() <= px, f"keypoint {i} of colmap_tpu has no counterpart"
            assert np.abs(desc_t[k] - desc_j[i]).max() <= 1e-4


def test_extract_aliked_matches_colmap_tpu():
    jp, tp = _aliked_params(0)
    img = (_image((64, 80), 5) * 255).astype(np.uint8)
    opts = JA.AlikedOptions(max_num_keypoints=CAP)
    xy, scores, desc, valid = JA.aliked_forward(jp, jnp.asarray(img.astype(np.float32) / 255.0),
                                                opts)
    v = np.asarray(valid)
    kp_j, desc_j = JA.extract_aliked(img, jp, opts)
    assert 20 < len(kp_j) < CAP
    kp_t, desc_t = TA.extract_aliked(img, tp, TA.AlikedOptions(max_num_keypoints=CAP), device="cpu")
    assert kp_t.dtype == np.float32 and desc_t.dtype == np.float32 and kp_t.shape[1] == 4
    assert np.array_equal(kp_t[:, 2:], kp_j[:, 2:])
    _assert_same_keypoints(kp_j[:, :2], np.asarray(scores)[v], desc_j, kp_t[:, :2], desc_t)
    np.testing.assert_allclose(np.linalg.norm(desc_t, axis=1), 1.0, atol=1e-5)


def _lg_params(seed, options):
    jp = JL.init_params(options, seed=seed)
    return jp, _np_tree(jp)


def _sets(n1, n2, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n1, 128)).astype(np.float32),
            rng.uniform(0, 512, (n1, 2)).astype(np.float32),
            rng.normal(size=(n2, 128)).astype(np.float32),
            rng.uniform(0, 400, (n2, 2)).astype(np.float32))


def test_lightglue_forward_scores_match_colmap_tpu():
    opts = JL.LightGlueOptions(**LG)
    jp, npp = _lg_params(4, opts)
    d1, k1, d2, k2 = _sets(48, 57, 3)
    cap = LG["max_num_keypoints"]

    def prep(d, k):
        D, K, M = np.zeros((cap, 128), np.float32), np.zeros((cap, 2), np.float32), np.zeros(cap, bool)
        D[:len(d)] = d / np.linalg.norm(d, axis=1, keepdims=True)
        K[:len(d)] = (k - np.array([256.0, 200.0])) / 256.0
        M[:len(d)] = True
        return D, K, M

    (D1, K1, M1), (D2, K2, M2) = prep(d1, k1), prep(d2, k2)
    scores, m1, m2 = JL.lightglue_forward(jp, D1, K1, M1, D2, K2, M2, opts)
    scores = np.asarray(scores)
    model = TL.LightGlue(convert.lightglue_params_from_numpy(npp, dtype=torch.float64),
                         TL.LightGlueOptions(**LG))
    f = lambda a: torch.from_numpy(a).double()  # noqa: E731
    # At the true sizes, and padded to the cap with masks as colmap_tpu runs.
    t, tm1, _ = TL.lightglue_forward(model, f(D1[:48]), f(K1[:48]), torch.ones(48, dtype=bool),
                                     f(D2[:57]), f(K2[:57]), torch.ones(57, dtype=bool))
    valid = scores[:48, :57]
    assert np.abs(t.numpy() - valid).max() <= 1e-6 * np.abs(valid).max()
    assert np.abs(tm1.numpy() - np.asarray(m1)[:48]).max() <= 1e-6
    tp, _, _ = TL.lightglue_forward(model, f(D1), f(K1), torch.from_numpy(M1), f(D2), f(K2),
                                    torch.from_numpy(M2))
    assert np.abs(tp.numpy()[:48, :57] - valid).max() <= 1e-6 * np.abs(valid).max()
    assert np.abs(tp.numpy() - scores).max() <= 1e-6 * np.abs(scores).max()


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["float64", "float32"])
def test_match_lightglue_matches_colmap_tpu(dtype):
    opts = JL.LightGlueOptions(**LG)
    jp, npp = _lg_params(4, opts)
    d1, k1, d2, k2 = _sets(48, 57, 3)
    d2[:30], k2[:30] = d1[10:40], k1[10:40] * 0.78  # shared features
    jm = JL.match_lightglue(d1, k1, d2, k2, (400, 512), (400, 512), jp, opts)
    model = TL.LightGlue(convert.lightglue_params_from_numpy(npp, dtype=dtype),
                         TL.LightGlueOptions(**LG))
    tm = TL.match_lightglue(d1, k1, d2, k2, (400, 512), (400, 512), model,
                            TL.LightGlueOptions(**LG), device="cpu")
    assert tm.dtype == np.uint32 and len(jm) > 10
    assert np.array_equal(tm, jm)


def test_lightglue_identical_and_permuted_sets():
    """colmap_tpu's properties (tests/test_learned_features.py:70-105) on the
    port, each equal to colmap_tpu's own result."""
    rng = np.random.default_rng(3)
    desc = rng.normal(size=(64, 128)).astype(np.float32)
    kpts = rng.uniform(0, 512, size=(64, 2)).astype(np.float32)
    opts = dict(num_layers=2, max_num_keypoints=128, filter_threshold=0.0)
    jp, npp = _lg_params(4, JL.LightGlueOptions(**opts))
    tp = convert.lightglue_params_from_numpy(npp, dtype=torch.float32)
    m = TL.match_lightglue(desc, kpts, desc, kpts, (512, 512), (512, 512), tp,
                           TL.LightGlueOptions(**opts), device="cpu")
    assert len(m) > 0.8 * 64 and (m[:, 0] == m[:, 1]).mean() > 0.9
    assert np.array_equal(m, JL.match_lightglue(desc, kpts, desc, kpts, (512, 512), (512, 512),
                                                jp, JL.LightGlueOptions(**opts)))
    rng = np.random.default_rng(5)
    desc = rng.normal(size=(48, 128)).astype(np.float32)
    kpts = rng.uniform(0, 256, size=(48, 2)).astype(np.float32)
    perm = rng.permutation(48)
    jp, npp = _lg_params(6, JL.LightGlueOptions(**LG))
    tp = convert.lightglue_params_from_numpy(npp, dtype=torch.float32)
    m = TL.match_lightglue(desc, kpts, desc[perm], kpts[perm], (256, 256), (256, 256), tp,
                           TL.LightGlueOptions(**LG), device="cpu")
    assert len(m) > 0.7 * 48 and (perm[m[:, 1]] == m[:, 0]).mean() > 0.9
    assert np.array_equal(m, JL.match_lightglue(desc, kpts, desc[perm], kpts[perm], (256, 256),
                                                (256, 256), jp, JL.LightGlueOptions(**LG)))


# K53 (a)'s arithmetic (attention_split_model: 3xTF32 operands, the
# splits' partials and their log-sum-exp merge) against colmap_tpu's
# _attention, with _apply_rotary for self-attention, in float64: (nq, nk,
# the rotation, splits, the key mask, masked queries). 150 keys are 3 tiles
# of 64, so 4 splits leave one empty.
ATTENTION_CASES = {
    "self_rotary_150": (150, 150, True, 2, "random", False),
    "cross_77x150": (77, 150, False, 2, "random", False),
    "all_keys_masked_s3": (77, 150, False, 3, "none", False),
    "masked_query": (150, 150, True, 3, "random", True),
    "s1": (150, 150, True, 1, "random", False),
    "s4": (77, 150, False, 4, "random", True),
}


@pytest.mark.parametrize("case", list(ATTENTION_CASES))
def test_attention_split_model_matches_colmap_tpu(case):
    """Within 1e-5 of the float64 output's largest entry; masked queries
    give 0; with every key masked each row averages all of v."""
    nq, nk, rotary, splits, keys, masked_q = ATTENTION_CASES[case]
    rng = np.random.default_rng(nq + nk + splits)
    q, k, v = (rng.normal(size=(n, 256)) for n in (nq, nk, nk))
    mask_q = np.ones(nq, bool)
    if masked_q:
        mask_q[rng.choice(nq, 20, replace=False)] = False
    mask_k = rng.random(nk) > 0.3 if keys == "random" else np.zeros(nk, bool)
    jq, jk, jv = (JL._heads(jnp.asarray(x), 4) for x in (q, k, v))
    cos = sin = None
    if rotary:
        jcos, jsin = JL._rotary_encode(jnp.asarray(rng.uniform(-1, 1, (nq, 2))), 256, 4)
        jq, jk = JL._apply_rotary(jq, jcos, jsin), JL._apply_rotary(jk, jcos, jsin)
        cos, sin = torch.from_numpy(np.array(jcos)), torch.from_numpy(np.array(jsin))
    ref = np.asarray(JL._unheads(JL._attention(jq, jk, jv, jnp.asarray(mask_q),
                                               jnp.asarray(mask_k))))
    f32 = lambda a: torch.from_numpy(a).float()  # noqa: E731
    got = KLG.attention_split_model(f32(q), f32(k), f32(v), torch.from_numpy(mask_q),
                                    torch.from_numpy(mask_k), 4, cos, sin, splits).numpy()
    assert got.dtype == np.float32 and got.shape == (nq, 256)
    assert _rel(got, ref) <= 1e-5
    assert not got[~mask_q].any()
    if keys == "none":
        assert _rel(got[mask_q], np.broadcast_to(v.mean(0), (int(mask_q.sum()), 256))) <= 1e-5
    if splits > 3:
        assert (0, 0) in KLG.split_ranges(nk, splits)  # an empty split takes part


def test_match_lightglue_raises_over_the_cap_as_colmap_tpu():
    opts = JL.LightGlueOptions(**LG)
    jp, npp = _lg_params(4, opts)
    d1, k1, d2, k2 = _sets(65, 20, 8)
    with pytest.raises(ValueError):
        JL.match_lightglue(d1, k1, d2, k2, (400, 512), (400, 512), jp, opts)
    with pytest.raises(ValueError, match="max_num_keypoints"):
        TL.match_lightglue(d1, k1, d2, k2, (400, 512), (400, 512),
                           convert.lightglue_params_from_numpy(npp), TL.LightGlueOptions(**LG),
                           device="cpu")
    # At the cap itself both run.
    assert len(TL.match_lightglue(d1[:64], k1[:64], d2, k2, (400, 512), (400, 512),
                                  convert.lightglue_params_from_numpy(npp),
                                  TL.LightGlueOptions(**LG), device="cpu")) >= 0


def test_learned_entry_points_default_to_cuda_and_wrappers_never_fall_back():
    img = np.zeros((16, 16), np.uint8)
    d = np.ones((3, 128), np.float32)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            TA.extract_aliked(img)
        with pytest.raises(RuntimeError, match="CUDA"):
            TL.match_lightglue(d, d[:, :2], d, d[:, :2], (16, 16), (16, 16))
    meta = dict(device="meta")
    x = torch.zeros((4, 8, 8), **meta)
    with pytest.raises(ValueError, match="no kernel for device"):
        KA.conv(x, torch.zeros((4, 4, 3, 3), **meta), torch.zeros(4, **meta))
    with pytest.raises(ValueError, match="no kernel for device"):
        KA.upsample_selu(x, torch.zeros((4, 16, 16), **meta))
    with pytest.raises(ValueError, match="no kernel for device"):
        KA.dkd(torch.zeros((8, 8), **meta), 4, 2, 0.2)
    with pytest.raises(ValueError, match="no kernel for device"):
        KA.sddh_offsets(x, torch.zeros((2, 2), **meta), *[torch.zeros(1, **meta)] * 4)
    with pytest.raises(ValueError, match="no kernel for device"):
        KA.sddh_describe(x, *[torch.zeros(1, **meta)] * 5)
    q = torch.zeros((5, 256), **meta)
    m = torch.ones(5, dtype=torch.bool, **meta)
    with pytest.raises(ValueError, match="no kernel for device"):
        KLG.attention(q, q, q, m, m, 4)
    with pytest.raises(ValueError, match="no kernel for device"):
        KLG.log_assignment(torch.zeros((5, 5), **meta), m, m, m.float(), m.float(), 0.1)


def _aliked_state(tree, extra=True):
    """An official-layout ALIKED state dict from a parameter tree (numpy or
    torch leaves), with a few layers the importers do not map."""
    t = lambda a: torch.as_tensor(np.array(a, dtype=np.float32))  # noqa: E731
    state = {}
    for blk in ("block1", "block2", "block3", "block4"):
        for sub in ("conv1", "conv2"):
            state[f"{blk}.{sub}.weight"] = t(tree[blk][sub]["w"])
    for i in range(1, 5):
        state[f"conv{i}.weight"] = t(tree[f"agg{i}"]["w"])
        if i % 2:
            state[f"conv{i}.bias"] = t(tree[f"agg{i}"]["b"]) + 0.25
    if extra:
        state["score_head.0.weight"] = torch.zeros((8, 128, 3, 3))
        state["desc_head.agg_weights"] = torch.zeros((16, 128, 128))
    return state


def test_aliked_importer_matches_colmap_tpu(tmp_path):
    src = _np_tree(JA.init_params(JA.AlikedOptions(), seed=7))
    path = str(tmp_path / "aliked.pth")
    torch.save(_aliked_state(src), path)
    jl = _np_tree(JA.load_torch_weights(path, JA.AlikedOptions()))
    tl = TA.load_torch_weights(path, TA.AlikedOptions())
    tinit = TA.init_params(TA.AlikedOptions())
    for blk in ("block1", "block2", "block3", "block4"):
        for sub in ("conv1", "conv2"):
            assert np.array_equal(tl[blk][sub]["w"].numpy(), jl[blk][sub]["w"])
            assert np.array_equal(tl[blk][sub]["b"].numpy(), jl[blk][sub]["b"])  # no bias: init
    for i in range(1, 5):
        for leaf in ("w", "b"):
            assert np.array_equal(tl[f"agg{i}"][leaf].numpy(), jl[f"agg{i}"][leaf])
    assert np.array_equal(tl["agg1"]["b"].numpy(), src["agg1"]["b"] + 0.25)
    # Unmapped layers keep each package's own initialization.
    assert torch.equal(tl["smh1"]["w"], tinit["smh1"]["w"])
    assert torch.equal(tl["sddh_agg"]["w"], tinit["sddh_agg"]["w"])
    bad = _aliked_state(src)
    bad["block2.conv1.weight"] = torch.zeros((32, 16, 5, 5))
    torch.save(bad, path)
    with pytest.raises(ValueError, match="shape mismatch"):
        JA.load_torch_weights(path, JA.AlikedOptions())
    with pytest.raises(ValueError, match="shape mismatch"):
        TA.load_torch_weights(path, TA.AlikedOptions())


def test_lightglue_importer_matches_colmap_tpu(tmp_path):
    opts = JL.LightGlueOptions(**LG)
    src = _np_tree(JL.init_params(opts, seed=9))
    t = lambda a: torch.as_tensor(np.array(a, dtype=np.float32))  # noqa: E731
    state = {"input_proj.weight": t(src["input_proj"]["w"]).T.contiguous(),
             "input_proj.bias": t(src["input_proj"]["b"]) + 0.5,
             "log_assignment.0.matchability.weight": torch.zeros((1, 256))}
    names = {("self", "qkv"): "self_attn.Wqkv", ("self", "out"): "self_attn.out_proj",
             ("cross", "qk"): "cross_attn.to_qk", ("cross", "v"): "cross_attn.to_v",
             ("cross", "out"): "cross_attn.to_out"}
    for i in range(opts.num_layers):
        for (blk, sub), theirs in names.items():
            if (i, sub) == (1, "v"):
                continue  # a layer the checkpoint lacks keeps its initialization
            state[f"transformers.{i}.{theirs}.weight"] = t(src["layers"][i][blk][sub]["w"]).T
            state[f"transformers.{i}.{theirs}.bias"] = t(src["layers"][i][blk][sub]["b"]) - 0.5
    path = str(tmp_path / "lightglue.pth")
    torch.save(state, path)
    jl = _np_tree(JL.load_torch_weights(path, opts))
    tl = TL.load_torch_weights(path, TL.LightGlueOptions(**LG))
    tinit = TL.init_params(TL.LightGlueOptions(**LG))
    assert np.array_equal(tl["input_proj"]["w"].numpy(), jl["input_proj"]["w"])
    assert np.array_equal(tl["input_proj"]["b"].numpy(), jl["input_proj"]["b"])
    for i in range(opts.num_layers):
        for (blk, sub) in names:
            got, ref = tl["layers"][i][blk][sub], jl["layers"][i][blk][sub]
            if (i, sub) == (1, "v"):
                assert torch.equal(got["w"], tinit["layers"][i][blk][sub]["w"])
                continue
            assert np.array_equal(got["w"].numpy(), ref["w"])
            assert np.array_equal(got["b"].numpy(), ref["b"])
    assert torch.equal(tl["layers"][0]["self"]["ffn1"]["w"], tinit["layers"][0]["self"]["ffn1"]["w"])
    assert torch.equal(tl["final_proj"]["w"], tinit["final_proj"]["w"])


def _write_views(root, n=3, shape=(64, 80)):
    os.makedirs(root)
    for i in range(n):
        image_io.write_png_gray(os.path.join(root, f"v{i}.png"),
                                (_image(shape, 20 + i) * 255).astype(np.uint8))
    return root


def _db_features(db):
    return {iid: (db.read_keypoints(iid), db.read_descriptors(iid)) for iid, _, _ in db.read_images()}


def _assert_same_db_features(jf, tf):
    """Per image: the same keypoints up to order (matched within 1e-3 px),
    uint8 descriptors within 1 count (truncation at a boundary)."""
    assert list(jf) == list(tf)
    for iid in jf:
        (kj, dj), (kt, dt) = jf[iid], tf[iid]
        assert kj.shape == kt.shape and dt.dtype == np.uint8 and dt.shape == (len(kt), 128)
        for i in range(len(kj)):
            d = np.abs(kt[:, :2] - kj[i, :2]).max(axis=1)
            k = int(d.argmin())
            assert d[k] <= 1e-3
            assert np.abs(dt[k].astype(int) - dj[i].astype(int)).max() <= 1


def _use_colmap_tpu_aliked(monkeypatch, seed=0):
    """The port's pipeline builds its default ALIKED from colmap_tpu's
    parameters (the packages' random initializations differ)."""
    tp = _aliked_params(seed)[1]
    monkeypatch.setattr(TA, "init_params", lambda options=None, seed=0: tp)
    monkeypatch.setattr(tpipe, "_ALIKED_MODELS", {})
    monkeypatch.delattr(jpipe.run_feature_extraction, "_aliked_params", raising=False)


def _extract_both(tmp_path, images, tag, path=None):
    jr = jpipe.ImageReaderOptions(extractor_type="aliked", aliked_weights_path=path)
    jd = jdb.Database(str(tmp_path / f"j{tag}.db"))
    td = tdb.Database(str(tmp_path / f"t{tag}.db"))
    jpipe.run_feature_extraction(jd, images, reader_options=jr,
                                 sift_options=JSiftOptions(max_num_features=CAP))
    tpipe.run_feature_extraction(td, images, reader_options=convert.convert_options(jr),
                                 sift_options=TSiftOptions(max_num_features=CAP), device="cpu")
    return jd, td


def test_pipeline_aliked_extraction_matches_colmap_tpu(tmp_path, monkeypatch):
    _use_colmap_tpu_aliked(monkeypatch)
    images = _write_views(str(tmp_path / "images"))
    jd, td = _extract_both(tmp_path, images, "")
    assert jd.read_images() == td.read_images()
    assert list(jd.read_cameras()) == list(td.read_cameras())
    _assert_same_db_features(_db_features(jd), _db_features(td))
    jd.close()
    td.close()


def test_pipeline_lightglue_matching_matches_colmap_tpu(tmp_path, monkeypatch):
    """Both packages' exhaustive matching with matcher_type="lightglue" on
    one database's features (the port's ALIKED extraction, copied): the
    same matches for every pair. min_num_inliers above every count keeps
    colmap_tpu's verification (its RANSAC compiles) out of this test."""
    images = _write_views(str(tmp_path / "images"))
    td = tdb.Database(str(tmp_path / "t.db"))
    tpipe.run_feature_extraction(td, images, reader_options=tpipe.ImageReaderOptions(
        extractor_type="aliked"), sift_options=TSiftOptions(max_num_features=64), device="cpu")
    td.close()
    jd_path = str(tmp_path / "j.db")
    with open(str(tmp_path / "t.db"), "rb") as f, open(jd_path, "wb") as g:
        g.write(f.read())
    lg = JL.LightGlueOptions(**LG)
    jp, npp = _lg_params(0, lg)
    monkeypatch.setattr(TL, "init_params", lambda options=None, seed=0: (
        convert.lightglue_params_from_numpy(npp, dtype=torch.float32)))
    jo = jpipe.MatchingPipelineOptions(matcher_type="lightglue", lightglue_options=lg,
                                       min_num_inliers=10 ** 6)
    to = convert.convert_options(jo)
    to.lightglue_options = TL.LightGlueOptions(**LG)
    jd, td = jdb.Database(jd_path), tdb.Database(str(tmp_path / "t.db"))
    assert jpipe.run_exhaustive_matching(jd, jo) == 0
    assert tpipe.run_exhaustive_matching(td, to, device="cpu") == 0
    jm, tm = dict(jd.read_all_matches()), dict(td.read_all_matches())
    assert sorted(jm) == sorted(tm) and len(jm) == 3
    assert sum(len(m) for m in tm.values()) > 0
    for pair in jm:
        assert np.array_equal(jm[pair], tm[pair])
    jd.close()
    td.close()


def test_aliked_networks_are_keyed_by_weights_path(tmp_path, monkeypatch):
    """colmap_tpu keeps the first call's ALIKED parameters on
    run_feature_extraction for the life of the process, whatever
    aliked_weights_path a later call names; the port loads each path's."""
    _use_colmap_tpu_aliked(monkeypatch)
    images = _write_views(str(tmp_path / "images"), n=1)
    paths = []
    for seed in (3, 4):
        paths.append(str(tmp_path / f"w{seed}.pth"))
        torch.save(_aliked_state(_np_tree(JA.init_params(JA.AlikedOptions(), seed=seed)),
                                 extra=False), paths[-1])
    first = _extract_both(tmp_path, images, "a", paths[0])
    second = _extract_both(tmp_path, images, "b", paths[1])
    (ja, ta), (jb, tb) = first, second
    fa, fb = _db_features(ta), _db_features(tb)
    # The port: the second database holds the second weights' features ...
    img = image_io.read_image_gray(os.path.join(images, "v0.png"))
    opts = TA.AlikedOptions(max_num_keypoints=CAP)
    for (kp, desc), path in ((fa[1], paths[0]), (fb[1], paths[1])):
        kp_r, desc_r = TA.extract_aliked(img, TA.load_torch_weights(path, opts), opts, "cpu")
        assert np.array_equal(kp, kp_r)
        assert np.array_equal(desc, np.clip((desc_r + 1.0) * 127.5, 0, 255).astype(np.uint8))
    assert not np.array_equal(fa[1][0], fb[1][0])
    assert len(tpipe._ALIKED_MODELS) == 2
    # ... where colmap_tpu's repeats the first weights' (its fault).
    ka, kb = ja.read_keypoints(1), jb.read_keypoints(1)
    assert np.array_equal(ka, kb)
    for db in (ja, ta, jb, tb):
        db.close()
