"""The port's retrieval slice against colmap_tpu, on the CPU.

colmap_tpu_torch/retrieval/{visual_index,vote_and_verify}.py and the plain
versions of K28-K30 (colmap_tpu_torch/kernels/retrieval.py) are held against
colmap_tpu/retrieval on inputs made with numpy from a seed, at the sizes of
tests/test_retrieval.py (corpora of 120 x 64 and 60 x 48 descriptors, trees
of branching 3-8 and depth 3).

Tolerances and their reasons:
* the plain versions against colmap_tpu's jitted programs in float64 (the
  suite enables x64): the same indices except at near-ties, rows whose best
  two float64 distances lie within 1e-5 of the best;
* colmap_tpu's builders and indexes cast descriptors to float32 and form
  |x|² - 2 x·c + |c|², whose error on uint8-valued rows (|x|² up to 8.3e6)
  is a few units; the port computes in float64 on the CPU. So against them
  the words agree except at rows within F32_NEAR of a tie, and the data
  sets used end to end are checked to have none;
* centroids within 1e-5 of the scale (255) after one step from the same
  assignment, 1e-3 after whole builds (float32 sums against float64);
* query scores within 1e-9 relative (the same float64 idf votes; colmap_tpu
  adds them one by one, the port counts them by idf value and adds the
  products in a fixed tree; numpy and torch may round log differently in
  the last place); S of rank_images_bow within 1e-5 (float32 in both).
"""

import os

import numpy as np
import pytest
import torch

from colmap_tpu.cli import extra_commands as jx
from colmap_tpu.cli.main import main as jmain
from colmap_tpu.retrieval import visual_index as J
from colmap_tpu.retrieval import vote_and_verify as jvv
from colmap_tpu_torch import convert
from colmap_tpu_torch.cli import main as tcli
from colmap_tpu_torch.kernels import retrieval as R
from colmap_tpu_torch.retrieval import visual_index as T
from colmap_tpu_torch.retrieval import vote_and_verify as tvv
from colmap_tpu_torch.scene.database import Database
from colmap_tpu_torch.scene.synthetic import SyntheticDatasetOptions, synthesize_dataset
from colmap_tpu_torch.utils.types import pair_id_to_image_pair

torch.set_num_threads(1)

F32_NEAR = 1e-3
SCALE = 255.0


def _clustered(rng, n_clusters, per_cluster, noise):
    centers = rng.uniform(0, 255, (n_clusters, 128))
    descs = centers[np.repeat(np.arange(n_clusters), per_cluster)]
    return np.clip(descs + rng.normal(0, noise, descs.shape), 0, 255)


def _pool_images(seed, n_images, n_feat, n_pools, pool_size, noise):
    """tests/test_retrieval.py's corpora: image i draws n_feat descriptors
    of pool i // (n_images / n_pools), with noise."""
    rng = np.random.default_rng(seed)
    pools = rng.integers(0, 256, (n_pools, pool_size, 128)).astype(np.float32)
    cluster_of = np.repeat(np.arange(n_pools), n_images // n_pools)
    descs = {}
    for i in range(n_images):
        sel = rng.choice(pool_size, n_feat, replace=False)
        d = pools[cluster_of[i], sel] + rng.normal(0, noise, (n_feat, 128))
        descs[i] = np.clip(d, 0, 255).astype(np.float32)
    return descs, cluster_of


def _corpus_120x64():
    return _pool_images(0, 120, 64, 6, 256, 10.0)


def _corpus_60x48():
    return _pool_images(1, 60, 48, 3, 128, 8.0)


def _f32_near_ties(desc, tree_levels=None, vocab=None):
    """Rows whose float64 word (flat, or at any level of the descent) lies
    within F32_NEAR of a tie."""
    x = np.asarray(desc, np.float64)

    def near(d2):
        s = np.sort(d2, axis=1)
        return s[:, 1] - s[:, 0] < F32_NEAR * s[:, 0]

    if vocab is not None:
        return near(((x[:, None, :] - np.asarray(vocab, np.float64)[None]) ** 2).sum(-1))
    node = np.zeros(len(x), np.int64)
    out = np.zeros(len(x), bool)
    for lv in tree_levels:
        d2 = ((x[:, None, :] - np.asarray(lv, np.float64)[node]) ** 2).sum(-1)
        out |= near(d2)
        node = node * lv.shape[1] + d2.argmin(1)
    return out


def _agree(got, want, near):
    got, want = np.asarray(got), np.asarray(want)
    assert ((got == want) | near).all(), f"{int(((got != want) & ~near).sum())} rows differ"


def _words_agree(tindex, jindex, desc):
    """The port's words (float64) equal colmap_tpu's (float32) except at
    rows within F32_NEAR of a tie."""
    desc = np.asarray(desc, np.float32)
    want = np.asarray(jindex._assign(desc))
    got = tindex._assign(tindex._desc(desc)).numpy()
    levels = jindex.tree.levels if jindex.tree is not None else None
    _agree(got, want, _f32_near_ties(desc, levels, None if levels else jindex.vocabulary))


# ---------------------------------------------------------------------------
# K28-K30's plain versions against colmap_tpu's programs, in float64.
# ---------------------------------------------------------------------------


def test_assign_plain_matches_assign_words():
    descs, _ = _corpus_120x64()
    x = np.concatenate(list(descs.values())).astype(np.float64)
    rng = np.random.default_rng(4)
    vocab = x[rng.choice(len(x), 256, replace=False)] + rng.normal(0, 3.0, (256, 128))
    vocab[17] = vocab[3]  # an exact tie: the first index wins
    want = np.asarray(J._assign_words(x, vocab))
    got, near = R.nearest64(torch.as_tensor(x), torch.as_tensor(vocab))
    assert got.dtype == torch.int32
    _agree(got.numpy(), want, near.numpy())
    assert (R.assign(torch.as_tensor(x), torch.as_tensor(vocab)).numpy() == got.numpy()).all()
    assert not (got.numpy() == 17).any()


def test_descend_plain_matches_tree_descend():
    descs, _ = _corpus_60x48()
    x = np.concatenate(list(descs.values())).astype(np.float64)
    rng = np.random.default_rng(5)
    levels = [x[rng.choice(len(x), 8 ** (lv + 1), replace=False)].reshape(8 ** lv, 8, 128)
              + rng.normal(0, 2.0, (8 ** lv, 8, 128)) for lv in range(3)]
    want = np.asarray(J._tree_descend_jit(x, tuple(levels)))
    flat = torch.cat([torch.as_tensor(lv).reshape(-1, 128) for lv in levels])
    got, near = R.descend64(torch.as_tensor(x), flat, 8, 3)
    _agree(got.numpy(), want, near.numpy())
    assert (R.descend(torch.as_tensor(x), flat, 8, 3).numpy() == got.numpy()).all()


def test_excess_measures_how_far_the_choice_lies_beyond_the_nearest():
    """excess64 and descend_excess64 (the card checks' error measure of K28
    and K30): 0 for the float64 choice, the gap to the nearest for another."""
    rng = np.random.default_rng(6)
    levels = [rng.normal(128.0, 30.0, (8 ** lv, 8, 128)) for lv in range(3)]
    flat = torch.cat([torch.as_tensor(lv).reshape(-1, 128) for lv in levels])
    x = torch.as_tensor(rng.normal(128.0, 30.0, (300, 128)))
    vocab = flat[-512:]
    best = R.assign_plain(x, vocab)
    ex, rel = R.excess64(x, vocab, best)
    assert float(ex.max()) == 0.0 and float(rel.max()) == 0.0
    other = (best + 1) % 512
    d2 = ((x[:, None, :] - vocab[None]) ** 2).sum(-1)
    ar = torch.arange(300)
    gap = d2[ar, other.long()] - d2[ar, best.long()]
    ex, rel = R.excess64(x, vocab, other)
    assert torch.allclose(ex, gap, rtol=1e-9, atol=1e-6)
    assert torch.allclose(rel, gap / d2[ar, best.long()], rtol=1e-9)
    leaves = R.descend_plain(x, flat, 8, 3)
    assert float(R.descend_excess64(x, flat, 8, 3, leaves)[0].max()) == 0.0
    moved = leaves // 8 * 8 + (leaves + 1) % 8  # another child at the last level
    ex, _ = R.descend_excess64(x, flat, 8, 3, moved)
    leaf_d2 = ((x[:, None, :] - vocab[None]) ** 2).sum(-1)
    assert torch.allclose(ex, leaf_d2[ar, moved.long()] - leaf_d2[ar, leaves.long()],
                          rtol=1e-9, atol=1e-6)


def test_bow_matrix_and_gram_plain_match_rank_images_bows_program():
    """bow_matrix against colmap_tpu's W (rank_images_bow l.476-485, written
    out in numpy) and K31's plain version against its jitted w @ w.T."""
    import jax

    rng = np.random.default_rng(7)
    lengths = [40, 0, 25, 60, 33, 40]
    words = rng.integers(0, 200, sum(lengths))
    words[100:140] = words[:40]  # image 3 begins with image 0's words
    want = np.zeros((len(lengths), 200), np.float32)
    pos = 0
    for row, n in enumerate(lengths):
        want[row] = np.bincount(words[pos:pos + n], minlength=200).astype(np.float32)
        pos += n
    df = np.maximum((want > 0).sum(axis=0), 1)
    want *= (np.log(len(lengths) / df).astype(np.float32) + 1e-6)[None, :]
    want /= np.maximum(np.linalg.norm(want, axis=1, keepdims=True), 1e-12)
    W = T.bow_matrix(torch.as_tensor(words), lengths, 200)
    assert W.dtype == torch.float32 and np.abs(W.numpy() - want).max() <= 1e-7
    S = R.gram(W)
    assert S.dtype == torch.float32 and torch.equal(S, S.T)
    ref = np.asarray(jax.jit(lambda w: w @ w.T)(want), np.float64)
    assert np.abs(S.numpy() - ref).max() <= 1e-5 * np.abs(ref).max()


def _bow_case(case):
    """A sparse bag-of-words W (float32, rows L2-normalized) for K31's
    integer model: "bow" plain; "stop_word" with word 0 in every row and
    row 5 all zero; "scaled" the bow W times 1e3 (a smaller 2^F)."""
    rng = np.random.default_rng(21)
    n, K = 37, 300
    w = rng.random((n, K)) * (rng.random((n, K)) < 0.08)
    if case == "stop_word":
        w[:, 0] = rng.uniform(0.2, 1.0, n)
        w[5] = 0.0
    w /= np.maximum(np.linalg.norm(w, axis=1, keepdims=True), 1e-12)
    if case == "scaled":
        w *= 1e3
    return w.astype(np.float32)


@pytest.mark.parametrize("case", ["bow", "stop_word", "scaled"])
def test_gram_integer_model_matches_rank_images_bows_program(case):
    """K31's sparse arithmetic (gram_fixed_plain: exact products scaled by
    2^F, rounded to integers and summed as integers) against colmap_tpu's
    jitted w @ w.T (rank_images_bow, visual_index.py:487) within 1e-6 of
    the scale and against float64 within 1e-7 (each product's rounding to
    2^-F and one float32 rounding); bit-for-bit symmetric; 2^F the largest
    power of two that keeps r m² 2^F below 2^GRAM_BITS."""
    import jax

    w = _bow_case(case)
    W = torch.from_numpy(w)
    S = R.gram_fixed_plain(W)
    assert S.dtype == torch.float32 and torch.equal(S, S.T)
    ref = np.asarray(jax.jit(lambda a: a @ a.T)(w), np.float64)
    scale = np.abs(ref).max()
    assert np.abs(S.numpy() - ref).max() <= 1e-6 * scale
    exact = w.astype(np.float64) @ w.astype(np.float64).T
    assert np.abs(S.numpy() - exact).max() <= 1e-7 * scale
    F = R.gram_scale_exponent(W)
    bound = float((w != 0).sum(1).max()) * float(np.abs(w).max()) ** 2
    assert bound * 2.0 ** F < 2.0 ** R.GRAM_BITS <= 2 * bound * 2.0 ** F
    if case == "stop_word":
        assert (S[5] == 0).all()


def test_one_kmeans_step_matches():
    """_kmeans_step: the same assignment (away from near-ties) and, from
    that assignment, centroids within 1e-5 of the scale; an empty word keeps
    its centroid."""
    descs, _ = _corpus_120x64()
    x = np.concatenate(list(descs.values())).astype(np.float64)
    rng = np.random.default_rng(6)
    cents = x[rng.choice(len(x), 64, replace=False)] + rng.normal(0, 2.0, (64, 128))
    cents[5] = 1e4  # no row is nearest: count 0
    want_c, want_a = (np.array(a) for a in J._kmeans_step(x, cents, 64))
    got_a, near = R.nearest64(torch.as_tensor(x), torch.as_tensor(cents))
    _agree(got_a.numpy(), want_a, near.numpy())
    new, counts = R.update(torch.as_tensor(x), torch.as_tensor(want_a), torch.as_tensor(cents))
    assert np.abs(new.numpy() - want_c).max() <= 1e-5 * SCALE
    assert counts[5] == 0 and (new[5].numpy() == cents[5]).all()
    assert counts.sum() == len(x)


def test_one_tree_level_step_matches():
    """_tree_kmeans_level_step on padded (M, S, D) blocks against K28 and
    K29's plain versions on the same samples as per-node segments (some
    nodes hold fewer samples than others, one none)."""
    descs, _ = _corpus_60x48()
    x = np.concatenate(list(descs.values())).astype(np.float64)
    rng = np.random.default_rng(7)
    M, S, B = 9, 40, 4
    sizes = rng.integers(1, S + 1, M)
    sizes[4] = 0
    blocks, mask = np.zeros((M, S, 128)), np.zeros((M, S))
    rows, nodes = [], []
    for m in range(M):
        idx = rng.choice(len(x), sizes[m], replace=False)
        blocks[m, :sizes[m]] = x[idx]
        mask[m, :sizes[m]] = 1.0
        rows.append(idx)
        nodes += [m] * sizes[m]
    init = x[rng.choice(len(x), M * B, replace=False)].reshape(M, B, 128)
    want_c, want_a = (np.array(a) for a in J._tree_kmeans_level_step(blocks, mask, init, B))
    xs = torch.as_tensor(x[np.concatenate(rows)])
    groups = torch.as_tensor(nodes, dtype=torch.int32)
    cents = torch.as_tensor(init.reshape(-1, 128))
    got_a, near = R.nearest64(xs, cents, groups, B)
    want_rows = np.concatenate([want_a[m, :sizes[m]] for m in range(M)])
    _agree(got_a.numpy(), want_rows, near.numpy())
    new, counts = R.update(xs, groups.long() * B + torch.as_tensor(want_rows), cents)
    assert np.abs(new.numpy().reshape(M, B, 128) - want_c).max() <= 1e-5 * SCALE
    assert (counts.view(M, B)[4] == 0).all()


# ---------------------------------------------------------------------------
# The builders end to end: the same host draws, then float64 Lloyd.
# ---------------------------------------------------------------------------


def test_build_vocabulary_matches():
    rng = np.random.default_rng(0)
    descs = _clustered(rng, 16, 50, 5.0)
    want = J.build_vocabulary(descs, 16, num_iterations=30)
    got = T.build_vocabulary(descs, 16, num_iterations=30, device="cpu")
    assert got.dtype == torch.float64
    assert np.abs(got.numpy() - want).max() <= 1e-3 * SCALE
    # Fewer descriptors than words: random centroids fill the rest.
    few = descs[:10]
    assert np.abs(T.build_vocabulary(few, 16, 3, seed=2, device="cpu").numpy()
                  - J.build_vocabulary(few, 16, 3, seed=2)).max() <= 1e-3 * SCALE


def test_build_vocabulary_tree_matches():
    """Branching 3 and 8, depth 3 (512 leaves over 7680 descriptors leaves
    nodes with fewer samples than children and empty nodes)."""
    rng = np.random.default_rng(1)
    for descs, kw in ((_clustered(rng, 24, 40, 2.0), dict(branching=3, depth=3, seed=1)),
                      (np.concatenate(list(_corpus_120x64()[0].values()))[::3],
                       dict(branching=8, depth=3, num_iterations=4, max_samples_per_node=128))):
        want = J.build_vocabulary_tree(descs, **kw)
        got = T.build_vocabulary_tree(descs, device="cpu", **kw)
        assert len(got.levels) == 3
        for a, b in zip(want.levels, got.levels):
            assert np.abs(b.numpy() - a).max() <= 1e-3 * SCALE
        near = _f32_near_ties(descs, want.levels)
        _agree(got.assign(descs).numpy(), want.assign(descs), near)


# ---------------------------------------------------------------------------
# The index: query on one state carried across, verification, BoW ranking.
# ---------------------------------------------------------------------------


def _jax_index(seed=1):
    rng = np.random.default_rng(seed)
    centers = rng.uniform(0, 255, (24, 128))

    def make_image(cluster_ids, n=60):
        picks = rng.choice(cluster_ids, n)
        return np.clip(centers[picks] + rng.normal(0, 4.0, (n, 128)), 0, 255)

    images = {1: make_image([0, 1, 2, 3]), 2: make_image([0, 1, 2, 4]),
              3: make_image([10, 11, 12, 13]), 4: make_image([10, 11, 14, 15]),
              5: make_image([20, 21, 22, 23])}
    images[7] = images[2].copy()  # a planted tie with image 2, added after it
    index = J.VisualIndex.create(np.concatenate(list(images.values())), num_words=64,
                                 num_iterations=20)
    for iid in (1, 2, 3, 4, 5, 7):
        index.add(iid, images[iid])
    return index, images


def _carried(index):
    vocab = [np.asarray(lv) for lv in index.tree.levels] if index.tree else index.vocabulary
    return convert.visual_index_from_numpy(vocab, index.signature_thresholds, index.inverted,
                                           index.image_word_counts, index.num_images,
                                           device="cpu")


def _same_results(got, want, rtol=1e-9):
    assert [r.image_id for r in got] == [r.image_id for r in want]
    for g, w in zip(got, want):
        assert abs(g.score - w.score) <= rtol * abs(w.score)


def test_query_on_a_carried_index_matches():
    """The same ids in the same order and scores within 1e-9; images 2 and
    7 tie exactly and rank in first-vote order (2, added first)."""
    jindex, images = _jax_index()
    tindex = _carried(jindex)
    assert int(tindex.postings().counts.sum()) == sum(len(p) for p in jindex.inverted.values())
    for iid, desc in images.items():
        for kw in (dict(num_images=10), dict(num_images=3, exclude_image_id=iid),
                   dict(num_images=10, hamming_threshold=30)):
            _same_results(tindex.query(desc, **kw), jindex.query(desc, **kw))
    res = tindex.query(images[1], num_images=10)
    ranks = [r.image_id for r in res]
    assert res[ranks.index(2)].score == res[ranks.index(7)].score
    assert ranks.index(2) < ranks.index(7)
    # The port's own add() gives the same postings (no word of this data
    # lies near a float32 tie).
    native = T.VisualIndex(jindex.vocabulary, device="cpu")
    for iid in (1, 2, 3, 4, 5, 7):
        native.add(iid, images[iid])
    _words_agree(native, jindex, np.concatenate(list(images.values())))
    for iid, desc in images.items():
        _same_results(native.query(desc, 4, exclude_image_id=iid),
                      jindex.query(desc, 4, exclude_image_id=iid))


def test_query_ties_images_with_the_same_votes_in_any_order():
    """Image 8 holds image 1's descriptors in reverse order, so that its
    votes arrive interleaved otherwise: it ties image 1 to the bit, ranks
    after it (first vote), and a query gives the same bits twice."""
    jindex, images = _jax_index()
    index = T.VisualIndex(jindex.vocabulary, device="cpu")
    for iid in (1, 2, 3, 4, 5, 7):
        index.add(iid, images[iid])
    index.add(8, images[1][::-1].copy())
    for query in (images[1], images[2], images[1][::2]):
        res = index.query(query, num_images=10)
        again = index.query(query, num_images=10)
        assert [(r.image_id, r.score) for r in res] == [(r.image_id, r.score) for r in again]
        ranks = [r.image_id for r in res]
        assert res[ranks.index(1)].score == res[ranks.index(8)].score
        assert ranks.index(1) < ranks.index(8)


def test_signature_popcount_counts_bit_63():
    index = T.VisualIndex(np.zeros((4, 128), np.float32), device="cpu")
    d = np.zeros((2, 128), np.float32)
    d[0, 63] = 1.0
    d[1, [0, 7, 8, 63]] = 1.0
    sig = index._signatures(torch.as_tensor(d))
    assert sig.shape == (2, 8) and sig.dtype == torch.uint8
    packed = [int(np.frombuffer(sig[i].numpy().tobytes(), "<u8")[0]) for i in range(2)]
    assert packed == [1 << 63, (1 << 63) | (1 << 8) | (1 << 7) | 1]
    ham = int(index._popcount[(sig[0] ^ sig[1]).long()].sum())
    assert ham == bin(packed[0] ^ packed[1]).count("1") == 3


def test_vote_and_verify_and_query_with_verification_match():
    rng = np.random.default_rng(0)
    n = 80
    xy = rng.uniform(0, 800, size=(n, 2))
    g1 = np.column_stack([xy, rng.uniform(1.0, 3.0, n), rng.uniform(-np.pi, np.pi, n)])
    s, a = 1.4, 0.3
    rot = np.array([[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]])
    g2 = np.column_stack([s * xy @ rot.T + [50.0, -20.0], g1[:, 2] * s, g1[:, 3] + a])
    g2_rand = np.column_stack([rng.uniform(0, 800, (n, 2)), g1[:, 2:]])
    for other in (g2, g2_rand, g2[:2]):
        for opts in (None, jvv.VoteAndVerifyOptions(eff_inlier_count=False)):
            topts = None if opts is None else tvv.VoteAndVerifyOptions(eff_inlier_count=False)
            assert tvv.vote_and_verify(g1[:len(other)], other, topts) == \
                jvv.vote_and_verify(g1[:len(other)], other, opts)

    base = rng.integers(0, 256, size=(300, 128)).astype(np.float32)
    jindex = J.VisualIndex.create(base, num_words=32)
    tindex = T.VisualIndex(jindex.vocabulary, device="cpu")
    desc = rng.integers(0, 256, size=(60, 128)).astype(np.float32)
    kp_q = np.column_stack([xy[:60], np.ones(60), np.zeros(60)])
    kps = {1: np.column_stack([xy[:60] + 10.0, np.ones(60), np.zeros(60)]),
           2: np.column_stack([rng.uniform(0, 640, (60, 2)), np.ones(60), np.zeros(60)]),
           3: None}
    for iid, kp in kps.items():
        jindex.add(iid, desc, kp)
        tindex.add(iid, desc, kp)
    _words_agree(tindex, jindex, desc)
    got = tindex.query_with_verification(desc, kp_q, num_images=3)
    _same_results(got, jindex.query_with_verification(desc, kp_q, num_images=3))
    assert got[0].image_id == 1 and got[0].score == float(int(got[0].score))


def _same_ranking(got, want, tol):
    """Scores within tol, ids equal except where tied within tol."""
    gs, ws = [r.score for r in got], [r.score for r in want]
    assert len(gs) == len(ws) and np.allclose(gs, ws, rtol=0, atol=tol)
    wid = [r.image_id for r in want]
    for p, r in enumerate(got):
        if r.image_id != wid[p]:
            tied = [q for q in range(len(ws)) if abs(ws[q] - ws[p]) <= tol]
            assert r.image_id in [wid[q] for q in tied] or abs(ws[p] - ws[-1]) <= tol


def test_rank_images_bow_matches():
    descs, cluster_of = _corpus_120x64()
    train = np.concatenate([descs[i] for i in range(0, 120, 3)])
    jtree = J.build_vocabulary_tree(train, branching=8, depth=3, num_iterations=4,
                                    max_samples_per_node=128)
    want = J.rank_images_bow(descs, J.VisualIndex(jtree), num_neighbors=5)
    ttree = convert.tree_vocabulary_from_numpy(jtree.levels, "cpu")
    _words_agree(T.VisualIndex(ttree, device="cpu"), J.VisualIndex(jtree),
                 np.concatenate([descs[i] for i in range(120)]))
    got = T.rank_images_bow(descs, ttree, num_neighbors=5, device="cpu")
    assert sorted(got) == sorted(want)
    for iid in want:
        _same_ranking(got[iid], want[iid], 1e-5)
    hits = sum(cluster_of[r.image_id] == cluster_of[iid] for iid in got for r in got[iid])
    assert hits / (5 * 120) > 0.9


def test_vocab_tree_pairs_match():
    """Both paths: index + query (6 images), rank_images_bow (60 > 50)."""
    rng = np.random.default_rng(2)
    centers = rng.uniform(0, 255, (30, 128))
    groups = {1: [0, 1, 2], 2: [0, 1, 3], 3: [1, 2, 3], 4: [10, 11, 12], 5: [10, 11, 13],
              6: [11, 12, 13]}
    small = {iid: np.clip(centers[rng.choice(cl, 50)] + rng.normal(0, 4.0, (50, 128)), 0, 255)
             for iid, cl in groups.items()}
    for descs, kw in ((small, dict(num_words=64, num_neighbors=2)),
                      (_corpus_60x48()[0], dict(num_words=128, num_neighbors=4))):
        want = J.vocab_tree_pairs(descs, **kw)
        got = T.vocab_tree_pairs(descs, device="cpu", **kw)
        assert set(got) == set(want) and len(got) == len(want)


def test_shipped_tree_is_colmap_tpus():
    path = T.default_vocab_tree_path()
    assert path is not None and os.path.dirname(path).endswith(os.path.join("colmap_tpu_torch",
                                                                             "data"))
    with open(path, "rb") as a, open(J.default_vocab_tree_path(), "rb") as b:
        assert a.read() == b.read()
    jtree = J.load_vocab_tree(J.default_vocab_tree_path())
    ttree = T.load_vocab_tree(path, device="cpu")
    assert ttree.num_words == 512
    rng = np.random.default_rng(3)
    sample = np.clip(ttree.leaf_centroids.numpy()[rng.integers(0, 512, 300)]
                     + rng.normal(0, 3.0, (300, 128)), 0, 255)
    _agree(ttree.assign(sample).numpy(), jtree.assign(sample),
           _f32_near_ties(sample, jtree.levels))


# ---------------------------------------------------------------------------
# The three commands against colmap_tpu's on one database.
# ---------------------------------------------------------------------------


def _database(path):
    """The verify scene: 8 frames that all see 120 points, each point one
    descriptor in every image that sees it (exact ties in the scores)."""
    db = Database(path)
    synthesize_dataset(SyntheticDatasetOptions(num_rigs=1, num_frames_per_rig=8, num_points3D=120,
                                               camera_has_prior_focal_length=True), db,
                       rng=np.random.default_rng(3))
    db.conn.execute("DELETE FROM matches")
    db.conn.execute("DELETE FROM two_view_geometries")
    db.commit()
    db.close()


def test_commands_match_colmap_tpu(tmp_path, capsys, monkeypatch):
    path = str(tmp_path / "db.db")
    _database(path)
    trees = {}
    for pkg, run in (("jax", jmain), ("port", tcli.main)):
        dev = ["--device", "cpu"] if pkg == "port" else []
        trees[pkg] = str(tmp_path / f"{pkg}_tree")
        run(["vocab_tree_builder", "--database_path", path, "--vocab_tree_path", trees[pkg],
             "--depth", "2", "--branching", "4"] + dev)
        run(["vocab_tree_builder", "--database_path", path, "--vocab_tree_path",
             str(tmp_path / f"{pkg}_flat.npz"), "--num_words", "32"] + dev)
    capsys.readouterr()
    # Each package's files load in the other.
    for name in ("tree.npz", "flat.npz"):
        a, b = np.load(str(tmp_path / f"jax_{name}")), np.load(str(tmp_path / f"port_{name}"))
        assert a.files == b.files
        for k in a.files:
            assert b[k].dtype == np.float32 and np.abs(a[k] - b[k]).max() <= 1e-3 * SCALE
    tree = T.load_vocab_tree(trees["jax"] + ".npz", device="cpu")
    assert tree.num_words == 16
    assert len(J.load_vocab_tree(trees["port"] + ".npz").levels) == 2

    db = Database(path, must_exist=True)
    all_desc = np.concatenate([db.read_descriptors(i) for i, _, _ in db.read_images()])
    db.close()
    for vocab in (trees["port"], str(tmp_path / "port_flat.npz")):
        _words_agree(tcli._load_or_train_index(vocab, {}, "cpu"),
                     jx._load_or_train_index(vocab, {}), all_desc)
        lines = {}
        for pkg, run in (("jax", jmain), ("port", tcli.main)):
            dev = ["--device", "cpu"] if pkg == "port" else []
            run(["vocab_tree_retriever", "--database_path", path, "--vocab_tree_path", vocab,
                 "--num_images", "3"] + dev)
            lines[pkg] = capsys.readouterr().out.splitlines()
        assert lines["port"] == lines["jax"] and len(lines["port"]) == 24

        jpairs = []
        monkeypatch.setattr("colmap_tpu.controllers.feature_pipeline.run_matches_import",
                            lambda db, pairs, *a, **k: jpairs.extend(pairs) or 0)
        jmain(["vocab_tree_matcher", "--database_path", path, "--vocab_tree_path", vocab,
               "--num_images", "3"])
        monkeypatch.undo()
        port_db = str(tmp_path / "port.db")
        with open(path, "rb") as src, open(port_db, "wb") as dst:
            dst.write(src.read())
        n = tcli.main(["vocab_tree_matcher", "--database_path", port_db, "--vocab_tree_path",
                       vocab, "--num_images", "3", "--device", "cpu"])
        out = capsys.readouterr().out
        assert f"of {len(jpairs)} vocab-tree pairs" in out and n == len(jpairs)
        db = Database(port_db, must_exist=True)
        matched = {pair_id_to_image_pair(pid) for pid, _ in db.read_all_matches()}
        db.close()
        assert matched == set(jpairs)
