"""Visual index for image retrieval: k-means vocabularies and a TF-IDF
inverted file with binary-signature re-ranking.

reference behavior: src/colmap/retrieval/visual_index.h:52-120 (a k-means
tree and an inverted index with Hamming embedding, TF-IDF scoring,
Build/Add/Query); the port of colmap_tpu/retrieval/visual_index.py. Two
vocabularies share one index:

* flat: Lloyd k-means, the assignment on K28 (``kernels/retrieval.py``
  ``assign``) and the update on K29 (``update``);
* a tree (``TreeVocabulary``): branching B, depth L, B^L leaf words, built
  level by level, every node's Lloyd iterations at once on K28 and K29 over
  per-node segments of the level's samples; assignment is descent on K30,
  all levels in one launch.

The host keeps what must draw the same random numbers as colmap_tpu in the
same order (k-means++ seeding, per-node sampling and initialization:
numpy's ``default_rng(seed)``), and the spatial verification
(``vote_and_verify``). The inverted file lives on the index's device as
arrays in CSR order by word, and a query is torch ops over its postings,
with colmap_tpu's results: the same document frequencies and Hamming cut,
idf votes summed in float64, and the same order of tied scores (the order
in which each image first got a vote).

Entry points run on ``cuda`` unless given ``device="cpu"``; on the CPU the
kernels' plain versions run, in float64.
"""

from __future__ import annotations

import dataclasses
import functools
import os
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from colmap_tpu_torch.kernels import retrieval as R
from colmap_tpu_torch.utils.dtypes import floatx, resolve_device

# Set bits of every byte value: a signature's Hamming distance is the sum of
# this table over the eight bytes of the XOR.
_POPCOUNT = [bin(i).count("1") for i in range(256)]


def _rows(desc, device, dtype):
    """Descriptors (N, D) as a ``dtype`` tensor on ``device``."""
    return torch.as_tensor(np.asarray(desc) if not torch.is_tensor(desc) else desc,
                           device=device).to(dtype)


def build_vocabulary(descriptors, num_words: int, num_iterations: int = 20, seed: int = 0,
                     device=None) -> torch.Tensor:
    """Train a flat k-means vocabulary (num_words, D) on (uint8)
    descriptors: k-means++ seeding on the host, then Lloyd iterations on
    K28 and K29."""
    rng = np.random.default_rng(seed)
    desc = np.asarray(descriptors, dtype=np.float32)
    n = len(desc)
    # k-means++ seeding: avoids cluster starvation of uniform picks.
    k = min(num_words, n)
    init = np.empty((k, desc.shape[1]), dtype=np.float32)
    init[0] = desc[rng.integers(n)]
    d2 = np.sum((desc - init[0]) ** 2, axis=1)
    for i in range(1, k):
        probs = d2 / max(d2.sum(), 1e-12)
        init[i] = desc[rng.choice(n, p=probs)]
        d2 = np.minimum(d2, np.sum((desc - init[i]) ** 2, axis=1))
    if k < num_words:
        init = np.concatenate(
            [init, rng.normal(128, 50, (num_words - k, desc.shape[1]))]
        ).astype(np.float32)
    device = resolve_device(device)
    dtype = floatx(device)
    x = _rows(desc, device, dtype)
    centroids = _rows(init, device, dtype)
    for _ in range(num_iterations):
        centroids, _ = R.update(x, R.assign(x, centroids), centroids)
    return centroids


@dataclasses.dataclass
class TreeVocabulary:
    """Hierarchical k-means vocabulary (reference:
    src/colmap/retrieval/visual_index.h:52-120).

    ``levels[l]`` has shape (branching**l, branching, D): the children of
    every level-l node, on one device. Leaf word count = branching**depth.
    """

    levels: List[torch.Tensor]

    @property
    def branching(self) -> int:
        return self.levels[0].shape[1]

    @property
    def depth(self) -> int:
        return len(self.levels)

    @property
    def num_words(self) -> int:
        return self.branching ** self.depth

    @property
    def leaf_centroids(self) -> torch.Tensor:
        lv = self.levels[-1]
        return lv.reshape(-1, lv.shape[-1])

    @functools.cached_property
    def concatenated(self) -> torch.Tensor:
        """The levels as one (Σ_l B^(l+1), D) tensor, as K30 reads them."""
        return torch.cat([lv.reshape(-1, lv.shape[-1]) for lv in self.levels]).contiguous()

    def assign(self, desc) -> torch.Tensor:
        """Leaf word ids (int32) of desc (N, D) by descent on K30."""
        ref = self.levels[0]
        return R.descend(_rows(desc, ref.device, ref.dtype), self.concatenated, self.branching,
                         self.depth)


def build_vocabulary_tree(
    descriptors,
    branching: int = 10,
    depth: int = 4,
    num_iterations: int = 10,
    max_samples_per_node: int = 1024,
    seed: int = 0,
    device=None,
) -> TreeVocabulary:
    """Train a hierarchical k-means vocabulary level by level.

    On the host, as colmap_tpu draws them: each node's samples (at most
    ``max_samples_per_node`` of its descriptors) and its B initial
    centroids; an empty node inherits a perturbed copy of its parent
    centroid so descent never dead-ends. On the device, every node's Lloyd
    iterations of the level at once: K28 over the samples with each row's
    group set to its node, K29 over the node x child segments. Then K28
    re-assigns every descriptor to a child of its node.
    """
    rng = np.random.default_rng(seed)
    desc = np.asarray(descriptors, dtype=np.float32)
    n, dim = desc.shape
    device = resolve_device(device)
    dtype = floatx(device)
    x_all = _rows(desc, device, dtype)
    assign = np.zeros(n, dtype=np.int64)  # current node of each descriptor
    levels: List[torch.Tensor] = []
    parents = desc.mean(0)[None]  # level l's node centroids, float32, for empty nodes
    for level in range(depth):
        num_nodes = branching ** level
        init = np.zeros((num_nodes, branching, dim), np.float32)
        order = np.argsort(assign, kind="stable")
        bounds = np.searchsorted(assign[order], np.arange(num_nodes + 1))
        samples = []
        for m in range(num_nodes):
            idx = order[bounds[m]:bounds[m + 1]]
            if len(idx) > max_samples_per_node:
                idx = rng.choice(idx, max_samples_per_node, replace=False)
            k = len(idx)
            samples.append(idx)
            if k >= branching:
                init[m] = desc[rng.choice(idx, branching, replace=False)]
            elif k > 0:
                reps = desc[idx[rng.integers(0, k, branching)]]
                init[m] = reps + rng.normal(0, 1.0, (branching, dim))
            else:
                init[m] = parents[m] + rng.normal(0, 1.0, (branching, dim))
        sizes = torch.as_tensor([len(s) for s in samples], device=device)
        nodes = torch.repeat_interleave(torch.arange(num_nodes, device=device), sizes)
        xs = x_all[torch.as_tensor(np.concatenate(samples), device=device)]
        groups = nodes.to(torch.int32)
        cents = _rows(init.reshape(-1, dim), device, dtype)
        for _ in range(num_iterations):
            child = R.assign(xs, cents, groups, branching)
            cents, _ = R.update(xs, nodes * branching + child.long(), cents)
        levels.append(cents.view(num_nodes, branching, dim))
        parents = cents.to(torch.float32).cpu().numpy()
        # Re-assign ALL descriptors (not just the samples) to children.
        child = R.assign(x_all, cents, torch.as_tensor(assign, device=device).to(torch.int32),
                         branching)
        assign = assign * branching + child.cpu().numpy()
    return TreeVocabulary(levels)


@dataclasses.dataclass
class QueryResult:
    image_id: int
    score: float


class _Postings(NamedTuple):
    """The inverted file in CSR order by word, on the index's device:
    word w's postings are rows offsets[w]:offsets[w + 1], in the order they
    were added."""

    offsets: torch.Tensor  # (num_words + 1,) int64
    counts: torch.Tensor  # (num_words,) int64
    level: torch.Tensor  # (num_words,) int64: the rank of each word's df among the dfs
    level_idf: torch.Tensor  # (L,) float64: log(num_images / df) + 1e-6 of each rank
    image: torch.Tensor  # (P,) int64 image ids
    slot: torch.Tensor  # (P,) int64 positions of the image ids in image_ids
    sig: torch.Tensor  # (P, 8) uint8 signatures
    image_ids: torch.Tensor  # (I,) int64 sorted distinct image ids


def _run_sums(values, lengths):
    """The sum of each consecutive run of ``values`` (run r holds lengths[r]
    > 0 of them), added as a fixed pairwise tree over the run's positions:
    a run's sum depends on its values alone."""
    dev = values.device
    run = torch.repeat_interleave(torch.arange(len(lengths), device=dev), lengths)
    col = torch.arange(len(values), device=dev) - (torch.cumsum(lengths, 0) - lengths)[run]
    width = 1 << int(lengths.max() - 1).bit_length()
    table = torch.zeros(len(lengths), width, dtype=values.dtype, device=dev)
    table[run, col] = values
    while width > 1:
        width //= 2
        table = table[:, :width] + table[:, width:]
    return table[:, 0]


class VisualIndex:
    """TF-IDF inverted-file index with binary-signature re-ranking, on one
    device (``cuda`` unless given ``device="cpu"``)."""

    def __init__(self, vocabulary, device=None):
        self.device = resolve_device(device)
        self.dtype = floatx(self.device)
        if isinstance(vocabulary, TreeVocabulary):
            self.tree: Optional[TreeVocabulary] = TreeVocabulary(
                [_rows(lv, self.device, self.dtype) for lv in vocabulary.levels])
            self.vocabulary = self.tree.leaf_centroids
            self.num_words = self.tree.num_words
        else:
            self.tree = None
            self.vocabulary = _rows(vocabulary, self.device, self.dtype)
            self.num_words = len(self.vocabulary)
        # Per-dimension median of the float32 centroids for binary signatures
        # (numpy's median: the mean of the middle two).
        thresholds = np.median(self.vocabulary.to(torch.float32).cpu().numpy(), axis=0)
        self.signature_thresholds = torch.as_tensor(thresholds, device=self.device)
        self._popcount = torch.tensor(_POPCOUNT, dtype=torch.uint8, device=self.device)
        self._bits = 2 ** torch.arange(8, device=self.device, dtype=torch.uint8)
        # Postings by add() call: (words, image ids, signatures).
        self._added: List[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = []
        self._postings: Optional[_Postings] = None
        # image_id -> (distinct words, their counts), int64.
        self.image_word_counts: Dict[int, Tuple[torch.Tensor, torch.Tensor]] = {}
        # image_id -> (word ids (N,), keypoint geometries (N, 4)), numpy.
        self.image_geometries: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
        self.num_images = 0

    @staticmethod
    def create(descriptors, num_words: int = 1024, device=None, **kw) -> "VisualIndex":
        return VisualIndex(build_vocabulary(descriptors, num_words, device=device, **kw),
                           device=device)

    @staticmethod
    def create_tree(descriptors, branching: int = 10, depth: int = 4, device=None,
                    **kw) -> "VisualIndex":
        """Hierarchical index (branching**depth effective words)."""
        return VisualIndex(build_vocabulary_tree(descriptors, branching, depth, device=device,
                                                 **kw), device=device)

    def _desc(self, descriptors) -> torch.Tensor:
        return _rows(descriptors, self.device, self.dtype)

    def _assign(self, desc: torch.Tensor) -> torch.Tensor:
        """Word ids (int32) of desc on the index's device."""
        if self.tree is not None:
            return self.tree.assign(desc)
        return R.assign(desc, self.vocabulary)

    def _signatures(self, desc: torch.Tensor) -> torch.Tensor:
        """64-bit binary signatures (reference: Hamming embedding): bit j is
        float32(desc[:, j]) > threshold[j], j < 64, stored little-endian as
        eight uint8 bytes a row."""
        bits = desc[:, :64].to(torch.float32) > self.signature_thresholds[:64]
        return (bits.view(-1, 8, 8).to(torch.uint8) * self._bits).sum(2, dtype=torch.uint8)

    def add(self, image_id: int, descriptors, keypoints: Optional[np.ndarray] = None):
        """Index an image. ``keypoints`` (N, >=4) with (x, y, scale,
        orientation) enables spatial verification at query time
        (reference: VisualIndex::Add with geometries)."""
        desc = self._desc(descriptors)
        if len(desc) == 0:
            return
        words = self._assign(desc).long()
        self._added.append((words, torch.full_like(words, int(image_id)), self._signatures(desc)))
        self._postings = None
        self.image_word_counts[image_id] = torch.unique(words, return_counts=True)
        if keypoints is not None:
            from colmap_tpu_torch.feature.keypoints import keypoints_to_xyso

            kp = keypoints_to_xyso(np.asarray(keypoints, dtype=np.float32))
            self.image_geometries[image_id] = (words.cpu().numpy(), kp)
        self.num_images += 1

    def postings(self) -> _Postings:
        """The inverted file in CSR order, rebuilt after an add()."""
        if self._postings is None:
            words, image, sig = (torch.cat(t) for t in zip(*self._added))
            order = torch.argsort(words, stable=True)
            words, image, sig = words[order], image[order], sig[order]
            counts = torch.bincount(words, minlength=self.num_words)
            offsets = torch.zeros(self.num_words + 1, dtype=torch.long, device=self.device)
            offsets[1:] = torch.cumsum(counts, 0)
            image_ids, slot = torch.unique(image, return_inverse=True)
            # Document frequency: distinct images among each word's postings.
            pairs = torch.unique(words * len(image_ids) + slot)
            df = torch.bincount(pairs // len(image_ids), minlength=self.num_words)
            dfs, level = torch.unique(df.clamp(min=1), return_inverse=True)
            level_idf = torch.log(max(self.num_images, 1) / dfs.double()) + 1e-6
            self._postings = _Postings(offsets, counts, level, level_idf, image, slot, sig,
                                       image_ids)
        return self._postings

    def query(
        self, descriptors, num_images: int = 10, hamming_threshold: int = 24,
        exclude_image_id: Optional[int] = None,
    ) -> List[QueryResult]:
        """TF-IDF vote with Hamming-filtered matches: each query descriptor
        votes the idf of its word for every posting of that word within
        ``hamming_threshold`` bits. Ranked by score, ties in the order in
        which the images first got a vote (query descriptor, then posting).
        colmap_tpu adds the votes one by one in that order; here each
        image's votes are counted by idf value, and the scores agree within
        ~1e-15 relative."""
        desc = self._desc(descriptors)
        if len(desc) == 0 or self.num_images == 0:
            return []
        words = self._assign(desc).long()
        sigs = self._signatures(desc)
        P = self.postings()
        cnt = P.counts[words]
        total = int(cnt.sum())
        if total == 0:
            return []
        # Every (query descriptor, posting of its word) in loop order.
        qi = torch.repeat_interleave(torch.arange(len(words), device=self.device), cnt)
        first = torch.cumsum(cnt, 0) - cnt
        pos = P.offsets[words][qi] + torch.arange(total, device=self.device) - first[qi]
        ham = self._popcount[(sigs[qi] ^ P.sig[pos]).long()].sum(1)
        keep = ham <= hamming_threshold
        if exclude_image_id is not None:
            keep &= P.image[pos] != exclude_image_id
        hits = torch.nonzero(keep).squeeze(1)
        if len(hits) == 0:
            return []
        slot = P.slot[pos[hits]]
        # Each image's score: Σ over the idf values of (its votes of that
        # value, an exact count) x idf, added in a fixed tree. No atomics:
        # images with as many votes of each value (a duplicate photo) tie
        # exactly on every device and run, as colmap_tpu's sums of the same
        # values tie.
        L = len(P.level_idf)
        pair, votes = torch.unique(slot * L + P.level[words[qi[hits]]], return_counts=True)
        voted, per = torch.unique_consecutive(pair // L, return_counts=True)
        scores = torch.zeros(len(P.image_ids), dtype=torch.float64, device=self.device)
        scores[voted] = _run_sums(votes * P.level_idf[pair % L], per)
        first_vote = torch.full_like(P.image_ids, total).scatter_reduce_(0, slot, hits, "amin")
        voted = voted[torch.argsort(first_vote[voted])]
        ranked = voted[torch.argsort(-scores[voted], stable=True)][:num_images]
        ids = P.image_ids[ranked].tolist()
        return [QueryResult(int(i), float(s)) for i, s in zip(ids, scores[ranked].tolist())]

    def query_with_verification(
        self, descriptors, keypoints: np.ndarray, num_images: int = 10,
        num_verifications: int = 20, exclude_image_id: Optional[int] = None,
    ) -> List[QueryResult]:
        """TF-IDF retrieval + vote-and-verify spatial re-ranking of the top
        candidates (reference: VisualIndex::Query spatial verification via
        retrieval/vote_and_verify.cc; putative matches are features assigned
        to the same visual word, at most 4 a query feature)."""
        from colmap_tpu_torch.feature.keypoints import keypoints_to_xyso
        from colmap_tpu_torch.retrieval.vote_and_verify import vote_and_verify

        prelim = self.query(descriptors, num_images=max(num_images, num_verifications),
                            exclude_image_id=exclude_image_id)
        if not prelim:
            return []
        words_q = self._assign(self._desc(descriptors)).long().cpu().numpy()
        kp_q = keypoints_to_xyso(np.asarray(keypoints, dtype=np.float32))

        verified = []
        for res in prelim[:num_verifications]:
            geo = self.image_geometries.get(res.image_id)
            if geo is None:
                verified.append((res, 0))
                continue
            words_db, kp_db = geo
            order_db = np.argsort(words_db, kind="stable")
            sorted_words = words_db[order_db]
            starts = np.searchsorted(sorted_words, words_q, side="left")
            cnt = np.minimum(np.searchsorted(sorted_words, words_q, side="right") - starts, 4)
            qi = np.repeat(np.arange(len(words_q)), cnt)
            j = starts[qi] + np.arange(len(qi)) - (np.cumsum(cnt) - cnt)[qi]
            if len(qi) < 3:
                verified.append((res, 0))
                continue
            verified.append((res, vote_and_verify(kp_q[qi], kp_db[order_db[j]])))
        verified.sort(key=lambda rs: (-rs[1], -rs[0].score))
        return [
            QueryResult(r.image_id, float(s if s > 0 else r.score))
            for (r, s) in verified[:num_images]
        ]


def default_vocab_tree_path() -> str:
    """Path of the shipped small vocabulary tree (8^3 = 512 words, trained
    on SIFT descriptors of rendered synthetic scenes), a byte copy of
    colmap_tpu's. The reference downloads pretrained trees at runtime
    (retrieval/resources.cc); without network access the small in-package
    tree is what a user gets without a tree of their own."""
    return os.path.normpath(os.path.join(os.path.dirname(__file__), "..", "data",
                                         "vocab_tree_small.npz"))


def load_vocab_tree(path: str, device=None) -> TreeVocabulary:
    """Load a vocabulary tree saved by the vocab_tree_builder command
    (level_<i> arrays in an .npz) onto ``device``."""
    device = resolve_device(device)
    data = np.load(path)
    n_levels = sum(1 for k in data.files if k.startswith("level_"))
    return TreeVocabulary([_rows(data[f"level_{i}"], device, floatx(device))
                           for i in range(n_levels)])


def bow_matrix(words, lengths: List[int], num_words: int) -> torch.Tensor:
    """rank_images_bow's (n_images, num_words) float32 W: image i's word
    histogram (its lengths[i] words, consecutive in ``words``), weighted by
    idf = log(n_images / images with the word) + 1e-6 (float32) and
    L2-normalized."""
    dev = words.device
    n_img = len(lengths)
    rows = torch.repeat_interleave(torch.arange(n_img, device=dev),
                                   torch.as_tensor(lengths, device=dev))
    W = torch.zeros(n_img * num_words, dtype=torch.float32, device=dev)
    W.index_add_(0, rows * num_words + words.long(), torch.ones(len(words), device=dev))
    W = W.view(n_img, num_words)
    df = (W > 0).sum(0).clamp(min=1)
    W *= torch.log(max(n_img, 1) / df.double()).to(torch.float32)[None, :] + 1e-6
    W /= torch.linalg.vector_norm(W, dim=1, keepdim=True).clamp(min=1e-12)
    return W


def rank_images_bow(
    descs_by_image: Dict[int, np.ndarray],
    vocabulary,
    num_neighbors: int = 10,
    device=None,
) -> Dict[int, List[QueryResult]]:
    """All-vs-all TF-IDF bag-of-words retrieval (reference scoring model:
    retrieval/vote_and_verify.cc TF-IDF ranking; Nister-Stewenius BoW):
    quantize every image's descriptors to words (K30, or K28 for a flat
    vocabulary), build the (n_images, num_words) idf-weighted L2-normalized
    float32 histogram matrix W (``bow_matrix``), score all pairs as S = W Wᵀ
    (K31) and keep each row's top ``num_neighbors``.

    Returns {image_id: [QueryResult ranked]}.
    """
    index = (vocabulary if isinstance(vocabulary, VisualIndex)
             else VisualIndex(vocabulary, device=device))
    ids = sorted(descs_by_image.keys())
    n_img = len(ids)
    lens = [len(descs_by_image[iid]) for iid in ids]
    if not any(lens):
        return {iid: [] for iid in ids}
    desc = index._desc(np.concatenate([np.asarray(descs_by_image[iid]) for iid in ids if
                                       len(descs_by_image[iid])]))
    S = R.gram(bow_matrix(index._assign(desc), lens, index.num_words))
    S.fill_diagonal_(-float("inf"))
    k = min(num_neighbors, n_img - 1)
    if k <= 0:
        return {iid: [] for iid in ids}
    vals, cand = (t.cpu().tolist() for t in torch.topk(S, k, dim=1))
    return {
        iid: [QueryResult(ids[c], v) for c, v in zip(cand[row], vals[row]) if np.isfinite(v)]
        for row, iid in enumerate(ids)
    }


def vocab_tree_pairs(
    descriptors_by_image: Dict[int, np.ndarray],
    num_words: int = 256,
    num_neighbors: int = 5,
    seed: int = 0,
    device=None,
) -> List[Tuple[int, int]]:
    """Vocab-tree pair generation (reference: VocabTreePairGenerator,
    controllers/pairing.h:54-84): index all images, query each for its
    nearest neighbors (over 50 images: rank_images_bow)."""
    from colmap_tpu_torch.utils.types import image_pair_to_pair_id

    all_desc = np.concatenate([d for d in descriptors_by_image.values() if len(d)])
    # Subsample for vocabulary training.
    rng = np.random.default_rng(seed)
    sub = all_desc[rng.choice(len(all_desc), min(len(all_desc), 20000), replace=False)]
    index = VisualIndex.create(sub, num_words=num_words, seed=seed, device=device)

    pairs = set()
    out = []

    def keep(iid, results):
        for r in results:
            key = image_pair_to_pair_id(iid, r.image_id)
            if key not in pairs:
                pairs.add(key)
                out.append((min(iid, r.image_id), max(iid, r.image_id)))

    if len(descriptors_by_image) > 50:
        for iid, results in rank_images_bow(descriptors_by_image, index,
                                            num_neighbors=num_neighbors).items():
            keep(iid, results)
        return out
    for iid, desc in descriptors_by_image.items():
        index.add(iid, desc)
    for iid, desc in descriptors_by_image.items():
        keep(iid, index.query(desc, num_neighbors, exclude_image_id=iid))
    return out
