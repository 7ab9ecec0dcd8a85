"""Matching pipelines: database features -> matches -> two-view geometries.

Counterpart of the matching half of colmap_tpu/controllers/feature_pipeline.py
(reference behavior: src/colmap/controllers/feature_matching.cc: pair blocks
-> matcher workers -> verifier pool -> database). Pairs stream in blocks of
256: each block is one call of the matcher kernel K10 over the block's
descriptor table, then blocks of up to 64 pairs through the E, F and H
RANSAC kernels (estimators/two_view_batch.py), and the results go to the
SQLite database. Descriptors live on the device only for their block.
Feature extraction is not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from colmap_tpu_torch.estimators.two_view_batch import estimate_two_view_geometries_batched
from colmap_tpu_torch.estimators.two_view_geometry import (
    TwoViewGeometryOptions,
    estimate_two_view_geometry,
)
from colmap_tpu_torch.feature.matcher import MatchingOptions, match_guided, match_pairs_batched
from colmap_tpu_torch.feature.pairing import (
    ExhaustivePairingOptions,
    SequentialPairingOptions,
    exhaustive_pairs,
    sequential_pairs,
)
from colmap_tpu_torch.scene.database import Database
from colmap_tpu_torch.utils.dtypes import resolve_device


@dataclasses.dataclass
class MatchingPipelineOptions:
    matching: MatchingOptions = dataclasses.field(default_factory=MatchingOptions)
    verification: TwoViewGeometryOptions = dataclasses.field(
        default_factory=TwoViewGeometryOptions)
    min_num_inliers: int = 15
    # Match again with the verified epipolar geometry as a constraint
    # (guided matching, controllers/feature_matching_utils.h:133).
    guided_matching: bool = False
    # "bruteforce"; "lightglue" is not ported yet.
    matcher_type: str = "bruteforce"
    lightglue_weights_path: Optional[str] = None
    lightglue_options: Optional[object] = None


def _require_bruteforce(options: MatchingPipelineOptions):
    if options.matcher_type != "bruteforce":
        raise NotImplementedError(
            f"matcher_type {options.matcher_type!r} is not ported yet (ROADMAP queue 2)")


def _match_and_verify_pairs(
    database: Database,
    pairs: Sequence[Tuple[int, int]],
    options: MatchingPipelineOptions,
    block_pairs: int = 256,
    device=None,
) -> int:
    """Match and verify a pair list block by block on ``device``; writes
    matches and two-view geometries, returns the number of verified pairs."""
    _require_bruteforce(options)
    device = resolve_device(device)
    cameras = database.read_cameras()
    images = {iid: (name, cid) for (iid, name, cid) in database.read_images()}
    kp_cache: Dict[int, np.ndarray] = {}

    def get_kp(iid):
        if iid not in kp_cache:
            kp_cache[iid] = database.read_keypoints(iid)[:, :2]
        return kp_cache[iid]

    pairs = list(pairs)
    n_verified = 0
    # Per-image normalized keypoints are kept across all blocks.
    normalized_cache: Dict[tuple, np.ndarray] = {}
    for blk_start in range(0, len(pairs), block_pairs):
        block = pairs[blk_start:blk_start + block_pairs]
        block_ids = sorted({i for p in block for i in p})
        descs = {iid: database.read_descriptors(iid) for iid in block_ids}
        local = {iid: k for k, iid in enumerate(block_ids)}
        pair_idxs = np.asarray([(local[a], local[b]) for (a, b) in block], dtype=np.int64)
        match_lists = match_pairs_batched([descs[iid] for iid in block_ids], pair_idxs,
                                          options.matching, device)

        items, verify_slots = [], []
        for k, (id1, id2) in enumerate(block):
            matches = match_lists[k]
            database.write_matches(id1, id2, matches)
            if len(matches) < options.min_num_inliers:
                continue
            items.append((cameras[images[id1][1]], get_kp(id1), cameras[images[id2][1]],
                          get_kp(id2), matches))
            verify_slots.append(k)

        geoms = estimate_two_view_geometries_batched(
            items, options.verification, normalized_cache=normalized_cache, device=device)

        for slot, g, item in zip(verify_slots, geoms, items):
            id1, id2 = block[slot]
            cam1, kp1, cam2, kp2, _ = item
            if options.guided_matching and g.F is not None and len(g.inlier_matches) > 0:
                guided = match_guided(descs[id1], descs[id2], kp1, kp2, g.F, options.matching,
                                      device)
                if len(guided) > len(g.inlier_matches):
                    g2 = estimate_two_view_geometry(cam1, kp1, cam2, kp2, guided,
                                                    options.verification, device=device)
                    if len(g2.inlier_matches) > len(g.inlier_matches):
                        g = g2
            if len(g.inlier_matches) >= options.min_num_inliers:
                database.write_two_view_geometry(id1, id2, g)
                n_verified += 1
    database.commit()
    return n_verified


def run_exhaustive_matching(
    database: Database,
    options: Optional[MatchingPipelineOptions] = None,
    pairing: Optional[ExhaustivePairingOptions] = None,
    device=None,
) -> int:
    """reference behavior: CreateExhaustiveFeatureMatcher
    (controllers/feature_matching.cc:330)."""
    options = options or MatchingPipelineOptions()
    _require_bruteforce(options)
    image_ids = [iid for (iid, _, _) in database.read_images()]
    n = 0
    for block in exhaustive_pairs(image_ids, pairing or ExhaustivePairingOptions()):
        n += _match_and_verify_pairs(database, block, options, device=device)
    return n


def run_sequential_matching(
    database: Database,
    options: Optional[MatchingPipelineOptions] = None,
    pairing: Optional[SequentialPairingOptions] = None,
    device=None,
) -> int:
    """reference behavior: CreateSequentialFeatureMatcher; the sequence is
    the images ordered by name."""
    rows = sorted(database.read_images(), key=lambda r: r[1])
    pairs = sequential_pairs([iid for (iid, _, _) in rows], pairing or SequentialPairingOptions())
    return _match_and_verify_pairs(database, pairs, options or MatchingPipelineOptions(),
                                   device=device)


def run_matches_import(
    database: Database,
    pairs: Sequence[Tuple[int, int]],
    options: Optional[MatchingPipelineOptions] = None,
    device=None,
) -> int:
    """reference behavior: the matches_importer path (match and verify the
    given pairs)."""
    return _match_and_verify_pairs(database, pairs, options or MatchingPipelineOptions(),
                                   device=device)
