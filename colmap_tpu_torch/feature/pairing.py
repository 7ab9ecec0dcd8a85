"""Pair generation strategies for matching.

Counterpart of colmap_tpu/feature/pairing.py (reference behavior:
src/colmap/controllers/pairing.h:43-410): exhaustive (blocked N²),
sequential (overlap window and quadratic expansion), spatial (position
kNN), transitive (two-hop expansion) and imported (file list) pairs. Host
code: pair generation is bookkeeping; the device does the matching.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, List, Sequence, Tuple

import numpy as np

from colmap_tpu_torch.scene.database import Database
from colmap_tpu_torch.utils.types import image_pair_to_pair_id


@dataclasses.dataclass
class ExhaustivePairingOptions:
    """reference: pairing.h:43-52."""

    block_size: int = 50


def exhaustive_pairs(
    image_ids: Sequence[int], options: ExhaustivePairingOptions = ExhaustivePairingOptions()
) -> Iterator[List[Tuple[int, int]]]:
    """Yield blocks of all N(N-1)/2 pairs (blocked iteration like the
    reference so match results can stream to the DB)."""
    ids = list(image_ids)
    n = len(ids)
    bs = options.block_size
    for start1 in range(0, n, bs):
        for start2 in range(start1, n, bs):
            block = []
            for i in range(start1, min(start1 + bs, n)):
                for j in range(start2, min(start2 + bs, n)):
                    if j > i:
                        block.append((ids[i], ids[j]))
            if block:
                yield block


@dataclasses.dataclass
class SequentialPairingOptions:
    """reference: pairing.h:86-158."""

    overlap: int = 10
    quadratic_overlap: bool = True
    loop_detection: bool = False
    loop_detection_period: int = 10
    loop_detection_num_images: int = 50


def sequential_pairs(
    image_ids: Sequence[int], options: SequentialPairingOptions = SequentialPairingOptions()
) -> List[Tuple[int, int]]:
    """Window pairs ordered by image name/id sequence; quadratic overlap adds
    pairs at power-of-two offsets."""
    ids = list(image_ids)
    pairs = []
    seen = set()

    def add(a, b):
        if a == b:
            return
        key = image_pair_to_pair_id(a, b)
        if key not in seen:
            seen.add(key)
            pairs.append((a, b))

    n = len(ids)
    for i in range(n):
        for d in range(1, options.overlap + 1):
            if i + d < n:
                add(ids[i], ids[i + d])
        if options.quadratic_overlap:
            d = 2
            while d <= 2 ** options.overlap:
                if i + d < n:
                    add(ids[i], ids[i + d])
                d *= 2
    return pairs


@dataclasses.dataclass
class SpatialPairingOptions:
    """reference: pairing.h:165-200."""

    max_num_neighbors: int = 50
    max_distance: float = 100.0
    ignore_z: bool = True


def spatial_pairs(
    image_ids: Sequence[int],
    positions: np.ndarray,
    options: SpatialPairingOptions = SpatialPairingOptions(),
) -> List[Tuple[int, int]]:
    """kNN pairs from prior positions (GPS/pose priors)."""
    ids = list(image_ids)
    pos = np.asarray(positions, dtype=np.float64)
    if options.ignore_z:
        pos = pos[:, :2]
    n = len(ids)
    pairs = []
    seen = set()
    d2 = np.sum((pos[:, None] - pos[None, :]) ** 2, axis=-1)
    np.fill_diagonal(d2, np.inf)
    max_d2 = options.max_distance**2
    for i in range(n):
        order = np.argsort(d2[i])[: options.max_num_neighbors]
        for j in order:
            if d2[i, j] > max_d2:
                break
            key = image_pair_to_pair_id(ids[i], int(ids[j]))
            if key not in seen:
                seen.add(key)
                pairs.append((ids[i], ids[int(j)]))
    return pairs


@dataclasses.dataclass
class TransitivePairingOptions:
    """reference: pairing.h:203-215."""

    batch_size: int = 1000
    num_iterations: int = 3


def transitive_pairs(
    database: Database, options: TransitivePairingOptions = TransitivePairingOptions()
) -> List[Tuple[int, int]]:
    """A->B, B->C => A->C expansion over existing matched pairs."""
    from colmap_tpu_torch.utils.types import pair_id_to_image_pair

    pairs = []
    existing = set()
    adj = {}
    for pair_id, m in database.read_all_matches():
        if len(m) == 0:
            continue
        a, b = pair_id_to_image_pair(pair_id)
        existing.add(pair_id)
        adj.setdefault(a, set()).add(b)
        adj.setdefault(b, set()).add(a)
    for _ in range(options.num_iterations):
        new_pairs = []
        for a, nbrs in adj.items():
            for b in nbrs:
                for c in adj.get(b, ()):
                    if c == a:
                        continue
                    key = image_pair_to_pair_id(a, c)
                    if key not in existing:
                        existing.add(key)
                        new_pairs.append((min(a, c), max(a, c)))
        if not new_pairs:
            break
        pairs.extend(new_pairs)
        for (a, c) in new_pairs:
            adj.setdefault(a, set()).add(c)
            adj.setdefault(c, set()).add(a)
        if len(pairs) >= options.batch_size * options.num_iterations:
            break
    return pairs


def imported_pairs(path: str, name_to_id: dict) -> List[Tuple[int, int]]:
    """Read 'name1 name2' lines (reference: ImportedPairGenerator)."""
    pairs = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            n1, n2 = line.split()
            if n1 in name_to_id and n2 in name_to_id:
                pairs.append((name_to_id[n1], name_to_id[n2]))
    return pairs
