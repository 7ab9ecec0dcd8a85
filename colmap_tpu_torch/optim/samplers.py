"""Samplers for the hypothesis-batch RANSAC harness.

Counterpart of colmap_tpu/optim/samplers.py (reference behavior:
src/colmap/optim/{random,progressive,combination}_sampler.*). The random and
progressive (PROSAC) strategies live in optim/ransac.py
(``RansacOptions.sampling``); this module is the CombinationSampler: every
C(n, m) minimal sample, for sample spaces small enough to cover whole.
Host numpy; no device code.
"""

from __future__ import annotations

from itertools import combinations
from math import comb

import numpy as np


def all_combinations(n: int, m: int, max_count: int = 1 << 20) -> np.ndarray:
    """All C(n, m) index combinations as a (C, m) int32 array in
    lexicographic order; raises ValueError above ``max_count``."""
    count = comb(n, m)
    if count > max_count:
        raise ValueError(
            f"C({n},{m}) = {count} exceeds max_count={max_count}; use random sampling instead")
    out = np.fromiter((i for c in combinations(range(n), m) for i in c), dtype=np.int32,
                      count=count * m)
    return out.reshape(count, m)


def shuffled_combinations(n: int, m: int, rng: np.random.Generator,
                          max_count: int = 1 << 20) -> np.ndarray:
    """All combinations in the order of one shuffle by ``rng`` (the
    reference sampler's shuffle-once order)."""
    combos = all_combinations(n, m, max_count)
    rng.shuffle(combos)
    return combos
