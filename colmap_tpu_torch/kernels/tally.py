"""Launch shapes: the sizes that set a kernel's work, counted beside
``LAUNCHES``, and the weighing of launches x (ms - bound) over them.

A kernel module that keeps a ``SHAPES`` tally adds its launches to the
entry (kernel, entry, *sizes) where it adds them to ``LAUNCHES``, and
nowhere else. ``utils/cuda_graph.py`` moves a recorded step's shapes to its
replays, as it moves the launches.

With ``sampling`` on, the first call of each shape class (``shape_class``:
every size rounded up to a power of two) outside a CUDA graph's capture
also keeps its wrapper and arguments, so that the kernel can be timed
again at that class later (chip_smoke.py's weighing). The arguments are
held alive until ``reset_samples``.
"""

from __future__ import annotations

import math
from collections import Counter, defaultdict


def shape_class(sizes) -> tuple:
    """Each size rounded up to a power of two (0 and 1 stay)."""
    return tuple(int(s) if s <= 1 else 1 << (int(s) - 1).bit_length() for s in sizes)


class ShapeTally:
    def __init__(self):
        self.counts = Counter()  # (kernel, entry, *sizes) -> launches
        # (kernel, entry, *shape_class) -> (sizes, fn, args, launches a call)
        self.samples = {}
        self.sampling = False

    def add(self, kernel: str, entry: str, sizes, fn=None, args=(), launches: int = 1):
        """Count ``launches`` launches of ``kernel`` at ``sizes``; while
        sampling, keep fn(*args) as the class's call if it has none."""
        sizes = tuple(int(s) for s in sizes)
        self.counts[(kernel, entry, *sizes)] += launches
        if not self.sampling or fn is None:
            return
        key = (kernel, entry, *shape_class(sizes))
        if key in self.samples:
            return
        import torch

        if not (torch.cuda.is_available() and torch.cuda.is_current_stream_capturing()):
            self.samples[key] = (sizes, fn, tuple(args), launches)

    def reset(self):
        self.counts.clear()

    def reset_samples(self):
        self.samples.clear()


def pair_sizes(x1, samples=None) -> tuple:
    """(pairs B, rows N, samples K) of a two-view RANSAC entry: x1 (N, d)
    or a block (B, N, d), samples (K, m) or (B, K, m); K is 0 without
    samples."""
    return (x1.shape[0] if x1.dim() == 3 else 1, x1.shape[-2],
            0 if samples is None else samples.shape[-2])


def by_class(counts) -> dict:
    """{kernel: Counter((entry, *shape_class) -> launches)} of a tally's
    counts."""
    out = defaultdict(Counter)
    for (kernel, entry, *sizes), n in counts.items():
        if n:
            out[kernel][(entry, *shape_class(sizes))] += n
    return dict(out)


def classes_to_time(counts, share: float) -> list:
    """The (kernel, entry, *shape_class) that hold at least ``share`` of
    their kernel's launches (all of a kernel's classes where none does),
    by kernel, most launches first."""
    keys = []
    for kernel, cls in by_class(counts).items():
        total = sum(cls.values())
        heavy = [((kernel, *c), n) for c, n in cls.items() if n >= share * total]
        keys += heavy or [((kernel, *c), n) for c, n in cls.items()]
    return [k for k, _ in sorted(keys, key=lambda kn: (kn[0][0], -kn[1], kn[0]))]


def _distance(a: tuple, b: tuple) -> float:
    """How far shape class b lies from a (both (entry, *sizes)): the sum of
    the sizes' log2 ratios, 64 more for another entry, sizes beyond the
    shorter one left out."""
    d = sum(abs(math.log2(x + 1) - math.log2(y + 1)) for x, y in zip(a[1:], b[1:]))
    return d + (0.0 if a[0] == b[0] else 64.0)


def weigh(counts, timed: dict, share: float) -> dict:
    """Launches x (ms - bound) by kernel over the shape classes of
    ``counts``. ``timed`` maps (kernel, entry, *shape_class) to (ms a
    launch, bound ms) for the classes that were timed (those of
    ``classes_to_time``); every other class is charged at its kernel's
    timed class nearest in size (``_distance``). Returns {kernel: {"weight_ms",
    "launches", "rows": [{entry, shape, launches, ms, bound_ms,
    charged_at}]}}, a kernel without a timed class with weight None."""
    out = {}
    for kernel, cls in by_class(counts).items():
        mine = {k[1:]: v for k, v in timed.items() if k[0] == kernel}
        rows, weight = [], 0.0
        for c, n in sorted(cls.items(), key=lambda cn: -cn[1]):
            at = c if c in mine else (min(mine, key=lambda t: (_distance(c, t), t))
                                      if mine else None)
            ms, b = mine[at] if at is not None else (None, None)
            rows.append(dict(entry=c[0], shape=list(c[1:]), launches=n, ms=ms, bound_ms=b,
                             charged_at=None if at is None or at == c else [at[0], *at[1:]]))
            if at is not None:
                weight += n * (ms - b)
        out[kernel] = dict(weight_ms=weight if mine else None, launches=sum(cls.values()),
                           share=share, rows=rows)
    return out
