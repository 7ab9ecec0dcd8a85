"""Retrieval kernels: wrappers, plain PyTorch versions, launch counts.

Four CUDA kernels carry the device programs of image retrieval (sources in
``colmap_tpu_torch/csrc``):

    K28 retrieval_assign   nearest centroid of each row within its group
                           (a flat vocabulary, or a tree node's children)
    K29 retrieval_update   the k-means update: each segment's mean and count
    K30 retrieval_descend  vocabulary-tree descent to a leaf word
    K31 retrieval_gram     S = W Wᵀ, the all-pairs bag-of-words similarity

Each wrapper runs the plain version when its tensors lie on the CPU and
launches the kernel when they lie on a CUDA device; on a CUDA tensor it
launches or raises, it never falls back. ``LAUNCHES`` counts kernel launches
by kernel name (a wrapper adds one where it launches, nowhere else).

The plain versions compute in float64 whatever their inputs' type, so that
they are the reference the float32 kernels are held against: distances as
|x|² - 2 x·c + |c|² (in float64 that form is exact to ~1e-9 on uint8-valued
rows, where float32 would lose whole units), segment sums with
``index_add_``, S as a float64 product. ``nearest64`` and ``descend64``
also mark near-ties: rows whose best two float64 distances lie within
``NEAR_TIE`` of the best, where float32 may rightly choose the other one;
``excess64`` and ``descend_excess64`` measure how far beyond the nearest
the kernels' choices lie.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Optional

import torch

from colmap_tpu_torch.kernels import sfm as S
from colmap_tpu_torch.kernels.tally import ShapeTally

LAUNCHES = {"retrieval_assign": 0, "retrieval_update": 0, "retrieval_descend": 0,
            "retrieval_gram": 0}
# Launch shapes of the kernels above, counted where LAUNCHES is (kernels/tally.py).
SHAPES = ShapeTally()
# K30's calls and rows by regime (``_descend_plan``), counted beside LAUNCHES.
DESCEND_CALLS = {"direct": 0, "sorted": 0}
DESCEND_ROWS = {"direct": 0, "sorted": 0}

f32, f64, i32 = torch.float32, torch.float64, torch.int32

# Relative gap between the best two distances under which a row is a near-tie.
NEAR_TIE = 1e-5
# Elements of one float64 block of the plain versions (256 MB).
_PLAIN_BLOCK = 1 << 25
# K31's sparse sums stay below 2^GRAM_BITS (retrieval_gram.cu kSparseBound).
GRAM_BITS = 61


# K30's regimes (retrieval_descend.cu). From DESCEND_SORTED_MIN_ROWS rows on
# the levels are descended in sorted passes, below it a warp a row reads the
# children from L2. chip_smoke.py's retrieval_kernels phase times both
# (``_descend_run``) at row counts around this threshold; on an H100
# through 8^5 they cross between 131 072 and 196 608 rows (PERF.md, row 15c).
# A pass stages its node's subtree in at most DESCEND_SMEM_BUDGET bytes of
# shared memory (a third of an H100 SM's 233 472, less 1 KB a block the
# card keeps, so that three blocks share an SM) and buckets rows into at
# most DESCEND_MAX_GROUPS nodes; trees beyond either descend directly.
DESCEND_SORTED_MIN_ROWS = 150000
DESCEND_SMEM_BUDGET = 75776
DESCEND_MAX_GROUPS = 1 << 20


class DescendPlan(NamedTuple):
    regime: str  # "direct", "sorted", or "none" (no rows or no levels: no launch)
    passes: tuple  # (first level, stop level) of each pass
    smem_bytes: int  # shared memory of a sorted pass's block (its first, largest pass)
    launches: int  # CUDA launches a call makes, a memset counted as one


def _pass_smem(branching: int, k: int, dim: int) -> int:
    """Shared bytes of a sorted pass of k levels (retrieval_descend.cu
    pass_smem): the subtree's B + ... + B^k rows, 16 bytes of padding after
    each node's B rows, then B^k node counts."""
    nodes = [branching ** m for m in range(k)]
    return sum(n * (branching * dim * 4 + 16) for n in nodes) + branching ** k * 4


def _descend_plan(n: int, branching: int, depth: int, dim: int) -> DescendPlan:
    """K30's regime for n rows of dim through a tree of branching^depth
    leaves, from the shapes alone: "sorted" from DESCEND_SORTED_MIN_ROWS
    rows on, in passes of the most levels whose subtree fits
    DESCEND_SMEM_BUDGET; "direct" below, or where no pass fits or a pass
    would bucket more than DESCEND_MAX_GROUPS nodes. Sorted passes after
    the first bucket the rows by node: a scan and a scatter each, and one
    memset of the counts for all of them."""
    if n == 0 or depth == 0:
        return DescendPlan("none", (), 0, 0)
    direct = DescendPlan("direct", ((0, depth),), 0, 1)
    if n < DESCEND_SORTED_MIN_ROWS or _pass_smem(branching, 1, dim) > DESCEND_SMEM_BUDGET:
        return direct
    k = 1
    while k < depth and _pass_smem(branching, k + 1, dim) <= DESCEND_SMEM_BUDGET:
        k += 1
    passes = tuple((l0, min(depth, l0 + k)) for l0 in range(0, depth, k))
    if any(branching ** l0 > DESCEND_MAX_GROUPS for l0, _ in passes):
        return direct
    later = len(passes) - 1
    return DescendPlan("sorted", passes, _pass_smem(branching, k, dim),
                       1 + 3 * later + (1 if later else 0))


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    SHAPES.reset()
    for counts in (DESCEND_CALLS, DESCEND_ROWS):
        for k in counts:
            counts[k] = 0


def _best_two(d2):
    """(argmin int32, the first on ties as jnp.argmin; near-tie mask) of each
    row of d2 (R, G)."""
    best, idx = torch.min(d2, dim=1)
    second = d2.scatter(1, idx[:, None], float("inf")).amin(dim=1)
    return idx.to(i32), second - best < NEAR_TIE * best


def _distances(x, c, groups, G):
    """Blocks (s, d2) of the float64 squared distances d2 (rows s:s + len(d2),
    G) of x's rows to their candidates: c[g G : g G + G], g = groups[i],
    or all of c without groups."""
    x2 = (x * x).sum(1)
    c2 = (c * c).sum(1)
    step = max(1, _PLAIN_BLOCK // (G if groups is None else G * x.shape[1]))
    for s in range(0, x.shape[0], step):
        xs = x[s:s + step]
        if groups is None:
            yield s, x2[s:s + step, None] - 2.0 * xs @ c.T + c2[None, :]
        else:
            rows = groups[s:s + step].long()[:, None] * G + torch.arange(G, device=x.device)
            yield s, (x2[s:s + step, None] - 2.0 * torch.einsum("nd,ngd->ng", xs, c[rows])
                      + c2[rows])


def nearest64(x, cents, groups=None, group_size: Optional[int] = None):
    """K28's function in float64: (index in [0, G) int32, near-tie mask).
    Row i's candidates are cents[g G : g G + G] with g = groups[i], or all
    of cents without groups."""
    x = x.to(f64)
    n = x.shape[0]
    G = cents.shape[0] if groups is None else int(group_size)
    out = (torch.empty(n, dtype=i32, device=x.device),
           torch.empty(n, dtype=torch.bool, device=x.device))
    for s, d2 in _distances(x, cents.to(f64), groups, G):
        for o, v in zip(out, _best_two(d2)):
            o[s:s + len(d2)] = v
    return out


def excess64(x, cents, chosen, groups=None, group_size: Optional[int] = None):
    """How far a chosen centroid (int32 index in [0, G) a row, K28's
    output) lies beyond the nearest, in float64: (d(chosen) - d(best),
    that over d(best)) a row, 0 where the chosen one is a nearest. At most
    NEAR_TIE relative where K28 may rightly differ from nearest64."""
    x = x.to(f64)
    G = cents.shape[0] if groups is None else int(group_size)
    ex = torch.empty(x.shape[0], dtype=f64, device=x.device)
    rel = torch.empty_like(ex)
    for s, d2 in _distances(x, cents.to(f64), groups, G):
        best = d2.amin(1)
        e = d2.gather(1, chosen[s:s + len(d2)].long()[:, None])[:, 0] - best
        ex[s:s + len(d2)] = e
        rel[s:s + len(d2)] = torch.where(e > 0, e / best.abs(), 0.0)
    return ex, rel


def assign_plain(x, cents, groups=None, group_size: Optional[int] = None):
    """K28's plain version: the nearest centroid's index (int32)."""
    return nearest64(x, cents, groups, group_size)[0]


def update_plain(x, segments, cents):
    """K29's plain version: (new centroids in cents' dtype, counts int32).
    new[s] = mean of the rows with segments == s, or cents[s] if there are
    none."""
    seg = segments.long()
    sums = torch.zeros(cents.shape, dtype=f64, device=x.device).index_add_(0, seg, x.to(f64))
    counts = torch.bincount(seg, minlength=cents.shape[0])
    new = torch.where(counts[:, None] > 0, sums / counts.clamp(min=1)[:, None], cents.to(f64))
    return new.to(cents.dtype), counts.to(i32)


def _level_rows(branching: int, depth: int):
    """(first row, rows) of each level in the concatenated levels."""
    sizes = [branching ** (level + 1) for level in range(depth)]
    return [(sum(sizes[:level]), size) for level, size in enumerate(sizes)]


def descend64(x, levels, branching: int, depth: int):
    """K30's function in float64: (leaf ids int32, near-tie mask: a near-tie
    at any level). ``levels`` is the (Σ_l B^(l+1), D) concatenation of the
    tree's levels."""
    x = x.to(f64)
    node = torch.zeros(x.shape[0], dtype=i32, device=x.device)
    near = torch.zeros(x.shape[0], dtype=torch.bool, device=x.device)
    for first, rows in _level_rows(branching, depth):
        child, tie = nearest64(x, levels[first:first + rows], node, branching)
        node = node * branching + child
        near |= tie
    return node, near


def descend_excess64(x, levels, branching: int, depth: int, leaves):
    """excess64 of the child that ``leaves`` (K30's output) took at each
    level, among its own node's children, in float64; the largest over the
    levels a row."""
    x = x.to(f64)
    leaves = leaves.long()
    ex = torch.zeros(x.shape[0], dtype=f64, device=x.device)
    rel = torch.zeros_like(ex)
    for level, (first, rows) in enumerate(_level_rows(branching, depth)):
        node = leaves // branching ** (depth - level)
        child = leaves // branching ** (depth - level - 1) % branching
        e, r = excess64(x, levels[first:first + rows], child, node, branching)
        ex, rel = torch.maximum(ex, e), torch.maximum(rel, r)
    return ex, rel


def descend_plain(x, levels, branching: int, depth: int):
    """K30's plain version: leaf ids (int32)."""
    return descend64(x, levels, branching, depth)[0]


def gram_plain(w):
    """K31's plain version: S = W Wᵀ of W (n, K), in float64, returned in
    W's dtype."""
    w64 = w.to(f64)
    return (w64 @ w64.T).to(w.dtype)


def gram_scale_exponent(w) -> int:
    """F of K31's sparse path: the largest with r m² 2^F < 2^GRAM_BITS,
    m = max |w| and r the most nonzeros of a row (|S[i, j]| <= r m²); 0
    for a zero W."""
    if w.numel() == 0:
        return 0
    m = float(w.abs().max())
    bound = float(int((w != 0).sum(1).max())) * m * m
    return GRAM_BITS - math.frexp(bound)[1] if bound > 0 else 0


def gram_fixed_plain(w):
    """K31's arithmetic on the card's sparse path, in PyTorch, for the CPU
    tests (the card path does not use it): each product w_ik w_jk, exact in
    float64, scaled by 2^F (gram_scale_exponent), rounded to an integer
    (half to even) and summed as integers; S = the sum times 2^-F in W's
    dtype."""
    F = gram_scale_exponent(w)
    w64, scale = w.to(f64), math.ldexp(1.0, F)
    n, K = w.shape
    acc = torch.zeros((n, n), dtype=torch.int64, device=w.device)
    rows = max(1, _PLAIN_BLOCK // max(n * K, 1))
    for i0 in range(0, n, rows):
        prod = w64[i0:i0 + rows, None, :] * w64[None, :, :] * scale
        acc[i0:i0 + rows] = torch.round(prod).to(torch.int64).sum(-1)
    return (acc.to(f64) * math.ldexp(1.0, -F)).to(w.dtype)


def csr(segments, num_segments: int):
    """(order, offsets) int32 of a stable sort by segment, on its device:
    the rows of segment s are order[offsets[s]:offsets[s + 1]]."""
    seg = segments.long()
    order = torch.argsort(seg, stable=True)
    offsets = torch.zeros(num_segments + 1, dtype=torch.long, device=seg.device)
    offsets[1:] = torch.cumsum(torch.bincount(seg, minlength=num_segments), 0)
    return order.to(i32), offsets.to(i32)


# ---------------------------------------------------------------------------
# CUDA wrappers.
# ---------------------------------------------------------------------------

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "retrieval_assign_f32": [_I, _I, _I] + [_P] * 5,
    "retrieval_update_f32": [_I, _I] + [_P] * 7,
    "retrieval_descend_f32": [_I] * 5 + [_P] * 5,
    "retrieval_gram_f32": [_I, _I] + [_P] * 4,
}


@functools.cache
def _lib():
    from colmap_tpu_torch.kernels.build import library

    lib = library()
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.retrieval_gram_workspace_bytes.argtypes = [_I, _I]
    lib.retrieval_gram_workspace_bytes.restype = ctypes.c_longlong
    lib.retrieval_descend_workspace_bytes.argtypes = [_I] * 4
    lib.retrieval_descend_workspace_bytes.restype = ctypes.c_longlong
    return lib


def _call(fn_name, *args):
    err = getattr(_lib(), fn_name)(*args)
    if err != 0:
        raise RuntimeError(f"{fn_name} failed to launch: CUDA error {err}")


def _rows(x):
    """Device and D of a float32 (N, D) row tensor the kernels take."""
    dev = S._require_cuda(x)
    if x.dim() != 2:
        raise ValueError(f"rows must be (N, D), got {tuple(x.shape)}")
    D = x.shape[1]
    if D % 4 or not 0 < D <= 128:
        raise NotImplementedError(f"the retrieval kernels take 4 <= D <= 128, D % 4 == 0; got {D}")
    S._check("x", x, f32, x.shape, dev)
    return dev, D


def assign(x, cents, groups=None, group_size: Optional[int] = None):
    """K28: for each row of x (N, D), the index in [0, G) of its nearest
    centroid among cents[g G : g G + G], g = groups[i] (int32), or among all
    of cents without groups; int32. See nearest64 for the function."""
    if x.device.type == "cpu":
        return assign_plain(x, cents, groups, group_size)
    dev, D = _rows(x)
    N = x.shape[0]
    G = cents.shape[0] if groups is None else int(group_size)
    S._check("cents", cents, f32, (cents.shape[0], D), dev)
    if groups is not None:
        S._check("groups", groups, i32, (N,), dev)
        if cents.shape[0] % G:
            raise ValueError(f"{cents.shape[0]} centroids are not groups of {G}")
    out = torch.empty(N, dtype=i32, device=dev)
    _call("retrieval_assign_f32", N, D, G, S._ptr(x), S._ptr(cents),
          S._P(0) if groups is None else S._ptr(groups), S._ptr(out), S._stream(dev))
    LAUNCHES["retrieval_assign"] += 1
    SHAPES.add("retrieval_assign", "grouped" if groups is not None else "flat", (N, D, G), assign,
               (x, cents, groups, group_size))
    return out


def update(x, segments, cents):
    """K29: (new centroids, counts int32) of the segments (N,) over cents'
    S rows; the rows are sorted by segment (stable) here. See update_plain."""
    if x.device.type == "cpu":
        return update_plain(x, segments, cents)
    dev, D = _rows(x)
    num_segments = cents.shape[0]
    S._check("cents", cents, f32, (num_segments, D), dev)
    order, offsets = csr(segments, num_segments)
    out = torch.empty_like(cents)
    counts = torch.empty(num_segments, dtype=i32, device=dev)
    _call("retrieval_update_f32", num_segments, D, S._ptr(x), S._ptr(order), S._ptr(offsets),
          S._ptr(cents), S._ptr(out), S._ptr(counts), S._stream(dev))
    LAUNCHES["retrieval_update"] += 1
    return out, counts


def descend(x, levels, branching: int, depth: int):
    """K30: leaf ids (int32) of the rows of x by descent through ``levels``
    ((Σ_l B^(l+1), D), the tree's levels concatenated), in the regime
    ``_descend_plan`` chooses from the shapes."""
    if x.device.type == "cpu":
        return descend_plain(x, levels, branching, depth)
    _, D = _rows(x)
    return _descend_run(x, levels, branching, depth, _descend_plan(x.shape[0], branching, depth, D))


def _descend_run(x, levels, branching: int, depth: int, plan: DescendPlan):
    """K30's launch on the card in the regime of ``plan``: descend's own
    plan, or (to time the regimes against each other) the other one."""
    dev, D = _rows(x)
    rows = sum(branching ** (level + 1) for level in range(depth))
    S._check("levels", levels, f32, (rows, D), dev)
    if branching ** depth >= 2 ** 31:
        raise ValueError(f"{branching}^{depth} leaves do not fit int32 ids")
    if x.data_ptr() % 16 or levels.data_ptr() % 16:
        raise ValueError("K30 reads rows as float4: x and levels must be 16-byte aligned")
    N = x.shape[0]
    if plan.regime == "none":
        return torch.zeros(N, dtype=i32, device=dev)
    k = plan.passes[0][1] - plan.passes[0][0] if plan.regime == "sorted" else 0
    out = torch.empty(N, dtype=i32, device=dev)
    ws = torch.empty(_lib().retrieval_descend_workspace_bytes(N, branching, depth, k),
                     dtype=torch.uint8, device=dev)
    _call("retrieval_descend_f32", N, D, branching, depth, k, S._ptr(x), S._ptr(levels),
          S._ptr(out), S._ptr(ws), S._stream(dev))
    LAUNCHES["retrieval_descend"] += 1
    DESCEND_CALLS[plan.regime] += 1
    DESCEND_ROWS[plan.regime] += N
    return out


def gram(w):
    """K31: S = W Wᵀ (n, n) float32 of W (n, K) float32, exactly symmetric
    and the same in every run. See gram_plain; on the card, sparse W go
    through an inverted file with integer sums (gram_fixed_plain is their
    arithmetic), dense ones through a tiled product: a small W by its shape,
    the others as the card chooses (retrieval_gram.cu)."""
    if w.device.type == "cpu":
        return gram_plain(w)
    dev = S._require_cuda(w)
    if w.dim() != 2:
        raise ValueError(f"W must be (n, K), got {tuple(w.shape)}")
    S._check("w", w, f32, w.shape, dev)
    n, K = w.shape
    out = torch.empty(n, n, dtype=f32, device=dev)
    ws = torch.empty(_lib().retrieval_gram_workspace_bytes(n, K), dtype=torch.uint8, device=dev)
    _call("retrieval_gram_f32", n, K, S._ptr(w), S._ptr(out), S._ptr(ws), S._stream(dev))
    LAUNCHES["retrieval_gram"] += 1
    return out
