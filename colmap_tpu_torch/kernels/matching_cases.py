"""Synthetic inputs for the matching kernels K10-K12, made from a numpy seed.

As kernels/sfm_cases.py does for K5-K9: each case builds the tensors one
kernel takes at the shapes the matching pipeline gives it, with the hard
parts in them. chip_smoke.py and the card tests hold each kernel against its
plain version on them; the CPU tests run the plain versions on them.
"""

from __future__ import annotations

import numpy as np
import torch

from colmap_tpu_torch.kernels.sfm_cases import (  # noqa: F401 (as_double is part of the cases)
    FOCAL,
    HEIGHT,
    WIDTH,
    _look_at,
    _t,
    as_double,
)

MAX_SQ_PX = 16.0  # the verification threshold, 4 px, squared
_K = np.array([[FOCAL, 0.0, WIDTH / 2], [0.0, FOCAL, HEIGHT / 2], [0.0, 0.0, 1.0]])


def _cameras(rng, count):
    """cam_from_world (R, t) of cameras on a radius-5 arc looking at the origin."""
    cams = []
    for _ in range(count):
        a = rng.uniform(-0.5, 0.5)
        cams.append(_look_at(np.array([5 * np.sin(a), rng.uniform(-0.6, 0.6), -5 * np.cos(a)])))
    return cams


def _project(cam, X):
    R, t = cam
    Xc = X @ R.T + t
    return (Xc[:, :2] / Xc[:, 2:]) * FOCAL + _K[:2, 2]


def _fundamental(cam1, cam2):
    (R1, t1), (R2, t2) = cam1, cam2
    R = R2 @ R1.T
    t = t2 - R @ t1
    tx = np.array([[0, -t[2], t[1]], [t[2], 0, -t[0]], [-t[1], t[0], 0]])
    Kinv = np.linalg.inv(_K)
    F = Kinv.T @ tx @ R @ Kinv
    return F / np.linalg.norm(F)


def descriptor_case(num_images, n, seed, device):
    """K10: a descriptor table (I, cap, 128) uint8 with counts (I,), all
    I (I - 1) / 2 pairs (B, 2), keypoints (I, cap, 2) and one F per pair
    (B, 3, 3) for guided matching.

    Each image holds a random subset (85-100% of ``n``, so counts differ) of
    a pool of points with one random descriptor each, perturbed by a few
    units, at the points' projections, in random order. A tenth of an
    image's rows are followed by a near-duplicate of themselves at a random
    keypoint: in image 1 the duplicate fails the cross check (its best
    column prefers the original), in image 2 it makes the ratio test fail.
    The remaining rows are unique descriptors at random keypoints.
    """
    rng = np.random.default_rng(seed)
    pool = int(n * 0.9)
    pool_desc = rng.integers(0, 256, (pool, 128))
    pool_xyz = rng.uniform(-1.0, 1.0, (pool, 3))
    cams = _cameras(rng, num_images)
    counts = [n - (i * n // 7) % (n // 7 + 1) for i in range(num_images)]
    desc = np.zeros((num_images, n, 128), dtype=np.uint8)
    kp = np.zeros((num_images, n, 2), dtype=np.float32)
    for i in range(num_images):
        cnt = counts[i]
        n_dup = cnt // 10
        n_pool = min(pool, int(cnt * rng.uniform(0.75, 0.85)))
        ids = rng.permutation(pool)[:n_pool]
        d = np.clip(pool_desc[ids] + rng.integers(-3, 4, (n_pool, 128)), 0, 255)
        xy = _project(cams[i], pool_xyz[ids])
        dup = np.clip(d[:n_dup] + rng.integers(-2, 3, (n_dup, 128)), 0, 255)
        n_rand = cnt - n_pool - n_dup
        rows_d = np.concatenate([d, dup, rng.integers(0, 256, (n_rand, 128))])
        rows_xy = np.concatenate([xy, rng.uniform(0, [WIDTH, HEIGHT], (n_dup + n_rand, 2))])
        perm = rng.permutation(cnt)
        desc[i, :cnt] = rows_d[perm]
        kp[i, :cnt] = rows_xy[perm]
    pairs = np.array([(a, b) for a in range(num_images) for b in range(a + 1, num_images)])
    Fs = np.stack([_fundamental(cams[a], cams[b]) for a, b in pairs])
    return dict(desc=torch.from_numpy(desc).to(device),
                counts=_t(np.asarray(counts), device, torch.int32),
                pairs=_t(pairs, device, torch.int32), keypoints=torch.from_numpy(kp).to(device),
                F=_t(Fs, device))


def two_view_case(kind, n, k, seed, device, outliers=0.3, valid=None):
    """K11 / K12 / K7 on one pair: x1, x2 (n, 2), mask (n,), samples (k, m)
    int32 and max_sq. ``kind`` "F": pixel matches of a general scene (m = 7);
    "H": of a planar scene (m = 4); "E": normalized matches (m = 5, max_sq in
    normalized units). A fraction ``outliers`` of the matches is random; rows
    at or beyond ``valid`` (default n - 3) are padding; samples 0 and 1
    repeat a row (degenerate)."""
    rng = np.random.default_rng(seed)
    m = {"F": 7, "H": 4, "E": 5}[kind]
    valid = n - 3 if valid is None else valid
    cam1, cam2 = _look_at(np.array([0.0, 0.0, -5.0])), _look_at(np.array([1.5, 0.3, -4.8]))
    X = rng.uniform(-1.0, 1.0, (n, 3))
    if kind == "H":
        X[:, 2] = 0.3 * X[:, 0] - 0.2 * X[:, 1]
    x1, x2 = _project(cam1, X), _project(cam2, X)
    bad = rng.random(n) < outliers
    x2[bad] = rng.uniform(0, [WIDTH, HEIGHT], (int(bad.sum()), 2))
    max_sq = MAX_SQ_PX
    if kind == "E":
        x1, x2 = (x1 - _K[:2, 2]) / FOCAL, (x2 - _K[:2, 2]) / FOCAL
        max_sq = MAX_SQ_PX / FOCAL**2
    mask = np.arange(n) < valid
    x1[~mask] = 0.0
    x2[~mask] = 0.0
    samples = rng.integers(0, valid, (k, m))
    samples[0] = 3
    samples[1, -1] = samples[1, 0]
    return dict(x1=_t(x1, device), x2=_t(x2, device), mask=_t(mask, device, torch.bool),
                samples=_t(samples, device, torch.int32), max_sq=max_sq)


def two_view_block_case(kind, b, n, k, seed, device):
    """A block of ``b`` pairs of ``two_view_case`` with different valid
    counts (n down to about n / 2) and outlier shares (0.1-0.5): x1, x2
    (b, n, 2), mask (b, n), samples (b, k, m) and max_sq, a (b,) tensor for
    "E" (one normalized threshold per pair) and a float otherwise."""
    cases = [two_view_case(kind, n, k, seed + 17 * i, device, outliers=0.1 + 0.4 * i / max(b - 1, 1),
                           valid=n - (i * n) // (2 * b)) for i in range(b)]
    out = {key: torch.stack([c[key] for c in cases]) for key in ("x1", "x2", "mask", "samples")}
    out["max_sq"] = cases[0]["max_sq"]
    if kind == "E":
        scale = 1.0 + 0.1 * np.arange(b)
        out["max_sq"] = _t(cases[0]["max_sq"] * scale, device)
    return out
