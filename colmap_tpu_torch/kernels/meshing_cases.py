"""Cases for the spectral Poisson kernels K41-K44 and the meshers.

Each case is numpy arrays made from a seed, so that the CPU tests can hand
the same inputs to colmap_tpu and to the port, and chip_smoke.py the same
to a kernel and its plain version:

- ``sphere``: unit normals of a sphere, the points on it;
- ``planes_and_wall``: chip_smoke.py's dense scene at a small size — two
  slanted planes (x < 0: z = 5 + 0.08 x + 0.05 y; x >= 0: z = 4.7 + 0.08 x
  - 0.04 y) joined by the wall x = 0, normals facing the cameras at z = 0;
- ``clip_border``: samples in [0, 1)^3 with coordinates at 0 and just below
  1, so that a corner's base + d leaves [0, N - 1] and is clipped;
- ``crowded_voxel``: a sphere with one voxel that receives more than 64
  contributions (K41's longest run).

``normalize`` is poisson_mesh's bounding-box map into [0, 1)^3.
"""

from __future__ import annotations

import numpy as np

# The dense scene's planes (normal, offset): n . X = c (chip_smoke.py DENSE_PLANES).
PLANES = ((np.array([-0.08, -0.05, 1.0]), 5.0), (np.array([-0.08, 0.04, 1.0]), 4.7))


def sphere(n, seed=0, radius=1.0):
    """(points, normals) of n samples of a sphere about the origin."""
    v = np.random.default_rng(seed).normal(size=(n, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    return v * radius, v


def _wall_span(y):
    (na, ca), (nb, cb) = PLANES
    za, zb = ca - na[1] * y, cb - nb[1] * y
    return np.minimum(za, zb), np.maximum(za, zb)


def planes_and_wall(n, seed=0, half_width=1.2, half_height=0.8):
    """(points, normals) of n samples of the two planes and the wall, the
    wall's share by its area; normals face the cameras (z < 0)."""
    rng = np.random.default_rng(seed)
    n_wall = max(n // 40, 8)
    x = rng.uniform(-half_width, half_width, n - n_wall)
    y = rng.uniform(-half_height, half_height, n - n_wall)
    pts, nrm = [], []
    for (nv, c), side in zip(PLANES, (x < 0, x >= 0)):
        xs, ys = x[side], y[side]
        pts.append(np.stack([xs, ys, c - nv[0] * xs - nv[1] * ys], 1))
        nrm.append(np.tile(-nv / np.linalg.norm(nv), (len(xs), 1)))
    yw = rng.uniform(-half_height, half_height, n_wall)
    lo, hi = _wall_span(yw)
    zw = lo + rng.uniform(0, 1, n_wall) * (hi - lo)
    pts.append(np.stack([np.zeros(n_wall), yw, zw], 1))
    nrm.append(np.tile([-1.0, 0.0, 0.0], (n_wall, 1)))
    return np.concatenate(pts), np.concatenate(nrm)


def surface_distance(pts):
    """Each point's distance to the planes-and-wall surface (its plane for x <
    0 or x >= 0, or the wall where it lies between the planes)."""
    (na, ca), (nb, cb) = PLANES
    da = np.abs(pts @ na - ca) / np.linalg.norm(na)
    db = np.abs(pts @ nb - cb) / np.linalg.norm(nb)
    lo, hi = _wall_span(pts[:, 1])
    on_wall = (pts[:, 2] >= lo) & (pts[:, 2] <= hi)
    dist = np.where(pts[:, 0] < 0, da, db)
    return np.where(on_wall, np.minimum(dist, np.abs(pts[:, 0])), dist)


def normalize(points, padding=1.1):
    """poisson_mesh's map into [0, 1)^3: (points01, center, scale)."""
    lo, hi = points.min(axis=0), points.max(axis=0)
    center = 0.5 * (lo + hi)
    scale = max(float((hi - lo).max()) * padding, 1e-9)
    return (points - center) / scale + 0.5, center, scale


def clip_border(n, seed=0):
    """(points01, normals): n samples in [0, 1)^3, a quarter with a
    coordinate at 0 or just below 1 (a corner outside the grid)."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(0.0, 1.0, (n, 3))
    edge = rng.integers(0, 3, n // 4)
    x[np.arange(n // 4), edge] = np.where(rng.uniform(size=n // 4) < 0.5, 0.0,
                                          np.nextafter(np.float32(1.0), np.float32(0.0)))
    v = rng.normal(size=(n, 3))
    return x, v / np.linalg.norm(v, axis=1, keepdims=True)


def crowded_voxel(n, N, crowd=100, seed=0):
    """(points01, normals): a sphere of n samples and ``crowd`` more inside
    one voxel of an N^3 grid."""
    pts, nrm = sphere(n, seed)
    p01 = pts / 2.2 + 0.5
    rng = np.random.default_rng(seed + 1)
    cell = (np.floor(p01[0] * N) + rng.uniform(0.2, 0.8, (crowd, 3))) / N
    return np.concatenate([p01, cell]), np.concatenate([nrm, np.tile(nrm[:1], (crowd, 1))])


def visibility(points, centers):
    """Image ids (keys of ``centers``) whose centre lies on each point's
    outer side: the sphere's visibility lists."""
    ids = np.array(sorted(centers))
    C = np.stack([centers[i] for i in ids])
    return [ids[(C @ p) > 0] for p in points]
