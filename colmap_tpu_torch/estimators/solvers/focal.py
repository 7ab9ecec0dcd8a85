"""Focal-length recovery from epipolar geometry.

Counterpart of colmap_tpu/estimators/solvers/focal.py (reference behavior:
src/colmap/estimators/solvers/relpose_shared_focal.{h,cc} and
relpose_one_sided_focal.cc, used by EstimateSharedFocalTwoViewGeometry /
EstimateOneSidedFocalTwoViewGeometry, estimators/two_view_geometry.cc:597-611,
when exactly one or neither camera has a focal prior). colmap_tpu's
closed-form formulation is kept:

- two independent focals: the Bougnoux closed form from F and the principal
  points (Bougnoux, ICCV'98);
- one shared focal: the geometric mean of the Bougnoux pair, checked for
  identifiability;
- one-sided focal: a log-space grid and golden-section refinement over the
  unknown focal, scoring how close diag(f, f, 1) G is to an essential matrix.

A handful of 3x3 operations per pair: float64 torch on the host.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def _t(x):
    return torch.as_tensor(np.asarray(x), dtype=torch.float64)


def _epipole(F):
    """Right epipole: F e = 0 (the smallest right singular vector)."""
    return torch.linalg.svd(F)[2][-1]


def _cross(v):
    z = torch.zeros((), dtype=v.dtype)
    return torch.stack([torch.stack([z, -v[2], v[1]]), torch.stack([v[2], z, -v[0]]),
                        torch.stack([-v[1], v[0], z])])


def bougnoux_focals(F, pp1, pp2) -> Tuple[float, float]:
    """Squared focal lengths (f1², f2²) from a fundamental matrix and the
    principal points pp1, pp2 (2,) in pixels. Negative values mark an
    unreliable or degenerate configuration."""
    F = _t(F)
    one = torch.ones(1, dtype=torch.float64)
    p1, p2 = torch.cat([_t(pp1), one]), torch.cat([_t(pp2), one])
    I2 = torch.diag(torch.tensor([1.0, 1.0, 0.0], dtype=torch.float64))
    e1, e2 = _epipole(F), _epipole(F.T)
    num1 = -(p2 @ _cross(e2) @ I2 @ F @ p1) * (p2 @ F @ p1)
    den1 = p2 @ _cross(e2) @ I2 @ F @ I2 @ F.T @ p2
    num2 = -(p1 @ _cross(e1) @ I2 @ F.T @ p2) * (p1 @ F.T @ p2)
    den2 = p1 @ _cross(e1) @ I2 @ F.T @ I2 @ F @ p1
    return float(num1 / den1), float(num2 / den2)


def shared_focal_from_fundamental(F, pp1, pp2, min_focal: float = 1e-3) -> Tuple[float, bool]:
    """One shared focal from F: the geometric mean of the Bougnoux pair.
    Returns (focal, ok); ok is False when a squared focal is not positive or
    the two estimates differ by more than a factor of 1.5."""
    f1_sq, f2_sq = bougnoux_focals(F, pp1, pp2)
    if not np.isfinite(f1_sq) or not np.isfinite(f2_sq):
        return 0.0, False
    if f1_sq <= min_focal or f2_sq <= min_focal:
        return 0.0, False
    ratio = np.sqrt(f1_sq / f2_sq)
    if ratio > 1.5 or ratio < 1.0 / 1.5:
        return 0.0, False
    return float((f1_sq * f2_sq) ** 0.25), True


def two_focals_from_fundamental(F, pp1, pp2, min_focal: float = 1e-3) -> Tuple[float, float, bool]:
    """Two independent focals by Bougnoux. Returns (f1, f2, ok)."""
    f1_sq, f2_sq = bougnoux_focals(F, pp1, pp2)
    if (not np.isfinite(f1_sq) or not np.isfinite(f2_sq) or f1_sq <= min_focal
            or f2_sq <= min_focal):
        return 0.0, 0.0, False
    return float(np.sqrt(f1_sq)), float(np.sqrt(f2_sq)), True


def _essentialness(E):
    """0 for an essential matrix (two equal singular values, the third 0);
    E (..., 3, 3)."""
    s = torch.linalg.svdvals(E)
    return ((s[..., 0] - s[..., 1]) / torch.clamp(s[..., 0] + s[..., 1], min=1e-12)
            + s[..., 2] / torch.clamp(s[..., 0], min=1e-12))


def one_sided_focal_from_geometry(G, min_focal: float, max_focal: float, num_samples: int = 64,
                                  num_refine: int = 24) -> Tuple[float, float]:
    """The unknown focal f of the second camera given G with
    x2_centeredᵀ G x1_ray = 0, i.e. E = diag(f, f, 1) G. Returns (f, the
    residual essential-ness score)."""
    G = _t(G)

    def score(f):
        f = torch.as_tensor(f, dtype=torch.float64)
        scale = torch.stack([f, f, torch.ones_like(f)], dim=-1)
        return _essentialness(scale[..., :, None] * G)

    fs = torch.exp(torch.linspace(np.log(min_focal), np.log(max_focal), num_samples,
                                  dtype=torch.float64))
    best = int(torch.argmin(score(fs)))
    a, b = float(fs[max(best - 1, 0)]), float(fs[min(best + 1, num_samples - 1)])
    gr = 0.61803398875
    c, d = b - gr * (b - a), a + gr * (b - a)
    fc, fd = float(score(c)), float(score(d))
    for _ in range(num_refine):
        if fc < fd:
            b, d, fd = d, c, fc
            c = b - gr * (b - a)
            fc = float(score(c))
        else:
            a, c, fc = c, d, fd
            d = a + gr * (b - a)
            fd = float(score(d))
    f = 0.5 * (a + b)
    return float(f), float(score(f))
