"""Closed-form low-degree polynomial roots, batched.

Counterpart of colmap_tpu/optim/polynomial.py (reference behavior:
src/colmap/math/polynomial.{h,cc}): cubic roots by the trigonometric /
Cardano closed form, quartics by Ferrari's resolvent, as branch-free
``where`` selections over any batch shape; invalid (complex) roots are
flagged by the returned mask. The P3P kernel K6 carries the same formulas
in CUDA (csrc/p3p_ransac.cu).
"""

from __future__ import annotations

import torch


def _safe(bad, x):
    return torch.where(bad, torch.ones_like(x), x)


def solve_quadratic(a, b, c):
    """Real roots of a x^2 + b x + c. Returns (roots (..., 2), mask)."""
    disc = b * b - 4 * a * c
    ok = disc >= 0
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    q = -0.5 * (b + torch.sign(b) * sq)
    lin = torch.abs(a) < 1e-30
    r1 = q / _safe(lin, a)
    r2 = c / _safe(torch.abs(q) < 1e-30, q)
    r_lin = -c / _safe(torch.abs(b) < 1e-30, b)
    roots = torch.stack([torch.where(lin, r_lin, r1), torch.where(lin, r_lin, r2)], dim=-1)
    mask = torch.stack([ok | lin, ok & ~lin], dim=-1)
    return roots, mask


def solve_cubic(a, b, c, d):
    """Real roots of a x^3 + b x^2 + c x + d (a assumed nonzero).

    Returns (roots (..., 3), mask (..., 3)); invalid entries repeat the
    first real root.
    """
    sa = _safe(torch.abs(a) < 1e-30, a)
    b_, c_, d_ = b / sa, c / sa, d / sa
    p = c_ - b_ * b_ / 3.0
    q = 2.0 * b_**3 / 27.0 - b_ * c_ / 3.0 + d_
    shift = -b_ / 3.0
    disc = (q / 2.0) ** 2 + (p / 3.0) ** 3
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    root_single = torch.sign(-q / 2.0 + sq) * torch.abs(-q / 2.0 + sq) ** (1.0 / 3.0) + (
        torch.sign(-q / 2.0 - sq) * torch.abs(-q / 2.0 - sq) ** (1.0 / 3.0)) + shift
    p_neg = torch.clamp(p, max=-1e-30)
    m = 2.0 * torch.sqrt(-p_neg / 3.0)
    theta = torch.arccos(torch.clamp(3.0 * q / (p_neg * m), -1.0, 1.0)) / 3.0
    k = torch.arange(3, dtype=a.dtype, device=a.device)
    roots3 = m[..., None] * torch.cos(theta[..., None] - 2.0 * torch.pi * k / 3.0) + shift[..., None]
    three = (disc <= 0)[..., None]
    roots = torch.where(three, roots3, root_single[..., None])
    mask = torch.cat([torch.ones_like(three), three, three], dim=-1)
    return roots, mask


def solve_quartic(a, b, c, d, e):
    """Real roots of a x^4 + b x^3 + c x^2 + d x + e by Ferrari.

    Returns (roots (..., 4), mask (..., 4)).
    """
    sa = _safe(torch.abs(a) < 1e-30, a)
    b_, c_, d_, e_ = b / sa, c / sa, d / sa, e / sa
    p = c_ - 3.0 * b_**2 / 8.0
    q = d_ - b_ * c_ / 2.0 + b_**3 / 8.0
    r = e_ - b_ * d_ / 4.0 + b_**2 * c_ / 16.0 - 3.0 * b_**4 / 256.0
    shift = -b_ / 4.0
    # Resolvent cubic m^3 + 2p m^2 + (p^2 - 4r) m - q^2 = 0: largest real root.
    mroots, mmask = solve_cubic(torch.ones_like(p), 2.0 * p, p * p - 4.0 * r, -q * q)
    m = torch.where(mmask, mroots, -torch.inf).amax(-1)
    m_pos = m > 1e-12
    sqm = torch.sqrt(torch.clamp(m, min=0.0))
    half = (p + m) / 2.0
    qterm = q / (2.0 * _safe(sqm < 1e-30, sqm))
    one = torch.ones_like(m)
    r1, m1 = solve_quadratic(one, sqm, half - qterm)
    r2, m2 = solve_quadratic(one, -sqm, half + qterm)
    # q ~ 0: the biquadratic y^4 + p y^2 + r = 0.
    z, zm = solve_quadratic(torch.ones_like(p), p, r)
    z_ok = zm & (z >= 0)
    sz = torch.sqrt(torch.clamp(z, min=0.0))
    use_biq = ((torch.abs(q) < 1e-12) | ~m_pos)[..., None]
    roots = torch.where(use_biq, torch.cat([sz, -sz], -1), torch.cat([r1, r2], -1))
    mask = torch.where(use_biq, torch.cat([z_ok, z_ok], -1), torch.cat([m1, m2], -1))
    return roots + shift[..., None], mask
