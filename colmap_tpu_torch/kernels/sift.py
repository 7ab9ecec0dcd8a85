"""SIFT kernels: wrappers, plain versions, counts.

Four CUDA kernels carry the device programs of colmap_tpu/feature/sift.py
(sources in ``colmap_tpu_torch/csrc``):

    K13 sift_pyramid      upsample2, blur_rows + blur_cols (one Gaussian
                          level and its DoG), downsample2
    K14 sift_extrema      3x3x3 DoG extrema with subpixel refinement
    K15 sift_orientation  36-bin orientation histograms and their peaks
    K16 sift_descriptor   4x4x8 descriptors, normalized and quantized
    K45 sift_affine_shape Baumberg affine shapes (estimate_affine_shape)

With estimate_affine_shape, K45 gives each keypoint a det-1 shape A (K, 2,
2), and K15 and K16 take it as ``shapes``: K15 samples with W = sigma A,
K16 with the frame sigma A R(theta), which its rows carry.

As in kernels/matching.py, each wrapper runs the plain version when its
tensors lie on the CPU and launches the kernel when they lie on a CUDA
device; on a CUDA tensor it launches or raises. ``LAUNCHES`` counts kernel
launches by kernel name. The plain versions are written for any float
dtype: the tests run them in float64 against colmap_tpu, extract_sift runs
them in float32 on the CPU.

Layouts follow colmap_tpu: an image is (H, W); an octave's Gaussian stack
(S+3, H, W) and DoG (S+2, H, W); keypoints in octave pixels (x, y), their
level index into the stack and their scale sigma. A descriptor row is one
(keypoint, orientation) pair, rows grouped by keypoint (``jnp.repeat``).

K14 appends every extremum of the octave (unordered) with its score
|DoG|, its flat index into the inner scales (S, H, W) and its refined row;
``select_candidates`` then takes the ``max_candidates_per_octave`` highest
by (score descending, flat index ascending), the order of ``lax.top_k``,
by two stable sorts. Refining every extremum and selecting afterwards
gives what colmap_tpu gives by selecting first: refinement is per
candidate and the key is the unrefined |DoG|.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from colmap_tpu_torch.kernels import sfm as S

LAUNCHES = {"sift_pyramid": 0, "sift_extrema": 0, "sift_orientation": 0, "sift_descriptor": 0,
            "sift_affine_shape": 0}

R = 8  # half window: 16 x 16 samples at unit spacing x sigma
NBINS_ORI = 36
DESC_DIM = 128
ROW_COLS = 9  # x, y, sigma, theta, response, frame (a11, a12, a21, a22)
MAX_RADIUS = 64  # widest blur the kernel takes: sigma up to 16 px


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


class Extrema(NamedTuple):
    """K14's output: every DoG extremum of an octave, in any order."""

    score: torch.Tensor  # (N,) |DoG| at the sample, the selection key
    flat: torch.Tensor  # (N,) int64 index into the inner scales (S, H, W)
    rows: torch.Tensor  # (N, 5) x, y, s (refined inner scale), sigma, response
    lvl: torch.Tensor  # (N,) int32 Gaussian level: clip(round(s) + 1, 0, S + 2)
    keep: torch.Tensor  # (N,) bool: passes the determinant, contrast, edge and bounds tests


# ---------------------------------------------------------------------------
# Plain versions.
# ---------------------------------------------------------------------------


def blur_radius(sigma: float) -> int:
    return max(1, int(np.ceil(4.0 * sigma)))


def gaussian_taps(sigma: float, dtype, device=None) -> torch.Tensor:
    """(2r + 1,) normalized Gaussian taps, r = max(1, ceil(4 sigma)), in
    ``dtype`` as colmap_tpu's ``_band_matrix`` builds its rows."""
    r = blur_radius(sigma)
    d = torch.arange(-r, r + 1, dtype=dtype, device=device)
    k = torch.exp(-0.5 * (d / sigma) ** 2)
    return k / torch.sum(k)


def _blur_axis(x, taps, axis):
    r = (taps.shape[0] - 1) // 2
    n = x.shape[axis]
    idx = torch.clamp(torch.arange(-r, n + r, device=x.device), 0, n - 1)
    xp = x.index_select(axis, idx)
    out = taps[0] * xp.narrow(axis, 0, n)
    for k in range(1, 2 * r + 1):
        out = out + taps[k] * xp.narrow(axis, k, n)
    return out


def blur_plain(img, sigma):
    """Separable Gaussian blur of (H, W) with edge replication: rows, then
    columns (colmap_tpu's ``_blur`` without its banded matmuls)."""
    taps = gaussian_taps(sigma, img.dtype, img.device)
    return _blur_axis(_blur_axis(img, taps, 1), taps, 0)


def upsample2_plain(img):
    """(H, W) -> (2H, 2W) bilinear with half-pixel centres and clamped edges
    (``jax.image.resize(..., "bilinear")`` at a factor of 2)."""

    def axis(x, dim):
        n = x.shape[dim]
        lo = x.index_select(dim, torch.clamp(torch.arange(-1, n - 1, device=x.device), 0, n - 1))
        hi = x.index_select(dim, torch.clamp(torch.arange(1, n + 1, device=x.device), 0, n - 1))
        even = 0.25 * lo + 0.75 * x
        odd = 0.75 * x + 0.25 * hi
        out = torch.stack([even, odd], dim=dim + 1)
        shape = list(x.shape)
        shape[dim] = 2 * n
        return out.reshape(shape)

    return axis(axis(img, 1), 0)


def downsample2_plain(img):
    return img[::2, ::2].contiguous()


def octave_sigmas(options):
    """The blur of each level s = 1..S+2 from level s - 1 (sift.py:134-138)."""
    S_ = options.octave_resolution
    k = 2.0 ** (1.0 / S_)
    out, sigma_prev = [], options.sigma0
    for s in range(1, S_ + 3):
        sigma_total = options.sigma0 * (k**s)
        out.append(float(np.sqrt(max(sigma_total**2 - sigma_prev**2, 1e-8))))
        sigma_prev = sigma_total
    return out


def build_octave_plain(img, options):
    """Gaussian stack (S+3, H, W) and DoG (S+2, H, W) of one octave."""
    levels = [img]
    for sigma in octave_sigmas(options):
        levels.append(blur_plain(levels[-1], sigma))
    gauss = torch.stack(levels)
    return gauss, gauss[1:] - gauss[:-1]


def extrema_mask_plain(dog, peak_threshold):
    """(S, H, W) bool: 3x3x3 extrema of the inner DoG scales (ties count),
    beyond +-0.8 peak_threshold, zero on the one-pixel border."""
    S2, H, W = dog.shape
    mask = torch.zeros((S2 - 2, H, W), dtype=torch.bool, device=dog.device)
    if H < 3 or W < 3:
        return mask
    c = dog[1:-1, 1:-1, 1:-1]
    mx, mn = c.clone(), c.clone()
    for ds in (0, 1, 2):
        for dy in (0, 1, 2):
            for dx in (0, 1, 2):
                v = dog[ds:ds + S2 - 2, dy:dy + H - 2, dx:dx + W - 2]
                mx = torch.maximum(mx, v)
                mn = torch.minimum(mn, v)
    thr = 0.8 * peak_threshold
    mask[:, 1:-1, 1:-1] = ((c >= mx) & (c > thr)) | ((c <= mn) & (c < -thr))
    return mask


def refine_plain(dog, ss, ys, xs, options):
    """colmap_tpu's ``_refine_candidates`` on candidates (inner scale, row,
    column), plus the level and sigma of ``_detect_octave_impl``. Returns
    (rows (N, 5) [x, y, s, sigma, response], lvl (N,) int32, keep (N,))."""
    S2, H, W = dog.shape
    s = ss + 1

    def d(ds, dy, dx):
        return dog[s + ds, ys + dy, xs + dx]

    gx = 0.5 * (d(0, 0, 1) - d(0, 0, -1))
    gy = 0.5 * (d(0, 1, 0) - d(0, -1, 0))
    gs = 0.5 * (d(1, 0, 0) - d(-1, 0, 0))
    dxx = d(0, 0, 1) + d(0, 0, -1) - 2 * d(0, 0, 0)
    dyy = d(0, 1, 0) + d(0, -1, 0) - 2 * d(0, 0, 0)
    dss = d(1, 0, 0) + d(-1, 0, 0) - 2 * d(0, 0, 0)
    dxy = 0.25 * (d(0, 1, 1) - d(0, 1, -1) - d(0, -1, 1) + d(0, -1, -1))
    dxs = 0.25 * (d(1, 0, 1) - d(1, 0, -1) - d(-1, 0, 1) + d(-1, 0, -1))
    dys = 0.25 * (d(1, 1, 0) - d(1, -1, 0) - d(-1, 1, 0) + d(-1, -1, 0))
    Hm = torch.stack([dxx, dxy, dxs, dxy, dyy, dys, dxs, dys, dss], dim=-1).reshape(-1, 3, 3)
    g = torch.stack([gx, gy, gs], dim=-1)
    ok_det = torch.abs(torch.linalg.det(Hm)) > 1e-12
    eye = torch.eye(3, dtype=dog.dtype, device=dog.device)
    Hm_safe = torch.where(ok_det[:, None, None], Hm, eye)
    delta = torch.clamp(-torch.linalg.solve(Hm_safe, g[..., None])[..., 0], -1.5, 1.5)
    response = d(0, 0, 0) + 0.5 * torch.sum(g * delta, dim=-1)
    keep = ok_det & (torch.abs(response) > options.peak_threshold)
    tr = dxx + dyy
    det2 = dxx * dyy - dxy * dxy
    r = options.edge_threshold
    keep &= (det2 > 0) & (tr * tr / torch.clamp(det2, min=1e-20) < (r + 1) ** 2 / r)
    x_ref = xs + delta[:, 0]
    y_ref = ys + delta[:, 1]
    s_ref = ss.to(dog.dtype) + delta[:, 2]
    keep &= (x_ref >= 1) & (x_ref < W - 1) & (y_ref >= 1) & (y_ref < H - 1)
    S_ = options.octave_resolution
    sigma = options.sigma0 * (2.0 ** ((s_ref + 1.0) / S_))
    lvl = torch.clamp(torch.round(s_ref).to(torch.int32) + 1, 0, S_ + 2)
    rows = torch.stack([x_ref, y_ref, s_ref, sigma, response], dim=1)
    return rows, lvl, keep


def detect_extrema_plain(dog, options) -> Extrema:
    """K14's function: every extremum of the octave (in flat order here),
    refined."""
    mask = extrema_mask_plain(dog, options.peak_threshold)
    _, H, W = mask.shape
    flat = torch.nonzero(mask.reshape(-1)).flatten()
    ss, rem = flat // (H * W), flat % (H * W)
    ys, xs = rem // W, rem % W
    score = torch.abs(dog[1:-1].reshape(-1)[flat])
    rows, lvl, keep = refine_plain(dog, ss, ys, xs, options)
    return Extrema(score, flat, rows, lvl, keep)


def top_candidates(ext: Extrema, cap: int) -> torch.Tensor:
    """Indices into ``ext`` of the ``cap`` highest extrema by (score
    descending, flat index ascending), in that order: ``lax.top_k``'s
    candidates."""
    by_index = torch.sort(ext.flat, stable=True).indices
    by_score = torch.sort(ext.score[by_index], descending=True, stable=True).indices
    return by_index[by_score[:cap]]


def select_candidates(ext: Extrema, cap: int) -> torch.Tensor:
    """The top candidates that pass refinement, in selection order, as
    colmap_tpu compacts them."""
    top = top_candidates(ext, cap)
    return top[ext.keep[top]]


def selected_keypoints(ext: Extrema, sel):
    """(x, y, lvl, sigma, response) of the candidates ``sel``, contiguous,
    as K15 and K16 take them."""
    return (ext.rows[sel, 0].contiguous(), ext.rows[sel, 1].contiguous(),
            ext.lvl[sel].contiguous(), ext.rows[sel, 3].contiguous(),
            ext.rows[sel, 4].contiguous())


def _gradient_stacks(gauss):
    gx = torch.zeros_like(gauss)
    gx[:, :, 1:-1] = 0.5 * (gauss[:, :, 2:] - gauss[:, :, :-2])
    gy = torch.zeros_like(gauss)
    gy[:, 1:-1, :] = 0.5 * (gauss[:, 2:, :] - gauss[:, :-2, :])
    return gx.reshape(-1), gy.reshape(-1)


def _bilinear(flat, lvl, yy, xx, H, W):
    """colmap_tpu's ``bilinear_lvl``: y0 in [0, H-2], x0 in [0, W-2], the
    fractions clipped to [0, 1]."""
    y0 = torch.clamp(torch.floor(yy).to(torch.int64), 0, H - 2)
    x0 = torch.clamp(torch.floor(xx).to(torch.int64), 0, W - 2)
    fy = torch.clamp(yy - y0, 0.0, 1.0)
    fx = torch.clamp(xx - x0, 0.0, 1.0)
    base = lvl.to(torch.int64) * (H * W) + y0 * W + x0
    v00, v01 = flat[base], flat[base + 1]
    v10, v11 = flat[base + W], flat[base + W + 1]
    return v00 * (1 - fy) * (1 - fx) + v01 * (1 - fy) * fx + v10 * fy * (1 - fx) + v11 * fy * fx


def _window(dtype, device):
    win = torch.arange(-R, R, dtype=dtype, device=device) + 0.5
    pu = win[:, None].expand(2 * R, 2 * R).reshape(-1)  # patch row offset of each sample
    pv = win[None, :].expand(2 * R, 2 * R).reshape(-1)  # patch column offset
    return win, pu, pv


def _warped_grads(grads, lvl, x, y, Wm, H, W):
    """Magnitude and angle (K, 256) of the gradients of the patch
    P(p) = I((x, y) + Wm p) at the 16 x 16 grid (colmap_tpu's
    ``sample_warped_grads_batched``, exact path)."""
    gx_flat, gy_flat = grads
    _, pu, pv = _window(x.dtype, x.device)
    dx = Wm[:, 0, 0, None] * pv + Wm[:, 0, 1, None] * pu
    dy = Wm[:, 1, 0, None] * pv + Wm[:, 1, 1, None] * pu
    yy, xx = y[:, None] + dy, x[:, None] + dx
    sgx = _bilinear(gx_flat, lvl[:, None], yy, xx, H, W)
    sgy = _bilinear(gy_flat, lvl[:, None], yy, xx, H, W)
    gv = Wm[:, 0, 0, None] * sgx + Wm[:, 1, 0, None] * sgy
    gu = Wm[:, 0, 1, None] * sgx + Wm[:, 1, 1, None] * sgy
    return torch.sqrt(gv * gv + gu * gu + 1e-20), torch.atan2(gu, gv)


def _circular_weight(pos, b, n):
    dist = torch.abs(pos - b)
    return torch.clamp(1.0 - torch.minimum(dist, n - dist), min=0.0)


def orientation_histograms_plain(gauss, x, y, lvl, sigma, shapes=None):
    """(K, 36) smoothed orientation histograms."""
    _, H, W = gauss.shape
    K = x.shape[0]
    if shapes is None:
        shapes = torch.eye(2, dtype=gauss.dtype, device=gauss.device).expand(K, 2, 2)
    m, a = _warped_grads(_gradient_stacks(gauss), lvl, x, y, sigma[:, None, None] * shapes, H, W)
    win, pu, pv = _window(gauss.dtype, gauss.device)
    w = torch.exp(-((pu**2 + pv**2) / (2.0 * (1.5 * R / 3.0) ** 2)))
    wm = m * w
    bin_f = (a + math.pi) / (2 * math.pi) * NBINS_ORI - 0.5
    b0 = torch.floor(bin_f)
    hist = torch.zeros((K, NBINS_ORI), dtype=gauss.dtype, device=gauss.device)
    for b in (b0, b0 + 1):
        wb = _circular_weight(bin_f, b, NBINS_ORI)
        hist.scatter_add_(1, torch.remainder(b, NBINS_ORI).to(torch.int64), wm * wb)
    for _ in range(2):
        hist = (torch.roll(hist, 1, 1) + hist + torch.roll(hist, -1, 1)) / 3.0
    return hist


def orientation_peaks(hist, n_ori):
    """colmap_tpu's ``peaks``: up to n_ori local maxima at or above 0.8 of
    the largest, by value (the first index wins a tie), parabolic
    interpolation. Returns theta (K, n_ori) and ok (K, n_ori)."""
    m = hist.max(dim=1, keepdim=True).values
    is_local = (hist >= torch.roll(hist, 1, 1)) & (hist >= torch.roll(hist, -1, 1))
    score = torch.where(is_local & (hist >= 0.8 * m), hist, -torch.inf)
    order = torch.sort(-score, dim=1, stable=True).indices[:, :n_ori]
    ok = torch.gather(score, 1, order) > 0
    h0 = torch.gather(hist, 1, torch.remainder(order - 1, NBINS_ORI))
    h1 = torch.gather(hist, 1, order)
    h2 = torch.gather(hist, 1, torch.remainder(order + 1, NBINS_ORI))
    denom = h0 - 2 * h1 + h2
    di = torch.where(torch.abs(denom) > 1e-12, 0.5 * (h0 - h2) / denom, torch.zeros_like(denom))
    theta = (order.to(hist.dtype) + 0.5 + di) / NBINS_ORI * 2 * math.pi - math.pi
    return theta, ok


def orientations_plain(gauss, x, y, lvl, sigma, options, shapes=None):
    """K15's function: theta (K, n_ori) and ok (K, n_ori) bool."""
    n_ori = options.max_num_orientations
    if options.upright:
        theta = torch.zeros((x.shape[0], n_ori), dtype=gauss.dtype, device=gauss.device)
        ok = torch.zeros((x.shape[0], n_ori), dtype=torch.bool, device=gauss.device)
        ok[:, 0] = True
        return theta, ok
    hist = orientation_histograms_plain(gauss, x, y, lvl, sigma, shapes)
    return orientation_peaks(hist, n_ori)


def _raw_descriptors(grads, lvl, x, y, frames, H, W):
    """(K, 128) trilinear 4 x 4 x 8 histograms of the warped gradients."""
    m, a = _warped_grads(grads, lvl, x, y, frames, H, W)
    _, pu, pv = _window(x.dtype, x.device)
    wm = m * torch.exp(-((pu**2 + pv**2) / (2.0 * (0.5 * 2 * R) ** 2)))
    bu = (pu + R - 0.5) / (2 * R) * 4.0 - 0.5
    bv = (pv + R - 0.5) / (2 * R) * 4.0 - 0.5
    bo = torch.remainder(a, 2 * math.pi) / (2 * math.pi) * 8.0 - 0.5
    u0, v0, o0 = torch.floor(bu), torch.floor(bv), torch.floor(bo)
    out = torch.zeros((x.shape[0], DESC_DIM), dtype=x.dtype, device=x.device)
    for u in (u0, u0 + 1):
        wu = torch.clamp(1.0 - torch.abs(bu - u), min=0.0) * ((u >= 0) & (u <= 3))
        for v in (v0, v0 + 1):
            wv = torch.clamp(1.0 - torch.abs(bv - v), min=0.0) * ((v >= 0) & (v <= 3))
            for o in (o0, o0 + 1):
                wo = _circular_weight(bo, o, 8)
                idx = (torch.clamp(u, 0, 3) * 32 + torch.clamp(v, 0, 3) * 8
                       + torch.remainder(o, 8)).to(torch.int64)
                out.scatter_add_(1, idx.expand_as(wo), wm * (wu * wv)[None, :] * wo)
    return out


def normalize_descriptors(desc, normalization):
    if normalization == "L2":
        return desc / torch.clamp(torch.linalg.vector_norm(desc, dim=1, keepdim=True), min=1e-12)
    return torch.sqrt(desc / torch.clamp(torch.sum(torch.abs(desc), dim=1, keepdim=True),
                                         min=1e-12))


def quantize_descriptors(desc):
    """clip(round_half_even(512 d), 0, 255) as uint8 (sift.py:690-692)."""
    return torch.clamp(torch.round(desc * 512.0), 0, 255).to(torch.uint8)


def dsp_scales(options):
    if not options.domain_size_pooling:
        return [1.0]
    return [float(f) for f in np.linspace(options.dsp_min_scale, options.dsp_max_scale,
                                          options.dsp_num_scales)]


def descriptors_plain(gauss, x, y, lvl, sigma, response, theta, options, shapes=None):
    """K16's function on every (keypoint, orientation) row, rows grouped by
    keypoint. Returns data (K n_ori, 9) [x, y, sigma, theta, response,
    frame], the normalized float descriptors (K n_ori, 128) and their
    uint8 quantization."""
    _, H, W = gauss.shape
    n_ori = theta.shape[1]
    K = x.shape[0]
    rep = lambda t: torch.repeat_interleave(t, n_ori, dim=0)  # noqa: E731
    xs, ys, ls, sg, rs = rep(x), rep(y), rep(lvl), rep(sigma), rep(response)
    th = theta.reshape(-1)
    c, s = torch.cos(th), torch.sin(th)
    rot = torch.stack([torch.stack([c, -s], -1), torch.stack([s, c], -1)], -2)
    if shapes is None:
        frames = sg[:, None, None] * rot
    else:
        frames = sg[:, None, None] * torch.einsum("kij,kjl->kil", rep(shapes), rot)
    grads = _gradient_stacks(gauss)
    scales = dsp_scales(options)
    acc = torch.zeros((K * n_ori, DESC_DIM), dtype=gauss.dtype, device=gauss.device)
    for f in scales:
        acc = acc + _raw_descriptors(grads, ls, xs, ys, frames * f, H, W)
    if len(scales) > 1:
        acc = acc / len(scales)
    desc = normalize_descriptors(acc, options.normalization)
    data = torch.cat([xs[:, None], ys[:, None], sg[:, None], th[:, None], rs[:, None],
                      frames.reshape(-1, 4)], dim=1)
    return data, desc, quantize_descriptors(desc)


def affine_shapes_plain(gauss, x, y, lvl, sigma, options, guard=True):
    """colmap_tpu's Baumberg iteration (``affine_shape``, sift.py:472-527):
    (K, 2, 2) det-1 shape matrices; with ``guard`` False the shapes before
    the guard that turns a shape with an entry of 8 or more (or a
    non-finite one) into the identity (for checks near that guard)."""
    _, H, W = gauss.shape
    K = x.shape[0]
    dtype, dev = gauss.dtype, gauss.device
    grads = _gradient_stacks(gauss)
    _, pu, pv = _window(dtype, dev)
    w = torch.exp(-((pu**2 + pv**2) / (2.0 * (1.5 * R / 3.0) ** 2)))
    w_sum = torch.sum(w)
    eps = 1e-10
    A = torch.eye(2, dtype=dtype, device=dev).repeat(K, 1, 1)
    for _ in range(options.affine_shape_iterations):
        Wm = sigma[:, None, None] * A
        dx = Wm[:, 0, 0, None] * pv + Wm[:, 0, 1, None] * pu
        dy = Wm[:, 1, 0, None] * pv + Wm[:, 1, 1, None] * pu
        sgx = _bilinear(grads[0], lvl[:, None], y[:, None] + dy, x[:, None] + dx, H, W)
        sgy = _bilinear(grads[1], lvl[:, None], y[:, None] + dy, x[:, None] + dx, H, W)
        gv = A[:, 0, 0, None] * sgx + A[:, 1, 0, None] * sgy
        gu = A[:, 0, 1, None] * sgx + A[:, 1, 1, None] * sgy
        m_a = torch.sum(w * gv * gv, dim=1) / w_sum + eps
        m_b = torch.sum(w * gv * gu, dim=1) / w_sum
        m_c = torch.sum(w * gu * gu, dim=1) / w_sum + eps
        sq_det = torch.sqrt(torch.clamp(m_a * m_c - m_b * m_b, min=eps * eps))
        denom = torch.sqrt(torch.clamp(m_a + m_c + 2.0 * sq_det, min=eps))
        s11, s12, s22 = (m_a + sq_det) / denom, m_b / denom, (m_c + sq_det) / denom
        i11, i12, i22 = s22 / sq_det, -s12 / sq_det, s11 / sq_det
        Minv_sqrt = torch.stack([torch.stack([i11, i12], -1), torch.stack([i12, i22], -1)], -2)
        A_new = A @ Minv_sqrt
        det_A = A_new[:, 0, 0] * A_new[:, 1, 1] - A_new[:, 0, 1] * A_new[:, 1, 0]
        A = A_new / torch.sqrt(torch.clamp(torch.abs(det_A), min=eps))[:, None, None]
    if not guard:
        return A
    ok = torch.isfinite(A).all(dim=(1, 2)) & (A.abs().amax(dim=(1, 2)) < 8.0)
    return torch.where(ok[:, None, None], A, torch.eye(2, dtype=dtype, device=dev))


# ---------------------------------------------------------------------------
# CUDA wrappers.
# ---------------------------------------------------------------------------

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "sift_upsample2_f32": [_I, _I, _P, _P, _P],
    "sift_blur_rows_f32": [_I, _I, _I, _P, _P, _P, _P],
    "sift_blur_cols_f32": [_I, _I, _I, _P, _P, _P, _P, _P, _P],
    "sift_downsample2_f32": [_I, _I, _P, _P, _P],
    "sift_extrema_f32": [_I, _I, _I, _F, _F, _F, _F, _I, _P, _P, _P, _P, _P, _P, _P, _P],
    "sift_orientation_f32": [_I, _I, _I, _I, _I] + [_P] * 9,
    "sift_descriptor_f32": [_I, _I, _I, _I, _I, _I] + [_P] * 13,
    "sift_affine_shape_f32": [_I, _I, _I, _I] + [_P] * 7,
}


@functools.cache
def _lib():
    from colmap_tpu_torch.kernels.build import library

    lib = library()
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def _call(fn_name, *args):
    err = getattr(_lib(), fn_name)(*args)
    if err != 0:
        raise RuntimeError(f"{fn_name} failed to launch: CUDA error {err}")


f32, i32 = torch.float32, torch.int32
_p, _s = S._ptr, S._stream


def _image(img):
    dev = S._require_cuda(img)
    if img.dim() != 2:
        raise ValueError(f"expected an (H, W) image, got shape {tuple(img.shape)}")
    S._check("img", img, f32, tuple(img.shape), dev)
    return dev, img.shape[0], img.shape[1]


# K13 -----------------------------------------------------------------------


def upsample2(img):
    """K13: (H, W) -> (2H, 2W) bilinear, half-pixel centres, clamped edges."""
    if img.device.type == "cpu":
        return upsample2_plain(img)
    dev, H, W = _image(img)
    out = torch.empty((2 * H, 2 * W), dtype=f32, device=dev)
    _call("sift_upsample2_f32", H, W, _p(img), _p(out), _s(dev))
    LAUNCHES["sift_pyramid"] += 1
    return out


def _blur_into(src, sigma, out, dog=None):
    """K13's two passes: the row pass into scratch, then the column pass
    into ``out`` and, with ``dog``, dog = out - src in its epilogue."""
    dev, H, W = _image(src)
    taps = gaussian_taps(sigma, f32, dev)
    r = (taps.shape[0] - 1) // 2
    if r > MAX_RADIUS:
        raise NotImplementedError(f"blur sigma {sigma} needs radius {r} > {MAX_RADIUS}")
    tmp = torch.empty((H, W), dtype=f32, device=dev)
    _call("sift_blur_rows_f32", H, W, r, _p(taps), _p(src), _p(tmp), _s(dev))
    LAUNCHES["sift_pyramid"] += 1
    _call("sift_blur_cols_f32", H, W, r, _p(taps), _p(tmp), _p(src), _p(out), S._opt_ptr(dog),
          _s(dev))
    LAUNCHES["sift_pyramid"] += 1


def blur(img, sigma):
    """K13: separable Gaussian blur of (H, W), edges replicated."""
    if img.device.type == "cpu":
        return blur_plain(img, sigma)
    out = torch.empty_like(img)
    _blur_into(img, sigma, out)
    return out


def build_octave(img, options):
    """K13: Gaussian stack (S+3, H, W) and DoG (S+2, H, W) of one octave;
    each level is blurred from the one before, and its column pass writes
    the level and its DoG."""
    if img.device.type == "cpu":
        return build_octave_plain(img, options)
    dev, H, W = _image(img)
    sigmas = octave_sigmas(options)
    gauss = torch.empty((len(sigmas) + 1, H, W), dtype=f32, device=dev)
    dog = torch.empty((len(sigmas), H, W), dtype=f32, device=dev)
    gauss[0].copy_(img)
    for s, sigma in enumerate(sigmas):
        _blur_into(gauss[s], sigma, gauss[s + 1], dog[s])
    return gauss, dog


def downsample2(img):
    """K13: x[::2, ::2]."""
    if img.device.type == "cpu":
        return downsample2_plain(img)
    dev, H, W = _image(img)
    out = torch.empty(((H + 1) // 2, (W + 1) // 2), dtype=f32, device=dev)
    _call("sift_downsample2_f32", H, W, _p(img), _p(out), _s(dev))
    LAUNCHES["sift_pyramid"] += 1
    return out


# K14 -----------------------------------------------------------------------


def detect_extrema(dog, options, capacity: Optional[int] = None) -> Extrema:
    """K14: every 3x3x3 extremum of the inner DoG scales, refined.

    The kernel appends through one atomic counter into lists of
    ``capacity`` rows (by default a 32nd of the samples); when the count
    exceeds it, the lists are made that large and the kernel runs again,
    so nothing is cut."""
    if dog.device.type == "cpu":
        return detect_extrema_plain(dog, options)
    dev = S._require_cuda(dog)
    S2, H, W = dog.shape
    S._check("dog", dog, f32, (S2, H, W), dev)
    n_inner = (S2 - 2) * H * W
    if n_inner >= 2**31:
        raise ValueError(f"octave of {n_inner} samples exceeds the kernel's int32 index")
    if capacity is None:
        capacity = max(1 << 14, n_inner // 32)
    counter = torch.zeros(1, dtype=i32, device=dev)
    while True:
        score = torch.empty(capacity, dtype=f32, device=dev)
        flat = torch.empty(capacity, dtype=i32, device=dev)
        rows = torch.empty((capacity, 5), dtype=f32, device=dev)
        lvl = torch.empty(capacity, dtype=i32, device=dev)
        keep = torch.empty(capacity, dtype=torch.uint8, device=dev)
        r = options.edge_threshold
        _call("sift_extrema_f32", S2 - 2, H, W, 0.8 * options.peak_threshold,
              options.peak_threshold, (r + 1) ** 2 / r, options.sigma0, capacity, _p(dog),
              _p(counter), _p(score), _p(flat), _p(rows), _p(lvl), _p(keep), _s(dev))
        LAUNCHES["sift_extrema"] += 1
        n = int(counter.item())
        if n <= capacity:
            break
        capacity = n
        counter.zero_()
    return Extrema(score[:n], flat[:n].to(torch.int64), rows[:n], lvl[:n], keep[:n].bool())


# K15 -----------------------------------------------------------------------


def _keypoints(gauss, x, y, lvl, sigma):
    dev = S._require_cuda(gauss)
    S._check("gauss", gauss, f32, tuple(gauss.shape), dev)
    K = x.shape[0]
    for name, t in (("x", x), ("y", y), ("sigma", sigma)):
        S._check(name, t, f32, (K,), dev)
    S._check("lvl", lvl, i32, (K,), dev)
    if gauss.shape[1] < 2 or gauss.shape[2] < 2:
        raise ValueError(f"levels of shape {tuple(gauss.shape[1:])} are too small to sample")
    return dev, K


def _shapes(shapes, K, dev):
    if shapes is not None:
        S._check("shapes", shapes, f32, (K, 2, 2), dev)
    return S._opt_ptr(shapes)


def orientations(gauss, x, y, lvl, sigma, options, shapes=None):
    """K15: one warp per keypoint; theta (K, n_ori) and ok (K, n_ori) bool
    (with ``upright``, theta 0 and only the first row ok). ``shapes`` (K, 2,
    2): affine frames sigma A, or None for sigma I."""
    if gauss.device.type == "cpu":
        return orientations_plain(gauss, x, y, lvl, sigma, options, shapes)
    dev, K = _keypoints(gauss, x, y, lvl, sigma)
    n_ori = options.max_num_orientations
    theta = torch.empty((K, n_ori), dtype=f32, device=dev)
    ok = torch.empty((K, n_ori), dtype=torch.uint8, device=dev)
    if K:
        _call("sift_orientation_f32", K, gauss.shape[1], gauss.shape[2], n_ori,
              int(options.upright), _p(gauss), _p(x), _p(y), _p(sigma), _p(lvl),
              _shapes(shapes, K, dev), _p(theta), _p(ok), _s(dev))
        LAUNCHES["sift_orientation"] += 1
    return theta, ok.bool()


# K16 -----------------------------------------------------------------------


def descriptors(gauss, x, y, lvl, sigma, response, theta, ok, options, shapes=None):
    """K16: one warp per (keypoint, orientation) row; rows where ``ok`` is
    false are skipped (zeros). Returns data (K n_ori, 9) and uint8
    descriptors (K n_ori, 128). ``shapes`` (K, 2, 2): frames sigma A R(theta),
    or None for sigma R(theta)."""
    if gauss.device.type == "cpu":
        data, _, desc = descriptors_plain(gauss, x, y, lvl, sigma, response, theta, options,
                                          shapes)
        return data, desc
    dev, K = _keypoints(gauss, x, y, lvl, sigma)
    n_ori = theta.shape[1]
    S._check("response", response, f32, (K,), dev)
    S._check("theta", theta, f32, (K, n_ori), dev)
    S._check("ok", ok, torch.bool, (K, n_ori), dev)
    data = torch.zeros((K * n_ori, ROW_COLS), dtype=f32, device=dev)
    desc = torch.zeros((K * n_ori, DESC_DIM), dtype=torch.uint8, device=dev)
    if K:
        scales = torch.tensor(dsp_scales(options), dtype=f32, device=dev)
        _call("sift_descriptor_f32", K, gauss.shape[1], gauss.shape[2], n_ori,
              int(options.normalization == "L2"), scales.shape[0], _p(scales), _p(gauss), _p(x),
              _p(y), _p(sigma), _p(response), _p(lvl), _p(theta), _shapes(shapes, K, dev), _p(ok),
              _p(data), _p(desc), _s(dev))
        LAUNCHES["sift_descriptor"] += 1
    return data, desc


# K45 -----------------------------------------------------------------------


def affine_shapes(gauss, x, y, lvl, sigma, options):
    """K45: Baumberg affine shapes (estimate_affine_shape), one warp per
    keypoint, ``affine_shape_iterations`` iterations; (K, 2, 2) det-1 shapes
    (the identity where the iteration does not stay finite and below 8)."""
    if gauss.device.type == "cpu":
        return affine_shapes_plain(gauss, x, y, lvl, sigma, options)
    dev, K = _keypoints(gauss, x, y, lvl, sigma)
    shapes = torch.empty((K, 2, 2), dtype=f32, device=dev)
    if K:
        _call("sift_affine_shape_f32", K, gauss.shape[1], gauss.shape[2],
              int(options.affine_shape_iterations), _p(gauss), _p(x), _p(y), _p(sigma), _p(lvl),
              _p(shapes), _s(dev))
        LAUNCHES["sift_affine_shape"] += 1
    return shapes
