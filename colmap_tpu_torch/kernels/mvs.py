"""PatchMatch stereo kernels: wrappers, plain versions, counts.

Four CUDA kernels carry the device programs of colmap_tpu/mvs/patch_match.py
(sources in ``colmap_tpu_torch/csrc``):

    K17 pm_cost            _per_view_costs (l.155) with _bilinear,
                           _plane_depth_at and _geom_consistency_cost:
                           the (S, H, W) cost of one plane per pixel
    K18 pm_iteration       _pm_iteration (l.452): one red-black
                           half-iteration, its seven candidates costed with
                           K17's device function and aggregated
    K19 pm_view_weights    _view_weights (l.415), and in its second mode
                           _consistency_filter (l.528)
    K20 pm_view_selection  _update_sel_prob (l.338): the HMM's forward and
                           backward messages along rows or columns

As the other kernel modules do, each wrapper runs the plain version when its
tensors lie on the CPU and launches the kernel when they lie on a CUDA
device; on a CUDA tensor it launches or raises. ``LAUNCHES`` counts kernel
launches by kernel name. The plain versions are written for any float
dtype: the tests run them in float64 against colmap_tpu.

A problem is the port's ``PatchMatchProblem`` (mvs/patch_match.py) or any
object with its fields: ref_image (H, W), src_images (S, H, W), K_ref (3,
3), K_src (S, 3, 3), R_rel (S, 3, 3), t_rel (S, 3) with x_src = R x_ref + t,
and src_depths (S, H, W) or None. All views share the reference's size, as
colmap_tpu stacks them into one array. Options are PatchMatchOptions.

Random draws are inputs: K18 and its plain version take the half-
iteration's four draws (``Draws``) as tensors, so the same numbers reach
both (JAX's stream cannot be reproduced in torch).

Borders: colmap_tpu propagates with ``jnp.roll``, so a border pixel's
neighbour is the pixel on the opposite edge; the port does the same.
"""

from __future__ import annotations

import ctypes
import functools
import math
import weakref
from typing import NamedTuple

import numpy as np
import torch

from colmap_tpu_torch.kernels import sfm as S
from colmap_tpu_torch.kernels.tally import ShapeTally

LAUNCHES = {"pm_cost": 0, "pm_iteration": 0, "pm_view_weights": 0, "pm_view_selection": 0}
# Launch shapes of the kernels above, counted where LAUNCHES is (kernels/tally.py).
SHAPES = ShapeTally()

MAX_VIEWS = 32  # K18's best-half sort and K19's per-view arrays live in registers
MAX_TAPS = 256  # K17's spatial weights live in shared memory
NO_CHANGE_PROB = 0.99999
UNIFORM_PROB = 0.5


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    SHAPES.reset()


class Draws(NamedTuple):
    """The random numbers of one half-iteration, in colmap_tpu's order."""

    depth: torch.Tensor  # (H, W) uniform in [depth_min, depth_max)
    normal: torch.Tensor  # (H, W, 3) random unit normals facing the camera
    factor: torch.Tensor  # (H, W) uniform in [-1, 1): the depth perturbation
    noise: torch.Tensor  # (H, W, 3) standard normal: the normal perturbation


# ---------------------------------------------------------------------------
# Plain versions.
# ---------------------------------------------------------------------------


def _mv(M, X):
    """M (3, 3) times each X (..., 3), as colmap_tpu's einsum."""
    return torch.einsum("ij,...j->...i", M, X)


def _safe_den(z):
    """colmap_tpu's ``jnp.where(jnp.abs(z) < 1e-8, 1e-8, z)``."""
    return torch.where(torch.abs(z) < 1e-8, torch.full_like(z, 1e-8), z)


def pixel_rays(K_ref, H, W):
    """Row and column grids (H, W) and the rays K⁻¹ (x, y, 1) (H, W, 3)."""
    dtype, dev = K_ref.dtype, K_ref.device
    gy, gx = torch.meshgrid(torch.arange(H, dtype=dtype, device=dev),
                            torch.arange(W, dtype=dtype, device=dev), indexing="ij")
    Kinv = torch.linalg.inv(K_ref)
    return gy, gx, _mv(Kinv, torch.stack([gx, gy, torch.ones_like(gx)], dim=-1)), Kinv


def plane_depth_at(d0, n, ray0, ray):
    """Depth along ``ray`` of the plane through d0 ray0 with normal n."""
    num = d0 * torch.sum(n * ray0, dim=-1)
    return num / _safe_den(torch.sum(n * ray, dim=-1))


def _project(problem, X, H, W):
    """Pixels (sx, sy) of the points X (..., 3) in every source view, each
    (S, ...), and the in-bounds mask."""
    Xs = torch.einsum("sij,...j->s...i", problem.R_rel, X)
    Xs = Xs + problem.t_rel.reshape((-1,) + (1,) * (X.dim() - 1) + (3,))
    ps = torch.einsum("sij,s...j->s...i", problem.K_src, Xs)
    z = _safe_den(ps[..., 2])
    sx, sy = ps[..., 0] / z, ps[..., 1] / z
    inb = (sx >= 0) & (sx <= W - 1) & (sy >= 0) & (sy <= H - 1) & (ps[..., 2] > 0)
    return sx, sy, inb


def _bilinear_views(imgs, y, x):
    """colmap_tpu's ``_bilinear`` of each view s of imgs (S, H, W) at
    (y[s], x[s]): the cell's corner clipped to [0, H-2] x [0, W-2], the
    fractions to [0, 1]."""
    S_, H, W = imgs.shape
    flat = imgs.reshape(S_, -1)
    y0 = torch.clamp(torch.floor(y).to(torch.int64), 0, H - 2)
    x0 = torch.clamp(torch.floor(x).to(torch.int64), 0, W - 2)
    fy = torch.clamp(y - y0, 0.0, 1.0)
    fx = torch.clamp(x - x0, 0.0, 1.0)
    i00 = (y0 * W + x0).reshape(S_, -1)

    def at(off):
        return torch.gather(flat, 1, i00 + off).reshape(y.shape)

    return (at(0) * (1 - fy) * (1 - fx) + at(1) * (1 - fy) * fx + at(W) * fy * (1 - fx)
            + at(W + 1) * fy * fx)


def geom_costs_plain(problem, depth):
    """colmap_tpu's ``_geom_consistency_cost``: (S, H, W) forward-backward
    reprojection error through each source's depth map, inf where the round
    trip leaves the image or a depth is not positive."""
    H, W = problem.ref_image.shape
    gy, gx, ray0, _ = pixel_rays(problem.K_ref, H, W)
    sx, sy, inb = _project(problem, ray0 * depth[..., None], H, W)
    d_src = _bilinear_views(problem.src_depths, torch.clamp(sy, 0, H - 1),
                            torch.clamp(sx, 0, W - 1))
    p_src = torch.stack([sx, sy, torch.ones_like(sx)], dim=-1)
    X_src = torch.einsum("sij,shwj->shwi", torch.linalg.inv(problem.K_src), p_src)
    X_src = X_src * d_src[..., None]
    X_back = torch.einsum("sji,shwj->shwi", problem.R_rel, X_src - problem.t_rel[:, None, None])
    p_back = _mv(problem.K_ref, X_back)
    zb = _safe_den(p_back[..., 2])
    err = torch.sqrt((p_back[..., 0] / zb - gx) ** 2 + (p_back[..., 1] / zb - gy) ** 2)
    ok = inb & (d_src > 0) & (p_back[..., 2] > 0)
    return torch.where(ok, err, torch.full_like(err, math.inf))


def spatial_weights(radius, step, sigma_spatial):
    """(K, 2) window taps (dy, dx), row by row as colmap_tpu orders them,
    and their spatial weights (float64)."""
    offsets = np.array([(dy, dx) for dy in range(-radius, radius + 1, step)
                        for dx in range(-radius, radius + 1, step)])
    return offsets, np.exp(-np.sum(offsets.astype(np.float64) ** 2, axis=1)
                           / (2 * sigma_spatial ** 2))


def costs_plain(problem, depth, normal, options):
    """K17's function: colmap_tpu's ``_per_view_costs``, the (S, H, W) cost
    of the plane (depth, normal) of every pixel in every source view:
    1 - clipped bilaterally weighted NCC over the plane-warped window, 2
    where under half of the window's weight lands inside the source, plus
    the clamped geometric term when the problem has source depths.
    kernels/mvs_cases.py ``cost_ties`` marks where rounding decides it."""
    ref = problem.ref_image
    H, W = ref.shape
    dtype, dev = ref.dtype, ref.device
    _, _, ray0, Kinv = pixel_rays(problem.K_ref, H, W)
    offsets, w_sp = spatial_weights(options.window_radius, options.window_step,
                                    options.sigma_spatial)
    rows = torch.arange(H, device=dev)
    cols = torch.arange(W, device=dev)
    zeros = torch.zeros((len(problem.src_images), H, W), dtype=dtype, device=dev)
    sw, swr, sws, swrr, swss, swrs = (zeros.clone() for _ in range(6))
    w_sum = torch.zeros((H, W), dtype=dtype, device=dev)
    two_sc2 = 2 * options.sigma_color ** 2
    for (dy, dx), wsp in zip(offsets.tolist(), w_sp.tolist()):
        ref_k = ref[torch.clamp(rows + dy, 0, H - 1)][:, torch.clamp(cols + dx, 0, W - 1)]
        w = wsp * torch.exp(-((ref_k - ref) ** 2) / two_sc2)
        w_sum = w_sum + w
        r = ray0 + dx * Kinv[:, 0] + dy * Kinv[:, 1]
        X = r * plane_depth_at(depth, normal, ray0, r)[..., None]
        sx, sy, inb = _project(problem, X, H, W)
        val = _bilinear_views(problem.src_images, torch.clamp(sy, 0, H - 1),
                              torch.clamp(sx, 0, W - 1))
        sv = torch.where(inb, val, 0.0)
        we = torch.where(inb, w, 0.0)
        sw += we
        swr += we * ref_k
        sws += we * sv
        swrr += we * ref_k * ref_k
        swss += we * sv * sv
        swrs += we * ref_k * sv
    sw_safe = sw + 1e-8
    mu_r = swr / sw_safe
    mu_s = sws / sw_safe
    var_r = torch.clamp(swrr / sw_safe - mu_r * mu_r, min=0.0)
    var_s = torch.clamp(swss / sw_safe - mu_s * mu_s, min=0.0)
    cov = swrs / sw_safe - mu_r * mu_s
    ncc = cov / torch.sqrt(torch.clamp(var_r * var_s, min=1e-10))
    frac_valid = sw / (w_sum[None] + 1e-8)
    cost = torch.where(frac_valid > 0.5, 1.0 - torch.clamp(ncc, -1.0, 1.0), 2.0)
    if problem.src_depths is not None:
        geom = torch.clamp(geom_costs_plain(problem, depth), max=options.geom_consistency_max_cost)
        cost = cost + options.geom_consistency_weight * geom
    return cost


def ncc_norm(ncc_sigma) -> float:
    """ComputeNCCCostNormFactor: the emission's normalization."""
    return 2.0 / (math.sqrt(2.0 * math.pi) * ncc_sigma * math.erf(math.sqrt(2.0) / ncc_sigma))


def ncc_prob(cost, ncc_sigma):
    """Emission likelihood of an NCC cost (ComputeNCCProb), of a tensor or a
    float."""
    exp = torch.exp if torch.is_tensor(cost) else math.exp
    return exp(-(cost * cost) / (2.0 * ncc_sigma ** 2)) * ncc_norm(ncc_sigma)


def update_sel_prob_plain(cost_all, sel_prob, axis, prev_weight, options):
    """K20's function: colmap_tpu's ``_update_sel_prob`` along H (``axis``
    0) or W (1) of (S, H, W): forward and backward messages of the hidden
    Markov chain, the posterior, blended with the previous map."""
    change = 1.0 - NO_CHANGE_PROB
    dim = 1 + axis
    em = torch.movedim(ncc_prob(cost_all, options.ncc_sigma), dim, 0)
    L = em.shape[0]
    alpha = torch.empty_like(em)
    beta = torch.empty_like(em)
    prev = torch.full(em.shape[1:], UNIFORM_PROB, dtype=em.dtype, device=em.device)
    for i in range(L):
        e = em[i]
        zn0 = (prev * change + (1.0 - prev) * NO_CHANGE_PROB) * UNIFORM_PROB
        zn1 = (prev * NO_CHANGE_PROB + (1.0 - prev) * change) * e
        prev = alpha[i] = zn1 / (zn0 + zn1)
    prev = torch.full(em.shape[1:], UNIFORM_PROB, dtype=em.dtype, device=em.device)
    for i in range(L - 1, -1, -1):
        e = em[i]
        zn0 = prev * e * change + (1.0 - prev) * UNIFORM_PROB * NO_CHANGE_PROB
        zn1 = prev * e * NO_CHANGE_PROB + (1.0 - prev) * UNIFORM_PROB * change
        prev = beta[i] = zn1 / (zn0 + zn1)
    alpha = torch.movedim(alpha, 0, dim)
    beta = torch.movedim(beta, 0, dim)
    zn0 = (1.0 - alpha) * (1.0 - beta)
    zn1 = alpha * beta
    return prev_weight * sel_prob + (1.0 - prev_weight) * (zn1 / (zn0 + zn1))


def viewing_angles_plain(problem, depth, normal):
    """cos(triangulation angle) and cos(incident angle), each (S, H, W)."""
    H, W = depth.shape
    _, _, ray0, _ = pixel_rays(problem.K_ref, H, W)
    X = ray0 * depth[..., None]
    C = -torch.einsum("sji,sj->si", problem.R_rel, problem.t_rel)
    SX = C[:, None, None, :] - X[None]
    inv_norm_SX = torch.rsqrt(torch.clamp(torch.sum(SX * SX, -1), min=1e-12))
    inv_norm_X = torch.rsqrt(torch.clamp(torch.sum(X * X, -1), min=1e-12))
    cos_inc = torch.sum(SX * normal[None], -1) * inv_norm_SX
    cos_tri = -torch.sum(SX * X[None], -1) * inv_norm_X[None] * inv_norm_SX
    return cos_tri, cos_inc


def resolution_prob_plain(problem, depth, normal, options):
    """Footprint ratio of the window's corners in each source, (S, H, W)."""
    H, W = depth.shape
    R = options.window_radius
    _, _, ray0, Kinv = pixel_rays(problem.K_ref, H, W)
    corners = [(-R, -R), (R, -R), (R, R), (-R, R)]
    Xc = []
    for dy, dx in corners:
        r = ray0 + dx * Kinv[:, 0] + dy * Kinv[:, 1]
        Xc.append(r * plane_depth_at(depth, normal, ray0, r)[..., None])
    pts = [_project(problem, X, H, W)[:2] for X in Xc]
    area = torch.zeros((len(problem.R_rel), H, W), dtype=depth.dtype, device=depth.device)
    for i in range(4):
        (ax, ay), (bx, by) = pts[i], pts[(i + 1) % 4]
        area = area + (ax * by - bx * ay)
    src_area = 0.5 * torch.abs(area)
    ref_area = float((2 * R) * (2 * R))
    ratio = torch.minimum(src_area / ref_area, ref_area / torch.clamp(src_area, min=1e-8))
    return torch.clamp(ratio, 0.0, 1.0)


def view_weights_plain(problem, depth, normal, sel_prob, options):
    """K19's first mode: colmap_tpu's ``_view_weights``, the selection
    probabilities times the triangulation, incidence and resolution priors,
    normalized over the views (uniform where their total is <= 1e-6)."""
    cos_tri, cos_inc = viewing_angles_plain(problem, depth, normal)
    cos_min = math.cos(math.radians(options.min_triangulation_angle_deg))
    scaled = 1.0 - (1.0 - cos_tri) / (1.0 - cos_min)
    tri = torch.where(cos_tri > cos_min, torch.clamp(1.0 - scaled * scaled, 0.0, 1.0), 1.0)
    x = 1.0 - torch.clamp(cos_inc, min=0.0)
    inc = torch.exp(-(x * x) / (2.0 * options.incident_angle_sigma ** 2))
    w = sel_prob * tri * inc * resolution_prob_plain(problem, depth, normal, options)
    total = torch.sum(w, dim=0, keepdim=True)
    return torch.where(total > 1e-6, w / torch.clamp(total, min=1e-6), 1.0 / w.shape[0])


def consistency_filter_plain(problem, depth, normal, cost_all, sel_prob, options):
    """K19's second mode: colmap_tpu's ``_consistency_filter``. Returns the
    filtered depth (H, W) and normal (H, W, 3), zero where fewer than
    filter_min_num_consistent views are consistent, and the (S, H, W) bool
    mask of consistent views at kept pixels."""
    cos_tri, cos_inc = viewing_angles_plain(problem, depth, normal)
    cos_min = math.cos(math.radians(options.filter_min_triangulation_angle_deg))
    consistent = (cos_tri <= cos_min) & (cos_inc > 0.0)
    if options.view_selection:
        consistent &= sel_prob >= ncc_prob(1.0 - options.filter_min_ncc, options.ncc_sigma)
    else:
        consistent &= cost_all <= 1.0 - options.filter_min_ncc
    if problem.src_depths is not None:
        consistent &= geom_costs_plain(problem, depth) <= options.filter_geom_consistency_max_cost
    keep = torch.sum(consistent, dim=0) >= options.filter_min_num_consistent
    return (torch.where(keep, depth, 0.0), torch.where(keep[..., None], normal, 0.0),
            consistent & keep[None])


def aggregate(cost_all, weights):
    """Expected cost under the view weights; the mean of the best half of
    the views when there are no weights (view_selection=False)."""
    if weights is None:
        k = max(1, cost_all.shape[0] // 2)
        return torch.mean(torch.sort(cost_all, dim=0).values[:k], dim=0)
    return torch.sum(weights * cost_all, dim=0)


def normalize_normals(v):
    """Unit normals facing the camera (nz <= 0), as ``_random_normals``."""
    v = v / torch.clamp(torch.linalg.vector_norm(v, dim=-1, keepdim=True), min=1e-8)
    return torch.cat([v[..., :2], -torch.abs(v[..., 2:])], dim=-1)


def candidates_plain(problem, depth, normal, draws: Draws, perturbation, options):
    """The seven candidate planes of ``_pm_iteration``, in its order."""
    H, W = depth.shape
    _, _, ray0, _ = pixel_rays(problem.K_ref, H, W)
    out = []
    for dy, dx in ((0, 1), (0, -1), (1, 0), (-1, 0)):
        nd = torch.roll(depth, (-dy, -dx), dims=(0, 1))
        nn = torch.roll(normal, (-dy, -dx), dims=(0, 1))
        n_ray = torch.roll(ray0, (-dy, -dx), dims=(0, 1))
        d = torch.clamp(plane_depth_at(nd, nn, n_ray, ray0), options.depth_min,
                        options.depth_max)
        out.append((d, nn))
    out.append((draws.depth, draws.normal))
    pert = 1.0 + perturbation * draws.factor
    out.append((torch.clamp(depth * pert, options.depth_min, options.depth_max), normal))
    out.append((depth, normalize_normals(normal + perturbation * draws.noise)))
    return out


def iteration_plain(problem, depth, normal, cost, cost_all, weights, draws: Draws, parity,
                    perturbation, options):
    """K18's function: the plane update of ``_pm_iteration`` at pixels with
    (y + x) % 2 == parity, given the view weights (None: best-half mean).
    Returns (depth, normal, cost, cost_all)."""
    H, W = depth.shape
    gy, gx = torch.meshgrid(torch.arange(H, device=depth.device),
                            torch.arange(W, device=depth.device), indexing="ij")
    active = (gy + gx) % 2 == parity
    best = (depth, normal, cost, cost_all)
    for d_c, n_c in candidates_plain(problem, depth, normal, draws, perturbation, options):
        ca = costs_plain(problem, d_c, n_c, options)
        c_c = aggregate(ca, weights)
        better = (c_c < best[2]) & active
        best = (torch.where(better, d_c, best[0]), torch.where(better[..., None], n_c, best[1]),
                torch.where(better, c_c, best[2]), torch.where(better[None], ca, best[3]))
    return best


# ---------------------------------------------------------------------------
# CUDA wrappers.
# ---------------------------------------------------------------------------

_P, _I, _F, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_double
_SIGNATURES = {
    "pm_cost_f32": [_I, _I, _I, _I, _I, _F, _F, _F, _P, _P, _P, _P, _P, _P, _P, _P, _P],
    "pm_iteration_f32": [_I, _I, _I, _I, _I, _F, _F, _F, _I, _F, _F, _F, _I, _I, _I] + [_P] * 18,
    "pm_sources_create": [_I, _I, _I, _P, _P, ctypes.POINTER(_P)],
    "pm_sources_destroy": [_P],
    "pm_view_weights_f32": [_I, _I, _I, _I, _D, _D, _P, _P, _P, _P, _P, _P],
    "pm_consistency_filter_f32": [_I, _I, _I, _I, _D, _F, _F, _I] + [_P] * 10,
    "pm_view_selection_f32": [_I, _I, _I, _I, _F, _F, _F, _P, _P, _P, _P],
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


f32 = torch.float32
_p, _s = S._ptr, S._stream


def _shapes(problem):
    """Check the problem's tensors for the kernels; returns (device, S, H, W)."""
    dev = S._require_cuda(problem.ref_image)
    H, W = problem.ref_image.shape
    Sv = problem.src_images.shape[0]
    if problem.src_images.dim() != 3 or tuple(problem.src_images.shape[1:]) != (H, W):
        raise ValueError(f"every source view must be {H} x {W} like the reference, got "
                         f"{tuple(problem.src_images.shape)}")
    if not 1 <= Sv <= MAX_VIEWS:
        raise ValueError(f"the kernels take 1 to {MAX_VIEWS} source views, got {Sv}")
    if H < 2 or W < 2 or Sv * H * W >= 2**31:
        raise ValueError(f"problem of {Sv} x {H} x {W} is outside the kernels' range")
    S._check("ref_image", problem.ref_image, f32, (H, W), dev)
    S._check("src_images", problem.src_images, f32, (Sv, H, W), dev)
    if problem.src_depths is not None:
        S._check("src_depths", problem.src_depths, f32, (Sv, H, W), dev)
    return dev, Sv, H, W


def _cams(problem):
    """[K_ref, K_ref⁻¹, then per view R, t, K, K⁻¹, K R K_ref⁻¹, K t] as one
    float64 vector (18 + 42 S), the kernels' cameras (``inv_ex``: no sync
    to check the inverses)."""
    Kr = problem.K_ref.double()
    Ks = problem.K_src.double()
    R = problem.R_rel.double()
    t = problem.t_rel.double()
    Kr_inv = torch.linalg.inv_ex(Kr)[0]
    per_view = torch.cat([R.reshape(-1, 9), t, Ks.reshape(-1, 9),
                          torch.linalg.inv_ex(Ks)[0].reshape(-1, 9),
                          (Ks @ R @ Kr_inv).reshape(-1, 9),
                          torch.einsum("sij,sj->si", Ks, t)], dim=1)
    return torch.cat([Kr.reshape(9), Kr_inv.reshape(9), per_view.reshape(-1)]).contiguous()


@functools.lru_cache(maxsize=16)
def _taps(radius, step, sigma_spatial, device):
    w = spatial_weights(radius, step, sigma_spatial)[1]
    if len(w) > MAX_TAPS:
        raise ValueError(f"a window of {len(w)} taps exceeds the kernels' {MAX_TAPS}")
    return torch.tensor(w, dtype=f32, device=device)


def _window(options, dev):
    return (options.window_radius, options.window_step,
            _taps(options.window_radius, options.window_step, options.sigma_spatial, str(dev)))


def _plane(name_d, depth, name_n, normal, dev, H, W):
    S._check(name_d, depth, f32, (H, W), dev)
    S._check(name_n, normal, f32, (H, W, 3), dev)


def _geom_args(problem, options):
    if problem.src_depths is None:
        return 0.0, 0.0
    return options.geom_consistency_weight, options.geom_consistency_max_cost


def costs(problem, depth, normal, options):
    """K17: (S, H, W) cost of every pixel's plane in every source view; one
    thread a (view, pixel)."""
    if problem.ref_image.device.type == "cpu":
        return costs_plain(problem, depth, normal, options)
    dev, Sv, H, W = _shapes(problem)
    cams = _cams(problem)  # held until the launch is queued
    _plane("depth", depth, "normal", normal, dev, H, W)
    R, step, taps = _window(options, dev)
    gw, gmax = _geom_args(problem, options)
    out = torch.empty((Sv, H, W), dtype=f32, device=dev)
    _call("pm_cost_f32", Sv, H, W, R, step, 1.0 / (2 * options.sigma_color ** 2), gw, gmax,
          _p(cams), _p(taps), _p(problem.ref_image), _p(problem.src_images),
          S._opt_ptr(problem.src_depths), _p(depth), _p(normal), _p(out), _s(dev))
    LAUNCHES["pm_cost"] += 1
    return out


class IterationPlan(NamedTuple):
    """K18's launch (pm_iteration.cu): the instantiation, the view bucket
    and the block's dynamic shared bytes."""

    fixed_window: bool  # the compile-time window (R 2, step 1), else the generic one
    bucket: int  # per-view arrays of 8, 16 or 32 registers
    smem_bytes: int  # the reference tile with its R halo, and the fixed window's taps


# A K18 block: ITER_TILE_Y rows x ITER_TILE_X active pixels (pm_iteration.cu
# kTileY, kTileX); its reference tile and halo stay under ITER_SMEM_MAX
# bytes of shared memory beside the cameras (an H100 block has 227 KB). At
# the compile-time window (R 2, step 1: 25 taps) each thread also keeps its
# taps' weights and deviations there.
ITER_TILE_X, ITER_TILE_Y = 32, 8
ITER_SMEM_MAX = 200 * 1024
ITER_FIXED_TAPS = 25


def iteration_plan(views: int, radius: int, step: int) -> IterationPlan:
    """K18's launch plan for S = ``views`` sources and a window of
    ``radius`` and ``step``."""
    if not 1 <= views <= MAX_VIEWS:
        raise ValueError(f"K18 takes 1 to {MAX_VIEWS} source views, got {views}")
    bucket = next(b for b in (8, 16, 32) if views <= b)
    fixed = (radius, step) == (2, 1)
    smem = 4 * (ITER_TILE_Y + 2 * radius) * (2 * ITER_TILE_X + 2 * radius)
    if smem > ITER_SMEM_MAX:
        raise ValueError(f"a window of radius {radius} needs {smem} bytes of K18's tile, over "
                         f"{ITER_SMEM_MAX}")
    if fixed:
        smem += 2 * 4 * ITER_FIXED_TAPS * ITER_TILE_X * ITER_TILE_Y
    return IterationPlan(fixed, bucket, smem)


class _SourceSet:
    """A problem's source images as K18 reads them: gather textures over a
    copy in CUDA arrays (``pm_sources_create``), freed with the tensor."""

    def __init__(self, src):
        handle = _P()
        Sv, H, W = src.shape
        _call("pm_sources_create", Sv, H, W, _p(src), _s(src.device), ctypes.byref(handle))
        self.handle, self.key = handle, _source_key(src)
        self.free = weakref.finalize(src, _lib().pm_sources_destroy, handle)
        self.free.atexit = False  # the process's end frees them


def _source_key(src):
    return src.data_ptr(), tuple(src.shape), src.device, src._version


# The last problem's sources, made once and reused by its half-iterations.
_SOURCES: dict = {}


def _sources(src) -> _SourceSet:
    held = _SOURCES.get("set")
    if held is not None and held.key == _source_key(src) and held.free.alive:
        return held
    if held is not None:
        held.free()
    _SOURCES["set"] = _SourceSet(src)
    return _SOURCES["set"]


def iteration(problem, depth, normal, cost, cost_all, weights, draws: Draws, parity,
              perturbation, options):
    """K18: one red-black half-iteration of the planes at (y + x) % 2 ==
    parity, one thread an active pixel in tiles of ``iteration_plan``; the
    others are copied. ``weights`` (S, H, W) from K19, or None for the
    best-half mean. The sources are read through textures made once per
    problem (``_sources``). Returns (depth, normal, cost, cost_all), new
    tensors."""
    if depth.device.type == "cpu":
        return iteration_plain(problem, depth, normal, cost, cost_all, weights, draws, parity,
                               perturbation, options)
    dev, Sv, H, W = _shapes(problem)
    cams = _cams(problem)  # held until the launch is queued
    _plane("depth", depth, "normal", normal, dev, H, W)
    S._check("cost", cost, f32, (H, W), dev)
    S._check("cost_all", cost_all, f32, (Sv, H, W), dev)
    if weights is not None:
        S._check("weights", weights, f32, (Sv, H, W), dev)
    _plane("draws.depth", draws.depth, "draws.normal", draws.normal, dev, H, W)
    _plane("draws.factor", draws.factor, "draws.noise", draws.noise, dev, H, W)
    R, step, taps = _window(options, dev)
    plan = iteration_plan(Sv, R, step)
    sources = _sources(problem.src_images)
    gw, gmax = _geom_args(problem, options)
    out = (depth.clone(), normal.clone(), cost.clone(), cost_all.clone())
    _call("pm_iteration_f32", Sv, H, W, R, step, 1.0 / (2 * options.sigma_color ** 2), gw, gmax,
          int(parity), float(perturbation), options.depth_min, options.depth_max,
          int(plan.fixed_window), plan.bucket, plan.smem_bytes,
          _p(cams), _p(taps), _p(problem.ref_image), _p(problem.src_images), sources.handle,
          S._opt_ptr(problem.src_depths), S._opt_ptr(weights), _p(draws.depth),
          _p(draws.normal), _p(draws.factor), _p(draws.noise), _p(depth), _p(normal),
          *map(_p, out), _s(dev))
    LAUNCHES["pm_iteration"] += 1
    SHAPES.add("pm_iteration", "weights" if weights is not None else "best_half",
               (Sv, H, W, len(taps), problem.src_depths is not None), iteration,
               (problem, depth, normal, cost, cost_all, weights, draws, parity, perturbation,
                options))
    return out


def view_weights(problem, depth, normal, sel_prob, options):
    """K19, weights mode: (S, H, W) normalized view weights; one thread a
    pixel."""
    if depth.device.type == "cpu":
        return view_weights_plain(problem, depth, normal, sel_prob, options)
    dev, Sv, H, W = _shapes(problem)
    cams = _cams(problem)  # held until the launch is queued
    _plane("depth", depth, "normal", normal, dev, H, W)
    S._check("sel_prob", sel_prob, f32, (Sv, H, W), dev)
    out = torch.empty((Sv, H, W), dtype=f32, device=dev)
    _call("pm_view_weights_f32", Sv, H, W, options.window_radius,
          math.cos(math.radians(options.min_triangulation_angle_deg)),
          1.0 / (2.0 * options.incident_angle_sigma ** 2), _p(cams), _p(depth),
          _p(normal), _p(sel_prob), _p(out), _s(dev))
    LAUNCHES["pm_view_weights"] += 1
    return out


def consistency_filter(problem, depth, normal, cost_all, sel_prob, options):
    """K19, filter mode: (depth, normal) zeroed where fewer than
    filter_min_num_consistent views are consistent, and the (S, H, W) bool
    mask; one thread a pixel, the geometric term by K17's device
    function."""
    if depth.device.type == "cpu":
        return consistency_filter_plain(problem, depth, normal, cost_all, sel_prob, options)
    dev, Sv, H, W = _shapes(problem)
    cams = _cams(problem)  # held until the launch is queued
    _plane("depth", depth, "normal", normal, dev, H, W)
    S._check("cost_all", cost_all, f32, (Sv, H, W), dev)
    S._check("sel_prob", sel_prob, f32, (Sv, H, W), dev)
    if options.view_selection:
        threshold = ncc_prob(1.0 - options.filter_min_ncc, options.ncc_sigma)
    else:
        threshold = 1.0 - options.filter_min_ncc
    depth_f = torch.empty_like(depth)
    normal_f = torch.empty_like(normal)
    mask = torch.empty((Sv, H, W), dtype=torch.bool, device=dev)
    _call("pm_consistency_filter_f32", Sv, H, W, int(options.view_selection),
          math.cos(math.radians(options.filter_min_triangulation_angle_deg)), threshold,
          options.filter_geom_consistency_max_cost, options.filter_min_num_consistent,
          _p(cams), S._opt_ptr(problem.src_depths), _p(depth), _p(normal),
          _p(cost_all), _p(sel_prob), _p(depth_f), _p(normal_f), _p(mask), _s(dev))
    LAUNCHES["pm_view_weights"] += 1
    return depth_f, normal_f, mask


def update_sel_prob(cost_all, sel_prob, axis, prev_weight, options):
    """K20: the view-selection posterior along H (``axis`` 0: one thread a
    (view, column)) or W (1: one thread a (view, row)), blended with the
    previous map."""
    if cost_all.device.type == "cpu":
        return update_sel_prob_plain(cost_all, sel_prob, axis, prev_weight, options)
    dev = S._require_cuda(cost_all)
    Sv, H, W = cost_all.shape
    S._check("cost_all", cost_all, f32, (Sv, H, W), dev)
    S._check("sel_prob", sel_prob, f32, (Sv, H, W), dev)
    if axis not in (0, 1):
        raise ValueError(f"axis must be 0 (along H) or 1 (along W), got {axis}")
    out = torch.empty_like(sel_prob)
    _call("pm_view_selection_f32", Sv, H, W, int(axis), float(prev_weight),
          1.0 / (2.0 * options.ncc_sigma ** 2), ncc_norm(options.ncc_sigma), _p(cost_all),
          _p(sel_prob), _p(out), _s(dev))
    LAUNCHES["pm_view_selection"] += 1
    SHAPES.add("pm_view_selection", "along_" + "HW"[axis], (Sv, H, W), update_sel_prob,
               (cost_all, sel_prob, axis, prev_weight, options))
    return out
