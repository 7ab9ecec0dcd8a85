"""Synthetic inputs for the PatchMatch kernels K17-K20, made from a numpy seed.

As kernels/sift_cases.py does for K13-K16: the card tests hold each kernel
against its plain version on these inputs, and the CPU tests run the plain
versions on them.

``plane_case`` renders a reference view and S source views of a textured
slanted plane, exactly (each pixel's ray meets the plane; the texture is
smoothed noise sampled bilinearly at about one texel per pixel). The
sources sit on a ring around the reference, turned a few degrees, so that
no row or column of the reference maps exactly onto one of a source's
borders. With it come a PatchMatch state near the truth (depths within a
few percent, normals within about ten degrees), selection probabilities
and one half-iteration's draws.

``cost_ties``, ``geom_ties``, ``choice_ties`` and ``filter_ties`` mark the entries and
pixels where rounding decides a cost or a choice, so that a comparison of
a float32 kernel with its float64 plain version can leave them out.
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import numpy as np
import torch
from scipy.ndimage import gaussian_filter
from scipy.spatial.transform import Rotation


class PlaneCase(NamedTuple):
    problem: Dict[str, np.ndarray]  # PatchMatchProblem fields (float64), src_depths included
    gt_depth: np.ndarray  # (H, W) depth of the plane along each reference ray
    depth: np.ndarray  # (H, W) a state near the truth
    normal: np.ndarray  # (H, W, 3)
    sel_prob: np.ndarray  # (S, H, W)
    draws: Dict[str, np.ndarray]  # one half-iteration's draws (kernels.mvs.Draws fields)


def _render(K, R, t, H, W, plane_n, plane_c, texture, texel):
    """Intensity and depth of view (R, t) (x_cam = R x_ref + t) of the plane
    n . X = c (reference frame): rays through integer pixel coordinates, as
    the PatchMatch kernels index pixels."""
    ys, xs = np.mgrid[0:H, 0:W].astype(np.float64)
    rays = np.stack([xs, ys, np.ones_like(xs)], axis=-1) @ np.linalg.inv(K).T
    o = -R.T @ t
    d = rays @ R  # ray directions in the reference frame
    s = (plane_c - plane_n @ o) / (d @ plane_n)
    X = o + s[..., None] * d
    u = X[..., 0] / texel + texture.shape[1] / 2
    v = X[..., 1] / texel + texture.shape[0] / 2
    u0 = np.clip(np.floor(u).astype(np.int64), 0, texture.shape[1] - 2)
    v0 = np.clip(np.floor(v).astype(np.int64), 0, texture.shape[0] - 2)
    fu, fv = np.clip(u - u0, 0, 1), np.clip(v - v0, 0, 1)
    img = (texture[v0, u0] * (1 - fu) * (1 - fv) + texture[v0, u0 + 1] * fu * (1 - fv)
           + texture[v0 + 1, u0] * (1 - fu) * fv + texture[v0 + 1, u0 + 1] * fu * fv)
    return img, s  # s is the z-depth: rays have z = 1 in the camera frame


def plane_case(H: int, W: int, S: int, seed: int, depth_min=2.0, depth_max=10.0) -> PlaneCase:
    rng = np.random.default_rng(seed)
    f = 1.2 * W
    K = np.array([[f, 0.0, W / 2.0], [0.0, f, H / 2.0], [0.0, 0.0, 1.0]])
    normal = np.array([0.15, -0.1, -1.0])
    plane_n = normal / np.linalg.norm(normal)
    plane_c = plane_n @ np.array([0.0, 0.0, 5.0])
    texel = 5.0 / f  # about one texel per pixel at depth 5
    side = int(2 * max(H, W) + 64)
    texture = gaussian_filter(rng.uniform(0.0, 1.0, (side, side)), 1.0)
    texture = (texture - texture.min()) / (texture.max() - texture.min())
    ref, gt = _render(K, np.eye(3), np.zeros(3), H, W, plane_n, plane_c, texture, texel)
    srcs, Rs, ts, deps = [], [], [], []
    for k in range(S):
        a = 2 * np.pi * (k + 0.25) / S
        c = np.array([0.4 * np.cos(a), 0.3 * np.sin(a), 0.05 * np.sin(3 * a)])
        R = Rotation.from_rotvec(rng.normal(0.0, 0.03, 3)).as_matrix()
        t = -R @ c
        img, dep = _render(K, R, t, H, W, plane_n, plane_c, texture, texel)
        srcs.append(img)
        Rs.append(R)
        ts.append(t)
        deps.append(dep * (1.0 + 0.002 * rng.standard_normal((H, W))))
    problem = dict(ref_image=ref, src_images=np.stack(srcs), K_ref=K,
                   K_src=np.repeat(K[None], S, axis=0), R_rel=np.stack(Rs), t_rel=np.stack(ts),
                   src_depths=np.stack(deps))
    depth = np.clip(gt * (1.0 + 0.03 * rng.standard_normal((H, W))), depth_min, depth_max)
    nrm = plane_n + 0.15 * rng.standard_normal((H, W, 3))
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    nrm[..., 2] = -np.abs(nrm[..., 2])
    dn = rng.standard_normal((H, W, 3))
    dn /= np.linalg.norm(dn, axis=-1, keepdims=True)
    dn[..., 2] = -np.abs(dn[..., 2])
    draws = dict(depth=rng.uniform(depth_min, depth_max, (H, W)), normal=dn,
                 factor=rng.uniform(-1.0, 1.0, (H, W)), noise=rng.standard_normal((H, W, 3)))
    return PlaneCase(problem, gt, depth, nrm, rng.uniform(0.05, 0.95, (S, H, W)), draws)


def tensors(case: PlaneCase, device, dtype, geometric=False):
    """(problem, depth, normal, sel_prob, draws) of a case as tensors; the
    problem without source depths unless ``geometric``."""
    from colmap_tpu_torch.kernels.mvs import Draws
    from colmap_tpu_torch.mvs.patch_match import PatchMatchProblem

    def t(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype).to(device).contiguous()

    fields = {k: t(v) for k, v in case.problem.items()}
    if not geometric:
        fields["src_depths"] = None
    return (PatchMatchProblem(**fields), t(case.depth), t(case.normal), t(case.sel_prob),
            Draws(**{k: t(v) for k, v in case.draws.items()}))


def cost_ties(problem, depth, normal, options, tie_px):
    """(S, H, W) bool: where rounding decides ``costs_plain``'s photometric
    cost. It jumps where a tap crosses a source's border, where the window
    weight in bounds crosses one half, and where a tap's ray grazes the
    plane (a tap's depth num / (n . r) loses its digits as n . r nears 0).
    Marked: a tap within ``tie_px`` pixels of the border (Chebyshev
    distance to the in-bounds box), a tap in front of the camera by less
    than 10 ``tie_px`` of its distance, a tap's ray at a cosine under 10
    ``tie_px`` to the plane, or an in-bounds weight share within 1e-6 of
    one half (``geom_ties`` marks the geometric term's)."""
    from colmap_tpu_torch.kernels import mvs as K

    ref = problem.ref_image
    H, W = ref.shape
    _, _, ray0, Kinv = K.pixel_rays(problem.K_ref, H, W)
    offsets, w_sp = K.spatial_weights(options.window_radius, options.window_step,
                                      options.sigma_spatial)
    rows = torch.arange(H, device=ref.device)
    cols = torch.arange(W, device=ref.device)
    sw = torch.zeros((len(problem.src_images), H, W), dtype=ref.dtype, device=ref.device)
    w_sum = torch.zeros((H, W), dtype=ref.dtype, device=ref.device)
    tie = torch.zeros_like(sw, dtype=torch.bool)
    for (dy, dx), wsp in zip(offsets.tolist(), w_sp.tolist()):
        ref_k = ref[torch.clamp(rows + dy, 0, H - 1)][:, torch.clamp(cols + dx, 0, W - 1)]
        w = wsp * torch.exp(-((ref_k - ref) ** 2) / (2 * options.sigma_color ** 2))
        w_sum = w_sum + w
        r = ray0 + dx * Kinv[:, 0] + dy * Kinv[:, 1]
        X = r * K.plane_depth_at(depth, normal, ray0, r)[..., None]
        sx, sy, inb = K._project(problem, X, H, W)
        sw += torch.where(inb, w, 0.0)
        inside = torch.minimum(torch.minimum(sx, W - 1 - sx), torch.minimum(sy, H - 1 - sy))
        outside = torch.maximum(torch.maximum(-sx, sx - (W - 1)), torch.maximum(-sy, sy - (H - 1)))
        margin = torch.where(inside >= 0, inside, outside)
        Xs = torch.einsum("sij,...j->s...i", problem.R_rel, X) + problem.t_rel[:, None, None]
        z = torch.einsum("sj,s...j->s...", problem.K_src[:, 2], Xs)
        grazing = (torch.abs(torch.sum(normal * r, -1))
                   < 10 * tie_px * torch.linalg.vector_norm(r, dim=-1))
        tie |= ((margin < tie_px) | (torch.abs(z) < 10 * tie_px * torch.linalg.vector_norm(Xs, dim=-1))
                | grazing[None])
    return tie | (torch.abs(sw / (w_sum[None] + 1e-8) - 0.5) < 1e-6)


def geom_ties(problem, depth, tie_px, depth_step):
    """(S, H, W) bool: where the geometric term has a near-tie: the pixel
    projects within ``tie_px`` pixels of a source's border (Chebyshev
    distance to the in-bounds box), or next to a hole or a depth step of
    the source depth map: the 4 x 4 pixels around the sample hold depths
    both at or below 0 and above it, or positive depths spanning more than
    ``depth_step`` (relative); inside a hole both versions give the term's
    cap. A sample's
    depth moves the round trip by the views' parallax, hundreds of pixels a
    unit of relative depth, so there float32's position error in the sample
    decides the term. All False without source depths."""
    from colmap_tpu_torch.kernels import mvs as K

    H, W = depth.shape
    if problem.src_depths is None:
        return torch.zeros((len(problem.src_images), H, W), dtype=torch.bool,
                           device=depth.device)
    _, _, ray0, _ = K.pixel_rays(problem.K_ref, H, W)
    sx, sy, _ = K._project(problem, ray0 * depth[..., None], H, W)
    inside = torch.minimum(torch.minimum(sx, W - 1 - sx), torch.minimum(sy, H - 1 - sy))
    outside = torch.maximum(torch.maximum(-sx, sx - (W - 1)), torch.maximum(-sy, sy - (H - 1)))
    border = torch.where(inside >= 0, inside, outside) < tie_px
    y0 = torch.floor(torch.clamp(sy, 0, H - 1))
    x0 = torch.floor(torch.clamp(sx, 0, W - 1))
    near = torch.stack([K._bilinear_views(problem.src_depths, torch.clamp(y0 + a, 0, H - 1),
                                          torch.clamp(x0 + b, 0, W - 1))
                        for a in (-1, 0, 1, 2) for b in (-1, 0, 1, 2)])
    lo, hi = near.amin(dim=0), near.amax(dim=0)
    return border | ((lo <= 0) & (hi > 0)) | ((lo > 0) & (hi > (1.0 + depth_step) * lo))


def choice_ties(problem, depth, normal, cost, weights, draws, parity, perturbation, options,
                tie_px, gap, depth_step=None):
    """(H, W) bool: active pixels of a half-iteration whose choice rounding
    may decide, by the plain versions (run them in float64): a candidate
    plane's cost has a near-tie (``cost_ties``, and with ``depth_step``
    ``geom_ties``), or the two lowest of the incumbent's and
    the seven candidates' aggregated costs lie within ``gap``."""
    from colmap_tpu_torch.kernels import mvs as K

    H, W = depth.shape
    gy, gx = torch.meshgrid(torch.arange(H, device=depth.device),
                            torch.arange(W, device=depth.device), indexing="ij")
    aggs, tie = [cost], torch.zeros((H, W), dtype=torch.bool, device=depth.device)
    for d_c, n_c in K.candidates_plain(problem, depth, normal, draws, perturbation, options):
        aggs.append(K.aggregate(K.costs_plain(problem, d_c, n_c, options), weights))
        tie |= cost_ties(problem, d_c, n_c, options, tie_px).any(dim=0)
        if depth_step is not None:
            tie |= geom_ties(problem, d_c, tie_px, depth_step).any(dim=0)
    low = torch.sort(torch.stack(aggs), dim=0).values
    return (tie | (low[1] - low[0] < gap)) & ((gy + gx) % 2 == parity)


def filter_ties(problem, depth, normal, cost_all, sel_prob, options, eps, tie_px=None,
                depth_step=None, geom_eps=None):
    """(H, W) bool: pixels where a view's test in the consistency filter
    lies within ``eps`` of its threshold (cosines, selection probability or
    cost; the geometric error within ``geom_eps`` pixels, by default
    ``eps``) or, with ``tie_px`` and ``depth_step``, a ``geom_ties`` entry,
    by the plain versions (run them in float64)."""
    import math

    from colmap_tpu_torch.kernels import mvs as K

    cos_tri, cos_inc = K.viewing_angles_plain(problem, depth, normal)
    cos_min = math.cos(math.radians(options.filter_min_triangulation_angle_deg))
    near = (torch.abs(cos_tri - cos_min) < eps) | (torch.abs(cos_inc) < eps)
    if options.view_selection:
        thr = K.ncc_prob(1.0 - options.filter_min_ncc, options.ncc_sigma)
        near |= torch.abs(sel_prob - thr) < eps
    else:
        near |= torch.abs(cost_all - (1.0 - options.filter_min_ncc)) < eps
    if problem.src_depths is not None:
        geom = K.geom_costs_plain(problem, depth)
        near |= (torch.abs(geom - options.filter_geom_consistency_max_cost)
                 < (eps if geom_eps is None else geom_eps))
        if depth_step is not None:
            near |= geom_ties(problem, depth, tie_px, depth_step)
    return near.any(dim=0)
