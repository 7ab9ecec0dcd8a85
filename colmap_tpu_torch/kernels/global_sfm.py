"""Global-SfM kernels: wrappers, plain PyTorch versions, launch counts.

Four CUDA kernels carry the device programs of the global mapper
(sources in ``colmap_tpu_torch/csrc``):

    K21 rotation_averaging      ra_edge_pass, ra_matvec, ra_update
    K22 global_positioning      gp_setup, gp_schur_matvec, gp_back_substitute
    K23 view_graph_calibration  vgc_loss_grad (and vgc_loss, its autograd form)
    K39 global_cg               cg_setup, cg_step: the Jacobi-preconditioned CG
                                around K21 (b) (rotation mode) and K22 (b)
                                (positioning mode, with the freeze rule)

Each wrapper runs the plain version when its tensors lie on the CPU and
launches the kernel when they lie on a CUDA device; on a CUDA tensor it
launches or raises, it never falls back. ``LAUNCHES`` counts kernel launches
by kernel name (a wrapper adds one where it launches, nowhere else). The
plain versions sum with ``index_add_``; the CPU tests run them in float64
against colmap_tpu, and a check on the card holds the kernels against them.

Graphs and problems (``ra_graph``, ``gp_problem``, ``vgc_graph``) are built
once per solve on the solve's device: the index lists are sorted into CSR
by node, point and camera there, so that every kernel sum is a gather over
a list in a fixed order and never a float atomic.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from colmap_tpu_torch.geometry import rotation as rot
from colmap_tpu_torch.kernels import sfm as S
from colmap_tpu_torch.kernels.tally import ShapeTally

LAUNCHES = {
    "rotation_averaging": 0,
    "global_positioning": 0,
    "view_graph_calibration": 0,
    "global_cg": 0,
}
# Launch shapes of the kernels above, counted where LAUNCHES is (kernels/tally.py).
SHAPES = ShapeTally()

f32, f64, i32 = torch.float32, torch.float64, torch.int32


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    SHAPES.reset()


def _segment_sum(contrib, ids, n):
    return contrib.new_zeros((n,) + contrib.shape[1:]).index_add_(0, ids, contrib)


def csr(keys, num_rows: int):
    """(offsets (num_rows + 1,), order) int32 of ``keys`` sorted stably, on
    their device: rows[order[offsets[r]:offsets[r + 1]]] == r."""
    keys = keys.long()
    order = torch.argsort(keys, stable=True)
    counts = torch.bincount(keys, minlength=num_rows)
    offsets = torch.zeros(num_rows + 1, dtype=torch.long, device=keys.device)
    offsets[1:] = torch.cumsum(counts, 0)
    return offsets.to(i32), order.to(i32)


# ---------------------------------------------------------------------------
# K21: rotation averaging.
# ---------------------------------------------------------------------------


class RAGraph(NamedTuple):
    """A view graph of relative rotations on one device. ``inc`` lists each
    node's incident edges, node by node (``offsets``): 2e + 1 where the node
    is edge e's j, 2e where it is its i."""

    edges: torch.Tensor  # (E, 2) int32 [i, j]
    rel_quats: torch.Tensor  # (E, 4) q_j = q_rel ⊗ q_i
    offsets: torch.Tensor  # (N + 1,) int32
    inc: torch.Tensor  # (2E,) int32
    free: torch.Tensor  # (N,) 1 free, 0 gauge-fixed
    proj: Optional[torch.Tensor]  # (N, 3, 3) tangent projectors, or None


class RAStep(NamedTuple):
    """K21 (a)'s results: ``ew`` holds w · R_jᵀ r and w per edge (the
    weights (b) reads), ``b`` and ``deg`` the constrained right-hand side and
    Jacobi degree per node, ``cost`` Σ |r|."""

    ew: torch.Tensor  # (E, 4)
    b: torch.Tensor  # (N, 3)
    deg: torch.Tensor  # (N,)
    cost: torch.Tensor  # 0-d


def ra_graph(num_nodes: int, edges, rel_quats, free, proj=None) -> RAGraph:
    edges = edges.to(i32).contiguous()
    E = edges.shape[0]
    codes = torch.arange(E, dtype=torch.long, device=edges.device) * 2
    offsets, order = csr(torch.cat([edges[:, 0], edges[:, 1]]), num_nodes)
    inc = torch.cat([codes, codes + 1])[order.long()].to(i32)
    return RAGraph(edges, rel_quats.contiguous(), offsets, inc.contiguous(), free.contiguous(),
                   None if proj is None else proj.contiguous())


def quat_log(q):
    """Unit quaternion -> so(3) tangent (..., 3) (colmap_tpu's _quat_log)."""
    q = rot.quat_normalize(q)
    q = q * torch.where(q[..., :1] < 0, -1.0, 1.0)
    w = torch.clamp(q[..., 0], -1.0, 1.0)
    v = q[..., 1:]
    vn = torch.linalg.vector_norm(v, dim=-1)
    angle = 2.0 * torch.atan2(vn, w)
    scale = torch.where(vn > 1e-12, angle / torch.clamp(vn, min=1e-30), 2.0)
    return v * scale[..., None]


def quat_exp(w):
    """so(3) tangent -> quaternion (colmap_tpu's _quat_exp)."""
    theta = torch.linalg.vector_norm(w, dim=-1, keepdim=True)
    half = 0.5 * theta
    sinc = torch.where(theta > 1e-12, torch.sin(half) / torch.clamp(theta, min=1e-30), 0.5)
    return torch.cat([torch.cos(half), sinc * w], dim=-1)


def edge_residuals(quats, edges, rel_quats):
    """r_e = Log(q_rel ⊗ q_i ⊗ q_j⁻¹), zero when consistent."""
    e = edges.long()
    pred = rot.quat_multiply(rel_quats, quats[e[:, 0]])
    err = rot.quat_multiply(pred, rot.quat_conjugate(rot.quat_normalize(quats[e[:, 1]])))
    return quat_log(err)


def _constrain(x, free, proj):
    x = x * free[:, None]
    return x if proj is None else torch.einsum("nde,ne->nd", proj, x)


def ra_edge_pass_plain(graph: RAGraph, quats, use_l1: bool, sigma: float) -> RAStep:
    """K21 (a)'s function: residuals, weights (L1 or Geman-McClure), the
    constrained right-hand side, the degrees and Σ |r|."""
    e = graph.edges.long()
    N = quats.shape[0]
    r = edge_residuals(quats, graph.edges, graph.rel_quats)
    rn = torch.linalg.vector_norm(r, dim=-1)
    r_world = rot.quat_rotate(rot.quat_conjugate(rot.quat_normalize(quats[e[:, 1]])), r)
    if use_l1:
        w = 1.0 / torch.clamp(rn, min=1e-5)
    else:
        w = sigma ** 2 / (rn ** 2 + sigma ** 2) ** 2
    wr = r_world * w[:, None]
    b = _segment_sum(wr, e[:, 1], N) - _segment_sum(wr, e[:, 0], N)
    deg = _segment_sum(w, e[:, 0], N) + _segment_sum(w, e[:, 1], N)
    return RAStep(torch.cat([wr, w[:, None]], dim=1), _constrain(b, graph.free, graph.proj),
                  deg, rn.sum())


def ra_matvec_plain(graph: RAGraph, ew, x):
    """K21 (b)'s function: constrain(Lᵀ W L x) with the weights ew[:, 3]."""
    e = graph.edges.long()
    d = (x[e[:, 1]] - x[e[:, 0]]) * ew[:, 3:]
    out = _segment_sum(d, e[:, 1], x.shape[0]) - _segment_sum(d, e[:, 0], x.shape[0])
    return _constrain(out, graph.free, graph.proj)


def ra_update_plain(quats, delta):
    """K21 (c)'s function: normalize(q ⊗ Exp(δ))."""
    return rot.quat_normalize(rot.quat_multiply(quats, quat_exp(delta)))


# ---------------------------------------------------------------------------
# K22: global positioning.
# ---------------------------------------------------------------------------


class GPProblem(NamedTuple):
    """The observations of a positioning solve on one device, with their
    CSR lists by point and by camera, and the scale anchor: observation
    ``anchor_obs``'s camera, point and direction with weight ``mu``."""

    dirs: torch.Tensor  # (O, 3) unit, world frame
    obs_cam: torch.Tensor  # (O,) int32
    obs_point: torch.Tensor  # (O,) int32
    obs_w: torch.Tensor  # (O,)
    pt_offsets: torch.Tensor  # (P + 1,) int32
    pt_obs: torch.Tensor  # (O,) int32
    cam_offsets: torch.Tensor  # (C + 1,) int32
    cam_obs: torch.Tensor  # (O,) int32
    anchor_cam: int
    anchor_point: int
    anchor_dir: tuple  # three floats of the dirs' dtype
    mu: float
    eps_rel: float  # the relative ridge: 1e-6 in float32, 1e-12 in float64
    huber_scale: float
    num_cams: int
    num_points: int


class GPSystem(NamedTuple):
    """K22 (a)'s results for one IRLS round."""

    w: torch.Tensor  # (O,) Huber weight · obs_w
    Hpp_inv: torch.Tensor  # (P, 3, 3)
    g_x: torch.Tensor  # (P, 3)
    Hcc: torch.Tensor  # (C, 3, 3)
    b: torch.Tensor  # (C, 3) CG right-hand side, 0 at the anchor camera
    diag_c: torch.Tensor  # (C, 3) Jacobi diagonal
    cost: torch.Tensor  # 0-d Σ huber · obs_w at the input state


def gp_problem(dirs, obs_cam, obs_point, obs_w, anchor_obs: int, mu: float, num_cams: int,
               num_points: int, huber_scale: float) -> GPProblem:
    """dirs, obs_w as float tensors and obs_cam, obs_point as integer tensors,
    all on the solve's device; the CSR lists are sorted there."""
    obs_cam, obs_point = obs_cam.to(i32).contiguous(), obs_point.to(i32).contiguous()
    pt_offsets, pt_obs = csr(obs_point, num_points)
    cam_offsets, cam_obs = csr(obs_cam, num_cams)
    a = dirs[anchor_obs].tolist()
    return GPProblem(dirs.contiguous(), obs_cam, obs_point, obs_w.contiguous(), pt_offsets,
                     pt_obs, cam_offsets, cam_obs, int(obs_cam[anchor_obs]),
                     int(obs_point[anchor_obs]), tuple(a), float(mu),
                     1e-6 if dirs.dtype == f32 else 1e-12, float(huber_scale), int(num_cams),
                     int(num_points))


def _proj(d, v):
    return v - d * (d * v).sum(-1, keepdim=True)


def _anchor(prob: GPProblem, like):
    a = torch.tensor(prob.anchor_dir, dtype=like.dtype, device=like.device)
    return a, prob.mu * torch.outer(a, a)


def _cam_mask(prob: GPProblem, like):
    m = torch.ones(prob.num_cams, 1, dtype=like.dtype, device=like.device)
    m[prob.anchor_cam] = 0.0
    return m


def _hpc_plain(prob, w, xc, Q):
    """H_pc xc: (P, 3)."""
    d, oc, op = prob.dirs, prob.obs_cam.long(), prob.obs_point.long()
    out = -_segment_sum(w[:, None] * _proj(d, xc[oc]), op, prob.num_points)
    out[prob.anchor_point] -= Q @ xc[prob.anchor_cam]
    return out


def _hcp_plain(prob, w, y, Q):
    """H_cp y: (C, 3)."""
    d, oc, op = prob.dirs, prob.obs_cam.long(), prob.obs_point.long()
    out = -_segment_sum(w[:, None] * _proj(d, y[op]), oc, prob.num_cams)
    out[prob.anchor_cam] -= Q @ y[prob.anchor_point]
    return out


def gp_setup_plain(prob: GPProblem, centers, points) -> GPSystem:
    """K22 (a)'s function (``_irls_solve`` l.57-139 before the CG loop)."""
    d, oc, op = prob.dirs, prob.obs_cam.long(), prob.obs_point.long()
    C, P = prob.num_cams, prob.num_points
    a, Q = _anchor(prob, d)
    r = _proj(d, points[op] - centers[oc])
    rn2 = (r * r).sum(-1)
    a2 = prob.huber_scale ** 2
    w = torch.where(rn2 <= a2, 1.0, torch.sqrt(a2 / torch.clamp(rn2, min=1e-30))) * prob.obs_w
    eye = torch.eye(3, dtype=d.dtype, device=d.device)
    blocks = w[:, None, None] * (eye - d[:, :, None] * d[:, None, :])
    Hpp = _segment_sum(blocks, op, P)
    Hpp[prob.anchor_point] += Q
    tr = torch.diagonal(Hpp, dim1=-2, dim2=-1).sum(-1)[:, None, None]
    Hpp_inv = torch.linalg.inv(Hpp + (prob.eps_rel * tr / 3.0 + 1e-30) * eye)
    Hcc = _segment_sum(blocks, oc, C)
    Hcc[prob.anchor_cam] += Q
    r_anchor = a @ (points[prob.anchor_point] - centers[prob.anchor_cam]) - 1.0
    wpr = w[:, None] * _proj(d, r)
    g_c = _segment_sum(wpr, oc, C)
    g_c[prob.anchor_cam] += prob.mu * a * r_anchor
    g_x = -_segment_sum(wpr, op, P)
    g_x[prob.anchor_point] -= prob.mu * a * r_anchor
    y0 = (Hpp_inv @ g_x[..., None])[..., 0]
    b = (g_c - _hcp_plain(prob, w, y0, Q)) * _cam_mask(prob, d)
    diag_c = _segment_sum(w[:, None] * (1.0 - d * d), oc, C)
    diag_c[prob.anchor_cam] += prob.mu * a * a
    huber = torch.where(rn2 <= a2, rn2,
                        2 * prob.huber_scale * torch.sqrt(torch.clamp(rn2, min=0.0)) - a2)
    return GPSystem(w, Hpp_inv, g_x, Hcc, b, diag_c, (huber * prob.obs_w).sum())


def gp_schur_matvec_plain(prob: GPProblem, sys: GPSystem, xc):
    """K22 (b)'s function: ((Hcc − Hcp Hpp⁻¹ Hpc) (xc · mask)) · mask."""
    d, oc = prob.dirs, prob.obs_cam.long()
    _, Q = _anchor(prob, d)
    mask = _cam_mask(prob, d)
    xc = xc * mask
    hcc = _segment_sum(sys.w[:, None] * _proj(d, xc[oc]), oc, prob.num_cams)
    hcc[prob.anchor_cam] += Q @ xc[prob.anchor_cam]
    y = (sys.Hpp_inv @ _hpc_plain(prob, sys.w, xc, Q)[..., None])[..., 0]
    return (hcc - _hcp_plain(prob, sys.w, y, Q)) * mask


def gp_back_substitute_plain(prob: GPProblem, sys: GPSystem, xc, centers, points):
    """K22 (c)'s function: (centres + xc · mask, points + Hpp⁻¹ (g_x − Hpc xc))."""
    _, Q = _anchor(prob, prob.dirs)
    xc = xc * _cam_mask(prob, prob.dirs)
    dx = (sys.Hpp_inv @ (sys.g_x - _hpc_plain(prob, sys.w, xc, Q))[..., None])[..., 0]
    return centers + xc, points + dx


# ---------------------------------------------------------------------------
# K39: the CG step of both solves.
# ---------------------------------------------------------------------------

CG_ROTATION, CG_POSITIONING = 0, 1
_CG_MODES = ("rotation", "positioning")  # the tally's entry names by mode


class CGState(NamedTuple):
    """K39's state: the preconditioner M, iterate x, residual r,
    preconditioned residual z and direction p, all shaped like the
    right-hand side ((N, 3) or (C, 3)), and scal (2,) float64 [rz, rz0]."""

    M: torch.Tensor
    x: torch.Tensor
    r: torch.Tensor
    z: torch.Tensor
    p: torch.Tensor
    scal: torch.Tensor


def cg_setup_plain(mode: int, b, diag, eps_rel: float = 0.0) -> CGState:
    """K39 set-up. Rotation mode (colmap_tpu's _solve_tangent_cg, l.155-162):
    diag is deg (N,), M = 1 / deg where deg > 1e-12, else 0. Positioning mode
    (_irls_solve, l.139-146): diag is diag_c (C, 3), M = 1 / (diag_c +
    eps_rel mean(diag_c) + 1e-30). Then x = 0, r = b, z = p = M r, rz = rz0
    = r.z."""
    if mode == CG_ROTATION:
        M = torch.where(diag > 1e-12, 1.0 / diag, 0.0)[:, None].expand_as(b).contiguous()
    else:
        M = 1.0 / (diag + eps_rel * diag.mean() + 1e-30)
    z = M * b
    rz = (b * z).sum().double()
    return CGState(M, torch.zeros_like(b), b, z, z.clone(), torch.stack([rz, rz]))


def cg_step_plain(mode: int, st: CGState, Ap) -> CGState:
    """K39 step after Ap = A p: rotation mode the fori_loop body of
    _solve_tangent_cg (l.164-173); positioning mode that of _irls_solve
    (l.148-162) with the freeze rule live = rz > 1e-12 rz0."""
    dt = st.x.dtype
    rz, rz0 = st.scal[0].to(dt), st.scal[1].to(dt)
    live = (rz > 1e-12 * rz0).to(dt) if mode == CG_POSITIONING else torch.ones_like(rz)
    alpha = live * rz / torch.clamp((st.p * Ap).sum(), min=1e-30)
    x = st.x + alpha * st.p
    r = st.r - alpha * Ap
    z = st.M * r
    rz_new = (r * z).sum()
    beta = live * rz_new / torch.clamp(rz, min=1e-30)
    p = live * (z + beta * st.p) + (1.0 - live) * st.p
    rz = live * rz_new + (1.0 - live) * rz
    return CGState(st.M, x, r, z, p, torch.stack([rz.double(), st.scal[1]]))


# ---------------------------------------------------------------------------
# K23: view-graph calibration.
# ---------------------------------------------------------------------------


class VGCGraph(NamedTuple):
    """Fundamental matrices between cameras on one device, float64, with
    each camera's incidence list: 2e where it is edge e's first camera, 2e + 1
    where it is its second."""

    Fs: torch.Tensor  # (E, 3, 3) float64
    e1: torch.Tensor  # (E,) int32
    e2: torch.Tensor  # (E,) int32
    f0: torch.Tensor  # (n,) float64 prior focals
    pp: torch.Tensor  # (n, 2) float64 principal points
    offsets: torch.Tensor  # (n + 1,) int32
    inc: torch.Tensor  # (2E,) int32


def vgc_graph(Fs, e1, e2, f0, pp) -> VGCGraph:
    n, E = f0.shape[0], Fs.shape[0]
    e1, e2 = e1.to(i32).contiguous(), e2.to(i32).contiguous()
    codes = torch.arange(E, dtype=torch.long, device=Fs.device) * 2
    offsets, order = csr(torch.cat([e1, e2]), n)
    inc = torch.cat([codes, codes + 1])[order.long()].to(i32).contiguous()
    return VGCGraph(Fs.to(f64).contiguous(), e1, e2, f0.to(f64).contiguous(),
                    pp.to(f64).contiguous(), offsets, inc)


def calibration_matrices(graph: VGCGraph, x, idx):
    """K = [[f, 0, cx], [0, f, cy], [0, 0, 1]] with f = f0 · exp(x), per edge end."""
    idx = idx.long()
    f = graph.f0[idx] * torch.exp(x.to(f64)[idx])
    K = torch.zeros(idx.shape[0], 3, 3, dtype=f64, device=x.device)
    K[:, 0, 0] = f
    K[:, 1, 1] = f
    K[:, :2, 2] = graph.pp[idx]
    K[:, 2, 2] = 1.0
    return K


def vgc_loss_plain(graph: VGCGraph, x):
    """K23's function, float64, differentiable by torch autograd through
    ``svdvals``: Σ ((σ0 − σ1) / max(σ0 + σ1, 1e-12))² over E = K2ᵀ F K1."""
    K1 = calibration_matrices(graph, x, graph.e1)
    K2 = calibration_matrices(graph, x, graph.e2)
    s = torch.linalg.svdvals(K2.transpose(-1, -2) @ graph.Fs @ K1)
    res = (s[:, 0] - s[:, 1]) / torch.clamp(s[:, 0] + s[:, 1], min=1e-12)
    return (res ** 2).sum()


def vgc_loss_grad(graph: VGCGraph, x):
    """K23: (loss, gradient in x); float32 on the card with float64 edge
    arithmetic. On the CPU, ``vgc_loss_plain`` and autograd."""
    if x.device.type == "cpu":
        xg = x.detach().requires_grad_()
        with torch.enable_grad():
            loss = vgc_loss_plain(graph, xg)
            (g,) = torch.autograd.grad(loss, xg)
        return loss.detach().to(x.dtype), g.to(x.dtype)
    dev = S._require_cuda(x)
    n, E = graph.f0.shape[0], graph.Fs.shape[0]
    for name, t, dt, shape in (
        ("x", x, f32, (n,)), ("Fs", graph.Fs, f64, (E, 3, 3)), ("e1", graph.e1, i32, (E,)),
        ("e2", graph.e2, i32, (E,)), ("f0", graph.f0, f64, (n,)), ("pp", graph.pp, f64, (n, 2)),
        ("offsets", graph.offsets, i32, (n + 1,)), ("inc", graph.inc, i32, (2 * E,)),
    ):
        S._check(name, t, dt, shape, dev)
    res2 = torch.empty(E, dtype=f64, device=dev)
    g = torch.empty(E, 2, dtype=f64, device=dev)
    grad = torch.empty(n, dtype=f32, device=dev)
    loss = torch.empty((), dtype=f64, device=dev)
    _call("vgc_loss_grad_f32", E, n, *map(S._ptr, (graph.Fs, graph.e1, graph.e2, graph.f0,
                                                   graph.pp, x, graph.offsets, graph.inc, res2,
                                                   g, grad, loss)), S._stream(dev))
    LAUNCHES["view_graph_calibration"] += 1
    return loss.to(f32), grad


class _VGCLoss(torch.autograd.Function):
    """K23 under autograd: the forward computes the gradient with the loss,
    as ``jax.value_and_grad`` does; backward scales it by grad_output."""

    @staticmethod
    def forward(ctx, x, graph):
        loss, grad = vgc_loss_grad(graph, x.detach().contiguous())
        ctx.save_for_backward(grad)
        return loss

    @staticmethod
    def backward(ctx, grad_output):
        (grad,) = ctx.saved_tensors
        return grad_output * grad, None


def vgc_loss(graph: VGCGraph, x):
    """The loss as a differentiable function of x: K23 on the card, the
    plain version (torch autograd through svdvals) on the CPU."""
    if x.device.type == "cpu":
        return vgc_loss_plain(graph, x)
    return _VGCLoss.apply(x, graph)


# ---------------------------------------------------------------------------
# CUDA wrappers of K21 and K22.
# ---------------------------------------------------------------------------

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_GP_OBS = [_LL, _I, _I] + [_P] * 8 + [_I, _I, _F, _F, _F, _F]
_SIGNATURES = {
    "ra_edge_pass_f32": [_I, _I, _I, _F] + [_P] * 13,
    "ra_matvec_f32": [_I] + [_P] * 9,
    "ra_update_f32": [_I] + [_P] * 4,
    "gp_setup_f32": _GP_OBS + [_F, _F] + [_P] * 14,
    "gp_schur_matvec_f32": _GP_OBS + [_P] * 7,
    "gp_back_substitute_f32": _GP_OBS + [_P] * 9,
    "vgc_loss_grad_f32": [_I, _I] + [_P] * 13,
    "global_cg_setup_f32": [_I, _I, _F] + [_P] * 8 + [_P],
    "global_cg_step_f32": [_I, _I] + [_P] * 7 + [_P],
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


def _opt(x):
    return S._P(0) if x is None else S._ptr(x)


def _ra_checks(graph: RAGraph, quats):
    dev = S._require_cuda(quats)
    N, E = quats.shape[0], graph.edges.shape[0]
    for name, t, dt, shape in (
        ("quats", quats, f32, (N, 4)), ("edges", graph.edges, i32, (E, 2)),
        ("rel_quats", graph.rel_quats, f32, (E, 4)), ("offsets", graph.offsets, i32, (N + 1,)),
        ("inc", graph.inc, i32, (2 * E,)), ("free", graph.free, f32, (N,)),
    ):
        S._check(name, t, dt, shape, dev)
    if graph.proj is not None:
        S._check("proj", graph.proj, f32, (N, 3, 3), dev)
    return dev, N, E


def ra_step_buffers(N: int, E: int, device) -> RAStep:
    """Buffers K21 (a) writes in place (``ra_edge_pass``'s ``out``): float32
    ew, b, deg and a float64 cost."""
    e = functools.partial(torch.empty, dtype=f32, device=device)
    return RAStep(e(E, 4), e(N, 3), e(N), torch.empty((), dtype=f64, device=device))


def ra_edge_pass(graph: RAGraph, quats, use_l1: bool, sigma: float,
                 out: Optional[RAStep] = None) -> RAStep:
    """K21 (a). On the card ``out`` (``ra_step_buffers``) takes the results in
    place, so that a captured CG reads them at fixed addresses; the returned
    step holds out's tensors and the cost rounded to float32. See
    ra_edge_pass_plain for the function."""
    if quats.device.type == "cpu":
        return ra_edge_pass_plain(graph, quats, use_l1, sigma)
    dev, N, E = _ra_checks(graph, quats)
    if out is None:
        out = ra_step_buffers(N, E, dev)
    for name, t, dt, shape in (("ew", out.ew, f32, (E, 4)), ("b", out.b, f32, (N, 3)),
                               ("deg", out.deg, f32, (N,)), ("cost", out.cost, f64, ())):
        S._check(name, t, dt, shape, dev)
    rn = torch.empty(E, dtype=f32, device=dev)
    _call("ra_edge_pass_f32", N, E, int(bool(use_l1)), float(sigma),
          *map(S._ptr, (graph.edges, quats, graph.rel_quats, graph.offsets, graph.inc,
                        graph.free)), _opt(graph.proj),
          *map(S._ptr, (out.ew, rn, out.b, out.deg, out.cost)), S._stream(dev))
    LAUNCHES["rotation_averaging"] += 1
    return out._replace(cost=out.cost.to(f32))


def ra_matvec(graph: RAGraph, ew, x):
    """K21 (b). See ra_matvec_plain for the function."""
    if x.device.type == "cpu":
        return ra_matvec_plain(graph, ew, x)
    dev = S._require_cuda(x)
    N, E = x.shape[0], graph.edges.shape[0]
    x = x.contiguous()
    S._check("x", x, f32, (N, 3), dev)
    S._check("ew", ew, f32, (E, 4), dev)
    out = torch.empty(N, 3, dtype=f32, device=dev)
    _call("ra_matvec_f32", N, *map(S._ptr, (graph.edges, graph.offsets, graph.inc, ew, x,
                                            graph.free)), _opt(graph.proj), S._ptr(out),
          S._stream(dev))
    LAUNCHES["rotation_averaging"] += 1
    return out


def ra_update(quats, delta):
    """K21 (c). See ra_update_plain for the function."""
    if quats.device.type == "cpu":
        return ra_update_plain(quats, delta)
    dev = S._require_cuda(quats)
    N = quats.shape[0]
    delta = delta.contiguous()
    S._check("quats", quats, f32, (N, 4), dev)
    S._check("delta", delta, f32, (N, 3), dev)
    out = torch.empty(N, 4, dtype=f32, device=dev)
    _call("ra_update_f32", N, S._ptr(quats), S._ptr(delta), S._ptr(out), S._stream(dev))
    LAUNCHES["rotation_averaging"] += 1
    return out


def _gp_checks(prob: GPProblem, **tensors):
    """Checks the problem's arrays and the given float32 (C, 3) or (P, 3)
    ``tensors``; returns (device, the C entries' leading arguments)."""
    dev = S._require_cuda(prob.dirs)
    O, C, P = prob.dirs.shape[0], prob.num_cams, prob.num_points
    for name, t, dt, shape in (
        ("dirs", prob.dirs, f32, (O, 3)), ("obs_cam", prob.obs_cam, i32, (O,)),
        ("obs_point", prob.obs_point, i32, (O,)), ("obs_w", prob.obs_w, f32, (O,)),
        ("pt_offsets", prob.pt_offsets, i32, (P + 1,)), ("pt_obs", prob.pt_obs, i32, (O,)),
        ("cam_offsets", prob.cam_offsets, i32, (C + 1,)), ("cam_obs", prob.cam_obs, i32, (O,)),
    ):
        S._check(name, t, dt, shape, dev)
    rows = {"centers": C, "xc": C, "points": P, "g_x": P}
    for name, t in tensors.items():
        S._check(name, t, f32, (rows[name], 3), dev)
    args = (O, C, P, *map(S._ptr, (prob.dirs, prob.obs_cam, prob.obs_point, prob.obs_w,
                                   prob.pt_offsets, prob.pt_obs, prob.cam_offsets,
                                   prob.cam_obs)),
            prob.anchor_cam, prob.anchor_point, *map(float, prob.anchor_dir), prob.mu)
    return dev, args


def gp_system_buffers(prob: GPProblem) -> GPSystem:
    """Buffers K22 (a) writes in place (``gp_setup``'s ``out``): float32
    arrays and a float64 cost on the problem's device."""
    O, C, P = prob.dirs.shape[0], prob.num_cams, prob.num_points
    e = functools.partial(torch.empty, dtype=f32, device=prob.dirs.device)
    return GPSystem(w=e(O), Hpp_inv=e(P, 3, 3), g_x=e(P, 3), Hcc=e(C, 3, 3), b=e(C, 3),
                    diag_c=e(C, 3), cost=torch.empty((), dtype=f64, device=prob.dirs.device))


def gp_setup(prob: GPProblem, centers, points, out: Optional[GPSystem] = None) -> GPSystem:
    """K22 (a). On the card ``out`` (``gp_system_buffers``) takes the results
    in place, so that a captured CG reads them at fixed addresses; the
    returned system holds out's tensors and the cost rounded to float32.
    See gp_setup_plain for the function."""
    if prob.dirs.device.type == "cpu":
        return gp_setup_plain(prob, centers, points)
    dev, args = _gp_checks(prob, centers=centers, points=points)
    O, C, P = args[:3]
    e = functools.partial(torch.empty, dtype=f32, device=dev)
    if out is None:
        out = gp_system_buffers(prob)
    for name, t, dt, shape in (("w", out.w, f32, (O,)), ("Hpp_inv", out.Hpp_inv, f32, (P, 3, 3)),
                               ("g_x", out.g_x, f32, (P, 3)), ("Hcc", out.Hcc, f32, (C, 3, 3)),
                               ("b", out.b, f32, (C, 3)), ("diag_c", out.diag_c, f32, (C, 3)),
                               ("cost", out.cost, f64, ())):
        S._check(name, t, dt, shape, dev)
    wpr, cost_term, cost_cam, y0 = e(O, 3), e(O), e(C), e(P, 3)
    _call("gp_setup_f32", *args, prob.huber_scale, prob.eps_rel,
          *map(S._ptr, (centers, points, out.w, wpr, cost_term, cost_cam, out.Hpp_inv, out.g_x,
                        y0, out.Hcc, out.b, out.diag_c, out.cost)), S._stream(dev))
    LAUNCHES["global_positioning"] += 1
    SHAPES.add("global_positioning", "setup", (O, C, P), gp_setup, (prob, centers, points, out))
    return out._replace(cost=out.cost.to(f32))


def gp_schur_matvec(prob: GPProblem, sys: GPSystem, xc):
    """K22 (b). See gp_schur_matvec_plain for the function."""
    if prob.dirs.device.type == "cpu":
        return gp_schur_matvec_plain(prob, sys, xc)
    xc = xc.contiguous()
    dev, args = _gp_checks(prob, xc=xc)
    O, C, P = args[:3]
    S._check("w", sys.w, f32, (O,), dev)
    S._check("Hpp_inv", sys.Hpp_inv, f32, (P, 3, 3), dev)
    S._check("Hcc", sys.Hcc, f32, (C, 3, 3), dev)
    y = torch.empty(P, 3, dtype=f32, device=dev)
    out = torch.empty(C, 3, dtype=f32, device=dev)
    _call("gp_schur_matvec_f32", *args,
          *map(S._ptr, (sys.w, sys.Hpp_inv, sys.Hcc, xc, y, out)), S._stream(dev))
    LAUNCHES["global_positioning"] += 1
    SHAPES.add("global_positioning", "schur_matvec", (O, C, P), gp_schur_matvec, (prob, sys, xc))
    return out


def gp_back_substitute(prob: GPProblem, sys: GPSystem, xc, centers, points):
    """K22 (c). See gp_back_substitute_plain for the function."""
    if prob.dirs.device.type == "cpu":
        return gp_back_substitute_plain(prob, sys, xc, centers, points)
    xc = xc.contiguous()
    dev, args = _gp_checks(prob, xc=xc, centers=centers, points=points, g_x=sys.g_x)
    O, C, P = args[:3]
    S._check("w", sys.w, f32, (O,), dev)
    S._check("Hpp_inv", sys.Hpp_inv, f32, (P, 3, 3), dev)
    new_c = torch.empty(C, 3, dtype=f32, device=dev)
    new_p = torch.empty(P, 3, dtype=f32, device=dev)
    _call("gp_back_substitute_f32", *args,
          *map(S._ptr, (sys.w, sys.Hpp_inv, sys.g_x, xc, centers, points, new_c, new_p)),
          S._stream(dev))
    LAUNCHES["global_positioning"] += 1
    SHAPES.add("global_positioning", "back_substitute", (O, C, P), gp_back_substitute,
               (prob, sys, xc, centers, points))
    return new_c, new_p


def cg_setup(mode: int, b, diag, eps_rel: float = 0.0) -> CGState:
    """K39 set-up. b (n, 3) float32 on the card; diag deg (n,) in rotation
    mode, diag_c (n, 3) in positioning mode. See cg_setup_plain."""
    if b.device.type == "cpu":
        return cg_setup_plain(mode, b, diag, eps_rel)
    dev = S._require_cuda(b)
    n = b.shape[0]
    S._check("b", b, f32, (n, 3), dev)
    S._check("diag", diag, f32, (n,) if mode == CG_ROTATION else (n, 3), dev)
    e = functools.partial(torch.empty, dtype=f32, device=dev)
    st = CGState(e(n, 3), e(n, 3), e(n, 3), e(n, 3), e(n, 3),
                 torch.empty(2, dtype=f64, device=dev))
    _call("global_cg_setup_f32", int(mode), 3 * n, float(eps_rel),
          *map(S._ptr, (b, diag, st.M, st.x, st.r, st.z, st.p, st.scal)), S._stream(dev))
    LAUNCHES["global_cg"] += 1
    SHAPES.add("global_cg", "setup_" + _CG_MODES[mode], (n,), cg_setup, (mode, b, diag, eps_rel))
    return st


def cg_step(mode: int, st: CGState, Ap) -> CGState:
    """K39 step, in place on the card after Ap = A p (K21 (b) or K22 (b));
    returns ``st``. See cg_step_plain."""
    if Ap.device.type == "cpu":
        return cg_step_plain(mode, st, Ap)
    dev = S._require_cuda(Ap)
    n = Ap.shape[0]
    for name, t in (("Ap", Ap), ("M", st.M), ("x", st.x), ("r", st.r), ("z", st.z),
                    ("p", st.p)):
        S._check(name, t, f32, (n, 3), dev)
    S._check("scal", st.scal, f64, (2,), dev)
    _call("global_cg_step_f32", int(mode), 3 * n,
          *map(S._ptr, (st.M, Ap, st.x, st.r, st.z, st.p, st.scal)), S._stream(dev))
    LAUNCHES["global_cg"] += 1
    SHAPES.add("global_cg", "step_" + _CG_MODES[mode], (n,), cg_step, (mode, st, Ap))
    return st


class GlobalKernels(NamedTuple):
    ra_edge_pass: object
    ra_matvec: object
    ra_update: object
    gp_setup: object
    gp_schur_matvec: object
    gp_back_substitute: object
    vgc_loss: object
    cg_setup: object
    cg_step: object


# The wrappers, which the solvers run, and the plain versions, which only a
# solver's ``kernels`` argument takes, so that a check on the card can run
# the same solve through both.
KERNELS = GlobalKernels(ra_edge_pass, ra_matvec, ra_update, gp_setup, gp_schur_matvec,
                        gp_back_substitute, vgc_loss, cg_setup, cg_step)
PLAIN = GlobalKernels(ra_edge_pass_plain, ra_matvec_plain, ra_update_plain, gp_setup_plain,
                      gp_schur_matvec_plain, gp_back_substitute_plain, vgc_loss_plain,
                      cg_setup_plain, cg_step_plain)
