"""Global rotation averaging (L1-IRLS, Chatterjee-style).

Counterpart of colmap_tpu/estimators/rotation_averaging.py (reference
behavior: src/colmap/estimators/rotation_averaging.h:25-102): a
maximum-spanning-tree initialization, an L1 phase, then IRLS with
Geman-McClure weights, each iteration a 3N tangent-space solve by
conjugate gradients on the weighted graph Laplacian. One iteration runs on
K21 (kernels/global_sfm.py): the edge pass, 50 CG matvecs and the node
update; CG's dots and axpys are torch ops on the solve's device, and no CG
iteration reads anything back to the host. The host reads the cost once per
IRLS iteration, as the reference does. The spanning tree, the gravity snap
and their quaternion arithmetic are host numpy.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from colmap_tpu_torch.kernels import global_sfm as K
from colmap_tpu_torch.utils.dtypes import floatx, resolve_device


@dataclasses.dataclass
class RotationAveragingOptions:
    max_num_l1_iterations: int = 5
    max_num_irls_iterations: int = 50
    irls_loss_width: float = np.deg2rad(5.0)  # Geman-McClure width
    cg_iterations: int = 50
    function_tolerance: float = 1e-8
    # Gravity-stratified mode: frames with a gravity prior keep only the
    # 1-DOF yaw about the world gravity axis, a per-node projector inside the
    # same CG solve (see colmap_tpu's module for the derivation).
    use_gravity: bool = True


def _qmul(q1, q2):
    """Hamilton product of two wxyz quaternions, numpy."""
    w1, x1, y1, z1 = q1
    w2, x2, y2, z2 = q2
    return np.array([
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
    ])


_CONJ = np.array([1.0, -1.0, -1.0, -1.0])


def spanning_tree_init(num_nodes: int, edges: np.ndarray, rel_quats: np.ndarray,
                       weights: np.ndarray) -> np.ndarray:
    """Maximum-spanning-tree rotation initialization.

    edges: (E, 2) [i, j] with q_j = q_ij ⊗ q_i. Returns (N, 4) quats, each
    component's first node (in node order) at identity.
    """
    order = np.argsort(-np.asarray(weights))
    parent = np.arange(num_nodes)

    def find(a):
        while parent[a] != a:
            parent[a] = parent[parent[a]]
            a = parent[a]
        return a

    adj: Dict[int, List[Tuple[int, int, bool]]] = {i: [] for i in range(num_nodes)}
    for e in order:
        i, j = int(edges[e, 0]), int(edges[e, 1])
        ri, rj = find(i), find(j)
        if ri != rj:
            parent[ri] = rj
            adj[i].append((j, e, True))   # forward: q_j = q_ij ⊗ q_i
            adj[j].append((i, e, False))  # backward
    quats = np.tile(np.array([1.0, 0, 0, 0]), (num_nodes, 1))
    visited = np.zeros(num_nodes, dtype=bool)
    for root in range(num_nodes):
        if visited[root]:
            continue
        visited[root] = True
        dq = collections.deque([root])
        while dq:
            i = dq.popleft()
            for (j, e, fwd) in adj[i]:
                if visited[j]:
                    continue
                visited[j] = True
                q_ij = rel_quats[e] if fwd else rel_quats[e] * _CONJ
                q_j = _qmul(q_ij, quats[i])
                quats[j] = q_j / np.linalg.norm(q_j)
                dq.append(j)
    return quats


def _align_quat(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Minimal rotation (quat) taking direction a to direction b."""
    a = a / np.linalg.norm(a)
    b = b / np.linalg.norm(b)
    c = np.cross(a, b)
    w = 1.0 + float(np.dot(a, b))
    if w < 1e-9:  # antiparallel: rotate pi about any orthogonal axis
        q = np.concatenate([[0.0], np.array([-a[1] - a[2], a[0], a[0]])])
    else:
        q = np.concatenate([[w], c])
    return q / np.linalg.norm(q)


def _snap_to_gravity(quats: np.ndarray, gravity_cam: np.ndarray,
                     g_world: np.ndarray) -> np.ndarray:
    """Project initial rotations onto the gravity-constraint manifold: for
    each node with a measured camera-frame gravity g_i, the closest rotation
    with R g_world = g_i (keeping the yaw of q)."""
    out = quats.copy()
    for i in range(len(quats)):
        g = gravity_cam[i]
        if not np.all(np.isfinite(g)):
            continue
        q0 = _align_quat(g_world, g)
        qr = _qmul(q0 * _CONJ, quats[i])
        qr = qr / np.linalg.norm(qr)
        qy = np.concatenate([[qr[0]], np.dot(qr[1:], g_world) * g_world])
        n = np.linalg.norm(qy)
        qy = qy / n if n > 1e-12 else np.array([1.0, 0, 0, 0])
        q = _qmul(q0, qy)
        out[i] = q / np.linalg.norm(q)
    return out


def solve_tangent_cg(graph: K.RAGraph, step: K.RAStep, iterations: int, kernels=K.KERNELS):
    """CG on constrain(Lᵀ W L) δ = b with the Jacobi preconditioner 1 / deg
    (colmap_tpu's _solve_tangent_cg); the matvec is K21 (b), the rest torch
    ops on the device with no host read. Returns δ (N, 3)."""
    M = torch.where(step.deg > 1e-12, 1.0 / step.deg, 0.0)[:, None]
    x = torch.zeros_like(step.b)
    rr = step.b
    z = M * rr
    p = z
    rz = (rr * z).sum()
    for _ in range(iterations):
        Ap = kernels.ra_matvec(graph, step.ew, p)
        alpha = rz / torch.clamp((p * Ap).sum(), min=1e-30)
        x = x + alpha * p
        rr = rr - alpha * Ap
        z = M * rr
        rz_new = (rr * z).sum()
        p = z + rz_new / torch.clamp(rz, min=1e-30) * p
        rz = rz_new
    return x


def estimate_rotations(
    num_nodes: int,
    edges: np.ndarray,
    rel_quats: np.ndarray,
    edge_weights: Optional[np.ndarray] = None,
    fixed_nodes: Optional[List[int]] = None,
    options: Optional[RotationAveragingOptions] = None,
    initial_quats: Optional[np.ndarray] = None,
    gravity_cam: Optional[np.ndarray] = None,
    gravity_in_world: Tuple[float, float, float] = (0.0, 1.0, 0.0),
    device=None,
    dtype=None,
    kernels=K.KERNELS,
    stats: Optional[dict] = None,
) -> np.ndarray:
    """Absolute rotations (cam_from_world, (N, 4) float64) from relative ones.

    edges (E, 2) [i, j], rel_quats (E, 4) with q_j = q_rel ⊗ q_i;
    gravity_cam optional (N, 3) gravity directions in each camera frame (NaN
    rows: no prior) for the 1-DOF stratified mode. Node 0 is gauge-fixed
    unless fixed_nodes are given. Runs on ``device`` (default cuda) in
    ``dtype`` (default its floatx). ``kernels`` is the kernels' bundle
    (global_sfm.PLAIN runs the plain versions, for checks); ``stats``, if
    given, receives the number of iterations and the last cost.
    """
    if options is None:
        options = RotationAveragingOptions()
    device = resolve_device(device)
    dtype = dtype or floatx(device)
    edges = np.asarray(edges, dtype=np.int32)
    rel_quats_np = np.asarray(rel_quats, dtype=np.float64)
    if edge_weights is None:
        edge_weights = np.ones(len(edges))
    if initial_quats is None:
        initial_quats = spanning_tree_init(num_nodes, edges, rel_quats_np, edge_weights)

    proj = None
    g_world = np.asarray(gravity_in_world, dtype=np.float64)
    g_world = g_world / np.linalg.norm(g_world)
    if options.use_gravity and gravity_cam is not None:
        gravity_cam = np.asarray(gravity_cam, dtype=np.float64)
        has_g = np.all(np.isfinite(gravity_cam), axis=1)
        if has_g.any():
            initial_quats = _snap_to_gravity(np.asarray(initial_quats), gravity_cam, g_world)
            P = np.tile(np.eye(3), (num_nodes, 1, 1))
            P[has_g] = np.outer(g_world, g_world)
            proj = P

    free = np.ones(num_nodes)
    for n in (fixed_nodes or [0]):
        free[n] = 0.0

    def dev(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype).to(device)

    graph = K.ra_graph(num_nodes, torch.as_tensor(edges).to(device), dev(rel_quats_np),
                       dev(free), None if proj is None else dev(proj))
    quats = dev(initial_quats).contiguous()
    sigma = float(options.irls_loss_width)

    def iteration(quats, use_l1):
        step = kernels.ra_edge_pass(graph, quats, use_l1, sigma)
        delta = solve_tangent_cg(graph, step, options.cg_iterations, kernels)
        return kernels.ra_update(quats, delta), step.cost

    cost = None
    for _ in range(options.max_num_l1_iterations):
        quats, cost = iteration(quats, True)
    prev_cost = np.inf
    n_irls = 0
    for _ in range(options.max_num_irls_iterations):
        quats, cost = iteration(quats, False)
        n_irls += 1
        c = float(cost)
        if abs(prev_cost - c) < options.function_tolerance * max(c, 1.0):
            break
        prev_cost = c
    if stats is not None:
        stats.update(l1_iterations=options.max_num_l1_iterations, irls_iterations=n_irls,
                     cost=None if cost is None else float(cost))
    return quats.double().cpu().numpy()
