"""Surface meshing from oriented point clouds (colmap_tpu/mvs/meshing.py).

reference behavior: src/colmap/mvs/poisson_meshing.{h,cc} (screened Poisson),
mvs/delaunay_meshing.{h,cc} (tetrahedralization + visibility min-cut) and
mvs/advancing_front_meshing.{h,cc}. colmap_tpu rebuilt Poisson as a
regular-grid spectral solve, and the port runs it on the card:

  1. the bounding box's normalisation in float64 on the host;
  2. the indicator chi - iso and the blurred density on K41-K44 and cuFFT
     (kernels/meshing.py ``poisson_indicator``);
  3. the trim, a 6-neighbour binary dilation of the density's support,
     ``ceil(trim)`` times with a border of 0 (scipy's default cross
     structure), and naive surface nets, both as torch ops on the
     indicator's device;
  4. unreferenced vertices dropped, vertices mapped back to the world, and
     colours taken from the nearest sample (scipy's cKDTree on the host).

Delaunay meshing and the advancing front stay on the host with scipy (Qhull,
``maximum_flow``, ``breadth_first_order``), as in colmap_tpu; the loops over
rays, tetrahedra and edges are array ops that give the same graph, the same
faces and the same face order. The advancing front's heap loop is serial
and stays a loop.
"""

from __future__ import annotations

import dataclasses
import heapq
from typing import Optional

import numpy as np
import torch

from colmap_tpu_torch.kernels.meshing import poisson_indicator
from colmap_tpu_torch.utils.dtypes import resolve_device


@dataclasses.dataclass
class PoissonMeshingOptions:
    """reference: mvs/poisson_meshing.h:37-66."""

    depth: int = 8  # grid = 2^depth voxels per side
    point_weight: float = 1.0  # screening weight (blend toward samples)
    trim: float = 3.0  # trim vertices farther than this many voxels from data
    color: float = 32.0  # >0: propagate sample colors to vertices
    padding: float = 1.1  # bounding-box scale (PoissonRecon --scale)


# The 12 edges of a cell, as corner offsets, in colmap_tpu's order.
_EDGES = (
    ((0, 0, 0), (1, 0, 0)), ((0, 1, 0), (1, 1, 0)),
    ((0, 0, 1), (1, 0, 1)), ((0, 1, 1), (1, 1, 1)),
    ((0, 0, 0), (0, 1, 0)), ((1, 0, 0), (1, 1, 0)),
    ((0, 0, 1), (0, 1, 1)), ((1, 0, 1), (1, 1, 1)),
    ((0, 0, 0), (0, 0, 1)), ((1, 0, 0), (1, 0, 1)),
    ((0, 1, 0), (0, 1, 1)), ((1, 1, 0), (1, 1, 1)),
)


def surface_nets(field, active_mask=None):
    """The zero iso-surface of field (N, N, N) by naive surface nets, as
    torch ops on the field's device: (vertices (V, 3) float32 in grid
    coordinates, faces (F, 3) int32, vertex_cells (V, 3) int32), in
    colmap_tpu's vertex and face order (``torch.nonzero`` is in C order, as
    ``np.nonzero``). One vertex per sign-change cell at the mean of its
    edge crossings; one quad (two triangles) per sign-change grid edge,
    wound from inside (field > 0) to outside."""
    g = torch.as_tensor(field).to(torch.float32)
    N = g.shape[0]
    dev = g.device
    s = g > 0

    c = s[:-1, :-1, :-1]
    same = torch.ones_like(c)
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                same &= s[dx:N - 1 + dx, dy:N - 1 + dy, dz:N - 1 + dz] == c
    active = ~same
    if active_mask is not None:
        active &= torch.as_tensor(active_mask, device=dev)
    idx = torch.nonzero(active)
    ii, jj, kk = idx.unbind(1)
    cell_idx = torch.full(active.shape, -1, dtype=torch.int64, device=dev)
    cell_idx[ii, jj, kk] = torch.arange(len(idx), device=dev)

    corners = {(dx, dy, dz): g[ii + dx, jj + dy, kk + dz]
               for dx in (0, 1) for dy in (0, 1) for dz in (0, 1)}
    f64 = torch.float64
    pos_sum = torch.zeros((len(idx), 3), dtype=f64, device=dev)
    cnt = torch.zeros(len(idx), dtype=f64, device=dev)
    for a, b in _EDGES:
        va, vb = corners[a], corners[b]
        cross = (va > 0) != (vb > 0)
        t = torch.where(cross, va / torch.where(va == vb, 1.0, va - vb), 0.0)
        pa = torch.tensor(a, dtype=f64, device=dev)
        pb = torch.tensor(b, dtype=f64, device=dev)
        contrib = pa[None, :] + t[:, None].to(f64) * (pb - pa)[None, :]
        pos_sum += torch.where(cross[:, None], contrib, 0.0)
        cnt += cross
    verts = idx.to(f64) + pos_sum / torch.clamp(cnt, min=1)[:, None]

    E = N - 1
    faces = []
    for axis in range(3):
        lo = [slice(1, E)] * 3
        hi = [slice(1, E)] * 3
        lo[axis], hi[axis] = slice(0, N - 1), slice(1, N)
        n0, n1 = s[tuple(lo)], s[tuple(hi)]
        base = torch.nonzero(n0 != n1)
        flip = n0[base[:, 0], base[:, 1], base[:, 2]]
        b = base + 1
        b[:, axis] -= 1
        bi, bj, bk = b.unbind(1)
        if axis == 0:
            cells = [(bi, bj - 1, bk - 1), (bi, bj, bk - 1), (bi, bj, bk), (bi, bj - 1, bk)]
        elif axis == 1:
            cells = [(bi - 1, bj, bk - 1), (bi - 1, bj, bk), (bi, bj, bk), (bi, bj, bk - 1)]
        else:
            cells = [(bi - 1, bj - 1, bk), (bi, bj - 1, bk), (bi, bj, bk), (bi - 1, bj, bk)]
        q = torch.stack([cell_idx[cc] for cc in cells], dim=1)
        ok = (q >= 0).all(dim=1)
        q, flip = q[ok], flip[ok]
        qf = torch.where(flip[:, None], q, q.flip(1))
        faces.append(torch.cat([qf[:, [0, 1, 2]], qf[:, [0, 2, 3]]], dim=0))
    faces = torch.cat(faces, dim=0).to(torch.int32)
    return verts.to(torch.float32), faces, idx.to(torch.int32)


def dilate6(occ, iterations):
    """scipy.ndimage.binary_dilation(occ, iterations=iterations) with its
    default 6-neighbour cross and a border of 0, as torch ops."""
    for _ in range(iterations):
        out = occ.clone()
        for d in range(3):
            n = occ.shape[d]
            out.narrow(d, 1, n - 1).logical_or_(occ.narrow(d, 0, n - 1))
            out.narrow(d, 0, n - 1).logical_or_(occ.narrow(d, 1, n - 1))
        occ = out
    return occ


def poisson_mesh(points, normals, colors=None, options: Optional[PoissonMeshingOptions] = None,
                 device="cuda"):
    """Reconstruct a triangle mesh from an oriented point cloud.

    Returns (vertices (V, 3) float32 world coordinates, faces (F, 3) int32,
    colors or None), numpy arrays.
    """
    if options is None:
        options = PoissonMeshingOptions()
    dev = resolve_device(device)
    points = np.asarray(points, dtype=np.float64)
    normals = np.asarray(normals, dtype=np.float64)
    nrm = normals / np.maximum(np.linalg.norm(normals, axis=1, keepdims=True), 1e-12)

    lo = points.min(axis=0)
    hi = points.max(axis=0)
    center = 0.5 * (lo + hi)
    scale = float((hi - lo).max()) * options.padding
    scale = max(scale, 1e-9)
    p01 = (points - center) / scale + 0.5

    N = 1 << options.depth
    f32 = torch.float32
    chi, density = poisson_indicator(
        torch.as_tensor(p01, dtype=f32).to(dev), torch.as_tensor(nrm, dtype=f32).to(dev),
        torch.ones(len(points), dtype=f32, device=dev), N, options.point_weight)

    # Trim: only keep cells within `trim` voxels of observed data.
    active_mask = None
    if options.trim > 0:
        occ = dilate6(density > 0, int(np.ceil(options.trim)))
        active_mask = occ[:-1, :-1, :-1]
    del density

    # chi < 0 inside; surface nets takes field > 0 = inside.
    chi.neg_()
    verts_g, faces, _ = surface_nets(chi, active_mask)
    del chi, active_mask

    faces = faces.to(torch.int64)
    used = torch.zeros(len(verts_g), dtype=torch.bool, device=dev)
    used[faces.reshape(-1)] = True
    remap = torch.cumsum(used, 0) - 1
    verts_g = verts_g[used]
    faces = remap[faces].to(torch.int32)

    verts = (((verts_g + 0.5) / N - 0.5) * scale).cpu().numpy().astype(np.float64) + center
    faces = faces.cpu().numpy()

    vcolors = None
    if colors is not None and options.color > 0 and len(verts):
        from scipy.spatial import cKDTree

        _, nearest = cKDTree(points).query(verts, k=1)
        vcolors = np.asarray(colors)[nearest]
    return verts.astype(np.float32), faces, vcolors


# ---------------------------------------------------------------------------
# Delaunay meshing: tetrahedralization + visibility-driven s-t min cut.
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class DelaunayMeshingOptions:
    """reference: mvs/delaunay_meshing.h:44-87 (subset)."""

    quality_regularization: float = 1.0  # smoothness on shared faces
    max_side_length_factor: float = 25.0  # drop huge surface triangles
    max_side_length_percentile: float = 95.0
    num_ray_samples: int = 8  # free-space samples per visibility ray
    visibility_sigma: float = 3.0  # ray vote weight


# Each tet face as the vertices opposite vertex f.
_FACE_VERTS = np.array([(1, 2, 3), (0, 3, 2), (0, 1, 3), (0, 2, 1)])
_FLOW_SCALE = 1000.0


def _visibility_rays(visibility, camera_centers):
    """(point index, camera centre) of every ray, in the order of the points
    and of each point's image ids; ids without a centre are skipped."""
    ids = [np.asarray(v).ravel() for v in visibility]
    lengths = np.array([len(v) for v in ids], dtype=np.int64)
    flat = (np.concatenate(ids).astype(np.int64) if len(ids) and lengths.sum()
            else np.zeros(0, np.int64))
    owner = np.repeat(np.arange(len(ids)), lengths)
    known = np.array(sorted(int(k) for k in camera_centers), dtype=np.int64)
    if not len(known):
        return np.zeros(0, np.int64), np.zeros((0, 3))
    table = np.stack([np.asarray(camera_centers[int(k)], dtype=np.float64) for k in known])
    pos = np.clip(np.searchsorted(known, flat), 0, len(known) - 1)
    ok = known[pos] == flat
    return owner[ok], table[pos[ok]]


def _capacity(c):
    return np.minimum(np.asarray(c, dtype=np.float64) * _FLOW_SCALE, 2 ** 30).astype(np.int64)


def delaunay_meshing(points, visibility, camera_centers,
                     options: Optional[DelaunayMeshingOptions] = None):
    """Mesh a point cloud using visibility information.

    Args:
        points: (P, 3) fused/sparse points.
        visibility: list of int arrays — image ids observing each point.
        camera_centers: dict image_id -> (3,) projection center.

    Returns (vertices (P, 3) float32, faces (F, 3) int32) — faces index
    ``points``.
    """
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import breadth_first_order, maximum_flow
    from scipy.spatial import Delaunay

    if options is None:
        options = DelaunayMeshingOptions()
    points = np.asarray(points, dtype=np.float64)
    tri = Delaunay(points)
    T = len(tri.simplices)

    ray_p, ray_c = _visibility_rays(visibility, camera_centers)
    source_votes = np.zeros(T, dtype=np.float64)
    sink_votes = np.zeros(T, dtype=np.float64)
    if len(ray_p):
        p = points[ray_p]
        d = p - ray_c
        # Free-space samples strictly between camera and point.
        S = options.num_ray_samples
        ts = (np.arange(1, S + 1) / (S + 1.0))[None, :, None]
        samples = ray_c[:, None, :] + ts * d[:, None, :]
        simp = tri.find_simplex(samples.reshape(-1, 3)).reshape(-1, S)
        w = options.visibility_sigma
        for s in range(S):
            valid = simp[:, s] >= 0
            np.add.at(source_votes, simp[valid, s], w / S)
        # Just behind the point along the ray: inside evidence.
        behind = p + 0.01 * d / np.maximum(
            np.linalg.norm(d, axis=1, keepdims=True), 1e-12
        ) * np.linalg.norm(d, axis=1, keepdims=True) * 0.05
        sb = tri.find_simplex(behind)
        valid = sb >= 0
        np.add.at(sink_votes, sb[valid], w)

    # Hull-adjacent cells are outside.
    nb = tri.neighbors
    source_votes[(nb == -1).any(axis=1)] += 10.0 * options.visibility_sigma

    # The flow network: 0 = source, 1 + t = tet t, 1 + T = sink. Edges in
    # colmap_tpu's order: each tet's source then sink edge, then for each
    # face slot f the pairs (a, b), a < b, each both ways.
    t = np.arange(T)
    rows = np.stack([np.zeros(T, np.int64), 1 + t], 1).reshape(-1)
    cols = np.stack([1 + t, np.full(T, 1 + T)], 1).reshape(-1)
    keep = np.stack([source_votes > 0, sink_votes > 0], 1).reshape(-1)
    caps = np.stack([_capacity(source_votes), _capacity(sink_votes)], 1).reshape(-1)
    rows, cols, caps = [rows[keep]], [cols[keep]], [caps[keep]]
    lam_cap = _capacity(options.quality_regularization)
    for f in range(4):
        src = np.nonzero(nb[:, f] >= 0)[0]
        dst = nb[src, f]
        a, b = src[src < dst], dst[src < dst]
        rows.append(np.stack([1 + a, 1 + b], 1).reshape(-1))
        cols.append(np.stack([1 + b, 1 + a], 1).reshape(-1))
        caps.append(np.full(2 * len(a), lam_cap, dtype=np.int64))
    n_nodes = T + 2
    graph = coo_matrix(
        (np.concatenate(caps).astype(np.int32), (np.concatenate(rows), np.concatenate(cols))),
        shape=(n_nodes, n_nodes),
    ).tocsr()
    res = maximum_flow(graph, 0, 1 + T)
    residual = graph - res.flow
    # Min-cut: nodes reachable from source in the residual graph = outside.
    residual.data = np.maximum(residual.data, 0)
    residual.eliminate_zeros()
    order = breadth_first_order(residual, 0, directed=True, return_predecessors=False)
    outside = np.zeros(n_nodes, dtype=bool)
    outside[order] = True
    label_out = outside[1:1 + T]

    # Surface: faces between an outside tet and an inside (or no) tet, in
    # (tet, face slot) order.
    inner_nb = (nb >= 0) & label_out[np.maximum(nb, 0)]
    owner, slot = np.nonzero(label_out[:, None] & ~inner_nb)
    faces = tri.simplices[owner[:, None], _FACE_VERTS[slot]].astype(np.int32)
    if len(faces):
        # Qhull simplices are not consistently oriented: flip each face so
        # its normal points toward the outside tet (air side).
        cent_t = points[tri.simplices[owner]].mean(axis=1)
        a, b, c = points[faces[:, 0]], points[faces[:, 1]], points[faces[:, 2]]
        nrm = np.cross(b - a, c - a)
        to_out = cent_t - (a + b + c) / 3.0
        flip = np.einsum("ij,ij->i", nrm, to_out) > 0
        faces[flip] = faces[flip][:, ::-1]

    # Drop oversized triangles (hull artifacts), à la max_side_length_*.
    if len(faces):
        e = points[faces]
        side = np.maximum(
            np.linalg.norm(e[:, 0] - e[:, 1], axis=1),
            np.maximum(
                np.linalg.norm(e[:, 1] - e[:, 2], axis=1),
                np.linalg.norm(e[:, 2] - e[:, 0], axis=1),
            ),
        )
        ref = np.percentile(side, options.max_side_length_percentile)
        faces = faces[side <= options.max_side_length_factor * ref / 5.0]

    return points.astype(np.float32), faces


@dataclasses.dataclass
class AdvancingFrontMeshingOptions:
    """reference: mvs/advancing_front_meshing.h — CGAL
    Advancing_front_surface_reconstruction options (radius ratio bound and
    beta angle), rebuilt as a manifold triangle front grown over the
    Delaunay facet graph with a circumradius priority."""

    radius_ratio_bound: float = 5.0  # max facet radius vs local edge scale
    # Facets whose circumradius exceeds this multiple of the global median
    # edge length are never accepted (guards against hull-spanning faces).
    max_radius_factor: float = 25.0


def advancing_front_mesh(points, options: Optional[AdvancingFrontMeshingOptions] = None):
    """Surface reconstruction from unoriented points.

    reference behavior: mvs/advancing_front_meshing.cc (CGAL advancing
    front). Greedy selection of Delaunay facets by increasing circumradius,
    constrained so every edge stays in <= 2 accepted facets (manifold
    front), seeded from the most plausible (smallest) facet of each
    connected region.

    Returns (vertices (P, 3) float32, faces (F, 3) int32).
    """
    from scipy.spatial import Delaunay

    if options is None:
        options = AdvancingFrontMeshingOptions()
    points = np.asarray(points, dtype=np.float64)
    if len(points) < 4:
        return points.astype(np.float32), np.zeros((0, 3), np.int32)
    tri = Delaunay(points)

    # The unique facets of the tetrahedralization.
    simp = tri.simplices
    facets = np.concatenate([simp[:, [1, 2, 3]], simp[:, [0, 2, 3]], simp[:, [0, 1, 3]],
                             simp[:, [0, 1, 2]]], axis=0)
    facets = np.unique(np.sort(facets, axis=1), axis=0)

    a = points[facets[:, 0]]
    b = points[facets[:, 1]]
    c = points[facets[:, 2]]
    # Triangle circumradius: R = abc / (4 * area).
    la = np.linalg.norm(b - c, axis=1)
    lb = np.linalg.norm(a - c, axis=1)
    lc = np.linalg.norm(a - b, axis=1)
    area = 0.5 * np.linalg.norm(np.cross(b - a, c - a), axis=1)
    radius = la * lb * lc / np.maximum(4.0 * area, 1e-300)

    med_edge = np.median(np.concatenate([la, lb, lc]))
    ok = radius <= options.max_radius_factor * med_edge
    facets = facets[ok]
    radius = radius[ok]
    if not len(facets):
        return points.astype(np.float32), np.zeros((0, 3), np.int32)

    # Edge ids and the edge -> facet lists (CSR, facets ascending).
    F = len(facets)
    edges_of = np.stack([facets[:, [0, 1]], facets[:, [0, 2]], facets[:, [1, 2]]], axis=1)
    keys = (edges_of[:, :, 0].astype(np.int64) << 32) | edges_of[:, :, 1].astype(np.int64)
    _, edge_id = np.unique(keys.reshape(-1), return_inverse=True)
    edge_id = edge_id.reshape(F, 3)
    by_edge = np.argsort(edge_id.reshape(-1), kind="stable")
    starts = np.concatenate([[0], np.cumsum(np.bincount(edge_id.reshape(-1)))])
    edge_facets = (by_edge // 3).tolist()
    starts = starts.tolist()
    edge_ids = edge_id.tolist()
    radius_l = radius.tolist()
    limit = options.radius_ratio_bound * med_edge

    edge_count = [0] * (len(starts) - 1)  # accepted facets per edge
    accepted = [False] * F
    order = np.argsort(radius).tolist()
    heap = []
    accepted_list = []
    seed_ptr = 0

    def try_accept(fi):
        if accepted[fi]:
            return False
        es = edge_ids[fi]
        if edge_count[es[0]] >= 2 or edge_count[es[1]] >= 2 or edge_count[es[2]] >= 2:
            return False
        if radius_l[fi] > limit:
            return False
        accepted[fi] = True
        accepted_list.append(fi)
        for e in es:
            edge_count[e] += 1
            if edge_count[e] < 2:
                for nfi in edge_facets[starts[e]:starts[e + 1]]:
                    if not accepted[nfi]:
                        heapq.heappush(heap, (radius_l[nfi], nfi))
        return True

    while True:
        # Advance the front; when it empties, seed the next region.
        progressed = False
        while heap:
            _, fi = heapq.heappop(heap)
            if try_accept(fi):
                progressed = True
        while seed_ptr < F:
            fi = order[seed_ptr]
            seed_ptr += 1
            if not accepted[fi] and try_accept(fi):
                progressed = True
                break
        if not progressed and seed_ptr >= F and not heap:
            break

    faces = facets[np.asarray(accepted_list, dtype=np.int64)]
    # Orient faces consistently-ish: normal votes toward the point-cloud
    # exterior (away from the cloud's centroid).
    centroid = points.mean(axis=0)
    av, bv, cv = points[faces[:, 0]], points[faces[:, 1]], points[faces[:, 2]]
    nrm = np.cross(bv - av, cv - av)
    outward = (av + bv + cv) / 3.0 - centroid
    flip = np.einsum("ij,ij->i", nrm, outward) < 0
    faces = faces.astype(np.int32)
    faces[flip] = faces[flip][:, ::-1]
    return points.astype(np.float32), faces
