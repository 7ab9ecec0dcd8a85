"""Multi-view triangulation math, batched.

Counterpart of colmap_tpu/geometry/triangulation.py (reference behavior:
src/colmap/geometry/triangulation.h:55-118): N-view triangulation and the
triangulation angle as masked fixed-shape tensor programs (padded views
carry zero weight). The robust per-track triangulation of the mapper runs
in the CUDA kernel K8 (kernels/sfm.py); these are its plain building blocks.
"""

from __future__ import annotations

import torch

from colmap_tpu_torch.geometry.essential import calc_depth, triangulate_point_dlt  # noqa: F401


def multi_view_system(proj_matrices, points, mask=None):
    """The 4x4 system A = Σ_v w_v termᵀ term, term = P - x̂ x̂ᵀ P with the
    homogeneous point x̂ of unit norm (reference: TriangulateMultiViewPoint)."""
    xh = torch.cat([points, torch.ones_like(points[..., :1])], dim=-1)
    xh = xh / torch.linalg.vector_norm(xh, dim=-1, keepdim=True)
    term = proj_matrices - torch.einsum("...i,...j,...jk->...ik", xh, xh, proj_matrices)
    if mask is None:
        return torch.einsum("...vij,...vik->...jk", term, term)
    return torch.einsum("...vij,...vik,...v->...jk", term, term, mask.to(points.dtype))


def triangulate_multi_view(proj_matrices, points, mask=None):
    """N-view triangulation via the smallest eigenvector of AᵀA.

    proj_matrices: (..., V, 3, 4) cam-from-world projections; points:
    (..., V, 2) normalized observations; mask: optional (..., V) 0/1
    weights. Returns (..., 3) world points.
    """
    _, vecs = torch.linalg.eigh(multi_view_system(proj_matrices, points, mask))
    Xh = vecs[..., 0]
    w = Xh[..., 3]
    safe_w = torch.where(torch.abs(w) < 1e-30, 1e-30, w)
    return Xh[..., :3] / safe_w[..., None]


def triangulation_angle(center1, center2, point3D):
    """Angle (radians) at the 3D point between the two viewing rays, by the
    law of cosines; the acute angle (reference: CalculateTriangulationAngle)."""
    baseline2 = ((center1 - center2) ** 2).sum(-1)
    ray1_2 = ((point3D - center1) ** 2).sum(-1)
    ray2_2 = ((point3D - center2) ** 2).sum(-1)
    denom = 2.0 * torch.sqrt(torch.clamp(ray1_2 * ray2_2, min=1e-30))
    angle = torch.arccos(torch.clamp((ray1_2 + ray2_2 - baseline2) / denom, -1.0, 1.0))
    return torch.minimum(angle, torch.pi - angle)
