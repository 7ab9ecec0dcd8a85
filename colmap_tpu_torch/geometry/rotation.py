"""Batched quaternion utilities.

Counterpart of colmap_tpu/geometry/rotation.py. Quaternions are ``(..., 4)``
tensors in Hamilton convention, scalar first ``(w, x, y, z)``, as in the
reference. All functions broadcast over leading batch dimensions and are
built from elementwise ops, so they work under ``torch.func.vmap``/``jacfwd``.
"""

from __future__ import annotations

import torch


def quat_identity(batch_shape=(), dtype=torch.float64, device=None):
    q = torch.zeros(tuple(batch_shape) + (4,), dtype=dtype, device=device)
    q[..., 0] = 1.0
    return q


def quat_normalize(q):
    norm = torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    return q / torch.clamp(norm, min=torch.finfo(q.dtype).tiny)


def quat_multiply(q1, q2):
    """Hamilton product q1 ⊗ q2 (composition: rotate by q2 then q1)."""
    w1, x1, y1, z1 = q1.unbind(-1)
    w2, x2, y2, z2 = q2.unbind(-1)
    return torch.stack(
        [
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        ],
        dim=-1,
    )


def _cross(a, b):
    a0, a1, a2 = a.unbind(-1)
    b0, b1, b2 = b.unbind(-1)
    return torch.stack(
        [a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0], dim=-1
    )


def quat_rotate(q, v):
    """Rotate vectors ``v`` (..., 3) by unit quaternions ``q`` (..., 4)."""
    w = q[..., :1]
    u = q[..., 1:]
    # v' = v + 2 w (u × v) + 2 u × (u × v)
    uv = _cross(u, v)
    return v + 2.0 * (w * uv + _cross(u, uv))


def quat_conjugate(q):
    return q * torch.tensor([1.0, -1.0, -1.0, -1.0], dtype=q.dtype, device=q.device)


def quat_to_rotmat(q):
    """Unit quaternion -> rotation matrix (..., 3, 3)."""
    w, x, y, z = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    m = torch.stack(
        [
            1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
            2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
            2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
        ],
        dim=-1,
    )
    return m.reshape(m.shape[:-1] + (3, 3))


def rotmat_to_quat(m):
    """Rotation matrix (..., 3, 3) -> unit quaternion with w >= 0.

    Four candidates, one per largest diagonal combination; the
    best-conditioned one is taken (as colmap_tpu's branch-free form).
    """
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tr = m00 + m11 + m22
    qw2 = torch.clamp(1.0 + tr, min=0.0)
    qx2 = torch.clamp(1.0 + m00 - m11 - m22, min=0.0)
    qy2 = torch.clamp(1.0 - m00 + m11 - m22, min=0.0)
    qz2 = torch.clamp(1.0 - m00 - m11 + m22, min=0.0)
    cands = torch.stack([
        torch.stack([qw2, m21 - m12, m02 - m20, m10 - m01], dim=-1),
        torch.stack([m21 - m12, qx2, m01 + m10, m02 + m20], dim=-1),
        torch.stack([m02 - m20, m01 + m10, qy2, m12 + m21], dim=-1),
        torch.stack([m10 - m01, m02 + m20, m12 + m21, qz2], dim=-1),
    ], dim=-2)
    best = torch.argmax(torch.stack([qw2, qx2, qy2, qz2], dim=-1), dim=-1)
    idx = best[..., None, None].expand(best.shape + (1, 4))
    q = quat_normalize(torch.gather(cands, -2, idx)[..., 0, :])
    return q * torch.where(q[..., :1] < 0, -1.0, 1.0)


def quat_from_axis_angle(axis, angle):
    """axis (..., 3) need not be normalized; angle (...,) in radians."""
    axis = axis / torch.clamp(torch.linalg.vector_norm(axis, dim=-1, keepdim=True),
                              min=torch.finfo(axis.dtype).tiny)
    half = 0.5 * torch.as_tensor(angle, dtype=axis.dtype, device=axis.device)
    return torch.cat([torch.cos(half)[..., None], torch.sin(half)[..., None] * axis], dim=-1)


def quat_angle(q1, q2=None):
    """Rotation angle (radians) of q1, or of the relative rotation q1⁻¹ q2."""
    q = q1 if q2 is None else quat_multiply(quat_conjugate(q1), q2)
    w = torch.clamp(torch.abs(quat_normalize(q)[..., 0]), 0.0, 1.0)
    return 2.0 * torch.arccos(w)


def quat_slerp(q1, q2, t):
    """Spherical linear interpolation between unit quaternions (lerp where
    they are nearly parallel)."""
    t = torch.as_tensor(t, dtype=q1.dtype, device=q1.device)
    dot = (q1 * q2).sum(-1, keepdim=True)
    q2 = torch.where(dot < 0, -q2, q2)
    theta = torch.arccos(torch.clamp(torch.abs(dot), -1.0, 1.0))
    sin_theta = torch.sin(theta)
    small = sin_theta < 1e-6
    safe = torch.where(small, 1.0, sin_theta)
    w1 = torch.where(small, 1.0 - t, torch.sin((1.0 - t) * theta) / safe)
    w2 = torch.where(small, t, torch.sin(t * theta) / safe)
    return quat_normalize(w1 * q1 + w2 * q2)


def average_quaternions(quats, weights=None):
    """Weighted chordal-L2 mean of (N, 4) quaternions: the eigenvector of the
    largest eigenvalue of sum w q qᵀ (Markley's method), with w >= 0.

    reference behavior: src/colmap/geometry/pose.h:69-78 (AverageQuaternions).
    """
    quats = quat_normalize(quats)
    if weights is None:
        weights = torch.ones(quats.shape[:-1], dtype=quats.dtype, device=quats.device)
    a = torch.einsum("...i,...j,...->ij", quats, quats, weights)
    q = torch.linalg.eigh(a)[1][..., -1]
    return q * torch.where(q[..., :1] < 0, -1.0, 1.0)


def rotation_between_vectors(a, b):
    """Smallest rotation quaternion taking direction a to direction b (a
    half turn about an axis orthogonal to a when they are antiparallel)."""
    a = a / torch.clamp(torch.linalg.vector_norm(a, dim=-1, keepdim=True), min=1e-30)
    b = b / torch.clamp(torch.linalg.vector_norm(b, dim=-1, keepdim=True), min=1e-30)
    w = 1.0 + (a * b).sum(-1, keepdim=True)
    ortho = torch.stack([-a[..., 1] - a[..., 2], a[..., 0], a[..., 0]], dim=-1)
    q = torch.cat([w, _cross(a, b)], dim=-1)
    q_anti = torch.cat([torch.zeros_like(w), ortho], dim=-1)
    return quat_normalize(torch.where(w < 1e-6, q_anti, q))
