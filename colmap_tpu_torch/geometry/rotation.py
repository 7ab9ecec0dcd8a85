"""Batched quaternion utilities (the subset bundle adjustment uses).

Counterpart of colmap_tpu/geometry/rotation.py. Quaternions are ``(..., 4)``
tensors in Hamilton convention, scalar first ``(w, x, y, z)``, as in the
reference. All functions broadcast over leading batch dimensions and are
built from elementwise ops, so they work under ``torch.func.vmap``/``jacfwd``.
"""

from __future__ import annotations

import torch


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
