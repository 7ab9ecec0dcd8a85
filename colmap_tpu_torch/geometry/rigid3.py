"""Rigid (SE3) and similarity (Sim3) transforms with leading batch dimensions.

Counterpart of colmap_tpu/geometry/rigid3.py (reference behavior:
src/colmap/geometry/rigid3.h:46 Rigid3d and sim3.h:44 Sim3d), as
NamedTuples of torch tensors.

Convention: a transform named ``b_from_a`` maps points from frame ``a`` to
frame ``b``: ``x_b = R x_a + t`` (Sim3: ``x_b = s R x_a + t``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from colmap_tpu_torch.geometry import rotation as rot


class Rigid3(NamedTuple):
    """quat: (..., 4) Hamilton wxyz; t: (..., 3)."""

    quat: torch.Tensor
    t: torch.Tensor

    @staticmethod
    def identity(batch_shape=(), dtype=torch.float64, device=None) -> "Rigid3":
        return Rigid3(rot.quat_identity(batch_shape, dtype, device),
                      torch.zeros(tuple(batch_shape) + (3,), dtype=dtype, device=device))

    def apply(self, points):
        """Transform points (..., 3)."""
        return rot.quat_rotate(self.quat, points) + self.t

    def inverse(self) -> "Rigid3":
        q_inv = rot.quat_conjugate(rot.quat_normalize(self.quat))
        return Rigid3(q_inv, -rot.quat_rotate(q_inv, self.t))

    def compose(self, other: "Rigid3") -> "Rigid3":
        """self ∘ other: apply ``other`` first, then ``self``."""
        return Rigid3(rot.quat_normalize(rot.quat_multiply(self.quat, other.quat)),
                      rot.quat_rotate(self.quat, other.t) + self.t)

    def rotmat(self):
        return rot.quat_to_rotmat(rot.quat_normalize(self.quat))

    def matrix3x4(self):
        """(..., 3, 4) [R | t]."""
        return torch.cat([self.rotmat(), self.t[..., None]], dim=-1)

    def projection_center(self):
        """Camera centre of a cam_from_world transform: -Rᵀ t."""
        return -rot.quat_rotate(rot.quat_conjugate(rot.quat_normalize(self.quat)), self.t)

    @staticmethod
    def from_matrix(m) -> "Rigid3":
        """From (..., 3, 4) or (..., 4, 4)."""
        return Rigid3(rot.rotmat_to_quat(m[..., :3, :3]), m[..., :3, 3])


def interpolate(a: Rigid3, b: Rigid3, t) -> Rigid3:
    """reference behavior: InterpolateCameraPoses (geometry/pose.h)."""
    t = torch.as_tensor(t, dtype=a.t.dtype, device=a.t.device)
    return Rigid3(rot.quat_slerp(a.quat, b.quat, t[..., None]),
                  (1.0 - t[..., None]) * a.t + t[..., None] * b.t)


class Sim3(NamedTuple):
    """scale: (...,); quat: (..., 4); t: (..., 3)."""

    scale: torch.Tensor
    quat: torch.Tensor
    t: torch.Tensor

    @staticmethod
    def identity(batch_shape=(), dtype=torch.float64, device=None) -> "Sim3":
        return Sim3(torch.ones(tuple(batch_shape), dtype=dtype, device=device),
                    rot.quat_identity(batch_shape, dtype, device),
                    torch.zeros(tuple(batch_shape) + (3,), dtype=dtype, device=device))

    def apply(self, points):
        return self.scale[..., None] * rot.quat_rotate(self.quat, points) + self.t

    def inverse(self) -> "Sim3":
        q_inv = rot.quat_conjugate(rot.quat_normalize(self.quat))
        inv_scale = 1.0 / self.scale
        return Sim3(inv_scale, q_inv, -inv_scale[..., None] * rot.quat_rotate(q_inv, self.t))

    def compose(self, other: "Sim3") -> "Sim3":
        return Sim3(self.scale * other.scale,
                    rot.quat_normalize(rot.quat_multiply(self.quat, other.quat)),
                    self.scale[..., None] * rot.quat_rotate(self.quat, other.t) + self.t)

    def transform_rigid(self, cam_from_a: Rigid3) -> Rigid3:
        """cam_from_b after remapping the world by ``b_from_a = self`` (the
        scene rescaled by ``scale`` so that the result stays rigid):
        R' = Rc R⁻¹, t' = s tc − R' t.

        reference behavior: TransformCameraWorld (geometry/sim3.h).
        """
        q_new = rot.quat_normalize(rot.quat_multiply(
            cam_from_a.quat, rot.quat_conjugate(rot.quat_normalize(self.quat))))
        return Rigid3(q_new, self.scale[..., None] * cam_from_a.t - rot.quat_rotate(q_new, self.t))
