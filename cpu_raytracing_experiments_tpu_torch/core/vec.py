"""Structure-of-arrays 3-vector and quaternion on PyTorch tensors, the
counterparts of the JAX package's ``core/vec.py``. A ``Vec3`` is three
same-shape float32 tensors, one per component, so every elementwise op runs
over full-width contiguous tensors (the layout the sphere-battery kernels
read)."""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import fp


class Vec3(NamedTuple):
    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor

    def __add__(self, o: "Vec3") -> "Vec3":
        return Vec3(self.x + o.x, self.y + o.y, self.z + o.z)

    def __sub__(self, o: "Vec3") -> "Vec3":
        return Vec3(self.x - o.x, self.y - o.y, self.z - o.z)

    def __mul__(self, o) -> "Vec3":
        if isinstance(o, Vec3):
            return Vec3(self.x * o.x, self.y * o.y, self.z * o.z)
        return Vec3(self.x * o, self.y * o, self.z * o)

    __rmul__ = __mul__

    def __neg__(self) -> "Vec3":
        return Vec3(-self.x, -self.y, -self.z)

    def dot(self, o: "Vec3") -> torch.Tensor:
        return fp.dot3(self.x, self.y, self.z, o.x, o.y, o.z)

    def length_sq(self) -> torch.Tensor:
        return self.dot(self)

    def normalize(self) -> "Vec3":
        return self * fp.rsqrt(torch.clamp_min(self.length_sq(), 1e-30))

    def cross(self, o: "Vec3") -> "Vec3":
        # y*oz - z*oy contracts to fma(y, oz, -(z*oy))
        return Vec3(
            fp.fma(self.y, o.z, -(self.z * o.y)),
            fp.fma(self.z, o.x, -(self.x * o.z)),
            fp.fma(self.x, o.y, -(self.y * o.x)),
        )

    def max_component(self) -> torch.Tensor:
        return torch.maximum(self.x, torch.maximum(self.y, self.z))

    @staticmethod
    def full(shape, value, device=None) -> "Vec3":
        a = torch.full(shape, value, dtype=torch.float32, device=device)
        return Vec3(a, a, a)

    @staticmethod
    def zeros(shape, device=None) -> "Vec3":
        return Vec3.full(shape, 0.0, device)

    @staticmethod
    def splat(v, device=None) -> "Vec3":
        """A scalar Vec3 (0-d float32 tensors) from a length-3 sequence."""
        return Vec3(*(torch.tensor(float(c), dtype=torch.float32, device=device)
                      for c in v[:3]))

    def where(self, mask, other: "Vec3") -> "Vec3":
        """Componentwise select: mask ? self : other."""
        return Vec3(
            torch.where(mask, self.x, other.x),
            torch.where(mask, self.y, other.y),
            torch.where(mask, self.z, other.z),
        )

    def stack(self) -> torch.Tensor:
        return torch.stack([self.x, self.y, self.z], dim=-1)

    def to(self, device) -> "Vec3":
        return Vec3(self.x.to(device), self.y.to(device), self.z.to(device))


class Quat(NamedTuple):
    """SoA quaternion (x, y, z, w), w = scalar part (glm layout)."""

    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor
    w: torch.Tensor

    def rotate(self, v: Vec3) -> Vec3:
        """q * v * conj(q) (glm::rotate(quat, vec3), Camera.hpp:80-88)."""
        qv = Vec3(self.x, self.y, self.z)
        t = qv.cross(v) * 2.0
        # (v + t*w) + cross(q, t): the first sum contracts, the second adds
        return fp.fma3(t, self.w, v) + qv.cross(t)

    def to(self, device) -> "Quat":
        return Quat(*(c.to(device) for c in self))
