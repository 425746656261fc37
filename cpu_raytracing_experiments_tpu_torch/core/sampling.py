"""Sampling and shading math of the main path: the counterparts of the JAX
package's ``core/sampling.py`` functions (median networks, the
hemisphere and sphere-cone samplers, tangent frames, MIS heuristics), in
the same operation order and with the multiply-adds fused where XLA fuses
them (``core/fp.py``), so that both packages round alike."""
from __future__ import annotations

import math

import torch

from . import fp
from .fp import fma
from .vec import Quat, Vec3

TWO_PI = 2.0 * math.pi
INV_PI = 1.0 / math.pi
INV_TWO_PI = 0.5 / math.pi


# Median networks (Sampling.hpp:8-21), used by the median-of-means resolve.
def median3(a, b, c):
    return torch.maximum(torch.minimum(a, b),
                         torch.minimum(torch.maximum(a, b), c))


def median5(a, b, c, d, e):
    return median3(
        torch.maximum(torch.minimum(a, b), torch.minimum(c, d)),
        torch.minimum(torch.maximum(a, b), torch.maximum(c, d)),
        e,
    )


# Mappings (Sampling.hpp:77-104)
def spherical_to_cartesian(phi_over_2pi, sin_theta, cos_theta) -> Vec3:
    phi = phi_over_2pi * TWO_PI
    return Vec3(sin_theta * fp.cos(phi), sin_theta * fp.sin(phi), cos_theta)


def cosine_hemisphere(t, s) -> Vec3:
    """+Z-oriented cosine-weighted hemisphere (Sampling.hpp:92-94)."""
    return spherical_to_cartesian(s, fp.sqrt(t),
                                  fp.sqrt(torch.clamp_min(1.0 - t, 0.0)))


# Tangent space (Sampling.hpp:108-187)
def orthonormal_basis(n: Vec3):
    """Branchless Pixar/Duff basis (Sampling.hpp:116-130). n must be unit."""
    sign = torch.where(torch.signbit(n.z), -1.0, 1.0).to(torch.float32)
    a = torch.div(-1.0, sign + n.z)
    b = n.x * n.y * a
    v2 = Vec3(fma(sign * n.x * n.x, a, 1.0), sign * b, -sign * n.x)
    v3 = Vec3(b, fma(a * n.y, n.y, sign), -n.y)
    return v2, v3


def tangent_space(n: Vec3) -> Quat:
    """Quaternion rotating +Z to N, with q.z == 0 (Sampling.hpp:150-159)."""
    degenerate = n.z < (-1.0 + 1.1920929e-7)
    s = fp.sqrt(torch.clamp_min(2.0 * (n.z + 1.0), 1e-30))
    invs = 1.0 / s
    return Quat(
        x=torch.where(degenerate, 0.0, -n.y * invs),
        y=torch.where(degenerate, 1.0, n.x * invs),
        z=torch.zeros_like(n.z),
        w=torch.where(degenerate, 0.0, s * 0.5),
    )


def _to_local(f, t: Quat, v: Vec3, fuse_xy: bool) -> Vec3:
    inner = f(v.x, t.y, v.z * t.w) if fuse_xy else f(v.z, t.w, v.x * t.y)
    temp = 2.0 * f(-t.x, v.y, inner)
    return Vec3(f(-t.y, temp, v.x), f(t.x, temp, v.y), f(temp, t.w, -v.z))


def _to_world(f, t: Quat, v: Vec3) -> Vec3:
    temp = 2.0 * f(t.x, v.y, f(v.z, t.w, -(v.x * t.y)))
    return Vec3(f(t.y, temp, v.x), f(-t.x, temp, v.y), f(temp, t.w, -v.z))


def to_local(t: Quat, v: Vec3, fuse_xy: bool = False) -> Vec3:
    """Rotate by conj(T) assuming T.z == 0 (Sampling.hpp:161-169); on the
    card one launch where the operands are flat.

    temp's inner sum v.z*t.w + v.x*t.y is one fused multiply-add, and XLA
    picks which product it fuses by the context of the call: the caller
    passes the JAX renderer's choice at its call site. fma(v.z, t.w,
    v.x*t.y) by default; with `fuse_xy`, fma(v.x, t.y, v.z*t.w)."""
    op = fp.fma_kernel.TO_LOCAL_XY if fuse_xy else fp.fma_kernel.TO_LOCAL
    out = fp.contract(op, (t.x, t.y, t.w, *v))
    return Vec3(*out) if out is not None else _to_local(fma, t, v, fuse_xy)


def to_world(t: Quat, v: Vec3) -> Vec3:
    """Rotate by T assuming T.z == 0 (Sampling.hpp:171-179); on the card
    one launch where the operands are flat."""
    out = fp.contract(fp.fma_kernel.TO_WORLD, (t.x, t.y, t.w, *v))
    return Vec3(*out) if out is not None else _to_world(fma, t, v)


def to_local_plain(t: Quat, v: Vec3, fuse_xy: bool = False) -> Vec3:
    """``to_local`` from ``fp.fma_plain``: the plain version of its
    kernel."""
    return _to_local(fp.fma_plain, t, v, fuse_xy)


def to_world_plain(t: Quat, v: Vec3) -> Vec3:
    """``to_world`` from ``fp.fma_plain``: the plain version of its
    kernel."""
    return _to_world(fp.fma_plain, t, v)


# Light sampling (Sampling.hpp:192-247)
def cone_pdf(cos_theta_max):
    # torch.div, not `c / x`: a Tensor's __rtruediv__ is reciprocal() * c,
    # which rounds twice where the JAX package's division rounds once
    return torch.div(INV_TWO_PI, torch.clamp_min(1.0 - cos_theta_max, 1e-6))


def sphere_pdf(radius_sq, dist_sq):
    sin_theta_max2 = radius_sq / dist_sq
    cos_theta_max = fp.sqrt(torch.clamp_min(1.0 - sin_theta_max2, 0.0))
    return cone_pdf(cos_theta_max)


def sample_direction_to_sphere(wc: Vec3, sin_theta_max2, center_dist,
                               radius_sq, t, s):
    """Cone-sample a direction toward a sphere light (Sampling.hpp:220-239),
    with the Taylor switch for tiny subtended angles and the scale-aware
    shadow-epsilon pull-back. Returns (L, distance, pdf)."""
    cos_theta_max = fp.sqrt(torch.clamp_min(1.0 - sin_theta_max2, 0.0))
    pdf = cone_pdf(cos_theta_max)
    small = sin_theta_max2 < 0.00068523
    cos_theta = fma(-t, 1.0 - cos_theta_max, 1.0)
    sin_theta = fp.sqrt(sin_theta_max2 * t)
    src_blend = torch.where(small, sin_theta, cos_theta)
    invert = fp.sqrt(torch.clamp_min(fma(-src_blend, src_blend, 1.0), 0.0))
    cos_theta = torch.where(small, invert, cos_theta)
    sin_theta = torch.where(small, sin_theta, invert)
    temp = center_dist * sin_theta
    raw = fma(center_dist, cos_theta, -fp.sqrt(
        torch.clamp_min(fma(-temp, temp, radius_sq), 0.0)))
    distance = raw - torch.clamp_min(raw * 1e-5, 1e-5)
    l_local = spherical_to_cartesian(s, sin_theta, cos_theta)
    wc_x, wc_y = orthonormal_basis(wc)
    l = Vec3(*(fp.dot3(bx, by, bz, l_local.x, l_local.y, l_local.z)
               for bx, by, bz in zip(wc_x, wc_y, wc)))
    return l, distance, pdf


def power_heuristic(f, g):
    f2 = f * f  # used twice, so only g*g contracts
    return f2 / torch.clamp_min(fma(g, g, f2), 1e-6)


def power_heuristic_over_f(f, g):
    return f / torch.clamp_min(fma(f, f, g * g), 1e-6)
