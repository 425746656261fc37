"""Sampling and shading math of the main path: the counterparts of the JAX
package's ``core/sampling.py`` functions (median networks, the
hemisphere, disk and sphere-cone samplers, tangent frames, MIS heuristics,
the GGX microfacet terms), in the same operation order and with the
multiply-adds fused where XLA fuses them (``core/fp.py``), so that both
packages round alike."""
from __future__ import annotations

import math
from typing import NamedTuple

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


def polar_to_cartesian(phi_over_2pi, rho):
    phi = phi_over_2pi * TWO_PI
    return rho * fp.cos(phi), rho * fp.sin(phi)


def cosine_hemisphere(t, s) -> Vec3:
    """+Z-oriented cosine-weighted hemisphere (Sampling.hpp:92-94)."""
    return spherical_to_cartesian(s, fp.sqrt(t),
                                  fp.sqrt(torch.clamp_min(1.0 - t, 0.0)))


def disk(t, s):
    return polar_to_cartesian(s, fp.sqrt(t))


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


# Microfacet / GGX math (Sampling.hpp:252-309)
class VndfParts(NamedTuple):
    """The terms of one VNDF sample: the stretched view vector `vv` and its
    basis, the disk point (dx, and dy in hz's form), hz, and the
    half-vector before normalization with the reciprocal of its length."""

    vv: Vec3
    x_axis: Vec3
    y_axis: Vec3
    dx: torch.Tensor
    dy_hz: torch.Tensor
    hz: torch.Tensor
    h: Vec3  # (alpha * h.x, alpha * h.y, max(h.z, 0))
    inv: torch.Tensor

    def z_hz(self):
        """The normalized half-vector's z recomputed from the terms,
        x_axis.z*dx + y_axis.z*dy + vv.z*hz, with hz's form of dy."""
        z = fp.dot3(self.x_axis.z, self.y_axis.z, self.vv.z, self.dx,
                    self.dy_hz, self.hz)
        return torch.clamp_min(z, 0.0) * self.inv


def vndf_parts(v_local: Vec3, alpha, u, v) -> VndfParts:
    """Heitz VNDF sampling of the GGX half-vector (Sampling.hpp:254-270),
    term by term.

    The warped dy = sqrt(t) * (1 - lerp_t) + dy * lerp_t is recomputed in
    each of XLA's fusions that reads it, and LLVM fuses the product that
    comes first in each one's IR: sqrt(t) * (1 - lerp_t) where dy makes
    the half-vector, dy * lerp_t where it makes hz (`dy_hz`)."""
    vv = Vec3(alpha * v_local.x, alpha * v_local.y, v_local.z).normalize()
    dx, dy = disk(u, v)
    t = fma(-dx, dx, 1.0)
    lerp_t = fma(vv.z, 0.5, 0.5)
    root_t, one_lerp = fp.sqrt(torch.clamp_min(t, 0.0)), 1.0 - lerp_t
    dy_h = fma(root_t, one_lerp, dy * lerp_t)
    dy_hz = fma(dy, lerp_t, root_t * one_lerp)
    x_axis, y_axis = orthonormal_basis(vv)
    hz = fp.sqrt(torch.clamp_min(fma(-dy_hz, dy_hz, t), 0.0))
    # x_axis*dx + y_axis*dy + vv*hz, each lane as fp.dot3 contracts it
    h = Vec3(*(fp.dot3(xa, ya, va, dx, dy_h, hz)
               for xa, ya, va in zip(x_axis, y_axis, vv)))
    h = Vec3(alpha * h.x, alpha * h.y, torch.clamp_min(h.z, 0.0))
    inv = fp.rsqrt(torch.clamp_min(h.length_sq(), 1e-30))
    return VndfParts(vv, x_axis, y_axis, dx, dy_hz, hz, h, inv)


def distribution_visible_normals(v_local: Vec3, alpha, u, v) -> Vec3:
    """Heitz VNDF sampling of the GGX half-vector (Sampling.hpp:254-270);
    ``vndf_parts`` gives its terms."""
    p = vndf_parts(v_local, alpha, u, v)
    return p.h * p.inv


def pow5(x):
    t = x * x
    t = t * t
    return x * t


def fresnel_schlick(f0: Vec3, h_dot_v, f80: Vec3 = None,
                    fuse_f0: bool = False) -> Vec3:
    """Schlick Fresnel (Sampling.hpp:272-275); with `f80` the grazing
    reflectance is the material's F80 color: lerp(f0, f80, (1-cos)^5).

    XLA picks which product of f0*(1 - w) + f80*w it fuses by context:
    f80*w jitted alone and in the sampled estimator, f0*(1 - w) in the JAX
    renderer's NEE (`fuse_f0`)."""
    w = pow5(torch.clamp(1.0 - h_dot_v, 0.0, 1.0))
    one_w = 1.0 - w
    if f80 is None:
        return Vec3(*(fma(c, one_w, w) for c in f0))
    if fuse_f0:
        return Vec3(*(fma(c, one_w, g * w) for c, g in zip(f0, f80)))
    return Vec3(*(fma(g, w, c * one_w) for c, g in zip(f0, f80)))


def ggx_d(alpha2, n_dot_h2):
    temp = fma(alpha2 - 1.0, n_dot_h2, 1.0)
    return alpha2 / (math.pi * temp * temp)


def _lagarde_root(alpha2, n_dot):
    # sqrt(alpha2 + n*(n - alpha2*n)), both products fused
    return fp.sqrt(fma(n_dot, fma(-alpha2, n_dot, n_dot), alpha2))


def smith_g2_lagarde(alpha2, n_dot_l, n_dot_v):
    """Height-correlated Smith G2 pre-divided by 4*NdotL*NdotV
    (Sampling.hpp:287-291): 0.5 / (a + b) with a = n_dot_v *
    sqrt(...n_dot_l...) and b = n_dot_l * sqrt(...n_dot_v...). The sum
    fuses b's product, as the JAX renderer's NEE contracts it."""
    total = fma(n_dot_l, _lagarde_root(alpha2, n_dot_v),
                n_dot_v * _lagarde_root(alpha2, n_dot_l))
    return torch.div(0.5, torch.clamp_min(total, 1e-20))


def microfacet_brdf(f0: Vec3, alpha, n_dot_v, n_dot_l, n_dot_h, h_dot_v,
                    f80: Vec3 = None) -> Vec3:
    """NdotL * F*D*G2/(4 NdotL NdotV) (Sampling.hpp:293-296), rounded as
    the JAX renderer's NEE contracts it (``fresnel_schlick``'s `fuse_f0`,
    ``smith_g2_lagarde``)."""
    alpha2 = alpha * alpha
    scalar = (n_dot_l * ggx_d(torch.clamp_min(alpha2, 1e-5), n_dot_h * n_dot_h)
              * smith_g2_lagarde(alpha2, n_dot_l, n_dot_v))
    return fresnel_schlick(f0, h_dot_v, f80, fuse_f0=True) * scalar


def _g1_denominator(alpha2, n_dot_s2):
    return 1.0 + fp.sqrt(fma(alpha2, 1.0 - n_dot_s2, n_dot_s2)
                         / torch.clamp_min(n_dot_s2, 1e-20))


def g1_ggx(alpha2, n_dot_s2):
    return torch.div(2.0, _g1_denominator(alpha2, n_dot_s2))


def smith_g2_over_g1(alpha2, n_dot_l, n_dot_v):
    """G1(L) / (G1(V) + G1(L) - G1(V) G1(L)). XLA rewrites (2 / a) / b as
    2 / (a * b), so G1(L)'s division is folded into the last one."""
    g1v = g1_ggx(alpha2, n_dot_v * n_dot_v)
    den_l = _g1_denominator(alpha2, n_dot_l * n_dot_l)
    g1l = torch.div(2.0, den_l)
    return torch.div(2.0, den_l * torch.clamp_min(
        fma(-g1v, g1l, g1v + g1l), 1e-20))


def vndf_estimator(f0: Vec3, alpha, n_dot_v, n_dot_l, h_dot_v,
                   f80: Vec3 = None) -> Vec3:
    """F * G2/G1: the estimator of the VNDF-sampled GGX lobe
    (Sampling.hpp:307-309)."""
    return fresnel_schlick(f0, h_dot_v, f80) * smith_g2_over_g1(
        alpha * alpha, n_dot_l, n_dot_v)


def ggx_vndf_pdf(alpha, n_dot_v, n_dot_h, h_dot_v):
    """pdf of the reflected direction under VNDF sampling,
    G1(V) * D(H) / (4 NdotV) (the reference's TODO, DataStreams.hpp:196)."""
    alpha2 = torch.clamp_min(alpha * alpha, 1e-7)
    g1 = g1_ggx(alpha2, n_dot_v * n_dot_v)
    d = ggx_d(alpha2, n_dot_h * n_dot_h)
    return g1 * d / torch.clamp_min(4.0 * n_dot_v, 1e-6)
