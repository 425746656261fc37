"""BSDF closures of the renderer, the port of the JAX package's
``ops/closures.py`` (DataStreams.hpp:130-219): Lambertian diffuse, GGX
microfacet reflection by VNDF sampling, and the principled per-material
BSDF (diffuse + GGX specular + GGX microfacet refraction). Directions are in
the local tangent frame (normal = +Z); ``estimator`` is NdotL * brdf / pdf,
premultiplied as in the reference's Sample struct. The multiply-adds are
fused where XLA fuses them (``core/fp.py``)."""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..core import fp, sampling
from ..core.fp import fma
from ..core.vec import Vec3

INV_PI = 1.0 / math.pi


class BsdfSample(NamedTuple):
    direction: Vec3  # local frame
    estimator: Vec3  # NdotL * brdf / pdf


# Lambertian (DataStreams.hpp:165-182)
def lambert_eval(albedo: Vec3, l_local: Vec3, v_local: Vec3) -> Vec3:
    n_dot_l = torch.clamp_min(l_local.z, 0.0)
    return albedo * (INV_PI * n_dot_l)


def lambert_pdf(l_local: Vec3) -> torch.Tensor:
    return INV_PI * torch.clamp_min(l_local.z, 0.0)


def lambert_sample(albedo: Vec3, v_local: Vec3, u, v) -> BsdfSample:
    return BsdfSample(direction=sampling.cosine_hemisphere(u, v),
                      estimator=albedo)


def _divided(v: Vec3, s) -> Vec3:
    """``v / s`` as the JAX package's Vec3 divides by a scalar: one
    reciprocal, then three products."""
    return v * torch.div(1.0, s)


# GGX via VNDF sampling (DataStreams.hpp:184-218); the pdf is implemented
# where the reference leaves a TODO (:196-198)
def _half_vector(l_local: Vec3, v_local: Vec3):
    h = (l_local + v_local).normalize()
    return torch.clamp_min(h.z, 0.0), torch.clamp_min(h.dot(v_local), 0.0)


def ggx_eval(f0: Vec3, alpha, l_local: Vec3, v_local: Vec3,
             f80: Vec3 = None) -> Vec3:
    """Rounded as the JAX renderer's NEE contracts it
    (``sampling.microfacet_brdf``)."""
    n_dot_l = torch.clamp_min(l_local.z, 0.0)
    n_dot_v = torch.clamp_min(v_local.z, 0.0)
    n_dot_h, h_dot_v = _half_vector(l_local, v_local)
    return sampling.microfacet_brdf(f0, alpha, n_dot_v, n_dot_l, n_dot_h,
                                    h_dot_v, f80)


def ggx_pdf(alpha, l_local: Vec3, v_local: Vec3) -> torch.Tensor:
    n_dot_v = torch.clamp_min(v_local.z, 1e-6)
    n_dot_h, h_dot_v = _half_vector(l_local, v_local)
    pdf = sampling.ggx_vndf_pdf(alpha, n_dot_v, n_dot_h, h_dot_v)
    return torch.where(l_local.z > 0.0, pdf, 0.0)


def _dot_yx(a: Vec3, b: Vec3):
    """a.b with the y product fused first, as some of XLA's fusions of the
    principled sample contract it: fma(a.z, b.z, fma(a.y, b.y, a.x*b.x))."""
    return fp.dot3(a.y, a.x, a.z, b.y, b.x, b.z)


def _reflect(h, h_dot_v, v):
    """One lane of h * (2 h.v) - v, one fused multiply-add."""
    return fma(h, 2.0 * h_dot_v, -v)


def ggx_sample(f0: Vec3, alpha, v_local: Vec3, u, v,
               f80: Vec3 = None) -> BsdfSample:
    """Rounded as the JAX renderer's bounce contracts it: h.v in the plain
    order in every lane."""
    n_dot_v = torch.clamp_min(v_local.z, 0.0)
    # mirror special case at alpha == 0 (DataStreams.hpp:202-208)
    mirror_dir = Vec3(-v_local.x, -v_local.y, v_local.z)
    h = sampling.distribution_visible_normals(
        v_local, torch.clamp_min(alpha, 1e-6), u, v)
    h_dot_v_raw = h.dot(v_local)
    rough_dir = Vec3(*(_reflect(hc, h_dot_v_raw, vc)
                       for hc, vc in zip(h, v_local)))
    is_mirror = alpha == 0.0
    direction = mirror_dir.where(is_mirror, rough_dir)
    h_dot_v = torch.where(is_mirror, n_dot_v,
                          torch.clamp_min(h_dot_v_raw, 0.0))
    n_dot_l = torch.clamp_min(direction.z, 0.0)
    estimator = sampling.vndf_estimator(f0, alpha, n_dot_v, n_dot_l, h_dot_v,
                                        f80)
    return BsdfSample(direction=direction, estimator=estimator)


# Principled per-material BSDF: diffuse + GGX specular + refractive
# transmission, with per-ray stochastic lobe selection; delta lobes
# (alpha == 0) are flagged so that the integrator skips MIS for them.
class PrincipledSample(NamedTuple):
    direction: Vec3  # local frame; z < 0 means transmitted below the surface
    estimator: Vec3  # throughput multiplier (premultiplied by 1/p_lobe)
    is_delta: torch.Tensor  # bool: sampled a delta (mirror/smooth-glass) lobe
    # `direction` as the JAX renderer's fusion of the world direction's x
    # lane rounds it (the specular lobe's h.v by ``_dot_yx``); `direction`
    # itself is rounded as the y and z lanes' fusions round it
    direction_x: Vec3


def _lobe_weights(albedo: Vec3, f0: Vec3, transmission: Vec3):
    w_d = albedo.max_component()
    w_s = f0.max_component()
    w_t = transmission.max_component()
    total = torch.clamp_min(w_d + w_s + w_t, 1e-6)
    return w_d / total, w_s / total, w_t / total


def principled_eval(albedo, f0, transmission, alpha, l_local, v_local,
                    f80: Vec3 = None) -> Vec3:
    """Reflection-side eval for NEE: diffuse + rough specular (delta and
    transmission lobes never contribute to same-side direct light)."""
    spec = ggx_eval(f0, alpha, l_local, v_local, f80)
    spec_on = (alpha > 0.0) & (f0.max_component() > 0.0)
    # diff + where(spec_on, spec, 0): LLVM moves the sum into the select
    # and fuses the diffuse product there
    s = INV_PI * torch.clamp_min(l_local.z, 0.0)
    return Vec3(*(torch.where(spec_on, fma(a, s, sc), a * s)
                  for a, sc in zip(albedo, spec)))


def principled_pdf(albedo, f0, transmission, alpha, l_local, v_local):
    """Solid-angle pdf of the reflection-side lobes, mixture-weighted."""
    w_d, w_s, _ = _lobe_weights(albedo, f0, transmission)
    diff_pdf = lambert_pdf(l_local)
    spec_pdf = ggx_pdf(torch.clamp_min(alpha, 1e-4), l_local, v_local)
    # w_d*diff + where(alpha > 0, w_s*spec, 0), the sum moved into the
    # select as in principled_eval
    return torch.where(alpha > 0.0, fma(w_d, diff_pdf, w_s * spec_pdf),
                       w_d * diff_pdf)


def _schlick_f0_from_ior(ior):
    r = (ior - 1.0) / (ior + 1.0)
    return r * r


def _principled_specular(f0: Vec3, alpha, v_local: Vec3,
                         vndf: sampling.VndfParts, f80: Vec3 = None):
    """``ggx_sample`` on the VNDF sample `vndf`, rounded as the JAX
    renderer's fusions of ``principled_sample`` round it: they recompute
    the half-vector's z with hz's form of dy (``VndfParts.z_hz``) for the
    direction and for the Fresnel term's h.v, and with the half-vector's
    own for NdotL. The direction comes twice: for the world y and z lanes
    (h.v in the plain order) and for the world x lane (``_dot_yx``)."""
    n_dot_v = torch.clamp_min(v_local.z, 0.0)
    mirror = alpha == 0.0
    h = vndf.h * vndf.inv
    h_lerp = Vec3(h.x, h.y, vndf.z_hz())
    h_dot_v = h_lerp.dot(v_local)
    mirror_dir = Vec3(-v_local.x, -v_local.y, v_local.z)
    direction, direction_x = (mirror_dir.where(mirror, Vec3(*(
        _reflect(hc, dot, vc) for hc, vc in zip(h_lerp, v_local))))
        for dot in (h_dot_v, _dot_yx(h_lerp, v_local)))
    n_dot_l = torch.clamp_min(torch.where(
        mirror, v_local.z, _reflect(h.z, h.dot(v_local), v_local.z)), 0.0)
    h_dot_v = torch.where(mirror, n_dot_v, torch.clamp_min(h_dot_v, 0.0))
    return direction, direction_x, sampling.vndf_estimator(
        f0, alpha, n_dot_v, n_dot_l, h_dot_v, f80)


def principled_sample(albedo: Vec3, f0: Vec3, transmission: Vec3, alpha,
                      ior, entering, v_local: Vec3, r_lobe, u, v, r_fresnel,
                      f80: Vec3 = None) -> PrincipledSample:
    """Stochastic-lobe sample. Draw order: lobe select, (u, v), fresnel.
    The specular and the transmission lobe share one VNDF sample. Rounded
    as the JAX renderer's bounce contracts it, where XLA computes each lane
    of the world direction in its own fusion and recomputes the sample
    there (``PrincipledSample.direction_x``)."""
    w_d, w_s, w_t = _lobe_weights(albedo, f0, transmission)
    pick_d = r_lobe < w_d
    pick_s = (~pick_d) & (r_lobe < w_d + w_s)
    delta = alpha == 0.0
    vndf = sampling.vndf_parts(v_local, torch.clamp_min(alpha, 1e-6), u, v)

    # diffuse lobe
    d_sample = lambert_sample(albedo, v_local, u, v)
    d_est = _divided(d_sample.estimator, torch.clamp_min(w_d, 1e-6))

    # specular lobe
    s_dir, s_dir_x, s_est = _principled_specular(f0, alpha, v_local, vndf,
                                                 f80)
    s_est = _divided(s_est, torch.clamp_min(w_s, 1e-6))

    # transmission lobe (GGX microfacet refraction)
    n_dot_v = torch.clamp_min(v_local.z, 1e-6)
    zero, one = torch.zeros_like(alpha), torch.ones_like(alpha)
    h = Vec3(zero, zero, one).where(delta, vndf.h * vndf.inv)
    # cos(H, V); the fusion of the refracted direction's x lane fuses the
    # y product first
    c = torch.clamp_min(h.dot(v_local), 1e-6)
    c_x = torch.clamp_min(_dot_yx(h, v_local), 1e-6)
    eta = torch.where(entering, torch.div(1.0, ior), ior)
    f0_ior = _schlick_f0_from_ior(ior)

    # k = 1 - eta*eta*(1 - c*c) < 0 (total internal reflection), which XLA
    # tests as eta*eta*(1 - c*c) > 1; else reflect with Schlick's F
    tir = eta * eta * fma(-c, c, 1.0) > 1.0
    f = fma(1.0 - f0_ior, sampling.pow5(torch.clamp(1.0 - c, 0.0, 1.0)),
            f0_ior)
    do_reflect = r_fresnel < torch.where(tir, 1.0, f)
    sqrt_k = fp.sqrt(torch.clamp_min(
        fma(-(eta * eta), fma(-c, c, 1.0), 1.0), 0.0))
    # -eta*v + (eta*c - sqrt_k)*h: XLA makes -eta*v the negated product
    # -(v*eta), and the product with h fuses
    refr_dir = Vec3(*(fma(hc, fma(eta, cos, -sqrt_k), -(vc * eta))
                      for hc, vc, cos in zip(h, v_local, (c_x, c, c))))
    refl_dir = Vec3(*(_reflect(hc, c, vc) for hc, vc in zip(h, v_local)))
    t_dir = refl_dir.where(do_reflect, refr_dir.normalize())
    # refracted rays are tinted by the transmission color; the
    # reflect/refract split is importance-sampled by F, so F cancels
    g2g1 = sampling.smith_g2_over_g1(alpha * alpha, torch.abs(t_dir.z),
                                     n_dot_v)
    shadowing = torch.where(alpha > 0.0, g2g1, 1.0)
    t_base = Vec3(one, one, one).where(do_reflect, transmission)
    t_est = t_base * (shadowing / torch.clamp_min(w_t, 1e-6))

    direction, direction_x = (d_sample.direction.where(
        pick_d, s.where(pick_s, t_dir)) for s in (s_dir, s_dir_x))
    estimator = d_est.where(pick_d, s_est.where(pick_s, t_est))
    return PrincipledSample(direction=direction, estimator=estimator,
                            is_delta=~pick_d & delta,
                            direction_x=direction_x)
