"""GGX and the principled BSDF of the port (``core/sampling.py``'s microfacet
terms, ``ops/closures.py``, the shading of ``render/renderer.py`` and
``scene/builders.py::brdf_test_scene``) against the JAX package on the CPU.

Tolerances:
* every function, against the JAX package's under ``jax.jit`` with
  correctly rounded rsqrt, sin and cos (``jax_exact_math``; XLA's CPU forms
  are not correctly rounded, the port's are): equal bits, NaN lanes
  counted equal, on 40,000 random lanes of physical inputs and 10,000 of
  wide ones (either sign, exponents -8 to 8: no subnormal result, which XLA
  on the CPU flushes to zero). Where XLA contracts a term of the function
  jitted alone otherwise than inside the JAX renderer, which the port
  follows, the JAX function is held to a witness chain of its contraction
  and the port to the chain of the renderer's, equal bits each;
* against ``tests/oracle.py``'s float64 GGX (the reference's formulas):
  within rtol 2e-4 / atol 1e-6 on every lane away from grazing angles;
* ``bounce_step`` on ``brdf_test_scene`` ('roughness', 'roughness_glass')
  and the hero under 'ggx' and 'principled', with and without
  ``shade_f80``: the bar of ``test_torch_knobs.check_bounce_steps`` (ids,
  alive, ray_count and the delta flags equal; floats within rtol 1e-4 /
  atol 1e-6 on 99.9% of lanes); against the exact-math witness, every
  lane bit for bit;
* a whole render through ``Renderer(device="cpu")`` against the checked-in
  ``brdf_ggx`` golden at ``tests/test_goldens.py::_check``'s bar.
"""
import numpy as np
import pytest
import jax
import torch

import oracle
from cpu_raytracing_experiments_tpu.core import sampling as jsampling
from cpu_raytracing_experiments_tpu.core.vec import Vec3 as JVec3
from cpu_raytracing_experiments_tpu.ops import closures as jclosures
from cpu_raytracing_experiments_tpu.scene import builders as jbuilders
from cpu_raytracing_experiments_tpu_torch import Renderer
from cpu_raytracing_experiments_tpu_torch.core import fp, sampling
from cpu_raytracing_experiments_tpu_torch.core.vec import Vec3
from cpu_raytracing_experiments_tpu_torch.ops import closures
from cpu_raytracing_experiments_tpu_torch.scene import builders as tbuilders

from test_goldens import SIZE, SPP, _check
from test_torch_knobs import (check_bounce_steps, jax_exact_math,  # noqa: F401
                              policies)
from test_torch_scene import _assert_same_arrays, jax_scene_to_numpy

torch.set_num_threads(1)

N, NW = 40_000, 10_000  # physical and wide random lanes


def _same(x, y):
    x, y = np.asarray(x), np.asarray(y)
    assert x.shape == y.shape and x.dtype == y.dtype
    if x.dtype != np.float32:
        return np.array_equal(x, y)
    return bool(np.all((np.isnan(x) & np.isnan(y))
                       | (x.view(np.int32) == y.view(np.int32))))


def _columns(seed, kinds):
    """One float32 column per kind: 'unit' in [0, 1), 'signed' in (-1, 1),
    'alpha' in [0, 1) with 15% exact zeros, 'ior' in [1, 1.5), 'bool';
    then NW wide lanes (all kinds but 'bool')."""
    g = np.random.default_rng(seed)
    cols = []
    for kind in kinds:
        if kind == "bool":
            cols.append(g.uniform(size=N + NW) < 0.5)
            continue
        a = {"unit": lambda: g.uniform(0, 1, N),
             "signed": lambda: g.uniform(-1, 1, N),
             "alpha": lambda: np.where(g.uniform(size=N) < 0.15, 0.0,
                                       g.uniform(0, 1, N)),
             "ior": lambda: 1.0 + 0.5 * g.uniform(0, 1, N)}[kind]()
        wide = (g.uniform(1, 2, NW) * 2.0 ** g.integers(-8, 9, NW)
                * g.choice([-1.0, 1.0], NW))
        cols.append(np.concatenate([a, wide]).astype(np.float32))
    return cols


def _unit_vectors(seed, n=N + NW, upper=False):
    g = np.random.default_rng(seed)
    a = g.normal(size=(3, n))
    a /= np.linalg.norm(a, axis=0)
    if upper:
        a[2] = np.abs(a[2])
    return [c.astype(np.float32) for c in a]


def _flat(out):
    """A function's outputs as a flat tuple of arrays."""
    if isinstance(out, (tuple, list)):
        return tuple(x for o in out for x in _flat(o))
    return (out,)


def _check_same(jax_fn, port_fn, cols):
    want = _flat(jax.jit(lambda *a: jax_fn(*a))(*cols))
    got = _flat(port_fn(*(torch.from_numpy(c) for c in cols)))
    assert len(want) == len(got)
    for k, (w, g) in enumerate(zip(want, got)):
        assert _same(g.numpy(), np.asarray(w)), k


SAMPLING = {
    "polar_to_cartesian": (lambda m: lambda s, r: m.polar_to_cartesian(s, r),
                           ["unit", "unit"]),
    "disk": (lambda m: lambda t, s: m.disk(t, s), ["unit", "unit"]),
    "distribution_visible_normals": (
        lambda m: lambda x, y, z, a, u, v: tuple(
            m.distribution_visible_normals(
                (JVec3 if m is jsampling else Vec3)(x, y, z), a, u, v)),
        ["signed", "signed", "unit", "unit", "unit", "unit"]),
    "pow5": (lambda m: m.pow5, ["signed"]),
    "fresnel_schlick": (
        lambda m: lambda a, b, c, h: tuple(m.fresnel_schlick(
            (JVec3 if m is jsampling else Vec3)(a, b, c), h)),
        ["unit"] * 4),
    "fresnel_schlick_f80": (
        lambda m: lambda a, b, c, h, d, e, f: tuple(m.fresnel_schlick(
            (JVec3 if m is jsampling else Vec3)(a, b, c), h,
            (JVec3 if m is jsampling else Vec3)(d, e, f))),
        ["unit"] * 7),
    "ggx_d": (lambda m: m.ggx_d, ["unit", "unit"]),
    "smith_g2_lagarde": (lambda m: m.smith_g2_lagarde, ["unit"] * 3),
    "microfacet_brdf": (
        lambda m: lambda a, b, c, al, nv, nl, nh, hv: tuple(m.microfacet_brdf(
            (JVec3 if m is jsampling else Vec3)(a, b, c), al, nv, nl, nh,
            hv)),
        ["unit"] * 8),
    "microfacet_brdf_f80": (
        lambda m: lambda a, b, c, al, nv, nl, nh, hv, d, e, f: tuple(
            m.microfacet_brdf((JVec3 if m is jsampling else Vec3)(a, b, c),
                              al, nv, nl, nh, hv,
                              (JVec3 if m is jsampling else Vec3)(d, e, f))),
        ["unit"] * 11),
    "g1_ggx": (lambda m: m.g1_ggx, ["unit", "unit"]),
    "smith_g2_over_g1": (lambda m: m.smith_g2_over_g1, ["unit"] * 3),
    "vndf_estimator": (
        lambda m: lambda a, b, c, al, nv, nl, hv: tuple(m.vndf_estimator(
            (JVec3 if m is jsampling else Vec3)(a, b, c), al, nv, nl, hv)),
        ["unit"] * 7),
    "vndf_estimator_f80": (
        lambda m: lambda a, b, c, al, nv, nl, hv, d, e, f: tuple(
            m.vndf_estimator((JVec3 if m is jsampling else Vec3)(a, b, c), al,
                             nv, nl, hv,
                             (JVec3 if m is jsampling else Vec3)(d, e, f))),
        ["unit"] * 10),
    "ggx_vndf_pdf": (lambda m: m.ggx_vndf_pdf, ["unit"] * 4),
}


def _smith_chain(alpha2, n_dot_l, n_dot_v, renderer):
    """smith_g2_lagarde's 0.5 / (a + b), a = n_dot_v * sqrt(...n_dot_l...)
    and b = n_dot_l * sqrt(...n_dot_v...): the sum fuses a's product where
    XLA contracts the function jitted alone, b's in the JAX renderer's NEE
    (`renderer`)."""
    root_l = sampling._lagarde_root(alpha2, n_dot_l)
    root_v = sampling._lagarde_root(alpha2, n_dot_v)
    total = (fp.fma(n_dot_l, root_v, n_dot_v * root_l) if renderer
             else fp.fma(n_dot_v, root_l, n_dot_l * root_v))
    return torch.div(0.5, torch.clamp_min(total, 1e-20))


def _brdf_chain(renderer, f0, alpha, n_dot_v, n_dot_l, n_dot_h, h_dot_v,
                f80=None):
    """microfacet_brdf with `_smith_chain`'s sum; the Fresnel lerp fuses
    its f80 product jitted alone, its f0 product in the renderer's NEE."""
    alpha2 = alpha * alpha
    scalar = (n_dot_l * sampling.ggx_d(torch.clamp_min(alpha2, 1e-5),
                                       n_dot_h * n_dot_h)
              * _smith_chain(alpha2, n_dot_l, n_dot_v, renderer))
    return sampling.fresnel_schlick(f0, h_dot_v, f80,
                                    fuse_f0=renderer) * scalar


# witness chains of the sampling terms that XLA contracts by context, as
# functions of (renderer, *columns)
SAMPLING_CHAINS = {
    "smith_g2_lagarde": lambda r, a2, nl, nv: _smith_chain(a2, nl, nv, r),
    "microfacet_brdf": lambda r, a, b, c, *x: tuple(
        _brdf_chain(r, Vec3(a, b, c), *x)),
    "microfacet_brdf_f80": lambda r, a, b, c, al, nv, nl, nh, hv, d, e, f:
        tuple(_brdf_chain(r, Vec3(a, b, c), al, nv, nl, nh, hv,
                          Vec3(d, e, f))),
}


@pytest.mark.parametrize("name", list(SAMPLING))
def test_sampling_matches_jitted_jax(name, jax_exact_math):
    """core/sampling.py's disk and GGX terms, bit for bit. XLA fuses the
    multiply-adds of each by its own rules, which the port writes out: for
    instance f0*(1-w) + f80*w fuses the second product, (2/a)/b becomes
    2/(a*b) in smith_g2_over_g1, and the VNDF's warped dy fuses its first
    product where it makes the half-vector and its second where it makes
    hz. smith_g2_lagarde and microfacet_brdf are contracted otherwise
    inside the JAX renderer's NEE, the port's one caller: the JAX function
    equals the chain of its own contraction, the port's the renderer's."""
    make, kinds = SAMPLING[name]
    cols = _columns(list(SAMPLING).index(name), kinds)
    if name not in SAMPLING_CHAINS:
        _check_same(make(jsampling), make(sampling), cols)
        return
    t = [torch.from_numpy(c) for c in cols]
    for renderer, ref in ((False, jax.jit(make(jsampling))(*cols)),
                          (True, make(sampling)(*t))):
        chain = _flat(SAMPLING_CHAINS[name](renderer, *t))
        ref = _flat(ref)
        assert len(chain) == len(ref)
        for k, (c, y) in enumerate(zip(chain, ref)):
            assert _same(c.numpy(), np.asarray(y)), (renderer, k)


def _closure_inputs(seed):
    """v (upper hemisphere but for the wide lanes' signs), l, alpha, f0,
    f80, albedo, transmission, ior, entering and four draws."""
    g = np.random.default_rng(seed)
    n = N + NW
    unit = lambda: g.uniform(0, 1, n).astype(np.float32)
    v = _unit_vectors(seed, upper=True)
    v[2][N:] *= np.where(g.uniform(size=NW) < 0.1, -1, 1).astype(np.float32)
    alpha = unit()
    alpha[g.uniform(size=n) < 0.15] = 0.0
    return dict(v=v, l=_unit_vectors(seed + 1), alpha=alpha,
                f0=[unit() for _ in range(3)], f80=[unit() for _ in range(3)],
                albedo=[unit() for _ in range(3)],
                transmission=[unit() for _ in range(3)],
                ior=(1.0 + 0.5 * unit()).astype(np.float32),
                entering=g.uniform(size=n) < 0.5,
                draws=[unit() for _ in range(4)])


def _closure(name, m, vec, x, f80):
    """The closure `name` of module `m` on the inputs `x` (arrays of `m`'s
    kind), as a flat tuple."""
    v, l, f = vec(*x["v"]), vec(*x["l"]), vec(*x["f0"]) if "f0" in x else None
    g80 = vec(*x["f80"]) if f80 else None
    d = x["draws"]
    if name == "ggx_eval":
        return tuple(m.ggx_eval(f, x["alpha"], l, v, g80))
    if name == "ggx_pdf":
        return (m.ggx_pdf(x["alpha"], l, v),)
    if name == "ggx_sample":
        s = m.ggx_sample(f, x["alpha"], v, d[0], d[1], g80)
        return tuple(s.direction) + tuple(s.estimator)
    alb, tr = vec(*x["albedo"]), vec(*x["transmission"])
    if name == "principled_eval":
        return tuple(m.principled_eval(alb, f, tr, x["alpha"], l, v, g80))
    if name == "principled_pdf":
        return (m.principled_pdf(alb, f, tr, x["alpha"], l, v),)
    if name == "lobe_weights":
        return tuple(m._lobe_weights(alb, f, tr))
    if name == "schlick_f0_from_ior":
        return (m._schlick_f0_from_ior(x["ior"]),)
    s = m.principled_sample(alb, f, tr, x["alpha"], x["ior"], x["entering"],
                            v, *d, g80)
    return tuple(s.direction) + tuple(s.estimator) + (s.is_delta,)


def _ggx_eval_chain(x, f80, renderer):
    """ggx_eval through `_brdf_chain`."""
    v, l = Vec3(*x["v"]), Vec3(*x["l"])
    n_dot_h, h_dot_v = closures._half_vector(l, v)
    return _brdf_chain(renderer, Vec3(*x["f0"]), x["alpha"],
                       torch.clamp_min(v.z, 0.0), torch.clamp_min(l.z, 0.0),
                       n_dot_h, h_dot_v, Vec3(*x["f80"]) if f80 else None)


def _principled_eval_chain(x, f80, renderer):
    """principled_eval: diffuse + where(spec_on, ggx_eval, 0), the sum
    moved into the select with the diffuse product fused, ggx_eval through
    `_ggx_eval_chain`."""
    spec = _ggx_eval_chain(x, f80, renderer)
    spec_on = (x["alpha"] > 0.0) & (Vec3(*x["f0"]).max_component() > 0.0)
    s = closures.INV_PI * torch.clamp_min(x["l"][2], 0.0)
    return tuple(torch.where(spec_on, fp.fma(a, s, sc), a * s)
                 for a, sc in zip(x["albedo"], spec))


def _dot(renderer):
    """The h.v of a direction's x lane: the plain order in the JAX
    renderer's fusions of the y and z lanes of the world direction, the y
    product fused first (closures._dot_yx) where XLA computes the x lane of
    ggx_sample or principled_sample jitted alone."""
    return (lambda a, b: a.dot(b)) if renderer else closures._dot_yx


def _ggx_sample_x_chain(x, f80, renderer):
    """The x lane of ggx_sample's direction: -v.x on the mirror lanes,
    else h * (2 h.v) - v with `_dot`'s h.v."""
    v, alpha = Vec3(*x["v"]), x["alpha"]
    h = sampling.distribution_visible_normals(
        v, torch.clamp_min(alpha, 1e-6), *x["draws"][:2])
    return torch.where(alpha == 0.0, -v.x, closures._reflect(
        h.x, _dot(renderer)(h, v), v.x))


def _principled_sample_x_chain(x, f80, renderer):
    """The x lane of principled_sample's direction with `_dot`'s h.v in the
    specular reflection and in the transmission lobe's Fresnel choice and
    reflection; the refraction's own fusion dots h.v as closures._dot_yx
    in its x lane, the plain order in y and z, in either form."""
    v, alpha, ior = Vec3(*x["v"]), x["alpha"], x["ior"]
    r_lobe, u, w, r_fresnel = x["draws"]
    dot = _dot(renderer)
    w_d, w_s, _ = closures._lobe_weights(
        *(Vec3(*x[k]) for k in ("albedo", "f0", "transmission")))
    vndf = sampling.vndf_parts(v, torch.clamp_min(alpha, 1e-6), u, w)
    h = vndf.h * vndf.inv
    h_s = Vec3(h.x, h.y, vndf.z_hz())
    spec = torch.where(alpha == 0.0, -v.x,
                       closures._reflect(h_s.x, dot(h_s, v), v.x))
    zero, one = torch.zeros_like(alpha), torch.ones_like(alpha)
    h = Vec3(zero, zero, one).where(alpha == 0.0, h)
    c, c_x = (torch.clamp_min(d, 1e-6)
              for d in (h.dot(v), closures._dot_yx(h, v)))
    c_dot = torch.clamp_min(dot(h, v), 1e-6)
    eta = torch.where(x["entering"], torch.div(1.0, ior), ior)
    f0_ior = closures._schlick_f0_from_ior(ior)
    tir = eta * eta * fp.fma(-c_dot, c_dot, 1.0) > 1.0
    fresnel = fp.fma(1.0 - f0_ior, sampling.pow5(
        torch.clamp(1.0 - c_dot, 0.0, 1.0)), f0_ior)
    sqrt_k = fp.sqrt(torch.clamp_min(
        fp.fma(-(eta * eta), fp.fma(-c, c, 1.0), 1.0), 0.0))
    refr = Vec3(*(fp.fma(hc, fp.fma(eta, cos, -sqrt_k), -(vc * eta))
                  for hc, vc, cos in zip(h, v, (c_x, c, c)))).normalize()
    trans = torch.where(r_fresnel < torch.where(tir, 1.0, fresnel),
                        closures._reflect(h.x, c_dot, v.x), refr.x)
    diffuse = sampling.cosine_hemisphere(u, w).x
    return torch.where(r_lobe < w_d, diffuse,
                       torch.where(r_lobe < w_d + w_s, spec, trans))


# witness chains of the closures' outputs that XLA contracts by context:
# {output index: chain(inputs, f80, renderer)}
CLOSURE_CHAINS = {
    "ggx_eval": {k: lambda x, f80, r, k=k: _ggx_eval_chain(x, f80, r)[k]
                 for k in range(3)},
    "ggx_sample": {0: _ggx_sample_x_chain},
    "principled_eval": {
        k: lambda x, f80, r, k=k: _principled_eval_chain(x, f80, r)[k]
        for k in range(3)},
    "principled_sample": {0: _principled_sample_x_chain},
}

CLOSURES = [("ggx_eval", False), ("ggx_eval", True), ("ggx_pdf", False),
            ("ggx_sample", False), ("ggx_sample", True),
            ("principled_eval", False), ("principled_eval", True),
            ("principled_pdf", False), ("lobe_weights", False),
            ("schlick_f0_from_ior", False), ("principled_sample", False),
            ("principled_sample", True)]


@pytest.mark.parametrize("name,f80", CLOSURES)
def test_closure_matches_jitted_jax(name, f80, jax_exact_math):
    """ops/closures.py, bit for bit, the mirror lanes (alpha == 0), the
    TIR lanes and the three lobes of the principled sample included. Where
    the JAX package writes diff + where(on, spec, 0) LLVM moves the sum
    into the select and fuses the diffuse product; XLA recomputes the
    half-vector in each output's fusion and contracts it there (the
    specular lobe's z takes hz's form of dy), and tests TIR's k < 0 as
    eta^2 (1 - c^2) > 1. The port follows each. The outputs of
    CLOSURE_CHAINS XLA contracts otherwise jitted alone than inside the
    JAX renderer, whose forms the port takes: NEE's eval (Smith's sum and
    the Fresnel lerp) and the x lane of the sampled direction (h.v). There
    the JAX function equals the chain of its own contraction, the port the
    renderer's; test_render_exact_with_exact_math holds the port's forms
    inside the renderer."""
    x = _closure_inputs(len(name) + 17 * f80)
    want = jax.jit(lambda a: _closure(name, jclosures, JVec3, a, f80))(x)
    t = {k: ([torch.from_numpy(c) for c in a] if isinstance(a, list)
             else torch.from_numpy(a)) for k, a in x.items()}
    got = _closure(name, closures, Vec3, t, f80)
    assert len(want) == len(got)
    chains = CLOSURE_CHAINS.get(name, {})
    for k, (w, g) in enumerate(zip(want, got)):
        if k in chains:
            assert _same(chains[k](t, f80, False).numpy(), np.asarray(w)), k
            assert _same(g.numpy(), chains[k](t, f80, True).numpy()), k
        else:
            assert _same(g.numpy(), np.asarray(w)), k
    if name == "principled_sample":
        # every lobe and the delta flag occur
        wd, ws, _ = closures._lobe_weights(
            *(Vec3(*t[k]) for k in ("albedo", "f0", "transmission")))
        lobe = t["draws"][0]
        assert (lobe < wd).any() and ((lobe >= wd) & (lobe < wd + ws)).any()
        assert (lobe >= wd + ws).any() and got[-1].any()


def _grazing_free(seed, n=2000):
    """Oracle inputs away from grazing angles: v.z and l.z >= 0.1, alpha in
    [0.05, 1)."""
    g = np.random.default_rng(seed)
    v, l = [], []
    while len(v) < n:
        a = g.normal(size=3)
        a /= np.linalg.norm(a)
        if a[2] >= 0.1:
            v.append(a)
        b = g.normal(size=3)
        b /= np.linalg.norm(b)
        if b[2] >= 0.1:
            l.append(b)
    m = min(len(v), len(l))
    return (np.array(v[:m], np.float32), np.array(l[:m], np.float32),
            g.uniform(0.05, 1, m).astype(np.float32),
            g.uniform(0, 1, (m, 3)).astype(np.float32),
            g.uniform(0, 1, (m, 3)).astype(np.float32),
            g.uniform(0, 1, (m, 2)).astype(np.float32))


@pytest.mark.parametrize("f80", [False, True])
def test_ggx_matches_oracle(f80):
    """ggx_eval, ggx_pdf, ggx_sample and the VNDF sample against
    tests/oracle.py's float64 GGX (Sampling.hpp:252-309,
    DataStreams.hpp:184-218): within rtol 2e-4 / atol 1e-6 on every
    lane (2,000 lanes with v.z, l.z >= 0.1 and alpha >= 0.05)."""
    v, l, alpha, f0, g80, uv = _grazing_free(3 + f80)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    tv, tl = Vec3(*t(v.T)), Vec3(*t(l.T))
    tf0, t80 = Vec3(*t(f0.T)), Vec3(*t(g80.T)) if f80 else None
    ev = np.stack([c.numpy() for c in closures.ggx_eval(
        tf0, t(alpha), tl, tv, t80)], axis=1)
    pdf = closures.ggx_pdf(t(alpha), tl, tv).numpy()
    s = closures.ggx_sample(tf0, t(alpha), tv, t(uv[:, 0]), t(uv[:, 1]), t80)
    sd, se = (np.stack([c.numpy() for c in x], axis=1)
              for x in (s.direction, s.estimator))
    h = np.stack([c.numpy() for c in sampling.distribution_visible_normals(
        tv, t(alpha), t(uv[:, 0]), t(uv[:, 1]))], axis=1)
    f64 = lambda a: np.asarray(a, np.float64)
    for i in range(len(alpha)):
        o80 = f64(g80[i]) if f80 else None
        want = oracle.ggx_eval(f64(f0[i]), float(alpha[i]), f64(l[i]),
                               f64(v[i]), o80)
        np.testing.assert_allclose(ev[i], want, rtol=2e-4, atol=1e-6)
        np.testing.assert_allclose(
            pdf[i], oracle.ggx_pdf(float(alpha[i]), f64(l[i]), f64(v[i])),
            rtol=2e-4, atol=1e-6)
        d, e = oracle.ggx_sample(f64(f0[i]), float(alpha[i]), f64(v[i]),
                                 float(uv[i, 0]), float(uv[i, 1]), o80)
        np.testing.assert_allclose(sd[i], d, rtol=2e-4, atol=1e-6)
        np.testing.assert_allclose(se[i], e, rtol=2e-4, atol=1e-6)
        np.testing.assert_allclose(
            h[i], oracle.vndf_sample(f64(v[i]), float(alpha[i]),
                                     float(uv[i, 0]), float(uv[i, 1])),
            rtol=2e-4, atol=1e-6)


@pytest.mark.parametrize("prop", jbuilders.BRDF_TEST_PROPERTIES)
def test_brdf_test_scene_matches_jax(prop):
    """scene/builders.py::brdf_test_scene: every array of each of the eight
    property lineups equals the JAX package's."""
    _assert_same_arrays(
        tbuilders.brdf_test_scene(16, 16, prop=prop).to_numpy(),
        jax_scene_to_numpy(jbuilders.brdf_test_scene(16, 16, prop=prop)))
    with pytest.raises(ValueError, match="brdf_test property"):
        tbuilders.brdf_test_scene(16, 16, prop="metal")


@pytest.mark.parametrize("name,prop,knobs", [
    ("brdf_test_scene", "roughness", {"brdf": "ggx"}),
    ("brdf_test_scene", "roughness", {"brdf": "ggx", "shade_f80": False}),
    ("brdf_test_scene", "roughness", {"brdf": "principled"}),
    ("brdf_test_scene", "roughness", {"brdf": "principled",
                                      "shade_f80": False}),
    ("brdf_test_scene", "roughness_glass", {"brdf": "principled"}),
    ("brdf_test_scene", "roughness_glass", {"brdf": "principled",
                                            "shade_f80": False}),
    ("default_scene", None, {"brdf": "ggx"}),
    ("default_scene", None, {"brdf": "principled"}),
])
def test_bounce_step_shading_matches_jax(name, prop, knobs):
    """render/renderer.py::bounce_step under 'ggx' and 'principled' (the
    material gather's 14 or 17 columns, NEE through _closure_eval /
    _closure_pdf, the principled draws lobe, u, v, fresnel, rr,
    transmitted rays leaving from below the surface, delta lobes flagged
    in prev_delta), three bounces of the 64x64 wavefront at the bar of
    check_bounce_steps. On the roughness lineup the roughness-0 sphere's
    mirror lobe sets prev_delta on some lanes under 'principled'."""
    jscene = getattr(jbuilders, name)(64, 64, **({"prop": prop} if prop
                                                   else {}))
    jpol, tpol = policies(**knobs)
    _, deltas = check_bounce_steps(jscene, jpol, tpol)
    if prop == "roughness":
        # the roughness-0 sphere's mirror lobe
        assert (sum(deltas) > 0) == (knobs["brdf"] == "principled"), deltas


@pytest.mark.parametrize("name,knobs", [
    ("brdf_test_scene", {"brdf": "ggx"}),
    ("default_scene", {"brdf": "ggx"}),
    ("default_scene", {"brdf": "principled"}),
    ("brdf_test_scene", {"brdf": "principled"}),
])
def test_render_exact_with_exact_math(name, knobs, jax_exact_math):
    """A whole render through the JAX renderer's own jit (accumulate_n and
    its bounce loop) against Renderer(device="cpu"): 32x32, 2 passes, 6
    bounces, one chunk; then three bounce steps of the 64x64 wavefront
    (on brdf_test_scene, the 'roughness' and 'roughness_glass' lineups).
    Against the JAX renderer with correctly rounded rsqrt, sin and cos
    every bucket and every lane of every bounce is bit-identical: the
    renderer's NEE fuses the Fresnel lerp's f0 product and Smith's n_dot_l
    product; its GGX sample dots h.v in the plain order; and XLA computes
    each lane of the principled sample's world direction in its own
    fusion, where the x lane's dots the specular h.v with h.y*v.y fused
    first and the y and z lanes' in the plain order, while the refraction's
    x lane dots with h.y*v.y fused first in every fusion."""
    from cpu_raytracing_experiments_tpu.render.api import Renderer as JRenderer

    n = 32
    jpol, tpol = policies(rays_per_chunk=n * n, **knobs)
    jr_ = JRenderer(getattr(jbuilders, name)(n, n), jpol, n, n)
    jr_.accumulate(2)
    r = Renderer(getattr(tbuilders, name)(n, n), tpol, n, n, device="cpu")
    r.accumulate(2)
    want = np.asarray(jr_.state.buckets)
    assert np.array_equal(r.state.buckets.numpy().view(np.int32),
                          want.view(np.int32))
    jpol, tpol = policies(**knobs)
    props = ([{"prop": "roughness"}, {"prop": "roughness_glass"}]
             if name == "brdf_test_scene" else [{}])
    for prop in props:
        differing, _ = check_bounce_steps(
            getattr(jbuilders, name)(64, 64, **prop), jpol, tpol)
        assert differing == [0, 0, 0], prop


def test_golden_brdf_ggx():
    """The GGX closure over the brdf_test roughness lineup, 64x64, 10 spp,
    max_bounces=6, 4096-ray chunks, through Renderer(device="cpu"), at
    tests/test_goldens.py::_check's bar against brdf_ggx_64x64_10spp.npy."""
    _, pol = policies(brdf="ggx")
    r = Renderer(tbuilders.brdf_test_scene(SIZE, SIZE), pol, SIZE, SIZE,
                 device="cpu")
    r.accumulate(SPP)
    _check("brdf_ggx", r.render(tonemap=False))
