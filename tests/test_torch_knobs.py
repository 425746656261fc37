"""The knobs the port renders, held to the JAX package's jitted renderer on
the CPU: ``bounce_step`` and ``trace_rays`` under ``mis=False``,
``russian_roulette=False``, ``sky_bug_compat`` (on a coloured sky),
``max_bounces`` 1 and 3 and ``narrow_wavefront=True``; ``render_pass``
under ``clamp_radiance`` and ``samples_per_pixel`` 2 and 4, with
``k_passes`` wide launches; ``estimator.resolve`` with the mean of the
buckets and with 3 and 7 buckets; resume equivalence at spp = 2.

Tolerances:
* ``bounce_step``, three bounces of a 64x64 wavefront each fed the same JAX
  state: alive, ray_count and the closest-hit ids equal; radiance,
  throughput, p and d within rtol 1e-4 / atol 1e-6 on at least 99.9% of
  lanes (the bar of ``test_torch_render.py``: XLA's CPU rsqrt, sin and cos
  are not correctly rounded, the port's are);
* ``trace_rays`` from the JAX package's camera rays: radiance within rtol
  1e-4 / atol 1e-5 on 99.9% of lanes, ray counts within 0.1%;
* ``render_pass`` against the JAX renderer whose rsqrt, sin and cos round
  correctly (``jax_exact_math``): equal bits;
* ``resolve``: equal bits.
"""
import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from cpu_raytracing_experiments_tpu.core import sampling as jsampling
from cpu_raytracing_experiments_tpu.core import vec as jvec
from cpu_raytracing_experiments_tpu.core.vec import Vec3 as JVec3
from cpu_raytracing_experiments_tpu.ops import intersect as jint
from cpu_raytracing_experiments_tpu.render import estimator as jest
from cpu_raytracing_experiments_tpu.render import renderer as jr
from cpu_raytracing_experiments_tpu.scene import builders as jbuilders
from cpu_raytracing_experiments_tpu.scene.scene import Sky as JSky
from cpu_raytracing_experiments_tpu.utils.config import RendererPolicy as JPolicy
from cpu_raytracing_experiments_tpu_torch import Renderer
from cpu_raytracing_experiments_tpu_torch.core.vec import Vec3 as TVec3
from cpu_raytracing_experiments_tpu_torch.ops import intersect as tint
from cpu_raytracing_experiments_tpu_torch.render import estimator
from cpu_raytracing_experiments_tpu_torch.render import renderer as tr
from cpu_raytracing_experiments_tpu_torch.scene import builders as tbuilders
from cpu_raytracing_experiments_tpu_torch.scene.scene import Scene
from cpu_raytracing_experiments_tpu_torch.utils.config import RendererPolicy

from test_torch_render import _exact_rsqrt, _jax_state_to_torch, _stack
from test_torch_scene import jax_scene_to_numpy

torch.set_num_threads(1)

ACC = 3  # accumulation index of the compared wavefronts
FIELDS = ("radiance", "throughput", "p", "d")


def _exact(fn):
    """A correctly rounded float32 `fn` for the JAX package: float64 on the
    host, rounded once, as the port's core/fp.py computes it."""
    def f(x):
        return jax.pure_callback(
            lambda a: fn(np.asarray(a, np.float64)).astype(np.float32),
            jax.ShapeDtypeStruct(x.shape, jnp.float32), x,
            vmap_method="expand_dims")
    return f


@pytest.fixture
def jax_exact_math(monkeypatch):
    """The JAX package with XLA's CPU rsqrt, sin and cos (not correctly
    rounded) replaced by correctly rounded ones for one test: rsqrt in
    ``Vec3.normalize``, sin and cos in ``sampling.spherical_to_cartesian``
    and ``sampling.polar_to_cartesian`` (the disk of the thin lens and of
    VNDF sampling), the only places the renderer takes them. The jit caches
    are cleared on both sides."""
    jax.clear_caches()
    sin, cos = _exact(np.sin), _exact(np.cos)

    def spherical_to_cartesian(phi_over_2pi, sin_theta, cos_theta):
        phi = phi_over_2pi * jsampling.TWO_PI
        return JVec3(sin_theta * cos(phi), sin_theta * sin(phi), cos_theta)

    def polar_to_cartesian(phi_over_2pi, rho):
        phi = phi_over_2pi * jsampling.TWO_PI
        return rho * cos(phi), rho * sin(phi)

    monkeypatch.setattr(jvec, "jax_rsqrt", _exact_rsqrt)
    monkeypatch.setattr(jsampling, "spherical_to_cartesian",
                        spherical_to_cartesian)
    monkeypatch.setattr(jsampling, "polar_to_cartesian", polar_to_cartesian)
    yield
    monkeypatch.undo()
    jax.clear_caches()


def policies(**knobs):
    """The same policy in both packages, 64x64 in one chunk."""
    base = dict(max_bounces=6, rays_per_chunk=4096)
    base.update(knobs)
    return JPolicy(**base), RendererPolicy(**base)


def scenes(jscene):
    return jscene, Scene.from_numpy(jax_scene_to_numpy(jscene), device="cpu")


def coloured_sky_hero(w=64, h=64):
    """The hero scene under a constant (0.5, 0.6, 0.8) sky."""
    return dataclasses.replace(jbuilders.default_scene(w, h),
                               sky=JSky.constant((0.5, 0.6, 0.8)))


def camera_state(jscene, jpol, w=64, h=64, acc=ACC):
    """The JAX package's bounce-0 wavefront: its jitted camera rays."""
    i = np.arange(w * h)
    p0, d0 = jax.jit(lambda s: jr.generate_camera_rays(
        s.camera, jnp.asarray(i % w, jnp.int32),
        jnp.asarray(i // w, jnp.int32), jnp.uint32(acc),
        jr.pixel_seeds(w, h, jpol), jpol.enable_dof, jpol))(jscene)
    one, zero = jnp.ones(w * h), jnp.zeros(w * h)
    return jr.PathState(
        bounce=jnp.int32(0), p=p0, d=d0, throughput=JVec3(one, one, one),
        radiance=JVec3(zero, zero, zero), prev_pdf=zero,
        prev_delta=zero > 1.0, alive=zero < 1.0, ray_count=jnp.uint32(0))


def check_bounce_steps(jscene, jpol, tpol, bounces=3, w=64, h=64,
                       fields=FIELDS, share=0.999):
    """`bounces` bounce steps, each fed the same JAX state: alive,
    ray_count, prev_delta and the closest-hit ids equal, `fields` within
    rtol 1e-4 / atol 1e-6 on `share` of the lanes. Returns, a bounce, the
    number of lanes whose floats differ in any bit and the number that
    sampled a delta lobe."""
    jscene, tscene = scenes(jscene)
    jseeds = jr.pixel_seeds(w, h, jpol)
    tseeds = tr.pixel_seeds(w, h, tpol)
    np.testing.assert_array_equal(np.asarray(jseeds).astype(np.int64),
                                  tseeds.numpy())
    state = camera_state(jscene, jpol, w, h)
    step = jax.jit(lambda s, st: jr.bounce_step(s, jpol, jnp.uint32(ACC),
                                                jseeds, st))
    hit_ids = jax.jit(lambda s, p, d: jint.intersect_scene(s, p, d)[1])
    differing, deltas = [], []
    for bounce in range(bounces):
        tstate = _jax_state_to_torch(state)
        np.testing.assert_array_equal(
            tint.intersect_scene(tscene, tstate.p, tstate.d)[1].numpy(),
            np.asarray(hit_ids(jscene, state.p, state.d)))
        want = step(jscene, state)
        got = tr.bounce_step(tscene, tpol, ACC, tseeds, tstate)
        assert got.bounce == int(want.bounce) == bounce + 1
        np.testing.assert_array_equal(got.alive.numpy(),
                                      np.asarray(want.alive))
        np.testing.assert_array_equal(got.prev_delta.numpy(),
                                      np.asarray(want.prev_delta))
        assert int(got.ray_count) == int(want.ray_count)
        bits = np.zeros(w * h, bool)
        for field in fields:
            g, wv = _stack(getattr(got, field)), _stack(getattr(want, field))
            close = np.isclose(g, wv, rtol=1e-4, atol=1e-6).all(axis=1)
            assert close.mean() >= share, (bounce, field, close.mean())
            bits |= (g.view(np.int32) != wv.view(np.int32)).any(axis=1)
        differing.append(int(bits.sum()))
        deltas.append(int(got.prev_delta.sum()))
        state = want
    return differing, deltas


KNOBS = [
    pytest.param("default_scene", {"mis": False}, id="mis_off"),
    pytest.param("default_scene", {"russian_roulette": False}, id="rr_off"),
    pytest.param("coloured_sky_hero", {"sky_bug_compat": True},
                 id="sky_bug_compat"),
    pytest.param("coloured_sky_hero", {}, id="coloured_sky"),
    pytest.param("default_scene", {"max_bounces": 1}, id="max_bounces_1"),
    pytest.param("default_scene", {"max_bounces": 3}, id="max_bounces_3"),
]


def _jax_scene(name, w=64, h=64):
    if name == "coloured_sky_hero":
        return coloured_sky_hero(w, h)
    return getattr(jbuilders, name)(w, h)


@pytest.mark.parametrize("name,knobs", KNOBS)
def test_bounce_step_knob_matches_jax(name, knobs):
    """render/renderer.py::bounce_step under one knob, three bounces (or
    max_bounces) of the 64x64 wavefront, against jitted JAX at the bar of
    the module docstring."""
    jpol, tpol = policies(**knobs)
    check_bounce_steps(_jax_scene(name), jpol, tpol,
                       bounces=min(3, jpol.max_bounces))


@pytest.mark.parametrize("name,knobs", KNOBS + [
    pytest.param("bvh_test_scene", {"narrow_wavefront": True},
                 id="narrow_wavefront"),
    pytest.param("brdf_test_scene", {"brdf": "ggx"}, id="ggx"),
    pytest.param("default_scene", {"brdf": "principled"}, id="principled"),
    pytest.param("default_scene", {"rng_scramble": True}, id="rng_scramble"),
])
def test_trace_rays_knob_matches_jax(name, knobs):
    """render/renderer.py::trace_rays under one knob, every bounce of two
    64x64 passes from the JAX package's camera rays: radiance within rtol
    1e-4 / atol 1e-5 on 99.9% of lanes, ray counts within 0.1%. With
    ``narrow_wavefront=True`` both packages compact the live lanes of
    bvh_test's 4096-lane chunk into narrower wavefronts; 'ggx' (the
    brdf_test lineup), 'principled' (the hero) and ``rng_scramble`` run
    the whole bounce loop of the shading knobs."""
    w = h = 64
    jpol, tpol = policies(**knobs)
    jscene, tscene = scenes(_jax_scene(name))
    assert tr.narrowing_on(tpol, tscene) == bool(
        knobs.get("narrow_wavefront", False))
    i = np.arange(w * h)
    jseeds = jr.pixel_seeds(w, h, jpol)
    tseeds = tr.pixel_seeds(w, h, tpol)
    camera = jax.jit(lambda s, a: jr.generate_camera_rays(
        s.camera, jnp.asarray(i % w, jnp.int32),
        jnp.asarray(i // w, jnp.int32), a, jseeds, False, jpol))
    trace = jax.jit(lambda s, a, p, d: jr.trace_rays(s, jpol, a, jseeds, p, d))
    to_t = lambda v: TVec3(*(torch.from_numpy(np.array(c)) for c in v))
    for acc in (1, 2):
        p0, d0 = camera(jscene, jnp.uint32(acc))
        want, want_count = trace(jscene, jnp.uint32(acc), p0, d0)
        got, got_count = tr.trace_rays(tscene, tpol, acc, tseeds, to_t(p0),
                                       to_t(d0))
        close = np.isclose(_stack(got), _stack(want), rtol=1e-4,
                           atol=1e-5).all(axis=1)
        assert close.mean() >= 0.999, (acc, close.mean())
        assert abs(int(got_count) - int(want_count)) <= 1e-3 * int(want_count)


def _render_pass(jscene, jpol, tpol, w, h, acc, k_passes=1):
    """(JAX radiance, port radiance) of one render_pass as [3, ...] numpy
    arrays, and both ray counts."""
    want, wcount = jax.jit(lambda s: jr.render_pass(
        s, jpol, jnp.uint32(acc), w, h, k_passes=k_passes))(jscene)
    tscene = Scene.from_numpy(jax_scene_to_numpy(jscene), device="cpu")
    got, gcount = tr.render_pass(tscene, tpol, acc, w, h, k_passes=k_passes)
    return (np.stack([np.asarray(c) for c in want]),
            np.stack([c.numpy() for c in got]), int(wcount), int(gcount))


@pytest.mark.parametrize("knobs", [
    pytest.param({"clamp_radiance": True, "max_radiance": 0.25},
                 id="clamp_radiance"),
    pytest.param({"samples_per_pixel": 2}, id="spp2"),
    pytest.param({"samples_per_pixel": 4}, id="spp4"),
    pytest.param({"samples_per_pixel": 2, "ray_order": "tile"},
                 id="spp2_tile_order"),
])
def test_render_pass_matches_exact_jax(knobs, jax_exact_math):
    """render/renderer.py::render_pass on the hero at 32x32, 4 bounces,
    against the JAX renderer whose rsqrt, sin and cos round correctly: the
    radiance (clamped after the bounce loop, then summed over a pixel's spp
    samples in lane order) and the ray count bit for bit; and two passes in
    one wide launch (k_passes = 2, lane acc = acc + ray // (npix * spp))
    equal to the two single passes."""
    w = h = 32
    jpol, tpol = policies(max_bounces=4, rays_per_chunk=2048, **knobs)
    jscene = jbuilders.default_scene(w, h)
    want, got, wcount, gcount = _render_pass(jscene, jpol, tpol, w, h, 5)
    assert np.array_equal(got.view(np.int32), want.view(np.int32))
    assert gcount == wcount
    if knobs.get("clamp_radiance"):
        assert got.max() == np.float32(0.25)
    want2, got2, wcount2, gcount2 = _render_pass(jscene, jpol, tpol, w, h, 5,
                                                 k_passes=2)
    assert np.array_equal(got2.view(np.int32), want2.view(np.int32))
    assert np.array_equal(got2[:, 0], got)
    assert gcount2 == wcount2


def test_resume_equivalence_spp2():
    """At samples_per_pixel = 2, accumulate(10) equals accumulate(4) then
    accumulate(6) bit for bit (32x32, 4096-ray chunks: 2 passes a launch),
    and the resolve divides the buckets by spp."""
    pol = RendererPolicy(max_bounces=4, rays_per_chunk=4096,
                         samples_per_pixel=2)
    assert estimator.launch_width(pol, 32, 32) == 2

    def run(*splits):
        r = Renderer(tbuilders.default_scene(32, 32), pol, 32, 32,
                     device="cpu")
        for n in splits:
            r.accumulate(n)
        return r

    whole, part = run(10), run(4, 6)
    assert torch.equal(part.state.buckets, whole.state.buckets)
    assert int(part.state.rays_traced) == int(whole.state.rays_traced) > 0
    one = dataclasses.replace(pol, samples_per_pixel=1)
    img = whole.render(tonemap=False)
    half = estimator.resolve(whole.state, one, 1.0, 32, 32, tonemap=False)
    np.testing.assert_array_equal(img, half.numpy()[::-1] / np.float32(2))


@pytest.mark.parametrize("buckets,median", [(5, False), (3, True),
                                            (7, True), (3, False),
                                            (7, False)])
def test_resolve_matches_jax(buckets, median):
    """render/estimator.py::resolve against the JAX package's on the same
    random buckets (20 accumulations, spp 1 and 3): the median of 3 or 7
    bucket means, or their average (Renderer.hpp:457-459), then ACES,
    bit for bit."""
    g = np.random.default_rng(buckets)
    w, h = 12, 8
    b = g.gamma(0.7, 2.0, (buckets, 3, w * h)).astype(np.float32)
    for spp in (1, 3):
        jpol, tpol = policies(accumulation_buckets=buckets, median=median,
                              samples_per_pixel=spp)
        js = jest.RenderState.create(w, h, jpol)
        js = js._replace(buckets=jnp.asarray(b),
                         accumulations=jnp.uint32(20)) \
            if hasattr(js, "_replace") else dataclasses.replace(
                js, buckets=jnp.asarray(b), accumulations=jnp.uint32(20))
        ts = estimator.RenderState(torch.from_numpy(b.copy()), 20,
                                   torch.zeros((), dtype=torch.int64))
        for tonemap in (False, True):
            want = np.asarray(jax.jit(lambda s: jest.resolve(
                s, jpol, 1.5, w, h, tonemap))(js))
            got = estimator.resolve(ts, tpol, 1.5, w, h, tonemap).numpy()
            assert np.array_equal(got.view(np.int32), want.view(np.int32)), \
                (spp, tonemap)
