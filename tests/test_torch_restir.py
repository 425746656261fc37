"""Renders of the port under every light selection mode against the JAX
package's jitted renderer, on the CPU: ``bounce_step``, ``trace_rays`` and
``render_pass`` under 'power', 'alias', 'ris' and 'restir' (its per-pixel
reservoirs through the pass, 1-D and 2-D neighbourhoods, raster and tile
order, spp 2), the ReSTIR reservoirs through ``Renderer`` (resume, reset,
the JAX package's reservoirs after 3 passes), and the hero under
``sky_models.clear_sky``.

The JAX reference is the renderer whose rsqrt, sin and cos round correctly
(``test_torch_knobs.py::jax_exact_math``; for the sky also atan2 and asin),
and the comparisons are bit for bit: radiance, ray counts and reservoirs.
The scene is ``benchmarks/convergence_restir_2d.py``'s: 1000 spheres, 326
of them lights (seed 77), cut to 32x32.
"""
import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from cpu_raytracing_experiments_tpu.render import api as japi
from cpu_raytracing_experiments_tpu.render import renderer as jr
from cpu_raytracing_experiments_tpu.scene import builders as jbuilders
from cpu_raytracing_experiments_tpu.scene import sky_models as jsky
from cpu_raytracing_experiments_tpu.scene.scene import Sky as JSky
from cpu_raytracing_experiments_tpu.utils.config import RendererPolicy as JPolicy
from cpu_raytracing_experiments_tpu_torch import Renderer
from cpu_raytracing_experiments_tpu_torch.core.vec import Vec3 as TVec3
from cpu_raytracing_experiments_tpu_torch.render import renderer as tr
from cpu_raytracing_experiments_tpu_torch.scene import builders as tbuilders
from cpu_raytracing_experiments_tpu_torch.scene import sky_models as tsky
from cpu_raytracing_experiments_tpu_torch.scene.scene import Scene, Sky
from cpu_raytracing_experiments_tpu_torch.utils.config import RendererPolicy

from test_torch_knobs import (_exact, camera_state, check_bounce_steps,
                              jax_exact_math)  # noqa: F401
from test_torch_scene import jax_scene_to_numpy

torch.set_num_threads(1)

W = H = 32


def field(w=W, h=H):
    """convergence_restir_2d.py's scene: 326 lights of 1000 spheres."""
    return jbuilders.random_spheres_scene(w, h, num_spheres=1000,
                                          emissive_fraction=0.3, seed=77)


def _bits(a):
    return np.asarray(a).view(np.int32)


def _stack(v):
    return np.stack([np.asarray(c) for c in v])


def _empty_reservoir(npix):
    return np.concatenate([np.full((1, npix), -1.0, np.float32),
                           np.zeros((2, npix), np.float32)])


@pytest.mark.parametrize("name,mode", [
    ("field", "power"), ("field", "alias"), ("field", "ris"),
    ("cornell_box_scene", "power"),
])
def test_bounce_step_light_modes_match_jax(name, mode, jax_exact_math):
    """bounce_step under each light mode, three bounces of the 32x32
    wavefront each fed the JAX state (the 326-light field; cornell's two
    triangle lights under 'power'): every lane's radiance, throughput, p
    and d bit for bit ('restir' needs reservoirs: render_pass below)."""
    jsc = field() if name == "field" else jbuilders.cornell_box_scene(W, H)
    assert name != "field" or int(jsc.lights.shape[0]) == 326
    knobs = dict(max_bounces=6, rays_per_chunk=W * H, light_sampling=mode)
    differing, _ = check_bounce_steps(jsc, JPolicy(**knobs),
                                      RendererPolicy(**knobs), w=W, h=H)
    assert differing == [0, 0, 0]


@pytest.mark.parametrize("mode", ["power", "ris", "restir"])
def test_trace_rays_light_modes_match_jax(mode, jax_exact_math):
    """trace_rays under each mode from the JAX package's camera rays, every
    bounce of the 32x32 chunk (narrowing on: the field has 1000 spheres):
    radiance and ray count bit for bit; under 'restir' with random incoming
    reservoirs and the 1-D neighbourhood, the reservoirs out too."""
    knobs = dict(max_bounces=4, rays_per_chunk=W * H, light_sampling=mode)
    jpol, tpol = JPolicy(**knobs), RendererPolicy(**knobs)
    jsc = field()
    tsc = Scene.from_numpy(jax_scene_to_numpy(jsc), device="cpu")
    state = camera_state(jsc, jpol, W, H, 2)
    seeds = jr.pixel_seeds(W, H, jpol)
    g = np.random.default_rng(3)
    n = W * H
    res = (g.integers(-1, 326, n).astype(np.int32),
           g.gamma(1.0, 0.01, n).astype(np.float32),
           g.integers(0, 9, n).astype(np.float32))
    res_j = tuple(jnp.asarray(a) for a in res) if mode == "restir" else None
    res_t = (tuple(torch.from_numpy(a.astype(np.int64) if a.dtype == np.int32
                                    else a) for a in res)
             if mode == "restir" else None)
    want = jax.jit(lambda s, p, d, r: jr.trace_rays(
        s, jpol, jnp.uint32(2), seeds, p, d, res_in=r))(jsc, state.p,
                                                        state.d, res_j)
    to_t = lambda v: TVec3(*(torch.from_numpy(np.array(c)) for c in v))
    got = tr.trace_rays(tsc, tpol, 2, tr.pixel_seeds(W, H, tpol),
                        to_t(state.p), to_t(state.d), res_in=res_t)
    assert np.array_equal(_bits(_stack(got[0])), _bits(_stack(want[0])))
    assert int(got[1]) == int(want[1])
    if mode == "restir":
        assert np.array_equal(got[2][0].numpy(), np.asarray(want[2][0]))
        for a, b in zip(got[2][1:], want[2][1:]):
            assert np.array_equal(_bits(a.numpy()), _bits(b))


PASSES = [
    pytest.param("power", {}, 1, id="power"),
    pytest.param("alias", {}, 1, id="alias"),
    pytest.param("ris", {}, 1, id="ris"),
    pytest.param("power", {"samples_per_pixel": 2, "ray_order": "tile"}, 1,
                 id="power_spp2_tile"),
    pytest.param("restir", {}, 2, id="restir"),
    pytest.param("restir", {"restir_spatial_2d": False}, 2, id="restir_1d"),
    pytest.param("restir", {"ray_order": "tile"}, 2, id="restir_tile"),
    pytest.param("restir", {"samples_per_pixel": 2}, 2, id="restir_spp2"),
]


@pytest.mark.parametrize("mode,knobs,passes", PASSES)
def test_render_pass_light_modes_match_exact_jax(mode, knobs, passes,
                                                 jax_exact_math):
    """render_pass under each mode on the 326-light field at 32x32, 3
    bounces, in chunks of 512 rays (a 2-D neighbour search stays inside its
    chunk): radiance, ray count and, under 'restir', the reservoirs out bit
    for bit, each pass fed the previous pass's reservoirs."""
    base = dict(max_bounces=3, rays_per_chunk=512, light_sampling=mode,
                **knobs)
    jpol, tpol = JPolicy(**base), RendererPolicy(**base)
    jsc = field()
    tsc = Scene.from_numpy(jax_scene_to_numpy(jsc), device="cpu")
    res_j = res_t = None
    if mode == "restir":
        res_j = jnp.asarray(_empty_reservoir(W * H))
        res_t = torch.from_numpy(_empty_reservoir(W * H))
    step = jax.jit(lambda s, a, r: jr.render_pass(s, jpol, a, W, H,
                                                  restir_in=r))
    for acc in range(1, passes + 1):
        want = step(jsc, jnp.uint32(acc), res_j)
        got = tr.render_pass(tsc, tpol, acc, W, H, restir_in=res_t)
        assert np.array_equal(_bits(_stack(got[0])), _bits(_stack(want[0])))
        assert int(got[1]) == int(want[1])
        if mode == "restir":
            assert np.array_equal(_bits(got[2].numpy()), _bits(want[2]))
            assert (got[2][0] >= 0).float().mean() > 0.2  # the hits
            res_j, res_t = want[2], got[2]


def _restir_renderer(w=16, h=16):
    pol = RendererPolicy(max_bounces=3, rays_per_chunk=256,
                         light_sampling="restir")
    return Renderer(tbuilders.random_spheres_scene(
        w, h, num_spheres=200, emissive_fraction=0.3, seed=77), pol, w, h,
        device="cpu")


def test_restir_resume_bit_exact():
    """Under 'restir' (one pass a launch), accumulate(10) equals accumulate
    (4) then (6) bit for bit: buckets, reservoirs and ray count; a reset
    empties the reservoirs with the buckets."""
    whole, part = _restir_renderer(), _restir_renderer()
    whole.accumulate(10)
    part.accumulate(4)
    part.accumulate(6)
    assert torch.equal(part.state.buckets, whole.state.buckets)
    assert torch.equal(part.state.reservoir, whole.state.reservoir)
    assert int(part.state.rays_traced) == int(whole.state.rays_traced) > 0
    assert (whole.state.reservoir[0] >= 0).any()
    whole.reset_accumulator()
    assert torch.equal(whole.state.reservoir,
                       torch.from_numpy(_empty_reservoir(16 * 16)))
    assert whole.state.accumulations == 0


def test_restir_reservoirs_match_jax(jax_exact_math):
    """Renderer under 'restir' against the JAX package's Renderer (its
    jitted accumulate), 24x24, 3 passes: buckets and reservoirs bit for
    bit; RenderState.create allocates the reservoirs only under 'restir'."""
    w = h = 24
    knobs = dict(max_bounces=3, rays_per_chunk=576, light_sampling="restir")
    jsc = field(w, h)
    jrend = japi.Renderer(jsc, JPolicy(**knobs), w, h)
    trend = Renderer(Scene.from_numpy(jax_scene_to_numpy(jsc)),
                     RendererPolicy(**knobs), w, h, device="cpu")
    jrend.accumulate(3)
    trend.accumulate(3)
    assert np.array_equal(_bits(trend.state.buckets.numpy()),
                          _bits(jrend.state.buckets))
    assert np.array_equal(_bits(trend.state.reservoir.numpy()),
                          _bits(jrend.state.reservoir))
    assert Renderer(tbuilders.default_scene(8, 8), RendererPolicy(), 8, 8,
                    device="cpu").state.reservoir is None


@pytest.fixture
def jax_exact_sky(monkeypatch, jax_exact_math):
    """jax_exact_math and, for the sky lookup, correctly rounded atan2 and
    asin (XLA's CPU forms are not; the port's are, core/fp.py)."""
    atan2 = jax.jit(lambda y, x: jax.pure_callback(
        lambda a, b: np.arctan2(np.asarray(a, np.float64),
                                np.asarray(b, np.float64)).astype(np.float32),
        jax.ShapeDtypeStruct(y.shape, jnp.float32), y, x,
        vmap_method="expand_dims"))
    monkeypatch.setattr(jnp, "arctan2", atan2)
    monkeypatch.setattr(jnp, "arcsin", _exact(np.arcsin))
    yield
    monkeypatch.undo()
    jax.clear_caches()


def test_hero_clear_sky_matches_jax(jax_exact_sky):
    """The hero under ``Sky.from_image(clear_sky(), ambient=(1, 1, 1))`` (the
    JAX CLI's ``--sky clear``) at 32x32, 4 bounces, two passes: radiance bit
    for bit; the port builds the same map and the sky lights most pixels."""
    img = jsky.clear_sky()
    jsc = dataclasses.replace(jbuilders.default_scene(W, H),
                              sky=JSky.from_image(img, ambient=(1.0, 1.0,
                                                                1.0)))
    tsc = dataclasses.replace(tbuilders.default_scene(W, H),
                              sky=Sky.from_image(tsky.clear_sky(),
                                                 ambient=(1.0, 1.0, 1.0)))
    knobs = dict(max_bounces=4, rays_per_chunk=W * H)
    jpol, tpol = JPolicy(**knobs), RendererPolicy(**knobs)
    step = jax.jit(lambda s, a: jr.render_pass(s, jpol, a, W, H))
    for acc in (1, 2):
        want = step(jsc, jnp.uint32(acc))
        got = tr.render_pass(tsc, tpol, acc, W, H)
        assert np.array_equal(_bits(_stack(got[0])), _bits(_stack(want[0])))
        assert (_stack(want[0]).sum(0) > 0).mean() > 0.5


def test_check_policy_accepts_every_light_mode():
    """check_policy lets every light_sampling through, under the BVH, grid
    and clustered backends too (ported; test_torch_accel.py renders
    them)."""
    for mode in ("uniform", "power", "alias", "ris", "restir"):
        tr.check_policy(RendererPolicy(light_sampling=mode))
    for knob in ({"accel": "grid"}, {"use_bvh": True},
                 {"accel": "clustered"}, {"primary_accel": "bvh"}):
        tr.check_policy(RendererPolicy(light_sampling="restir", **knob))
