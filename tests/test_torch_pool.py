"""The port's regeneration pool (``render/wavefront_pool.py``) and the
per-lane bounce of ``bounce_step``, against the port's masked pass and the
JAX package on the CPU.

Tolerances:
* the pool against the port's ``render_pass``: per-pixel radiance and the
  ray count equal bit for bit (the same bounce_step per lane, each pixel
  dumped once into a zero entry);
* the pool against JAX ``render_pass_pooled``: the bar of
  tests/test_wavefront_pool.py::_compare, ray counts equal and at most 2% of
  pixels outside rtol 1e-5 / atol 1e-6 (XLA's rsqrt, sin and cos are not
  correctly rounded; the port's are);
* ``bounce_step`` with a [P] bounce against jitted JAX ``bounce_step`` on the
  same state, JAX with correctly rounded rsqrt, sin and cos
  (``test_torch_knobs.py::jax_exact_math``): every field bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpu_raytracing_experiments_tpu.render import renderer as jr
from cpu_raytracing_experiments_tpu.render import wavefront_pool as jpool
from cpu_raytracing_experiments_tpu.scene import builders as jbuilders
from cpu_raytracing_experiments_tpu.utils.config import RendererPolicy as JPolicy
from cpu_raytracing_experiments_tpu_torch.render import renderer as tr
from cpu_raytracing_experiments_tpu_torch.render import wavefront_pool
from cpu_raytracing_experiments_tpu_torch.scene import builders
from cpu_raytracing_experiments_tpu_torch.scene.scene import Scene
from cpu_raytracing_experiments_tpu_torch.utils.config import RendererPolicy

from test_torch_knobs import camera_state, jax_exact_math  # noqa: F401
from test_torch_render import _jax_state_to_torch, _stack
from test_torch_scene import jax_scene_to_numpy

torch.set_num_threads(1)

W = H = 32
CASES = [
    pytest.param("default_scene", dict(max_bounces=6, rays_per_chunk=1024), 1,
                 id="pool1024"),
    pytest.param("default_scene", dict(max_bounces=6, rays_per_chunk=128), 3,
                 id="pool128_acc3"),
    pytest.param("default_scene", dict(max_bounces=4, rays_per_chunk=1000), 2,
                 id="pool1000_ragged"),
    pytest.param("white_furnace_scene", dict(max_bounces=8,
                                             rays_per_chunk=256), 1,
                 id="furnace"),
]


@pytest.mark.parametrize("name,knobs,acc", CASES)
def test_pool_matches_render_pass(name, knobs, acc):
    """render_pass_pooled (JAX ``render_pass_pooled``) against the port's
    masked ``render_pass`` on the same scene and accumulation: radiance and
    ray count bit for bit; pools of 1024 (the frame), 128 (eight pixels a
    lane, many refills), 1000 (a pool that does not divide the 1024 pixels)
    and the white furnace at 8 bounces."""
    scene = getattr(builders, name)(W, H)
    pol = RendererPolicy(**knobs)
    want, want_count = tr.render_pass(scene, pol, acc, W, H)
    got, count = wavefront_pool.render_pass_pooled(scene, pol, acc, W, H)
    assert int(count) == int(want_count)
    for g, w in zip(got, want):
        assert g.shape == (W * H,)
        assert torch.equal(g.view(torch.int32), w.view(torch.int32))


def test_pool_matches_jax_pool():
    """The port's pool against JAX ``render_pass_pooled`` at
    tests/test_wavefront_pool.py::_compare's bar: ray counts equal, at most
    2% of pixels outside rtol 1e-5 / atol 1e-6 (pool of 128, 6 bounces,
    accumulation 3)."""
    knobs = dict(max_bounces=6, rays_per_chunk=128)
    jscene = jbuilders.default_scene(W, H)
    tscene = Scene.from_numpy(jax_scene_to_numpy(jscene), device="cpu")
    jrad, jcount = jpool.render_pass_pooled(jscene, JPolicy(**knobs),
                                            jnp.uint32(3), W, H)
    trad, tcount = wavefront_pool.render_pass_pooled(
        tscene, RendererPolicy(**knobs), 3, W, H)
    assert int(tcount) == int(jcount)
    mism = np.zeros(W * H, bool)
    for t, j in zip(trad, jrad):
        mism |= ~np.isclose(t.numpy(), np.asarray(j), rtol=1e-5, atol=1e-6)
    assert mism.mean() <= 0.02, mism.mean()


@pytest.mark.parametrize("name,knobs", [
    pytest.param("default_scene", {}, id="hero"),
    pytest.param("random_spheres_scene", {"light_sampling": "ris"},
                 id="field_ris"),
])
def test_bounce_step_per_lane_matches_jax(name, knobs, jax_exact_math):
    """``bounce_step`` with a [P] int32 bounce whose lanes hold 0 ..
    max_bounces - 1 (JAX ``bounce_step`` with a vector ``state.bounce``):
    from the JAX package's state after two bounces of a 64x64 wavefront,
    every field of the next state equals jitted JAX's bit for bit: the
    per-lane RNG sites, the camera-ray emission weight (MIS, and RIS's
    NEE-only rule) and the per-lane bounce cap."""
    w = h = 64
    base = dict(max_bounces=4, rays_per_chunk=4096, **knobs)
    jpol, tpol = JPolicy(**base), RendererPolicy(**base)
    jscene = getattr(jbuilders, name)(w, h)
    tscene = Scene.from_numpy(jax_scene_to_numpy(jscene), device="cpu")
    seeds = jr.pixel_seeds(w, h, jpol)
    step = jax.jit(lambda s, st: jr.bounce_step(s, jpol, jnp.uint32(3),
                                                seeds, st))
    state = camera_state(jscene, jpol, w, h)
    for _ in range(2):
        state = step(jscene, state)
    lanes = jnp.arange(w * h, dtype=jnp.int32) % jpol.max_bounces
    state = state._replace(bounce=lanes, alive=state.alive | (lanes == 0))
    want = step(jscene, state)
    tstate = _jax_state_to_torch(state._replace(bounce=0))._replace(
        bounce=torch.from_numpy(np.array(lanes)))
    got = tr.bounce_step(tscene, tpol, 3, tr.pixel_seeds(w, h, tpol), tstate)
    assert got.bounce.dtype == torch.int32
    np.testing.assert_array_equal(got.bounce.numpy(), np.asarray(want.bounce))
    for field in ("alive", "prev_delta"):
        np.testing.assert_array_equal(getattr(got, field).numpy(),
                                      np.asarray(getattr(want, field)))
    assert int(got.ray_count) == int(want.ray_count)
    assert not got.alive.numpy()[np.asarray(lanes) == jpol.max_bounces - 1] \
        .any()
    for field in ("radiance", "throughput", "p", "d"):
        g, j = _stack(getattr(got, field)), _stack(getattr(want, field))
        assert np.array_equal(g.view(np.int32), j.view(np.int32)), field
    np.testing.assert_array_equal(got.prev_pdf.numpy().view(np.int32),
                                  np.asarray(want.prev_pdf).view(np.int32))


def test_pool_refuses_spp2():
    """The pooled path traces one sample a pixel (JAX asserts spp == 1)."""
    pol = RendererPolicy(max_bounces=2, samples_per_pixel=2)
    with pytest.raises(ValueError, match="samples_per_pixel=2"):
        wavefront_pool.render_pass_pooled(builders.default_scene(8, 8), pol,
                                          1, 8, 8)


@pytest.mark.cuda
def test_pool_matches_render_pass_on_card():
    """On the card: the pool equals the masked pass bit for bit (the hero at
    64x64, pool 1000), and equals the CPU's pool."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    pol = RendererPolicy(max_bounces=6, rays_per_chunk=1000)
    scene = builders.default_scene(64, 64)
    card = scene.to("cuda")
    want, want_count = tr.render_pass(card, pol, 2, 64, 64)
    got, count = wavefront_pool.render_pass_pooled(card, pol, 2, 64, 64)
    cpu, _ = wavefront_pool.render_pass_pooled(scene, pol, 2, 64, 64)
    assert int(count) == int(want_count)
    for g, w, c in zip(got, want, cpu):
        assert torch.equal(g.cpu().view(torch.int32), w.cpu().view(torch.int32))
        assert torch.equal(g.cpu().view(torch.int32), c.view(torch.int32))
