"""Adaptive sampling in the PyTorch port against the JAX package, on the CPU:
``render/estimator.py`` (``stderr_arrays``, ``accumulate_pixels``, the
count-aware ``resolve``), ``render/renderer.py::render_pass_pixels`` and
``render/api.py`` (``render_adaptive``, ``variance_map``,
``render_to_tolerance``).

The JAX reference is jitted, and where a render is compared it is the
renderer whose rsqrt, sin and cos round correctly
(``test_torch_knobs.py::jax_exact_math``): then buckets, counts and stats
are equal bit for bit. The adaptive rounds rank pixels by their standard
error, so ``stderr_arrays`` is held bit for bit on its own as well.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from cpu_raytracing_experiments_tpu.render import estimator as jest
from cpu_raytracing_experiments_tpu.render.api import Renderer as JRenderer
from cpu_raytracing_experiments_tpu.scene import builders as jbuilders
from cpu_raytracing_experiments_tpu.utils.config import RendererPolicy as JPolicy
from cpu_raytracing_experiments_tpu_torch import Renderer
from cpu_raytracing_experiments_tpu_torch.render import api
from cpu_raytracing_experiments_tpu_torch.render import estimator
from cpu_raytracing_experiments_tpu_torch.scene.scene import Scene
from cpu_raytracing_experiments_tpu_torch.utils.config import RendererPolicy

from test_torch_knobs import jax_exact_math  # noqa: F401
from test_torch_scene import jax_scene_to_numpy

torch.set_num_threads(1)


def _bits(a):
    return np.asarray(a).view(np.int32)


def policies(**knobs):
    base = dict(max_bounces=2, rays_per_chunk=2048)
    base.update(knobs)
    return JPolicy(**base), RendererPolicy(**base)


def renderers(jscene, w, h, **knobs):
    """A JAX Renderer and a port Renderer (CPU) on the same scene."""
    jpol, tpol = policies(**knobs)
    return (JRenderer(jscene, jpol, w, h),
            Renderer(Scene.from_numpy(jax_scene_to_numpy(jscene)), tpol, w,
                     h, device="cpu"))


def _random_buckets(seed, b, n):
    g = np.random.default_rng(seed)
    buckets = (g.gamma(0.5, 1.0, (b, 3, n))
               * g.integers(1, 5, (1, 1, n))).astype(np.float32)
    buckets[:, :, :50] = 0.0  # the black sky: se = 0, ties in the ranking
    counts = (g.integers(2, 12, n) * b).astype(np.float32)
    return buckets, counts


@pytest.mark.parametrize("b", [3, 5, 7])
@pytest.mark.parametrize("with_counts", [False, True])
def test_stderr_arrays_matches_jax(b, with_counts):
    """render/estimator.py::stderr_arrays against jitted JAX
    ``estimator.stderr_arrays`` on 20,000 random pixels, uniform (29
    accumulations) and with per-pixel counts, for 3, 5 and 7 buckets: bit
    for bit (XLA's reciprocal products and fma chains, written out in the
    port)."""
    buckets, counts = _random_buckets(b, b, 20000)
    cnt = counts if with_counts else None
    want = jax.jit(jest.stderr_arrays)(
        jnp.asarray(buckets), jnp.uint32(29),
        None if cnt is None else jnp.asarray(cnt))
    got = estimator.stderr_arrays(
        torch.from_numpy(buckets), 29,
        None if cnt is None else torch.from_numpy(cnt))
    assert np.array_equal(_bits(got.numpy()), _bits(want))
    state = estimator.RenderState(torch.from_numpy(buckets), 29,
                                  torch.zeros((), dtype=torch.int64),
                                  counts=None if cnt is None
                                  else torch.from_numpy(cnt))
    assert torch.equal(estimator.pixel_stderr(state), got)


@pytest.mark.parametrize("b,tonemap", [(5, False), (5, True), (3, True)])
def test_count_aware_resolve_matches_jax(b, tonemap):
    """render/estimator.py::resolve with per-pixel counts against jitted JAX
    ``estimator.resolve`` (the count-aware branch, estimator.py:269-281) on
    random buckets and counts, spp 1 and 2: bit for bit; and the hand case
    of tests/test_adaptive.py: pixels of 5 and 10 passes resolve to the same
    per-pass mean."""
    w, h = 40, 25
    buckets, counts = _random_buckets(11, b, w * h)
    for spp in (1, 2):
        jpol, tpol = policies(accumulation_buckets=b, samples_per_pixel=spp)
        js = jest.RenderState(buckets=jnp.asarray(buckets),
                              accumulations=jnp.uint32(20),
                              counts=jnp.asarray(counts))
        want = jax.jit(lambda s: jest.resolve(s, jpol, 1.5, w, h,
                                              tonemap))(js)
        ts = estimator.RenderState(torch.from_numpy(buckets.copy()), 20,
                                   torch.zeros((), dtype=torch.int64),
                                   counts=torch.from_numpy(counts))
        got = estimator.resolve(ts, tpol, 1.5, w, h, tonemap)
        assert np.array_equal(_bits(got.numpy()), _bits(want)), spp
    hand = np.zeros((5, 3, 4), np.float32)
    hand[:, :, 0] = 1.0
    hand[:, :, 1] = 2.0
    ts = estimator.RenderState(torch.from_numpy(hand), 10,
                               torch.zeros((), dtype=torch.int64),
                               counts=torch.tensor([5.0, 10.0, 5.0, 5.0]))
    img = estimator.resolve(ts, RendererPolicy(max_bounces=2), 1.0, 2, 2,
                            tonemap=False).numpy().reshape(4, 3)
    np.testing.assert_array_equal(img[:2], 1.0)


def test_accumulate_pixels_matches_jax(jax_exact_math):
    """render/estimator.py::accumulate_pixels (through
    renderer.py::render_pass_pixels) against jitted JAX
    ``estimator.accumulate_pixels``, after tests/test_adaptive.py:44-57:
    pixel 5 alone in a list padded with id 0, then a second subset pass of
    40 pixels (repeated padding ids among them) onto a state with counts and
    three uniform passes: buckets and counts bit for bit, only the listed
    pixels touched, and the padding adds nothing."""
    w = h = 16
    jscene = jbuilders.default_scene(w, h)
    jr_, tr_ = renderers(jscene, w, h, max_bounces=3)
    jpol, tpol = jr_.policy, tr_.policy
    step = jax.jit(lambda s, st, ids, ok: jest.accumulate_pixels(
        s, jpol, st, w, h, ids, ok))
    ids = np.asarray([5, 0, 0, 0, 0, 0, 0, 0], np.int32)
    valid = np.asarray([True] + [False] * 7)
    js = step(jr_.scene, jr_.state, jnp.asarray(ids), jnp.asarray(valid))
    ts = estimator.accumulate_pixels(tr_.scene, tpol, tr_.state, w, h,
                                     torch.from_numpy(ids),
                                     torch.from_numpy(valid))
    touched = np.nonzero(np.abs(ts.buckets.numpy()).sum(axis=(0, 1)))[0]
    assert set(touched.tolist()) <= {5}
    assert ts.counts[5] == 1.0 and ts.counts[0] == 0.0
    assert ts.accumulations == 1
    assert np.array_equal(_bits(ts.buckets.numpy()), _bits(js.buckets))
    assert np.array_equal(ts.counts.numpy(), np.asarray(js.counts))
    # three uniform passes keep the counts, then a subset of 40
    js = jax.jit(lambda s, st: jest.accumulate_n(s, jpol, st, w, h, 3))(
        jr_.scene, js)
    ts = estimator.accumulate_n(tr_.scene, tpol, ts, w, h, 3)
    assert np.array_equal(ts.counts.numpy(), np.asarray(js.counts))
    g = np.random.default_rng(3)
    ids = g.permutation(w * h)[:40].astype(np.int32)
    valid = g.random(40) < 0.8
    ids[~valid] = 7  # repeated padding ids
    js = step(jr_.scene, js, jnp.asarray(ids), jnp.asarray(valid))
    before = ts.buckets.clone()
    ts = estimator.accumulate_pixels(tr_.scene, tpol, ts, w, h,
                                     torch.from_numpy(ids),
                                     torch.from_numpy(valid))
    assert np.array_equal(_bits(ts.buckets.numpy()), _bits(js.buckets))
    assert np.array_equal(ts.counts.numpy(), np.asarray(js.counts))
    assert ts.accumulations == int(js.accumulations) == 5
    untouched = np.ones(w * h, bool)
    untouched[ids[valid]] = False
    assert torch.equal(ts.buckets[..., untouched], before[..., untouched])


def _tiers_run(monkeypatch):
    """Record (tier, rounds) of every api._adaptive_tier call."""
    run = []
    tier = api._adaptive_tier

    def recorded(*args):
        out = tier(*args)
        run.append((args[6], out[3]))
        return out

    monkeypatch.setattr(api, "_adaptive_tier", recorded)
    return run


def _check_same(jr_, tr_, jimg, timg, jstats, tstats):
    assert tstats == jstats
    assert np.array_equal(_bits(tr_.state.buckets.numpy()),
                          _bits(jr_.state.buckets))
    assert np.array_equal(tr_.state.counts.numpy(),
                          np.asarray(jr_.state.counts))
    assert tr_.state.accumulations == int(jr_.state.accumulations)
    assert np.array_equal(_bits(timg), _bits(jimg))


@pytest.mark.parametrize("w,kw,tiers", [
    (32, dict(tol=0.03, max_spp=60, warmup=5), [1024, 512, 256]),
    (16, dict(tol=0.05, max_spp=30, warmup=10), [256]),
])
def test_render_adaptive_matches_jax(w, kw, tiers, jax_exact_math,
                                     monkeypatch):
    """render/api.py::Renderer.render_adaptive against the JAX package's
    (``_count_active_jit`` / ``_adaptive_tier_jit``, api.py:197-316) on the
    hero, 2 bounces: at 32x32 with a tolerance that runs the tiers 1024,
    512 and 256, and at 16x16 (one tier). Buckets, counts, accumulations,
    the stats dict and the image bit for bit."""
    run = _tiers_run(monkeypatch)
    jr_, tr_ = renderers(jbuilders.default_scene(w, w), w, w)
    jimg, jstats = jr_.render_adaptive(**kw)
    timg, tstats = tr_.render_adaptive(**kw)
    assert [t for t, rounds in run if rounds] == tiers
    assert 0 < tstats["saved_fraction"] < 1
    _check_same(jr_, tr_, jimg, timg, jstats, tstats)


def test_adaptive_tol0_equals_uniform():
    """With tol = 0 every pixel of nonzero spread stays active and pixels of
    zero spread (the black sky) have gathered no light to spread: the
    count-aware resolve reproduces the uniform render of the same passes
    bit for bit (tests/test_adaptive.py's first test, at 16x16)."""
    pol = RendererPolicy(max_bounces=2, rays_per_chunk=2048)
    scene = jbuilders.default_scene(16, 16)
    tscene = Scene.from_numpy(jax_scene_to_numpy(scene))
    r = Renderer(tscene, pol, 16, 16, device="cpu")
    img, stats = r.render_adaptive(tol=0.0, max_spp=20, warmup=10)
    r2 = Renderer(tscene, pol, 16, 16, device="cpu")
    r2.accumulate(20)
    assert np.array_equal(_bits(img), _bits(r2.render()))
    assert stats["samples_traced"] <= stats["uniform_equivalent"]


def test_adaptive_spp2_matches_jax_fault(jax_exact_math):
    """At samples_per_pixel = 2 the JAX package's adaptive rounds trace one
    sample a pixel (``render_pass_pixels`` seeds sample 0 only) while its
    count-aware resolve divides by spp: its image is darker than the uniform
    render (ROADMAP queue 3). The port reproduces it bit for bit (buckets,
    counts, stats, image), and the fault shows: the linear mean is below 85%
    of the uniform render's (hero 16x16, tol = 0, max_spp 20, warmup 10)."""
    w = 16
    kw = dict(tol=0.0, max_spp=20, warmup=10)
    jr_, tr_ = renderers(jbuilders.default_scene(w, w), w, w,
                         samples_per_pixel=2)
    jimg, jstats = jr_.render_adaptive(tonemap=False, **kw)
    timg, tstats = tr_.render_adaptive(tonemap=False, **kw)
    _check_same(jr_, tr_, jimg, timg, jstats, tstats)
    uniform = Renderer(tr_.scene, tr_.policy, w, w, device="cpu")
    uniform.accumulate(20)
    assert timg.mean() < 0.85 * uniform.render(tonemap=False).mean()


def test_adaptive_restir_matches_jax(jax_exact_math):
    """render_adaptive under light_sampling='restir' on a 16-light field
    (16x16): the subset passes carry no reservoirs, so NEE takes the RIS
    selection in both packages (JAX renderer.py:580-593), the warmup's
    uniform passes the reservoirs; buckets, counts, stats and image bit for
    bit, and the reservoirs equal."""
    w = 16
    jscene = jbuilders.random_spheres_scene(w, w, num_spheres=60,
                                            emissive_fraction=0.3, seed=5)
    jr_, tr_ = renderers(jscene, w, w, light_sampling="restir")
    assert tr_.scene.num_lights > 1
    kw = dict(tol=0.05, max_spp=20, warmup=5)
    jimg, jstats = jr_.render_adaptive(**kw)
    timg, tstats = tr_.render_adaptive(**kw)
    _check_same(jr_, tr_, jimg, timg, jstats, tstats)
    assert np.array_equal(_bits(tr_.state.reservoir.numpy()),
                          _bits(jr_.state.reservoir))


def test_variance_map_and_render_to_tolerance_match_jax(jax_exact_math):
    """Renderer.variance_map (the port's copy of
    utils/metrics.py::pixel_variance_map, host numpy) and
    render_to_tolerance against the JAX package's on the hero, 16x16: the
    map after 10 passes, then the image and pass count at which the 90th
    percentile of the standard error falls below 0.15 (steps of 5 passes;
    30 passes), bit for bit."""
    w = 16
    jr_, tr_ = renderers(jbuilders.default_scene(w, w), w, w)
    jr_.accumulate(10)
    tr_.accumulate(10)
    vmap = tr_.variance_map()
    assert vmap.shape == (w, w) and vmap.dtype == np.float32
    assert np.array_equal(_bits(vmap), _bits(jr_.variance_map()))
    kw = dict(max_spp=40, check_every=5, quantile=0.9)
    jimg = jr_.render_to_tolerance(0.15, **kw)
    timg = tr_.render_to_tolerance(0.15, **kw)
    assert tr_.state.accumulations == int(jr_.state.accumulations)
    assert 10 < tr_.state.accumulations < 40
    assert np.array_equal(_bits(timg), _bits(jimg))


def test_adaptive_tiers():
    """The tier rule of JAX render_adaptive (api.py:278-283): npix halved
    while at least max(npix // 64, 256)."""
    assert api.adaptive_tiers(1024) == [1024, 512, 256]
    assert api.adaptive_tiers(256) == [256]
    assert api.adaptive_tiers(1920 * 1088) == [
        2088960, 1044480, 522240, 261120, 130560, 65280, 32640]
