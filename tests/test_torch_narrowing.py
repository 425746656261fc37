"""The PyTorch port's wavefront narrowing, primary-bounce override, screen
tile ray order and ``accel='pallas'`` render path against the JAX package's
``render/renderer.py``, on the CPU.

Narrowing, the ray order and the choice of backend are schedules: within the
port they must leave every bucket bit-identical. Against the JAX package
(Pallas kernels in interpret mode) ``bounce_step`` must give the same alive
mask, ray count and hit ids, and a whole render must meet the bar of
``tests/test_goldens.py::_check``."""
import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from cpu_raytracing_experiments_tpu.core.vec import Vec3 as JVec3
from cpu_raytracing_experiments_tpu.ops import intersect as jint
from cpu_raytracing_experiments_tpu.render import renderer as jr
from cpu_raytracing_experiments_tpu.render.api import Renderer as JRenderer
from cpu_raytracing_experiments_tpu.scene import accel as jaccel
from cpu_raytracing_experiments_tpu.scene import builders as jbuilders
from cpu_raytracing_experiments_tpu.utils.config import RendererPolicy as JPolicy
from cpu_raytracing_experiments_tpu_torch import Renderer
from cpu_raytracing_experiments_tpu_torch.ops import intersect as tint
from cpu_raytracing_experiments_tpu_torch.render import renderer as tr
from cpu_raytracing_experiments_tpu_torch.scene import accel as taccel
from cpu_raytracing_experiments_tpu_torch.scene import builders as tbuilders
from cpu_raytracing_experiments_tpu_torch.scene.scene import Scene
from cpu_raytracing_experiments_tpu_torch.utils.config import RendererPolicy

from test_torch_scene import jax_scene_to_numpy
from test_torch_render import (_jax_state_to_torch, _stack,  # noqa: F401
                               jax_exact_rsqrt)

# The suite runs in several worker processes at once: one intra-op thread
# each, or the workers' thread pools fight over the cores.
torch.set_num_threads(1)

PALLAS = dict(accel="pallas", pallas_tile_rays=64)


def _field(w, h, n=300):
    """(JAX scene, the port's scene) of an n-sphere field with K = 32 SAH
    clusters attached, the port's made from the JAX arrays."""
    jscene = jaccel.with_pallas_clusters(
        jbuilders.random_spheres_scene(w, h, num_spheres=n), cluster_size=32)
    return jscene, Scene.from_numpy(jax_scene_to_numpy(jscene), device="cpu")


def _pass(policy, scene, w, h, acc=3, k_passes=1):
    rad, count = tr.render_pass(scene, policy, acc, w, h, k_passes=k_passes)
    return torch.stack(list(rad)), int(count)


@pytest.mark.parametrize("accel,k_passes", [
    ("brute", 1), ("brute", 2), ("pallas", 1)])
def test_narrowing_bit_identical(accel, k_passes):
    """trace_rays with the narrowing cascade on (two stages: 9216 lanes ->
    6144 -> 2048) equals narrowing off in every lane's radiance and in the
    ray count, with per-lane accumulation indices (k_passes = 2) too."""
    w = h = 96 if k_passes == 1 else 64
    scene = _field(w, h, 200)[1]
    base = dict(max_bounces=6, rays_per_chunk=w * h * k_passes,
                ray_order="raster")
    if accel == "pallas":
        base.update(PALLAS)
    off = _pass(RendererPolicy(narrow_wavefront=False, **base), scene, w, h,
                k_passes=k_passes)
    on_pol = RendererPolicy(narrow_wavefront=True, narrow_factors=(2, 8),
                            **base)
    assert len(tr._narrow_caps(on_pol, scene, w * h * k_passes)) == 2
    on = _pass(on_pol, scene, w, h, k_passes=k_passes)
    assert torch.equal(on[0], off[0])
    assert on[1] == off[1] > w * h


def test_narrow_caps_match_jax_rule():
    """The cascade's widths: num_rays / f rounded up to 2048 lanes, strictly
    decreasing; 'auto' engages at >= 64 spheres or under accel='pallas'."""
    small, big = tbuilders.default_scene(8, 8), tbuilders.bvh_test_scene(8, 8)
    pol = RendererPolicy()
    assert tr._narrow_caps(pol, small, 1 << 19) == []
    assert tr._narrow_caps(pol, big, 1 << 19) == [131072, 16384]
    assert tr._narrow_caps(pol, big, 4096) == [2048]
    assert tr._narrow_caps(pol, big, 2048) == []
    assert tr._narrow_caps(RendererPolicy(accel="pallas"), small,
                           9216) == [4096, 2048]
    assert tr._narrow_caps(RendererPolicy(narrow_wavefront=False), big,
                           1 << 19) == []


def test_ray_order_and_primary_accel_bit_identical():
    """ray_order='tile' (with the inverse permutation back to raster) and
    the primary_accel peel leave every value as the raster, single-backend
    pass has it; the tile order equals the JAX package's permutation."""
    w, h = 48, 32
    scene = _field(w, h)[1]
    base = dict(max_bounces=5, rays_per_chunk=1024)
    want = _pass(RendererPolicy(ray_order="raster", **base), scene, w, h)
    for kw in ({"ray_order": "tile"}, {"primary_accel": "pallas", **PALLAS,
                                       "accel": "brute"},
               {"ray_order": "tile", "pallas_tile_rays": 64}):
        got = _pass(RendererPolicy(**base, **kw), scene, w, h)
        assert torch.equal(got[0], want[0]) and got[1] == want[1], kw
    for tile in (8, 16):
        np.testing.assert_array_equal(
            tr._tile_pixel_order_np(w, w * h, tile),
            jr._tile_pixel_order_np(w, w * h, tile).astype(np.int64))
    assert tr._tile_pixel_order_np(w, w * h - 5, 16) is None


def test_bounce_step_pallas_matches_jax():
    """render/renderer.py::bounce_step under accel='pallas' on a 32x32
    wavefront over 300 spheres, three bounces each fed the same JAX state
    (its Pallas kernels in interpret mode): alive, ray_count and the hit ids
    exactly equal, the dead lanes of later bounces planned around in both;
    floats within rtol 1e-4 / atol 1e-6 on at least 99.9% of lanes (XLA's
    rsqrt and sin/cos are not correctly rounded)."""
    w = h = 32
    acc = 3
    jscene, tscene = _field(w, h)
    jpol = JPolicy(max_bounces=6, rays_per_chunk=1024, pallas_interpret=True,
                   **PALLAS)
    tpol = RendererPolicy(max_bounces=6, rays_per_chunk=1024, **PALLAS)
    i = np.arange(w * h)
    jseeds = jr.pixel_seeds(w, h, jpol)
    tseeds = tr.pixel_seeds(w, h, tpol)
    p0, d0 = jax.jit(lambda s: jr.generate_camera_rays(
        s.camera, jnp.asarray(i % w, jnp.int32), jnp.asarray(i // w, jnp.int32),
        jnp.uint32(acc), jseeds, False, jpol))(jscene)
    one, zero = jnp.ones(w * h), jnp.zeros(w * h)
    state = jr.PathState(
        bounce=jnp.int32(0), p=p0, d=d0, throughput=JVec3(one, one, one),
        radiance=JVec3(zero, zero, zero), prev_pdf=zero,
        prev_delta=zero > 1.0, alive=zero < 1.0, ray_count=jnp.uint32(0))
    step = jax.jit(lambda s, st: jr.bounce_step(s, jpol, jnp.uint32(acc),
                                                jseeds, st))
    hit_ids = jax.jit(lambda s, st: jint.intersect_scene(
        s, st.p, st.d, accel="pallas", alive=st.alive, policy=jpol)[1])
    for bounce in range(3):
        tstate = _jax_state_to_torch(state)
        got_ids = tint.intersect_scene(
            tscene, tstate.p, tstate.d, accel="pallas", alive=tstate.alive,
            policy=tpol)[1].numpy()
        np.testing.assert_array_equal(got_ids,
                                      np.asarray(hit_ids(jscene, state)))
        want = step(jscene, state)
        got = tr.bounce_step(tscene, tpol, acc, tseeds, tstate)
        np.testing.assert_array_equal(got.alive.numpy(), np.asarray(want.alive))
        assert int(got.ray_count) == int(want.ray_count)
        for field in ("radiance", "throughput", "p", "d"):
            close = np.isclose(_stack(getattr(got, field)),
                               _stack(getattr(want, field)),
                               rtol=1e-4, atol=1e-6).all(axis=1)
            assert close.mean() >= 0.999, (bounce, field, close.mean())
        state = want
    assert 0 < int(np.asarray(state.alive).sum()) < w * h


def test_render_pallas_tile_order_equals_brute_and_meets_jax(jax_exact_rsqrt):
    """The slice as a whole: a 32x32, 10-pass render of the 300-sphere field
    through Renderer with accel='pallas', ray_order='tile' and narrowing
    'auto' is bit-identical to accel='brute' in the port, and meets
    tests/test_goldens.py::_check's bar (> 99.5% of values within rtol 1e-3 /
    atol 1e-4, means within 1e-3) against the JAX package's render with
    pallas_interpret=True. The JAX witness rounds rsqrt correctly, as the
    port does (XLA's CPU rsqrt is one ulp off in half the camera directions,
    which sends a few percent of 10-pass pixels down other paths:
    test_torch_render.py::test_golden_bvh_test)."""
    w = h = 32
    jscene, tscene = _field(w, h)
    base = dict(max_bounces=4, rays_per_chunk=4096)
    tpol = RendererPolicy(ray_order="tile", **base, **PALLAS)
    assert tr._narrow_caps(tpol, tscene, 4096) == [2048]
    rp = Renderer(tscene, tpol, w, h, device="cpu")
    rp.accumulate(10)
    rb = Renderer(tscene, RendererPolicy(**base), w, h, device="cpu")
    rb.accumulate(10)
    assert torch.equal(rp.state.buckets, rb.state.buckets)
    assert int(rp.state.rays_traced) == int(rb.state.rays_traced)
    # the port's own build of the clusters renders the same buckets
    own = taccel.with_pallas_clusters(
        tbuilders.random_spheres_scene(w, h, num_spheres=300), cluster_size=32)
    ro = Renderer(own, tpol, w, h, device="cpu")
    ro.accumulate(10)
    assert torch.equal(ro.state.buckets, rp.state.buckets)

    jrend = JRenderer(jscene, JPolicy(ray_order="tile", pallas_interpret=True,
                                      **base, **PALLAS), w, h)
    jrend.accumulate(10)
    want = np.asarray(jrend.render(tonemap=False))
    img = rp.render(tonemap=False)
    assert np.isclose(img, want, rtol=1e-3, atol=1e-4).mean() > 0.995
    np.testing.assert_allclose(img.mean(), want.mean(), rtol=1e-3)


def test_cornell_pallas_stream_equals_brute():
    """Cornell (2 spheres, 12 triangles), 24x24, 2 passes, under
    accel='pallas' with pallas_stream=True and 32 prims a cluster leaves the
    buckets bit-identical to accel='brute' (after the JAX package's
    test_renderer_accel_pallas_stream_matches_brute): both kinds are below
    PALLAS_MIN_PRIMS and a pack below 128 prims a cluster switches the
    streamed walks off for itself, so the dense batteries run on both
    sides."""
    w = h = 24
    base = dict(max_bounces=4, rays_per_chunk=w * h)
    scene = tbuilders.cornell_box_scene(w, h)
    rb = Renderer(scene, RendererPolicy(**base), w, h, device="cpu")
    rb.accumulate(2)
    rp = Renderer(taccel.with_pallas_clusters(scene, cluster_size=32),
                  RendererPolicy(pallas_stream=True, **base, **PALLAS), w, h,
                  device="cpu")
    rp.accumulate(2)
    assert torch.equal(rp.state.buckets, rb.state.buckets)
    assert int(rp.state.rays_traced) == int(rb.state.rays_traced) > w * h


def test_mesh_render_stream_and_mxu():
    """mesh_scene(32, 32, subdivisions=3) (1280 triangles) at 128 prims a
    cluster, 10 passes, through Renderer with accel='pallas': the streamed
    walks (pallas_stream=True) leave every bucket as the resident walks
    (pallas_stream=False) have it, bit for bit, and 'auto' resolves to the
    resident walks for this small table; the product-form triangle battery
    (pallas_mxu=True) rounds t differently and is held to
    tests/test_goldens.py::_check's bar against the resident render (> 99.5%
    of values within rtol 1e-3 / atol 1e-4, means within 1e-3)."""
    w = h = 32
    scene = taccel.with_pallas_clusters(
        tbuilders.mesh_scene(w, h, subdivisions=3), cluster_size=128)
    assert scene.tri_clusters.cluster_size == 128
    base = dict(max_bounces=4, rays_per_chunk=1024, **PALLAS)

    def run(**kw):
        pol = RendererPolicy(**base, **kw)
        r = Renderer(scene, pol, w, h, device="cpu")
        # the streamed walks' table is made with the renderer, not in a walk
        assert (r.scene.tri_clusters.packed is not None) == \
            tint.stream_resolves_on(pol, scene.tri_clusters)
        r.accumulate(10)
        return r, pol

    resident, pol = run(pallas_stream=False)
    assert not tint.stream_resolves_on(pol, scene.tri_clusters)
    streamed, pol = run(pallas_stream=True)
    assert tint.stream_resolves_on(pol, scene.tri_clusters)
    auto, pol = run()
    assert not tint.stream_resolves_on(pol, scene.tri_clusters)
    for other in (streamed, auto):
        assert torch.equal(other.state.buckets, resident.state.buckets)
        assert int(other.state.rays_traced) == int(resident.state.rays_traced)
    product, _ = run(pallas_mxu=True)
    want = resident.render(tonemap=False)
    img = product.render(tonemap=False)
    assert want.mean() > 0.1
    assert np.isclose(img, want, rtol=1e-3, atol=1e-4).mean() > 0.995
    np.testing.assert_allclose(img.mean(), want.mean(), rtol=1e-3)


def test_small_scene_under_pallas_takes_the_dense_battery():
    """Below PALLAS_MIN_PRIMS spheres, or without clusters on the scene,
    accel='pallas' runs the dense battery, as in the JAX package: the same
    buckets as accel='brute'."""
    pol = dict(max_bounces=3, rays_per_chunk=4096)
    few = taccel.with_pallas_clusters(tbuilders.default_scene(16, 16))
    bare = tbuilders.random_spheres_scene(16, 16, num_spheres=250)
    for scene in (few, bare):
        a = Renderer(scene, RendererPolicy(accel="pallas", **pol), 16, 16,
                     device="cpu")
        b = Renderer(scene, RendererPolicy(narrow_wavefront=True, **pol), 16,
                     16, device="cpu")
        a.accumulate(2)
        b.accumulate(2)
        assert torch.equal(a.state.buckets, b.state.buckets)
