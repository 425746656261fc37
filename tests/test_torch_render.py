"""The PyTorch port's renderer against the JAX package's
``render/renderer.py``, ``render/estimator.py`` and ``render/api.py``, on
the CPU.

* ``bounce_step`` on a 64x64 wavefront, fed the same JAX state at each
  bounce: alive, ray_count and hit ids exactly equal; floats within a stated
  tolerance.
* whole renders through ``Renderer(device="cpu")`` against the checked-in
  goldens at the bar of ``tests/test_goldens.py::_check``.
* resume equivalence, refused knobs and the device rule of the entry points.
"""
import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from cpu_raytracing_experiments_tpu.core import vec as jvec
from cpu_raytracing_experiments_tpu.core.vec import Vec3 as JVec3
from cpu_raytracing_experiments_tpu.ops import intersect as jint
from cpu_raytracing_experiments_tpu.render import renderer as jr
from cpu_raytracing_experiments_tpu.render.api import Renderer as JRenderer
from cpu_raytracing_experiments_tpu.scene import builders as jbuilders
from cpu_raytracing_experiments_tpu.utils.config import RendererPolicy as JPolicy
from cpu_raytracing_experiments_tpu_torch import Renderer, render_image
from cpu_raytracing_experiments_tpu_torch.core.vec import Vec3 as TVec3
from cpu_raytracing_experiments_tpu_torch.ops import intersect as tint
from cpu_raytracing_experiments_tpu_torch.render import checkpoint, estimator
from cpu_raytracing_experiments_tpu_torch.render import renderer as tr
from cpu_raytracing_experiments_tpu_torch.scene import accel as taccel
from cpu_raytracing_experiments_tpu_torch.scene import builders as tbuilders
from cpu_raytracing_experiments_tpu_torch.scene.scene import Scene
from cpu_raytracing_experiments_tpu_torch.utils.config import RendererPolicy

from test_goldens import GOLDEN_DIR, POL as GOLDEN_POL, SIZE, SPP, _check
from test_torch_scene import jax_scene_to_numpy

# The suite runs in several worker processes at once: one intra-op thread
# each, or the workers' thread pools fight over the cores.
torch.set_num_threads(1)

ACC = 3  # accumulation index of the compared wavefront


def _jax_state_to_torch(s) -> tr.PathState:
    t = lambda a: torch.from_numpy(np.array(a))
    v = lambda x: TVec3(*(t(c) for c in x))
    return tr.PathState(
        bounce=int(s.bounce), p=v(s.p), d=v(s.d), throughput=v(s.throughput),
        radiance=v(s.radiance), prev_pdf=t(s.prev_pdf),
        prev_delta=t(s.prev_delta), alive=t(s.alive),
        ray_count=torch.tensor(int(s.ray_count)))


def _stack(v):
    return np.stack([np.asarray(c) for c in v], axis=1)


@pytest.mark.parametrize("name,policy", [
    ("default_scene", {}),
    ("bvh_test_scene", {"narrow_wavefront": False}),
])
def test_bounce_step_matches_jax(name, policy):
    """render/renderer.py::bounce_step, three bounces of a 64x64 wavefront
    (4096 rays, one chunk), each fed the same JAX state. alive, ray_count and
    the closest-hit ids must be exactly equal. Floats within rtol 1e-4 /
    atol 1e-6 on at least 99.9% of lanes: both packages fuse the same
    multiply-adds, but XLA's rsqrt and sin/cos are not correctly rounded,
    which moves a shadow ray lying within an ulp of a light's silhouette."""
    w = h = 64
    jpol = JPolicy(max_bounces=6, rays_per_chunk=4096, **policy)
    tpol = RendererPolicy(max_bounces=6, rays_per_chunk=4096, **policy)
    jscene = getattr(jbuilders, name)(w, h)
    tscene = Scene.from_numpy(jax_scene_to_numpy(jscene), device="cpu")
    i = np.arange(w * h)
    jseeds = jr.pixel_seeds(w, h, jpol)
    tseeds = tr.pixel_seeds(w, h, tpol)
    np.testing.assert_array_equal(np.asarray(jseeds).astype(np.int64),
                                  tseeds.numpy())
    p0, d0 = jax.jit(lambda s: jr.generate_camera_rays(
        s.camera, jnp.asarray(i % w, jnp.int32), jnp.asarray(i // w, jnp.int32),
        jnp.uint32(ACC), jseeds, False, jpol))(jscene)
    tp0, td0 = tr.generate_camera_rays(
        tscene.camera, torch.from_numpy(i % w), torch.from_numpy(i // w), ACC,
        tseeds, False, tpol)
    np.testing.assert_allclose(_stack(td0), _stack(d0), rtol=0, atol=1e-6)
    one, zero = jnp.ones(w * h), jnp.zeros(w * h)
    state = jr.PathState(
        bounce=jnp.int32(0), p=p0, d=d0, throughput=JVec3(one, one, one),
        radiance=JVec3(zero, zero, zero), prev_pdf=zero,
        prev_delta=zero > 1.0, alive=zero < 1.0, ray_count=jnp.uint32(0))
    step = jax.jit(lambda s, st: jr.bounce_step(s, jpol, jnp.uint32(ACC),
                                                jseeds, st))
    hit_ids = jax.jit(lambda s, p, d: jint.intersect_scene(s, p, d)[1])
    for bounce in range(3):
        tstate = _jax_state_to_torch(state)
        want_ids = np.asarray(hit_ids(jscene, state.p, state.d))
        got_ids = tint.intersect_scene(tscene, tstate.p, tstate.d)[1].numpy()
        np.testing.assert_array_equal(got_ids, want_ids)
        want = step(jscene, state)
        got = tr.bounce_step(tscene, tpol, ACC, tseeds, tstate)
        assert got.bounce == int(want.bounce) == bounce + 1
        np.testing.assert_array_equal(got.alive.numpy(), np.asarray(want.alive))
        assert int(got.ray_count) == int(want.ray_count)
        for field in ("radiance", "throughput", "p", "d"):
            close = np.isclose(_stack(getattr(got, field)),
                               _stack(getattr(want, field)),
                               rtol=1e-4, atol=1e-6).all(axis=1)
            assert close.mean() >= 0.999, (bounce, field, close.mean())
        state = want


@pytest.mark.parametrize("name,policy", [
    ("default_scene", {}),
    ("bvh_test_scene", {"narrow_wavefront": False}),
])
def test_trace_rays_matches_jax_from_same_camera_rays(name, policy):
    """render/renderer.py::trace_rays, all six bounces of two 64x64
    passes, both packages starting from the JAX package's camera rays:
    radiance within rtol 1e-4 / atol 1e-5 on at least 99.9% of lanes and
    ray counts within 0.1%. (From their own camera rays the two packages
    differ in one ulp of ~half the directions, because XLA's CPU rsqrt is
    not correctly rounded: test_golden_bvh_test holds that case.)"""
    w = h = 64
    jpol = JPolicy(max_bounces=6, rays_per_chunk=4096, **policy)
    tpol = RendererPolicy(max_bounces=6, rays_per_chunk=4096, **policy)
    jscene = getattr(jbuilders, name)(w, h)
    tscene = Scene.from_numpy(jax_scene_to_numpy(jscene), device="cpu")
    i = np.arange(w * h)
    jseeds = jr.pixel_seeds(w, h, jpol)
    tseeds = tr.pixel_seeds(w, h, tpol)
    camera = jax.jit(lambda s, a: jr.generate_camera_rays(
        s.camera, jnp.asarray(i % w, jnp.int32), jnp.asarray(i // w, jnp.int32),
        a, jseeds, False, jpol))
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


def _exact_rsqrt(x):
    """A correctly rounded float32 rsqrt for the JAX package: float64 on the
    host, rounded once, as the port's ``core/fp.py::rsqrt`` computes it."""
    return jax.pure_callback(
        lambda a: (1.0 / np.sqrt(np.asarray(a, np.float64))).astype(np.float32),
        jax.ShapeDtypeStruct(x.shape, jnp.float32), x,
        vmap_method="expand_dims")


@pytest.fixture
def jax_exact_rsqrt(monkeypatch):
    """The JAX package with XLA's CPU rsqrt (``vrsqrtps`` and Newton steps,
    not correctly rounded) replaced by ``_exact_rsqrt`` for one test. The jit
    caches are cleared on both sides, so no trace of either form reaches
    another test."""
    jax.clear_caches()
    monkeypatch.setattr(jvec, "jax_rsqrt", _exact_rsqrt)
    yield
    monkeypatch.undo()
    jax.clear_caches()


@pytest.mark.parametrize("name", ["default_scene", "bvh_test_scene"])
def test_camera_rays_match_jax_with_exact_rsqrt(name, jax_exact_rsqrt):
    """render/renderer.py::generate_camera_rays: origins and directions are
    bit-equal to the JAX package's once both round rsqrt correctly. XLA
    squares the camera's scalar view depth once, outside the elementwise
    loop, so only x*x + y*y of |v|^2 is contracted."""
    w = h = 64
    jpol = JPolicy(max_bounces=6, rays_per_chunk=4096)
    tpol = RendererPolicy(max_bounces=6, rays_per_chunk=4096)
    jscene = getattr(jbuilders, name)(w, h)
    tscene = Scene.from_numpy(jax_scene_to_numpy(jscene), device="cpu")
    i = np.arange(w * h)
    camera = jax.jit(lambda s, a: jr.generate_camera_rays(
        s.camera, jnp.asarray(i % w, jnp.int32), jnp.asarray(i // w, jnp.int32),
        a, jr.pixel_seeds(w, h, jpol), False, jpol))
    for acc in (1, 7):
        p0, d0 = camera(jscene, jnp.uint32(acc))
        tp0, td0 = tr.generate_camera_rays(
            tscene.camera, torch.from_numpy(i % w), torch.from_numpy(i // w),
            acc, tr.pixel_seeds(w, h, tpol), False, tpol)
        np.testing.assert_array_equal(_stack(tp0), _stack(p0))
        np.testing.assert_array_equal(_stack(td0), _stack(d0))


def _render(builder, policy, device="cpu"):
    r = Renderer(builder(SIZE, SIZE), policy, SIZE, SIZE, device=device)
    r.accumulate(SPP)
    return r.render(tonemap=False)


def test_golden_hero():
    """The hero scene, 64x64, 10 spp, max_bounces=6, rays_per_chunk=4096,
    at tests/test_goldens.py::_check's bar."""
    _check("hero", _render(tbuilders.default_scene, _port(GOLDEN_POL)))


def test_golden_cornell():
    """The Cornell box (12 triangles with a triangle light, 2 spheres),
    64x64, 10 spp, at tests/test_goldens.py::_check's bar."""
    _check("cornell", _render(tbuilders.cornell_box_scene, _port(GOLDEN_POL)))


@pytest.mark.parametrize("accel", [
    # 134 s on one CPU core: the dense battery tests every ray against all
    # 1280 triangles in float64 multiply-adds
    pytest.param("brute", marks=pytest.mark.slow),
    "pallas"])
def test_golden_mesh(accel):
    """mesh_scene(96, 96, subdivisions=3) (1280 triangles over a ground
    sphere, a sphere light), 10 spp, against mesh_96x96_10spp.npy at
    _check's bar (> 99.5% of values within rtol 1e-3 / atol 1e-4, the means
    within 1e-3), as tests/test_goldens.py::test_golden_mesh holds the JAX
    package: through the dense batteries, and through the clustered
    traversal at 64 prims a cluster and 64-ray tiles."""
    scene = tbuilders.mesh_scene(96, 96, subdivisions=3)
    pol = _port(GOLDEN_POL)
    if accel == "pallas":
        scene = taccel.with_pallas_clusters(scene, cluster_size=64)
        pol = dataclasses.replace(pol, accel="pallas", pallas_tile_rays=64,
                                  rays_per_chunk=9216)
    r = Renderer(scene, pol, 96, 96, device="cpu")
    r.accumulate(SPP)
    img = r.render(tonemap=False)
    want = np.load(GOLDEN_DIR / "mesh_96x96_10spp.npy")
    assert np.isclose(img, want, rtol=1e-3, atol=1e-4).mean() > 0.995
    np.testing.assert_allclose(img.mean(), want.mean(), rtol=1e-3)


def test_golden_bvh_test(jax_exact_rsqrt):
    """bvh_test (255 spheres), 64x64, 10 spp, narrowing off in both packages
    (narrowing leaves every lane's value as it is, in the JAX package and in
    the port: tests/test_narrowing.py, tests/test_torch_narrowing.py). The
    checked-in golden comes from XLA's CPU rsqrt, which the port
    does not copy: it rounds rsqrt correctly. One ulp in half the camera
    directions moves grazing hits at distance ~300 and so the 10-spp mean
    by ~0.5%, beyond _check's 1e-3 on the mean. So the witness is the JAX
    renderer with a correctly rounded rsqrt, and the port is held to it at
    _check's bar; against the golden itself, at _check's bar on the share
    of close values."""
    pol = RendererPolicy(max_bounces=6, rays_per_chunk=4096,
                         narrow_wavefront=False)
    img = _render(tbuilders.bvh_test_scene, pol)
    jr_ = JRenderer(jbuilders.bvh_test_scene(SIZE, SIZE),
                    JPolicy(max_bounces=6, rays_per_chunk=4096,
                            narrow_wavefront=False), SIZE, SIZE)
    jr_.accumulate(SPP)
    witness = np.asarray(jr_.render(tonemap=False))
    assert np.isclose(img, witness, rtol=1e-3, atol=1e-4).mean() > 0.995
    np.testing.assert_allclose(img.mean(), witness.mean(), rtol=1e-3)
    golden = np.load(GOLDEN_DIR / f"bvh_test_{SIZE}x{SIZE}_{SPP}spp.npy")
    assert np.isclose(img, golden, rtol=1e-3, atol=1e-4).mean() > 0.995


def test_golden_white_furnace():
    """Energy conservation: every pixel of the linear resolve is 1."""
    img = _render(tbuilders.white_furnace_scene, _port(GOLDEN_POL))
    _check("white_furnace", img)
    np.testing.assert_allclose(img, 1.0, rtol=2e-3)


def _port(jpol):
    """The port's policy with the same fields as a JAX policy."""
    return RendererPolicy(**{f.name: getattr(jpol, f.name)
                             for f in dataclasses.fields(jpol)})


def test_resume_equivalence_bitwise():
    """accumulate(10) equals accumulate(4) then accumulate(6), and
    accumulate(3) then accumulate(7), bit for bit: the counter RNG keys every
    draw by (accumulation, pixel), however passes are batched into wide
    launches (32x32 frames, 4096-ray chunks: 4 passes per launch)."""
    pol = RendererPolicy(max_bounces=4, rays_per_chunk=4096)
    assert estimator.launch_width(pol, 32, 32) == 4

    def run(*splits):
        r = Renderer(tbuilders.default_scene(32, 32), pol, 32, 32,
                     device="cpu")
        for n in splits:
            r.accumulate(n)
        return r.state

    whole = run(10)
    assert whole.accumulations == 10
    for splits in ((4, 6), (3, 7)):
        part = run(*splits)
        assert part.accumulations == 10
        assert torch.equal(part.buckets, whole.buckets), splits
        assert int(part.rays_traced) == int(whole.rays_traced) > 0, splits


@pytest.mark.parametrize("knob", [
    {"accel": "clustered"}, {"use_bvh": True},
    {"brdf": "ggx"},  # ggx, the camera knobs and spp = 2 render now
    {"light_sampling": "power"}, {"enable_dof": True},  # and power, alias
    {"stratify_camera": True}, {"rng_scramble": True},
    {"samples_per_pixel": 2}, {"primary_accel": "bvh"},
    {"accel": "grid"}, {"accel": "pallas", "pallas_stream": True},
    {"accel": "pallas", "pallas_mxu": True},  # these six render now
    {"accel": "pallas", "pallas_plan": "super"},
    {"primary_accel": "pallas", "pallas_plan": "group"},
    {"accel": "pallas", "pallas_sort_impl": "xla"},
    {"accel": "pallas", "pallas_sort_visits": False},
    {"light_sampling": "alias"},
])
def test_knob_outside_slice_raises(knob):
    """A knob the port does not render yet raises NotImplementedError, which
    names it, instead of changing the result. ``pallas_stream=True`` and
    ``pallas_mxu`` are ported: they render, and on this 9-sphere scene (dense
    batteries under accel='pallas') leave the buckets as accel='brute' has
    them; the two together are refused by RendererPolicy, as in the JAX
    package. The planners are ported: on 200 spheres in clusters of 32 with
    group boxes, 'super' and ``pallas_sort_impl='xla'`` leave the buckets as
    the 'ray' planner has them, and 'group' and
    ``pallas_sort_visits=False`` meet tests/test_goldens.py::_check's bar
    against it (their visit order may settle an exact tie otherwise).
    ``brdf='ggx'``, ``enable_dof``, ``stratify_camera``, ``rng_scramble``,
    ``samples_per_pixel=2`` and ``light_sampling`` 'power' and 'alias' are
    ported: the hero at 16x16, 2 bounces, 5 passes meets the JAX renderer
    under the same knob at _check's bar (test_torch_brdf.py,
    test_torch_camera.py, test_torch_knobs.py, test_torch_lights.py and
    test_torch_restir.py hold them closer)."""
    planner = {"pallas_plan", "pallas_sort_impl", "pallas_sort_visits"}
    shading = {"brdf", "enable_dof", "stratify_camera", "rng_scramble",
               "samples_per_pixel", "light_sampling"}
    if shading & set(knob):
        r = Renderer(tbuilders.default_scene(16, 16), RendererPolicy(
            max_bounces=2, rays_per_chunk=4096, **knob), 16, 16, device="cpu")
        r.accumulate(5)
        jr_ = JRenderer(jbuilders.default_scene(16, 16), JPolicy(
            max_bounces=2, rays_per_chunk=4096, **knob), 16, 16)
        jr_.accumulate(5)
        img, want = r.render(tonemap=False), np.asarray(
            jr_.render(tonemap=False))
        assert np.isclose(img, want, rtol=1e-3, atol=1e-4).mean() > 0.995
        np.testing.assert_allclose(img.mean(), want.mean(), rtol=1e-3)
        return
    if planner & set(knob):
        scene = taccel.with_pallas_clusters(
            tbuilders.random_spheres_scene(16, 16, num_spheres=200),
            cluster_size=32, fill_window=8, group_boxes=True)
        renders = []
        for kw in (knob, {k: v for k, v in knob.items() if k not in planner}):
            r = Renderer(scene, RendererPolicy(
                max_bounces=3, rays_per_chunk=4096, pallas_tile_rays=64,
                **kw), 16, 16, device="cpu")
            r.accumulate(2)
            renders.append(r)
        if knob.get("pallas_plan") == "super" or "pallas_sort_impl" in knob:
            assert torch.equal(renders[0].state.buckets,
                               renders[1].state.buckets)
            return
        img, want = (r.render(tonemap=False) for r in renders)
        assert np.isclose(img, want, rtol=1e-3, atol=1e-4).mean() > 0.995
        np.testing.assert_allclose(img.mean(), want.mean(), rtol=1e-3)
        return
    pol = RendererPolicy(max_bounces=2, rays_per_chunk=4096, **knob)
    if "pallas_stream" in knob or "pallas_mxu" in knob:
        renders = [Renderer(tbuilders.default_scene(8, 8), p, 8, 8,
                            device="cpu")
                   for p in (pol, RendererPolicy(max_bounces=2,
                                                 rays_per_chunk=4096,
                                                 narrow_wavefront=True))]
        for r in renders:
            r.accumulate(1)
        assert torch.equal(renders[0].state.buckets, renders[1].state.buckets)
        with pytest.raises(ValueError, match="pallas_stream=True excludes"):
            RendererPolicy(pallas_stream=True, pallas_mxu=True)
        return
    with pytest.raises(NotImplementedError) as err:
        Renderer(tbuilders.default_scene(8, 8), pol, 8, 8, device="cpu")
    assert [k for k in knob if k in str(err.value)] or "use_bvh" in knob


@pytest.mark.parametrize("knob", [
    {"pallas_unroll": 4}, {"pallas_fuse": 2}, {"pallas_trav_block": 8},
    {"pallas_exit_refresh": 32}, {"pallas_prefetch": True},
    {"pallas_plan_block": 16}, {"pallas_interpret": True},
    {"pallas_plan": "auto"},
])
def test_schedule_knobs_accepted_and_change_nothing(knob):
    """The pallas_* schedule knobs choose among TPU schedules the JAX
    package holds bit-identical; the port accepts them and renders the same
    buckets."""
    scene = taccel.with_pallas_clusters(
        tbuilders.random_spheres_scene(16, 16, num_spheres=200),
        cluster_size=32)
    base = dict(max_bounces=3, rays_per_chunk=4096, accel="pallas",
                pallas_tile_rays=64)

    def buckets(**kw):
        r = Renderer(scene, RendererPolicy(**base, **kw), 16, 16,
                     device="cpu")
        r.accumulate(2)
        return r.state.buckets

    assert torch.equal(buckets(**knob), buckets())


def test_too_many_clusters_refused_before_any_work(monkeypatch):
    """No cluster count is refused any more. The planner kernel that sorts
    keeps a tile's entries and sorts its list in one block's shared memory
    (``max_plan_clusters``); a pack above that is planned by
    ``cluster_plan_rows`` and the PyTorch sort, which give the same lists.
    So a Renderer is made for a scene of 16,385 clusters (spheres or
    triangles) under the default policy, and with the limit patched below a
    real pack's cluster count the route is the rows planner, and the render
    equals the unpatched one bit for bit."""
    import dataclasses

    from cpu_raytracing_experiments_tpu_torch.ops.kernels import \
        cluster_traverse as ct

    assert [ct.max_plan_clusters(t) for t in (32, 128, 256, 1024)] \
        == [32768] * 3 + [16384]
    scene = taccel.with_pallas_clusters(
        tbuilders.random_spheres_scene(8, 8, num_spheres=200),
        cluster_size=32)
    over = dataclasses.replace(scene, sphere_clusters=dataclasses.replace(
        scene.sphere_clusters, num_clusters=1 << 16))
    pol = RendererPolicy(max_bounces=2, accel="pallas")
    Renderer(over, pol, 8, 8, device="cpu")
    mesh = taccel.with_pallas_clusters(
        tbuilders.mesh_scene(8, 8, subdivisions=2), cluster_size=32)
    Renderer(dataclasses.replace(mesh, tri_clusters=dataclasses.replace(
        mesh.tri_clusters, num_clusters=1 << 16)), pol, 8, 8, device="cpu")
    assert not ct.plans_in_kernel(over.sphere_clusters, "ray", True,
                                  "kernel", 256)
    cp = scene.sphere_clusters
    assert ct.plans_in_kernel(cp, "ray", True, "kernel", 256)

    def render():
        r = Renderer(scene, RendererPolicy(max_bounces=2, accel="pallas",
                                           pallas_tile_rays=32), 8, 8,
                     device="cpu")
        r.accumulate(2)
        return r.state.buckets

    want = render()
    monkeypatch.setattr(ct, "max_plan_clusters", lambda tile_r: 4)
    assert cp.num_clusters > 4
    assert not ct.plans_in_kernel(cp, "ray", True, "kernel", 256)
    assert torch.equal(render(), want)


def test_narrowing_auto_and_triangles_raise():
    """narrow_wavefront='auto' resolves to on at >= 64 prims, spheres and
    triangles together (bvh_test has 255 spheres; mesh_scene(subdivisions=1)
    80 triangles and 2 spheres; cornell's 14 prims stay below), and under
    accel='pallas'; such scenes render. Triangle scenes no longer raise at
    construction: they render, from the JAX package's arrays too."""
    big = tbuilders.bvh_test_scene(8, 8)
    mesh = tbuilders.mesh_scene(8, 8, subdivisions=1)
    cornell = tbuilders.cornell_box_scene(8, 8)
    assert tr.narrowing_on(RendererPolicy(), big)
    assert tr.narrowing_on(RendererPolicy(), mesh)
    assert not tr.narrowing_on(RendererPolicy(), cornell)
    assert not tr.narrowing_on(RendererPolicy(), tbuilders.default_scene(8, 8))
    assert tr.narrowing_on(RendererPolicy(accel="pallas"),
                           tbuilders.default_scene(8, 8))
    assert tr._narrow_caps(RendererPolicy(), mesh, 1 << 19) == [131072, 16384]
    carried = Scene.from_numpy(
        jax_scene_to_numpy(jbuilders.cornell_box_scene(8, 8)))
    for scene in (big, mesh, cornell, carried):
        r = Renderer(scene, RendererPolicy(max_bounces=2), 8, 8, device="cpu")
        r.accumulate(1)
        assert np.isfinite(r.render()).all()


def test_entry_points_default_to_cuda(tmp_path):
    """Renderer, render_image and checkpoint.load without `device` run on
    the card; with no card they raise rather than fall back to the CPU.
    (The other entry points take a scene or a Renderer and run on its
    device.)"""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    scene = tbuilders.white_furnace_scene(8, 8)
    with pytest.raises(RuntimeError, match="CUDA"):
        Renderer(scene, RendererPolicy(), 8, 8)
    with pytest.raises(RuntimeError, match="CUDA"):
        render_image(scene, 8, 8, 5)
    pol = RendererPolicy(max_bounces=4)
    img = render_image(scene, 8, 8, 5, pol, tonemap=False, device="cpu")
    assert img.shape == (8, 8, 3)
    path = tmp_path / "state.npz"
    checkpoint.save(path, estimator.RenderState.create(8, 8, pol), pol, 8, 8)
    with pytest.raises(RuntimeError, match="CUDA"):
        checkpoint.load(path, pol, 8, 8)
    assert checkpoint.load(path, pol, 8, 8, device="cpu").buckets.is_cpu
