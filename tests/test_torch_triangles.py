"""The PyTorch port's triangle geometry against the JAX package, on the CPU:
the dense triangle batteries of ``ops/intersect.py`` (``intersect_triangles``,
``occluded_triangles``), the mixed sphere and triangle dispatch
(``intersect_scene``, ``occluded_scene``) under ``accel='brute'`` and
``accel='pallas'``, and ``render/renderer.py::bounce_step`` on the two
triangle scenes.

The JAX functions run under ``jax.jit``, as the renderer runs them, and the
Pallas kernels in interpret mode. Tolerance of the batteries: none. The
port writes the contraction of ``_triangle_candidates`` out in XLA's order
(``a*b - c*d`` is ``fma(a, b, -(c*d))``, a three-term sum ``fma(z, z',
fma(x, x', y*y'))``, the hit point ``fma(t, d, p)``, g added unfused), and
with it ids, occlusion bits and the bits of t are all equal."""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from cpu_raytracing_experiments_tpu.core.vec import Vec3 as JVec3
from cpu_raytracing_experiments_tpu.ops import intersect as jint
from cpu_raytracing_experiments_tpu.render import renderer as jr
from cpu_raytracing_experiments_tpu.scene import accel as jaccel
from cpu_raytracing_experiments_tpu.scene import builders as jbuilders
from cpu_raytracing_experiments_tpu.utils.config import RendererPolicy as JPolicy
from cpu_raytracing_experiments_tpu_torch.core.vec import Vec3 as TVec3
from cpu_raytracing_experiments_tpu_torch.ops import intersect as tint
from cpu_raytracing_experiments_tpu_torch.render import renderer as tr
from cpu_raytracing_experiments_tpu_torch.scene.scene import Scene
from cpu_raytracing_experiments_tpu_torch.utils.config import RendererPolicy

from test_torch_render import _jax_state_to_torch, _stack
from test_torch_scene import jax_scene_to_numpy

# The suite runs in several worker processes at once: one intra-op thread
# each, or the workers' thread pools fight over the cores.
torch.set_num_threads(1)

FLT_MAX = np.float32(3.4028235e38)
j_intersect_triangles = jax.jit(jint.intersect_triangles)
j_occluded_triangles = jax.jit(jint.occluded_triangles)


def _jv(a):
    return JVec3(*(jnp.asarray(a[:, i]) for i in range(3)))


def _tv(a):
    return TVec3(*(torch.from_numpy(np.ascontiguousarray(a[:, i]))
                   for i in range(3)))


def _unit(a):
    return a / np.linalg.norm(a, axis=1, keepdims=True)


def _batch(case, seed=0):
    """Seeded triangles (v0, e1, e2) and rays (p, d), float32 [n, 3], with a
    tfar seed. 'scattered': random rays through a random soup. 'grazing':
    rays that pass through an edge or a vertex of their triangle (u, v or
    u + v at a bound). 'in_plane': rays lying in their triangle's plane
    (den ~ 0, t = 0/0 or x/0). 'degenerate': a third of the triangles have
    a zero or a repeated edge (n = 0). 'duplicates': the soup followed by a
    copy of itself, 600 + 600, so every tie straddles the 512-prim chunks
    and the first occurrence must win."""
    g = np.random.default_rng(seed + sum(map(ord, case)))
    n_tri = 600 if case == "duplicates" else 700
    n = 2048
    v0 = g.uniform(-6, 6, (n_tri, 3))
    e1 = g.normal(0, 1.5, (n_tri, 3))
    e2 = g.normal(0, 1.5, (n_tri, 3))
    if case == "degenerate":
        e1[0::3] = 0.0
        e2[1::6] = e1[1::6]
        e2[4::6] = -2.0 * e1[4::6]
    v0, e1, e2 = (a.astype(np.float32) for a in (v0, e1, e2))
    p = g.uniform(-9, 9, (n, 3))
    d = _unit(g.normal(size=(n, 3)))
    k = g.integers(0, n_tri, n)
    a, b, c = (x[k].astype(np.float64) for x in (v0, e1, e2))
    if case == "grazing":
        s = g.random((n, 1))
        on_edge = np.where(g.random((n, 1)) < 0.5, a + s * b,
                           a + s * b + (1 - s) * c)
        target = np.where(g.random((n, 1)) < 0.3, a, on_edge)
        d = _unit(target - p)
    elif case == "in_plane":
        u, v = g.random((n, 1)), g.random((n, 1))
        d = _unit(u * b + v * c)
        p = a + 0.3 * b + 0.3 * c - 4.0 * d
    if case == "duplicates":
        v0, e1, e2 = (np.concatenate([x, x]) for x in (v0, e1, e2))
    tf = g.uniform(0.5, 25.0, n)
    tf[g.random(n) < 0.3] = FLT_MAX
    tf[g.random(n) < 0.1] = 0.0
    f32 = lambda x: np.ascontiguousarray(x, np.float32)
    return f32(p), f32(d), v0, e1, e2, f32(tf)


CASES = ["scattered", "grazing", "in_plane", "degenerate", "duplicates"]


@pytest.mark.parametrize("seeded", [False, True], ids=["unseeded", "tfar_seed"])
@pytest.mark.parametrize("case", CASES)
def test_intersect_triangles_matches_jax(case, seeded):
    """ops/intersect.py::intersect_triangles (:287): ids equal and the bits
    of t equal on every lane, with and without a ``tfar`` seed (lanes the
    seed wins keep (seed, -1))."""
    p, d, v0, e1, e2, tf = _batch(case)
    seed_j = {"tfar": jnp.asarray(tf)} if seeded else {}
    seed_t = {"tfar": torch.from_numpy(tf)} if seeded else {}
    want_t, want_id = j_intersect_triangles(_jv(p), _jv(d), _jv(v0), _jv(e1),
                                            _jv(e2), **seed_j)
    got_t, got_id = tint.intersect_triangles(_tv(p), _tv(d), _tv(v0), _tv(e1),
                                             _tv(e2), **seed_t)
    want_t, want_id = np.asarray(want_t), np.asarray(want_id)
    np.testing.assert_array_equal(got_id.numpy(), want_id)
    np.testing.assert_array_equal(got_t.numpy().view(np.int32),
                                  want_t.view(np.int32))
    assert (want_id >= 0).sum() > (20 if seeded else 100)
    if case == "duplicates":
        assert int(got_id.max()) < 600
    if seeded:
        assert (got_id.numpy()[tf == 0] == -1).all()
        np.testing.assert_array_equal(seed_t["tfar"].numpy(), tf)  # not edited


@pytest.mark.parametrize("case", CASES)
def test_occluded_triangles_matches_jax(case):
    """ops/intersect.py::occluded_triangles (:313): the same bits; a lane
    with tfar = 0 is never occluded."""
    p, d, v0, e1, e2, tf = _batch(case, seed=1)
    want = np.asarray(j_occluded_triangles(_jv(p), _jv(d), jnp.asarray(tf),
                                           _jv(v0), _jv(e1), _jv(e2)))
    got = tint.occluded_triangles(_tv(p), _tv(d), torch.from_numpy(tf),
                                  _tv(v0), _tv(e1), _tv(e2)).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.any() and not got[tf <= 0].any()


def test_triangle_battery_chunks_rays_and_prims(monkeypatch):
    """The dense batteries cut rays as well as prims into blocks; any block
    shape gives the same result."""
    p, d, v0, e1, e2, tf = _batch("duplicates", seed=2)
    args = (_tv(p), _tv(d), _tv(v0), _tv(e1), _tv(e2))
    want = tint.intersect_triangles(*args)
    want_occ = tint.occluded_triangles(args[0], args[1], torch.from_numpy(tf),
                                       *args[2:])
    monkeypatch.setattr(tint, "RAY_CHUNK", 300)
    monkeypatch.setattr(tint, "PRIM_CHUNK", 96)
    got = tint.intersect_triangles(*args)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert torch.equal(tint.occluded_triangles(
        args[0], args[1], torch.from_numpy(tf), *args[2:]), want_occ)


def _scenes(name, clusters, **kw):
    """(JAX scene, the port's scene made from its arrays), with cluster
    packs of `clusters` prims where that is not None."""
    jscene = getattr(jbuilders, name)(32, 32, **kw)
    if clusters:
        jscene = jaccel.with_pallas_clusters(jscene, cluster_size=clusters)
    return jscene, Scene.from_numpy(jax_scene_to_numpy(jscene), device="cpu")


def _camera_and_bounce_rays(jscene, n, seed):
    """Rays that meet mixed geometry: from the scene's camera, and from
    random points near the origin in random directions."""
    g = np.random.default_rng(seed)
    cam = np.array([float(c) for c in jscene.camera.pos], np.float32)
    p = np.where(g.random((n, 1)) < 0.5, cam,
                 g.uniform(-0.2, 1.2, (n, 3))).astype(np.float32)
    target = g.uniform(-0.3, 1.3, (n, 3))
    d = _unit(np.where(g.random((n, 1)) < 0.6, target - p,
                       g.normal(size=(n, 3)))).astype(np.float32)
    return p, d


SCENE_CASES = {
    # name, builder keywords, cluster size, accel
    "cornell_brute": ("cornell_box_scene", {}, None, "brute"),
    "cornell_pallas": ("cornell_box_scene", {}, 32, "pallas"),
    "mesh_brute": ("mesh_scene", {"subdivisions": 2}, None, "brute"),
    "mesh_pallas": ("mesh_scene", {"subdivisions": 2}, 64, "pallas"),
}


@pytest.mark.parametrize("case", sorted(SCENE_CASES))
def test_scene_dispatch_matches_jax(case):
    """ops/intersect.py::intersect_scene / occluded_scene on mixed geometry:
    tfar (bits), prim_id and is_tri equal, with an alive mask under
    accel='pallas'; occlusion bits equal. Cornell's 12 triangles and both
    scenes' 2 spheres are below PALLAS_MIN_PRIMS and take the dense
    batteries under accel='pallas' too; the mesh's 320 triangles walk their
    clusters (Pallas in interpret mode on the JAX side)."""
    name, kw, clusters, accel = SCENE_CASES[case]
    jscene, tscene = _scenes(name, clusters, **kw)
    n = 1024
    p, d = _camera_and_bounce_rays(jscene, n, 7)
    g = np.random.default_rng(8)
    alive = g.random(n) < 0.8
    jpol = JPolicy(accel=accel, pallas_tile_rays=64, pallas_interpret=True)
    tpol = RendererPolicy(accel=accel, pallas_tile_rays=64)
    want = jax.jit(lambda s, p, d, a: jint.intersect_scene(
        s, p, d, accel=accel, alive=a, policy=jpol))(
            jscene, _jv(p), _jv(d), jnp.asarray(alive))
    got = tint.intersect_scene(tscene, _tv(p), _tv(d), accel=accel,
                               alive=torch.from_numpy(alive), policy=tpol)
    live = alive if accel == "pallas" and case == "mesh_pallas" else slice(None)
    want_t, want_id, want_tri = (np.asarray(a) for a in want)
    np.testing.assert_array_equal(got[1].numpy()[live], want_id[live])
    np.testing.assert_array_equal(got[2].numpy()[live], want_tri[live])
    hit = (want_id >= 0) & (alive if live is alive else True)
    np.testing.assert_array_equal(got[0].numpy().view(np.int32)[hit],
                                  want_t.view(np.int32)[hit])
    assert want_tri[hit].sum() > 100 and (~want_tri[hit]).sum() > 20
    # shadow rays to just before and just behind the closest hit
    tf = np.where(want_id >= 0, want_t * np.where(np.arange(n) % 2, 0.999,
                                                  1.001), 5.0)
    tf = np.where(g.random(n) < 0.1, 0.0, tf).astype(np.float32)
    want_occ = jax.jit(lambda s, p, d, t: jint.occluded_scene(
        s, p, d, t, accel=accel, policy=jpol))(
            jscene, _jv(p), _jv(d), jnp.asarray(tf))
    got_occ = tint.occluded_scene(tscene, _tv(p), _tv(d),
                                  torch.from_numpy(tf), accel=accel,
                                  policy=tpol)
    np.testing.assert_array_equal(got_occ.numpy(), np.asarray(want_occ))
    assert got_occ.any() and not got_occ.numpy()[tf <= 0].any()


@pytest.mark.parametrize("case", sorted(SCENE_CASES))
def test_bounce_step_on_triangle_scenes_matches_jax(case):
    """render/renderer.py::bounce_step on a 32x32 wavefront of cornell (a
    triangle light, no sphere light: area sampling, the self-light
    exclusion, the triangle half of the emissive MIS) and of
    mesh_scene(subdivisions=2) (a sphere light over triangles), three
    bounces each fed the same JAX state: alive, ray_count, the hit ids and
    is_tri exactly equal; floats within rtol 1e-4 / atol 1e-6 on at least
    99.9% of lanes (XLA's rsqrt and sin/cos are not correctly rounded)."""
    name, kw, clusters, accel = SCENE_CASES[case]
    w = h = 32
    acc = 3
    jscene, tscene = _scenes(name, clusters, **kw)
    base = dict(max_bounces=6, rays_per_chunk=w * h, accel=accel,
                pallas_tile_rays=64)
    jpol, tpol = JPolicy(pallas_interpret=True, **base), RendererPolicy(**base)
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
    hits = jax.jit(lambda s, st: jint.intersect_scene(
        s, st.p, st.d, accel=accel, alive=st.alive, policy=jpol)[1:])
    seen_tri = 0
    for bounce in range(3):
        tstate = _jax_state_to_torch(state)
        want_id, want_tri = (np.asarray(a) for a in hits(jscene, state))
        _, got_id, got_tri = tint.intersect_scene(
            tscene, tstate.p, tstate.d, accel=accel, alive=tstate.alive,
            policy=tpol)
        alive = np.asarray(state.alive)
        np.testing.assert_array_equal(got_id.numpy()[alive], want_id[alive])
        np.testing.assert_array_equal(got_tri.numpy()[alive], want_tri[alive])
        seen_tri += int(want_tri[alive].sum())
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
    assert seen_tri > 100
    assert float(np.asarray(state.radiance.x).max()) > 0
