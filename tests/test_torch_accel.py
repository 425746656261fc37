"""The PyTorch port's backends without Pallas, ``accel='clustered'``,
'grid' and 'bvh', against the JAX package's, on the CPU: the clustered
walks (``ops/clustered.py``), the scene dispatch (``ops/intersect.py``),
``ops/sort.py``, the policy check and whole render passes.

Intersections are bit-equal to jitted JAX. Render passes under a backend
are held to the JAX renderer with correctly rounded rsqrt, sin and cos
(``jax_exact_math``): the JAX renderer under 'bvh', 'grid' or 'clustered'
rounds a few shading results otherwise than its own brute renderer does on
the same scene (14 of 1024 lanes of a 32x32 pass differ by at most 1e-6
relative, with equal hits, equal occlusion and equal ray counts: XLA fuses
the shading of a program with a while loop otherwise). The port rounds as
the brute program does under every backend. So on every lane where the JAX
package's backend render equals its brute render the port equals both bit
for bit, and on the few others it is within 2e-6 relative of the backend
render."""
import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from cpu_raytracing_experiments_tpu.ops import clustered as jcl
from cpu_raytracing_experiments_tpu.ops import intersect as jint
from cpu_raytracing_experiments_tpu.ops import sort as jsort
from cpu_raytracing_experiments_tpu.render import renderer as jr
from cpu_raytracing_experiments_tpu.scene import accel as jaccel
from cpu_raytracing_experiments_tpu.scene import builders as jbuilders
from cpu_raytracing_experiments_tpu.utils.config import \
    RendererPolicy as JPolicy
from cpu_raytracing_experiments_tpu_torch import Renderer
from cpu_raytracing_experiments_tpu_torch.ops import clustered as tcl
from cpu_raytracing_experiments_tpu_torch.ops import intersect as tint
from cpu_raytracing_experiments_tpu_torch.ops import sort as tsort
from cpu_raytracing_experiments_tpu_torch.render import renderer as tr
from cpu_raytracing_experiments_tpu_torch.scene import accel as taccel
from cpu_raytracing_experiments_tpu_torch.scene import builders as tbuilders
from cpu_raytracing_experiments_tpu_torch.scene.scene import Scene
from cpu_raytracing_experiments_tpu_torch.utils.config import RendererPolicy

from test_goldens import GOLDEN_DIR, SIZE, SPP
from test_torch_bvh import FLT_MAX, bits, jv, rays, spheres, triangles, tv
from test_torch_knobs import jax_exact_math  # noqa: F401  (a fixture)
from test_torch_scene import jax_clusters_to_numpy, jax_scene_to_numpy

torch.set_num_threads(1)

W = H = 32


def _packs(kind, num_clusters):
    """A morton pack of 1000 spheres or 1500 triangles in both packages."""
    if kind == "sphere":
        c, r = spheres(1000, 4)
        mins, maxs = c - r[:, None], c + r[:, None]
        rows = np.concatenate([c, (r * r)[:, None]], 1)
        p, d = rays(3000, 9, -100, 100)
    else:
        v0, v1, v2 = triangles(1500, 5)
        mins = np.minimum(np.minimum(v0, v1), v2)
        maxs = np.maximum(np.maximum(v0, v1), v2)
        rows = np.concatenate([v0, v1 - v0, v2 - v0], 1)
        p, d = rays(3000, 10, -30, 30)
    jcp = jcl.build_clusters(mins, maxs, rows, num_clusters=num_clusters,
                             kind=kind)
    return jcp, tcl.ClusteredPrims.from_numpy(jax_clusters_to_numpy(jcp)), \
        p, d


@pytest.mark.parametrize("kind,num_clusters", [
    ("sphere", 64), ("sphere", 7), ("triangle", 64), ("triangle", 5)])
def test_clustered_bit_equal_jax(kind, num_clusters):
    """ops/clustered.py::intersect_clustered / occluded_clustered against
    jitted JAX: tfar bits and original prim ids, and occlusion bits, exactly
    equal, with a tfar0 seed on every fifth lane and disabled shadow lanes
    (after tests/test_clustered.py). 1000 / 7 and 1500 / 5 leave the last
    cluster partly padding (a non-uniform count)."""
    jcp, tcp, p, d = _packs(kind, num_clusters)
    tf0 = np.full(p.shape[0], FLT_MAX, np.float32)
    tf0[::5] = 20.0
    want = jax.jit(lambda cp, p, d, t: jcl.intersect_clustered(
        cp, p, d, tfar0=t))(jcp, jv(p), jv(d), jnp.asarray(tf0))
    got = tcl.intersect_clustered(tcp, tv(p), tv(d), torch.from_numpy(tf0))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(bits(got[0].numpy()), bits(want[0]))
    assert (got[1] >= 0).float().mean() > 0.05
    tf = np.full(p.shape[0], 80.0 if kind == "sphere" else 25.0, np.float32)
    tf[::7] = 0.0
    want = jax.jit(lambda cp, p, d, t: jcl.occluded_clustered(cp, p, d, t))(
        jcp, jv(p), jv(d), jnp.asarray(tf))
    got = tcl.occluded_clustered(tcp, tv(p), tv(d), torch.from_numpy(tf))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.float().mean() > 0.05


def test_clustered_axis_aligned_ray_past_padding():
    """A ray exactly along +x through a partly padded cluster (1000 spheres
    in 7 clusters of 256 slots: one partly filled, the rest empty): the
    padding rows (zero-radius spheres at x = 1e16) lie on the line of the
    second ray and must never hit; the JAX package masks them by id, the
    port tests real rows only."""
    jcp, tcp, _, _ = _packs("sphere", 7)
    k = tcp.cluster_size
    real = (tcp.order.view(-1, k) >= 0).sum(dim=1)
    partial = int(torch.nonzero((real > 0) & (real < k))[0, 0])
    c = tcp.rows[partial * k]
    p = np.array([[-200.0, float(c[1]), float(c[2])],
                  [-200.0, 0.0, 0.0]], np.float32)
    d = np.array([[1.0, 0.0, 0.0], [1.0, 0.0, 0.0]], np.float32)
    want = jax.jit(lambda cp, p, d: jcl.intersect_clustered(cp, p, d))(
        jcp, jv(p), jv(d))
    got = tcl.intersect_clustered(tcp, tv(p), tv(d))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(bits(got[0].numpy()), bits(want[0]))
    assert (got[0] < 1e15).all()


# (backend, the JAX package's builder of its tables)
ATTACH = {
    "bvh": jaccel.with_bvh,
    "grid": lambda s: jaccel.with_grid(s, res=4, max_per_cell=2),
    "clustered": lambda s: jaccel.with_clusters(s, num_clusters=4),
}


@pytest.mark.parametrize("accel", list(ATTACH))
def test_scene_dispatch_bit_equal_jax(accel):
    """ops/intersect.py::intersect_scene / occluded_scene on the Cornell box
    (2 spheres and 12 triangles, the grid with a residual) under each
    backend against jitted JAX: hits, is_tri, tfar bits and occlusion bits
    exactly equal; the triangle pass is seeded with the sphere pass's tfar
    and the shadow's triangle pass skips lanes the spheres occlude."""
    js = ATTACH[accel](jbuilders.cornell_box_scene(16, 16))
    ts = Scene.from_numpy(jax_scene_to_numpy(js), device="cpu")
    p, d = rays(3000, 11, -1.0, 1.0)
    want = jax.jit(lambda s, p, d: jint.intersect_scene(
        s, p, d, accel=accel))(js, jv(p), jv(d))
    got = tint.intersect_scene(ts, tv(p), tv(d), accel=accel)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy().view(np.int32)
                                      if a.dtype == torch.float32
                                      else a.numpy(),
                                      bits(b) if a.dtype == torch.float32
                                      else np.asarray(b))
    assert 0.05 < got[2].float().mean() < 0.95
    tf = np.full(p.shape[0], 1.5, np.float32)
    tf[::7] = 0.0
    want = jax.jit(lambda s, p, d, t: jint.occluded_scene(
        s, p, d, t, accel=accel))(js, jv(p), jv(d), jnp.asarray(tf))
    got = tint.occluded_scene(ts, tv(p), tv(d), torch.from_numpy(tf),
                              accel=accel)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("accel", list(ATTACH))
def test_missing_table_rules_follow_jax(accel):
    """The JAX package's dispatch rules, not a device fallback: a scene
    without the backend's sphere table renders with the dense batteries
    (the port's result equals its 'brute' result), and a scene whose
    triangles lack their table gets no triangle pass under the backend.
    Both equal jitted JAX bit for bit."""
    base = jbuilders.cornell_box_scene(16, 16)
    keys = {"bvh": ("sphere_bvh", "tri_bvh"),
            "grid": ("sphere_grid", "tri_grid"),
            "clustered": ("sphere_clusters", "tri_clusters")}[accel]
    p, d = rays(2000, 12, -1.0, 1.0)
    for js in (base, dataclasses.replace(ATTACH[accel](base),
                                         **{keys[1]: None})):
        ts = Scene.from_numpy(jax_scene_to_numpy(js), device="cpu")
        want = jax.jit(lambda s, p, d: jint.intersect_scene(
            s, p, d, accel=accel))(js, jv(p), jv(d))
        got = tint.intersect_scene(ts, tv(p), tv(d), accel=accel)
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
        np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
        np.testing.assert_array_equal(bits(got[0].numpy()), bits(want[0]))
        brute = tint.intersect_scene(ts, tv(p), tv(d))
        if js is base:
            assert all(torch.equal(a, b) for a, b in zip(got, brute))
        else:
            assert not got[2].any() and brute[2].any()


def test_sort_equals_jax():
    """ops/sort.py: histogram, prefix_sum, sort_ray_ids (misses first,
    stable by material) and compaction_order (live lanes first, stable),
    after tests/test_components.py, and on 5000 seeded keys against JAX."""
    mat = torch.tensor([2, -1, 0, 2, -1, 1, 0, 2], dtype=torch.int32)
    ids, miss = tsort.sort_ray_ids(mat, num_materials=3)
    assert int(miss) == 2
    assert ids.tolist() == [1, 4, 2, 6, 5, 0, 3, 7]
    keys = torch.tensor([0, 1, 1, 3, 3, 3], dtype=torch.int32)
    assert tsort.histogram(keys, 4).tolist() == [1, 2, 0, 3]
    assert tsort.prefix_sum(tsort.histogram(keys, 4)).tolist() == [1, 3, 3, 6]
    alive = torch.tensor([False, True, False, True, True])
    order, n = tsort.compaction_order(alive)
    assert int(n) == 3 and order.tolist() == [1, 3, 4, 0, 2]
    g = np.random.default_rng(13)
    mat = g.integers(-1, 9, 5000).astype(np.int32)
    alive = g.random(5000) < 0.4
    for got, want in (
            (tsort.sort_ray_ids(torch.from_numpy(mat), 9),
             jsort.sort_ray_ids(jnp.asarray(mat), 9)),
            (tsort.compaction_order(torch.from_numpy(alive)),
             jsort.compaction_order(jnp.asarray(alive))),
            ((tsort.histogram(torch.from_numpy(mat + 1), 10),),
             (jsort.histogram(jnp.asarray(mat + 1), 10),))):
        for a, b in zip(got, want):
            assert a.dtype == torch.int32
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("knob", [
    {"accel": "bvh"}, {"accel": "grid"}, {"accel": "clustered"},
    {"use_bvh": True}, {"primary_accel": "bvh"}, {"primary_accel": "grid"},
    {"primary_accel": "clustered"}, {"accel": "grid", "primary_accel": "bvh"},
])
def test_check_policy_accepts_every_accel(knob):
    """render/renderer.py::check_policy lets every accel and primary_accel
    of the JAX package's RendererPolicy through, and use_bvh=True means
    'bvh'."""
    pol = RendererPolicy(**knob)
    tr.check_policy(pol)
    if "use_bvh" in knob:
        assert pol.effective_accel == "bvh"


# (label, the JAX package's table builder, policy knobs)
RENDERS = {
    "bvh": (jaccel.with_bvh, {"accel": "bvh"}),
    "grid": (jaccel.with_grid, {"accel": "grid"}),
    "clustered": (lambda s: jaccel.with_clusters(s, num_clusters=16),
                  {"accel": "clustered"}),
    # the packs after with_bvh, so that they carry the BVH's prim order
    "bvh, primary pallas": (
        lambda s: jaccel.with_pallas_clusters(jaccel.with_bvh(s)),
        {"accel": "bvh", "primary_accel": "pallas"}),
}


def _stack(v):
    return np.stack([np.asarray(c) for c in v], axis=-1)


@pytest.mark.parametrize("name", list(RENDERS))
def test_render_pass_matches_jax(name, jax_exact_math):
    """render/renderer.py::render_pass at 32x32 on bvh_test_scene (255
    spheres), 3 bounces, 4096-ray chunks, accumulations 1 and 2, under each
    backend, against jitted JAX with exact rsqrt, sin and cos: ray counts
    equal; every lane on which the JAX package's backend render equals its
    brute render of the same scene equals it bit for bit, and the others (at
    most 2% of the lanes) are within 2e-6 relative (see the module
    docstring). Under 'bvh' use_bvh=True renders the same buckets."""
    attach, knobs = RENDERS[name]
    js = attach(jbuilders.bvh_test_scene(W, H))
    ts = Scene.from_numpy(jax_scene_to_numpy(js), device="cpu")
    base = dict(max_bounces=3, rays_per_chunk=4096)
    jpol = JPolicy(**base, **knobs, pallas_interpret=True)
    jbrute = JPolicy(**base)
    tpol = RendererPolicy(**base, **knobs)
    backend = jax.jit(lambda s, a: jr.render_pass(s, jpol, a, W, H))
    brute = jax.jit(lambda s, a: jr.render_pass(s, jbrute, a, W, H))
    for acc in (1, 2):
        want = backend(js, jnp.uint32(acc))
        ref = _stack(brute(js, jnp.uint32(acc))[0])
        got = tr.render_pass(ts, tpol, acc, W, H)
        assert int(got[1]) == int(want[1])
        a, b = _stack(got[0]), _stack(want[0])
        agree = (bits(b) == bits(ref)).all(axis=1)
        assert agree.mean() >= 0.98, agree.mean()
        np.testing.assert_array_equal(bits(a)[agree], bits(b)[agree])
        np.testing.assert_allclose(a, b, rtol=2e-6, atol=0)
        if name == "bvh":
            again = tr.render_pass(ts, RendererPolicy(**base, use_bvh=True),
                                   acc, W, H)
            np.testing.assert_array_equal(bits(_stack(again[0])), bits(a))


@pytest.mark.slow
@pytest.mark.parametrize("accel", ["bvh", "grid", "clustered"])
def test_golden_bvh_test_through_each_backend(accel):
    """The bvh_test golden (64x64, 10 spp, 6 bounces, narrowing off) through
    each backend, held as test_torch_render.py::test_golden_bvh_test holds
    the brute render against the golden: more than 99.5% of the values
    within rtol 1e-3 / atol 1e-4 (the golden comes from XLA's CPU rsqrt)."""
    scene = tbuilders.bvh_test_scene(SIZE, SIZE)
    scene = {"bvh": taccel.with_bvh, "grid": taccel.with_grid,
             "clustered": taccel.with_clusters}[accel](scene)
    r = Renderer(scene, RendererPolicy(max_bounces=6, rays_per_chunk=4096,
                                       narrow_wavefront=False, accel=accel),
                 SIZE, SIZE, device="cpu")
    r.accumulate(SPP)
    golden = np.load(GOLDEN_DIR / f"bvh_test_{SIZE}x{SIZE}_{SPP}spp.npy")
    img = r.render(tonemap=False)
    assert np.isclose(img, golden, rtol=1e-3, atol=1e-4).mean() > 0.995
