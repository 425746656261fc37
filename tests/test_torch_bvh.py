"""The PyTorch port's threaded BVH (``bvh/builder.py``, ``bvh/traverse.py``,
``scene/accel.py::with_bvh``) against the JAX package's, on the CPU.

The builds give the JAX package's arrays exactly (both take the native
full-sweep SAH builder), and every walk gives jitted JAX's tfar bits, prim
ids and occlusion bits exactly, on seeded rays among which a quarter are
exactly axis-aligned or have an exact zero in the origin (1/d is inf there,
and n = p/d may be NaN, which XLA's minimum / maximum propagate). The
``cuda`` test holds the kernels of ``ops/kernels/bvh_walk.py`` to these
plain forms on a card."""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from cpu_raytracing_experiments_tpu.bvh import builder as jbuilder
from cpu_raytracing_experiments_tpu.bvh import traverse as jtraverse
from cpu_raytracing_experiments_tpu.core.vec import Vec3 as JVec3
from cpu_raytracing_experiments_tpu.scene import accel as jaccel
from cpu_raytracing_experiments_tpu.scene import builders as jbuilders
from cpu_raytracing_experiments_tpu_torch.bvh import builder as tbuilder
from cpu_raytracing_experiments_tpu_torch.bvh import traverse as ttraverse
from cpu_raytracing_experiments_tpu_torch.core.vec import Vec3 as TVec3
from cpu_raytracing_experiments_tpu_torch.ops.kernels import bvh_walk
from cpu_raytracing_experiments_tpu_torch.scene import accel as taccel
from cpu_raytracing_experiments_tpu_torch.scene import builders as tbuilders

from test_torch_scene import _assert_same_arrays, jax_scene_to_numpy

torch.set_num_threads(1)

FLT_MAX = np.float32(3.4028235e38)


def rays(n, seed, lo, hi):
    """(p, d) [n, 3] float32: uniform origins in [lo, hi)^3 and unit
    directions; the first eighth exactly axis-aligned (half of those with
    x = 0 in the origin), the next eighth with one direction component an
    exact zero (half of those with y = 0 in the origin)."""
    g = np.random.default_rng(seed)
    p = g.uniform(lo, hi, (n, 3)).astype(np.float32)
    d = g.normal(size=(n, 3)).astype(np.float32)
    k = n // 8
    d[:k] = 0.0
    d[np.arange(k), g.integers(0, 3, k)] = g.choice([-1.0, 1.0], k)
    d[np.arange(k, 2 * k), g.integers(0, 3, k)] = 0.0
    d[k:] /= np.linalg.norm(d[k:], axis=1, keepdims=True)
    p[:k // 2, 0] = 0.0
    p[k:k + k // 2, 1] = 0.0
    return p, d.astype(np.float32)


def jv(a):
    return JVec3(*(jnp.asarray(a[:, k]) for k in range(3)))


def tv(a):
    return TVec3(*(torch.from_numpy(np.ascontiguousarray(a[:, k]))
                   for k in range(3)))


def bits(a):
    return np.asarray(a).view(np.int32)


def spheres(m, seed):
    g = np.random.default_rng(seed)
    c = g.uniform(-50, 50, (m, 3)).astype(np.float32)
    r = g.uniform(0.3, 5.0, m).astype(np.float32)
    return c, r


def triangles(m, seed):
    g = np.random.default_rng(seed)
    v0 = g.uniform(-20, 20, (m, 3)).astype(np.float32)
    v1 = v0 + g.uniform(-4, 4, (m, 3)).astype(np.float32)
    v2 = v0 + g.uniform(-4, 4, (m, 3)).astype(np.float32)
    return v0, v1, v2


@pytest.fixture(scope="module")
def sphere_case():
    """300 spheres and their BVHs in both packages, prims in leaf order."""
    c, r = spheres(300, 1)
    jb, order = jbuilder.build_bvh(c - r[:, None], c + r[:, None], 4)
    tb, torder = tbuilder.build_bvh(c - r[:, None], c + r[:, None], 4)
    c, rsq = c[order], (r * r)[order]
    return {"order": (order, torder), "bvh": (jb, tb),
            "rows": (jtraverse.pack_spheres(jv(c), jnp.asarray(rsq)),
                     ttraverse.pack_spheres(tv(c), torch.from_numpy(rsq))),
            "leaf": (jtraverse.sphere_leaf_test(jv(c), jnp.asarray(rsq)),
                     ttraverse.sphere_leaf_test(tv(c), torch.from_numpy(rsq))),
            "row_test": (jtraverse.sphere_row_test,
                         ttraverse.sphere_row_test),
            "rays": rays(4000, 2, -80, 80), "tfar": 60.0}


@pytest.fixture(scope="module")
def triangle_case():
    """400 triangles and their BVHs in both packages, in leaf order."""
    v0, v1, v2 = triangles(400, 12)
    mins, maxs = jbuilder.triangle_bounds(v0, v1, v2)
    jb, order = jbuilder.build_bvh(mins, maxs, 4)
    tb, torder = tbuilder.build_bvh(mins, maxs, 4)
    v0, e1, e2 = v0[order], (v1 - v0)[order], (v2 - v0)[order]
    return {"order": (order, torder), "bvh": (jb, tb),
            "rows": (jtraverse.pack_triangles(jv(v0), jv(e1), jv(e2)),
                     ttraverse.pack_triangles(tv(v0), tv(e1), tv(e2))),
            "leaf": (jtraverse.triangle_leaf_test(jv(v0), jv(e1), jv(e2)),
                     ttraverse.triangle_leaf_test(tv(v0), tv(e1), tv(e2))),
            "row_test": (jtraverse.triangle_row_test,
                         ttraverse.triangle_row_test),
            "rays": rays(4000, 3, -30, 30), "tfar": 25.0}


def _case(request, kind):
    return request.getfixturevalue(f"{kind}_case")


def _same_bvh(jb, tb):
    want = {"node_min": np.stack([np.asarray(c) for c in jb.node_min], 1),
            "node_max": np.stack([np.asarray(c) for c in jb.node_max], 1),
            "first": np.asarray(jb.first), "count": np.asarray(jb.count),
            "miss": np.asarray(jb.miss), "max_leaf": jb.max_leaf}
    _assert_same_arrays(tb.to_numpy(), want)


@pytest.mark.parametrize("kind", ["sphere", "triangle"])
def test_build_bvh_equals_jax(request, kind):
    """bvh/builder.py::build_bvh and compute_miss_links: nodes, miss links,
    max_leaf and the prim order equal to the JAX package's; the thread
    visits every node once and the leaves partition the prims (after
    tests/test_bvh.py::test_bvh_structure)."""
    case = _case(request, kind)
    jb, tb = case["bvh"]
    _same_bvh(jb, tb)
    order, torder = case["order"]
    np.testing.assert_array_equal(order, torder)
    first, count = tb.first.numpy(), tb.count.numpy()
    np.testing.assert_array_equal(
        tbuilder.compute_miss_links(first, count),
        jbuilder.compute_miss_links(first, count))
    seen, cur = set(), 0
    while cur != -1:
        assert cur not in seen
        seen.add(cur)
        cur = int(first[cur]) if count[cur] == 0 else int(tb.miss[cur])
    assert len(seen) == tb.num_nodes
    covered = np.zeros(order.shape[0], int)
    for f, c in zip(first[count > 0], count[count > 0]):
        covered[f:f + c] += 1
    assert (covered == 1).all()


@pytest.mark.parametrize("name", ["bvh_test_scene", "cornell_box_scene"])
def test_with_bvh_equals_jax(name):
    """scene/accel.py::with_bvh: the reordered spheres and triangles, the
    remapped lights / tri_lights and both BVHs equal the JAX package's
    arrays (Scene.to_numpy against the flattened JAX scene)."""
    want = jax_scene_to_numpy(jaccel.with_bvh(getattr(jbuilders, name)(16,
                                                                       16)))
    got = taccel.with_bvh(getattr(tbuilders, name)(16, 16)).to_numpy()
    _assert_same_arrays(got, want)


@pytest.mark.parametrize("kind", ["sphere", "triangle"])
def test_pack_nodes_equals_jax(request, kind):
    """bvh/traverse.py::pack_nodes, bit for bit (first | count << 27 and the
    miss link bitcast into float32 slots), and _unpack_row's round trip."""
    jb, tb = _case(request, kind)["bvh"]
    got = ttraverse.pack_nodes(tb)
    np.testing.assert_array_equal(bits(got.numpy()),
                                  bits(jtraverse.pack_nodes(jb)))
    *_, first, count, miss = ttraverse._unpack_row(got)
    assert torch.equal(first, tb.first) and torch.equal(count, tb.count)
    assert torch.equal(miss, tb.miss)


def _jax_walk(form, shadow, jb, case, p, d, tf):
    """The JAX package's walk `form` ('scalar' or 'packed'), jitted."""
    rows, leaf, row_test = case["rows"][0], case["leaf"][0], \
        case["row_test"][0]
    if form == "scalar":
        fn = (lambda b, p, d, t: jtraverse.traverse_shadow(b, p, d, t, leaf)
              ) if shadow else (lambda b, p, d, t: jtraverse.traverse_closest(
                  b, p, d, leaf, tfar0=t))
    else:
        fn = (lambda b, p, d, t: jtraverse.traverse_shadow_packed(
            b, p, d, t, rows, row_test)) if shadow else (
            lambda b, p, d, t: jtraverse.traverse_closest_packed(
                b, p, d, rows, row_test, tfar0=t))
    return jax.jit(fn)(jb, p, d, tf)


def _port_walk(form, shadow, tb, case, p, d, tf):
    rows, leaf, row_test = case["rows"][1], case["leaf"][1], \
        case["row_test"][1]
    if form == "scalar":
        if shadow:
            return ttraverse.traverse_shadow(tb, p, d, tf, leaf)
        return ttraverse.traverse_closest(tb, p, d, leaf, tfar0=tf)
    if shadow:
        return ttraverse.traverse_shadow_packed(tb, p, d, tf, rows, row_test)
    return ttraverse.traverse_closest_packed(tb, p, d, rows, row_test,
                                             tfar0=tf)


@pytest.mark.parametrize("shadow", [False, True], ids=["closest", "shadow"])
@pytest.mark.parametrize("form", ["scalar", "packed"])
@pytest.mark.parametrize("kind", ["sphere", "triangle"])
def test_walks_bit_equal_jax(request, kind, form, shadow):
    """traverse_closest / traverse_shadow (one gathered prim per ray) and
    traverse_closest_packed / traverse_shadow_packed (node and leaf rows)
    against jitted JAX (bvh/traverse.py): tfar bits and prim ids, or
    occlusion bits, exactly equal. Closest walks start from a tfar0 of
    FLT_MAX with every fifth lane at 20; shadow walks take a fixed tfar with
    every seventh lane disabled (tfar = 0)."""
    case = _case(request, kind)
    jb, tb = case["bvh"]
    p, d = case["rays"]
    tf = np.full(p.shape[0], FLT_MAX, np.float32)
    tf[::5] = 20.0
    if shadow:
        tf = np.full(p.shape[0], case["tfar"], np.float32)
        tf[::7] = 0.0
    want = _jax_walk(form, shadow, jb, case, jv(p), jv(d), jnp.asarray(tf))
    got = _port_walk(form, shadow, tb, case, tv(p), tv(d),
                     torch.from_numpy(tf))
    if shadow:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert 0.02 < got.float().mean() < 0.5
        return
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(bits(got[0].numpy()), bits(want[0]))
    assert 0.02 < (got[1] >= 0).float().mean() < 0.5


def test_slab_test_and_ray_coeffs_bit_equal_jax(sphere_case):
    """_ray_coeffs (m = 1/d, n = p * m: inf and NaN on axis-aligned rays)
    and _slab_test on random nodes against jitted JAX: m and n bit for bit
    (NaN where JAX has NaN), the hit bits exactly."""
    jb, tb = sphere_case["bvh"]
    p, d = sphere_case["rays"]
    g = np.random.default_rng(21)
    node = g.integers(0, tb.num_nodes, p.shape[0]).astype(np.int32)
    tf = g.uniform(0.0, 200.0, p.shape[0]).astype(np.float32)

    def jax_slab(b, node, p, d, tf):
        m, n = jtraverse._ray_coeffs(p, d)
        return m, n, jtraverse._slab_test(b, node, m, n, tf)

    jm, jn, jhit = jax.jit(jax_slab)(jb, jnp.asarray(node), jv(p), jv(d),
                                     jnp.asarray(tf))
    m, n = ttraverse._ray_coeffs(tv(p), tv(d))
    hit = ttraverse._slab_test(tb, torch.from_numpy(node), m, n,
                               torch.from_numpy(tf))
    for a, b in zip((*m, *n), (*jm, *jn)):
        np.testing.assert_array_equal(bits(a.numpy()), bits(b))
    assert np.isnan(np.asarray(jn.x)).any()
    np.testing.assert_array_equal(hit.numpy(), np.asarray(jhit))
    assert 0.01 < hit.float().mean() < 0.99


@pytest.mark.parametrize("kind", ["sphere", "triangle"])
def test_with_stats_steps_equal_jax(request, kind):
    """traverse_closest_packed(with_stats=True): the lock-step loop's trip
    count (the worst ray's node visits) equals the JAX package's."""
    case = _case(request, kind)
    jb, tb = case["bvh"]
    p, d = case["rays"]
    want = jax.jit(lambda b, p, d: jtraverse.traverse_closest_packed(
        b, p, d, case["rows"][0], case["row_test"][0], with_stats=True))(
        jb, jv(p), jv(d))
    got = ttraverse.traverse_closest_packed(
        tb, tv(p), tv(d), case["rows"][1], case["row_test"][1],
        with_stats=True)
    assert got[2] == int(want[2]) > 1
    np.testing.assert_array_equal(bits(got[0].numpy()), bits(want[0]))


def test_wrappers_take_the_plain_version_on_the_cpu(sphere_case):
    """ops/kernels/bvh_walk.py: CPU tensors take the plain walks and launch
    nothing; a tensor on neither the CPU nor a card raises."""
    _, tb = sphere_case["bvh"]
    rows = sphere_case["rows"][1]
    p, d = (tv(a) for a in sphere_case["rays"])
    tf = torch.full((p.x.shape[0],), 60.0)
    bvh_walk.CLOSEST.launches = bvh_walk.OCCLUDED.launches = 0
    got = bvh_walk.closest(tb, p, d, rows)
    want = ttraverse.traverse_closest_packed(tb, p, d, rows,
                                             ttraverse.sphere_row_test)
    assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])
    assert torch.equal(bvh_walk.occluded(tb, p, d, tf, rows),
                       ttraverse.traverse_shadow_packed(
                           tb, p, d, tf, rows, ttraverse.sphere_row_test))
    assert bvh_walk.CLOSEST.launches == bvh_walk.OCCLUDED.launches == 0
    meta = TVec3(*(torch.empty(4, device="meta") for _ in range(3)))
    with pytest.raises(ValueError):
        bvh_walk.closest(tb, meta, meta, rows.to("meta"))
    with pytest.raises(ValueError):
        bvh_walk.occluded(tb, meta, meta, torch.empty(4, device="meta"),
                          rows.to("meta"))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["sphere", "triangle"])
def test_kernels_match_plain_on_card(request, kind):
    """csrc/bvh_walk.cu on a CUDA card: bvh_closest and bvh_occluded equal
    their plain versions bit for bit (tfar bits, ids, occlusion)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU form")
    case = _case(request, kind)
    tb = case["bvh"][1].to("cuda")
    rows = case["rows"][1].to("cuda")
    p, d = (tv(a).to("cuda") for a in case["rays"])
    tf = torch.full((p.x.shape[0],), case["tfar"], device="cuda")
    kt, kid = bvh_walk.closest(tb, p, d, rows)
    pt, pid = ttraverse.traverse_closest_packed(tb, p, d, rows,
                                                bvh_walk.ROW_TESTS[
                                                    rows.shape[1]])
    assert torch.equal(kid, pid)
    assert torch.equal(kt.view(torch.int32), pt.view(torch.int32))
    assert torch.equal(
        bvh_walk.occluded(tb, p, d, tf, rows),
        ttraverse.traverse_shadow_packed(tb, p, d, tf, rows,
                                         bvh_walk.ROW_TESTS[rows.shape[1]]))
