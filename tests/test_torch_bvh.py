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


@pytest.mark.parametrize("kind", ["sphere", "triangle"])
def test_cached_node_table_equals_pack_nodes(request, kind):
    """BVHArrays.nodes, the table the walk kernels read, packed once when
    the arrays are made: bit for bit traverse.pack_nodes of the arrays, also
    after .to() and from_numpy."""
    _, tb = _case(request, kind)["bvh"]
    want = bits(ttraverse.pack_nodes(tb).numpy())
    for arrays in (tb, tb.to("cpu"),
                   tbuilder.BVHArrays.from_numpy(tb.to_numpy())):
        assert arrays.nodes.shape == (tb.num_nodes, 8)
        assert arrays.nodes.is_contiguous()
        np.testing.assert_array_equal(bits(arrays.nodes.numpy()), want)


def _inner_depth(first, count):
    """The most inner nodes on a path from the root (a walk down the
    tree; children come after their parent)."""
    depth = np.zeros(first.shape[0], int)
    depth[0] = int(count[0] == 0)
    for node in range(first.shape[0]):
        if count[node] == 0:
            for c in (first[node], first[node] + 1):
                depth[c] = depth[node] + int(count[c] == 0)
    return int(depth.max())


def _small_tree(m):
    """(BVH, prim order, centers, radii) of `m` seeded spheres at leaf size
    4 (3: the root is a leaf; 7: its children are)."""
    c, r = spheres(m, 40 + m)
    bvh, order = tbuilder.build_bvh(c - r[:, None], c + r[:, None], 4)
    return bvh, order, c, r


def _small_bvh(m):
    return _small_tree(m)[0]


DEEP_LEVELS = 100  # stacks of 99 entries: 50,688 B a 128-thread block


def _deep_tree(levels=DEEP_LEVELS):
    """(BVH, centers, radii) of a tree built by hand with `levels` inner
    nodes on its spine: spine node k's children are spine node k + 1 and
    an inner node over two spheres, the last spine node's two spheres.
    The 2 x levels spheres (radius 1) lie along x at (4i, 0.95, 0.95), so a
    ray near the line y = z = 0 enters every box and meets no sphere: a
    walk over the pair table then keeps levels - 1 rows pending, past the
    48 KB of shared memory a 128-thread block takes by default."""
    first, count = [0], [0]

    def add(f, k):
        first.append(f)
        count.append(k)
        return len(first) - 1

    spine, prims = 0, 0
    for k in range(levels):
        if k < levels - 1:
            nxt = add(0, 0)  # the next spine node
            pair = add(0, 0)  # its sibling, over two spheres
            first[spine], first[pair] = nxt, add(prims, 1)
        else:
            nxt, first[spine] = None, add(prims, 1)
        add(prims + 1, 1)
        prims += 2
        spine = nxt
    n = prims
    c = np.stack([4.0 * np.arange(n), np.full(n, 0.95), np.full(n, 0.95)],
                 1).astype(np.float32)
    r = np.ones(n, np.float32)
    first, count = np.array(first), np.array(count)
    lo = np.zeros((first.shape[0], 3), np.float32)
    hi = np.zeros_like(lo)
    for node in range(first.shape[0] - 1, -1, -1):  # children come after
        f = first[node]
        if count[node]:
            lo[node], hi[node] = c[f] - r[f], c[f] + r[f]
        else:
            lo[node] = np.minimum(lo[f], lo[f + 1])
            hi[node] = np.maximum(hi[f], hi[f + 1])
    miss = tbuilder.compute_miss_links(first, count)
    bvh = tbuilder.BVHArrays(
        node_min=tv(lo), node_max=tv(hi),
        first=torch.from_numpy(first.astype(np.int32)),
        count=torch.from_numpy(count.astype(np.int32)),
        miss=torch.from_numpy(miss), max_leaf=1)
    return bvh, c, r


def _deep_rays(n, seed):
    """(p, d, tfar) for _deep_tree: the first half start before the chain
    near y = z = 0.01 and run along it at slopes below 1e-4 (every box
    entered, no sphere met), the rest from random points of the chain's
    bounds toward random spheres' centers, jittered; tfar finite, +inf, 0
    or NaN."""
    g = np.random.default_rng(seed)
    h = n // 2
    far = 4.0 * 2 * DEEP_LEVELS
    start = g.uniform((-5, -2, -2), (far, 3, 3), (n - h, 3))
    toward = np.stack([4.0 * g.integers(0, 2 * DEEP_LEVELS, n - h),
                       np.full(n - h, 0.95), np.full(n - h, 0.95)], 1)
    p = np.concatenate([
        np.stack([np.full(h, -10.0), g.uniform(0.0, 0.02, h),
                  g.uniform(0.0, 0.02, h)], 1), start])
    d = np.concatenate([
        np.stack([np.ones(h), g.uniform(0, 1e-4, h), g.uniform(0, 1e-4, h)],
                 1), toward + g.normal(0.0, 0.5, (n - h, 3)) - start])
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tf = g.uniform(0.0, 2 * far, n)
    tf[::5] = np.inf
    tf[1::7] = 0.0
    tf[2::11] = np.nan
    return (p.astype(np.float32), d.astype(np.float32),
            torch.from_numpy(tf.astype(np.float32)))


def _bvh_of(request, kind):
    if kind.startswith("small"):
        return _small_bvh(int(kind[len("small"):]))
    if kind == "deep":
        return _deep_tree()[0]
    return _case(request, kind)["bvh"][1]


@pytest.mark.parametrize("kind",
                         ["sphere", "triangle", "small3", "small7", "deep"])
def test_pair_table_equals_node_table(request, kind):
    """BVHArrays.pairs, the child-pair table bvh_occluded reads
    (traverse.pack_pairs): row j belongs to the j-th inner node and holds
    its children first and first + 1, each field bit for bit the child's
    row of the threaded table, but for slot 7: the row of the child's own
    children (-1 for a leaf). stack_depth is the most inner nodes on a
    root path, less one. Both also after .to() and from_numpy."""
    tb = _bvh_of(request, kind)
    nodes = bits(tb.nodes.numpy())
    first, count = tb.first.numpy(), tb.count.numpy()
    inner = np.nonzero(count == 0)[0]
    row_of = np.full(first.shape[0], -1)
    row_of[inner] = np.arange(inner.shape[0])
    for arrays in (tb, tb.to("cpu"),
                   tbuilder.BVHArrays.from_numpy(tb.to_numpy())):
        pairs = bits(arrays.pairs.numpy())
        assert pairs.shape == (inner.shape[0], 16)
        assert arrays.pairs.is_contiguous()
        for side in (0, 1):
            child = first[inner] + side
            half = pairs[:, 8 * side:8 * side + 8]
            np.testing.assert_array_equal(half[:, :7], nodes[child, :7])
            np.testing.assert_array_equal(
                half[:, 7], np.where(count[child] == 0, row_of[child], -1))
        assert arrays.stack_depth == max(_inner_depth(first, count) - 1, 0)
    assert (inner.shape[0] == 0) == (kind == "small3")


def test_edit_rebuilds_the_node_table():
    """A geometry edit of a with_bvh scene (scene/edit.py's
    apply_invalidation, through with_bvh) makes a new BVH, and its node
    table and child-pair table are the new tree's, not the old one's."""
    from cpu_raytracing_experiments_tpu_torch.scene import edit

    scene = taccel.with_bvh(tbuilders.default_scene(16, 16))
    moved, flags = edit.set_sphere(scene, 3, position=(5.0, 5.0, 5.0))
    assert flags.needs_bvh
    bvh = edit.apply_invalidation(moved, flags).sphere_bvh
    assert bvh is not scene.sphere_bvh
    np.testing.assert_array_equal(bits(bvh.nodes.numpy()),
                                  bits(ttraverse.pack_nodes(bvh).numpy()))
    assert not np.array_equal(bits(bvh.nodes.numpy()),
                              bits(scene.sphere_bvh.nodes.numpy()))
    pairs, depth = ttraverse.pack_pairs(bvh, ttraverse.pack_nodes(bvh))
    np.testing.assert_array_equal(bits(bvh.pairs.numpy()),
                                  bits(pairs.numpy()))
    assert bvh.stack_depth == depth
    old = scene.sphere_bvh.pairs
    assert old.shape != bvh.pairs.shape or not np.array_equal(
        bits(old.numpy()), bits(bvh.pairs.numpy()))


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


def pair_walk_model(bvh, p: TVec3, d: TVec3, tfar, rows, row_test):
    """The visit order of the any-hit kernel (csrc/bvh_walk.cu,
    bvh_occluded) over BVHArrays.pairs, lane by lane in lock-step: a lane
    with tfar > 0 tests the root's own box (the threaded table's row 0),
    then at each pair row both children's boxes, a hit leaf's prims at
    once (the first child's leaf first, stopping at the first occluder),
    and takes the first hit inner child, keeping the second on a stack
    (popped when neither is taken). The slab and leaf arithmetic are the
    plain version's (bvh/traverse.py). Returns (occluded [R] bool, the
    most stack entries a lane held, each lane's pair rows visited)."""
    nodes, pairs = bvh.nodes.numpy(), bvh.pairs.numpy()
    m, n = ttraverse._ray_coeffs(p, d)

    def sub(v, idx):
        return TVec3(*(c[idx] for c in v))

    def slab(box, idx):
        t = torch.from_numpy(np.ascontiguousarray(box))
        return ttraverse._slab_from_row(*(t[:, k] for k in range(6)),
                                        sub(m, idx), sub(n, idx),
                                        tfar[idx]).numpy()

    def leaf(fc, idx):
        first, count = fc & ttraverse.FIRST_MASK, fc >> ttraverse.COUNT_SHIFT
        found = np.zeros(idx.shape[0], bool)
        for s in range(int(count.max(initial=0))):
            valid = (s < count) & ~found
            prim = torch.from_numpy(np.where(valid, first + s, 0))
            t, ok = row_test(rows[prim], sub(p, idx), sub(d, idx))
            found |= valid & (ok & (t < tfar[idx]) & (t >= 0.0)).numpy()
        return found

    def fc_of(half):
        return np.ascontiguousarray(half[:, 6]).view(np.uint32).astype(
            np.int64)

    r = tfar.shape[0]
    occ = np.zeros(r, bool)
    visits = np.zeros(r, int)
    live = np.nonzero((tfar > 0.0).numpy())[0]
    root = np.repeat(nodes[:1], live.shape[0], axis=0)
    live = live[slab(root, torch.from_numpy(live))]
    rfc = fc_of(nodes[:1])
    if rfc[0] >> ttraverse.COUNT_SHIFT:
        occ[live] = leaf(np.repeat(rfc, live.shape[0]),
                         torch.from_numpy(live))
        return occ, 0, visits
    cur = np.zeros(r, np.int64)
    stack = np.full((r, max(bvh.stack_depth, 1)), -1, np.int64)
    sp = np.zeros(r, int)
    most = 0
    active = np.zeros(r, bool)
    active[live] = True
    while active.any():
        idx = np.nonzero(active)[0]
        tidx = torch.from_numpy(idx)
        visits[idx] += 1
        row = pairs[cur[idx]]
        a, b = row[:, :8], row[:, 8:]
        hit_a, hit_b = slab(a, tidx), slab(b, tidx)
        fa, fb = fc_of(a), fc_of(b)
        leaf_a = (fa >> ttraverse.COUNT_SHIFT) > 0
        leaf_b = (fb >> ttraverse.COUNT_SHIFT) > 0
        found = np.zeros(idx.shape[0], bool)
        for hit, is_leaf, fc in ((hit_a, leaf_a, fa), (hit_b, leaf_b, fb)):
            k = np.nonzero(hit & is_leaf & ~found)[0]
            found[k] = leaf(fc[k], tidx[k])
        below_a = np.ascontiguousarray(a[:, 7]).view(np.int32)
        below_b = np.ascontiguousarray(b[:, 7]).view(np.int32)
        go_a, go_b = hit_a & ~leaf_a, hit_b & ~leaf_b
        push = go_a & go_b & ~found
        stack[idx[push], sp[idx[push]]] = below_b[push]
        sp[idx[push]] += 1
        most = max(most, int(sp.max()))
        pop = ~go_a & ~go_b & ~found
        done = found | (pop & (sp[idx] == 0))
        popping = pop & ~done
        sp[idx[popping]] -= 1
        nxt = np.where(go_a, below_a, below_b).astype(np.int64)
        nxt[popping] = stack[idx[popping], sp[idx[popping]]]
        cur[idx] = nxt
        occ[idx[found]] = True
        active[idx[done]] = False
    return occ, most, visits


def _shadow_tfar(case, mode, n):
    """The any-hit distances of a test case: 'finite' uniform in (0,
    1.5 x the case's tfar); 'zero', 'inf' and 'nan' put 0, +inf or NaN in
    every third lane of those."""
    g = np.random.default_rng(31)
    tf = g.uniform(0.0, 1.5 * case["tfar"], n).astype(np.float32)
    if mode != "finite":
        tf[::3] = {"zero": 0.0, "inf": np.inf, "nan": np.nan}[mode]
    return tf


@pytest.mark.parametrize("tfar", ["finite", "zero", "inf", "nan"])
@pytest.mark.parametrize("kind", ["sphere", "triangle"])
def test_pair_walk_order_equals_jax(request, kind, tfar):
    """The order argument of bvh_occluded's source note, on the CPU: the
    kernel's visit order over the child-pair table (pair_walk_model, a
    model in this file) gives jitted JAX traverse_shadow_packed's
    occlusion bit in every lane, though it visits the tree in another order
    than the threaded walk and stops elsewhere; among the rays a quarter
    are axis-aligned or have a zero direction component, with zero origin
    components (NaN slabs). The model's stack stays within stack_depth and
    no lane visits more pair rows than the tree has."""
    case = _case(request, kind)
    jb, tb = case["bvh"]
    p, d = case["rays"]
    tf = _shadow_tfar(case, tfar, p.shape[0])
    want = np.asarray(_jax_walk("packed", True, jb, case, jv(p), jv(d),
                                jnp.asarray(tf)))
    got, most, visits = pair_walk_model(tb, tv(p), tv(d),
                                        torch.from_numpy(tf),
                                        case["rows"][1], case["row_test"][1])
    np.testing.assert_array_equal(got, want)
    assert 0.02 < got.mean() < 0.6
    assert 0 < most <= tb.stack_depth
    assert visits.max() <= tb.pairs.shape[0]


@pytest.mark.parametrize("m", [3, 7])
def test_pair_walk_order_on_small_trees(m):
    """pair_walk_model on a tree that is one leaf (3 spheres) and on one
    whose root's children are leaves (7): equal to the plain any-hit walk
    (traverse_shadow_packed), which the test above holds to jitted JAX."""
    tb, order, c, r = _small_tree(m)
    rows = ttraverse.pack_spheres(tv(c[order]),
                                  torch.from_numpy((r * r)[order]))
    p, d = rays(2000, 50 + m, -80, 80)
    tf = torch.from_numpy(_shadow_tfar({"tfar": 60.0}, "nan", 2000))
    got, most, _ = pair_walk_model(tb, tv(p), tv(d), tf, rows,
                                   ttraverse.sphere_row_test)
    want = ttraverse.traverse_shadow_packed(tb, tv(p), tv(d), tf, rows,
                                            ttraverse.sphere_row_test)
    np.testing.assert_array_equal(got, want.numpy())
    assert got.any() and most == 0 == tb.stack_depth


def test_pair_walk_order_on_deep_tree():
    """pair_walk_model on _deep_tree, whose walks keep 99 rows pending (a
    block's stacks past 48 KB, where bvh_occluded raises the card's
    shared-memory limit): equal to the plain any-hit walk, the stack as
    deep as stack_depth says and no deeper."""
    tb, c, r = _deep_tree()
    rows = ttraverse.pack_spheres(tv(c), torch.from_numpy(r * r))
    p, d, tf = _deep_rays(1000, 61)
    got, most, _ = pair_walk_model(tb, tv(p), tv(d), tf, rows,
                                   ttraverse.sphere_row_test)
    want = ttraverse.traverse_shadow_packed(tb, tv(p), tv(d), tf, rows,
                                            ttraverse.sphere_row_test)
    np.testing.assert_array_equal(got, want.numpy())
    assert 0.05 < got.mean() < 0.95
    assert most == tb.stack_depth == DEEP_LEVELS - 1
    assert tb.stack_depth * 128 * 4 > 48 * 1024


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
    their plain versions bit for bit (tfar bits, ids, occlusion); the
    any-hit walk at every distance mix of test_pair_walk_order_equals_jax
    (finite, with 0, +inf or NaN lanes)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU form")
    case = _case(request, kind)
    tb = case["bvh"][1].to("cuda")
    rows = case["rows"][1].to("cuda")
    p, d = (tv(a).to("cuda") for a in case["rays"])
    kt, kid = bvh_walk.closest(tb, p, d, rows)
    pt, pid = ttraverse.traverse_closest_packed(tb, p, d, rows,
                                                bvh_walk.ROW_TESTS[
                                                    rows.shape[1]])
    assert torch.equal(kid, pid)
    assert torch.equal(kt.view(torch.int32), pt.view(torch.int32))
    for mode in ("finite", "zero", "inf", "nan"):
        tf = torch.from_numpy(_shadow_tfar(case, mode, p.x.shape[0])).to(
            "cuda")
        want = ttraverse.traverse_shadow_packed(
            tb, p, d, tf, rows, bvh_walk.ROW_TESTS[rows.shape[1]])
        assert torch.equal(bvh_walk.occluded(tb, p, d, tf, rows), want)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["small3", "small7", "deep"])
def test_occluded_on_small_and_deep_trees_on_card(kind):
    """bvh_occluded on a card equals the plain any-hit walk on a tree that
    is one leaf (the pair table empty), on one whose root's children are
    leaves, and on _deep_tree, whose stacks pass 48 KB a block."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU form")
    if kind == "deep":
        tb, c, r = _deep_tree()
        p, d, tf = _deep_rays(4096, 62)
    else:
        m = int(kind[len("small"):])
        tb, order, c, r = _small_tree(m)
        c, r = c[order], r[order]
        p, d = rays(4096, 50 + m, -80, 80)
        tf = torch.from_numpy(_shadow_tfar({"tfar": 60.0}, "nan", 4096))
    rows = ttraverse.pack_spheres(tv(c), torch.from_numpy(r * r))
    want = ttraverse.traverse_shadow_packed(tb, tv(p), tv(d), tf, rows,
                                            ttraverse.sphere_row_test)
    got = bvh_walk.occluded(tb.to("cuda"), tv(p).to("cuda"),
                            tv(d).to("cuda"), tf.to("cuda"), rows.to("cuda"))
    assert want.any() and torch.equal(got.cpu(), want)
