"""The PyTorch port's clustered traversal (``ops/kernels/cluster_traverse.py``)
against the JAX package's ``ops/pallas/traverse_kernel.py``, on the CPU.

The same numpy-seeded rays and the same cluster tables go through the JAX
wrappers (Pallas in interpret mode, under ``jax.jit``) and through the
port's plain versions, at a small size: 400 spheres or triangles,
``cluster_size=32``, ``tile_r=64``. Tolerance: equal bits, for the planner's
lists below ``nvis``, for both sphere walks and for both triangle walks, and
for the streamed walks (``stream=True``, 128 prims a cluster). The
product-form triangle battery (``mxu=True``) rounds differently from the JAX
package's matrix product: equal ids, t within rtol 1e-5 / atol 1e-6, the
JAX package's own bar for it. The CUDA kernels are held to the same plain
versions on the card by ``chip_smoke.py``; the tests that launch them here
need a card.
"""
import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from cpu_raytracing_experiments_tpu.bvh import builder as jbvh
from cpu_raytracing_experiments_tpu.core.vec import Vec3 as JVec3
from cpu_raytracing_experiments_tpu.ops import clustered as jcl
from cpu_raytracing_experiments_tpu.ops import intersect as jint
from cpu_raytracing_experiments_tpu.ops.pallas import traverse_kernel as jtk
from cpu_raytracing_experiments_tpu.scene import accel as jaccel
from cpu_raytracing_experiments_tpu.scene import builders as jbuilders
from cpu_raytracing_experiments_tpu_torch.core.vec import Vec3 as TVec3
from cpu_raytracing_experiments_tpu_torch.ops import clustered as tcl
from cpu_raytracing_experiments_tpu_torch.ops import intersect as tint
from cpu_raytracing_experiments_tpu_torch.ops.kernels import \
    cluster_traverse as ttk
from cpu_raytracing_experiments_tpu_torch.ops.kernels import \
    sphere_battery as tsb

from test_torch_scene import jax_clusters_to_numpy

# The suite runs in several worker processes at once: one intra-op thread
# each, or the workers' thread pools fight over the cores.
torch.set_num_threads(1)

TILE_R = 64
K = 32
N_PRIMS = 400
FLT_MAX = np.float32(3.4028235e38)


def _packs(kind, n_prims=N_PRIMS, k=K):
    g = np.random.default_rng(11)
    if kind == "sphere":
        centers = g.uniform(-6, 6, (n_prims, 3)).astype(np.float32)
        radii = g.uniform(0.1, 0.7, n_prims).astype(np.float32)
        rows = np.concatenate([centers, (radii ** 2)[:, None]], axis=1)
        mins, maxs = jbvh.sphere_bounds(centers, radii)
    else:
        v0 = g.uniform(-6, 6, (n_prims, 3)).astype(np.float32)
        e1 = g.normal(0, 0.9, (n_prims, 3)).astype(np.float32)
        e2 = g.normal(0, 0.9, (n_prims, 3)).astype(np.float32)
        rows = np.concatenate([v0, e1, e2], axis=1)
        mins, maxs = jbvh.triangle_bounds(v0, v0 + e1, v0 + e2)
    jcp = jcl.build_clusters_sah(mins, maxs, rows, cluster_size=k, kind=kind)
    tcp = tcl.ClusteredPrims.from_numpy(jax_clusters_to_numpy(jcp))
    return jcp, tcp, rows


@pytest.fixture(scope="module")
def spheres():
    return _packs("sphere")


@pytest.fixture(scope="module")
def triangles():
    return _packs("triangle")


def _rays(n, seed, coherent=False):
    """Seeded rays as numpy [n, 3] origins and unit directions: scattered,
    or camera-like (one origin, a narrow fan)."""
    g = np.random.default_rng(seed)
    if coherent:
        p = np.tile(np.array([[0.5, 1.0, 14.0]], np.float32), (n, 1))
        d = np.stack([g.uniform(-0.4, 0.4, n), g.uniform(-0.4, 0.4, n),
                      -np.ones(n)], axis=1)
    else:
        p = g.uniform(-9, 9, (n, 3)).astype(np.float32)
        d = g.normal(size=(n, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    return p.astype(np.float32), d


def _jv(a):
    return JVec3(*(jnp.asarray(a[:, i]) for i in range(3)))


def _tv(a):
    return TVec3(*(torch.from_numpy(np.ascontiguousarray(a[:, i]))
                   for i in range(3)))


def _bits(a):
    return np.asarray(a, np.float32).view(np.int32)


@pytest.mark.parametrize("case", ["scattered", "camera", "on_box_faces"])
def test_plan_visits_matches_jax(spheres, case):
    """_plan_visits (the flat 'ray' plan, sorted in the kernel): nvis equal,
    and below nvis the cluster ids and the entry distances equal. The
    'on_box_faces' rays have a zero direction component and start on a face
    of a cluster box: 0 * inf = NaN in the slab test, which jnp.minimum /
    maximum propagate, so such a ray does not enter that box in either
    package."""
    jcp, tcp, _ = spheres
    n = 500
    p, d = _rays(n, 21, coherent=(case == "camera"))
    g = np.random.default_rng(22)
    tf = g.uniform(0.5, 25.0, n).astype(np.float32)
    tf[g.random(n) < 0.2] = FLT_MAX
    valid = g.random(n) < 0.7
    if case == "on_box_faces":
        lo = np.stack([np.asarray(c) for c in jcp.lo], axis=1)
        hi = np.stack([np.asarray(c) for c in jcp.hi], axis=1)
        for i in range(0, n, 2):
            c, axis = i % jcp.num_clusters, (i // 2) % 3
            p[i] = 0.5 * (lo[c] + hi[c])
            p[i, axis] = (lo if i % 4 else hi)[c, axis]
            d[i, axis] = 0.0
            d[i] /= np.linalg.norm(d[i])
        valid[:] = True
    tf = np.where(valid, tf, np.float32(0.0))
    t_tiles = -(-(-(-n // TILE_R)) // 8) * 8
    ray_in = jtk._ray_cols(
        [(jnp.asarray(p[:, 0]), 1e30), (jnp.asarray(p[:, 1]), 1e30),
         (jnp.asarray(p[:, 2]), 1e30), (jnp.asarray(d[:, 0]), 1.0),
         (jnp.asarray(d[:, 1]), 1.0), (jnp.asarray(d[:, 2]), 1.0),
         (jnp.asarray(tf), 0.0), (jnp.asarray(valid, jnp.float32), 0.0)],
        t_tiles * TILE_R)
    want_v, want_e, want_n = jax.jit(
        lambda cp, rays: jtk._plan_visits(cp, rays, t_tiles, TILE_R, True,
                                          True))(jcp, ray_in)
    got_v, got_e, got_n = ttk._plan_visits(
        tcp, _tv(p), _tv(d), torch.from_numpy(tf), torch.from_numpy(valid),
        TILE_R)
    tiles = got_n.shape[0]
    assert tiles == -(-n // TILE_R)
    want_n = np.asarray(want_n)[:, 0]
    np.testing.assert_array_equal(got_n.numpy(), want_n[:tiles])
    assert (want_n[tiles:] == 0).all() and want_n.sum() > 0
    for t in range(tiles):
        m = want_n[t]
        np.testing.assert_array_equal(got_v[t, :m].numpy(),
                                      np.asarray(want_v)[t, :m])
        np.testing.assert_array_equal(got_e[t, :m].numpy(),
                                      np.asarray(want_e)[t, :m])
        assert (got_e[t, m:].numpy() == FLT_MAX).all()


@pytest.mark.parametrize("seeded", [False, True])
def test_closest_matches_jax(spheres, seeded):
    """intersect_clustered_pallas: tfar bit-equal and ids equal, without and
    with a tfar0 seed and an alive mask (dead lanes return (tfar0, -1))."""
    jcp, tcp, _ = spheres
    n = 500
    p, d = _rays(n, 31)
    kw_j, kw_t = {}, {}
    if seeded:
        g = np.random.default_rng(32)
        tf0 = g.uniform(0.5, 12.0, n).astype(np.float32)
        tf0[g.random(n) < 0.3] = FLT_MAX
        alive = g.random(n) < 0.6
        kw_j = {"tfar0": jnp.asarray(tf0), "alive": jnp.asarray(alive)}
        kw_t = {"tfar0": torch.from_numpy(tf0),
                "alive": torch.from_numpy(alive)}
    want_t, want_id = jtk.intersect_clustered_pallas(
        jcp, _jv(p), _jv(d), tile_r=TILE_R, interpret=True, **kw_j)
    got_t, got_id = ttk.intersect_clustered_pallas(
        tcp, _tv(p), _tv(d), tile_r=TILE_R, **kw_t)
    np.testing.assert_array_equal(got_id.numpy(), np.asarray(want_id))
    np.testing.assert_array_equal(_bits(got_t.numpy()), _bits(want_t))
    assert (got_id.numpy() >= 0).sum() > 50
    if seeded:
        assert (got_id.numpy()[~alive] == -1).all()
        np.testing.assert_array_equal(got_t.numpy()[~alive], tf0[~alive])


def test_shadow_matches_jax(spheres):
    """occluded_clustered_pallas with lanes at tfar = 0, < 0 and FLT_MAX."""
    jcp, tcp, _ = spheres
    n = 500
    p, d = _rays(n, 41)
    g = np.random.default_rng(42)
    tf = g.uniform(0.5, 20.0, n).astype(np.float32)
    tf[g.random(n) < 0.2] = 0.0
    tf[g.random(n) < 0.1] = -1.0
    tf[g.random(n) < 0.1] = FLT_MAX
    want = jtk.occluded_clustered_pallas(jcp, _jv(p), _jv(d), jnp.asarray(tf),
                                         tile_r=TILE_R, interpret=True)
    got = ttk.occluded_clustered_pallas(tcp, _tv(p), _tv(d),
                                        torch.from_numpy(tf), tile_r=TILE_R)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.any() and not got.numpy()[tf <= 0].any()


def test_compact_wrappers_match_jax(spheres):
    """Both _compact wrappers (rays regrouped by coherence_order, results
    scattered back), with seg_len 128: equal bits."""
    jcp, tcp, _ = spheres
    n = 300
    p, d = _rays(n, 51)
    g = np.random.default_rng(52)
    alive = g.random(n) < 0.5
    tf = np.where(g.random(n) < 0.3, 0.0,
                  g.uniform(0.5, 20.0, n)).astype(np.float32)
    want_t, want_id = jtk.intersect_clustered_pallas_compact(
        jcp, _jv(p), _jv(d), jnp.asarray(alive), tile_r=TILE_R,
        interpret=True, seg_len=128)
    got_t, got_id = ttk.intersect_clustered_pallas_compact(
        tcp, _tv(p), _tv(d), torch.from_numpy(alive), tile_r=TILE_R,
        seg_len=128)
    np.testing.assert_array_equal(got_id.numpy(), np.asarray(want_id))
    np.testing.assert_array_equal(_bits(got_t.numpy()), _bits(want_t))
    want = jtk.occluded_clustered_pallas_compact(
        jcp, _jv(p), _jv(d), jnp.asarray(tf), tile_r=TILE_R, interpret=True,
        seg_len=128)
    got = ttk.occluded_clustered_pallas_compact(
        tcp, _tv(p), _tv(d), torch.from_numpy(tf), tile_r=TILE_R, seg_len=128)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_coherence_and_compact_order_match_jax():
    """coherence_order and compact_order: the same permutations."""
    g = np.random.default_rng(61)
    n = 1000
    alive = g.random(n) < 0.4
    _, d = _rays(n, 62)
    for seg in (128, 2048):
        want = jtk.coherence_order(jnp.asarray(alive), _jv(d), seg)
        got = ttk.coherence_order(torch.from_numpy(alive), _tv(d), seg)
        assert got[2] == want[2]
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    want = jtk.compact_order(jnp.asarray(alive))
    got = ttk.compact_order(torch.from_numpy(alive))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


def test_triangle_batteries_match_jax(triangles):
    """The walks over a triangle table (Baldwin-Weber planes): the closest
    walk seeded with tfar0, and the any-hit walk; equal bits."""
    jcp, tcp, _ = triangles
    n = 400
    p, d = _rays(n, 71)
    g = np.random.default_rng(72)
    tf0 = np.where(g.random(n) < 0.5, FLT_MAX,
                   g.uniform(2.0, 15.0, n)).astype(np.float32)
    want_t, want_id = jtk.intersect_clustered_pallas(
        jcp, _jv(p), _jv(d), tfar0=jnp.asarray(tf0), tile_r=TILE_R,
        interpret=True)
    got_t, got_id = ttk.intersect_clustered_pallas(
        tcp, _tv(p), _tv(d), tfar0=torch.from_numpy(tf0), tile_r=TILE_R)
    np.testing.assert_array_equal(got_id.numpy(), np.asarray(want_id))
    np.testing.assert_array_equal(_bits(got_t.numpy()), _bits(want_t))
    assert (got_id.numpy() >= 0).sum() > 30
    tf = np.where(g.random(n) < 0.2, 0.0,
                  g.uniform(0.5, 20.0, n)).astype(np.float32)
    want = jtk.occluded_clustered_pallas(jcp, _jv(p), _jv(d), jnp.asarray(tf),
                                         tile_r=TILE_R, interpret=True)
    got = ttk.occluded_clustered_pallas(tcp, _tv(p), _tv(d),
                                        torch.from_numpy(tf), tile_r=TILE_R)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.any()


@pytest.mark.parametrize("tile_r", [32, 64, 256])
def test_clustered_equals_brute_in_port(spheres, tile_r):
    """Within the port, the clustered walks agree with the dense batteries
    on the same spheres: equal tfar bits, equal ids, equal occlusion (these
    tables hold no two spheres a ray hits at the same distance), whatever
    the tile width; padding slots (order = -1) never win."""
    _, tcp, rows = spheres
    n = 700
    p, d = _rays(n, 81)
    center = _tv(rows[:, :3])
    radius_sq = torch.from_numpy(np.ascontiguousarray(rows[:, 3]))
    want_t, want_id = tsb.intersect_spheres(_tv(p), _tv(d), center, radius_sq)
    got_t, got_id = ttk.intersect_clustered_pallas(tcp, _tv(p), _tv(d),
                                                   tile_r=tile_r)
    hit = want_id.numpy() >= 0
    np.testing.assert_array_equal(got_id.numpy(), want_id.numpy())
    np.testing.assert_array_equal(_bits(got_t.numpy())[hit],
                                  _bits(want_t.numpy())[hit])
    tf = torch.where(torch.arange(n) % 2 == 0, want_t * 0.999,
                     torch.full_like(want_t, 7.0))
    np.testing.assert_array_equal(
        ttk.occluded_clustered_pallas(tcp, _tv(p), _tv(d), tf,
                                      tile_r=tile_r).numpy(),
        tsb.occluded_spheres(_tv(p), _tv(d), tf, center, radius_sq).numpy())


def test_walk_stats_and_table_bytes(spheres):
    """The plain closest walk counts its (tile, cluster) visits and (ray,
    prim) pairs, and early exit walks fewer than the plan lists;
    table_bytes and tile_r='auto' follow the JAX package."""
    from cpu_raytracing_experiments_tpu.ops import intersect as jint

    jcp, tcp, rows = spheres
    n = 512
    # each tile's rays aim at one sphere from 30 units off: every lane hits,
    # so the exit bound drops and the walk stops before the list ends
    g = np.random.default_rng(91)
    target = rows[np.repeat(g.integers(0, N_PRIMS, n // TILE_R), TILE_R), :3]
    p = (target + np.array([0.0, 0.0, 30.0])).astype(np.float32)
    d = np.array([0.0, 0.0, -1.0]) + g.normal(0, 1e-3, (n, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    tf0 = torch.full((n,), float(FLT_MAX))
    valid = torch.ones(n, dtype=torch.bool)
    plan = ttk._plan_visits(tcp, _tv(p), _tv(d), tf0, valid, TILE_R)
    stats = {}
    ttk.walk_closest_plain(tcp, *plan, _tv(p), _tv(d), tf0, valid, TILE_R,
                           stats=stats)
    assert 0 < stats["visits"] < int(plan[2].sum())
    # every lane is valid; the SAH clusters are partly filled, and the
    # padding slots are no pairs
    filled = (tcp.order.reshape(-1, K) >= 0).sum(dim=1)
    assert int(filled.min()) < K
    assert stats["pairs"] % TILE_R == 0
    assert (stats["visits"] * TILE_R * int(filled.min()) <= stats["pairs"]
            < stats["visits"] * TILE_R * K)
    assert ttk.table_bytes(tcp) == jtk.table_bytes(jcp)
    assert tint.PALLAS_MIN_PRIMS == jint.PALLAS_MIN_PRIMS
    for auto in ({"tile_r": "auto"}, {"tile_r": 64}):
        assert (tint._tile_for(auto, tcp)["tile_r"]
                == jint._tile_for(dict(auto), jcp)["tile_r"])


def test_walk_stats_count_real_prims():
    """The pairs a walk needs, on one cluster of three spheres in four
    slots: the closest walk tests every valid ray against the three prims,
    never the padding slot; the any-hit walk tests a lane up to and
    including its first occluder, and a lane with tfar <= 0 not at all."""
    centers = np.array([[0, 0, 0], [0, 0, -3], [0, 0, -6]], np.float32)
    radii = np.ones(3, np.float32)
    rows = np.concatenate([centers, (radii ** 2)[:, None]], axis=1)
    cp = tcl.build_clusters(*jbvh.sphere_bounds(centers, radii), rows,
                            num_clusters=1, kind="sphere")
    assert cp.cluster_size == 4 and int((cp.order >= 0).sum()) == 3
    slot_of = {int(prim): s for s, prim in enumerate(cp.order) if prim >= 0}
    # down the axis through all three; the same, reaching only sphere 0;
    # through the box beside the spheres; and a lane with tfar = 0
    p = np.array([[0, 0, 10], [0, 0, 10], [0.95, 0.95, 10], [0, 0, 10]],
                 np.float32)
    d = np.tile(np.array([[0, 0, -1]], np.float32), (4, 1))
    tf = torch.tensor([float(FLT_MAX), 10.5, float(FLT_MAX), 0.0])
    valid = tf > 0
    plan = ttk._plan_visits(cp, _tv(p), _tv(d), tf, valid, 4)
    closest, anyhit = {}, {}
    _, prim = ttk.walk_closest_plain(cp, *plan, _tv(p), _tv(d), tf, valid, 4,
                                     stats=closest)
    occ = ttk.walk_occluded_plain(cp, *plan, _tv(p), _tv(d), tf, 4,
                                  stats=anyhit)
    assert cp.order[prim[:2].long()].tolist() == [0, 0]
    assert prim[2:].tolist() == [-1, -1]
    assert occ.tolist() == [True, True, False, False]
    assert closest == {"visits": 1, "pairs": 3 * 3}
    first_any = min(slot_of.values()) + 1  # lane 0: every sphere occludes
    assert anyhit == {"visits": 1,
                      "pairs": first_any + (slot_of[0] + 1) + 3}


# ---------------------------------------------------------------------------
# The streamed walks (stream=True) and the product-form battery (mxu=True)
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def stream_packs():
    """300 spheres and 300 triangles at 128 prims a cluster (the streamed
    walks and the product-form battery take no smaller clusters)."""
    return {kind: _packs(kind, 300, 128) for kind in ("sphere", "triangle")}


@pytest.mark.parametrize("kind", ["sphere", "triangle"])
def test_tables_packed_equals_jax(stream_packs, kind):
    """_tables_packed: the [C * F8, K] array of the JAX package, zero rows
    included, and ``_tables_unpacked`` reads the planes back out of it."""
    jcp, tcp, _ = stream_packs[kind]
    want = np.asarray(jtk._tables_packed(jcp))
    got = ttk._tables_packed(tcp)
    assert ttk._stream_rows(kind) == jtk._stream_rows(kind)
    assert got.is_contiguous() and ttk._tables_packed(tcp) is got
    # kept in the pack's declared field, which `to` carries and counts
    assert tcp.packed is got and torch.equal(tcp.to("cpu").packed, got)
    assert ttk.device_bytes(tcp) - ttk.device_bytes(
        dataclasses.replace(tcp, packed=None)) == got.numel() * 4
    np.testing.assert_array_equal(got.numpy(), want)
    f8 = jtk._stream_rows(kind)
    assert want.shape == (jcp.num_clusters * f8, 128)
    for a, b in zip(ttk._tables_unpacked(tcp, got), ttk._tables(tcp)):
        assert torch.equal(a, b)
    assert ttk.walk_shared_bytes(tcp, stream=True) \
        == 2 * 128 * 4 * (12 if kind == "triangle" else 4)


def test_stream_walks_match_jax_spheres(stream_packs):
    """The streamed walks over spheres against the Pallas kernels with
    ``stream=True`` in interpret mode, with an alive mask (after the JAX
    package's test_stream_bit_exact_spheres): ids, the bits of tfar and the
    occlusion bits equal, and equal to the port's resident plain walks."""
    jcp, tcp, _ = stream_packs["sphere"]
    n = 777
    p, d = _rays(n, 111)
    alive = np.random.default_rng(112).random(n) > 0.25
    want_t, want_id = jtk.intersect_clustered_pallas(
        jcp, _jv(p), _jv(d), None, jnp.asarray(alive), tile_r=TILE_R,
        interpret=True, stream=True)
    args = (tcp, _tv(p), _tv(d), None, torch.from_numpy(alive))
    got_t, got_id = ttk.intersect_clustered_pallas(*args, tile_r=TILE_R,
                                                   stream=True)
    np.testing.assert_array_equal(got_id.numpy(), np.asarray(want_id))
    np.testing.assert_array_equal(_bits(got_t.numpy()), _bits(want_t))
    res_t, res_id = ttk.intersect_clustered_pallas(*args, tile_r=TILE_R)
    assert torch.equal(res_id, got_id) and torch.equal(res_t, got_t)
    assert (got_id.numpy() >= 0).sum() > 50
    tf = np.where(alive, np.float32(10.0), np.float32(0.0))
    want = jtk.occluded_clustered_pallas(
        jcp, _jv(p), _jv(d), jnp.asarray(tf), tile_r=TILE_R, interpret=True,
        stream=True)
    got = ttk.occluded_clustered_pallas(tcp, _tv(p), _tv(d),
                                        torch.from_numpy(tf), tile_r=TILE_R,
                                        stream=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.any() and not got.numpy()[~alive].any()


def test_stream_walks_match_jax_triangles(stream_packs):
    """The streamed walks over triangles, the closest walk seeded with
    tfar0 (after test_stream_triangles_and_seed): equal bits, through the
    _compact wrapper too."""
    jcp, tcp, _ = stream_packs["triangle"]
    n = 333
    p, d = _rays(n, 121)
    g = np.random.default_rng(122)
    seed = np.where(g.random(n) < 0.5, 6.0, FLT_MAX).astype(np.float32)
    want_t, want_id = jtk.intersect_clustered_pallas(
        jcp, _jv(p), _jv(d), tfar0=jnp.asarray(seed), tile_r=TILE_R,
        interpret=True, stream=True)
    got_t, got_id = ttk.intersect_clustered_pallas(
        tcp, _tv(p), _tv(d), tfar0=torch.from_numpy(seed), tile_r=TILE_R,
        stream=True)
    np.testing.assert_array_equal(got_id.numpy(), np.asarray(want_id))
    np.testing.assert_array_equal(_bits(got_t.numpy()), _bits(want_t))
    assert (got_id.numpy() >= 0).sum() > 30
    tf = np.full(n, 6.0, np.float32)
    want = jtk.occluded_clustered_pallas(
        jcp, _jv(p), _jv(d), jnp.asarray(tf), tile_r=TILE_R, interpret=True,
        stream=True)
    got = ttk.occluded_clustered_pallas(tcp, _tv(p), _tv(d),
                                        torch.from_numpy(tf), tile_r=TILE_R,
                                        stream=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.any()
    alive = g.random(n) < 0.6
    ct, cid = ttk.intersect_clustered_pallas_compact(
        tcp, _tv(p), _tv(d), torch.from_numpy(alive), tile_r=TILE_R,
        seg_len=128, stream=True)
    rt, rid = ttk.intersect_clustered_pallas_compact(
        tcp, _tv(p), _tv(d), torch.from_numpy(alive), tile_r=TILE_R,
        seg_len=128)
    assert torch.equal(cid, rid) and torch.equal(ct, rt)


def test_mxu_battery_matches_jax():
    """The product-form triangle battery (``mxu=True``) against the Pallas
    kernel with ``mxu=True`` in interpret mode, on the triangle pack of
    mesh_scene(32, 32, subdivisions=3) at 128 prims a cluster (after
    test_mxu_battery_matches_vpu). The two sum a length-3 product in
    different orders, so: equal ids, t within rtol 1e-5 / atol 1e-6 on hit
    lanes; the same holds against the ordinary battery; the any-hit walks
    agree on every lane whose shadow distance is not within that tolerance
    of a hit."""
    jscene = jaccel.with_pallas_clusters(
        jbuilders.mesh_scene(32, 32, subdivisions=3), cluster_size=128)
    jcp = jscene.tri_clusters
    tcp = tcl.ClusteredPrims.from_numpy(jax_clusters_to_numpy(jcp))
    n = 512
    g = np.random.default_rng(131)
    p = (_rays(n, 132)[1] * 4.0).astype(np.float32)  # on a sphere about it
    d = -p / 4.0 + g.normal(0, 0.25, (n, 3)).astype(np.float32)
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    want_t, want_id = jtk.intersect_clustered_pallas(
        jcp, _jv(p), _jv(d), tile_r=TILE_R, interpret=True, mxu=True)
    got_t, got_id = ttk.intersect_clustered_pallas(tcp, _tv(p), _tv(d),
                                                   tile_r=TILE_R, mxu=True)
    vpu_t, vpu_id = ttk.intersect_clustered_pallas(tcp, _tv(p), _tv(d),
                                                   tile_r=TILE_R)
    hit = np.asarray(want_id) >= 0
    assert hit.sum() > 150
    for other_t, other_id in ((want_t, want_id), (vpu_t.numpy(),
                                                  vpu_id.numpy())):
        np.testing.assert_array_equal(got_id.numpy(), np.asarray(other_id))
        np.testing.assert_allclose(got_t.numpy()[hit],
                                   np.asarray(other_t)[hit], rtol=1e-5,
                                   atol=1e-6)
    tf = np.where(hit, np.asarray(want_t) * np.where(np.arange(n) % 2, 0.99,
                                                     1.01), 3.0)
    tf = tf.astype(np.float32)
    want = jtk.occluded_clustered_pallas(
        jcp, _jv(p), _jv(d), jnp.asarray(tf), tile_r=TILE_R, interpret=True,
        mxu=True)
    got = ttk.occluded_clustered_pallas(tcp, _tv(p), _tv(d),
                                        torch.from_numpy(tf), tile_r=TILE_R,
                                        mxu=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.any() and not got.all()


def test_stream_and_mxu_exclusions(stream_packs, spheres):
    """As in the JAX package: the streamed walks exclude the product-form
    battery, and a pack below 128 prims a cluster takes neither; on a sphere
    pack ``mxu`` changes nothing."""
    _, tcp, _ = stream_packs["triangle"]
    _, small, _ = spheres
    p, d = _rays(64, 141)
    with pytest.raises(ValueError, match="stream"):
        ttk.intersect_clustered_pallas(tcp, _tv(p), _tv(d), tile_r=TILE_R,
                                       mxu=True, stream=True)
    for kw in ({"stream": True}, {"mxu": True}):
        with pytest.raises(ValueError, match="128"):
            ttk.intersect_clustered_pallas(small, _tv(p), _tv(d),
                                           tile_r=TILE_R, **kw)
        with pytest.raises(ValueError, match="128"):
            ttk.occluded_clustered_pallas(small, _tv(p), _tv(d),
                                          torch.ones(64), tile_r=TILE_R, **kw)
    _, scp, _ = stream_packs["sphere"]
    a = ttk.intersect_clustered_pallas(scp, _tv(p), _tv(d), tile_r=TILE_R)
    b = ttk.intersect_clustered_pallas(scp, _tv(p), _tv(d), tile_r=TILE_R,
                                       mxu=True)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


class _Pack:
    """What ``_tile_for`` and ``table_bytes`` read of a cluster pack."""

    def __init__(self, kind, num_clusters, cluster_size):
        self.kind = kind
        self.num_clusters = num_clusters
        self.cluster_size = cluster_size


@pytest.mark.parametrize("kind", ["sphere", "triangle"])
@pytest.mark.parametrize("c,k", [
    (22, 64), (461, 64), (1044, 128), (2047, 128), (2048, 128), (784, 128),
    (6800, 256), (4096, 256), (3000, 1024), (16384, 256)])
def test_tile_for_resolves_as_jax(kind, c, k):
    """ops/intersect.py::_tile_for: tile_r, stream and mxu resolve as the
    JAX package's do, for every policy of (stream, mxu): 'auto' by
    ``table_bytes`` against the 48 MiB threshold, both off below 128 prims a
    cluster, and no mxu under stream. ``stream_resolves_on`` says the same."""
    from cpu_raytracing_experiments_tpu.utils.config import \
        RendererPolicy as JPolicy
    from cpu_raytracing_experiments_tpu_torch.utils.config import \
        RendererPolicy

    pack = _Pack(kind, c, k)
    assert ttk.table_bytes(pack) == jtk.table_bytes(pack)
    assert tint.PALLAS_STREAM_BYTES == jint.PALLAS_STREAM_BYTES
    for stream in (True, False, "auto"):
        for mxu in (False, True):
            if stream is True and mxu:
                continue  # RendererPolicy refuses the pair in both packages
            kw = dict(pallas_stream=stream, pallas_mxu=mxu)
            want = jint._tile_for(jint._pallas_kw(JPolicy(**kw)), pack)
            tpol = RendererPolicy(**kw)
            got = tint._tile_for(tint._pallas_kw(tpol), pack)
            for key in ("tile_r", "stream", "mxu"):
                assert got[key] == want[key], (key, stream, mxu)
            assert tint.stream_resolves_on(tpol, pack) == bool(want["stream"])
    want = jint._tile_for(jint._pallas_kw(None), pack)
    got = tint._tile_for(tint._pallas_kw(None), pack)
    assert (got["stream"], got["mxu"]) == (want["stream"], want["mxu"])


def test_default_policy_streams_the_large_mesh_table():
    """The pack of mesh_scene(uv_res=810) (1,312,200 triangles, 256 a
    cluster, about 6,800 clusters at the SAH build's fill) is over the
    threshold, and the 100,352-triangle pack of uv_res=224 is not."""
    from cpu_raytracing_experiments_tpu_torch.utils.config import \
        RendererPolicy

    assert tint.stream_resolves_on(RendererPolicy(),
                                   _Pack("triangle", 6800, 256))
    assert not tint.stream_resolves_on(RendererPolicy(),
                                       _Pack("triangle", 1100, 128))
    assert not tint.stream_resolves_on(
        RendererPolicy(pallas_stream=False), _Pack("triangle", 6800, 256))


def _card_batch(cp_cpu, n=4000):
    cp = cp_cpu.to("cuda")
    p, d = _rays(n, 101)
    p, d = _tv(p).to("cuda"), _tv(d).to("cuda")
    g = np.random.default_rng(102)
    tf = torch.from_numpy(np.where(
        g.random(n) < 0.2, 0.0, g.uniform(0.5, 20.0, n)
    ).astype(np.float32)).cuda()
    valid = tf > 0
    return cp, p, d, tf, valid, ttk._plan_visits(cp, p, d, tf, valid, TILE_R)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["sphere", "triangle"])
def test_stream_kernels_match_on_card(stream_packs, kind):
    """cluster_closest_stream / cluster_occluded_stream on a CUDA card: equal
    to their plain versions and to the resident kernels, bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU form")
    cp, p, d, tf, valid, plan = _card_batch(stream_packs[kind][1])
    kt, kid = ttk.walk_closest(cp, *plan, p, d, tf, valid, TILE_R, stream=True)
    for ot, oid in (
            ttk.walk_closest_plain(cp, *plan, p, d, tf, valid, TILE_R,
                                   packed=ttk._tables_packed(cp)),
            ttk.walk_closest(cp, *plan, p, d, tf, valid, TILE_R)):
        assert torch.equal(kid, oid)
        assert torch.equal(kt.view(torch.int32), ot.view(torch.int32))
    ko = ttk.walk_occluded(cp, *plan, p, d, tf, TILE_R, stream=True)
    assert torch.equal(ko, ttk.walk_occluded_plain(
        cp, *plan, p, d, tf, TILE_R, packed=ttk._tables_packed(cp)))
    assert torch.equal(ko, ttk.walk_occluded(cp, *plan, p, d, tf, TILE_R))


@pytest.mark.cuda
def test_mxu_kernels_match_on_card(stream_packs):
    """The product-form battery of cluster_closest / cluster_occluded on a
    CUDA card against its plain version: equal ids and occlusion bits, t
    within 2 ulp."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU form")
    cp, p, d, tf, valid, plan = _card_batch(stream_packs["triangle"][1])
    kt, kid = ttk.walk_closest(cp, *plan, p, d, tf, valid, TILE_R, mxu=True)
    pt, pid = ttk.walk_closest_plain(cp, *plan, p, d, tf, valid, TILE_R,
                                     mxu=True)
    assert torch.equal(kid, pid)
    ulp = (kt.view(torch.int32) - pt.view(torch.int32)).abs()
    assert int(ulp.max()) <= 2
    assert torch.equal(
        ttk.walk_occluded(cp, *plan, p, d, tf, TILE_R, mxu=True),
        ttk.walk_occluded_plain(cp, *plan, p, d, tf, TILE_R, mxu=True))


@pytest.mark.cuda
def test_kernels_match_plain_on_card(spheres, triangles):
    """csrc/cluster_traverse.cu against the plain versions on a CUDA card:
    the planner's lists below nvis and both walks, bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU form")
    for _, cp_cpu, _ in (spheres, triangles):
        cp = cp_cpu.to("cuda")
        n = 4000
        p, d = _rays(n, 101)
        p, d = _tv(p).to("cuda"), _tv(d).to("cuda")
        g = np.random.default_rng(102)
        tf = torch.from_numpy(np.where(
            g.random(n) < 0.2, 0.0, g.uniform(0.5, 20.0, n)
        ).astype(np.float32)).cuda()
        valid = tf > 0
        kv, ke, kn = ttk._plan_visits(cp, p, d, tf, valid, TILE_R)
        pv, pe, pn = ttk.plan_visits_plain(cp, p, d, tf, valid, TILE_R)
        assert torch.equal(kn, pn)
        below = torch.arange(cp.num_clusters, device="cuda")[None] < pn[:, None]
        assert torch.equal(kv[below], pv[below])
        assert torch.equal(ke[below], pe[below])
        kt, kid = ttk.walk_closest(cp, pv, pe, pn, p, d, tf, valid, TILE_R)
        pt, pid = ttk.walk_closest_plain(cp, pv, pe, pn, p, d, tf, valid,
                                         TILE_R)
        assert torch.equal(kid, pid)
        assert torch.equal(kt.view(torch.int32), pt.view(torch.int32))
        assert torch.equal(
            ttk.walk_occluded(cp, pv, pe, pn, p, d, tf, TILE_R),
            ttk.walk_occluded_plain(cp, pv, pe, pn, p, d, tf, TILE_R))
