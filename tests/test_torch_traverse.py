"""The PyTorch port's clustered traversal (``ops/kernels/cluster_traverse.py``)
against the JAX package's ``ops/pallas/traverse_kernel.py``, on the CPU.

The same numpy-seeded rays and the same cluster tables go through the JAX
wrappers (Pallas in interpret mode, under ``jax.jit``) and through the
port's plain versions, at a small size: 400 spheres or triangles,
``cluster_size=32``, ``tile_r=64``. Tolerance: equal bits, for the planner's
lists below ``nvis``, for both sphere walks and for both triangle walks. The
CUDA kernels are held to the same plain versions on the card by
``chip_smoke.py``; the test that launches them here needs a card.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from cpu_raytracing_experiments_tpu.bvh import builder as jbvh
from cpu_raytracing_experiments_tpu.core.vec import Vec3 as JVec3
from cpu_raytracing_experiments_tpu.ops import clustered as jcl
from cpu_raytracing_experiments_tpu.ops.pallas import traverse_kernel as jtk
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


def _packs(kind):
    g = np.random.default_rng(11)
    if kind == "sphere":
        centers = g.uniform(-6, 6, (N_PRIMS, 3)).astype(np.float32)
        radii = g.uniform(0.1, 0.7, N_PRIMS).astype(np.float32)
        rows = np.concatenate([centers, (radii ** 2)[:, None]], axis=1)
        mins, maxs = jbvh.sphere_bounds(centers, radii)
    else:
        v0 = g.uniform(-6, 6, (N_PRIMS, 3)).astype(np.float32)
        e1 = g.normal(0, 0.9, (N_PRIMS, 3)).astype(np.float32)
        e2 = g.normal(0, 0.9, (N_PRIMS, 3)).astype(np.float32)
        rows = np.concatenate([v0, e1, e2], axis=1)
        mins, maxs = jbvh.triangle_bounds(v0, v0 + e1, v0 + e2)
    jcp = jcl.build_clusters_sah(mins, maxs, rows, cluster_size=K, kind=kind)
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
