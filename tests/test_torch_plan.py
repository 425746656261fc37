"""The PyTorch port's planner modes (``ops/kernels/cluster_traverse.py``:
``plan`` = 'super', 'group', 'tilebox', 'hybrid', the unsorted plan and the
sort outside the kernel) and the group boxes of the SAH cluster build
(``ops/clustered.py``), against the JAX package's
``ops/pallas/traverse_kernel.py`` and ``ops/clustered.py`` on the CPU.

The same numpy-seeded rays and the same cluster tables (2000 spheres or
triangles at 8 prims a cluster, leaves packed two to a cluster with their
group boxes: C of about 300, so 'super' has three superclusters, the last
partial) go through the JAX function under ``jax.jit``, its Pallas kernels
with ``interpret=True``, and through the port's plain versions, in tiles of
64 rays. Tolerance: equal values, for nvis and below nvis for the visit ids
and the entries, past nvis FLT_MAX; for the wrappers equal ids, equal bits
of t and equal occlusion. Renders under each planner are held to the 'ray'
render: bit for bit under 'super' and the sort outside the kernel, which
give the 'ray' lists; at tests/test_goldens.py::_check's bar under the
others, whose visit order may settle an exact tie between two clusters
otherwise. The CUDA kernels are held to the same plain versions on the card
by ``chip_smoke.py``.
"""
import dataclasses
import functools

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from cpu_raytracing_experiments_tpu.bvh import builder as jbvh
from cpu_raytracing_experiments_tpu.core.vec import Vec3 as JVec3
from cpu_raytracing_experiments_tpu.ops import clustered as jcl
from cpu_raytracing_experiments_tpu.ops.pallas import traverse_kernel as jtk
from cpu_raytracing_experiments_tpu.scene import accel as jaccel
from cpu_raytracing_experiments_tpu.scene import builders as jbuilders
from cpu_raytracing_experiments_tpu_torch import Renderer
from cpu_raytracing_experiments_tpu_torch.core.vec import Vec3 as TVec3
from cpu_raytracing_experiments_tpu_torch.ops import clustered as tcl
from cpu_raytracing_experiments_tpu_torch.ops import intersect as tint
from cpu_raytracing_experiments_tpu_torch.ops.kernels import \
    cluster_traverse as ttk
from cpu_raytracing_experiments_tpu_torch.render import renderer as tr
from cpu_raytracing_experiments_tpu_torch.scene import accel as taccel
from cpu_raytracing_experiments_tpu_torch.scene import builders as tbuilders
from cpu_raytracing_experiments_tpu_torch.scene.scene import Scene
from cpu_raytracing_experiments_tpu_torch.utils.config import RendererPolicy

from test_torch_scene import jax_clusters_to_numpy, jax_scene_to_numpy

# The suite runs in several worker processes at once: one intra-op thread
# each, or the workers' thread pools fight over the cores.
torch.set_num_threads(1)

TILE_R = 64
N_RAYS = 512  # 8 tiles: the JAX planner pads to no further tile
FLT_MAX = np.float32(3.4028235e38)
# (plan, sort, sort_impl) as the JAX package's _plan_visits takes them;
# 'tilebox' and 'hybrid' always sort outside the kernel
MODES = [
    ("ray", True, "xla"), ("ray", False, "kernel"),
    ("super", True, "kernel"), ("super", True, "xla"),
    ("super", False, "kernel"),
    ("group", True, "kernel"), ("group", True, "xla"),
    ("group", False, "kernel"),
    ("tilebox", True, "kernel"), ("tilebox", False, "kernel"),
    ("hybrid", True, "kernel"), ("hybrid", False, "kernel"),
]
MODE_IDS = [f"{p}-{'sorted' if s else 'unsorted'}-{i}" for p, s, i in MODES]


def _prims(kind, n=2000, seed=5):
    g = np.random.default_rng(seed)
    if kind == "sphere":
        centers = g.uniform(-6, 6, (n, 3)).astype(np.float32)
        radii = g.uniform(0.1, 0.6, n).astype(np.float32)
        rows = np.concatenate([centers, (radii ** 2)[:, None]], axis=1)
        mins, maxs = jbvh.sphere_bounds(centers, radii)
    else:
        v0 = g.uniform(-6, 6, (n, 3)).astype(np.float32)
        e1 = g.normal(0, 0.7, (n, 3)).astype(np.float32)
        e2 = g.normal(0, 0.7, (n, 3)).astype(np.float32)
        rows = np.concatenate([v0, e1, e2], axis=1)
        mins, maxs = jbvh.triangle_bounds(v0, v0 + e1, v0 + e2)
    return mins, maxs, rows


@functools.lru_cache(maxsize=None)
def _packs(kind):
    """(JAX pack, port pack) with group boxes, built by the JAX package and
    carried into the port bit for bit."""
    jcp = jcl.build_clusters_sah(*_prims(kind), cluster_size=8, kind=kind,
                                 fill_window=8, group_boxes=True)
    return jcp, tcl.ClusteredPrims.from_numpy(jax_clusters_to_numpy(jcp))


def _tv(a):
    return TVec3(*(torch.from_numpy(np.ascontiguousarray(a[:, i]))
                   for i in range(3)))


def _jv(a):
    return JVec3(*(jnp.asarray(a[:, i]) for i in range(3)))


def _unit(d):
    return (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)


def _ray_case(case, jcp, n=N_RAYS, seed=21):
    """(p, d, tf, valid) as numpy. 'scattered' and 'camera' (one origin, a
    narrow fan) as in test_torch_traverse; 'on_box_faces': a zero direction
    component with the origin on a face of a cluster box (0 * inf = NaN in
    the slab test, so the ray does not enter that box); 'coherent': tiles of
    one shared direction (a zero-width direction interval), of one shared
    direction with x = 0 (an interval at 0, which bounds nothing), of no
    valid ray, and two octant-coherent tiles, before scattered tiles."""
    g = np.random.default_rng(seed)
    p = g.uniform(-9, 9, (n, 3)).astype(np.float32)
    d = _unit(g.normal(size=(n, 3)))
    tf = g.uniform(0.5, 25.0, n).astype(np.float32)
    tf[g.random(n) < 0.2] = FLT_MAX
    valid = g.random(n) < 0.7
    if case == "camera":
        p[:] = (0.5, 1.0, 14.0)
        d = _unit(np.stack([g.uniform(-0.4, 0.4, n), g.uniform(-0.4, 0.4, n),
                            -np.ones(n)], axis=1))
    elif case == "on_box_faces":
        lo = np.stack([np.asarray(c) for c in jcp.lo], axis=1)
        hi = np.stack([np.asarray(c) for c in jcp.hi], axis=1)
        for i in range(0, n, 2):
            c, axis = i % jcp.num_clusters, (i // 2) % 3
            p[i] = 0.5 * (lo[c] + hi[c])
            p[i, axis] = (lo if i % 4 else hi)[c, axis]
            d[i, axis] = 0.0
            d[i] /= np.linalg.norm(d[i])
        valid[:] = True
    elif case == "coherent":
        t = TILE_R
        d[0:t] = _unit(np.array([[0.3, 0.5, -0.8]]))
        d[t:2 * t] = _unit(np.array([[0.0, 0.6, 0.8]]))
        valid[2 * t:3 * t] = False
        d[3 * t:4 * t] = _unit(np.abs(g.normal(size=(t, 3))) + 0.05)
        d[4 * t:5 * t] = _unit((np.abs(g.normal(size=(t, 3))) + 0.05)
                               * np.array([-1.0, 1.0, -1.0]))
    tf = np.where(valid, tf, np.float32(0.0))
    return p, d.astype(np.float32), tf, valid


@functools.partial(jax.jit, static_argnames=("plan", "sort", "sort_impl"))
def _jax_plan(cp, ray_in, plan, sort, sort_impl):
    return jtk._plan_visits(cp, ray_in, N_RAYS // TILE_R, TILE_R, sort, True,
                            plan, 8, sort_impl)


@pytest.mark.parametrize("case", ["scattered", "camera", "on_box_faces",
                                  "coherent"])
@pytest.mark.parametrize("mode", MODES, ids=MODE_IDS)
@pytest.mark.parametrize("kind", ["sphere", "triangle"])
def test_plan_modes_match_jax(kind, mode, case):
    """_plan_visits in every mode the JAX package has: nvis equal, and below
    nvis the cluster ids and the entries equal; FLT_MAX past nvis."""
    plan, sort, sort_impl = mode
    jcp, tcp = _packs(kind)
    p, d, tf, valid = _ray_case(case, jcp)
    ray_in = jtk._ray_cols(
        [(jnp.asarray(a), pad) for a, pad in (
            (p[:, 0], 1e30), (p[:, 1], 1e30), (p[:, 2], 1e30),
            (d[:, 0], 1.0), (d[:, 1], 1.0), (d[:, 2], 1.0), (tf, 0.0),
            (valid.astype(np.float32), 0.0))], N_RAYS)
    want_v, want_e, want_n = (np.asarray(a) for a in _jax_plan(
        jcp, ray_in, plan, sort, sort_impl))
    got_v, got_e, got_n = ttk._plan_visits(
        tcp, _tv(p), _tv(d), torch.from_numpy(tf), torch.from_numpy(valid),
        TILE_R, plan, sort, sort_impl)
    want_n = want_n[:, 0]
    np.testing.assert_array_equal(got_n.numpy(), want_n)
    assert want_n.sum() > 0
    for t, m in enumerate(want_n):
        np.testing.assert_array_equal(got_v[t, :m].numpy(), want_v[t, :m])
        np.testing.assert_array_equal(got_e[t, :m].numpy(), want_e[t, :m])
        assert (got_e[t, m:].numpy() == FLT_MAX).all()
    if case == "coherent" and plan in ("tilebox", "hybrid"):
        # the tile of no valid ray plans nothing
        assert want_n[2] == 0
    if not sort:
        assert (np.diff(got_e.numpy(), axis=1) >= 0).all()


def test_plan_super_and_sorts_equal_ray():
    """'super' gives the 'ray' lists bit for bit, and the sort outside the
    kernel the same lists as inside; the tilebox and hybrid lists hold every
    cluster of the 'ray' list at an entry no larger (lower bounds)."""
    jcp, tcp = _packs("sphere")
    assert tcp.num_clusters > 2 * tcl.SUPER  # three superclusters
    for case in ("scattered", "coherent"):
        p, d, tf, valid = _ray_case(case, jcp)
        args = (tcp, _tv(p), _tv(d), torch.from_numpy(tf),
                torch.from_numpy(valid), TILE_R)
        rows = {plan: ttk.plan_rows_plain(*args, plan) for plan in ttk.PLANS}
        assert torch.equal(rows["super"], rows["ray"])
        hit = rows["ray"] < FLT_MAX
        for plan in ("tilebox", "hybrid"):
            assert (rows[plan][hit] <= rows["ray"][hit]).all(), plan
        base = ttk._plan_visits(*args)
        for plan, sort_impl in (("super", "kernel"), ("ray", "xla")):
            got = ttk._plan_visits(*args, plan, True, sort_impl)
            assert all(torch.equal(a, b) for a, b in zip(got, base))


@pytest.mark.parametrize("how", ["super", "group", "tilebox", "hybrid",
                                 "xla", "unsorted"])
@pytest.mark.parametrize("kind", ["sphere", "triangle"])
def test_wrappers_match_jax(kind, how):
    """intersect_clustered_pallas and occluded_clustered_pallas under each
    planner: ids and the bits of t equal the JAX package's, and occlusion."""
    kw = {"xla": {"sort_impl": "xla"}, "unsorted": {"sort": False}}.get(
        how, {"plan": how})
    jcp, tcp = _packs(kind)
    n = 5 * TILE_R  # the coherent tiles (the JAX walks pad to 8 tiles)
    p, d, tf, valid = _ray_case("coherent", jcp, n=n, seed=31)
    tf0 = np.where(np.random.default_rng(32).random(n) < 0.5, tf, FLT_MAX)
    want_t, want_id = jtk.intersect_clustered_pallas(
        jcp, _jv(p), _jv(d), tfar0=jnp.asarray(tf0),
        alive=jnp.asarray(valid), tile_r=TILE_R, interpret=True, **kw)
    got_t, got_id = ttk.intersect_clustered_pallas(
        tcp, _tv(p), _tv(d), tfar0=torch.from_numpy(tf0),
        alive=torch.from_numpy(valid), tile_r=TILE_R, **kw)
    np.testing.assert_array_equal(got_id.numpy(), np.asarray(want_id))
    np.testing.assert_array_equal(got_t.numpy().view(np.int32),
                                  np.asarray(want_t).view(np.int32))
    assert (got_id.numpy() >= 0).sum() > 20
    hit = got_id.numpy() >= 0
    shadow = tf.copy()
    shadow[hit] = got_t.numpy()[hit] * np.float32(1.001)
    want_o = jtk.occluded_clustered_pallas(
        jcp, _jv(p), _jv(d), jnp.asarray(shadow), tile_r=TILE_R,
        interpret=True, **kw)
    got_o = ttk.occluded_clustered_pallas(
        tcp, _tv(p), _tv(d), torch.from_numpy(shadow), tile_r=TILE_R, **kw)
    np.testing.assert_array_equal(got_o.numpy(), np.asarray(want_o))
    assert got_o.numpy().sum() > 20


def test_group_on_pack_without_group_boxes_plans_as_ray():
    """plan='group' on a pack without group boxes plans as 'ray', as in the
    JAX package."""
    jcp, tcp = _packs("sphere")
    plain = dataclasses.replace(tcp, glo=None, ghi=None)
    p, d, tf, valid = _ray_case("scattered", jcp)
    args = (_tv(p), _tv(d), torch.from_numpy(tf), torch.from_numpy(valid),
            TILE_R)
    got = ttk._plan_visits(plain, *args, "group")
    want = ttk._plan_visits(plain, *args, "ray")
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert not ttk.sorts_in_kernel(tcp, "tilebox", True, "kernel")
    assert ttk.sorts_in_kernel(plain, "group", True, "kernel")
    with pytest.raises(ValueError, match="plan='auto'"):
        ttk._plan_visits(tcp, *args, "auto")


@pytest.mark.parametrize("kind", ["sphere", "mesh"])
def test_group_boxes_equal_jax(kind):
    """build_clusters_sah(group_boxes=True) through with_pallas_clusters:
    every array of the pack equals the JAX package's, the group boxes
    (glo / ghi, [2, C, 3]) among them; the supercluster rows equal the
    JAX package's _super_slab_rows."""
    if kind == "sphere":
        jscene = jbuilders.random_spheres_scene(8, 8, num_spheres=900)
        key = "sphere_clusters"
    else:
        jscene = jbuilders.mesh_scene(8, 8, subdivisions=3)
        key = "tri_clusters"
    tscene = Scene.from_numpy(jax_scene_to_numpy(jscene))
    kw = {"cluster_size": 16, "fill_window": 8, "group_boxes": True}
    jcp = getattr(jaccel.with_pallas_clusters(jscene, **kw), key)
    tcp = getattr(taccel.with_pallas_clusters(tscene, **kw), key)
    want, got = jax_clusters_to_numpy(jcp), tcp.to_numpy()
    assert sorted(got) == sorted(want) and want["glo"] is not None
    for k, v in want.items():
        if isinstance(v, np.ndarray):
            assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
            np.testing.assert_array_equal(got[k], v, err_msg=k)
        else:
            assert got[k] == v, k
    assert want["glo"].shape == (2, jcp.num_clusters, 3)
    # a single-leaf cluster carries its box twice
    single = (want["glo"][0] == want["glo"][1]).all(1)
    assert single.any() and not single.all()
    s = -(-tcp.num_clusters // tcl.SUPER)
    for got_row, want_row in zip(ttk._super_slab_rows(tcp),
                                 jtk._super_slab_rows(jcp)):
        np.testing.assert_array_equal(got_row.numpy(),
                                      np.asarray(want_row)[0, :s])


@functools.lru_cache(maxsize=None)
def _mesh():
    return taccel.with_pallas_clusters(
        tbuilders.mesh_scene(32, 32, subdivisions=3), cluster_size=4,
        fill_window=8, group_boxes=True)


def _mesh_render(**kw):
    pol = RendererPolicy(max_bounces=4, rays_per_chunk=1024, accel="pallas",
                         pallas_tile_rays=64, **kw)
    r = Renderer(_mesh(), pol, 32, 32, device="cpu")
    r.accumulate(4)
    return r


@pytest.mark.parametrize("how", ["super", "xla", "group", "tilebox",
                                 "hybrid", "unsorted"])
def test_mesh_render_under_each_planner(how):
    """mesh_scene(32, 32, subdivisions=3) (1280 triangles at 4 a cluster,
    group boxes, C > 256), 4 passes, accel='pallas': 'super' and the sort
    outside the kernel leave every bucket as the 'ray' planner has it;
    'group', 'tilebox', 'hybrid' and the unsorted plan meet
    tests/test_goldens.py::_check's bar against it (> 99.5% of values within
    rtol 1e-3 / atol 1e-4, means within 1e-3)."""
    kw = {"xla": {"pallas_sort_impl": "xla"},
          "unsorted": {"pallas_sort_visits": False}}.get(
        how, {"pallas_plan": how})
    assert _mesh().tri_clusters.num_clusters > 2 * tcl.SUPER
    base, r = _mesh_render(), _mesh_render(**kw)
    if how in ("super", "xla"):
        assert torch.equal(r.state.buckets, base.state.buckets)
        return
    want, img = base.render(tonemap=False), r.render(tonemap=False)
    assert want.mean() > 0.05
    assert np.isclose(img, want, rtol=1e-3, atol=1e-4).mean() > 0.995
    np.testing.assert_allclose(img.mean(), want.mean(), rtol=1e-3)


def test_cluster_limit_binds_only_the_sort_in_the_kernel(monkeypatch):
    """``max_plan_clusters`` limits only the planner that sorts in the
    kernel, and no longer refuses a pack: with the limit patched below the
    pack's cluster count, check_policy accepts every planner, the route of
    the policies that sort in the kernel turns to ``cluster_plan_rows`` and
    the PyTorch sort, and that route's lists (the rows' plain version, then
    ``_sort_tail``) equal the sorted plain plan: nvis, and below it the ids
    and the entries."""
    scene = taccel.with_pallas_clusters(
        tbuilders.random_spheres_scene(8, 8, num_spheres=200),
        cluster_size=32)
    cp = scene.sphere_clusters
    assert cp.num_clusters > 4
    base = dict(max_bounces=2, accel="pallas")
    sorted_in_kernel = ({}, {"pallas_plan": "super"},
                        {"pallas_plan": "group"})
    for kw in sorted_in_kernel:
        pol = RendererPolicy(**base, **kw)
        k = tint._tile_for(tint._pallas_kw(pol), cp)
        assert ttk.plans_in_kernel(cp, k["plan"], k["sort"], k["sort_impl"],
                                   k["tile_r"])
    monkeypatch.setattr(ttk, "max_plan_clusters", lambda tile_r: 4)
    for kw in sorted_in_kernel + ({"pallas_sort_impl": "xla"},
                                  {"pallas_sort_visits": False},
                                  {"pallas_plan": "tilebox"}):
        pol = RendererPolicy(**base, **kw)
        tr.check_policy(pol)
        k = tint._tile_for(tint._pallas_kw(pol), cp)
        assert not ttk.plans_in_kernel(cp, k["plan"], k["sort"],
                                       k["sort_impl"], k["tile_r"])
    jcp, tcp = _packs("sphere")
    p, d, tf, valid = _ray_case("scattered", jcp)
    args = (tcp, _tv(p), _tv(d), torch.from_numpy(tf),
            torch.from_numpy(valid), TILE_R)
    for plan in ("ray", "super"):
        v, e, n = ttk._sort_tail(ttk.plan_rows(*args, plan))
        pv, pe, pn = ttk.plan_visits_plain(*args, plan)
        below = torch.arange(tcp.num_clusters)[None] < pn[:, None]
        assert torch.equal(n, pn) and int(pn.sum()) > 0
        assert torch.equal(v[below], pv[below])
        assert torch.equal(e[below], pe[below])
    with pytest.raises(NotImplementedError, match="pallas_plan='bvh'"):
        tr.check_policy(RendererPolicy(**base, pallas_plan="bvh"))


@pytest.mark.cuda
@pytest.mark.parametrize("plan", ["ray", "super", "group"])
def test_plan_kernel_on_box_faces_and_equal_entries_on_card(plan):
    """cluster_plan on a CUDA card in each mode against its plain version:
    nvis, and below it the ids and the entries, equal, on rays that start
    on a box face with a zero direction component (a NaN slab product: the
    box is not entered) and on a pack in which every cluster box appears
    twice, so that every entered cluster has an equal entry in another
    cluster and the lower id must come first."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU form")
    jcp, tcp = _packs("triangle")
    src = tcp.to_numpy()
    twice = dict(src, lo=np.repeat(src["lo"], 2, axis=0),
                 hi=np.repeat(src["hi"], 2, axis=0),
                 glo=np.repeat(src["glo"], 2, axis=1),
                 ghi=np.repeat(src["ghi"], 2, axis=1),
                 rows=np.repeat(src["rows"].reshape(tcp.num_clusters, -1),
                                2, axis=0).reshape(-1, src["rows"].shape[1]),
                 planes=np.repeat(src["planes"].reshape(tcp.num_clusters, -1),
                                  2, axis=0).reshape(-1, 12),
                 order=np.repeat(src["order"].reshape(tcp.num_clusters, -1),
                                 2, axis=0).reshape(-1),
                 num_clusters=2 * tcp.num_clusters)
    for case, cp_cpu in (("on_box_faces", tcp), ("scattered", tcp),
                         ("camera", tcl.ClusteredPrims.from_numpy(twice))):
        cp = cp_cpu.to("cuda")
        p, d, tf, valid = _ray_case(case, jcp)
        args = (cp, _tv(p).to("cuda"), _tv(d).to("cuda"),
                torch.from_numpy(tf).cuda(), torch.from_numpy(valid).cuda(),
                TILE_R, plan)
        kv, ke, kn = ttk._plan_visits(*args)
        pv, pe, pn = ttk.plan_visits_plain(*args)
        below = torch.arange(cp.num_clusters, device="cuda")[None] \
            < pn[:, None]
        assert torch.equal(kn, pn) and int(pn.sum()) > 0
        assert torch.equal(kv[below], pv[below])
        assert torch.equal(ke[below], pe[below])


def _chunks(c, chunk):
    """How many times cluster_plan_rows' sweep takes each cluster: it sweeps
    [c0, c0 + chunk) for c0 = 0, chunk, 2 chunk, ... below C."""
    taken = np.zeros(c, np.int64)
    for c0 in range(0, c, chunk):
        taken[c0:c0 + chunk] += 1
    return taken


@pytest.mark.parametrize("tile_r", [1, 32, 64, 128, 256, 512, 1024])
def test_plan_rows_chunk_fits_and_covers(tile_r):
    """cluster_plan_rows' chunk at tiles of 1 to 1024 rays and up to 2^20
    clusters, with and without the union entries of 'super': the shared
    memory the kernel asks for (plan_shared_bytes, as the .cu computes it)
    fits one block beside 1 KB of static shared memory, and the chunks take
    every cluster exactly once."""
    for c in (1, 31, 32, 33, 1130, 7384, 16385, 100_000, 1 << 20):
        for n_super in (0, -(-c // tcl.SUPER)):
            chunk = ttk.plan_rows_chunk(tile_r, c, n_super)
            assert chunk >= 32 and chunk % 32 == 0
            assert ttk.plan_shared_bytes(tile_r, chunk, n_super, 0) \
                <= ttk.MAX_SHARED_BYTES - 1024
            assert (_chunks(c, chunk) == 1).all()
            # all C at once where they fit the aim of three blocks an SM
            if ttk.plan_shared_bytes(tile_r, 32 * -(-c // 32), n_super, 0) \
                    <= ttk.PLAN_ROWS_SHARED_BYTES:
                assert chunk >= c


@pytest.mark.parametrize("c", [1130, 7384, 100_000, 1 << 20])
def test_plan_rows_super_chunks_start_on_slots(c):
    """Under 'super' every chunk of cluster_plan_rows starts on a slot of
    32 clusters, so that each slot the sweep takes lies in one union box of
    SUPER clusters, at every tile size and at a chunk patched small."""
    n_super = -(-c // tcl.SUPER)
    for chunk in [ttk.plan_rows_chunk(t, c, n_super)
                  for t in (1, 128, 256, 1024)] + [32, 64, 96]:
        for c0 in range(0, c, chunk):
            assert c0 % 32 == 0
            slots = np.arange(c0 // 32, -(-min(c0 + chunk, c) // 32))
            assert ((32 * slots) // tcl.SUPER
                    == (32 * slots + 31) // tcl.SUPER).all()


@pytest.mark.cuda
@pytest.mark.parametrize("plan", ["ray", "super", "group", "tilebox",
                                  "hybrid"])
def test_plan_rows_kernel_matches_plain_on_card(plan, monkeypatch):
    """cluster_plan_rows on a CUDA card in each mode against plan_rows_plain,
    the whole [T, C] matrix bit for bit: on rays that start on a box face
    with a zero direction component, on sign-coherent tiles, on scattered
    rays, on a pack in which every cluster box appears twice, and with the
    sweep's chunk patched below C (a chunk of 32 and of 64 clusters)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU form")
    jcp, tcp = _packs("triangle")
    src = tcp.to_numpy()
    twice = tcl.ClusteredPrims.from_numpy(dict(
        src, lo=np.repeat(src["lo"], 2, axis=0),
        hi=np.repeat(src["hi"], 2, axis=0),
        glo=np.repeat(src["glo"], 2, axis=1),
        ghi=np.repeat(src["ghi"], 2, axis=1),
        rows=np.repeat(src["rows"].reshape(tcp.num_clusters, -1), 2,
                       axis=0).reshape(-1, src["rows"].shape[1]),
        planes=np.repeat(src["planes"].reshape(tcp.num_clusters, -1), 2,
                         axis=0).reshape(-1, 12),
        order=np.repeat(src["order"].reshape(tcp.num_clusters, -1), 2,
                        axis=0).reshape(-1),
        num_clusters=2 * tcp.num_clusters))
    chunk = ttk.plan_rows_chunk
    for chunk_of in (chunk, lambda *args: 32, lambda *args: 64):
        monkeypatch.setattr(ttk, "plan_rows_chunk", chunk_of)
        for case, cp_cpu in (("on_box_faces", tcp), ("coherent", tcp),
                             ("scattered", tcp), ("camera", twice)):
            cp = cp_cpu.to("cuda")
            p, d, tf, valid = _ray_case(case, jcp)
            args = (cp, _tv(p).to("cuda"), _tv(d).to("cuda"),
                    torch.from_numpy(tf).cuda(),
                    torch.from_numpy(valid).cuda(), TILE_R, plan)
            got = ttk.plan_rows(*args)
            want = ttk.plan_rows_plain(*args)
            assert torch.equal(got, want), (case, int((got != want).sum()))
            assert bool((want < FLT_MAX).any())
