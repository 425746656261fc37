"""The PyTorch port's sphere batteries against the JAX package's
``ops/intersect.py::intersect_spheres`` / ``occluded_spheres`` and the Pallas
kernels ``ops/pallas/sphere_kernel.py::intersect_spheres_pallas`` /
``occluded_spheres_pallas`` (interpret mode, as the JAX package's own CPU
tests run them).

The JAX functions run under ``jax.jit``, as the renderer runs them: XLA
then fuses the multiply-adds the port writes out (core/fp.py), where eager
op-by-op dispatch would not. ids and occlusion bits must be exactly equal,
tangent rays included; t within rtol 2e-3, the bound
tests/test_pallas_kernel.py allows for grazing hits. The CUDA kernels
themselves run only on the card (``cuda`` marker)."""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from cpu_raytracing_experiments_tpu.core.vec import Vec3 as JVec3
from cpu_raytracing_experiments_tpu.ops import intersect as jint
from cpu_raytracing_experiments_tpu.ops.pallas import sphere_kernel as jpk
from cpu_raytracing_experiments_tpu_torch.core.vec import Vec3 as TVec3
from cpu_raytracing_experiments_tpu_torch.ops import intersect as tint
from cpu_raytracing_experiments_tpu_torch.ops.kernels import sphere_battery as sb

# The suite runs in several worker processes at once: one intra-op thread
# each, or the workers' thread pools fight over the cores.
torch.set_num_threads(1)

j_intersect_spheres = jax.jit(jint.intersect_spheres)
j_occluded_spheres = jax.jit(jint.occluded_spheres)


def _batch(n_rays, n_prims, seed, dup=False):
    """Seeded rays and spheres; a quarter of the rays tangent to a sphere;
    with `dup`, the table is followed by a copy of itself so that ties
    straddle the 512-sphere chunks of the plain version, the 1024-sphere
    staging chunks of the CUDA kernel and the Pallas prim blocks."""
    g = np.random.default_rng(seed)
    c = g.uniform(-20, 20, (n_prims, 3))
    r = g.uniform(0.5, 3.0, n_prims)
    if dup:
        c, r = np.concatenate([c, c]), np.concatenate([r, r])
    o = g.uniform(-25, 25, (n_rays, 3))
    d = g.normal(size=(n_rays, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    m = n_rays // 4
    k = g.integers(0, len(r), m)
    u = g.normal(size=(m, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    t = np.cross(u, g.normal(size=(m, 3)))
    t /= np.linalg.norm(t, axis=1, keepdims=True)
    o[:m] = c[k] + r[k, None] * u - t * 2.0
    d[:m] = t
    tf = g.uniform(0, 60, n_rays)
    tf[g.random(n_rays) < 0.1] = 0.0
    tf[g.random(n_rays) < 0.1] = -3.0
    f32 = lambda a: np.ascontiguousarray(a, np.float32)
    cols = lambda a: [f32(a[:, j]) for j in range(3)]
    return cols(o), cols(d), cols(c), f32(r * r), f32(tf)


def _jax(o, d, c, rsq, tf):
    j = lambda cs: JVec3(*(jnp.asarray(a) for a in cs))
    return j(o), j(d), j(c), jnp.asarray(rsq), jnp.asarray(tf)


def _torch(o, d, c, rsq, tf):
    t = lambda cs: TVec3(*(torch.from_numpy(a) for a in cs))
    return t(o), t(d), t(c), torch.from_numpy(rsq), torch.from_numpy(tf)


CASES = {  # (rays, spheres, duplicated)
    "hero_9": (4096, 9, False),
    "field_300": (2048, 300, False),
    "dup_across_chunks_2x600": (1024, 600, True),
}


def _check_closest(want_t, want_id, got_t, got_id):
    want_t, want_id = np.asarray(want_t), np.asarray(want_id)
    np.testing.assert_array_equal(got_id.numpy(), want_id)
    hit = want_id >= 0
    np.testing.assert_allclose(got_t.numpy()[hit], want_t[hit], rtol=2e-3)
    assert (got_t.numpy()[~hit] == np.float32(3.4028235e38)).all()


@pytest.mark.parametrize("case", sorted(CASES))
def test_closest_matches_intersect_spheres(case):
    """ops/intersect.py::intersect_spheres: same ids, first occurrence on
    ties (the duplicated table must never report the copy)."""
    n, p, dup = CASES[case]
    arrays = _batch(n, p, seed=len(case), dup=dup)
    jo, jd, jc, jr, _ = _jax(*arrays)
    to, td, tc, tr, _ = _torch(*arrays)
    want_t, want_id = j_intersect_spheres(jo, jd, jc, jr)
    got_t, got_id = sb.intersect_spheres(to, td, tc, tr)
    _check_closest(want_t, want_id, got_t, got_id)
    if dup:
        assert int(got_id.max()) < p


@pytest.mark.parametrize("case", sorted(CASES))
def test_closest_matches_pallas_interpret(case):
    """ops/pallas/sphere_kernel.py::intersect_spheres_pallas (the TPU
    kernel the CUDA kernel ports), in interpret mode."""
    n, p, dup = CASES[case]
    arrays = _batch(n, p, seed=len(case), dup=dup)
    jo, jd, jc, jr, _ = _jax(*arrays)
    to, td, tc, tr, _ = _torch(*arrays)
    want_t, want_id = jpk.intersect_spheres_pallas(jo, jd, jc, jr,
                                                   interpret=True)
    got_t, got_id = sb.intersect_spheres(to, td, tc, tr)
    _check_closest(want_t, want_id, got_t, got_id)


# the any-hit cases add: NaN shadow distances, and 1025-sphere tables
# whose one occluder sits at the edge of the CUDA kernel's 1024-sphere
# staging chunk (the last of the first chunk, the first of the ragged
# second), the other spheres 10^5 away
OCCLUDED_CASES = {**{name: (*case, None) for name, case in CASES.items()},
                  "nan_tfar_field_300": (2048, 300, False, "nan"),
                  "edge_1023_of_1025": (1024, 1025, False, 1023),
                  "edge_1024_of_1025": (1024, 1025, False, 1024)}


def _occluded_batch(case):
    n, p, dup, extra = OCCLUDED_CASES[case]
    o, d, c, rsq, tf = _batch(n, p, seed=10 + len(case), dup=dup)
    g = np.random.default_rng(len(case))
    if extra == "nan":
        tf[g.random(n) < 0.1] = np.nan
    elif extra is not None:
        far = np.arange(p, dtype=np.float32) * 3.0
        c = [far, np.full(p, 1e5, np.float32), np.zeros(p, np.float32)]
        rsq = np.ones(p, np.float32)
        for col in c:
            col[extra] = 0.0
        rsq[extra] = 15.0 ** 2
    return o, d, c, rsq, tf


@pytest.mark.parametrize("case", sorted(OCCLUDED_CASES))
def test_occluded_matches_jax(case):
    """ops/intersect.py::occluded_spheres and occluded_spheres_pallas
    (interpret): the same bits, and lanes with tfar <= 0 or NaN never
    occluded; on the edge tables, by the edge sphere alone."""
    arrays = _occluded_batch(case)
    jo, jd, jc, jr, jt = _jax(*arrays)
    to, td, tc, tr, tt = _torch(*arrays)
    got = sb.occluded_spheres(to, td, tt, tc, tr).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(j_occluded_spheres(jo, jd, jt, jc, jr)))
    np.testing.assert_array_equal(
        got, np.asarray(jpk.occluded_spheres_pallas(jo, jd, jt, jc, jr,
                                                    interpret=True)))
    tf = arrays[4]
    assert got.any() and not got[(tf <= 0) | np.isnan(tf)].any()
    at = OCCLUDED_CASES[case][3]
    if isinstance(at, int):
        keep = np.arange(len(arrays[3])) != at
        _, _, c, rsq, _ = arrays
        without = sb.occluded_spheres(
            to, td, tt, TVec3(*(torch.from_numpy(a[keep]) for a in c)),
            torch.from_numpy(rsq[keep]))
        assert not without.numpy().any()


def test_occluded_pairs_false_at_nonpositive_tfar():
    """The CUDA kernel skips lanes with tfar <= 0; the plain predicate must
    be false there for every pair, tangent rays included."""
    o, d, c, rsq, _ = _batch(2048, 64, seed=3)
    to, td, tc, tr, _ = _torch(o, d, c, rsq, np.zeros(2048, np.float32))
    for tfar in (0.0, -1e-30, -2.5, -np.inf):
        tf = torch.full((2048,), tfar, dtype=torch.float32)
        pairs = sb._sphere_occluded_pairs(to, td, tf, tc.x, tc.y, tc.z, tr)
        assert not bool(pairs.any()), tfar


def test_scene_dispatch_on_cpu_takes_plain_version():
    """intersect_scene / occluded_scene on CPU tensors run the plain
    batteries and launch no kernel."""
    from cpu_raytracing_experiments_tpu_torch.scene import builders

    scene = builders.default_scene(16, 16)
    o, d, _, _, tf = _batch(512, 9, seed=4)
    to, td, _, _, tt = _torch(o, d, [np.zeros(1, np.float32)] * 3,
                              np.zeros(1, np.float32), tf)
    sb.reset_counts()
    tfar, prim, is_tri = tint.intersect_scene(scene, to, td)
    occ = tint.occluded_scene(scene, to, td, tt)
    want_t, want_id = sb.intersect_spheres(to, td, scene.spheres.center,
                                           scene.spheres.radius_sq)
    assert torch.equal(prim, want_id) and torch.equal(tfar, want_t)
    assert not bool(is_tri.any())
    assert torch.equal(occ, sb.occluded_spheres(
        to, td, tt, scene.spheres.center, scene.spheres.radius_sq))
    assert sb.CLOSEST.launches == 0 and sb.OCCLUDED.launches == 0


def test_wrapper_refuses_other_devices_and_accels():
    """No silent fallback: a tensor neither on the CPU nor on a CUDA card
    raises, and so does an acceleration structure outside the slice."""
    from cpu_raytracing_experiments_tpu_torch.scene import builders

    meta = TVec3(*(torch.empty(8, device="meta") for _ in range(3)))
    with pytest.raises(ValueError):
        sb.closest_hit(meta, meta, meta, torch.empty(3, device="meta"))
    with pytest.raises(ValueError):
        sb.any_hit(meta, meta, torch.empty(8, device="meta"), meta,
                   torch.empty(3, device="meta"))
    scene = builders.default_scene(16, 16)
    v = TVec3(*(torch.zeros(4) for _ in range(3)))
    for accel in ("bvh", "grid", "clustered"):
        with pytest.raises(NotImplementedError):
            tint.intersect_scene(scene, v, v, accel=accel)
        with pytest.raises(NotImplementedError):
            tint.occluded_scene(scene, v, v, torch.ones(4), accel=accel)
    # the cluster kernels' wrappers refuse a device that is neither, too
    from cpu_raytracing_experiments_tpu_torch.ops.kernels import \
        cluster_traverse as ct
    from cpu_raytracing_experiments_tpu_torch.scene import accel as taccel

    cp = taccel.with_pallas_clusters(
        builders.bvh_test_scene(8, 8), cluster_size=32).sphere_clusters
    tf = torch.empty(8, device="meta")
    with pytest.raises(ValueError):
        ct._plan_visits(cp, meta, meta, tf, tf > 0, 64)
    plan = ct._plan_visits(cp, v, v, torch.ones(4), torch.ones(4) > 0, 64)
    with pytest.raises(ValueError):
        ct.walk_closest(cp, *plan, meta, meta, tf, tf > 0, 64)
    with pytest.raises(ValueError):
        ct.walk_occluded(cp, *plan, meta, meta, tf, 64)


@pytest.mark.cuda
def test_cuda_kernels_equal_plain_versions():
    """On the card: both kernels equal their plain versions bit for bit,
    across a staging-chunk boundary, the any-hit kernel also on NaN shadow
    distances and with its only occluder at the chunk's edge (the full
    check is chip_smoke.py)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py runs this on the H100")
    o, d, c, rsq, tf = _batch(65536, 600, seed=5, dup=True)
    to, td, tc, tr, tt = (x.to("cuda") if isinstance(x, torch.Tensor)
                          else TVec3(*(a.to("cuda") for a in x))
                          for x in _torch(o, d, c, rsq, tf))
    kt, kid = sb.closest_hit(to, td, tc, tr)
    pt, pid = sb.intersect_spheres(to, td, tc, tr)
    assert torch.equal(kid, pid)
    assert torch.equal(kt.view(torch.int32), pt.view(torch.int32))
    assert torch.equal(sb.any_hit(to, td, tt, tc, tr),
                       sb.occluded_spheres(to, td, tt, tc, tr))
    # sphere_occluded on NaN shadow distances and with the only occluder
    # at the staging chunk's edge
    for case in ("nan_tfar_field_300", "edge_1023_of_1025",
                 "edge_1024_of_1025"):
        to, td, tc, tr, tt = (x.to("cuda") if isinstance(x, torch.Tensor)
                              else TVec3(*(a.to("cuda") for a in x))
                              for x in _torch(*_occluded_batch(case)))
        assert torch.equal(sb.any_hit(to, td, tt, tc, tr),
                           sb.occluded_spheres(to, td, tt, tc, tr)), case
