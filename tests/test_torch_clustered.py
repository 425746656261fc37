"""The PyTorch port's cluster build against the JAX package's
``ops/clustered.py``, ``bvh/builder.py`` and ``scene/accel.py``: host numpy
code in both, so every array must be equal to the last bit.

``jax_clusters_to_numpy`` (test side only, beside ``jax_scene_to_numpy`` in
``test_torch_scene.py``) flattens a JAX ``ClusteredPrims`` into the arrays
``ClusteredPrims.from_numpy`` reads, so a JAX scene with clusters attached
becomes the port's and both traverse identical tables."""
import numpy as np
import pytest
import torch

from cpu_raytracing_experiments_tpu.bvh import builder as jbvh
from cpu_raytracing_experiments_tpu.ops import clustered as jcl
from cpu_raytracing_experiments_tpu.scene import accel as jaccel
from cpu_raytracing_experiments_tpu.scene import builders as jbuilders
from cpu_raytracing_experiments_tpu.utils import native as jnative
from cpu_raytracing_experiments_tpu_torch.bvh import builder as tbvh
from cpu_raytracing_experiments_tpu_torch.ops import clustered as tcl
from cpu_raytracing_experiments_tpu_torch.scene import accel as taccel
from cpu_raytracing_experiments_tpu_torch.scene import builders as tbuilders
from cpu_raytracing_experiments_tpu_torch.scene.scene import Scene
from cpu_raytracing_experiments_tpu_torch.utils import native as tnative

from test_torch_scene import (_assert_same_arrays, jax_clusters_to_numpy,
                              jax_scene_to_numpy)

# The suite runs in several worker processes at once: one intra-op thread
# each, or the workers' thread pools fight over the cores.
torch.set_num_threads(1)


def _same_clusters(got: tcl.ClusteredPrims, want):
    _assert_same_arrays(got.to_numpy(), jax_clusters_to_numpy(want))


def _spheres(n, seed):
    g = np.random.default_rng(seed)
    centers = g.uniform(-20, 20, (n, 3)).astype(np.float32)
    radii = g.uniform(0.1, 1.5, n).astype(np.float32)
    rows = np.concatenate([centers, (radii ** 2)[:, None]], axis=1)
    return (*jbvh.sphere_bounds(centers, radii), rows)


def _triangles(n, seed):
    g = np.random.default_rng(seed)
    v0 = g.uniform(-8, 8, (n, 3)).astype(np.float32)
    e1 = g.normal(0, 0.8, (n, 3)).astype(np.float32)
    e2 = g.normal(0, 0.8, (n, 3)).astype(np.float32)
    rows = np.concatenate([v0, e1, e2], axis=1)
    return (*jbvh.triangle_bounds(v0, v0 + e1, v0 + e2), rows)


def test_bounds_equal_jax():
    """bvh/builder.py::sphere_bounds and triangle_bounds."""
    g = np.random.default_rng(0)
    c = g.normal(size=(50, 3)).astype(np.float32)
    r = g.uniform(0.1, 2, 50).astype(np.float32)
    for got, want in zip(tbvh.sphere_bounds(c, r), jbvh.sphere_bounds(c, r)):
        np.testing.assert_array_equal(got, want)
    v = [g.normal(size=(50, 3)).astype(np.float32) for _ in range(3)]
    for got, want in zip(tbvh.triangle_bounds(*v), jbvh.triangle_bounds(*v)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind,fill_window", [
    ("sphere", 1), ("sphere", 2), ("triangle", 1), ("triangle", 2)])
def test_build_clusters_sah_equals_jax(kind, fill_window):
    """ops/clustered.py::build_clusters_sah over the native SAH builder
    (both packages compile the same C++ with the same flags): rows, order,
    bounds and the Baldwin-Weber planes, exactly."""
    if jnative.get_lib() is None:
        pytest.skip("no C++ compiler: neither package has its native builder")
    mins, maxs, rows = (_spheres if kind == "sphere" else _triangles)(700, 3)
    got = tcl.build_clusters_sah(mins, maxs, rows, cluster_size=32, kind=kind,
                                 fill_window=fill_window)
    want = jcl.build_clusters_sah(mins, maxs, rows, cluster_size=32,
                                  kind=kind, fill_window=fill_window)
    assert got.cluster_size == 32 and got.order.dtype == torch.int32
    _same_clusters(got, want)
    # every prim lands in exactly one slot
    order = got.order.numpy()
    assert sorted(order[order >= 0]) == list(range(700))


@pytest.mark.parametrize("kind", ["sphere", "triangle"])
def test_build_tree_equals_jax_native_builder(kind):
    """bvh/builder.py::build_tree: the port's copy of the C++ builder gives
    the JAX package's tree, node for node."""
    if jnative.get_lib() is None:
        pytest.skip("no C++ compiler: neither package has its native builder")
    mins, maxs, _ = (_spheres if kind == "sphere" else _triangles)(300, 4)
    for got, want in zip(tbvh.build_tree(mins, maxs, leaf_size=16),
                         jnative.bvh_build(mins, maxs, leaf_size=16)):
        np.testing.assert_array_equal(got, want)


def test_build_raises_without_compiler(monkeypatch):
    """The port has one tree builder. Where csrc/bvh_builder.cpp cannot be
    compiled the cluster build raises and names what is missing; it does not
    switch to another builder, whose clusters would differ."""
    from cpu_raytracing_experiments_tpu_torch.ops.kernels import build

    monkeypatch.setattr(tnative.LIBRARY, "_lib", None)
    monkeypatch.setattr(build, "BUILD_DIR", build.BUILD_DIR / "none_here")
    monkeypatch.setenv("CXX", "no-such-compiler")
    mins, maxs, rows = _spheres(50, 6)
    with pytest.raises(RuntimeError, match="C\\+\\+ compiler"):
        tcl.build_clusters_sah(mins, maxs, rows, cluster_size=16)
    assert not (build.BUILD_DIR).exists()


@pytest.mark.parametrize("kind,n,num_clusters", [
    ("sphere", 500, 8), ("sphere", 37, 64), ("triangle", 400, 13)])
def test_build_clusters_morton_equals_jax(kind, n, num_clusters):
    """ops/clustered.py::build_clusters (morton chop), _norm_k, _morton3."""
    mins, maxs, rows = (_spheres if kind == "sphere" else _triangles)(n, 5)
    _same_clusters(
        tcl.build_clusters(mins, maxs, rows, num_clusters, kind=kind),
        jcl.build_clusters(mins, maxs, rows, num_clusters, kind=kind))
    for k in (1, 2, 3, 31, 33, 64, 127, 128, 129, 254, 600):
        assert tcl._norm_k(k) == jcl._norm_k(k)


@pytest.mark.parametrize("kw", [
    {}, {"cluster_size": 32}, {"cluster_size": 32, "fill_window": 2},
    {"cluster_size": 32, "method": "morton"}])
def test_with_pallas_clusters_equals_jax(kw):
    """scene/accel.py::with_pallas_clusters on the 255-sphere field: the
    same tables from both packages, and the scene around them untouched."""
    got = taccel.with_pallas_clusters(tbuilders.bvh_test_scene(32, 32), **kw)
    want = jaccel.with_pallas_clusters(jbuilders.bvh_test_scene(32, 32), **kw)
    _same_clusters(got.sphere_clusters, want.sphere_clusters)
    _assert_same_arrays(got.to_numpy(), jax_scene_to_numpy(want))
    np.testing.assert_array_equal(
        taccel.with_clusters(tbuilders.bvh_test_scene(32, 32), 7)
        .sphere_clusters.order.numpy(),
        np.asarray(jaccel.with_clusters(jbuilders.bvh_test_scene(32, 32), 7)
                   .sphere_clusters.order))


def test_from_numpy_carrier_round_trip():
    """ClusteredPrims.from_numpy of flattened JAX clusters gives the same
    arrays back; Scene.to moves the clusters with the scene; the root AABB is
    the union of the cluster bounds."""
    jscene = jaccel.with_pallas_clusters(
        jbuilders.random_spheres_scene(16, 16, num_spheres=400),
        cluster_size=32)
    scene = Scene.from_numpy(jax_scene_to_numpy(jscene), device="cpu")
    cp = scene.sphere_clusters
    _same_clusters(cp, jscene.sphere_clusters)
    assert cp.rows.dtype == torch.float32 and cp.order.dtype == torch.int32
    moved = scene.to("cpu").sphere_clusters
    _same_clusters(moved, jscene.sphere_clusters)
    want_root = [float(c.min()) for c in cp.lo] + [float(c.max())
                                                   for c in cp.hi] + [0, 0]
    np.testing.assert_array_equal(moved.root.numpy(),
                                  np.asarray(want_root, np.float32))


def test_large_sphere_field_builds_and_equals_jax():
    """scene/builders.py::random_spheres_scene at 100,000 spheres (the
    scene of the full-width run on the card), and its K = 128 SAH clusters,
    equal the JAX package's exactly."""
    if jnative.get_lib() is None:
        pytest.skip("no C++ compiler: neither package has its native builder")
    n = 100_000
    tscene = tbuilders.random_spheres_scene(64, 48, num_spheres=n)
    jscene = jbuilders.random_spheres_scene(64, 48, num_spheres=n)
    _assert_same_arrays(tscene.to_numpy(), jax_scene_to_numpy(jscene))
    got = taccel.with_pallas_clusters(tscene).sphere_clusters
    want = jaccel.with_pallas_clusters(jscene).sphere_clusters
    assert got.cluster_size == 128
    _same_clusters(got, want)
