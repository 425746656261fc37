"""The PyTorch port's triangle-mesh scenes against the JAX package's
``scene/meshes.py``, ``scene/builders.py`` (``cornell_box_scene``,
``mesh_scene``) and ``scene/accel.py::with_pallas_clusters``.

Everything here is host numpy in both packages, so every array must be
exactly equal (no tolerance): vertices and faces, the scene's triangle
arrays with ``tri_lights``, and the triangle cluster packs (rows, planes,
order, lo, hi) with the 'auto' cluster size."""
import dataclasses

import numpy as np
import pytest
import torch

from cpu_raytracing_experiments_tpu.scene import accel as jaccel
from cpu_raytracing_experiments_tpu.scene import builders as jbuilders
from cpu_raytracing_experiments_tpu.scene import meshes as jmeshes
from cpu_raytracing_experiments_tpu_torch.scene import accel as taccel
from cpu_raytracing_experiments_tpu_torch.scene import builders as tbuilders
from cpu_raytracing_experiments_tpu_torch.scene import meshes as tmeshes

from test_torch_scene import _assert_same_arrays, jax_scene_to_numpy

# The suite runs in several worker processes at once: one intra-op thread
# each, or the workers' thread pools fight over the cores.
torch.set_num_threads(1)


def _same(got, want):
    for a, b in zip(got, want):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("call", [
    lambda m: m.icosahedron(),
    lambda m: m.subdivide(*m.icosahedron()),
    lambda m: m.displaced_icosphere(2),
    lambda m: m.displaced_icosphere(1, displacement=0.3, seed=11),
    lambda m: m.displaced_uv_sphere(12, 9),
    lambda m: m.displaced_uv_sphere(5, 7, displacement=0.05, seed=3),
], ids=["icosahedron", "subdivide", "icosphere_2", "icosphere_seed",
        "uv_12x9", "uv_seed"])
def test_meshes_equal_jax(call):
    """scene/meshes.py: the same vertices (dtype included) and faces."""
    _same(call(tmeshes), call(jmeshes))


def test_mesh_to_triangles_and_load_obj(tmp_path):
    """``mesh_to_triangles`` on a displaced icosphere, and ``load_obj`` on
    an OBJ written here: a quad and a pentagon (fans), with v/vt/vn face
    records and a comment line."""
    v, f = tmeshes.displaced_icosphere(1)
    got, want = (m.mesh_to_triangles(v, f, 3) for m in (tmeshes, jmeshes))
    assert sorted(got) == sorted(want)
    _same([got[k] for k in sorted(got)], [want[k] for k in sorted(want)])
    g = np.random.default_rng(5)
    path = tmp_path / "fan.obj"
    lines = ["# a comment"] + [
        "v " + " ".join(f"{c:.6f}" for c in row)
        for row in g.uniform(-1, 1, (9, 3))]
    lines += ["f 1 2 3 4", "f 5/1/1 6/2/1 7/3/1 8/4/1 9/5/1", "vn 0 0 1"]
    path.write_text("\n".join(lines) + "\n")
    got, want = tmeshes.load_obj(path), jmeshes.load_obj(path)
    _same(got, want)
    assert got[0].shape == (9, 3) and got[1].shape == (2 + 3, 3)


MESH_CASES = {
    "cornell": ("cornell_box_scene", {}),
    "mesh_subdiv2": ("mesh_scene", {"subdivisions": 2}),
    "mesh_uv16": ("mesh_scene", {"uv_res": 16}),
}


@pytest.mark.parametrize("case", sorted(MESH_CASES))
def test_triangle_builder_arrays_equal_jax(case):
    """cornell_box_scene and mesh_scene: every array of the scene equals the
    JAX package's, the triangle arrays and ``tri_lights`` among them."""
    name, kw = MESH_CASES[case]
    want = jax_scene_to_numpy(getattr(jbuilders, name)(48, 32, **kw))
    got = getattr(tbuilders, name)(48, 32, **kw).to_numpy()
    assert "tri_v0" in want and "tri_lights" in want
    _assert_same_arrays(got, want)


def test_mesh_scene_from_obj_equals_jax(tmp_path):
    """mesh_scene(obj_path=...): the OBJ branch, with its normalisation."""
    v, f = tmeshes.displaced_icosphere(1)
    path = tmp_path / "blob.obj"
    path.write_text("".join(f"v {a:.7f} {b:.7f} {c:.7f}\n" for a, b, c in v)
                    + "".join(f"f {a + 1} {b + 1} {c + 1}\n" for a, b, c in f))
    want = jax_scene_to_numpy(jbuilders.mesh_scene(16, 16, obj_path=path))
    got = tbuilders.mesh_scene(16, 16, obj_path=path).to_numpy()
    assert want["tri_v0"].shape == (80, 3)
    _assert_same_arrays(got, want)


@pytest.mark.parametrize("case,cluster_size", [
    ("cornell", 32), ("mesh_subdiv2", "auto"), ("mesh_uv16", 128),
    ("mesh_uv16", 32)])
def test_tri_clusters_equal_jax(case, cluster_size):
    """with_pallas_clusters (SAH) attaches ``tri_clusters`` beside
    ``sphere_clusters``: rows, planes, order, lo and hi equal the JAX
    package's, and so does the cluster size 'auto' picks."""
    name, kw = MESH_CASES[case]
    want = jax_scene_to_numpy(jaccel.with_pallas_clusters(
        getattr(jbuilders, name)(16, 16, **kw), cluster_size=cluster_size))
    scene = taccel.with_pallas_clusters(
        getattr(tbuilders, name)(16, 16, **kw), cluster_size=cluster_size)
    got = scene.to_numpy()
    assert got["tri_clusters"]["planes"] is not None
    assert got["tri_clusters"]["kind"] == "triangle"
    _assert_same_arrays(got, want)
    assert scene.to("cpu").tri_clusters.num_clusters \
        == want["tri_clusters"]["num_clusters"]


def test_morton_tri_clusters_and_auto_k_equal_jax():
    """method='morton' cuts the triangles at their own cluster count, and
    'auto' takes the larger of the sphere and the triangle count: 64 below
    50,000 prims, 128 below 200,000, else 256 (checked on scenes whose
    triangle arrays are widened, not built, to those counts)."""
    jscene, tscene = (b.mesh_scene(16, 16, uv_res=16)
                      for b in (jbuilders, tbuilders))
    want = jax_scene_to_numpy(jaccel.with_pallas_clusters(
        jscene, cluster_size=64, method="morton"))
    got = taccel.with_pallas_clusters(tscene, cluster_size=64,
                                      method="morton").to_numpy()
    assert want["tri_clusters"]["num_clusters"] == 8
    _assert_same_arrays(got, want)

    picked = []

    def spy(scene, cluster_size, *options):
        picked.append(cluster_size)
        return scene

    real = taccel._with_sah_clusters
    taccel._with_sah_clusters = spy
    try:
        for count in (512, 49_999, 50_000, 199_999, 200_000):
            tri = tscene.triangles
            wide = dataclasses.replace(tri, material_id=torch.zeros(
                count, dtype=torch.int32))
            taccel.with_pallas_clusters(
                dataclasses.replace(tscene, triangles=wide))
    finally:
        taccel._with_sah_clusters = real
    assert picked == [64, 64, 128, 128, 256]
