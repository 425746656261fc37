"""The PyTorch port's scene model against the JAX package's
``scene/scene.py`` and ``scene/builders.py``.

``jax_scene_to_numpy`` (test side only: the port never imports the JAX
package) flattens a JAX ``Scene`` into the arrays ``Scene.from_numpy``
reads, with its triangles, its triangle lights, its cluster packs
(``jax_clusters_to_numpy``) and its light alias table where it has them, so
both packages render identical inputs. The port's own builders
must give exactly the JAX builders' arrays."""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from cpu_raytracing_experiments_tpu.core.vec import Vec3 as JVec3
from cpu_raytracing_experiments_tpu.scene import builders as jbuilders
from cpu_raytracing_experiments_tpu.scene import scene as jscene
from cpu_raytracing_experiments_tpu_torch.core.vec import Vec3 as TVec3
from cpu_raytracing_experiments_tpu_torch.scene import builders as tbuilders
from cpu_raytracing_experiments_tpu_torch.scene import scene as tscene

# The suite runs in several worker processes at once: one intra-op thread
# each, or the workers' thread pools fight over the cores.
torch.set_num_threads(1)


def _vec(v):
    return np.stack([np.asarray(c) for c in v], axis=-1)


def jax_clusters_to_numpy(cp) -> dict:
    """Flatten a JAX ClusteredPrims into the dict
    ``ClusteredPrims.from_numpy`` reads."""
    return {
        "rows": np.asarray(cp.rows), "order": np.asarray(cp.order),
        "lo": _vec(cp.lo), "hi": _vec(cp.hi),
        "planes": None if cp.planes is None else np.asarray(cp.planes),
        "glo": None if cp.glo is None else _vec(cp.glo),
        "ghi": None if cp.ghi is None else _vec(cp.ghi),
        "num_clusters": int(cp.num_clusters),
        "cluster_size": int(cp.cluster_size), "kind": str(cp.kind),
    }


def jax_scene_to_numpy(scene) -> dict:
    """Flatten a JAX Scene into the dict ``Scene.from_numpy`` reads."""
    out = {
        "sphere_center": _vec(scene.spheres.center),
        "sphere_radius_sq": np.asarray(scene.spheres.radius_sq),
        "sphere_material_id": np.asarray(scene.spheres.material_id),
        "lights": np.asarray(scene.lights),
        "sky_ambient": _vec(scene.sky.ambient),
        "sky_hdri": np.stack([np.asarray(scene.sky.hdri_r),
                              np.asarray(scene.sky.hdri_g),
                              np.asarray(scene.sky.hdri_b)], axis=-1),
        "sky_width": int(scene.sky.width),
        "sky_height": int(scene.sky.height),
        "camera_pos": _vec(scene.camera.pos),
        "camera_orient": np.stack([np.asarray(c) for c in scene.camera.orient]),
    }
    m = scene.materials
    for k in ("albedo", "f0", "f80", "emission", "transmission"):
        out[f"material_{k}"] = _vec(getattr(m, k))
    for k in ("roughness", "ior_minus_one"):
        out[f"material_{k}"] = np.asarray(getattr(m, k))
    for k in ("half_width", "half_height", "z", "exposure", "aperture_radius",
              "focus_distance"):
        out[f"camera_{k}"] = np.asarray(getattr(scene.camera, k))
    tri = scene.triangles
    if tri is not None:
        for k in ("v0", "e1", "e2", "normal"):
            out[f"tri_{k}"] = _vec(getattr(tri, k))
        out["tri_area"] = np.asarray(tri.area)
        out["tri_material_id"] = np.asarray(tri.material_id)
        out["tri_lights"] = np.asarray(scene.tri_lights)
    for key in ("sphere_clusters", "tri_clusters"):
        if getattr(scene, key) is not None:
            out[key] = jax_clusters_to_numpy(getattr(scene, key))
    la = scene.light_alias
    if la is not None:
        out["light_alias_table"] = np.asarray(la.table)
        out["light_alias_sphere_pdf"] = np.asarray(la.sphere_pdf)
        if la.tri_pdf is not None:
            out["light_alias_tri_pdf"] = np.asarray(la.tri_pdf)
    return out


def _assert_same_arrays(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k in want:
        if isinstance(want[k], dict):  # the clusters' own arrays
            _assert_same_arrays(got[k], want[k])
            continue
        if want[k] is None:
            assert got[k] is None, k
            continue
        a, b = np.asarray(got[k]), np.asarray(want[k])
        assert a.dtype == b.dtype and a.shape == b.shape, (k, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=k)


BUILDERS = ["default_scene", "white_furnace_scene", "bvh_test_scene",
            "random_spheres_scene", "cornell_box_scene"]


@pytest.mark.parametrize("name", BUILDERS)
def test_builder_arrays_equal_jax(name):
    """scene/builders.py: the port's tensors equal the JAX arrays exactly."""
    args = (64, 48)
    want = jax_scene_to_numpy(getattr(jbuilders, name)(*args))
    got = getattr(tbuilders, name)(*args).to_numpy()
    _assert_same_arrays(got, want)


@pytest.mark.parametrize("name", BUILDERS)
def test_from_numpy_round_trip(name):
    """Scene.from_numpy of a flattened JAX scene gives back the same arrays."""
    arrays = jax_scene_to_numpy(getattr(jbuilders, name)(32, 32))
    scene = tscene.Scene.from_numpy(arrays, device="cpu")
    assert scene.spheres.material_id.dtype == torch.int32
    assert scene.lights.dtype == torch.int32
    _assert_same_arrays(scene.to_numpy(), arrays)


def test_camera_resized_matches_jax():
    """scene/scene.py::Camera.resized, bit for bit."""
    jcam = jbuilders.default_scene(256, 256).camera.resized(1920, 1088)
    tcam = tbuilders.default_scene(256, 256).camera.resized(1920, 1088)
    for k in ("half_width", "half_height", "z"):
        assert np.asarray(getattr(jcam, k)) == getattr(tcam, k).numpy(), k


def test_quat_look_at_and_light_list():
    """quat_look_at (:198) and build_light_list (:356) are host numpy in
    both packages: equal to the last bit."""
    for fwd in [(0.1, -0.4, -1), (0, 0, -1), (1, 0.2, 0.3), (0, -0.1, -1)]:
        assert tscene.quat_look_at(fwd, (0, 1, 0)) == jscene.quat_look_at(
            fwd, (0, 1, 0))
    g = np.random.default_rng(0)
    em = g.uniform(0, 1, (8, 3)).astype(np.float32) * (g.random((8, 1)) < 0.5)
    ids = g.integers(0, 8, 100).astype(np.int32)
    np.testing.assert_array_equal(tscene.build_light_list(ids, em),
                                  jscene.build_light_list(ids, em))


def test_sky_sample_matches_jax():
    """Sky.sample: a constant sky exactly; an 8x16 equirect map at the
    texel the JAX lookup picks, except where atan2/asin round across a
    texel edge (at most 0.5% of random directions)."""
    g = np.random.default_rng(1)
    d = g.normal(size=(3, 4096)).astype(np.float32)
    d /= np.linalg.norm(d, axis=0)
    img = g.uniform(0, 4, (8, 16, 3)).astype(np.float32)
    cases = [(jscene.Sky.constant((0.5, 0.6, 0.8)),
              tscene.Sky.constant((0.5, 0.6, 0.8)), 1.0),
             (jscene.Sky.from_image(img, (1.0, 0.5, 2.0)),
              tscene.Sky.from_image(img, (1.0, 0.5, 2.0)), 0.995)]
    for jsky, tsky, need in cases:
        want = _vec(jsky.sample(JVec3(*(jnp.asarray(c) for c in d))))
        got = tsky.sample(TVec3(*(torch.from_numpy(c) for c in d))).stack()
        assert (got.numpy() == want).all(axis=1).mean() >= need
        assert bool(tsky.has_ambient()) == bool(jsky.has_ambient())


def test_triangle_scenes_refused():
    """Triangle geometry is ported, so a scene with triangles is no longer
    refused: it is carried across whole (never dropped), with its triangle
    lights, and ``Scene.to`` keeps it. What stays refused is a flat dict
    that names some triangle arrays and lacks the others."""
    arrays = jax_scene_to_numpy(jbuilders.cornell_box_scene(16, 16))
    scene = tscene.Scene.from_numpy(arrays).to("cpu")
    assert scene.triangles.count == 12 and scene.num_tri_lights == 2
    assert scene.num_lights == 0 and scene.num_prims == 14
    assert scene.triangles.material_id.dtype == torch.int32
    assert scene.tri_lights.dtype == torch.int32
    _assert_same_arrays(scene.to_numpy(), arrays)
    del arrays["tri_area"]
    with pytest.raises(KeyError):
        tscene.Scene.from_numpy(arrays)
