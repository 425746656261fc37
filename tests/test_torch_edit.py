"""Scene edits, the fly camera, Renderer.resize / update_scene and the named
presets of the PyTorch port against the JAX package, on the CPU:
``scene/edit.py``, ``render/api.py`` and ``models/presets.py``.

Edits are compared through the flat arrays both packages' scenes give
(``Scene.to_numpy`` and the test-side ``jax_scene_to_numpy``): equal arrays,
the light lists and the alias table rebuilt by ``apply_invalidation``
included. Renders after an edit are compared with the JAX renderer whose
rsqrt, sin and cos round correctly (``test_torch_knobs.py::jax_exact_math``),
bit for bit.
"""
import dataclasses

import numpy as np
import pytest
import torch

from cpu_raytracing_experiments_tpu.models import presets as jpresets
from cpu_raytracing_experiments_tpu.render.api import Renderer as JRenderer
from cpu_raytracing_experiments_tpu.scene import builders as jbuilders
from cpu_raytracing_experiments_tpu.scene import edit as jedit
from cpu_raytracing_experiments_tpu.utils.config import RendererPolicy as JPolicy
from cpu_raytracing_experiments_tpu_torch import Renderer
from cpu_raytracing_experiments_tpu_torch.models import presets
from cpu_raytracing_experiments_tpu_torch.scene import accel, builders, edit
from cpu_raytracing_experiments_tpu_torch.scene.scene import Scene
from cpu_raytracing_experiments_tpu_torch.utils.config import RendererPolicy

from test_torch_knobs import jax_exact_math  # noqa: F401
from test_torch_scene import _assert_same_arrays, jax_scene_to_numpy

torch.set_num_threads(1)

KNOBS = dict(max_bounces=3, rays_per_chunk=2048)

# (edit, args, kwargs) applied to both packages' scenes; material 0 is the
# hero's floor, sphere 0 the floor sphere, the lights' material is looked up
EDITS = [
    ("set_sphere", (3,), dict(position=(0.25, 0.5, -1.0))),
    ("set_sphere", (2,), dict(radius=0.3)),
    ("set_sphere", (4,), dict(material_id=1)),
    ("set_sphere", (1,), dict(position=(0.1, 0.2, 0.3), radius=0.7,
                              material_id=0)),
    ("set_material", (0,), dict(albedo=(0.2, 0.3, 0.4), roughness=0.35)),
    ("set_material", ("light",), dict(emission=(0.0, 0.0, 0.0))),
    ("set_material", (1,), dict(emission=(2.0, 1.0, 0.5),
                                ior_minus_one=0.45)),
    ("set_ambient", ((0.1, 0.2, 0.3),), {}),
    ("set_camera", (), dict(pos=(1.0, 2.0, 3.0), exposure=2.0,
                            focus_distance=4.0, aperture_radius=0.01)),
]


def _args(jscene, args):
    light_mat = int(jscene.spheres.material_id[int(jscene.lights[0])])
    return tuple(light_mat if a == "light" else a for a in args)


@pytest.mark.parametrize("name,args,kwargs", EDITS,
                         ids=[f"{e[0]}{i}" for i, e in enumerate(EDITS)])
def test_edit_matches_jax(name, args, kwargs):
    """scene/edit.py: each edit and apply_invalidation against the JAX
    package's on the hero (32x32): the same flags, the same
    needs_bvh / needs_light_list, and equal flat arrays before and after
    the invalidation (lights, alias table); the scene given to the edit is
    left as it was."""
    jscene = jbuilders.default_scene(32, 32)
    tscene = Scene.from_numpy(jax_scene_to_numpy(jscene))
    before = tscene.to_numpy()
    args = _args(jscene, args)
    js, jflags = getattr(jedit, name)(jscene, *args, **kwargs)
    ts, tflags = getattr(edit, name)(tscene, *args, **kwargs)
    assert int(tflags) == int(jflags)
    assert (tflags.needs_bvh, tflags.needs_light_list) \
        == (jflags.needs_bvh, jflags.needs_light_list)
    _assert_same_arrays(ts.to_numpy(), jax_scene_to_numpy(js))
    _assert_same_arrays(tscene.to_numpy(), before)
    js = jedit.apply_invalidation(js, jflags)
    ts = edit.apply_invalidation(ts, tflags)
    _assert_same_arrays(ts.to_numpy(), jax_scene_to_numpy(js))


def test_invalidation_rebuilds_triangle_lights_and_keeps_clusters():
    """apply_invalidation on cornell (triangle lights): making a wall
    material emissive and killing the ceiling light rebuilds tri_lights
    and the alias table's triangle pdfs as the JAX package does; on a
    scene with cluster packs a geometry edit leaves the packs as they were
    in both packages (the clusters go stale: ROADMAP queue 3)."""
    jscene = jbuilders.cornell_box_scene(16, 16)
    tscene = Scene.from_numpy(jax_scene_to_numpy(jscene))
    tri_light_mat = int(jscene.triangles.material_id[int(
        jscene.tri_lights[0])])
    js, f = jedit.set_material(jscene, tri_light_mat,
                               emission=(0.0, 0.0, 0.0))
    js, f2 = jedit.set_material(js, 1, emission=(0.5, 0.5, 0.5))
    js = jedit.apply_invalidation(js, f | f2)
    ts, f = edit.set_material(tscene, tri_light_mat,
                              emission=(0.0, 0.0, 0.0))
    ts, f2 = edit.set_material(ts, 1, emission=(0.5, 0.5, 0.5))
    ts = edit.apply_invalidation(ts, f | f2)
    assert not torch.equal(ts.tri_lights, tscene.tri_lights)
    _assert_same_arrays(ts.to_numpy(), jax_scene_to_numpy(js))

    packed = accel.with_pallas_clusters(
        builders.random_spheres_scene(8, 8, num_spheres=200), cluster_size=32)
    moved, flags = edit.set_sphere(packed, 5, position=(9.0, 9.0, 9.0))
    moved = edit.apply_invalidation(moved, flags)
    assert flags.needs_bvh
    assert moved.sphere_clusters is packed.sphere_clusters


def test_scene_editor_commit_resets_and_renders_the_edit(jax_exact_math):
    """SceneEditor (after tests/test_components.py:98-118) on a port
    Renderer: edits reach the renderer's scene, commit rebuilds the lights
    and resets the accumulator; the next render equals, bit for bit, that of
    a Renderer made on the edited scene and the JAX package's after the same
    edit; a commit without edits keeps the accumulator."""
    w = 16
    pol = RendererPolicy(**KNOBS)
    jscene = jbuilders.default_scene(w, w)
    r = Renderer(Scene.from_numpy(jax_scene_to_numpy(jscene)), pol, w, w,
                 device="cpu")
    r.accumulate(5)
    editor = edit.SceneEditor(r)
    editor.commit()
    assert r.state.accumulations == 5
    editor.edit(edit.set_sphere, 3, position=(0.2, 0.4, -0.8))
    editor.edit(edit.set_material, 2, emission=(3.0, 3.0, 3.0))
    assert r.state.accumulations == 5
    editor.commit()
    assert r.state.accumulations == 0 and editor.flags == 0
    r.accumulate(5)
    fresh = Renderer(r.scene, pol, w, w, device="cpu")
    fresh.accumulate(5)
    assert torch.equal(r.state.buckets, fresh.state.buckets)
    jr_ = JRenderer(jscene, JPolicy(**KNOBS), w, w)
    jeditor = jedit.SceneEditor(jr_)
    jeditor.edit(jedit.set_sphere, 3, position=(0.2, 0.4, -0.8))
    jeditor.edit(jedit.set_material, 2, emission=(3.0, 3.0, 3.0)).commit()
    jr_.accumulate(5)
    assert np.array_equal(r.state.buckets.numpy(),
                          np.asarray(jr_.state.buckets))


def test_fly_camera_matches_jax():
    """rotate_camera_local, translate_camera_local and set_camera_lens
    (host float64 quaternion math, Camera.hpp:47-59) against the JAX
    package's: equal camera arrays; after tests/test_components.py:178-206
    and :306-330, translating along -Z moves along the view direction and a
    rotation keeps a unit quaternion."""
    jscene = jbuilders.default_scene(32, 32)
    tscene = Scene.from_numpy(jax_scene_to_numpy(jscene))
    for name, args in (("rotate_camera_local", ((0.1, -0.2, 0.05),)),
                       ("translate_camera_local", ((0.0, 0.0, -1.0),)),
                       ("translate_camera_local", ((0.3, -0.2, 0.7),)),
                       ("set_camera_lens", (32, 32, 80.0)),
                       ("set_camera_lens", (32, 32, 50.0, 2.0)),
                       ("set_camera_lens", (32, 32, None, None, 2.5, 3.0))):
        js, jflags = getattr(jedit, name)(jscene, *args)
        ts, tflags = getattr(edit, name)(tscene, *args)
        assert int(tflags) == int(jflags) == int(edit.SceneUpdate.CAMERA)
        _assert_same_arrays(ts.to_numpy(), jax_scene_to_numpy(js))
    moved, _ = edit.translate_camera_local(tscene, (0.0, 0.0, -1.0))
    step = np.array([float(a) - float(b) for a, b in
                     zip(moved.camera.pos, tscene.camera.pos)])
    fwd = np.array([0.1, -0.4, -1.0])
    np.testing.assert_allclose(step, fwd / np.linalg.norm(fwd), atol=1e-5)
    turned, _ = edit.rotate_camera_local(tscene, (0.1, -0.2, 0.05))
    assert abs(np.linalg.norm(edit._camera_quat(turned)) - 1.0) < 1e-6


def test_renderer_resize_and_update_scene(jax_exact_math):
    """Renderer.resize (Renderer::Resize, after
    tests/test_components.py:289-303): new frame, the camera rescaled as the
    JAX package rescales it, the accumulator reset; the next passes equal
    the JAX package's after the same resize bit for bit. update_scene:
    the new scene moved to the render device, the accumulator reset, and
    the next passes equal a Renderer made on that scene."""
    jscene = jbuilders.default_scene(32, 32)
    tscene = Scene.from_numpy(jax_scene_to_numpy(jscene))
    r = Renderer(tscene, RendererPolicy(**KNOBS), 32, 32, device="cpu")
    r.accumulate(5)
    r.resize(24, 12)
    assert r.state.accumulations == 0
    assert r.state.buckets.shape == (5, 3, 24 * 12)
    assert float(r.scene.camera.half_width) == 12.0
    assert float(r.scene.camera.half_height) == 6.0
    jr_ = JRenderer(jscene, JPolicy(**KNOBS), 32, 32)
    jr_.resize(24, 12)
    _assert_same_arrays(r.scene.to_numpy(), jax_scene_to_numpy(jr_.scene))
    r.accumulate(5)
    jr_.accumulate(5)
    img = r.render(tonemap=False)
    assert img.shape == (12, 24, 3) and np.isfinite(img).all()
    assert np.array_equal(r.state.buckets.numpy(),
                          np.asarray(jr_.state.buckets))

    other = builders.white_furnace_scene(24, 12)
    r.update_scene(other)
    assert r.state.accumulations == 0 and r.scene.device.type == "cpu"
    r.accumulate(5)
    fresh = Renderer(other, RendererPolicy(**KNOBS), 24, 12, device="cpu")
    fresh.accumulate(5)
    assert torch.equal(r.state.buckets, fresh.state.buckets)


def test_presets_match_jax():
    """models/presets.py: the seven presets equal the JAX package's field
    for field; get() looks one up and overrides fields (after
    tests/test_presets.py:10-15)."""
    assert list(presets.PRESETS) == list(jpresets.PRESETS)
    for name, pol in presets.PRESETS.items():
        assert isinstance(pol, RendererPolicy)
        assert dataclasses.asdict(pol) \
            == dataclasses.asdict(jpresets.PRESETS[name]), name
    p = presets.get("production")
    assert p is presets.PRODUCTION
    assert p.brdf == "principled" and p.light_sampling == "power"
    q = presets.get("production", max_bounces=6)
    assert q.max_bounces == 6 and presets.PRODUCTION.max_bounces == 12
    assert presets.get("reference_compat").sky_bug_compat


@pytest.mark.parametrize("name", list(presets.PRESETS))
def test_every_preset_renders(name):
    """Each preset renders the hero at 16x16 on the CPU, 5 passes, at most 4
    bounces, to a finite image (tests/test_presets.py::
    test_every_preset_renders); THROUGHPUT walks the scene's cluster packs
    (accel='pallas')."""
    scene = builders.default_scene(16, 16)
    pol = presets.get(name, rays_per_chunk=2048,
                      max_bounces=min(presets.PRESETS[name].max_bounces, 4))
    if pol.accel == "pallas":
        scene = accel.with_pallas_clusters(scene)
    img = Renderer(scene, pol, 16, 16, device="cpu").render_spp(
        5, tonemap=False)
    assert img.shape == (16, 16, 3) and np.isfinite(img).all()
