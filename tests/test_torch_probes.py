"""The port's probes, AOVs, ambient occlusion, denoiser and numerical guards
against the JAX package, on the CPU: ``render/probes.py``, ``render/ao.py``,
``render/denoise.py`` and ``render/validate.py``.

The JAX reference for the AOVs and AO is the jitted one whose rsqrt, sin and
cos round correctly (``test_torch_knobs.py::jax_exact_math``): equal bits.
The depth probe of the JAX package runs eagerly (no contraction) and the
denoiser takes exp in 25 taps an iteration: both are held at a stated
tolerance.
"""
import dataclasses

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from cpu_raytracing_experiments_tpu.core.vec import Vec3 as JVec3
from cpu_raytracing_experiments_tpu.render import ao as jao
from cpu_raytracing_experiments_tpu.render import denoise as jdenoise
from cpu_raytracing_experiments_tpu.render import probes as jprobes
from cpu_raytracing_experiments_tpu.render import validate as jvalidate
from cpu_raytracing_experiments_tpu.render.api import Renderer as JRenderer
from cpu_raytracing_experiments_tpu.scene import builders as jbuilders
from cpu_raytracing_experiments_tpu.scene.scene import Sky as JSky
from cpu_raytracing_experiments_tpu.utils.config import RendererPolicy as JPolicy
from cpu_raytracing_experiments_tpu_torch import Renderer
from cpu_raytracing_experiments_tpu_torch.render import ao, denoise, probes
from cpu_raytracing_experiments_tpu_torch.render import validate
from cpu_raytracing_experiments_tpu_torch.scene.scene import Scene
from cpu_raytracing_experiments_tpu_torch.utils.config import RendererPolicy

from test_torch_knobs import jax_exact_math  # noqa: F401
from test_torch_render import jax_exact_rsqrt  # noqa: F401
from test_torch_scene import jax_scene_to_numpy

torch.set_num_threads(1)

KNOBS = dict(max_bounces=3, rays_per_chunk=2048)
JPOL, TPOL = JPolicy(**KNOBS), RendererPolicy(**KNOBS)


def _port(jscene):
    return Scene.from_numpy(jax_scene_to_numpy(jscene), device="cpu")


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32 if a.dtype == np.float32 else np.int64)


@pytest.mark.parametrize("name", ["default_scene", "bvh_test_scene",
                                  "white_furnace_scene"])
def test_probe_depth_and_autofocus_match_jax(name, jax_exact_rsqrt):
    """render/probes.py::probe_depth and autofocus against the JAX
    package's, with its rsqrt correctly rounded, on a grid of 64 pixels
    of a 64x64 frame: the same pixels hit (inf on a miss), depths within
    rtol 1e-4. Not bit for bit: the JAX probe runs eagerly, without XLA's
    contractions, and the port's ray is made and traced as the render path
    makes and traces it (grazing hits of bvh_test's spheres read ~4e-5
    apart, the hero's floor 1 ulp). The white furnace's centre ray hits the
    unit sphere at 2 (tests/test_probes_ris.py)."""
    jscene = getattr(jbuilders, name)(64, 64)
    tscene = _port(jscene)
    grid = [(x, y) for y in range(0, 64, 9) for x in range(0, 64, 9)]
    want = np.asarray([jprobes.probe_depth(jscene, x, y, 64, 64)
                       for x, y in grid])
    got = np.asarray([probes.probe_depth(tscene, x, y, 64, 64)
                      for x, y in grid])
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-4)
    focused = probes.autofocus(tscene, 32, 32, 64, 64)
    assert float(focused.camera.focus_distance) == np.float32(
        probes.probe_depth(tscene, 32, 32, 64, 64))
    np.testing.assert_allclose(
        float(focused.camera.focus_distance),
        float(jprobes.autofocus(jscene, 32, 32, 64, 64).camera
              .focus_distance), rtol=1e-4)
    if name == "white_furnace_scene":
        assert abs(float(focused.camera.focus_distance) - 2.0) < 1e-3
    if name == "default_scene":  # the sky: a miss
        assert probes.probe_depth(tscene, 32, 63, 64, 64) == float("inf")


@pytest.mark.parametrize("samples,knobs", [
    (1, {}), (4, {}), (2, {"enable_dof": True, "stratify_camera": True})])
def test_render_aovs_match_jax(samples, knobs, jax_exact_math):
    """render/probes.py::render_aovs against the JAX package's on the hero
    at 24x24 (a 1024-ray chunk, so the port's AOVs come in chunks): depth,
    normal, albedo and prim_id bit for bit, with one camera sample and with
    4 averaged on the host in float64 (and 2 through the thin lens,
    stratified)."""
    w = 24
    jscene = jbuilders.default_scene(w, w)
    jpol = dataclasses.replace(JPOL, rays_per_chunk=1024, **knobs)
    tpol = dataclasses.replace(TPOL, rays_per_chunk=1024, **knobs)
    want = jprobes.render_aovs(jscene, jpol, w, w, samples=samples)
    got = probes.render_aovs(_port(jscene), tpol, w, w, samples=samples)
    assert sorted(got) == sorted(want)
    for key in want:
        a, b = np.asarray(got[key]), np.asarray(want[key])
        assert a.dtype == b.dtype and a.shape == b.shape, key
        assert np.array_equal(_bits(a), _bits(b)), key
    if not knobs:  # the sky, top left
        assert np.isinf(got["depth"][0, 0]) and got["prim_id"][0, 0] == -1


@pytest.mark.parametrize("samples,radius", [(16, 2.0), (3, 1e3)])
def test_render_ao_matches_jax(samples, radius, jax_exact_math):
    """render/ao.py::render_ao against the JAX package's ``_ao_pass`` on the
    hero at 24x24: bit for bit (the probes' draws from hash_2d(2, seed + k),
    the cosine lobe, tfar = 0 on a miss, the mean as a product by
    float32(1 / samples) fused with 1 - ..., so that 3 occluded probes of 3
    read -2.98e-8); sky pixels read 1 and some are occluded."""
    w = 24
    jscene = jbuilders.default_scene(w, w)
    want = jao.render_ao(jscene, JPOL, w, w, samples=samples, radius=radius)
    tpol = dataclasses.replace(TPOL, rays_per_chunk=256)
    got = ao.render_ao(_port(jscene), tpol, w, w, samples=samples,
                       radius=radius)
    assert got.shape == (w, w, 3) and got.dtype == np.float32
    assert np.array_equal(_bits(got), _bits(want))
    assert got.max() == 1.0 and got.min() < 0.9
    if samples == 3:  # 1 - 3 * float32(1/3) rounded once
        assert got.min() == np.float32(1.0 - 3.0 * float(np.float32(1 / 3)))
        assert got.min() < 0.0


def _guides(w=16):
    """Noisy hero radiance and its AOVs from the JAX package, as numpy."""
    jscene = jbuilders.default_scene(w, w)
    r = JRenderer(jscene, JPOL, w, w)
    r.accumulate(5)
    aovs = jprobes.render_aovs(jscene, JPOL, w, w, samples=2)
    return (np.asarray(r.render(tonemap=False)),
            np.asarray(aovs["albedo"], np.float32),
            np.asarray(aovs["normal"], np.float32), aovs["depth"],
            np.asarray(r.variance_map()))


@pytest.mark.parametrize("guided", [False, True])
def test_atrous_denoise_matches_jax(guided):
    """render/denoise.py::atrous_denoise against the JAX package's jitted
    one on the same guides (a 5-pass hero at 16x16, the AOVs averaged over
    2 samples, with and without the bucket-spread variance, sigma_l 4 and
    25): within rtol 1e-5 / atol 1e-6 (exp differs by ulps between XLA and
    PyTorch, and XLA contracts the weight products); with no iteration
    (demodulate, then remodulate) bit for bit. Numpy guides are filtered on
    the host."""
    hdr, alb, nrm, dep, var = _guides()
    variance = var if guided else None
    for sigma_l in (4.0, 25.0):
        want = jdenoise.atrous_denoise(
            jnp.asarray(hdr), jnp.asarray(alb), jnp.asarray(nrm),
            jnp.asarray(dep), sigma_l=sigma_l,
            variance=None if variance is None else jnp.asarray(variance))
        got = denoise.atrous_denoise(hdr, alb, nrm, dep, sigma_l=sigma_l,
                                     variance=variance)
        assert got.device.type == "cpu"
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-6)
    want = jdenoise.atrous_denoise(jnp.asarray(hdr), jnp.asarray(alb),
                                   jnp.asarray(nrm), jnp.asarray(dep),
                                   iterations=0)
    got = denoise.atrous_denoise(torch.from_numpy(hdr.copy()),
                                 torch.from_numpy(alb), torch.from_numpy(nrm),
                                 torch.from_numpy(dep.copy()), iterations=0)
    assert np.array_equal(_bits(got.numpy()), _bits(want))


@pytest.mark.parametrize("guided", [False, True])
def test_denoise_render_matches_jax(guided, jax_exact_math):
    """render/denoise.py::denoise_render against the JAX package's on a
    5-pass hero at 16x16 (its render and AOVs bit-equal under the exact-math
    witness): within rtol 1e-5 / atol 1e-6 of the tonemapped image (the JAX
    package tonemaps eagerly, without contractions), fixed and
    variance-guided (sigma_l 25)."""
    w = 16
    jscene = jbuilders.default_scene(w, w)
    jr_ = JRenderer(jscene, JPOL, w, w)
    tr_ = Renderer(_port(jscene), TPOL, w, w, device="cpu")
    jr_.accumulate(5)
    tr_.accumulate(5)
    kw = dict(variance_guided=guided, sigma_l=25.0 if guided else 4.0)
    want = jdenoise.denoise_render(jr_, **kw)
    got = denoise.denoise_render(tr_, **kw)
    assert got.shape == (w, w, 3) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def _nan_albedo(scene, jax_side: bool):
    """tests/test_validate.py:21-37: the floor's albedo (material 0) NaN."""
    mats = scene.materials
    if jax_side:
        bad = JVec3(mats.albedo.x.at[0].set(jnp.nan), mats.albedo.y,
                    mats.albedo.z)
    else:
        x = mats.albedo.x.clone()
        x[0] = float("nan")
        bad = type(mats.albedo)(x, mats.albedo.y, mats.albedo.z)
    return dataclasses.replace(
        scene, materials=dataclasses.replace(mats, albedo=bad))


def test_check_render_matches_jax(jax_exact_math):
    """render/validate.py::check_render against the JAX package's checkify
    guard (hero 16x16, 4 bounces): a clean scene passes and returns the
    pass's radiance; with the floor's albedo NaN both raise with the same
    message and the same first bad pixel ("non-finite radiance in channel r
    (first bad pixel i)"; JAX appends "(`check` failed)")."""
    pol = dict(max_bounces=4, rays_per_chunk=1024)
    jscene = jbuilders.default_scene(16, 16)
    tscene = _port(jscene)
    rad = validate.check_render(tscene, RendererPolicy(**pol), 16, 16)
    assert torch.isfinite(rad.x).all() and rad.x.shape == (256,)
    with pytest.raises(Exception) as jerr:
        jvalidate.check_render(_nan_albedo(jscene, True), JPolicy(**pol), 16,
                               16)
    with pytest.raises(FloatingPointError) as terr:
        validate.check_render(_nan_albedo(tscene, False),
                              RendererPolicy(**pol), 16, 16)
    assert str(terr.value).startswith("non-finite radiance in channel r")
    assert str(jerr.value).startswith(str(terr.value) + " ")


def test_validate_scene_matches_jax():
    """render/validate.py::validate_scene against the JAX package's on the
    scenes of tests/test_validate.py (clean; a white furnace under a black
    sky; a sphere's material id out of range) and on more broken ones (a
    non-positive radius, a NaN centre, negative emission, cornell with a
    triangle's material out of range and one of zero area): the same problem
    list."""
    import jax.numpy as jnp_

    hero = jbuilders.default_scene(16, 16)
    sp = hero.spheres
    cases = [
        hero,
        dataclasses.replace(jbuilders.white_furnace_scene(8, 8),
                            sky=JSky.constant((0, 0, 0))),
        dataclasses.replace(hero, spheres=dataclasses.replace(
            sp, material_id=sp.material_id.at[0].set(99))),
        dataclasses.replace(hero, spheres=dataclasses.replace(
            sp, radius_sq=sp.radius_sq.at[2].set(0.0),
            center=JVec3(sp.center.x.at[1].set(jnp_.nan), sp.center.y,
                         sp.center.z))),
        dataclasses.replace(hero, materials=dataclasses.replace(
            hero.materials, emission=JVec3(
                hero.materials.emission.x.at[1].set(-1.0),
                hero.materials.emission.y, hero.materials.emission.z))),
    ]
    cornell = jbuilders.cornell_box_scene(8, 8)
    tri = cornell.triangles
    cases.append(dataclasses.replace(cornell, triangles=dataclasses.replace(
        tri, material_id=tri.material_id.at[0].set(-1),
        area=tri.area.at[3].set(0.0))))
    for k, jscene in enumerate(cases):
        want = jvalidate.validate_scene(jscene)
        assert validate.validate_scene(_port(jscene)) == want, k
        assert bool(want) == (k > 0), k
