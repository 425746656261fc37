"""The camera knobs of the port (``render/renderer.py``:
``generate_camera_rays`` with ``enable_dof``, ``stratify_camera`` and
``rng_scramble``, and ``core/rng.py::site_state``) against the JAX package's jitted
renderer on the CPU.

Tolerances:
* camera rays, against the JAX package with correctly rounded rsqrt, sin
  and cos (``jax_exact_math``): origins and directions bit for bit, the
  thin lens's origin included (XLA drops the zero z of the lens point in
  ``orient.rotate`` and fuses t.z*w with the cross term there);
* RNG site states: equal integers;
* ``bounce_step`` under ``rng_scramble``: the bar of
  ``test_torch_knobs.check_bounce_steps``;
* ``render_pass`` with the three knobs together: bit for bit against the
  exact-math witness;
* a whole render of ``builders.dof_scene`` (the hero with the camera of
  the ``dof`` golden) through ``Renderer(device="cpu")`` against the
  checked-in golden at ``tests/test_goldens.py::_check``'s bar.
"""
import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from cpu_raytracing_experiments_tpu.render import renderer as jr
from cpu_raytracing_experiments_tpu.scene import builders as jbuilders
from cpu_raytracing_experiments_tpu_torch import Renderer
from cpu_raytracing_experiments_tpu_torch.core import rng as trng
from cpu_raytracing_experiments_tpu_torch.render import renderer as tr
from cpu_raytracing_experiments_tpu_torch.scene import builders as tbuilders
from cpu_raytracing_experiments_tpu_torch.scene.scene import Scene

from test_goldens import SIZE, SPP, _check
from test_torch_knobs import (check_bounce_steps, jax_exact_math,  # noqa: F401
                              policies)
from test_torch_render import _stack
from test_torch_scene import jax_scene_to_numpy

torch.set_num_threads(1)

CAMERA_KNOBS = [
    pytest.param({}, id="pinhole"),
    pytest.param({"enable_dof": True}, id="dof"),
    pytest.param({"stratify_camera": True}, id="stratify"),
    pytest.param({"rng_scramble": True}, id="scramble"),
    pytest.param({"enable_dof": True, "stratify_camera": True,
                  "rng_scramble": True}, id="all_three"),
]


def dof_scene(w, h):
    """The JAX package's hero with the camera of the port's
    ``builders.dof_scene``."""
    cam = tbuilders.dof_scene(w, h).camera
    jscene = jbuilders.default_scene(w, h)
    return dataclasses.replace(jscene, camera=dataclasses.replace(
        jscene.camera, focus_distance=jnp.float32(cam.focus_distance.item()),
        aperture_radius=jnp.float32(cam.aperture_radius.item())))


def _bits(v):
    return _stack(v).view(np.int32)


@pytest.mark.parametrize("knobs", CAMERA_KNOBS)
def test_camera_rays_match_jax(knobs, jax_exact_math):
    """generate_camera_rays at accumulations 1, 7, 123457 and 2^32 - 1 (the
    van der Corput index reversed, the golden-ratio product of a large
    float): origins and directions bit for bit; and with one accumulation
    index a lane (the wide launch of k passes), the same rays."""
    w = h = 64
    jpol, tpol = policies(**knobs)
    jscene = dof_scene(w, h)
    tscene = Scene.from_numpy(jax_scene_to_numpy(jscene), device="cpu")
    i = np.arange(w * h)
    camera = jax.jit(lambda s, a: jr.generate_camera_rays(
        s.camera, jnp.asarray(i % w, jnp.int32),
        jnp.asarray(i // w, jnp.int32), a, jr.pixel_seeds(w, h, jpol),
        jpol.enable_dof, jpol))
    tx, ty = torch.from_numpy(i % w), torch.from_numpy(i // w)
    seeds = tr.pixel_seeds(w, h, tpol)
    for acc in (1, 7, 123457, 0xFFFFFFFF):
        p0, d0 = camera(jscene, jnp.uint32(acc))
        tp, td = tr.generate_camera_rays(tscene.camera, tx, ty, acc, seeds,
                                         tpol.enable_dof, tpol)
        assert np.array_equal(_bits(tp), _bits(p0)), acc
        assert np.array_equal(_bits(td), _bits(d0)), acc
    lanes = np.array([2, 9], np.uint32)[i % 2]
    p0, d0 = camera(jscene, jnp.asarray(lanes))
    tp, td = tr.generate_camera_rays(tscene.camera, tx, ty,
                                     torch.from_numpy(lanes.astype(np.int64)),
                                     seeds, tpol.enable_dof, tpol)
    assert np.array_equal(_bits(tp), _bits(p0))
    assert np.array_equal(_bits(td), _bits(d0))


@pytest.mark.parametrize("scramble", [False, True])
def test_site_state_matches_jax(scramble):
    """The port's site_state against the JAX renderer's _site_state
    (Renderer.hpp:117/255/362), plain and avalanche-scrambled by hash_u32
    under rng_scramble: equal u32 states."""
    jpol, tpol = policies(rng_scramble=scramble)
    g = np.random.default_rng(5)
    counter = g.integers(0, 2 ** 32, 4096, dtype=np.uint64).astype(np.uint32)
    for acc in (0, 3, 0xFFFFFFFF):
        want = np.asarray(jax.jit(lambda c: jr._site_state(
            jnp.uint32(acc), c, jpol))(counter)).astype(np.int64)
        got = trng.site_state(acc, torch.from_numpy(
            counter.astype(np.int64)), tpol.rng_scramble).numpy()
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("brdf", ["lambertian", "principled"])
def test_bounce_step_rng_scramble_matches_jax(brdf):
    """bounce_step under rng_scramble (the NEE and BSDF sites scrambled),
    three bounces of the hero's 64x64 wavefront at check_bounce_steps's
    bar."""
    jpol, tpol = policies(rng_scramble=True, brdf=brdf)
    check_bounce_steps(jbuilders.default_scene(64, 64), jpol, tpol)


def test_render_pass_camera_knobs_match_exact_jax(jax_exact_math):
    """render_pass with enable_dof, stratify_camera and rng_scramble
    together on the dof camera at 32x32, 4 bounces, one pass and two in one
    wide launch: the radiance and the ray count bit for bit against the
    exact-math witness."""
    w = h = 32
    jpol, tpol = policies(max_bounces=4, rays_per_chunk=2048, enable_dof=True,
                          stratify_camera=True, rng_scramble=True)
    jscene = dof_scene(w, h)
    tscene = Scene.from_numpy(jax_scene_to_numpy(jscene), device="cpu")
    for k in (1, 2):
        want, wcount = jax.jit(lambda s: jr.render_pass(
            s, jpol, jnp.uint32(11), w, h, k_passes=k))(jscene)
        got, gcount = tr.render_pass(tscene, tpol, 11, w, h, k_passes=k)
        got = np.stack([c.numpy() for c in got])
        want = np.stack([np.asarray(c) for c in want])
        assert np.array_equal(got.view(np.int32), want.view(np.int32)), k
        assert int(gcount) == int(wcount)


def test_golden_dof():
    """Thin-lens depth of field, the hero at 64x64, 10 spp, max_bounces=6,
    4096-ray chunks, through Renderer(device="cpu"), at
    tests/test_goldens.py::_check's bar against dof_64x64_10spp.npy."""
    _, pol = policies(enable_dof=True)
    r = Renderer(tbuilders.dof_scene(SIZE, SIZE), pol, SIZE, SIZE,
                 device="cpu")
    r.accumulate(SPP)
    _check("dof", r.render(tonemap=False))
