"""Checkpoint / resume in the PyTorch port against the JAX package's
``render/checkpoint.py``, on the CPU: bit-exact resume, refused
configurations, the adaptive counts and the ReSTIR reservoirs in the file,
and checkpoints crossing between the two packages (the same ``.npz`` layout
and the same policy fingerprint). Where a render of one package continues
one of the other, the JAX side is the renderer whose rsqrt, sin and cos round
correctly (``test_torch_knobs.py::jax_exact_math``), and buckets are equal
bit for bit.
"""
import dataclasses

import numpy as np
import pytest
import torch

from cpu_raytracing_experiments_tpu.render import checkpoint as jckpt
from cpu_raytracing_experiments_tpu.render.api import Renderer as JRenderer
from cpu_raytracing_experiments_tpu.scene import builders as jbuilders
from cpu_raytracing_experiments_tpu.utils.config import RendererPolicy as JPolicy
from cpu_raytracing_experiments_tpu_torch import Renderer
from cpu_raytracing_experiments_tpu_torch.render import checkpoint
from cpu_raytracing_experiments_tpu_torch.scene import builders
from cpu_raytracing_experiments_tpu_torch.scene.scene import Scene
from cpu_raytracing_experiments_tpu_torch.utils.config import RendererPolicy

from test_torch_knobs import jax_exact_math  # noqa: F401
from test_torch_scene import jax_scene_to_numpy

torch.set_num_threads(1)

KNOBS = dict(max_bounces=3, rays_per_chunk=2048)
POL = RendererPolicy(**KNOBS)


def _renderer(scene, pol=POL, w=32, h=32):
    return Renderer(scene, pol, w, h, device="cpu")


def test_checkpoint_resume_bit_exact(tmp_path):
    """render/checkpoint.py save / load (JAX checkpoint.py:34-77), after
    tests/test_io_checkpoint.py:66-81: accumulate(10) equals accumulate(5),
    save, load into a fresh Renderer, accumulate(5), bit for bit; the file
    holds the JAX package's keys (version, buckets, accumulations as uint32,
    fingerprint), and rays_traced, which is not in it, loads as 0."""
    scene = builders.default_scene(32, 32)
    a = _renderer(scene)
    a.accumulate(10)
    b = _renderer(scene)
    b.accumulate(5)
    path = tmp_path / "state.npz"
    checkpoint.save(path, b.state, POL, 32, 32)
    assert checkpoint.exists(path)
    with np.load(path) as z:
        assert sorted(z.files) == ["accumulations", "buckets", "fingerprint",
                                   "version"]
        assert z["accumulations"].dtype == np.uint32
        assert int(z["version"]) == checkpoint.FORMAT_VERSION == 1
    c = _renderer(scene)
    c.state = checkpoint.load(path, POL, 32, 32, device="cpu")
    assert c.state.accumulations == 5 and int(c.state.rays_traced) == 0
    assert c.state.reservoir is None and c.state.counts is None
    c.accumulate(5)
    assert torch.equal(c.state.buckets, a.state.buckets)


def test_checkpoint_rejects_mismatched_config(tmp_path):
    """A checkpoint of another policy or frame size is refused with "different
    render config"; only rays_per_chunk may change (after
    tests/test_io_checkpoint.py:84-100). A file of another format version is
    refused too."""
    r = _renderer(builders.default_scene(16, 16), w=16, h=16)
    r.accumulate(5)
    path = tmp_path / "state.npz"
    checkpoint.save(path, r.state, POL, 16, 16)
    with pytest.raises(ValueError, match="different render config"):
        checkpoint.load(path, dataclasses.replace(POL, max_bounces=4), 16,
                        16, device="cpu")
    with pytest.raises(ValueError, match="different render config"):
        checkpoint.load(path, POL, 32, 32, device="cpu")
    state = checkpoint.load(path, dataclasses.replace(POL,
                                                      rays_per_chunk=4096),
                            16, 16, device="cpu")
    assert torch.equal(state.buckets, r.state.buckets)
    with np.load(path) as z:
        arrays = dict(z)
    arrays["version"] = np.asarray(2)
    np.savez(tmp_path / "v2.npz", **arrays)
    with pytest.raises(ValueError, match="checkpoint version 2 != 1"):
        checkpoint.load(tmp_path / "v2.npz", POL, 16, 16, device="cpu")


def test_checkpoint_carries_counts_and_reservoirs(tmp_path):
    """The adaptive per-pixel counts and the ReSTIR reservoirs go into the
    file and come back: after an adaptive round, resuming the adaptive
    render from the checkpoint gives the buckets, counts and stats of the
    uninterrupted one; under 'restir' (a 16-light field, 16x16) accumulate(6)
    equals accumulate(3) + save + load + accumulate(3), buckets and
    reservoirs bit for bit."""
    scene = builders.default_scene(16, 16)
    kw = dict(tol=0.05, max_spp=30, warmup=10)
    whole = _renderer(scene, w=16, h=16)
    _, want_stats = whole.render_adaptive(**kw)
    part = _renderer(scene, w=16, h=16)
    part.render_adaptive(**dict(kw, max_spp=15))
    assert part.state.counts is not None and part.state.accumulations == 15
    path = tmp_path / "adaptive.npz"
    checkpoint.save(path, part.state, POL, 16, 16)
    resumed = _renderer(scene, w=16, h=16)
    resumed.state = checkpoint.load(path, POL, 16, 16, device="cpu")
    assert torch.equal(resumed.state.counts, part.state.counts)
    _, stats = resumed.render_adaptive(**kw)
    assert torch.equal(resumed.state.buckets, whole.state.buckets)
    assert torch.equal(resumed.state.counts, whole.state.counts)
    assert stats["max_spp_pixel"] == want_stats["max_spp_pixel"]
    assert stats["uniform_equivalent"] == want_stats["uniform_equivalent"]

    field = builders.random_spheres_scene(16, 16, num_spheres=60,
                                          emissive_fraction=0.3, seed=5)
    pol = RendererPolicy(light_sampling="restir", **KNOBS)
    whole = _renderer(field, pol, 16, 16)
    whole.accumulate(6)
    part = _renderer(field, pol, 16, 16)
    part.accumulate(3)
    path = tmp_path / "restir.npz"
    checkpoint.save(path, part.state, pol, 16, 16)
    resumed = _renderer(field, pol, 16, 16)
    resumed.state = checkpoint.load(path, pol, 16, 16, device="cpu")
    assert torch.equal(resumed.state.reservoir, part.state.reservoir)
    resumed.accumulate(3)
    assert torch.equal(resumed.state.buckets, whole.state.buckets)
    assert torch.equal(resumed.state.reservoir, whole.state.reservoir)


def test_policy_fingerprints_equal_across_packages():
    """The two RendererPolicy classes have the same fields and defaults
    (dataclasses.asdict equal), so their fingerprints are equal, under the
    defaults and under knobs."""
    for knobs in ({}, KNOBS, dict(light_sampling="restir", brdf="ggx",
                                  accel="pallas", narrow_factors=(8,))):
        jpol, tpol = JPolicy(**knobs), RendererPolicy(**knobs)
        assert dataclasses.asdict(tpol) == dataclasses.asdict(jpol)
        assert checkpoint.policy_fingerprint(tpol, 24, 16) \
            == jckpt.policy_fingerprint(jpol, 24, 16)


@pytest.mark.parametrize("light_sampling", ["uniform", "restir"])
def test_checkpoint_crosses_packages(tmp_path, light_sampling,
                                     jax_exact_math):
    """A checkpoint the JAX package writes after 3 passes, resumed in the
    port for 3 more, gives the buckets of the JAX package's uninterrupted 6
    (and its reservoirs under 'restir'); a checkpoint the port writes after
    3 passes loads in the JAX package with the same arrays, and the JAX
    package resumed from it reaches the same 6-pass buckets. 16x16, the hero
    or a 16-light field under 'restir'."""
    w = 16
    jscene = (jbuilders.default_scene(w, w) if light_sampling == "uniform"
              else jbuilders.random_spheres_scene(w, w, num_spheres=60,
                                                  emissive_fraction=0.3,
                                                  seed=5))
    tscene = Scene.from_numpy(jax_scene_to_numpy(jscene))
    jpol = JPolicy(light_sampling=light_sampling, **KNOBS)
    tpol = RendererPolicy(light_sampling=light_sampling, **KNOBS)
    jwhole = JRenderer(jscene, jpol, w, w)
    jwhole.accumulate(6)
    want = np.asarray(jwhole.state.buckets)

    jpart = JRenderer(jscene, jpol, w, w)
    jpart.accumulate(3)
    jckpt.save(tmp_path / "jax.npz", jpart.state, jpol, w, w)
    port = Renderer(tscene, tpol, w, w, device="cpu")
    port.state = checkpoint.load(tmp_path / "jax.npz", tpol, w, w,
                                 device="cpu")
    port.accumulate(3)
    assert np.array_equal(port.state.buckets.numpy().view(np.int32),
                          want.view(np.int32))
    if light_sampling == "restir":
        assert np.array_equal(port.state.reservoir.numpy(),
                              np.asarray(jwhole.state.reservoir))

    tpart = Renderer(tscene, tpol, w, w, device="cpu")
    tpart.accumulate(3)
    checkpoint.save(tmp_path / "port.npz", tpart.state, tpol, w, w)
    jstate = jckpt.load(tmp_path / "port.npz", jpol, w, w)
    assert np.array_equal(np.asarray(jstate.buckets),
                          tpart.state.buckets.numpy())
    assert int(jstate.accumulations) == 3
    jres = JRenderer(jscene, jpol, w, w)
    jres.state = jstate
    jres.accumulate(3)
    assert np.array_equal(np.asarray(jres.state.buckets).view(np.int32),
                          want.view(np.int32))
