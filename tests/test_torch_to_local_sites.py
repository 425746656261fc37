"""How the JAX renderer rounds ``sampling.to_local`` / ``to_world`` at each
of its call sites in ``bounce_step``, and the port held to it, on the CPU.

temp's inner sum in ``to_local``, v.z*t.w + v.x*t.y, is one fused
multiply-add under ``jax.jit``, and XLA picks which product it fuses by the
fusion the call lands in. Each site is read on the hero's 64x64 camera rays
at the default policy (the wavefront of ``test_torch_render.py``):

* ``v_local`` (``_closest_hit_frame``): held in ``test_torch_contract.py``
  (``test_renderer_frame_v_local_contraction``): fma(v.x, t.y, v.z*t.w);
* ``n_dot_w`` (the sphere-light cone test) and ``world_dir``: each call's
  inputs and used lanes are returned from inside the jitted bounce_step,
  which leaves every output of bounce_step bit-identical (checked);
  ``n_dot_w`` is fma(v.x, t.y, v.z*t.w), ``world_dir`` fma(v.z, t.w,
  -(v.x*t.y)) in every lane;
* ``l_local``: returning its z lane changes the program (outputs move), so
  it is read from bounce_step's outputs: with XLA's rsqrt, sin and cos
  replaced by correctly rounded ones in the JAX package (as the port
  computes them), the port's bounce_step equals the JAX package's in every
  lane of every output with fma(v.z, t.w, v.x*t.y) there, and not with the
  other order; that test also checks that the port's renderer passes each
  site's order. A 128x128 hero render through the JAX renderer's own jit
  is bit-identical to the port's against the same witness.

Tolerance: equal bits throughout.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from cpu_raytracing_experiments_tpu.core import sampling as jsampling
from cpu_raytracing_experiments_tpu.core import vec as jvec
from cpu_raytracing_experiments_tpu.core.vec import Vec3 as JVec3
from cpu_raytracing_experiments_tpu.render import renderer as jr
from cpu_raytracing_experiments_tpu.scene import builders as jbuilders
from cpu_raytracing_experiments_tpu.utils.config import RendererPolicy as JPolicy
from cpu_raytracing_experiments_tpu_torch.core import sampling
from cpu_raytracing_experiments_tpu_torch.core.vec import Quat, Vec3
from cpu_raytracing_experiments_tpu_torch.render import renderer as tr
from cpu_raytracing_experiments_tpu_torch.scene.scene import Scene
from cpu_raytracing_experiments_tpu_torch.utils.config import RendererPolicy

from test_torch_render import _exact_rsqrt, _jax_state_to_torch, _stack
from test_torch_scene import jax_scene_to_numpy

torch.set_num_threads(1)

W = H = 64
ACC = 3
FIELDS = ("p", "d", "throughput", "radiance", "prev_pdf", "prev_delta",
          "alive")


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


class Hero:
    """The hero scene's 64x64 wavefront at bounce 0 in both packages."""

    def __init__(self):
        self.jpol = JPolicy(max_bounces=6, rays_per_chunk=W * H)
        self.tpol = RendererPolicy(max_bounces=6, rays_per_chunk=W * H)
        self.jscene = jbuilders.default_scene(W, H)
        self.tscene = Scene.from_numpy(jax_scene_to_numpy(self.jscene),
                                       device="cpu")
        i = np.arange(W * H)
        self.jseeds = jr.pixel_seeds(W, H, self.jpol)
        self.tseeds = tr.pixel_seeds(W, H, self.tpol)
        p0, d0 = jax.jit(lambda s: jr.generate_camera_rays(
            s.camera, jnp.asarray(i % W, jnp.int32),
            jnp.asarray(i // W, jnp.int32), jnp.uint32(ACC), self.jseeds,
            False, self.jpol))(self.jscene)
        one, zero = jnp.ones(W * H), jnp.zeros(W * H)
        self.state = jr.PathState(
            bounce=jnp.int32(0), p=p0, d=d0, throughput=JVec3(one, one, one),
            radiance=JVec3(zero, zero, zero), prev_pdf=zero,
            prev_delta=zero > 1.0, alive=zero < 1.0, ray_count=jnp.uint32(0))

    def step(self, state, sites=()):
        """The JAX bounce_step under jax.jit, and for each (function name,
        call index, lanes) of `sites` that call's (t.x, t.y, t.w, v.x, v.y,
        v.z) and the listed output lanes, returned from inside the jit."""
        calls = {"to_local": [], "to_world": []}
        originals = {name: getattr(jsampling, name) for name in calls}

        def recorder(name):
            def f(t, v):
                out = originals[name](t, v)
                calls[name].append(((t.x, t.y, t.w, *v), tuple(out)))
                return out
            return f

        def run(s, st):
            out = jr.bounce_step(s, self.jpol, jnp.uint32(ACC), self.jseeds,
                                 st)
            seen = [(calls[name][k][0],
                     tuple(calls[name][k][1][i] for i in lanes))
                    for name, k, lanes in sites]
            return out, seen, {name: len(c) for name, c in calls.items()}

        for name in calls:
            setattr(jsampling, name, recorder(name))
        try:
            out, seen, counts = jax.jit(run)(self.jscene, state)
        finally:
            for name, f in originals.items():
                setattr(jsampling, name, f)
        return out, seen, counts

    def port_step(self, state):
        return tr.bounce_step(self.tscene, self.tpol, ACC, self.tseeds,
                              _jax_state_to_torch(state))


@pytest.fixture(scope="module")
def hero():
    h = Hero()
    h.plain, _, h.counts = h.step(h.state)
    return h


def _same_outputs(a, b):
    return all(np.array_equal(_bits(x), _bits(y)) for x, y in
               zip(jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)))


def _port_form(name, ins, fuse_xy):
    t = [torch.from_numpy(np.array(a)) for a in ins]
    q, v = Quat(t[0], t[1], None, t[2]), Vec3(*t[3:])
    if name == "to_world":
        return sampling.to_world(q, v)
    return sampling.to_local(q, v, fuse_xy=fuse_xy)


@pytest.mark.parametrize("name,call,lanes,fuse_xy", [
    pytest.param("to_local", 1, (2,), True, id="n_dot_w"),
    pytest.param("to_world", 0, (0, 1, 2), False, id="world_dir"),
])
def test_site_read_inside_the_jit(hero, name, call, lanes, fuse_xy):
    """The call's used lanes, returned from inside the jitted bounce_step
    (whose outputs stay bit-identical), equal the port's form at that site
    on every lane; the other contraction of to_local's inner sum differs on
    some (n_dot_w)."""
    assert hero.counts == {"to_local": 3, "to_world": 1}
    out, seen, _ = hero.step(hero.state, [(name, call, lanes)])
    assert _same_outputs(out, hero.plain)
    ins, got = seen[0]
    port = _port_form(name, ins, fuse_xy)
    for lane, want in zip(lanes, got):
        assert np.array_equal(_bits(port[lane].numpy()), _bits(want))
    if name == "to_local":
        other = _port_form(name, ins, not fuse_xy)
        assert any(not np.array_equal(_bits(other[lane].numpy()), _bits(w))
                   for lane, w in zip(lanes, got))


def _exact(fn):
    """A correctly rounded float32 `fn` for the JAX package: float64 on the
    host, rounded once, as the port's core/fp.py computes it."""
    def f(x):
        return jax.pure_callback(
            lambda a: fn(np.asarray(a, np.float64)).astype(np.float32),
            jax.ShapeDtypeStruct(x.shape, jnp.float32), x,
            vmap_method="expand_dims")
    return f


@pytest.fixture
def jax_exact_math(monkeypatch):
    """The JAX package with XLA's CPU rsqrt, sin and cos (not correctly
    rounded) replaced by correctly rounded ones for one test: rsqrt through
    ``test_torch_render._exact_rsqrt``, sin and cos in
    ``sampling.spherical_to_cartesian``, the one place the renderer takes
    them. The jit caches are cleared on both sides."""
    jax.clear_caches()
    sin, cos = _exact(np.sin), _exact(np.cos)

    def spherical_to_cartesian(phi_over_2pi, sin_theta, cos_theta):
        phi = phi_over_2pi * jsampling.TWO_PI
        return JVec3(sin_theta * cos(phi), sin_theta * sin(phi), cos_theta)

    monkeypatch.setattr(jvec, "jax_rsqrt", _exact_rsqrt)
    monkeypatch.setattr(jsampling, "spherical_to_cartesian",
                        spherical_to_cartesian)
    yield
    monkeypatch.undo()
    jax.clear_caches()


def test_l_local_and_bounce_step_exact_with_exact_math(jax_exact_math,
                                                       monkeypatch):
    """Against the JAX renderer with correctly rounded rsqrt, sin and cos,
    the port's bounce_step is bit-equal in every lane of every output over
    two bounces of the hero's wavefront. Its three to_local calls (v_local,
    n_dot_w, l_local) take fuse_xy True, True, False; with l_local's inner
    sum fused the other way (fma(v.x, t.y, v.z*t.w)) the radiance
    differs."""
    h = Hero()
    state = h.state
    for _ in range(2):
        want, _, _ = h.step(state)
        got = h.port_step(state)
        for field in FIELDS:
            g, w = getattr(got, field), getattr(want, field)
            if isinstance(g, Vec3):
                g, w = _stack(g), _stack(w)
            assert np.array_equal(_bits(np.asarray(g)), _bits(w)), field
        assert int(got.ray_count) == int(want.ray_count)
        state = want

    calls = []
    to_local = sampling.to_local

    def swapped(t, v, fuse_xy=False):
        calls.append(fuse_xy)
        # the third call of bounce_step is l_local's
        return to_local(t, v, fuse_xy=(not fuse_xy) if len(calls) == 3
                        else fuse_xy)

    monkeypatch.setattr(sampling, "to_local", swapped)
    want, _, _ = h.step(h.state)
    got = h.port_step(h.state)
    assert calls == [True, True, False]
    assert not np.array_equal(_bits(_stack(got.radiance)),
                              _bits(_stack(want.radiance)))


def test_hero_render_exact_with_exact_math(jax_exact_math, monkeypatch):
    """The whole render, through the JAX renderer's own jit (accumulate_n
    and its bounce loop): the hero at 128x128, 2 passes, 8 bounces, one
    chunk. Against the JAX renderer with correctly rounded rsqrt, sin and
    cos the port's buckets are bit-identical; with v_local's inner sum
    fused the other way (the port's order before it followed the renderer)
    some bucket entries differ: an emissive hit's MIS weight reads
    v_local.z."""
    from cpu_raytracing_experiments_tpu.render.api import Renderer as JRenderer
    from cpu_raytracing_experiments_tpu_torch import Renderer

    n = 128
    jr_ = JRenderer(jbuilders.default_scene(n, n),
                    JPolicy(max_bounces=8, rays_per_chunk=n * n), n, n)
    jr_.accumulate(2)
    want = _bits(jr_.state.buckets)
    scene = Scene.from_numpy(jax_scene_to_numpy(jbuilders.default_scene(n, n)),
                             device="cpu")
    policy = RendererPolicy(max_bounces=8, rays_per_chunk=n * n)

    def buckets():
        r = Renderer(scene, policy, n, n, device="cpu")
        r.accumulate(2)
        return _bits(r.state.buckets.numpy())

    assert np.array_equal(buckets(), want)
    calls = []
    to_local = sampling.to_local

    def swapped(t, v, fuse_xy=False):
        calls.append(fuse_xy)
        # the first call of each bounce is v_local's
        return to_local(t, v, fuse_xy=(not fuse_xy) if len(calls) % 3 == 1
                        else fuse_xy)

    monkeypatch.setattr(sampling, "to_local", swapped)
    assert not np.array_equal(buckets(), want)
