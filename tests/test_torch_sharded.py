"""The port's multi-device renderer (``parallel/sharded.py``,
``parallel/distributed.py``) against the JAX package's
``parallel/sharded.py`` on the CPU, after tests/test_sharding.py and
tests/test_distributed_multiproc.py.

The port runs one process per mesh coordinate over gloo
(``tests/torch_sharded_worker.py``, spawned once per mesh shape, meeting at
a ``file://`` store in tmp_path); the JAX package runs its ShardedRenderer
on the 8 virtual CPU devices at the same (dp, sp), with correctly rounded
rsqrt, sin and cos (``test_torch_knobs.py::jax_exact_math``).

Tolerances:
* against JAX ``ShardedRenderer`` at the same (dp, sp): buckets, reservoirs,
  counts and adaptive stats equal bit for bit (both merge the sp partials by
  a sum in rank order);
* against the port's one-device ``Renderer``: bit for bit at sp = 1; at
  sp > 1 within test_sharding.py's rtol 2e-5 / atol 1e-5 (the sp ranks sum
  other subsets of passes into a bucket);
* checkpoint resume across topologies and packages: bit for bit.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from cpu_raytracing_experiments_tpu.parallel import sharded as jsharded
from cpu_raytracing_experiments_tpu.render import checkpoint as jckpt
from cpu_raytracing_experiments_tpu.render.api import Renderer as JRenderer
from cpu_raytracing_experiments_tpu.scene import builders as jbuilders
from cpu_raytracing_experiments_tpu.utils.config import RendererPolicy as JPolicy
from cpu_raytracing_experiments_tpu_torch import Renderer
from cpu_raytracing_experiments_tpu_torch.parallel import sharded
from cpu_raytracing_experiments_tpu_torch.render import checkpoint
from cpu_raytracing_experiments_tpu_torch.scene import builders
from cpu_raytracing_experiments_tpu_torch.utils.config import RendererPolicy

from test_torch_knobs import jax_exact_math  # noqa: F401  (a fixture)

torch.set_num_threads(1)

WORKER = Path(__file__).resolve().parent / "torch_sharded_worker.py"
SHAPES = [(2, 1), (1, 2), (2, 2)]
W = 32
KNOBS = dict(max_bounces=6, rays_per_chunk=2048)  # the worker's POL
SMALL = dict(max_bounces=3, rays_per_chunk=1024)
ADAPTIVE = {"tol": 0.05, "max_spp": 20, "warmup": 10}
RTOL, ATOL = 2e-5, 1e-5  # tests/test_sharding.py's, for sp > 1


def _spawn(out: Path, dp: int, sp: int, timeout: float = 240.0) -> dict:
    """Run the worker on dp * sp processes; rank 0's results."""
    world = dp * sp
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, str(WORKER), str(out / "store"), str(world), str(r),
         str(dp), str(sp), str(out), "cpu", str(W)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        for r in range(world)]
    try:
        outs = [p.communicate(timeout=timeout) for p in procs]
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.communicate()
        pytest.fail(f"a worker of the {dp} x {sp} mesh timed out")
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    with np.load(out / "results.npz") as z:
        return dict(z)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The worker's results for each mesh shape, spawned once each, with
    the JAX package's 4-pass checkpoint of the hero in its directory."""
    jpol = JPolicy(**KNOBS)
    jr = JRenderer(jbuilders.default_scene(W, W), jpol, W, W)
    jr.accumulate(4)
    cache = {}

    def get(dp, sp):
        if (dp, sp) not in cache:
            out = tmp_path_factory.mktemp(f"mesh{dp}x{sp}")
            jckpt.save(out / "jax4.npz", jr.state, jpol, W, W)
            cache[dp, sp] = (_spawn(out, dp, sp), out)
        return cache[dp, sp]

    return get


@pytest.fixture(scope="module")
def single():
    """The port's one-device render of the hero: 10 passes."""
    r = Renderer(builders.default_scene(W, W), RendererPolicy(**KNOBS), W, W,
                 device="cpu")
    r.accumulate(10)
    return r


def _jax_sharded(dp, sp, scene, pol, w):
    mesh = jsharded.make_mesh(dp=dp, sp=sp, devices=jax.devices()[:dp * sp])
    return jsharded.ShardedRenderer(scene, pol, w, w, mesh)


def _bits(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return a.shape == b.shape and np.array_equal(a.view(np.int32),
                                                 b.view(np.int32))


@pytest.mark.parametrize("dp,sp", SHAPES)
def test_sharded_matches_jax_and_single_device(runs, single, dp, sp,
                                               jax_exact_math):
    """accumulate(10) on a dp x sp mesh (JAX ``accumulate_n_sharded``, the
    merge of ``resolve_sharded``): the merged buckets equal JAX
    ShardedRenderer's at the same (dp, sp) bit for bit, and the port's
    one-device buckets bit for bit at sp = 1, within rtol 2e-5 / atol 1e-5
    at sp > 1."""
    res, _ = runs(dp, sp)
    jr = _jax_sharded(dp, sp, jbuilders.default_scene(W, W),
                      JPolicy(**KNOBS), W)
    jr.accumulate(10)
    assert _bits(res["buckets"], np.asarray(jr.state.buckets).sum(axis=0))
    want = single.state.buckets.numpy()
    if sp == 1:
        assert _bits(res["buckets"], want)
    else:
        np.testing.assert_allclose(res["buckets"], want, rtol=RTOL,
                                   atol=ATOL)


@pytest.mark.parametrize("dp,sp", SHAPES)
def test_sharded_resolve_and_variance(runs, single, dp, sp):
    """``render`` (tonemapped and linear, JAX ``resolve_sharded``) and
    ``variance_map`` on the mesh against the port's one-device Renderer:
    bit for bit at sp = 1, within rtol 2e-5 / atol 1e-5 at sp > 1."""
    res, _ = runs(dp, sp)
    for key, want in (("image", single.render(tonemap=True)),
                      ("linear", single.render(tonemap=False)),
                      ("variance", single.variance_map())):
        assert res[key].shape == want.shape, key
        if sp == 1:
            assert _bits(res[key], want), key
        else:
            np.testing.assert_allclose(res[key], want, rtol=RTOL, atol=ATOL,
                                       err_msg=key)


@pytest.mark.parametrize("dp,sp", SHAPES)
def test_checkpoint_from_jax_resumes_on_the_mesh(runs, dp, sp):
    """The JAX package's 4-pass checkpoint loaded into each mesh
    (``load_checkpoint``: merged buckets into sp rank 0's partial) and
    accumulated 6 more passes equals the port's one-device Renderer resumed
    from the same file, bit for bit."""
    res, out = runs(dp, sp)
    pol = RendererPolicy(**KNOBS)
    r = Renderer(builders.default_scene(W, W), pol, W, W, device="cpu")
    r.state = checkpoint.load(out / "jax4.npz", pol, W, W, device="cpu")
    r.accumulate(6)
    assert _bits(res["resumed"], r.state.buckets.numpy())


def test_checkpoint_from_the_mesh_resumes_in_jax(runs, single,
                                                 jax_exact_math):
    """The 2 x 2 mesh's 4-pass ``save_checkpoint`` (merged, written by rank
    0) resumes in the JAX package's Renderer and in the port's: 6 more
    passes give the 10-pass buckets of an uninterrupted render, bit for bit
    (JAX with correctly rounded rsqrt, sin and cos)."""
    _, out = runs(2, 2)
    jpol = JPolicy(**KNOBS)
    jscene = jbuilders.default_scene(W, W)
    whole = JRenderer(jscene, jpol, W, W)
    whole.accumulate(10)
    resumed = JRenderer(jscene, jpol, W, W)
    resumed.state = jckpt.load(out / "port4.npz", jpol, W, W)
    assert int(resumed.state.accumulations) == 4
    resumed.accumulate(6)
    assert _bits(resumed.state.buckets, whole.state.buckets)
    pol = RendererPolicy(**KNOBS)
    r = Renderer(builders.default_scene(W, W), pol, W, W, device="cpu")
    r.state = checkpoint.load(out / "port4.npz", pol, W, W, device="cpu")
    r.accumulate(6)
    assert _bits(r.state.buckets, single.state.buckets)


@pytest.mark.parametrize("dp,sp", SHAPES)
def test_render_spp_sample_accounting(runs, dp, sp):
    """``render_spp(10)`` at samples_per_pixel=2 counts samples (JAX
    ``render_spp``): ceil(10 / 2) = 5 passes rounded up to a multiple of
    lcm(B, sp), 5 at sp = 1 and 10 at sp = 2; at sp = 1 the image equals
    the one-device render_spp bit for bit, at sp = 2 its mean is within
    0.02 of it."""
    res, _ = runs(dp, sp)
    assert int(res["spp_passes"]) == (5 if sp == 1 else 10)
    pol = RendererPolicy(samples_per_pixel=2, **KNOBS)
    r = Renderer(builders.default_scene(W, W), pol, W, W, device="cpu")
    img = r.render_spp(10)
    assert r.state.accumulations == 5
    if sp == 1:
        assert _bits(res["spp_image"], img)
    else:
        assert abs(float(res["spp_image"].mean()) - float(img.mean())) < 0.02


def test_restir_dp2_matches_jax(runs, jax_exact_math):
    """light_sampling='restir' on a 2 x 1 mesh (reservoirs sharded with
    their pixels), 4 passes of the 16-light field at 16x16: the buckets and
    the reservoirs equal JAX ShardedRenderer's at dp 2 bit for bit."""
    res, _ = runs(2, 1)
    jpol = JPolicy(light_sampling="restir", **SMALL)
    jr = _jax_sharded(2, 1, jbuilders.random_spheres_scene(
        16, 16, num_spheres=60, emissive_fraction=0.3, seed=5), jpol, 16)
    jr.accumulate(4)
    assert _bits(res["restir_buckets"],
                 np.asarray(jr.state.buckets).sum(axis=0))
    assert _bits(res["restir_reservoir"], np.asarray(jr.state.reservoir))


def test_adaptive_dp2_matches_jax(runs, jax_exact_math):
    """``render_adaptive(tol=0.05, max_spp=20, warmup=10)`` on a 2 x 1 mesh
    of the hero at 16x16 (per-shard selection, JAX
    ``_adaptive_round_sharded``): the buckets, the per-pixel counts, the
    stats and the image equal JAX ShardedRenderer's at dp 2 bit for bit, and
    the rounds saved samples."""
    res, _ = runs(2, 1)
    jr = _jax_sharded(2, 1, jbuilders.default_scene(16, 16),
                      JPolicy(**SMALL), 16)
    img, stats = jr.render_adaptive(**ADAPTIVE)
    assert _bits(res["adaptive_buckets"],
                 np.asarray(jr.state.buckets).sum(axis=0))
    assert _bits(res["adaptive_counts"], np.asarray(jr.state.counts))
    assert json.loads(str(res["adaptive_stats"])) == stats
    assert _bits(res["adaptive_image"], img)
    assert stats["saved_fraction"] > 0


def test_accumulate_pixels_sharded_matches_one_device(runs):
    """``accumulate_pixels_sharded`` (JAX ``accumulate_pixels_sharded``) on
    a 2 x 1 mesh after 5 passes of the hero at 16x16: each shard traces its
    own row of global ids (padding masked); the merged buckets and per-pixel
    counts equal the port's one-device ``estimator.accumulate_pixels`` on
    the rows joined, bit for bit."""
    from torch_sharded_worker import subset_ids

    from cpu_raytracing_experiments_tpu_torch.render import estimator

    res, _ = runs(2, 1)
    pol = RendererPolicy(**SMALL)
    r = Renderer(builders.default_scene(16, 16), pol, 16, 16, device="cpu")
    r.accumulate(5)
    ids, valid = subset_ids()
    st = estimator.accumulate_pixels(r.scene, pol, r.state, 16, 16,
                                     ids.reshape(-1), valid.reshape(-1))
    assert _bits(res["subset_buckets"], st.buckets.numpy())
    assert _bits(res["subset_counts"], st.counts.numpy())
    assert st.counts.numpy().max() == 6 and st.counts.numpy().min() == 5


def test_initialize_and_pod_mesh(runs):
    """``distributed.initialize`` over a file:// store with 2 processes and
    gloo, then the mesh builders (after test_two_process_initialize):
    ``pod_mesh(1)`` is the 2 x 1 mesh with rank r at (r, 0),
    ``multi_slice_mesh(2)`` the 1 x 2 mesh with rank r at (0, r)."""
    res, _ = runs(2, 1)
    every = json.loads(str(res["topology"]))
    assert [t["rank"] for t in every] == [0, 1]
    for t in every:
        assert (t["world"], t["backend"]) == (2, "gloo")
        assert t["pod"] == [[2, 1], [t["rank"], 0]]
        assert t["multi_slice"] == [[1, 2], [0, t["rank"]]]


def test_single_process_mesh(tmp_path):
    """One process: without a group ``make_mesh`` raises; after
    ``distributed.initialize()`` (a world-size-1 group over an in-process
    store, the only place a group is made) it is the 1 x 1 mesh, and a
    ShardedRenderer on it, whose gathers run gloo's all_gather on the
    1-wide axes, equals the one-device Renderer bit for bit, with the same
    resume through its checkpoint; without a card and without ``device`` it
    raises."""
    import torch.distributed as dist

    from cpu_raytracing_experiments_tpu_torch.parallel import distributed

    scene = builders.default_scene(16, 16)
    pol = RendererPolicy(**SMALL)
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="no process group"):
        sharded.make_mesh(device_type="cpu")
    try:
        distributed.initialize(backend="gloo")
        mesh = sharded.make_mesh(device_type="cpu")
        assert tuple(mesh.mesh.shape) == (1, 1)
        sr = sharded.ShardedRenderer(scene, pol, 16, 16, mesh, device="cpu")
        sr.accumulate(5)
        r = Renderer(scene, pol, 16, 16, device="cpu")
        r.accumulate(5)
        assert _bits(sr.state.buckets, r.state.buckets)
        assert _bits(sr.render(), r.render())
        sr.save_checkpoint(tmp_path / "one.npz")
        sr.load_checkpoint(tmp_path / "one.npz")
        r.state = checkpoint.load(tmp_path / "one.npz", pol, 16, 16,
                                  device="cpu")
        sr.accumulate(3)
        r.accumulate(3)
        assert _bits(sr.state.buckets, r.state.buckets)
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="no CUDA device"):
                sharded.ShardedRenderer(scene, pol, 16, 16, mesh)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
