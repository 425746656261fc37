"""How the port rounds the closest-hit sphere battery's ``disc`` against
how jitted XLA rounds it on the CPU, where that depends on the width of the
battery's prim chunk (``core/fp.py::xla_fuses_sphere_bb``).

The JAX form is ``disc = r_sq - (tx*tx + ty*ty + tz*tz) + b*b``
(``ops/intersect.py::_sphere_candidates``). On 1-4 and 9 or more spheres a
chunk XLA fuses ``b*b`` into the sum; on 5-8 it rounds ``b*b`` alone. Held
here, each against the JAX function named, on seeded random rays:

* ``intersect_spheres`` at widths 1-17 and 516-521 (the last 512-sphere
  chunk 4-9 wide) against jitted JAX ``intersect_spheres``, bit for bit;
* the grid's residual battery, 5-8 residual spheres, against jitted JAX
  ``traverse_grid_closest`` / ``traverse_grid_shadow``, bit for bit: XLA
  rounds the residual's chunks as it rounds the brute battery's;
* ``accel='clustered'`` at K = 5-8 against jitted JAX
  ``intersect_clustered``, bit for bit: there XLA fuses at every K (the
  battery inside ``lax.cond`` in a scan), so the port keeps the fused form
  (with the width rule applied instead, t moves on some lanes);
* ``render_pass`` on ``tests/test_fuzz_oracle.py``'s random scenes with 5-8
  spheres against the JAX renderer whose rsqrt, sin and cos round correctly
  (``jax_exact_math``), bit for bit, and against the float64 oracle
  ``tests/oracle.py::trace_pixel`` within ``test_fuzz_oracle.py``'s budget.

The ray counts above are those of the renderer's chunks (powers of two).
At other counts (1000, 3000, 4001) jitted JAX's own bits depend on the CPUs
its process may use: XLA splits the rays into thread partitions, and the
scalar tail of a partition fuses ``b*b`` at every width. The witness is
jitted JAX in a one-CPU process, which equals the rule in every lane
(``test_one_cpu_jax_equals_rule``); at the host's own CPU count every lane
where JAX differs from the rule is the fused form
(``test_every_lane_is_one_of_two_roundings``). ROADMAP's standing
deviations record this; ``benchmarks/torch_disc_witness.py`` counts the
lanes at 1, 2 and all CPUs, and on the grid residual."""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import oracle
from cpu_raytracing_experiments_tpu.bvh import grid as jgrid
from cpu_raytracing_experiments_tpu.bvh import traverse as jtraverse
from cpu_raytracing_experiments_tpu.ops import clustered as jcl
from cpu_raytracing_experiments_tpu.ops import intersect as jint
from cpu_raytracing_experiments_tpu.render import renderer as jr
from cpu_raytracing_experiments_tpu_torch.bvh import grid as tgrid
from cpu_raytracing_experiments_tpu_torch.bvh import traverse as ttraverse
from cpu_raytracing_experiments_tpu_torch.core import fp
from cpu_raytracing_experiments_tpu_torch.ops import clustered as tcl
from cpu_raytracing_experiments_tpu_torch.ops.kernels import sphere_battery as sb
from cpu_raytracing_experiments_tpu_torch.render import renderer as tr
from cpu_raytracing_experiments_tpu_torch.scene.scene import Scene
from cpu_raytracing_experiments_tpu_torch.utils.config import RendererPolicy

from test_fuzz_oracle import H, MAX_BOUNCES, POL, W, _random_scene
from test_oracle_parity import _camera_to_np, _scene_to_np
from test_torch_bvh import FLT_MAX, bits, jv, rays, spheres, tv
from test_torch_intersect import _batch, _jax, _torch
from test_torch_knobs import jax_exact_math  # noqa: F401  (a fixture)
from test_torch_scene import jax_clusters_to_numpy, jax_scene_to_numpy

torch.set_num_threads(1)

RAYS = 4096


def test_rule_names_the_widths():
    """XLA rounds b*b alone on 5-8-wide chunks only; ``unfused_from`` gives
    the start of the last 512-chunk where that chunk is 5-8 wide."""
    assert [w for w in range(1, 1100) if not fp.xla_fuses_sphere_bb(w)] == \
        [5, 6, 7, 8]
    assert [sb.unfused_from(n) for n in (0, 4, 5, 8, 9, 516, 517, 520, 521,
                                         1029)] == \
        [0, 4, 0, 0, 9, 516, 512, 512, 521, 1024]


@pytest.mark.parametrize("width", list(range(1, 18)) + list(range(516, 522)))
def test_intersect_spheres_width_matches_jax(width):
    """ops/intersect.py::intersect_spheres at `width` spheres: t bits and
    ids equal to jitted JAX's; where the last chunk is 5-8 wide, the fused
    form (``xla_chunks=False``) moves some t, so the rule is what holds."""
    arrays = _batch(RAYS, width, seed=width)
    jo, jd, jc, jrsq, _ = _jax(*arrays)
    to, td, tc, trsq, _ = _torch(*arrays)
    want_t, want_id = jax.jit(jint.intersect_spheres)(jo, jd, jc, jrsq)
    got_t, got_id = sb.intersect_spheres(to, td, tc, trsq)
    np.testing.assert_array_equal(got_id.numpy(), np.asarray(want_id))
    np.testing.assert_array_equal(bits(got_t.numpy()), bits(want_t))
    assert (got_id >= 0).float().mean() > 0.1
    fused_t, _ = sb.intersect_spheres(to, td, tc, trsq, xla_chunks=False)
    moved = int((bits(fused_t.numpy()) != bits(want_t)).sum())
    last = (width - 1) % sb.PRIM_CHUNK + 1
    assert (moved > 0) == (not fp.xla_fuses_sphere_bb(last)), moved


# the ray counts at which XLA's thread partitions leave scalar tails, and
# the chunk widths of the rule (517: a fused 512-wide chunk, then 5)
ODD_RAYS = (1000, 3000, 4001)
ODD_WIDTHS = (5, 6, 8, 517)
CHILD_TIMEOUT_S = 60

# Runs in a child process: restrict the process to the CPUs named in
# argv[3] before JAX is imported, then write jitted JAX's closest-hit bits
# for each case of the .npz argv[1] (keys '<case>_<array>') to argv[2]: the
# brute battery (``intersect_spheres``) for cases 's...', the grid
# (``traverse_grid_closest`` over a res-4 grid, 40 slots a cell) for 'g...'.
_CHILD = r"""
import os, sys
os.sched_setaffinity(0, {int(c) for c in sys.argv[3].split(",")})
sys.path.insert(0, sys.argv[4])
import numpy as np
import jax
import jax.numpy as jnp
from cpu_raytracing_experiments_tpu.bvh import grid as jgrid
from cpu_raytracing_experiments_tpu.bvh import traverse as jtraverse
from cpu_raytracing_experiments_tpu.core.vec import Vec3
from cpu_raytracing_experiments_tpu.ops import intersect as jint

data = np.load(sys.argv[1])
v = lambda a: Vec3(*(jnp.asarray(a[:, k]) for k in range(3)))
out = {}
for case in sorted({k.split("_")[0] for k in data.files}):
    a = {k.split("_", 1)[1]: data[k] for k in data.files
         if k.split("_")[0] == case}
    if case[0] == "s":
        t, i = jax.jit(jint.intersect_spheres)(
            v(a["o"]), v(a["d"]), v(a["c"]), jnp.asarray(a["rsq"]))
    else:
        c, r = a["c"], a["r"]
        g = jgrid.build_grid(c - r[:, None], c + r[:, None], res=4,
                             max_per_cell=40)
        rows = jtraverse.pack_spheres(v(c), jnp.asarray(r * r))
        t, i = jax.jit(lambda g, p, d, t0: jgrid.traverse_grid_closest(
            g, p, d, rows, jtraverse.sphere_row_test, tfar0=t0))(
                g, v(a["p"]), v(a["d"]), jnp.asarray(a["tf0"]))
    out[case + "_t"] = np.asarray(t).view(np.int32)
    out[case + "_id"] = np.asarray(i)
np.savez(sys.argv[2], **out)
"""


def jax_bits_on_cpus(cases: dict, cpus, tmp: Path,
                     timeout=CHILD_TIMEOUT_S) -> dict:
    """{case: (t bits, ids)} of jitted JAX run in a child process that may
    use only `cpus`. `cases` maps a name beginning 's' to the brute
    battery's arrays (o, d, c [n, 3], rsq) and one beginning 'g' to a
    grid's (c [m, 3], r, p, d [n, 3], tf0)."""
    src, dst = tmp / "cases.npz", tmp / "bits.npz"
    np.savez(src, **{f"{case}_{k}": a for case, arrays in cases.items()
                     for k, a in arrays.items()})
    root = str(Path(__file__).resolve().parents[1])
    subprocess.run([sys.executable, "-c", _CHILD, str(src), str(dst),
                    ",".join(map(str, sorted(cpus))), root],
                   check=True, timeout=timeout,
                   env={**os.environ, "JAX_PLATFORMS": "cpu"})
    got = np.load(dst)
    return {case: (got[case + "_t"], got[case + "_id"]) for case in cases}


def odd_batteries() -> dict:
    """The brute battery's cases: `_batch` rays at each of ODD_RAYS against
    each of ODD_WIDTHS spheres, as [n, 3] arrays."""
    cases = {}
    for n in ODD_RAYS:
        for w in ODD_WIDTHS:
            o, d, c, rsq, _ = _batch(n, w, seed=n + w)
            cases[f"s{n}x{w}"] = {"o": np.stack(o, 1), "d": np.stack(d, 1),
                                  "c": np.stack(c, 1), "rsq": rsq}
    return cases


def port_battery(a: dict, xla_chunks: bool):
    """(t bits, ids) of the port's brute battery on a case of
    ``odd_batteries``."""
    t, i = sb.intersect_spheres(tv(a["o"]), tv(a["d"]), tv(a["c"]),
                                torch.from_numpy(a["rsq"]),
                                xla_chunks=xla_chunks)
    return bits(t.numpy()), i.numpy()


@pytest.mark.skipif(not hasattr(os, "sched_setaffinity"),
                    reason="os.sched_setaffinity is missing on this platform")
def test_one_cpu_jax_equals_rule(tmp_path):
    """The witness of the width rule: jitted JAX ``intersect_spheres`` in a
    process restricted to one CPU (of this process's set) equals the port's
    rule (``xla_chunks=True``) in every lane, t bits and ids, at ray counts
    where XLA's thread partitions leave scalar tails."""
    cases = odd_batteries()
    one = min(os.sched_getaffinity(0))
    want = jax_bits_on_cpus(cases, {one}, tmp_path)
    differ = {}
    for case, a in cases.items():
        t, i = port_battery(a, xla_chunks=True)
        bad = (t != want[case][0]) | (i != want[case][1])
        if bad.any():
            differ[case] = np.nonzero(bad)[0].tolist()
        assert (i >= 0).mean() > 0.1
    assert not differ, f"lanes where one-CPU JAX leaves the rule: {differ}"


def test_every_lane_is_one_of_two_roundings():
    """At this host's own CPU count, jitted JAX ``intersect_spheres`` on the
    cases of ``test_one_cpu_jax_equals_rule`` rounds each lane either as
    the rule does or, where a thread partition's scalar tail fuses ``b*b``,
    as the port's fused form (``xla_chunks=False``), bit for bit in t and
    id. How many lanes are fused depends on the host, so only the
    explanation is asserted; the count is in the message."""
    fused_lanes, unexplained = 0, {}
    for case, a in odd_batteries().items():
        want_t, want_id = jax.jit(jint.intersect_spheres)(
            jv(a["o"]), jv(a["d"]), jv(a["c"]), jnp.asarray(a["rsq"]))
        want_t, want_id = bits(want_t), np.asarray(want_id)
        t, i = port_battery(a, xla_chunks=True)
        ft, fi = port_battery(a, xla_chunks=False)
        off = (t != want_t) | (i != want_id)
        fused_lanes += int(off.sum())
        neither = off & ((ft != want_t) | (fi != want_id))
        if neither.any():
            unexplained[case] = np.nonzero(neither)[0].tolist()
    cpus = (len(os.sched_getaffinity(0)) if hasattr(os, "sched_getaffinity")
            else os.cpu_count())
    assert not unexplained, (
        f"{fused_lanes} lanes leave the rule at {cpus} CPUs; these are not "
        f"the fused form either: {unexplained}")


def _residual_grid(k):
    """40 small spheres and k giant ones that span more than res^2 cells
    of a res-4 grid: the residual list holds the k giants."""
    c, r = spheres(40, 3)
    g = np.random.default_rng(k)
    c = np.concatenate([c, g.uniform(-10, 10, (k, 3))]).astype(np.float32)
    r = np.concatenate([r, g.uniform(40, 55, k)]).astype(np.float32)
    rsq = (r * r).astype(np.float32)
    mins, maxs = c - r[:, None], c + r[:, None]
    jg = jgrid.build_grid(mins, maxs, res=4, max_per_cell=40)
    tg = tgrid.build_grid(mins, maxs, res=4, max_per_cell=40)
    assert tg.residual.tolist() == list(range(40, 40 + k))
    return (jg, jtraverse.pack_spheres(jv(c), jnp.asarray(rsq)),
            tg, ttraverse.pack_spheres(tv(c), torch.from_numpy(rsq)))


@pytest.mark.parametrize("k", [5, 6, 7, 8])
def test_grid_residual_width_matches_jax(k):
    """bvh/grid.py's walks with k residual spheres against jitted JAX
    traverse_grid_closest (tfar bits, ids; every fifth lane seeded at 20) and
    traverse_grid_shadow (occlusion bits at tfar 80, every seventh lane at
    0), the two in one jit."""
    jg, jrows, tg, trows = _residual_grid(k)
    p, d = rays(RAYS, 5, -100, 100)
    tf0 = np.full(RAYS, FLT_MAX, np.float32)
    tf0[::5] = 20.0
    tf = np.full(RAYS, 80.0, np.float32)
    tf[::7] = 0.0
    test = jtraverse.sphere_row_test
    (want_t, want_id), want_occ = jax.jit(lambda g, p, d, t0, t: (
        jgrid.traverse_grid_closest(g, p, d, jrows, test, tfar0=t0),
        jgrid.traverse_grid_shadow(g, p, d, t, jrows, test)))(
            jg, jv(p), jv(d), jnp.asarray(tf0), jnp.asarray(tf))
    got_t, got_id = tgrid.traverse_grid_closest(
        tg, tv(p), tv(d), trows, ttraverse.sphere_row_test,
        tfar0=torch.from_numpy(tf0))
    np.testing.assert_array_equal(got_id.numpy(), np.asarray(want_id))
    np.testing.assert_array_equal(bits(got_t.numpy()), bits(want_t))
    assert np.isin(got_id.numpy(), tg.residual.numpy()).mean() > 0.1
    got = tgrid.traverse_grid_shadow(tg, tv(p), tv(d), torch.from_numpy(tf),
                                     trows, ttraverse.sphere_row_test)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want_occ))


@pytest.mark.parametrize("k", [5, 6, 7, 8])
def test_clustered_fused_at_every_k(k, monkeypatch):
    """ops/clustered.py::intersect_clustered on 1000 spheres in clusters of
    k slots against jitted JAX: tfar bits and ids equal with disc fused;
    with the width rule applied to the clusters instead, some t move. The
    JAX builder rounds a sub-128 K up to a power of two (8 here), so K =
    5-7 are made with that rounding patched out, in both packages' arrays
    alike."""
    monkeypatch.setattr(jcl, "_norm_k", lambda n: n)
    c, r = spheres(1000, 4)
    mins, maxs = c - r[:, None], c + r[:, None]
    rows = np.concatenate([c, (r * r)[:, None]], 1)
    jcp = jcl.build_clusters(mins, maxs, rows, num_clusters=-(-1000 // k),
                             kind="sphere")
    assert jcp.cluster_size == k
    tcp = tcl.ClusteredPrims.from_numpy(jax_clusters_to_numpy(jcp))
    p, d = rays(3000, 9, -100, 100)
    tf0 = np.full(p.shape[0], FLT_MAX, np.float32)
    tf0[::5] = 20.0
    want = jax.jit(lambda cp, p, d, t: jcl.intersect_clustered(
        cp, p, d, tfar0=t))(jcp, jv(p), jv(d), jnp.asarray(tf0))
    got = tcl.intersect_clustered(tcp, tv(p), tv(d), torch.from_numpy(tf0))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(bits(got[0].numpy()), bits(want[0]))
    assert (got[1] >= 0).float().mean() > 0.05
    chunked = sb.intersect_spheres
    monkeypatch.setattr(sb, "intersect_spheres",
                        lambda p, d, c, rsq, xla_chunks: chunked(p, d, c, rsq))
    ruled = tcl.intersect_clustered(tcp, tv(p), tv(d), torch.from_numpy(tf0))
    assert (bits(ruled[0].numpy()) != bits(want[0])).sum() > 0


# _random_scene seeds with 5-8 spheres: 0 (7 spheres) and 6 (6; its pixel
# 75 was (0.688, 0.446, 0.974) with disc always fused, (1.292, 0.734, 1.466)
# in JAX and the oracle) in the gate; every such seed of 0-59 under slow
FUZZ_SEEDS = (0, 1, 5, 6, 7, 8, 14, 15, 16, 17, 18, 19, 21, 22, 23, 24, 26, 27, 28, 33, 35, 37, 38, 39, 40, 42, 43, 45, 47, 48, 49, 50, 52, 55, 56, 57, 58, 59)


@pytest.mark.parametrize("seeds,budget", [
    ((0, 6), 1),
    pytest.param(FUZZ_SEEDS, len(FUZZ_SEEDS) // 2, marks=pytest.mark.slow)])
def test_fuzz_port_matches_exact_jax_and_oracle(seeds, budget,
                                                jax_exact_math):
    """render/renderer.py::render_pass on test_fuzz_oracle.py's random
    scenes (16x16, 5 bounces, 256-ray chunks): radiance bits and the ray
    count equal to the jitted JAX renderer with correctly rounded rsqrt, sin
    and cos; 24 sampled pixels a scene against tests/oracle.py::trace_pixel
    at test_fuzz_oracle.py's tolerance, at most `budget` missing (its own
    budget: one a two seeds)."""
    tpol = RendererPolicy(max_bounces=MAX_BOUNCES, rays_per_chunk=256)
    bad = 0
    for seed in seeds:
        jscene = _random_scene(seed)
        assert 5 <= jscene.spheres.radius_sq.shape[0] <= 8
        acc = seed + 1
        want, wcount = jax.jit(lambda s: jr.render_pass(
            s, POL, jnp.uint32(acc), W, H))(jscene)
        tscene = Scene.from_numpy(jax_scene_to_numpy(jscene), device="cpu")
        got, gcount = tr.render_pass(tscene, tpol, acc, W, H)
        want = np.stack([np.asarray(c) for c in want], 1)
        got = np.stack([c.numpy() for c in got], 1)
        np.testing.assert_array_equal(bits(got), bits(want), err_msg=seed)
        assert int(gcount) == int(wcount)
        scene_np, cam = _scene_to_np(jscene), _camera_to_np(jscene)
        pixel_seeds = np.asarray(jr.pixel_seeds(W, H, POL))
        g = np.random.default_rng(seed + 100)
        for px in g.choice(W * H, 24, replace=False):
            ref = oracle.trace_pixel(scene_np, int(px % W), int(px // W), acc,
                                     int(pixel_seeds[px]), MAX_BOUNCES, W, H,
                                     cam)
            bad += not np.allclose(got[px], ref, rtol=3e-3, atol=3e-3)
    assert bad <= budget, bad
