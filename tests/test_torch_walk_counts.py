"""The cluster walks' work counters and the 1,312,200-triangle mesh's
configuration (``portbench/configs/mesh1p3m.json``).

* The plain walks count their (valid ray, real prim) pairs and their
  (tile, cluster) visits; on a hand-made pack of three clusters they equal a
  count by hand, and the ``port.walk`` span carries them, with the walk's
  form, kind and prims, while a profiler session records.
* The configuration at full size resolves to the streamed walks, tiles of
  256 and the flat planner under the default policy (from its prim count:
  no 1.3M-triangle build), and at 288 triangles through ``Renderer`` with
  the streamed walks it agrees with the benchmark's plain reference within
  the cell's limits.
* The benchmark's readers of the streamed walks' metrics, on a synthetic
  trace and span store.
* On the card (``cuda``): every walk form's kernel counts, at S = 1, 2
  and 4, equal the plain walk's; without a profiler session the kernel is
  handed no counter and a streamed render's buckets are those the walks
  gave before they could count.

The file imports no JAX, so its ``cuda`` tests run on the card without
``tests/conftest.py``: ``python -m pytest --noconftest -q -m cuda
tests/test_torch_walk_counts.py``.
"""
import copy
import dataclasses
import hashlib
import json
import shutil

import numpy as np
import pytest
import torch

from cpu_raytracing_experiments_tpu_torch.core.vec import Vec3
from cpu_raytracing_experiments_tpu_torch.ops import clustered as tcl
from cpu_raytracing_experiments_tpu_torch.ops import intersect as tint
from cpu_raytracing_experiments_tpu_torch.ops.kernels import \
    cluster_traverse as ttk
from cpu_raytracing_experiments_tpu_torch.utils import profiling
from portbench import check, manifest, run, scenes, spans, trace
from portbench.metrics import (stream_walk_ms_per_pass,
                               stream_walk_roofline_pct)

torch.set_num_threads(1)

FLT_MAX = float(np.float32(3.4028235e38))
CELL = "mesh1p3m.final-1080p"


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the walk kernels have no CPU form")
    return torch.device("cuda")


def _vec(a, device="cpu"):
    a = torch.as_tensor(np.asarray(a, np.float32), device=device)
    return Vec3(a[:, 0].contiguous(), a[:, 1].contiguous(),
                a[:, 2].contiguous())


def _spans_of(fn):
    """fn() under a CPU profiler session; its return value and the spans
    recorded in it."""
    profiling.clear()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        out = fn()
    recs = profiling.spans()
    profiling.clear()
    return out, recs


# ---------------------------------------------------------------------------
# The plain walks' counts, by hand
# ---------------------------------------------------------------------------
def _three_clusters():
    """Three clusters of unit spheres down the -z axis, K = 4 slots:
    cluster 0 at z = 0 holds 3 (the axis sphere in slot 1), cluster 1 at
    z = -6 holds 2, cluster 2 at z = -12 holds 4 (the sphere at y = 3 in
    slot 3). Padding slots are the builders' far-away degenerate prims."""
    clusters = [[(3, 0, 0), (0, 0, 0), (-3, 0, 0)],
                [(0, 0, -6), (3, 0, -6)],
                [(0, 0, -12), (3, 0, -12), (-3, 0, -12), (0, 3, -12)]]
    k = 4
    rows, order, lo, hi = [], [], [], []
    prim = 0
    for members in clusters:
        c = np.asarray(members, np.float32)
        lo.append(c.min(axis=0) - 1.0)
        hi.append(c.max(axis=0) + 1.0)
        for s in range(k):
            if s < len(members):
                rows.append([*members[s], 1.0])
                order.append(prim)
                prim += 1
            else:
                rows.append([1e16, 0.0, 0.0, 0.0])
                order.append(-1)
    return tcl.ClusteredPrims.from_numpy({
        "rows": np.asarray(rows, np.float32),
        "order": np.asarray(order, np.int32),
        "lo": np.asarray(lo), "hi": np.asarray(hi),
        "num_clusters": 3, "cluster_size": k, "kind": "sphere"})


# one tile of 4 rays down -z from z = 10: on the axis, at x = 3, at y = 3,
# and a fourth lane that is not valid (closest) / has tfar 0 (any hit)
ORIGINS = [(0, 0, 10), (3, 0, 10), (0, 3, 10), (0, 0, 10)]
DIRS = [(0, 0, -1)] * 4

# By hand. The tile's list is clusters 0, 1, 2 (entries 9, 15, 21), and the
# exit bound stays at the root box's exit (23) while the ray at y = 3 has
# no hit, so the walks visit all three.
# Closest: 3 valid rays x (3 + 2 + 4) real prims = 27 pairs.
# Any hit (tfar 100, 5, 100, 0): cluster 0: the axis ray up to its
# occluder in slot 1 (2), the x = 3 ray (its sphere lies beyond tfar 5)
# and the y = 3 ray all 3: 8; cluster 1: the x = 3 and y = 3 rays, 2 each:
# 4; cluster 2: the x = 3 ray all 4, the y = 3 ray up to slot 3: 4 + 4 = 8.
CLOSEST = {"visits": 3, "pairs": 27}
ANYHIT = {"visits": 3, "pairs": 8 + 4 + 8}


def test_plain_walk_counts_equal_a_hand_count():
    cp = _three_clusters()
    assert cp.filled.tolist() == [3, 2, 4]
    p, d = _vec(ORIGINS), _vec(DIRS)
    tf0 = torch.full((4,), FLT_MAX)
    valid = torch.tensor([True, True, True, False])
    plan = ttk._plan_visits(cp, p, d, tf0, valid, 4)
    assert plan[2].tolist() == [3] and plan[0][0].tolist() == [0, 1, 2]
    closest = {}
    tfar, prim = ttk.walk_closest_plain(cp, *plan, p, d, tf0, valid, 4,
                                        stats=closest)
    assert closest == CLOSEST
    assert prim.tolist() == [1, 0, 11, -1]
    tf = torch.tensor([100.0, 5.0, 100.0, 0.0])
    splan = ttk._plan_visits(cp, p, d, tf, tf > 0, 4)
    anyhit = {}
    occ = ttk.walk_occluded_plain(cp, *splan, p, d, tf, 4, stats=anyhit)
    assert anyhit == ANYHIT
    assert occ.tolist() == [True, False, True, False]


def test_walk_span_carries_the_counts():
    """Under a profiler session the wrappers' ``port.walk`` spans count
    the plain walks' pairs and visits and the rays given, and say which
    walk ran; with no session nothing records and the counter row is
    None."""
    cp = _three_clusters()
    p, d = _vec(ORIGINS), _vec(DIRS)
    alive = torch.tensor([True, True, True, False])
    tf = torch.tensor([100.0, 5.0, 100.0, 0.0])

    def both():
        return (ttk.intersect_clustered_pallas(cp, p, d, alive=alive,
                                               tile_r=4),
                ttk.occluded_clustered_pallas(cp, p, d, tf, tile_r=4))

    (hit, occ), recs = _spans_of(both)
    walks = [r for r in recs if r["name"] == "port.walk"]
    assert [r["attrs"] for r in walks] == [
        {"walk_form": "resident", "walk_kind": "closest",
         "walk_prims": "sphere"},
        {"walk_form": "resident", "walk_kind": "anyhit",
         "walk_prims": "sphere"}]
    assert walks[0]["counts"] == {"walk_pairs": 27, "walk_visits": 3,
                                  "walk_rays": 4}
    assert walks[1]["counts"] == {"walk_pairs": 20, "walk_visits": 3,
                                  "walk_rays": 4}
    assert hit[1].tolist() == [1, 0, 8, -1]
    assert occ.tolist() == [True, False, True, False]
    assert not profiling.recording()
    assert ttk._count_row("walk", cp, torch.device("cpu")) is None


# ---------------------------------------------------------------------------
# The configuration
# ---------------------------------------------------------------------------
class _Pack:
    """What ``_tile_for`` and ``table_bytes`` read of a cluster pack."""

    def __init__(self, kind, num_clusters, cluster_size):
        self.kind = kind
        self.num_clusters = num_clusters
        self.cluster_size = cluster_size


def _config_and_traffic():
    mf = manifest.Manifest()
    wl = mf.workload(CELL)
    return mf, mf.config(wl["config"]), mf.traffic(wl["traffic"])


def test_full_size_resolves_to_the_streamed_walks():
    """mesh1p3m's 1,312,200 triangles take K = 256 (cluster_size='auto')
    and at least ceil(P / K) = 5,126 clusters (the SAH build makes more):
    even that many make tables over PALLAS_STREAM_BYTES, so the cell's
    policy resolves to the streamed walks and tiles of 256 under the flat
    'ray' planner, with no product-form battery."""
    from cpu_raytracing_experiments_tpu_torch.scene import accel

    _, config, traffic = _config_and_traffic()
    (mesh,) = config["meshes"]
    prims = 2 * mesh["n_u"] * mesh["n_v"]
    assert prims == 1_312_200
    assert config["clusters"] == {"cluster_size": "auto", "method": "sah"}
    k = accel.auto_cluster_size(prims)
    assert k == 256
    pack = _Pack("triangle", -(-prims // k), k)
    assert ttk.table_bytes(pack) > tint.PALLAS_STREAM_BYTES
    policy = run.port_policy(config, traffic)
    # the default policy's: 'auto' stream and tile, the default planner
    assert (policy.pallas_stream, policy.pallas_plan,
            policy.pallas_tile_rays) == ("auto", "ray", "auto")
    kw = tint._tile_for(tint._pallas_kw(policy), pack)
    assert (kw["stream"], kw["tile_r"], kw["plan"], kw["mxu"]) == (
        True, 256, "ray", False)
    assert policy.rays_per_chunk == 1 << 23


def test_small_mesh1p3m_agrees_with_the_reference():
    """The configuration with n_u = n_v = 12 (288 triangles; nothing else
    changed) through ``Renderer`` with the streamed walks, at 32x24 for 5
    passes, against ``portbench.reference.pathtrace`` at every pixel:
    within the cell's limits. The clusters are of 128 triangles: the
    'auto' size at 288 triangles is 64, for which the streamed walks are
    switched off."""
    from cpu_raytracing_experiments_tpu_torch.render import estimator
    from cpu_raytracing_experiments_tpu_torch.render.api import Renderer
    from cpu_raytracing_experiments_tpu_torch.scene import accel
    from cpu_raytracing_experiments_tpu_torch.scene.scene import Scene
    from portbench.reference import pathtrace

    mf, config, traffic = _config_and_traffic()
    config = copy.deepcopy(config)
    config["meshes"][0].update(n_u=12, n_v=12)
    width, height, passes, seed = 32, 24, 5, 2 ** 31 + 99
    inputs = scenes.build(config, width, height)
    assert inputs["tri_v0"].shape[0] == 288
    scene = accel.with_pallas_clusters(
        Scene.from_numpy(scenes.port_arrays(inputs)), cluster_size=128,
        method="sah")
    policy = dataclasses.replace(run.port_policy(config, traffic),
                                 pallas_stream=True)
    assert tint.stream_resolves_on(policy, scene.tri_clusters)
    r = Renderer(scene, policy, width, height, device=torch.device("cpu"))
    first = seed & run.MASK
    r.state = dataclasses.replace(r.state,
                                  accumulations=(first - 1) & run.MASK)
    _, recs = _spans_of(lambda: r.accumulate(passes))
    walks = [x for x in recs if x["name"] == "port.walk"]
    assert walks and {x["attrs"]["walk_form"] for x in walks} == {
        "streamed"}
    assert sum(x["counts"]["walk_pairs"] for x in walks) > 0
    pixels = torch.arange(width * height)
    image = estimator.resolve(
        dataclasses.replace(r.state, accumulations=passes), policy,
        r.scene.camera.exposure, width, height).reshape(-1, 3)
    ref_policy = run.reference_policy(policy)
    rsc = pathtrace.make_scene(inputs, torch.device("cpu"))
    ref_buckets = pathtrace.buckets(rsc, ref_policy, pixels, first, passes,
                                    width)
    ref_image = pathtrace.resolve(ref_buckets, passes, ref_policy.spp,
                                  float(r.scene.camera.exposure))
    numbers = check.compare(r.state.buckets, ref_buckets, image, ref_image)
    limits = mf.check(CELL)["limits"]
    assert check.judge(numbers, limits), numbers


def _small_manifest(tmp_path):
    """A copy of the benchmark whose mesh1p3m configuration has n_u = n_v =
    12 (288 triangles) and clusters of 128, so that the cell renders on the
    CPU through the streamed walks; nothing else changed."""
    bench = tmp_path / "portbench"
    shutil.copytree(manifest.HERE, bench,
                    ignore=shutil.ignore_patterns("__pycache__"))
    (tmp_path / "BENCHMARK.json").write_text(
        (manifest.ROOT / "BENCHMARK.json").read_text())
    path = bench / "configs" / "mesh1p3m.json"
    config = json.loads(path.read_text())
    config["meshes"][0].update(n_u=12, n_v=12)
    config["clusters"]["cluster_size"] = 128
    path.write_text(json.dumps(config))
    return manifest.Manifest(tmp_path, bench)


@pytest.mark.parametrize("fault", ["sound", "noop", "half", "altered"])
def test_planted_faults_come_out_not_correct(tmp_path, monkeypatch, fault):
    """The faults of ``portbench/tests/test_portbench_control.py`` planted
    in the timed path of a run of the cell (at 288 triangles, 16x16, two
    updates: 8 passes): each comes out not correct under the cell's
    limits; the sound run comes out correct."""
    from cpu_raytracing_experiments_tpu_torch.render import (estimator,
                                                             renderer)
    from portbench.tests import test_portbench_control as faults

    if fault == "noop":
        monkeypatch.setattr(estimator, "accumulate_n", faults._noop)
    elif fault == "half":
        monkeypatch.setattr(renderer, "render_pass",
                            faults._half_left_out(renderer.render_pass))
    elif fault == "altered":
        monkeypatch.setattr(renderer, "render_pass",
                            faults._answer_altered(renderer.render_pass))
    out = run.run_cell(CELL, 424242, 1e9, False, device="cpu",
                       frame=(16, 16), max_updates=2,
                       mf=_small_manifest(tmp_path))
    assert out.result["correct"] == (fault == "sound"), out.numbers


# ---------------------------------------------------------------------------
# The benchmark's readers
# ---------------------------------------------------------------------------
STREAM_CLOSEST = ("void (anonymous namespace)::closest_kernel<1, true, 2>"
                  "(int const*)")
STREAM_ANYHIT = ("void (anonymous namespace)::occluded_kernel<1, true, 4>"
                 "(int const*)")
RESIDENT = "void (anonymous namespace)::closest_kernel<1, false, 2>(int)"


def _ev(cat, name, ts, dur, tid=1):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "pid": 7, "tid": tid}


def _trace():
    """Two traced updates of 4 passes each: the streamed walks take 300 +
    100 us of device time, a resident walk 50."""
    return trace.parse([
        _ev("user_annotation", trace.UPDATE_SPAN, 0, 500),
        _ev("user_annotation", trace.UPDATE_SPAN, 500, 500),
        _ev("kernel", STREAM_CLOSEST, 100, 300, tid=9),
        _ev("kernel", STREAM_ANYHIT, 600, 100, tid=9),
        _ev("kernel", RESIDENT, 800, 50, tid=9),
    ], passes=8)


def _records(counted: bool):
    """The store of the two updates: a streamed closest and any-hit walk
    each, and a resident walk, counted or (as on a tree that counts
    nothing) not."""
    recs, ident = [], 0
    for u in range(2):
        root = ident
        recs.append({"id": root, "name": "port.update", "parent": None,
                     "attrs": {}, "counts": {}, "device_ms": 0.5})
        ident += 1
        for form, kind, pairs, rays in (
                ("streamed", "closest", 10 ** 8, 10 ** 6),
                ("streamed", "anyhit", 4 * 10 ** 7, 10 ** 6),
                ("resident", "closest", 10 ** 9, 10 ** 6)):
            attrs = {"walk_form": form, "walk_kind": kind,
                     "walk_prims": "triangle"} if counted else {}
            counts = {"walk_pairs": pairs, "walk_visits": 7,
                      "walk_rays": rays} if counted else {}
            recs.append({"id": ident, "name": "port.walk", "parent": root,
                         "attrs": attrs, "counts": counts,
                         "device_ms": 0.1})
            ident += 1
    return recs


def _ctx(tr):
    return run.Context(CELL, {}, {}, 0.0, [], 0.0, 0, 0, {}, trace=tr)


def test_stream_walk_ms_per_pass_reads_the_streamed_kernels():
    assert stream_walk_ms_per_pass.read(_ctx(_trace())) == pytest.approx(
        0.400 / 8)
    assert stream_walk_ms_per_pass.read(_ctx(None)) is None
    tr = _trace()
    tr.kernels = [k for k in tr.kernels if k[0] == RESIDENT]
    assert stream_walk_ms_per_pass.read(_ctx(tr)) is None
    assert stream_walk_ms_per_pass.STREAM.match(STREAM_CLOSEST)
    assert not stream_walk_ms_per_pass.STREAM.match(RESIDENT)


def test_stream_walk_roofline_pct_reads_the_counted_pairs(monkeypatch):
    """100 x the least time of the streamed calls' pairs (38 ops a closest
    pair, 39 an any-hit one, at 67 TFLOP/s; each call bound by operations)
    over the streamed kernels' 400 us; None without the counters, as on a
    tree that counts nothing, and without a trace."""
    monkeypatch.setattr(spans, "store", lambda: _records(True))
    least = 2 * (10 ** 8 * 38 + 4 * 10 ** 7 * 39) / 67e12
    assert stream_walk_roofline_pct.read(_ctx(_trace())) == pytest.approx(
        100.0 * least / 400e-6)
    assert stream_walk_roofline_pct.read(_ctx(None)) is None
    monkeypatch.setattr(spans, "store", lambda: _records(False))
    assert stream_walk_roofline_pct.read(_ctx(_trace())) is None


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------
def _pack(kind, n_prims=3000, k=128, seed=11):
    g = np.random.default_rng(seed)
    if kind == "sphere":
        centers = g.uniform(-6, 6, (n_prims, 3)).astype(np.float32)
        radii = g.uniform(0.1, 0.7, n_prims).astype(np.float32)
        rows = np.concatenate([centers, (radii ** 2)[:, None]], axis=1)
        mins, maxs = centers - radii[:, None], centers + radii[:, None]
    else:
        v0 = g.uniform(-6, 6, (n_prims, 3)).astype(np.float32)
        e1 = g.normal(0, 0.9, (n_prims, 3)).astype(np.float32)
        e2 = g.normal(0, 0.9, (n_prims, 3)).astype(np.float32)
        rows = np.concatenate([v0, e1, e2], axis=1)
        corners = np.stack([v0, v0 + e1, v0 + e2])
        mins, maxs = corners.min(axis=0), corners.max(axis=0)
    return tcl.build_clusters_sah(mins, maxs, rows, cluster_size=k,
                                  kind=kind)


def _card_rays(n, seed, device):
    g = np.random.default_rng(seed)
    p = g.uniform(-9, 9, (n, 3)).astype(np.float32)
    d = g.normal(size=(n, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    alive = torch.from_numpy(g.random(n) < 0.6).to(device)
    return _vec(p, device), _vec(d, device), alive


def _counted(fn):
    """fn() inside a ``port.walk`` span under a profiler session: its
    value and the span's walk counters."""
    def inside():
        with profiling.span("port.walk"):
            return fn()

    out, recs = _spans_of(inside)
    (rec,) = [r for r in recs if r["name"] == "port.walk"]
    return out, {k: v for k, v in rec["counts"].items()
                 if k.startswith("walk_")}


FORMS = [("sphere", False, False), ("sphere", True, False),
         ("triangle", False, False), ("triangle", True, False),
         ("triangle", False, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("split", [1, 2, 4])
@pytest.mark.parametrize("kind,stream,mxu", FORMS)
def test_kernel_counts_equal_the_plain_walks(card, monkeypatch, split, kind,
                                             stream, mxu):
    """Each walk form's kernel (resident, streamed, product; closest and
    any hit) at S = `split`: its pairs and visits equal the plain walk's on
    the same plan, its results too, bit for bit."""
    monkeypatch.setattr(ttk, "_stream_split", lambda *args: split)
    cp = _pack(kind).to(card)
    packed = ttk._tables_packed(cp) if stream else None
    n, tile = 6000, 64
    p, d, alive = _card_rays(n, 21, card)
    tf0 = torch.full((n,), FLT_MAX, device=card)
    plan = ttk._plan_visits(cp, p, d, torch.where(alive, tf0, 0.0), alive,
                            tile)
    (kt, kid), counts = _counted(lambda: ttk.walk_closest(
        cp, *plan, p, d, tf0, alive, tile, mxu=mxu, stream=stream))
    stats = {}
    pt, pid = ttk.walk_closest_plain(cp, *plan, p, d, tf0, alive, tile,
                                     stats=stats, mxu=mxu, packed=packed)
    assert torch.equal(kid, pid)
    assert torch.equal(kt.view(torch.int32), pt.view(torch.int32))
    assert counts == {"walk_pairs": stats["pairs"],
                      "walk_visits": stats["visits"], "walk_rays": n}
    assert stats["pairs"] > 0
    # shadow distances just before and just behind each closest hit
    scale = torch.where(torch.arange(n, device=card) % 2 == 0, 1.001, 0.999)
    tf = torch.where(alive, torch.where(kid >= 0, kt * scale, 5.0), 0.0)
    splan = ttk._plan_visits(cp, p, d, tf, tf > 0, tile)
    ko, counts = _counted(lambda: ttk.walk_occluded(
        cp, *splan, p, d, tf, tile, mxu=mxu, stream=stream))
    stats = {}
    po = ttk.walk_occluded_plain(cp, *splan, p, d, tf, tile, stats=stats,
                                 mxu=mxu, packed=packed)
    assert torch.equal(ko, po)
    assert 0 < int(ko.sum()) < int(alive.sum())
    assert counts == {"walk_pairs": stats["pairs"],
                      "walk_visits": stats["visits"], "walk_rays": n}


# SHA-256 of the buckets of _streamed_render on the card, rendered by the
# tree before the counters (no counter argument) and by this one: equal
STREAMED_BUCKETS_SHA = ("cbf8f5cb10799dad664889c9191d8c7f"
                        "29a91e344b4293c5f3ad3384feeb23fc")


def _streamed_render(device):
    """mesh_scene(96, 96, subdivisions=3) in clusters of 128 under the
    streamed walks, 10 passes of 6 bounces (chip_smoke.py's phase 12)."""
    from cpu_raytracing_experiments_tpu_torch.render.api import Renderer
    from cpu_raytracing_experiments_tpu_torch.scene import accel, builders
    from cpu_raytracing_experiments_tpu_torch.utils.config import \
        RendererPolicy

    scene = accel.with_pallas_clusters(
        builders.mesh_scene(96, 96, subdivisions=3), cluster_size=128)
    policy = RendererPolicy(max_bounces=6, rays_per_chunk=9216,
                            accel="pallas", pallas_tile_rays=64,
                            pallas_stream=True)
    r = Renderer(scene, policy, 96, 96, device=device)
    r.accumulate(10)
    return r.state.buckets


@pytest.mark.cuda
def test_uncounted_walks_leave_the_buckets_as_they_were(card, monkeypatch):
    """With no profiler session every walk launch is handed null counters
    and the streamed render's buckets equal the ones rendered before the
    counters existed; under a session they are the same bits."""
    handed = []
    orig = ttk._count_args

    def spy(cp, row):
        handed.append(row)
        return orig(cp, row)

    monkeypatch.setattr(ttk, "_count_args", spy)
    buckets = _streamed_render(card)
    assert handed and all(row is None for row in handed)
    digest = hashlib.sha256(buckets.cpu().numpy().tobytes()).hexdigest()
    assert digest == STREAMED_BUCKETS_SHA
    handed.clear()
    counted, _ = _spans_of(lambda: _streamed_render(card))
    assert handed and all(row is not None for row in handed)
    assert torch.equal(counted, buckets)
