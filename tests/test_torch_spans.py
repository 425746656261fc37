"""The port's spans and counters (``utils/profiling.py``: ``span``,
``count``, ``spans``) in its render loop, and the benchmark's readers of
them (``portbench/spans.py``, ``portbench/metrics/*``).

On the CPU: the span tree of an update under a profiler, the counters
against what the test counts itself (host reads of the render loop, the
rays of ``RenderState.rays_traced``, the planner calls of
``portbench.counters.PlannerCalls``), buckets bit-equal with the profiler
on and off, nothing recorded and ``record_function`` never called with it
off; the six readers on a synthetic store and trace. On the card (marked
``cuda``): ``host_syncs`` against the synchronising operations that
``torch.cuda.set_sync_debug_mode`` reports, and the spans' self times
against the update's device time. This file imports no JAX.
"""
import collections
import os
import sys
import warnings

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from cpu_raytracing_experiments_tpu_torch.render.api import Renderer
from cpu_raytracing_experiments_tpu_torch.scene import accel, builders
from cpu_raytracing_experiments_tpu_torch.utils import profiling
from cpu_raytracing_experiments_tpu_torch.utils.config import RendererPolicy
from portbench import counters, spans, trace
from portbench.metrics import (host_syncs_per_pass, intersect_ms_per_pass,
                               live_lane_pct, rng_ms_per_pass,
                               shade_ms_per_pass, sync_idle_pct)
from portbench.run import Context

torch.set_num_threads(1)

RENDER_DIR = os.path.join("cpu_raytracing_experiments_tpu_torch", "render")
# what torch.cuda.set_sync_debug_mode('warn') says at each synchronising op
# (its other warnings, such as the one that calls the mode a prototype, are
# no such report)
SYNC_WARNING = "called a synchronizing CUDA operation"


def _renderer(kind, w, h, device="cpu", **policy):
    """The hero (9 spheres, 'brute': no narrowing) or the displaced UV
    sphere at uv_res 10 (200 triangles, just above the clustered path's
    192-prim floor) under accel 'pallas'."""
    policy = {"max_bounces": 8, **policy}
    if kind == "hero":
        scene = builders.default_scene(w, h)
    else:
        scene = accel.with_pallas_clusters(
            builders.mesh_scene(w, h, uv_res=10))
        policy["accel"] = "pallas"
    return Renderer(scene, RendererPolicy(**policy), w, h, device=device)


def _traced(r, passes):
    """One update of `passes` passes under a profiler: its span records."""
    profiling.clear()
    acts = [ProfilerActivity.CPU]
    if r.device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts):
        r.accumulate(passes)
    return profiling.spans()


def _total(recs, name):
    return sum(r["counts"].get(name, 0) for r in recs)


BOUNCE = {"port.intersect", "port.closest_hit", "port.nee",
          "port.emissive", "port.bsdf", "port.writeback"}
PARENTS = {
    "port.wavefront": {"port.update"},
    "port.camera": {"port.wavefront"},
    "port.bounce": {"port.wavefront"},
    "port.sync": {"port.wavefront"},
    "port.narrow": {"port.wavefront"},
    "port.buckets": {"port.update"},
    "port.intersect": {"port.bounce"},
    "port.closest_hit": {"port.bounce"},
    "port.nee": {"port.bounce"},
    "port.emissive": {"port.bounce"},
    "port.bsdf": {"port.bounce"},
    "port.writeback": {"port.bounce"},
    "port.occluded": {"port.nee"},
    "port.rng": {"port.wavefront", "port.camera", "port.nee", "port.bsdf"},
    "port.plan": {"port.intersect", "port.occluded"},
    "port.walk": {"port.intersect", "port.occluded"},
}


@pytest.mark.parametrize("kind", ["hero", "mesh"])
def test_span_tree_of_an_update(kind):
    """Under a profiler, one update is one port.update tree: every span
    named port.*, nested where it belongs, one update_id throughout (the
    update's first accumulation index), a port.bounce a bounce with its
    stages inside, and a second update gets the next id."""
    r = _renderer(kind, 16, 16)
    r.accumulate(2)
    recs = _traced(r, 3)
    assert recs[0]["name"] == "port.update" and recs[0]["parent"] is None
    assert recs[0]["attrs"] == {"update_id": 3, "passes": 3}
    assert all(x["update_id"] == 3 for x in recs)
    assert sum(x["parent"] is None for x in recs) == 1
    by_id = {x["id"]: x for x in recs}
    for x in recs[1:]:
        assert by_id[x["parent"]]["name"] in PARENTS[x["name"]], x["name"]
        assert x["parent"] < x["id"]
    names = collections.Counter(x["name"] for x in recs)
    bounces = [x for x in recs if x["name"] == "port.bounce"]
    assert names["port.wavefront"] == 1 and names["port.buckets"] == 3
    assert [b["attrs"]["bounce"] for b in bounces] == list(
        range(len(bounces)))
    for b in bounces:
        inside = {x["name"] for x in recs if x["parent"] == b["id"]}
        assert inside == BOUNCE
    if kind == "mesh":
        assert names["port.plan"] == names["port.walk"] > 0
    else:
        assert "port.plan" not in names
    assert all(x["device_ms"] is None for x in recs)  # no card
    recs2 = _traced(r, 1)
    assert {x["update_id"] for x in recs2} == {6}


class _Reads:
    """Counts the render loop's reads of tensors to the host: each
    ``bool``, ``int``, ``float``, ``item`` or ``tolist`` of a tensor whose
    caller is a module of ``render/`` (the CPU's plain kernels read their
    own tensors; they do not run on the card)."""

    NAMES = ("__bool__", "__int__", "__float__", "item", "tolist")

    def __init__(self, monkeypatch):
        self.n = 0
        for name in self.NAMES:
            orig = getattr(torch.Tensor, name)
            monkeypatch.setattr(torch.Tensor, name, self._wrap(orig))

    def _wrap(self, orig):
        def read(t, *a):
            if RENDER_DIR in sys._getframe(1).f_code.co_filename:
                self.n += 1
            return orig(t, *a)
        return read


@pytest.mark.parametrize("kind,w,h", [
    ("hero", 16, 16), ("mesh", 16, 16), ("mesh", 48, 48)])
def test_host_syncs_are_the_render_loops_reads(monkeypatch, kind, w, h):
    """host_syncs over an update equals the reads of the render loop that
    the test counts itself: the liveness test a bounce (the 48x48 mesh
    narrows once at 2048 lanes, so it reads the live count, then whether
    any lane lives)."""
    r = _renderer(kind, w, h)
    r.accumulate(1)
    reads = _Reads(monkeypatch)
    recs = _traced(r, 2)
    assert reads.n > 0
    assert _total(recs, "host_syncs") == reads.n
    syncs = [x for x in recs if x["name"] == "port.sync"]
    assert len(syncs) == reads.n
    sites = {x["attrs"]["site"] for x in syncs}
    assert sites == ({"live_lanes", "any_alive"} if w == 48
                     else {"any_alive"})
    narrow = [x for x in recs if x["name"] == "port.narrow"]
    assert len(narrow) == (2 if w == 48 else 0)  # the narrowing, the restore


@pytest.mark.parametrize("kind", ["hero", "mesh"])
def test_rays_traced_and_lanes(kind):
    """rays_traced summed over the spans equals the update's
    RenderState.rays_traced delta; lanes_traced counts every lane given to
    the closest-hit and the shadow calls."""
    r = _renderer(kind, 16, 16)
    r.accumulate(1)
    before = int(r.state.rays_traced)
    recs = _traced(r, 2)
    assert _total(recs, "rays_traced") == int(r.state.rays_traced) - before
    lanes = sum(x["attrs"]["lanes"] for x in recs
                if x["name"] == "port.bounce")
    shadow = sum(x["counts"]["lanes_traced"] for x in recs
                 if x["name"] == "port.occluded")
    assert shadow == lanes  # one shadow call a bounce, every lane
    assert _total(recs, "lanes_traced") == 2 * lanes


def test_plan_counters_equal_the_planner_wrapper():
    """The port.plan spans' counter and attrs equal the benchmark's
    PlannerCalls records over the same update, call by call."""
    r = _renderer("mesh", 16, 16)
    r.accumulate(1)
    profiling.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        with counters.PlannerCalls() as calls:
            r.accumulate(2)
    plans = [x for x in profiling.spans() if x["name"] == "port.plan"]
    assert len(plans) == len(calls.calls) > 0
    assert sum(c["valid"] for c in calls.calls) > 0
    for x, c in zip(plans, calls.calls):
        assert x["counts"] == {"plan_rays": c["rays"]}
        assert (x["attrs"]["plan_clusters"], x["attrs"]["plan_tile"],
                x["attrs"]["plan_mode"]) == (c["clusters"], c["tile"],
                                             c["plan"])


@pytest.mark.parametrize("kind", ["hero", "mesh"])
def test_buckets_equal_with_the_profiler_on_and_off(kind):
    """Spans change no output: buckets, ray counts and the resolved image
    are bit-equal with the profiler on and off."""
    on, off = _renderer(kind, 16, 16), _renderer(kind, 16, 16)
    _traced(on, 3)
    off.accumulate(3)
    assert torch.equal(on.state.buckets, off.state.buckets)
    assert int(on.state.rays_traced) == int(off.state.rays_traced)
    assert (on.render() == off.render()).all()


def test_nothing_is_recorded_with_the_profiler_off(monkeypatch):
    """With no profiler running a span is the shared no-op, count adds
    nothing and record_function is never called."""
    def refuse(*a, **k):
        raise AssertionError("record_function called")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    profiling.clear()
    r = _renderer("mesh", 16, 16)
    r.accumulate(2)
    assert profiling.spans() == []
    assert profiling.span("port.x", a=1) is profiling.NO_SPAN
    assert profiling.sync("x") is profiling.NO_SPAN
    with profiling.span("port.x"):
        profiling.count("n", 5)
    assert profiling.spans() == []


def test_counts_of_ints_and_device_scalars():
    """count takes ints and 0-d tensors, summed when the store is read;
    nested spans get their own counts and inherit the update_id."""
    profiling.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.span("port.a", update_id=7):
            profiling.count("n", 2)
            with profiling.span("port.b"):
                profiling.count("n", torch.tensor(3))
                profiling.count("n", 1)
                profiling.count("m", torch.tensor(4))
    recs = profiling.spans()
    assert [(x["name"], x["parent"], x["update_id"], x["counts"])
            for x in recs] == [("port.a", None, 7, {"n": 2}),
                               ("port.b", 0, 7, {"n": 4, "m": 4})]
    assert profiling.spans()[1]["counts"] == {"n": 4, "m": 4}
    profiling.clear()
    assert profiling.spans() == []


# ---------------------------------------------------------------------------
# The readers, on a synthetic store and trace
# ---------------------------------------------------------------------------
def _ev(cat, name, ts, dur, tid=1):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "pid": 7, "tid": tid}


def _rec(i, name, parent, ms, counts=None, **attrs):
    return {"id": i, "name": name, "parent": parent, "update_id": 1,
            "attrs": attrs, "counts": counts or {}, "host_start_s": 0.0,
            "host_end_s": 0.0, "device_ms": ms, "self_ms": None}


def _store():
    """An older update (dropped: the trace holds one), then the traced one
    of 2 passes: a bounce of 10 ms holding intersect 3 (with a plan), nee 4
    (rng 0.5, occluded 2), bsdf 2 (rng 1); camera rng 0.25 and a sync."""
    old = [_rec(0, "port.update", None, 99.0, {"host_syncs": 50})]
    new = [
        _rec(1, "port.update", None, 20.0, passes=2),
        _rec(2, "port.wavefront", 1, 19.0),
        _rec(3, "port.camera", 2, 1.0),
        _rec(4, "port.rng", 3, 0.25),
        _rec(5, "port.sync", 2, 0.1, {"host_syncs": 1}, site="any_alive"),
        _rec(6, "port.bounce", 2, 10.0),
        _rec(7, "port.intersect", 6, 3.0, {"lanes_traced": 100}),
        _rec(8, "port.plan", 7, 1.0),
        _rec(9, "port.nee", 6, 4.0),
        _rec(10, "port.rng", 9, 0.5),
        _rec(11, "port.occluded", 9, 2.0, {"lanes_traced": 100}),
        _rec(12, "port.bsdf", 6, 2.0),
        _rec(13, "port.rng", 12, 1.0),
        _rec(14, "port.writeback", 6, 0.5, {"rays_traced": 75}),
        _rec(15, "port.sync", 2, 0.1, {"host_syncs": 1}, site="any_alive"),
    ]
    return old + new


def _trace():
    """A window of 1000 us (one update, 2 passes): kernels busy over
    [0, 300), [400, 700) and [900, 1000); a port.sync span on the host over
    [290, 320) (the idle stretch from 300 begins inside it) and another
    over [650, 660) (no stretch begins inside it); port.bounce over
    [700, 900), so the stretch [700, 900) lies in it."""
    k = "void at::native::vectorized_elementwise_kernel<4, X>()"
    return trace.parse([
        _ev("user_annotation", trace.UPDATE_SPAN, 0, 1000),
        _ev("user_annotation", "port.update", 0, 990),
        _ev("user_annotation", "port.sync", 290, 30),
        _ev("user_annotation", "port.sync", 650, 10),
        _ev("user_annotation", "port.bounce", 700, 200),
        _ev("kernel", k, 0, 300, tid=9),
        _ev("kernel", k, 400, 300, tid=9),
        _ev("kernel", k, 900, 100, tid=9),
    ], passes=2)


def _ctx(tr):
    return Context("c", {}, {}, 0.0, [], 0.0, 0, 0, {}, trace=tr)


def test_readers_on_a_synthetic_store(monkeypatch):
    monkeypatch.setattr(spans, "store", _store)
    ctx = _ctx(_trace())
    assert [r["id"] for r in spans.records(ctx)] == list(range(1, 16))
    assert host_syncs_per_pass.read(ctx) == pytest.approx(1.0)
    # idle [300, 400) begins inside a sync; [700, 900) does not
    assert sync_idle_pct.read(ctx) == pytest.approx(10.0)
    assert live_lane_pct.read(ctx) == pytest.approx(37.5)
    assert rng_ms_per_pass.read(ctx) == pytest.approx(1.75 / 2)
    # bounce 10 less intersect 3, occluded 2, rng 0.5 and 1
    assert shade_ms_per_pass.read(ctx) == pytest.approx(3.5 / 2)
    assert intersect_ms_per_pass.read(ctx) == pytest.approx(5.0 / 2)
    # by the innermost span at each stretch's midpoint: 350 lies past the
    # first sync's end, in port.update only
    idle = spans.idle_by_span(ctx.trace)
    assert idle == pytest.approx({"port.update": 100e-6,
                                  "port.bounce": 200e-6})


def test_readers_without_spans_or_times(monkeypatch):
    """No span in the store (a program that records none) gives no value;
    spans without device times (off a card) give the counts only."""
    monkeypatch.setattr(spans, "store", lambda: [])
    ctx = _ctx(_trace())
    readers = (host_syncs_per_pass, sync_idle_pct, live_lane_pct,
               rng_ms_per_pass, shade_ms_per_pass, intersect_ms_per_pass)
    assert [m.read(ctx) for m in readers] == [None] * 6
    assert [m.read(_ctx(None)) for m in readers] == [None] * 6
    cpu = [dict(r, device_ms=None) for r in _store()]
    monkeypatch.setattr(spans, "store", lambda: cpu)
    assert host_syncs_per_pass.read(ctx) == pytest.approx(1.0)
    assert live_lane_pct.read(ctx) == pytest.approx(37.5)
    assert rng_ms_per_pass.read(ctx) is None
    assert shade_ms_per_pass.read(ctx) is None
    assert intersect_ms_per_pass.read(ctx) is None


def test_readers_on_a_cpu_run_of_the_ports_spans():
    """The readers take the port's own store: counts from a real update
    under trace.profile, the device times absent on the CPU."""
    r = _renderer("hero", 16, 16)
    r.accumulate(1)
    profiling.clear()
    tr = trace.profile(lambda: r.accumulate(2), 1, 2, cuda=False)
    ctx = _ctx(tr)
    syncs = sum(x["counts"].get("host_syncs", 0) for x in profiling.spans())
    assert syncs > 0
    assert host_syncs_per_pass.read(ctx) == pytest.approx(syncs / 2)
    assert 0.0 < live_lane_pct.read(ctx) < 100.0
    assert rng_ms_per_pass.read(ctx) is None
    assert sync_idle_pct.read(ctx) is None  # no device ops in the trace
    assert {n for n, _, _ in tr.host if n.startswith("port.")} >= {
        "port.update", "port.bounce", "port.sync", "port.rng"}


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: spans time the card's stream")


@pytest.mark.cuda
@pytest.mark.parametrize("kind,w,h,policy", [
    ("hero", 256, 256, {}),
    ("mesh", 256, 256, {}),
    ("mesh", 256, 256, {"samples_per_pixel": 4, "stratify_camera": True,
                        "max_bounces": 4}),
])
def test_host_syncs_are_the_synchronising_ops_on_the_card(kind, w, h,
                                                          policy):
    """Over one update on the card, host_syncs equals the synchronising
    operations torch.cuda.set_sync_debug_mode('warn') reports."""
    _card()
    r = _renderer(kind, w, h, device="cuda", **policy)
    r.accumulate(2)
    torch.cuda.synchronize()
    profiling.clear()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]):
            torch.cuda.set_sync_debug_mode("warn")
            try:
                r.accumulate(2)
            finally:
                torch.cuda.set_sync_debug_mode("default")
    reported = [c for c in caught if SYNC_WARNING in str(c.message)]
    recs = profiling.spans()
    assert len(reported) > 0
    assert _total(recs, "host_syncs") == len(reported)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["hero", "mesh"])
def test_self_times_sum_to_the_update(kind):
    """The self ms of every span of an update sum to its port.update device
    ms within 1%, and every span has a device time."""
    _card()
    r = _renderer(kind, 256, 256, device="cuda")
    r.accumulate(2)
    torch.cuda.synchronize()
    recs = _traced(r, 2)
    assert all(x["device_ms"] is not None for x in recs)
    update = recs[0]["device_ms"]
    assert update > 0
    assert sum(x["self_ms"] for x in recs) == pytest.approx(update, rel=0.01)
