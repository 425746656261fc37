"""The device side of a traced run, read from a synthetic Chrome trace:
busy time as the union of device intervals, the idle share, the labels of
idle stretches, and which kernels are the port's own."""
import pytest

import cpu_raytracing_experiments_tpu_torch as port
from portbench import trace
from portbench.metrics import (aten_ms_per_pass, device_idle_pct,
                               launches_per_pass, walk_ms_per_pass)
from portbench.run import Context

WALK = "void (anonymous namespace)::closest_kernel<0, false, 2>(int const*)"
SPHERE = "closest_kernel(float const*, float const*)"
ATEN = "void at::native::vectorized_elementwise_kernel<4, at::native::X>()"


def ev(cat, name, ts, dur, tid=1):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "pid": 7, "tid": tid}


def synthetic():
    """A window of 1000 us (two updates of 2 passes each) with kernels busy
    over [100, 400) and [600, 700) (overlapping ones merged) and a memcpy
    at [850, 900)."""
    return [
        ev("user_annotation", trace.UPDATE_SPAN, 0, 600),
        ev("user_annotation", trace.UPDATE_SPAN, 600, 400),
        ev("cpu_op", "aten::nonzero", 420, 160),
        ev("cuda_runtime", "cudaLaunchKernel", 50, 40),
        ev("cpu_op", "aten::mul", 20, 300, tid=2),  # another thread
        ev("kernel", WALK, 100, 200, tid=9),
        ev("kernel", ATEN, 250, 150, tid=9),
        ev("kernel", SPHERE, 600, 100, tid=9),
        ev("gpu_memcpy", "Memcpy DtoH", 850, 50, tid=9),
        ev("gpu_user_annotation", trace.UPDATE_SPAN, 0, 1000, tid=9),
    ]


def test_busy_and_idle_share():
    tr = trace.parse(synthetic(), passes=4)
    assert tr.window == (0.0, 1000.0)
    assert trace.busy_intervals(tr) == [(100.0, 400.0), (600.0, 700.0),
                                        (850.0, 900.0)]
    assert trace.busy_s(tr) == pytest.approx(450e-6)
    ctx = Context("c", {}, {}, 0.0, [], 0.0, 0, 0, {}, trace=tr,
                  csrc_kernels=frozenset({"closest_kernel"}))
    assert device_idle_pct.read(ctx) == pytest.approx(55.0)
    assert launches_per_pass.read(ctx) == pytest.approx(3 / 4)
    assert aten_ms_per_pass.read(ctx) == pytest.approx(0.150e-3 * 1e3 / 4)
    assert walk_ms_per_pass.read(ctx) == pytest.approx(0.200 / 4)


def test_idle_stretches_are_labelled_by_the_updating_thread():
    tr = trace.parse(synthetic(), passes=4)
    gaps = dict((k, v) for k, v in trace.top(trace.idle_gaps(tr)))
    # [0, 100): the launch call at 50; [400, 600): nonzero at 500 (the
    # other thread's op is ignored); [700, 850) and [900, 1000): Python
    assert gaps["cudaLaunchKernel"] == pytest.approx(100e-6)
    assert gaps["aten::nonzero"] == pytest.approx(200e-6)
    assert gaps["host Python between ops"] == pytest.approx(250e-6)
    b = trace.breakdown(tr)
    assert b["device_ops"][0][0] == "closest_kernel<0, false, 2>"
    assert len(b["device_ops"]) <= 10 and len(b["idle_gaps"]) <= 10


def test_the_ports_kernels_are_told_from_pytorchs():
    import os

    names = trace.csrc_kernels(os.path.join(os.path.dirname(port.__file__),
                                            "csrc"))
    assert {"closest_kernel", "occluded_kernel", "plan_kernel",
            "flat_kernel"} <= names
    assert trace.is_csrc(WALK, names) and trace.is_csrc(SPHERE, names)
    assert not trace.is_csrc(ATEN, names)
    assert not trace.is_csrc("void cub::closest_kernel<1>()", names)
    assert walk_ms_per_pass.WALK.match(WALK)
    assert not walk_ms_per_pass.WALK.match(SPHERE)


def test_a_trace_without_updates_is_refused():
    with pytest.raises(ValueError):
        trace.parse([ev("kernel", ATEN, 0, 1)], passes=1)
