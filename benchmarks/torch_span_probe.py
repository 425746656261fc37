#!/usr/bin/env python3
"""The port's spans on the card, cell by cell of the benchmark: what the
host syncs on, where the device idles, and what the spans cost.

    python3 benchmarks/torch_span_probe.py [--cells C,...] [--updates N]
        [--rounds N] [--seed N] [--out DIR]

For each cell of BENCHMARK.json (all by default) it sets the cell up as
``portbench.run`` does (the full frame, one warm-up update), then prints
JSON lines:
  syncs     one update under a profiler with
            ``torch.cuda.set_sync_debug_mode('warn')``: the synchronising
            operations it reports, each with the port's innermost frames,
            beside the update's ``host_syncs`` counter;
  spans     `--updates` traced updates (the harness's own profiler window,
            ``portbench.trace.profile``): the six span metrics, the idle
            seconds by the innermost port.* span (and the share of idle
            time inside a port.* span other than port.update), and device
            and self ms a pass by span name, every counter summed over
            the spans a pass (``launches.<kernel>``, ``host_syncs``,
            ``rng_eager_lanes``, ``nee_kernel_lanes``,
            ``nee_eager_lanes``, ``shade_kernel_lanes``, ...; the eight
            of REPORTED always, 0 where nothing counted them); the self
            ms of each update's spans against its port.update device ms;
  overhead  `--rounds` times (on, off, off, on) the same traced window with
            the spans recording and with ``profiling.span`` replaced by the
            no-op in this script: the median update's wall ms of each.
Each line carries the card's name and power limit. It writes the lines to
DIR/spans.jsonl too. It loads no JAX.
"""
from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time
import traceback
import warnings

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

PKG = "cpu_raytracing_experiments_tpu_torch"
# what torch.cuda.set_sync_debug_mode('warn') says at each synchronising op
SYNC_WARNING = "called a synchronizing CUDA operation"
# counters reported a pass even where no span counted them (0 then): which
# path shaded NEE and the rest of the hit shading, and the kernels' launches
REPORTED = ("nee_kernel_lanes", "nee_eager_lanes", "launches.nee_sphere",
            "launches.nee_combine", "shade_kernel_lanes", "shade_eager_lanes",
            "launches.shade_frame", "launches.shade_tail")
READERS = ("host_syncs_per_pass", "sync_idle_pct", "live_lane_pct",
           "rng_ms_per_pass", "shade_ms_per_pass", "intersect_ms_per_pass",
           "launches_per_pass", "device_idle_pct", "aten_ms_per_pass")


def card() -> dict:
    import torch

    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader", "-i", "0"],
                         capture_output=True, text=True).stdout.strip()
    return {"card": torch.cuda.get_device_name(0), "smi": out}


def setup(cell: str, seed: int):
    """The cell's renderer, warmed up, and its passes an update."""
    import torch

    from portbench import manifest, run, scenes
    from cpu_raytracing_experiments_tpu_torch.render.api import Renderer
    from cpu_raytracing_experiments_tpu_torch.scene import accel
    from cpu_raytracing_experiments_tpu_torch.scene.scene import Scene

    mf = manifest.Manifest()
    wl = mf.workload(cell)
    config, traffic = mf.config(wl["config"]), mf.traffic(wl["traffic"])
    w, h = traffic["width"], traffic["height"]
    inputs = scenes.build(config, w, h)
    scene = Scene.from_numpy(scenes.port_arrays(inputs))
    if "clusters" in config:
        scene = accel.with_pallas_clusters(scene, **config["clusters"])
    r = Renderer(scene, run.port_policy(config, traffic), w, h,
                 device="cuda")
    k = int(traffic["passes_per_update"])
    r.accumulate(k)
    torch.cuda.synchronize()
    r.state = dataclasses.replace(r.state, accumulations=seed & 0xFFFFFFFF)
    return r, k


def sync_search(r, k: int) -> dict:
    """One update with the card's sync debug mode on, under a profiler so
    that the spans count host_syncs of the same update."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from cpu_raytracing_experiments_tpu_torch.utils import profiling

    sites = collections.Counter()

    def hook(message, category, filename, lineno, file=None, line=None):
        if SYNC_WARNING not in str(message):
            return
        frames = [f"{os.path.relpath(f.filename, ROOT)}:{f.lineno}:{f.name}"
                  for f in traceback.extract_stack()[:-1]
                  if PKG in f.filename]
        sites[" < ".join(reversed(frames[-3:]))] += 1

    profiling.clear()
    saved = warnings.showwarning
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = hook
        try:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]):
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    r.accumulate(k)
                finally:
                    torch.cuda.set_sync_debug_mode("default")
        finally:
            warnings.showwarning = saved
    torch.cuda.synchronize()
    recs = profiling.spans()
    by_site = collections.Counter(x["attrs"]["site"] for x in recs
                                  if x["name"] == "port.sync")
    return {"reported": sum(sites.values()), "sites": dict(sites),
            "host_syncs": sum(x["counts"].get("host_syncs", 0)
                              for x in recs),
            "host_syncs_by_site": dict(by_site), "passes": k}


def traced(r, k: int, updates: int, cell: str) -> dict:
    import torch

    import cpu_raytracing_experiments_tpu_torch as port
    from portbench import manifest, run, spans, trace
    from cpu_raytracing_experiments_tpu_torch.utils import profiling

    def update():
        r.accumulate(k)
        torch.cuda.synchronize()

    profiling.clear()
    tr = trace.profile(update, updates, updates * k, True)
    ctx = run.Context(cell=cell, config={}, traffic={}, setup_s=0.0,
                      update_s=[], window_s=0.0, samples=0, peak_bytes=0,
                      spans={}, trace=tr,
                      csrc_kernels=frozenset(trace.csrc_kernels(
                          os.path.join(os.path.dirname(port.__file__),
                                       "csrc"))))
    metrics = {m: manifest.reader(m)(ctx) for m in READERS}
    recs = spans.records(ctx)
    idle = spans.idle_by_span(tr)
    total_idle = sum(idle.values())
    inside = sum(v for n, v in idle.items()
                 if n.startswith("port.") and n != "port.update")
    dev = collections.Counter()
    own = collections.Counter()
    counts = collections.Counter(dict.fromkeys(REPORTED, 0))
    for x in recs:
        dev[x["name"]] += x["device_ms"] / tr.passes
        own[x["name"]] += x["self_ms"] / tr.passes
        for name, n in x["counts"].items():
            counts[name] += n / tr.passes
    roots = [x for x in recs if x["name"] == "port.update"]
    by_root = collections.defaultdict(float)
    parent = {x["id"]: x["parent"] for x in recs}
    for x in recs:
        top = x["id"]
        while parent[top] is not None:
            top = parent[top]
        by_root[top] += x["self_ms"]
    return {"metrics": metrics, "window_s": tr.window_s,
            "busy_s": trace.busy_s(tr), "passes": tr.passes,
            "idle_s_by_span": dict(sorted(idle.items(),
                                          key=lambda kv: -kv[1])),
            "idle_in_port_spans_share": inside / total_idle if total_idle
            else None,
            "device_ms_per_pass": dict(dev.most_common()),
            "self_ms_per_pass": dict(own.most_common()),
            "counts_per_pass": dict(sorted(counts.items())),
            "update_device_ms": [x["device_ms"] for x in roots],
            "update_self_sum_ms": [by_root[x["id"]] for x in roots],
            "spans_per_update": len(recs) / max(1, len(roots))}


def overhead(r, k: int, updates: int, rounds: int) -> dict:
    """Median wall ms of an update in the traced window with the spans
    recording (on) and with profiling.span the no-op (off)."""
    import torch

    from portbench import trace
    from cpu_raytracing_experiments_tpu_torch.utils import profiling

    real = profiling.span
    times = {"on": [], "off": []}

    def update():
        t0 = time.perf_counter()
        r.accumulate(k)
        torch.cuda.synchronize()
        times[mode].append(time.perf_counter() - t0)

    for _ in range(rounds):
        for mode in ("on", "off", "off", "on"):
            profiling.clear()
            if mode == "off":
                profiling.span = lambda name, **attrs: profiling.NO_SPAN
            try:
                trace.profile(update, updates, updates * k, True)
            finally:
                profiling.span = real
    profiling.clear()
    med = {m: 1e3 * statistics.median(v) for m, v in times.items()}
    return {"update_ms_on": med["on"], "update_ms_off": med["off"],
            "cost_pct": 100.0 * (med["on"] / med["off"] - 1.0),
            "updates_each": len(times["on"])}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cells", default="")
    ap.add_argument("--updates", type=int, default=3)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--seed", type=int, default=2718281834)
    ap.add_argument("--out", default="probe_out/spans")
    args = ap.parse_args(argv)

    import torch

    from portbench import manifest

    if not torch.cuda.is_available():
        print("torch_span_probe: needs a CUDA card", file=sys.stderr)
        return 2
    cells = ([c for c in args.cells.split(",") if c] or
             [w["name"] for w in manifest.Manifest().data["workloads"]])
    os.makedirs(args.out, exist_ok=True)
    info = card()
    with open(os.path.join(args.out, "spans.jsonl"), "a") as f:
        def emit(**line):
            text = json.dumps({**line, **info}, default=str)
            print(text, flush=True)
            f.write(text + "\n")

        for cell in cells:
            r, k = setup(cell, args.seed)
            emit(kind="syncs", cell=cell, **sync_search(r, k))
            emit(kind="spans", cell=cell,
                 **traced(r, k, args.updates, cell))
            emit(kind="overhead", cell=cell,
                 **overhead(r, k, args.updates, args.rounds))
            del r
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
