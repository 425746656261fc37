"""Run one cell of the benchmark once and print its result line.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

A cell is a configuration (``configs/<config>.json``: the scene) under a
traffic mix (``traffic/<traffic>.json``: frame, render policy, passes per
update), named ``<config>.<traffic>`` in ``BENCHMARK.json``. A run

1. sets up: builds the scene's arrays from the configuration, hands them to
   the port (``Scene.from_numpy``, the acceleration builds the
   configuration names, ``Renderer`` on the card) and warms up with one
   update of the cell's shapes;
2. measures: ``Renderer.accumulate(k)`` back to back, each call followed
   by ``torch.cuda.synchronize()`` (one update), for ``--seconds``, ending
   with the update in flight; where the traffic mix sets
   ``"resolve_every_s"``, the first update that ends that long after the
   last pull also pulls the image, as the viewer's page does; the window's
   first pass has the accumulation index ``--seed``, which keys the counter
   RNG;
3. with ``--trace 1``, traces 3 more updates with ``torch.profiler`` and
   counts the planner's work over one more;
4. reads the peak of device memory, frees the port's state, and checks the
   port's buckets and resolved image at pixels drawn from the seed against
   the plain reference that the configuration names (``reference/``,
   ``check.py``).

It prints the cell's end-to-end metrics (``--trace 0``) or per-layer
metrics (``--trace 1``) as the last line of standard output, one JSON
object, and the compared numbers beside their limits as the last lines of
standard error. It runs on the card only, and refuses to print a result
if JAX or the JAX package was loaded in this process.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import importlib
import json
import os
import subprocess
import sys
import time
from typing import Optional

from . import check, counters, manifest, scenes, trace, window

MASK = 0xFFFFFFFF
TRACED_UPDATES = 3
FORBIDDEN = ("jax", "jaxlib", "flax", "cpu_raytracing_experiments_tpu")
# a configuration's acceleration builds, by key, in the order they run
# (``scene/accel.py``): the BVH reorders the prims, and a cluster pack
# names the prim ids it is built on
BUILDS = {"bvh": "with_bvh", "grid": "with_grid",
          "clusters": "with_pallas_clusters",
          "morton_clusters": "with_clusters"}
# the build whose tables each backend walks
WALKS = {"bvh": "bvh", "grid": "grid", "pallas": "clusters",
         "clustered": "morton_clusters"}
# the keys of a configuration that this module reads; ``scenes.KEYS`` are
# the scene's, ``BUILDS`` the acceleration builds'
RUN_KEYS = {"name", "source", "about", "reduced", "assumed", "reference",
            "policy"}


def process_start() -> float:
    """The wall-clock time at which this process started (from /proc on
    Linux), else the time of the call."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        age = uptime - int(fields[19]) / os.sysconf("SC_CLK_TCK")
        return time.time() - age
    except (OSError, ValueError, IndexError):
        return time.time()


def forbidden_modules(modules) -> list:
    """Loaded modules whose whole top-level name is JAX's or the JAX
    package's."""
    return sorted({m.split(".", 1)[0] for m in modules} & set(FORBIDDEN))


@dataclasses.dataclass
class Context:
    """What the metric readers (``metrics/<name>.py``) read."""

    cell: str
    config: dict
    traffic: dict
    setup_s: float
    update_s: list  # each update of the window, seconds
    window_s: float
    samples: int  # pixel samples completed in the window
    peak_bytes: int
    spans: dict  # seconds of named set-up steps
    trace: Optional[trace.Trace] = None
    planner_calls: Optional[list] = None  # counters.PlannerCalls.calls
    planner_passes: int = 0  # passes the planner calls were counted over
    csrc_kernels: frozenset = frozenset()
    power_limit_w: Optional[float] = None


@dataclasses.dataclass
class Outcome:
    """One run: its result line, the compared numbers and their limits,
    and what standard error reports beside them (each update's seconds,
    the set-up's steps)."""

    result: dict
    numbers: dict
    limits: dict
    update_s: list
    spans: dict


def port_policy(config: dict, traffic: dict):
    from cpu_raytracing_experiments_tpu_torch.utils.config import (
        RendererPolicy)

    return RendererPolicy(**traffic["policy"], **config["policy"])


def reference(config: Optional[dict] = None):
    """The reference module that `config` names (``"reference"``;
    ``pathtrace`` where it names none): ``reference/<name>.py``."""
    name = (config or {}).get("reference", "pathtrace")
    if not name.isidentifier():
        raise ValueError(f"no reference module {name!r}")
    return importlib.import_module(f"{__package__}.reference.{name}")


def reference_policy(policy, config: Optional[dict] = None):
    """The policy of the reference that `config` names for the port's
    `policy`; it refuses the knobs that the reference does not render."""
    return reference(config).policy(policy)


def accel_builds(config: dict, policy) -> list:
    """The acceleration builds of `config`, (function name in
    ``scene/accel.py``, its arguments), in the order they run. Refuses a
    key that the configuration format does not have, and a policy whose
    backend (``effective_accel``, ``primary_accel``) walks tables that no
    build of the configuration makes: the port would render such a scene
    with the dense batteries. Refuses two builds that fill the same
    tables."""
    unknown = sorted(set(config) - RUN_KEYS - scenes.KEYS - set(BUILDS))
    if unknown:
        raise ValueError(f"configuration {config.get('name')!r}: unknown "
                         f"keys {unknown}; the acceleration builds are "
                         f"{sorted(BUILDS)}")
    if {"clusters", "morton_clusters"} <= set(config):
        raise ValueError(f"configuration {config.get('name')!r} names both "
                         f"'clusters' and 'morton_clusters', which fill the "
                         f"scene's cluster packs; name one")
    for backend in {policy.effective_accel, policy.primary_accel}:
        if backend in (None, "brute"):
            continue
        if backend not in WALKS:
            raise ValueError(f"accel {backend!r} walks tables that no "
                             f"build makes; the builds are {sorted(BUILDS)}")
        if WALKS[backend] not in config:
            raise ValueError(
                f"accel {backend!r} walks the tables of the "
                f"{WALKS[backend]!r} build, which configuration "
                f"{config.get('name')!r} lacks")
    return [(fn, config[key]) for key, fn in BUILDS.items() if key in config]


def port_scene(inputs: dict, builds: list):
    """The port's scene from the scene inputs, on the host, with the
    acceleration builds (``accel_builds``) made."""
    from cpu_raytracing_experiments_tpu_torch.scene import accel
    from cpu_raytracing_experiments_tpu_torch.scene.scene import Scene

    scene = Scene.from_numpy(scenes.port_arrays(inputs))
    for fn, args in builds:
        scene = getattr(accel, fn)(scene, **args)
    return scene


def power_limit_w() -> Optional[float]:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=20).stdout
        return float(out.split()[0])
    except (OSError, ValueError, IndexError, subprocess.TimeoutExpired):
        return None


def run_cell(cell: str, seed: int, seconds: float, traced: bool,
             device: str = "cuda", t_start: Optional[float] = None,
             frame: Optional[tuple] = None,
             max_updates: Optional[int] = None,
             mf: Optional[manifest.Manifest] = None) -> Outcome:
    """One run of `cell`. `frame` (width, height) and `max_updates` shrink
    a run for a test on the CPU."""
    import torch

    import cpu_raytracing_experiments_tpu_torch as port
    from cpu_raytracing_experiments_tpu_torch.render import estimator
    from cpu_raytracing_experiments_tpu_torch.render.api import Renderer

    t_start = time.time() if t_start is None else t_start
    mf = mf or manifest.Manifest()
    wl = mf.workload(cell)
    config, traffic = mf.config(wl["config"]), mf.traffic(wl["traffic"])
    chk = mf.check(cell)
    width, height = frame or (traffic["width"], traffic["height"])
    k = int(traffic["passes_per_update"])
    policy = port_policy(config, traffic)
    ref = reference(config)
    ref_policy = ref.policy(policy)
    builds = accel_builds(config, policy)
    # the viewer's page pulls the image every second (viewer.py's
    # ``setInterval(tick, 1000)``) while its render thread accumulates
    pull_every_s = traffic.get("resolve_every_s")
    dev = torch.device(device)
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    if cuda:
        torch.cuda.init()
        torch.cuda.reset_peak_memory_stats(dev)

    # ---- set-up ----
    spans = {"imports_s": time.time() - t_start}
    t0 = time.perf_counter()
    inputs = scenes.build(config, width, height)
    spans["scene_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    scene = port_scene(inputs, builds)
    r = Renderer(scene, policy, width, height, device=dev)
    sync()
    # with a build, this step is the scene's acceleration build
    spans["accel_build_s" if builds else "renderer_s"] = (
        time.perf_counter() - t0)
    del scene

    last_pull = [-float("inf")]

    def update():
        r.accumulate(k)
        sync()
        if (pull_every_s is not None
                and time.perf_counter() - last_pull[0] >= pull_every_s):
            # the image as the viewer's /delta serves it: the resolve, the
            # tonemap and the copy to the host
            r.render(tonemap=True)
            last_pull[0] = time.perf_counter()

    t0 = time.perf_counter()
    update()  # warm-up: every shape of the window, and a pull
    spans["warmup_s"] = time.perf_counter() - t0
    r.reset_accumulator()
    first = seed & MASK
    r.state = dataclasses.replace(r.state, accumulations=(first - 1) & MASK)
    setup_s = time.time() - t_start
    last_pull[0] = time.perf_counter()

    # ---- the window ----
    update_s, window_s = window.run(update, seconds, max_updates)
    passes = len(update_s) * k
    samples = passes * width * height * policy.samples_per_pixel

    tr, planner = None, None
    if traced:
        tr = trace.profile(update, TRACED_UPDATES, TRACED_UPDATES * k, cuda)
        with counters.PlannerCalls() as planner:
            update()
        passes += (TRACED_UPDATES + 1) * k
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0

    # ---- the program's outputs at pixels drawn from the seed ----
    pixels = torch.from_numpy(check.sample_pixels(
        seed, width * height, int(chk["pixels"]))).to(dev)
    port_buckets = r.state.buckets[:, :, pixels].cpu()
    # the state's counter holds the last pass's index, which starts from the
    # seed; the resolve divides by the passes the buckets hold
    image = estimator.resolve(
        dataclasses.replace(r.state, accumulations=passes), policy,
        r.scene.camera.exposure, width, height)
    port_image = image.reshape(-1, 3)[pixels].cpu()
    exposure = float(r.scene.camera.exposure)
    del r, image
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    # ---- the reference ----
    rsc = ref.make_scene(inputs, dev)
    ref_buckets = ref.buckets(rsc, ref_policy, pixels, first, passes, width)
    ref_image = ref.resolve(ref_buckets, passes, ref_policy.spp, exposure)
    numbers = check.compare(port_buckets, ref_buckets, port_image, ref_image)
    limits = chk["limits"]
    correct = check.judge(numbers, limits)
    del rsc, ref_buckets
    if cuda:
        torch.cuda.empty_cache()

    # ---- metrics ----
    ctx = Context(cell=cell, config=config, traffic=traffic, setup_s=setup_s,
                  update_s=update_s, window_s=window_s, samples=samples,
                  peak_bytes=int(peak), spans=spans, trace=tr,
                  planner_calls=planner.calls if planner else None,
                  planner_passes=k if planner else 0,
                  csrc_kernels=frozenset(trace.csrc_kernels(
                      os.path.join(os.path.dirname(port.__file__), "csrc"))),
                  power_limit_w=power_limit_w() if cuda else None)
    metrics = {}
    for m in mf.metrics(cell, traced):
        value = manifest.reader(m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev_info = {"platform": "gpu" if cuda else dev.type,
                "kind": (torch.cuda.get_device_name(dev) if cuda
                         else "cpu"),
                "count": 1, "memory_peak_bytes": int(peak)}
    if ctx.power_limit_w is not None:
        dev_info["power_limit_w"] = ctx.power_limit_w
    result = {"correct": bool(correct), "attempted": len(update_s),
              "failed": 0, "metrics": metrics, "device": dev_info}
    if tr is not None:
        dev_info["busy_s"] = trace.busy_s(tr)
        dev_info["window_s"] = tr.window_s
        result["breakdown"] = trace.breakdown(tr)
    result["checked"] = {name: {"value": numbers[name], "limit": limits[name]}
                         for name in check.NAMES}
    return Outcome(result, numbers, limits, update_s, spans)


def main(argv=None) -> int:
    t_start = process_start()
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    mf = manifest.Manifest()
    chips = mf.workload(args.workload)["chips"]

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} CUDA card(s); "
              f"{torch.cuda.device_count()} available", file=sys.stderr)
        return 2
    out = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                   t_start=t_start, mf=mf)
    found = forbidden_modules(sys.modules)
    if found:
        print(f"portbench: loaded in this process: {', '.join(found)}",
              file=sys.stderr)
        return 3
    print(f"updates in the window: {out.result['attempted']}; pixels "
          f"compared: {mf.check(args.workload)['pixels']}", file=sys.stderr)
    print("set-up s: " + ", ".join(f"{k} {v:.3f}"
                                   for k, v in out.spans.items()),
          file=sys.stderr)
    if "power_limit_w" in out.result["device"]:
        print(f"card: {out.result['device']['kind']}, power limit "
              f"{out.result['device']['power_limit_w']} W", file=sys.stderr)
    ms = [round(t * 1e3, 3) for t in out.update_s]
    print(f"update ms: first {ms[:3]}, median "
          f"{window.quantile(ms, 0.5)}, max {max(ms)}", file=sys.stderr)
    print(json.dumps(out.result))
    sys.stdout.flush()
    for name in check.NAMES:
        print(f"{name} {out.numbers[name]!r} limit {out.limits[name]!r}",
              file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
