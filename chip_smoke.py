#!/usr/bin/env python3
"""Drive the PyTorch port (cpu_raytracing_experiments_tpu_torch) on one
NVIDIA GPU and check it end to end.

    python3 chip_smoke.py    # every phase, always; needs one CUDA card

Phases:
  1. device info and the kernels' nvcc build (sm_90a);
  2. each sphere-battery kernel against its plain PyTorch version, bit for
     bit, on seeded batches with tangent/grazing rays, duplicate spheres on
     both sides of a staging-chunk boundary and shadow lanes with tfar <= 0;
     their CUDA-event times beside the bound and the plain version's time;
  3. white furnace, 256x256, 25 spp: every pixel of the linear resolve is 1;
  4. hero scene, 64x64, 10 spp, against tests/goldens/hero_64x64_10spp.npy
     at the bar of tests/test_goldens.py::_check;
  5. the main path: the hero scene at 1920x1088, 8 bounces, 2^19 rays per
     chunk, through Renderer.accumulate, with the kernels' launch counts;
  6. the 1000-sphere random_spheres_scene at 512x512, 8 bounces.

Any failure raises and exits non-zero. On success the last lines are the
card's name and power limit, one JSON object with the kernels' numbers, and
{"ok": true, "device": {...}}. Without a CUDA device it exits 2 and prints
no result.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
DEVICE = "cuda"
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
FP32_OPS_PER_S = 67e12  # H100 SXM FP32 outside the tensor cores
CLOSEST_OPS_PER_PAIR = 20  # 19 FLOP + 1 sqrt (csrc/sphere_battery.cu)
OCCLUDED_OPS_PER_PAIR = 19
PASSES = 5  # accumulation passes per timed window of phases 5 and 6
WINDOWS = 3  # timed windows, for the spread of ms/pass within one call
KERNEL_SOURCE = "cpu_raytracing_experiments_tpu_torch/csrc/sphere_battery.cu"
REPLACES = {
    "sphere_closest":
        "cpu_raytracing_experiments_tpu/ops/pallas/sphere_kernel.py:72",
    "sphere_occluded":
        "cpu_raytracing_experiments_tpu/ops/pallas/sphere_kernel.py:97",
}


def log(*args):
    print(*args, flush=True)


def gpu_name_power() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()


class Timer:
    """CUDA-event timing of one callable, with the L2 cache flushed before
    every launch (the main path meets the battery's inputs cold enough that
    a warm-L2 time would undercut the HBM bound)."""

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(64 << 20, dtype=torch.uint8, device=DEVICE)

    def __call__(self, fn, iters: int, warmup: int = 2) -> float:
        torch = self.torch
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        total = 0.0
        for _ in range(iters):
            self.flush.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            total += start.elapsed_time(end)
        return total / iters


def ray_batch(torch, np, center, radius_sq, n, seed):
    """Seeded rays in and around the sphere table's bounds, a quarter of
    them tangent to a sphere (the ill-conditioned disc ~ 0 case), and shadow
    distances mixing hit distances, +inf, 0 and negative values."""
    from cpu_raytracing_experiments_tpu_torch.core.vec import Vec3

    g = np.random.default_rng(seed)
    c = np.stack([t.cpu().numpy() for t in center], 1).astype(np.float64)
    r = np.sqrt(radius_sq.cpu().numpy().astype(np.float64))
    lo, hi = c.min(0) - r.max(), c.max(0) + r.max()
    o = g.uniform(lo, hi, (n, 3))
    d = g.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    # tangent lanes: touch sphere k at c_k + r_k * u, along t orthogonal to u
    m = n // 4
    k = g.integers(0, len(r), m)
    u = g.normal(size=(m, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    t = np.cross(u, g.normal(size=(m, 3)))
    t /= np.linalg.norm(t, axis=1, keepdims=True)
    touch = c[k] + r[k, None] * u
    o[:m] = touch - t * g.uniform(0.5, 3.0, (m, 1)) * r[k, None]
    d[:m] = t
    tf = g.uniform(0.0, 2.0 * np.abs(hi - lo).max(), n)
    tf[g.random(n) < 0.1] = np.inf
    tf[g.random(n) < 0.1] = 0.0
    tf[g.random(n) < 0.1] = -1.0
    as_t = lambda a: torch.tensor(np.ascontiguousarray(a), dtype=torch.float32,
                                  device=DEVICE)
    return (Vec3(*(as_t(o[:, j]) for j in range(3))),
            Vec3(*(as_t(d[:, j]) for j in range(3))), as_t(tf))


def check_kernels(torch, np, timer, center, radius_sq, n_rays, seed, label):
    """Kernels against plain versions, bit for bit; returns their numbers."""
    from cpu_raytracing_experiments_tpu_torch.ops.kernels import \
        sphere_battery as sb

    p, d, tf = ray_batch(torch, np, center, radius_sq, n_rays, seed)
    n_prims = radius_sq.shape[0]
    kt, kid = sb.closest_hit(p, d, center, radius_sq)
    pt, pid = sb.intersect_spheres(p, d, center, radius_sq)
    # shadow lanes also test the hit distances the closest battery returns
    tf = torch.where(torch.arange(n_rays, device=DEVICE) % 2 == 0, tf,
                     torch.where(kid >= 0, kt * 0.999, tf))
    ko = sb.any_hit(p, d, tf, center, radius_sq)
    po = sb.occluded_spheres(p, d, tf, center, radius_sq)
    torch.cuda.synchronize()
    same_t = torch.equal(kt.view(torch.int32), pt.view(torch.int32))
    same_id = torch.equal(kid, pid)
    same_occ = torch.equal(ko, po)
    hit = pid >= 0
    err = float((kt[hit] - pt[hit]).abs().max()) if bool(hit.any()) else 0.0
    log(f"[{label}] R={n_rays} P={n_prims}: hits {int(hit.sum())}, occluded "
        f"{int(po.sum())}; tfar bits equal {same_t}, ids equal {same_id}, "
        f"occ equal {same_occ}, max |dt| {err}")
    if not (same_t and same_id and same_occ):
        bad = (kid != pid) | (kt.view(torch.int32) != pt.view(torch.int32))
        idx = torch.nonzero(bad | (ko != po))[:5, 0].tolist()
        for i in idx:
            log(f"  lane {i}: kernel ({float(kt[i])!r}, {int(kid[i])}, "
                f"{bool(ko[i])}) plain ({float(pt[i])!r}, {int(pid[i])}, "
                f"{bool(po[i])})")
        raise AssertionError(f"[{label}] kernel disagrees with plain version")
    if bool((tf <= 0).any()) and bool(po[tf <= 0].any()):
        raise AssertionError("plain any-hit occludes a lane with tfar <= 0")

    # pairs the any-hit run needs: up to the first occluder, none at tfar<=0
    first = torch.full((n_rays,), n_prims, dtype=torch.int64, device=DEVICE)
    for start in range(0, n_prims, 256):
        end = min(start + 256, n_prims)
        pairs = sb._sphere_occluded_pairs(
            p, d, tf, center.x[start:end], center.y[start:end],
            center.z[start:end], radius_sq[start:end])
        idx = torch.where(pairs.any(1), pairs.int().argmax(1) + start,
                          n_prims)
        first = torch.minimum(first, idx)
    occ_pairs = int(torch.where(tf > 0, torch.clamp_max(first + 1, n_prims),
                                0).sum())

    iters = 20
    out = {}
    for name, kern, plain, nbytes, ops in (
        ("sphere_closest",
         lambda: sb.closest_hit(p, d, center, radius_sq),
         lambda: sb.intersect_spheres(p, d, center, radius_sq),
         n_rays * (24 + 8) + n_prims * 16,
         n_rays * n_prims * CLOSEST_OPS_PER_PAIR),
        ("sphere_occluded",
         lambda: sb.any_hit(p, d, tf, center, radius_sq),
         lambda: sb.occluded_spheres(p, d, tf, center, radius_sq),
         n_rays * (28 + 1) + n_prims * 16,
         occ_pairs * OCCLUDED_OPS_PER_PAIR),
    ):
        ms = timer(kern, iters)
        plain_ms = timer(plain, 5, warmup=1)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / FP32_OPS_PER_S * 1e3
        out[name] = {
            "name": name, "route": "cuda", "source": KERNEL_SOURCE,
            "replaces": REPLACES[name], "launches": None,
            "max_abs_err": err if name == "sphere_closest" else 0.0,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None, "shape": f"R={n_rays} P={n_prims}",
        }
        log(f"[{label}] {name}: {ms:.4f} ms (bound {max(t_bytes, t_ops):.4f} "
            f"ms by {out[name]['bound_by']}; plain {plain_ms:.4f} ms)")
    return out


def render(torch, crt, scene, policy, width, height, passes, label):
    """Run WINDOWS timed windows of `passes` accumulation passes each
    through Renderer.accumulate, with the launch counts set to 0 just
    before the first and read just after the last; returns (image,
    numbers). ms/pass is the median window's; rays per pass are the port's
    ray_count summed over all timed passes."""
    import numpy as np

    from cpu_raytracing_experiments_tpu_torch.ops.kernels import \
        sphere_battery as sb

    r = crt.Renderer(scene, policy, width, height)
    r.accumulate(1)  # warm-up pass
    r.reset_accumulator()
    torch.cuda.synchronize()
    sb.reset_counts()
    window_ms = []
    for _ in range(WINDOWS):
        t0 = time.perf_counter()
        r.accumulate(passes)
        torch.cuda.synchronize()
        window_ms.append((time.perf_counter() - t0) * 1e3 / passes)
    launches = {c.name: c.launches for c in (sb.CLOSEST, sb.OCCLUDED)}
    ms = sorted(window_ms)[WINDOWS // 2]
    rays = int(r.state.rays_traced) / (passes * WINDOWS)
    img = r.render(tonemap=False)
    if img.shape != (height, width, 3) or not np.isfinite(img).all():
        raise AssertionError(f"[{label}] bad image {img.shape}")
    log(f"[{label}] {width}x{height}: {ms:.2f} ms/pass (median of windows "
        f"{[round(m, 2) for m in window_ms]}), {rays} rays/pass (port "
        f"ray_count), {rays / ms / 1e3:.2f} Mrays/s; launches in "
        f"{passes * WINDOWS} passes {launches}; image mean "
        f"{float(img.mean()):.5f}")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"[{label}] {name} was never launched")
    profile_pass(torch, r, label)
    return img, {"ms_per_pass": ms, "rays_per_pass": rays,
                 "launches": launches}


def profile_pass(torch, r, label):
    """One more pass under torch.profiler: device busy time against the
    pass's wall time, and the kernels that take the most device time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        r.accumulate(1)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device-side events only: a CPU op's row repeats its kernels' time
    rows = [(ev.self_device_time_total, ev.count, ev.key)
            for ev in prof.key_averages()
            if ev.device_type == torch.autograd.DeviceType.CUDA
            and ev.self_device_time_total > 0]
    if not rows:
        log(f"[{label}] profiler: no device time recorded (not measured)")
        return
    busy_ms = sum(us for us, _, _ in rows) / 1e3
    log(f"[{label}] profiled pass: wall {wall_ms:.2f} ms, device busy "
        f"{busy_ms:.2f} ms ({100 * busy_ms / wall_ms:.1f}%), "
        f"{sum(c for _, c, _ in rows)} kernel launches")
    for us, count, key in sorted(rows, reverse=True)[:8]:
        log(f"    {us / 1e3:8.3f} ms  x{count:<5d} {key[:90]}")


def golden_check(np, img, name):
    """tests/test_goldens.py::_check: > 99.5% of values within rtol 1e-3 /
    atol 1e-4 of the golden, and the mean within rtol 1e-3."""
    want = np.load(ROOT / "tests" / "goldens" / f"{name}_64x64_10spp.npy")
    close = np.isclose(img, want, rtol=1e-3, atol=1e-4).mean()
    mean_ok = abs(img.mean() - want.mean()) <= 1e-3 * abs(want.mean())
    log(f"[golden {name}] close {close:.5f} (need > 0.995), mean "
        f"{img.mean():.6f} vs {want.mean():.6f}")
    if not (close > 0.995 and mean_ok):
        raise AssertionError(f"{name} misses the golden bar")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing run", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import numpy as np

    import cpu_raytracing_experiments_tpu_torch as crt
    from cpu_raytracing_experiments_tpu_torch.ops.kernels import \
        sphere_battery as sb

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = gpu_name_power()
    log(f"[1] {card}; torch {torch.__version__} cuda {torch.version.cuda}; "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    t0 = time.perf_counter()
    sb.load_library()
    log(f"[1] kernels built and loaded in {time.perf_counter() - t0:.1f} s "
        f"({sb.SOURCE.name})")
    for line in sb.BUILD_LOG.strip().splitlines():
        log("    nvcc:", line)

    timer = Timer(torch)
    hero = crt.builders.default_scene(1920, 1088).to(DEVICE)
    field = crt.builders.random_spheres_scene(512, 512).to(DEVICE)
    hero_rows = check_kernels(
        torch, np, timer, hero.spheres.center, hero.spheres.radius_sq,
        1 << 19, 1, "2 hero table")
    field_rows = check_kernels(
        torch, np, timer, field.spheres.center, field.spheres.radius_sq,
        262144, 2, "2 1k table")
    # duplicates across the 1024-sphere staging chunk (spheres j and
    # j + 1000): the first occurrence must win every tie
    from cpu_raytracing_experiments_tpu_torch.core.vec import Vec3
    dup = Vec3(*(torch.cat([c, c]) for c in field.spheres.center))
    check_kernels(torch, np, timer, dup,
                  torch.cat([field.spheres.radius_sq] * 2), 65536, 3,
                  "2 duplicated 2k table")

    pol = crt.RendererPolicy
    img = crt.render_image(crt.builders.white_furnace_scene(256, 256),
                           256, 256, 25, pol(max_bounces=8), tonemap=False)
    err = float(np.abs(img - 1.0).max())
    log(f"[3] white furnace 256x256 25 spp: max |img - 1| = {err}")
    if not err <= 2e-3:
        raise AssertionError("white furnace is not 1 within 2e-3")
    r = crt.Renderer(crt.builders.default_scene(64, 64),
                     pol(max_bounces=6, rays_per_chunk=4096), 64, 64)
    r.accumulate(10)
    golden_check(np, r.render(tonemap=False), "hero")
    _, main_path = render(torch, crt, hero,
                          pol(max_bounces=8, rays_per_chunk=1 << 19),
                          1920, 1088, PASSES, "5 hero")
    _, field_path = render(torch, crt, field,
                           pol(max_bounces=8, narrow_wavefront=False),
                           512, 512, PASSES, "6 random_spheres 1k")

    for rows, path in ((hero_rows, main_path), (field_rows, field_path)):
        for name, row in rows.items():
            row["launches"] = path["launches"][name]
    log(card)
    log(json.dumps({"kernels_at_1k_spheres": list(field_rows.values())}))
    log(json.dumps({"kernels": list(hero_rows.values())}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
