#!/usr/bin/env python3
"""Drive the PyTorch port (cpu_raytracing_experiments_tpu_torch) on one
NVIDIA GPU and check it end to end.

    python3 chip_smoke.py    # every phase, always; needs one CUDA card

Phases:
  1. device info and the build of csrc/ (both CUDA sources with nvcc for
     sm_90a and the host tree builder with g++);
  2. each sphere-battery kernel against its plain PyTorch version, bit for
     bit, on seeded batches with tangent/grazing rays, duplicate spheres on
     both sides of a staging-chunk boundary and shadow lanes with tfar <= 0;
     their CUDA-event times beside the bound and the plain version's time;
  3. white furnace, 256x256, 25 spp: every pixel of the linear resolve is 1;
  4. hero scene, 64x64, 10 spp, against tests/goldens/hero_64x64_10spp.npy
     at the bar of tests/test_goldens.py::_check;
  5. the hero path: the hero scene at 1920x1088, 8 bounces, 2^19 rays per
     chunk, through Renderer.accumulate, with the kernels' launch counts;
  6. the 1000-sphere random_spheres_scene at 512x512, 8 bounces, brute;
  7. the three cluster kernels (planner, closest walk, any-hit walk)
     against their plain versions, bit for bit, with their times: tables of
     1000 spheres (K = 64), 100,000 spheres (K = 128) and 20,000 random
     triangles, in tiles of 128 at the widths the full-width render
     launches them with: the 2^19 camera rays of the frame's first chunk,
     2^19 diffuse-like rays with a tfar0 seed and half the lanes dead, and
     the 131,072-lane wavefront the bounce loop narrows that chunk to, with
     its alive mask;
  8. the clustered closest walk against the brute sphere_closest kernel on
     the same rays: equal tfar, equal ids except at exact ties;
  9. the large-scene path at full width: random_spheres_scene(1920, 1088)
     with 1000 and with 100,000 spheres through Renderer with
     accel='pallas', default knobs, narrowing 'auto', 8 bounces;
 10. the 1000-sphere scene at 256x256 with accel='pallas' and with
     accel='brute': bit-identical buckets.

Any failure raises and exits non-zero. On success the last lines are the
card's name and power limit, JSON objects with the kernels' numbers (the one
keyed "kernels" lists all five), and {"ok": true, "device": {...}}. Without
a CUDA device it exits 2 and prints no result.
"""
from __future__ import annotations

import json
import math
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
PASSES = 3  # accumulation passes per timed window of the render phases
WINDOWS = 3  # timed windows, for the spread of ms/pass within one call
KERNEL_SOURCE = "cpu_raytracing_experiments_tpu_torch/csrc/sphere_battery.cu"
CLUSTER_SOURCE = \
    "cpu_raytracing_experiments_tpu_torch/csrc/cluster_traverse.cu"
_TK = "cpu_raytracing_experiments_tpu/ops/pallas/traverse_kernel.py"
REPLACES = {
    "sphere_closest":
        "cpu_raytracing_experiments_tpu/ops/pallas/sphere_kernel.py:72",
    "sphere_occluded":
        "cpu_raytracing_experiments_tpu/ops/pallas/sphere_kernel.py:97",
    "cluster_plan": _TK + ":420",
    "cluster_closest": _TK + ":732",
    "cluster_occluded": _TK + ":981",
}
# operations per test, counted from csrc/cluster_traverse.cu: a slab test is
# 6 sub, 6 mul, 11 min/max, 2 compares and the running min; the triangle
# battery 15 mul-adds counted as 2, a division and 7 compares and adds
SLAB_OPS = 26
TRI_CLOSEST_OPS = 38
TRI_OCCLUDED_OPS = 39
FRAME = (1920, 1088)  # the full-width renders' frame
CLUSTER_RAYS = 1 << 19  # lanes of one chunk of that frame (rays_per_chunk)
CLUSTER_TILE = 128  # tile_r='auto' below 2048 clusters


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
        out[name] = kernel_row(
            name, KERNEL_SOURCE, f"R={n_rays} P={n_prims}", None,
            err if name == "sphere_closest" else 0.0, ms, plain_ms, nbytes,
            ops)
        log(f"[{label}] {name}: {ms:.4f} ms (bound "
            f"{out[name]['bound_ms']:.4f} ms by {out[name]['bound_by']}; "
            f"plain {plain_ms:.4f} ms)")
    return out


def kernel_row(name, source, shape, launches, err, ms, plain_ms, nbytes,
               ops):
    """One entry of the kernels line; the bound is the larger of bytes over
    the card's memory rate and operations over its FP32 rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return {
        "name": name, "route": "cuda", "source": source,
        "replaces": REPLACES[name], "launches": launches,
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": None, "shape": shape,
    }


def triangle_clusters(np, n, seed):
    """A cluster table of n random triangles in the sphere field's bounds,
    made with numpy from a seed (the port renders no triangle scenes yet;
    the walks' triangle battery is held to its plain version here)."""
    from cpu_raytracing_experiments_tpu_torch.bvh import builder
    from cpu_raytracing_experiments_tpu_torch.ops import clustered

    g = np.random.default_rng(seed)
    v0 = g.uniform((-100, 0, -100), (100, 60, 100), (n, 3)).astype(np.float32)
    e1 = g.normal(0, 2.0, (n, 3)).astype(np.float32)
    e2 = g.normal(0, 2.0, (n, 3)).astype(np.float32)
    mins, maxs = builder.triangle_bounds(v0, v0 + e1, v0 + e2)
    return clustered.build_clusters_sah(
        mins, maxs, np.concatenate([v0, e1, e2], axis=1), cluster_size=64,
        kind="triangle").to(DEVICE)


def cluster_rays(torch, np, crt, scene, cp, seed, narrowed):
    """Ray batches for a cluster table, at the widths the full-width render
    launches the kernels with. 'camera' (CLUSTER_RAYS lanes): the primary
    rays of the first chunk of the 1920x1088 frame in screen-tile order,
    every lane valid, tfar0 = FLT_MAX. 'diffuse' (CLUSTER_RAYS lanes): from
    where those rays hit (or a random point in the bounds) in a uniformly
    random direction, half the lanes dead, and every other lane seeded with
    a finite tfar0. 'narrowed', for a scene's own table: that chunk's
    wavefront as the renderer's bounce loop leaves it when the live lanes
    first fit a quarter of the width, compacted as trace_rays compacts it,
    with its alive mask (CLUSTER_RAYS / 4 lanes)."""
    from cpu_raytracing_experiments_tpu_torch.core.vec import Vec3
    from cpu_raytracing_experiments_tpu_torch.ops.kernels import \
        cluster_traverse as ct
    from cpu_raytracing_experiments_tpu_torch.render import renderer

    width, height = FRAME
    n = CLUSTER_RAYS
    pol = crt.RendererPolicy(max_bounces=8, accel="pallas")
    pixel = renderer._tile_pixel_order(width, width * height, 16,
                                       torch.device(DEVICE))[0][:n]
    seeds = renderer.pixel_seeds_from_index(pixel, width, pol)
    p, d = renderer.generate_camera_rays(
        scene.camera.resized(width, height), pixel % width, pixel // width,
        1, seeds, False, pol)
    far = torch.full((n,), ct.FLT_MAX, dtype=torch.float32, device=DEVICE)
    everyone = torch.ones(n, dtype=torch.bool, device=DEVICE)
    t, prim = ct.intersect_clustered_pallas(cp, p, d, tile_r=CLUSTER_TILE)
    g = np.random.default_rng(seed)
    as_t = lambda a, dt=torch.float32: torch.tensor(
        np.ascontiguousarray(a), dtype=dt, device=DEVICE)
    hit = prim >= 0
    lo, hi = cp.root[0:3].cpu().numpy(), cp.root[3:6].cpu().numpy()
    rand_o = g.uniform(lo, hi, (n, 3))
    dirs = g.normal(size=(n, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    o = Vec3(*(torch.where(hit, pc + t * dc, as_t(rand_o[:, j])).contiguous()
               for j, (pc, dc) in enumerate(zip(p, d))))
    dd = Vec3(*(as_t(dirs[:, j]) for j in range(3)))
    alive = as_t(g.random(n) < 0.5, torch.bool)
    seed_t = torch.where(as_t(g.random(n) < 0.5, torch.bool),
                         as_t(g.uniform(1.0, 120.0, n)), far)
    out = {"camera": (p, d, far, everyone), "diffuse": (o, dd, seed_t, alive)}
    if narrowed:
        cap = renderer._narrow_caps(pol, scene, n)[0]
        state = renderer.initial_state(p, d)
        while int(state.alive.sum()) > cap:
            state = renderer.bounce_step(scene, pol, 1, seeds, state)
        state, _, _ = renderer.narrow_state(state, cap)
        log(f"    narrowed wavefront: {cap} lanes after bounce "
            f"{state.bounce}, {int(state.alive.sum())} alive")
        out["narrowed"] = (Vec3(*(c.contiguous() for c in state.p)),
                           Vec3(*(c.contiguous() for c in state.d)),
                           far[:cap].clone(), state.alive.contiguous())
    return out


def check_cluster_kernels(torch, np, timer, cp, rays, label):
    """The three cluster kernels against their plain versions on one table
    and one ray batch, bit for bit, and their numbers. The any-hit walk
    takes tfar0 as its shadow distance (dead lanes get 0: they are invalid
    there)."""
    from cpu_raytracing_experiments_tpu_torch.ops.kernels import \
        cluster_traverse as ct

    p, d, tf0, alive = rays
    n, c, k = tf0.shape[0], cp.num_clusters, cp.cluster_size
    tile = CLUSTER_TILE
    tiles = -(-n // tile)
    tri = cp.kind == "triangle"
    plan_tf = torch.where(alive, tf0, 0.0)
    kv, ke, kn = ct._plan_visits(cp, p, d, plan_tf, alive, tile)
    pv, pe, pn = ct.plan_visits_plain(cp, p, d, plan_tf, alive, tile)
    below = torch.arange(c, device=DEVICE)[None, :] < pn[:, None]
    ok_plan = (torch.equal(kn, pn) and torch.equal(kv[below], pv[below])
               and torch.equal(ke[below], pe[below]))
    kt, kid = ct.walk_closest(cp, pv, pe, pn, p, d, tf0, alive, tile)
    closest_stats, occ_stats = {}, {}
    pt, pid = ct.walk_closest_plain(cp, pv, pe, pn, p, d, tf0, alive, tile,
                                    stats=closest_stats)
    ok_closest = (torch.equal(kid, pid)
                  and torch.equal(kt.view(torch.int32), pt.view(torch.int32)))
    # shadow rays: to just behind the closest hit on even lanes (occluded),
    # to just before it on odd lanes, tfar0 where nothing was hit
    scale = torch.where(torch.arange(n, device=DEVICE) % 2 == 0, 1.001, 0.999)
    shadow_tf = torch.where(alive, torch.where(pid >= 0, pt * scale, tf0), 0.0)
    sv, se, sn = ct._plan_visits(cp, p, d, shadow_tf, shadow_tf > 0, tile)
    ko = ct.walk_occluded(cp, sv, se, sn, p, d, shadow_tf, tile)
    po = ct.walk_occluded_plain(cp, sv, se, sn, p, d, shadow_tf, tile,
                                stats=occ_stats)
    torch.cuda.synchronize()
    ok_occ = torch.equal(ko, po) and not bool(po[shadow_tf <= 0].any())
    hit = pid >= 0
    err = float((kt[hit] - pt[hit]).abs().max()) if bool(hit.any()) else 0.0
    listed, listed_s = int(pn.sum()), int(sn.sum())
    log(f"[{label}] R={n} C={c} K={k}: planned {listed / tiles:.1f} of {c} "
        f"clusters a tile, walked {closest_stats.get('visits', 0) / tiles:.1f}"
        f" (closest) and {occ_stats.get('visits', 0) / tiles:.1f} of "
        f"{listed_s / tiles:.1f} (any-hit); hits {int(hit.sum())}, occluded "
        f"{int(po.sum())}; plan equal {ok_plan}, closest equal {ok_closest}, "
        f"any-hit equal {ok_occ}")
    if not (ok_plan and ok_closest and ok_occ):
        raise AssertionError(f"[{label}] a cluster kernel disagrees with its "
                             "plain version")

    shape = f"R={n} tile_r={tile} C={c} K={k} {cp.kind}s"
    row_bytes = 48 if tri else 16
    ray_bytes = n * (7 * 4 + 1)
    out = {}
    for name, kern, plain, nbytes, ops in (
        ("cluster_plan",
         lambda: ct._plan_visits(cp, p, d, plan_tf, alive, tile),
         lambda: ct.plan_visits_plain(cp, p, d, plan_tf, alive, tile),
         ray_bytes + c * 24 + tiles * (c * 8 + 4),
         n * c * SLAB_OPS),
        ("cluster_closest",
         lambda: ct.walk_closest(cp, pv, pe, pn, p, d, tf0, alive, tile),
         lambda: ct.walk_closest_plain(cp, pv, pe, pn, p, d, tf0, alive, tile),
         ray_bytes + n * 8 + c * k * row_bytes + listed * 8 + tiles * 4,
         closest_stats.get("pairs", 0)
         * (TRI_CLOSEST_OPS if tri else CLOSEST_OPS_PER_PAIR)),
        ("cluster_occluded",
         lambda: ct.walk_occluded(cp, sv, se, sn, p, d, shadow_tf, tile),
         lambda: ct.walk_occluded_plain(cp, sv, se, sn, p, d, shadow_tf, tile),
         n * (7 * 4 + 1) + c * k * row_bytes + listed_s * 8 + tiles * 4,
         occ_stats.get("pairs", 0)
         * (TRI_OCCLUDED_OPS if tri else OCCLUDED_OPS_PER_PAIR)),
    ):
        ms = timer(kern, 5, warmup=1)
        plain_ms = timer(plain, 1, warmup=0)
        out[name] = kernel_row(name, CLUSTER_SOURCE, f"{shape}, {label}",
                               None, err if name == "cluster_closest" else 0.0,
                               ms, plain_ms, nbytes, ops)
        log(f"[{label}] {name}: {ms:.4f} ms (bound "
            f"{out[name]['bound_ms']:.4f} ms by {out[name]['bound_by']}; "
            f"plain {plain_ms:.2f} ms)")
    return out


def check_against_brute(torch, scene, rays, label):
    """The clustered closest walk against the brute sphere_closest kernel:
    equal tfar wherever the brute battery hits, equal ids except where two
    spheres lie at exactly the same distance."""
    from cpu_raytracing_experiments_tpu_torch.ops.kernels import \
        cluster_traverse as ct
    from cpu_raytracing_experiments_tpu_torch.ops.kernels import \
        sphere_battery as sb

    p, d = rays[0], rays[1]
    bt, bid = sb.closest_hit(p, d, scene.spheres.center,
                             scene.spheres.radius_sq)
    ct_t, cid = ct.intersect_clustered_pallas(scene.sphere_clusters, p, d,
                                              tile_r=CLUSTER_TILE)
    torch.cuda.synchronize()
    hit = bid >= 0
    same_t = torch.equal(ct_t[hit].view(torch.int32),
                         bt[hit].view(torch.int32))
    same_miss = torch.equal(cid >= 0, hit)
    ties = int((cid != bid).sum())
    log(f"[{label}] clustered vs brute closest: hits {int(hit.sum())}, tfar "
        f"bits equal {same_t}, same lanes hit {same_miss}, ids that differ "
        f"(exact ties) {ties}")
    if not (same_t and same_miss) or ties > 1e-4 * max(1, int(hit.sum())):
        raise AssertionError(f"[{label}] clustered walk disagrees with brute")


def render(torch, crt, scene, policy, width, height, passes, label, expect):
    """Run WINDOWS timed windows of `passes` accumulation passes each
    through Renderer.accumulate, with the launch counts set to 0 just
    before the first and read just after the last; returns (image,
    numbers). ms/pass is the median window's; rays per pass are the port's
    ray_count summed over all timed passes. Every kernel named in `expect`
    must have been launched in those passes."""
    import numpy as np

    from cpu_raytracing_experiments_tpu_torch.ops.kernels import build

    r = crt.Renderer(scene, policy, width, height)
    r.accumulate(1)  # warm-up pass
    r.reset_accumulator()
    torch.cuda.synchronize()
    build.reset_counts()
    window_ms = []
    for _ in range(WINDOWS):
        t0 = time.perf_counter()
        r.accumulate(passes)
        torch.cuda.synchronize()
        window_ms.append((time.perf_counter() - t0) * 1e3 / passes)
    launches = build.launch_counts()
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
    for name in expect:
        if launches[name] <= 0:
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
    from cpu_raytracing_experiments_tpu_torch.core.vec import Vec3
    from cpu_raytracing_experiments_tpu_torch.ops.kernels import build
    from cpu_raytracing_experiments_tpu_torch.ops.kernels import \
        cluster_traverse as ct
    from cpu_raytracing_experiments_tpu_torch.ops.kernels import \
        sphere_battery as sb
    from cpu_raytracing_experiments_tpu_torch.utils import native

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = gpu_name_power()
    log(f"[1] {card}; torch {torch.__version__} cuda {torch.version.cuda}; "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    t0 = time.perf_counter()
    libraries = (sb.LIBRARY, ct.LIBRARY, native.LIBRARY)
    for lib in libraries:
        lib.load()
    log(f"[1] csrc/ built and loaded in {time.perf_counter() - t0:.1f} s "
        f"({', '.join(lib.source.name for lib in libraries)})")
    for lib in libraries:
        for line in lib.build_log.strip().splitlines():
            if "Used" in line or "error" in line or "warning" in line:
                log(f"    {lib.source.name}:", line.strip())

    timer = Timer(torch)
    pol = crt.RendererPolicy
    sphere_kernels = ("sphere_closest", "sphere_occluded")
    cluster_kernels = ("cluster_plan", "cluster_closest", "cluster_occluded")
    hero = crt.builders.default_scene(1920, 1088).to(DEVICE)
    field = crt.accel.with_pallas_clusters(
        crt.builders.random_spheres_scene(1920, 1088)).to(DEVICE)
    hero_rows = check_kernels(
        torch, np, timer, hero.spheres.center, hero.spheres.radius_sq,
        1 << 19, 1, "2 hero table")
    field_rows = check_kernels(
        torch, np, timer, field.spheres.center, field.spheres.radius_sq,
        262144, 2, "2 1k table")
    # duplicates across the 1024-sphere staging chunk (spheres j and
    # j + 1000): the first occurrence must win every tie
    dup = Vec3(*(torch.cat([c, c]) for c in field.spheres.center))
    check_kernels(torch, np, timer, dup,
                  torch.cat([field.spheres.radius_sq] * 2), 65536, 3,
                  "2 duplicated 2k table")

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
    _, hero_path = render(torch, crt, hero,
                          pol(max_bounces=8, rays_per_chunk=1 << 19),
                          1920, 1088, PASSES, "5 hero", sphere_kernels)
    _, field_path = render(torch, crt, field, pol(max_bounces=8), 512, 512,
                           PASSES, "6 random_spheres 1k brute",
                           sphere_kernels)

    t0 = time.perf_counter()
    big = crt.accel.with_pallas_clusters(crt.builders.random_spheres_scene(
        1920, 1088, num_spheres=100_000)).to(DEVICE)
    log(f"[7] 100,000-sphere scene and its clusters built in "
        f"{time.perf_counter() - t0:.1f} s "
        f"(C={big.sphere_clusters.num_clusters}, "
        f"K={big.sphere_clusters.cluster_size}, "
        f"{big.num_lights} lights)")
    tables = {"1k spheres": (field, field.sphere_clusters),
              "100k spheres": (big, big.sphere_clusters),
              "20k triangles": (field, triangle_clusters(np, 20_000, 7))}
    cluster_rows = {}
    for tname, (scene, cp) in tables.items():
        batches = cluster_rays(torch, np, crt, scene, cp, 11,
                               narrowed=cp is scene.sphere_clusters)
        for kind, rays in batches.items():
            cluster_rows[tname, kind] = check_cluster_kernels(
                torch, np, timer, cp, rays, f"7 {tname}, {kind} rays")
            if cp.kind == "sphere":
                check_against_brute(torch, scene, rays,
                                    f"8 {tname}, {kind} rays")

    clustered = pol(max_bounces=8, accel="pallas")
    _, field_pallas = render(torch, crt, field, clustered, 1920, 1088, PASSES,
                             "9 random_spheres 1k pallas", cluster_kernels)
    _, big_pallas = render(torch, crt, big, clustered, 1920, 1088, 2,
                           "9 random_spheres 100k pallas", cluster_kernels)

    small = crt.accel.with_pallas_clusters(
        crt.builders.random_spheres_scene(256, 256))
    ra = crt.Renderer(small, clustered, 256, 256)
    rb = crt.Renderer(small, pol(max_bounces=8), 256, 256)
    ra.accumulate(5)
    rb.accumulate(5)
    same = torch.equal(ra.state.buckets, rb.state.buckets)
    log(f"[10] 256x256 1k spheres, 5 passes: accel='pallas' buckets equal "
        f"accel='brute' buckets: {same}; rays {int(ra.state.rays_traced)} "
        f"and {int(rb.state.rays_traced)}")
    if not same or int(ra.state.rays_traced) != int(rb.state.rays_traced):
        raise AssertionError("accel='pallas' differs from accel='brute'")

    for rows, path in ((hero_rows, hero_path), (field_rows, field_path)):
        for name, row in rows.items():
            row["launches"] = path["launches"][name]
    for (tname, _), rows in cluster_rows.items():
        path = big_pallas if tname == "100k spheres" else field_pallas
        for name, row in rows.items():
            # the triangle table is on no render path yet
            row["launches"] = (0 if tname == "20k triangles"
                               else path["launches"][name])
    main_rows = cluster_rows.pop(("100k spheres", "diffuse"))
    log(card)
    log(json.dumps({"kernels_at_1k_spheres": list(field_rows.values())}))
    log(json.dumps({"cluster_kernels_at_other_shapes": [
        row for rows in cluster_rows.values() for row in rows.values()]}))
    log(json.dumps({"kernels": list(hero_rows.values())
                    + list(main_rows.values())}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
