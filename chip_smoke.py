#!/usr/bin/env python3
"""Drive the PyTorch port (cpu_raytracing_experiments_tpu_torch) on one
NVIDIA GPU and check it end to end.

    python3 chip_smoke.py    # every phase, always; needs one CUDA card

Phases:
  1. device info and the build of csrc/ (both CUDA sources with nvcc for
     sm_90a and the host tree builder with g++, the three compilers started
     together);
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
     its alive mask; on the 100,000-sphere and the 20,000-triangle table
     also the streamed walks, against their plain versions and against the
     resident kernels, bit for bit;
  8. the clustered closest walk against the brute sphere_closest kernel on
     the same rays: equal tfar, equal ids except at exact ties;
  9. the large-scene path at full width: random_spheres_scene(1920, 1088)
     with 1000 and with 100,000 spheres through Renderer with
     accel='pallas', default knobs, narrowing 'auto', 8 bounces;
 10. the 1000-sphere scene at 256x256 with accel='pallas' and with
     accel='brute': bit-identical buckets;
 11. the triangle-mesh tables: mesh_scene(uv_res=224) (100,352 triangles,
     K = 128, tiles of 128) with the resident walks and the product-form
     triangle battery (against its plain version: equal ids and occlusion
     bits, t within 2 ulp; against the ordinary battery: ids equal and t
     within rtol 1e-5 / atol 1e-6 on every lane but those that a float64
     evaluation shows to lie on a decision boundary to within float32
     rounding), and
     mesh_scene(uv_res=810) (1,312,200 triangles, K = 256, tiles of 256)
     with the planner, the resident and the streamed walks, on camera,
     diffuse and narrowed batches;
 12. goldens on the card: cornell 64x64 and mesh_scene(96, 96,
     subdivisions=3) at the bar of tests/test_goldens.py::_check through the
     dense batteries; the mesh again under accel='pallas' at K = 128 with
     the resident walks, with pallas_stream=True (buckets equal to the
     resident walks' bit for bit) and with pallas_mxu=True (at the bar);
 13. the triangle-mesh path at full width, 1920x1088, 8 bounces, default
     knobs, accel='pallas': mesh_scene(uv_res=224) (resident walks),
     mesh_scene(uv_res=810) (the default policy resolves to the streamed
     walks) and mesh_scene(uv_res=224) with pallas_mxu=True.

Any failure raises and exits non-zero. On success the last lines are the
card's name and power limit, JSON objects with the kernels' numbers (the one
keyed "kernels" lists every kernel: the five of the sphere paths, the two
streamed walks and the two walks with the product-form battery), the total
time, and {"ok": true, "device": {...}}. Without a CUDA device it exits 2
and prints no result.
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
    "cluster_closest_stream": _TK + ":1174",
    "cluster_occluded_stream": _TK + ":1174",
    "cluster_closest[mxu]": _TK + ":198",
    "cluster_occluded[mxu]": _TK + ":198",
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
ROUNDING_TERMS = 2  # float32 epsilons (2^-23) of rounding allowed per summed
# term where a lane on which the product-form and the ordinary triangle
# battery differ is shown to lie on a decision boundary (boundary_ratio)
PLAIN_WALK_LIMIT_S = 20.0  # a plain walk predicted to take longer is run on
# the narrowed width instead


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


def cluster_rays(torch, np, crt, scene, cp, seed, narrowed,
                 tile=CLUSTER_TILE):
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
    t, prim = ct.intersect_clustered_pallas(cp, p, d, tile_r=tile)
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


def _same_hits(torch, a, b):
    """Two (tfar, id) results equal: ids, and the bits of tfar."""
    return (torch.equal(a[1], b[1])
            and torch.equal(a[0].view(torch.int32), b[0].view(torch.int32)))


def boundary_ratio(torch, cp, p, d, tf0, lanes, ids):
    """For the rays `lanes` against the triangles `ids` (slots of the pack,
    as the walks return them), from the pack's float32 planes evaluated in float64: the exact t, the
    bound dt of its float32 rounding, and the least ratio of a decision
    quantity's distance from its threshold to the bound of that quantity's
    rounding, over u >= 0, v >= 0, u + v <= 1, t > 1e-6 and t < tf0. A
    ratio of at most 1 means that float32 arithmetic may decide the lane
    either way. A rounding bound is ROUNDING_TERMS epsilons of the summed
    magnitudes of an expression's terms, and dt carried through u and v."""
    eps = ROUNDING_TERMS * 2.0 ** -23
    rows = cp.planes[ids.long()].double()
    n, d0, f1, g1, f2, g2 = (rows[:, 0:3], rows[:, 3], rows[:, 4:7],
                             rows[:, 7], rows[:, 8:11], rows[:, 11])
    o = torch.stack([c[lanes] for c in p], dim=1).double()
    w = torch.stack([c[lanes] for c in d], dim=1).double()
    den = (n * w).sum(1)
    t = (d0 - (n * o).sum(1)) / den
    dt = eps * ((d0.abs() + (n * o).abs().sum(1)) / den.abs()
                + t.abs() * (n * w).abs().sum(1) / den.abs())

    def barycentric(f, g):
        fw = (f * w).sum(1)
        value = (f * o).sum(1) + t * fw + g
        bound = eps * ((f * o).abs().sum(1) + t.abs() * (f * w).abs().sum(1)
                       + g.abs()) + dt * fw.abs()
        return value, bound

    u, du = barycentric(f1, g1)
    v, dv = barycentric(f2, g2)
    ratios = torch.stack([u.abs() / du, v.abs() / dv,
                          (1.0 - u - v).abs() / (du + dv),
                          (t - 1e-6).abs() / dt,
                          (t - tf0[lanes].double()).abs() / dt])
    # a ray in the triangle's plane (den = 0) is decided by rounding alone
    return t, dt, torch.nan_to_num(ratios, nan=0.0).min(dim=0).values


def unexplained_mxu_lanes(torch, cp, p, d, tf0, ordinary, product):
    """The lanes on which the walk with the product-form battery and the
    walk with the ordinary one differ (another id, or the same id with t
    beyond rtol 1e-5 / atol 1e-6), held to their cause. A lane is explained
    where one of the two winning triangles lies on a decision boundary to
    within float32 rounding, where both are hit at distances that rounding
    cannot order, or, with one winner, where the two distances differ by no
    more than the rounding of t. Returns (lanes with another id, lanes with
    t beyond, lanes not explained, the largest ratio among the explained)."""
    (kt, kid), (mt, mid) = ordinary, product
    other = mid != kid
    both = ~other & (kid >= 0)
    beyond = both & ((mt - kt).abs() > 1e-6 + 1e-5 * kt.abs())
    lanes = torch.nonzero(other | beyond)[:, 0]
    if lanes.numel() == 0:
        return 0, 0, 0, 0.0
    a, b = kid[lanes], mid[lanes]
    ta, dta, ra = boundary_ratio(torch, cp, p, d, tf0, lanes, a.clamp_min(0))
    tb, dtb, rb = boundary_ratio(torch, cp, p, d, tf0, lanes, b.clamp_min(0))
    inf = torch.full_like(ra, float("inf"))
    tie = torch.where((a >= 0) & (b >= 0), (ta - tb).abs() / (dta + dtb), inf)
    # one winner: both batteries' t lie within dt of the exact value
    apart = (mt[lanes] - kt[lanes]).double().abs() / (2.0 * dta)
    ratio = torch.where(
        a == b, apart,
        torch.minimum(torch.minimum(torch.where(a >= 0, ra, inf),
                                    torch.where(b >= 0, rb, inf)), tie))
    explained = ratio <= 1.0
    worst = float(ratio[explained].max()) if bool(explained.any()) else 0.0
    return (int(other.sum()), int(beyond.sum()), int((~explained).sum()),
            worst)


def check_cluster_kernels(torch, np, timer, cp, rays, label,
                          tile=CLUSTER_TILE, stream=False, mxu=False,
                          time_plain_apart=True):
    """The cluster kernels against their plain versions on one table and one
    ray batch, and their numbers: the planner and the two resident walks,
    bit for bit; with `stream` also the two streamed walks, bit for bit
    against their plain version (the plain walk over tables unpacked from
    the packed layout) and against the resident kernels; with `mxu` also the
    walks with the product-form triangle battery, against their plain
    version (equal ids and occlusion bits, t within 2 ulp) and against the
    ordinary battery (the ids agree and t lies within rtol 1e-5 / atol 1e-6
    on every lane but those that `boundary_ratio` shows to lie on a decision
    boundary to within float32 rounding; the counts are printed). The any-hit walk
    takes tfar0 as its shadow distance (dead lanes get 0: they are invalid
    there). Without `time_plain_apart` a plain version's time is that of its
    one checking run, not of a run of its own."""
    from cpu_raytracing_experiments_tpu_torch.ops.kernels import \
        cluster_traverse as ct

    p, d, tf0, alive = rays
    n, c, k = tf0.shape[0], cp.num_clusters, cp.cluster_size
    tiles = -(-n // tile)
    tri = cp.kind == "triangle"
    plain_s = {}

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        plain_s[name] = time.perf_counter() - t0
        return out

    plan_tf = torch.where(alive, tf0, 0.0)
    kv, ke, kn = ct._plan_visits(cp, p, d, plan_tf, alive, tile)
    pv, pe, pn = timed("cluster_plan", lambda: ct.plan_visits_plain(
        cp, p, d, plan_tf, alive, tile))
    below = torch.arange(c, device=DEVICE)[None, :] < pn[:, None]
    ok_plan = (torch.equal(kn, pn) and torch.equal(kv[below], pv[below])
               and torch.equal(ke[below], pe[below]))
    del below
    # the streamed walks' plain version reads the packed table; the planes
    # it unpacks are the resident walks' own, so one plain run holds both
    packed = ct._tables_packed(cp) if stream else None
    if stream and not all(torch.equal(a, b) for a, b in zip(
            ct._tables_unpacked(cp, packed), ct._tables(cp))):
        raise AssertionError(f"[{label}] the packed table does not unpack "
                             "to the resident planes")
    closest_stats, occ_stats = {}, {}
    kt, kid = ct.walk_closest(cp, pv, pe, pn, p, d, tf0, alive, tile)
    pt, pid = timed("cluster_closest", lambda: ct.walk_closest_plain(
        cp, pv, pe, pn, p, d, tf0, alive, tile, stats=closest_stats,
        packed=packed))
    ok_closest = _same_hits(torch, (kt, kid), (pt, pid))
    # shadow rays: to just behind the closest hit on even lanes (occluded),
    # to just before it on odd lanes, tfar0 where nothing was hit
    scale = torch.where(torch.arange(n, device=DEVICE) % 2 == 0, 1.001, 0.999)
    shadow_tf = torch.where(alive, torch.where(pid >= 0, pt * scale, tf0), 0.0)
    sv, se, sn = ct._plan_visits(cp, p, d, shadow_tf, shadow_tf > 0, tile)
    ko = ct.walk_occluded(cp, sv, se, sn, p, d, shadow_tf, tile)
    po = timed("cluster_occluded", lambda: ct.walk_occluded_plain(
        cp, sv, se, sn, p, d, shadow_tf, tile, stats=occ_stats,
        packed=packed))
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
    closest_ops = (closest_stats.get("pairs", 0)
                   * (TRI_CLOSEST_OPS if tri else CLOSEST_OPS_PER_PAIR))
    occ_ops = (occ_stats.get("pairs", 0)
               * (TRI_OCCLUDED_OPS if tri else OCCLUDED_OPS_PER_PAIR))
    closest_bytes = ray_bytes + n * 8 + listed * 8 + tiles * 4
    occ_bytes = n * (7 * 4 + 1) + listed_s * 8 + tiles * 4
    # name -> (kernel, plain, bytes, operations, max |dt|, plain's name)
    kernels = {
        "cluster_plan": (
            lambda: ct._plan_visits(cp, p, d, plan_tf, alive, tile),
            lambda: ct.plan_visits_plain(cp, p, d, plan_tf, alive, tile),
            ray_bytes + c * 24 + tiles * (c * 8 + 4), n * c * SLAB_OPS, 0.0,
            "cluster_plan"),
        "cluster_closest": (
            lambda: ct.walk_closest(cp, pv, pe, pn, p, d, tf0, alive, tile),
            lambda: ct.walk_closest_plain(cp, pv, pe, pn, p, d, tf0, alive,
                                          tile),
            closest_bytes + c * k * row_bytes, closest_ops, err,
            "cluster_closest"),
        "cluster_occluded": (
            lambda: ct.walk_occluded(cp, sv, se, sn, p, d, shadow_tf, tile),
            lambda: ct.walk_occluded_plain(cp, sv, se, sn, p, d, shadow_tf,
                                           tile),
            occ_bytes + c * k * row_bytes, occ_ops, 0.0, "cluster_occluded"),
    }
    if stream:
        st, sid = ct.walk_closest(cp, pv, pe, pn, p, d, tf0, alive, tile,
                                  stream=True)
        so = ct.walk_occluded(cp, sv, se, sn, p, d, shadow_tf, tile,
                              stream=True)
        torch.cuda.synchronize()
        ok = {"closest, plain": _same_hits(torch, (st, sid), (pt, pid)),
              "closest, resident": _same_hits(torch, (st, sid), (kt, kid)),
              "any-hit, plain": torch.equal(so, po),
              "any-hit, resident": torch.equal(so, ko)}
        log(f"[{label}] streamed walks equal to: {ok}")
        if not all(ok.values()):
            raise AssertionError(f"[{label}] a streamed walk disagrees")
        # the bytes of the rows copied: one cluster's attribute rows per
        # visit walked, beside the rays, the lists and the results
        copied = k * (12 if tri else 4) * 4
        kernels["cluster_closest_stream"] = (
            lambda: ct.walk_closest(cp, pv, pe, pn, p, d, tf0, alive, tile,
                                    stream=True),
            lambda: ct.walk_closest_plain(cp, pv, pe, pn, p, d, tf0, alive,
                                          tile, packed=packed),
            closest_bytes + closest_stats.get("visits", 0) * copied,
            closest_ops, err, "cluster_closest")
        kernels["cluster_occluded_stream"] = (
            lambda: ct.walk_occluded(cp, sv, se, sn, p, d, shadow_tf, tile,
                                     stream=True),
            lambda: ct.walk_occluded_plain(cp, sv, se, sn, p, d, shadow_tf,
                                           tile, packed=packed),
            occ_bytes + occ_stats.get("visits", 0) * copied, occ_ops, 0.0,
            "cluster_occluded")
    if mxu:
        mt, mid = ct.walk_closest(cp, pv, pe, pn, p, d, tf0, alive, tile,
                                  mxu=True)
        qt, qid = timed("cluster_closest[mxu]", lambda: ct.walk_closest_plain(
            cp, pv, pe, pn, p, d, tf0, alive, tile, mxu=True))
        mo = ct.walk_occluded(cp, sv, se, sn, p, d, shadow_tf, tile, mxu=True)
        qo = timed("cluster_occluded[mxu]", lambda: ct.walk_occluded_plain(
            cp, sv, se, sn, p, d, shadow_tf, tile, mxu=True))
        torch.cuda.synchronize()
        mhit = qid >= 0
        ulp = int((mt.view(torch.int32) - qt.view(torch.int32))[mhit]
                  .abs().max()) if bool(mhit.any()) else 0
        merr = float((mt[mhit] - qt[mhit]).abs().max()) if bool(
            mhit.any()) else 0.0
        # against the ordinary battery: a lane at an edge, at a silhouette
        # or at the t > 1e-6 threshold may fall the other way, and no other
        differ, beyond, unexplained, worst = unexplained_mxu_lanes(
            torch, cp, p, d, tf0, (kt, kid), (mt, mid))
        winners = torch.nonzero(hit)[:, 0]
        on_boundary = int((boundary_ratio(torch, cp, p, d, tf0, winners,
                                          kid[winners])[2] <= 1.0).sum())
        log(f"[{label}] product-form battery: ids equal to plain "
            f"{torch.equal(mid, qid)}, any-hit equal {torch.equal(mo, qo)}, "
            f"t within {ulp} ulp of plain; against the ordinary battery "
            f"{differ} of {int(hit.sum())} hits take another id, {beyond} "
            f"common hits lie beyond rtol 1e-5 / atol 1e-6, {unexplained} of "
            f"these lanes are not on a decision boundary to within "
            f"{ROUNDING_TERMS} epsilons a term (largest ratio of the others "
            f"{worst:.3f}; {on_boundary} of all hits lie on one by the same "
            f"measure), any-hit lanes that differ {int((mo != ko).sum())}")
        if not (torch.equal(mid, qid) and torch.equal(mo, qo) and ulp <= 2
                and unexplained == 0):
            raise AssertionError(f"[{label}] the product-form battery misses "
                                 "its contract")
        kernels["cluster_closest[mxu]"] = (
            lambda: ct.walk_closest(cp, pv, pe, pn, p, d, tf0, alive, tile,
                                    mxu=True),
            lambda: ct.walk_closest_plain(cp, pv, pe, pn, p, d, tf0, alive,
                                          tile, mxu=True),
            closest_bytes + c * k * row_bytes, closest_ops, merr,
            "cluster_closest[mxu]")
        kernels["cluster_occluded[mxu]"] = (
            lambda: ct.walk_occluded(cp, sv, se, sn, p, d, shadow_tf, tile,
                                     mxu=True),
            lambda: ct.walk_occluded_plain(cp, sv, se, sn, p, d, shadow_tf,
                                           tile, mxu=True),
            occ_bytes + c * k * row_bytes, occ_ops, 0.0,
            "cluster_occluded[mxu]")

    out = {}
    for name, (kern, plain, nbytes, ops, dt, plain_of) in kernels.items():
        ms = timer(kern, 5, warmup=1)
        plain_ms = (timer(plain, 1, warmup=0) if time_plain_apart
                    else plain_s[plain_of] * 1e3)
        out[name] = kernel_row(name, CLUSTER_SOURCE, f"{shape}, {label}",
                               None, dt, ms, plain_ms, nbytes, ops)
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


def render(torch, crt, scene, policy, width, height, passes, label, expect,
           idle=()):
    """Run WINDOWS timed windows of `passes` accumulation passes each
    through Renderer.accumulate, with the launch counts set to 0 just
    before the first and read just after the last; returns (image,
    numbers). ms/pass is the median window's; rays per pass are the port's
    ray_count summed over all timed passes. Every kernel named in `expect`
    must have been launched in those passes, and none named in `idle`."""
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
    for name in idle:
        if launches[name] != 0:
            raise AssertionError(f"[{label}] {name} was launched "
                                 f"{launches[name]} times on this path")
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


def golden_check(np, img, name, want=None):
    """tests/test_goldens.py::_check: > 99.5% of values within rtol 1e-3 /
    atol 1e-4 of the golden (or of `want`), and the mean within rtol 1e-3."""
    if want is None:
        size = "96x96" if name.startswith("mesh") else "64x64"
        want = np.load(ROOT / "tests" / "goldens"
                       / f"{name.split()[0]}_{size}_10spp.npy")
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
    from cpu_raytracing_experiments_tpu_torch.ops import intersect
    from cpu_raytracing_experiments_tpu_torch.ops.kernels import build
    from cpu_raytracing_experiments_tpu_torch.ops.kernels import \
        cluster_traverse as ct
    from cpu_raytracing_experiments_tpu_torch.ops.kernels import \
        sphere_battery as sb
    from cpu_raytracing_experiments_tpu_torch.utils import native

    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = gpu_name_power()
    log(f"[1] {card}; torch {torch.__version__} cuda {torch.version.cuda}; "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    t0 = time.perf_counter()
    libraries = (sb.LIBRARY, ct.LIBRARY, native.LIBRARY)
    build.load_all(libraries)
    log(f"[1] csrc/ built side by side and loaded in {time.perf_counter() - t0:.1f} s "
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
                torch, np, timer, cp, rays, f"7 {tname}, {kind} rays",
                stream=tname != "1k spheres")
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

    # ---- triangle meshes: tables, goldens, full-width renders ----
    resident = ("cluster_plan", "cluster_closest", "cluster_occluded")
    streamed = ("cluster_plan", "cluster_closest_stream",
                "cluster_occluded_stream")
    product = ("cluster_plan", "cluster_closest[mxu]",
               "cluster_occluded[mxu]")
    meshes = {}
    for uv_res in (224, 810):
        t0 = time.perf_counter()
        scene = crt.builders.mesh_scene(*FRAME, uv_res=uv_res)
        t1 = time.perf_counter()
        scene = crt.accel.with_pallas_clusters(scene).to(DEVICE)
        cp = scene.tri_clusters
        streams = intersect.stream_resolves_on(clustered, cp)
        log(f"[11] mesh_scene(uv_res={uv_res}): {scene.triangles.count} "
            f"triangles built in {t1 - t0:.1f} s, clusters in "
            f"{time.perf_counter() - t1:.1f} s on the host (C="
            f"{cp.num_clusters}, K={cp.cluster_size}, tables "
            f"{ct.table_bytes(cp) / 2 ** 20:.1f} MiB: the default policy "
            f"takes the {'streamed' if streams else 'resident'} walks, "
            f"tiles of {intersect._tile_for({'tile_r': 'auto'}, cp)['tile_r']})")
        if streams != (uv_res == 810):
            raise AssertionError("pallas_stream='auto' resolved otherwise "
                                 "than the JAX package's rule")
        meshes[uv_res] = scene
    mesh_rows = {}
    for uv_res, scene in meshes.items():
        cp = scene.tri_clusters
        tile = intersect._tile_for({"tile_r": "auto"}, cp)["tile_r"]
        batches = cluster_rays(torch, np, crt, scene, cp, 13, narrowed=True,
                               tile=tile)
        took = 0.0
        for kind in ("camera", "narrowed", "diffuse"):
            rays = batches[kind]
            label = f"11 mesh uv{uv_res}, {kind} rays"
            width = rays[2].shape[0]
            narrow = batches["narrowed"][2].shape[0]
            if (kind == "diffuse" and uv_res == 810
                    and took * width / narrow > PLAIN_WALK_LIMIT_S):
                log(f"[{label}] the plain walks took {took:.1f} s on the "
                    f"{narrow} narrowed lanes: this batch is cut from "
                    f"{width} lanes to its first {narrow}")
                rays = tuple(
                    type(a)(*(c[:narrow].contiguous() for c in a))
                    if isinstance(a, Vec3) else a[:narrow].contiguous()
                    for a in rays)
            t0 = time.perf_counter()
            mesh_rows[uv_res, kind] = check_cluster_kernels(
                torch, np, timer, cp, rays, label, tile=tile,
                stream=uv_res == 810, mxu=uv_res == 224,
                time_plain_apart=False)
            if kind == "narrowed":
                took = sum(mesh_rows[uv_res, kind][name]["plain_ms"]
                           for name in resident[1:]) / 1e3
        del batches
        mib = {name: 0.0 if t is None else t.numel() * t.element_size() / 2 ** 20
               for name, t in (("rows", cp.rows), ("planes", cp.planes),
                               ("packed", cp.packed))}
        log(f"[11] mesh uv{uv_res}: the triangle pack holds "
            f"{ct.device_bytes(cp) / 2 ** 20:.1f} MiB on the card (rows "
            f"{mib['rows']:.1f}, planes {mib['planes']:.1f}, the streamed "
            f"walks' packed table {mib['packed']:.1f})")

    gpol = pol(max_bounces=6, rays_per_chunk=4096)
    r = crt.Renderer(crt.builders.cornell_box_scene(64, 64), gpol, 64, 64)
    r.accumulate(10)
    golden_check(np, r.render(tonemap=False), "cornell")
    small_mesh = crt.builders.mesh_scene(96, 96, subdivisions=3)
    r = crt.Renderer(small_mesh, gpol, 96, 96)
    r.accumulate(10)
    golden_check(np, r.render(tonemap=False), "mesh brute")
    small_mesh = crt.accel.with_pallas_clusters(small_mesh, cluster_size=128)
    buckets = {}
    for name, kw, expect in (
            ("mesh pallas resident", {"pallas_stream": False}, resident),
            ("mesh pallas stream", {"pallas_stream": True}, streamed),
            ("mesh pallas mxu", {"pallas_mxu": True}, product)):
        r = crt.Renderer(small_mesh, pol(
            max_bounces=6, rays_per_chunk=9216, accel="pallas",
            pallas_tile_rays=64, **kw), 96, 96)
        build.reset_counts()
        r.accumulate(10)
        counts = build.launch_counts()
        if min(counts[k] for k in expect) <= 0:
            raise AssertionError(f"[12 {name}] launches {counts}")
        golden_check(np, r.render(tonemap=False), name)
        buckets[name] = r.state.buckets
    same = torch.equal(buckets["mesh pallas stream"],
                       buckets["mesh pallas resident"])
    log(f"[12] mesh 96x96 under accel='pallas', K=128: pallas_stream=True "
        f"buckets equal the resident walks' buckets: {same}")
    if not same:
        raise AssertionError("the streamed render differs from the resident")

    mesh_paths = {}
    for name, uv_res, kw, expect, idle in (
            ("mesh 100k pallas", 224, {}, resident, streamed[1:] + product[1:]),
            ("mesh 1.3M pallas", 810, {}, streamed, product[1:]),
            ("mesh 100k pallas mxu", 224, {"pallas_mxu": True}, product,
             resident[1:] + streamed[1:])):
        # the 2 spheres of these scenes are below PALLAS_MIN_PRIMS: the
        # resident walks' counters then belong to the triangle pack alone
        _, mesh_paths[name] = render(
            torch, crt, meshes[uv_res], pol(max_bounces=8, accel="pallas",
                                            **kw),
            *FRAME, 2, f"13 {name}", expect + sphere_kernels,
            idle if uv_res == 224 else idle + resident[1:])

    for rows, path in ((hero_rows, hero_path), (field_rows, field_path)):
        for name, row in rows.items():
            row["launches"] = path["launches"][name]
    for (tname, _), rows in cluster_rows.items():
        path = big_pallas if tname == "100k spheres" else field_pallas
        for name, row in rows.items():
            # neither the triangle table of phase 7 nor a streamed walk over
            # a sphere table is on a render path
            row["launches"] = (0 if tname == "20k triangles"
                               or name.endswith("_stream")
                               else path["launches"][name])
    for (uv_res, _), rows in mesh_rows.items():
        for name, row in rows.items():
            path = mesh_paths["mesh 1.3M pallas" if uv_res == 810
                              else "mesh 100k pallas mxu" if "[mxu]" in name
                              else "mesh 100k pallas"]
            row["launches"] = path["launches"][name]
    main_rows = dict(cluster_rows.pop(("100k spheres", "diffuse")))
    # the streamed walks' main-path shape is the 1.3 M-triangle table's
    cluster_rows["100k spheres", "diffuse, streamed"] = {
        k: main_rows.pop(k) for k in list(main_rows) if k.endswith("_stream")}
    new_rows = {name: mesh_rows[810, "narrowed"].pop(name)
                for name in streamed[1:]}
    new_rows.update({name: mesh_rows[224, "narrowed"].pop(name)
                     for name in product[1:]})
    log(card)
    log(json.dumps({"kernels_at_1k_spheres": list(field_rows.values())}))
    log(json.dumps({"cluster_kernels_at_other_shapes": [
        row for rows in list(cluster_rows.values()) + list(mesh_rows.values())
        for row in rows.values()]}))
    log(json.dumps({"kernels": list(hero_rows.values())
                    + list(main_rows.values()) + list(new_rows.values())}))
    log(f"chip_smoke: every phase passed in "
        f"{time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
