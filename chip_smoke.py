#!/usr/bin/env python3
"""Drive the PyTorch port (cpu_raytracing_experiments_tpu_torch) on one
NVIDIA GPU and check it end to end.

    python3 chip_smoke.py    # every phase, always; needs one CUDA card

Phases:
  1. device info and the build of csrc/ (the eight CUDA sources with nvcc
     for sm_90a and the host tree builder with g++, the nine compilers
     started together); -Xptxas -v of both planners, every walk (the BVH
     and grid walks too), both sphere batteries, the fma kernels and the
     NEE kernels (registers, spills, shared memory), the float64
     instructions in the SASS of every kernel of the eight CUDA sources
     (cuobjdump): a planner, a walk, a battery, an fma kernel, the RNG site
     kernel or nee_combine with any fails the run (nee_sphere's sin and cos
     are float64, as fp.sin / fp.cos); the SASS
     opcodes of the flat planner, sphere_closest and sphere_occluded, and
     the card's clock, for their issue floors;
  2. every form of the fma kernels against its plain version (fp.fma_plain
     and its chains in core/), bit for bit: the flat kernel's six
     expressions (fp.fma, fp.dot3, fp.fma3, sampling.to_local with either
     contraction of its inner sum, and to_world) on seven columns of 2^22
     random floats with wide exponents,
     the triples on which a float64 sum rounds twice and specials; on
     operands 1-3 elements off a 16-byte boundary, with n % 4 = 1, 2, 3,
     with 0-d and Python-float operands, and broadcast (the strided kernel
     or the chain of fma calls), the strided kernel on 4-D operands and on
     2^19 lanes with an operand a column of a table (the hero's light
     sampler); their times at 2^19 lanes and the host microseconds a call
     takes;
     sphere_closest on tables of 1, 9 and 1000
     spheres, of 9, 1024 and 1025 with duplicated spheres and of 5-8 and
     517 (a last 512-sphere chunk whose disc rounds b*b alone), on ray slices
     at offsets 0-3 with n % 4 = 0-3; sphere_occluded on tables of 1, 9 and
     1000 spheres and of 1024-1026 with one occluder at the staging chunk's
     edge (index 1023, 1024, 1025), on the same slices, with NaN shadow
     lanes among +inf, 0 and -1; each sphere-battery kernel against its
     plain PyTorch version, bit for bit, on seeded batches with
     tangent/grazing rays, duplicate spheres on both sides of a
     staging-chunk boundary and shadow lanes with tfar <= 0; their
     CUDA-event times beside the bound and the plain version's time, the
     any-hit battery's also beside its warp pairs (what one ray a thread
     must do when a warp runs as long as its slowest lane);
  3. white furnace, 256x256, 25 spp: every pixel of the linear resolve is 1;
  4. hero scene, 64x64, 10 spp, against tests/goldens/hero_64x64_10spp.npy
     at the bar of tests/test_goldens.py::_check;
  5. the hero path: the hero scene at 1920x1088, 8 bounces, 2^19 rays per
     chunk, through Renderer.accumulate, with the kernels' launch counts
     (every fma form among them but to_local and the strided form, which
     only the plain NEE launches: the NEE kernels shade it here) and, over one profiled pass, the kernel
     launches of the pass and those of the fma kernels;
  6. the 1000-sphere random_spheres_scene at 512x512, 8 bounces, brute;
  7. the three cluster kernels (planner, closest walk, any-hit walk)
     against their plain versions, bit for bit, with their times: tables of
     1000 spheres (K = 64), 100,000 spheres (K = 128) and 20,000 random
     triangles, in tiles of 128 at the widths the full-width render
     launches them with: the 2^19 camera rays of the frame's first chunk,
     2^19 diffuse-like rays with a tfar0 seed and half the lanes dead, and
     the 131,072-lane wavefront the bounce loop narrows that chunk to, with
     its alive mask; both walks bit for bit and timed at every S of their
     S-way split (1, 2, 4); on the 100,000-sphere and the 20,000-triangle
     table also the streamed walks, against their plain versions and
     against the resident kernels (at every S), bit for bit;
  8. the clustered closest walk against the brute sphere_closest kernel on
     the same rays: equal tfar, equal ids except at exact ties;
  9. the large-scene path at full width: random_spheres_scene(1920, 1088)
     with 1000 and with 100,000 spheres through Renderer with
     accel='pallas', default knobs, narrowing 'auto', 8 bounces;
 10. the 1000-sphere scene at 256x256 with accel='pallas' and with
     accel='brute': bit-identical buckets;
 11. the triangle-mesh tables: mesh_scene(uv_res=224) (100,352 triangles,
     K = 128, tiles of 128) with the resident walks and the product-form
     triangle battery (both walks against their plain version at every S:
     equal ids, occlusion bits and t bits; against the ordinary battery: ids
     equal and t within rtol 1e-5 / atol 1e-6 on every lane but those that
     a float64 evaluation shows to lie on a decision boundary to within
     float32 rounding), and
     mesh_scene(uv_res=810) (1,312,200 triangles, K = 256, tiles of 256)
     with the planner, the resident and the streamed walks, on camera,
     diffuse and narrowed batches; the streamed walks bit for bit at every
     S of their S-way split (1, 2, 4) and timed at each; then the tie batch:
     a pack made from the 100,352-triangle one in which every prim has 3
     more copies in its cluster and 4 in the next cluster, walked by the
     resident walks (the closest one with both triangle batteries) and the
     streamed walks at every S against the plain version, the first copy
     in (visit, slot) order winning every hit;
 12. goldens on the card: cornell 64x64 and mesh_scene(96, 96,
     subdivisions=3) at the bar of tests/test_goldens.py::_check through the
     dense batteries; the mesh again under accel='pallas' at K = 128 with
     the resident walks, with pallas_stream=True (buckets equal to the
     resident walks' bit for bit) and with pallas_mxu=True (at the bar);
 13. the triangle-mesh path at full width, 1920x1088, 8 bounces, default
     knobs, accel='pallas': mesh_scene(uv_res=224) (resident walks),
     mesh_scene(uv_res=810) (the default policy resolves to the streamed
     walks; the walks' counters of one traced pass printed, as the
     benchmark's cell mesh1p3m.final-1080p reads them) and
     mesh_scene(uv_res=224) with pallas_mxu=True;
 14. the planners (pallas_plan 'super', 'group', 'tilebox', 'hybrid', the
     sort outside the kernel and the unsorted plan): on the 100,352-triangle
     and the 100,000-sphere tables, each with a group-box pack beside the
     default one, on camera, narrowed and diffuse batches, every mode of
     cluster_plan and cluster_plan_rows against its plain version bit for
     bit (cluster_plan_rows also with its chunk patched to 96 clusters, below
     every pack's C), 'super' equal to the flat plan, the tilebox and hybrid
     entries no larger than the flat ones, the any-hit walk on each pack at
     every S against its plain version and the streamed walk, and the walks
     each planner feeds equal to the flat plan's walks but for exact ties
     between clusters; then
     mesh_scene(uv_res=224) at 1920x1088 under each planner (eight
     renders: the six of the planners and two more that launch the super
     and group modes of cluster_plan_rows), and the mesh golden under
     'group' and 'tilebox'; then the cluster limit: with max_plan_clusters
     patched below the mesh pack's C, the sorted plan comes from
     cluster_plan_rows and the PyTorch sort, equal to cluster_plan's;
 15. benchmarks/diag_stream2.py's path at its own size through the port's
     diag/stream2.py (100,000 random triangles, K = 256, C = 391, 262,144
     rays, tiles of 256): repro (the resident against the streamed walk
     over every ray, ids and tfar bits, then tile 0 and the tile with the
     most visits alone), dma (the stream_replay kernel on those two tiles,
     every visit's rows equal to the packed table), trace (the prefix walk
     against the plain replay on the busiest tile, no diverging visit) and
     trace2 (its four variants), the launch counts from 0 before the
     stages; then stream_replay against its plain version bit for bit (on
     those tiles of the one-tile plans, and on the full plan's tile 0, its
     busiest tile, the tile with the fewest nonzero visits and one with an
     odd nv, the busiest on the grid of a one-SM card and the fewest-visit
     tile into 64 visits, each launch's grid printed), each
     one-tile plan against the full plan's row, the prefix walk
     (cluster_closest_stream with nvis clamped to m) against the plain
     prefix walk at m = 1, nv/4, nv/2, nv, the trace2 variants against each
     other, and the times of stream_replay on the busiest tile (beside an
     index_select of the same rows) and on tile 0, and of the prefix
     launch;
 16. the shading knobs (SHADING_PATHS) at full width and card against CPU
     at 64x64 (check_shading_knobs);
 17. light selection: the light_rows kernel against its plain version, bit
     for bit, on 2^19 rows at 1-10,817 lights (the selection, the sum, the
     fused sum; both sides of its staged and streamed forms) and its time
     at 326 and 10,817 lights; one timed pass of the 326-light scene under
     'power' at 1920x1088 (light_rows launches and device ms); then every
     LIGHT_PATHS path at full width (10,817 lights at 256x256 under
     'uniform' and 'alias', brute and accel='pallas'; the 326-light scene at
     192x192 under 'uniform', 'power', 'ris' and 'restir', 2-D, 1-D and at
     spp 2; the
     hero under clear_sky at 1920x1088) with its peak device memory, and
     each at 64x64 on the CPU and the card: buckets, and the reservoirs
     under 'restir', equal bit for bit;
 18. the host features around a render (check_host_paths): render_adaptive
     on the hero at 1920x1088 (tol 0.08, max_spp 50, warmup 25; both
     sphere batteries launched; wall time, stats, tiers, rounds, peak
     memory) and at 64x64 card against CPU (two tier sizes; buckets and
     counts bit for bit); checkpoint resume on the card bit for bit (the
     hero at 1920x1088, with adaptive counts, and 'restir' reservoirs on the
     326-light scene at 192x192); render_aovs and render_ao at 1920x1088,
     and at 64x64 card against CPU bit for bit; denoise_render at 64x64
     card against CPU within rtol 1e-5 / atol 1e-6; check_render on the
     hero and on a NaN-albedo scene (the same first bad pixel as the CPU);
     a SceneEditor edit on the card against a scene built with the edit;
 19. the backends without Pallas (check_accel_paths): bvh_closest,
     bvh_occluded, grid_closest and grid_occluded against their plain
     versions bit for bit on the 1000-sphere field's BVH (leaf_size 4) and
     grid (res=32) and on mesh_scene(subdivisions=6)'s (81,920 triangles;
     the grid at res=48 with its residual list), on camera, diffuse and
     exactly axis-aligned batches of 2^19 rays (2^16 on the mesh grid,
     whose plain residual battery is slow), and the BVH walks also on the
     shadow batch (CaptureOccluded: the operands of the largest
     bvh_occluded call of the warm-up pass of the field's or mesh's 'bvh'
     render below), timed beside the bound from the plain version's visit
     counts, bvh_closest also by the host's clock
     around one call (its node table packed once, with the BVH) beside
     what packing the table took; both grid kernels on residual lists of
     5-8 spheres (disc rounds b*b alone), bit for bit; the mesh grid's
     kernels on the 2^19 camera rays of a chunk, timed only (the bound from
     the set-up and the residual pairs); the field at 1920x1088, 8 bounces, under
     'brute', 'bvh', 'grid' and 'clustered' (64 clusters), and the mesh at
     5 bounces under 'bvh' and 'grid' (one window), each with its launches
     and peak memory, each image held to the field's 'brute' image (the
     mesh's to each other): the mean within rtol 1e-3 and more than
     ACCEL_CLOSE of the values within rtol 1e-3 / atol 1e-4; bvh_test at
     64x64 under 'bvh',
     'grid', 'clustered' and 'bvh' with primary_accel='pallas', the card's
     buckets of one pass equal to the CPU's bit for bit, and the bvh_test
     golden on the card at 10 spp; a 6-sphere scene at 64x64 (brute), the
     card's buckets equal to the CPU's; a SceneEditor edit of a with_bvh scene on the card
     against the scene built with the edit;
 20. the pool, the shell and multi-device (check_shell_paths): the hero at
     1920x1088 through render_pass_pooled (pool 2^19) against render_pass,
     radiance and ray count bit for bit, both timed (median of 3 windows),
     the pool's iterations, launches, busy time and peak memory, and card =
     CPU at 64x64; ``python -m cpu_raytracing_experiments_tpu_torch.cli
     render`` of the hero at 1920x1088, 5 spp, in a subprocess (its .hdr
     equal to the RGBE bytes of the in-process resolve, its PNG decoded
     with zlib to the tonemapped resolve) and ``cli bench`` at
     BENCH_PASSES=3 (its line names the card); the viewer at 1920x1088
     (/stats, /frame.png, /edit, /delta, stopped), its ms a pass; the
     sharded renderer at world size 1 over NCCL (its all_gathers on card
     tensors) against Renderer, and tests/torch_sharded_worker.py on two
     processes over gloo at dp 2 on the card (bit for bit) and sp 2 on the
     card (within tests/test_sharding.py's tolerance, and equal to the same
     run on the CPU); it prints a ``shell_paths`` JSON line;
 21. the counter RNG's site kernel (check_rng_sites): rng.site_draws on the
     card against core/rng.py's site_draws_plain on the same inputs, bit
     for bit, at the benchmark cells' sites, on their own pixel seeds: the
     hero's NEE site (1920x1088, 4 passes packed, 8,355,840 lanes, one
     accumulation a lane, 3 draws), the 4K cell's NEE site on its narrowed
     wavefront (2,073,600 of 3840x2160's lanes, 3 draws) and the preview's
     camera site (1920x1088 at 4 samples a pixel, the stratified jitter, 2
     rows); the kernel's and the plain version's times; its launches are
     those of phase 5's hero path (phase 13's mesh paths launch it too);
 22. NEE toward sphere lights (check_nee_sites): at every bounce of one
     wavefront of the hero cell (1920x1088, 4 passes packed, 8,355,840
     lanes, 3 lights) and of the 4K cell (mesh100k at 3840x2160, narrowed),
     nee_sphere and nee_combine against the plain path
     (renderer._next_event_estimation and its add, the shadow query
     answered alike): l_dir, tfar, valid and the radiance bit for bit; their
     time a pass beside their byte bound, with the site's draws, and the
     plain composite's; over one profiled hero pass on each path, the
     int64 light-row gather (vectorized_gather_kernel) launched by the
     plain path only and nee_sphere once a bounce.
 23. the lambertian hit shading (check_shade_sites): at every bounce of
     the same two wavefronts, shade_frame against _closest_hit_frame and
     _gather_material at the hit lanes and the bounce the kernels shaded
     against bounce_step on the plain path (the intersection answered
     alike), every PathState field bit for bit; shade_frame + shade_tail a
     pass beside their byte bound; the bounce after the intersection on
     both paths less NEE and the draws (the eager spans the kernels
     replace); the launches of one bounce on each path.

Any failure raises and exits non-zero. On success the last lines are the
card's name and power limit, JSON objects with the kernels' numbers (the one
keyed "kernels" lists every kernel: the five of the sphere paths, the seven
forms of the fma kernels, every walk with its S, the walks with the
product-form battery, the seven planner modes of phase 14, and phase 15's
stream_replay and prefix launch, phase 17's light_rows, phase 19's four
walks, phase 21's rng_site at the hero's NEE site, phase 22's nee_sphere
with nee_combine a pass of the hero cell, phase 23's shade_frame with
shade_tail a pass of the hero cell), the
clusters planned and walked per tile under each planner, phase 16's numbers
(keyed "shading_paths"), phase 17's (keyed "light_paths"), phase 18's (keyed
"host_paths"), phase 19's walks at their other shapes and its paths (keyed
"accel_paths"), phase 20's (keyed "shell_paths"), the total time,
and {"ok": true, "device": {...}}. Without a CUDA device it exits 2 and
prints no result.
"""
from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import math
import re
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
FMA_SOURCE = "cpu_raytracing_experiments_tpu_torch/csrc/fma.cu"
LIGHT_ROWS_SOURCE = "cpu_raytracing_experiments_tpu_torch/csrc/light_rows.cu"
RNG_SOURCE = "cpu_raytracing_experiments_tpu_torch/csrc/rng.cu"
NEE_SOURCE = "cpu_raytracing_experiments_tpu_torch/csrc/nee.cu"
SHADE_SOURCE = "cpu_raytracing_experiments_tpu_torch/csrc/shade.cu"
_TK = "cpu_raytracing_experiments_tpu/ops/pallas/traverse_kernel.py"
REPLACES = {
    **{name: "none: the single-rounding a*b + c that XLA contracts in the "
              "JAX package's elementwise code (core/fp.py)"
       for name in ("fma", "fma[strided]", "fma[dot3]", "fma[fma3]",
                    "fma[to_local]", "fma[to_world]", "fma[to_local_xy]")},
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
    "stream_replay": "benchmarks/diag_stream2.py:152",
    # the streamed walk over one tile's first m visits (_TK:1174)
    "cluster_closest_stream[prefix]": "benchmarks/diag_stream2.py:327",
    "light_rows": "none: XLA's jnp.sum / jnp.cumsum over the lights, "
                  "cpu_raytracing_experiments_tpu/render/renderer.py:300, "
                  ":302 (_select_light) and :341 (the emissive-hit pdf)",
    # phase 19's walks, each an XLA lax.while_loop in the JAX package
    "bvh_closest": "none: an XLA lax.while_loop, "
                   "cpu_raytracing_experiments_tpu/bvh/traverse.py:254 "
                   "(traverse_closest_packed)",
    "bvh_occluded": "none: an XLA lax.while_loop, "
                    "cpu_raytracing_experiments_tpu/bvh/traverse.py:309 "
                    "(traverse_shadow_packed)",
    "grid_closest": "none: an XLA lax.while_loop and dense battery, "
                    "cpu_raytracing_experiments_tpu/bvh/grid.py:100 "
                    "(traverse_grid_closest) and :215 (_battery_closest)",
    "grid_occluded": "none: an XLA lax.while_loop and dense battery, "
                     "cpu_raytracing_experiments_tpu/bvh/grid.py:246 "
                     "(traverse_grid_shadow) and :215 (_battery_closest)",
    "rng_site": "none: XLA's fusion of "
                "cpu_raytracing_experiments_tpu/core/rng.py (hash_2d :78, "
                "draws :98) at each site of "
                "cpu_raytracing_experiments_tpu/render/renderer.py "
                "(_site_state :102, the draws after it, the stratified "
                "camera jitter)",
    "nee_sphere": "none: XLA's fusion of "
                  "cpu_raytracing_experiments_tpu/render/renderer.py "
                  "(_next_event_estimation :543, under the lambertian "
                  "closure, uniform selection and sphere lights)",
    "shade_frame": "none: XLA's fusion of "
                   "cpu_raytracing_experiments_tpu/render/renderer.py "
                   "(bounce_step's closest-hit frame, emissive hit, BSDF "
                   "sample, Russian roulette and writeback under the "
                   "lambertian closure)",
    # the planner modes last: phase 14 takes them as tuple(REPLACES)[-7:]
    "cluster_plan[super]": _TK + ":420",
    "cluster_plan[group]": _TK + ":420",
    "cluster_plan_rows[ray]": _TK + ":420",
    "cluster_plan_rows[super]": _TK + ":420",
    "cluster_plan_rows[group]": _TK + ":420",
    "cluster_plan_rows[tilebox]": _TK + ":351",
    "cluster_plan_rows[hybrid]": _TK + ":371",
}
# operations per test, counted from csrc/cluster_traverse.cu: a slab test is
# 6 sub, 6 mul, 11 min/max, 2 compares and the running min; the triangle
# battery 15 mul-adds counted as 2, a division and 7 compares and adds
SLAB_OPS = 26
# an interval test of the tilebox planner: per axis 4 sub, 8 mul, 14 min/max
# and 2 selects; then 3 max, 2 min, 3 compares and a select
TILEBOX_OPS = 93
# the planner renders of phase 14: (label, policy knobs, group-box pack,
# the counter of the planner kernel the render must launch); the last two
# show the remaining modes of cluster_plan_rows on a render path and are
# neither profiled nor timed beyond one pass a window
PLANNER_RENDERS = (
    ("super", {"pallas_plan": "super"}, False, "cluster_plan[super]"),
    ("group", {"pallas_plan": "group"}, True, "cluster_plan[group]"),
    ("tilebox", {"pallas_plan": "tilebox"}, False,
     "cluster_plan_rows[tilebox]"),
    ("hybrid", {"pallas_plan": "hybrid"}, False, "cluster_plan_rows[hybrid]"),
    ("xla-sort", {"pallas_sort_impl": "xla"}, False,
     "cluster_plan_rows[ray]"),
    ("unsorted", {"pallas_sort_visits": False}, False,
     "cluster_plan_rows[ray]"),
    # the two remaining modes of cluster_plan_rows on a render path
    ("super, xla-sort", {"pallas_plan": "super", "pallas_sort_impl": "xla"},
     False, "cluster_plan_rows[super]"),
    ("group, unsorted", {"pallas_plan": "group",
                         "pallas_sort_visits": False}, True,
     "cluster_plan_rows[group]"),
)
# the pack of diag_group_plan.py for pallas_plan='group'
GROUP_PACK = {"cluster_size": 128, "fill_window": 8, "group_boxes": True}
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
FMA_TRIPLES = 1 << 22  # random triples the fma kernel is held to fp.fma on
SPLITS = (1, 2, 4)  # the S of the walks' S-way split
PATCHED_CHUNK = 96  # cluster_plan_rows' chunk in phase 14's patched run
RESIDUAL_SPHERES = (5, 6, 7, 8)  # chunk widths whose disc rounds b*b alone


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
    a warm-L2 time would undercut the HBM bound). The card spins for
    HOST_SLACK_CYCLES after the flush, so that the host has enqueued the
    callable's launches before the start event fires: the time between the
    events is the device's, not the wrapper's host time."""

    HOST_SLACK_CYCLES = 2_000_000  # about 1 ms at the H100's clock

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
            torch.cuda._sleep(self.HOST_SLACK_CYCLES)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            total += start.elapsed_time(end)
        return total / iters


def ptxas_report(build_log: str, keys):
    """(entry function, registers, spill bytes stored and loaded, shared
    memory bytes) from nvcc's -Xptxas -v output, for the entry functions
    whose mangled names hold one of `keys`."""
    out, fn, spill = [], None, (0, 0)
    for line in build_log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            fn, spill = m.group(1), (0, 0)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spill = (int(m.group(1)), int(m.group(2)))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and fn is not None:
            if any(k in fn for k in keys):
                smem = re.search(r"(\d+) bytes smem", line)
                out.append((fn, int(m.group(1)), spill,
                            int(smem.group(1)) if smem else 0))
            fn = None
    return out


def stack_frames(build_log: str) -> dict:
    """{entry function: bytes of its stack frame} from nvcc's -Xptxas -v
    output."""
    out, fn = {}, None
    for line in build_log.splitlines():
        m = re.search(r"Function properties for (\w+)", line)
        fn = m.group(1) if m else fn
        m = re.search(r"(\d+) bytes stack frame", line)
        if m and fn is not None:
            out[fn] = int(m.group(1))
    return out


def kernel_name(mangled: str) -> str:
    """A readable name for a mangled kernel of csrc/: the streamed walks'
    battery and split, or the function's name."""
    m = re.search(r"(closest|occluded)_kernelILi(\d)ELb([01])ELi(\d)E",
                  mangled)
    if m:
        battery = ("sphere", "triangle", "product form")[int(m.group(2))]
        return (f"cluster_{m.group(1)}"
                f"{'_stream' if m.group(3) == '1' else ''}"
                f"[{battery}, S={m.group(4)}]")
    m = re.search(r"14closest_kernelILb([01])ELb([01])EE", mangled)
    if m:  # bvh_closest: its leaves, its node table staged or not
        return (f"closest_kernel[{('sphere', 'triangle')[int(m.group(1))]}, "
                f"{('nodes by __ldg', 'nodes staged')[int(m.group(2))]}]")
    m = re.search(r"light_rows_kernelILb([01])EE", mangled)
    if m:
        return f"light_rows_kernel[{('staged', 'streamed')[int(m.group(1))]}]"
    m = re.search(r"(walk_|residual_)?(closest|occluded|occluded_pairs)"
                  r"_kernelILb([01])EE", mangled)
    if m:  # the BVH and grid walks, the grid's residual battery
        return (f"{m.group(1) or ''}{m.group(2)}_kernel"
                f"[{('sphere', 'triangle')[int(m.group(3))]}]")
    m = re.search(r"replay_kernelILi(\d)EE", mangled)
    if m:
        return f"stream_replay[{('sphere', 'triangle')[int(m.group(1))]}]"
    m = re.search(r"flat_kernelILi(\d)E([jx])E", mangled)
    if m:
        form = ("fma", "dot3", "fma3", "to_local", "to_world",
                "to_local_xy")[int(m.group(1))]
        return (f"fma flat_kernel[{form}, "
                f"{'32' if m.group(2) == 'j' else '64'}-bit index]")
    m = re.search(r"plan_kernelILi(\d)ELb([01])ELb([01])E", mangled)
    if m:
        mode = ("ray", "group", "super", "tilebox", "hybrid")[int(m.group(1))]
        return (f"cluster_plan{'_rows' if m.group(3) == '1' else ''}[{mode}, "
                f"{'wide' if m.group(2) == '1' else 'narrow'}]")
    m = re.search(r"\d+([a-z_]+_kernel)(?:I(?:Li)?(\w)E)?", mangled)
    if not m:
        return mangled
    arg = {"i": "int", "x": "long long"}.get(m.group(2), m.group(2))
    return m.group(1) + (f"<{arg}>" if arg else "")


def sass_report(library) -> dict:
    """Per kernel of a built library (cuobjdump -sass): its SASS
    instructions, the float64 arithmetic among them (DFMA, DADD, DMUL,
    DSETP, DMNMX), the conversions to or from float64 (F2F with an F64
    operand) and the count of each opcode."""
    from cpu_raytracing_experiments_tpu_torch.ops.kernels import build

    tool = Path(build.nvcc()).parent / "cuobjdump"
    text = subprocess.run([str(tool), "-sass", str(library.path)],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout
    counts, fn = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            counts[fn] = {"instructions": 0, "f64 arithmetic": 0,
                          "f64 conversions": 0, "opcodes": {}}
            continue
        m = re.search(
            r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9]*)", line)
        if fn is None or not m:
            continue
        counts[fn]["instructions"] += 1
        ops = counts[fn]["opcodes"]
        ops[m.group(1)] = ops.get(m.group(1), 0) + 1
        if re.search(r"\bD(FMA|ADD|MUL|SETP|MNMX)\b", line):
            counts[fn]["f64 arithmetic"] += 1
        if re.search(r"\bF2F\.[A-Z0-9.]*F64", line):
            counts[fn]["f64 conversions"] += 1
    return counts


SPLIT_WALKS = ("closest_kernel", "occluded_kernel",
               "occluded_pairs_kernel")  # the walks' names (and the sphere
# batteries')
FMA_KERNELS = ("flat_kernel", "strided_kernel")  # csrc/fma.cu
CHECKED = SPLIT_WALKS + ("closest_split_kernel", "plan_kernel",
                         "replay_kernel", "light_rows_kernel",
                         "merge_kernel", "site_kernel",
                         "nee_combine_kernel") + FMA_KERNELS
# (the kernels that must hold no float64)
FLOAT64_BY_DESIGN = ("nee_sphere_kernel", "shade_frame_kernel",
                     "shade_tail_kernel")  # sin, cos and rsqrt in float64,
# as fp.sin / fp.cos / fp.rsqrt
FLAT_PLANNER = "plan_kernelILi0ELb1ELb0E"  # cluster_plan['ray', wide]
SPHERE_CLOSEST = "closest_kernelE"  # sphere_closest (the walks' are
# templates)
SPHERE_OCCLUDED = "occluded_kernelE"  # sphere_occluded
GRID_RESIDUAL = "residual_"  # the grid's residual battery
BVH_CLOSEST = "14closest_kernelILb"  # bvh_closest's four instantiations
BVH_PAIRS = "occluded_pairs_kernel"  # bvh_occluded's pair walk
LIGHT_ROWS = "light_rows_kernel"


def report_kernels(libraries):
    """Phase 1's reading of what was compiled: -Xptxas -v for both
    planners, every walk (each a split walk), the sphere batteries and the
    fma kernels, the SASS of every kernel of the four CUDA sources, and the
    opcodes of the flat planner (the slab tests of its sweep are unrolled 80
    times: 8 octants x (8 + 2) boxes), of sphere_closest, of
    sphere_occluded, of the grid's residual battery, of bvh_closest and of
    light_rows;
    raises where a planner, a walk, a battery or an fma kernel holds float64
    arithmetic or a float64 conversion."""
    from cpu_raytracing_experiments_tpu_torch.ops.kernels import \
        cluster_traverse as ct
    from cpu_raytracing_experiments_tpu_torch.ops.kernels import fma as kf
    from cpu_raytracing_experiments_tpu_torch.ops.kernels import \
        light_rows as lr
    from cpu_raytracing_experiments_tpu_torch.ops.kernels import \
        sphere_battery as sb

    bad = []
    for lib in libraries:
        frames = stack_frames(lib.build_log)
        for fn, regs, (st, ld), smem in ptxas_report(
                lib.build_log, CHECKED + FLOAT64_BY_DESIGN):
            log(f"    ptxas {lib.source.name} {kernel_name(fn)}: {regs} "
                f"registers, spill "
                f"stores {st} B, spill loads {ld} B, {smem} B static shared, "
                f"{frames.get(fn, 0)} B stack frame")
            # bvh_occluded's pair walk: at most 64 registers, no stack frame
            if BVH_PAIRS in fn and (regs > 64 or frames.get(fn, 0)):
                bad.append(kernel_name(fn))
    if bad:
        raise AssertionError(f"more than 64 registers or a stack frame: {bad}")
    from cpu_raytracing_experiments_tpu_torch.ops.kernels import \
        bvh_walk as bw
    from cpu_raytracing_experiments_tpu_torch.ops.kernels import \
        grid_walk as gw
    from cpu_raytracing_experiments_tpu_torch.ops.kernels import nee as nk
    from cpu_raytracing_experiments_tpu_torch.ops.kernels import rng as rk
    from cpu_raytracing_experiments_tpu_torch.ops.kernels import \
        shade as sk

    for lib in (ct.LIBRARY, sb.LIBRARY, kf.LIBRARY, lr.LIBRARY, bw.LIBRARY,
                gw.LIBRARY, rk.LIBRARY, nk.LIBRARY, sk.LIBRARY):
        for fn, c in sass_report(lib).items():
            log(f"    SASS {lib.source.name} {kernel_name(fn)}: "
                f"{c['instructions']} instructions, {c['f64 arithmetic']} "
                f"float64 arithmetic, {c['f64 conversions']} float64 "
                "conversions")
            if any(k in fn for k in CHECKED) and (c["f64 arithmetic"]
                                                  or c["f64 conversions"]):
                bad.append(kernel_name(fn))
            if any(k in fn for k in (FLAT_PLANNER, SPHERE_CLOSEST,
                                     SPHERE_OCCLUDED, GRID_RESIDUAL,
                                     BVH_CLOSEST, BVH_PAIRS, LIGHT_ROWS)):
                log(f"    SASS opcodes of {kernel_name(fn)}: " + ", ".join(
                    f"{op} {n}" for op, n in sorted(
                        c["opcodes"].items(), key=lambda kv: -kv[1])))
    if bad:
        raise AssertionError(f"float64 in a planner, a walk, a battery or "
                             f"an fma kernel: {bad}")


def wide_floats(np, g, n):
    """Random float32 of either sign with exponents from -30 to 30."""
    return (g.uniform(1.0, 2.0, n) * 2.0 ** g.integers(-30, 31, n)
            * g.choice([-1.0, 1.0], n)).astype(np.float32)


FMA_FORMS = ("fma", "fma[dot3]", "fma[fma3]", "fma[to_local]",
             "fma[to_world]", "fma[to_local_xy]")  # the flat kernel's
# expressions, in the order of csrc/fma.cu's enum Op
# per element of each form: (operands read, outputs written, FLOP)
FMA_WORK = {"fma": (3, 1, 2), "fma[strided]": (3, 1, 2),
            "fma[dot3]": (6, 1, 5), "fma[fma3]": (7, 3, 6),
            "fma[to_local]": (6, 3, 12), "fma[to_world]": (6, 3, 12),
            "fma[to_local_xy]": (6, 3, 12)}


def fma_forms(torch):
    """Each flat form as (kernel call, plain version), both on a tuple of
    operands and returning a tuple of outputs."""
    from cpu_raytracing_experiments_tpu_torch.core import fp, sampling
    from cpu_raytracing_experiments_tpu_torch.core.vec import Quat, Vec3

    def rotation(f):
        return lambda x: tuple(f(Quat(x[0], x[1], None, x[2]),
                                 Vec3(*x[3:])))

    return {
        "fma": (lambda x: (fp.fma(*x),), lambda x: (fp.fma_plain(*x),)),
        "fma[dot3]": (lambda x: (fp.dot3(*x),),
                      lambda x: (fp.dot3_plain(*x),)),
        "fma[fma3]": (lambda x: tuple(fp.fma3(Vec3(*x[:3]), x[3],
                                              Vec3(*x[4:]))),
                      lambda x: tuple(fp.fma3_plain(Vec3(*x[:3]), x[3],
                                                    Vec3(*x[4:])))),
        "fma[to_local]": (rotation(sampling.to_local),
                          rotation(sampling.to_local_plain)),
        "fma[to_world]": (rotation(sampling.to_world),
                          rotation(sampling.to_world_plain)),
        "fma[to_local_xy]": (
            rotation(lambda t, v: sampling.to_local(t, v, fuse_xy=True)),
            rotation(lambda t, v: sampling.to_local_plain(t, v,
                                                          fuse_xy=True))),
    }


def same_bits(torch, x, y):
    """Per lane: equal bits, or both NaN."""
    return ((x.view(torch.int32) == y.view(torch.int32))
            | (torch.isnan(x) & torch.isnan(y)))


def fma_columns(torch, np, g):
    """Seven operand columns: FMA_TRIPLES wide random floats, then the
    triples on which a float64 sum rounds twice (a = 1 + k 2^-23, b = 2^-24
    (1 - (k - 1) 2^-23), c = 1, k = 2800-2959) as (a, b, c) in columns 0-2
    (fp.fma's operands) and as (a, b, c) in columns 0, 3, 4 (the x lane of
    fp.fma3), then rows of specials (NaN, inf, signed zeros, subnormal
    results), each row a triple (a, b, c) in columns 0-2 and rotated
    through the others."""
    k = np.arange(2800, 2960)
    a = (1.0 + k * 2.0 ** -23).astype(np.float32)
    b = (2.0 ** -24 * (1.0 - (k - 1) * 2.0 ** -23)).astype(np.float32)
    c = np.ones(k.size, np.float32)
    twice = (a, b, c, b, c, a, b)
    nan, inf = float("nan"), float("inf")
    specials = [(nan, 1, 1), (1, 1, nan), (inf, 1, 1), (inf, 0, 1),
                (inf, 1, -inf), (1e30, 1e30, 0), (-0.0, 1, 0.0),
                (-0.0, 1, -0.0), (2, 3, -6), (2.0 ** -75, 2.0 ** -75, 0),
                (2.0 ** -75, 1.5 * 2.0 ** -75, 0),
                (2.0 ** -100, 2.0 ** -50, 2.0 ** -149)]
    cols = []
    for j in range(7):
        rows = [r[j] if j < 3 else r[(j + i) % 3]
                for i, r in enumerate(specials)]
        cols.append(torch.tensor(np.concatenate([
            wide_floats(np, g, FMA_TRIPLES), twice[j],
            np.array(rows, np.float32)]), device=DEVICE))
    return cols


def check_fma_forms(torch, np, timer):
    """Every form of the fma kernels against its plain version (fp.fma_plain
    and the chains of it in core/), bit for bit (NaN lanes: both NaN), on
    the card: the flat kernel's six expressions on seven columns of
    FMA_TRIPLES wide random floats with the double-rounding triples and
    specials (16-byte groups); on slices that start 1-3 elements off a
    16-byte boundary, each operand at its own offset (scalar loads); with
    n % 4 = 1, 2, 3 (a scalar tail); with each operand in turn a 0-d tensor
    and a Python float; and on broadcast operands, which the flat kernel
    does not take (fp.fma: the strided kernel, also on 4-D operands with a
    transposed one and on the hero's 2^19 lanes with one operand a column
    of a table; the fused forms: their chain of fma calls). Each call must
    launch its form once, the chains aside. Returns the forms' rows, timed
    at the hero chunk's 2^19 lanes (the strided form with c a column of a
    [2^19, 8] table, as the hero's light sampler gives it), and the host
    microseconds a call of each takes."""
    from cpu_raytracing_experiments_tpu_torch.ops.kernels import build
    from cpu_raytracing_experiments_tpu_torch.ops.kernels import fma as kf

    g = np.random.default_rng(23)
    cols = fma_columns(torch, np, g)
    forms = fma_forms(torch)
    arity = {name: kf.ARITY[op][0] for op, name in enumerate(FMA_FORMS)}
    failures = []

    def check(name, operands, label, form=None):
        kern, plain = forms[name]
        before = build.launch_counts()
        got, want = kern(operands), plain(operands)
        launched = {k: v - before[k] for k, v in build.launch_counts().items()
                    if v != before[k]}
        bad = sum(int((~same_bits(torch, x, y)).sum())
                  for x, y in zip(got, want))
        if bad or (form is not None and launched != {form: 1}):
            failures.append(f"{name} {label}: {bad} lanes differ; launches "
                            f"{launched}")
        return bad

    n = cols[0].numel()
    for name in FMA_FORMS:
        k = arity[name]
        x = cols[:k] if name != "fma[fma3]" else cols
        check(name, tuple(x), "aligned", name)
        for off in ((1, 1, 1, 1, 1, 1, 1), (2, 3, 1, 2, 3, 1, 2),
                    (3, 0, 2, 1, 0, 3, 3)):
            m = n - 8
            check(name, tuple(c[o:o + m] for c, o in zip(x, off)),
                  f"offsets {off[:k]}", name)
        for tail in (1, 2, 3):
            m = (1 << 16) + tail
            check(name, tuple(c[:m] for c in x), f"n % 4 = {tail}", name)
        for j in range(k):
            for kind in ("0-d", "float")[:1 if (name, j) == ("fma", 0)
                                         else 2]:
                # fp.fma's `a` is a tensor
                scalar = (x[j][12345] if kind == "0-d"
                          else float(x[j][12345]))
                y = tuple(scalar if i == j else c[:1 << 16]
                          for i, c in enumerate(x))
                check(name, y, f"operand {j} a {kind}", name)
        # broadcast [256, 1] / [1, 64] / [256, 64] operands: not flat
        shapes = ((256, 1), (1, 64), (256, 64))
        y = tuple(c[:shapes[i % 3][0] * shapes[i % 3][1]].reshape(
            shapes[i % 3]) for i, c in enumerate(x))
        check(name, y, "broadcast", "fma[strided]" if name == "fma" else None)
    # the strided kernel over four dimensions, a transposed operand among
    # them, and a Python-float c
    a4 = cols[0][:3 * 5 * 7 * 9].reshape(3, 5, 7, 9).transpose(1, 2)
    b4 = cols[1][:5 * 9].reshape(1, 5, 1, 9).transpose(1, 2)
    check("fma", (a4, b4, 0.75), "strided 4-D", "fma[strided]")
    check("fma", (a4, b4, cols[2][0]), "strided 4-D, 0-d c", "fma[strided]")
    # the hero's light sampler, fma(-temp, temp, radius_sq): 2^19 lanes, c
    # a column of the contiguous [n, 8] light-row table (the strided kernel
    # over one dimension of stride 8); the last 2^19 lanes of the columns,
    # so the double-rounding triples and the specials are among them
    m = 1 << 19
    table = torch.stack([cols[2][-m:] if j == 4 else cols[j % 7][-m:]
                         for j in range(8)], 1)
    check("fma", (cols[0][-m:], cols[1][-m:], table[:, 4]),
          "2^19 lanes, c a column of an [n, 8] table", "fma[strided]")
    log(f"[2 fma] {len(FMA_FORMS)} flat forms on {n} lanes of 7 columns "
        f"(wide random floats, double-rounding triples, specials), aligned, "
        f"offset, ragged, with 0-d and Python-float operands and broadcast; "
        f"the strided kernel on 4-D operands and on 2^19 lanes with c a "
        f"column of an [n, 8] table: "
        + ("every one equal to its plain version" if not failures
           else str(failures)))
    if failures:
        raise AssertionError(f"an fma form disagrees with its plain version: "
                             f"{failures}")

    n = 1 << 19
    x = [c[:n].clone() for c in cols]
    rows, host_us = {}, {}
    for name in FMA_FORMS:
        kern, plain = forms[name]
        ops = tuple(x[:arity[name]]) if name != "fma[fma3]" else tuple(x)
        ms = timer(lambda: kern(ops), 20)
        plain_ms = timer(lambda: plain(ops), 5, warmup=1)
        rows[name] = fma_row(name, n, ms, plain_ms)
        small = tuple(c[:1024] for c in ops)
        host_us[name] = host_microseconds(torch, lambda: kern(small))
    # the strided form at the shape the hero path gives it: c a column of
    # the [2^19, 8] light-row table
    a2, b2 = x[0], x[1]
    c2 = torch.stack([x[j % 7] for j in range(8)], 1)[:, 4]
    ms = timer(lambda: kf.fma(a2, b2, c2), 20)
    plain_ms = timer(lambda: forms["fma"][1]((a2, b2, c2)), 5, warmup=1)
    rows["fma[strided]"] = fma_row("fma[strided]", n, ms, plain_ms,
                                   shape=f"n={n}, c a column of [{n}, 8]")
    host_us["fma[strided]"] = host_microseconds(
        torch, lambda: kf.fma(a2[:1024], b2[:1024], c2[:1024]))
    for name, row in rows.items():
        log(f"[2 {name}] 2^19 lanes: {row['ms']:.4f} ms (bound "
            f"{row['bound_ms']:.4f} ms by {row['bound_by']}; plain "
            f"{row['plain_ms']:.4f} ms); host {host_us[name]:.2f} us a call")
    return rows, host_us


def fma_row(name, n, ms, plain_ms, shape=None):
    reads, writes, flop = FMA_WORK[name]
    return kernel_row(name, FMA_SOURCE, shape or f"n={n}", None, 0.0, ms,
                      plain_ms, (reads + writes) * 4 * n, flop * n)


def host_microseconds(torch, fn, calls=2000):
    """Host time of one call of `fn`, over `calls` calls with no
    synchronize between them (the device runs behind)."""
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) * 1e6 / calls
    torch.cuda.synchronize()
    return us


@contextlib.contextmanager
def forced_split(ct, split):
    """The split walks at a given S of their split, not the wrapper's."""
    chosen = ct._stream_split
    ct._stream_split = lambda *args: split
    try:
        yield
    finally:
        ct._stream_split = chosen


def tie_pack(np, cp):
    """A triangle pack in which every prim meets exact ties, made from the
    pack `cp`: its cluster i becomes clusters 2i and 2i + 1 with its box;
    cluster 2i holds cluster i's first K/4 slots' prims, prim m in slots 2m,
    2m + 1, K/2 + 2m and K/2 + 2m + 1 (a tie across the S threads of a ray
    and within one thread), cluster 2i + 1 holds cluster 2i's slot
    (k + 1) mod K in slot k, at the same entry (a tie across two visits).
    Every copy has its own id. The rule: the first copy in (visit order,
    slot order) wins, which is slot 2m of cluster 2i."""
    from cpu_raytracing_experiments_tpu_torch.ops.clustered import \
        ClusteredPrims

    src = cp.to_numpy()
    k = src["cluster_size"]
    planes = src["planes"].reshape(-1, k, 12)
    rows = src["rows"].reshape(-1, k, src["rows"].shape[1])
    slot = (np.arange(k) % (k // 2)) // 2
    twin = slot[(np.arange(k) + 1) % k]
    pick = lambda a: np.stack([x for c in a for x in (c[slot], c[twin])])
    c2 = 2 * planes.shape[0]
    return ClusteredPrims.from_numpy({
        "rows": pick(rows).reshape(c2 * k, -1),
        "planes": pick(planes).reshape(c2 * k, 12),
        "order": np.arange(c2 * k, dtype=np.int32),
        "lo": np.repeat(src["lo"], 2, axis=0),
        "hi": np.repeat(src["hi"], 2, axis=0),
        "num_clusters": c2, "cluster_size": k, "kind": "triangle"},
        device=DEVICE)


def check_ties(torch, cp, rays, label, tile=CLUSTER_TILE):
    """The tie batch: both resident walks (the closest one with the
    ordinary and the product-form battery) and both streamed walks on the
    tie pack `cp` at every S of their split and at the wrapper's own,
    against the plain version, bit for bit, and every hit won by the first
    copy of its prim (slot 2m of the first cluster of a pair)."""
    from cpu_raytracing_experiments_tpu_torch.ops.kernels import \
        cluster_traverse as ct

    p, d, tf0, alive = rays
    n, k = tf0.shape[0], cp.cluster_size
    packed = ct._tables_packed(cp)
    plan = ct._plan_visits(cp, p, d, torch.where(alive, tf0, 0.0), alive,
                           tile)
    pt, pid = ct.walk_closest_plain(cp, *plan, p, d, tf0, alive, tile,
                                    packed=packed)
    rt, rid = ct.walk_closest(cp, *plan, p, d, tf0, alive, tile)
    mt, mid = ct.walk_closest_plain(cp, *plan, p, d, tf0, alive, tile,
                                    mxu=True)

    def first_copy(ids):
        hit = ids >= 0
        slot = ids[hit] % k
        return bool((((ids[hit] // k) % 2 == 0) & (slot < k // 2)
                     & (slot % 2 == 0)).all())

    hit = pid >= 0
    rule = first_copy(pid) and first_copy(mid)
    scale = torch.where(torch.arange(n, device=DEVICE) % 2 == 0, 1.001, 0.999)
    shadow_tf = torch.where(alive, torch.where(hit, pt * scale, tf0), 0.0)
    splan = ct._plan_visits(cp, p, d, shadow_tf, shadow_tf > 0, tile)
    po = ct.walk_occluded_plain(cp, *splan, p, d, shadow_tf, tile,
                                packed=packed)
    ro = ct.walk_occluded(cp, *splan, p, d, shadow_tf, tile)
    ok = {"resident equal to plain": _same_hits(torch, (rt, rid), (pt, pid))
          and torch.equal(ro, po), "first copy wins": rule}
    chosen = ct._stream_split(plan[0].shape[0], tile, torch.device(DEVICE))
    for split in SPLITS + (None,):
        with (forced_split(ct, split) if split else contextlib.nullcontext()):
            st, sid = ct.walk_closest(cp, *plan, p, d, tf0, alive, tile,
                                      stream=True)
            so = ct.walk_occluded(cp, *splan, p, d, shadow_tf, tile,
                                  stream=True)
            resident = ct.walk_closest(cp, *plan, p, d, tf0, alive, tile)
            product = ct.walk_closest(cp, *plan, p, d, tf0, alive, tile,
                                      mxu=True)
            ro = ct.walk_occluded(cp, *splan, p, d, shadow_tf, tile)
        ok[f"S={split or chosen}{'' if split else ' (chosen)'}"] = (
            _same_hits(torch, (st, sid), (pt, pid)) and torch.equal(so, po)
            and _same_hits(torch, resident, (pt, pid))
            and _same_hits(torch, product, (mt, mid))
            and torch.equal(ro, po))
    log(f"[{label}] tie pack C={cp.num_clusters} K={k}, R={n}: {int(hit.sum())}"
        f" hits, each on a prim with 3 more copies in its cluster and 4 in "
        f"the next; occluded {int(po.sum())}; {ok}")
    if not all(ok.values()):
        raise AssertionError(f"[{label}] the tie batch fails: {ok}")


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

    occ_pairs, warp_pairs = any_hit_pairs(torch, sb, p, d, tf, center,
                                          radius_sq)

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
        out[name] = row = kernel_row(
            name, KERNEL_SOURCE, f"R={n_rays} P={n_prims}", None,
            err if name == "sphere_closest" else 0.0, ms, plain_ms, nbytes,
            ops)
        extra = ""
        if name == "sphere_occluded":
            # the least work one ray a thread can do: a warp runs until its
            # slowest lane is done
            row["pairs"], row["warp_pairs"] = occ_pairs, warp_pairs
            row["warp_pairs_bound_ms"] = max(
                nbytes / HBM_BYTES_PER_S,
                warp_pairs * OCCLUDED_OPS_PER_PAIR / FP32_OPS_PER_S) * 1e3
            extra = (f"; pairs {occ_pairs}, warp pairs {warp_pairs}, "
                     f"bound by warp pairs {row['warp_pairs_bound_ms']:.4f} "
                     "ms")
        log(f"[{label}] {name}: {ms:.4f} ms (bound "
            f"{row['bound_ms']:.4f} ms by {row['bound_by']}; "
            f"plain {plain_ms:.4f} ms{extra})")
    return out


def any_hit_pairs(torch, sb, p, d, tf, center, radius_sq):
    """(pairs, warp pairs) of the any-hit battery on these rays: each ray's
    spheres up to and including its first occluder (the whole table where
    none occludes, none at tfar <= 0 or NaN), summed; and the sum over
    warps of 32 consecutive rays of 32 x the most pairs a lane of the warp
    needs, the least work one ray a thread can do."""
    n_rays, n_prims = tf.shape[0], radius_sq.shape[0]
    first = torch.full((n_rays,), n_prims, dtype=torch.int64,
                       device=tf.device)
    for start in range(0, n_prims, 256):
        end = min(start + 256, n_prims)
        pairs = sb._sphere_occluded_pairs(
            p, d, tf, center.x[start:end], center.y[start:end],
            center.z[start:end], radius_sq[start:end])
        idx = torch.where(pairs.any(1), pairs.int().argmax(1) + start,
                          n_prims)
        first = torch.minimum(first, idx)
    need = torch.where(tf > 0, torch.clamp_max(first + 1, n_prims), 0)
    warps = torch.nn.functional.pad(need, (0, -n_rays % 32)).view(-1, 32)
    return int(need.sum()), int(warps.max(1).values.sum()) * 32


def check_closest_tables(torch, np, hero, field):
    """sphere_closest against the plain version, bit for bit (t bits and
    ids): tables of 1, 9 (the hero's) and 1000 spheres (the 1000-sphere
    field), the hero's 9 with ties (spheres 5-8 are copies of 0-3), and
    1024 and 1025 spheres
    with ties across the staging chunk (the field and copies of its first
    24 or 25 spheres); tables of 5-8 and 517 spheres (the field's first),
    where the plain battery rounds b*b alone in the last 512-sphere chunk
    (fp.xla_fuses_sphere_bb); on 65,543 rays sliced at offsets 0-3 from a
    16-byte boundary, with 65,543 - offset - {0, 1, 2} rays (every n %
    4)."""
    from cpu_raytracing_experiments_tpu_torch.core.vec import Vec3
    from cpu_raytracing_experiments_tpu_torch.ops.kernels import \
        sphere_battery as sb

    def table(sph, idx):
        idx = torch.tensor(idx, device=DEVICE)
        return (Vec3(*(c[idx] for c in sph.center)), sph.radius_sq[idx])

    nf = field.radius_sq.shape[0]
    tables = {
        "1 sphere": table(hero, [0]),
        "9 spheres (hero)": table(hero, list(range(9))),
        "9 with ties": table(hero, [0, 1, 2, 3, 4, 0, 1, 2, 3]),
        "1000 spheres": table(field, list(range(nf))),
        "1024 with ties": table(field, list(range(nf)) + list(range(24))),
        "1025 with ties": table(field, list(range(nf)) + list(range(25))),
        **{f"{k} spheres (disc rounds b*b alone)": table(field, list(range(k)))
           for k in RESIDUAL_SPHERES + (517,)},
    }
    n = 65536 + 7
    failures, calls = [], 0
    for seed, (tname, (center, rsq)) in enumerate(tables.items()):
        p, d, _ = ray_batch(torch, np, center, rsq, n, 40 + seed)
        wt, wid = sb.intersect_spheres(p, d, center, rsq)
        hits = int((wid >= 0).sum())
        for off in range(4):
            for cut in range(3):
                m = n - off - cut
                lanes = slice(off, off + m)
                ps = Vec3(*(c[lanes] for c in p))
                ds = Vec3(*(c[lanes] for c in d))
                kt, kid = sb.closest_hit(ps, ds, center, rsq)
                calls += 1
                if not (torch.equal(kt.view(torch.int32),
                                    wt[lanes].view(torch.int32))
                        and torch.equal(kid, wid[lanes])):
                    failures.append((tname, off, m))
        log(f"[2 sphere_closest tables] {tname}: {n} rays, {hits} hits")
    log(f"[2 sphere_closest tables] {calls} launches over {len(tables)} "
        f"tables, ray offsets 0-3, n % 4 = 0-3: "
        + ("every one equal to the plain version" if not failures
           else str(failures)))
    if failures:
        raise AssertionError(f"sphere_closest disagrees with the plain "
                             f"version: {failures[:10]}")


def check_occluded_tables(torch, np, hero, field):
    """sphere_occluded against the plain version, bit for bit: tables of 1,
    9 (the hero's) and 1000 spheres (the field), and tables of 1024-1026
    spheres with one occluder at the edge of the 1024-sphere staging chunk
    (index 1023, 1024 or 1025; a ragged last chunk of 1 or 2 spheres) among
    fillers that lie 10^5 away, alone or after the field's 1000 spheres;
    on 65,543 rays sliced at offsets 0-3 from a 16-byte boundary, with
    65,543 - offset - {0, 1, 2} rays (every n % 4), shadow distances mixing
    hit distances, +inf, 0, -1 and NaN. Each edge table must have lanes
    that only its edge sphere occludes."""
    from cpu_raytracing_experiments_tpu_torch.core.vec import Vec3
    from cpu_raytracing_experiments_tpu_torch.ops.kernels import \
        sphere_battery as sb

    fc = torch.stack(list(field.center), 1)
    mid = (fc.min(0).values + fc.max(0).values) / 2
    span = float((fc.max(0).values - fc.min(0).values).max())

    def table(rows):
        c = torch.cat([r[0] for r in rows])
        return (Vec3(*(c[:, j].contiguous() for j in range(3))),
                torch.cat([r[1] for r in rows]).contiguous())

    def fillers(k):  # k unit spheres 10^5 from the field, along +y
        c = mid + torch.tensor([0.0, 1e5, 0.0], device=DEVICE)
        return (c.repeat(k, 1) + torch.arange(k, device=DEVICE)[:, None]
                * torch.tensor([3.0, 0.0, 0.0], device=DEVICE),
                torch.ones(k, device=DEVICE))

    edge = (mid[None], torch.tensor([(0.5 * span) ** 2], device=DEVICE))
    hc = torch.stack(list(hero.center), 1)
    tables = {
        "1 sphere": (table([(hc[:1], hero.radius_sq[:1])]), None),
        "9 spheres (hero)": (table([(hc, hero.radius_sq)]), None),
        "1000 spheres": (table([(fc, field.radius_sq)]), None),
        "1024, occluder at 1023": (table([fillers(1023), edge]), 1023),
        "1025, occluder at 1023": (table([fillers(1023), edge, fillers(1)]),
                                   1023),
        "1025, occluder at 1024": (table([fillers(1024), edge]), 1024),
        "1026, occluder at 1025": (table([fillers(1025), edge]), 1025),
        "field, 1025, occluder at 1024": (
            table([(fc, field.radius_sq), fillers(24), edge]), 1024),
    }
    n = 65536 + 7
    failures, calls = [], 0
    for seed, (tname, ((center, rsq), at)) in enumerate(tables.items()):
        sph = (hero if tname.endswith("(hero)") or tname == "1 sphere"
               else field)
        p, d, tf = ray_batch(torch, np, sph.center, sph.radius_sq, n,
                             60 + seed)
        # odd lanes stop just short of their closest hit on this table
        kt, kid = sb.intersect_spheres(p, d, center, rsq)
        tf = torch.where((torch.arange(n, device=DEVICE) % 2 == 1)
                         & (kid >= 0), kt * 0.999, tf)
        g = np.random.default_rng(80 + seed)
        tf[torch.tensor(g.random(n) < 0.05, device=DEVICE)] = float("nan")
        want = sb.occluded_spheres(p, d, tf, center, rsq)
        alone = 0
        if at is not None:
            keep = torch.arange(rsq.shape[0], device=DEVICE) != at
            without = sb.occluded_spheres(
                p, d, tf, Vec3(*(c[keep] for c in center)), rsq[keep])
            alone = int((want & ~without).sum())
            if alone == 0:
                failures.append((tname, "no lane that only the edge "
                                 "sphere occludes"))
        if bool(want[torch.isnan(tf) | (tf <= 0)].any()):
            failures.append((tname, "plain occludes a lane with tfar <= 0 "
                             "or NaN"))
        for off in range(4):
            for cut in range(3):
                m = n - off - cut
                lanes = slice(off, off + m)
                got = sb.any_hit(Vec3(*(c[lanes] for c in p)),
                                 Vec3(*(c[lanes] for c in d)), tf[lanes],
                                 center, rsq)
                calls += 1
                if not torch.equal(got, want[lanes]):
                    failures.append((tname, off, m))
        log(f"[2 sphere_occluded tables] {tname}: {n} rays, "
            f"{int(want.sum())} occluded"
            + (f", {alone} by sphere {at} alone" if at is not None else ""))
    log(f"[2 sphere_occluded tables] {calls} launches over {len(tables)} "
        f"tables, ray offsets 0-3, n % 4 = 0-3: "
        + ("every one equal to the plain version" if not failures
           else str(failures)))
    if failures:
        raise AssertionError(f"sphere_occluded disagrees with the plain "
                             f"version: {failures[:10]}")


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


def closest_splits(torch, timer, ct, want, label, name, walk):
    """A closest walk `walk()` at every S of its split against the plain
    version's `want` (tfar, id), bit for bit, and timed at each S; the
    times are logged. Returns whether every S agrees."""
    return _splits(timer, ct, lambda got: _same_hits(torch, got, want),
                   label, name, walk)


def occluded_splits(torch, timer, ct, want, label, name, walk, stream=None):
    """An any-hit walk `walk()` at every S of its split against the plain
    version's occlusion bits `want`, bit for bit, and, where `stream` gives
    the streamed walk on the same plan, against it at the same S; timed at
    each S. Returns whether every S agrees."""
    return _splits(timer, ct, lambda got: torch.equal(got, want) and (
        stream is None or torch.equal(got, stream())), label, name, walk)


def _splits(timer, ct, agrees, label, name, walk):
    ok, ms = {}, {}
    for s in SPLITS:
        with forced_split(ct, s):
            ok[s] = agrees(walk())
            ms[s] = timer(walk, 3, warmup=1)
    log(f"[{label}] {name} at S = 1, 2, 4: equal {ok}; ms "
        + ", ".join(f"S={s} {t:.4f}" for s, t in ms.items()))
    return all(ok.values())


def check_cluster_kernels(torch, np, timer, cp, rays, label,
                          tile=CLUSTER_TILE, stream=False, mxu=False,
                          time_plain_apart=True):
    """The cluster kernels against their plain versions on one table and one
    ray batch, and their numbers: the planner and the two resident walks,
    bit for bit, each walk at every S of its split (timed at each; with
    `stream` the resident any-hit walk also equal to the streamed one at
    each S); with `stream` also the two streamed walks, bit for bit
    against their plain version (the plain walk over tables unpacked from
    the packed layout) and against the resident kernels; with `mxu` also the
    walks with the product-form triangle battery, against their plain
    version (equal ids, occlusion bits and t bits) and against the
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
    ok_closest = ok_closest and closest_splits(
        torch, timer, ct, (pt, pid), label, "cluster_closest",
        lambda: ct.walk_closest(cp, pv, pe, pn, p, d, tf0, alive, tile))
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
    ok_occ = ok_occ and occluded_splits(
        torch, timer, ct, po, label, "cluster_occluded",
        lambda: ct.walk_occluded(cp, sv, se, sn, p, d, shadow_tf, tile),
        (lambda: ct.walk_occluded(cp, sv, se, sn, p, d, shadow_tf, tile,
                                  stream=True)) if stream else None)
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
            ray_bytes + c * 24 + tiles * (c * 8 + 4),
            int(alive.sum()) * c * SLAB_OPS, 0.0, "cluster_plan"),
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
    split = ct._stream_split(tiles, tile, torch.device(DEVICE))
    if stream:
        ok, sweep = {}, {}
        for s in SPLITS:
            # every S of the split, bit for bit; the wrapper takes `split`
            with forced_split(ct, s):
                st, sid = ct.walk_closest(cp, pv, pe, pn, p, d, tf0, alive,
                                          tile, stream=True)
                so = ct.walk_occluded(cp, sv, se, sn, p, d, shadow_tf, tile,
                                      stream=True)
                torch.cuda.synchronize()
                ok[s] = {"closest, plain": _same_hits(torch, (st, sid),
                                                      (pt, pid)),
                         "closest, resident": _same_hits(torch, (st, sid),
                                                         (kt, kid)),
                         "any-hit, plain": torch.equal(so, po),
                         "any-hit, resident": torch.equal(so, ko)}
                sweep[s] = (
                    timer(lambda: ct.walk_closest(
                        cp, pv, pe, pn, p, d, tf0, alive, tile, stream=True),
                        3, warmup=1),
                    timer(lambda: ct.walk_occluded(
                        cp, sv, se, sn, p, d, shadow_tf, tile, stream=True),
                        3, warmup=1))
        log(f"[{label}] streamed walks equal at S = 1, 2, 4 to: {ok}")
        log(f"[{label}] streamed walks at S = 1, 2, 4 (the wrapper takes S = "
            f"{split}): closest / any-hit ms " + ", ".join(
                f"S={s} {c:.4f} / {o:.4f}" for s, (c, o) in sweep.items()))
        if not all(all(v.values()) for v in ok.values()):
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
        ok_splits = closest_splits(
            torch, timer, ct, (qt, qid), label, "cluster_closest[mxu]",
            lambda: ct.walk_closest(cp, pv, pe, pn, p, d, tf0, alive, tile,
                                    mxu=True)) and occluded_splits(
            torch, timer, ct, qo, label, "cluster_occluded[mxu]",
            lambda: ct.walk_occluded(cp, sv, se, sn, p, d, shadow_tf, tile,
                                     mxu=True))
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
        if not (torch.equal(mid, qid) and torch.equal(mo, qo) and ulp == 0
                and ok_splits and unexplained == 0):
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
        if name != "cluster_plan":
            out[name]["split"] = split
        log(f"[{label}] {name}: {ms:.4f} ms (bound "
            f"{out[name]['bound_ms']:.4f} ms by {out[name]['bound_by']}; "
            f"plain {plain_ms:.2f} ms)")
    return out


def plan_bound(torch, ct, cp, rays, tile, mode, sorted_):
    """(bytes, operations) of one planner launch on these rays: each input
    read once, the entries (and under the sort the ids and nvis) written
    once; SLAB_OPS a slab test of a valid ray (a dead lane needs none),
    TILEBOX_OPS an interval test. 'super' counts the tests this run's data
    needs: every tile's valid rays against the S union boxes, and against
    the members of the unions it entered (counted by the plain version);
    'hybrid' the interval tests of its sign-coherent tiles and the slab
    tests of the others."""
    p, d, tf0, alive = rays
    n, c = tf0.shape[0], cp.num_clusters
    tiles = -(-n // tile)
    s = -(-c // ct.SUPER)
    boxes = {"group": 2 * c, "super": c + s}.get(mode, c)
    nbytes = n * (7 * 4 + 1) + boxes * 24 + tiles * c * (8 if sorted_ else 4)
    nbytes += tiles * 4 if sorted_ else 0
    tiled = ct._tiled(p, d, torch.where(alive, tf0, 0.0), alive, tile)
    valid = tiled[7].sum(dim=1)  # [T] valid rays a tile
    if mode == "super":
        entered = ct._tile_entry_rows(ct._super_slab_rows(cp), *tiled) \
            < ct.FLT_MAX
        members = torch.clamp(c - torch.arange(s, device=DEVICE) * ct.SUPER,
                              max=ct.SUPER)
        tests = int((valid * (s + (entered * members).sum(dim=1))).sum())
        return nbytes, tests * SLAB_OPS
    if mode in ("tilebox", "hybrid"):
        coherent = torch.ones_like(valid, dtype=torch.bool)
        if mode == "hybrid":
            ok, dx, dy, dz = tiled[7], tiled[3], tiled[4], tiled[5]
            coherent = (ct._sign_coherent(dx, ok) & ct._sign_coherent(dy, ok)
                        & ct._sign_coherent(dz, ok))[:, 0]
        return nbytes, (int(coherent.sum()) * c * TILEBOX_OPS + n * 14
                        + int(valid[~coherent].sum()) * c * SLAB_OPS)
    return nbytes, int(valid.sum()) * boxes * SLAB_OPS


def check_planners(torch, timer, cp, gcp, rays, label, tile=CLUSTER_TILE,
                   stats=False):
    """Phase 14 on one table and one ray batch: every planner mode of both
    kernels against its plain version, bit for bit (cluster_plan_rows' whole
    [T, C] matrix, also with its chunk patched to PATCHED_CHUNK clusters;
    cluster_plan's nvis and, below it, ids and entries), on the default pack
    `cp` and, for 'group', on the group-box pack `gcp`; 'super' equal to the
    flat plan; the tilebox and hybrid entries at most the flat entry of
    every cluster the flat plan enters. The flat plan's any-hit walk on each
    pack at every S against its plain version and the streamed walk. Then
    the walks fed by each planner against the walks fed by the flat plan on
    the same pack:
    equal occlusion, equal t bits, and equal ids except at lanes where the
    two winners lie in different clusters at exactly the same t. With
    `stats`, the clusters planned and walked (closest) per tile under each
    planner. Returns (kernel rows, per-planner numbers)."""
    from cpu_raytracing_experiments_tpu_torch.ops.kernels import \
        cluster_traverse as ct

    p, d, tf0, alive = rays
    n, c = tf0.shape[0], cp.num_clusters
    tiles = -(-n // tile)
    plan_tf = torch.where(alive, tf0, 0.0)
    args = lambda pack: (pack, p, d, plan_tf, alive, tile)
    pack_of = lambda mode: gcp if mode.startswith("group") else cp
    bad, rows, kernels = [], {}, {}
    for mode in ct.PLANS:
        got = ct.plan_rows(*args(pack_of(mode)), mode)
        want = ct.plan_rows_plain(*args(pack_of(mode)), mode)
        if not torch.equal(got, want):
            bad.append(f"cluster_plan_rows[{mode}] != plain "
                       f"({int((got != want).sum())} entries)")
        rows[mode] = got
        kernels[f"cluster_plan_rows[{mode}]"] = (
            lambda m=mode: ct.plan_rows(*args(pack_of(m)), m),
            lambda m=mode: ct.plan_rows_plain(*args(pack_of(m)), m),
            plan_bound(torch, ct, pack_of(mode), rays, tile, mode, False))
    # the sweep's chunk patched below the pack's C (chunks of three slots,
    # which straddle the union boxes of 'super'): the same matrices
    chunk_of = ct.plan_rows_chunk
    ct.plan_rows_chunk = lambda tile_r, c, n_super: PATCHED_CHUNK
    try:
        for mode in ct.PLANS:
            if not torch.equal(ct.plan_rows(*args(pack_of(mode)), mode),
                               rows[mode]):
                bad.append(f"cluster_plan_rows[{mode}] in chunks of "
                           f"{PATCHED_CHUNK} != in one")
    finally:
        ct.plan_rows_chunk = chunk_of
    flat = rows["ray"]
    entered = flat < ct.FLT_MAX
    if not torch.equal(rows["super"], flat):
        bad.append("cluster_plan_rows[super] != [ray]")
    for mode in ("tilebox", "hybrid"):
        if not bool((rows[mode][entered] <= flat[entered]).all()):
            bad.append(f"cluster_plan_rows[{mode}] is no superset")
    below = lambda v, nv: (torch.arange(v.shape[1], device=DEVICE)[None, :]
                           < nv[:, None])
    lists = {"ray": ct._plan_visits(*args(cp)),
             "ray on the group pack": ct._plan_visits(*args(gcp))}
    for mode in ("super", "group"):
        kv, ke, kn = ct._plan_visits(*args(pack_of(mode)), mode)
        pv, pe, pn = ct.plan_visits_plain(*args(pack_of(mode)), mode)
        m = below(pv, pn)
        if not (torch.equal(kn, pn) and torch.equal(kv[m], pv[m])
                and torch.equal(ke[m], pe[m])):
            bad.append(f"cluster_plan[{mode}] != plain")
        lists[mode] = (kv, ke, kn)
        kernels[f"cluster_plan[{mode}]"] = (
            lambda m=mode: ct._plan_visits(*args(pack_of(m)), m),
            lambda m=mode: ct.plan_visits_plain(*args(pack_of(m)), m),
            plan_bound(torch, ct, pack_of(mode), rays, tile, mode, True))
    (bv, be, bn), (sv, se, sn) = lists["ray"], lists["super"]
    m = below(bv, bn)
    if not (torch.equal(sn, bn) and torch.equal(sv[m], bv[m])
            and torch.equal(se[m], be[m])):
        bad.append("cluster_plan[super] != cluster_plan")
    del rows, flat, entered

    # the walks each planner feeds, against the flat plan's on that pack;
    # the flat plan's any-hit walk at every S against its plain version and
    # the streamed walk
    reference = {}
    for pack in (cp, gcp):
        visits = lists["ray" if pack is cp else "ray on the group pack"]
        t, i = ct.walk_closest(pack, *visits, p, d, tf0, alive, tile)
        scale = torch.where(torch.arange(n, device=DEVICE) % 2 == 0, 1.001,
                            0.999)
        shadow_tf = torch.where(alive, torch.where(i >= 0, t * scale, tf0),
                                0.0)
        splan = ct._plan_visits(pack, p, d, shadow_tf, shadow_tf > 0, tile)
        occ = ct.walk_occluded(pack, *splan, p, d, shadow_tf, tile)
        if not occluded_splits(
                torch, timer, ct, ct.walk_occluded_plain(
                    pack, *splan, p, d, shadow_tf, tile), label,
                f"cluster_occluded (C={pack.num_clusters})",
                lambda: ct.walk_occluded(pack, *splan, p, d, shadow_tf, tile),
                lambda: ct.walk_occluded(pack, *splan, p, d, shadow_tf, tile,
                                         stream=True)):
            bad.append(f"cluster_occluded on C={pack.num_clusters}")
        reference[id(pack)] = (t, i, shadow_tf, occ)
    numbers = {}
    for how, kw in (("ray", {}), ("super", {"plan": "super"}),
                    ("group", {"plan": "group"}),
                    ("tilebox", {"plan": "tilebox"}),
                    ("hybrid", {"plan": "hybrid"}),
                    ("xla-sort", {"sort_impl": "xla"}),
                    ("unsorted", {"sort": False})):
        pack = pack_of(how)
        rt, ri, shadow_tf, rocc = reference[id(pack)]
        visits = ct._plan_visits(*args(pack), **kw)
        t, i = ct.walk_closest(pack, *visits, p, d, tf0, alive, tile)
        occ = ct.walk_occluded(pack, *ct._plan_visits(
            pack, p, d, shadow_tf, shadow_tf > 0, tile, **kw), p, d,
            shadow_tf, tile)
        same_t = t.view(torch.int32) == rt.view(torch.int32)
        other = i != ri
        k = pack.cluster_size
        ties = other & same_t & (i >= 0) & (ri >= 0) & (i // k != ri // k)
        unexplained = int((~same_t | (other & ~ties)).sum())
        occ_differ = int((occ != rocc).sum())
        if unexplained or occ_differ:
            bad.append(f"walks under {how}: {unexplained} lanes differ from "
                       f"the flat plan's beyond exact ties, {occ_differ} "
                       "any-hit lanes differ")
        numbers[how] = {"planned": int(visits[2].sum()) / tiles,
                        "ties": int(ties.sum())}
        if stats:
            walked = {}
            ct.walk_closest_plain(pack, *visits, p, d, tf0, alive, tile,
                                  stats=walked)
            numbers[how]["walked"] = walked.get("visits", 0) / tiles
    log(f"[{label}] R={n} C={c} (group pack C={gcp.num_clusters}): "
        + "; ".join(f"{how} planned {v['planned']:.1f}"
                    + (f" walked {v['walked']:.1f}" if "walked" in v else "")
                    + f" ties {v['ties']}" for how, v in numbers.items()))
    if bad:
        raise AssertionError(f"[{label}] " + "; ".join(bad))

    out = {}
    shape = f"R={n} tile_r={tile} C={c} K={cp.cluster_size} {cp.kind}s"
    for name, (kern, plain, (nbytes, ops)) in kernels.items():
        ms = timer(kern, 5, warmup=1)
        plain_ms = timer(plain, 1, warmup=0)
        out[name] = kernel_row(name, CLUSTER_SOURCE, f"{shape}, {label}",
                               None, 0.0, ms, plain_ms, nbytes, ops)
        log(f"[{label}] {name}: {ms:.4f} ms (bound "
            f"{out[name]['bound_ms']:.4f} ms by {out[name]['bound_by']}; "
            f"plain {plain_ms:.2f} ms)")
    return out, numbers


def check_cluster_limit(torch, cp, gcp, rays, label, tile=CLUSTER_TILE):
    """A pack above max_plan_clusters: with the limit patched to one below
    the pack's C, the sorted plan of 'ray', 'super' and 'group' (the latter
    on the group-box pack `gcp`) launches cluster_plan_rows, not
    cluster_plan, and its nvis, and below nvis its ids and entries, equal
    cluster_plan's bit for bit."""
    from cpu_raytracing_experiments_tpu_torch.ops.kernels import build
    from cpu_raytracing_experiments_tpu_torch.ops.kernels import \
        cluster_traverse as ct

    p, d, tf0, alive = rays
    plan_tf = torch.where(alive, tf0, 0.0)
    limit = ct.max_plan_clusters
    ok = {}
    for mode, pack in (("ray", cp), ("super", cp), ("group", gcp)):
        kernel = {"ray": "cluster_plan"}.get(mode, f"cluster_plan[{mode}]")
        want = ct._plan_visits(pack, p, d, plan_tf, alive, tile, mode)
        build.reset_counts()
        ct.max_plan_clusters = lambda tile_r, c=pack.num_clusters: c - 1
        try:
            got = ct._plan_visits(pack, p, d, plan_tf, alive, tile, mode)
        finally:
            ct.max_plan_clusters = limit
        counts = build.launch_counts()
        below = (torch.arange(pack.num_clusters, device=DEVICE)[None, :]
                 < want[2][:, None])
        ok[mode] = (counts[f"cluster_plan_rows[{mode}]"] == 1
                    and counts[kernel] == 0
                    and torch.equal(got[2], want[2])
                    and torch.equal(got[0][below], want[0][below])
                    and torch.equal(got[1][below], want[1][below]))
    log(f"[{label}] C above the limit: cluster_plan_rows and the sort, "
        f"equal to cluster_plan's lists: {ok}")
    if not all(ok.values()):
        raise AssertionError(f"[{label}] the plan above the cluster limit "
                             "differs")


def planned_per_tile(r):
    """One more pass of renderer `r` with the planner wrapped: the clusters
    planned per tile over the pass's closest-hit and any-hit calls (nvis
    summed over every tile of every call, over the tiles)."""
    from cpu_raytracing_experiments_tpu_torch.ops.kernels import \
        cluster_traverse as ct

    real = (ct._plan_visits, ct.intersect_clustered_pallas,
            ct.occluded_clustered_pallas)
    counts = {"closest": [0, 0], "any-hit": [0, 0]}
    calling = []

    def plan(*args, **kw):
        visit, entry, nvis = real[0](*args, **kw)
        counts[calling[-1]][0] += int(nvis.sum())
        counts[calling[-1]][1] += nvis.numel()
        return visit, entry, nvis

    def wrap(fn, what):
        def call(*args, **kw):
            calling.append(what)
            try:
                return fn(*args, **kw)
            finally:
                calling.pop()
        return call

    ct._plan_visits = plan
    ct.intersect_clustered_pallas = wrap(real[1], "closest")
    ct.occluded_clustered_pallas = wrap(real[2], "any-hit")
    try:
        r.accumulate(1)
    finally:
        (ct._plan_visits, ct.intersect_clustered_pallas,
         ct.occluded_clustered_pallas) = real
    return {what: planned / max(1, tiles)
            for what, (planned, tiles) in counts.items()}


def walk_counts(torch, r):
    """One more pass of renderer `r` under a profiler session: the cluster
    walks' counters on its ``port.walk`` spans (``walk_pairs``,
    ``walk_visits``, ``walk_rays``), summed by walk form and kind, each
    with its spans' device ms and the least time of its pairs and rays at
    the card's peaks: what the benchmark's ``stream_walk_roofline_pct``
    reads (``portbench/walks.py``), and the profiler's device ms of the
    streamed walk kernels beside it."""
    from torch.profiler import ProfilerActivity, profile

    from cpu_raytracing_experiments_tpu_torch.utils import profiling
    from portbench import peaks, walks
    from portbench.metrics.stream_walk_ms_per_pass import STREAM

    profiling.clear()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        r.accumulate(1)
        torch.cuda.synchronize()
    recs = profiling.spans()
    profiling.clear()
    rows = {}
    for rec in recs:
        a = rec["attrs"]
        if rec["name"] != "port.walk" or "walk_pairs" not in rec["counts"]:
            continue
        row = rows.setdefault(f"{a['walk_form']} {a['walk_kind']}", {
            "calls": 0, "walk_pairs": 0, "walk_visits": 0, "walk_rays": 0,
            "span_ms": 0.0, "least_ms": 0.0})
        row["calls"] += 1
        for name in ("walk_pairs", "walk_visits", "walk_rays"):
            row[name] += rec["counts"][name]
        row["span_ms"] += rec["device_ms"] or 0.0
        row["least_ms"] += 1e3 * peaks.least_seconds(*walks.walk_call(
            a["walk_prims"], a["walk_kind"], rec["counts"]["walk_pairs"],
            rec["counts"]["walk_rays"]))
    kernel_ms = sum(ev.self_device_time_total for ev in prof.key_averages()
                    if STREAM.match(ev.key)) / 1e3
    log(f"walk counters, one traced pass: {json.dumps(rows)}; streamed "
        f"walk kernels {kernel_ms:.3f} device ms")
    if not rows:
        raise AssertionError("no port.walk span carried the walk counters")
    return {"walks": rows, "stream_kernel_ms": kernel_ms}


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
           idle=(), probe=None, profiled=True, windows=WINDOWS, watch=(),
           warmup=None):
    """Run `windows` timed windows of `passes` accumulation passes each
    through Renderer.accumulate, with the launch counts set to 0 just
    before the first and read just after the last; returns (image,
    numbers). ms/pass is the median window's; rays per pass are the port's
    ray_count summed over all timed passes. Every kernel named in `expect`
    must have been launched in those passes, and none named in `idle`.
    Then one profiled pass (unless not `profiled`; the device ms of the
    kernels whose names hold one of `watch` kept too); `probe(renderer)`,
    if given, runs after it and its result is kept under "probe". The
    warm-up pass runs inside the context manager `warmup` where given."""
    import numpy as np

    from cpu_raytracing_experiments_tpu_torch.ops.kernels import build

    r = crt.Renderer(scene, policy, width, height)
    with warmup if warmup is not None else contextlib.nullcontext():
        r.accumulate(1)  # warm-up pass
    r.reset_accumulator()
    torch.cuda.synchronize()
    build.reset_counts()
    window_ms = []
    for _ in range(windows):
        t0 = time.perf_counter()
        r.accumulate(passes)
        torch.cuda.synchronize()
        window_ms.append((time.perf_counter() - t0) * 1e3 / passes)
    launches = build.launch_counts()
    ms = sorted(window_ms)[windows // 2]
    rays = int(r.state.rays_traced) / (passes * windows)
    img = r.render(tonemap=False)
    if img.shape != (height, width, 3) or not np.isfinite(img).all():
        raise AssertionError(f"[{label}] bad image {img.shape}")
    log(f"[{label}] {width}x{height}: {ms:.2f} ms/pass (median of windows "
        f"{[round(m, 2) for m in window_ms]}), {rays} rays/pass (port "
        f"ray_count), {rays / ms / 1e3:.2f} Mrays/s; launches in "
        f"{passes * windows} passes {launches}; image mean "
        f"{float(img.mean()):.5f}")
    for name in expect:
        if launches[name] <= 0:
            raise AssertionError(f"[{label}] {name} was never launched")
    for name in idle:
        if launches[name] != 0:
            raise AssertionError(f"[{label}] {name} was launched "
                                 f"{launches[name]} times on this path")
    profile = profile_pass(torch, r, label, watch=watch) if profiled else None
    return img, {"ms_per_pass": ms, "rays_per_pass": rays,
                 "launches": launches, "profile": profile,
                 "probe": None if probe is None else probe(r)}


def profile_pass(torch, r, label, run=None, watch=()):
    """One more pass under torch.profiler (``r.accumulate(1)``, or `run()`
    where given): device busy time against the pass's wall time, the kernel
    launches of the pass (all, and those of the fma kernels by their
    counters and the profiler), the kernels that take the most device
    time, and the launches and device ms of the kernels whose names hold
    one of `watch`."""
    from torch.profiler import ProfilerActivity, profile

    from cpu_raytracing_experiments_tpu_torch.ops.kernels import build

    torch.cuda.synchronize()
    build.reset_counts()
    # device activity only: the busy time and launches read nothing else,
    # and recording every host op of a pass slows the pass and the reading
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        if run is None:
            r.accumulate(1)
        else:
            run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    fma_counts = {k: v for k, v in build.launch_counts().items()
                  if k.startswith("fma") and v}
    rows = [(ev.self_device_time_total, ev.count, ev.key)
            for ev in prof.key_averages()
            if ev.device_type == torch.autograd.DeviceType.CUDA
            and ev.self_device_time_total > 0]
    if not rows:
        log(f"[{label}] profiler: no device time recorded (not measured); "
            f"fma launches {sum(fma_counts.values())} {fma_counts}")
        return {"wall_ms": wall_ms, "busy_ms": None, "launches": None,
                "fma_launches": sum(fma_counts.values())}
    busy_ms = sum(us for us, _, _ in rows) / 1e3
    fma_rows = [(us, c) for us, c, key in rows
                if any(k in key for k in FMA_KERNELS)]
    log(f"[{label}] profiled pass: wall {wall_ms:.2f} ms, device busy "
        f"{busy_ms:.2f} ms ({100 * busy_ms / wall_ms:.1f}%), "
        f"{sum(c for _, c, _ in rows)} kernel launches; fma kernels "
        f"{sum(c for _, c in fma_rows)} launches, "
        f"{sum(us for us, _ in fma_rows) / 1e3:.3f} ms (counters: "
        f"{sum(fma_counts.values())} {fma_counts})")
    for us, count, key in sorted(rows, reverse=True)[:8]:
        log(f"    {us / 1e3:8.3f} ms  x{count:<5d} {key[:90]}")
    watched = {k: {"launches": sum(c for _, c, key in rows if k in key),
                   "device_ms": sum(us for us, _, key in rows
                                    if k in key) / 1e3} for k in watch}
    if watched:
        log(f"[{label}] profiled pass, watched kernels: {watched}")
    return {"wall_ms": wall_ms, "busy_ms": busy_ms,
            "launches": sum(c for _, c, _ in rows),
            "fma_launches": sum(fma_counts.values()),
            **({"watched": watched} if watched else {})}


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


def staged(label, fn, *args):
    """Run a stage of diag/stream2.py, its printed lines logged under
    `label`."""
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            return fn(*args)
    finally:
        for line in out.getvalue().splitlines():
            log(f"[{label}] {line}")


def check_stream2(torch, timer):
    """Phase 15: benchmarks/diag_stream2.py's path on the card, at the
    script's size, through the port's diag/stream2.py: its stages with the
    launch counts set to 0 before them and read after, then each kernel of
    the path against its plain version and the two launches timed. Returns
    the kernels' rows (stream_replay, the prefix launch of
    cluster_closest_stream) and the launch counts of the stages."""
    from cpu_raytracing_experiments_tpu_torch.diag import stream2 as s2
    from cpu_raytracing_experiments_tpu_torch.ops.kernels import build
    from cpu_raytracing_experiments_tpu_torch.ops.kernels import \
        cluster_traverse as ct

    t0 = time.perf_counter()
    cp, p, d = s2.build(DEVICE)
    n, c, k = p.x.shape[0], cp.num_clusters, cp.cluster_size
    tiles = -(-n // s2.TILE)
    device = torch.device(DEVICE)
    tf = torch.full((n,), s2.FLT_MAX, dtype=torch.float32, device=DEVICE)
    valid = torch.ones((n,), dtype=torch.bool, device=DEVICE)
    full_plan = ct._plan_visits(cp, p, d, tf, valid, s2.TILE)
    nvis_all = full_plan[2]
    busiest = int(torch.argmax(nvis_all))
    log(f"[15] diag_stream2's pack: {s2.P} triangles, C={c}, K={k}, {n} "
        f"rays in {tiles} tiles of {s2.TILE}, built in "
        f"{time.perf_counter() - t0:.1f} s; visits a tile: mean "
        f"{float(nvis_all.float().mean()):.1f}, most {int(nvis_all.max())} "
        f"(tile {busiest}); the walks' S: "
        f"{ct._stream_split(tiles, s2.TILE, device)} over all tiles, "
        f"{ct._stream_split(1, s2.TILE, device)} on one tile")

    # ---- the path: every stage through its entry point ----
    build.reset_counts()
    bad, _ = staged("15 repro", s2.full_repro, cp, p, d)
    chosen = (0, busiest)
    sub = {t: staged(f"15 repro tile {t}", s2.tile_repro, cp, p, d, t)
           for t in chosen}
    dmas = {t: staged(f"15 dma tile {t}", s2.dma, cp, p, d, t)
            for t in chosen}
    tr = staged(f"15 trace tile {busiest}", s2.trace, cp, p, d, busiest)
    t2 = {v: staged(f"15 trace2 tile {busiest}", s2.trace2, cp, p, d,
                    busiest, v) for v in s2.VARIANTS}
    torch.cuda.synchronize()
    counts = {k_: v for k_, v in build.launch_counts().items() if v}
    log(f"[15] launches of the stages: {counts}")
    need = ("cluster_plan", "cluster_closest", "cluster_closest_stream",
            "stream_replay")
    if min(counts.get(name, 0) for name in need) <= 0:
        raise AssertionError(f"[15] a kernel of the path never launched: "
                             f"{counts}")
    if bad or any(sub.values()):
        raise AssertionError(f"[15] the streamed walk differs from the "
                             f"resident: {bad} lanes, tiles {sub}")
    if any(r["bad"] or r["pad_nonzero"] for r in dmas.values()):
        raise AssertionError("[15] the replay's rows are not the packed "
                             "table's")
    if tr["first"] is not None:
        raise AssertionError(f"[15] the prefix walk parts from the plain "
                             f"replay at visit {tr['first']}")

    # ---- each kernel against its plain version ----
    failures = []
    pv, pe, pn = ct.plan_visits_plain(cp, p, d, tf, valid, s2.TILE)
    below = torch.arange(c, device=DEVICE)[None, :] < pn[:, None]
    if not (torch.equal(nvis_all, pn)
            and torch.equal(full_plan[0][below], pv[below])
            and torch.equal(full_plan[1][below].view(torch.int32),
                            pe[below].view(torch.int32))):
        failures.append("cluster_plan, every tile")
    del below
    for stream in (False, True):
        want = ct.walk_closest_plain(
            cp, *full_plan, p, d, tf, valid, s2.TILE,
            packed=ct._tables_packed(cp) if stream else None)
        got = ct.walk_closest(cp, *full_plan, p, d, tf, valid, s2.TILE,
                              stream=stream)
        if not _same_hits(torch, got, want):
            failures.append(("cluster_closest_stream" if stream
                             else "cluster_closest") + ", every ray")
    for t in chosen:
        visit, entry, nvis = dmas[t]["plan"]
        nv = int(nvis[0])
        want = ct.stream_replay_plain(cp, visit, nvis, 0)
        if not torch.equal(dmas[t]["out"].view(torch.int32),
                           want.view(torch.int32)):
            failures.append(f"stream_replay tile {t}")
        # the one-tile plan: the full plan's row, and the plain planner's
        ps, ds = s2.tile_rays(p, d, t)
        qv, qe, qn = ct.plan_visits_plain(cp, ps, ds, tf[:s2.TILE],
                                          valid[:s2.TILE], s2.TILE)
        row_ok = all(int(n_) == nv and torch.equal(v_[:nv], visit[0, :nv])
                     and torch.equal(e_[:nv].view(torch.int32),
                                     entry[0, :nv].view(torch.int32))
                     for v_, e_, n_ in ((full_plan[0][t], full_plan[1][t],
                                         nvis_all[t]), (qv[0], qe[0], qn[0])))
        if not row_ok:
            failures.append(f"one-tile plan of tile {t}")
    # the replay's partitions, on the full plan: tiles 0 and the busiest,
    # the tile with the fewest nonzero visits, a tile with an odd nv (the
    # busiest may be one), the busiest on the grid of a one-SM card (long
    # slices) and the fewest-visit tile into an output of 64 visits (a grid
    # larger than its list: blocks that own no visit)
    sms = build.sm_count(torch.cuda.current_device())
    fewest = int(torch.where(nvis_all > 0, nvis_all,
                             torch.iinfo(torch.int32).max).argmin())
    odd = [t for t in torch.nonzero(nvis_all % 2 == 1)[:, 0].tolist()
           if t not in (0, busiest, fewest)][:1]
    log(f"[15 stream_replay] blocks an SM at K={k} with its shared memory: "
        f"{ct.replay_occupancy(cp)}")
    for t, n_out, on in ([(t, None, None) for t in (0, busiest, fewest, *odd)]
                         + [(busiest, None, 1), (fewest, 64, None)]):
        nv = int(nvis_all[t])
        n_out = max(n_out or 0, ct.replay_visits(nv))
        want = ct.stream_replay_plain(cp, full_plan[0], nvis_all, t)
        got = ct.replay_launch(cp, full_plan[0], nvis_all, t, n_out, sms=on)
        ok = (torch.equal(got[:want.shape[0]].view(torch.int32),
                          want.view(torch.int32))
              and not bool(got[want.shape[0]:].any()))
        lengths = [b - a for a, b in ct.replay_slices(nv, on or sms)]
        log(f"[15 stream_replay] tile {t}: nv {nv}, n_out {n_out}, grid "
            f"{ct.replay_blocks(n_out, on or sms)} blocks ({on or sms} SMs), "
            f"{len(lengths)} of them own {min(lengths)}-{max(lengths)} "
            f"visits: equal to the plain version {ok}")
        if not ok:
            failures.append(f"stream_replay tile {t}, n_out {n_out}, "
                            f"{on or sms} SMs")
    ps, ds = s2.tile_rays(p, d, busiest)
    plan, nv = tr["plan"], tr["nv"]
    prefixes = sorted({m for m in (1, nv // 4, nv // 2, nv) if m > 0})
    for m in prefixes:
        got = s2.prefix_walk(cp, ps, ds, plan, m)
        want = s2.prefix_walk_plain(cp, ps, ds, plan, m)
        if not _same_hits(torch, got, want):
            failures.append(f"prefix walk m={m}")
    base = t2["full"]
    for v, out in t2.items():
        if not all(_same_hits(torch, out[m], base[m]) for m in out):
            failures.append(f"trace2 {v}")
    log(f"[15] cluster_plan and both closest walks on every ray, "
        f"stream_replay on tiles {chosen} (nv "
        f"{[dmas[t]['nv'] for t in chosen]}), the one-tile plans, the "
        f"prefix walk at m = {prefixes} of tile {busiest} and the trace2 "
        "variants: " + ("every one equal to its plain version"
                        if not failures else str(failures)))
    if failures:
        raise AssertionError(f"[15] {failures}")

    # ---- times ----
    visit, entry, nvis = dmas[busiest]["plan"]
    nv, f8 = dmas[busiest]["nv"], ct._stream_rows(cp.kind)
    n_out = ct.replay_visits(nv)
    packed = ct._tables_packed(cp)
    rows = (visit[0, :nv].to(torch.int64)[:, None] * f8
            + torch.arange(f8, device=DEVICE)).reshape(-1)
    ms = timer(lambda: ct.replay_launch(cp, visit, nvis, 0, n_out), 20)
    v0, _, n0 = dmas[0]["plan"]
    out0 = ct.replay_visits(dmas[0]["nv"])
    tile0_ms = timer(lambda: ct.replay_launch(cp, v0, n0, 0, out0), 20)
    plain_ms = timer(lambda: ct.stream_replay_plain(cp, visit, nvis, 0), 5,
                     warmup=1)
    library_ms = timer(lambda: packed.index_select(0, rows), 20)
    replay = kernel_row(
        "stream_replay", CLUSTER_SOURCE, f"{nv} x {f8} x {k} (tile "
        f"{busiest}, C={c})", counts["stream_replay"], 0.0, ms, plain_ms,
        2 * nv * f8 * k * 4, 0)
    replay["library_ms"] = library_ms
    replay["grid"] = ct.replay_blocks(n_out, sms)
    replay["tile0_ms"] = tile0_ms
    stats = {}
    tf0 = torch.full((ps.x.shape[0],), s2.FLT_MAX, dtype=torch.float32,
                     device=DEVICE)
    ok = torch.ones_like(tf0, dtype=torch.bool)
    ct.walk_closest_plain(cp, visit, entry, torch.clamp(nvis, max=nv), ps,
                          ds, tf0, ok, s2.TILE, stats=stats, packed=packed)
    walk_ms = timer(lambda: s2.prefix_walk(cp, ps, ds, plan, nv), 20)
    walk_plain_ms = timer(lambda: s2.prefix_walk_plain(cp, ps, ds, plan, nv),
                          2, warmup=0)
    r = ps.x.shape[0]
    prefix = kernel_row(
        "cluster_closest_stream[prefix]", CLUSTER_SOURCE,
        f"R={r} tile_r={s2.TILE} C={c} K={k} triangles, one tile, m=nv={nv}",
        counts["cluster_closest_stream"], 0.0, walk_ms, walk_plain_ms,
        r * (7 * 4 + 1) + r * 8 + nv * 8 + 4
        + stats.get("visits", 0) * k * 12 * 4,
        stats.get("pairs", 0) * TRI_CLOSEST_OPS)
    prefix["split"] = ct._stream_split(1, s2.TILE, device)
    for row in (replay, prefix):
        log(f"[15] {row['name']} {row['shape']}: {row['ms']:.4f} ms (bound "
            f"{row['bound_ms']:.4f} ms by {row['bound_by']}; plain "
            f"{row['plain_ms']:.4f} ms"
            + (f"; index_select of the rows {row['library_ms']:.4f} ms; "
               f"grid {row['grid']} blocks; tile 0 ({dmas[0]['nv']} visits) "
               f"{row['tile0_ms']:.4f} ms"
               if row["library_ms"] is not None else "") + ")")
    return {"stream_replay": replay, "cluster_closest_stream[prefix]": prefix}


# phase 16: (label, scene, policy knobs) of the shading paths
SHADING_PATHS = (
    ("hero principled f80", "hero", {"brdf": "principled",
                                     "shade_f80": True}),
    ("brdf_test ggx", "brdf_test", {"brdf": "ggx"}),
    ("hero dof stratify scramble", "dof", {
        "enable_dof": True, "stratify_camera": True, "rng_scramble": True}),
    ("hero spp2", "hero", {"samples_per_pixel": 2}),
)


def shading_scene(crt, kind, width, height):
    """The scene of a phase-16 path, on the host: the hero, the brdf_test
    roughness lineup, or the hero with the `dof` golden's camera
    (``builders.dof_scene``)."""
    builder = {"brdf_test": crt.builders.brdf_test_scene,
               "dof": crt.builders.dof_scene}.get(kind,
                                                   crt.builders.default_scene)
    return builder(width, height)


def check_shading_knobs(torch, np, crt):
    """Phase 16: (a) the four SHADING_PATHS at full width (1920x1088, 8
    bounces, 2^19-ray chunks, brute), one timed pass a window, each
    launching both sphere batteries and the fma kernel; (b) each at 64x64,
    6 bounces, 2 passes on the CPU (the plain versions) and on the card:
    buckets equal bit for bit, or else at tests/test_goldens.py::_check's
    bar with the differing entries counted; (c) the brdf_ggx and dof
    goldens on the card. Returns the numbers of (a) and (b)."""
    import hashlib

    expect = ("sphere_closest", "sphere_occluded", "fma")
    numbers = {}
    for label, kind, knobs in SHADING_PATHS:
        policy = crt.RendererPolicy(max_bounces=8, rays_per_chunk=1 << 19,
                                    **knobs)
        _, path = render(torch, crt, shading_scene(crt, kind, *FRAME),
                         policy, *FRAME, 1, f"16 {label}", expect)
        timed = WINDOWS
        fma = {k: v / timed for k, v in path["launches"].items()
               if k.startswith("fma") and v}
        prof = path["profile"]
        log(f"[16 {label}] a pass: {path['ms_per_pass']:.2f} ms, "
            f"{path['rays_per_pass'] / path['ms_per_pass'] / 1e3:.2f} "
            f"Mrays/s, busy {prof['busy_ms']} ms of {prof['wall_ms']:.2f}, "
            f"{prof['launches']} kernel launches, counted launches "
            f"{sum(path['launches'].values()) / timed:.1f}, fma launches "
            f"{sum(fma.values()):.1f} {fma}")
        numbers[label] = {"ms_per_pass": path["ms_per_pass"],
                          "rays_per_pass": path["rays_per_pass"],
                          "profile": prof, "fma_launches_a_pass": fma,
                          "launches": {k: v for k, v in
                                       path["launches"].items() if v}}
    for label, kind, knobs in SHADING_PATHS:
        policy = crt.RendererPolicy(max_bounces=6, rays_per_chunk=4096,
                                    **knobs)
        scene = shading_scene(crt, kind, 64, 64)
        renders = []
        for device in ("cpu", DEVICE):
            r = crt.Renderer(scene, policy, 64, 64, device=device)
            r.accumulate(2)
            renders.append(r)
        cpu, card = (r.state.buckets.cpu() for r in renders)
        differ = int((cpu.view(torch.int32) != card.view(torch.int32)).sum())
        digest = hashlib.sha256(card.numpy().tobytes()).hexdigest()[:16]
        log(f"[16 {label}] 64x64, 2 passes: card buckets {digest}, "
            f"{differ} of {card.numel()} entries differ from the CPU's")
        numbers[label]["cpu_card_differing"] = differ
        numbers[label]["buckets_sha256"] = digest
        if differ:
            golden_check(np, renders[1].render(tonemap=False),
                         f"{label} card vs cpu",
                         want=renders[0].render(tonemap=False))
    gpol = crt.RendererPolicy(max_bounces=6, rays_per_chunk=4096)
    for name, kind, knobs in (("brdf_ggx", "brdf_test", {"brdf": "ggx"}),
                              ("dof", "dof", {"enable_dof": True})):
        import dataclasses

        r = crt.Renderer(shading_scene(crt, kind, 64, 64),
                         dataclasses.replace(gpol, **knobs), 64, 64)
        r.accumulate(10)
        golden_check(np, r.render(tonemap=False), name)
    return numbers


# phase 17: the light-row reductions' counts of lights, held on 2^19 rows
# (up to 380 lights the kernel stages a warp's rows whole, rows padded where
# L is a multiple of 8; above that it streams them in column tiles of 64)
LIGHT_ROWS_L = (1, 3, 8, 16, 17, 18, 31, 32, 33, 64, 326, 376, 380, 381, 512,
                1000, 4096, 10817)
LIGHT_ROWS_N = 1 << 19
LIGHT_ROWS_TIMED = (326, 10817)  # the kernel's ms at these counts
# (label, scene, frame, bounces, policy knobs, kernels launched); the
# scenes: benchmarks/many_lights.py:30-33 (10,817 lights), the 326-light
# scene of benchmarks/convergence_restir_2d.py:32-35, the hero under
# sky_models.clear_sky() (the JAX CLI's --sky clear)
BRUTE = ("sphere_closest", "sphere_occluded", "fma")
LIGHT_PATHS = (
    ("many lights uniform", "many", (256, 256), 6, {}, BRUTE),
    ("many lights alias", "many", (256, 256), 6, {"light_sampling": "alias"},
     BRUTE),
    ("many lights alias pallas", "many", (256, 256), 6,
     {"light_sampling": "alias", "accel": "pallas"},
     ("cluster_plan", "cluster_closest", "cluster_occluded", "fma")),
    ("326 lights uniform", "field", (192, 192), 6, {}, BRUTE),
    ("326 lights power", "field", (192, 192), 6, {"light_sampling": "power"},
     BRUTE + ("light_rows",)),
    ("326 lights ris", "field", (192, 192), 6, {"light_sampling": "ris"},
     BRUTE),
    ("326 lights restir", "field", (192, 192), 6,
     {"light_sampling": "restir"}, BRUTE),
    ("326 lights restir 1-D", "field", (192, 192), 6,
     {"light_sampling": "restir", "restir_spatial_2d": False}, BRUTE),
    ("326 lights restir spp2", "field", (192, 192), 6,
     {"light_sampling": "restir", "samples_per_pixel": 2}, BRUTE),
    ("hero clear sky", "hero sky", FRAME, 8, {"rays_per_chunk": 1 << 19},
     BRUTE),
)


def light_scene(crt, kind, width, height):
    """A phase-17 scene on the host."""
    from cpu_raytracing_experiments_tpu_torch.scene.scene import Sky

    if kind == "many":
        scene = crt.builders.random_spheres_scene(
            width, height, num_spheres=12000, emissive_fraction=0.9, seed=99)
        return crt.accel.with_pallas_clusters(scene)
    if kind == "field":
        return crt.builders.random_spheres_scene(
            width, height, num_spheres=1000, emissive_fraction=0.3, seed=77)
    import dataclasses

    return dataclasses.replace(
        crt.builders.default_scene(width, height),
        sky=Sky.from_image(crt.sky_models.clear_sky(), ambient=(1, 1, 1)))


def check_light_rows(torch, timer):
    """Phase 17 (a): the light_rows kernel against its plain version, bit
    for bit, on 2^19 rows at every count of LIGHT_ROWS_L: the selection
    (half the draws on an entry of the running sum) and the sum alone, in
    both orders up to 32 lights. Random weights (a cube of uniforms, a
    tenth zero) from a seed on the card; the plain version runs on slices
    of rows. Returns the kernels-line row at 2^19 x 326, with the times at
    10,817 lights beside it."""
    from cpu_raytracing_experiments_tpu_torch.core import fp
    from cpu_raytracing_experiments_tpu_torch.ops.kernels import \
        light_rows as lr

    n = LIGHT_ROWS_N
    gen = torch.Generator(device=DEVICE).manual_seed(17)
    timed = {}
    for lights in LIGHT_ROWS_L:
        step = max(1, (1 << 28) // lights)  # rows of a 1 GiB slice
        slices = [slice(a, min(a + step, n)) for a in range(0, n, step)]
        w = torch.empty((n, lights), dtype=torch.float32, device=DEVICE)
        for sl in slices:
            part = w[sl]
            part.copy_(torch.rand(part.shape, generator=gen, device=DEVICE)
                       ** 3)
            part.masked_fill_(torch.rand(part.shape, generator=gen,
                                         device=DEVICE) < 0.1, 0.0)
        f = torch.rand(n, generator=gen, device=DEVICE)
        pick = torch.randint(0, lights, (n, 1), generator=gen, device=DEVICE)
        on = torch.rand(n, generator=gen, device=DEVICE) < 0.5
        for sl in slices:
            total = fp.row_sum(w[sl])
            entry = fp.row_cumsum(w[sl]).gather(1, pick[sl])[:, 0]
            f[sl] = torch.where(on[sl] & (total > 0),
                                (entry.double() / total.double()).float(),
                                f[sl])
        modes = [(f, False), (None, False)] + (
            [(None, True)] if lights <= 32 else [])
        for draws, fused in modes:
            got = lr.light_rows(w, draws, fused)
            torch.cuda.synchronize()
            differ = 0
            for sl in slices:
                want = lr.rows_plain(w[sl], None if draws is None
                                     else draws[sl], fused)
                for a, b in zip(got, want):
                    if b is not None:
                        differ += int((a[sl].view(torch.int32)
                                       != b.view(torch.int32)).sum())
            log(f"[17 light_rows] {n} x {lights}, "
                f"{'selection' if draws is not None else 'sum'}"
                f"{', fused order' if fused else ''}: {differ} entries "
                f"differ from the plain version")
            if differ:
                raise AssertionError(f"light_rows differs at {lights} lights")
        if lights in LIGHT_ROWS_TIMED:
            ms = timer(lambda: lr.light_rows(w, f), 5)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for sl in slices:
                lr.rows_plain(w[sl], f[sl])
            torch.cuda.synchronize()
            plain_ms = (time.perf_counter() - t0) * 1e3
            ref_ms = (timer(lambda: torch.cumsum(w, dim=1), 3)
                      if len(slices) == 1 else None)
            timed[lights] = kernel_row(
                "light_rows", LIGHT_ROWS_SOURCE, f"{n} x {lights}", 0, 0.0,
                ms, plain_ms, n * lights * 4 + n * 16, 3 * n * lights)
            log(f"[17 light_rows] {n} x {lights}: {ms:.4f} ms (bound "
                f"{timed[lights]['bound_ms']:.4f} ms by bytes); plain "
                f"{plain_ms:.2f} ms in {len(slices)} slice(s); torch.cumsum "
                f"of the rows alone {ref_ms} ms")
        del w
        torch.cuda.empty_cache()
    main, big = (timed[k] for k in LIGHT_ROWS_TIMED)
    main["at_10817_lights"] = {k: big[k] for k in ("shape", "ms", "plain_ms",
                                                   "bound_ms")}
    return main


POWER_FULL = ("326 lights power 1920x1088", "field", FRAME, 6,
              {"light_sampling": "power", "rays_per_chunk": 1 << 19})


def check_power_full(torch, crt):
    """Phase 17 (d): the slice's path at full width: the 326-light scene
    under 'power' at 1920x1088, one timed pass after a warm-up (the launch
    counts from 0 around it), then one profiled pass: light_rows' launches
    and device ms beside the pass's busy time."""
    label, kind, (width, height), bounces, knobs = POWER_FULL
    scene = light_scene(crt, kind, width, height)
    policy = crt.RendererPolicy(max_bounces=bounces, **knobs)
    _, path = render(torch, crt, scene, policy, width, height, 1,
                     f"17 {label}", BRUTE + ("light_rows",), windows=1,
                     watch=("light_rows_kernel",))
    prof = path["profile"]
    numbers = {"ms_per_pass": path["ms_per_pass"],
               "rays_per_pass": path["rays_per_pass"], "profile": prof,
               "lights": scene.num_lights,
               "launches": {k: v for k, v in path["launches"].items() if v}}
    log(f"[17 {label}] {path['ms_per_pass']:.2f} ms/pass, light_rows "
        f"{path['launches']['light_rows']} launches a pass; profiled pass: "
        f"busy {prof['busy_ms']} ms of {prof['wall_ms']:.2f}, light_rows "
        f"{prof.get('watched')}")
    del scene
    torch.cuda.empty_cache()
    return numbers


def check_light_modes(torch, np, crt):
    """Phase 17 (b)-(c): every LIGHT_PATHS path at its full width, one
    timed pass a window (render(): launches from 0, expected kernels,
    light_rows idle but under 'power'), its peak device memory (also above
    what the process held before the path); then each at
    64x64 on the CPU and on the card, 2 passes (3 under 'restir', 1 on the
    12,000-sphere scene): buckets, and under 'restir' the reservoirs, equal
    bit for bit. Returns the numbers of each path."""
    import hashlib

    numbers = {}
    for label, kind, (width, height), bounces, knobs, expect in LIGHT_PATHS:
        policy = crt.RendererPolicy(max_bounces=bounces, **knobs)
        scene = light_scene(crt, kind, width, height)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated() / 2 ** 20  # earlier phases'
        idle = () if "light_rows" in expect else ("light_rows",)
        _, path = render(torch, crt, scene, policy, width, height, 1,
                         f"17 {label}", expect, idle)
        peak = torch.cuda.max_memory_allocated() / 2 ** 20
        prof = path["profile"]
        log(f"[17 {label}] {width}x{height}, {scene.num_lights} lights: "
            f"{path['ms_per_pass']:.2f} ms/pass, busy {prof['busy_ms']} ms of "
            f"{prof['wall_ms']:.2f}, {prof['launches']} kernel launches, "
            f"light_rows {path['launches']['light_rows'] / WINDOWS:.1f} a "
            f"pass, peak {peak:.1f} MiB, {peak - held:.1f} MiB above the "
            f"{held:.1f} MiB held before the path")
        numbers[label] = {"ms_per_pass": path["ms_per_pass"],
                          "rays_per_pass": path["rays_per_pass"],
                          "profile": prof, "peak_mib": peak,
                          "peak_above_held_mib": peak - held,
                          "lights": scene.num_lights,
                          "launches": {k: v for k, v in
                                       path["launches"].items() if v}}
        del scene
        torch.cuda.empty_cache()
    for label, kind, _, bounces, knobs, _ in LIGHT_PATHS:
        policy = crt.RendererPolicy(max_bounces=bounces, **{
            **knobs, "rays_per_chunk": 4096})
        scene = light_scene(crt, kind, 64, 64)
        # the 12,000-sphere scene's plain batteries take ~17 s a pass on
        # the host: one pass there
        passes = (3 if policy.light_sampling == "restir"
                  else 1 if kind == "many" else 2)
        renders = []
        for device in ("cpu", DEVICE):
            r = crt.Renderer(scene, policy, 64, 64, device=device)
            r.accumulate(passes)
            renders.append(r)
        cpu, card = (r.state.buckets.cpu() for r in renders)
        differ = int((cpu.view(torch.int32) != card.view(torch.int32)).sum())
        res_differ = 0
        if policy.light_sampling == "restir":
            a, b = (r.state.reservoir.cpu() for r in renders)
            res_differ = int((a.view(torch.int32) != b.view(torch.int32))
                             .sum())
        digest = hashlib.sha256(card.numpy().tobytes()).hexdigest()[:16]
        log(f"[17 {label}] 64x64, {passes} passes: card buckets {digest}, "
            f"{differ} of {card.numel()} entries differ from the CPU's; "
            f"reservoir entries differing {res_differ}")
        numbers[label].update(cpu_card_differing=differ,
                              reservoir_differing=res_differ,
                              buckets_sha256=digest)
        if differ or res_differ:
            raise AssertionError(f"[17 {label}] the card differs from the CPU")
    return numbers


# phase 18: the host features around a render (adaptive sampling,
# checkpoint / resume, AOVs, AO, the denoiser, the NaN guard, scene edits).
# The full-width adaptive render takes benchmarks/adaptive.py:63's settings;
# at 64x64 the tolerance makes the 4096 and 2048 tiers run
ADAPTIVE_FULL = {"tol": 0.08, "max_spp": 50, "warmup": 25}
ADAPTIVE_SMALL = {"tol": 0.04, "max_spp": 30, "warmup": 10}
DENOISE_RTOL, DENOISE_ATOL = 1e-5, 1e-6  # tests/test_torch_probes.py's


@contextlib.contextmanager
def tiers_run():
    """Record (tier, rounds) of every adaptive tier the block runs
    (render/api.py::_adaptive_tier)."""
    from cpu_raytracing_experiments_tpu_torch.render import api

    run, tier = [], api._adaptive_tier

    def recorded(*args):
        out = tier(*args)
        run.append((args[6], out[3]))
        return out

    api._adaptive_tier = recorded
    try:
        yield run
    finally:
        api._adaptive_tier = tier


def equal_bits(torch, a, b) -> bool:
    """Equal shapes and every element's bits equal (on the host)."""
    a, b = a.cpu(), b.cpu()
    return a.shape == b.shape and torch.equal(a.view(torch.int32),
                                              b.view(torch.int32))


def counted(torch, label, expect, fn, *args, **kwargs):
    """fn(*args, **kwargs) with the launch counts set to 0 just before and
    read just after; every kernel of `expect` must have been launched.
    Returns (result, wall s, launches of the kernels launched, peak MiB
    above what the process held before)."""
    from cpu_raytracing_experiments_tpu_torch.ops.kernels import build

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    build.reset_counts()
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: v for k, v in build.launch_counts().items() if v}
    peak = (torch.cuda.max_memory_allocated() - held) / 2 ** 20
    for name in expect:
        if launches.get(name, 0) <= 0:
            raise AssertionError(f"[18 {label}] {name} was never launched")
    log(f"[18 {label}] {wall:.2f} s, peak {peak:.1f} MiB above the "
        f"{held / 2 ** 20:.1f} MiB held before, launches {launches}")
    return out, wall, launches, peak


def check_host_paths(torch, np, crt):
    """Phase 18: (a) render_adaptive on the hero at 1920x1088 (8 bounces,
    ADAPTIVE_FULL), both sphere batteries launched, and at 64x64
    (ADAPTIVE_SMALL, two tier sizes) card against CPU: buckets and counts
    bit for bit; (b) checkpoint resume on the card: accumulate(10) against
    accumulate(5) + save + load into a fresh Renderer + accumulate(5) at
    1920x1088, the same after an adaptive round (counts in the file) and
    under 'restir' on phase 17's 326-light scene at 192x192 (reservoirs in
    the file); (c) render_aovs(samples=4) and render_ao(samples=32) at
    1920x1088, and at 64x64 card against CPU bit for bit; denoise_render of
    a 25-pass hero at 64x64 card against CPU within the CPU test's
    tolerance; check_render on the hero at full width, and on the
    NaN-albedo scene of tests/test_validate.py, where the card names the
    CPU's first bad pixel; (d) a SceneEditor edit on the card (a sphere
    moved and made emissive, committed): the accumulator resets and the next
    64x64 passes equal those of a scene built with the edit from the start.
    Returns the numbers."""
    import dataclasses
    import tempfile

    from cpu_raytracing_experiments_tpu_torch.render import (ao, checkpoint,
                                                             denoise, probes,
                                                             validate)
    from cpu_raytracing_experiments_tpu_torch.scene import edit
    from cpu_raytracing_experiments_tpu_torch.scene.scene import (
        Scene, build_light_list, light_alias_arrays)

    pol = crt.RendererPolicy
    sphere_kernels = ("sphere_closest", "sphere_occluded")
    numbers = {}
    hero = crt.builders.default_scene(*FRAME)
    policy = pol(max_bounces=8, rays_per_chunk=1 << 19)

    # (a) adaptive sampling
    r = crt.Renderer(hero, policy, *FRAME)
    with tiers_run() as run:
        (img, stats), wall, launches, peak = counted(
            torch, "adaptive 1920x1088", sphere_kernels, r.render_adaptive,
            **ADAPTIVE_FULL)
    if img.shape != (FRAME[1], FRAME[0], 3) or not np.isfinite(img).all():
        raise AssertionError("[18 adaptive] bad image")
    log(f"[18 adaptive 1920x1088] {ADAPTIVE_FULL}: stats {stats}, tiers "
        f"(size, rounds) {run}, {r.state.accumulations} passes")
    numbers["adaptive 1920x1088"] = {
        "settings": ADAPTIVE_FULL, "wall_s": wall, "stats": stats,
        "tiers": run, "rounds": sum(k for _, k in run),
        "launches": {k: launches[k] for k in sphere_kernels},
        "launches_all": sum(launches.values()), "peak_mib": peak}
    del r
    small = crt.builders.default_scene(64, 64)
    spol = pol(max_bounces=6, rays_per_chunk=4096)
    renders = []
    for device in ("cpu", DEVICE):
        r = crt.Renderer(small, spol, 64, 64, device=device)
        with tiers_run() as run:
            _, small_stats = r.render_adaptive(**ADAPTIVE_SMALL)
        renders.append((r, run))
    (cpu, cpu_run), (card, card_run) = renders
    same = (equal_bits(torch, cpu.state.buckets, card.state.buckets)
            and equal_bits(torch, cpu.state.counts, card.state.counts))
    sizes = sorted({t for t, k in card_run if k})
    log(f"[18 adaptive 64x64] {ADAPTIVE_SMALL}: tiers card {card_run}, cpu "
        f"{cpu_run}; buckets and counts equal the CPU's bit for bit: {same}")
    if not same or card_run != cpu_run or len(sizes) < 2:
        raise AssertionError("[18 adaptive 64x64] the card differs from the "
                             "CPU or fewer than two tier sizes ran")
    numbers["adaptive 64x64"] = {"tiers": card_run, "stats": small_stats,
                                 "cpu_card_equal": same}

    # (b) checkpoint / resume on the card
    with tempfile.TemporaryDirectory(dir=ROOT) as tmp:
        path = Path(tmp) / "state.npz"

        def resumed(scene, p, width, height, first, then, label):
            whole = crt.Renderer(scene, p, width, height)
            first(whole)
            then(whole)
            part = crt.Renderer(scene, p, width, height)
            first(part)
            checkpoint.save(path, part.state, p, width, height)
            again = crt.Renderer(scene, p, width, height)
            again.state = checkpoint.load(path, p, width, height)
            then(again)
            ok = all(
                (a is None and b is None) or equal_bits(torch, a, b)
                for a, b in ((whole.state.buckets, again.state.buckets),
                             (whole.state.counts, again.state.counts),
                             (whole.state.reservoir, again.state.reservoir)))
            ok = ok and whole.state.accumulations == again.state.accumulations
            log(f"[18 checkpoint {label}] resumed equals uninterrupted bit "
                f"for bit: {ok} (file {path.stat().st_size / 2 ** 20:.1f} "
                f"MiB)")
            if not ok:
                raise AssertionError(f"[18 checkpoint {label}] resume differs")
            return ok

        t0 = time.perf_counter()
        ckpt = {
            "1920x1088": resumed(hero, policy, *FRAME,
                                 lambda x: x.accumulate(5),
                                 lambda x: x.accumulate(5), "1920x1088"),
            "1920x1088 counts": resumed(
                hero, policy, *FRAME,
                lambda x: x.render_adaptive(tol=0.08, max_spp=10, warmup=5),
                lambda x: x.accumulate(5), "1920x1088 counts"),
            "326 lights restir 192x192": resumed(
                light_scene(crt, "field", 192, 192),
                pol(max_bounces=6, light_sampling="restir"), 192, 192,
                lambda x: x.accumulate(3), lambda x: x.accumulate(3),
                "326 lights restir 192x192")}
        numbers["checkpoint"] = {"resumed_equal": ckpt,
                                 "wall_s": time.perf_counter() - t0}

    # (c) AOVs, AO, the denoiser, the NaN guard
    card_hero = hero.to(DEVICE)
    aovs, wall, launches, peak = counted(
        torch, "aovs 1920x1088 samples=4", ("sphere_closest",),
        probes.render_aovs, card_hero, policy, *FRAME, samples=4)
    numbers["aovs 1920x1088"] = {"wall_s": wall, "launches": launches,
                                 "peak_mib": peak}
    img, wall, launches, peak = counted(
        torch, "ao 1920x1088 samples=32", sphere_kernels, ao.render_ao,
        card_hero, policy, *FRAME, samples=32)
    if not (np.isfinite(img).all() and img.max() == 1.0 and img.min() < 1.0):
        raise AssertionError("[18 ao] bad image")
    numbers["ao 1920x1088"] = {"wall_s": wall, "launches": launches,
                               "peak_mib": peak}
    del card_hero
    small_pol = pol(max_bounces=6, rays_per_chunk=4096)
    got = [probes.render_aovs(small.to(dev), small_pol, 64, 64, samples=4)
           for dev in ("cpu", DEVICE)]
    aov_same = all(np.array_equal(got[0][k], got[1][k]) for k in got[0])
    ao_imgs = [ao.render_ao(small.to(dev), small_pol, 64, 64, samples=32)
               for dev in ("cpu", DEVICE)]
    ao_same = np.array_equal(ao_imgs[0].view(np.int32),
                             ao_imgs[1].view(np.int32))
    den = []
    for dev in ("cpu", DEVICE):
        r = crt.Renderer(small, small_pol, 64, 64, device=dev)
        r.accumulate(25)
        den.append([denoise.denoise_render(r),
                    denoise.denoise_render(r, variance_guided=True,
                                           sigma_l=25.0)])
    den_err = max(float(np.max(np.abs(a - b))) for a, b in zip(*den))
    den_ok = all(np.allclose(a, b, rtol=DENOISE_RTOL, atol=DENOISE_ATOL)
                 for a, b in zip(*den))
    log(f"[18 64x64] card against CPU: AOVs (samples=4) equal bit for bit "
        f"{aov_same}, AO (samples=32) {ao_same}; denoise_render (fixed, "
        f"guided) within rtol {DENOISE_RTOL} / atol {DENOISE_ATOL}: {den_ok} "
        f"(max |diff| {den_err:.3g})")
    if not (aov_same and ao_same and den_ok):
        raise AssertionError("[18 64x64] the card differs from the CPU")
    numbers["64x64 card vs cpu"] = {"aovs_equal": aov_same,
                                    "ao_equal": ao_same,
                                    "denoise_max_abs_diff": den_err}
    rad, wall, _, _ = counted(torch, "check_render 1920x1088",
                              sphere_kernels, validate.check_render,
                              hero.to(DEVICE), policy, *FRAME)
    vpol = pol(max_bounces=4, rays_per_chunk=1024)
    nan_scene = crt.builders.default_scene(16, 16)
    albedo = nan_scene.materials.albedo
    x = albedo.x.clone()
    x[0] = float("nan")  # material 0 = the floor (tests/test_validate.py)
    nan_scene = dataclasses.replace(nan_scene, materials=dataclasses.replace(
        nan_scene.materials, albedo=type(albedo)(x, albedo.y, albedo.z)))
    messages = []
    for dev in ("cpu", DEVICE):
        try:
            validate.check_render(nan_scene.to(dev), vpol, 16, 16)
            messages.append(None)
        except FloatingPointError as err:
            messages.append(str(err))
    log(f"[18 check_render] the hero at 1920x1088 passes ({wall:.2f} s); "
        f"the NaN-albedo scene raises on the CPU {messages[0]!r} and on the "
        f"card {messages[1]!r}")
    if messages[1] is None or messages[1] != messages[0]:
        raise AssertionError("[18 check_render] the card's guard differs")
    numbers["check_render"] = {"hero_wall_s": wall, "nan_scene": messages[1]}

    # (d) a scene edit on the card
    light_mat = int(small.spheres.material_id[int(small.lights[0])])
    k = 6  # a small diffuse sphere of the hero
    if k in small.lights.tolist():
        raise AssertionError("[18 edit] the edited sphere is a light")
    pos = tuple(float(c[k]) + 0.05 for c in small.spheres.center)
    r = crt.Renderer(small, small_pol, 64, 64)
    r.accumulate(2)
    editor = edit.SceneEditor(r)
    editor.edit(edit.set_sphere, k, position=pos, material_id=light_mat)
    editor.commit()
    reset = r.state.accumulations == 0
    r.accumulate(2)
    arrays = small.to_numpy()
    arrays["sphere_center"][k] = pos
    arrays["sphere_material_id"][k] = light_mat
    arrays["lights"] = build_light_list(arrays["sphere_material_id"],
                                        arrays["material_emission"])
    arrays.update(light_alias_arrays(arrays))
    built = crt.Renderer(Scene.from_numpy(arrays), small_pol, 64, 64)
    built.accumulate(2)
    edit_same = equal_bits(torch, r.state.buckets, built.state.buckets)
    log(f"[18 edit] sphere {k} moved and made emissive on the card: "
        f"accumulator reset {reset}, {r.scene.num_lights} lights (was "
        f"{small.num_lights}); the next 2 passes equal a scene built with the "
        f"edit bit for bit: {edit_same}")
    if not (reset and edit_same
            and r.scene.num_lights == small.num_lights + 1):
        raise AssertionError("[18 edit] the edited render differs")
    numbers["edit"] = {"reset": reset, "equal_to_built": edit_same,
                       "lights": r.scene.num_lights}
    return numbers


# phase 19: the backends without Pallas. The sphere field is BASELINE.json's
# config 2 (benchmarks/tpu_diag.py:138-146: 'brute', 'bvh' and 'grid' at
# res=32) with 'clustered' at with_clusters' 64 clusters; the mesh is
# tpu_diag.py:171-173's 81,920 triangles at 5 bounces ('grid' at res=48, and
# 'bvh')
WALKS = ("bvh_closest", "bvh_occluded", "grid_closest", "grid_occluded")
WALK_SOURCES = {"bvh": "cpu_raytracing_experiments_tpu_torch/csrc/bvh_walk.cu",
                "grid": "cpu_raytracing_experiments_tpu_torch/csrc/grid_walk.cu"}
WALK_RAYS = 1 << 19  # the rays of one chunk at the default rays_per_chunk
MESH_GRID_RAYS = 1 << 16  # the mesh grid's plain residual battery is slow
FIELD_GRID_RES, MESH_GRID_RES, FIELD_CLUSTERS = 32, 48, 64
# operations per test, counted from csrc/walk_common.cuh and grid_walk.cu:
# the sphere leaf test 20 (as the dense battery's pair), Moller-Trumbore
# 6 fma + 3 mul (h), 2 fma + 1 mul (det), a division, 3 sub, 3 x (2 fma +
# 2 mul) (u, v, t), 6 fma + 3 mul (q), 6 compares and an add, fmas counted
# as 2; the DDA's set-up (per ray: 3 x (fma, reciprocal, 2 sub, 2 mul, min,
# max, fma, sub, mul, convert, fma, sub, division, abs, division) + 6) and
# a cell step (the exit min, 3 compares, an add, the done test, the flat
# index)
SPHERE_LEAF_OPS = CLOSEST_OPS_PER_PAIR
# the share of values a backend's full-width image holds to the reference
# image at rtol 1e-3 / atol 1e-4, below _check's 0.995: the brute any-hit
# battery is the sqrt-free predicate and the walks compare t < tfar, which
# round apart for about one shadow ray in a thousand (the ray to a point
# sampled on the light itself, at t ~ tfar), and over 9 passes that moves
# 0.6% of the values (PR 14's first chip run: 0.99406 for 'bvh')
ACCEL_CLOSE = 0.99
TRI_LEAF_OPS = 52
GRID_SETUP_OPS = 66
GRID_STEP_OPS = 14


def walk_batches(torch, np, crt, scene, accel, n, seed):
    """Ray batches for a walk over `scene`'s `accel` table, each (p, d,
    tfar0 of the closest walk or None, tfar of the any-hit walk): 'camera',
    the primary rays of the 1920x1088 frame's first chunk in screen-tile
    order; 'diffuse', from where those rays hit (or a random point of the
    bounds) in random directions, half the lanes seeded with a finite
    tfar0; 'axis', exactly axis-aligned directions from random points of
    the bounds, a quarter of the origins 0 on the ray's axis (n = 0 * inf =
    NaN there). The any-hit distances mix finite values, 0 and +inf."""
    from cpu_raytracing_experiments_tpu_torch.core.vec import Vec3
    from cpu_raytracing_experiments_tpu_torch.ops import intersect
    from cpu_raytracing_experiments_tpu_torch.render import renderer

    width, height = FRAME
    pol = crt.RendererPolicy(max_bounces=8)
    pixel = renderer._tile_pixel_order(width, width * height, 16,
                                       torch.device(DEVICE))[0][:n]
    seeds = renderer.pixel_seeds_from_index(pixel, width, pol)
    p, d = renderer.generate_camera_rays(
        scene.camera.resized(width, height), pixel % width, pixel // width,
        1, seeds, False, pol)
    t, prim, _ = intersect.intersect_scene(scene, p, d, accel=accel)
    g = np.random.default_rng(seed)
    as_t = lambda a: torch.tensor(np.ascontiguousarray(a),
                                  dtype=torch.float32, device=DEVICE)
    cent = np.stack([c.cpu().numpy() for c in scene.spheres.center], 1)
    if scene.triangles is not None:
        cent = np.concatenate([cent, np.stack(
            [c.cpu().numpy() for c in scene.triangles.v0], 1)])
    lo, hi = np.percentile(cent, 2, 0), np.percentile(cent, 98, 0)
    extent = float(np.abs(hi - lo).max())

    def shadow_tfar():
        tf = g.uniform(0.0, extent, n)
        tf[g.random(n) < 0.1] = 0.0
        tf[g.random(n) < 0.05] = np.inf
        return as_t(tf)

    def unit(a):
        return a / np.linalg.norm(a, axis=1, keepdims=True)

    hit = prim >= 0
    o = Vec3(*(torch.where(hit, pc + t * dc, as_t(g.uniform(lo[j], hi[j], n)))
               .contiguous() for j, (pc, dc) in enumerate(zip(p, d))))
    dirs = unit(g.normal(size=(n, 3)))
    seed_t = torch.where(as_t(g.random(n)) < 0.5,
                         as_t(g.uniform(1.0, extent, n)),
                         torch.full((n,), FLT_MAX_F32, device=DEVICE))
    axis = np.zeros((n, 3))
    k = g.integers(0, 3, n)
    axis[np.arange(n), k] = g.choice([-1.0, 1.0], n)
    ao = g.uniform(lo, hi, (n, 3))
    zero = g.random(n) < 0.25
    ao[zero, k[zero]] = 0.0
    return {
        "camera": (p, d, None, shadow_tfar()),
        "diffuse": (o, Vec3(*(as_t(dirs[:, j]) for j in range(3))), seed_t,
                    shadow_tfar()),
        "axis": (Vec3(*(as_t(ao[:, j]) for j in range(3))),
                 Vec3(*(as_t(axis[:, j]) for j in range(3))), None,
                 shadow_tfar()),
    }


FLT_MAX_F32 = 3.4028234663852886e38


class CaptureOccluded:
    """A context manager: within it, every bvh_walk.occluded call over
    `table` (a BVH of its node count; the renderer may hold a copy) runs as
    before, and the operands of the one with the most lanes at tfar > 0
    are copied to the host (a host read a call; nothing is left on the
    card). Afterwards ``batch`` holds them, (p, d, tfar0 None, tfar) on the
    host, and ``calls`` a summary of the calls. The package's module `bw`
    is passed in, so that a probe of another checkout can use this on that
    checkout's package."""

    def __init__(self, torch, bw, table):
        self.torch, self.bw, self.table = torch, bw, table
        self.batch, self.calls, self._seen, self._best = None, None, [], {}

    def _record(self, bvh, p, d, tfar, rows):
        if bvh.num_nodes == self.table.num_nodes:
            live = int((tfar > 0.0).sum())
            self._seen.append((p.x.shape[0], live))
            if live > self._best.get("live", -1):
                self._best.update(live=live, ops=(p.to("cpu"), d.to("cpu"),
                                                  tfar.cpu()))
        return self._wrapped(bvh, p, d, tfar, rows)

    def __enter__(self):
        self._wrapped, self.bw.occluded = self.bw.occluded, self._record
        return self

    def __exit__(self, *exc):
        self.bw.occluded = self._wrapped
        if exc[0] is None:
            self.torch.cuda.synchronize()
            p, d, tf = self._best["ops"]
            self.batch = (p, d, None, tf)
            self.calls = {
                "calls": len(self._seen),
                "lanes": sum(n for n, _ in self._seen),
                "live": sum(k for _, k in self._seen),
                "batch_lanes": p.x.shape[0],
                "batch_live": self._best["live"]}
        return False


def residual_anyhit_pairs(torch, grid, rows, p, d, tf):
    """The (ray, residual prim) pairs grid_occluded's residual loop needs on
    these rays: a lane stops after its first prim whose candidate lies
    below FLT_MAX and tfar, else it tests all Rr."""
    from cpu_raytracing_experiments_tpu_torch.core.vec import Vec3
    from cpu_raytracing_experiments_tpu_torch.ops import intersect
    from cpu_raytracing_experiments_tpu_torch.ops.kernels import \
        sphere_battery as sb

    rr = grid.residual.shape[0]
    if rr == 0:
        return 0
    r = rows[grid.residual]
    cols = [r[:, k].contiguous() for k in range(r.shape[1])]
    needed = torch.full((p.x.shape[0],), rr, dtype=torch.int64, device=DEVICE)
    if r.shape[1] == 9:
        blocks = intersect._triangle_blocks(p, d, Vec3(*cols[0:3]),
                                            Vec3(*cols[3:6]),
                                            Vec3(*cols[6:9]))
    else:
        blocks = ((slice(r0, r0 + intersect.RAY_CHUNK), s0,
                   sb._sphere_candidates(
                       Vec3(*(c[r0:r0 + intersect.RAY_CHUNK] for c in p)),
                       Vec3(*(c[r0:r0 + intersect.RAY_CHUNK] for c in d)),
                       *(c[s0:s0 + sb.PRIM_CHUNK] for c in cols)))
                  for r0 in range(0, p.x.shape[0], intersect.RAY_CHUNK)
                  for s0 in range(0, rr, sb.PRIM_CHUNK))
    for rs, start, t in blocks:
        hit = (t < FLT_MAX_F32) & (t < tf[rs, None])
        first = torch.where(hit.any(dim=1), hit.to(torch.int8).argmax(dim=1)
                            + start + 1, rr)
        needed[rs] = torch.minimum(needed[rs], first)
    return int(needed.sum())


def residual_sphere_grid(torch, np, k, n, seed):
    """A res-4 grid over 40 small spheres and k giant ones that each span
    more than res^2 cells, so that its residual list is the k giants, with
    the sphere rows and `n` seeded rays from the grid's box in random
    directions: (grid, rows, p, d, tfar0 (every fifth lane 20, else
    FLT_MAX), shadow tfar (80, every seventh lane 0))."""
    from cpu_raytracing_experiments_tpu_torch.bvh import grid as grid_mod
    from cpu_raytracing_experiments_tpu_torch.bvh import traverse
    from cpu_raytracing_experiments_tpu_torch.core.vec import Vec3

    g = np.random.default_rng(seed)
    c = np.concatenate([g.uniform(-50, 50, (40, 3)),
                        g.uniform(-10, 10, (k, 3))]).astype(np.float32)
    r = np.concatenate([g.uniform(0.3, 5.0, 40),
                        g.uniform(40, 55, k)]).astype(np.float32)
    grid = grid_mod.build_grid(c - r[:, None], c + r[:, None], res=4,
                               max_per_cell=40, device=DEVICE)
    if grid.residual.tolist() != list(range(40, 40 + k)):
        raise AssertionError(f"the residual grid holds {grid.residual}")
    as_t = lambda a: torch.tensor(np.ascontiguousarray(a),
                                  dtype=torch.float32, device=DEVICE)
    rows = traverse.pack_spheres(Vec3(*(as_t(c[:, j]) for j in range(3))),
                                 as_t(r * r))
    o = g.uniform(-100, 100, (n, 3))
    d = g.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tf0 = np.full(n, FLT_MAX_F32)
    tf0[::5] = 20.0
    tf = np.full(n, 80.0)
    tf[::7] = 0.0
    return (grid, rows, Vec3(*(as_t(o[:, j]) for j in range(3))),
            Vec3(*(as_t(d[:, j]) for j in range(3))), as_t(tf0), as_t(tf))


def check_residual_widths(torch, np):
    """grid_closest and grid_occluded against their plain versions, bit for
    bit, on residual lists of RESIDUAL_SPHERES spheres (the widths whose
    disc rounds b*b alone), 2^16 rays each; returns the residual hits."""
    from cpu_raytracing_experiments_tpu_torch.bvh import grid as grid_mod
    from cpu_raytracing_experiments_tpu_torch.bvh import traverse
    from cpu_raytracing_experiments_tpu_torch.ops.kernels import grid_walk

    hits = {}
    for k in RESIDUAL_SPHERES:
        grid, rows, p, d, tf0, tf = residual_sphere_grid(torch, np, k,
                                                         1 << 16, 190 + k)
        test = traverse.sphere_row_test
        kt, kid = grid_walk.closest(grid, p, d, rows, tf0)
        pt, pid = grid_mod.traverse_grid_closest(grid, p, d, rows, test,
                                                 tfar0=tf0)
        ko = grid_walk.occluded(grid, p, d, tf, rows)
        po = grid_mod.traverse_grid_shadow(grid, p, d, tf, rows, test)
        same = (torch.equal(kid, pid) and torch.equal(ko, po) and torch.equal(
            kt.view(torch.int32), pt.view(torch.int32)))
        hits[k] = int(torch.isin(pid, grid.residual).sum())
        log(f"[19 residual of {k} spheres] 65536 rays: {hits[k]} residual "
            f"hits, occluded {int(po.sum())}; grid_closest and grid_occluded "
            f"equal their plain versions bit for bit: {same}")
        if not same or hits[k] == 0:
            raise AssertionError(f"[19 residual of {k} spheres] a walk kernel "
                                 "disagrees with its plain version")
    return hits


def host_ms(torch, fn, calls=5):
    """The median of `calls` host-clock times of fn() ending in
    torch.cuda.synchronize(), after one untimed call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(calls):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return sorted(times)[calls // 2]


def check_walks(torch, timer, kind, table, rows, batches, label):
    """bvh_closest / bvh_occluded (kind 'bvh') or grid_closest /
    grid_occluded ('grid') against their plain versions on each batch, bit
    for bit (tfar bits, ids, occlusion); their CUDA-event times beside the
    plain version's and the bound from the plain version's visit counts.
    Returns {(kernel, batch): row}."""
    from cpu_raytracing_experiments_tpu_torch.bvh import grid as grid_mod
    from cpu_raytracing_experiments_tpu_torch.bvh import traverse
    from cpu_raytracing_experiments_tpu_torch.ops.kernels import bvh_walk
    from cpu_raytracing_experiments_tpu_torch.ops.kernels import grid_walk

    walk = bvh_walk if kind == "bvh" else grid_walk
    test = bvh_walk.ROW_TESTS[rows.shape[1]]
    tri = rows.shape[1] == 9
    leaf_ops = TRI_LEAF_OPS if tri else SPHERE_LEAF_OPS
    dense_ops = TRI_CLOSEST_OPS if tri else CLOSEST_OPS_PER_PAIR
    if kind == "bvh":
        closest_plain, occluded_plain = (traverse.traverse_closest_packed,
                                         traverse.traverse_shadow_packed)
        table_bytes = table.num_nodes * 32 + rows.numel() * 4
        # the any-hit walk reads the root's row and the child-pair table
        occ_table_bytes = rows.numel() * 4 + 32 + table.pairs.numel() * 4
        shape = f"N={table.num_nodes} nodes, {rows.shape[0]} prims"
    else:
        closest_plain, occluded_plain = (grid_mod.traverse_grid_closest,
                                         grid_mod.traverse_grid_shadow)
        rr = table.residual.shape[0]
        table_bytes = (table.cells.numel() * 4 + table.cell_count.numel() * 4
                       + rows.numel() * 4 + rr * (4 + (48 if tri else 0)))
        shape = (f"res={table.res} K={table.max_per_cell}, {rows.shape[0]} "
                 f"prims, residual {rr}")
        occ_table_bytes = table_bytes

    def ops(counts, n, residual_pairs=0):
        tests = counts.get("tests", 0)
        if kind == "bvh":
            return SLAB_OPS * counts.get("nodes", 0) + leaf_ops * tests
        return (GRID_SETUP_OPS * n + GRID_STEP_OPS * counts.get("cells", 0)
                + leaf_ops * tests + dense_ops * residual_pairs)

    out = {}
    for bname, (p, d, tf0, tf) in batches.items():
        n = p.x.shape[0]
        cc, oc, plain = {}, {}, {}
        kt, kid = walk.closest(table, p, d, rows, tf0)
        ko = walk.occluded(table, p, d, tf, rows)
        # one run of each plain version, timed, its visits counted (the
        # counts cost a host read a leaf slot or cell, inside the time)
        plain_ms = {
            f"{kind}_closest": timer(lambda: plain.__setitem__(
                "closest", closest_plain(table, p, d, rows, test, tfar0=tf0,
                                         counts=cc)), 1, warmup=0),
            f"{kind}_occluded": timer(lambda: plain.__setitem__(
                "occluded", occluded_plain(table, p, d, tf, rows, test,
                                           counts=oc)), 1, warmup=0)}
        (pt, pid), po = plain["closest"], plain["occluded"]
        same = (torch.equal(kid, pid)
                and torch.equal(kt.view(torch.int32), pt.view(torch.int32))
                and torch.equal(ko, po))
        hit = pid >= 0
        log(f"[{label}, {bname}] R={n} {shape}: hits {int(hit.sum())}, "
            f"occluded {int(po.sum())}, plain counts closest {cc} any-hit "
            f"{oc}; kernels equal the plain versions bit for bit: {same}")
        if not same:
            bad = ((kid != pid) | (kt.view(torch.int32) != pt.view(torch.int32))
                   | (ko != po))
            for i in torch.nonzero(bad)[:5, 0].tolist():
                log(f"  lane {i}: kernel ({float(kt[i])!r}, {int(kid[i])}, "
                    f"{bool(ko[i])}) plain ({float(pt[i])!r}, {int(pid[i])}, "
                    f"{bool(po[i])})")
            raise AssertionError(f"[{label}, {bname}] a walk kernel "
                                 "disagrees with its plain version")
        anyhit_pairs = (0 if kind == "bvh" else
                        residual_anyhit_pairs(torch, table, rows, p, d, tf))
        # bvh_occluded reads the ray of a lane with tfar > 0 only
        # (csrc/bvh_walk.cu); grid_occluded reads every lane's
        occ_ray_bytes = (24 * int((tf > 0.0).sum()) + 5 * n if kind == "bvh"
                         else 29 * n)
        for name, kern, nbytes, n_ops in (
                (f"{kind}_closest",
                 lambda: walk.closest(table, p, d, rows, tf0),
                 n * (24 + (0 if tf0 is None else 4) + 8) + table_bytes,
                 ops(cc, n, cc.get("residual_pairs", 0))),
                (f"{kind}_occluded",
                 lambda: walk.occluded(table, p, d, tf, rows),
                 occ_ray_bytes + occ_table_bytes,
                 ops(oc, n, anyhit_pairs))):
            ms = timer(kern, 10)
            row = kernel_row(name, WALK_SOURCES[kind], f"R={n} {shape}",
                             None, 0.0, ms, plain_ms[name], nbytes, n_ops)
            row["batch"] = f"{label}, {bname}"
            if name == "bvh_closest":
                # the host's clock around a call after the first (the node
                # table packed once, with the BVH), beside what packing the
                # table, as each call did before, takes: medians of 5
                row["second_call_host_ms"] = host_ms(torch, kern)
                row["pack_nodes_host_ms"] = host_ms(
                    torch, lambda: traverse.pack_nodes(table))
                log(f"[{label}, {bname}] bvh_closest by the host's clock: "
                    f"{row['second_call_host_ms']:.4f} ms a call; packing "
                    f"the node table {row['pack_nodes_host_ms']:.4f} ms")
            out[name, bname] = row
            log(f"[{label}, {bname}] {name}: {ms:.4f} ms (bound "
                f"{row['bound_ms']:.4f} ms by {row['bound_by']}, "
                f"{n_ops / 1e9:.3f} GFLOP; plain {plain_ms[name]:.1f} ms)")
    return out


def time_mesh_grid_chunk(torch, np, crt, timer, scene):
    """grid_closest and grid_occluded on the mesh grid at the pass's chunk
    width (WALK_RAYS camera rays), timed only: the plain residual battery
    is too slow to compare there. The bound counts the set-up and the
    residual pairs (the any-hit form's up to each lane's first occluder),
    not the walk's cells: a least time of part of the work."""
    from cpu_raytracing_experiments_tpu_torch.bvh import traverse
    from cpu_raytracing_experiments_tpu_torch.ops.kernels import grid_walk

    tri = scene.triangles
    rows = traverse.pack_triangles(tri.v0, tri.e1, tri.e2)
    grid = scene.tri_grid
    p, d, tf0, tf = walk_batches(torch, np, crt, scene, "grid", WALK_RAYS,
                                 19)["camera"]
    n, rr = WALK_RAYS, grid.residual.shape[0]
    table_bytes = (grid.cells.numel() * 4 + grid.cell_count.numel() * 4
                   + rows.numel() * 4 + rr * (4 + 48))
    shape = (f"R={n} res={grid.res} K={grid.max_per_cell}, {rows.shape[0]} "
             f"prims, residual {rr} (timed only)")
    out = {}
    for name, kern, nbytes, n_ops in (
            ("grid_closest", lambda: grid_walk.closest(grid, p, d, rows, tf0),
             n * 32 + table_bytes,
             GRID_SETUP_OPS * n + TRI_CLOSEST_OPS * n * rr),
            ("grid_occluded", lambda: grid_walk.occluded(grid, p, d, tf, rows),
             n * 29 + table_bytes,
             GRID_SETUP_OPS * n + TRI_CLOSEST_OPS * residual_anyhit_pairs(
                 torch, grid, rows, p, d, tf))):
        ms = timer(kern, 10)
        row = kernel_row(name, WALK_SOURCES["grid"], shape, None, 0.0, ms,
                         None, nbytes, n_ops)
        row["batch"] = "19 mesh grid, camera, chunk width"
        out["mesh grid", name, "camera 2^19"] = row
        log(f"[19 mesh grid, camera, {n} rays] {name}: {ms:.4f} ms (bound "
            f"{row['bound_ms']:.4f} ms by {row['bound_by']} from the set-up "
            f"and the residual pairs; timed only)")
    return out


def check_accel_paths(torch, np, crt, timer):
    """Phase 19: (a) the four walk kernels against their plain versions on
    the 1000-sphere field's BVH and grid and on the 81,920-triangle mesh's
    (WALK_RAYS rays, MESH_GRID_RAYS on the mesh grid); (b) the field at
    1920x1088, 8 bounces, under 'brute', 'bvh', 'grid' and 'clustered', and
    the mesh at 5 bounces under 'bvh' and 'grid' (the BVH walks then also
    on the shadow rays of the 'bvh' renders' warm-up pass,
    CaptureOccluded), each image held to the
    field's 'brute' image (the mesh's: to each other) as ACCEL_CLOSE says,
    with launches and peak memory; (c) bvh_test at 64x64 on the card against the
    CPU under each backend, bucket bits, and the bvh_test golden on the
    card; (d) a SceneEditor edit of a with_bvh scene on the card. Returns
    (numbers, kernel rows)."""
    from cpu_raytracing_experiments_tpu_torch.bvh import traverse
    from cpu_raytracing_experiments_tpu_torch.ops.kernels import build
    from cpu_raytracing_experiments_tpu_torch.ops.kernels import \
        bvh_walk as bw
    from cpu_raytracing_experiments_tpu_torch.scene import accel, edit
    from cpu_raytracing_experiments_tpu_torch.scene.scene import (
        Scene, build_light_list, light_alias_arrays)

    pol = crt.RendererPolicy
    numbers, rows_out = {}, {}
    t0 = time.perf_counter()
    field = crt.builders.random_spheres_scene(*FRAME, num_spheres=1000)
    mesh = crt.builders.mesh_scene(*FRAME, subdivisions=6)
    scenes = {
        "field bvh": accel.with_bvh(field).to(DEVICE),
        "field grid": accel.with_grid(field, res=FIELD_GRID_RES).to(DEVICE),
        "field clustered": accel.with_clusters(
            field, num_clusters=FIELD_CLUSTERS).to(DEVICE),
        "mesh bvh": accel.with_bvh(mesh).to(DEVICE),
        "mesh grid": accel.with_grid(mesh, res=MESH_GRID_RES).to(DEVICE),
    }
    g = scenes["mesh grid"].tri_grid
    log(f"[19] tables built on the host in {time.perf_counter() - t0:.1f} s: "
        f"field BVH {scenes['field bvh'].sphere_bvh.num_nodes} nodes, mesh "
        f"BVH {scenes['mesh bvh'].tri_bvh.num_nodes} nodes ({mesh.triangles.count} "
        f"triangles), mesh grid res {g.res} residual {g.residual.shape[0]}, "
        f"field grid residual "
        f"{scenes['field grid'].sphere_grid.residual.shape[0]}")

    # (a) the kernels against their plain versions
    walked = {}
    for sname, kind, n in (("field bvh", "bvh", WALK_RAYS),
                           ("field grid", "grid", WALK_RAYS),
                           ("mesh bvh", "bvh", WALK_RAYS),
                           ("mesh grid", "grid", MESH_GRID_RAYS)):
        sc = scenes[sname]
        if sname.startswith("field"):
            table = sc.sphere_bvh if kind == "bvh" else sc.sphere_grid
            rows = traverse.pack_spheres(sc.spheres.center,
                                         sc.spheres.radius_sq)
        else:
            table = sc.tri_bvh if kind == "bvh" else sc.tri_grid
            tri = sc.triangles
            rows = traverse.pack_triangles(tri.v0, tri.e1, tri.e2)
        if n < WALK_RAYS:
            log(f"[19 {sname}] {n} rays, not {WALK_RAYS}: the plain "
                f"version's dense residual battery is slow at full width")
        batches = walk_batches(torch, np, crt, sc, kind, n, 19)
        if kind == "bvh":  # the render's shadow batch is checked after (b)
            walked[sname] = (table, rows, CaptureOccluded(torch, bw, table))
        rows_out.update({(sname,) + k: v for k, v in check_walks(
            torch, timer, kind, table, rows, batches, f"19 {sname}").items()})
        del batches

    numbers["residual_width_hits"] = check_residual_widths(torch, np)
    rows_out.update(time_mesh_grid_chunk(torch, np, crt, timer,
                                         scenes["mesh grid"]))
    log(f"[19] kernels checked at {time.perf_counter() - t0:.1f} s")

    # (b) full-width renders
    renders = {}
    for name, scene, kw, expect, bounces in (
            ("field brute", field.to(DEVICE), {},
             ("sphere_closest", "sphere_occluded"), 8),
            ("field bvh", scenes["field bvh"], {"accel": "bvh"},
             ("bvh_closest", "bvh_occluded"), 8),
            ("field grid", scenes["field grid"], {"accel": "grid"},
             ("grid_closest", "grid_occluded"), 8),
            ("field clustered", scenes["field clustered"],
             {"accel": "clustered"}, ("sphere_closest",), 8),
            ("mesh bvh", scenes["mesh bvh"], {"accel": "bvh"},
             ("bvh_closest", "bvh_occluded"), 5),
            ("mesh grid", scenes["mesh grid"], {"accel": "grid"},
             ("grid_closest", "grid_occluded"), 5)):
        mesh_path = name.startswith("mesh")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        # the mesh: one window of 3 passes (the median of 5 buckets is 0
        # below 3 passes); the field: the images it compares are of equal
        # pass counts
        img, nums = render(torch, crt, scene, pol(max_bounces=bounces, **kw),
                           *FRAME, PASSES, f"19 {name}", expect,
                           idle=() if kw else WALKS,
                           windows=1 if mesh_path else WINDOWS,
                           warmup=(walked[name][2] if name in walked
                                   else None))
        nums["peak_mib"] = (torch.cuda.max_memory_allocated() - held) / 2**20
        log(f"[19 {name}] peak {nums['peak_mib']:.1f} MiB above the "
            f"{held / 2 ** 20:.1f} MiB held before")
        renders[name] = (img, nums)
        if name in walked:
            # the BVH walks on the shadow rays of the warm-up pass
            table, rows, got = walked.pop(name)
            p, d, _, tf = got.batch
            numbers[f"{name} shadow batch"] = got.calls
            log(f"[19 {name}] shadow batch: {got.calls}")
            rows_out.update({(name,) + k: v for k, v in check_walks(
                torch, timer, "bvh", table, rows, {"shadow": (
                    p.to(DEVICE), d.to(DEVICE), None, tf.to(DEVICE))},
                f"19 {name}").items()})
    for name, ref in (("field bvh", "field brute"),
                      ("field grid", "field brute"),
                      ("field clustered", "field brute"),
                      ("mesh grid", "mesh bvh")):
        img, want = renders[name][0], renders[ref][0]
        close = float(np.isclose(img, want, rtol=1e-3, atol=1e-4).mean())
        mean_ok = abs(img.mean() - want.mean()) <= 1e-3 * abs(want.mean())
        log(f"[19 {name} vs {ref}] close {close:.5f} (need > "
            f"{ACCEL_CLOSE}), mean {img.mean():.6f} vs {want.mean():.6f} "
            f"(within rtol 1e-3: {mean_ok})")
        renders[name][1]["close_to_" + ref.split()[1]] = close
        if not (close > ACCEL_CLOSE and mean_ok and want.mean() > 0):
            raise AssertionError(f"[19 {name}] the image differs from "
                                 f"{ref}'s")
    numbers["renders"] = {
        name: {k: v for k, v in nums.items() if k != "probe"}
        for name, (_, nums) in renders.items()}
    del renders, scenes

    log(f"[19] full-width renders done at {time.perf_counter() - t0:.1f} s")

    # (c) the card against the CPU at 64x64 (one pass), and the bvh_test
    # golden on the card
    small = crt.builders.bvh_test_scene(64, 64)
    spol = dict(max_bounces=6, rays_per_chunk=4096)
    equal = {}
    for name, attach, kw in (
            ("bvh", accel.with_bvh, {"accel": "bvh"}),
            ("grid", accel.with_grid, {"accel": "grid"}),
            ("clustered", accel.with_clusters, {"accel": "clustered"}),
            ("bvh, primary pallas",
             lambda s: accel.with_pallas_clusters(accel.with_bvh(s)),
             {"accel": "bvh", "primary_accel": "pallas"})):
        sc = attach(small)
        got = []
        for dev in ("cpu", DEVICE):
            r = crt.Renderer(sc, pol(**spol, **kw), 64, 64, device=dev)
            r.accumulate(1)
            got.append(r.state.buckets)
        equal[name] = equal_bits(torch, got[0], got[1])
        r = crt.Renderer(sc, pol(**spol, narrow_wavefront=False, **kw), 64,
                         64)
        r.accumulate(10)
        img = r.render(tonemap=False)
        golden = np.load(ROOT / "tests" / "goldens" / "bvh_test_64x64_10spp.npy")
        close = float(np.isclose(img, golden, rtol=1e-3, atol=1e-4).mean())
        log(f"[19 bvh_test 64x64 {name}] card buckets equal the CPU's bit "
            f"for bit: {equal[name]}; 10 spp on the card against the golden: "
            f"close {close:.5f} (need > 0.995)")
        if not equal[name] or close <= 0.995:
            raise AssertionError(f"[19 bvh_test {name}] card differs from "
                                 "the CPU or misses the golden")
        numbers[f"bvh_test {name}"] = {"cpu_card_equal": equal[name],
                                       "golden_close": close}

    # a 6-sphere scene: its one chunk is 6 wide, where the plain battery
    # rounds disc's b*b alone (fp.xla_fuses_sphere_bb)
    six = crt.builders.random_spheres_scene(64, 64, num_spheres=6)
    got = []
    for dev in ("cpu", DEVICE):
        r = crt.Renderer(six, pol(**spol), 64, 64, device=dev)
        build.reset_counts()
        r.accumulate(1)
        got.append(r.state.buckets)
    launched = build.launch_counts()["sphere_closest"]
    same = equal_bits(torch, got[0], got[1])
    log(f"[19 6 spheres 64x64] card buckets equal the CPU's bit for bit: "
        f"{same}; sphere_closest launched {launched} times on the card")
    if not same or launched <= 0:
        raise AssertionError("[19 6 spheres] card differs from the CPU")
    numbers["6 spheres"] = {"cpu_card_equal": same}

    log(f"[19] card against CPU done at {time.perf_counter() - t0:.1f} s")

    # (d) an edit of a with_bvh scene on the card
    hero = crt.builders.default_scene(64, 64)
    bpol = pol(**spol, accel="bvh")
    sb = accel.with_bvh(hero)
    r = crt.Renderer(sb, bpol, 64, 64)
    r.accumulate(1)
    k = 6
    pos = tuple(float(c[k]) + 0.05 for c in sb.spheres.center)
    editor = edit.SceneEditor(r)
    editor.edit(edit.set_sphere, k, position=pos)
    editor.commit()
    r.accumulate(2)
    # the same sphere moved in the scene as built, then with_bvh; the light
    # list in leaf order, as the editor's invalidation rebuilds it
    centers = np.stack([c.numpy() for c in hero.spheres.center], 1)
    moved = int(np.nonzero((centers == np.stack(
        [c.numpy() for c in sb.spheres.center], 1)[k]).all(1))[0][0])
    arrays = hero.to_numpy()
    arrays["sphere_center"][moved] = pos
    arrays = accel.with_bvh(Scene.from_numpy(arrays)).to_numpy()
    arrays["lights"] = build_light_list(arrays["sphere_material_id"],
                                        arrays["material_emission"])
    arrays.update(light_alias_arrays(arrays))
    built = crt.Renderer(Scene.from_numpy(arrays), bpol, 64, 64)
    built.accumulate(2)
    same = equal_bits(torch, r.state.buckets, built.state.buckets)
    log(f"[19 edit] sphere {k} of a with_bvh hero moved on the card and "
        f"committed (BVH rebuilt: {r.scene.sphere_bvh is not sb.sphere_bvh}); "
        f"the next 2 passes equal the scene built with the edit bit for bit: "
        f"{same}")
    if not same:
        raise AssertionError("[19 edit] the edited bvh render differs")
    numbers["edit"] = {"equal_to_built": same}
    return numbers, rows_out


# phase 20: the pool, the shell and multi-device. The hero is bench.py's
# main path (bench.py:89-104: default_scene at 1920x1088, 8 bounces, 2^19
# rays a chunk); the pool's size is that chunk (JAX wavefront_pool.py:59)
SHELL_PASSES = 5  # spp of the CLI render
SHARDED_WIDTH = 256  # the two-process meshes' square frame
SHARDED_PASSES = 10  # torch_sharded_worker.py's "buckets" case
SHARDED_RTOL, SHARDED_ATOL = 2e-5, 1e-5  # tests/test_sharding.py's


def read_png(np, data: bytes):
    """The pixels of an 8-bit RGB PNG whose scanlines all have filter type
    0 (what utils/image.py::encode_png writes), decoded with zlib."""
    import struct
    import zlib

    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise AssertionError("not a PNG")
    pos, idat, size = 8, b"", None
    while pos < len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if kind == b"IHDR":
            size = struct.unpack(">IIBB", body[:10])
        elif kind == b"IDAT":
            idat += body
        pos += 12 + n
    w, h, depth, ctype = size
    if (depth, ctype) != (8, 2):
        raise AssertionError(f"not 8-bit RGB: {size}")
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + 3 * w)
    if raw[:, 0].any():
        raise AssertionError("a scanline with a filter other than 0")
    return raw[:, 1:].reshape(h, w, 3)


def tonemapped_bytes(np, img):
    """utils/image.py::write_png's quantization."""
    return (np.clip(img, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)


@contextlib.contextmanager
def pool_iterations():
    """Count the bounce steps (= pool iterations) of the block's pooled
    passes."""
    from cpu_raytracing_experiments_tpu_torch.render import wavefront_pool

    calls, step = [0], wavefront_pool._r.bounce_step

    def counted(*args, **kwargs):
        calls[0] += 1
        return step(*args, **kwargs)

    wavefront_pool._r.bounce_step = counted
    try:
        yield calls
    finally:
        wavefront_pool._r.bounce_step = step


def windows_ms(torch, fn, windows=WINDOWS):
    """ms of `fn` (one pass) in each of `windows` windows, synchronized."""
    out = []
    for _ in range(windows):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def check_pool(torch, np, crt, numbers):
    """(a) render_pass_pooled on the hero at full width against render_pass
    on the card, bit for bit, both timed; the pool's launches, busy time and
    iterations from one profiled pass, its peak memory; the pool at 64x64
    on the card against the CPU, bit for bit."""
    from cpu_raytracing_experiments_tpu_torch.ops.kernels import build
    from cpu_raytracing_experiments_tpu_torch.render import renderer as rr
    from cpu_raytracing_experiments_tpu_torch.render import wavefront_pool

    policy = crt.RendererPolicy(max_bounces=8, rays_per_chunk=1 << 19)
    hero = crt.builders.default_scene(*FRAME).to(DEVICE)
    pooled = wavefront_pool.render_pass_pooled
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    build.reset_counts()
    with pool_iterations() as calls:
        got, count = pooled(hero, policy, 1, *FRAME)
        torch.cuda.synchronize()
    launches = {k: v for k, v in build.launch_counts().items() if v}
    peak = (torch.cuda.max_memory_allocated() - held) / 2 ** 20
    for name in ("sphere_closest", "sphere_occluded", "fma"):
        if launches.get(name, 0) <= 0:
            raise AssertionError(f"[20 pool] {name} was never launched")
    want, want_count = rr.render_pass(hero, policy, 1, *FRAME)
    same = (int(count) == int(want_count)
            and all(equal_bits(torch, g, w) for g, w in zip(got, want)))
    log(f"[20 pool] the hero at {FRAME[0]}x{FRAME[1]}, pool 2^19: radiance "
        f"and ray count ({int(count)}) equal render_pass's bit for bit: "
        f"{same}; {calls[0]} iterations a pass, peak {peak:.1f} MiB above "
        f"the {held / 2 ** 20:.1f} MiB held; launches {launches}")
    if not same:
        raise AssertionError("[20 pool] the pool differs from render_pass")
    pool_ms = windows_ms(torch, lambda: pooled(hero, policy, 2, *FRAME))
    masked_ms = windows_ms(torch, lambda: rr.render_pass(hero, policy, 2,
                                                         *FRAME))
    med = sorted(pool_ms)[WINDOWS // 2], sorted(masked_ms)[WINDOWS // 2]
    log(f"[20 pool] ms/pass, median of windows: pool {med[0]:.2f} "
        f"{[round(m, 2) for m in pool_ms]}, masked render_pass {med[1]:.2f} "
        f"{[round(m, 2) for m in masked_ms]}")
    prof = {name: profile_pass(torch, None, f"20 {name}", run=run)
            for name, run in (
                ("pool", lambda: pooled(hero, policy, 3, *FRAME)),
                ("masked", lambda: rr.render_pass(hero, policy, 3, *FRAME)))}
    small = crt.builders.default_scene(64, 64)
    spol = crt.RendererPolicy(max_bounces=6, rays_per_chunk=1000)
    outs = [pooled(small.to(dev), spol, 2, 64, 64) for dev in ("cpu", DEVICE)]
    small_same = (int(outs[0][1]) == int(outs[1][1]) and all(
        equal_bits(torch, a, b) for a, b in zip(outs[0][0], outs[1][0])))
    log(f"[20 pool 64x64] pool 1000: the card equals the CPU bit for bit: "
        f"{small_same}")
    if not small_same:
        raise AssertionError("[20 pool 64x64] the card differs from the CPU")
    numbers["pool"] = {
        "ms_per_pass": med[0], "windows_ms": pool_ms,
        "masked_ms_per_pass": med[1], "masked_windows_ms": masked_ms,
        "iterations": calls[0], "peak_mib": peak, "launches": launches,
        "launches_all": sum(launches.values()), "profile": prof,
        "rays_per_pass": int(count), "equal_to_render_pass": same,
        "cpu_card_equal_64x64": small_same}


def check_cli(torch, np, crt, numbers):
    """(b) ``python -m cpu_raytracing_experiments_tpu_torch.cli render`` on
    the card: the hero at 1920x1088, 5 spp, with --out, --hdr-out and
    --metrics; the .hdr equals the RGBE encoding of the in-process
    Renderer's linear resolve byte for byte, the PNG decodes to its
    tonemapped resolve; then ``cli bench`` at BENCH_PASSES=3."""
    import os
    import tempfile

    from cpu_raytracing_experiments_tpu_torch.utils import image

    policy = crt.RendererPolicy(max_bounces=8, rays_per_chunk=1 << 19)
    cmd = [sys.executable, "-m", "cpu_raytracing_experiments_tpu_torch.cli"]
    with tempfile.TemporaryDirectory(dir=ROOT) as tmp:
        out = {k: str(Path(tmp) / f"hero.{k}") for k in ("png", "hdr",
                                                         "jsonl")}
        t0 = time.perf_counter()
        res = subprocess.run(
            cmd + ["render", "--scene", "default", "--width", str(FRAME[0]),
                   "--height", str(FRAME[1]), "--spp", str(SHELL_PASSES),
                   "--quiet", "--out", out["png"], "--hdr-out", out["hdr"],
                   "--metrics", out["jsonl"]],
            cwd=ROOT, capture_output=True, text=True, timeout=300)
        wall = time.perf_counter() - t0
        if res.returncode != 0:
            raise AssertionError(f"[20 cli render] exit {res.returncode}: "
                                 f"{res.stderr[-2000:]}")
        hdr = Path(out["hdr"]).read_bytes()
        png = read_png(np, Path(out["png"]).read_bytes())
        records = [json.loads(x) for x in
                   Path(out["jsonl"]).read_text().splitlines()]
    r = crt.Renderer(crt.builders.default_scene(*FRAME), policy, *FRAME)
    r.accumulate(SHELL_PASSES)
    hdr_same = hdr == image.encode_hdr(r.render(tonemap=False))
    png_same = np.array_equal(png, tonemapped_bytes(np, r.render()))
    step = [x for x in records if x["event"] == "step"]
    log(f"[20 cli render] {FRAME[0]}x{FRAME[1]}, {SHELL_PASSES} spp: exit 0 "
        f"in {wall:.2f} s (the process, start and build load included; the "
        f"passes' step {step[0]['wall_s'] if step else None} s); the .hdr "
        f"equals the in-process resolve's RGBE bytes: {hdr_same}; the PNG "
        f"decodes to its tonemapped resolve: {png_same}; metrics {records}")
    if not (hdr_same and png_same and step):
        raise AssertionError("[20 cli render] the CLI's files differ")
    t0 = time.perf_counter()
    res = subprocess.run(cmd + ["bench"], cwd=ROOT, capture_output=True,
                         text=True, timeout=300,
                         env=dict(os.environ, BENCH_PASSES="3"))
    bench_wall = time.perf_counter() - t0
    if res.returncode != 0:
        raise AssertionError(f"[20 cli bench] exit {res.returncode}: "
                             f"{res.stderr[-2000:]}")
    bench = json.loads(res.stdout.strip().splitlines()[-1])
    log(f"[20 cli bench] BENCH_PASSES=3 in {bench_wall:.2f} s: {bench}")
    if bench["device"] != torch.cuda.get_device_name(0):
        raise AssertionError("[20 cli bench] the line does not name the card")
    numbers["cli"] = {"render_wall_s": wall, "hdr_equal": hdr_same,
                      "png_equal": png_same,
                      "step_wall_s": step[0]["wall_s"], "bench": bench,
                      "bench_wall_s": bench_wall}


def check_viewer(torch, np, crt, numbers):
    """(c) the viewer on the card at 1920x1088 on an ephemeral port: /stats
    until spp grows, /frame.png, one /edit (spp drops back), /delta?gen=0
    (a full frame) and the next generation (tiles), then stopped."""
    import base64
    import threading
    import urllib.request

    from cpu_raytracing_experiments_tpu_torch import viewer

    policy = crt.RendererPolicy(max_bounces=8, rays_per_chunk=1 << 19)
    server, renderer, stop, worker = viewer.make_server(
        crt.builders.default_scene(*FRAME), policy, *FRAME, port=0)
    serving = threading.Thread(target=server.serve_forever, daemon=True)
    serving.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"

    def get(path):
        with urllib.request.urlopen(base + path, timeout=120) as resp:
            return resp.read()

    def stats_until(ok, seconds=90.0):
        deadline = time.time() + seconds
        while time.time() < deadline:
            s = json.loads(get("/stats"))
            if ok(s):
                return s
            time.sleep(0.1)
        raise AssertionError(f"[20 viewer] /stats never met the condition "
                             f"(last {s})")

    try:
        t0 = time.perf_counter()
        first = stats_until(lambda s: s["spp"] >= 10)
        first_s = time.perf_counter() - t0
        frame = read_png(np, get("/frame.png"))
        if frame.shape != (FRAME[1], FRAME[0], 3):
            raise AssertionError(f"[20 viewer] /frame.png is {frame.shape}")
        if get("/edit?material=0&albedo=0.5,0.5,0.5") != b"ok":
            raise AssertionError("[20 viewer] /edit refused")
        spp_before = first["spp"]
        after = stats_until(lambda s: s["spp"] < spp_before)
        full = json.loads(get("/delta?gen=0"))
        part = json.loads(get(f"/delta?gen={full['gen']}"))
        full_png = read_png(np, base64.b64decode(full["png_b64"]))
        stats = json.loads(get("/stats"))
    finally:
        stop.set()
        server.shutdown()
        server.server_close()
        worker.join(timeout=120)
        serving.join(timeout=60)
    ok = (full["full"] and full_png.shape == (FRAME[1], FRAME[0], 3)
          and not part["full"] and part["gen"] == full["gen"] + 1
          and not worker.is_alive())
    log(f"[20 viewer] {FRAME[0]}x{FRAME[1]} on the card: spp {spp_before} "
        f"after {first_s:.2f} s; /frame.png decodes; after /edit spp "
        f"{after['spp']} < {spp_before}; /delta full frame then "
        f"{len(part['tiles'])} tiles at gen {part['gen']}; /stats "
        f"{stats['ms_per_pass']:.2f} ms/pass, "
        f"{stats['msamples_per_s']:.3f} Msamples/s; render thread stopped: "
        f"{not worker.is_alive()}")
    if not ok:
        raise AssertionError("[20 viewer] the protocol or the stop failed")
    numbers["viewer"] = {"ms_per_pass": stats["ms_per_pass"],
                         "msamples_per_s": stats["msamples_per_s"],
                         "history_ms": [v for v in stats["history_ms"] if v],
                         "spp_before_edit": spp_before,
                         "spp_after_edit": after["spp"],
                         "delta_tiles": len(part["tiles"])}


def check_sharded(torch, np, crt, numbers):
    """(d) ShardedRenderer at world size 1 over NCCL on the hero at
    1920x1088, 2 passes, against Renderer bit for bit (the sp merge and the
    dp frame are all_gathers over NCCL on card tensors, 1 wide); then
    tests/torch_sharded_worker.py's hero (its policy, 10 passes) at 256x256
    on two processes over gloo, three meshes at once: dp 2 and sp 2 on the
    one card, sp 2 on the CPU. dp 2's merged buckets equal one device's bit
    for bit, sp 2's are within test_sharding.py's tolerance of one
    device's and equal to the same sp 2 run on the CPU bit for bit."""
    import tempfile

    from cpu_raytracing_experiments_tpu_torch.parallel import (distributed,
                                                               sharded)

    sys.path.insert(0, str(ROOT / "tests"))
    import torch_sharded_worker as worker

    policy = crt.RendererPolicy(max_bounces=8, rays_per_chunk=1 << 19)
    hero = crt.builders.default_scene(*FRAME)
    t0 = time.perf_counter()
    torch.cuda.set_device(0)  # NCCL's device, before the DeviceMesh
    distributed.initialize(backend="nccl")
    try:
        backend = torch.distributed.get_backend()
        mesh = sharded.make_mesh(1, 1, device_type="cuda")
        sr = sharded.ShardedRenderer(hero, policy, *FRAME, mesh)
        sr.accumulate(2)
        img = sr.render(tonemap=False)
    finally:
        torch.distributed.destroy_process_group()
    nccl_s = time.perf_counter() - t0
    r = crt.Renderer(hero, policy, *FRAME)
    r.accumulate(2)
    one_same = (equal_bits(torch, sr.state.buckets, r.state.buckets)
                and np.array_equal(img, r.render(tonemap=False)))
    log(f"[20 sharded] world size 1 over {backend} (its all_gathers on the "
        f"card), the hero at {FRAME[0]}x{FRAME[1]}, 2 passes in "
        f"{nccl_s:.2f} s: buckets and image equal Renderer's bit for bit: "
        f"{one_same}")
    if not one_same:
        raise AssertionError("[20 sharded] world size 1 differs")
    del sr, r
    runs = {"2x1 card": (2, 1, DEVICE), "1x2 card": (1, 2, DEVICE),
            "1x2 cpu": (1, 2, "cpu")}
    got = {}
    with tempfile.TemporaryDirectory(dir=ROOT) as tmp:
        t0 = time.perf_counter()
        procs = []
        for name, (dp, sp, device) in runs.items():
            out = Path(tmp) / name.replace(" ", "_")
            out.mkdir()
            for rank in (0, 1):
                with open(out / f"rank{rank}.log", "w") as f:
                    procs.append((name, out, subprocess.Popen(
                        [sys.executable, str(ROOT / "tests" /
                                             "torch_sharded_worker.py"),
                         str(out / "store"), "2", str(rank), str(dp),
                         str(sp), str(out), device, str(SHARDED_WIDTH),
                         "buckets"], cwd=ROOT, stdout=f,
                        stderr=subprocess.STDOUT)))
        try:
            for _, _, p in procs:
                p.wait(timeout=max(1.0, 300 - (time.perf_counter() - t0)))
        finally:
            for _, _, p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        gloo_s = time.perf_counter() - t0
        for name, out, p in procs:
            if p.returncode != 0:
                tail = "".join(open(f).read()[-3000:]
                               for f in sorted(out.glob("rank*.log")))
                raise AssertionError(f"[20 sharded gloo] a rank of {name} "
                                     f"exited {p.returncode}: {tail}")
        for name, out, _ in procs:
            with np.load(out / "results.npz") as z:
                got[name] = z["buckets"]
    one = crt.Renderer(crt.builders.default_scene(SHARDED_WIDTH,
                                                  SHARDED_WIDTH),
                       worker.POL, SHARDED_WIDTH, SHARDED_WIDTH)
    one.accumulate(SHARDED_PASSES)
    want = one.state.buckets.cpu().numpy()

    def bits(a, b):
        return np.array_equal(a.view(np.int32), b.view(np.int32))

    dp_same = bits(got["2x1 card"], want)
    sp_close = bool(np.allclose(got["1x2 card"], want, rtol=SHARDED_RTOL,
                                atol=SHARDED_ATOL))
    sp_cpu = bits(got["1x2 card"], got["1x2 cpu"])
    sp_bits = bits(got["1x2 card"], want)
    log(f"[20 sharded gloo] 3 meshes of 2 processes at once (2 on the card "
        f"each, one on the CPU), {SHARDED_WIDTH}x{SHARDED_WIDTH}, "
        f"{SHARDED_PASSES} passes, in {gloo_s:.2f} s: dp 2 equals one device "
        f"bit for bit: {dp_same}; sp 2 within rtol {SHARDED_RTOL} / atol "
        f"{SHARDED_ATOL} of one device: {sp_close} (bit for bit: {sp_bits}); "
        f"sp 2 on the card equals sp 2 on the CPU bit for bit: {sp_cpu}")
    if not (dp_same and sp_close and sp_cpu):
        raise AssertionError("[20 sharded gloo] a mesh differs")
    numbers["sharded"] = {"world1_backend": backend, "world1_equal": one_same,
                          "world1_s": nccl_s, "gloo_s": gloo_s,
                          "dp2_equal": dp_same, "sp2_close": sp_close,
                          "sp2_bits_equal_one_device": sp_bits,
                          "sp2_cpu_card_equal": sp_cpu}


def check_shell_paths(torch, np, crt):
    """Phase 20: the regeneration pool, the CLI (render and bench), the
    viewer and the sharded renderer on the card. Returns the numbers."""
    numbers = {}
    for name, check in (("pool", check_pool), ("cli", check_cli),
                        ("viewer", check_viewer),
                        ("sharded", check_sharded)):
        t0 = time.perf_counter()
        check(torch, np, crt, numbers)
        numbers[name]["phase_s"] = time.perf_counter() - t0
    return numbers


# phase 21: the counter RNG's site kernel at the benchmark cells' sites:
# (label, frame, samples a pixel, passes packed into the wavefront, lanes
# kept of it (the narrowed wavefront) or None, bounces, draws, jitter)
RNG_SITES = (
    ("hero nee", (1920, 1088), 1, 4, None, 8, 3, False),
    ("4k narrowed nee", (3840, 2160), 1, 1, 2_073_600, 8, 3, False),
    ("preview camera", (1920, 1088), 4, 1, None, 4, 2, True),
)
RNG_BOUNCE = 3  # the NEE sites' bounce: offset 2 * bounce
RNG_ACCUMULATION = 4_000_000_123  # the first pass index, past 2^31


def check_rng_sites(torch, timer):
    """Phase 21: rng.site_draws (the rng_site kernel) against
    site_draws_plain on the same inputs, bit for bit, at each RNG_SITES
    site: the pixel seeds of the cell's wavefront (renderer's
    pixel_seeds_from_index), its lanes narrowed to a seeded subset where
    the site runs on the narrowed wavefront, one accumulation a lane where
    passes are packed. Both timed; returns the kernels-line row at the
    hero's NEE site, the other sites' numbers beside it."""
    from cpu_raytracing_experiments_tpu_torch.core import rng
    from cpu_raytracing_experiments_tpu_torch.render import renderer
    from cpu_raytracing_experiments_tpu_torch.utils.config import \
        RendererPolicy

    gen = torch.Generator(device=DEVICE).manual_seed(21)
    rows = {}
    for (label, (width, height), spp, packed, kept, bounces, n,
         jitter) in RNG_SITES:
        policy = RendererPolicy(max_bounces=bounces, samples_per_pixel=spp)
        per_pass = width * height * spp
        ray = torch.arange(per_pass * packed, dtype=torch.int64,
                           device=DEVICE)
        if kept is not None:
            ray = torch.randperm(ray.numel(), generator=gen,
                                 device=DEVICE)[:kept].sort().values
        r_in_pass = ray % per_pass
        seeds = renderer.pixel_seeds_from_index(
            r_in_pass // spp, width, policy, r_in_pass % spp)
        acc = (rng.add32(RNG_ACCUMULATION, ray // per_pass) if packed > 1
               else RNG_ACCUMULATION)
        offset = 0 if jitter else 2 * RNG_BOUNCE
        lanes = seeds.numel()
        del ray, r_in_pass

        def kern():
            return rng.site_draws(acc, seeds, offset, n, False, jitter=jitter)

        def plain():
            return rng.site_draws_plain(acc, seeds, offset, n, False,
                                        jitter=jitter)

        got, want = kern(), plain()
        differ = int((got.view(torch.int32) != want.view(torch.int32)).sum())
        log(f"[21 rng_site] {label}: {lanes} lanes, {n} draws"
            f"{', the jitter' if jitter else ''}, accumulation "
            f"{'one a lane' if packed > 1 else 'one value'}: {differ} of "
            f"{got.numel()} draws differ from the plain version")
        if differ or got.shape != want.shape:
            raise AssertionError(f"rng_site differs at the {label} site")
        del got, want
        ms = timer(kern, 20)
        plain_ms = timer(plain, 5, warmup=1)
        nbytes = lanes * (8 + (8 if packed > 1 else 0) + 4 * n)
        rows[label] = kernel_row(
            "rng_site", RNG_SOURCE,
            f"{lanes} lanes x {n} draws ({label})", 0, 0.0, ms, plain_ms,
            nbytes, 0)
        log(f"[21 rng_site] {label}: {ms:.4f} ms (bound "
            f"{rows[label]['bound_ms']:.4f} ms by bytes); plain "
            f"{plain_ms:.3f} ms")
        del seeds, acc
        torch.cuda.empty_cache()
    main = rows.pop(RNG_SITES[0][0])
    main["at_other_sites"] = {
        label: {k: row[k] for k in ("shape", "ms", "plain_ms", "bound_ms")}
        for label, row in rows.items()}
    return main


# phase 22: NEE toward sphere lights (csrc/nee.cu) at the benchmark cells'
# shapes: (label, scene, frame, passes packed into the wavefront); every
# bounce of one wavefront is captured
NEE_SITES = (
    ("hero", "hero", (1920, 1088), 4),
    ("4k", "mesh", (3840, 2160), 1),
)
NEE_ACCUMULATION = 4_000_000_123  # the first pass index, past 2^31


def nee_bounces(torch, crt, scene, width, height, packed):
    """The operands of renderer._nee_sphere_kernels at every bounce of one
    wavefront of `packed` passes (REFERENCE_FIXED at 8 bounces, 2^23 lanes
    a chunk, as the cells run), each bounce's shadow-query answer with
    them."""
    from cpu_raytracing_experiments_tpu_torch.ops import intersect
    from cpu_raytracing_experiments_tpu_torch.render import renderer

    got = []
    real = renderer._nee_sphere_kernels

    def capture(scene_, policy, state, accumulation, seeds, hit, prim_id,
                is_tri, p_offset, t_quat, mat, radiance):
        out = real(scene_, policy, state, accumulation, seeds, hit, prim_id,
                   is_tri, p_offset, t_quat, mat, radiance)
        l_dir, tfar, valid, _ = renderer.nee_kernel.nee_sphere(
            hit, prim_id, is_tri, p_offset, t_quat, mat["albedo"],
            state.throughput,
            renderer.rng.site_draws(accumulation, seeds, 2 * state.bounce, 3,
                                    policy.rng_scramble),
            renderer._sphere_light_table(scene_))
        occluded = intersect.occluded_scene(
            scene_, p_offset, l_dir, tfar, accel=policy.effective_accel,
            policy=policy)
        got.append(dict(scene=scene_, policy=policy, state=state,
                        accumulation=accumulation, seeds=seeds, hit=hit,
                        prim_id=prim_id, is_tri=is_tri, p_offset=p_offset,
                        t_quat=t_quat, mat={"albedo": mat["albedo"]},
                        radiance=radiance, occluded=occluded))
        return out

    policy = crt.RendererPolicy(max_bounces=8, rays_per_chunk=1 << 23,
                                **({"accel": "pallas"} if scene.triangles
                                   is not None else {}))
    r = crt.Renderer(scene, policy, width, height)
    # the window's first pass past 2^31, as the harness's seeds put it
    r.state = dataclasses.replace(r.state, accumulations=NEE_ACCUMULATION)
    renderer._nee_sphere_kernels = capture
    try:
        r.accumulate(packed)
    finally:
        renderer._nee_sphere_kernels = real
    return got


def check_nee_sites(torch, crt, timer, mesh_scene):
    """Phase 22: at every bounce of the hero cell's wavefront (1920x1088,
    4 passes packed, 8,355,840 lanes, 3 lights) and of the 4K cell's
    (3840x2160 on mesh100k, 8,294,400 lanes, narrowed), nee_sphere and
    nee_combine against the plain path (_next_event_estimation and its add,
    the shadow query answered alike), l_dir, tfar, valid and the radiance
    bit for bit; the kernels' time a pass beside their byte bound, with the
    site's draws and against the plain composite's; and over one profiled
    hero pass, no int64 row gather (vectorized_gather_kernel) left, with the
    plain path's for comparison. Returns the kernels-line row at the hero's
    shape, the 4K cell's numbers beside it."""
    from torch.profiler import ProfilerActivity, profile

    from cpu_raytracing_experiments_tpu_torch.ops import intersect
    from cpu_raytracing_experiments_tpu_torch.ops.kernels import nee as nk
    from cpu_raytracing_experiments_tpu_torch.render import renderer

    rows = {}
    for label, kind, (width, height), packed in NEE_SITES:
        scene = (crt.builders.default_scene(width, height).to(DEVICE)
                 if kind == "hero" else mesh_scene)
        bounces = nee_bounces(torch, crt, scene, width, height, packed)
        ms = {"kernels": 0.0, "with draws": 0.0, "plain": 0.0}
        nbytes = 0
        shapes = []
        for k, b in enumerate(bounces):
            hit, n = b["hit"], b["hit"].shape[0]
            table = renderer._sphere_light_table(b["scene"])
            draws = renderer.rng.site_draws(
                b["accumulation"], b["seeds"], 2 * b["state"].bounce, 3,
                b["policy"].rng_scramble)

            def kernels(draws=draws, b=b, table=table):
                l_dir, tfar, valid, sh = nk.nee_sphere(
                    b["hit"], b["prim_id"], b["is_tri"], b["p_offset"],
                    b["t_quat"], b["mat"]["albedo"], b["state"].throughput,
                    draws, table)
                return (l_dir, tfar, valid, nk.nee_combine(
                    b["radiance"], valid, b["occluded"], sh))

            def with_draws(b=b, table=table):
                d = renderer.rng.site_draws(
                    b["accumulation"], b["seeds"], 2 * b["state"].bounce, 3,
                    b["policy"].rng_scramble)
                return kernels(d, b, table)

            seen = {}

            def answer(scene_, p, d, tfar, b=b, **kw):
                seen["d"], seen["tfar"] = d, tfar
                return b["occluded"]

            def plain(b=b):
                nee, valid, _ = renderer._next_event_estimation(
                    b["scene"], b["policy"], b["state"], b["accumulation"],
                    b["seeds"], b["hit"], b["prim_id"], b["is_tri"],
                    b["p_offset"], b["t_quat"], None, b["mat"])
                return valid, b["radiance"] + nee

            real = intersect.occluded_scene
            intersect.occluded_scene = answer
            try:
                valid_p, rad_p = plain()
                l_dir, tfar, valid, rad = kernels()
                differ = sum(
                    int((x.view(torch.int32) != y.view(torch.int32)).sum())
                    for x, y in zip((*l_dir, tfar, *rad),
                                    (*seen["d"], seen["tfar"], *rad_p)))
                differ += int((valid != valid_p).sum())
                if differ:
                    raise AssertionError(
                        f"[22 nee] {label} bounce {k}: {differ} values of "
                        "the kernels differ from the plain path")
                live = int(hit.sum())
                lit = int((valid & ~b["occluded"]).sum())
                shapes.append((n, live, int(valid.sum())))
                # nee_sphere: a live lane reads 78 B, every lane its mask
                # and 29 B of outputs; nee_combine: the radiance, the masks
                # and the new radiance, the shadow radiance where it adds
                nbytes += live * 78 + n * 30 + n * 26 + lit * 12
                ms["kernels"] += timer(kernels, 10)
                ms["with draws"] += timer(with_draws, 10)
                ms["plain"] += timer(plain, 3, warmup=1)
            finally:
                intersect.occluded_scene = real
        per_pass = {k: v / packed for k, v in ms.items()}
        rows[label] = kernel_row(
            "nee_sphere", NEE_SOURCE,
            f"{label}: {len(bounces)} bounces of {shapes[0][0]} lanes "
            f"(the last {shapes[-1][0]}), a pass of {packed}", 0, 0.0,
            per_pass["kernels"], per_pass["plain"], nbytes / packed, 0)
        rows[label]["with_draws_ms"] = per_pass["with draws"]
        rows[label]["lanes_live_valid"] = shapes
        log(f"[22 nee] {label}: bit for bit at {len(bounces)} bounces "
            f"(lanes, live, valid: {shapes}); a pass: nee_sphere + "
            f"nee_combine {per_pass['kernels']:.4f} ms (bound "
            f"{rows[label]['bound_ms']:.4f} ms by bytes), with the site's "
            f"draws {per_pass['with draws']:.4f} ms; the plain composite "
            f"{per_pass['plain']:.3f} ms")
        del bounces
        torch.cuda.empty_cache()

    # one profiled hero pass on each path: the light-row gather is gone
    hero = crt.builders.default_scene(1920, 1088).to(DEVICE)
    gathers = {}
    for path in ("kernels", "plain"):
        r = crt.Renderer(hero, crt.RendererPolicy(
            max_bounces=8, rays_per_chunk=1 << 23), 1920, 1088)
        real = renderer.nee_kernel_path
        if path == "plain":
            renderer.nee_kernel_path = lambda *a: False
        try:
            r.accumulate(1)
            torch.cuda.synchronize()
            before = nk.SPHERE.launches
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                r.accumulate(1)
                torch.cuda.synchronize()
        finally:
            renderer.nee_kernel_path = real
        found = [(ev.key, ev.count, ev.self_device_time_total / 1e3)
                 for ev in prof.key_averages()
                 if "vectorized_gather_kernel" in ev.key]
        gathers[path] = {"launches": sum(c for _, c, _ in found),
                         "device_ms": sum(t for _, _, t in found),
                         "nee_sphere": nk.SPHERE.launches - before}
    log(f"[22 nee] one profiled 1920x1088 hero pass: vectorized_gather_"
        f"kernel {gathers}")
    if gathers["kernels"]["launches"] or gathers["kernels"][
            "nee_sphere"] != 8 or not gathers["plain"]["launches"]:
        raise AssertionError(f"[22 nee] the hero pass's gathers {gathers}")
    main = rows.pop(NEE_SITES[0][0])
    main["hero_pass_row_gathers"] = gathers
    main["at_other_sites"] = {
        label: {k: row[k] for k in ("shape", "ms", "plain_ms", "bound_ms",
                                    "with_draws_ms")}
        for label, row in rows.items()}
    return main


# phase 23: the lambertian hit shading (csrc/shade.cu) at the benchmark
# cells' shapes (NEE_SITES'): every bounce of one wavefront is captured
SHADE_BOUNCE_BYTES = 112  # both kernels, a lane: its masks, the state it
# carries (read and written anew) and shade_frame's hit byte
SHADE_ALIVE_BYTES = 4  # an alive lane's prim id
SHADE_HIT_BYTES = 109  # a hit lane's is_tri, tfar, p, d and the frame's 40 B
# written, then read again by shade_tail with the BSDF site's draws


def shade_bounces(torch, crt, scene, width, height, packed):
    """The operands of renderer._bounce_kernels at every bounce of one
    wavefront of `packed` passes (REFERENCE_FIXED at 8 bounces, 2^23 lanes
    a chunk, as the cells run), each with the state it returned."""
    from cpu_raytracing_experiments_tpu_torch.render import renderer

    got = []
    real = renderer._bounce_kernels

    def capture(scene_, policy, accumulation, seeds, state, tfar, prim_id,
                is_tri):
        out = real(scene_, policy, accumulation, seeds, state, tfar, prim_id,
                   is_tri)
        got.append(dict(scene=scene_, policy=policy,
                        accumulation=accumulation, seeds=seeds, state=state,
                        answer=(tfar, prim_id, is_tri), out=out))
        return out

    policy = crt.RendererPolicy(max_bounces=8, rays_per_chunk=1 << 23,
                                **({"accel": "pallas"} if scene.triangles
                                   is not None else {}))
    r = crt.Renderer(scene, policy, width, height)
    r.state = dataclasses.replace(r.state, accumulations=NEE_ACCUMULATION)
    renderer._bounce_kernels = capture
    try:
        r.accumulate(packed)
    finally:
        renderer._bounce_kernels = real
    return got


def csrc_launches(fn):
    """The hand-written kernels `fn()` launches, by name (the counters that
    ``build.launch`` keeps)."""
    from cpu_raytracing_experiments_tpu_torch.ops.kernels import build

    before = build.launch_counts()
    fn()
    return {k: v - before[k] for k, v in build.launch_counts().items()
            if v != before[k]}


def check_shade_sites(torch, crt, timer, mesh_scene):
    """Phase 23: at every bounce of the hero cell's wavefront (1920x1088,
    4 passes packed, 8,355,840 lanes) and of the 4K cell's (3840x2160 on
    mesh100k, 8,294,400 lanes, narrowed): shade_frame against
    _closest_hit_frame and _gather_material at the hit lanes, and the
    bounce the kernels shaded against bounce_step on the plain path with
    the intersection answered alike, every PathState field bit for bit;
    shade_frame + shade_tail timed against their byte bound; the bounce
    after the intersection on both paths with NEE's and the BSDF draws'
    time taken off (the eager spans the kernels replace against the
    kernels), and the hand-written launches of one kernel bounce. Returns the
    kernels-line row at the hero's shape, the 4K cell's numbers beside
    it."""
    from cpu_raytracing_experiments_tpu_torch.ops import intersect
    from cpu_raytracing_experiments_tpu_torch.ops.kernels import shade as sk
    from cpu_raytracing_experiments_tpu_torch.render import renderer

    rows = {}
    for label, kind, (width, height), packed in NEE_SITES:
        scene = (crt.builders.default_scene(width, height).to(DEVICE)
                 if kind == "hero" else mesh_scene)
        bounces = shade_bounces(torch, crt, scene, width, height, packed)
        ms = {"kernels": 0.0, "kernel bounce": 0.0, "plain bounce": 0.0,
              "nee and draws": 0.0}
        nbytes = 0
        shapes, launches = [], {}
        for k, b in enumerate(bounces):
            st, pol, (tfar, prim, is_tri) = b["state"], b["policy"], \
                b["answer"]
            cols = sk.scene_columns(b["scene"].spheres, b["scene"].triangles,
                                    b["scene"].materials, b["scene"].sky)
            hit, p_off, quat, albedo, mat = sk.shade_frame(
                st.alive, prim, is_tri, tfar, st.p, st.d, cols)
            rad, valid = renderer._nee_sphere_kernels(
                b["scene"], pol, st, b["accumulation"], b["seeds"], hit,
                prim, is_tri, p_off, quat, {"albedo": albedo}, st.radiance)
            draws = renderer.rng.site_draws(
                b["accumulation"], b["seeds"], 2 * st.bounce + 1, 3,
                pol.rng_scramble)
            n_lights = b["scene"].num_lights
            flags = dict(use_mis=pol.mis and n_lights > 0 and st.bounce > 0,
                         inv_l=1.0 / max(n_lights, 1),
                         roulette=pol.russian_roulette,
                         sky_compat=pol.sky_bug_compat,
                         last=st.bounce + 1 >= pol.max_bounces)

            def kernels(b=b, st=st, cols=cols, rad=rad, valid=valid,
                        draws=draws, flags=flags, tfar=tfar, prim=prim,
                        is_tri=is_tri):
                hit, p_off, quat, albedo, mat = sk.shade_frame(
                    st.alive, prim, is_tri, tfar, st.p, st.d, cols)
                return sk.shade_tail(
                    st.alive, hit, prim, is_tri, tfar, mat, quat, p_off,
                    st.p, st.d, st.throughput, rad, st.prev_pdf,
                    st.prev_delta, valid, st.ray_count, draws, cols,
                    **flags)

            def nee_and_draws(b=b, st=st, hit=hit, prim=prim, is_tri=is_tri,
                              p_off=p_off, quat=quat, albedo=albedo):
                renderer._nee_sphere_kernels(
                    b["scene"], b["policy"], st, b["accumulation"],
                    b["seeds"], hit, prim, is_tri, p_off, quat,
                    {"albedo": albedo}, st.radiance)
                renderer.rng.site_draws(
                    b["accumulation"], b["seeds"], 2 * st.bounce + 1, 3,
                    b["policy"].rng_scramble)

            def step(b=b):
                return renderer.bounce_step(b["scene"], b["policy"],
                                            b["accumulation"], b["seeds"],
                                            b["state"])

            real_intersect = intersect.intersect_scene
            real_path = renderer.shade_kernel_path
            intersect.intersect_scene = \
                lambda *a, b=b, **kw: b["answer"]
            try:
                renderer.shade_kernel_path = lambda *a: False
                want = step()
                ms["plain bounce"] += timer(step, 3, warmup=1)
                renderer.shade_kernel_path = real_path
                bounce_launches = csrc_launches(step)
                ms["kernel bounce"] += timer(step, 10)
            finally:
                intersect.intersect_scene = real_intersect
                renderer.shade_kernel_path = real_path
            got = b["out"]
            differ = []
            for field in ("p", "d", "throughput", "radiance"):
                for a, w in zip(getattr(got, field), getattr(want, field)):
                    differ.append(int((a.view(torch.int32)
                                       != w.view(torch.int32)).sum()))
            for field in ("prev_pdf",):
                differ.append(int((getattr(got, field).view(torch.int32)
                                   != getattr(want, field).view(
                                       torch.int32)).sum()))
            for field in ("prev_delta", "alive"):
                differ.append(int((getattr(got, field)
                                   != getattr(want, field)).sum()))
            differ.append(int(got.ray_count != want.ray_count))
            w_off, _, w_quat, _, w_mat, _, _, _ = \
                renderer._closest_hit_frame(b["scene"], st, tfar, prim,
                                            is_tri)
            w_alb = renderer._gather_material(b["scene"], pol,
                                              w_mat)["albedo"]
            want_hit = st.alive & (prim >= 0)
            differ.append(int((hit != want_hit).sum()))
            for a, w in zip((*p_off, quat.x, quat.y, quat.w, *albedo),
                            (*w_off, w_quat.x, w_quat.y, w_quat.w, *w_alb)):
                differ.append(int((a.view(torch.int32)[hit]
                                   != w.view(torch.int32)[hit]).sum()))
            differ.append(int((mat[hit] != w_mat[hit]).sum()))
            if any(differ):
                raise AssertionError(
                    f"[23 shade] {label} bounce {k}: {sum(differ)} values of "
                    f"the kernels differ from the plain path ({differ})")
            n = int(hit.shape[0])
            alive, live = int(st.alive.sum()), int(hit.sum())
            shapes.append((n, alive, live))
            nbytes += (n * SHADE_BOUNCE_BYTES + alive * SHADE_ALIVE_BYTES
                       + live * SHADE_HIT_BYTES)
            ms["kernels"] += timer(kernels, 10)
            ms["nee and draws"] += timer(nee_and_draws, 10)
            if k == 1:
                launches = bounce_launches
        per_pass = {k: v / packed for k, v in ms.items()}
        eager_spans = per_pass["plain bounce"] - per_pass["nee and draws"]
        kernel_spans = per_pass["kernel bounce"] - per_pass["nee and draws"]
        rows[label] = kernel_row(
            "shade_frame", SHADE_SOURCE,
            f"{label}: {len(bounces)} bounces of {shapes[0][0]} lanes "
            f"(the last {shapes[-1][0]}), a pass of {packed}", 0, 0.0,
            per_pass["kernels"], eager_spans, nbytes / packed, 0)
        rows[label].update({
            "kernel_spans_ms": kernel_spans,
            "bounce_ms": {k: per_pass[k] for k in ("kernel bounce",
                                                   "plain bounce",
                                                   "nee and draws")},
            "lanes_alive_hit": shapes,
            "csrc_launches_a_bounce": launches,
            "kernel_launches_a_pass": 2 * len(bounces) / packed})
        log(f"[23 shade] {label}: bit for bit at {len(bounces)} bounces "
            f"(lanes, alive, hit: {shapes}); a pass: shade_frame + "
            f"shade_tail {per_pass['kernels']:.4f} ms (bound "
            f"{rows[label]['bound_ms']:.4f} ms by bytes); after the "
            f"intersection, less NEE and the draws "
            f"({per_pass['nee and draws']:.4f} ms): kernels "
            f"{kernel_spans:.4f} ms, plain {eager_spans:.4f} ms; hand-written "
            f"launches of kernel bounce 1 {launches}")
        del bounces
        torch.cuda.empty_cache()
    main = rows.pop(NEE_SITES[0][0])
    main["at_other_sites"] = {
        label: {k: row[k] for k in ("shape", "ms", "plain_ms", "bound_ms",
                                    "kernel_spans_ms",
                                    "csrc_launches_a_bounce")}
        for label, row in rows.items()}
    return main


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
        bvh_walk as bw
    from cpu_raytracing_experiments_tpu_torch.ops.kernels import \
        cluster_traverse as ct
    from cpu_raytracing_experiments_tpu_torch.ops.kernels import fma as kf
    from cpu_raytracing_experiments_tpu_torch.ops.kernels import \
        grid_walk as gw
    from cpu_raytracing_experiments_tpu_torch.ops.kernels import \
        light_rows as lr
    from cpu_raytracing_experiments_tpu_torch.ops.kernels import nee as nk
    from cpu_raytracing_experiments_tpu_torch.ops.kernels import rng as rk
    from cpu_raytracing_experiments_tpu_torch.ops.kernels import \
        shade as sk
    from cpu_raytracing_experiments_tpu_torch.ops.kernels import \
        sphere_battery as sb
    from cpu_raytracing_experiments_tpu_torch.utils import native

    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = gpu_name_power()
    log(f"[1] {card}; torch {torch.__version__} cuda {torch.version.cuda}; "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; "
        "clocks.max.sm " + subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.max.sm",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip())
    t0 = time.perf_counter()
    libraries = (sb.LIBRARY, ct.LIBRARY, kf.LIBRARY, lr.LIBRARY,
                 bw.LIBRARY, gw.LIBRARY, rk.LIBRARY, nk.LIBRARY,
                 sk.LIBRARY, native.LIBRARY)
    build.load_all(libraries)
    log(f"[1] csrc/ built side by side and loaded in {time.perf_counter() - t0:.1f} s "
        f"({', '.join(lib.source.name for lib in libraries)})")
    for lib in libraries:
        for line in lib.build_log.strip().splitlines():
            if "Used" in line or "error" in line or "warning" in line:
                log(f"    {lib.source.name}:", line.strip())
    report_kernels(libraries)

    timer = Timer(torch)
    fma_rows, fma_host = check_fma_forms(torch, np, timer)
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
    check_closest_tables(torch, np, hero.spheres, field.spheres)
    check_occluded_tables(torch, np, hero.spheres, field.spheres)
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
    # NEE and the hit shading are csrc/nee.cu's and csrc/shade.cu's
    # kernels here: the fma kernels run for the camera rays only (fma and
    # fma3 of the view direction's rotation)
    camera_forms = ("fma", "fma[fma3]")
    _, hero_path = render(torch, crt, hero,
                          pol(max_bounces=8, rays_per_chunk=1 << 19),
                          1920, 1088, PASSES, "5 hero",
                          sphere_kernels + camera_forms
                          + ("rng_site", "nee_sphere", "nee_combine",
                             "shade_frame", "shade_tail"),
                          idle=tuple(f for f in FMA_FORMS
                                     if f not in camera_forms)
                          + ("fma[strided]",))
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

    # the tie batch: the streamed walks where (t, slot) ties are certain
    ties = tie_pack(np, meshes[224].tri_clusters)
    batches = cluster_rays(torch, np, crt, meshes[224], ties, 19,
                           narrowed=False)
    for kind, rays in batches.items():
        check_ties(torch, ties, rays, f"11 ties, {kind} rays")
    del ties, batches

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
            *FRAME, 2, f"13 {name}",
            expect + sphere_kernels + ("rng_site",),
            idle if uv_res == 224 else idle + resident[1:],
            {"mesh 100k pallas": planned_per_tile,
             "mesh 1.3M pallas": lambda r: walk_counts(torch, r)}.get(name))
    log(f"[13 mesh 100k pallas] clusters planned a tile over one pass: "
        f"{mesh_paths['mesh 100k pallas']['probe']}")

    # ---- phase 14: the planners ----
    log(f"[14] phases 1-13 done at {time.perf_counter() - t_start:.1f} s")
    planner_kernels = tuple(REPLACES)[-7:]
    planners = ("cluster_plan",) + planner_kernels
    gmesh = crt.accel.with_pallas_clusters(meshes[224], **GROUP_PACK)
    gbig = crt.accel.with_pallas_clusters(big, **GROUP_PACK)
    plan_rows, plan_numbers = {}, {}
    for tname, scene, grouped, cp, gcp in (
            ("mesh 100k", meshes[224], gmesh, meshes[224].tri_clusters,
             gmesh.tri_clusters),
            ("100k spheres", big, gbig, big.sphere_clusters,
             gbig.sphere_clusters)):
        batches = cluster_rays(torch, np, crt, scene, cp, 17, narrowed=True)
        for kind in ("camera", "narrowed", "diffuse"):
            plan_rows[tname, kind], plan_numbers[tname, kind] = \
                check_planners(torch, timer, cp, gcp, batches[kind],
                               f"14 {tname}, {kind} rays",
                               stats=(tname, kind) == ("mesh 100k",
                                                       "narrowed"))
            check_cluster_limit(torch, cp, gcp, batches[kind],
                                f"14 {tname}, {kind} rays")
        del batches
    del gbig
    log(f"[14] planner checks done at {time.perf_counter() - t_start:.1f} s")
    planner_paths = {}
    for i, (name, kw, grouped, kernel) in enumerate(PLANNER_RENDERS):
        extra = i >= len(PLANNER_RENDERS) - 2
        # a tilebox pass takes seconds: one pass a window there
        _, planner_paths[name] = render(
            torch, crt, gmesh if grouped else meshes[224],
            pol(max_bounces=8, accel="pallas", **kw), *FRAME,
            1 if extra or name == "tilebox" else 2, f"14 mesh 100k {name}",
            (kernel,) + resident[1:] + sphere_kernels,
            tuple(k for k in planners if k != kernel), planned_per_tile,
            profiled=not extra)
        log(f"[14 mesh 100k {name}] clusters planned a tile over one pass: "
            f"{planner_paths[name]['probe']}")
    small_group = crt.accel.with_pallas_clusters(
        crt.builders.mesh_scene(96, 96, subdivisions=3), **GROUP_PACK)
    for name, scene, kernel in (
            ("group", small_group, "cluster_plan[group]"),
            ("tilebox", small_mesh, "cluster_plan_rows[tilebox]")):
        r = crt.Renderer(scene, pol(
            max_bounces=6, rays_per_chunk=9216, accel="pallas",
            pallas_tile_rays=64, pallas_plan=name), 96, 96)
        build.reset_counts()
        r.accumulate(10)
        if build.launch_counts()[kernel] <= 0:
            raise AssertionError(f"[14 mesh {name}] {kernel} never launched")
        golden_check(np, r.render(tonemap=False), f"mesh pallas {name}")

    log(f"[15] phases 1-14 done at {time.perf_counter() - t_start:.1f} s")
    stream2_rows = check_stream2(torch, timer)
    log(f"[16] phases 1-15 done at {time.perf_counter() - t_start:.1f} s")
    t0 = time.perf_counter()
    shading = check_shading_knobs(torch, np, crt)
    log(f"[16] shading knobs checked in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    light_rows_row = check_light_rows(torch, timer)
    light_paths = check_light_modes(torch, np, crt)
    light_paths[POWER_FULL[0]] = check_power_full(torch, crt)
    light_rows_row["launches"] = \
        light_paths[POWER_FULL[0]]["launches"]["light_rows"]
    log(f"[17] light selection checked in {time.perf_counter() - t0:.1f} s")
    log(f"[18] phases 1-17 done at {time.perf_counter() - t_start:.1f} s")
    t0 = time.perf_counter()
    host_paths = check_host_paths(torch, np, crt)
    host_paths["phase_s"] = time.perf_counter() - t0
    log(f"[18] host features checked in {host_paths['phase_s']:.1f} s")
    log(f"[19] phases 1-18 done at {time.perf_counter() - t_start:.1f} s")
    t0 = time.perf_counter()
    accel_paths, walk_rows = check_accel_paths(torch, np, crt, timer)
    accel_paths["phase_s"] = time.perf_counter() - t0
    log(f"[19] the backends without Pallas checked in "
        f"{accel_paths['phase_s']:.1f} s")
    log(f"[20] phases 1-19 done at {time.perf_counter() - t_start:.1f} s")
    t0 = time.perf_counter()
    shell_paths = check_shell_paths(torch, np, crt)
    shell_paths["phase_s"] = time.perf_counter() - t0
    log(f"[20] the pool, the shell and multi-device checked in "
        f"{shell_paths['phase_s']:.1f} s")
    log(f"[21] phases 1-20 done at {time.perf_counter() - t_start:.1f} s")
    rng_row = check_rng_sites(torch, timer)
    rng_row["launches"] = hero_path["launches"]["rng_site"]
    log(f"[22] phases 1-21 done at {time.perf_counter() - t_start:.1f} s")
    nee_row = check_nee_sites(torch, crt, timer, meshes[224])
    nee_row["launches"] = hero_path["launches"]["nee_sphere"]
    log(f"[23] phases 1-22 done at {time.perf_counter() - t_start:.1f} s")
    shade_row = check_shade_sites(torch, crt, timer, meshes[224])
    shade_row["launches"] = hero_path["launches"]["shade_frame"]
    # each walk's row at the field's camera batch (bvh_occluded's at the
    # field render's own shadow rays), its launches from the field's render
    # under that backend
    walk_main = {}
    for (sname, name, bname), row in walk_rows.items():
        render_nums = accel_paths["renders"].get(sname)
        row["launches"] = (render_nums["launches"][name]
                           if render_nums else 0)
        main_batch = "shadow" if name == "bvh_occluded" else "camera"
        if sname.startswith("field") and bname == main_batch:
            walk_main[name] = row

    for rows, path in ((hero_rows, hero_path), (field_rows, field_path)):
        for name, row in rows.items():
            row["launches"] = path["launches"][name]
    for name, row in fma_rows.items():
        row["launches"] = hero_path["launches"][name]
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
    # each planner kernel's launches: those of the first render that takes it
    first_path = {}
    for name, _, _, kernel in PLANNER_RENDERS:
        first_path.setdefault(kernel, planner_paths[name])
    for (tname, _), rows in plan_rows.items():
        for name, row in rows.items():
            # the 100,000-sphere table is on no planner render
            row["launches"] = (first_path[name]["launches"][name]
                               if tname == "mesh 100k" else 0)
    main_rows = dict(cluster_rows.pop(("100k spheres", "diffuse")))
    # the streamed walks' main-path shape is the 1.3 M-triangle table's
    cluster_rows["100k spheres", "diffuse, streamed"] = {
        k: main_rows.pop(k) for k in list(main_rows) if k.endswith("_stream")}
    new_rows = {name: mesh_rows[810, "narrowed"].pop(name)
                for name in streamed[1:]}
    new_rows.update({name: mesh_rows[224, "narrowed"].pop(name)
                     for name in product[1:]})
    new_rows.update({name: plan_rows["mesh 100k", "narrowed"].pop(name)
                     for name in planner_kernels})
    log(card)
    log(json.dumps({"kernels_at_1k_spheres": list(field_rows.values())}))
    log(json.dumps({"cluster_kernels_at_other_shapes": [
        row for rows in (list(cluster_rows.values()) + list(mesh_rows.values())
                         + list(plan_rows.values()))
        for row in rows.values()]}))
    log(json.dumps({"planners_per_tile": {
        f"{tname}, {kind}": v for (tname, kind), v in plan_numbers.items()}}))
    log(json.dumps({"fma_host_us_a_call": fma_host}))
    log(json.dumps({"shading_paths": shading}))
    log(json.dumps({"light_paths": light_paths}))
    log(json.dumps({"host_paths": host_paths}))
    log(json.dumps({"walk_kernels_at_other_shapes": [
        row for row in walk_rows.values()
        if row not in walk_main.values()]}))
    log(json.dumps({"accel_paths": accel_paths}))
    log(json.dumps({"shell_paths": shell_paths}))
    log(card)
    log(json.dumps({"kernels": list(hero_rows.values())
                    + list(fma_rows.values())
                    + list(main_rows.values()) + list(new_rows.values())
                    + list(stream2_rows.values()) + [light_rows_row]
                    + [walk_main[name] for name in WALKS] + [rng_row]
                    + [nee_row, shade_row]}))
    log(f"chip_smoke: every phase passed in "
        f"{time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
