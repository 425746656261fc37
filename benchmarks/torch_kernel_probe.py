#!/usr/bin/env python3
"""Time the PyTorch port's kernels of one checkout on the card, at the
widths the full-width renders launch them with, after checking each
against its plain version.

    python3 benchmarks/torch_kernel_probe.py TREE LABEL [--kernels K,...]
        [--out DIR]

TREE is the root of a checkout of this repository (its chip_smoke.py and
its cpu_raytracing_experiments_tpu_torch package are imported from there),
LABEL a name for its lines. To compare two versions of a kernel, unpack
both into directories that .gitignore lists and run them in turns in one
call on one card (A, B, B, A). For each kernel asked for (all by default)
it prints JSON lines:
  plan      cluster_plan in modes 'ray' and 'super' (equal to plain, ms);
  rows      cluster_plan_rows in every mode, 'group' on a group-box pack
            (not made for the 1.3 M-triangle table), equal to plain and ms;
  closest   cluster_closest at S = 1, 2, 4 (equal to plain, except on the
            1.3 M-triangle table, where the plain walk is too slow; ms),
            the product form too on the 100,352-triangle mesh;
  occluded  cluster_occluded at S = 1, 2, 4 on shadow rays to just behind
            (even lanes) or just before (odd lanes) each closest hit,
            equal to plain and, on tables of 128 or more prims a cluster,
            to cluster_occluded_stream at the same S; ms; the product form
            too on the 100,352-triangle mesh;
  fma       fp.fma on 2^19 contiguous lanes and each contraction that
            core/ chains from it (fp.dot3, the three lanes of hit_pt =
            d * t + p, sampling.to_local and to_world) on 2^19 lanes:
            equal to the chain of fp.fma_plain, kernel launches a call, ms,
            and the host microseconds a call takes (2000 calls on 1024
            lanes, no synchronize between them); fp.fma on 2^19 lanes with
            c a column of an [n, 8] table (the hero's light sampler):
            kernels launched, equal to plain, ms; as yardsticks of the
            card's elementwise rate, torch.add and torch.addcmul on the
            same 2^19 lanes and fp.fma on 1024;
  sphere    sphere_closest and sphere_occluded at 2^19 rays x the hero's 9
            spheres and 262,144 and 2^19 rays x the 1000-sphere field
            (equal to plain, ms), sphere_occluded also on the table sorted
            by radius, largest first (the any-hit result does not depend
            on the order), with the pairs the rays need and the warp pairs
            (chip_smoke.any_hit_pairs, where the checkout has it); both
            kernels at 2^19 rays on tables of 1-256 spheres (equal to
            plain, ms); the SASS of csrc/sphere_battery.cu into DIR;
  replay    stream_replay on diag/stream2.py's pack (100,000 triangles,
            K = 256), planned over all its rays: at tile 0 and the tile
            with the most visits equal to plain, its grid (where the
            checkout has replay_blocks), ms, and an index_select of the
            same rows (ms); ms also at the tile with the fewest visits, on
            the busiest tile into an output of exactly nv visits, and on
            the grids of a one- and a four-SM card;
  grid      grid_closest and grid_occluded on phase 19's grids: the
            81,920-triangle mesh's (res 48, 33,576 residual triangles) on
            camera, diffuse and axis-aligned batches of 2^16 rays (equal to
            plain, ms) and on the camera rays of a 2^19-ray chunk (ms
            only: the plain residual battery is too slow there), and the
            1000-sphere field's (res 32, no residual) on the three batches
            of 2^19 (equal to plain, ms); the SASS of
            csrc/grid_walk.cu into DIR;
  hero      the hero scene at 256x256, 8 bounces, 2 passes through
            Renderer.accumulate: the buckets' SHA-256 and their equality
            with every other checkout's buckets saved in DIR, the kernel
            launches a pass by the wrappers' counters, and one profiled
            pass's kernel launches; then at 1920x1088 its ms/pass (median of
            three windows of three passes) and one profiled pass's kernel
            launches and device busy time.
DIR (--out, default probe_out) holds the saved buckets and SASS. Every
time is a CUDA-event time with the L2 cache emptied before each launch:
"ms" by writing 64 MB (chip_smoke.Timer), "clean_ms" by reading them.
Where the checkout built its cluster kernels in this process it first
prints -Xptxas -v of the planners and the walks.
"""
import argparse
import hashlib
import importlib
import json
import re
import subprocess
import sys
import time
from pathlib import Path

KERNELS = ("plan", "rows", "closest", "occluded", "fma", "sphere",
           "replay", "grid", "hero")
CLUSTER = ("plan", "rows", "closest", "occluded")


def plan_equal(torch, got, want, c):
    below = torch.arange(c, device="cuda")[None] < want[2][:, None]
    return (torch.equal(got[2], want[2])
            and torch.equal(got[0][below], want[0][below])
            and torch.equal(got[1][below], want[1][below]))


def probe(m, timer, label, name, cp, gcp, rays, tile, kernels, mxu=False,
          plain_walks=True):
    """One table and batch: the kernels asked for; one JSON line."""
    torch, cs, ct = m["torch"], m["cs"], m["ct"]
    p, d, tf0, alive = rays
    plan_tf = torch.where(alive, tf0, 0.0)
    res = {}
    if "plan" in kernels and not mxu:
        for mode in ("ray", "super"):
            args = (cp, p, d, plan_tf, alive, tile, mode)
            res[f"{mode}_equal"] = plan_equal(
                torch, ct._plan_visits(*args), ct.plan_visits_plain(*args),
                cp.num_clusters)
            res[f"{mode}_ms"] = timer(lambda: ct._plan_visits(*args), 5,
                                      warmup=1)
    if "rows" in kernels and not mxu:
        for mode in ct.PLANS:
            pack = gcp if mode == "group" else cp
            if pack is None:
                continue
            args = (pack, p, d, plan_tf, alive, tile, mode)
            res[f"rows_{mode}_equal"] = torch.equal(
                ct.plan_rows(*args), ct.plan_rows_plain(*args))
            res[f"rows_{mode}_ms"] = timer(lambda: ct.plan_rows(*args), 5,
                                           warmup=1)
    pv, pe, pn = ct.plan_visits_plain(cp, p, d, plan_tf, alive, tile)
    if "closest" in kernels:
        walk = lambda: ct.walk_closest(cp, pv, pe, pn, p, d, tf0, alive, tile,
                                       mxu=mxu)
        want = (ct.walk_closest_plain(cp, pv, pe, pn, p, d, tf0, alive, tile,
                                      mxu=mxu) if plain_walks else None)
        for s in cs.SPLITS:
            with cs.forced_split(ct, s):
                if want is not None:
                    res[f"closest_equal_S{s}"] = cs._same_hits(torch, walk(),
                                                               want)
                res[f"closest_ms_S{s}"] = timer(walk, 5, warmup=1)
    if "occluded" in kernels:
        n = tf0.shape[0]
        t, i = ct.walk_closest(cp, pv, pe, pn, p, d, tf0, alive, tile)
        scale = torch.where(torch.arange(n, device="cuda") % 2 == 0, 1.001,
                            0.999)
        shadow_tf = torch.where(alive, torch.where(i >= 0, t * scale, tf0),
                                0.0)
        splan = ct._plan_visits(cp, p, d, shadow_tf, shadow_tf > 0, tile)
        walk = lambda **kw: ct.walk_occluded(cp, *splan, p, d, shadow_tf,
                                             tile, mxu=mxu, **kw)
        want = ct.walk_occluded_plain(cp, *splan, p, d, shadow_tf, tile,
                                      mxu=mxu)
        streams = not mxu and cp.cluster_size >= 128
        res["occluded_lanes"] = int(want.sum())
        for s in cs.SPLITS:
            with cs.forced_split(ct, s):
                got = walk()
                res[f"occluded_equal_S{s}"] = torch.equal(got, want) and (
                    not streams or torch.equal(got, walk(stream=True)))
                res[f"occluded_ms_S{s}"] = timer(walk, 5, warmup=1)
    print(f"[{label}] {name}: {json.dumps(res)}", flush=True)


def wide(np, g, n):
    """Random float32 of either sign with exponents from -30 to 30."""
    return (g.uniform(1.0, 2.0, n) * 2.0 ** g.integers(-30, 31, n)
            * g.choice([-1.0, 1.0], n)).astype(np.float32)


def fma_forms(m):
    """(name, operand count, kernel call, plain chain) of fp.fma and each
    contraction core/ chains from it, through the checkout's public
    functions: a checkout without a fused form runs its chain of fp.fma."""
    fp, sampling, Vec3, Quat = m["fp"], m["sampling"], m["Vec3"], m["Quat"]
    f, fpl = fp.fma, fp.fma_plain
    fma3 = getattr(fp, "fma3", None) or (
        lambda a, b, c: Vec3(*(f(ac, b, cc) for ac, cc in zip(a, c))))

    def local(g, t, v):
        temp = 2.0 * g(-t.x, v.y, g(v.z, t.w, v.x * t.y))
        return (g(-t.y, temp, v.x), g(t.x, temp, v.y), g(temp, t.w, -v.z))

    def world(g, t, v):
        temp = 2.0 * g(t.x, v.y, g(v.z, t.w, -(v.x * t.y)))
        return (g(t.y, temp, v.x), g(-t.x, temp, v.y), g(temp, t.w, -v.z))

    quat = lambda x: Quat(x[0], x[1], None, x[2])
    return (
        ("fma", 3, lambda x: (f(*x),), lambda x: (fpl(*x),)),
        ("dot3", 6, lambda x: (fp.dot3(*x),),
         lambda x: (fpl(x[2], x[5], fpl(x[0], x[3], x[1] * x[4])),)),
        ("fma3", 7, lambda x: tuple(fma3(Vec3(*x[:3]), x[3], Vec3(*x[4:]))),
         lambda x: tuple(fpl(x[i], x[3], x[4 + i]) for i in range(3))),
        ("to_local", 6,
         lambda x: tuple(sampling.to_local(quat(x), Vec3(*x[3:]))),
         lambda x: local(fpl, quat(x), Vec3(*x[3:]))),
        ("to_world", 6,
         lambda x: tuple(sampling.to_world(quat(x), Vec3(*x[3:]))),
         lambda x: world(fpl, quat(x), Vec3(*x[3:]))),
    )


def clean_timer(cs, torch):
    """cs.Timer with the L2 cache emptied by reading its 64 MB buffer, which
    leaves clean lines, in place of writing it: the time of a memory-bound
    kernel without the write-back of the flush's dirty lines."""

    class Clean(cs.Timer):
        def __call__(self, fn, iters, warmup=2):
            for _ in range(warmup):
                fn()
            torch.cuda.synchronize()
            total = 0.0
            for _ in range(iters):
                self.flush.view(torch.int64).sum()
                torch.cuda._sleep(self.HOST_SLACK_CYCLES)
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                fn()
                end.record()
                end.synchronize()
                total += start.elapsed_time(end)
            return total / iters

    return Clean(torch)


def probe_fma(m, timer, label):
    torch, np, build = m["torch"], m["np"], m["build"]
    g = np.random.default_rng(3)
    n = 1 << 19
    cols = [torch.tensor(wide(np, g, n), device="cuda") for _ in range(7)]
    res = {}
    for name, arity, kern, plain in fma_forms(m):
        x = tuple(cols[:arity])
        before = sum(build.launch_counts().values())
        got = kern(x)
        res[f"{name}_launches_a_call"] = (sum(build.launch_counts().values())
                                          - before)
        res[f"{name}_equal"] = all(
            torch.equal(a.view(torch.int32), b.view(torch.int32))
            for a, b in zip(got, plain(x)))
        res[f"{name}_ms"] = timer(lambda: kern(x), 20)
        res[f"{name}_clean_ms"] = m["clean"](lambda: kern(x), 20)
        small = tuple(c[:1024] for c in x)
        for _ in range(20):
            kern(small)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(2000):
            kern(small)
        res[f"{name}_host_us"] = (time.perf_counter() - t0) * 1e6 / 2000
        torch.cuda.synchronize()
    # fp.fma as the hero's light sampler calls it: c a column of an
    # [n, 8] table (the strided form where the checkout has one)
    col = torch.stack([cols[j % 7] for j in range(8)], 1)[:, 4]
    ops = (cols[0], cols[1], col)
    before = build.launch_counts()
    got = m["fp"].fma(*ops)
    res["fma_column_launches"] = {k: v - before[k] for k, v in
                                  build.launch_counts().items()
                                  if v != before[k]}
    res["fma_column_equal"] = torch.equal(
        got.view(torch.int32), m["fp"].fma_plain(*ops).view(torch.int32))
    res["fma_column_ms"] = timer(lambda: m["fp"].fma(*ops), 20)
    # yardsticks, not the same function: PyTorch's elementwise kernels on
    # the same bytes (addcmul rounds a*b before adding), and the fma at
    # 1024 lanes, where the time is the launch's
    a, b, c = cols[:3]
    res["torch_add_ms"] = timer(lambda: torch.add(a, b), 20)
    res["torch_addcmul_ms"] = timer(lambda: torch.addcmul(c, a, b), 20)
    res["fma_1024_ms"] = timer(lambda: m["fp"].fma(a[:1024], b[:1024],
                                                   c[:1024]), 20)
    print(f"[{label}] fma 2^19: {json.dumps(res)}", flush=True)


def probe_sphere(m, timer, label, out):
    torch, np, cs, crt = m["torch"], m["np"], m["cs"], m["crt"]
    sb = m["sb"]
    for tname, scene, n in (
            ("hero 9", crt.builders.default_scene(*cs.FRAME), 1 << 19),
            ("field 1000", crt.builders.random_spheres_scene(*cs.FRAME),
             262144),
            ("field 1000", crt.builders.random_spheres_scene(*cs.FRAME),
             1 << 19)):
        sph = scene.to("cuda").spheres
        center, rsq = sph.center, sph.radius_sq
        p, d, tf = cs.ray_batch(torch, np, center, rsq, n, 1)
        want = sb.intersect_spheres(p, d, center, rsq)
        res = {}
        got = sb.closest_hit(p, d, center, rsq)
        res["closest_equal"] = cs._same_hits(torch, got, want)
        res["closest_ms"] = timer(lambda: sb.closest_hit(p, d, center, rsq),
                                  20)
        res["closest_clean_ms"] = m["clean"](
            lambda: sb.closest_hit(p, d, center, rsq), 20)
        tf = torch.where(torch.arange(n, device="cuda") % 2 == 0, tf,
                         torch.where(want[1] >= 0, want[0] * 0.999, tf))
        occ = sb.occluded_spheres(p, d, tf, center, rsq)
        res["occluded_equal"] = torch.equal(
            sb.any_hit(p, d, tf, center, rsq), occ)
        res["occluded_ms"] = timer(lambda: sb.any_hit(p, d, tf, center, rsq),
                                   20)
        res["occluded_clean_ms"] = m["clean"](
            lambda: sb.any_hit(p, d, tf, center, rsq), 20)
        order = torch.argsort(rsq, descending=True, stable=True)
        scenter = m["Vec3"](*(c[order].contiguous() for c in center))
        srsq = rsq[order].contiguous()
        call = lambda: sb.any_hit(p, d, tf, scenter, srsq)
        res["occluded_largest_first_equal"] = torch.equal(call(), occ)
        res["occluded_largest_first_ms"] = timer(call, 20)
        if hasattr(cs, "any_hit_pairs"):
            for key, (c_, r_) in (("", (center, rsq)),
                                  ("largest_first_", (scenter, srsq))):
                pairs, warp = cs.any_hit_pairs(torch, sb, p, d, tf, c_, r_)
                res[f"{key}pairs"], res[f"{key}warp_pairs"] = pairs, warp
        print(f"[{label}] sphere {tname} x {n} rays: {json.dumps(res)}",
              flush=True)
    probe_tables(m, timer, label)
    tool = Path(m["build"].nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(tool), "-sass", str(sb.LIBRARY.path)],
                          capture_output=True, text=True, timeout=300).stdout
    (out / f"sass_{label}_sphere_battery.txt").write_text(sass)


SWEEP_TABLES = (1, 4, 9, 12, 16, 32, 64, 128, 256)  # spheres


def probe_tables(m, timer, label):
    """sphere_closest and sphere_occluded at 2^19 rays on tables of
    SWEEP_TABLES spheres (the hero's 9, and the first k spheres of the
    1000-sphere field): equal to the plain version, and ms of 20 launches.
    One JSON line a table."""
    torch, np, cs, crt, sb = m["torch"], m["np"], m["cs"], m["crt"], m["sb"]
    hero = crt.builders.default_scene(*cs.FRAME).to("cuda").spheres
    field = crt.builders.random_spheres_scene(*cs.FRAME).to("cuda").spheres
    n = 1 << 19
    for k in SWEEP_TABLES:
        sph = hero if k == 9 else field
        center = m["Vec3"](*(c[:k].contiguous() for c in sph.center))
        rsq = sph.radius_sq[:k].contiguous()
        p, d, tf = cs.ray_batch(torch, np, center, rsq, n, 100 + k)
        want = sb.intersect_spheres(p, d, center, rsq)
        call = lambda: sb.closest_hit(p, d, center, rsq)
        tf = torch.where(torch.arange(n, device="cuda") % 2 == 0, tf,
                         torch.where(want[1] >= 0, want[0] * 0.999, tf))
        occ = sb.occluded_spheres(p, d, tf, center, rsq)
        any_hit = lambda: sb.any_hit(p, d, tf, center, rsq)
        res = {"hits": int((want[1] >= 0).sum()),
               "equal": cs._same_hits(torch, call(), want),
               "ms": timer(call, 20),
               "occluded": int(occ.sum()),
               "occluded_equal": torch.equal(any_hit(), occ),
               "occluded_ms": timer(any_hit, 20)}
        print(f"[{label}] sphere batteries, {k} spheres x {n} rays: "
              f"{json.dumps(res)}", flush=True)


def probe_replay(m, timer, label):
    """stream_replay on diag/stream2.py's pack, planned over all its rays
    (the docstring's `replay`)."""
    torch, ct = m["torch"], m["ct"]
    s2 = importlib.import_module(
        "cpu_raytracing_experiments_tpu_torch.diag.stream2")
    cp, p, d = s2.build("cuda")
    n = p.x.shape[0]
    tf = torch.full((n,), s2.FLT_MAX, dtype=torch.float32, device="cuda")
    valid = torch.ones((n,), dtype=torch.bool, device="cuda")
    visit, _, nvis = ct._plan_visits(cp, p, d, tf, valid, s2.TILE)
    f8 = ct._stream_rows(cp.kind)
    packed = ct._tables_packed(cp)
    sms = m["build"].sm_count(0)
    busiest = int(torch.argmax(nvis))
    empty = torch.nonzero(nvis == 0)[:1, 0].tolist()
    fewest = int(torch.where(nvis > 0, nvis, nvis.max() + 1).argmin())
    # where the time goes: a tile with no visit (the launch, the read of
    # nv and the zero rows), the fewest visits, the busiest tile with no
    # pad visit, and the busiest on the grids of a one- and a four-SM card
    # (long slices: the visits one block walks in turn)
    for tile in empty + [fewest]:
        nv = int(nvis[tile])
        call = lambda: ct.replay_launch(cp, visit, nvis, tile,
                                        ct.replay_visits(max(nv, 1)))
        print(f"[{label}] stream_replay tile {tile} (nv {nv}): "
              f"{json.dumps({'ms': timer(call, 20)})}", flush=True)
    nv = int(nvis[busiest])
    call = lambda: ct.replay_launch(cp, visit, nvis, busiest, nv)
    print(f"[{label}] stream_replay tile {busiest} into {nv} visits (no pad "
          f"visit): {json.dumps({'ms': timer(call, 20)})}", flush=True)
    if hasattr(ct, "replay_blocks"):
        n_out = ct.replay_visits(nv)
        for on in (1, 4):
            call = lambda: ct.replay_launch(cp, visit, nvis, busiest, n_out,
                                            sms=on)
            print(f"[{label}] stream_replay tile {busiest}, grid "
                  f"{ct.replay_blocks(n_out, on)}: "
                  f"{json.dumps({'ms': timer(call, 20)})}", flush=True)
    for tile in (0, busiest):
        nv = int(nvis[tile])
        n_out = ct.replay_visits(nv)
        want = ct.stream_replay_plain(cp, visit, nvis, tile)
        rows = (visit[tile, :nv].to(torch.int64)[:, None] * f8
                + torch.arange(f8, device="cuda")).reshape(-1)
        res = {"nv": nv}
        if hasattr(ct, "replay_blocks"):
            res["grid"] = ct.replay_blocks(n_out, sms)
            res["owners"] = ct.replay_blocks(nv, sms)
            res["blocks_an_sm"] = ct.replay_occupancy(cp)
        call = lambda: ct.replay_launch(cp, visit, nvis, tile, n_out)
        res["equal"] = torch.equal(call().view(torch.int32),
                                   want.view(torch.int32))
        res["ms"] = timer(call, 20)
        res["index_select_ms"] = timer(lambda: packed.index_select(0, rows),
                                       20)
        print(f"[{label}] stream_replay tile {tile}: {json.dumps(res)}",
              flush=True)


def probe_grid(m, timer, label, out):
    """The grid walks on phase 19's grids (the docstring's `grid`): one
    JSON line a grid and batch."""
    torch, np, cs, crt = m["torch"], m["np"], m["cs"], m["crt"]
    gw, traverse, grid_mod = m["gw"], m["traverse"], m["grid"]
    field = crt.accel.with_grid(crt.builders.random_spheres_scene(
        *cs.FRAME, num_spheres=1000), res=cs.FIELD_GRID_RES).to("cuda")
    mesh = crt.accel.with_grid(crt.builders.mesh_scene(
        *cs.FRAME, subdivisions=6), res=cs.MESH_GRID_RES).to("cuda")
    tri = mesh.triangles
    for gname, scene, table, rows, n, plain in (
            ("mesh", mesh, mesh.tri_grid,
             traverse.pack_triangles(tri.v0, tri.e1, tri.e2), 1 << 16, True),
            ("mesh", mesh, mesh.tri_grid,
             traverse.pack_triangles(tri.v0, tri.e1, tri.e2), 1 << 19, False),
            ("field", field, field.sphere_grid, traverse.pack_spheres(
                field.spheres.center, field.spheres.radius_sq), 1 << 19,
             True)):
        test = traverse.sphere_row_test if rows.shape[1] == 4 else \
            traverse.triangle_row_test
        batches = cs.walk_batches(torch, np, crt, scene, "grid", n, 19)
        for bname, (p, d, tf0, tf) in batches.items():
            if not plain and bname != "camera":
                continue
            closest = lambda: gw.closest(table, p, d, rows, tf0)
            occluded = lambda: gw.occluded(table, p, d, tf, rows)
            res = {}
            if plain:
                want = grid_mod.traverse_grid_closest(table, p, d, rows, test,
                                                      tfar0=tf0)
                res["closest_equal"] = cs._same_hits(torch, closest(), want)
                res["occluded_equal"] = torch.equal(
                    occluded(), grid_mod.traverse_grid_shadow(
                        table, p, d, tf, rows, test))
            res["closest_ms"] = timer(closest, 10)
            res["occluded_ms"] = timer(occluded, 10)
            print(f"[{label}] grid {gname} (residual "
                  f"{table.residual.shape[0]}) {bname} x {n} rays: "
                  f"{json.dumps(res)}", flush=True)
    tool = Path(m["build"].nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(tool), "-sass", str(gw.LIBRARY.path)],
                          capture_output=True, text=True, timeout=300).stdout
    (out / f"sass_{label}_grid_walk.txt").write_text(sass)


def probe_hero(m, label, out):
    """The hero at 256x256, 2 passes: buckets against the other
    checkouts' saved in `out`, launches a pass; then at 1920x1088: ms/pass
    (the median of three windows of three passes, after a warm-up pass)
    and one profiled pass's device busy time and kernel launches."""
    torch, crt, build, cs = m["torch"], m["crt"], m["build"], m["cs"]
    from torch.profiler import ProfilerActivity, profile

    def profiled(r):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            r.accumulate(1)
            torch.cuda.synchronize()
        rows = [ev for ev in prof.key_averages()
                if ev.device_type == torch.autograd.DeviceType.CUDA
                and ev.self_device_time_total > 0]
        return (sum(ev.count for ev in rows),
                sum(ev.self_device_time_total for ev in rows) / 1e3)

    policy = crt.RendererPolicy(max_bounces=8, rays_per_chunk=1 << 19)
    r = crt.Renderer(crt.builders.default_scene(256, 256), policy, 256, 256)
    build.reset_counts()
    r.accumulate(2)
    torch.cuda.synchronize()
    counts = {k: v / 2 for k, v in build.launch_counts().items() if v}
    buckets = r.state.buckets.cpu().numpy()
    mine = out / f"hero_buckets_{label}.npy"
    m["np"].save(mine, buckets)
    equal = {f.stem[len("hero_buckets_"):]:
             m["np"].load(f).tobytes() == buckets.tobytes()
             for f in sorted(out.glob("hero_buckets_*.npy")) if f != mine}
    launches, _ = profiled(r)
    fma = sum(v for k, v in counts.items() if k.startswith("fma"))
    print(f"[{label}] hero 256x256, 2 passes: buckets sha256 "
          f"{hashlib.sha256(buckets.tobytes()).hexdigest()[:16]}, equal to "
          f"{equal}; launches a pass by the counters: fma kernels {fma} "
          f"{counts}; kernel launches of one profiled pass {launches}",
          flush=True)
    r = crt.Renderer(crt.builders.default_scene(*cs.FRAME), policy,
                     *cs.FRAME)
    r.accumulate(1)
    torch.cuda.synchronize()
    windows = []
    for _ in range(3):
        t0 = time.perf_counter()
        r.accumulate(3)
        torch.cuda.synchronize()
        windows.append((time.perf_counter() - t0) * 1e3 / 3)
    launches, busy = profiled(r)
    print(f"[{label}] hero 1920x1088: {sorted(windows)[1]:.2f} ms/pass "
          f"(windows {[round(w, 2) for w in windows]}); one profiled pass: "
          f"{launches} kernel launches, device busy {busy:.2f} ms",
          flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("tree", help="root of the checkout to measure")
    ap.add_argument("label", help="name of its output lines")
    ap.add_argument("--kernels", default=",".join(KERNELS),
                    help=f"comma-separated, of {', '.join(KERNELS)}")
    ap.add_argument("--out", default="probe_out",
                    help="directory of the saved buckets and SASS")
    opt = ap.parse_args()
    kernels = set(opt.kernels.split(","))
    if not kernels <= set(KERNELS):
        ap.error(f"--kernels: {sorted(kernels - set(KERNELS))} unknown")
    out = Path(opt.out)
    out.mkdir(parents=True, exist_ok=True)
    sys.path.insert(0, opt.tree)
    pkg = "cpu_raytracing_experiments_tpu_torch"
    m = {name: importlib.import_module(mod) for name, mod in (
        ("torch", "torch"), ("np", "numpy"), ("cs", "chip_smoke"),
        ("crt", pkg), ("fp", pkg + ".core.fp"),
        ("sampling", pkg + ".core.sampling"), ("vec", pkg + ".core.vec"),
        ("intersect", pkg + ".ops.intersect"),
        ("build", pkg + ".ops.kernels.build"),
        ("sb", pkg + ".ops.kernels.sphere_battery"),
        ("kf", pkg + ".ops.kernels.fma"),
        ("gw", pkg + ".ops.kernels.grid_walk"),
        ("traverse", pkg + ".bvh.traverse"), ("grid", pkg + ".bvh.grid"),
        ("ct", pkg + ".ops.kernels.cluster_traverse"))}
    m["Vec3"], m["Quat"] = m["vec"].Vec3, m["vec"].Quat
    torch, cs, crt, ct = m["torch"], m["cs"], m["crt"], m["ct"]
    label = opt.label
    print(f"[{label}] {cs.gpu_name_power()}", flush=True)
    t0 = time.perf_counter()
    libraries = (m["sb"].LIBRARY, m["kf"].LIBRARY) + (
        (ct.LIBRARY,) if kernels & set(CLUSTER + ("replay",)) else ()) + (
        (m["gw"].LIBRARY,) if "grid" in kernels else ())
    m["build"].load_all(libraries)
    print(f"[{label}] built in {time.perf_counter() - t0:.1f} s", flush=True)
    for lib in libraries:
        for fn, regs, (st, ld), smem in cs.ptxas_report(
                lib.build_log, ("plan_kernel", "closest_kernel",
                                "occluded_kernel", "stream_kernel",
                                "fma_kernel", "flat_kernel",
                                "strided_kernel", "replay_kernel",
                                "merge_kernel")):
            print(f"    ptxas {cs.kernel_name(fn)}: {regs} registers, spill "
                  f"{st} / {ld} B, {smem} B static shared", flush=True)
        fn = None
        for line in lib.build_log.splitlines():
            hit = re.search(r"Function properties for (\w+)", line)
            fn = hit.group(1) if hit else fn
            frame = re.search(r"(\d+) bytes stack frame", line)
            if frame and fn and int(frame.group(1)):
                print(f"    ptxas {cs.kernel_name(fn)}: {frame.group(1)} B "
                      "stack frame", flush=True)
    timer = cs.Timer(torch)
    m["clean"] = clean_timer(cs, torch)
    if "fma" in kernels:
        probe_fma(m, timer, label)
    if "sphere" in kernels:
        probe_sphere(m, timer, label, out)
    if "replay" in kernels:
        probe_replay(m, timer, label)
    if "grid" in kernels:
        probe_grid(m, timer, label, out)
    if "hero" in kernels:
        probe_hero(m, label, out)
    if not kernels & set(CLUSTER):
        return
    tables = []
    for n in (1000, 100_000):
        scene = crt.builders.random_spheres_scene(*cs.FRAME, num_spheres=n)
        tables.append((f"{n} spheres", crt.accel.with_pallas_clusters(
            scene).to("cuda"), "sphere_clusters", scene))
    for uv in (224, 810):
        scene = crt.builders.mesh_scene(*cs.FRAME, uv_res=uv)
        tables.append((f"mesh uv{uv}", crt.accel.with_pallas_clusters(
            scene).to("cuda"), "tri_clusters", scene))
    for tname, scene, field, bare in tables:
        cp = getattr(scene, field)
        big = cp.num_clusters > 2048
        gcp = None if big or "rows" not in kernels else getattr(
            crt.accel.with_pallas_clusters(bare, **cs.GROUP_PACK).to("cuda"),
            field)
        tile = m["intersect"]._tile_for({"tile_r": "auto"}, cp)["tile_r"]
        batches = cs.cluster_rays(torch, m["np"], crt, scene, cp, 13,
                                  narrowed=True, tile=tile)
        for kind, rays in batches.items():
            probe(m, timer, label, f"{tname} {kind}", cp, gcp, rays, tile,
                  kernels, plain_walks=not big)
            if cp.kind == "triangle" and not big:
                probe(m, timer, label, f"{tname} {kind} mxu", cp, gcp, rays,
                      tile, kernels & {"closest", "occluded"}, mxu=True)


if __name__ == "__main__":
    main()
