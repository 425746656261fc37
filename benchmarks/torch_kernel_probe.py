#!/usr/bin/env python3
"""Time the PyTorch port's cluster kernels of one checkout on the card, at
the widths the full-width renders launch them with, after checking each
against its plain version.

    python3 benchmarks/torch_kernel_probe.py TREE LABEL [--kernels K,...]

TREE is the root of a checkout of this repository (its chip_smoke.py and
its cpu_raytracing_experiments_tpu_torch package are imported from there),
LABEL a name for its lines. To compare two versions of a kernel, unpack
both into directories that .gitignore lists and run them in turns in one
call on one card (A, B, B, A). For each table (1000 and 100,000 spheres,
the 100,352- and the 1,312,200-triangle mesh) and batch (camera, diffuse,
narrowed) it prints one JSON line with, for each kernel asked for (all by
default):
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
            too on the 100,352-triangle mesh.
Where the checkout built its kernels in this process it first prints
-Xptxas -v of the planners and the walks.
"""
import argparse
import importlib
import json
import re
import sys
import time

KERNELS = ("plan", "rows", "closest", "occluded")


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


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("tree", help="root of the checkout to measure")
    ap.add_argument("label", help="name of its output lines")
    ap.add_argument("--kernels", default=",".join(KERNELS),
                    help=f"comma-separated, of {', '.join(KERNELS)}")
    opt = ap.parse_args()
    kernels = set(opt.kernels.split(","))
    if not kernels <= set(KERNELS):
        ap.error(f"--kernels: {sorted(kernels - set(KERNELS))} unknown")
    sys.path.insert(0, opt.tree)
    m = {name: importlib.import_module(mod) for name, mod in (
        ("torch", "torch"), ("np", "numpy"), ("cs", "chip_smoke"),
        ("crt", "cpu_raytracing_experiments_tpu_torch"),
        ("intersect", "cpu_raytracing_experiments_tpu_torch.ops.intersect"),
        ("build", "cpu_raytracing_experiments_tpu_torch.ops.kernels.build"),
        ("ct", "cpu_raytracing_experiments_tpu_torch.ops.kernels."
               "cluster_traverse"))}
    torch, cs, crt, ct = m["torch"], m["cs"], m["crt"], m["ct"]
    label = opt.label
    t0 = time.perf_counter()
    m["build"].load_all((ct.LIBRARY,))
    print(f"[{label}] built in {time.perf_counter() - t0:.1f} s", flush=True)
    for fn, regs, (st, ld), smem in cs.ptxas_report(
            ct.LIBRARY.build_log, ("plan_kernel", "closest_kernel",
                                   "occluded_kernel", "stream_kernel")):
        print(f"    ptxas {cs.kernel_name(fn)}: {regs} registers, spill "
              f"{st} / {ld} B, {smem} B static shared", flush=True)
    fn = None
    for line in ct.LIBRARY.build_log.splitlines():
        hit = re.search(r"Function properties for (\w+)", line)
        fn = hit.group(1) if hit else fn
        frame = re.search(r"(\d+) bytes stack frame", line)
        if frame and fn and int(frame.group(1)):
            print(f"    ptxas {cs.kernel_name(fn)}: {frame.group(1)} B stack "
                  "frame", flush=True)
    timer = cs.Timer(torch)
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
