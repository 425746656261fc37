#!/usr/bin/env python3
"""Time the PyTorch port's sorted planner and closest walk of one checkout
on the card, at the widths the full-width renders launch them with, after
checking each against its plain version.

    python3 benchmarks/torch_kernel_probe.py TREE LABEL [--plan-only]

TREE is the root of a checkout of this repository (its chip_smoke.py and
its cpu_raytracing_experiments_tpu_torch package are imported from there),
LABEL a name for its lines. To compare two versions of a kernel, unpack
both into directories that .gitignore lists and run them in turns in one
call on one card (A, B, B, A). For each table (1000 and 100,000 spheres,
the 100,352- and the 1,312,200-triangle mesh) and batch (camera, diffuse,
narrowed) it prints one JSON line: cluster_plan in modes 'ray' and 'super'
(equal to plain, CUDA-event ms) and cluster_closest at S = 1, 2, 4 (equal
to plain, except on the 1.3 M-triangle table, where the plain walk is too
slow; ms), the product form too on the 100,352-triangle mesh. Where the
checkout built its kernels in this process it first prints -Xptxas -v of
the planner and the closest walks. --plan-only times the planner alone.
"""
import argparse
import importlib
import json
import sys
import time


def plan_equal(torch, got, want, c):
    below = torch.arange(c, device="cuda")[None] < want[2][:, None]
    return (torch.equal(got[2], want[2])
            and torch.equal(got[0][below], want[0][below])
            and torch.equal(got[1][below], want[1][below]))


def probe(m, timer, label, name, cp, rays, tile, plan_only, mxu=False,
          plain_closest=True):
    """One table and batch: the planner in 'ray' and 'super', then the
    closest walk at every S (unless `plan_only`); one JSON line."""
    torch, cs, ct = m["torch"], m["cs"], m["ct"]
    p, d, tf0, alive = rays
    plan_tf = torch.where(alive, tf0, 0.0)
    res = {}
    for mode in ("ray", "super"):
        args = (cp, p, d, plan_tf, alive, tile, mode)
        res[f"{mode}_equal"] = plan_equal(torch, ct._plan_visits(*args),
                                          ct.plan_visits_plain(*args),
                                          cp.num_clusters)
        res[f"{mode}_ms"] = timer(lambda: ct._plan_visits(*args), 5, warmup=1)
    if not plan_only:
        pv, pe, pn = ct.plan_visits_plain(cp, p, d, plan_tf, alive, tile)
        walk = lambda: ct.walk_closest(cp, pv, pe, pn, p, d, tf0, alive, tile,
                                       mxu=mxu)
        want = (ct.walk_closest_plain(cp, pv, pe, pn, p, d, tf0, alive, tile,
                                      mxu=mxu) if plain_closest else None)
        for s in cs.SPLITS:
            with cs.forced_split(ct, s):
                if want is not None:
                    res[f"closest_equal_S{s}"] = cs._same_hits(torch, walk(),
                                                               want)
                res[f"closest_ms_S{s}"] = timer(walk, 5, warmup=1)
    print(f"[{label}] {name}: {json.dumps(res)}", flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("tree", help="root of the checkout to measure")
    ap.add_argument("label", help="name of its output lines")
    ap.add_argument("--plan-only", action="store_true",
                    help="time the planner alone")
    opt = ap.parse_args()
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
            ct.LIBRARY.build_log, ("plan_kernel", "closest_kernel")):
        print(f"    ptxas {cs.kernel_name(fn)}: {regs} registers, spill "
              f"{st} / {ld} B, {smem} B static shared", flush=True)
    timer = cs.Timer(torch)
    tables = []
    for n in (1000, 100_000):
        scene = crt.accel.with_pallas_clusters(
            crt.builders.random_spheres_scene(*cs.FRAME, num_spheres=n))
        scene = scene.to("cuda")
        tables.append((f"{n} spheres", scene, scene.sphere_clusters))
    for uv in (224, 810):
        scene = crt.accel.with_pallas_clusters(
            crt.builders.mesh_scene(*cs.FRAME, uv_res=uv)).to("cuda")
        tables.append((f"mesh uv{uv}", scene, scene.tri_clusters))
    for tname, scene, cp in tables:
        tile = m["intersect"]._tile_for({"tile_r": "auto"}, cp)["tile_r"]
        batches = cs.cluster_rays(torch, m["np"], crt, scene, cp, 13,
                                  narrowed=True, tile=tile)
        big = cp.num_clusters > 2048
        for kind, rays in batches.items():
            probe(m, timer, label, f"{tname} {kind}", cp, rays, tile,
                  opt.plan_only, plain_closest=not big)
            if cp.kind == "triangle" and not big and not opt.plan_only:
                probe(m, timer, label, f"{tname} {kind} mxu", cp, rays, tile,
                      opt.plan_only, mxu=True)


if __name__ == "__main__":
    main()
