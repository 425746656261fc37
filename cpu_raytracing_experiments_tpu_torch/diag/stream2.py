"""The streamed closest walk checked visit by visit: the port of the JAX
package's ``benchmarks/diag_stream2.py`` (its stage-2 diagnosis of a
streamed-walk mismatch on the TPU), at that script's size: 100,000 random
triangles in clusters of K = 256 (C = 391), 262,144 camera-like rays, tiles
of 256 rays, numpy seed 7.

Stages:
  repro   the resident against the streamed walk (``intersect_clustered_
          pallas``) over every ray, ids and the bits of tfar; then one
          tile's rays alone
  dma     one tile's visit list replayed through the streamed walks'
          staging (``stream_replay``), each visit's rows held to the
          packed table
  trace   the streamed walk over the first m visits of the tile's list
          (``walk_closest(stream=True)`` with nvis clamped to m) against a
          replay of the visits, every ray of the tile; bisects for the first
          visit at which they part
  trace2  the prefix walk with the plan and the packed table made in the
          same call (full) or beforehand and copied into fresh buffers
          (ext-plan, ext-packed, ext-both); ray 12 at m = 10000 and 60

    python -m cpu_raytracing_experiments_tpu_torch.diag.stream2 --stage repro
    python -m cpu_raytracing_experiments_tpu_torch.diag.stream2 \\
        --stage dma --tile 0 --device cpu

It runs on the card unless ``--device cpu`` is given, and raises without
one; on the CPU every kernel is its plain version, so keep to ``--tile``
runs there (the full-size pass walks 262,144 rays). Without ``--tile`` the
later stages run on the tile of the first mismatch, as in the JAX script,
and stop where there is none.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys

import numpy as np
import torch

from ..core.vec import Vec3
from ..ops import clustered
from ..ops.kernels import cluster_traverse as ct
from ..ops.kernels.sphere_battery import FLT_MAX, _closest_epilogue

P, K, R = 100_000, 256, 262_144  # triangles, cluster size, rays
SEED = 7
TILE = 256  # rays a tile
STAGES = ("repro", "dma", "trace", "trace2")
VARIANTS = ("full", "ext-plan", "ext-packed", "ext-both")
TRACE2_RAY = 12
TRACE2_PREFIXES = (10000, 60)
# the JAX script's fifth variant lifts the Mosaic compiler's VMEM limit
# (traverse_kernel.py:70): nothing on the card corresponds to it
NO_CP = "no-cp"


def make_tris(n: int, rng):
    """n random triangles (``benchmarks/bench_stream.py``'s make_tris):
    (mins [n, 3], maxs [n, 3], rows [n, 9] = v0, e1, e2), float32."""
    v0 = rng.uniform(-5, 5, (n, 3)).astype(np.float32)
    e1 = rng.normal(0, 0.15, (n, 3)).astype(np.float32)
    e2 = rng.normal(0, 0.15, (n, 3)).astype(np.float32)
    rows = np.concatenate([v0, e1, e2], axis=1)
    pts = np.stack([v0, v0 + e1, v0 + e2], axis=0)
    return pts.min(axis=0), pts.max(axis=0), rows


def make_rays(n: int, rng, device=None):
    """n camera-like rays from (0, 0, 12) through a grid of directions
    (``bench_stream.py``'s make_rays; `rng` is not drawn from): (p, d) as
    Vec3 of float32 tensors."""
    side = int(np.sqrt(n))
    u, v = np.meshgrid(np.linspace(-0.4, 0.4, side),
                       np.linspace(-0.4, 0.4, side))
    d = np.stack([u.ravel(), v.ravel(), -np.ones(side * side)], axis=1)
    d = np.concatenate([d, d[: n - side * side]], axis=0)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    p = np.tile(np.array([[0.0, 0.0, 12.0]], np.float32), (n, 1))

    def vec(a):
        return Vec3(*(torch.from_numpy(a[:, i].astype(np.float32)).to(device)
                      for i in range(3)))

    return vec(p), vec(d)


def build(device, prims: int = P, k: int = K, rays: int = R,
          seed: int = SEED):
    """(cluster pack, p, d) on `device`: `prims` random triangles in
    ceil(prims / k) morton clusters and `rays` rays, from numpy's
    default_rng(seed), as the JAX script's build()."""
    rng = np.random.default_rng(seed)
    mins, maxs, rows = make_tris(prims, rng)
    cp = clustered.build_clusters(mins, maxs, rows,
                                  num_clusters=-(-prims // k),
                                  kind="triangle").to(device)
    p, d = make_rays(rays, rng, device)
    return cp, p, d


def slice_rays(p: Vec3, d: Vec3, lo: int, hi: int):
    return (Vec3(*(a[lo:hi].contiguous() for a in p)),
            Vec3(*(a[lo:hi].contiguous() for a in d)))


def tile_rays(p: Vec3, d: Vec3, tile: int):
    return slice_rays(p, d, tile * TILE, (tile + 1) * TILE)


def _bits(t):
    return t.view(torch.int32)


def find_bad(cp, p: Vec3, d: Vec3, tile_r: int = TILE):
    """Lanes where the streamed walk's hit is not the resident walk's: the
    id or the bits of tfar differ (the JAX script compares the ids). Returns
    (lanes, (resident tfar, ids, streamed tfar, ids))."""
    t0, i0 = ct.intersect_clustered_pallas(cp, p, d, tile_r=tile_r)
    t1, i1 = ct.intersect_clustered_pallas(cp, p, d, tile_r=tile_r,
                                           stream=True)
    bad = torch.nonzero((i0 != i1) | (_bits(t0) != _bits(t1)))[:, 0]
    return bad, (t0, i0, t1, i1)


def full_repro(cp, p: Vec3, d: Vec3):
    """The full-size pass: prints the mismatch count and the first bad lane;
    returns (mismatches, that lane's tile or None)."""
    bad, (t0, i0, t1, i1) = find_bad(cp, p, d)
    print(f"full-size mismatches: {bad.numel()}")
    if not bad.numel():
        print("NO MISMATCH: cannot reproduce")
        return 0, None
    lane = int(bad[0])
    print(f"first bad lane {lane} tile {lane // TILE} in-tile {lane % TILE}")
    print(f"  resident (t, id): {float(t0[lane])}, {int(i0[lane])}")
    print(f"  stream   (t, id): {float(t1[lane])}, {int(i1[lane])}")
    return bad.numel(), lane // TILE


def tile_repro(cp, p: Vec3, d: Vec3, tile: int):
    """The single-tile isolation: the tile's rays alone through both walks;
    returns the in-tile lanes that differ."""
    sub_bad, _ = find_bad(cp, *tile_rays(p, d, tile))
    print(f"single-tile mismatches: {sub_bad.numel()} at {sub_bad.tolist()}")
    return sub_bad.tolist()


def _open_rays(p: Vec3):
    """(tfar FLT_MAX, valid) for every lane of p: the rays of the script."""
    n, device = p.x.shape[0], p.x.device
    return (torch.full((n,), FLT_MAX, dtype=torch.float32, device=device),
            torch.ones((n,), dtype=torch.bool, device=device))


def tile_plan(cp, p: Vec3, d: Vec3):
    """(visit [1, C], entry [1, C], nvis [1]) of one tile of rays p, d, every
    lane valid with tfar FLT_MAX, as the JAX script plans it. The JAX
    planner pads the rays to its 8-tile grid minimum, and its padding tiles
    plan nothing; the port plans the one tile alone."""
    if p.x.shape[0] > TILE:
        raise ValueError(f"tile_plan: {p.x.shape[0]} rays, a tile holds "
                         f"{TILE}")
    return ct._plan_visits(cp, p, d, *_open_rays(p), TILE)


def prefix_walk(cp, p: Vec3, d: Vec3, plan, m: int):
    """The streamed closest walk over the first m visits of the tile's list
    (nvis clamped to m), through ``walk_closest(stream=True)``, the launch
    the renderer's streamed path makes: (tfar, cluster * K + slot) of each
    ray. Where `cp` holds no packed table the walk makes it."""
    visit, entry, nvis = plan
    return ct.walk_closest(cp, visit, entry, torch.clamp(nvis, max=m), p, d,
                           *_open_rays(p), TILE, stream=True)


def prefix_walk_plain(cp, p: Vec3, d: Vec3, plan, m: int):
    """``prefix_walk``'s plain version, on any device."""
    visit, entry, nvis = plan
    return ct.walk_closest_plain(cp, visit, entry, torch.clamp(nvis, max=m),
                                 p, d, *_open_rays(p), TILE,
                                 packed=ct._tables_packed(cp))


def dma(cp, p: Vec3, d: Vec3, tile: int):
    """The DMA stage: the tile's visit list replayed through the streamed
    walks' staging, each visit's F8 rows held to the packed table bit for
    bit, and the rows that pad the output to 8 visits held to zero. Returns
    a dict: nv, the visits that differ, the replay and the plan."""
    plan = tile_plan(cp, *tile_rays(p, d, tile))
    visit, _, nvis = plan
    nv = int(nvis[0])
    print(f"visits for tile {tile}: {nv}")
    out = ct.stream_replay(cp, visit, nvis, 0)
    packed = ct._tables_packed(cp)
    f8, k = ct._stream_rows(cp.kind), cp.cluster_size
    vis = visit[0, :nv].to(torch.int64)
    want = packed[(vis[:, None] * f8 + torch.arange(
        f8, device=packed.device)).reshape(-1)].reshape(nv, f8, k)
    got = out[:nv * f8].reshape(nv, f8, k)
    cells = _bits(got) != _bits(want)
    bad = torch.nonzero(cells.flatten(1).any(dim=1))[:, 0].tolist()
    for j in bad[:4]:
        rows = sorted(set(torch.nonzero(cells[j])[:, 0].tolist()))
        print(f"  visit {j} cluster {int(vis[j])}: "
              f"{int(cells[j].sum())} bad cells, rows {rows}")
    pad = int((out[nv * f8:] != 0).sum())
    print(f"DMA replay: {len(bad)}/{nv} visits mismatched; "
          f"{out.shape[0] // f8 - nv} pad visits, {pad} nonzero cells")
    return {"nv": nv, "bad": bad, "pad_nonzero": pad, "out": out,
            "plan": plan}


def replay_numpy(packed, vis, nv: int, k: int, f8: int, p, d):
    """The JAX script's per-visit replay for one ray, as it is (float32
    numpy, no fused multiply-adds): [(t, cluster * K + slot)] of the running
    hit after each visit. `packed` is the numpy packed table, p and d the
    ray's origin and direction as floats."""
    px_, py_, pz_ = p
    dx_, dy_, dz_ = d
    t_run, pr_run = np.float32(FLT_MAX), -1
    expect = []
    for j in range(nv):
        c = vis[j]
        rows = packed[c * f8:c * f8 + 12].astype(np.float32)
        (nx, ny, nz, d0, f1x, f1y, f1z, g1, f2x, f2y, f2z, g2) = rows
        den = nx * dx_ + ny * dy_ + nz * dz_
        num = d0 - (nx * px_ + ny * py_ + nz * pz_)
        with np.errstate(all="ignore"):
            t = (num / den).astype(np.float32)
            hx = (px_ + dx_ * t).astype(np.float32)
            hy = (py_ + dy_ * t).astype(np.float32)
            hz = (pz_ + dz_ * t).astype(np.float32)
            u = (f1x * hx + f1y * hy + f1z * hz + g1).astype(np.float32)
            v = (f2x * hx + f2y * hy + f2z * hz + g2).astype(np.float32)
        valid = ((np.abs(den) > 1e-12) & (t > 1e-6) & (u >= 0)
                 & (v >= 0) & (u + v <= 1))
        t = np.where(valid, t, FLT_MAX).astype(np.float32)
        best = t.min()
        arg = int(np.where(t == best, np.arange(k), 1 << 30).min())
        if best < t_run:
            t_run, pr_run = np.float32(best), int(c) * k + arg
        expect.append((float(t_run), pr_run))
    return expect


def replay_plain(cp, vis, nv: int, p: Vec3, d: Vec3):
    """The per-visit replay through the port's own plain battery (the
    walks' arithmetic: fused multiply-adds where XLA fuses them), for every
    ray of the tile: [nv, n] tfar and [nv, n] cluster * K + slot of the
    running hit after each visit. The ground truth the prefix walks are
    held to bit for bit."""
    attrs = ct._tables_unpacked(cp, ct._tables_packed(cp))
    battery = ct._closest_battery(cp, False)
    k = cp.cluster_size
    rays = [a[:, None] for a in (*p, *d)]
    best = torch.full_like(p.x, FLT_MAX)
    prim = torch.full(p.x.shape, -1, dtype=torch.int32, device=p.x.device)
    ts, ids = [], []
    for j in range(nv):
        c = int(vis[j])
        tb, first = _closest_epilogue(
            battery(*rays, tuple(a[c][None, :] for a in attrs)))
        closer = tb < best
        best = torch.where(closer, tb, best)
        prim = torch.where(closer, (c * k + first).to(torch.int32), prim)
        ts.append(best)
        ids.append(prim)
    return torch.stack(ts), torch.stack(ids)


def _agree(hit, t, ids):
    return bool(torch.equal(_bits(hit[0]), _bits(t))
                and torch.equal(hit[1], ids))


def trace(cp, p: Vec3, d: Vec3, tile: int, ray=None):
    """The trace stage on one tile: the prefix walk against the plain
    replay on every ray, bisecting for the first m at which some ray
    parts; for ray `ray` (the first lane with a hit where None) also the
    JAX script's numpy replay, printed where it differs from the plain one.
    Returns a dict: nv, the ray, the first diverging visit (None where the
    whole list agrees), the visits at which the two replays differ."""
    ps, ds = tile_rays(p, d, tile)
    plan = tile_plan(cp, ps, ds)
    visit, _, nvis = plan
    nv = int(nvis[0])
    vis = visit[0, :nv].cpu().numpy()
    print(f"visits: {nv}")
    exp_t, exp_id = replay_plain(cp, vis, nv, ps, ds)
    if ray is None:
        hits = torch.nonzero(exp_id[-1] >= 0)[:, 0] if nv else []
        ray = int(hits[0]) if len(hits) else 0
    packed = ct._tables_packed(cp).cpu().numpy()
    ray_p = [float(a[ray]) for a in ps]
    ray_d = [float(a[ray]) for a in ds]
    numpy_rep = replay_numpy(packed, vis, nv, cp.cluster_size,
                             ct._stream_rows(cp.kind), ray_p, ray_d)
    plain_rep = [(float(t), int(i)) for t, i in
                 zip(exp_t[:, ray].tolist(), exp_id[:, ray].tolist())]
    apart = [j for j in range(nv) if numpy_rep[j] != plain_rep[j]]
    print(f"ray {ray}: the numpy and the plain replay differ after "
          f"{len(apart)} of {nv} visits")
    for j in apart[:8]:
        print(f"  visit {j} cluster {vis[j]}: numpy {numpy_rep[j]}, plain "
              f"{plain_rep[j]}")
    result = {"nv": nv, "ray": ray, "first": None, "apart": apart,
              "plan": plan}
    if nv == 0:
        return result
    full = prefix_walk(cp, ps, ds, plan, nv)
    print(f"full prefix: ray {ray} walk ({float(full[0][ray])}, "
          f"{int(full[1][ray])}), replay {plain_rep[-1]}")
    if _agree(full, exp_t[-1], exp_id[-1]):
        print(f"the prefix walk equals the plain replay on all "
              f"{ps.x.shape[0]} rays")
        return result
    lo, hi = 0, nv  # the first m in (0, nv] where walk(m) != replay[m - 1]
    while lo + 1 < hi:
        mid = (lo + hi) // 2
        ok_m = _agree(prefix_walk(cp, ps, ds, plan, mid), exp_t[mid - 1],
                      exp_id[mid - 1])
        print(f"  m={mid}: {'OK' if ok_m else 'DIVERGED'}")
        lo, hi = (mid, hi) if ok_m else (lo, mid)
    j_bad = hi - 1
    got = prefix_walk(cp, ps, ds, plan, hi)
    lanes = torch.nonzero((_bits(got[0]) != _bits(exp_t[j_bad]))
                          | (got[1] != exp_id[j_bad]))[:, 0].tolist()
    print(f"FIRST DIVERGING VISIT: j={j_bad} cluster={vis[j_bad]}, rays "
          f"{lanes[:16]}")
    for r in lanes[:4]:
        print(f"  ray {r}: replay after the visit "
              f"({float(exp_t[j_bad, r])}, {int(exp_id[j_bad, r])}), walk "
              f"({float(got[0][r])}, {int(got[1][r])})")
    result["first"] = j_bad
    return result


def trace2(cp, p: Vec3, d: Vec3, tile: int, variant: str,
           prefixes=TRACE2_PREFIXES, ray: int = TRACE2_RAY):
    """The trace2 stage: the tile's plan, the packed table and the prefix
    walk made in one call ('full'), or with the plan ('ext-plan'), the
    table ('ext-packed') or both ('ext-both') made beforehand and copied
    into fresh buffers. Prints ray `ray`'s hit at each m of `prefixes`;
    returns {m: (tfar, ids)} of every ray of the tile."""
    if variant not in VARIANTS:
        raise ValueError(f"trace2: variant {variant!r}, one of {VARIANTS}")
    ps, ds = tile_rays(p, d, tile)
    ext_plan = variant in ("ext-plan", "ext-both")
    ext_packed = variant in ("ext-packed", "ext-both")
    pre_packed = ct._tables_packed(cp).clone() if ext_packed else None
    pre_plan = (tuple(a.clone() for a in tile_plan(cp, ps, ds))
                if ext_plan else None)
    print(f"variant={variant}")
    label = "hw" if ps.x.is_cuda else "plain"
    out = {}
    for m in prefixes:
        # the walk makes the packed table where the pack holds none
        run = dataclasses.replace(cp, packed=pre_packed)
        plan = pre_plan if ext_plan else tile_plan(run, ps, ds)
        out[m] = prefix_walk(run, ps, ds, plan, m)
        print(f"m={m}: ray{ray} {label}=({float(out[m][0][ray])}, "
              f"{int(out[m][1][ray])})")
    return out


def _parser():
    ap = argparse.ArgumentParser(
        description="The streamed closest walk checked visit by visit.")
    ap.add_argument("--stage", default="repro", choices=STAGES)
    ap.add_argument("--tile", type=int, default=None,
                    help="a tile to diagnose: skips the full-size repro pass")
    ap.add_argument("--variant", default="full", choices=VARIANTS + (NO_CP,),
                    help="trace2: what is made before the walk's call")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cpu: every kernel's plain version")
    return ap


def main(argv=None) -> int:
    ap = _parser()
    args = ap.parse_args(argv)
    if args.variant == NO_CP:
        ap.error(f"--variant {NO_CP} lifts the Mosaic compiler's VMEM limit "
                 "(traverse_kernel.py:70), a TPU setting with no "
                 "counterpart on the card; refused")
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("diag.stream2 runs on a CUDA card and finds none; "
                           "--device cpu takes the plain versions")
    device = torch.device(args.device)
    print("device=" + (torch.cuda.get_device_name(device)
                       if device.type == "cuda" else "cpu"))
    cp, p, d = build(device)
    tile = args.tile
    if tile is None:
        _, tile = full_repro(cp, p, d)
        if tile is None:
            return 0
    sub_bad = []
    if args.stage in ("repro", "trace"):
        sub_bad = tile_repro(cp, p, d, tile)
        if args.stage == "repro":
            return 0
    if args.stage == "dma":
        dma(cp, p, d, tile)
    elif args.stage == "trace2":
        trace2(cp, p, d, tile, args.variant)
    else:
        trace(cp, p, d, tile, sub_bad[0] if sub_bad else None)
    return 0


if __name__ == "__main__":
    sys.exit(main())
