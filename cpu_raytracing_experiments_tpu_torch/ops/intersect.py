"""Batched ray-primitive intersection, the port of the JAX package's
``ops/intersect.py`` for spheres and triangles under every ``accel``:
'brute', 'pallas', 'clustered', 'grid' and 'bvh'.

The plain batteries ``intersect_spheres`` / ``occluded_spheres`` keep the JAX
semantics (first-occurrence tie-break, sqrt-free any-hit predicate) and live
beside their CUDA kernels in ``ops/kernels/sphere_battery.py``; the clustered
traversal of ``accel='pallas'`` lives in ``ops/kernels/cluster_traverse.py``,
the BVH and grid walks in ``ops/kernels/bvh_walk.py`` / ``grid_walk.py`` and
``accel='clustered'`` in ``ops/clustered.py``.
The dense triangle batteries ``intersect_triangles`` / ``occluded_triangles``
are XLA code in the JAX package, not a TPU kernel, and are plain PyTorch here
on every device. ``intersect_scene`` / ``occluded_scene`` dispatch to the
kernels for CUDA tensors and to the plain versions for CPU tensors.
"""
from __future__ import annotations

from functools import partial

import torch

from ..bvh import traverse as _bvh
from ..core.vec import Vec3
from . import clustered
from .kernels import bvh_walk as _bw
from .kernels import cluster_traverse as _tk
from .kernels import grid_walk as _gw
from .kernels.sphere_battery import (  # noqa: F401  (re-exported JAX names)
    FLT_MAX, PRIM_CHUNK, _closest_epilogue, any_hit, closest_hit,
    intersect_spheres, occluded_spheres)

PALLAS_MIN_PRIMS = 192  # below this the clustered path's fixed cost (a plan
# and a walk launch per call) is not worth it and the dense battery runs, as
# in the JAX package; kept equal so both packages pick the same backend

PALLAS_STREAM_BYTES = 48 << 20  # pallas_stream='auto' resolves to the
# streamed walks above this table size. The value is the JAX package's
# dispatch rule, kept so that both packages pick the same kernel for a scene;
# it is not a measured optimum for this card.

RAY_CHUNK = 1 << 15  # rays per [R, PRIM_CHUNK] block of the dense triangle
# batteries: their float64 temporaries then take 134 MB each


def _tile_for(kw: dict, cp) -> dict:
    """Resolve tile_r='auto', plan='auto' and stream='auto' per cluster
    pack, as the JAX package does: 128 rays per tile below 2048 clusters,
    else 256; the flat 'ray' planner; the streamed walks where the pack's
    tables exceed PALLAS_STREAM_BYTES; neither the streamed walks nor the
    product-form triangle battery (``mxu``) for clusters of fewer than 128
    prims; and no product-form battery under the streamed walks."""
    if kw.get("tile_r") == "auto":
        kw = dict(kw, tile_r=128 if cp.num_clusters < 2048 else 256)
    if kw.get("plan") == "auto":
        kw = dict(kw, plan="ray")
    if kw.get("stream") == "auto":
        kw = dict(kw, stream=_tk.table_bytes(cp) > PALLAS_STREAM_BYTES)
    if cp.cluster_size < 128:
        kw = dict(kw, stream=False, mxu=False)
    if kw.get("stream"):
        kw = dict(kw, mxu=False)
    return kw


def _pallas_kw(policy) -> dict:
    """The pallas_* knobs the traversal reads from a RendererPolicy
    (defaults when policy is None). The schedule knobs of the JAX package
    (plan_block, unroll, fuse, trav_block, exit_refresh, prefetch) describe
    a TPU schedule and change nothing here; ``render.renderer.check_policy``
    refuses the options that are not ported."""
    if policy is None:
        return {"tile_r": _tk.DEFAULT_TILE_R, "compact": False, "mxu": False,
                "stream": "auto", "plan": "ray", "sort": True,
                "sort_impl": "kernel"}
    return {"tile_r": policy.pallas_tile_rays,
            "compact": policy.pallas_compact, "mxu": policy.pallas_mxu,
            "stream": policy.pallas_stream, "plan": policy.pallas_plan,
            "sort": policy.pallas_sort_visits,
            "sort_impl": policy.pallas_sort_impl}


def stream_resolves_on(policy, cp) -> bool:
    """Whether ``pallas_stream`` resolves to the streamed walks for `cp`."""
    return bool(_tile_for(_pallas_kw(policy), cp)["stream"])


def prepare_stream(policy, scene) -> None:
    """Make the packed table of every cluster pack of `scene` that `policy`
    walks streamed, so that the first traced ray does not pay for it."""
    for cp in (scene.sphere_clusters, scene.tri_clusters):
        if cp is not None and stream_resolves_on(policy, cp):
            _tk._tables_packed(cp)


# ---------------------------------------------------------------------------
# Dense triangle batteries (ops/intersect.py:235-325 of the JAX package)
# ---------------------------------------------------------------------------
def _triangle_planes(v0: Vec3, e1: Vec3, e2: Vec3):
    """Per-triangle constants of the Baldwin-Weber precomputed-plane test,
    from the edges, in float32 with the multiply-adds fused as XLA fuses
    them: n = e1 x e2, the u/v dual rows f1 = (e2 x n) / |n|^2 and
    f2 = -(e1 x n) / |n|^2, d0 = n . v0, g = -(f . v0). A degenerate
    triangle gives n = 0, which the battery's |den| test rejects. (The
    cluster tables carry planes made in numpy at build time,
    ``clustered._bw_planes_np``, which round differently: hits of the dense
    and the clustered triangle batteries agree to float rounding, not to the
    bit, in both packages.)"""
    n = e1.cross(e2)
    nn = n.dot(n)
    inv_nn = torch.where(nn > 0.0,
                         torch.reciprocal(torch.clamp_min(nn, 1e-38)), 0.0)
    f1 = e2.cross(n) * inv_nn
    f2 = (-e1.cross(n)) * inv_nn
    return (n.x, n.y, n.z, n.dot(v0), f1.x, f1.y, f1.z, -f1.dot(v0),
            f2.x, f2.y, f2.z, -f2.dot(v0))


def _triangle_blocks(p: Vec3, d: Vec3, v0: Vec3, e1: Vec3, e2: Vec3):
    """Yields (ray slice, first prim of the block, t [r, c]) over blocks of
    RAY_CHUNK rays by PRIM_CHUNK triangles: candidate distances, FLT_MAX
    where the ray misses."""
    planes = _triangle_planes(v0, e1, e2)
    for r0 in range(0, p.x.shape[0], RAY_CHUNK):
        rs = slice(r0, r0 + RAY_CHUNK)
        rays = [a[rs, None] for a in (*p, *d)]
        for start in range(0, planes[0].shape[0], PRIM_CHUNK):
            rows = tuple(a[None, start:start + PRIM_CHUNK] for a in planes)
            yield rs, start, _tk._triangle_battery(*rays, rows)


def intersect_triangles(p: Vec3, d: Vec3, v0: Vec3, e1: Vec3, e2: Vec3,
                        tfar=None):
    """Closest hit over all triangles: (tfar [R], prim_id [R] int32, -1 for a
    miss). `tfar` seeds the search (only closer hits count). Prims are
    reduced in PRIM_CHUNK-wide chunks with a strict `<` between chunks: the
    first occurrence wins."""
    n = p.x.shape[0]
    best_t = (torch.full((n,), FLT_MAX, dtype=torch.float32,
                         device=p.x.device) if tfar is None else tfar.clone())
    best_id = torch.full((n,), -1, dtype=torch.int32, device=p.x.device)
    for rs, start, t in _triangle_blocks(p, d, v0, e1, e2):
        chunk_best, first = _closest_epilogue(t)
        closer = chunk_best < best_t[rs]
        best_id[rs] = torch.where(closer, first + start, best_id[rs])
        best_t[rs] = torch.where(closer, chunk_best, best_t[rs])
    return best_t, best_id


def occluded_triangles(p: Vec3, d: Vec3, tfar, v0: Vec3, e1: Vec3, e2: Vec3):
    """Any-hit shadow test: True where a triangle lies at t in (1e-6, tfar)."""
    occ = torch.zeros(p.x.shape[0], dtype=torch.bool, device=p.x.device)
    for rs, _, t in _triangle_blocks(p, d, v0, e1, e2):
        occ[rs] |= (t < tfar[rs, None]).any(dim=1)
    return occ


# ---------------------------------------------------------------------------
# Scene-level dispatch
# ---------------------------------------------------------------------------
def _accel_passes(scene, accel):
    """The passes of accel='clustered', 'grid' or 'bvh': [(closest,
    occluded)], the sphere pass and, where the scene has triangles and
    their table, the triangle pass; closest(p, d, tfar0) -> (tfar, prim_id)
    and occluded(p, d, tfar) -> [R] bool. None for another accel, and where
    the scene lacks the backend's sphere table: the dense batteries run
    then. Both rules are the JAX package's dispatch (its intersect_scene
    tests ``scene.sphere_* is not None``, and skips triangles whose table is
    missing), not a fallback of the device."""
    if accel == "clustered":
        tables = (scene.sphere_clusters, scene.tri_clusters)

        def walks(table, _):
            return (partial(clustered.intersect_clustered, table),
                    partial(clustered.occluded_clustered, table))
    elif accel in ("grid", "bvh"):
        walk = _gw if accel == "grid" else _bw
        tables = ((scene.sphere_grid, scene.tri_grid) if accel == "grid"
                  else (scene.sphere_bvh, scene.tri_bvh))

        def walks(table, rows):
            return (lambda p, d, tfar0=None: walk.closest(table, p, d, rows(),
                                                          tfar0),
                    lambda p, d, tfar: walk.occluded(table, p, d, tfar,
                                                     rows()))
    else:
        return None
    if tables[0] is None:
        return None
    sp, tri = scene.spheres, scene.triangles
    passes = [walks(tables[0],
                    lambda: _bvh.pack_spheres(sp.center, sp.radius_sq))]
    if tri is not None and tables[1] is not None:
        passes.append(walks(tables[1], lambda: _bvh.pack_triangles(
            tri.v0, tri.e1, tri.e2)))
    return passes


def _clusters_for(scene, accel, kind: str):
    """The cluster pack accel='pallas' walks for `kind` ('sphere' or
    'triangle'), or None where the dense battery runs: the scene carries no
    clusters (scene.accel.with_pallas_clusters attaches both packs) or has
    fewer than PALLAS_MIN_PRIMS prims of that kind."""
    if accel != "pallas" or scene.sphere_clusters is None:
        return None
    if kind == "sphere":
        geom, cp = scene.spheres, scene.sphere_clusters
    else:
        geom, cp = scene.triangles, scene.tri_clusters
    return cp if cp is not None and geom.count >= PALLAS_MIN_PRIMS else None


def intersect_scene(scene, p: Vec3, d: Vec3, accel: str = None, alive=None,
                    policy=None):
    """Closest hit over the scene: (tfar [R], prim_id [R] int32, is_tri [R]
    bool). prim_id indexes the spheres, or the triangles where is_tri; -1 for
    a miss. The triangle pass is seeded with the sphere pass's tfar. `accel`
    picks the backend ('brute', 'pallas', 'clustered', 'grid', 'bvh';
    ``_accel_passes`` says when the last three run the dense batteries).
    `alive` masks dead wavefront lanes for accel='pallas', whose planner
    skips them (they return a miss); every other backend tests every lane.
    `policy` carries the pallas_* knobs."""
    accel = accel or "brute"
    passes = _accel_passes(scene, accel)
    if passes is not None:
        tfar, prim_id = passes[0][0](p, d)
        is_tri = torch.zeros_like(prim_id, dtype=torch.bool)
        if len(passes) > 1:
            t2, id2 = passes[1][0](p, d, tfar)
            is_tri = id2 >= 0
            tfar = torch.where(is_tri, t2, tfar)
            prim_id = torch.where(is_tri, id2, prim_id)
        return tfar, prim_id, is_tri
    kw = _pallas_kw(policy)
    if kw.pop("compact") and alive is not None:
        run = partial(_tk.intersect_clustered_pallas_compact, alive=alive)
    else:
        run = partial(_tk.intersect_clustered_pallas, alive=alive)
    cp = _clusters_for(scene, accel, "sphere")
    if cp is not None:
        tfar, prim_id = run(cp, p, d, **_tile_for(kw, cp))
    else:
        tfar, prim_id = closest_hit(p, d, scene.spheres.center,
                                    scene.spheres.radius_sq)
    tri = scene.triangles
    if tri is None:
        return tfar, prim_id, torch.zeros_like(prim_id, dtype=torch.bool)
    cp = _clusters_for(scene, accel, "triangle")
    if cp is not None:
        t2, id2 = run(cp, p, d, tfar0=tfar, **_tile_for(kw, cp))
    else:
        t2, id2 = intersect_triangles(p, d, tri.v0, tri.e1, tri.e2, tfar=tfar)
    is_tri = id2 >= 0
    return (torch.where(is_tri, t2, tfar), torch.where(is_tri, id2, prim_id),
            is_tri)


def occluded_scene(scene, p: Vec3, d: Vec3, tfar, accel: str = None,
                   policy=None):
    """Any-hit shadow test over the scene: [R] bool. The triangle pass of
    'clustered', 'grid', 'bvh' and of the clustered 'pallas' path skips the
    lanes a sphere already occludes (their tfar is set to 0, which walks
    nothing)."""
    accel = accel or "brute"
    passes = _accel_passes(scene, accel)
    if passes is not None:
        occ = passes[0][1](p, d, tfar)
        if len(passes) > 1:
            occ = occ | passes[1][1](p, d, torch.where(occ, 0.0, tfar))
        return occ
    kw = _pallas_kw(policy)
    run = (_tk.occluded_clustered_pallas_compact if kw.pop("compact")
           else _tk.occluded_clustered_pallas)
    cp = _clusters_for(scene, accel, "sphere")
    if cp is not None:
        occ = run(cp, p, d, tfar, **_tile_for(kw, cp))
    else:
        occ = any_hit(p, d, tfar, scene.spheres.center,
                      scene.spheres.radius_sq)
    tri = scene.triangles
    if tri is None:
        return occ
    cp = _clusters_for(scene, accel, "triangle")
    if cp is not None:
        rest = torch.where(occ, 0.0, tfar)
        return occ | run(cp, p, d, rest, **_tile_for(kw, cp))
    return occ | occluded_triangles(p, d, tfar, tri.v0, tri.e1, tri.e2)
