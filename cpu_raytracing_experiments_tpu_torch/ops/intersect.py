"""Batched ray-sphere intersection, the port of the JAX package's
``ops/intersect.py`` for sphere scenes under ``accel='brute'`` and
``accel='pallas'``.

The plain batteries ``intersect_spheres`` / ``occluded_spheres`` keep the JAX
semantics (first-occurrence tie-break, sqrt-free any-hit predicate) and live
beside their CUDA kernels in ``ops/kernels/sphere_battery.py``; the clustered
traversal of ``accel='pallas'`` lives in ``ops/kernels/cluster_traverse.py``.
``intersect_scene`` / ``occluded_scene`` dispatch to the kernels for CUDA
tensors and to the plain versions for CPU tensors.
"""
from __future__ import annotations

from functools import partial

import torch

from ..core.vec import Vec3
from .kernels import cluster_traverse as _tk
from .kernels.sphere_battery import (  # noqa: F401  (re-exported JAX names)
    any_hit, closest_hit, intersect_spheres, occluded_spheres)

PALLAS_MIN_PRIMS = 192  # below this the clustered path's fixed cost (a plan
# and a walk launch per call) is not worth it and the dense battery runs, as
# in the JAX package; kept equal so both packages pick the same backend

PALLAS_STREAM_BYTES = 48 << 20  # pallas_stream='auto' resolves to on above
# this table size in the JAX package; the streamed walks are not ported


def _tile_for(kw: dict, cp) -> dict:
    """Resolve tile_r='auto' per cluster pack, as the JAX package does: 128
    rays per tile below 2048 clusters, else 256."""
    if kw.get("tile_r") == "auto":
        kw = dict(kw, tile_r=128 if cp.num_clusters < 2048 else 256)
    return kw


def _pallas_kw(policy) -> dict:
    """The pallas_* knobs the traversal reads from a RendererPolicy
    (defaults when policy is None). The schedule knobs of the JAX package
    (plan_block, unroll, fuse, trav_block, exit_refresh, prefetch) describe
    a TPU schedule and change nothing here; ``render.renderer.check_policy``
    refuses the options that are not ported."""
    if policy is None:
        return {"tile_r": _tk.DEFAULT_TILE_R, "compact": False}
    return {"tile_r": policy.pallas_tile_rays,
            "compact": policy.pallas_compact}


def stream_resolves_on(policy, cp) -> bool:
    """Whether ``pallas_stream`` resolves to the streamed walks for `cp`
    (``_tile_for`` of the JAX package): True, or 'auto' with tables above
    PALLAS_STREAM_BYTES at a cluster size of 128 or more."""
    stream = policy.pallas_stream
    if stream == "auto":
        stream = _tk.table_bytes(cp) > PALLAS_STREAM_BYTES
    return bool(stream) and cp.cluster_size >= 128


def max_clusters(policy, cp) -> int:
    """The most clusters the planner kernel takes at the tile size `policy`
    resolves to for `cp` (``cluster_traverse.max_plan_clusters``)."""
    kw = _tile_for(_pallas_kw(policy), cp)
    return _tk.max_plan_clusters(kw["tile_r"])


def _check_accel(scene, accel):
    if accel not in ("brute", "pallas"):
        raise NotImplementedError(
            f"accel={accel!r} is not ported yet ('brute' and 'pallas' are)")
    if scene.triangles is not None:
        raise NotImplementedError("triangle geometry is not ported yet")


def _use_clusters(scene, accel) -> bool:
    """accel='pallas' runs the clustered traversal where the scene carries
    clusters (scene.accel.with_pallas_clusters) and has at least
    PALLAS_MIN_PRIMS spheres; otherwise the dense battery runs."""
    return (accel == "pallas" and scene.sphere_clusters is not None
            and scene.spheres.count >= PALLAS_MIN_PRIMS)


def intersect_scene(scene, p: Vec3, d: Vec3, accel: str = None, alive=None,
                    policy=None):
    """Closest hit over the scene: (tfar [R], prim_id [R] int32, is_tri [R]
    bool). prim_id = -1 for a miss. `alive` masks dead wavefront lanes for
    accel='pallas', whose planner skips them (they return a miss); the
    brute battery tests every lane. `policy` carries the pallas_* knobs."""
    accel = accel or "brute"
    _check_accel(scene, accel)
    if _use_clusters(scene, accel):
        kw = _pallas_kw(policy)
        if kw.pop("compact") and alive is not None:
            run = partial(_tk.intersect_clustered_pallas_compact, alive=alive)
        else:
            run = partial(_tk.intersect_clustered_pallas, alive=alive)
        cp = scene.sphere_clusters
        tfar, prim_id = run(cp, p, d, **_tile_for(kw, cp))
    else:
        tfar, prim_id = closest_hit(p, d, scene.spheres.center,
                                    scene.spheres.radius_sq)
    return tfar, prim_id, torch.zeros_like(prim_id, dtype=torch.bool)


def occluded_scene(scene, p: Vec3, d: Vec3, tfar, accel: str = None,
                   policy=None):
    """Any-hit shadow test over the scene: [R] bool."""
    accel = accel or "brute"
    _check_accel(scene, accel)
    if _use_clusters(scene, accel):
        kw = _pallas_kw(policy)
        run = (_tk.occluded_clustered_pallas_compact if kw.pop("compact")
               else _tk.occluded_clustered_pallas)
        cp = scene.sphere_clusters
        return run(cp, p, d, tfar, **_tile_for(kw, cp))
    return any_hit(p, d, tfar, scene.spheres.center, scene.spheres.radius_sq)
