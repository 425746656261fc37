"""Scene acceleration: attach cluster tables to a scene, the cluster part of
the JAX package's ``scene/accel.py``, for spheres and triangles. Cluster
tables carry original prim ids, so nothing is reordered and the light lists
stay valid. ``with_bvh`` and ``with_grid`` belong to later port slices."""
from __future__ import annotations

import dataclasses
import functools

import numpy as np

from ..bvh import builder
from ..ops import clustered
from .scene import Scene


def _sphere_tables(scene: Scene):
    """(mins, maxs, rows) of the scene's spheres as host arrays."""
    sp = scene.spheres
    centers = np.stack([c.cpu().numpy() for c in sp.center], axis=1)
    radius_sq = sp.radius_sq.cpu().numpy()
    mins, maxs = builder.sphere_bounds(centers, np.sqrt(radius_sq))
    rows = np.concatenate([centers, radius_sq[:, None]], axis=1)
    return mins, maxs, rows


def _triangle_tables(scene: Scene):
    """(mins, maxs, rows) of the scene's triangles as host arrays; a row is
    (v0, e1, e2)."""
    tri = scene.triangles
    v0, e1, e2 = (np.stack([c.cpu().numpy() for c in v], axis=1)
                  for v in (tri.v0, tri.e1, tri.e2))
    mins, maxs = builder.triangle_bounds(v0, v0 + e1, v0 + e2)
    return mins, maxs, np.concatenate([v0, e1, e2], axis=1)


def with_pallas_clusters(scene: Scene, cluster_size="auto",
                         method: str = "sah", fill_window: int = 1) -> Scene:
    """Attach clusters sized for the cluster-walk kernels (accel='pallas',
    ops/kernels/cluster_traverse.py). method='sah' (default) cuts an SAH
    tree into maximal <= K-prim leaves (tight boxes, partial fill);
    method='morton' is the fixed-size morton chop. cluster_size='auto' is
    the JAX package's pick by prim count, the larger of the sphere and the
    triangle count (64 below 50,000 prims, 128 below 200,000, else 256),
    kept so that both packages build the same tables.

    The SAH tree comes from ``csrc/bvh_builder.cpp``, built with g++ at
    first use; without a C++ compiler the build raises (there is no second
    builder). The planner kernel takes at most 16,384 clusters
    (``cluster_traverse.max_plan_clusters``), which at cluster_size 256 is
    about 3.1 million prims; the renderer refuses a larger table before
    any work (``render.renderer.check_policy``)."""
    if cluster_size == "auto":
        p = scene.spheres.count
        if scene.triangles is not None:
            p = max(p, scene.triangles.count)
        cluster_size = 64 if p < 50_000 else (128 if p < 200_000 else 256)
    if method == "sah":
        return _with_sah_clusters(scene, cluster_size, fill_window)
    # each kind at its own cluster count
    return _attach(scene, lambda mins, maxs, rows, kind:
                   clustered.build_clusters(
                       mins, maxs, rows, kind=kind,
                       num_clusters=-(-rows.shape[0] // cluster_size)))


def _attach(scene: Scene, build) -> Scene:
    """`scene` with the packs ``build(mins, maxs, rows, kind=...)`` makes of
    its spheres and, where it has any, of its triangles."""
    packs = {"sphere_clusters": build(*_sphere_tables(scene), kind="sphere")}
    if scene.triangles is not None:
        packs["tri_clusters"] = build(*_triangle_tables(scene),
                                      kind="triangle")
    return dataclasses.replace(
        scene, **{k: cp.to(scene.device) for k, cp in packs.items()})


def _with_sah_clusters(scene: Scene, cluster_size: int,
                       fill_window: int = 1) -> Scene:
    return _attach(scene, functools.partial(
        clustered.build_clusters_sah, cluster_size=cluster_size,
        fill_window=fill_window))


def with_clusters(scene: Scene, num_clusters: int = 64) -> Scene:
    """Attach morton-clustered tables (ops/clustered.py::build_clusters)."""
    return _attach(scene, functools.partial(clustered.build_clusters,
                                            num_clusters=num_clusters))
