"""Scene acceleration, the port of the JAX package's ``scene/accel.py``:
attach BVHs, uniform grids or cluster tables to a scene, for its spheres and
triangles, on the scene's device.

``with_bvh`` is the reference's rebuild on a geometry change
(Application.cpp:508 -> BVH.hpp:90-206): a host-side SAH build, the prims
reordered into leaf order and the NEE light lists remapped to the new
order. Like the JAX package it leaves ``light_alias`` and any cluster packs
as they are (the alias table indexes positions in the light lists, which
the remap keeps; a cluster pack built before the reorder names the old
prim ids). Grids and cluster tables carry original prim ids, so
``with_grid`` and the cluster builders reorder nothing."""
from __future__ import annotations

import dataclasses
import functools

import numpy as np

import torch

from ..bvh import builder, grid as grid_mod
from ..core.vec import Vec3
from ..ops import clustered
from ..utils import profiling
from .scene import Scene, SphereGeometry, TriangleGeometry


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


def _reordered(v: Vec3, idx) -> Vec3:
    return Vec3(v.x[idx], v.y[idx], v.z[idx])


def _remap(lights, order: np.ndarray):
    """`lights` (old prim indices) renumbered to positions in `order`."""
    inv = np.empty_like(order)
    inv[order] = np.arange(order.shape[0], dtype=order.dtype)
    return torch.from_numpy(inv.astype(np.int32)).to(lights.device)[lights]


def with_bvh(scene: Scene, leaf_size: int = 4) -> Scene:
    """The scene with sphere (and triangle) BVHs attached, its primitives
    reordered into leaf order and its light lists remapped. The native
    builder raises where no C++ compiler is found (the JAX package would
    build another tree in numpy)."""
    dev = scene.device
    mins, maxs, _ = _sphere_tables(scene)
    sphere_bvh, order = builder.build_bvh(mins, maxs, leaf_size=leaf_size,
                                          device=dev)
    idx = torch.from_numpy(order.astype(np.int64)).to(dev)
    sp = scene.spheres
    spheres = SphereGeometry(_reordered(sp.center, idx), sp.radius_sq[idx],
                             sp.material_id[idx])
    lights = _remap(scene.lights, order)
    tri_bvh, triangles, tri_lights = None, scene.triangles, scene.tri_lights
    if triangles is not None:
        tmins, tmaxs, _ = _triangle_tables(scene)
        tri_bvh, torder = builder.build_bvh(tmins, tmaxs,
                                            leaf_size=leaf_size, device=dev)
        tidx = torch.from_numpy(torder.astype(np.int64)).to(dev)
        tri = triangles
        triangles = TriangleGeometry(
            *(_reordered(v, tidx) for v in (tri.v0, tri.e1, tri.e2,
                                            tri.normal)),
            material_id=tri.material_id[tidx], area=tri.area[tidx])
        if tri_lights is not None:
            tri_lights = _remap(tri_lights, torder)
    return dataclasses.replace(
        scene, spheres=spheres, lights=lights, triangles=triangles,
        tri_lights=tri_lights, sphere_bvh=sphere_bvh, tri_bvh=tri_bvh)


def with_grid(scene: Scene, res: int = 32, max_per_cell: int = 16) -> Scene:
    """The scene with uniform DDA grids attached (``bvh/grid.py``). Cells
    hold prim ids, so nothing is reordered and the light lists stay
    valid."""
    def grid(mins, maxs, _):
        return grid_mod.build_grid(mins, maxs, res=res,
                                   max_per_cell=max_per_cell,
                                   device=scene.device)

    tri_grid = (None if scene.triangles is None
                else grid(*_triangle_tables(scene)))
    return dataclasses.replace(scene, sphere_grid=grid(*_sphere_tables(scene)),
                               tri_grid=tri_grid)


def auto_cluster_size(prims: int) -> int:
    """cluster_size='auto' for a scene whose larger pack holds `prims`
    prims: 64 below 50,000, 128 below 200,000, else 256 (the JAX package's
    pick)."""
    return 64 if prims < 50_000 else (128 if prims < 200_000 else 256)


def with_pallas_clusters(scene: Scene, cluster_size="auto",
                         method: str = "sah", fill_window: int = 1,
                         group_boxes: bool = False) -> Scene:
    """Attach clusters sized for the cluster-walk kernels (accel='pallas',
    ops/kernels/cluster_traverse.py). method='sah' (default) cuts an SAH
    tree into maximal <= K-prim leaves (tight boxes, partial fill);
    method='morton' is the fixed-size morton chop. `group_boxes` (SAH only)
    caps a cluster at two leaves and keeps their boxes for
    ``pallas_plan='group'``. cluster_size='auto' is
    the JAX package's pick by prim count, the larger of the sphere and the
    triangle count (64 below 50,000 prims, 128 below 200,000, else 256),
    kept so that both packages build the same tables.

    The SAH tree comes from ``csrc/bvh_builder.cpp``, built with g++ at
    first use; without a C++ compiler the build raises (there is no second
    builder). Any cluster count plans: above what the sorting planner
    kernel holds in one block (``cluster_traverse.max_plan_clusters``),
    ``_plan_visits`` sorts the entry matrix in PyTorch."""
    with profiling.span("port.accel_build", step="with_pallas_clusters"):
        if cluster_size == "auto":
            p = scene.spheres.count
            if scene.triangles is not None:
                p = max(p, scene.triangles.count)
            cluster_size = auto_cluster_size(p)
        if method == "sah":
            return _with_sah_clusters(scene, cluster_size, fill_window,
                                      group_boxes)
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
                       fill_window: int = 1,
                       group_boxes: bool = False) -> Scene:
    return _attach(scene, functools.partial(
        clustered.build_clusters_sah, cluster_size=cluster_size,
        fill_window=fill_window, group_boxes=group_boxes))


def with_clusters(scene: Scene, num_clusters: int = 64) -> Scene:
    """Attach morton-clustered tables (ops/clustered.py::build_clusters)."""
    return _attach(scene, functools.partial(clustered.build_clusters,
                                            num_clusters=num_clusters))
