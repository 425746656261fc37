"""Batched ray-sphere intersection, the port of the JAX package's
``ops/intersect.py`` for ``accel='brute'`` sphere scenes.

The plain batteries ``intersect_spheres`` / ``occluded_spheres`` keep the JAX
semantics (first-occurrence tie-break, sqrt-free any-hit predicate) and live
beside their CUDA kernels in ``ops/kernels/sphere_battery.py``.
``intersect_scene`` / ``occluded_scene`` dispatch to those kernels for CUDA
tensors and to the plain versions for CPU tensors.
"""
from __future__ import annotations

import torch

from ..core.vec import Vec3
from .kernels.sphere_battery import (  # noqa: F401  (re-exported JAX names)
    any_hit, closest_hit, intersect_spheres, occluded_spheres)


def _check_brute(scene, accel):
    if (accel or "brute") != "brute":
        raise NotImplementedError(
            f"accel={accel!r} is not ported yet (brute sphere battery only)")
    if scene.triangles is not None:
        raise NotImplementedError("triangle geometry is not ported yet")


def intersect_scene(scene, p: Vec3, d: Vec3, accel: str = None):
    """Closest hit over the scene: (tfar [R], prim_id [R] int32, is_tri [R]
    bool). prim_id = -1 for a miss. The brute battery tests every lane."""
    _check_brute(scene, accel)
    tfar, prim_id = closest_hit(p, d, scene.spheres.center,
                                scene.spheres.radius_sq)
    return tfar, prim_id, torch.zeros_like(prim_id, dtype=torch.bool)


def occluded_scene(scene, p: Vec3, d: Vec3, tfar, accel: str = None):
    """Any-hit shadow test over the scene: [R] bool."""
    _check_brute(scene, accel)
    return any_hit(p, d, tfar, scene.spheres.center, scene.spheres.radius_sq)
