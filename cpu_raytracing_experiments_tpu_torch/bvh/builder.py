"""Primitive bounds and the host-side SAH tree build, the part of the JAX
package's ``bvh/builder.py`` that the cluster build (``ops/clustered.py``)
needs: ``sphere_bounds``, ``triangle_bounds`` and the tree as flat arrays
from the native full-sweep builder (``csrc/bvh_builder.cpp``). The JAX
package's numpy binned-SAH builder, which it takes where no C++ compiler is
at hand and which gives a different tree, has no copy here: one builder, so
the clusters of a scene are always the same. The threaded BVH itself
(``BVHArrays``, miss links, ``accel='bvh'``) belongs to a later port slice.
"""
from __future__ import annotations

import numpy as np

from ..utils import native


def build_tree(mins: np.ndarray, maxs: np.ndarray, leaf_size: int = 1):
    """(node_min [N,3], node_max [N,3], first [N], count [N], prim_order):
    inner nodes have count 0; a leaf holds prims order[first:first+count].
    Always the native builder: where it cannot be built, this raises."""
    return native.bvh_build(mins, maxs, leaf_size=leaf_size)


def sphere_bounds(centers: np.ndarray, radii: np.ndarray):
    r = radii[:, None]
    return centers - r, centers + r


def triangle_bounds(v0: np.ndarray, v1: np.ndarray, v2: np.ndarray):
    mins = np.minimum(np.minimum(v0, v1), v2)
    maxs = np.maximum(np.maximum(v0, v1), v2)
    return mins, maxs
