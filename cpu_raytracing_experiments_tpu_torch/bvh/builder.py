"""BVH construction, the port of the JAX package's ``bvh/builder.py``:
primitive bounds, the host-side SAH tree build from the native full-sweep
builder (``csrc/bvh_builder.cpp``), and the threaded BVH of ``accel='bvh'``
(``BVHArrays``, ``compute_miss_links``, ``build_bvh``) that
``bvh/traverse.py`` walks. The cluster build (``ops/clustered.py``) cuts the
same tree into clusters.

The JAX package falls back to a numpy binned-SAH builder where no C++
compiler is at hand, and that builder gives a different tree. It has no copy
here: one builder, so the BVH and the clusters of a scene are always the
same, and ``build_tree`` / ``build_bvh`` raise without a compiler.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.vec import Vec3
from ..utils import native


def build_tree(mins: np.ndarray, maxs: np.ndarray, leaf_size: int = 1):
    """(node_min [N,3], node_max [N,3], first [N], count [N], prim_order):
    inner nodes have count 0; a leaf holds prims order[first:first+count].
    Always the native builder: where it cannot be built, this raises."""
    return native.bvh_build(mins, maxs, leaf_size=leaf_size)


@dataclasses.dataclass
class BVHArrays:
    """Flattened *threaded* BVH (the reference's node layout, BVH.hpp:18-33,
    as structure of arrays, plus a skip link): an inner node has first = its
    first child (the two children are adjacent) and count 0; a leaf has
    count > 0 and first = its first primitive (the primitives are reordered
    into leaf order). ``miss`` threads the depth-first order: the node to
    visit when this node's box is missed or its leaf is done; -1 ends the
    walk. A ray's whole traversal state is one node cursor."""

    node_min: Vec3  # [N] float32
    node_max: Vec3  # [N] float32
    first: torch.Tensor  # [N] int32
    count: torch.Tensor  # [N] int32
    miss: torch.Tensor  # [N] int32 skip link
    max_leaf: int = 1  # the most prims in any leaf (a loop bound)

    @property
    def num_nodes(self) -> int:
        return int(self.first.shape[0])

    def to(self, device) -> "BVHArrays":
        return dataclasses.replace(
            self, node_min=self.node_min.to(device),
            node_max=self.node_max.to(device), first=self.first.to(device),
            count=self.count.to(device), miss=self.miss.to(device))

    @staticmethod
    def from_numpy(arrays: dict, device=None) -> "BVHArrays":
        """From ``to_numpy``'s layout: ``node_min`` / ``node_max`` [N, 3]
        float32, ``first`` / ``count`` / ``miss`` [N] int32 and the int
        ``max_leaf``. Values are taken bit for bit."""
        def t(key, dtype):
            return torch.from_numpy(np.array(arrays[key], dtype=dtype,
                                             order="C")).to(device)

        lo, hi = t("node_min", np.float32), t("node_max", np.float32)
        return BVHArrays(
            node_min=Vec3(*(lo[:, k].contiguous() for k in range(3))),
            node_max=Vec3(*(hi[:, k].contiguous() for k in range(3))),
            first=t("first", np.int32), count=t("count", np.int32),
            miss=t("miss", np.int32), max_leaf=int(arrays["max_leaf"]))

    def to_numpy(self) -> dict:
        """The flat-array layout ``from_numpy`` reads."""
        return {
            "node_min": np.stack([c.cpu().numpy() for c in self.node_min], 1),
            "node_max": np.stack([c.cpu().numpy() for c in self.node_max], 1),
            "first": self.first.cpu().numpy(),
            "count": self.count.cpu().numpy(),
            "miss": self.miss.cpu().numpy(), "max_leaf": self.max_leaf}


def compute_miss_links(first: np.ndarray, count: np.ndarray) -> np.ndarray:
    """Thread the tree: miss[n] = the next node in depth-first order once
    n's subtree is skipped or finished; -1 at the end. Children are adjacent
    (first, first + 1) and visited in stored order."""
    n = first.shape[0]
    miss = np.full(n, -1, np.int64)
    stack = [(0, -1)]
    while stack:
        node, after = stack.pop()
        miss[node] = after
        if count[node] == 0:  # inner
            c0 = int(first[node])
            stack.append((c0 + 1, after))
            stack.append((c0, c0 + 1))
    return miss.astype(np.int32)


def build_bvh(mins: np.ndarray, maxs: np.ndarray, leaf_size: int = 1,
              device=None) -> tuple:
    """A threaded BVH over primitive AABBs: (BVHArrays on `device`,
    prim_order). Callers reorder their primitive arrays by prim_order so
    that leaves index them directly (the reference's final reorder,
    BVH.hpp:201-205). Raises where the native builder cannot be built."""
    mins = np.asarray(mins, np.float32)
    maxs = np.asarray(maxs, np.float32)
    node_min, node_max, first, count, order = build_tree(
        mins, maxs, leaf_size=leaf_size)
    miss = compute_miss_links(first, count)
    max_leaf = int(count.max()) if count.size else 1

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    arrays = BVHArrays(
        node_min=Vec3(*(t(node_min[:, k]) for k in range(3))),
        node_max=Vec3(*(t(node_max[:, k]) for k in range(3))),
        first=t(first.astype(np.int32)), count=t(count.astype(np.int32)),
        miss=t(miss), max_leaf=max(max_leaf, 1))
    return arrays, order


def sphere_bounds(centers: np.ndarray, radii: np.ndarray):
    r = radii[:, None]
    return centers - r, centers + r


def triangle_bounds(v0: np.ndarray, v1: np.ndarray, v2: np.ndarray):
    mins = np.minimum(np.minimum(v0, v1), v2)
    maxs = np.maximum(np.maximum(v0, v1), v2)
    return mins, maxs
