"""Clustered primitive tables, the host-side build of the JAX package's
``ops/clustered.py``: primitives are cut into C clusters of K slots each
(an SAH tree cut into maximal <= K-prim leaves, or a morton chop), every
cluster has an AABB, and the packed rows feed the cluster-walk kernels
(``ops/kernels/cluster_traverse.py``). The build is numpy, statement for
statement the JAX package's, so the arrays are equal to the last bit.

Not ported here: the per-leaf group boxes (``group_boxes``, read only by
``pallas_plan='group'``) and the XLA paths ``intersect_clustered`` /
``occluded_clustered`` of ``accel='clustered'``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..bvh import builder as _bvh
from ..core.vec import Vec3


@dataclasses.dataclass
class ClusteredPrims:
    """Clustered primitive arrays, padded to C * K slots."""

    rows: torch.Tensor  # [C*K, F] packed prim rows (sphere: 4, triangle: 9)
    order: torch.Tensor  # [C*K] int32 original prim id (-1 = padding)
    lo: Vec3  # [C] cluster AABB min
    hi: Vec3  # [C] cluster AABB max
    # [C*K, 12] Baldwin-Weber plane attributes (n, d0, f1, g1, f2, g2),
    # computed once in numpy at build time (triangles only)
    planes: Optional[torch.Tensor] = None
    num_clusters: int = 0
    cluster_size: int = 0
    kind: str = "sphere"
    # [8] float32 [lo.xyz, hi.xyz, 0, 0]: the root AABB, the union of the
    # cluster bounds (derived; the walks cap their exit bound with it)
    root: Optional[torch.Tensor] = None
    # [C * F8, K] row-packed attribute planes, the table the streamed walks
    # read (derived: ``cluster_traverse._tables_packed`` makes it at first
    # need; a third copy of the attributes beside `rows` and `planes`)
    packed: Optional[torch.Tensor] = None

    def __post_init__(self):
        if self.root is None:
            zero = torch.zeros((), dtype=torch.float32,
                               device=self.lo.x.device)
            self.root = torch.stack([*(c.min() for c in self.lo),
                                     *(c.max() for c in self.hi), zero, zero])

    def to(self, device) -> "ClusteredPrims":
        return dataclasses.replace(
            self, rows=self.rows.to(device), order=self.order.to(device),
            lo=self.lo.to(device), hi=self.hi.to(device),
            planes=None if self.planes is None else self.planes.to(device),
            root=self.root.to(device),
            packed=None if self.packed is None else self.packed.to(device))

    @staticmethod
    def from_numpy(arrays: dict, device=None) -> "ClusteredPrims":
        """From the flat arrays of ``to_numpy``'s layout: ``rows`` [C*K, F],
        ``order`` [C*K] int32, ``lo``/``hi`` [C, 3], ``planes`` [C*K, 12]
        (triangles) and the ints ``num_clusters``, ``cluster_size`` and the
        string ``kind``. Values are taken bit for bit."""
        def t(key, dtype=np.float32):
            return torch.from_numpy(
                np.array(arrays[key], dtype=dtype, order="C")).to(device)

        lo, hi = t("lo"), t("hi")
        return ClusteredPrims(
            rows=t("rows"), order=t("order", np.int32),
            lo=Vec3(*(lo[:, k].contiguous() for k in range(3))),
            hi=Vec3(*(hi[:, k].contiguous() for k in range(3))),
            planes=t("planes") if arrays.get("planes") is not None else None,
            num_clusters=int(arrays["num_clusters"]),
            cluster_size=int(arrays["cluster_size"]),
            kind=str(arrays["kind"]))

    def to_numpy(self) -> dict:
        """The flat-array layout ``from_numpy`` reads."""
        return {
            "rows": self.rows.cpu().numpy(),
            "order": self.order.cpu().numpy(),
            "lo": np.stack([c.cpu().numpy() for c in self.lo], axis=-1),
            "hi": np.stack([c.cpu().numpy() for c in self.hi], axis=-1),
            "planes": (None if self.planes is None
                       else self.planes.cpu().numpy()),
            "num_clusters": self.num_clusters,
            "cluster_size": self.cluster_size,
            "kind": self.kind,
        }


def _bw_planes_np(packed: np.ndarray) -> np.ndarray:
    """[C*K, 9] packed (v0, e1, e2) triangle rows -> [C*K, 12] Baldwin-Weber
    plane attributes (n.xyz, d0, f1.xyz, g1, f2.xyz, g2), in numpy float32.
    u(x) = f1.x + g1 with u(v0+e1)=1, u(v0+e2)=0 and symmetrically for v.
    Degenerate / padding rows give n = 0, which the battery's |den| mask
    rejects."""
    r = packed.astype(np.float32)
    v0, e1, e2 = r[:, 0:3], r[:, 3:6], r[:, 6:9]
    n = np.cross(e1, e2).astype(np.float32)
    nn = np.sum(n * n, axis=-1, dtype=np.float32)
    inv = np.where(nn > 0.0,
                   np.float32(1.0) / np.maximum(nn, np.float32(1e-38)),
                   np.float32(0.0)).astype(np.float32)[:, None]
    f1 = (np.cross(e2, n).astype(np.float32) * inv).astype(np.float32)
    f2 = (-np.cross(e1, n).astype(np.float32) * inv).astype(np.float32)
    d0 = np.sum(n * v0, axis=-1, dtype=np.float32)
    g1 = -np.sum(f1 * v0, axis=-1, dtype=np.float32)
    g2 = -np.sum(f2 * v0, axis=-1, dtype=np.float32)
    return np.concatenate(
        [n, d0[:, None], f1, g1[:, None], f2, g2[:, None]], axis=1
    ).astype(np.float32)


def _norm_k(k: int) -> int:
    """Normalize a cluster size as the JAX package does: below 128 up to the
    next power of two, from 128 on up to a multiple of 128. (There the rule
    comes from the TPU's 128-lane registers; here it is kept so that both
    packages cut a scene into the same clusters.)"""
    if k >= 128:
        return -(-k // 128) * 128
    return 1 << max(0, (k - 1)).bit_length()


def _pack(rows: np.ndarray, full_order: np.ndarray, c_lo, c_hi, k: int,
          kind: str) -> ClusteredPrims:
    """Packed rows with far-away degenerate padding prims that never hit
    (x = 1e16, everything else 0), as tensors on the CPU."""
    p = rows.shape[0]
    pad_row = np.zeros(rows.shape[1], np.float32)
    pad_row[0] = 1e16
    all_rows = np.vstack([rows.astype(np.float32), pad_row[None, :]])
    packed = all_rows[np.where(full_order >= 0, full_order, p)]
    return ClusteredPrims.from_numpy({
        "rows": packed, "order": full_order.astype(np.int32),
        "lo": c_lo, "hi": c_hi,
        "planes": _bw_planes_np(packed) if kind == "triangle" else None,
        "num_clusters": c_lo.shape[0], "cluster_size": k, "kind": kind})


def build_clusters_sah(mins: np.ndarray, maxs: np.ndarray, rows: np.ndarray,
                       cluster_size: int = 128, kind: str = "sphere",
                       fill_window: int = 1) -> ClusteredPrims:
    """SAH-cut clustering: build an SAH tree with leaf_size=cluster_size
    (leaves are then maximal subtrees holding <= cluster_size prims) and emit
    each leaf as one cluster, padded to cluster_size. Consecutive leaves in
    tree order are greedily re-merged while their union stays within
    cluster_size; `fill_window` > 1 keeps that many partially filled groups
    open and puts each leaf into the first it fits in (windowed first-fit),
    closing the oldest group when none fits and the window is full."""
    mins32 = np.asarray(mins, np.float32)
    maxs32 = np.asarray(maxs, np.float32)
    p = mins32.shape[0]
    k = _norm_k(int(min(cluster_size, max(1, p))))
    node_min, node_max, first, count, order = _bvh.build_tree(
        mins32, maxs32, leaf_size=k)
    leaf_ids = np.where(count > 0)[0]
    # leaves tile the reordered prim range contiguously, so sorting by range
    # start makes consecutive leaves tree-adjacent (usually siblings)
    leaf_ids = leaf_ids[np.argsort(first[leaf_ids], kind="stable")]
    groups = []  # closed groups, (ids, lo, hi)
    open_groups = []  # windowed first-fit: insertion-ordered open groups
    w = max(1, int(fill_window))
    for nid in leaf_ids:
        b, m = int(first[nid]), int(count[nid])
        # the native builder ends un-splittable runs (identical centroids)
        # as leaves of up to 8*leaf_size prims; chop those into k-sized
        # clusters with their own bounds
        if m > k:
            for b2 in range(b, b + m, k):
                m2 = min(k, b + m - b2)
                ids = order[b2 : b2 + m2].astype(np.int64)
                groups.append((ids, mins32[ids].min(axis=0),
                               maxs32[ids].max(axis=0)))
            continue
        ids = order[b : b + m].astype(np.int64)
        lo, hi = node_min[nid].copy(), node_max[nid].copy()
        for gi, (pids, plo, phi) in enumerate(open_groups):
            if pids.size + m <= k:
                merged = (np.concatenate([pids, ids]), np.minimum(plo, lo),
                          np.maximum(phi, hi))
                # a full group stops occupying a window slot
                if merged[0].size == k:
                    groups.append(merged)
                    open_groups.pop(gi)
                else:
                    open_groups[gi] = merged
                break
        else:
            if m == k:
                groups.append((ids, lo, hi))
            else:
                open_groups.append((ids, lo, hi))
            if len(open_groups) > w:  # close the oldest group
                groups.append(open_groups.pop(0))
    groups.extend(open_groups)
    num_clusters = len(groups)
    full_order = np.full(num_clusters * k, -1, np.int64)
    c_lo = np.empty((num_clusters, 3), np.float32)
    c_hi = np.empty((num_clusters, 3), np.float32)
    for c, (ids, lo, hi) in enumerate(groups):
        full_order[c * k : c * k + ids.size] = ids
        c_lo[c], c_hi[c] = lo, hi
    return _pack(rows, full_order, c_lo, c_hi, k, kind)


def _morton3(x, y, z):
    def spread(v):
        v = v.astype(np.uint64) & 0x1FFFFF
        v = (v | (v << 32)) & 0x1F00000000FFFF
        v = (v | (v << 16)) & 0x1F0000FF0000FF
        v = (v | (v << 8)) & 0x100F00F00F00F00F
        v = (v | (v << 4)) & 0x10C30C30C30C30C3
        v = (v | (v << 2)) & 0x1249249249249249
        return v

    return spread(x) | (spread(y) << 1) | (spread(z) << 2)


def build_clusters(mins: np.ndarray, maxs: np.ndarray, rows: np.ndarray,
                   num_clusters: int = 64, kind: str = "sphere"
                   ) -> ClusteredPrims:
    """Morton clustering: sort prim centroids along the morton curve, chop
    into `num_clusters` contiguous runs, pad to equal size. `rows` is the
    packed per-prim test data ([P,4] spheres / [P,9] triangles)."""
    mins = np.asarray(mins, np.float64)
    maxs = np.asarray(maxs, np.float64)
    p = mins.shape[0]
    num_clusters = max(1, min(num_clusters, p))
    cent = 0.5 * (mins + maxs)
    lo = cent.min(axis=0)
    span = np.maximum(cent.max(axis=0) - lo, 1e-12)
    q = ((cent - lo) / span * ((1 << 21) - 1)).astype(np.uint64)
    order = np.argsort(_morton3(q[:, 0], q[:, 1], q[:, 2]), kind="stable")

    k = _norm_k(-(-p // num_clusters))
    full_order = np.full(num_clusters * k, -1, np.int64)
    full_order[:p] = order
    c_lo = np.empty((num_clusters, 3), np.float32)
    c_hi = np.empty((num_clusters, 3), np.float32)
    for c in range(num_clusters):
        ids = full_order[c * k : (c + 1) * k]
        ids = ids[ids >= 0]
        if ids.size:
            c_lo[c] = mins[ids].min(axis=0)
            c_hi[c] = maxs[ids].max(axis=0)
        else:
            c_lo[c] = 1e16
            c_hi[c] = 1e16
    return _pack(rows, full_order, c_lo, c_hi, k, kind)
