"""Clustered primitive tables, the host-side build of the JAX package's
``ops/clustered.py``: primitives are cut into C clusters of K slots each
(an SAH tree cut into maximal <= K-prim leaves, or a morton chop), every
cluster has an AABB, and the packed rows feed the cluster-walk kernels
(``ops/kernels/cluster_traverse.py``). The build is numpy, statement for
statement the JAX package's, so the arrays are equal to the last bit.

``build_clusters_sah(group_boxes=True)`` also records each cluster's SAH
leaf boxes (``glo`` / ``ghi``), which ``pallas_plan='group'`` culls against.

``intersect_clustered`` / ``occluded_clustered`` are ``accel='clustered'``:
every cluster that any ray of the call touches runs the dense battery of
``accel='brute'`` over its real rows, nearest cluster first. The JAX package
scans all C clusters with a ``lax.cond`` each; here the cull is read back
once a call and the loop visits the touched clusters only. A sphere cluster
goes through ``closest_hit`` (the ``sphere_closest`` kernel on the card), a
triangle cluster through the plain Baldwin-Weber battery of
``ops/intersect.py``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..bvh import builder as _bvh
from ..core.vec import Vec3

SUPER = 128  # clusters a supercluster box covers (pallas_plan='super')
FLT_MAX = 3.4028234663852886e38  # float32 max, exactly representable
CULL_RAYS = 1 << 16  # rays per [R, C] block of the cull


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
    # per-cluster SAH leaf boxes ([2, C] per component), made by
    # build_clusters_sah(group_boxes=True): a cluster holds one or two
    # leaves; glo/ghi[0] bounds the first, [1] the second (a copy of the
    # first for a single-leaf cluster). pallas_plan='group' culls against them
    glo: Optional[Vec3] = None
    ghi: Optional[Vec3] = None
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
    # [6, S] float32 rows lo.xyz, hi.xyz of the S = ceil(C / SUPER)
    # supercluster boxes, each the union of SUPER consecutive clusters
    # (derived; pallas_plan='super' culls against them first)
    supers: Optional[torch.Tensor] = None
    # [C] int32 real prims a cluster (derived; every builder here puts them
    # in a cluster's first slots): what the walk kernels' counters read
    filled: Optional[torch.Tensor] = None

    def __post_init__(self):
        if self.root is None:
            zero = torch.zeros((), dtype=torch.float32,
                               device=self.lo.x.device)
            self.root = torch.stack([*(c.min() for c in self.lo),
                                     *(c.max() for c in self.hi), zero, zero])
        if self.supers is None:
            s = -(-self.num_clusters // SUPER)

            def union(a, pad, reduce):
                padded = torch.nn.functional.pad(
                    a, (0, s * SUPER - a.shape[0]), value=pad)
                return reduce(padded.reshape(s, SUPER), dim=1)

            # padding members are inverted boxes, neutral in the union
            self.supers = torch.stack(
                [union(a, 1e30, torch.amin) for a in self.lo]
                + [union(a, -1e30, torch.amax) for a in self.hi])
        if self.filled is None:
            self.filled = (self.order.view(self.num_clusters,
                                           self.cluster_size) >= 0).sum(
                dim=1, dtype=torch.int32)

    def to(self, device) -> "ClusteredPrims":
        return dataclasses.replace(
            self, rows=self.rows.to(device), order=self.order.to(device),
            lo=self.lo.to(device), hi=self.hi.to(device),
            planes=None if self.planes is None else self.planes.to(device),
            glo=None if self.glo is None else self.glo.to(device),
            ghi=None if self.ghi is None else self.ghi.to(device),
            root=self.root.to(device), supers=self.supers.to(device),
            filled=self.filled.to(device),
            packed=None if self.packed is None else self.packed.to(device))

    @staticmethod
    def from_numpy(arrays: dict, device=None) -> "ClusteredPrims":
        """From the flat arrays of ``to_numpy``'s layout: ``rows`` [C*K, F],
        ``order`` [C*K] int32, ``lo``/``hi`` [C, 3], ``planes`` [C*K, 12]
        (triangles), ``glo``/``ghi`` [2, C, 3] (group boxes, or absent) and
        the ints ``num_clusters``, ``cluster_size`` and the string ``kind``.
        Values are taken bit for bit."""
        def t(key, dtype=np.float32):
            return torch.from_numpy(
                np.array(arrays[key], dtype=dtype, order="C")).to(device)

        def vec(key, axis):
            a = t(key)
            return Vec3(*(a.select(axis, k).contiguous() for k in range(3)))

        has = lambda key: arrays.get(key) is not None
        return ClusteredPrims(
            rows=t("rows"), order=t("order", np.int32),
            lo=vec("lo", 1), hi=vec("hi", 1),
            planes=t("planes") if has("planes") else None,
            glo=vec("glo", 2) if has("glo") else None,
            ghi=vec("ghi", 2) if has("ghi") else None,
            num_clusters=int(arrays["num_clusters"]),
            cluster_size=int(arrays["cluster_size"]),
            kind=str(arrays["kind"]))

    def to_numpy(self) -> dict:
        """The flat-array layout ``from_numpy`` reads."""
        return {
            "rows": self.rows.cpu().numpy(),
            "order": self.order.cpu().numpy(),
            "lo": _stack3(self.lo), "hi": _stack3(self.hi),
            "planes": (None if self.planes is None
                       else self.planes.cpu().numpy()),
            "glo": None if self.glo is None else _stack3(self.glo),
            "ghi": None if self.ghi is None else _stack3(self.ghi),
            "num_clusters": self.num_clusters,
            "cluster_size": self.cluster_size,
            "kind": self.kind,
        }


def _stack3(v: Vec3) -> np.ndarray:
    """The components of `v` stacked on a last axis of 3, in numpy."""
    return np.stack([c.cpu().numpy() for c in v], axis=-1)


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
          kind: str, g_lo=None, g_hi=None) -> ClusteredPrims:
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
        "glo": g_lo, "ghi": g_hi,
        "num_clusters": c_lo.shape[0], "cluster_size": k, "kind": kind})


def build_clusters_sah(mins: np.ndarray, maxs: np.ndarray, rows: np.ndarray,
                       cluster_size: int = 128, kind: str = "sphere",
                       fill_window: int = 1,
                       group_boxes: bool = False) -> ClusteredPrims:
    """SAH-cut clustering: build an SAH tree with leaf_size=cluster_size
    (leaves are then maximal subtrees holding <= cluster_size prims) and emit
    each leaf as one cluster, padded to cluster_size. Consecutive leaves in
    tree order are greedily re-merged while their union stays within
    cluster_size; `fill_window` > 1 keeps that many partially filled groups
    open and puts each leaf into the first it fits in (windowed first-fit),
    closing the oldest group when none fits and the window is full.

    `group_boxes=True` caps a cluster at two leaves and records each
    cluster's leaf boxes in ``glo`` / ``ghi``, so that
    ``pallas_plan='group'`` culls per leaf inside a packed cluster."""
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
    groups = []  # closed groups, (ids, lo, hi, leaf boxes)
    open_groups = []  # windowed first-fit: insertion-ordered open groups
    w = max(1, int(fill_window))
    max_leaves = 2 if group_boxes else None
    for nid in leaf_ids:
        b, m = int(first[nid]), int(count[nid])
        # the native builder ends un-splittable runs (identical centroids)
        # as leaves of up to 8*leaf_size prims; chop those into k-sized
        # clusters with their own bounds
        if m > k:
            for b2 in range(b, b + m, k):
                m2 = min(k, b + m - b2)
                ids = order[b2 : b2 + m2].astype(np.int64)
                blo, bhi = mins32[ids].min(axis=0), maxs32[ids].max(axis=0)
                groups.append((ids, blo, bhi, [(blo, bhi)]))
            continue
        ids = order[b : b + m].astype(np.int64)
        lo, hi = node_min[nid].copy(), node_max[nid].copy()
        for gi, (pids, plo, phi, pboxes) in enumerate(open_groups):
            if pids.size + m <= k and (
                    max_leaves is None or len(pboxes) < max_leaves):
                merged = (np.concatenate([pids, ids]), np.minimum(plo, lo),
                          np.maximum(phi, hi), pboxes + [(lo, hi)])
                # a group that can take no further leaf (at exactly k prims,
                # or at the leaf cap) stops occupying a window slot
                if merged[0].size == k or (
                        max_leaves is not None
                        and len(merged[3]) >= max_leaves):
                    groups.append(merged)
                    open_groups.pop(gi)
                else:
                    open_groups[gi] = merged
                break
        else:
            if m == k:
                groups.append((ids, lo, hi, [(lo, hi)]))
            else:
                open_groups.append((ids, lo, hi, [(lo, hi)]))
            if len(open_groups) > w:  # close the oldest group
                groups.append(open_groups.pop(0))
    groups.extend(open_groups)
    num_clusters = len(groups)
    full_order = np.full(num_clusters * k, -1, np.int64)
    c_lo = np.empty((num_clusters, 3), np.float32)
    c_hi = np.empty((num_clusters, 3), np.float32)
    g_lo = np.empty((2, num_clusters, 3), np.float32) if group_boxes else None
    g_hi = np.empty((2, num_clusters, 3), np.float32) if group_boxes else None
    for c, (ids, lo, hi, boxes) in enumerate(groups):
        full_order[c * k : c * k + ids.size] = ids
        c_lo[c], c_hi[c] = lo, hi
        if group_boxes:
            g_lo[0, c], g_hi[0, c] = boxes[0]
            g_lo[1, c], g_hi[1, c] = boxes[-1]  # boxes[0] for a single leaf
    return _pack(rows, full_order, c_lo, c_hi, k, kind, g_lo, g_hi)


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


def _cluster_cull(cp: ClusteredPrims, p: Vec3, d: Vec3, tfar):
    """([C] whether any ray's slab test hits the cluster's box, [C] the
    nearest entry distance over the rays that hit it, FLT_MAX elsewhere),
    in blocks of CULL_RAYS rays (min and any are exact in any order)."""
    inv = Vec3(*(torch.reciprocal(c) for c in d))
    any_hit, entry = [], []
    for r0 in range(0, p.x.shape[0], CULL_RAYS):
        rs = slice(r0, r0 + CULL_RAYS)
        tmin = tmax = None
        for lo, hi, pc, ic in zip(cp.lo, cp.hi, p, inv):
            a = (lo[None, :] - pc[rs, None]) * ic[rs, None]
            b = (hi[None, :] - pc[rs, None]) * ic[rs, None]
            if tmin is None:
                tmin, tmax = torch.minimum(a, b), torch.maximum(a, b)
            else:
                tmin = torch.maximum(tmin, torch.minimum(a, b))
                tmax = torch.minimum(tmax, torch.maximum(a, b))
        near = torch.clamp_min(tmin, 0.0)
        hit = (tmax >= near) & (tmin < tfar[rs, None])
        any_hit.append(hit.any(dim=0))
        entry.append(torch.where(hit, near, FLT_MAX).amin(dim=0))
    return (torch.stack(any_hit).any(dim=0),
            torch.stack(entry).amin(dim=0))


def _touched(cp: ClusteredPrims, p: Vec3, d: Vec3, tfar):
    """[(cluster, real rows)] of the clusters the cull touches, nearest
    entry first (a stable sort: untouched clusters tie at FLT_MAX), from
    one host read. A cluster's real rows are a prefix of its K slots."""
    any_hit, entry = _cluster_cull(cp, p, d, tfar)
    visit = torch.argsort(entry, stable=True)
    real = (cp.order.view(cp.num_clusters, cp.cluster_size) >= 0).sum(dim=1)
    visit, hit, real = torch.stack(
        [visit, any_hit[visit].to(visit.dtype), real[visit].to(visit.dtype)]
    ).tolist()
    return [(c, n) for c, h, n in zip(visit, hit, real) if h]


def _cluster_closest(cp: ClusteredPrims, cols, c: int, n: int, p: Vec3,
                     d: Vec3):
    """(best t [R], ORIGINAL prim id [R] or -1) over cluster c's n real
    rows: the first of the least t, FLT_MAX on a miss. `cols` are the
    pack's rows as contiguous columns. A sphere's disc is fused at every
    width: XLA rounds the JAX package's K-slot battery so at every K, 8
    too (``fp.xla_fuses_sphere_bb``; tests/test_torch_disc_width.py)."""
    from . import intersect as _i

    rs = slice(c * cp.cluster_size, c * cp.cluster_size + n)
    ids = cp.order[rs]
    cl = [a[rs] for a in cols]
    if cp.kind == "sphere":
        best, arg = _i.closest_hit(p, d, Vec3(*cl[:3]), cl[3],
                                   xla_chunks=False)
    else:
        best, arg = _i.intersect_triangles(p, d, Vec3(*cl[0:3]),
                                           Vec3(*cl[3:6]), Vec3(*cl[6:9]))
    return best, torch.where(arg >= 0, ids[torch.clamp_min(arg, 0)], -1)


def _columns(cp: ClusteredPrims):
    return list(cp.rows.t().contiguous())


def intersect_clustered(cp: ClusteredPrims, p: Vec3, d: Vec3, tfar0=None):
    """Closest hit over the clustered primitives: (tfar [R], prim_id [R] in
    ORIGINAL primitive numbering, -1 for a miss). Each touched cluster, in
    order of nearest entry, replaces a lane's hit where its best is strictly
    closer; the cull uses the tfar the call starts with, a finite one (see
    ``occluded_clustered``)."""
    n = p.x.shape[0]
    tfar = (torch.full((n,), FLT_MAX, dtype=torch.float32, device=p.x.device)
            if tfar0 is None else tfar0)
    prim_id = torch.full((n,), -1, dtype=torch.int32, device=p.x.device)
    cols = _columns(cp)
    for c, real in _touched(cp, p, d, tfar):
        if real == 0:  # an empty cluster: every slot is padding
            continue
        best, ids = _cluster_closest(cp, cols, c, real, p, d)
        closer = best < tfar
        tfar = torch.where(closer, best, tfar)
        prim_id = torch.where(closer, ids, prim_id)
    return tfar, prim_id


def occluded_clustered(cp: ClusteredPrims, p: Vec3, d: Vec3, tfar):
    """Any hit: [R] bool, some prim of a touched cluster at t < tfar (the
    least t of the cluster's battery below tfar). For finite tfar, as the
    renderer's are: the JAX package's padding slots test as FLT_MAX, which
    an infinite tfar would count."""
    from . import intersect as _i

    occ = torch.zeros(p.x.shape[0], dtype=torch.bool, device=p.x.device)
    cols = _columns(cp)
    for c, real in _touched(cp, p, d, tfar):
        if real == 0:  # an empty cluster: every slot is padding
            continue
        if cp.kind == "sphere":
            best, _ = _cluster_closest(cp, cols, c, real, p, d)
            occ = occ | (best < tfar)
        else:
            rs = slice(c * cp.cluster_size, c * cp.cluster_size + real)
            cl = [a[rs] for a in cols]
            occ = occ | _i.occluded_triangles(
                p, d, tfar, Vec3(*cl[0:3]), Vec3(*cl[3:6]), Vec3(*cl[6:9]))
    return occ
