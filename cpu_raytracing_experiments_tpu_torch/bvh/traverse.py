"""Stackless threaded-BVH traversal, the port of the JAX package's
``bvh/traverse.py``: the plain PyTorch forms of ``accel='bvh'``.

Every ray carries one node cursor and steps

    cursor <- hit & inner ? first_child : miss_link

until it reads -1; a leaf it hits tests its up to ``max_leaf`` prims in
order, the closest form tightening tfar as it goes. Per-ray slab
coefficients m = 1/dir, n = p/dir as the reference's
AABB_acceleration_struct (BVH.hpp:326-333); the slab test clamps tmin at
1e-4 and caps tmax at the current tfar (test_AABB, BVH.hpp:220-234).

The JAX package runs the walk as a lock-step ``lax.while_loop`` over all
rays. Each ray's walk depends on that ray alone, so the loop here steps only
the rays still walking (one host read a step) and gives every lane the bits
of the lock-step loop. These forms are what a tensor on the CPU takes, and
the reference the kernels of ``ops/kernels/bvh_walk.py`` are held to on the
card.

Rounding: XLA contracts each product of the slab test with the subtraction
that follows it (lo = fma(node_min, m, -n)), the dot products and cross
products of the leaf tests as ``core/fp.py``'s ``dot3`` and
``Vec3.cross`` write them, and the sphere test's disc as fma(b, b,
r^2 - |t|^2). Its minimum and maximum propagate NaN, as ``torch.minimum`` /
``torch.maximum`` / ``torch.clamp_min`` do: an axis-aligned ray whose
origin is 0 on that axis makes n = 0 * inf = NaN there, and misses every
box.
"""
from __future__ import annotations

from typing import Callable

import torch

from ..core import fp
from ..core.vec import Vec3
from .builder import BVHArrays

FLT_MAX = 3.4028234663852886e38  # float32 max, exactly representable
COUNT_SHIFT = 27  # pack_nodes: count in the high bits of slot 6
FIRST_MASK = (1 << COUNT_SHIFT) - 1


def _slab_from_row(mnx, mny, mnz, mxx, mxy, mxz, m: Vec3, n: Vec3, tfar):
    """Reference test_AABB (BVH.hpp:220-234) with per-ray m = 1/dir,
    n = p/dir; each bound fma(bound, m, -n), rounded once."""
    lo = fp.fma(mnx, m.x, -n.x)
    hi = fp.fma(mxx, m.x, -n.x)
    tmin = torch.clamp_min(torch.minimum(lo, hi), 1e-4)
    tmax = torch.minimum(tfar, torch.maximum(lo, hi))
    for mn, mx, mc, nc in ((mny, mxy, m.y, n.y), (mnz, mxz, m.z, n.z)):
        lo = fp.fma(mn, mc, -nc)
        hi = fp.fma(mx, mc, -nc)
        tmin = torch.maximum(tmin, torch.minimum(lo, hi))
        tmax = torch.minimum(tmax, torch.maximum(lo, hi))
    return tmax >= tmin


def _slab_test(bvh: BVHArrays, node, m: Vec3, n: Vec3, tfar):
    """``_slab_from_row`` on the bounds of `node` [R] gathered from the
    structure-of-arrays BVH."""
    return _slab_from_row(*(c[node] for c in (*bvh.node_min, *bvh.node_max)),
                          m, n, tfar)


def _ray_coeffs(p: Vec3, d: Vec3):
    """m = 1/dir (inf on an axis-aligned ray) and n = p * m."""
    m = Vec3(*(torch.reciprocal(c) for c in d))
    return m, Vec3(p.x * m.x, p.y * m.y, p.z * m.z)


def _sub(v: Vec3, idx) -> Vec3:
    return Vec3(v.x[idx], v.y[idx], v.z[idx])


def _walk(fetch, leaf, max_leaf: int, p: Vec3, d: Vec3, tfar, cursor,
          shadow: bool, counts=None):
    """The threaded walk of the rays whose cursor is >= 0. fetch(cursor [r])
    -> (the six bounds, first, count, miss) of those nodes; leaf(prim [r],
    p, d) -> (t [r], ok [r]). Closest (shadow False): returns (tfar,
    prim_id, steps), tfar tightening within a leaf. Any hit: (occluded,
    None, steps), a ray stopping at its first hit with t in [0, tfar).
    `steps` counts the lock-step loop's trips (the worst ray's nodes). A
    `counts` dict gains the node visits ("nodes") and prim tests ("tests")
    of all rays (one host read a leaf slot)."""
    m, n = _ray_coeffs(p, d)
    count_r = p.x.shape[0]
    dev = p.x.device
    prim_id = torch.full((count_r,), -1, dtype=torch.int32, device=dev)
    occluded = torch.zeros(count_r, dtype=torch.bool, device=dev)
    idx = torch.nonzero(cursor >= 0)[:, 0]
    steps = 0
    while idx.numel():
        steps += 1
        *bounds, first, count, miss = fetch(cursor[idx])
        ps, ds = _sub(p, idx), _sub(d, idx)
        tf = tfar[idx]
        hit = _slab_from_row(*bounds, _sub(m, idx), _sub(n, idx), tf)
        is_leaf = count > 0
        leaf_hit = hit & is_leaf
        pid = prim_id[idx]
        found = torch.zeros_like(hit)
        if counts is not None:
            counts["nodes"] = counts.get("nodes", 0) + idx.numel()
        for s in range(max_leaf):
            valid = leaf_hit & (s < count)
            prim = first + s
            if counts is not None:
                counts["tests"] = counts.get("tests", 0) + int(valid.sum())
            t, ok = leaf(torch.where(valid, prim, 0), ps, ds)
            if shadow:
                found = found | (valid & ok & (t < tf) & (t >= 0.0))
            else:
                closer = valid & ok & (t < tf)
                tf = torch.where(closer, t, tf)
                pid = torch.where(closer, prim, pid)
        nxt = torch.where(hit & ~is_leaf, first, miss)
        if shadow:
            occluded[idx] = found
            nxt = torch.where(found, -1, nxt)
        else:
            tfar[idx] = tf
            prim_id[idx] = pid
        cursor[idx] = nxt
        idx = idx[nxt >= 0]
    if shadow:
        return occluded, None, steps
    return tfar, prim_id, steps


def _start(p: Vec3, tfar0):
    n = p.x.shape[0]
    dev = p.x.device
    tfar = (torch.full((n,), FLT_MAX, dtype=torch.float32, device=dev)
            if tfar0 is None else tfar0.clone())
    return tfar, torch.zeros(n, dtype=torch.int32, device=dev)


def _soa_fetch(bvh: BVHArrays):
    def fetch(node):
        return (*(c[node] for c in (*bvh.node_min, *bvh.node_max)),
                bvh.first[node], bvh.count[node], bvh.miss[node])
    return fetch


def traverse_closest(bvh: BVHArrays, p: Vec3, d: Vec3, leaf_test: Callable,
                     tfar0=None):
    """Closest-hit traversal. leaf_test(prim [R] int32, p, d, tfar [R]) ->
    (t [R], valid [R]). Returns (tfar [R], prim_id [R], -1 for a miss)."""
    tfar, cursor = _start(p, tfar0)
    tfar, prim_id, _ = _walk(
        _soa_fetch(bvh), lambda prim, p, d: leaf_test(prim, p, d, None),
        bvh.max_leaf, p, d, tfar, cursor, shadow=False)
    return tfar, prim_id


def traverse_shadow(bvh: BVHArrays, p: Vec3, d: Vec3, tfar,
                    leaf_test: Callable):
    """Any-hit traversal (BVH.hpp:362-404): occluded [R], a prim at t in
    [0, tfar). Rays with tfar <= 0 are disabled shadow queries."""
    cursor = torch.where(tfar > 0.0, 0, -1).to(torch.int32)
    occ, _, _ = _walk(
        _soa_fetch(bvh), lambda prim, p, d: leaf_test(prim, p, d, None),
        bvh.max_leaf, p, d, tfar, cursor, shadow=True)
    return occ


# ---------------------------------------------------------------------------
# Leaf primitive tests (one gathered prim per ray)
# ---------------------------------------------------------------------------
def _sphere_t(cx, cy, cz, rsq, p: Vec3, d: Vec3):
    """(t, ok) of the reference's root selection (BVH.hpp:270-287)."""
    tx = cx - p.x
    ty = cy - p.y
    tz = cz - p.z
    b = fp.dot3(d.x, d.y, d.z, tx, ty, tz)
    disc = fp.fma(b, b, rsq - fp.dot3(tx, ty, tz, tx, ty, tz))
    sq = fp.sqrt(torch.clamp_min(disc, 0.0))
    t_near = b - sq
    t = torch.where(t_near < 0.0, b + sq, t_near)
    return t, (disc >= 0.0) & (t >= 0.0)


def sphere_leaf_test(center: Vec3, radius_sq):
    """Reference root selection, one gathered sphere per ray."""
    def test(prim, p: Vec3, d: Vec3, tfar):
        return _sphere_t(center.x[prim], center.y[prim], center.z[prim],
                         radius_sq[prim], p, d)
    return test


def _moller_trumbore(v0: Vec3, e1: Vec3, e2: Vec3, p: Vec3, d: Vec3):
    """(t, ok) of Moller-Trumbore; |det| <= 1e-12 rejects."""
    h = d.cross(e2)
    det = e1.dot(h)
    big = torch.abs(det) > 1e-12
    inv_det = torch.where(big, torch.reciprocal(det), 0.0)
    s = p - v0
    u = s.dot(h) * inv_det
    q = s.cross(e1)
    v = d.dot(q) * inv_det
    t = e2.dot(q) * inv_det
    ok = big & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > 1e-6)
    return t, ok


def triangle_leaf_test(v0: Vec3, e1: Vec3, e2: Vec3):
    """Moller-Trumbore, one gathered triangle per ray."""
    def test(prim, p: Vec3, d: Vec3, tfar):
        return _moller_trumbore(_sub(v0, prim), _sub(e1, prim),
                                _sub(e2, prim), p, d)
    return test


# ---------------------------------------------------------------------------
# Packed-row traversal: one [8]-float node row per step. Row layout:
# [min.x, min.y, min.z, max.x, max.y, max.z, bitcast(first | count << 27),
# bitcast(miss)] (first < 2^27, count < 32).
# ---------------------------------------------------------------------------
def pack_nodes(bvh: BVHArrays) -> torch.Tensor:
    """[N, 8] float32 node table for row-gather traversal."""
    fc = bvh.first | (bvh.count << COUNT_SHIFT)
    return torch.stack([*bvh.node_min, *bvh.node_max,
                        fc.view(torch.float32), bvh.miss.view(torch.float32)],
                       dim=1)


def pack_pairs(bvh: BVHArrays, nodes) -> tuple:
    """(pairs [I, 16] float32, stack_depth) for the any-hit kernel
    (``csrc/bvh_walk.cu`` ``bvh_occluded``), from the [N, 8] table `nodes`.
    Row j belongs to the j-th inner node in node order (the root's is row
    0) and holds its two children c = first, first + 1 side by side, each
    as its threaded row with slot 7, the miss link, replaced by the row of
    c's own children where c is inner, else -1. ``stack_depth`` is the most
    rows a walk that keeps the second child for later can hold pending: the
    most inner nodes on a path from the root, less one (0 when no inner
    node has an inner child)."""
    inner = bvh.count == 0
    row_of = torch.cumsum(inner.to(torch.int32), 0, dtype=torch.int32) - 1
    c0 = bvh.first[inner].long()
    halves = []
    for c in (c0, c0 + 1):
        below = torch.where(inner[c], row_of[c], -1).to(torch.int32)
        halves += [nodes[c, :7], below.view(torch.float32)[:, None]]
    pairs = torch.cat(halves, dim=1).contiguous()
    levels, level = 0, c0[:1] if bool(inner[0]) else c0[:0]
    while level.numel():  # children of the inner nodes of one level
        levels += 1
        level = torch.cat([level, level + 1])
        level = bvh.first[level[inner[level]]].long()
    return pairs, max(levels - 1, 0)


def _unpack_row(rows):
    """rows: [R, 8] gathered node rows -> the six bounds, first, count,
    miss."""
    fc = rows[:, 6].contiguous().view(torch.int32)
    first = fc & FIRST_MASK
    count = (fc >> COUNT_SHIFT) & 31
    miss = rows[:, 7].contiguous().view(torch.int32)
    return (*(rows[:, k] for k in range(6)), first, count, miss)


def _packed_fetch(nodes):
    return lambda node: _unpack_row(nodes[node])


def _row_leaf(leaf_rows, leaf_row_test):
    return lambda prim, p, d: leaf_row_test(leaf_rows[prim], p, d)


def traverse_closest_packed(bvh: BVHArrays, p: Vec3, d: Vec3, leaf_rows,
                            leaf_row_test: Callable, tfar0=None,
                            with_stats: bool = False, counts=None):
    """Closest hit with packed node and leaf rows. leaf_rows: [P, K] prim
    table; leaf_row_test(rows [R, K], p, d) -> (t [R], valid [R]). With
    with_stats, also the lock-step loop's trip count (the worst ray's node
    visits); a `counts` dict gains the node visits and prim tests."""
    tfar, cursor = _start(p, tfar0)
    tfar, prim_id, steps = _walk(
        _packed_fetch(pack_nodes(bvh)), _row_leaf(leaf_rows, leaf_row_test),
        bvh.max_leaf, p, d, tfar, cursor, shadow=False, counts=counts)
    if with_stats:
        return tfar, prim_id, steps
    return tfar, prim_id


def traverse_shadow_packed(bvh: BVHArrays, p: Vec3, d: Vec3, tfar, leaf_rows,
                           leaf_row_test: Callable, counts=None):
    """Any hit with packed node and leaf rows: occluded [R]; a `counts`
    dict gains the node visits and prim tests."""
    cursor = torch.where(tfar > 0.0, 0, -1).to(torch.int32)
    occ, _, _ = _walk(
        _packed_fetch(pack_nodes(bvh)), _row_leaf(leaf_rows, leaf_row_test),
        bvh.max_leaf, p, d, tfar, cursor, shadow=True, counts=counts)
    return occ


def pack_spheres(center: Vec3, radius_sq) -> torch.Tensor:
    """[P, 4] rows: cx, cy, cz, r^2."""
    return torch.stack([*center, radius_sq], dim=1)


def sphere_row_test(rows, p: Vec3, d: Vec3):
    return _sphere_t(rows[:, 0], rows[:, 1], rows[:, 2], rows[:, 3], p, d)


def pack_triangles(v0: Vec3, e1: Vec3, e2: Vec3) -> torch.Tensor:
    """[T, 9] rows: v0, e1, e2."""
    return torch.stack([*v0, *e1, *e2], dim=1)


def triangle_row_test(rows, p: Vec3, d: Vec3):
    cols = [rows[:, k] for k in range(9)]
    return _moller_trumbore(Vec3(*cols[0:3]), Vec3(*cols[3:6]),
                            Vec3(*cols[6:9]), p, d)
