"""Clustered traversal, the large-scene intersection path (accel='pallas'):
the port of the JAX package's ``ops/pallas/traverse_kernel.py``, with that
module's names so a reader finds each counterpart.

Rays are cut into tiles of ``tile_r`` consecutive rays. Per call, a planner
gives every tile the list of cluster boxes any of its valid rays enters
before its tfar, sorted front to back; a walk then tests the tile's rays
against the prims of the listed clusters only, and stops as soon as the next
entry distance lies beyond what any lane can still improve (closest hit) or
every lane is occluded (any hit).

Each of the three steps has two forms in this module:

* a plain PyTorch version (``plan_visits_plain``, ``walk_closest_plain``,
  ``walk_occluded_plain``): a chunked [T, tile_r, C] slab battery with a
  stable sort, and a loop over visit position j that gathers each tile's
  j-th cluster rows. It runs for tensors on the CPU, and ``chip_smoke.py``
  holds the kernels to it on the card;
* a hand-written CUDA kernel (``csrc/cluster_traverse.cu``: ``cluster_plan``,
  ``cluster_plan_rows``, ``cluster_closest``, ``cluster_occluded``),
  launched for CUDA tensors by ``_plan_visits`` / ``plan_rows``,
  ``walk_closest`` and ``walk_occluded``, or they raise; nothing falls
  back. Each counts its launches (``PLAN``, ``PLAN_SUPER``, ``PLAN_GROUP``,
  ``PLAN_ROWS``, ``CLOSEST``, ``OCCLUDED``). While a profiler session
  records, the walks also count their work, in the kernel on the card and
  in the plain version on the CPU, on the ``port.walk`` span
  (``_count_walk``: ``walk_pairs``, ``walk_visits``, ``walk_rays``); that
  span says which walk ran (``walk_form``, ``walk_kind``, ``walk_prims``).

The planner has the JAX module's modes (``plan``), each the same function
there and here:

* 'ray': per cluster box, the least slab entry distance over the tile's
  valid rays (``_tile_entry_row``);
* 'group': the lesser of those entries against a cluster's two SAH leaf
  boxes (``ClusteredPrims.glo`` / ``ghi``; a pack without them plans as
  'ray');
* 'super': the entries against the union boxes of SUPER consecutive
  clusters first, then the 'ray' entries of the members of the
  superclusters some ray entered, FLT_MAX for the others: equal to 'ray' bit
  for bit;
* 'tilebox': one interval slab test per tile and cluster, from the tile's
  masked min / max of origin, direction and tfar (``_tilebox_entry_row``):
  a lower bound of every ray's entry, so a superset of the 'ray' list;
* 'hybrid': the tilebox entries where the tile's valid directions are
  sign-coherent on all three axes, the 'ray' entries elsewhere.

With ``sort`` and ``sort_impl='kernel'``, 'ray', 'super' and 'group' are
planned and sorted by ``cluster_plan``. Every other combination launches
``cluster_plan_rows``, which writes the unsorted [T, C] entry matrix (its
sweep takes ``plan_rows_chunk`` clusters at a time, so it has no cluster
limit), and sorts in PyTorch as the JAX package sorts in XLA
(``_sort_tail``, ``_unsorted_tail``).

Every walk is a split walk: S threads share a ray (``_walk_split``: S = 1,
2 or 4 by the tile count and the card's size), a tile's live rays are
packed into its first warps, and the next visit's rows are copied into
shared memory while the battery runs on the current visit's.

The walks have two more forms each, chosen by the wrappers' keywords as in
the JAX module:

* ``stream=True``: the streamed walks (``cluster_closest_stream``,
  ``cluster_occluded_stream``). They read the row-packed table of
  ``_tables_packed`` (cluster c's attribute rows contiguous) and copy each
  visited cluster into one of two shared-memory slots asynchronously, the
  next visit's copy in flight while the battery runs on the current one.
  Results equal the resident walks bit for bit. The plain version is the
  plain walk on tables unpacked from the packed layout.
* ``mxu=True``: the triangle battery in product form
  (``_triangle_battery_mxu``; ``cluster_closest[mxu]``,
  ``cluster_occluded[mxu]``): the six ray . constant contractions of a
  visited cluster as two [tile_r, 3] x [3, 3K] products, then
  ``u = f1.p + t * (f1.d) + g1`` without forming the hit point. It rounds
  differently from the ordinary battery by design (same ids, t to float
  rounding). It applies to triangle packs of 128 or more prims a cluster
  and not under ``stream``.

``stream_replay`` (the DMA replay of ``benchmarks/diag_stream2.py``)
replays one tile's visit list through the streamed walks' staging and
writes the staged rows back out in the packed layout: the check that the
streamed walks stage the rows they should. Its plain version,
``stream_replay_plain``, is an index gather of those rows. A grid of
blocks shares the list, each block a contiguous slice of at least two
visits where the list has them (``replay_blocks``, ``replay_slices``).

What is TPU schedule in the JAX module and has no counterpart here: the
lane packing of clusters below 128 prims, ``fuse`` / ``unroll`` /
``trav_block`` / ``exit_refresh`` / ``prefetch`` / ``plan_block``, the 8-row
SMEM blocks, the [8, Cp] slab layout and the padding of the tile count to a
multiple of 8.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from ...core import fp
from ...core.fp import fma
from ...core.vec import Vec3
from ...utils import profiling
from ..clustered import SUPER, ClusteredPrims
from . import build
from .build import LaunchCounter
from .sphere_battery import (FLT_MAX, _closest_epilogue, sphere_candidates,
                             sphere_occluded_pairs)

DEFAULT_TILE_R = 256
DEFAULT_SEG_LEN = 2048
_N_ATTRS = {"sphere": 4, "triangle": 12}
PLAN_CHUNK_ELEMS = 1 << 23  # [t, tile_r, C] elements per planner chunk
MAX_SHARED_BYTES = 227 * 1024  # dynamic shared memory one block can have
MAX_BLOCK = 1024  # threads a block can have

PLAN = LaunchCounter("cluster_plan")
PLAN_SUPER = LaunchCounter("cluster_plan[super]")
PLAN_GROUP = LaunchCounter("cluster_plan[group]")
PLANS = ("ray", "super", "group", "tilebox", "hybrid")
PLAN_ROWS = {plan: LaunchCounter(f"cluster_plan_rows[{plan}]")
             for plan in PLANS}
CLOSEST = LaunchCounter("cluster_closest")
OCCLUDED = LaunchCounter("cluster_occluded")
CLOSEST_STREAM = LaunchCounter("cluster_closest_stream")
OCCLUDED_STREAM = LaunchCounter("cluster_occluded_stream")
CLOSEST_MXU = LaunchCounter("cluster_closest[mxu]")
OCCLUDED_MXU = LaunchCounter("cluster_occluded[mxu]")
REPLAY = LaunchCounter("stream_replay")


# ---------------------------------------------------------------------------
# Tables
# ---------------------------------------------------------------------------
def _tables(cp: ClusteredPrims):
    """[C*K, F] packed rows -> per-attribute [C, K] planes (views).
    Triangles use the stored Baldwin-Weber planes (n, d0, f1, g1, f2, g2)."""
    c, k = cp.num_clusters, cp.cluster_size
    src = cp.rows if cp.kind != "triangle" else cp.planes
    if src is None:
        raise ValueError("triangle clusters without stored planes")
    rows = src.reshape(c, k, -1)
    return tuple(rows[:, :, f] for f in range(rows.shape[2]))


def _stream_rows(kind: str) -> int:
    """Rows per cluster in the packed table of the streamed walks: the
    attribute count rounded up to a multiple of 8 (8 for spheres, 16 for
    triangles), the JAX package's layout."""
    return -(-_N_ATTRS[kind] // 8) * 8


def _tables_packed(cp: ClusteredPrims) -> torch.Tensor:
    """[C * F8, K] row-packed attribute planes for the streamed walks:
    cluster c's attribute rows are contiguous, zero-padded from the
    attribute count to F8 = ``_stream_rows``, so one contiguous copy fetches
    a cluster. Made once per pack and kept in its ``packed`` field."""
    if cp.packed is None:
        stacked = torch.stack(_tables(cp), dim=1)  # [C, F, K]
        pad = _stream_rows(cp.kind) - stacked.shape[1]
        cp.packed = torch.nn.functional.pad(stacked, (0, 0, 0, pad)).reshape(
            -1, cp.cluster_size).contiguous()
    return cp.packed


def device_bytes(cp: ClusteredPrims) -> int:
    """Bytes of every tensor the pack holds now, the packed table of the
    streamed walks included once it is made."""
    tensors = (cp.rows, cp.order, *cp.lo, *cp.hi, cp.planes, cp.root,
               cp.packed, cp.filled)
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def _tables_unpacked(cp: ClusteredPrims, packed: torch.Tensor):
    """The per-attribute [C, K] planes read back out of a packed table."""
    planes = packed.reshape(cp.num_clusters, _stream_rows(cp.kind),
                            cp.cluster_size)
    return tuple(planes[:, f] for f in range(_N_ATTRS[cp.kind]))


def _slab_rows(cp: ClusteredPrims):
    """The cluster AABBs as six [C] rows: lo.xyz, hi.xyz."""
    return (*cp.lo, *cp.hi)


def _group_slab_rows(cp: ClusteredPrims):
    """The group boxes as two six-row slab sets of [C] rows: set 0 bounds
    each cluster's first SAH leaf, set 1 its second (a copy of the first
    for a single-leaf cluster), so the lesser of the two entries is exact."""
    return tuple(tuple(a[g] for a in (*cp.glo, *cp.ghi)) for g in range(2))


def _super_slab_rows(cp: ClusteredPrims):
    """The supercluster boxes as six [S] rows, S = ceil(C / SUPER): box s is
    the union of clusters [s * SUPER, (s + 1) * SUPER). Consecutive clusters
    of the SAH cut are tree-adjacent, so the unions stay tight."""
    return tuple(cp.supers[i] for i in range(6))


def _root_row(cp: ClusteredPrims) -> torch.Tensor:
    """[8] float32 [lo.xyz, hi.xyz, 0, 0] of the root AABB, the union of
    the cluster bounds; reduced once, when the pack is made."""
    return cp.root


def table_bytes(cp: ClusteredPrims) -> int:
    """Bytes of a pack's attribute tables as the JAX package counts them
    ([C, max(K, 128)] float32 per attribute plane): what ``pallas_stream=
    'auto'`` compares with its threshold."""
    return (cp.num_clusters * max(cp.cluster_size, 128)
            * _N_ATTRS[cp.kind] * 4)


def _ray_cols(arrs, rp: int):
    """Pad each (array, value) to rp lanes. The padding lanes of a tile are
    p = 1e30, d = 1, tfar = 0, valid = 0."""
    out = []
    for a, padval in arrs:
        pad = torch.full((rp - a.shape[0],), padval, dtype=a.dtype,
                         device=a.device)
        out.append(torch.cat([a, pad]))
    return out


def _tiled(p: Vec3, d: Vec3, tf, valid, tile_r: int):
    """The rays as [T, tile_r] tensors, the last tile padded."""
    n = tf.shape[0]
    t_tiles = -(-n // tile_r)
    cols = _ray_cols(
        [(p.x, 1e30), (p.y, 1e30), (p.z, 1e30), (d.x, 1.0), (d.y, 1.0),
         (d.z, 1.0), (tf, 0.0), (valid, False)], t_tiles * tile_r)
    return [a.reshape(t_tiles, tile_r) for a in cols]


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------
def _slab(lo, hi, px, py, pz, dx, dy, dz):
    """(tmin, tmax) of rays against boxes (test_AABB, BVH.hpp:220-234); the
    arguments broadcast. torch.minimum / maximum propagate NaN, as
    jnp.minimum / maximum do."""
    ix, iy, iz = 1.0 / dx, 1.0 / dy, 1.0 / dz
    ax, bx = (lo[0] - px) * ix, (hi[0] - px) * ix
    tmin = torch.minimum(ax, bx)
    tmax = torch.maximum(ax, bx)
    ay, by = (lo[1] - py) * iy, (hi[1] - py) * iy
    tmin = torch.maximum(tmin, torch.minimum(ay, by))
    tmax = torch.minimum(tmax, torch.maximum(ay, by))
    az, bz = (lo[2] - pz) * iz, (hi[2] - pz) * iz
    tmin = torch.maximum(tmin, torch.minimum(az, bz))
    tmax = torch.minimum(tmax, torch.maximum(az, bz))
    return tmin, tmax


def _root_exit_bound(root, px, py, pz, dx, dy, dz):
    """Per-ray exit distance of the root AABB, 0 where the ray misses it:
    a ray cannot hit anything beyond it, so rays that leave the geometry stop
    holding their tile's exit bound at FLT_MAX."""
    tmin, tmax = _slab(root[0:3], root[3:6], px, py, pz, dx, dy, dz)
    zero = torch.zeros((), dtype=torch.float32, device=px.device)
    hit = tmax >= torch.maximum(tmin, zero)
    return torch.where(hit, tmax * (1.0 + 1e-5), 0.0)


def _tile_entry_rows(slabs, px, py, pz, dx, dy, dz, tfs, ok):
    """[T, B] per tile and box of the six [B] `slabs` rows, the least slab
    entry distance over the tile's valid rays, FLT_MAX where none enters the
    box before its tf (``_tile_entry_row``); rays are [T, tile_r]. Chunked
    over tiles, a [t, tile_r, B] slab battery at a time."""
    t_tiles, tile_r = px.shape
    b = slabs[0].shape[0]
    lo = [a[None, None, :] for a in slabs[:3]]
    hi = [a[None, None, :] for a in slabs[3:]]
    zero = torch.zeros((), dtype=torch.float32, device=px.device)
    step = max(1, PLAN_CHUNK_ELEMS // max(1, tile_r * b))
    rows = [torch.empty((0, b), dtype=torch.float32, device=px.device)]
    for s in range(0, t_tiles, step):
        sl = slice(s, s + step)
        tmin, tmax = _slab(lo, hi, *(a[sl, :, None]
                                     for a in (px, py, pz, dx, dy, dz)))
        entry = torch.maximum(tmin, zero)
        hit = (tmax >= entry) & (entry < tfs[sl, :, None]) & ok[sl, :, None]
        rows.append(torch.where(hit, entry, FLT_MAX).amin(dim=1))
    return torch.cat(rows)


def _super_entry_rows(cp: ClusteredPrims, rays):
    """'super': phase A tests the tiles against the S supercluster boxes;
    phase B computes the member clusters' entries (the flat rows'
    arithmetic) of each entered supercluster, for the tiles that entered
    it. Every other entry stays FLT_MAX."""
    srow = _tile_entry_rows(_super_slab_rows(cp), *rays)  # [T, S]
    c = cp.num_clusters
    out = torch.full((srow.shape[0], c), FLT_MAX, dtype=torch.float32,
                     device=srow.device)
    slabs = _slab_rows(cp)
    for s in range(srow.shape[1]):
        tiles = torch.nonzero(srow[:, s] < FLT_MAX)[:, 0]
        if tiles.numel() == 0:
            continue
        members = slice(s * SUPER, min((s + 1) * SUPER, c))
        out[tiles, members] = _tile_entry_rows(
            tuple(a[members] for a in slabs), *(a[tiles] for a in rays))
    return out


def _tilebox_entry_rows(slabs, px, py, pz, dx, dy, dz, tfs, ok):
    """[T, C] interval slab test per tile (``_tilebox_entry_row``): each
    tile's valid rays are summed up by the masked min / max of origin and
    direction per axis and the max of tf, and every cluster is tested
    against that bundle once. An axis whose direction interval holds 0
    bounds nothing. The entry is a lower bound of every valid ray's entry,
    so the list is a superset of the exact one. torch.minimum / maximum and
    amin / amax propagate NaN, as jnp's do."""
    big = FLT_MAX

    def mn(a):
        return torch.where(ok, a, big).amin(dim=1, keepdim=True)

    def mx(a):
        return torch.where(ok, a, -big).amax(dim=1, keepdim=True)

    any_ok = ok.any(dim=1, keepdim=True)
    tfm = mx(tfs)

    def axis(lo, hi, pl, ph, dl, dh):
        mixed = (dl <= 0.0) & (dh >= 0.0)
        inv_a = 1.0 / torch.where(mixed, 1.0, dh)
        inv_b = 1.0 / torch.where(mixed, 1.0, dl)
        il = torch.minimum(inv_a, inv_b)
        ih = torch.maximum(inv_a, inv_b)
        a1, a2 = (lo - ph) * il, (lo - ph) * ih
        a3, a4 = (lo - pl) * il, (lo - pl) * ih
        b1, b2 = (hi - ph) * il, (hi - ph) * ih
        b3, b4 = (hi - pl) * il, (hi - pl) * ih
        t_lo_lb = torch.minimum(torch.minimum(a1, a2), torch.minimum(a3, a4))
        t_lo_ub = torch.maximum(torch.maximum(a1, a2), torch.maximum(a3, a4))
        t_hi_lb = torch.minimum(torch.minimum(b1, b2), torch.minimum(b3, b4))
        t_hi_ub = torch.maximum(torch.maximum(b1, b2), torch.maximum(b3, b4))
        tmin_lb = torch.minimum(t_lo_lb, t_hi_lb)
        tmax_ub = torch.maximum(t_lo_ub, t_hi_ub)
        return (torch.where(mixed, -big, tmin_lb),
                torch.where(mixed, big, tmax_ub))

    lo = [a[None, :] for a in slabs[:3]]
    hi = [a[None, :] for a in slabs[3:]]
    xlb, xub = axis(lo[0], hi[0], mn(px), mx(px), mn(dx), mx(dx))
    ylb, yub = axis(lo[1], hi[1], mn(py), mx(py), mn(dy), mx(dy))
    zlb, zub = axis(lo[2], hi[2], mn(pz), mx(pz), mn(dz), mx(dz))
    zero = torch.zeros((), dtype=torch.float32, device=px.device)
    entry = torch.maximum(torch.maximum(torch.maximum(xlb, ylb), zlb), zero)
    exit_ub = torch.minimum(torch.minimum(xub, yub), zub)
    hit = (exit_ub >= entry) & (entry < tfm) & any_ok
    return torch.where(hit, entry, big)


def _sign_coherent(d, ok):
    """[T, 1]: the tile's valid values of `d` all > 0 or all < 0 (true for
    a tile without a valid ray)."""
    lo = torch.where(ok, d, FLT_MAX).amin(dim=1, keepdim=True)
    hi = torch.where(ok, d, -FLT_MAX).amax(dim=1, keepdim=True)
    return (lo > 0.0) | (hi < 0.0)


def plan_rows_plain(cp: ClusteredPrims, p: Vec3, d: Vec3, tf, valid,
                    tile_r: int, plan: str = "ray"):
    """The unsorted [T, C] entry matrix of a resolved planner mode
    (``_plan_mode``) in plain PyTorch: the plain version of
    ``cluster_plan_rows``, and of ``cluster_plan`` before its sort."""
    rays = _tiled(p, d, tf, valid, tile_r)
    slabs = _slab_rows(cp)
    if plan == "ray":
        return _tile_entry_rows(slabs, *rays)
    if plan == "group":
        first, second = _group_slab_rows(cp)
        return torch.minimum(_tile_entry_rows(first, *rays),
                             _tile_entry_rows(second, *rays))
    if plan == "super":
        return _super_entry_rows(cp, rays)
    boxed = _tilebox_entry_rows(slabs, *rays)
    if plan == "tilebox":
        return boxed
    ok, dx, dy, dz = rays[7], rays[3], rays[4], rays[5]
    coherent = (_sign_coherent(dx, ok) & _sign_coherent(dy, ok)
                & _sign_coherent(dz, ok))
    return torch.where(coherent, boxed, _tile_entry_rows(slabs, *rays))


def _sort_tail(entry):
    """The sorted tail (the JAX package's XLA argsort + take_along_axis):
    each row sorted by a stable sort, the lowest cluster id first among
    equal entries. Returns (visit [T, C] int32, sorted entry, nvis [T]
    int32); past nvis the entries are FLT_MAX."""
    entry_sorted, order = torch.sort(entry, dim=1, stable=True)
    nvis = (entry < FLT_MAX).sum(dim=1).to(torch.int32)
    return order.to(torch.int32), entry_sorted, nvis


def _unsorted_tail(entry):
    """The unsorted tail (``sort=False``): the entered clusters to the front
    by a stable sort on the hit flag only, so they keep cluster-id order;
    their entries in that order, then the suffix minimum of those. The
    walks leave a tile at the first entry[j] >= mx, which is exact only
    where no later entry is smaller: the suffix minimum makes it so for
    any visit order (and is the identity on sorted entries)."""
    order = torch.sort((entry >= FLT_MAX).to(torch.int32), dim=1,
                       stable=True).indices
    gathered = entry.gather(1, order).flip(1)
    suffix_min = torch.cummin(gathered, dim=1).values.flip(1).contiguous()
    nvis = (entry < FLT_MAX).sum(dim=1).to(torch.int32)
    return order.to(torch.int32), suffix_min, nvis


def _plan_mode(cp: ClusteredPrims, plan: str) -> str:
    """The planner mode that runs: 'group' on a pack without group boxes
    plans as 'ray', as in the JAX package."""
    if plan not in PLANS:
        raise ValueError(f"plan={plan!r}: one of {PLANS}")
    return "ray" if plan == "group" and cp.glo is None else plan


def sorts_in_kernel(cp: ClusteredPrims, plan: str, sort: bool,
                    sort_impl: str) -> bool:
    """Whether the policy asks ``_plan_visits`` to sort in ``cluster_plan``:
    'ray', 'super' and 'group' with ``sort`` and ``sort_impl='kernel'``
    (it does up to ``max_plan_clusters``)."""
    return (sort and sort_impl == "kernel"
            and _plan_mode(cp, plan) in ("ray", "super", "group"))


def plans_in_kernel(cp: ClusteredPrims, plan: str, sort: bool,
                    sort_impl: str, tile_r: int) -> bool:
    """Whether ``_plan_visits`` on the card launches ``cluster_plan``: where
    the policy sorts in the kernel and the pack holds at most
    ``max_plan_clusters(tile_r)`` clusters. Otherwise it launches
    ``cluster_plan_rows`` and sorts in PyTorch. The choice is by size, not
    a fallback: both give the same lists."""
    return (sorts_in_kernel(cp, plan, sort, sort_impl)
            and cp.num_clusters <= max_plan_clusters(tile_r))


def plan_visits_plain(cp: ClusteredPrims, p: Vec3, d: Vec3, tf, valid,
                      tile_r: int, plan: str = "ray", sort: bool = True):
    """The planner in plain PyTorch: ``plan_rows_plain`` then the sorted or
    the unsorted tail. Returns (visit [T, C] int32, entry [T, C] float32,
    FLT_MAX past the end; nvis [T] int32). Where the sort runs
    (``sort_impl``) does not change what it gives."""
    rows = plan_rows_plain(cp, p, d, tf, valid, tile_r, _plan_mode(cp, plan))
    return _sort_tail(rows) if sort else _unsorted_tail(rows)


def _sphere_battery(px, py, pz, dx, dy, dz, rows):
    return sphere_candidates(px, py, pz, dx, dy, dz, *rows)


def _triangle_battery(px, py, pz, dx, dy, dz, rows):
    """Baldwin-Weber precomputed-plane test, with the multiply-adds fused as
    XLA fuses them in the JAX package's kernel."""
    (nx, ny, nz, d0, f1x, f1y, f1z, g1, f2x, f2y, f2z, g2) = rows
    den = fp.dot3(nx, ny, nz, dx, dy, dz)
    num = d0 - fp.dot3(nx, ny, nz, px, py, pz)
    t = num / den
    qx = fma(t, dx, px)
    qy = fma(t, dy, py)
    qz = fma(t, dz, pz)
    u = fp.dot3(f1x, f1y, f1z, qx, qy, qz) + g1
    v = fp.dot3(f2x, f2y, f2z, qx, qy, qz) + g2
    valid = ((torch.abs(den) > 1e-12) & (u >= 0.0) & (v >= 0.0)
             & (u + v <= 1.0) & (t > 1e-6))
    return torch.where(valid, t, FLT_MAX)


def _mat3(ax, ay, az, bx, by, bz):
    """One element of a [., 3] x [3, .] product, summed over k = 0, 1, 2 with
    a fused multiply-add per step: the order the kernel fixes."""
    return fma(az, bz, fma(ay, by, ax * bx))


def _triangle_battery_mxu(px, py, pz, dx, dy, dz, rows):
    """The Baldwin-Weber test in product form: the contractions of the ray's
    direction and origin with the cluster's n, f1 and f2 are the two matrix
    products dmat @ m and pmat @ m, m = [n | f1 | f2] of shape [3, 3K]; then
    t = (d0 - n.p) / (n.d) and u = f1.p + t * (f1.d) + g1 (v likewise): the
    hit point q = p + t * d is never formed. Algebraically the ordinary
    battery, rounded differently."""
    (nx, ny, nz, d0, f1x, f1y, f1z, g1, f2x, f2y, f2z, g2) = rows
    den = _mat3(dx, dy, dz, nx, ny, nz)
    f1d = _mat3(dx, dy, dz, f1x, f1y, f1z)
    f2d = _mat3(dx, dy, dz, f2x, f2y, f2z)
    pn = _mat3(px, py, pz, nx, ny, nz)
    f1p = _mat3(px, py, pz, f1x, f1y, f1z)
    f2p = _mat3(px, py, pz, f2x, f2y, f2z)
    t = (d0 - pn) / den
    u = fma(t, f1d, f1p) + g1
    v = fma(t, f2d, f2p) + g2
    valid = ((torch.abs(den) > 1e-12) & (u >= 0.0) & (v >= 0.0)
             & (u + v <= 1.0) & (t > 1e-6))
    return torch.where(valid, t, FLT_MAX)


def _sphere_anyhit_battery(px, py, pz, dx, dy, dz, tf, rows):
    return sphere_occluded_pairs(px, py, pz, dx, dy, dz, tf, *rows)


def _uses_mxu(cp: ClusteredPrims, mxu: bool) -> bool:
    """The product-form battery is a triangle battery."""
    return bool(mxu) and cp.kind == "triangle"


def _closest_battery(cp: ClusteredPrims, mxu: bool):
    if _uses_mxu(cp, mxu):
        return _triangle_battery_mxu
    return _sphere_battery if cp.kind == "sphere" else _triangle_battery


def _anyhit_battery(cp: ClusteredPrims, mxu: bool):
    if cp.kind == "sphere":
        return _sphere_anyhit_battery
    closest = _closest_battery(cp, mxu)
    return lambda px, py, pz, dx, dy, dz, tf, rows: closest(
        px, py, pz, dx, dy, dz, rows) < tf


NEG = -FLT_MAX


def _walk_plain(cp, attrs, visit, entry, nvis, rays, bound, live_of,
                visit_fn, stats):
    """The loop both plain walks share, over the [C, K] attribute planes
    `attrs`: at visit position j every tile still
    running (j < nvis and entry[j] below its exit bound mx) gathers its j-th
    cluster's rows and runs ``visit_fn(idx, cluster, rows, rays_of_idx,
    real)``; then mx is refreshed from the lanes ``live_of(idx)`` says still
    count. A tile that stops once stays stopped, as the kernel's loop does.

    With `stats`, ``real`` is the [Ta, K] mask of the visited clusters'
    slots that hold a prim (padding slots have order -1) and ``visit_fn``
    returns the (ray, prim) tests this visit needs; else both are None."""
    filled = None
    if stats is not None:
        filled = cp.order.reshape(cp.num_clusters, cp.cluster_size) >= 0
        stats.setdefault("visits", 0)
        stats.setdefault("pairs", 0)
    mx = torch.where(live_of(slice(None)), bound, NEG).amax(dim=1)
    running = torch.ones_like(nvis, dtype=torch.bool)
    n_max = int(nvis.max()) if nvis.numel() else 0
    for j in range(n_max):
        running = running & (j < nvis) & (entry[:, j] < mx)
        idx = torch.nonzero(running)[:, 0]
        if idx.numel() == 0:
            break
        c = visit[idx, j].to(torch.int64)
        rows = tuple(a[c][:, None, :] for a in attrs)  # [Ta, 1, K]
        pairs = visit_fn(idx, c, rows, [a[idx][:, :, None] for a in rays],
                         None if filled is None else filled[c])
        if stats is not None:
            stats["visits"] += idx.numel()
            stats["pairs"] += int(pairs)
        mx[idx] = torch.where(live_of(idx), bound[idx], NEG).amax(dim=1)
    return mx


def walk_closest_plain(cp: ClusteredPrims, visit, entry, nvis, p: Vec3,
                       d: Vec3, tf0, valid, tile_r: int,
                       stats: Optional[dict] = None, mxu: bool = False,
                       packed: Optional[torch.Tensor] = None):
    """The closest-hit walk in plain PyTorch: (tfar [R], packed prim
    [R] int32 = cluster * K + slot, -1 = none). With `packed` (the table of
    ``_tables_packed``) it is the plain version of the streamed walk: the
    same walk over planes unpacked from that layout. `mxu` takes the
    product-form triangle battery. `stats`, if given, receives
    the (tile, cluster) visits of this walk, which refreshes its exit bound
    after every visit, and its pairs: every valid ray of a visiting tile
    against every prim of the visited cluster (padding slots not counted)."""
    n = tf0.shape[0]
    px, py, pz, dx, dy, dz, tfs, ok = _tiled(p, d, tf0, valid, tile_r)
    rays = (px, py, pz, dx, dy, dz)
    k = cp.cluster_size
    battery = _closest_battery(cp, mxu)
    attrs = _tables(cp) if packed is None else _tables_unpacked(cp, packed)
    rexit = _root_exit_bound(_root_row(cp), *rays)
    start = torch.minimum(tfs, rexit)
    best = tfs.clone()
    prim = torch.full_like(best, -1, dtype=torch.int32)
    # the bound a lane holds its tile to: min(current tfar, root exit)
    bound = start.clone()

    def visit_fn(idx, c, rows, r, real):
        t = battery(*r, rows)  # [Ta, tile_r, K]
        tb, first = _closest_epilogue(t.reshape(-1, k))
        tb, first = tb.reshape(-1, tile_r), first.reshape(-1, tile_r)
        closer = (tb < best[idx]) & ok[idx]
        best[idx] = torch.where(closer, tb, best[idx])
        prim[idx] = torch.where(
            closer, (c[:, None] * k + first).to(torch.int32), prim[idx])
        bound[idx] = torch.minimum(best[idx], start[idx])
        if real is not None:
            return (ok[idx].sum(dim=1) * real.sum(dim=1)).sum()

    _walk_plain(cp, attrs, visit, entry, nvis, rays, bound, lambda i: ok[i],
                visit_fn, stats)
    return best.reshape(-1)[:n], prim.reshape(-1)[:n]


def walk_occluded_plain(cp: ClusteredPrims, visit, entry, nvis, p: Vec3,
                        d: Vec3, tfar, tile_r: int,
                        stats: Optional[dict] = None, mxu: bool = False,
                        packed: Optional[torch.Tensor] = None):
    """The any-hit walk in plain PyTorch: [R] bool. Lanes with tfar <= 0 are
    invalid and never occluded. `packed` and `mxu` as in
    ``walk_closest_plain``. `stats`, if given, receives the visits and
    the pairs: for every valid lane not yet occluded, the prims of the
    visited cluster up to and including its first occluder there (all of
    them where none occludes; padding slots not counted)."""
    n = tfar.shape[0]
    px, py, pz, dx, dy, dz, tfs, ok = _tiled(p, d, tfar, tfar > 0.0, tile_r)
    rays = (px, py, pz, dx, dy, dz)
    battery = _anyhit_battery(cp, mxu)
    attrs = _tables(cp) if packed is None else _tables_unpacked(cp, packed)
    bound = torch.minimum(tfs, _root_exit_bound(_root_row(cp), *rays))
    occ = torch.zeros_like(ok)

    def visit_fn(idx, c, rows, r, real):
        pairs = battery(*r, tfs[idx][:, :, None], rows)  # [Ta, tile_r, K]
        hit = pairs.any(dim=2)
        live = ok[idx] & ~occ[idx]
        occ[idx] = occ[idx] | (hit & ok[idx])
        if real is not None:
            upto = torch.cumsum(real, dim=1)  # prims in slots 0..s, [Ta, K]
            first = pairs.to(torch.uint8).argmax(dim=2)  # [Ta, tile_r]
            need = torch.where(hit, upto.gather(1, first), upto[:, -1:])
            return (need * live).sum()

    _walk_plain(cp, attrs, visit, entry, nvis, rays, bound,
                lambda i: ok[i] & ~occ[i], visit_fn, stats)
    return occ.reshape(-1)[:n]


# ---------------------------------------------------------------------------
# Kernel build, binding and launch
# ---------------------------------------------------------------------------
def _bind(lib: ctypes.CDLL):
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.cluster_plan.argtypes = ([i32] + [ptr] * 12 + [i32] + [ptr] * 8
                                 + [i32] * 3 + [ptr] * 4)
    # cluster_plan_rows takes the chunk of its sweep after the cluster count
    lib.cluster_plan_rows.argtypes = ([i32] + [ptr] * 12 + [i32] + [ptr] * 8
                                      + [i32] * 4 + [ptr] * 2)
    for fn in (lib.cluster_plan, lib.cluster_plan_rows):
        fn.restype = i32
    # the walks take the split S after the battery code, and the counters'
    # `filled` and `counts` before the stream
    lib.cluster_closest.argtypes = [ptr] * 13 + [i32] * 6 + [ptr] * 5
    lib.cluster_occluded.argtypes = [ptr] * 12 + [i32] * 6 + [ptr] * 4
    lib.cluster_closest_stream.argtypes = [ptr] * 13 + [i32] * 6 + [ptr] * 5
    lib.cluster_occluded_stream.argtypes = [ptr] * 12 + [i32] * 6 + [ptr] * 4
    for fn in (lib.cluster_closest, lib.cluster_occluded,
               lib.cluster_closest_stream, lib.cluster_occluded_stream):
        fn.restype = i32
    lib.stream_replay.argtypes = [ptr] * 3 + [i32] * 6 + [ptr] * 2
    lib.stream_replay_occupancy.argtypes = [i32] * 2 + [ptr]
    for fn in (lib.stream_replay, lib.stream_replay_occupancy):
        fn.restype = i32


LIBRARY = build.Library("cluster_traverse.cu", build.nvcc, build.NVCC_FLAGS,
                        _bind)

# the `battery` argument of the walks' C entry points
_SPHERE, _TRIANGLE, _TRIANGLE_PRODUCT = 0, 1, 2
# the `mode` argument of the planners' C entry points
_MODES = {"ray": 0, "group": 1, "super": 2, "tilebox": 3, "hybrid": 4}


def _check(name: str, device, tensors, dtype, length=None):
    for a in tensors:
        if (a.device != device or a.dtype != dtype or not a.is_contiguous()
                or (length is not None and a.shape != (length,))):
            raise ValueError(
                f"{name}: needs contiguous {dtype} tensors on {device}"
                + (f" of shape ({length},)" if length is not None else "")
                + f"; got {a.dtype} {tuple(a.shape)} {a.device} "
                f"contiguous={a.is_contiguous()}")


def walk_shared_bytes(cp: ClusteredPrims) -> int:
    """Dynamic shared memory a walk's block stages clusters in: two slots
    of one cluster's attributes (32 KB at 256 triangles a cluster, 128 KB at
    1024; the streamed copies skip the zero rows that pad a packed cluster
    to F8)."""
    return 2 * cp.cluster_size * _N_ATTRS[cp.kind] * 4


def _check_walk(name, cp: ClusteredPrims, device, n, tile_r, rays, visit,
                entry, nvis, stream):
    """Checks what a walk kernel takes and returns its table: the [C*K, F]
    rows (planes for triangles) of the resident walks, 16-byte aligned for
    their 16-byte copies, or the [C*F8, K] packed table of the streamed
    ones."""
    if device.type != "cuda":
        raise ValueError(f"{name}: tensors on {device}, need cuda or cpu")
    if tile_r % 32 or not 32 <= tile_r <= 1024:
        raise ValueError(f"{name}: tile_r={tile_r} must be a multiple of 32 "
                         "in [32, 1024] (a tile's rays fill whole warps)")
    t_tiles, c, k = -(-n // tile_r), cp.num_clusters, cp.cluster_size
    _check(name, device, rays, torch.float32, n)
    if stream:
        # the kernels copy 4 bytes at a time, so any K is aligned
        table, shape = _tables_packed(cp), (c * _stream_rows(cp.kind), k)
    else:
        table = cp.planes if cp.kind == "triangle" else cp.rows
        shape = (c * k, _N_ATTRS[cp.kind])
    _check(name, device, (table, entry), torch.float32)
    _check(name, device, (visit, nvis), torch.int32)
    if (visit.shape != (t_tiles, c) or entry.shape != (t_tiles, c)
            or nvis.shape != (t_tiles,)):
        raise ValueError(f"{name}: plan of shape {tuple(visit.shape)} for "
                         f"{t_tiles} tiles x {c} clusters")
    if table.shape != shape:
        raise ValueError(f"{name}: table of shape {tuple(table.shape)}, "
                         f"need {shape}")
    if not stream and table.data_ptr() % 16:
        raise ValueError(f"{name}: table not 16-byte aligned")
    if walk_shared_bytes(cp) > MAX_SHARED_BYTES:
        raise ValueError(f"{name}: cluster_size {k} does not fit one "
                         "block's shared memory")
    if n >= 2 ** 31 or t_tiles * c >= 2 ** 31 or table.numel() >= 2 ** 31:
        raise ValueError(f"{name}: sizes beyond int32")
    return table


def plan_shared_bytes(tile_r: int, chunk: int, n_super: int,
                      n_keys: int) -> int:
    """Dynamic shared memory of a sweep block of ``cluster_plan`` or
    ``cluster_plan_rows`` (``plan_shared_bytes`` of
    ``csrc/cluster_traverse.cu``): 32 bytes a staged ray, 4 a cluster of the
    chunk swept at once (its least entry), a union box ('super') and a slot
    of 32 clusters of the chunk, and 2 a sort key (``cluster_plan``: C
    rounded up to a power of two; none for ``cluster_plan_rows``)."""
    return (tile_r * 32 + 4 * (chunk + n_super + -(-chunk // 32))
            + 2 * n_keys)


def max_plan_clusters(tile_r: int) -> int:
    """The most clusters ``cluster_plan`` takes (a power of two): one block
    keeps a tile's entries and sorts its list in shared memory, beside 1 KB
    of static shared memory, and ids are 16-bit. 16,384 clusters at
    tile_r = 1024, 32,768 up to tile_r = 512. ``_plan_visits`` plans a
    larger pack with ``cluster_plan_rows`` and the PyTorch sort, which give
    the same lists."""
    c = 1
    while (2 * c < 1 << 16
           and plan_shared_bytes(tile_r, 2 * c, -(-2 * c // SUPER), 2 * c)
           <= MAX_SHARED_BYTES - 1024):
        c *= 2
    return c


# dynamic shared memory a cluster_plan_rows block aims at: three blocks an
# SM, as many as the registers of its wide sweep allow
PLAN_ROWS_SHARED_BYTES = 72 * 1024


def plan_rows_chunk(tile_r: int, c: int, n_super: int) -> int:
    """Clusters one pass of ``cluster_plan_rows``' sweep takes, a multiple
    of 32, so that every chunk starts on a slot of 32 clusters (under
    'super' a slot lies in one union box): all C where they fit
    PLAN_ROWS_SHARED_BYTES beside the staged rays and the `n_super` union
    entries, else C cut into the fewest chunks of one size that fit (the
    most a block can have beside 1 KB of static shared memory where the
    rays and unions alone leave no room in that aim). The kernel sweeps
    [c0, c0 + chunk) for c0 = 0, chunk, 2 chunk, ... below C."""
    fixed = plan_shared_bytes(tile_r, 0, n_super, 0)
    slot = plan_shared_bytes(0, 32, 0, 0)  # a slot's entries and list entry
    room = (PLAN_ROWS_SHARED_BYTES if fixed + slot <= PLAN_ROWS_SHARED_BYTES
            else MAX_SHARED_BYTES - 1024)
    most = (room - fixed) // slot
    if most < 1:
        raise ValueError(f"cluster_plan_rows: {tile_r} rays and {n_super} "
                         "union boxes leave no shared memory for a slot")
    slots = -(-c // 32)
    return 32 * -(-slots // -(-slots // most))


def _plan_args(name: str, cp: ClusteredPrims, mode: str, p: Vec3, d: Vec3,
               tf, valid, tile_r: int):
    """Checks what a planner kernel takes; returns its arguments before the
    outputs, and T."""
    device = tf.device
    if device.type != "cuda":
        raise ValueError(f"{name}: tensors on {device}, need cuda or cpu")
    n, c = tf.shape[0], cp.num_clusters
    t_tiles = -(-n // tile_r)
    if not 1 <= tile_r <= 1024:
        raise ValueError(f"{name}: tile_r={tile_r} outside [1, 1024]")
    if n >= 2 ** 31 or t_tiles * c >= 2 ** 31:
        raise ValueError(f"{name}: sizes beyond int32")
    if mode == "group":
        slabs, extra = _group_slab_rows(cp)
        _check(name, device, extra, torch.float32, c)
    elif mode == "super":
        slabs, extra = _slab_rows(cp), _super_slab_rows(cp)
        _check(name, device, extra, torch.float32, -(-c // SUPER))
    else:
        slabs, extra = _slab_rows(cp), (None,) * 6
    _check(name, device, slabs, torch.float32, c)
    _check(name, device, (*p, *d, tf), torch.float32, n)
    _check(name, device, (valid,), torch.bool, n)
    args = ([_MODES[mode]]
            + [a.data_ptr() for a in slabs]
            + [None if a is None else a.data_ptr() for a in extra]
            + [0 if extra[0] is None else extra[0].shape[0]]
            + [a.data_ptr() for a in (*p, *d, tf, valid)]
            + [n, tile_r, c])
    return args, t_tiles


def plan_rows(cp: ClusteredPrims, p: Vec3, d: Vec3, tf, valid, tile_r: int,
              plan: str = "ray"):
    """The unsorted [T, C] entry matrix of planner mode `plan`. CPU tensors
    take ``plan_rows_plain``; CUDA tensors launch ``cluster_plan_rows``,
    whose sweep takes ``plan_rows_chunk`` clusters at a time."""
    mode = _plan_mode(cp, plan)
    if tf.device.type == "cpu":
        return plan_rows_plain(cp, p, d, tf, valid, tile_r, mode)
    counter = PLAN_ROWS[mode]
    args, t_tiles = _plan_args(counter.name, cp, mode, p, d, tf, valid,
                               tile_r)
    c = cp.num_clusters
    chunk = plan_rows_chunk(tile_r, c, -(-c // SUPER) if mode == "super"
                            else 0)
    entry = torch.empty((t_tiles, c), dtype=torch.float32, device=tf.device)
    build.launch(counter, LIBRARY.load().cluster_plan_rows, tf.device,
                 args + [chunk, entry.data_ptr()])
    return entry


def _plan_visits(cp: ClusteredPrims, p: Vec3, d: Vec3, tf, valid,
                 tile_r: int, plan: str = "ray", sort: bool = True,
                 sort_impl: str = "kernel"):
    """Per ray-tile broad phase: (visit [T, C] int32 cluster ids in visit
    order, entry [T, C] float32 entry distances in that order, nvis [T]
    int32), T = ceil(R / tile_r). Only positions below nvis are meaningful.
    Lanes that are not `valid`, or whose tf is 0, plan no visits. `plan` is
    the planner mode (module docstring); `sort` orders each list front to
    back, else the entered clusters keep cluster-id order under suffix-
    minimum entries; `sort_impl='kernel'` sorts 'ray', 'super' and 'group'
    lists in ``cluster_plan`` up to ``max_plan_clusters``, and every other
    combination, or a larger pack, takes ``plan_rows`` and sorts in PyTorch
    (the same lists: the sort is stable). CPU tensors take
    ``plan_visits_plain``."""
    mode = _plan_mode(cp, plan)
    if tf.device.type == "cpu":
        return plan_visits_plain(cp, p, d, tf, valid, tile_r, mode, sort)
    if not plans_in_kernel(cp, mode, sort, sort_impl, tile_r):
        rows = plan_rows(cp, p, d, tf, valid, tile_r, mode)
        return _sort_tail(rows) if sort else _unsorted_tail(rows)
    counter = {"ray": PLAN, "super": PLAN_SUPER, "group": PLAN_GROUP}[mode]
    args, t_tiles = _plan_args(counter.name, cp, mode, p, d, tf, valid,
                               tile_r)
    shape, device = (t_tiles, cp.num_clusters), tf.device
    entry = torch.empty(shape, dtype=torch.float32, device=device)
    visit = torch.empty(shape, dtype=torch.int32, device=device)
    nvis = torch.empty((t_tiles,), dtype=torch.int32, device=device)
    build.launch(counter, LIBRARY.load().cluster_plan, device,
                 args + [a.data_ptr() for a in (entry, visit, nvis)])
    return visit, entry, nvis


@functools.lru_cache(maxsize=None)
def _card_threads(index: int) -> int:
    """Threads card `index` holds resident at once: SMs x threads an SM
    (132 x 2048 on an H100 SXM)."""
    props = torch.cuda.get_device_properties(index)
    return props.multi_processor_count * props.max_threads_per_multi_processor


STREAM_WAVES = 4  # the walks' threads, in the card's resident threads


def _stream_split(t_tiles: int, tile_r: int, device) -> int:
    """S of the walks' S-way split (``csrc/cluster_traverse.cu``:
    S threads a ray, each owning every S-th slot of a staged cluster): the
    largest of 1, 2 and 4 at which the launch's T x tile_r x S threads stay
    within STREAM_WAVES times the threads the card holds resident at once,
    in blocks of at most MAX_BLOCK threads. More threads a ray shorten each
    tile's walk S-fold, which trims the tail of long tiles and fills the
    card on a narrow wavefront, and each repeats its ray's setup and joins
    the reduction; ``chip_smoke.py`` times S = 1, 2 and 4 on every batch of
    every walk. On an H100: S = 4 for the 131,072-lane narrowed batches,
    S = 2 for 2^19 lanes, at tiles of 128 or 256 rays."""
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    budget = STREAM_WAVES * _card_threads(index)
    s = 1
    while (s < 4 and tile_r * 2 * s <= MAX_BLOCK
           and t_tiles * tile_r * 2 * s <= budget):
        s *= 2
    return s


def _walk_split(counter: LaunchCounter, t_tiles: int, tile_r: int,
                device) -> int:
    """S of the S-way split of the walk kernel `counter` counts: every walk,
    closest or any-hit, resident, product-form or streamed, is a split walk
    and takes ``_stream_split``'s S."""
    return _stream_split(t_tiles, tile_r, device)


def _walk_kernel(cp: ClusteredPrims, mxu: bool, stream: bool, resident,
                 streamed, product):
    """(counter, battery code) of the kernel form the keywords select
    (``walk_form``), out of a walk's three LaunchCounters."""
    if stream and mxu:
        raise ValueError("the streamed walks exclude the product-form "
                         "battery (stream=True with mxu=True)")
    form = walk_form(cp, mxu, stream)
    if form == "product":
        return product, _TRIANGLE_PRODUCT
    battery = _TRIANGLE if cp.kind == "triangle" else _SPHERE
    return (streamed if form == "streamed" else resident), battery


# ---------------------------------------------------------------------------
# The walks' counters
# ---------------------------------------------------------------------------
WALK_COUNT_ROWS = 1 << 16  # counted launches one counter buffer serves


class _CountRows:
    """A card's counter buffer: [WALK_COUNT_ROWS, 2] int64 zeros, one row
    (pairs, visits) a counted walk launch, handed out in turn. A full
    buffer is replaced by a new one and never written again, so the rows
    that recorded spans still hold keep their counts until they are read."""

    def __init__(self, device):
        self.rows = torch.zeros((WALK_COUNT_ROWS, 2), dtype=torch.int64,
                                device=device)
        self.used = 0


_COUNT_ROWS = {}  # card index -> _CountRows


def _count_row(name: str, cp: ClusteredPrims, device):
    """The counter row of one walk launch while a profiler session records
    spans (``profiling.recording``, the test ``profiling.span`` makes),
    else None: then the launch passes null and the kernel counts nothing.
    Allocates only when a card's buffer is first needed or full."""
    if not profiling.recording():
        return None
    _check(name, device, (cp.filled,), torch.int32, cp.num_clusters)
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    buf = _COUNT_ROWS.get(index)
    if buf is None or buf.used == WALK_COUNT_ROWS:
        buf = _COUNT_ROWS[index] = _CountRows(torch.device("cuda", index))
    row = buf.rows[buf.used]
    buf.used += 1
    return row


def _count_args(cp: ClusteredPrims, row) -> list:
    """The walks' `filled` and `counts` arguments: null without a row."""
    if row is None:
        return [None, None]
    return [cp.filled.data_ptr(), row.data_ptr()]


def _count_walk(pairs, visits, rays: int):
    """The counters of one walk call, on the innermost open span
    (``port.walk``): ``walk_pairs``, the (valid ray, real prim) pairs the
    walk needs; ``walk_visits``, the (tile, cluster) visits it walks; both 0-d
    device tensors on the card (summed when the spans are read), ints on the
    CPU; and ``walk_rays``, the rays it was given."""
    profiling.count("walk_pairs", pairs)
    profiling.count("walk_visits", visits)
    profiling.count("walk_rays", rays)


def _plain_counted(plain, n: int, *args, **kw):
    """``plain(*args, **kw)``, a plain walk of `n` rays, counted on the
    innermost span while a profiler session records."""
    stats = {} if profiling.recording() else None
    out = plain(*args, stats=stats, **kw)
    if stats is not None:
        _count_walk(stats.get("pairs", 0), stats.get("visits", 0), n)
    return out


def walk_form(cp: ClusteredPrims, mxu: bool, stream: bool) -> str:
    """The walk kernel's form the keywords select: 'streamed', 'product'
    (the product-form triangle battery) or 'resident'."""
    if stream:
        return "streamed"
    return "product" if _uses_mxu(cp, mxu) else "resident"


def walk_closest(cp: ClusteredPrims, visit, entry, nvis, p: Vec3, d: Vec3,
                 tf0, valid, tile_r: int, mxu: bool = False,
                 stream: bool = False):
    """Closest hit over each tile's visit list: (tfar [R], packed prim [R]
    int32 = cluster * K + slot, or (tf0, -1)). CPU tensors take
    ``walk_closest_plain``; CUDA tensors launch ``cluster_closest``, its
    product-form variant (`mxu`, triangle packs) or
    ``cluster_closest_stream`` (`stream`), each at the S of
    ``_walk_split``."""
    device = tf0.device
    counter, battery = _walk_kernel(cp, mxu, stream, CLOSEST, CLOSEST_STREAM,
                                    CLOSEST_MXU)
    n = tf0.shape[0]
    if device.type == "cpu":
        return _plain_counted(
            walk_closest_plain, n, cp, visit, entry, nvis, p, d, tf0, valid,
            tile_r, mxu=mxu, packed=_tables_packed(cp) if stream else None)
    table = _check_walk(counter.name, cp, device, n, tile_r, (*p, *d, tf0),
                        visit, entry, nvis, stream)
    _check(counter.name, device, (valid,), torch.bool, n)
    root = _root_row(cp)
    lib = LIBRARY.load()
    tfar = torch.empty(n, dtype=torch.float32, device=device)
    prim = torch.empty(n, dtype=torch.int32, device=device)
    split = _walk_split(counter, visit.shape[0], tile_r, device)
    row = _count_row(counter.name, cp, device)
    build.launch(counter,
                 lib.cluster_closest_stream if stream else lib.cluster_closest,
                 device,
                 [a.data_ptr() for a in (nvis, visit, entry, root, *p, *d,
                                         tf0, valid, table)]
                 + [battery, split, n, tile_r, cp.num_clusters,
                    cp.cluster_size, tfar.data_ptr(), prim.data_ptr()]
                 + _count_args(cp, row))
    if row is not None:
        _count_walk(row[0], row[1], n)
    return tfar, prim


def walk_occluded(cp: ClusteredPrims, visit, entry, nvis, p: Vec3, d: Vec3,
                  tfar, tile_r: int, mxu: bool = False, stream: bool = False):
    """Any hit over each tile's visit list: [R] bool. CPU tensors take
    ``walk_occluded_plain``; CUDA tensors launch ``cluster_occluded``, its
    product-form variant (`mxu`, triangle packs) or
    ``cluster_occluded_stream`` (`stream`), each at the S of
    ``_walk_split``."""
    device = tfar.device
    counter, battery = _walk_kernel(cp, mxu, stream, OCCLUDED,
                                    OCCLUDED_STREAM, OCCLUDED_MXU)
    n = tfar.shape[0]
    if device.type == "cpu":
        return _plain_counted(
            walk_occluded_plain, n, cp, visit, entry, nvis, p, d, tfar,
            tile_r, mxu=mxu, packed=_tables_packed(cp) if stream else None)
    table = _check_walk(counter.name, cp, device, n, tile_r, (*p, *d, tfar),
                        visit, entry, nvis, stream)
    root = _root_row(cp)
    lib = LIBRARY.load()
    occ = torch.empty(n, dtype=torch.bool, device=device)
    split = _walk_split(counter, visit.shape[0], tile_r, device)
    row = _count_row(counter.name, cp, device)
    build.launch(counter,
                 lib.cluster_occluded_stream if stream
                 else lib.cluster_occluded, device,
                 [a.data_ptr() for a in (nvis, visit, entry, root, *p, *d,
                                         tfar, table)]
                 + [battery, split, n, tile_r, cp.num_clusters,
                    cp.cluster_size, occ.data_ptr()] + _count_args(cp, row))
    if row is not None:
        _count_walk(row[0], row[1], n)
    return occ


# ---------------------------------------------------------------------------
# The streamed walks' staging, replayed (benchmarks/diag_stream2.py's DMA
# replay)
# ---------------------------------------------------------------------------
def replay_visits(nv: int) -> int:
    """Visits the replay's output holds: nv rounded up to a multiple of 8,
    the JAX kernel's output block."""
    return -(-nv // 8) * 8


def stream_replay_plain(cp: ClusteredPrims, visit, nvis, tile: int):
    """Tile `tile`'s visited clusters copied out of the packed table: the
    F8 rows of cluster visit[tile, j] at rows [j * F8, (j + 1) * F8) of a
    [replay_visits(nv) * F8, K] float32 table, nv = nvis[tile], the rows of
    the visits at or past nv zero. An index gather of ``_tables_packed``."""
    packed = _tables_packed(cp)
    f8, nv = _stream_rows(cp.kind), int(nvis[tile])
    out = packed.new_zeros((replay_visits(nv) * f8, cp.cluster_size))
    rows = (visit[tile, :nv].to(torch.int64)[:, None] * f8
            + torch.arange(f8, device=packed.device))
    out[:nv * f8] = packed[rows.reshape(-1)]
    return out


def stream_replay(cp: ClusteredPrims, visit, nvis, tile: int):
    """``stream_replay_plain``'s table through the streamed walks' own
    staging (``csrc/cluster_traverse.cu``: ``stream_replay``, counted in
    ``REPLAY``): every visit of the tile's list copied into the two
    shared-memory slots as ``cluster_closest_stream`` copies it, and
    written back out. CPU tensors take the plain version; CUDA tensors
    launch the kernel or raise. Reads nv = nvis[tile] to the host to size
    the output."""
    if visit.device.type == "cpu":
        return stream_replay_plain(cp, visit, nvis, tile)
    return replay_launch(cp, visit, nvis, tile,
                         replay_visits(int(nvis[tile])))


REPLAY_BLOCKS_PER_SM = 8  # 256-thread blocks: 2048 threads an SM


def replay_blocks(n: int, sms: int) -> int:
    """Blocks that share a list of n visits on a card of `sms` SMs: two
    visits a block at least where n has two, at most REPLAY_BLOCKS_PER_SM
    an SM. The replay's grid is ``replay_blocks(n_out, sms)``; on the card
    the kernel reads nv <= n_out and splits the list over
    ``min(grid, max(1, nv // 2)) = replay_blocks(nv, sms)`` of them."""
    return max(1, min(REPLAY_BLOCKS_PER_SM * sms, n // 2))


def replay_slices(nv: int, sms: int):
    """The [first, last) visits of each block that owns some of a list of
    nv visits, in block order: contiguous, together the list, nv // blocks
    visits or one more (the longer slices last), so that block b starts at
    visit 2b wherever nv // 2 blocks fit on the card."""
    blocks = replay_blocks(nv, sms)
    per, longer = divmod(nv, blocks)
    firsts = [b * per + max(0, b - (blocks - longer)) for b in range(blocks)]
    return list(zip(firsts, firsts[1:] + [nv]))


def replay_occupancy(cp: ClusteredPrims) -> int:
    """Blocks of the replay one SM holds at this pack's cluster size, with
    the shared memory a launch asks for (CUDA's occupancy calculator)."""
    per_sm = ctypes.c_int(0)
    err = LIBRARY.load().stream_replay_occupancy(
        int(cp.kind == "triangle"), cp.cluster_size, ctypes.byref(per_sm))
    if err != 0:
        raise RuntimeError(f"stream_replay: occupancy query failed with "
                           f"cudaError {err}")
    return per_sm.value


def replay_launch(cp: ClusteredPrims, visit, nvis, tile: int, n_out: int,
                  sms: Optional[int] = None):
    """One launch of the ``stream_replay`` kernel into a new [n_out * F8,
    K] table, n_out at least nvis[tile] (``stream_replay`` reads it; this
    form leaves the host read out of a timed launch), on a grid of
    ``replay_blocks(n_out, sms)`` blocks; `sms` defaults to the card's SM
    count (a smaller one forces longer slices)."""
    device = visit.device
    if device.type != "cuda":
        raise ValueError(f"stream_replay: tensors on {device}, need cuda or "
                         "cpu")
    t_tiles, c, k = visit.shape[0], cp.num_clusters, cp.cluster_size
    packed = _tables_packed(cp)
    f8 = _stream_rows(cp.kind)
    _check(REPLAY.name, device, (packed,), torch.float32)
    _check(REPLAY.name, device, (visit, nvis), torch.int32)
    if (visit.shape != (t_tiles, c) or nvis.shape != (t_tiles,)
            or packed.shape != (c * f8, k) or not 0 <= tile < t_tiles):
        raise ValueError(f"stream_replay: tile {tile} of a plan "
                         f"{tuple(visit.shape)} over a table "
                         f"{tuple(packed.shape)}")
    if walk_shared_bytes(cp) > MAX_SHARED_BYTES:
        raise ValueError(f"stream_replay: cluster_size {k} does not fit one "
                         "block's shared memory")
    out = torch.empty((n_out * f8, k), dtype=torch.float32, device=device)
    if n_out == 0:
        return out
    blocks = replay_blocks(
        n_out, build.sm_count(device.index) if sms is None else sms)
    build.launch(REPLAY, LIBRARY.load().stream_replay, device,
                 [nvis.data_ptr(), visit.data_ptr(), packed.data_ptr(),
                  int(cp.kind == "triangle"), tile, c, k, n_out, blocks,
                  out.data_ptr()])
    return out


# ---------------------------------------------------------------------------
# Host-facing wrappers
# ---------------------------------------------------------------------------
def _check_forms(cp: ClusteredPrims, mxu: bool, stream: bool):
    """The JAX package's rule for clusters below 128 prims (lane-packed
    there): neither the streamed walks nor the product-form battery."""
    if cp.cluster_size < 128 and (stream or mxu):
        raise ValueError(
            f"cluster_size {cp.cluster_size} < 128 excludes stream and mxu "
            "(ops.intersect._tile_for switches both off for such a pack)")


def _planned(cp: ClusteredPrims, p: Vec3, d: Vec3, tf, valid, tile_r: int,
             plan: str, sort: bool, sort_impl: str):
    """``_plan_visits`` in a ``port.plan`` span that counts the rays it is
    given (``plan_rays``)."""
    with profiling.span("port.plan", plan_clusters=cp.num_clusters,
                        plan_tile=tile_r, plan_mode=_plan_mode(cp, plan)):
        profiling.count("plan_rays", tf.shape[0])
        return _plan_visits(cp, p, d, tf, valid, tile_r, plan, sort,
                            sort_impl)


def intersect_clustered_pallas(
    cp: ClusteredPrims, p: Vec3, d: Vec3,
    tfar0: Optional[torch.Tensor] = None,
    alive: Optional[torch.Tensor] = None,
    tile_r: int = DEFAULT_TILE_R, mxu: bool = False, stream: bool = False,
    plan: str = "ray", sort: bool = True, sort_impl: str = "kernel",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Closest hit. Returns (tfar [R], prim_id [R] int32 in ORIGINAL
    numbering, -1 = miss). `tfar0` seeds the search; `alive=False` lanes are
    planned around and return (tfar0, -1). `stream` takes the streamed walk,
    `mxu` the product-form triangle battery, `plan`, `sort` and `sort_impl`
    the planner (module docstring; ``_plan_visits``)."""
    _check_forms(cp, mxu, stream)
    n = p.x.shape[0]
    device = p.x.device
    if tfar0 is None:
        tfar0 = torch.full((n,), FLT_MAX, dtype=torch.float32, device=device)
    if alive is None:
        valid = torch.ones((n,), dtype=torch.bool, device=device)
        plan_tf = tfar0
    else:
        valid = alive
        plan_tf = torch.where(alive, tfar0, 0.0)
    visit, entry, nvis = _planned(cp, p, d, plan_tf, valid, tile_r, plan,
                                  sort, sort_impl)
    with profiling.span("port.walk", walk_form=walk_form(cp, mxu, stream),
                        walk_kind="closest", walk_prims=cp.kind):
        tfar, packed = walk_closest(cp, visit, entry, nvis, p, d, tfar0,
                                    valid, tile_r, mxu=mxu, stream=stream)
    orig = torch.where(packed >= 0,
                       cp.order[torch.clamp_min(packed, 0).to(torch.int64)],
                       -1)
    return tfar, orig


def occluded_clustered_pallas(cp: ClusteredPrims, p: Vec3, d: Vec3, tfar,
                              tile_r: int = DEFAULT_TILE_R,
                              mxu: bool = False, stream: bool = False,
                              plan: str = "ray", sort: bool = True,
                              sort_impl: str = "kernel") -> torch.Tensor:
    """Any-hit: True where some prim lies at t in [0, tfar). Lanes with
    tfar <= 0 plan no visits (the renderer masks invalid shadow rays by
    tfar = 0). The keywords as in ``intersect_clustered_pallas``."""
    _check_forms(cp, mxu, stream)
    visit, entry, nvis = _planned(cp, p, d, tfar, tfar > 0.0, tile_r, plan,
                                  sort, sort_impl)
    with profiling.span("port.walk", walk_form=walk_form(cp, mxu, stream),
                        walk_kind="anyhit", walk_prims=cp.kind):
        return walk_occluded(cp, visit, entry, nvis, p, d, tfar, tile_r,
                             mxu=mxu, stream=stream)


# ---------------------------------------------------------------------------
# Coherence ordering
# ---------------------------------------------------------------------------
def coherence_order(alive, d: Vec3, seg_len: int = DEFAULT_SEG_LEN):
    """Returns (order [RP] int32, inv [RP] int32, rp): gather by `order`
    groups each seg_len-ray segment by (alive first, direction octant),
    stably; `inv` scatters results back. Padding lanes (index >= R) sort
    last in their segment. A stable sort on the 4-bit key, which is what the
    JAX package's four radix passes compute."""
    r = alive.shape[0]
    s = -(-r // seg_len)
    rp = s * seg_len
    octant = ((d.x < 0).to(torch.int32) | ((d.y < 0).to(torch.int32) << 1)
              | ((d.z < 0).to(torch.int32) << 2))
    key = torch.where(alive, octant, 8)  # dead lanes after all octants
    (key,) = _ray_cols([(key, 15)], rp)
    perm = torch.sort(key.reshape(s, seg_len), dim=1, stable=True).indices
    base = torch.arange(s, device=alive.device)[:, None] * seg_len
    order = (perm + base).reshape(-1)
    inv = torch.empty_like(order)
    inv[order] = torch.arange(rp, device=alive.device)
    return order.to(torch.int32), inv.to(torch.int32), rp


def compact_order(alive):
    """Returns (order, inv), int32: `order` gathers alive lanes to the front
    (stable), `inv` scatters results back."""
    a = alive.to(torch.int64)
    n_alive = a.sum()
    inv = torch.where(alive, torch.cumsum(a, 0) - 1,
                      n_alive + torch.cumsum(1 - a, 0) - 1)
    order = torch.empty_like(inv)
    order[inv] = torch.arange(alive.shape[0], device=alive.device)
    return order.to(torch.int32), inv.to(torch.int32)


def _gather_vec3_padded(v: Vec3, idx, padval) -> Vec3:
    return Vec3(*(_ray_cols([(a, padval)], idx.shape[0])[0][idx] for a in v))


def intersect_clustered_pallas_compact(
    cp, p, d, alive, tfar0=None, tile_r: int = DEFAULT_TILE_R,
    seg_len: int = DEFAULT_SEG_LEN, **kw,
):
    """``intersect_clustered_pallas`` on rays regrouped by
    ``coherence_order``, results scattered back; `kw` are its keywords
    (mxu, stream, plan, sort, sort_impl)."""
    r = alive.shape[0]
    order, inv, rp = coherence_order(alive, d, seg_len)
    order, inv = order.to(torch.int64), inv.to(torch.int64)
    tfar, prim = intersect_clustered_pallas(
        cp, _gather_vec3_padded(p, order, 1e30),
        _gather_vec3_padded(d, order, 1.0),
        tfar0=(None if tfar0 is None
               else _ray_cols([(tfar0, 0.0)], rp)[0][order]),
        alive=_ray_cols([(alive, False)], rp)[0][order], tile_r=tile_r, **kw)
    return tfar[inv[:r]], prim[inv[:r]]


def occluded_clustered_pallas_compact(
    cp, p, d, tfar, tile_r: int = DEFAULT_TILE_R,
    seg_len: int = DEFAULT_SEG_LEN, **kw,
):
    """``occluded_clustered_pallas`` on rays regrouped by
    ``coherence_order``; `kw` as in ``intersect_clustered_pallas``."""
    r = tfar.shape[0]
    order, inv, rp = coherence_order(tfar > 0.0, d, seg_len)
    order, inv = order.to(torch.int64), inv.to(torch.int64)
    occ = occluded_clustered_pallas(
        cp, _gather_vec3_padded(p, order, 1e30),
        _gather_vec3_padded(d, order, 1.0),
        _ray_cols([(tfar, 0.0)], rp)[0][order], tile_r=tile_r, **kw)
    return occ[inv[:r]]
