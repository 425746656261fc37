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
  ``cluster_closest``, ``cluster_occluded``), launched for CUDA tensors by
  ``_plan_visits``, ``walk_closest`` and ``walk_occluded``, or they raise;
  nothing falls back. Each counts its launches (``PLAN``, ``CLOSEST``,
  ``OCCLUDED``).

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

What is TPU schedule in the JAX module and has no counterpart here: the
lane packing of clusters below 128 prims, ``fuse`` / ``unroll`` /
``trav_block`` / ``exit_refresh`` / ``prefetch`` / ``plan_block``, the 8-row
SMEM blocks, the [8, Cp] slab layout and the padding of the tile count to a
multiple of 8. The other planners (``plan`` = 'super', 'group', 'tilebox',
'hybrid', the unsorted plan) are not ported yet.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from ...core import fp
from ...core.fp import fma
from ...core.vec import Vec3
from ..clustered import ClusteredPrims
from . import build
from .build import LaunchCounter
from .sphere_battery import (FLT_MAX, _closest_epilogue, sphere_candidates,
                             sphere_occluded_pairs)

DEFAULT_TILE_R = 256
DEFAULT_SEG_LEN = 2048
_N_ATTRS = {"sphere": 4, "triangle": 12}
PLAN_CHUNK_ELEMS = 1 << 23  # [t, tile_r, C] elements per planner chunk
MAX_SHARED_BYTES = 227 * 1024  # dynamic shared memory one block can have

PLAN = LaunchCounter("cluster_plan")
CLOSEST = LaunchCounter("cluster_closest")
OCCLUDED = LaunchCounter("cluster_occluded")
CLOSEST_STREAM = LaunchCounter("cluster_closest_stream")
OCCLUDED_STREAM = LaunchCounter("cluster_occluded_stream")
CLOSEST_MXU = LaunchCounter("cluster_closest[mxu]")
OCCLUDED_MXU = LaunchCounter("cluster_occluded[mxu]")


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
               cp.packed)
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def _tables_unpacked(cp: ClusteredPrims, packed: torch.Tensor):
    """The per-attribute [C, K] planes read back out of a packed table."""
    planes = packed.reshape(cp.num_clusters, _stream_rows(cp.kind),
                            cp.cluster_size)
    return tuple(planes[:, f] for f in range(_N_ATTRS[cp.kind]))


def _slab_rows(cp: ClusteredPrims):
    """The cluster AABBs as six [C] rows: lo.xyz, hi.xyz."""
    return (*cp.lo, *cp.hi)


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


def plan_visits_plain(cp: ClusteredPrims, p: Vec3, d: Vec3, tf, valid,
                      tile_r: int):
    """The planner in plain PyTorch: per tile and cluster the min over valid
    rays of the slab entry distance (``_tile_entry_row``), then a stable sort
    of each row. Returns (visit [T, C] int32, entry [T, C] float32 sorted,
    FLT_MAX past the end; nvis [T] int32)."""
    px, py, pz, dx, dy, dz, tfs, ok = _tiled(p, d, tf, valid, tile_r)
    t_tiles, c = px.shape[0], cp.num_clusters
    lo = [a[None, None, :] for a in cp.lo]
    hi = [a[None, None, :] for a in cp.hi]
    zero = torch.zeros((), dtype=torch.float32, device=tf.device)
    step = max(1, PLAN_CHUNK_ELEMS // (tile_r * c))
    rows = []
    for s in range(0, t_tiles, step):
        sl = slice(s, s + step)
        tmin, tmax = _slab(lo, hi, *(a[sl, :, None]
                                     for a in (px, py, pz, dx, dy, dz)))
        entry = torch.maximum(tmin, zero)
        hit = (tmax >= entry) & (entry < tfs[sl, :, None]) & ok[sl, :, None]
        rows.append(torch.where(hit, entry, FLT_MAX).amin(dim=1))
    entry_t = (torch.cat(rows) if rows else
               torch.empty((0, c), dtype=torch.float32, device=tf.device))
    entry_sorted, order = torch.sort(entry_t, dim=1, stable=True)
    nvis = (entry_sorted < FLT_MAX).sum(dim=1).to(torch.int32)
    return order.to(torch.int32), entry_sorted, nvis


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
    lib.cluster_plan.argtypes = [ptr] * 14 + [i32] * 3 + [ptr] * 4
    lib.cluster_plan.restype = i32
    for fn in (lib.cluster_closest, lib.cluster_closest_stream):
        fn.argtypes = [ptr] * 13 + [i32] * 5 + [ptr] * 3
        fn.restype = i32
    for fn in (lib.cluster_occluded, lib.cluster_occluded_stream):
        fn.argtypes = [ptr] * 12 + [i32] * 5 + [ptr] * 2
        fn.restype = i32


LIBRARY = build.Library("cluster_traverse.cu", build.nvcc, build.NVCC_FLAGS,
                        _bind)

# the `battery` argument of the walks' C entry points
_SPHERE, _TRIANGLE, _TRIANGLE_PRODUCT = 0, 1, 2


def _check(name: str, device, tensors, dtype, length=None):
    for a in tensors:
        if (a.device != device or a.dtype != dtype or not a.is_contiguous()
                or (length is not None and a.shape != (length,))):
            raise ValueError(
                f"{name}: needs contiguous {dtype} tensors on {device}"
                + (f" of shape ({length},)" if length is not None else "")
                + f"; got {a.dtype} {tuple(a.shape)} {a.device} "
                f"contiguous={a.is_contiguous()}")


def walk_shared_bytes(cp: ClusteredPrims, stream: bool) -> int:
    """Dynamic shared memory a walk's block stages clusters in: one
    cluster's attributes for the resident walks, two slots of them for the
    streamed walks (32 KB at 256 triangles a cluster, 128 KB at 1024; the
    copies skip the zero rows that pad a packed cluster to F8)."""
    return cp.cluster_size * _N_ATTRS[cp.kind] * 4 * (2 if stream else 1)


def _check_walk(name, cp: ClusteredPrims, device, n, tile_r, rays, visit,
                entry, nvis, stream):
    """Checks what a walk kernel takes and returns its table: the [C*K, F]
    rows (planes for triangles) of the resident walks, or the [C*F8, K]
    packed table of the streamed ones."""
    if device.type != "cuda":
        raise ValueError(f"{name}: tensors on {device}, need cuda or cpu")
    if tile_r % 32 or not 32 <= tile_r <= 1024:
        raise ValueError(f"{name}: tile_r={tile_r} must be a multiple of 32 "
                         "in [32, 1024] (one thread per ray of a tile)")
    t_tiles, c, k = -(-n // tile_r), cp.num_clusters, cp.cluster_size
    _check(name, device, rays, torch.float32, n)
    if stream:
        # any K is aligned for the 16-byte copies: a packed cluster is
        # F8 * K floats, its attribute rows 4 * K or 12 * K
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
    if walk_shared_bytes(cp, stream) > MAX_SHARED_BYTES:
        raise ValueError(f"{name}: cluster_size {k} does not fit one "
                         "block's shared memory")
    if n >= 2 ** 31 or t_tiles * c >= 2 ** 31 or table.numel() >= 2 ** 31:
        raise ValueError(f"{name}: sizes beyond int32")
    return table


def max_plan_clusters(tile_r: int) -> int:
    """The most clusters ``cluster_plan`` takes. One block sorts a tile's
    list in shared memory, as a power-of-two array of 8-byte keys beside 28
    bytes for each staged ray: 16,384 clusters for any tile_r up to 1024.
    With 256 prims a cluster that is 4,194,304 prims in full clusters, and
    about 3.1 million at the three-quarter fill of the SAH build."""
    keys = (MAX_SHARED_BYTES - tile_r * 28) // 8
    return 1 << (keys.bit_length() - 1) if keys >= 1 else 0


def _plan_visits(cp: ClusteredPrims, p: Vec3, d: Vec3, tf, valid,
                 tile_r: int):
    """Per ray-tile broad phase: (visit [T, C] int32 cluster ids sorted near
    to far, entry [T, C] float32 sorted tile-min entry distances, nvis [T]
    int32), T = ceil(R / tile_r). Only positions below nvis are meaningful.
    Lanes that are not `valid`, or whose tf is 0, plan no visits. CPU tensors
    take ``plan_visits_plain``; CUDA tensors launch ``cluster_plan``."""
    device = tf.device
    if device.type == "cpu":
        return plan_visits_plain(cp, p, d, tf, valid, tile_r)
    name = PLAN.name
    if device.type != "cuda":
        raise ValueError(f"{name}: tensors on {device}, need cuda or cpu")
    n, c = tf.shape[0], cp.num_clusters
    t_tiles = -(-n // tile_r)
    if not 1 <= tile_r <= 1024:
        raise ValueError(f"{name}: tile_r={tile_r} outside [1, 1024]")
    if c > max_plan_clusters(tile_r):
        raise ValueError(f"{name}: {c} clusters, more than the "
                         f"{max_plan_clusters(tile_r)} whose sort keys fit "
                         "one block's shared memory")
    if n >= 2 ** 31 or t_tiles * c >= 2 ** 31:
        raise ValueError(f"{name}: sizes beyond int32")
    slabs = _slab_rows(cp)
    _check(name, device, slabs, torch.float32, c)
    _check(name, device, (*p, *d, tf), torch.float32, n)
    _check(name, device, (valid,), torch.bool, n)
    lib = LIBRARY.load()
    entry = torch.empty((t_tiles, c), dtype=torch.float32, device=device)
    visit = torch.empty((t_tiles, c), dtype=torch.int32, device=device)
    nvis = torch.empty((t_tiles,), dtype=torch.int32, device=device)
    build.launch(name, lib.cluster_plan, device,
                 [a.data_ptr() for a in (*slabs, *p, *d, tf, valid)]
                 + [n, tile_r, c]
                 + [a.data_ptr() for a in (entry, visit, nvis)])
    PLAN.launches += 1
    return visit, entry, nvis


def _walk_kernel(cp: ClusteredPrims, mxu: bool, stream: bool, resident,
                 streamed, product):
    """(counter, battery code) of the kernel form the keywords select, out
    of a walk's three LaunchCounters."""
    if stream and mxu:
        raise ValueError("the streamed walks exclude the product-form "
                         "battery (stream=True with mxu=True)")
    if stream:
        return streamed, int(cp.kind == "triangle")
    if _uses_mxu(cp, mxu):
        return product, _TRIANGLE_PRODUCT
    return resident, _TRIANGLE if cp.kind == "triangle" else _SPHERE


def walk_closest(cp: ClusteredPrims, visit, entry, nvis, p: Vec3, d: Vec3,
                 tf0, valid, tile_r: int, mxu: bool = False,
                 stream: bool = False):
    """Closest hit over each tile's visit list: (tfar [R], packed prim [R]
    int32 = cluster * K + slot, or (tf0, -1)). CPU tensors take
    ``walk_closest_plain``; CUDA tensors launch ``cluster_closest``, its
    product-form variant (`mxu`, triangle packs) or
    ``cluster_closest_stream`` (`stream`)."""
    device = tf0.device
    counter, battery = _walk_kernel(cp, mxu, stream, CLOSEST, CLOSEST_STREAM,
                                    CLOSEST_MXU)
    if device.type == "cpu":
        return walk_closest_plain(
            cp, visit, entry, nvis, p, d, tf0, valid, tile_r, mxu=mxu,
            packed=_tables_packed(cp) if stream else None)
    n = tf0.shape[0]
    table = _check_walk(counter.name, cp, device, n, tile_r, (*p, *d, tf0),
                        visit, entry, nvis, stream)
    _check(counter.name, device, (valid,), torch.bool, n)
    root = _root_row(cp)
    lib = LIBRARY.load()
    tfar = torch.empty(n, dtype=torch.float32, device=device)
    prim = torch.empty(n, dtype=torch.int32, device=device)
    build.launch(counter.name,
                 lib.cluster_closest_stream if stream else lib.cluster_closest,
                 device,
                 [a.data_ptr() for a in (nvis, visit, entry, root, *p, *d,
                                         tf0, valid, table)]
                 + [battery, n, tile_r, cp.num_clusters, cp.cluster_size,
                    tfar.data_ptr(), prim.data_ptr()])
    counter.launches += 1
    return tfar, prim


def walk_occluded(cp: ClusteredPrims, visit, entry, nvis, p: Vec3, d: Vec3,
                  tfar, tile_r: int, mxu: bool = False, stream: bool = False):
    """Any hit over each tile's visit list: [R] bool. CPU tensors take
    ``walk_occluded_plain``; CUDA tensors launch ``cluster_occluded``, its
    product-form variant (`mxu`, triangle packs) or
    ``cluster_occluded_stream`` (`stream`)."""
    device = tfar.device
    counter, battery = _walk_kernel(cp, mxu, stream, OCCLUDED,
                                    OCCLUDED_STREAM, OCCLUDED_MXU)
    if device.type == "cpu":
        return walk_occluded_plain(
            cp, visit, entry, nvis, p, d, tfar, tile_r, mxu=mxu,
            packed=_tables_packed(cp) if stream else None)
    n = tfar.shape[0]
    table = _check_walk(counter.name, cp, device, n, tile_r, (*p, *d, tfar),
                        visit, entry, nvis, stream)
    root = _root_row(cp)
    lib = LIBRARY.load()
    occ = torch.empty(n, dtype=torch.bool, device=device)
    build.launch(counter.name,
                 lib.cluster_occluded_stream if stream
                 else lib.cluster_occluded, device,
                 [a.data_ptr() for a in (nvis, visit, entry, root, *p, *d,
                                         tfar, table)]
                 + [battery, n, tile_r, cp.num_clusters, cp.cluster_size,
                    occ.data_ptr()])
    counter.launches += 1
    return occ


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


def intersect_clustered_pallas(
    cp: ClusteredPrims, p: Vec3, d: Vec3,
    tfar0: Optional[torch.Tensor] = None,
    alive: Optional[torch.Tensor] = None,
    tile_r: int = DEFAULT_TILE_R, mxu: bool = False, stream: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Closest hit. Returns (tfar [R], prim_id [R] int32 in ORIGINAL
    numbering, -1 = miss). `tfar0` seeds the search; `alive=False` lanes are
    planned around and return (tfar0, -1). `stream` takes the streamed walk,
    `mxu` the product-form triangle battery (module docstring)."""
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
    visit, entry, nvis = _plan_visits(cp, p, d, plan_tf, valid, tile_r)
    tfar, packed = walk_closest(cp, visit, entry, nvis, p, d, tfar0, valid,
                                tile_r, mxu=mxu, stream=stream)
    orig = torch.where(packed >= 0,
                       cp.order[torch.clamp_min(packed, 0).to(torch.int64)],
                       -1)
    return tfar, orig


def occluded_clustered_pallas(cp: ClusteredPrims, p: Vec3, d: Vec3, tfar,
                              tile_r: int = DEFAULT_TILE_R,
                              mxu: bool = False,
                              stream: bool = False) -> torch.Tensor:
    """Any-hit: True where some prim lies at t in [0, tfar). Lanes with
    tfar <= 0 plan no visits (the renderer masks invalid shadow rays by
    tfar = 0). `stream` and `mxu` as in ``intersect_clustered_pallas``."""
    _check_forms(cp, mxu, stream)
    visit, entry, nvis = _plan_visits(cp, p, d, tfar, tfar > 0.0, tile_r)
    return walk_occluded(cp, visit, entry, nvis, p, d, tfar, tile_r, mxu=mxu,
                         stream=stream)


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
    seg_len: int = DEFAULT_SEG_LEN, mxu: bool = False, stream: bool = False,
):
    """``intersect_clustered_pallas`` on rays regrouped by
    ``coherence_order``, results scattered back."""
    r = alive.shape[0]
    order, inv, rp = coherence_order(alive, d, seg_len)
    order, inv = order.to(torch.int64), inv.to(torch.int64)
    tfar, prim = intersect_clustered_pallas(
        cp, _gather_vec3_padded(p, order, 1e30),
        _gather_vec3_padded(d, order, 1.0),
        tfar0=(None if tfar0 is None
               else _ray_cols([(tfar0, 0.0)], rp)[0][order]),
        alive=_ray_cols([(alive, False)], rp)[0][order], tile_r=tile_r,
        mxu=mxu, stream=stream)
    return tfar[inv[:r]], prim[inv[:r]]


def occluded_clustered_pallas_compact(
    cp, p, d, tfar, tile_r: int = DEFAULT_TILE_R,
    seg_len: int = DEFAULT_SEG_LEN, mxu: bool = False, stream: bool = False,
):
    """``occluded_clustered_pallas`` on rays regrouped by
    ``coherence_order``."""
    r = tfar.shape[0]
    order, inv, rp = coherence_order(tfar > 0.0, d, seg_len)
    order, inv = order.to(torch.int64), inv.to(torch.int64)
    occ = occluded_clustered_pallas(
        cp, _gather_vec3_padded(p, order, 1e30),
        _gather_vec3_padded(d, order, 1.0),
        _ray_cols([(tfar, 0.0)], rp)[0][order], tile_r=tile_r, mxu=mxu,
        stream=stream)
    return occ[inv[:r]]
