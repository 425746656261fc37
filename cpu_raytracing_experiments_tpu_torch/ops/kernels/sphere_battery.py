"""The two sphere batteries of the main path: closest hit and any hit of a
ray batch against all spheres. Each has two forms in this module:

* the plain PyTorch version (``intersect_spheres``, ``occluded_spheres``),
  the port of ``ops/intersect.py``'s XLA batteries of the JAX package. It
  runs for tensors on the CPU, and ``chip_smoke.py`` holds the kernels to it
  on the card;
* a hand-written CUDA kernel (``csrc/sphere_battery.cu``), the port of the
  Pallas kernels ``_closest_kernel`` and ``_occluded_kernel`` of
  ``ops/pallas/sphere_kernel.py``. ``closest_hit`` and ``any_hit`` launch it
  for CUDA tensors, or raise; nothing falls back.

The kernels are built with nvcc for sm_90a at first use (``build.py``)
and bound with ctypes. Each wrapper counts its launches in
``CLOSEST.launches`` and ``OCCLUDED.launches``.
"""
from __future__ import annotations

import ctypes

import torch

from ...core import fp
from ...core.fp import fma
from ...core.vec import Vec3
from . import build
from .build import LaunchCounter, reset_counts  # noqa: F401

FLT_MAX = 3.4028234663852886e38  # float32 max, exactly representable
PRIM_CHUNK = 512  # spheres per [R, C] block of the plain versions

CLOSEST = LaunchCounter("sphere_closest")
OCCLUDED = LaunchCounter("sphere_occluded")


# ---------------------------------------------------------------------------
# Plain PyTorch versions (ops/intersect.py:109-228 of the JAX package)
# ---------------------------------------------------------------------------
def _closest_epilogue(t):
    """(min t [R], first index achieving it [R] int32) of a [R, C] block."""
    best = t.min(dim=1).values
    iota = torch.arange(t.shape[1], dtype=torch.int32, device=t.device)
    first = torch.where(t == best[:, None], iota, t.shape[1]).min(dim=1).values
    return best, first


def sphere_candidates(px, py, pz, dx, dy, dz, cx, cy, cz, r_sq,
                      fuse_bb=True):
    """Candidate distances of rays against spheres, FLT_MAX where the ray
    misses; the arguments broadcast against each other. b and disc fuse
    their multiply-adds as XLA does (core/fp.py); with `fuse_bb` False,
    b*b is rounded alone and added to disc, as XLA rounds a 5-8-wide chunk
    (``fp.xla_fuses_sphere_bb``)."""
    tx = cx - px
    ty = cy - py
    tz = cz - pz
    b = fp.dot3(dx, dy, dz, tx, ty, tz)
    rest = r_sq - fp.dot3(tx, ty, tz, tx, ty, tz)
    disc = fma(b, b, rest) if fuse_bb else rest + b * b
    sq = fp.sqrt(torch.clamp_min(disc, 0.0))
    t_near = b - sq
    t = torch.where(t_near < 0.0, b + sq, t_near)
    valid = (disc >= 0.0) & (t >= 0.0)
    return torch.where(valid, t, FLT_MAX)


def _sphere_candidates(p: Vec3, d: Vec3, cx, cy, cz, r_sq, fuse_bb=True):
    """[R, C] candidate distances of rays [R] against spheres [C]."""
    return sphere_candidates(
        p.x[:, None], p.y[:, None], p.z[:, None], d.x[:, None], d.y[:, None],
        d.z[:, None], cx[None, :], cy[None, :], cz[None, :], r_sq[None, :],
        fuse_bb)


def unfused_from(n_prims: int) -> int:
    """The first sphere whose disc ``intersect_spheres`` rounds with b*b
    alone: the start of the last PRIM_CHUNK-wide chunk where that chunk is
    5-8 spheres wide (``fp.xla_fuses_sphere_bb``), else n_prims."""
    last = (n_prims - 1) // PRIM_CHUNK * PRIM_CHUNK if n_prims else 0
    return n_prims if fp.xla_fuses_sphere_bb(n_prims - last) else last


def intersect_spheres(p: Vec3, d: Vec3, center: Vec3, radius_sq,
                      xla_chunks=True):
    """Closest hit over all spheres: (tfar [R], prim_id [R] int32), FLT_MAX
    and -1 for a miss. Prims are reduced in PRIM_CHUNK-wide chunks with a
    strict `<` between chunks: the first occurrence wins. With `xla_chunks`
    disc is rounded as jitted XLA rounds each chunk of the JAX package's
    ``intersect_spheres`` (``unfused_from``); without, fused in every
    chunk, as XLA rounds the cluster battery of its ``intersect_clustered``
    (inside ``lax.cond`` in a scan) at every K."""
    n = p.x.shape[0]
    best_t = torch.full((n,), FLT_MAX, dtype=torch.float32, device=p.x.device)
    best_id = torch.full((n,), -1, dtype=torch.int32, device=p.x.device)
    n_prims = radius_sq.shape[0]
    alone = unfused_from(n_prims) if xla_chunks else n_prims
    for start in range(0, n_prims, PRIM_CHUNK):
        end = min(start + PRIM_CHUNK, n_prims)
        t = _sphere_candidates(p, d, center.x[start:end], center.y[start:end],
                               center.z[start:end], radius_sq[start:end],
                               fuse_bb=start < alone)
        chunk_best, first = _closest_epilogue(t)
        closer = chunk_best < best_t
        best_id = torch.where(closer, first + start, best_id)
        best_t = torch.where(closer, chunk_best, best_t)
    return best_t, best_id


def sphere_occluded_pairs(px, py, pz, dx, dy, dz, tfar, cx, cy, cz, r_sq):
    """Occlusion bits of rays against spheres (the arguments broadcast): the
    selected root lies in [0, tfar), tested sqrt-free (sign tests and square
    comparisons, ops/intersect.py:178-205 of the JAX package). tfar <= 0
    never occludes. b*b has three uses here, so XLA leaves it unfused in
    disc."""
    tx = cx - px
    ty = cy - py
    tz = cz - pz
    b = fp.dot3(dx, dy, dz, tx, ty, tz)
    bb = b * b
    disc = r_sq - fp.dot3(tx, ty, tz, tx, ty, tz) + bb
    e = b - tfar
    q = e * e
    near_ge0 = (b >= 0.0) & (bb >= disc)
    hit_near = (e < 0.0) | (q < disc)
    far_ge0 = (b >= 0.0) | (bb <= disc)
    hit_far = (e < 0.0) & (disc < q)
    return (disc >= 0.0) & torch.where(near_ge0, hit_near, far_ge0 & hit_far)


def _sphere_occluded_pairs(p: Vec3, d: Vec3, tfar, cx, cy, cz, r_sq):
    """[R, C] occlusion bits of rays [R] against spheres [C]."""
    return sphere_occluded_pairs(
        p.x[:, None], p.y[:, None], p.z[:, None], d.x[:, None], d.y[:, None],
        d.z[:, None], tfar[:, None], cx[None, :], cy[None, :], cz[None, :],
        r_sq[None, :])


def occluded_spheres(p: Vec3, d: Vec3, tfar, center: Vec3, radius_sq):
    """Any-hit shadow test: True where a sphere lies at t in [0, tfar)."""
    occ = torch.zeros(p.x.shape[0], dtype=torch.bool, device=p.x.device)
    for start in range(0, radius_sq.shape[0], PRIM_CHUNK):
        end = min(start + PRIM_CHUNK, radius_sq.shape[0])
        pairs = _sphere_occluded_pairs(
            p, d, tfar, center.x[start:end], center.y[start:end],
            center.z[start:end], radius_sq[start:end])
        occ = occ | pairs.any(dim=1)
    return occ


# ---------------------------------------------------------------------------
# Kernel build and binding
# ---------------------------------------------------------------------------
def _bind(lib: ctypes.CDLL):
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.sphere_closest.argtypes = [ptr] * 10 + [i32] * 4 + [ptr] * 3
    lib.sphere_closest.restype = i32
    lib.sphere_occluded.argtypes = [ptr] * 11 + [i32] * 3 + [ptr] * 2
    lib.sphere_occluded.restype = i32


LIBRARY = build.Library("sphere_battery.cu", build.nvcc, build.NVCC_FLAGS,
                        _bind)


def _check_inputs(name, device, n, rays, prims):
    if device.type != "cuda":
        raise ValueError(f"{name}: tensors on {device}, need cuda or cpu")
    for what, arrays, length in (("ray", rays, n), ("sphere", prims, None)):
        for a in arrays:
            if (a.device != device or a.dtype != torch.float32 or a.dim() != 1
                    or not a.is_contiguous()
                    or (length is not None and a.shape[0] != length)):
                raise ValueError(
                    f"{name}: {what} arrays must be contiguous 1-D float32 on "
                    f"{device} of one length; got {a.dtype} {tuple(a.shape)} "
                    f"{a.device} contiguous={a.is_contiguous()}")
    if len({a.shape[0] for a in prims}) != 1:
        raise ValueError(f"{name}: sphere arrays differ in length")
    if n >= 2 ** 31 or prims[0].shape[0] >= 2 ** 31:
        raise ValueError(f"{name}: more than 2^31 rays or spheres")


def closest_hit(p: Vec3, d: Vec3, center: Vec3, radius_sq, xla_chunks=True):
    """Closest sphere hit per ray: (tfar [R] float32, prim [R] int32, -1 and
    FLT_MAX for a miss); `xla_chunks` as ``intersect_spheres``'s. CPU
    tensors take the plain version; CUDA tensors launch
    ``sphere_closest``."""
    device = p.x.device
    if device.type == "cpu":
        return intersect_spheres(p, d, center, radius_sq, xla_chunks)
    n = p.x.shape[0]
    prims = (center.x, center.y, center.z, radius_sq)
    _check_inputs(CLOSEST.name, device, n, (*p, *d), prims)
    lib = LIBRARY.load()
    tfar = torch.empty(n, dtype=torch.float32, device=device)
    prim = torch.empty(n, dtype=torch.int32, device=device)
    build.launch(CLOSEST.name, lib.sphere_closest, device,
                 [a.data_ptr() for a in (*p, *d, *prims)]
                 + [n, radius_sq.shape[0],
                    (unfused_from(radius_sq.shape[0]) if xla_chunks
                     else radius_sq.shape[0]),
                    build.sm_count(device.index), tfar.data_ptr(),
                    prim.data_ptr()])
    CLOSEST.launches += 1
    return tfar, prim


def any_hit(p: Vec3, d: Vec3, tfar, center: Vec3, radius_sq):
    """Whether any sphere lies at t in [0, tfar) per ray ([R] bool). CPU
    tensors take the plain version; CUDA tensors launch
    ``sphere_occluded``."""
    device = p.x.device
    if device.type == "cpu":
        return occluded_spheres(p, d, tfar, center, radius_sq)
    n = p.x.shape[0]
    prims = (center.x, center.y, center.z, radius_sq)
    _check_inputs(OCCLUDED.name, device, n, (*p, *d, tfar), prims)
    lib = LIBRARY.load()
    occ = torch.empty(n, dtype=torch.bool, device=device)
    build.launch(OCCLUDED.name, lib.sphere_occluded, device,
                 [a.data_ptr() for a in (*p, *d, tfar, *prims)]
                 + [n, radius_sq.shape[0], build.sm_count(device.index),
                    occ.data_ptr()])
    OCCLUDED.launches += 1
    return occ
