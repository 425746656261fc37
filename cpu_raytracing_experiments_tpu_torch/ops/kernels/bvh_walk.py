"""The threaded-BVH walks of ``accel='bvh'``: closest hit and any hit of a
ray batch against a BVH over spheres ([P, 4] rows) or triangles ([T, 9]
rows). Two forms each:

* the plain PyTorch version, ``bvh/traverse.py``'s
  ``traverse_closest_packed`` / ``traverse_shadow_packed``, which a tensor
  on the CPU takes and ``chip_smoke.py`` holds the kernels to on the card;
* a hand-written CUDA kernel (``csrc/bvh_walk.cu``), one thread walking one
  ray to the end. It replaces no Pallas kernel: the JAX package runs these
  walks as XLA ``lax.while_loop``s (``bvh/traverse.py:254``, ``:309``).

``closest`` and ``occluded`` launch the kernel for CUDA tensors or raise;
nothing falls back. Launches are counted in ``CLOSEST.launches`` and
``OCCLUDED.launches``.
"""
from __future__ import annotations

import ctypes

import torch

from ...bvh import traverse
from ...bvh.builder import BVHArrays
from ...core.vec import Vec3
from . import build
from .build import LaunchCounter

CLOSEST = LaunchCounter("bvh_closest")
OCCLUDED = LaunchCounter("bvh_occluded")
ROW_TESTS = {4: traverse.sphere_row_test, 9: traverse.triangle_row_test}


def _bind(lib: ctypes.CDLL):
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.bvh_closest.argtypes = [ptr] * 9 + [i32] * 2 + [ptr] * 3
    lib.bvh_closest.restype = i32
    lib.bvh_occluded.argtypes = [ptr] * 9 + [i32] * 2 + [ptr] * 2
    lib.bvh_occluded.restype = i32


LIBRARY = build.Library("bvh_walk.cu", build.nvcc, build.NVCC_FLAGS, _bind,
                        headers=("walk_common.cuh",))


def check_operands(name: str, p: Vec3, d: Vec3, lanes, rows):
    """Raise unless the rays and the [n] lane arrays (tfar; None skipped)
    are contiguous 1-D float32 of one length on one CUDA device and `rows`
    a contiguous float32 [P, 4] or [T, 9] table there."""
    device = p.x.device
    if device.type != "cuda":
        raise ValueError(f"{name}: tensors on {device}, need cuda or cpu")
    n = p.x.shape[0]
    for a in (*p, *d, *(x for x in lanes if x is not None)):
        if (a.device != device or a.dtype != torch.float32 or a.dim() != 1
                or not a.is_contiguous() or a.shape[0] != n):
            raise ValueError(
                f"{name}: ray arrays must be contiguous 1-D float32 on "
                f"{device} of one length; got {a.dtype} {tuple(a.shape)} "
                f"{a.device} contiguous={a.is_contiguous()}")
    if (rows.device != device or rows.dtype != torch.float32
            or rows.dim() != 2 or rows.shape[1] not in ROW_TESTS
            or not rows.is_contiguous()):
        raise ValueError(f"{name}: rows must be a contiguous float32 [P, 4] "
                         f"or [T, 9] table on {device}; got {rows.dtype} "
                         f"{tuple(rows.shape)} {rows.device}")
    if n >= 2 ** 31 or rows.shape[0] >= 2 ** 31:
        raise ValueError(f"{name}: more than 2^31 rays or prims")


def _args(p: Vec3, d: Vec3, lane, nodes, rows):
    return [a.data_ptr() for a in (*p, *d)] + [
        None if lane is None else lane.data_ptr(), nodes.data_ptr(),
        rows.data_ptr(), int(rows.shape[1] == 9), p.x.shape[0]]


def closest(bvh: BVHArrays, p: Vec3, d: Vec3, rows, tfar0=None):
    """(tfar [R] float32, prim [R] int32, -1 for a miss) of the closest hit
    through `bvh` over the leaf `rows`, only hits closer than `tfar0`
    counting. CPU tensors take the plain version; CUDA tensors launch
    ``bvh_closest``."""
    if p.x.device.type == "cpu":
        return traverse.traverse_closest_packed(
            bvh, p, d, rows, ROW_TESTS[rows.shape[1]], tfar0=tfar0)
    check_operands(CLOSEST.name, p, d, (tfar0,), rows)
    lib = LIBRARY.load()
    n = p.x.shape[0]
    tfar = torch.empty(n, dtype=torch.float32, device=p.x.device)
    prim = torch.empty(n, dtype=torch.int32, device=p.x.device)
    nodes = traverse.pack_nodes(bvh)
    build.launch(CLOSEST.name, lib.bvh_closest, p.x.device,
                 _args(p, d, tfar0, nodes, rows)
                 + [tfar.data_ptr(), prim.data_ptr()])
    CLOSEST.launches += 1
    return tfar, prim


def occluded(bvh: BVHArrays, p: Vec3, d: Vec3, tfar, rows):
    """Whether a prim of the leaf `rows` lies at t in [0, tfar) ([R] bool).
    CPU tensors take the plain version; CUDA tensors launch
    ``bvh_occluded``."""
    if p.x.device.type == "cpu":
        return traverse.traverse_shadow_packed(
            bvh, p, d, tfar, rows, ROW_TESTS[rows.shape[1]])
    check_operands(OCCLUDED.name, p, d, (tfar,), rows)
    lib = LIBRARY.load()
    occ = torch.empty(p.x.shape[0], dtype=torch.bool, device=p.x.device)
    nodes = traverse.pack_nodes(bvh)
    build.launch(OCCLUDED.name, lib.bvh_occluded, p.x.device,
                 _args(p, d, tfar, nodes, rows)
                 + [occ.data_ptr()])
    OCCLUDED.launches += 1
    return occ
