"""The threaded-BVH walks of ``accel='bvh'``: closest hit and any hit of a
ray batch against a BVH over spheres ([P, 4] rows) or triangles ([T, 9]
rows). Two forms each:

* the plain PyTorch version, ``bvh/traverse.py``'s
  ``traverse_closest_packed`` / ``traverse_shadow_packed``, which a tensor
  on the CPU takes and ``chip_smoke.py`` holds the kernels to on the card;
* a hand-written CUDA kernel (``csrc/bvh_walk.cu``): ``bvh_closest`` in
  persistent warps that take rays from a counter and step inner nodes and
  leaves in turns, the node table in shared memory where it fits, over the
  node table that ``BVHArrays`` packs once (``BVHArrays.nodes``);
  ``bvh_occluded`` one thread walking one ray to the end, a step a row of
  the child-pair table (``BVHArrays.pairs``: both children of a node in 64
  bytes), the second inner child on a shared-memory stack of
  ``BVHArrays.stack_depth`` entries (the any-hit bit does not depend on
  the order of the visits). They replace no Pallas kernel: the JAX
  package runs these walks as XLA ``lax.while_loop``s
  (``bvh/traverse.py:254``, ``:309``).

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
    lib.bvh_closest.argtypes = ([ptr] * 8 + [i32, ptr] + [i32] * 2
                                + [ptr] * 4)
    lib.bvh_closest.restype = i32
    lib.bvh_occluded.argtypes = ([ptr] * 9 + [i32, ptr] + [i32] * 2
                                 + [ptr] * 2)
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


def _table(name: str, table, shape: tuple, device):
    """A table a kernel reads (BVHArrays.nodes [N, 8] or .pairs [I, 16]),
    checked to be a contiguous, 16-byte aligned float32 table of `shape` on
    `device`."""
    if (table.device != device or table.dtype != torch.float32
            or tuple(table.shape) != shape or not table.is_contiguous()
            or table.data_ptr() % 16):
        raise ValueError(f"{name}: the BVH's table must be a contiguous, "
                         f"16-byte aligned float32 {list(shape)} table on "
                         f"{device}; got {table.dtype} {tuple(table.shape)} "
                         f"{table.device}")
    return table


def _rays(p: Vec3, d: Vec3, lane):
    return [a.data_ptr() for a in (*p, *d)] + [
        None if lane is None else lane.data_ptr()]


def closest(bvh: BVHArrays, p: Vec3, d: Vec3, rows, tfar0=None):
    """(tfar [R] float32, prim [R] int32, -1 for a miss) of the closest hit
    through `bvh` over the leaf `rows`, only hits closer than `tfar0`
    counting. CPU tensors take the plain version; CUDA tensors launch
    ``bvh_closest``."""
    if p.x.device.type == "cpu":
        return traverse.traverse_closest_packed(
            bvh, p, d, rows, ROW_TESTS[rows.shape[1]], tfar0=tfar0)
    check_operands(CLOSEST.name, p, d, (tfar0,), rows)
    nodes = _table(CLOSEST.name, bvh.nodes, (bvh.num_nodes, 8), p.x.device)
    lib = LIBRARY.load()
    n = p.x.shape[0]
    tfar = torch.empty(n, dtype=torch.float32, device=p.x.device)
    prim = torch.empty(n, dtype=torch.int32, device=p.x.device)
    next_ray = torch.empty(1, dtype=torch.int32, device=p.x.device)
    build.launch(CLOSEST, lib.bvh_closest, p.x.device,
                 _rays(p, d, tfar0) + [
                     nodes.data_ptr(), bvh.num_nodes, rows.data_ptr(),
                     int(rows.shape[1] == 9), n, next_ray.data_ptr(),
                     tfar.data_ptr(), prim.data_ptr()])
    return tfar, prim


def occluded(bvh: BVHArrays, p: Vec3, d: Vec3, tfar, rows):
    """Whether a prim of the leaf `rows` lies at t in [0, tfar) ([R] bool).
    CPU tensors take the plain version; CUDA tensors launch
    ``bvh_occluded``."""
    if p.x.device.type == "cpu":
        return traverse.traverse_shadow_packed(
            bvh, p, d, tfar, rows, ROW_TESTS[rows.shape[1]])
    check_operands(OCCLUDED.name, p, d, (tfar,), rows)
    nodes = _table(OCCLUDED.name, bvh.nodes, (bvh.num_nodes, 8),
                   p.x.device)
    pairs = _table(OCCLUDED.name, bvh.pairs, (bvh.pairs.shape[0], 16),
                   p.x.device)
    lib = LIBRARY.load()
    occ = torch.empty(p.x.shape[0], dtype=torch.bool, device=p.x.device)
    build.launch(OCCLUDED, lib.bvh_occluded, p.x.device,
                 _rays(p, d, tfar) + [
                     nodes.data_ptr(), pairs.data_ptr(), bvh.stack_depth,
                     rows.data_ptr(), int(rows.shape[1] == 9), p.x.shape[0],
                     occ.data_ptr()])
    return occ
