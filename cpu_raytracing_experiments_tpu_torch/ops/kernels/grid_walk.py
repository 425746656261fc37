"""The uniform-grid DDA walks of ``accel='grid'``, with the dense battery
over the grid's residual prims: closest hit and any hit of a ray batch
against a grid over spheres ([P, 4] rows) or triangles ([T, 9] rows). Two
forms each:

* the plain PyTorch version, ``bvh/grid.py``'s ``traverse_grid_closest`` /
  ``traverse_grid_shadow``, which a tensor on the CPU takes and
  ``chip_smoke.py`` holds the kernels to on the card;
* a hand-written CUDA kernel (``csrc/grid_walk.cu``), one thread walking
  one ray, residual battery included. It replaces no Pallas kernel: the JAX
  package runs these walks as XLA ``lax.while_loop``s and its residual as a
  dense XLA battery (``bvh/grid.py:100``, ``:215``, ``:246``).

The residual triangles' Baldwin-Weber planes are made per call by the plain
``ops/intersect.py::_triangle_planes`` (the dense battery's own constants)
and handed to the kernel. ``closest`` and ``occluded`` launch the kernel for
CUDA tensors or raise; nothing falls back. Launches are counted in
``CLOSEST.launches`` and ``OCCLUDED.launches``.
"""
from __future__ import annotations

import ctypes

import torch

from ...bvh import grid as grid_mod
from ...bvh.grid import UniformGrid
from ...core.vec import Vec3
from . import build
from .build import LaunchCounter
from .bvh_walk import ROW_TESTS, check_operands

CLOSEST = LaunchCounter("grid_closest")
OCCLUDED = LaunchCounter("grid_occluded")


def _bind(lib: ctypes.CDLL):
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for fn, outs in ((lib.grid_closest, 3), (lib.grid_occluded, 2)):
        fn.argtypes = ([ptr] * 12 + [i32] * 2 + [ptr] + [i32] + [ptr] * 2
                       + [i32] * 2 + [ptr] * outs)
        fn.restype = i32


LIBRARY = build.Library("grid_walk.cu", build.nvcc, build.NVCC_FLAGS, _bind,
                        headers=("walk_common.cuh",))


def residual_planes(grid: UniformGrid, rows):
    """[Rr, 12] Baldwin-Weber planes (n, d0, f1, g1, f2, g2) of the residual
    triangles, as the dense battery makes them; None for spheres or an
    empty residual."""
    from ..intersect import _triangle_planes

    if rows.shape[1] != 9 or grid.residual.shape[0] == 0:
        return None
    r = rows[grid.residual]
    cols = [r[:, k] for k in range(9)]
    return torch.stack(_triangle_planes(Vec3(*cols[0:3]), Vec3(*cols[3:6]),
                                        Vec3(*cols[6:9])), dim=1).contiguous()


def _args(grid: UniformGrid, p: Vec3, d: Vec3, lane, rows, planes):
    for a in (grid.origin, grid.inv_cell, grid.cell_size, grid.cells,
              grid.cell_count, grid.residual):
        if a.device != p.x.device or not a.is_contiguous():
            raise ValueError(f"grid walk: the grid's tables must be "
                             f"contiguous on {p.x.device}; got {a.device}")
    return [a.data_ptr() for a in (*p, *d)] + [
        None if lane is None else lane.data_ptr(), grid.origin.data_ptr(),
        grid.inv_cell.data_ptr(), grid.cell_size.data_ptr(),
        grid.cells.data_ptr(), grid.cell_count.data_ptr(), grid.res,
        grid.max_per_cell, rows.data_ptr(), int(rows.shape[1] == 9),
        grid.residual.data_ptr(),
        None if planes is None else planes.data_ptr(),
        grid.residual.shape[0], p.x.shape[0]]


def closest(grid: UniformGrid, p: Vec3, d: Vec3, rows, tfar0=None):
    """(tfar [R] float32, prim [R] int32, -1 for a miss): the DDA walk's
    closest hit over the leaf `rows`, then the residual's where strictly
    closer; only hits closer than `tfar0` count. CPU tensors take the plain
    version; CUDA tensors launch ``grid_closest``."""
    if p.x.device.type == "cpu":
        return grid_mod.traverse_grid_closest(
            grid, p, d, rows, ROW_TESTS[rows.shape[1]], tfar0=tfar0)
    check_operands(CLOSEST.name, p, d, (tfar0,), rows)
    lib = LIBRARY.load()
    n = p.x.shape[0]
    tfar = torch.empty(n, dtype=torch.float32, device=p.x.device)
    prim = torch.empty(n, dtype=torch.int32, device=p.x.device)
    planes = residual_planes(grid, rows)
    build.launch(CLOSEST.name, lib.grid_closest, p.x.device,
                 _args(grid, p, d, tfar0, rows, planes)
                 + [tfar.data_ptr(), prim.data_ptr()])
    CLOSEST.launches += 1
    return tfar, prim


def occluded(grid: UniformGrid, p: Vec3, d: Vec3, tfar, rows):
    """Whether a prim of the leaf `rows` lies at t in [0, tfar) ([R] bool):
    the residual first, then the DDA walk. CPU tensors take the plain
    version; CUDA tensors launch ``grid_occluded``."""
    if p.x.device.type == "cpu":
        return grid_mod.traverse_grid_shadow(grid, p, d, tfar, rows,
                                             ROW_TESTS[rows.shape[1]])
    check_operands(OCCLUDED.name, p, d, (tfar,), rows)
    lib = LIBRARY.load()
    occ = torch.empty(p.x.shape[0], dtype=torch.bool, device=p.x.device)
    planes = residual_planes(grid, rows)
    build.launch(OCCLUDED.name, lib.grid_occluded, p.x.device,
                 _args(grid, p, d, tfar, rows, planes) + [occ.data_ptr()])
    OCCLUDED.launches += 1
    return occ
