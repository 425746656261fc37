"""The uniform-grid DDA walks of ``accel='grid'``, with the dense battery
over the grid's residual prims: closest hit and any hit of a ray batch
against a grid over spheres ([P, 4] rows) or triangles ([T, 9] rows). Two
forms each:

* the plain PyTorch version, ``bvh/grid.py``'s ``traverse_grid_closest`` /
  ``traverse_grid_shadow``, which a tensor on the CPU takes and
  ``chip_smoke.py`` holds the kernels to on the card;
* hand-written CUDA kernels (``csrc/grid_walk.cu``): the walk, one thread a
  ray, and the residual battery, 4 rays a thread against tiles of the
  residual staged in shared memory, the residual split into slices across
  blocks when rays are few (``residual_split``). They replace no Pallas
  kernel: the JAX package runs these walks as XLA ``lax.while_loop``s and
  its residual as a dense XLA battery (``bvh/grid.py:100``, ``:215``,
  ``:246``).

The residual's rows are made per call: the spheres' rows gathered, or the
triangles' Baldwin-Weber planes by the plain
``ops/intersect.py::_triangle_planes`` (the dense battery's own constants).
A sphere residual's disc is rounded as the plain battery's 512-sphere
chunks round it (``sphere_battery.unfused_from``). ``closest`` and
``occluded`` launch the kernels for CUDA tensors or raise; nothing falls
back. Each call counts one launch in ``CLOSEST.launches`` or
``OCCLUDED.launches``.
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
from .sphere_battery import unfused_from

CLOSEST = LaunchCounter("grid_closest")
OCCLUDED = LaunchCounter("grid_occluded")

RAY_TILE = 512  # rays a block of the residual battery (csrc kRayTile)
ROW_TILE = 128  # residual rows a staged tile (csrc kTile)
BLOCKS_PER_SM = 16  # battery blocks a split aims at: two waves of eight
MIN_SLICE_TILES = 4  # tiles a slice takes at least


def _bind(lib: ctypes.CDLL):
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    head = [ptr] * 12 + [i32] * 2 + [ptr, i32, ptr, ptr] + [i32] * 4
    lib.grid_closest.argtypes = head + [ptr, ptr, i32] + [ptr] * 3
    lib.grid_occluded.argtypes = head + [ptr, i32] + [ptr] * 2
    lib.grid_closest.restype = lib.grid_occluded.restype = i32


LIBRARY = build.Library("grid_walk.cu", build.nvcc, build.NVCC_FLAGS, _bind,
                        headers=("walk_common.cuh",))


def residual_table(grid: UniformGrid, rows):
    """The rows the residual battery stages: the residual spheres' [Rr, 4]
    rows, or the residual triangles' [Rr, 12] Baldwin-Weber planes (n, d0,
    f1, g1, f2, g2) as the dense battery makes them; None for an empty
    residual."""
    from ..intersect import _triangle_planes

    if grid.residual.shape[0] == 0:
        return None
    r = rows[grid.residual]
    if rows.shape[1] == 4:
        return r.contiguous()
    cols = [r[:, k] for k in range(9)]
    return torch.stack(_triangle_planes(Vec3(*cols[0:3]), Vec3(*cols[3:6]),
                                        Vec3(*cols[6:9])), dim=1).contiguous()


def residual_split(n_rays: int, n_residual: int, sms: int):
    """(slices, rows a slice) of the residual battery: enough slices that
    the blocks (ray tiles x slices) reach BLOCKS_PER_SM an SM, each slice
    at least MIN_SLICE_TILES tiles of ROW_TILE rows, and no slice empty."""
    tiles = -(-n_residual // ROW_TILE)
    ray_tiles = -(-n_rays // RAY_TILE)
    want = -(-BLOCKS_PER_SM * sms // max(ray_tiles, 1))
    slices = max(1, min(want, tiles // MIN_SLICE_TILES))
    rows = -(-tiles // slices) * ROW_TILE
    return -(-n_residual // rows) if n_residual else 1, rows


def _args(grid: UniformGrid, p: Vec3, d: Vec3, lane, rows, table, split):
    for a in (grid.origin, grid.inv_cell, grid.cell_size, grid.cells,
              grid.cell_count, grid.residual):
        if a.device != p.x.device or not a.is_contiguous():
            raise ValueError(f"grid walk: the grid's tables must be "
                             f"contiguous on {p.x.device}; got {a.device}")
    rr = grid.residual.shape[0]
    return [a.data_ptr() for a in (*p, *d)] + [
        None if lane is None else lane.data_ptr(), grid.origin.data_ptr(),
        grid.inv_cell.data_ptr(), grid.cell_size.data_ptr(),
        grid.cells.data_ptr(), grid.cell_count.data_ptr(), grid.res,
        grid.max_per_cell, rows.data_ptr(), int(rows.shape[1] == 9),
        grid.residual.data_ptr(),
        None if table is None else table.data_ptr(), rr,
        unfused_from(rr) if rows.shape[1] == 4 else rr, *split]


def _split(grid: UniformGrid, p: Vec3):
    return residual_split(p.x.shape[0], grid.residual.shape[0],
                          build.sm_count(p.x.device.index))


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
    dev = p.x.device
    tfar = torch.empty(n, dtype=torch.float32, device=dev)
    prim = torch.empty(n, dtype=torch.int32, device=dev)
    split = _split(grid, p)
    part = split[0] > 1 and grid.residual.shape[0] > 0
    part_t = torch.empty((split[0], n) if part else 0, dtype=torch.float32,
                         device=dev)
    part_arg = torch.empty_like(part_t, dtype=torch.int32)
    build.launch(CLOSEST.name, lib.grid_closest, dev,
                 _args(grid, p, d, tfar0, rows, residual_table(grid, rows),
                       split)
                 + [part_t.data_ptr() if part else None,
                    part_arg.data_ptr() if part else None, n,
                    tfar.data_ptr(), prim.data_ptr()])
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
    n = p.x.shape[0]
    dev = p.x.device
    occ = torch.empty(n, dtype=torch.bool, device=dev)
    split = _split(grid, p)
    part_occ = torch.empty((split[0], n) if grid.residual.shape[0] else 0,
                           dtype=torch.uint8, device=dev)
    build.launch(OCCLUDED.name, lib.grid_occluded, dev,
                 _args(grid, p, d, tfar, rows, residual_table(grid, rows),
                       split)
                 + [part_occ.data_ptr() if part_occ.numel() else None, n,
                    occ.data_ptr()])
    OCCLUDED.launches += 1
    return occ
