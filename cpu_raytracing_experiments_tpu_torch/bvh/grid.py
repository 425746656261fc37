"""Uniform-grid acceleration with 3-D DDA stepping, the port of the JAX
package's ``bvh/grid.py``: the host build and the plain PyTorch walks of
``accel='grid'``.

Cells store up to K primitive ids (host-built); a cell's overflow, and any
prim that spans more than res^2 cells, goes to a global residual list that
is tested densely. A ray is clipped to the grid's box, enters the cell of
its entry point and steps cell to cell (Amanatides-Woo); the closest form
stops once its best hit lies before the cell's exit, the any-hit form at
its first hit or past tfar.

The JAX package runs the walk as a lock-step ``lax.while_loop``; the loop
here steps only the rays still walking (one host read a step), which gives
every lane the lock-step loop's bits. These forms are what a tensor on the
CPU takes, and the reference the kernels of ``ops/kernels/grid_walk.py`` are
held to on the card.

Rounding and conversions as XLA's CPU code has them: the entry point
p + d * start and the next boundary origin + c * cell_size are single
multiply-adds; a float cell coordinate converts to int32 truncating,
saturating, with NaN to 0 (XLA's convert; PyTorch's CPU cast is undefined
outside int32's range, so the coordinate is clamped to [-1, res] in float
first, which gives the same cell after the clip to [0, res - 1]).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from ..core import fp
from ..core.vec import Vec3

FLT_MAX = 3.4028234663852886e38
BIG = 1e30  # tmax / tdelta of an axis the ray does not move along


@dataclasses.dataclass
class UniformGrid:
    origin: torch.Tensor  # [3] float32 world-space min corner
    inv_cell: torch.Tensor  # [3] float32 1 / cell_size
    cell_size: torch.Tensor  # [3] float32
    cells: torch.Tensor  # [G^3, K] int32 prim ids, -1 padded
    cell_count: torch.Tensor  # [G^3] int32
    residual: torch.Tensor  # [Rr] int32 prim ids tested densely
    res: int = 32
    max_per_cell: int = 16

    def to(self, device) -> "UniformGrid":
        return dataclasses.replace(
            self, origin=self.origin.to(device),
            inv_cell=self.inv_cell.to(device),
            cell_size=self.cell_size.to(device), cells=self.cells.to(device),
            cell_count=self.cell_count.to(device),
            residual=self.residual.to(device))

    ARRAYS = (("origin", np.float32), ("inv_cell", np.float32),
              ("cell_size", np.float32), ("cells", np.int32),
              ("cell_count", np.int32), ("residual", np.int32))

    @staticmethod
    def from_numpy(arrays: dict, device=None) -> "UniformGrid":
        """From ``to_numpy``'s layout: the arrays of ``ARRAYS`` by name and
        the ints ``res`` and ``max_per_cell``. Values are taken bit for
        bit."""
        return UniformGrid(
            *(torch.from_numpy(np.array(arrays[k], dtype=t, order="C")
                               ).to(device) for k, t in UniformGrid.ARRAYS),
            res=int(arrays["res"]), max_per_cell=int(arrays["max_per_cell"]))

    def to_numpy(self) -> dict:
        """The flat-array layout ``from_numpy`` reads."""
        out = {k: getattr(self, k).cpu().numpy() for k, _ in self.ARRAYS}
        return dict(out, res=self.res, max_per_cell=self.max_per_cell)


def build_grid(mins: np.ndarray, maxs: np.ndarray, res: int = 32,
               max_per_cell: int = 16, device=None) -> UniformGrid:
    """Host-side grid build from primitive AABBs (float64, as the JAX
    package builds it). Prims overlapping several cells are replicated;
    a cell's overflow beyond max_per_cell, and every prim spanning more than
    res^2 cells, goes to the sorted residual list."""
    mins = np.asarray(mins, np.float64)
    maxs = np.asarray(maxs, np.float64)
    lo = mins.min(axis=0) - 1e-4
    hi = maxs.max(axis=0) + 1e-4
    size = np.maximum(hi - lo, 1e-6)
    cell = size / res
    inv = 1.0 / cell
    n = mins.shape[0]
    cells = [[] for _ in range(res ** 3)]
    residual = set()
    c0 = np.clip(((mins - lo) * inv).astype(np.int64), 0, res - 1)
    c1 = np.clip(((maxs - lo) * inv).astype(np.int64), 0, res - 1)
    span = (c1 - c0 + 1).prod(axis=1)
    for i in range(n):
        if span[i] > res * res:  # a giant prim: test it densely
            residual.add(i)
            continue
        x0, y0, z0 = c0[i]
        x1, y1, z1 = c1[i]
        for cx in range(x0, x1 + 1):
            for cy in range(y0, y1 + 1):
                for cz in range(z0, z1 + 1):
                    idx = (cx * res + cy) * res + cz
                    if len(cells[idx]) < max_per_cell:
                        cells[idx].append(i)
                    else:
                        residual.add(i)
    table = np.full((res ** 3, max_per_cell), -1, np.int32)
    count = np.zeros(res ** 3, np.int32)
    for idx, lst in enumerate(cells):
        count[idx] = len(lst)
        table[idx, :len(lst)] = lst
    residual = np.asarray(sorted(residual), np.int32)

    def t(a, dtype):
        return torch.from_numpy(np.asarray(a, dtype)).to(device)

    return UniformGrid(origin=t(lo, np.float32), inv_cell=t(inv, np.float32),
                       cell_size=t(cell, np.float32),
                       cells=t(table, np.int32), cell_count=t(count, np.int32),
                       residual=t(residual, np.int32), res=res,
                       max_per_cell=max_per_cell)


def _axis_range(po, do, lo, hi):
    dinv = torch.reciprocal(do)
    t0 = (lo - po) * dinv
    t1 = (hi - po) * dinv
    return torch.minimum(t0, t1), torch.maximum(t0, t1)


def _cell_index(x, res: int):
    """int32 of float `x` truncated as XLA converts (saturating, NaN to 0),
    clipped to [0, res - 1]."""
    x = torch.where(torch.isnan(x), 0.0, x).clamp(-1.0, float(res))
    return x.to(torch.int32).clamp(0, res - 1)


def _setup(grid: UniformGrid, p: Vec3, d: Vec3, tfar=None):
    """The DDA's start: (inside [R], cell coordinates, steps, tmax, tdelta);
    with `tfar` (the any-hit form) the exit is capped at tfar and lanes
    with tfar <= 0 start outside."""
    res = grid.res
    o, csize, inv = grid.origin, grid.cell_size, grid.inv_cell
    ranges = [_axis_range(pc, dc, o[k], fp.fma(csize[k], float(res), o[k]))
              for k, (pc, dc) in enumerate(zip(p, d))]
    (t0x, t1x), (t0y, t1y), (t0z, t1z) = ranges
    t_enter = torch.maximum(torch.maximum(t0x, t0y),
                            torch.clamp_min(t0z, 0.0))
    t_exit = torch.minimum(torch.minimum(t1x, t1y), t1z)
    if tfar is None:
        inside = t_enter <= t_exit
    else:
        inside = (t_enter <= torch.minimum(t_exit, tfar)) & (tfar > 0.0)
    start = t_enter + 1e-5
    cell, step, tmax, tdelta = [], [], [], []
    for k, (pc, dc) in enumerate(zip(p, d)):
        c = _cell_index((fp.fma(dc, start, pc) - o[k]) * inv[k], res)
        s = torch.where(dc >= 0, 1, -1).to(torch.int32)
        nb = fp.fma((c + (s > 0).to(torch.int32)).to(torch.float32),
                    csize[k], o[k])
        moving = dc != 0
        cell.append(c)
        step.append(s)
        tmax.append(torch.where(moving, torch.div(nb - pc, dc), BIG))
        tdelta.append(torch.where(moving, torch.abs(torch.div(csize[k], dc)),
                                  BIG))
    return inside, cell, step, tmax, tdelta


def _walk(grid: UniformGrid, p: Vec3, d: Vec3, leaf_rows, leaf_row_test,
          tfar, shadow: bool, counts=None):
    """The DDA over the lanes of `inside`, one cell a trip. Closest: returns
    (tfar, prim_id); any hit: (occluded, None). A `counts` dict gains the
    cell visits ("cells") and prim tests ("tests") of all rays."""
    res = grid.res
    n = p.x.shape[0]
    dev = p.x.device
    inside, cell, step, tmax, tdelta = _setup(
        grid, p, d, tfar if shadow else None)
    prim_id = torch.full((n,), -1, dtype=torch.int32, device=dev)
    occluded = torch.zeros(n, dtype=torch.bool, device=dev)
    idx = torch.nonzero(inside)[:, 0]
    state = [a[idx] for a in (*cell, *tmax)]
    while idx.numel():
        cx, cy, cz, tx, ty, tz = state
        ps, ds = (Vec3(*(c[idx] for c in v)) for v in (p, d))
        tf = tfar[idx]
        pid = prim_id[idx]
        flat = ((cx * res + cy) * res + cz).clamp(0, res ** 3 - 1)
        ids = grid.cells[flat]
        count = grid.cell_count[flat]
        found = torch.zeros(idx.shape[0], dtype=torch.bool, device=dev)
        if counts is not None:
            counts["cells"] = counts.get("cells", 0) + idx.numel()
            counts["tests"] = counts.get("tests", 0) + int(
                (ids >= 0).sum())
        for k in range(grid.max_per_cell):
            prim = ids[:, k]
            valid = (k < count) & (prim >= 0)
            t, ok = leaf_row_test(leaf_rows[torch.clamp_min(prim, 0)], ps, ds)
            if shadow:
                found = found | (valid & ok & (t < tf) & (t >= 0.0))
            else:
                closer = valid & ok & (t < tf)
                tf = torch.where(closer, t, tf)
                pid = torch.where(closer, prim, pid)
        t_cell_exit = torch.minimum(torch.minimum(tx, ty), tz)
        if shadow:
            stop = found | (t_cell_exit > tf)
            occluded[idx] = found
        else:
            stop = (pid >= 0) & (tf <= t_cell_exit + 1e-6)
            tfar[idx] = tf
            prim_id[idx] = pid
        use_x = (tx <= ty) & (tx <= tz)
        use_y = ~use_x & (ty <= tz)
        use_z = ~use_x & ~use_y
        stepped = []
        for c, t_, use, k in ((cx, tx, use_x, 0), (cy, ty, use_y, 1),
                              (cz, tz, use_z, 2)):
            stepped.append((torch.where(use, c + step[k][idx], c),
                            torch.where(use, t_ + tdelta[k][idx], t_)))
        (cx, tx), (cy, ty), (cz, tz) = stepped
        out = ((cx < 0) | (cx >= res) | (cy < 0) | (cy >= res) | (cz < 0)
               | (cz >= res))
        keep = ~out & ~stop
        idx = idx[keep]
        state = [a[keep] for a in (cx, cy, cz, tx, ty, tz)]
    if shadow:
        return occluded, None
    return tfar, prim_id


def traverse_grid_closest(grid: UniformGrid, p: Vec3, d: Vec3, leaf_rows,
                          leaf_row_test: Callable, tfar0=None, counts=None):
    """Amanatides-Woo 3-D DDA over the grid: (tfar, prim_id), then the
    residual prims densely (``_battery_closest``), a residual hit replacing
    the walk's where strictly closer. A `counts` dict gains the cell visits,
    the prim tests and the (ray, residual prim) pairs."""
    n = p.x.shape[0]
    tfar = (torch.full((n,), FLT_MAX, dtype=torch.float32, device=p.x.device)
            if tfar0 is None else tfar0.clone())
    tfar, prim_id = _walk(grid, p, d, leaf_rows, leaf_row_test, tfar,
                          shadow=False, counts=counts)
    if counts is not None:
        counts["residual_pairs"] = n * grid.residual.shape[0]
    if grid.residual.shape[0] > 0:
        t_res, idx_res = _battery_closest(leaf_rows[grid.residual], p, d,
                                          leaf_row_test)
        closer = (idx_res >= 0) & (t_res < tfar)
        tfar = torch.where(closer, t_res, tfar)
        prim_id = torch.where(
            closer, grid.residual[torch.clamp_min(idx_res, 0)], prim_id)
    return tfar, prim_id


def _battery_closest(rows, p: Vec3, d: Vec3, leaf_row_test=None):
    """Dense closest hit over packed prim rows [K, F] (F = 4 spheres, 9
    triangles): (t [R], local index [R] or -1), with the candidate formulas
    of the dense batteries (``ops/intersect.py``), 512 prims a chunk, the
    first index of the least t."""
    from ..ops import intersect as _i

    cols = [rows[:, k].contiguous() for k in range(rows.shape[1])]
    if rows.shape[1] == 4:
        best_t, best_i = _i.intersect_spheres(p, d, Vec3(*cols[:3]), cols[3])
    else:
        best_t, best_i = _i.intersect_triangles(
            p, d, Vec3(*cols[0:3]), Vec3(*cols[3:6]), Vec3(*cols[6:9]))
    return best_t, torch.where(best_t < FLT_MAX, best_i, -1)


def traverse_grid_shadow(grid: UniformGrid, p: Vec3, d: Vec3, tfar, leaf_rows,
                         leaf_row_test: Callable, counts=None):
    """Any-hit DDA: occluded [R], a prim with t in [0, tfar). The residual
    prims are tested first, and a lane they occlude does not walk. A
    `counts` dict gains the cell visits and the prim tests (the residual's
    pairs are the caller's to count: the kernel stops at a lane's first
    occluder, the plain battery here does not)."""
    occluded = torch.zeros(p.x.shape[0], dtype=torch.bool, device=p.x.device)
    if grid.residual.shape[0] > 0:
        t_res, idx_res = _battery_closest(leaf_rows[grid.residual], p, d,
                                          leaf_row_test)
        occluded = (idx_res >= 0) & (t_res < tfar) & (t_res >= 0.0)
    walk_tfar = torch.where(occluded, 0.0, tfar)
    occ, _ = _walk(grid, p, d, leaf_rows, leaf_row_test, walk_tfar,
                   shadow=True, counts=counts)
    return occluded | occ
