"""How jitted JAX rounds the closest-hit sphere battery's ``disc`` on 5-8-wide
chunks, against the PyTorch port's width rule (``core/fp.py::
xla_fuses_sphere_bb``), as a function of the CPUs the JAX process may use.

For each CPU set (one CPU, two, and all of this process's), jitted JAX runs
in a child process restricted to that set (``os.sched_setaffinity`` before
JAX is imported; ``tests/test_torch_disc_width.py::jax_bits_on_cpus``) on:

* the brute battery (``intersect_spheres``) at 1000, 3000 and 4001 rays x
  5, 6, 8 and 517 spheres (``odd_batteries``, the cases of
  ``test_one_cpu_jax_equals_rule``);
* the grid's residual battery (``traverse_grid_closest``) with 5-8 residual
  spheres (``_residual_grid``'s scene) at the same ray counts.

It prints, a case a line, the lanes where JAX differs from the port's rule
and, of those, the lanes that are not the port's fused form either (the
brute battery's ``xla_chunks=False``, in the grid's residual battery
too), then the totals of each CPU set.

    JAX_PLATFORMS=cpu python benchmarks/torch_disc_witness.py

On the CPU only (about three minutes on an 8-CPU host, most of it the
one-CPU child compiling the grid walks).
"""
from __future__ import annotations

import functools
import os
import sys
import tempfile
from pathlib import Path
from unittest import mock

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "tests")]

import torch  # noqa: E402

from cpu_raytracing_experiments_tpu_torch.bvh import (  # noqa: E402
    grid as tgrid, traverse as ttraverse)
from cpu_raytracing_experiments_tpu_torch.ops import intersect  # noqa: E402
from cpu_raytracing_experiments_tpu_torch.ops.kernels import (  # noqa: E402
    sphere_battery as sb)
from test_torch_bvh import FLT_MAX, rays, spheres, tv  # noqa: E402
from test_torch_disc_width import (  # noqa: E402
    ODD_RAYS, jax_bits_on_cpus, odd_batteries, port_battery)

GRID_K = (5, 6, 7, 8)


def grid_cases() -> dict:
    """40 small spheres and k giants that land in the residual list of a
    res-4 grid (``test_torch_disc_width.py::_residual_grid``), and seeded
    rays, every fifth seeded with tfar0 = 20."""
    cases = {}
    for n in ODD_RAYS:
        for k in GRID_K:
            c, r = spheres(40, 3)
            g = np.random.default_rng(k)
            c = np.concatenate([c, g.uniform(-10, 10, (k, 3))]).astype(
                np.float32)
            r = np.concatenate([r, g.uniform(40, 55, k)]).astype(np.float32)
            p, d = rays(n, 5, -100, 100)
            tf0 = np.full(n, FLT_MAX, np.float32)
            tf0[::5] = 20.0
            cases[f"g{n}x{k}"] = {"c": c, "r": r, "p": p, "d": d, "tf0": tf0}
    return cases


def port_grid(a: dict, fused: bool):
    """(t bits, ids) of the port's grid walk on a case of ``grid_cases``;
    with `fused`, its residual battery rounds every chunk fused."""
    c, r = a["c"], a["r"]
    grid = tgrid.build_grid(c - r[:, None], c + r[:, None], res=4,
                            max_per_cell=40)
    rows = ttraverse.pack_spheres(tv(c), torch.from_numpy(r * r))
    battery = functools.partial(sb.intersect_spheres, xla_chunks=not fused)
    with mock.patch.object(intersect, "intersect_spheres", battery):
        t, i = tgrid.traverse_grid_closest(
            grid, tv(a["p"]), tv(a["d"]), rows, ttraverse.sphere_row_test,
            tfar0=torch.from_numpy(a["tf0"]))
    return t.numpy().view(np.int32), i.numpy()


def main():
    torch.set_num_threads(1)
    cpus = sorted(os.sched_getaffinity(0))
    cases = {**odd_batteries(), **grid_cases()}
    port = {}
    for case, a in cases.items():
        if case[0] == "s":
            port[case] = (port_battery(a, True), port_battery(a, False))
        else:
            port[case] = (port_grid(a, False), port_grid(a, True))
    for cpu_set in (cpus[:1], cpus[:2], cpus):
        with tempfile.TemporaryDirectory() as tmp:
            want = jax_bits_on_cpus(cases, cpu_set, Path(tmp), timeout=900)
        totals = {"s": [0, 0, 0], "g": [0, 0, 0]}
        for case, ((rt, ri), (ft, fi)) in port.items():
            jt, ji = want[case]
            off = (rt != jt) | (ri != ji)
            neither = off & ((ft != jt) | (fi != ji))
            tot = totals[case[0]]
            tot[0] += jt.shape[0]
            tot[1] += int(off.sum())
            tot[2] += int(neither.sum())
            print(f"{len(cpu_set)} CPU(s) {case}: {int(off.sum())} lanes "
                  f"leave the rule, {int(neither.sum())} of them not the "
                  f"fused form", flush=True)
        for kind, (lanes, off, neither) in totals.items():
            name = "brute battery" if kind == "s" else "grid residual"
            print(f"{len(cpu_set)} CPU(s), {name}: {off} of {lanes} lanes "
                  f"leave the rule, {neither} neither form", flush=True)


if __name__ == "__main__":
    main()
