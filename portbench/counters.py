"""Counters the benchmark takes around calls into the program, in the
traced run only: every call of the clustered traversal's planner
(``ops/kernels/cluster_traverse.py::_plan_visits``) with its rays, the
rays that need a test, its clusters and tiles."""
from __future__ import annotations

import inspect


class PlannerCalls:
    """While entered, wraps the port's planner and records each call as a
    dict: rays, valid (lanes that are valid and have tf > 0: the rays the
    planner must test), clusters, tile, plan (the mode that ran) and
    in_kernel (whether the kernel sorts the lists itself)."""

    def __init__(self):
        self.calls = []
        self._orig = None

    def __enter__(self):
        from cpu_raytracing_experiments_tpu_torch.ops.kernels import (
            cluster_traverse as ct)

        self._ct = ct
        self._orig = orig = ct._plan_visits
        sig = inspect.signature(orig)

        def wrapped(*args, **kwargs):
            a = sig.bind(*args, **kwargs)
            a.apply_defaults()
            v = a.arguments
            cp, tf = v["cp"], v["tf"]
            mode = ct._plan_mode(cp, v["plan"])
            self.calls.append({
                "rays": int(tf.shape[0]),
                "valid": (v["valid"] & (tf > 0.0)).sum(),
                "clusters": int(cp.num_clusters), "tile": int(v["tile_r"]),
                "plan": mode,
                "in_kernel": bool(ct.plans_in_kernel(
                    cp, mode, v["sort"], v["sort_impl"], v["tile_r"]))})
            return orig(*args, **kwargs)

        ct._plan_visits = wrapped
        return self

    def __exit__(self, *exc):
        self._ct._plan_visits = self._orig
        for c in self.calls:
            c["valid"] = int(c["valid"])
        return False
