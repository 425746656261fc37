"""ctypes binding to the port's host-side C++ (``csrc/bvh_builder.cpp``), the
counterpart of the JAX package's ``utils/native.py``. The library is built
with g++ at first use (``ops/kernels/build.py``); without a C++ compiler
``bvh_build`` raises.
"""
from __future__ import annotations

import ctypes
import numpy as np

from ..ops.kernels import build


def _bind(lib: ctypes.CDLL):
    f32p = ctypes.POINTER(ctypes.c_float)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    lib.bvh_build.restype = ctypes.c_int32
    lib.bvh_build.argtypes = [
        f32p, f32p, ctypes.c_uint32,  # mins, maxs, n
        f32p, f32p, u32p, u32p, u32p,  # node_min/max/first/count, prim_order
        ctypes.c_uint32, ctypes.c_float,  # max_nodes, cost_ratio
        ctypes.c_uint32, ctypes.c_uint32,  # log_cluster_size, leaf_size
    ]


LIBRARY = build.Library("bvh_builder.cpp", build.gxx, build.GXX_FLAGS, _bind)


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def bvh_build(mins: np.ndarray, maxs: np.ndarray, cost_ratio: float = 1.0,
              log_cluster_size: int = 0, leaf_size: int = 1) -> tuple:
    """Native full-sweep SAH build: (node_min, node_max, node_first,
    node_count, prim_order)."""
    lib = LIBRARY.load()
    mins = np.ascontiguousarray(mins, np.float32)
    maxs = np.ascontiguousarray(maxs, np.float32)
    n = mins.shape[0]
    max_nodes = 2 * n + 2
    node_min = np.empty((max_nodes, 3), np.float32)
    node_max = np.empty((max_nodes, 3), np.float32)
    node_first = np.empty(max_nodes, np.uint32)
    node_count = np.empty(max_nodes, np.uint32)
    prim_order = np.empty(n, np.uint32)
    f32, u32 = ctypes.c_float, ctypes.c_uint32
    written = lib.bvh_build(
        _ptr(mins, f32), _ptr(maxs, f32), n, _ptr(node_min, f32),
        _ptr(node_max, f32), _ptr(node_first, u32), _ptr(node_count, u32),
        _ptr(prim_order, u32), max_nodes, cost_ratio, log_cluster_size,
        leaf_size)
    if written < 0:
        raise RuntimeError("bvh_build: node buffer too small")
    return (node_min[:written].copy(), node_max[:written].copy(),
            node_first[:written].copy(), node_count[:written].copy(),
            prim_order)
