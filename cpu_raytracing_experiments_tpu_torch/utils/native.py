"""ctypes bindings to the port's host-side C++, the counterpart of the JAX
package's ``utils/native.py``: the SAH tree builder
(``csrc/bvh_builder.cpp``) and the Radiance RGBE codec (``csrc/rgbe.cpp``).
Each library is built with g++ at first use (``ops/kernels/build.py``);
without a C++ compiler ``bvh_build``, ``rgbe_encode`` and ``rgbe_decode``
raise.
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


def _bind_rgbe(lib: ctypes.CDLL):
    f32p = ctypes.POINTER(ctypes.c_float)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.rgbe_encode.restype = None
    lib.rgbe_encode.argtypes = [f32p, u8p, ctypes.c_size_t]
    lib.rgbe_decode.restype = None
    lib.rgbe_decode.argtypes = [u8p, f32p, ctypes.c_size_t]


LIBRARY = build.Library("bvh_builder.cpp", build.gxx, build.GXX_FLAGS, _bind)
RGBE = build.Library("rgbe.cpp", build.gxx, build.GXX_FLAGS, _bind_rgbe)


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


def rgbe_encode(rgb: np.ndarray) -> np.ndarray:
    """float32 [H, W, 3] linear radiance -> uint8 [H, W, 4] RGBE."""
    lib = RGBE.load()
    rgb = np.ascontiguousarray(rgb, np.float32)
    if rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(f"rgbe_encode takes [H, W, 3], not {rgb.shape}")
    out = np.empty((*rgb.shape[:2], 4), np.uint8)
    lib.rgbe_encode(_ptr(rgb, ctypes.c_float), _ptr(out, ctypes.c_uint8),
                    rgb.shape[0] * rgb.shape[1])
    return out


def rgbe_decode(rgbe: np.ndarray) -> np.ndarray:
    """uint8 [H, W, 4] RGBE -> float32 [H, W, 3]."""
    lib = RGBE.load()
    rgbe = np.ascontiguousarray(rgbe, np.uint8)
    if rgbe.ndim != 3 or rgbe.shape[2] != 4:
        raise ValueError(f"rgbe_decode takes [H, W, 4], not {rgbe.shape}")
    out = np.empty((*rgbe.shape[:2], 3), np.float32)
    lib.rgbe_decode(_ptr(rgbe, ctypes.c_uint8), _ptr(out, ctypes.c_float),
                    rgbe.shape[0] * rgbe.shape[1])
    return out
