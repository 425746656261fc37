"""The card's form of ``core/fp.py::fma``: a * b + c rounded once to
float32, elementwise with broadcasting, as one hand-written CUDA kernel
(``csrc/fma.cu``, ``__fmaf_rn``). Its plain version is
``core.fp.fma_plain`` (float64 with round-to-odd), which ``fp.fma`` takes
for tensors on the CPU and ``chip_smoke.py`` holds the kernel to on the
card. ``fma`` launches the kernel for CUDA tensors or raises; nothing falls
back. Launches are counted in ``FMA.launches``.
"""
from __future__ import annotations

import ctypes

import torch

from . import build
from .build import LaunchCounter

FMA = LaunchCounter("fma")
MAX_DIMS = 4  # dimensions the kernel indexes, after merging


def _bind(lib: ctypes.CDLL):
    ptr, f32, i32, i64 = (ctypes.c_void_p, ctypes.c_float, ctypes.c_int,
                          ctypes.c_longlong)
    lib.fma_f32.argtypes = [ptr, f32, ptr, f32, ptr, f32, ptr, ptr, i32, i64,
                            ptr, ptr]
    lib.fma_f32.restype = i32


LIBRARY = build.Library("fma.cu", build.nvcc, build.NVCC_FLAGS, _bind)


def _layout(shape, operands):
    """(sizes, strides of each operand) over `shape`: broadcast dimensions
    and scalars at stride 0, dimensions of size 1 dropped, and adjacent
    dimensions merged wherever every operand steps through them as one. The
    common call, contiguous tensors of the output's shape and scalars, is
    one dimension."""
    n = 1
    for size in shape:
        n *= size
    if all(not isinstance(x, torch.Tensor)
           or (x.numel() == n and x.is_contiguous()) for x in operands):
        return [n], [[1 if isinstance(x, torch.Tensor) else 0]
                     for x in operands]
    ndim = len(shape)
    strides = []
    for x in operands:
        if not isinstance(x, torch.Tensor):
            strides.append([0] * ndim)
            continue
        pad = ndim - x.dim()
        strides.append([0 if d < pad or x.shape[d - pad] == 1
                        else x.stride(d - pad) for d in range(ndim)])
    keep = [d for d in range(ndim) if shape[d] != 1]
    sizes = [shape[d] for d in keep]
    strides = [[s[d] for d in keep] for s in strides]
    d = len(sizes) - 1
    while d > 0:  # merge dimension d into d - 1
        if all(s[d - 1] == s[d] * sizes[d] for s in strides):
            sizes[d - 1] *= sizes[d]
            del sizes[d]
            for s in strides:
                s[d - 1] = s[d]
                del s[d]
        d -= 1
    return sizes or [1], [s or [0] for s in strides]


def fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """a * b + c rounded once to float32 on the card. `a` is a float32 CUDA
    tensor; `b` and `c` are float32 tensors on its device or Python floats;
    the three broadcast. Launches ``fma_f32`` or raises."""
    device = a.device
    if device.type != "cuda":
        raise ValueError(f"fma: tensor on {device}; the plain version is "
                         "core.fp.fma_plain")
    operands = (a, b, c)
    tensors = [x for x in operands if isinstance(x, torch.Tensor)]
    for x in tensors:
        if x.device != device or x.dtype != torch.float32:
            raise ValueError(f"fma: needs float32 tensors on {device}; got "
                             f"{x.dtype} on {x.device}")
    shape = torch.broadcast_shapes(*(x.shape for x in tensors))
    out = torch.empty(shape, dtype=torch.float32, device=device)
    n = out.numel()
    if n == 0:
        return out
    sizes, strides = _layout(shape, operands)
    if len(sizes) > MAX_DIMS:
        raise ValueError(f"fma: {len(sizes)} dimensions after merging, the "
                         f"kernel indexes {MAX_DIMS}")
    args = []
    for x in operands:
        if isinstance(x, torch.Tensor):
            args += [x.data_ptr(), 0.0]
        else:
            args += [None, float(x)]
    ndim = len(sizes)
    c_sizes = (ctypes.c_longlong * ndim)(*sizes)
    c_strides = (ctypes.c_longlong * (3 * ndim))(*(v for s in strides
                                                    for v in s))
    build.launch(FMA.name, LIBRARY.load().fma_f32, device,
                 args + [c_sizes, c_strides, ndim, n, out.data_ptr()])
    FMA.launches += 1
    return out
