"""The card's form of ``core/fp.py``'s single-rounding multiply-adds, as
hand-written CUDA kernels (``csrc/fma.cu``, ``__fmaf_rn``):

* ``fma(a, b, c)``: a * b + c rounded once, elementwise with broadcasting.
  Flat operands (below) take ``flat_kernel`` (launches counted in
  ``FMA``); any other layout takes ``strided_kernel`` over up to four
  merged dimensions (``FMA_STRIDED``);
* ``contract(op, operands)``: one launch of ``flat_kernel`` for one of the
  contraction expressions that ``core/`` chains from fp.fma, each rounded
  as that chain rounds it: ``DOT3`` (``fp.dot3``), ``FMA3`` (``fp.fma3``),
  ``TO_LOCAL``, ``TO_LOCAL_XY`` and ``TO_WORLD`` (``sampling.to_local``
  with either contraction of its inner sum, ``sampling.to_world``),
  counted in ``COUNTERS[op]``. It returns None where the operands are not
  flat, and the caller then composes ``fma``.

Flat operands: every tensor operand either has one shape, the output's, and
is contiguous, or is 0-d (read by every lane from device memory, never
copied); a Python float (or a 0-d tensor on the CPU) is passed by value.
The plain versions are ``core.fp.fma_plain`` (float64 with round-to-odd)
and the compositions of it in ``core/`` (``fp.dot3_plain`` and the like),
which ``fp`` takes for tensors on the CPU and ``chip_smoke.py`` holds the
kernels to on the card. Each wrapper launches its kernel for CUDA tensors or
raises; nothing falls back.
"""
from __future__ import annotations

import ctypes

import torch

from . import build, lanes
from .build import LaunchCounter

MAX_DIMS = 4  # dimensions the strided kernel indexes, after merging
MAX_IN, MAX_OUT = 7, 3  # operands and outputs of the flat kernel
# csrc/fma.cu's enum Op
OP_FMA, DOT3, FMA3, TO_LOCAL, TO_WORLD, TO_LOCAL_XY = range(6)
ARITY = {OP_FMA: (3, 1), DOT3: (6, 1), FMA3: (7, 3), TO_LOCAL: (6, 3),
         TO_WORLD: (6, 3), TO_LOCAL_XY: (6, 3)}  # (operands, outputs)

FMA = LaunchCounter("fma")  # flat_kernel<kFma>
FMA_STRIDED = LaunchCounter("fma[strided]")
COUNTERS = {OP_FMA: FMA}
COUNTERS.update({op: LaunchCounter(f"fma[{name}]") for op, name in (
    (DOT3, "dot3"), (FMA3, "fma3"), (TO_LOCAL, "to_local"),
    (TO_WORLD, "to_world"), (TO_LOCAL_XY, "to_local_xy"))})


def _bind(lib: ctypes.CDLL):
    ptr, f32, i32, u32, i64 = (ctypes.c_void_p, ctypes.c_float, ctypes.c_int,
                               ctypes.c_uint, ctypes.c_longlong)
    lib.fma_f32.argtypes = [ptr, f32, ptr, f32, ptr, f32, ptr, ptr, i32, i64,
                            ptr, ptr]
    lib.fma_f32.restype = i32
    lib.fma_flat.argtypes = [i32, ptr, ptr, u32, i64, i64, i32, ptr]
    lib.fma_flat.restype = i32


LIBRARY = build.Library("fma.cu", build.nvcc, build.NVCC_FLAGS, _bind)

_PTRS = ctypes.c_void_p * (MAX_IN + MAX_OUT)  # operands, then outputs
_VALUES = ctypes.c_float * MAX_IN


def flat_shape(operands):
    """The output's shape where the flat kernel takes `operands`, else
    None: every tensor that is not 0-d has that one shape and is
    contiguous. With no such tensor the shape is ()."""
    shape = None
    for x in operands:
        if not isinstance(x, torch.Tensor) or x.dim() == 0:
            continue
        if shape is None:
            shape = x.shape
        elif x.shape != shape:
            return None
        if not x.is_contiguous():
            return None
    return torch.Size(()) if shape is None else shape


def _device_of(operands):
    """The first CUDA tensor among the operands; raises where an operand is
    not a float32 CUDA tensor of that device, a 0-d tensor on the CPU or a
    Python float."""
    first = None
    for x in operands:
        if not isinstance(x, torch.Tensor):
            continue
        if x.dtype is not torch.float32 or not (x.is_cuda or x.dim() == 0):
            raise ValueError(f"fma: needs float32 CUDA tensors; got "
                             f"{x.dtype} on {x.device} (the plain version "
                             "is core.fp.fma_plain)")
        if x.is_cuda:
            if first is None:
                first = x
            elif x.get_device() != first.get_device():
                raise ValueError(f"fma: tensors on {first.device} and "
                                 f"{x.device}")
    if first is None:
        raise ValueError("fma: no CUDA tensor among the operands; the plain "
                         "version is core.fp.fma_plain")
    return first


def _launch_flat(op, operands, shape, first):
    """One launch of flat_kernel, on the device of the CUDA tensor
    `first`; returns the outputs."""
    n_out = ARITY[op][1]
    n = shape.numel()
    ptrs, values, stride_one, stepped = [0] * MAX_IN, None, 0, []
    for k, x in enumerate(operands):
        if isinstance(x, torch.Tensor) and x.is_cuda:
            ptrs[k] = x.data_ptr()
            if x.dim() != 0:
                stride_one |= 1 << k
                stepped.append(ptrs[k])
        else:
            if values is None:
                values = _VALUES()
            values[k] = float(x)
    if n_out == 1:
        outs = (first.new_empty(shape),)
    else:
        outs = lanes.rows(n_out, n, first.device).unbind(0)
        if len(shape) != 1:
            outs = tuple(o.view(shape) for o in outs)
    out_ptrs = [o.data_ptr() for o in outs]
    groups = lanes.groups(n, stepped + out_ptrs)
    build.launch(COUNTERS[op], _lib().fma_flat, first.device,
                 [op, _PTRS(*ptrs, *out_ptrs), values, stride_one, n,
                  groups, build.sm_count(first.get_device())])
    return outs


_LOADED = None


def _lib():
    global _LOADED
    if _LOADED is None:
        _LOADED = LIBRARY.load()
    return _LOADED


def contract(op: int, operands):
    """Expression `op` (DOT3, FMA3, TO_LOCAL, TO_LOCAL_XY, TO_WORLD;
    OP_FMA) over its operands in one launch of the flat kernel: a tuple of
    its outputs, or None where the operands are not flat."""
    if len(operands) != ARITY[op][0]:
        raise ValueError(f"fma: op {op} takes {ARITY[op][0]} operands")
    first = _device_of(operands)
    shape = flat_shape(operands)
    if shape is None:
        return None
    return _launch_flat(op, operands, shape, first)


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


def _fma_strided(operands, first):
    """a * b + c by strided_kernel over the broadcast shape, on the device
    of the CUDA tensor `first`."""
    tensors = [x for x in operands if isinstance(x, torch.Tensor)]
    shape = torch.broadcast_shapes(*(x.shape for x in tensors))
    out = first.new_empty(shape)
    n = out.numel()
    if n == 0:
        return out
    operands = [x if isinstance(x, torch.Tensor) and x.is_cuda else
                float(x) for x in operands]
    sizes, strides = _layout(shape, operands)
    if len(sizes) > MAX_DIMS:
        raise ValueError(f"fma: {len(sizes)} dimensions after merging, the "
                         f"kernel indexes {MAX_DIMS}")
    args = []
    for x in operands:
        if isinstance(x, torch.Tensor):
            args += [x.data_ptr(), 0.0]
        else:
            args += [None, x]
    ndim = len(sizes)
    c_sizes = (ctypes.c_longlong * ndim)(*sizes)
    c_strides = (ctypes.c_longlong * (3 * ndim))(*(v for s in strides
                                                    for v in s))
    build.launch(FMA_STRIDED, _lib().fma_f32, first.device,
                 args + [c_sizes, c_strides, ndim, n, out.data_ptr()])
    return out


def fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """a * b + c rounded once to float32 on the card. `a`, `b` and `c` are
    float32 CUDA tensors of one device, 0-d tensors or Python floats, and
    broadcast. Flat operands launch ``flat_kernel``, others
    ``strided_kernel``; raises without a CUDA tensor."""
    operands = (a, b, c)
    first = _device_of(operands)
    shape = flat_shape(operands)
    if shape is None:
        return _fma_strided(operands, first)
    if shape.numel() == 0:
        return first.new_empty(shape)
    return _launch_flat(OP_FMA, operands, shape, first)[0]
