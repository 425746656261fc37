"""One site of the counter RNG in one launch: the card's form of
``core/rng.py::site_draws`` (``csrc/rng.cu``).

A site is the lane counter (seed + offset), the site state
(``hash_2d(accumulation, counter)``, then ``hash_u32`` under `scramble`) and
n sequential unit draws, with the stratified camera jitter in rows 0 and 1
under `jitter`. The kernel computes it in registers and writes the n float32
rows (and the final state where asked), bit for bit the plain version's
(``core/rng.py::site_draws_plain``, which the CPU takes). It replaces no
Pallas kernel: the JAX package leaves these sites to XLA's fusion.

The form follows the operands: the accumulation is an int or an int64 [R]
tensor, one a lane; the offset an int or an int32 [R] tensor. ``site_draws``
launches the kernel for CUDA tensors or raises; nothing falls back. Its
launches are counted in ``SITE``.
"""
from __future__ import annotations

import ctypes
import operator

import torch

from . import build, lanes
from .build import LaunchCounter

SITE = LaunchCounter("rng_site")
MAX_DRAWS = 5  # csrc/rng.cu's kMaxDraws
MASK = 0xFFFFFFFF


def _bind(lib: ctypes.CDLL):
    ptr, i32, u32, i64 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_uint,
                          ctypes.c_longlong)
    lib.rng_site.argtypes = [ptr, ptr, u32, ptr, u32, i32, i32, i32, ptr,
                             i64, ptr, i64, i64, i32, ptr]
    lib.rng_site.restype = i32


LIBRARY = build.Library("rng.cu", build.nvcc, build.NVCC_FLAGS, _bind,
                        headers=("lanes.cuh",))


def _operand(x, name, dtype, seeds):
    """(pointer, value) of the accumulation or offset `x`: (0, x mod 2^32)
    for an int, (data_ptr, 0) for a contiguous `dtype` tensor of the
    seeds' shape and device; raises otherwise."""
    if not isinstance(x, torch.Tensor):
        return 0, operator.index(x) & MASK
    if (x.dtype != dtype or x.device != seeds.device
            or x.shape != seeds.shape or not x.is_contiguous()):
        raise ValueError(
            f"site_draws: {name} must be an int or a contiguous {dtype} "
            f"tensor of the seeds' shape {tuple(seeds.shape)} on "
            f"{seeds.device}; got {x.dtype} {tuple(x.shape)} on {x.device}")
    return x.data_ptr(), 0


def site_draws(accumulation, seeds: torch.Tensor, offset, n: int,
               scramble: bool, want_state: bool = False,
               jitter: bool = False):
    """The [n, R] float32 draws of one RNG site over the u32 `seeds` (an
    int64 [R] CUDA tensor), and the final state (int64 [R]) where
    `want_state`: one launch of ``csrc/rng.cu``."""
    if (not isinstance(seeds, torch.Tensor) or not seeds.is_cuda
            or seeds.dtype != torch.int64 or seeds.dim() != 1
            or not seeds.is_contiguous()):
        raise ValueError(
            "site_draws: seeds must be a contiguous int64 [R] CUDA tensor; "
            f"got {getattr(seeds, 'dtype', type(seeds))} "
            f"{tuple(getattr(seeds, 'shape', ()))} on "
            f"{getattr(seeds, 'device', 'the host')} (the plain version is "
            "core.rng.site_draws_plain)")
    if not 1 <= n <= MAX_DRAWS or (jitter and n < 2):
        raise ValueError(f"site_draws: {n} draws (1-{MAX_DRAWS}, at least "
                         "2 with the jitter)")
    acc_ptr, acc_value = _operand(accumulation, "accumulation", torch.int64,
                                  seeds)
    off_ptr, off_value = _operand(offset, "offset", torch.int32, seeds)
    r = seeds.shape[0]
    rows = lanes.rows(n, r, seeds.device)
    state = (torch.empty(r, dtype=torch.int64, device=seeds.device)
             if want_state else None)
    state_ptr = 0 if state is None else state.data_ptr()
    n_vec = lanes.groups(r, [seeds.data_ptr(), rows.data_ptr(), acc_ptr,
                             off_ptr, state_ptr])
    build.launch(SITE, LIBRARY.load().rng_site, seeds.device,
                 [seeds.data_ptr(), acc_ptr, acc_value, off_ptr, off_value,
                  n, int(scramble), int(jitter), rows.data_ptr(),
                  rows.stride(0), state_ptr, r, n_vec,
                  build.sm_count(seeds.get_device())])
    return (rows, state) if want_state else rows
