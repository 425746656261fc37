"""Bit-manipulation utilities, the JAX package's ``core/bitmanip.py`` on
u32 values held in int64 tensors (see ``core/rng.py``). ``bitreverse32``
lives in ``core/rng.py``, as it does in the JAX package."""
from __future__ import annotations

import torch

from .rng import MASK, mul32, u32


def popcount32(x) -> torch.Tensor:
    """Per-element bit population count (Bitmanip.hpp popcnt)."""
    x = u32(x)
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return mul32(x, 0x01010101) >> 24


def _part1by1(x) -> torch.Tensor:
    """Spread the low 16 bits of x to even bit positions (pdep 0x55555555)."""
    x = u32(x) & 0x0000FFFF
    x = (x | (x << 8)) & 0x00FF00FF
    x = (x | (x << 4)) & 0x0F0F0F0F
    x = (x | (x << 2)) & 0x33333333
    x = (x | (x << 1)) & 0x55555555
    return x


def _compact1by1(x) -> torch.Tensor:
    """Inverse of _part1by1 (pext 0x55555555)."""
    x = u32(x) & 0x55555555
    x = (x | (x >> 1)) & 0x33333333
    x = (x | (x >> 2)) & 0x0F0F0F0F
    x = (x | (x >> 4)) & 0x00FF00FF
    x = (x | (x >> 8)) & 0x0000FFFF
    return x


def morton_encode2d(x, y) -> torch.Tensor:
    """Interleave 16-bit x (even bits) and y (odd bits)."""
    return _part1by1(x) | ((_part1by1(y) << 1) & MASK)


def morton_decode2d(code):
    code = u32(code)
    return _compact1by1(code), _compact1by1(code >> 1)


def round_up_pow2(x) -> torch.Tensor:
    """Smallest power of two >= x (u32 wrap-around as in the JAX version)."""
    x = u32(x)
    v = (x - 1) & MASK
    for s in (1, 2, 4, 8, 16):
        v = v | (v >> s)
    return torch.where(x <= 1, torch.ones_like(x), (v + 1) & MASK)


def float_exponent(x) -> torch.Tensor:
    """Biased IEEE-754 exponent bits of a float32 tensor."""
    bits = torch.as_tensor(x, dtype=torch.float32).view(torch.int32)
    return (bits.to(torch.int64) >> 23) & 0xFF
