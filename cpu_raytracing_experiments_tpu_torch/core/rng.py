"""Counter-based (stateless) RNG, bit for bit the JAX package's
``core/rng.py`` (the reference's PCG scheme, Random.hpp:10-50).

PyTorch's ``uint32`` has no ``+``, ``>>`` or ``minimum``, so a u32 value is
held in an ``int64`` tensor in [0, 2^32) and every ``+`` and ``*`` is reduced
with ``& 0xFFFFFFFF``. Products are split into 16-bit halves of the constant
so that no intermediate leaves the int64 range: the low 32 bits of ``a * c``
are those of ``a * c_lo + ((a * c_hi) mod 2^16) << 16``.

All functions work elementwise on such tensors (or on Python ints).
"""
from __future__ import annotations

import torch

MASK = 0xFFFFFFFF


def u32(x, device=None) -> torch.Tensor:
    """An int64 tensor holding the u32 value(s) of `x`."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.int64) & MASK
    return torch.as_tensor(x, dtype=torch.int64, device=device) & MASK


def mul32(a, c: int):
    """(a * c) mod 2^32 for u32 `a` and a Python int constant `c`."""
    if not isinstance(a, torch.Tensor):
        return (a * c) & MASK
    lo, hi = c & 0xFFFF, (c >> 16) & 0xFFFF
    return (a * lo + (((a * hi) & 0xFFFF) << 16)) & MASK


def add32(a, b):
    return (a + b) & MASK


def pcg_state_transition(state):
    """LCG step (Random.hpp:10-13)."""
    return add32(mul32(state, 747796405), 2891336453)


def pcg_output(state):
    """PCG XSH-RR style output permutation (Random.hpp:14-18)."""
    word = mul32((state >> ((state >> 28) + 4)) ^ state, 277803737)
    return (word >> 22) ^ word


def pcg_generate(state):
    """(new_state, output); the output comes from the previous state."""
    return pcg_state_transition(state), pcg_output(state)


def make_unit_float(bits: torch.Tensor) -> torch.Tensor:
    """u32 -> float32 in [0, 1] via x * 2^-32 (Random.hpp:5)."""
    return bits.to(torch.float32) * (2.0 ** -32)


def rand_unit_float(state):
    state, bits = pcg_generate(state)
    return state, make_unit_float(bits)


def rand_bounded_int(state, range_):
    """(new_state, u32 in [0, range)) (Random.hpp:31-34)."""
    state, f = rand_unit_float(state)
    r = u32(range_, f.device)
    v = (f * r.to(torch.float32)).to(torch.int64)
    return state, torch.minimum(r - 1, v)


def hash_u32(i):
    """hash-prospector avalanche hash (Random.hpp:36-43)."""
    i = u32(i)
    i = i ^ (i >> 16)
    i = mul32(i, 0x21F0AAAD)
    i = i ^ (i >> 15)
    i = mul32(i, 0xD35A2D97)
    i = i ^ (i >> 15)
    return i ^ 0xE6FE3BEB


def hash_2d(x, y):
    """2D counter hash (Random.hpp:45-50). `x`, `y` are u32 tensors or ints."""
    m = 0x41C64E6D
    qx = mul32((x >> 1) ^ y, m)
    qy = mul32((y >> 1) ^ x, m)
    return mul32(qx ^ (qy >> 3), m)


def bitreverse32(x):
    """Reverse the bits of a u32 (Bitmanip.hpp:200-233 semantics)."""
    x = u32(x)
    x = ((x & 0x55555555) << 1) | ((x >> 1) & 0x55555555)
    x = ((x & 0x33333333) << 2) | ((x >> 2) & 0x33333333)
    x = ((x & 0x0F0F0F0F) << 4) | ((x >> 4) & 0x0F0F0F0F)
    x = ((x & 0x00FF00FF) << 8) | ((x >> 8) & 0x00FF00FF)
    return ((x << 16) & MASK) | (x >> 16)


def draws(state, n: int):
    """`n` sequential unit floats from a site state: (new_state, [f0..])."""
    outs = []
    for _ in range(n):
        state, f = rand_unit_float(state)
        outs.append(f)
    return state, outs
