"""Counter-based (stateless) RNG, bit for bit the JAX package's
``core/rng.py`` (the reference's PCG scheme, Random.hpp:10-50).

PyTorch's ``uint32`` has no ``+``, ``>>`` or ``minimum``, so a u32 value is
held in an ``int64`` tensor in [0, 2^32) and every ``+`` and ``*`` is reduced
with ``& 0xFFFFFFFF``. Products are split into 16-bit halves of the constant
so that no intermediate leaves the int64 range: the low 32 bits of ``a * c``
are those of ``a * c_lo + ((a * c_hi) mod 2^16) << 16``.

All functions work elementwise on such tensors (or on Python ints).

A site of the renderer (the site state and the draws after it, the
stratified camera jitter) is one call of ``site_draws``: on the CPU the
composition of these functions (``site_draws_plain``), on the card one
launch of ``csrc/rng.cu`` (``ops/kernels/rng.py``), bit for bit the same.
Draws made eagerly on the card, and the renderer's pixel seeds
(``render/renderer.py::pixel_seeds_from_index``), count their lanes as
``rng_eager_lanes`` on the innermost span (``utils/profiling.py``).
"""
from __future__ import annotations

import torch

from ..ops.kernels import rng as rng_kernel
from ..utils import profiling

MASK = 0xFFFFFFFF
GOLDEN_RATIO_CONJUGATE = 0.6180339887498949


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
    if state.is_cuda:
        profiling.count("rng_eager_lanes", state.numel())
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


def site_state(accumulation, counter, scramble: bool):
    """RNG site state (Renderer.hpp:117/255/362), avalanche-scrambled under
    `scramble` (``policy.rng_scramble``) to break hash_2d's lattice
    structure."""
    state = hash_2d(accumulation, counter)
    if scramble:
        state = hash_u32(state)
    return state


def stratified_jitter(accumulation, seeds):
    """The pixel jitter of ``stratify_camera``: van der Corput in base 2 over
    the accumulation index (the bitreverse the reference computes but never
    uses, Renderer.hpp:80) and a golden-ratio second dimension, rotated per
    pixel (Cranley-Patterson) by hashed-pixel offsets. All sums are >= 0,
    where ``torch.remainder`` and the JAX package's ``jnp.mod`` are exact."""
    acc = u32(accumulation, seeds.device)
    vdc = make_unit_float(bitreverse32(acc))
    gr = torch.remainder(acc.to(torch.float32) * GOLDEN_RATIO_CONJUGATE, 1.0)
    ox = make_unit_float(hash_u32(seeds))
    oy = make_unit_float(hash_u32(seeds ^ 0x9E3779B9))
    return torch.remainder(vdc + ox, 1.0), torch.remainder(gr + oy, 1.0)


def site_draws_plain(accumulation, seeds, offset, n: int, scramble: bool,
                     want_state: bool = False, jitter: bool = False):
    """``site_draws`` composed of the functions above."""
    state = site_state(accumulation, add32(seeds, offset), scramble)
    state, ds = draws(state, n)
    if jitter:
        ds[:2] = stratified_jitter(accumulation, seeds)
    rows = torch.stack(ds)
    return (rows, state) if want_state else rows


def site_draws(accumulation, seeds, offset, n: int, scramble: bool,
               want_state: bool = False, jitter: bool = False):
    """One RNG site: the lane counter add32(seeds, offset), its state
    ``site_state(accumulation, counter, scramble)`` and `n` sequential
    draws from it, as an [n, R] float32 tensor (row k the k-th draw), and
    the state after them where `want_state`. With `jitter` rows 0 and 1 are
    ``stratified_jitter(accumulation, seeds)`` instead (the draws still
    advance the state). `seeds` are u32 in an int64 [R] tensor;
    `accumulation` is an int or one a lane (int64 [R]); `offset` an int or
    one a lane (int32 [R]). CPU tensors take ``site_draws_plain``; CUDA
    tensors launch ``csrc/rng.cu`` (n from 1 to 5) or raise."""
    if seeds.device.type == "cpu":
        return site_draws_plain(accumulation, seeds, offset, n, scramble,
                                want_state, jitter)
    return rng_kernel.site_draws(accumulation, seeds, offset, n, scramble,
                                 want_state, jitter)
