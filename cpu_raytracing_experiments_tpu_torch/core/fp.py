"""Float32 arithmetic that rounds the way the JAX package's compiled code
rounds.

XLA compiles the JAX package's elementwise math with floating-point
contraction: ``a*b + c`` becomes one fused multiply-add, by LLVM's rules
(for ``a*b + c*d + e*f``: ``fma(e, f, fma(a, b, c*d))``; a product used
twice is not fused). PyTorch rounds every op on its own. Where a path tracer
rounds differently, shadow and Russian-roulette decisions near their
thresholds flip and whole paths diverge, so the port writes each contraction
out with ``fma``, and keeps square roots and transcendentals correctly
rounded:

* ``fma(a, b, c)`` rounds once, as a hardware fused multiply-add does.
  On the CPU it is computed in float64 and rounded to odd: the product
  a*b is exact in float64, the sum's rounding error comes from TwoSum, and
  an inexact sum whose last bit is even steps one float64 ulp toward the
  exact value. Float64 keeps 53 >= 2*24 + 2 bits, so rounding that result
  to float32 gives the correctly rounded a*b + c (subnormal results
  included). A tensor on the card goes to a hand-written CUDA kernel
  (``ops/kernels/fma.py``, ``__fmaf_rn``), which rounds the same; PyTorch
  has no single-rounding fma there (``addcmul`` rounds the product
  first). The CUDA kernels of ``csrc/`` use ``__fmaf_rn`` too;
* ``dot3`` and ``fma3`` (and ``sampling.to_local`` / ``to_world``) chain
  several of them. On the CPU they are that chain of ``fma`` calls; on the
  card one launch computes the whole expression, rounded as the chain
  rounds it (``ops/kernels/fma.py::contract``), where its operands are
  flat, and the chain of kernel calls otherwise. ``dot3_plain`` and
  ``fma3_plain`` are the chains of ``fma_plain`` that ``chip_smoke.py``
  holds the fused launches to;
* ``sqrt``: IEEE on the card; on the CPU PyTorch's vectorised sqrt is off by
  one ulp in ~0.6% of lanes, so the CPU path goes through float64;
* ``rsqrt``, ``sin``, ``cos``, ``atan2``, ``asin``: through float64,
  rounded once to float32, on the CPU and the card alike.

XLA's own CPU ``rsqrt`` (``vrsqrtps`` plus two Newton steps) and its
``sin``/``cos``/``atan2``/``asin`` are not correctly rounded, so those stay
a source of one-ulp differences from the JAX package.

Reductions over a row of runtime length (the lights of a scene) are summed in
the order XLA's CPU compiler gives ``jnp.sum(w, axis=1)`` and
``jnp.cumsum(w, axis=1)`` (``row_sum``, ``row_cumsum``): a light's cdf entry
one ulp off moves the selected light, and with it the path. On the card
``ops/kernels/light_rows.py`` computes both in the same order.

One contraction depends on the width of the block XLA computes: the closest-hit
sphere battery's ``disc`` (``xla_fuses_sphere_bb``).
"""
from __future__ import annotations

import torch

from ..ops.kernels import fma as fma_kernel


def _f64(x):
    """A tensor in float64; a Python float rounded to float32 first, as a
    weakly typed scalar is in the JAX package's float32 arithmetic."""
    if isinstance(x, torch.Tensor):
        return x.double()
    return float(torch.tensor(float(x), dtype=torch.float32))


def fma_plain(a, b, c):
    """a * b + c rounded once to float32, in float64 with round-to-odd
    (module docstring); any device, and broadcasting as PyTorch does. NaN
    and inf propagate as in IEEE arithmetic."""
    p = _f64(a) * _f64(b)  # exact: 24 + 24 bits
    c = _f64(c)
    s = p + c
    # TwoSum: s + err == p + c exactly
    bv = s - p
    err = (p - (s - bv)) + (c - bv)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, torch.inf, -torch.inf).to(s.dtype)
    odd = torch.nextafter(s, toward)
    s = torch.where((err != 0) & even & torch.isfinite(s), odd, s)
    return s.to(torch.float32)


def fma(a, b, c):
    """a * b + c rounded once to float32. `a` is a float32 tensor; `b` and
    `c` may be float32 tensors or Python floats, and broadcast. A tensor on
    the CPU takes ``fma_plain``; one on the card launches the fma kernel."""
    if a.is_cuda:
        return fma_kernel.fma(a, b, c)
    return fma_plain(a, b, c)


def contract(op: int, operands):
    """One launch of the fma kernel's expression `op`
    (``ops/kernels/fma.py``: DOT3, FMA3, TO_LOCAL, TO_LOCAL_XY, TO_WORLD)
    where an operand lies on the card and the operands are flat: the tuple
    of its outputs. None otherwise: the caller then chains ``fma``."""
    if any(isinstance(x, torch.Tensor) and x.is_cuda for x in operands):
        return fma_kernel.contract(op, operands)
    return None


def sqrt(x: torch.Tensor) -> torch.Tensor:
    if x.is_cuda:
        return torch.sqrt(x)
    return torch.sqrt(x.double()).float()


def rsqrt(x: torch.Tensor) -> torch.Tensor:
    return torch.rsqrt(x.double()).float()


def sin(x: torch.Tensor) -> torch.Tensor:
    return torch.sin(x.double()).float()


def cos(x: torch.Tensor) -> torch.Tensor:
    return torch.cos(x.double()).float()


def atan2(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return torch.atan2(y.double(), x.double()).float()


def asin(x: torch.Tensor) -> torch.Tensor:
    return torch.asin(x.double()).float()


def _dot3(f, ax, ay, az, bx, by, bz):
    return f(az, bz, f(ax, bx, ay * by))


def dot3(ax, ay, az, bx, by, bz):
    """ax*bx + ay*by + az*bz as XLA contracts it: fma(az, bz, fma(ax, bx,
    ay*by)); on the card one launch where the operands are flat."""
    out = contract(fma_kernel.DOT3, (ax, ay, az, bx, by, bz))
    if out is not None:
        return out[0]
    return _dot3(fma, ax, ay, az, bx, by, bz)


def dot3_plain(ax, ay, az, bx, by, bz):
    """``dot3`` from ``fma_plain``: the plain version of its kernel."""
    return _dot3(fma_plain, ax, ay, az, bx, by, bz)


def fma3(a, b, c):
    """The 3-vector (fma(a.x, b, c.x), fma(a.y, b, c.y), fma(a.z, b, c.z)),
    of the type of `a` (a Vec3); `b` is shared by the three. On the card
    one launch where the operands are flat."""
    out = contract(fma_kernel.FMA3, (*a, b, *c))
    if out is not None:
        return type(a)(*out)
    return type(a)(*(fma(ac, b, cc) for ac, cc in zip(a, c)))


def fma3_plain(a, b, c):
    """``fma3`` from ``fma_plain``: the plain version of its kernel."""
    return type(a)(*(fma_plain(ac, b, cc) for ac, cc in zip(a, c)))


SPHERE_BB_UNFUSED = range(5, 9)  # chunk widths where XLA rounds b*b alone


def xla_fuses_sphere_bb(width: int) -> bool:
    """Whether jitted XLA on the CPU fuses ``b*b`` into the closest-hit
    sphere battery's ``disc = r_sq - (tx*tx + ty*ty + tz*tz) + b*b``
    (``ops/intersect.py::_sphere_candidates`` of the JAX package) when the
    battery's prim chunk is `width` spheres wide: fused
    (``fma(b, b, r_sq - dot3(t, t))``, one rounding) at every width but
    5-8, where XLA's CPU backend rounds ``b*b`` alone and adds it,
    ``(r_sq - dot3(t, t)) + b*b``. Like the orders above, this is XLA's CPU
    backend's choice, not the source's. It holds for the brute battery's and the grid
    residual's 512-sphere chunks; the K-slot battery of the JAX package's
    ``intersect_clustered`` (inside ``lax.cond`` in a scan) fuses at every
    K. Held by ``tests/test_torch_disc_width.py`` at widths 1-17 and
    516-521 on 4096 rays; at ray counts that XLA splits into thread
    partitions of no multiple of its 8-lane vectors, a partition's scalar
    tail fuses at every width (ROADMAP queue 3)."""
    return width not in SPHERE_BB_UNFUSED


SUM_BLOCK = 32  # XLA's CPU tree reduction: windows of 32 above 32 terms
SCAN_BLOCK = 16  # XLA's blocked cumulative sum: blocks of 16 above 16 terms


def _sequential_sum(x):
    """The last axis of `x` added left to right from 0, as XLA reduces it."""
    acc = torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
    for j in range(x.shape[-1]):
        acc = acc + x[..., j]
    return acc


def _sequential_scan(x):
    """The running sums of the last axis of `x`, left to right from 0."""
    acc = torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
    out = torch.empty_like(x)
    for j in range(x.shape[-1]):
        acc = acc + x[..., j]
        out[..., j] = acc
    return out


def sum_levels(n: int):
    """Term counts of ``row_sum``'s levels: n, then the window sums of each
    level until at most SUM_BLOCK remain."""
    sizes = [n]
    while sizes[-1] > SUM_BLOCK:
        sizes.append(-(-sizes[-1] // SUM_BLOCK))
    return sizes


def scan_levels(n: int):
    """Term counts of ``row_cumsum``'s levels: n, then the block totals of
    each level until at most SCAN_BLOCK remain."""
    sizes = [n]
    while sizes[-1] > SCAN_BLOCK:
        sizes.append(-(-sizes[-1] // SCAN_BLOCK))
    return sizes


def _lanes8(b):
    """The 8 lanes of `b` [..., 8] reduced as LLVM reduces a vector of 8
    floats: halves, then quarters, then the pair."""
    c = b[..., :4] + b[..., 4:]
    d = c[..., :2] + c[..., 2:]
    return d[..., 0] + d[..., 1]


def _vector_sum(x):
    """The last axis of `x` (at most 32 terms) summed as XLA's CPU backend
    sums a reduction fused with the elementwise producer of its terms, which
    it emits with reassociation allowed, so that LLVM vectorizes it in lanes
    of 8: up to 11 terms left to right; 12-15 terms as 8 lanes (terms 8.. on
    lanes 0..) reduced by ``_lanes8``; 16-31 terms as one or two more blocks
    of 8 added lane by lane, reduced by ``_lanes8``, the rest added left to
    right; 32 terms as two accumulators of 8 lanes (blocks 0 and 2, 1 and
    3) added lane by lane, then reduced."""
    n = x.shape[-1]
    if n < 12:
        return _sequential_sum(x)
    if n < 16:
        lanes = x[..., :8].clone()
        lanes[..., :n - 8] = x[..., :n - 8] + x[..., 8:]
        return _lanes8(lanes)
    if n == 32:
        return _lanes8((x[..., :8] + x[..., 16:24])
                       + (x[..., 8:16] + x[..., 24:]))
    blocks = n // 8
    lanes = x[..., :8]
    for k in range(1, blocks):
        lanes = lanes + x[..., 8 * k:8 * k + 8]
    acc = _lanes8(lanes)
    for j in range(8 * blocks, n):
        acc = acc + x[..., j]
    return acc


def row_sum(w: torch.Tensor, fused: bool = False) -> torch.Tensor:
    """The sums of the rows of float32 `w` [R, L], rounded as jitted
    ``jnp.sum(w, axis=1)`` rounds them on XLA's CPU backend: up to 32 terms
    left to right; above that the row is zero-padded to windows of 32, half
    the padding (rounded down) in front, each window summed left to right,
    and the window sums reduced again the same way. With `fused`, a row of
    at most 32 terms is summed as a reduction fused with the computation of
    its terms is (``_vector_sum``): the JAX renderer's emissive-hit pdf."""
    x = w
    if fused and x.shape[1] <= SUM_BLOCK:
        return _vector_sum(x)
    while x.shape[1] > SUM_BLOCK:
        n = x.shape[1]
        nb = -(-n // SUM_BLOCK)
        lo = (nb * SUM_BLOCK - n) // 2
        x = torch.nn.functional.pad(x, (lo, nb * SUM_BLOCK - n - lo))
        x = _sequential_sum(x.view(x.shape[0], nb, SUM_BLOCK))
    return _sequential_sum(x)


def row_cumsum(w: torch.Tensor) -> torch.Tensor:
    """The running sums along the rows of float32 `w` [R, L], rounded as
    jitted ``jnp.cumsum(w, axis=1)`` rounds them on XLA's CPU backend: up to
    16 terms left to right; above that the row is zero-padded at its end to
    blocks of 16, each block scanned left to right, the block totals scanned
    the same way (recursively), and entry i is its in-block running sum plus
    the running total of the blocks before its own."""
    n = w.shape[1]
    if n <= SCAN_BLOCK:
        return _sequential_scan(w)
    nb = -(-n // SCAN_BLOCK)
    x = torch.nn.functional.pad(w, (0, nb * SCAN_BLOCK - n))
    inblock = _sequential_scan(x.view(x.shape[0], nb, SCAN_BLOCK))
    before = torch.nn.functional.pad(row_cumsum(inblock[:, :, -1])[:, :-1],
                                     (1, 0))
    return (inblock + before[:, :, None]).view(x.shape[0], -1)[:, :n]
