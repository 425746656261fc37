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
* ``rsqrt``, ``sin``, ``cos``: through float64, rounded once to float32.

XLA's own CPU ``rsqrt`` (``vrsqrtps`` plus two Newton steps) and its
``sin``/``cos`` are not correctly rounded, so those stay a source of
one-ulp differences from the JAX package.
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
