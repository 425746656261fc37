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

* ``fma(a, b, c)`` is ``float32(float64(a) * float64(b) + float64(c))``: the
  product is exact in float64, the sum is rounded to float64 and then to
  float32. It equals a single-rounding fmaf except in about one case in
  2^29, and it is the same expression on every device, which the CUDA
  kernels evaluate in double too (PyTorch has no single-rounding fma on the
  card: ``addcmul`` rounds the product first there);
* ``sqrt``: IEEE on the card; on the CPU PyTorch's vectorised sqrt is off by
  one ulp in ~0.6% of lanes, so the CPU path goes through float64;
* ``rsqrt``, ``sin``, ``cos``: through float64, rounded once to float32.

XLA's own CPU ``rsqrt`` (``vrsqrtps`` plus two Newton steps) and its
``sin``/``cos`` are not correctly rounded, so those stay a source of
one-ulp differences from the JAX package.
"""
from __future__ import annotations

import torch


def _f64(x):
    if isinstance(x, torch.Tensor):
        return x.double()
    return float(x)


def fma(a, b, c):
    """a * b + c, rounded as described above. `a` is a float32 tensor; `b`
    and `c` may be tensors or Python floats."""
    return (_f64(a) * _f64(b) + _f64(c)).to(torch.float32)


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


def dot3(ax, ay, az, bx, by, bz):
    """ax*bx + ay*by + az*bz as XLA contracts it."""
    return fma(az, bz, fma(ax, bx, ay * by))
