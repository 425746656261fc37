"""ACES tonemap of the resolve (the JAX package's ``core/color.py``,
Color.hpp:39-73), channelwise on same-shape float32 tensors, with the
multiply-adds fused where XLA fuses them (``core/fp.py``)."""
from __future__ import annotations

import torch

from .fp import fma

# input and output matrices, rows of (r, g, b) weights
_ACES_IN = ((0.59719, 0.35458, 0.04823), (0.07600, 0.90834, 0.01566),
            (0.02840, 0.13383, 0.83777))
_ACES_OUT = ((1.604750, -0.53108, -0.07367), (-0.10208, 1.10813, -0.00605),
             (-0.00327, -0.07276, 1.07602))


def aces_rtt_odt_fit(x):
    """(x (x + a) - b) / (x (c x + d) + e) (Color.hpp:39-49)."""
    return (fma(x, x + 0.0245786, -0.000090537)
            / fma(x, fma(x, 0.983729, 0.4329510), 0.238081))


def _row(w, a, b, c, fuse_b=False):
    """a*w0 + b*w1 + c*w2 as XLA contracts it: fma(c, w2, fma(a, w0,
    b*w1)), or with `fuse_b` fma(c, w2, fma(b, w1, a*w0)). LLVM turns a sum
    with a product by a negative weight into a difference, which moves
    that product to the second operand: so it is b*w1 that fuses in the
    output matrix's green row (-0.10208, 1.10813, ...)."""
    if fuse_b:
        return fma(c, w[2], fma(b, w[1], a * w[0]))
    return fma(c, w[2], fma(a, w[0], b * w[1]))


def tonemap_aces(r, g, b):
    """Input matrix -> rtt_odt fit -> output matrix -> clamp to [0, 1]."""
    x, y, z = (aces_rtt_odt_fit(_row(w, r, g, b)) for w in _ACES_IN)
    return tuple(torch.clamp(_row(w, x, y, z, fuse_b=k == 1), 0.0, 1.0)
                 for k, w in enumerate(_ACES_OUT))
