"""Device ms per pass of the kernels that are not the port's own CUDA
kernels (csrc/*.cu): PyTorch's gathers, elementwise ops, sorts and
reductions of the eager shading path."""
from ..trace import is_csrc


def read(ctx):
    tr = ctx.trace
    if tr is None or not tr.kernels:
        return None
    us = sum(d for n, _, d in tr.kernels if not is_csrc(n, ctx.csrc_kernels))
    return us * 1e-3 / tr.passes
