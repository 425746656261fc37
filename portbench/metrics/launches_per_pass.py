"""Kernels launched on the device in the traced updates, per accumulation
pass (a count from the profiler's trace: every kernel, the port's and
PyTorch's)."""


def read(ctx):
    tr = ctx.trace
    if tr is None or not tr.kernels:
        return None
    return len(tr.kernels) / tr.passes
