"""The median wall time of the traced run's window updates, in ms."""
from ..window import quantile


def read(ctx):
    return quantile(ctx.update_s, 0.5) * 1e3
