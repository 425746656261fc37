"""The 90th percentile of the wall time of all updates of the window, in
ms: the stall a viewer sees."""
from ..window import quantile


def read(ctx):
    return quantile(ctx.update_s, 0.9) * 1e3
