"""The share of the traced window in which no operation runs on the
device: 100 x (1 - the union of the device ops' intervals / the window)."""
from ..trace import busy_s


def read(ctx):
    tr = ctx.trace
    if tr is None or not tr.device_ops:
        return None
    return 100.0 * (1.0 - busy_s(tr) / tr.window_s)
