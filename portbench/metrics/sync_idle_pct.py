"""The share of the traced window the device idles because the host waited
on a read: 100 x the idle stretches that begin while the host is inside a
``port.sync`` span, over the window."""
from .. import spans


def read(ctx):
    tr = ctx.trace
    if spans.records(ctx) is None or not tr.device_ops:
        return None
    return 100.0 * spans.sync_idle_s(tr) / tr.window_s
