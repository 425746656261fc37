"""Reads of device values by the host in the traced updates, per
accumulation pass: the ``host_syncs`` counter of the port's ``port.sync``
spans (each read that waits for the device's queue, such as the bounce
loop's liveness test)."""
from .. import spans


def read(ctx):
    recs = spans.records(ctx)
    if recs is None:
        return None
    return spans.counter(recs, "host_syncs") / ctx.trace.passes
