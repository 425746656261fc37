"""Device ms per pass of the intersection dispatch: the device time of the
port's ``port.intersect`` and ``port.occluded`` spans (the batteries, or
the planner, the walks and their glue) in the traced updates."""
from .. import spans


def read(ctx):
    recs = spans.records(ctx)
    if recs is None:
        return None
    ms = spans.device_ms(spans.outermost(
        recs, ("port.intersect", "port.occluded")))
    return None if ms is None else ms / ctx.trace.passes
