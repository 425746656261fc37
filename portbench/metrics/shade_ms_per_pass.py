"""Device ms per pass of the eager shading: the device time of the port's
``port.bounce`` spans less their ``port.intersect``, ``port.occluded`` and
``port.rng`` spans, in the traced updates."""
from .. import spans


def read(ctx):
    recs = spans.records(ctx)
    if recs is None:
        return None
    ms = spans.shade_ms(recs)
    return None if ms is None else ms / ctx.trace.passes
