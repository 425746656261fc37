"""Device ms per pass of the counter RNG: the device time of the port's
outermost ``port.rng`` spans (pixel seeds, the camera's, NEE's and the
BSDF's site states and draws) in the traced updates."""
from .. import spans


def read(ctx):
    recs = spans.records(ctx)
    if recs is None:
        return None
    ms = spans.device_ms(spans.outermost(recs, ("port.rng",)))
    return None if ms is None else ms / ctx.trace.passes
