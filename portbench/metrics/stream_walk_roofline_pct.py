"""The streamed cluster walks' share of their roofline: the least time
their calls could take at the card's published peaks (walks.walk_call and
peaks.least_seconds on the pairs and rays the port counts on each
``port.walk`` span of walk form 'streamed' in the traced updates) over
the device time of the streamed walk kernels in those updates. None where
the program counts no pairs, or no streamed walk ran."""
from .. import peaks, spans, walks
from .stream_walk_ms_per_pass import STREAM


def read(ctx):
    tr = ctx.trace
    recs = spans.records(ctx)
    if recs is None:
        return None
    calls = walks.walk_spans(recs, "streamed")
    kernel_us = sum(d for n, _, d in tr.kernels if STREAM.match(n))
    if not calls or kernel_us <= 0.0:
        return None
    least = sum(peaks.least_seconds(*walks.walk_call(
        r["attrs"]["walk_prims"], r["attrs"]["walk_kind"],
        r["counts"]["walk_pairs"], r["counts"]["walk_rays"]))
        for r in calls)
    return 100.0 * least / (kernel_us * 1e-6)
