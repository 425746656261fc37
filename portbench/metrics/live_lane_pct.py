"""The share of the wavefront's lanes that carry a ray: 100 x the rays the
intersection calls traced (``rays_traced``: closest-hit lanes alive and
shadow rays) over the lanes they were given (``lanes_traced``), in the
traced updates. Masked bounces at full width lower it; narrowing raises
it."""
from .. import spans


def read(ctx):
    recs = spans.records(ctx)
    if recs is None:
        return None
    lanes = spans.counter(recs, "lanes_traced")
    if lanes == 0:
        return None
    return 100.0 * spans.counter(recs, "rays_traced") / lanes
