"""Device ms per pass of the cluster walks (csrc/cluster_traverse.cu's
closest_kernel and occluded_kernel templates: cluster_closest,
cluster_occluded and their streamed forms). None where no walk ran."""
import re

WALK = re.compile(r"^(?:void )?(?:\(anonymous namespace\)::)?"
                  r"(?:closest|occluded)_kernel<\d+, (?:true|false), \d+>")


def read(ctx):
    tr = ctx.trace
    if tr is None:
        return None
    us = [d for n, _, d in tr.kernels if WALK.match(n)]
    return sum(us) * 1e-3 / tr.passes if us else None
