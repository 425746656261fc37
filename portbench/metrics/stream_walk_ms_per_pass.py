"""Device ms per pass of the streamed cluster walks (csrc/cluster_traverse.cu's
closest_kernel and occluded_kernel with kPacked: cluster_closest_stream and
cluster_occluded_stream). None where no streamed walk ran."""
import re

STREAM = re.compile(r"^(?:void )?(?:\(anonymous namespace\)::)?"
                    r"(?:closest|occluded)_kernel<\d+, true, \d+>")


def read(ctx):
    tr = ctx.trace
    if tr is None:
        return None
    us = [d for n, _, d in tr.kernels if STREAM.match(n)]
    return sum(us) * 1e-3 / tr.passes if us else None
