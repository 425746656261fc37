"""The flat planner's share of its roofline: the least time its calls
could take at the card's published peaks (peaks.plan_call and
peaks.least_seconds on the rays each call must test, counted over one
update by counters.PlannerCalls) over the device time of the planner
kernel (csrc/cluster_traverse.cu's plan_kernel), both per pass. None where
no planner ran, or a planner mode other than 'ray' did."""
import re

from .. import peaks

PLAN = re.compile(r"^(?:void )?(?:\(anonymous namespace\)::)?plan_kernel<")


def read(ctx):
    tr, calls = ctx.trace, ctx.planner_calls
    if tr is None or not calls or any(c["plan"] != "ray" for c in calls):
        return None
    kernel_us = sum(d for n, _, d in tr.kernels if PLAN.match(n))
    if kernel_us <= 0.0:
        return None
    least = sum(peaks.least_seconds(*peaks.plan_call(
        c["rays"], c["valid"], c["clusters"], c["tile"], c["in_kernel"]))
        for c in calls) / ctx.planner_passes
    return 100.0 * least / (kernel_us * 1e-6 / tr.passes)
