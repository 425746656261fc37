"""The port's own spans and counters in a traced run.

The port records a span for each stage of its render loop, and counters on
them, while a ``torch.profiler`` session records
(``cpu_raytracing_experiments_tpu_torch/utils/profiling.py``: ``span``,
``count``, ``spans``). The traced run's profiler window is such a session, so
after it the program's store holds the spans of the traced updates, and the
trace holds the same spans as ``record_function`` ranges on the host
thread. The readers here take both; each returns None where the store holds
no ``port.update`` span, as with a program that records none.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Tuple

from . import trace

UPDATE = "port.update"
SYNC = "port.sync"
PREFIX = "port."


def store() -> list:
    """The program's span records, or [] where it records none."""
    try:
        from cpu_raytracing_experiments_tpu_torch.utils import profiling
    except ImportError:
        return []
    read = getattr(profiling, "spans", None)
    return read() if read is not None else []


def records(ctx, recs: Optional[list] = None) -> Optional[list]:
    """The span records of the traced updates: the last n ``port.update``
    trees of the store (`recs`, else the program's), n the updates of the
    trace; None without a trace or without such spans."""
    tr = ctx.trace
    if tr is None:
        return None
    recs = store() if recs is None else recs
    n = sum(1 for name, _, _ in tr.host if name == trace.UPDATE_SPAN)
    roots = [r["id"] for r in recs if r["name"] == UPDATE
             and r["parent"] is None]
    if not roots or n == 0:
        return None
    keep = set(roots[-n:])
    by_id = {r["id"]: r for r in recs}
    out = []
    for r in recs:
        top = r
        while top["parent"] is not None:
            top = by_id[top["parent"]]
        if top["id"] in keep:
            out.append(r)
    return out


def counter(recs: list, name: str) -> int:
    """Counter `name` summed over `recs`."""
    return sum(r["counts"].get(name, 0) for r in recs)


def _ancestors(recs: list):
    by_id = {r["id"]: r for r in recs}

    def chain(r):
        while r["parent"] is not None and r["parent"] in by_id:
            r = by_id[r["parent"]]
            yield r
    return chain


def outermost(recs: list, names: Iterable[str]) -> List[dict]:
    """The spans named one of `names` that lie inside no other such span."""
    names = set(names)
    chain = _ancestors(recs)
    return [r for r in recs if r["name"] in names
            and not any(a["name"] in names for a in chain(r))]


def device_ms(spans: Iterable[dict]) -> Optional[float]:
    """The device ms of `spans` summed; None where one has none (off a
    card)."""
    total = 0.0
    for r in spans:
        if r["device_ms"] is None:
            return None
        total += r["device_ms"]
    return total


def shade_ms(recs: list) -> Optional[float]:
    """Device ms of the ``port.bounce`` spans less their outermost
    ``port.intersect``, ``port.occluded`` and ``port.rng`` descendants."""
    cut = {"port.intersect", "port.occluded", "port.rng"}
    chain = _ancestors(recs)
    bounces = [r for r in recs if r["name"] == "port.bounce"]
    inner = [r for r in outermost(recs, cut)
             if any(a["name"] == "port.bounce" for a in chain(r))]
    whole, cut_ms = device_ms(bounces), device_ms(inner)
    if whole is None or cut_ms is None or not bounces:
        return None
    return whole - cut_ms


def _host_ranges(tr: trace.Trace, pred) -> List[Tuple[float, float, str]]:
    return [(s, s + d, name) for name, s, d in tr.host if pred(name)]


def gaps(tr: trace.Trace) -> List[Tuple[float, float]]:
    """The window's idle stretches, (start, end) us, in order."""
    w0, w1 = tr.window
    edges = [w0]
    for s, e in trace.busy_intervals(tr):
        edges += [s, e]
    edges.append(w1)
    return [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]


def sync_idle_s(tr: trace.Trace) -> float:
    """Seconds of the window's idle stretches that begin while the host is
    inside a ``port.sync`` span: the device ran dry while the host waited
    on a read."""
    syncs = _host_ranges(tr, lambda n: n == SYNC)
    return sum(e - s for s, e in gaps(tr)
               if any(a <= s < b for a, b, _ in syncs)) * 1e-6


def idle_by_span(tr: trace.Trace) -> Dict[str, float]:
    """Seconds of idle stretches by the innermost ``port.`` span the host
    was in at the stretch's midpoint ("outside port spans" where none)."""
    ranges = sorted(_host_ranges(tr, lambda n: n.startswith(PREFIX)),
                    key=lambda x: (x[0], -x[1]))
    out: Dict[str, float] = {}
    stack: List[Tuple[float, float, str]] = []
    i = 0
    for s, e in gaps(tr):  # in order; the spans nest on one thread
        mid = 0.5 * (s + e)
        while i < len(ranges) and ranges[i][0] <= mid:
            while stack and stack[-1][1] < ranges[i][0]:
                stack.pop()
            stack.append(ranges[i])
            i += 1
        while stack and stack[-1][1] < mid:
            stack.pop()
        label = stack[-1][2] if stack else "outside port spans"
        out[label] = out.get(label, 0.0) + (e - s) * 1e-6
    return out
