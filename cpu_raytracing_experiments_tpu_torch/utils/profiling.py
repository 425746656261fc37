"""Profiling hooks, the port of the JAX package's ``utils/profiling.py``.

The reference profiles with IACA marks and offline sampling, leaving stage
percentages as comments (iacaMarks.h, Renderer.hpp stage comments;
SURVEY.md section 5). Here:
  * ``trace()`` wraps a region in a ``torch.profiler`` trace (CPU and, on a
    card, CUDA activity) and writes it as a Chrome trace, readable in
    Perfetto or chrome://tracing, with the spans recorded in the region
    beside it (``spans.json``);
  * ``span()`` marks a stage of the render loop (the names start with
    ``port.``) and ``count()`` adds to a counter of the innermost open span.
    Both record only while a ``torch.profiler`` session records, whoever
    started it; otherwise ``span()`` returns one shared no-op after a
    single check and ``count()`` does nothing. A recorded span is a
    ``record_function`` range, so it lies in the profiler's trace on the
    kernels' clock, and on a card it also records a CUDA event on the
    current stream at entry and at exit: the port runs on one stream, so a
    span's device time (exit event minus entry event) is its kernels and
    the idle stretches its own dispatch left. ``spans()`` reads the
    records back, ``clear()`` drops them.
"""
from __future__ import annotations

import contextlib
import json
import threading
import time
from pathlib import Path

import torch
from torch.autograd import _profiler_enabled


class _NoSpan:
    """The span while nothing records: enters and exits, records nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NO_SPAN = _NoSpan()


class _Open(threading.local):
    def __init__(self):
        self.stack = []  # the thread's open spans, innermost last


_OPEN = _Open()
_STORE = []  # every recorded span, in order of entry
_EVENTS = []  # timing events free for reuse


def _event():
    return _EVENTS.pop() if _EVENTS else torch.cuda.Event(enable_timing=True)


class _Span:
    __slots__ = ("name", "parent", "update_id", "attrs", "counts",
                 "host_start", "host_end", "start", "end", "_range")

    def __init__(self, name: str, attrs: dict):
        self.name = name
        self.attrs = attrs
        self.counts = {}
        self.host_end = self.start = self.end = None

    def __enter__(self):
        stack = _OPEN.stack
        self.parent = stack[-1] if stack else None
        self.update_id = self.attrs.get(
            "update_id", self.parent.update_id if self.parent else None)
        self._range = torch.profiler.record_function(self.name)
        self._range.__enter__()
        if torch.cuda.is_initialized():
            self.start = _event()
            self.start.record()
        self.host_start = time.perf_counter()
        stack.append(self)
        _STORE.append(self)
        return self

    def __exit__(self, *exc):
        self.host_end = time.perf_counter()
        if self.start is not None:
            self.end = _event()
            self.end.record()
        self._range.__exit__(*exc)
        _OPEN.stack.pop()
        return False


def recording() -> bool:
    """Whether a profiler session records, so that spans and counters do."""
    return _profiler_enabled()


def span(name: str, **attrs):
    """A context manager that records stage `name` with `attrs` while a
    profiler session records (an ``update_id`` attr is inherited by the
    spans inside), else the shared no-op ``NO_SPAN``."""
    if not recording():
        return NO_SPAN
    return _Span(name, attrs)


def sync(site: str):
    """``span('port.sync', site=site)`` around one read that synchronises
    the host with the device, counted as ``host_syncs``."""
    s = span("port.sync", site=site)
    if s is not NO_SPAN:
        s.counts["host_syncs"] = [1]
    return s


def count(name: str, n=1):
    """Add `n` to counter `name` of the innermost open recorded span; no-op
    where none is open. `n` is an int or a 0-d tensor, summed when the
    store is read, so that counting waits for nothing."""
    stack = _OPEN.stack
    if stack:
        stack[-1].counts.setdefault(name, []).append(n)


def spans() -> list:
    """The recorded spans in order of entry, each a dict: id, name, parent
    (its id, or None), update_id, attrs, counts ({name: int}),
    host_start_s / host_end_s (``time.perf_counter``), device_ms (exit event
    minus entry event; None off a card or while open) and self_ms
    (device_ms minus its children's). Synchronises with the card, and sums
    the counters once."""
    if any(s.start is not None for s in _STORE):
        torch.cuda.synchronize()
    ids = {id(s): k for k, s in enumerate(_STORE)}
    out = []
    for k, s in enumerate(_STORE):
        for name, values in s.counts.items():
            s.counts[name] = [sum(int(v) for v in values)]
        ms = (s.start.elapsed_time(s.end)
              if s.start is not None and s.end is not None else None)
        out.append({"id": k, "name": s.name,
                    "parent": None if s.parent is None
                    else ids.get(id(s.parent)),
                    "update_id": s.update_id, "attrs": dict(s.attrs),
                    "counts": {n: v[0] for n, v in s.counts.items()},
                    "host_start_s": s.host_start, "host_end_s": s.host_end,
                    "device_ms": ms, "self_ms": ms})
    for rec in out:
        parent = rec["parent"]
        if parent is not None and out[parent]["self_ms"] is not None:
            out[parent]["self_ms"] -= rec["device_ms"] or 0.0
    return out


def clear():
    """Drop every recorded span; their timing events go back to the pool."""
    for s in _STORE:
        _EVENTS.extend(e for e in (s.start, s.end) if e is not None)
    _STORE.clear()


@contextlib.contextmanager
def trace(logdir: str = "torch-trace"):
    """A ``torch.profiler.profile`` over the block; on exit the trace is
    written to ``<logdir>/trace.json`` (Chrome trace format) and the spans
    recorded in the block to ``<logdir>/spans.json`` (``spans()``'s
    records). Yields `logdir`."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    out = Path(logdir)
    out.mkdir(parents=True, exist_ok=True)
    first = len(_STORE)
    with profile(activities=activities) as prof:
        yield logdir
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(str(out / "trace.json"))
    recs = spans()[first:]
    for rec in recs:
        rec["id"] -= first
        if rec["parent"] is not None:
            rec["parent"] = (rec["parent"] - first
                             if rec["parent"] >= first else None)
    (out / "spans.json").write_text(json.dumps(recs, default=str))
