"""The device side of a traced run: a ``torch.profiler`` window over whole
updates, read back from its Chrome trace (kernel names and intervals on the
device, the host's ops on the thread that drives the updates)."""
from __future__ import annotations

import json
import os
import re
import tempfile
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, List, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation",
             "python_function")
UPDATE_SPAN = "portbench.update"


@dataclass
class Trace:
    """kernels / device_ops: (name, start us, duration us); window: (start,
    end) us of the traced updates; passes: accumulation passes in it;
    host: (name, start, duration) of the updating thread's events, by
    start."""

    kernels: List[Tuple[str, float, float]]
    device_ops: List[Tuple[str, float, float]]
    window: Tuple[float, float]
    passes: int
    host: List[Tuple[str, float, float]]

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-6


def profile(update: Callable[[], None], n_updates: int, passes: int,
            cuda: bool) -> Trace:
    """Trace `n_updates` calls of `update` (each ending once its work is
    done), which run `passes` accumulation passes in all."""
    from torch.profiler import ProfilerActivity, record_function
    from torch.profiler import profile as torch_profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with torch_profile(activities=acts) as prof:
        for _ in range(n_updates):
            with record_function(UPDATE_SPAN):
                update()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    return parse(events, passes)


def parse(events: list, passes: int) -> Trace:
    """A Trace from the events of a Chrome trace."""
    def spans(cats):
        return [e for e in events if e.get("ph") == "X"
                and e.get("cat") in cats]

    def triple(e):
        return (e.get("name", ""), float(e["ts"]), float(e.get("dur", 0.0)))

    updates = [e for e in spans(("user_annotation",))
               if e.get("name") == UPDATE_SPAN]
    if not updates:
        raise ValueError(f"no {UPDATE_SPAN} span in the trace")
    window = (min(float(e["ts"]) for e in updates),
              max(float(e["ts"]) + float(e.get("dur", 0.0))
                  for e in updates))
    pid, tid = updates[0].get("pid"), updates[0].get("tid")
    host = sorted((triple(e) for e in spans(HOST_CATS)
                   if e.get("pid") == pid and e.get("tid") == tid),
                  key=lambda x: (x[1], -x[2]))
    return Trace(kernels=[triple(e) for e in spans(("kernel",))],
                 device_ops=[triple(e) for e in spans(DEVICE_CATS)],
                 window=window, passes=passes, host=host)


def busy_intervals(tr: Trace) -> List[Tuple[float, float]]:
    """The union of the device ops' intervals inside the window, merged and
    in order."""
    w0, w1 = tr.window
    ivs = sorted((max(s, w0), min(s + d, w1)) for _, s, d in tr.device_ops
                 if s < w1 and s + d > w0)
    merged: List[List[float]] = []
    for s, e in ivs:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def busy_s(tr: Trace) -> float:
    """Seconds in which an operation ran on the device, in the window."""
    return sum(e - s for s, e in busy_intervals(tr)) * 1e-6


def idle_gaps(tr: Trace) -> List[Tuple[str, float]]:
    """The window's idle stretches as (what the updating thread was doing
    at the stretch's midpoint: its innermost event, seconds)."""
    w0, w1 = tr.window
    edges = [w0]
    for s, e in busy_intervals(tr):
        edges += [s, e]
    edges.append(w1)
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    out = []
    stack: List[Tuple[str, float, float]] = []
    i = 0
    for s, e in gaps:  # in order; the host events nest on one thread
        mid = 0.5 * (s + e)
        while i < len(tr.host) and tr.host[i][1] <= mid:
            ev = tr.host[i]
            while stack and stack[-1][1] + stack[-1][2] < ev[1]:
                stack.pop()
            stack.append(ev)
            i += 1
        while stack and stack[-1][1] + stack[-1][2] < mid:
            stack.pop()
        label = stack[-1][0] if stack else "outside the updates"
        if label == UPDATE_SPAN:
            label = "host Python between ops"
        out.append((label, (e - s) * 1e-6))
    return out


def short_name(name: str) -> str:
    """A kernel's name without its parameter list and return type."""
    s = name.replace("(anonymous namespace)::", "")
    if s.startswith("void "):
        s = s[5:]
    depth = 0
    for k, ch in enumerate(s):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0:
            s = s[:k]
            break
    return s[:120]


def top(pairs, n: int = 10) -> list:
    """The `n` largest totals of (name, seconds) pairs summed by name."""
    totals = {}
    for name, sec in pairs:
        totals[name] = totals.get(name, 0.0) + sec
    return [[k, v] for k, v in sorted(totals.items(), key=lambda kv: -kv[1])
            [:n]]


def breakdown(tr: Trace) -> dict:
    """The result line's breakdown: the device ops that took most time and
    the idle stretches by what the host was doing, 10 of each."""
    return {"device_ops": top((short_name(n), d * 1e-6)
                              for n, _, d in tr.device_ops),
            "idle_gaps": top(idle_gaps(tr))}


_GLOBAL = re.compile(
    r"__global__\s+void\s+"
    r"(?:__launch_bounds__\s*\((?:[^()]|\([^()]*\))*\)\s*)?"
    r"([A-Za-z_]\w*)\s*\(")


def csrc_kernels(csrc: Path) -> set:
    """The names of the ``__global__`` functions in the port's CUDA
    sources."""
    names = set()
    for path in sorted(Path(csrc).glob("*.cu")):
        names.update(_GLOBAL.findall(path.read_text()))
    return names


def is_csrc(name: str, names: set) -> bool:
    """Whether a kernel of the trace is one of the port's own: its name is
    one of `names`, outside any namespace but an anonymous one."""
    s = name[5:] if name.startswith("void ") else name
    s = s.replace("(anonymous namespace)::", "", 1)
    m = re.match(r"[A-Za-z_]\w*", s)
    return bool(m) and m.group(0) in names and not s[m.end():].startswith(
        "::")
