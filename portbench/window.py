"""The measured window: updates back to back for a fixed time, and the
statistics over all of them."""
from __future__ import annotations

import time
from typing import Callable, List, Optional


def run(update: Callable[[], None], seconds: float,
        max_updates: Optional[int] = None) -> tuple:
    """Call `update` (which returns once its work is done) back to back until
    `seconds` have passed, ending with the update in flight, or after
    `max_updates`. Returns (each update's seconds, the window's seconds,
    from the first update's start to the last one's end)."""
    times: List[float] = []
    start = time.perf_counter()
    end = start
    while True:
        t0 = time.perf_counter()
        update()
        end = time.perf_counter()
        times.append(end - t0)
        if end - start >= seconds or (max_updates is not None
                                      and len(times) >= max_updates):
            return times, end - start


def quantile(values, q: float) -> float:
    """The q-quantile of all `values`, interpolated linearly between order
    statistics (numpy's default, Python's 'inclusive' method)."""
    xs = sorted(values)
    if not xs:
        raise ValueError("quantile of no values")
    pos = q * (len(xs) - 1)
    lo = int(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)

