"""Structured metrics, the port of the JAX package's ``utils/metrics.py``
(host numpy and the standard library; kept here so that the port imports
nothing of that package).

Replaces the reference's ImGui HUD (frame-time EWMA, Msamples/s plot,
Application.cpp:389-421) with per-step JSONL records: spp, wall time,
Mrays/s, spp/s, and a free variance estimate from the median-of-means
bucket spread: the B independent bucket means spread as sigma^2 /
per_bucket, a consistent estimate of each pixel's variance (SURVEY.md
section 5).
"""
from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Optional

import numpy as np


class Ewma:
    """Frame-time EWMA, alpha = 2/(N+1) like the reference
    (Application.cpp:310-311 uses N=64)."""

    def __init__(self, n: int = 64):
        self.alpha = 2.0 / (n + 1)
        self.value: Optional[float] = None

    def update(self, x: float) -> float:
        self.value = x if self.value is None else (
            self.value + self.alpha * (x - self.value))
        return self.value


def bucket_variance_estimate(buckets: np.ndarray, accumulations: int) -> float:
    """Mean per-pixel variance of the sample mean, from the spread of the
    B independent bucket means. buckets: [B, 3, npix] sums."""
    b = buckets.shape[0]
    per_bucket = max(accumulations // b, 1)
    means = buckets / per_bucket
    # var of bucket means ~ sigma^2 / per_bucket; var of total mean = that / B
    var_of_bucket_means = means.var(axis=0, ddof=1) if b > 1 else np.zeros(1)
    return float(var_of_bucket_means.mean() / b)


def pixel_variance_map(buckets: np.ndarray, accumulations: int) -> np.ndarray:
    """Per-pixel variance of the running mean (channel-averaged), [npix]:
    ``bucket_variance_estimate`` without the spatial reduction, the basis
    of adaptive stopping."""
    b = buckets.shape[0]
    per_bucket = max(accumulations // b, 1)
    means = buckets / per_bucket
    if b <= 1:
        return np.zeros(buckets.shape[-1], np.float32)
    return (means.var(axis=0, ddof=1).mean(axis=0) / b).astype(np.float32)


class MetricsLogger:
    """Append-only JSONL metrics stream + stdout one-liners, the JAX
    package's records and keys."""

    def __init__(self, path=None, quiet: bool = False):
        self.path = Path(path) if path else None
        self.quiet = quiet
        self.ewma = Ewma()
        self._t_start = time.perf_counter()

    def log_step(self, spp: int, step_wall: float, width: int, height: int,
                 rays: Optional[int] = None,
                 buckets: Optional[np.ndarray] = None,
                 extra: Optional[dict] = None):
        rec = {
            "event": "step",
            "spp": spp,
            "wall_s": round(step_wall, 4),
            "total_wall_s": round(time.perf_counter() - self._t_start, 3),
            "wall_ewma_s": round(self.ewma.update(step_wall), 4),
            "Msamples_per_s": round(width * height / step_wall / 1e6, 3),
        }
        if rays is not None:
            rec["Mrays_per_s"] = round(rays / step_wall / 1e6, 2)
        if buckets is not None:
            rec["variance_estimate"] = bucket_variance_estimate(buckets, spp)
        if extra:
            rec.update(extra)
        self._emit(rec)

    def log(self, **rec):
        self._emit(rec)

    def _emit(self, rec: dict):
        line = json.dumps(rec)
        if self.path:
            with open(self.path, "a") as f:
                f.write(line + "\n")
        if not self.quiet:
            print(line, flush=True)
