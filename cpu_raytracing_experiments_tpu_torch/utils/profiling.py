"""Profiling hooks, the port of the JAX package's ``utils/profiling.py``.

The reference profiles with IACA marks and offline sampling, leaving stage
percentages as comments (iacaMarks.h, Renderer.hpp stage comments;
SURVEY.md section 5). Here:
  * ``trace()`` wraps a region in a ``torch.profiler`` trace (CPU and, on a
    card, CUDA activity) and writes it as a Chrome trace, readable in
    Perfetto or chrome://tracing;
  * ``stage_shares()`` reproduces the reference's stage-percentage table by
    timing ablated pipelines, each work item ended by a device
    synchronisation on the card.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from pathlib import Path

import torch


@contextlib.contextmanager
def trace(logdir: str = "torch-trace"):
    """A ``torch.profiler.profile`` over the block; on exit the trace is
    written to ``<logdir>/trace.json`` (Chrome trace format). Yields
    `logdir`."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    out = Path(logdir)
    out.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield logdir
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(str(out / "trace.json"))


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def stage_shares(scene, policy, width: int, height: int, repeats: int = 10):
    """Approximate per-stage cost shares (the reference's in-source
    percentages, Renderer.hpp:111-442) by timing ablated pipelines: full -
    (pipeline without stage) ~ stage cost. The passes run on the scene's
    device. Returns {stage: seconds}, the JAX package's keys."""
    from ..render import renderer as _r

    device = torch.device(scene.device)

    def timed(pol):
        _r.render_pass(scene, pol, 1, width, height)  # warm-up
        _sync(device)
        t0 = time.perf_counter()
        for _ in range(repeats):
            _r.render_pass(scene, pol, 1, width, height)
        _sync(device)
        return (time.perf_counter() - t0) / repeats

    full = timed(policy)
    no_mis = timed(dataclasses.replace(policy, mis=False))
    no_rr = timed(dataclasses.replace(policy, russian_roulette=False))
    one_bounce = timed(dataclasses.replace(policy, max_bounces=1))
    return {
        "full_s": full,
        "nee_shadow_s": max(full - no_mis, 0.0),
        "russian_roulette_s": max(full - no_rr, 0.0),
        "first_bounce_s": one_bounce,
        "later_bounces_s": max(full - one_bounce, 0.0),
    }
