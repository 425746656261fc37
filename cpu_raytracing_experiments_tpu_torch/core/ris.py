"""Resampled importance sampling (RIS) and weighted reservoirs, the port of
the JAX package's ``core/ris.py`` (the reference's dormant ReSTIR building
blocks, Sampling.hpp:25-73) as plain tensor functions.

A reservoir streams candidate samples with weights and keeps one survivor
with probability proportional to its weight; ``ris`` draws `count`
candidates from a source distribution and returns the selected sample with
its unbiased contribution weight W = weight_sum / (M * p_hat(selected)).
No render calls these: the renderer's RIS and ReSTIR light selection is
written inline (``render/renderer.py``), as in the JAX package.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from . import rng as _rng


class Reservoir(NamedTuple):
    """SoA batched reservoir (Sampling.hpp:27-37)."""

    sample: torch.Tensor  # [R] int32 selected candidate (-1 = empty)
    weight: torch.Tensor  # [R] float32 contribution weight W
    weight_sum: torch.Tensor  # [R] float32
    count: torch.Tensor  # [R] int32 candidates seen

    @staticmethod
    def empty(shape, device=None) -> "Reservoir":
        return Reservoir(
            sample=torch.full(shape, -1, dtype=torch.int32, device=device),
            weight=torch.zeros(shape, dtype=torch.float32, device=device),
            weight_sum=torch.zeros(shape, dtype=torch.float32, device=device),
            count=torch.zeros(shape, dtype=torch.int32, device=device))

    def update(self, candidate, weight, random_01,
               num_samples=1) -> "Reservoir":
        """Streaming weighted selection (Sampling.hpp:31-36)."""
        weight_sum = self.weight_sum + weight
        take = random_01 < torch.div(weight,
                                     torch.clamp_min(weight_sum, 1e-30))
        return Reservoir(
            sample=torch.where(take, candidate, self.sample),
            weight=self.weight,
            weight_sum=weight_sum,
            count=(self.count + num_samples).to(torch.int32))


def _contribution_weight(r: Reservoir, weight_sample: Callable):
    """(ok, W): W = weight_sum / (count * max(p_hat, 1e-30)) where the
    reservoir holds a sample of positive target weight, else 0."""
    ok = r.sample >= 0
    w = weight_sample(torch.clamp_min(r.sample, 0))
    ok = ok & (w > 0.0)
    weight = torch.where(ok, torch.div(
        r.weight_sum,
        r.count.to(torch.float32) * torch.clamp_min(w, 1e-30)), 0.0)
    return ok, weight


def ris(count: int, src_dist: Callable, weight_sample: Callable, rng_state):
    """Resampled importance sampling (Sampling.hpp:42-54).

    src_dist(i, state) -> (state, candidate [R] int32, recip_pdf [R])
    weight_sample(candidate) -> target weight p_hat [R]
    Returns (rng_state, sample [R] int32, W [R]) with sample = -1 / W = 0
    where nothing viable was seen."""
    r = None
    state = rng_state
    for i in range(count):
        state, cand, rp = src_dist(i, state)
        if r is None:
            r = Reservoir.empty(cand.shape, cand.device)
        state, u = _rng.rand_unit_float(state)
        r = r.update(cand, weight_sample(cand) * rp, u)
    ok, weight = _contribution_weight(r, weight_sample)
    return state, torch.where(ok, r.sample, -1), weight


def combine_reservoirs(reservoirs, weight_sample: Callable, rng_state):
    """Merge reservoirs (spatial / temporal reuse, Sampling.hpp:56-73):
    (rng_state, merged Reservoir)."""
    r = reservoirs[0]
    state = rng_state
    for other in reservoirs[1:]:
        safe = torch.clamp_min(other.sample, 0)
        w = torch.where(
            other.sample >= 0,
            weight_sample(safe) * other.weight
            * other.count.to(torch.float32), 0.0)
        state, u = _rng.rand_unit_float(state)
        r = r.update(other.sample, w, u, num_samples=other.count)
    ok, weight = _contribution_weight(r, weight_sample)
    return state, Reservoir(sample=torch.where(ok, r.sample, -1),
                            weight=weight, weight_sum=r.weight_sum,
                            count=r.count)
