"""Coherence extraction, the port of the JAX package's ``ops/sort.py``: a
counting sort of ray indices by material id (the reference's per-tile sort,
DataStreams.hpp:221-253 and Renderer.hpp:235-243) and the stable
live-lanes-first order of a wavefront. A stable argsort is a stable counting
sort; ``torch.argsort(..., stable=True)`` gives ``jnp.argsort``'s
permutation, and every result is an integer.
"""
from __future__ import annotations

from typing import Tuple

import torch


def histogram(keys: torch.Tensor, num_bins: int) -> torch.Tensor:
    """Counts per key (DataStreams.hpp:221-232). keys: [N] int in
    [0, num_bins); int32 counts [num_bins]."""
    bins = torch.arange(num_bins, device=keys.device)
    return (keys[:, None] == bins[None, :]).to(torch.int32).sum(
        dim=0, dtype=torch.int32)


def prefix_sum(counts: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum (DataStreams.hpp:233-235)."""
    return torch.cumsum(counts, dim=0, dtype=counts.dtype)


def sort_ray_ids(mat_id: torch.Tensor,
                 num_materials: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stable sort of ray indices by material id, misses (-1) first
    (sort_rayID, DataStreams.hpp:239-253): (ray_ids [N] int32, the miss
    count, a 0-d int32). `num_materials` is the JAX signature's; the sort
    needs no bound."""
    keys = mat_id + 1  # -1 (miss) -> bin 0, the reference's +1 shift
    ray_ids = torch.argsort(keys, stable=True).to(torch.int32)
    return ray_ids, (keys == 0).sum(dtype=torch.int32)


def compaction_order(alive: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The permutation putting live lanes first, stably, and the live count
    (the reference's dense rewrite at output_index, Renderer.hpp:357-404)."""
    order = torch.argsort((~alive).to(torch.int8), stable=True)
    return order.to(torch.int32), alive.sum(dtype=torch.int32)
