"""Checkpoint / resume for long progressive renders, the port of the JAX
package's ``render/checkpoint.py``.

The render state is the accumulator: the buckets and the pass counter
(Renderer.hpp:46-48), and with them the ReSTIR reservoirs and the adaptive
per-pixel counts where the state has them. The counter-based RNG makes N
more passes from a checkpoint bit-identical to an uninterrupted render. A
policy fingerprint refuses a resume under another sampling configuration.

The file is the JAX package's ``.npz`` layout (``version``, ``buckets``,
``accumulations`` as uint32, ``fingerprint``, optional ``reservoir`` and
``counts``), and the two ``RendererPolicy`` classes have the same fields and
defaults, so a checkpoint either package writes loads in the other.
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import numpy as np
import torch

from ..utils.config import RendererPolicy
from .api import resolve_device
from .estimator import RenderState

FORMAT_VERSION = 1


def policy_fingerprint(policy: RendererPolicy, width: int, height: int) -> str:
    fields = dataclasses.asdict(policy)
    fields.pop("rays_per_chunk", None)  # execution-only knob; safe to change
    return json.dumps({"policy": fields, "w": width, "h": height},
                      sort_keys=True)


def save(path, state: RenderState, policy: RendererPolicy, width: int,
         height: int):
    """Serialize the render state to one compressed .npz."""
    extra = {}
    if state.reservoir is not None:
        # a resumed ReSTIR render continues from the same reservoirs
        extra["reservoir"] = state.reservoir.cpu().numpy()
    if state.counts is not None:
        # without them the resolve would take the uniform divide and
        # mis-weight every pixel the adaptive rounds skipped
        extra["counts"] = state.counts.cpu().numpy()
    np.savez_compressed(
        path,
        version=FORMAT_VERSION,
        buckets=state.buckets.cpu().numpy(),
        accumulations=np.asarray(state.accumulations, dtype=np.uint32),
        fingerprint=policy_fingerprint(policy, width, height),
        **extra,
    )


def load(path, policy: RendererPolicy, width: int, height: int,
         device=None) -> RenderState:
    """Load a render state onto ``resolve_device(device)`` (the card unless
    the caller names another device); refuses a checkpoint of another render
    configuration. ``rays_traced`` is not in the file: it loads as 0."""
    device = resolve_device(device)
    with np.load(path, allow_pickle=False) as z:
        version = int(z["version"])
        if version != FORMAT_VERSION:
            raise ValueError(
                f"checkpoint version {version} != {FORMAT_VERSION}")
        fp = str(z["fingerprint"])
        want = policy_fingerprint(policy, width, height)
        if fp != want:
            raise ValueError(
                "checkpoint was produced under a different render config:\n"
                f"  checkpoint: {fp}\n  requested:  {want}")

        def tensor(key):
            return (torch.from_numpy(np.array(z[key], np.float32)).to(device)
                    if key in z else None)

        return RenderState(
            buckets=tensor("buckets"),
            accumulations=int(z["accumulations"]),
            rays_traced=torch.zeros((), dtype=torch.int64, device=device),
            reservoir=tensor("reservoir"),
            counts=tensor("counts"),
        )


def exists(path) -> bool:
    return Path(path).exists()
