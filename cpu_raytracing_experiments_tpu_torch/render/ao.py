"""Ambient occlusion, the port of the JAX package's ``render/ao.py``: a
second render mode on the same machinery (no reference equivalent; its
closest analog is the disabled first-bounce debug output,
Renderer.hpp:218-231).

One camera ray a pixel, then K cosine-weighted hemisphere probes with a
finite occlusion radius: AO = 1 - mean(occluded). The probes draw from the
counter RNG, so the image is deterministic. It runs on the device of the
scene it is given.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import fp, rng, sampling
from ..ops import intersect
from ..scene.scene import Scene
from ..utils.config import RendererPolicy
from .probes import first_hits


def _ao_pass(scene: Scene, policy: RendererPolicy, width: int, height: int,
             samples: int, radius: float) -> torch.Tensor:
    """[H, W] ambient occlusion, row 0 = bottom scanline (JAX ``_ao_pass``):
    the camera rays of accumulation 1 without the thin lens; probe k of a
    pixel draws from ``hash_2d(2, seed + k)``; a miss lane probes with
    tfar = 0 (never occluded) and reads 1."""
    # XLA divides by the constant `samples` as a product by its float32
    # reciprocal, fused with 1 - ...: a pixel whose probes are all occluded
    # can read a hair below 0, as in the JAX package
    inv_samples = float(np.float32(1.0 / samples))
    rows = []
    for seeds, frame, _, prim_id in first_hits(scene, policy, width, height,
                                               1, False):
        p_off, t_quat = frame[0], frame[2]
        hit = prim_id >= 0
        tfar = torch.where(hit, float(np.float32(radius)), 0.0)
        occluded = torch.zeros_like(tfar)
        for k in range(samples):
            u, v = rng.site_draws(2, seeds, k, 2, False)
            d = sampling.to_world(t_quat, sampling.cosine_hemisphere(u, v))
            occ = intersect.occluded_scene(scene, p_off, d, tfar,
                                           accel=policy.effective_accel)
            occluded = occluded + occ.to(torch.float32)
        rows.append(torch.where(hit, fp.fma(occluded, -inv_samples, 1.0),
                                1.0))
    return torch.cat(rows).reshape(height, width)


def render_ao(scene: Scene, policy: RendererPolicy, width: int, height: int,
              samples: int = 32, radius: float = 1e3) -> np.ndarray:
    """AO image [H, W, 3] float32 in [0, 1], row 0 = top."""
    img = _ao_pass(scene, policy, width, height, samples,
                   radius).cpu().numpy()[::-1]
    return np.repeat(img[..., None], 3, axis=-1)
