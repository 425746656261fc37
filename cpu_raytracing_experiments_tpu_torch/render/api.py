"""High-level progressive renderer, the port of the JAX package's
``render/api.py`` (the reference's ResetAccumulator / Accumulate / Render
interface, Renderer.hpp:29-478).

Entry points run on the card: with ``device=None`` they use ``cuda`` and
raise if there is none. Pass ``device="cpu"`` to render on the CPU, where the
sphere batteries take their plain PyTorch versions.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..ops import intersect
from ..scene.scene import Scene
from ..utils.config import RendererPolicy
from . import estimator
from .renderer import check_policy


def resolve_device(device=None) -> torch.device:
    """`device`, or ``cuda`` when it is None; no silent CPU fallback."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to render on the "
            "CPU")
    return torch.device("cuda")


class Renderer:
    """Progressive accumulator: any scene edit resets it; renders continue
    indefinitely and resolve on demand (every `buckets` accumulations for
    equal weighting)."""

    def __init__(self, scene: Scene, policy: Optional[RendererPolicy] = None,
                 width: int = 256, height: int = 256, device=None):
        self.device = resolve_device(device)
        self.policy = policy or RendererPolicy()
        check_policy(self.policy, scene)
        self.width = width
        self.height = height
        self.scene = scene.to(self.device)
        if "pallas" in (self.policy.effective_accel,
                        self.policy.primary_accel):
            intersect.prepare_stream(self.policy, self.scene)
        cam = self.scene.camera
        if (float(cam.half_width) * 2 != width
                or float(cam.half_height) * 2 != height):
            self.scene = dataclasses.replace(
                self.scene, camera=cam.resized(width, height))
        self.state = estimator.RenderState.create(width, height, self.policy,
                                                  self.device)

    def reset_accumulator(self):
        """Renderer::ResetAccumulator (Renderer.hpp:64-67)."""
        self.state = self.state.reset()

    def accumulate(self, n: int = 1):
        """n progressive samples per pixel (Renderer::Accumulate)."""
        self.state = estimator.accumulate_n(
            self.scene, self.policy, self.state, self.width, self.height, n)

    def render(self, tonemap: bool = True) -> np.ndarray:
        """Median-of-means resolve (+ACES): [H, W, 3] float32, row 0 = TOP
        scanline (the y-up framebuffer flipped, Image.cpp:71-74)."""
        img = estimator.resolve(self.state, self.policy,
                                self.scene.camera.exposure, self.width,
                                self.height, tonemap)
        return img.cpu().numpy()[::-1]

    def render_spp(self, spp: int, tonemap: bool = True) -> np.ndarray:
        """Accumulate at least `spp` samples per pixel, rounded up to a
        bucket multiple so every bucket carries equal weight, then resolve."""
        b = self.policy.accumulation_buckets
        passes = -(-spp // self.policy.samples_per_pixel)
        self.accumulate(-(-passes // b) * b)
        return self.render(tonemap=tonemap)


def render_image(scene: Scene, width: int, height: int, spp: int,
                 policy: Optional[RendererPolicy] = None, tonemap: bool = True,
                 device=None) -> np.ndarray:
    """One-shot render: [H, W, 3] float32, row 0 = top scanline."""
    return Renderer(scene, policy, width, height, device).render_spp(
        spp, tonemap=tonemap)
