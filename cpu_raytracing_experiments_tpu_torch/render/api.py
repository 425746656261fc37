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

from ..core.rng import MASK
from ..ops import intersect
from ..scene.scene import Scene
from ..utils import profiling
from ..utils.config import RendererPolicy
from ..utils.metrics import pixel_variance_map
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


def _tol32(tol) -> float:
    """`tol` rounded to float32, as the JAX package passes it
    (``jnp.float32(tol)``)."""
    return float(np.float32(tol))


def _count_active(state: estimator.RenderState, tol) -> int:
    """Pixels whose standard error exceeds `tol` (JAX ``_count_active_jit``):
    one number read back."""
    return int((estimator.pixel_stderr(state) > _tol32(tol)).sum())


def _adaptive_round(scene: Scene, policy: RendererPolicy,
                    state: estimator.RenderState, width: int, height: int,
                    tol, tier: int):
    """One adaptive round (the body of JAX ``_adaptive_round_jit``): the
    `tier` pixels of highest standard error, worst first (a stable sort, so
    ties keep pixel order as ``jnp.argsort`` does), those already under
    `tol` masked off, traced for B subset passes. Returns (state, pixels
    traced, pixels still above `tol`), the two counts as 0-d tensors on the
    render device: nothing is read back here."""
    tol = _tol32(tol)
    se = estimator.pixel_stderr(state)
    order = torch.argsort(-se, stable=True)[:tier]
    valid = se[order] > tol
    n_traced = valid.sum()
    for _ in range(policy.accumulation_buckets):
        state = estimator.accumulate_pixels(scene, policy, state, width,
                                            height, order, valid)
    n_next = (estimator.pixel_stderr(state) > tol).sum()
    return state, n_traced, n_next


def _adaptive_tier(scene: Scene, policy: RendererPolicy,
                   state: estimator.RenderState, width: int, height: int,
                   tol, tier: int, max_rounds: int, last_tier: bool):
    """Every adaptive round at one tier size (JAX ``_adaptive_tier_jit``,
    whose device-side while_loop becomes a host loop reading one count a
    round): rounds go on while the active count still selects this tier by
    the host's rule (above tier // 2, or above 0 on the last tier; at most
    `tier`, unbounded at the full frame) and `max_rounds` remain. The
    per-pixel counts are made up front, as there. Returns (state, pixels
    traced, active count, rounds run)."""
    floor = 0 if last_tier else tier // 2
    cap = tier if tier != width * height else 1 << 30
    if state.counts is None:
        state = dataclasses.replace(state, counts=torch.full(
            (state.buckets.shape[-1],), float(state.accumulations),
            dtype=torch.float32, device=state.buckets.device))
    n_active = _count_active(state, tol)
    traced, rounds = 0, 0
    while floor < n_active <= cap and rounds < max_rounds:
        state, n_traced, n_next = _adaptive_round(scene, policy, state,
                                                  width, height, tol, tier)
        traced = traced + n_traced
        n_active = int(n_next)
        rounds += 1
    return state, int(traced), n_active, rounds


def adaptive_tiers(npix: int):
    """The static subset sizes of the adaptive rounds: npix, halved while
    at least max(npix // 64, 256)."""
    tiers = []
    t = npix
    while t >= max(npix // 64, 256):
        tiers.append(t)
        t //= 2
    return tiers


class Renderer:
    """Progressive accumulator: any scene edit resets it; renders continue
    indefinitely and resolve on demand (every `buckets` accumulations for
    equal weighting)."""

    def __init__(self, scene: Scene, policy: Optional[RendererPolicy] = None,
                 width: int = 256, height: int = 256, device=None):
        self.device = resolve_device(device)
        self.policy = policy or RendererPolicy()
        check_policy(self.policy)
        self.width = width
        self.height = height
        self._set_scene(scene)
        cam = self.scene.camera
        if (float(cam.half_width) * 2 != width
                or float(cam.half_height) * 2 != height):
            self.scene = dataclasses.replace(
                self.scene, camera=cam.resized(width, height))
        self.state = estimator.RenderState.create(width, height, self.policy,
                                                  self.device)

    def _set_scene(self, scene: Scene):
        """`scene` on the render device, with the streamed walks' packed
        tables made for every cluster pack the policy walks streamed."""
        self.scene = scene.to(self.device)
        if "pallas" in (self.policy.effective_accel,
                        self.policy.primary_accel):
            intersect.prepare_stream(self.policy, self.scene)

    def resize(self, width: int, height: int):
        """Renderer::Resize (Renderer.hpp:53-63): new frame, the camera's
        projection rescaled, the accumulator reset."""
        self.width, self.height = width, height
        self.scene = dataclasses.replace(
            self.scene, camera=self.scene.camera.resized(width, height))
        self.state = estimator.RenderState.create(width, height, self.policy,
                                                  self.device)

    def update_scene(self, scene: Scene):
        """Scene edit entry point: swap the scene (moved to the render
        device) and reset the accumulator (UpdateTracker semantics,
        Application.cpp:343-358, 508-510)."""
        self._set_scene(scene)
        self.reset_accumulator()

    def reset_accumulator(self):
        """Renderer::ResetAccumulator (Renderer.hpp:64-67); also empties the
        ReSTIR reservoirs."""
        self.state = self.state.reset()

    def accumulate(self, n: int = 1):
        """n progressive samples per pixel (Renderer::Accumulate), in a
        ``port.update`` span whose update_id is the first pass's
        accumulation index."""
        with profiling.span("port.update",
                            update_id=(self.state.accumulations + 1) & MASK,
                            passes=n):
            self.state = estimator.accumulate_n(
                self.scene, self.policy, self.state, self.width, self.height,
                n)

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

    def variance_map(self) -> np.ndarray:
        """[H, W] per-pixel variance of the running mean from the bucket
        spread (no extra samples), on the host; row 0 is the top scanline,
        as in render()."""
        v = pixel_variance_map(self.state.buckets.cpu().numpy(),
                               self.state.accumulations)
        return v.reshape(self.height, self.width)[::-1]

    def render_to_tolerance(self, tol: float, max_spp: int = 10000,
                            check_every: Optional[int] = None,
                            tonemap: bool = True,
                            quantile: float = 0.99) -> np.ndarray:
        """Adaptive stopping: accumulate in bucket-multiple steps until the
        `quantile`-th per-pixel standard error (``variance_map``) drops
        below `tol` (linear radiance) or max_spp passes are reached."""
        b = self.policy.accumulation_buckets
        step = check_every or 5 * b
        step = -(-step // b) * b
        while self.state.accumulations < max_spp:
            self.accumulate(step)
            se = float(np.sqrt(np.quantile(self.variance_map(), quantile)))
            if se < tol:
                break
        return self.render(tonemap=tonemap)

    def render_adaptive(self, tol: float, max_spp: int = 10000,
                        warmup: Optional[int] = None, tonemap: bool = True):
        """Per-pixel adaptive sample allocation: after a uniform warmup,
        each round traces only the pixels whose bucket-spread standard
        error still exceeds `tol`, worst first, in rounds of B subset
        passes so every bucket keeps an equal per-pixel share and the
        count-aware median-of-means resolve stays exact. Rounds run by tier
        (``_adaptive_tier``): the host picks the smallest static subset
        size that holds the active pixels and re-picks when the count
        leaves it; a round reads one count back. Resumes from a state past
        its warmup.

        Returns (image, stats), stats = {'samples_traced',
        'uniform_equivalent', 'saved_fraction', 'max_spp_pixel'}."""
        b = self.policy.accumulation_buckets
        npix = self.width * self.height
        warmup = -(-(warmup or 4 * b) // b) * b
        acc = self.state.accumulations
        need = -(-max(0, warmup - acc) // b) * b
        if need:
            self.accumulate(need)
            acc += need
        traced = need * npix
        tiers = adaptive_tiers(npix)
        n_active = _count_active(self.state, tol)
        min_tier = tiers[-1]
        while acc < max_spp:
            if n_active == 0:
                break
            tier = next((t for t in reversed(tiers) if t >= n_active), npix)
            max_rounds = (max_spp - acc) // b
            if max_rounds == 0:
                break
            self.state, n_traced, n_active, rounds = _adaptive_tier(
                self.scene, self.policy, self.state, self.width, self.height,
                tol, tier, max_rounds, tier == min_tier)
            traced += b * n_traced
            acc += b * rounds
        img = self.render(tonemap=tonemap)
        uniform_equiv = acc * npix
        counts = (self.state.counts.cpu().numpy()
                  if self.state.counts is not None
                  else np.full(npix, float(acc)))
        stats = {
            "samples_traced": int(traced),
            "uniform_equivalent": int(uniform_equiv),
            "saved_fraction": 1.0 - traced / max(uniform_equiv, 1),
            "max_spp_pixel": float(counts.max()),
        }
        return img, stats


def render_image(scene: Scene, width: int, height: int, spp: int,
                 policy: Optional[RendererPolicy] = None, tonemap: bool = True,
                 device=None) -> np.ndarray:
    """One-shot render: [H, W, 3] float32, row 0 = top scanline."""
    return Renderer(scene, policy, width, height, device).render_spp(
        spp, tonemap=tonemap)
