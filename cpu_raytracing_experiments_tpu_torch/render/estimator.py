"""Progressive accumulation and median-of-means resolve, the port of the JAX
package's ``render/estimator.py`` (Renderer.hpp:38-68, 436-478).

Radiance is accumulated round-robin into 5 buckets (bucket = accumulation %
5); the resolve takes the per-pixel, per-channel median of the 5 bucket
means, scales by exposure / (accumulations / 5), and applies ACES. The
buckets are updated in place, where the JAX package returns new arrays: a
frame's buckets are the largest state the renderer keeps.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..core import color, fp, sampling
from ..core.rng import MASK
from ..scene.scene import Scene
from ..utils import profiling
from ..utils.config import RendererPolicy
from . import renderer as _renderer


@dataclasses.dataclass
class RenderState:
    """buckets: [B, 3, npix] float32 on the render device; accumulations: the
    u32 pass counter, kept on the host; rays_traced: 0-d int64 on the render
    device, the passes' ``ray_count`` summed since the last reset (the
    Mrays/s numerator; read it only after the passes, it syncs); reservoir:
    under ``light_sampling='restir'`` the per-pixel ReSTIR reservoirs
    carried from pass to pass, [3, npix] float32 (light index as a float,
    -1 = empty; contribution weight W; candidate count), else None. A reset
    empties them with the buckets. counts: [npix] float32 per-pixel pass
    counts on the render device once a pass has traced a pixel subset
    (``accumulate_pixels``), else None (every pixel traced every pass); a
    reset drops them."""

    buckets: torch.Tensor
    accumulations: int
    rays_traced: torch.Tensor
    reservoir: Optional[torch.Tensor] = None
    counts: Optional[torch.Tensor] = None

    @staticmethod
    def _empty_reservoir(npix: int, device=None) -> torch.Tensor:
        res = torch.zeros((3, npix), dtype=torch.float32, device=device)
        res[0] = -1.0
        return res

    @staticmethod
    def create(width: int, height: int, policy: RendererPolicy,
               device=None) -> "RenderState":
        return RenderState(
            torch.zeros((policy.accumulation_buckets, 3, width * height),
                        dtype=torch.float32, device=device),
            0, torch.zeros((), dtype=torch.int64, device=device),
            RenderState._empty_reservoir(width * height, device)
            if policy.light_sampling == "restir" else None)

    def reset(self) -> "RenderState":
        """ResetAccumulator (Renderer.hpp:64-67)."""
        res = self.reservoir
        return RenderState(
            torch.zeros_like(self.buckets), 0,
            torch.zeros_like(self.rays_traced),
            None if res is None
            else RenderState._empty_reservoir(res.shape[1], res.device))


def _add_pass(buckets, policy, acc: int, rad_x, rad_y, rad_z):
    with profiling.span("port.buckets"):
        buckets[acc % policy.accumulation_buckets] += torch.stack(
            [rad_x, rad_y, rad_z])


def _counts_plus(state: RenderState, k: int):
    return None if state.counts is None else state.counts + float(k)


def accumulate(scene: Scene, policy: RendererPolicy, state: RenderState,
               width: int, height: int) -> RenderState:
    """One progressive sample per pixel into bucket accumulations % B
    (Renderer.hpp:73-84), the ReSTIR reservoirs carried through the pass."""
    acc = (state.accumulations + 1) & MASK
    reservoir = state.reservoir
    if policy.light_sampling == "restir" and reservoir is not None:
        rad, count, reservoir = _renderer.render_pass(
            scene, policy, acc, width, height, restir_in=reservoir)
    else:
        rad, count = _renderer.render_pass(scene, policy, acc, width, height)
    _add_pass(state.buckets, policy, acc, *rad)
    return RenderState(state.buckets, acc, state.rays_traced + count,
                       reservoir, _counts_plus(state, 1))


def accumulate_pixels(scene: Scene, policy: RendererPolicy,
                      state: RenderState, width: int, height: int,
                      pixel_ids: torch.Tensor,
                      valid: torch.Tensor) -> RenderState:
    """One progressive sample for a pixel subset (per-pixel adaptive sample
    allocation; the reference traces every pixel every pass,
    Renderer.hpp:75). `pixel_ids` [N] lists flat pixels, `valid` [N] masks
    the padding entries (any id; they add nothing). The pass counter still
    advances globally (it keys the RNG), but only the listed pixels receive
    the sample, and ``state.counts`` keeps each pixel's passes for the
    count-aware resolve. As in the JAX package the sample goes into a zero
    frame by a scatter-add that tolerates repeated ids, and the frame is then
    added to the bucket, so untraced pixels keep their bits."""
    acc = (state.accumulations + 1) & MASK
    rad, count = _renderer.render_pass_pixels(scene, policy, acc, width,
                                              pixel_ids, valid)
    ids = pixel_ids.to(torch.int64)
    vf = valid.to(torch.float32)
    npix = state.buckets.shape[-1]
    frame = torch.zeros((3, npix), dtype=torch.float32,
                        device=state.buckets.device)
    frame.index_add_(1, ids, torch.stack([rad.x * vf, rad.y * vf,
                                          rad.z * vf]))
    counts = state.counts
    if counts is None:
        counts = torch.full((npix,), float(state.accumulations),
                            dtype=torch.float32, device=frame.device)
    counts = counts.index_add(0, ids, vf)
    state.buckets[acc % policy.accumulation_buckets] += frame
    return RenderState(state.buckets, acc, state.rays_traced + count,
                       state.reservoir, counts)


def stderr_arrays(buckets: torch.Tensor, accumulations: int,
                  counts: Optional[torch.Tensor]) -> torch.Tensor:
    """[n] per-pixel standard error of the running mean from the spread of
    the B bucket means (channel-averaged), as the JAX package's jitted
    ``stderr_arrays`` computes it bit for bit: each pixel's bucket sums are
    divided by its passes per bucket (accumulations // B, or counts / B
    with ``counts``), then ``var(axis=0, ddof=1).mean(axis=0) / B`` in
    XLA's order. XLA turns each division by a constant into a product by
    its float32 reciprocal (the mean over the channels and the / B into one
    product by float32(1/3) * float32(1/B)), sums the B terms of the mean
    left to right and contracts the squares and the channel sum into fma
    chains. The adaptive rounds rank pixels by this value, so one ulp can
    change which pixels a round traces."""
    b = buckets.shape[0]
    n = buckets.shape[-1]
    if b <= 1:
        return torch.zeros((n,), dtype=torch.float32, device=buckets.device)
    inv_b = float(np.float32(1.0 / b))
    if counts is None:
        acc = torch.tensor(float(accumulations), dtype=torch.float32)
        per_bucket = torch.clamp_min(torch.floor(acc * inv_b), 1.0).to(
            buckets.device)
    else:
        per_bucket = torch.clamp_min(counts * inv_b, 1.0)
    means = buckets / per_bucket
    centred = means - _renderer.sum_rows(means) * inv_b
    sq = centred[0] * centred[0]
    for k in range(1, b):
        sq = fp.fma(centred[k], centred[k], sq)
    inv_dof = float(np.float32(1.0 / (b - 1)))
    total = sq[0] * inv_dof
    for c in (1, 2):
        total = fp.fma(sq[c], inv_dof, total)
    scale = float(np.float32(np.float32(1.0 / 3.0) * np.float32(inv_b)))
    return fp.sqrt(total * scale)


def pixel_stderr(state: RenderState) -> torch.Tensor:
    return stderr_arrays(state.buckets, state.accumulations, state.counts)


def accumulate_wide(scene: Scene, policy: RendererPolicy, state: RenderState,
                    width: int, height: int, k: int) -> RenderState:
    """k passes traced as one wide wavefront; every bucket is bit-identical
    to k sequential ``accumulate`` calls."""
    acc0 = (state.accumulations + 1) & MASK
    rad, count = _renderer.render_pass(scene, policy, acc0, width, height,
                                       k_passes=k)
    for i in range(k):
        _add_pass(state.buckets, policy, (acc0 + i) & MASK,
                  rad.x[i], rad.y[i], rad.z[i])
    return RenderState(state.buckets, (acc0 + k - 1) & MASK,
                       state.rays_traced + count, state.reservoir,
                       _counts_plus(state, k))


def launch_width(policy: RendererPolicy, width: int, height: int) -> int:
    """Passes per wavefront launch for accumulate_n: fill rays_per_chunk,
    cap 8 ('auto'), or policy.passes_per_launch; 1 under 'restir', whose
    reservoirs chain pass to pass."""
    if policy.light_sampling == "restir":
        return 1
    ppl = policy.passes_per_launch
    if ppl == "auto":
        per_pass = width * height * policy.samples_per_pixel
        return max(1, min(8, policy.rays_per_chunk // per_pass))
    return max(1, int(ppl))


def accumulate_n(scene: Scene, policy: RendererPolicy, state: RenderState,
                 width: int, height: int, n: int) -> RenderState:
    """n passes: launch_width passes per wavefront launch, then the
    remainder one at a time (bit-identical to n sequential passes)."""
    k = min(launch_width(policy, width, height), n)
    if k > 1:
        for _ in range(n // k):
            state = accumulate_wide(scene, policy, state, width, height, k)
        n = n % k
    for _ in range(n):
        state = accumulate(scene, policy, state, width, height)
    return state


def resolve(state: RenderState, policy: RendererPolicy, exposure, width: int,
            height: int, tonemap: bool = True) -> torch.Tensor:
    """Median-of-means resolve + ACES (Renderer.hpp:436-478): an [H, W, 3]
    image, row 0 = bottom scanline. Bucket weights are equal only when
    accumulations is a multiple of the bucket count, as in the reference."""
    b = policy.accumulation_buckets
    buckets = state.buckets
    if state.counts is not None:
        # the count-aware resolve of adaptive sampling: a bucket holds
        # counts / B of the pixel's passes (subset rounds come in bucket
        # multiples); XLA divides by the constant B as a product by its
        # float32 reciprocal
        n_rounds = torch.clamp_min(
            state.counts * float(np.float32(1.0 / b)), 1.0)
    else:
        n_rounds = torch.tensor(float(max(state.accumulations // b, 1)),
                                dtype=torch.float32, device=buckets.device)
    scale = torch.as_tensor(exposure, dtype=torch.float32).to(buckets.device) \
        / (n_rounds * policy.samples_per_pixel)
    if policy.median and b == 5:
        channels = [sampling.median5(*[buckets[k, c] for k in range(5)])
                    * scale for c in range(3)]
    elif policy.median:
        channels = [buckets[:, c, :].median(dim=0).values * scale
                    for c in range(3)]
    else:  # average-of-buckets variant (Renderer.hpp:457-459)
        # XLA folds jnp.mean's division into the scale: the bucket sum
        # times scale * float32(1/B)
        scale_b = scale * torch.tensor(1.0 / b, dtype=torch.float32)
        channels = [_renderer.sum_rows(buckets[:, c, :]) * scale_b
                    for c in range(3)]
    r, g, bl = channels
    if tonemap:
        r, g, bl = color.tonemap_aces(r, g, bl)
    return torch.stack([r.reshape(height, width), g.reshape(height, width),
                        bl.reshape(height, width)], dim=-1)


def resolve_hdr(state: RenderState, policy: RendererPolicy, exposure,
                width: int, height: int) -> torch.Tensor:
    """Linear-radiance resolve (no tonemap)."""
    return resolve(state, policy, exposure, width, height, tonemap=False)
