"""Pooled wavefront with ray regeneration, the port of the JAX package's
``render/wavefront_pool.py``: the compaction experiment.

The masked wavefront (``renderer.render_pass``) spends lanes on dead paths:
a chunk iterates until its longest surviving path dies, so late bounces run
mostly dead. The reference compacts the ray stream every bounce
(Renderer.hpp:357-404, 431); the fixed-shape equivalent is a ray pool with
**regeneration**: every iteration traces ONE bounce for the whole pool,
then dead lanes dump their radiance (a scatter-add by pixel id) and are
refilled with fresh camera rays from the pixel queue. Each lane carries its
own bounce (``PathState.bounce`` a [P] int32 tensor), so one step runs
lanes at different depths.

The RNG sites depend only on (accumulation, pixel seed, bounce), so a
pixel's path in the pool is the one it takes in the masked pass: the pooled
radiance and ray count equal ``render_pass``'s bit for bit (a pixel is
dumped once, into a zero entry).

Where the JAX package runs the loop on the device (``lax.while_loop``),
the port runs it on the host and reads one small tensor an iteration: the
number of rays issued and whether any lane is alive. The masked wavefront
stays the production path; ``chip_smoke.py`` phase 20 times the pool
against it on the card.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.rng import MASK
from ..core.vec import Vec3
from ..scene.scene import Scene
from ..utils.config import RendererPolicy
from . import renderer as _r


class PoolState(NamedTuple):
    path: _r.PathState  # lane state; path.bounce is a [P] int32 tensor
    pixel: torch.Tensor  # [P] int64 pixel id of each lane (-1 = empty)
    seeds: torch.Tensor  # [P] u32 (in int64) per-lane RNG base seed
    queue_head: int  # next pixel to issue (on the host)
    image: torch.Tensor  # [3, npix + P] radiance, then a drop slot a lane
    ray_count: torch.Tensor  # 0-d int64 holding a u32


def _dump(image: torch.Tensor, path: _r.PathState, pixel: torch.Tensor,
          drop: torch.Tensor):
    """Add the radiance of the dead lanes that hold a pixel into `image`;
    each other lane adds its zero into its own slot of `drop` (JAX
    ``.at[].add(mode="drop")``): one shared slot would serialize the atomic
    adds of every live lane."""
    dump = ~path.alive & (pixel >= 0)
    target = torch.where(dump, pixel, drop)
    image.index_add_(1, target, torch.stack(
        [torch.where(dump, c, 0.0) for c in path.radiance]))


def render_pass_pooled(scene: Scene, policy: RendererPolicy, accumulation,
                       width: int, height: int):
    """One progressive sample per pixel through the regeneration pool
    (JAX ``render_pass_pooled``): (radiance Vec3 of [npix] tensors in raster
    order, ray_count, a 0-d u32 in int64). The pool holds
    ``min(rays_per_chunk, npix)`` lanes; samples_per_pixel must be 1."""
    if policy.samples_per_pixel != 1:
        raise ValueError("the pooled path traces one sample a pixel "
                         f"(samples_per_pixel={policy.samples_per_pixel})")
    _r.check_policy(policy)
    device = scene.device
    npix = width * height
    pool = min(policy.rays_per_chunk, npix)
    accumulation = accumulation & MASK

    def fresh_rays(pixel_ids):
        """Camera rays and seeds for a vector of pixel ids (clamped)."""
        i = torch.clamp(pixel_ids, 0, npix - 1)
        seeds = _r.pixel_seeds_from_index(i, width, policy)
        p0, d0 = _r.generate_camera_rays(scene.camera, i % width, i // width,
                                         accumulation, seeds,
                                         policy.enable_dof, policy)
        return p0, d0, seeds

    zero = torch.zeros(pool, dtype=torch.float32, device=device)
    one = torch.ones_like(zero)
    no = torch.zeros(pool, dtype=torch.bool, device=device)
    s = PoolState(
        path=_r.PathState(
            bounce=torch.zeros(pool, dtype=torch.int32, device=device),
            p=Vec3(zero, zero, zero), d=Vec3(zero, zero, one),
            throughput=Vec3(one, one, one), radiance=Vec3(zero, zero, zero),
            prev_pdf=zero, prev_delta=no,
            alive=no,  # all dead: the first iteration refills every lane
            ray_count=torch.zeros((), dtype=torch.int64, device=device)),
        pixel=torch.full((pool,), -1, dtype=torch.int64, device=device),
        seeds=torch.zeros(pool, dtype=torch.int64, device=device),
        queue_head=0,
        image=torch.zeros((3, npix + pool), dtype=torch.float32,
                          device=device),
        ray_count=torch.zeros((), dtype=torch.int64, device=device))
    drop = npix + torch.arange(pool, dtype=torch.int64, device=device)
    any_alive = False
    while any_alive or s.queue_head < npix:
        path = s.path
        # 1) dump the dead lanes' radiance into the image
        _dump(s.image, path, s.pixel, drop)
        # 2) refill the dead lanes with queued camera rays, in lane order
        dead = ~path.alive
        candidate = s.queue_head + torch.cumsum(dead, 0) - 1
        take = dead & (candidate < npix)
        pixel = torch.where(take, candidate, torch.where(dead, -1, s.pixel))
        p0, d0, fresh_seeds = fresh_rays(candidate)
        path = _r.PathState(
            bounce=torch.where(take, 0, path.bounce),
            p=p0.where(take, path.p), d=d0.where(take, path.d),
            throughput=Vec3(one, one, one).where(take, path.throughput),
            radiance=Vec3(zero, zero, zero).where(take, path.radiance),
            prev_pdf=torch.where(take, 0.0, path.prev_pdf),
            prev_delta=path.prev_delta & ~take,
            alive=path.alive | take, ray_count=path.ray_count)
        seeds = torch.where(take, fresh_seeds, s.seeds)
        # 3) one bounce for the whole (now dense) pool
        path = _r.bounce_step(scene, policy, accumulation, seeds, path)
        issued, alive = torch.stack([take.sum(), path.alive.sum()]).tolist()
        any_alive = alive > 0
        s = PoolState(path, pixel, seeds, s.queue_head + issued, s.image,
                      path.ray_count)
    # the lanes that died on the last iteration
    _dump(s.image, s.path, s.pixel, drop)
    return Vec3(*s.image[:, :npix]), s.ray_count
