"""Renderer configuration, field for field the JAX package's
``utils/config.py::RendererPolicy`` with the same defaults, so a policy and
its fingerprint mean the same thing in both packages.

The PyTorch port renders scenes of spheres and triangles (the dense
batteries, the clustered traversal of ``accel='pallas'`` under each of its
planners, resident or streamed, with the ordinary or the product-form
triangle battery, or ``accel='clustered'``, 'grid' and 'bvh'; lambertian,
GGX or principled shading, pinhole or thin lens camera, jittered or
stratified, with or without the scrambled RNG, any samples_per_pixel,
every light selection ('uniform', 'power', 'alias', 'ris', 'restir'), MIS,
Russian roulette, wavefront narrowing, raster or screen-tile ray order,
median or mean resolve). A ``pallas_plan`` outside the port's planners is
accepted here and refused with ``NotImplementedError`` by
``render.renderer.check_policy`` before any work is done. The pallas_* schedule knobs (``pallas_unroll``, ``pallas_fuse``,
``pallas_trav_block``, ``pallas_exit_refresh``, ``pallas_prefetch``,
``pallas_plan_block``) and ``pallas_interpret`` describe how the JAX
package runs its TPU kernels; the port accepts them and they change nothing.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class RendererPolicy:
    """Static render-policy knobs. See the JAX package's ``RendererPolicy``
    for the measured rationale behind each default."""

    log_tile: int = 4  # (2^log_tile)^2-pixel tiles key the RNG path index
    samples_per_pixel: int = 1
    max_material_id: int = 64
    max_bounces: int = 16
    max_radiance: float = 1e2  # ceiling used when clamp_radiance=True
    clamp_radiance: bool = False
    accumulation_buckets: int = 5  # median-of-means buckets

    brdf: str = "lambertian"  # 'lambertian' | 'ggx' | 'principled'
    shade_f80: bool = True
    mis: bool = True
    light_sampling: str = "uniform"  # 'uniform' | 'power' | 'alias' | 'ris' | 'restir'
    use_bvh: bool = False
    accel: str = "brute"  # 'brute' | 'bvh' | 'grid' | 'clustered' | 'pallas'
    pallas_mxu: bool = False
    pallas_plan: str = "ray"
    pallas_tile_rays: object = "auto"
    pallas_sort_visits: bool = True
    pallas_sort_impl: str = "kernel"
    pallas_compact: bool = False
    pallas_interpret: bool = False
    pallas_plan_block: int = 8
    pallas_unroll: int = 1
    pallas_fuse: object = "auto"
    pallas_trav_block: int = 1
    pallas_exit_refresh: int = 8
    pallas_prefetch: bool = False
    pallas_stream: object = "auto"
    primary_accel: Optional[str] = None
    ray_order: str = "auto"  # 'auto' | 'tile' | 'raster'
    median: bool = True
    narrow_wavefront: object = "auto"  # True | False | 'auto'
    narrow_factors: tuple = (4, 32)
    passes_per_launch: object = "auto"  # int | 'auto'
    rays_per_chunk: int = 1 << 19  # microbatch size of the wavefront loop
    sky_bug_compat: bool = False
    russian_roulette: bool = True
    stratify_camera: bool = False
    rng_scramble: bool = False
    restir_temporal_cap: int = 2
    restir_spatial: int = 4
    restir_radius: int = 2
    restir_spatial_2d: bool = True
    restir_reject: bool = True
    enable_dof: bool = False

    @property
    def effective_accel(self) -> str:
        return "bvh" if (self.use_bvh and self.accel == "brute") else self.accel

    @property
    def tile_root(self) -> int:
        return 1 << self.log_tile

    @property
    def tile_size(self) -> int:
        return self.tile_root * self.tile_root

    def __post_init__(self):
        def check(ok, what):
            if not ok:
                raise ValueError(f"RendererPolicy: {what}")

        check(self.brdf in ("lambertian", "ggx", "principled"), self.brdf)
        check(self.accel in ("brute", "bvh", "grid", "clustered", "pallas"),
              self.accel)
        check(self.light_sampling in ("uniform", "power", "alias", "ris",
                                      "restir"), self.light_sampling)
        check(self.accumulation_buckets % 2 == 1, "median needs odd buckets")
        check(self.pallas_unroll in (1, 2, 4, 8), self.pallas_unroll)
        check(self.pallas_sort_impl in ("kernel", "xla"), self.pallas_sort_impl)
        check(self.pallas_fuse in (False, True, 0, 2, 4, "auto"),
              self.pallas_fuse)
        check(not (self.pallas_fuse and self.pallas_fuse != "auto"
                   and self.pallas_unroll != 1),
              "pallas_fuse replaces the unroll schedule (fused visits)")
        check(self.pallas_trav_block in (1, 8), self.pallas_trav_block)
        check(self.pallas_exit_refresh in (8, 16, 32, 64),
              self.pallas_exit_refresh)
        check(self.pallas_prefetch in (True, False), self.pallas_prefetch)
        check(self.pallas_stream in (True, False, "auto"), self.pallas_stream)
        check(self.primary_accel in (None, "brute", "bvh", "grid", "clustered",
                                     "pallas"), self.primary_accel)
        if self.pallas_stream is True:
            check(not (self.pallas_mxu
                       or (self.pallas_fuse and self.pallas_fuse != "auto")
                       or self.pallas_unroll != 1
                       or self.pallas_trav_block != 1),
                  "pallas_stream=True excludes mxu/fuse/unroll/trav_block")

