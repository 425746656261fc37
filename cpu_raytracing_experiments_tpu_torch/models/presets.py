"""Named render models, the port of the JAX package's ``models/presets.py``:
curated policies, each a tested configuration of the integrator for one kind
of use (the reference's compile-time configuration axis, RendererPolicy NTTPs
and preprocessor switches, Renderer.hpp:19-30, 70-71, packaged as data).
Field for field the JAX package's presets, as port ``RendererPolicy``s.

    from cpu_raytracing_experiments_tpu_torch.models import presets
    policy = presets.get("production", max_bounces=6)
"""
from __future__ import annotations

import dataclasses

from ..utils.config import RendererPolicy

# Bit-parity with the reference's shipped configuration: lambertian BRDF,
# MIS on, brute-force intersection, uniform light selection, plain camera
# jitter, median-of-means, and the reference's sky bug.
REFERENCE_COMPAT = RendererPolicy(
    brdf="lambertian",
    mis=True,
    accel="brute",
    light_sampling="uniform",
    sky_bug_compat=True,
    shade_f80=False,  # the reference never reads Material::F80
)

# Reference semantics with its bugs fixed: the same sampling decisions, the
# correct sky contribution.
REFERENCE_FIXED = RendererPolicy()

# Interactive preview: shallow paths, several samples a pass; pair with
# render.denoise for display.
PREVIEW = RendererPolicy(
    max_bounces=4,
    samples_per_pixel=4,
    stratify_camera=True,
)

# Production stills: the full material model, deep paths, power-proportional
# light selection, stratified primary samples, a firefly clamp on top of
# median-of-means.
PRODUCTION = RendererPolicy(
    brdf="principled",
    max_bounces=12,
    light_sampling="power",
    stratify_camera=True,
    clamp_radiance=True,
    max_radiance=1e3,
)

# Physically strict, no clamp: furnace tests and ground-truth renders.
GROUND_TRUTH = RendererPolicy(
    brdf="principled",
    max_bounces=32,
    light_sampling="power",
)

# Large scenes: the same integrator, execution knobs sized for big
# batteries.
LARGE_SCENE = RendererPolicy(
    max_bounces=6,
    rays_per_chunk=1 << 16,
)

# Throughput-first mesh rendering: the clustered traversal with two samples
# a pass (two samples of a pixel in adjacent lanes of a traversal tile halve
# its screen footprint). Scenes need scene.accel.with_pallas_clusters.
THROUGHPUT = RendererPolicy(
    accel="pallas",
    samples_per_pixel=2,
    stratify_camera=True,
)

PRESETS = {
    "reference_compat": REFERENCE_COMPAT,
    "reference_fixed": REFERENCE_FIXED,
    "preview": PREVIEW,
    "production": PRODUCTION,
    "ground_truth": GROUND_TRUTH,
    "large_scene": LARGE_SCENE,
    "throughput": THROUGHPUT,
}


def get(name: str, **overrides) -> RendererPolicy:
    """A preset by name, with fields overridden."""
    policy = PRESETS[name]
    return dataclasses.replace(policy, **overrides) if overrides else policy
