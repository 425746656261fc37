"""Lambertian closure of the main path, the port of the JAX package's
``ops/closures.py`` lambert functions (DataStreams.hpp:165-182). Directions
are in the local tangent frame (normal = +Z); ``estimator`` is
NdotL * brdf / pdf. GGX and the principled closure are later port slices."""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..core import sampling
from ..core.vec import Vec3

INV_PI = 1.0 / math.pi


class BsdfSample(NamedTuple):
    direction: Vec3  # local frame
    estimator: Vec3  # NdotL * brdf / pdf


def lambert_eval(albedo: Vec3, l_local: Vec3, v_local: Vec3) -> Vec3:
    n_dot_l = torch.clamp_min(l_local.z, 0.0)
    return albedo * (INV_PI * n_dot_l)


def lambert_pdf(l_local: Vec3) -> torch.Tensor:
    return INV_PI * torch.clamp_min(l_local.z, 0.0)


def lambert_sample(albedo: Vec3, v_local: Vec3, u, v) -> BsdfSample:
    return BsdfSample(direction=sampling.cosine_hemisphere(u, v),
                      estimator=albedo)
