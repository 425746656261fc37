"""PyTorch/CUDA port of the wavefront path tracer for one NVIDIA H100,
beside the JAX package it is tested against.

Hand-written CUDA kernels (csrc/, bound by ops/kernels/): the ray x sphere
batteries; the clustered traversal's planners and walks, resident and
streamed; the BVH and grid walks; the single-rounding multiply-add and its
contractions (fma); the light-selection rows (light_rows); one site of the
counter RNG; next-event estimation toward sphere lights (NEE). Everything
else is PyTorch."""
from .render.api import Renderer, render_image  # noqa: F401
from .scene import accel, builders, sky_models  # noqa: F401
from .utils.config import RendererPolicy  # noqa: F401

__version__ = "0.1.0"
