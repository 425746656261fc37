"""PyTorch/CUDA port of the wavefront path tracer for one NVIDIA H100,
beside the JAX package it is tested against. The ray x sphere batteries and
the clustered traversal (planner and walks) are hand-written CUDA kernels
(csrc/); everything else is PyTorch."""
from .render.api import Renderer, render_image  # noqa: F401
from .scene import accel, builders, sky_models  # noqa: F401
from .utils.config import RendererPolicy  # noqa: F401

__version__ = "0.1.0"
