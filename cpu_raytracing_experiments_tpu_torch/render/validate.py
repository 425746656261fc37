"""Numerical guards, the port of the JAX package's ``render/validate.py``.

``check_render`` runs one pass and checks its radiance: the JAX package's
checkify assertions become explicit checks that raise ``FloatingPointError``
with the same message and the same first bad pixel. ``validate_scene``
checks a scene on the host before a long render (the reference aborts at
run time instead: a missing HDRI terminates, Application.cpp:226-229).
"""
from __future__ import annotations

import numpy as np
import torch

from ..scene.scene import Scene
from ..utils.config import RendererPolicy
from . import renderer as _renderer


def check_render(scene: Scene, policy: RendererPolicy, width: int,
                 height: int, accumulation: int = 1):
    """One pass on the scene's device; raises ``FloatingPointError`` on a
    non-finite or a negative radiance, channel by channel (r, g, b), the
    non-finite test first, naming the first bad pixel in raster order.
    Returns the radiance (a Vec3 of [npix] tensors) on success."""
    rad, _ = _renderer.render_pass(scene, policy, accumulation, width, height)
    for name, channel in (("r", rad.x), ("g", rad.y), ("b", rad.z)):
        for bad, what in ((~torch.isfinite(channel), "non-finite"),
                          (channel < 0.0, "negative")):
            if bool(bad.any()):
                i = int(torch.argmax(bad.to(torch.uint8)))
                raise FloatingPointError(
                    f"{what} radiance in channel {name} (first bad pixel "
                    f"{i})")
    return rad


def validate_scene(scene: Scene) -> list:
    """Host-side pre-launch scene validation: a list of problem strings,
    empty when the scene is fine."""
    problems = []
    r_sq = scene.spheres.radius_sq.cpu().numpy()
    if (r_sq <= 0).any():
        problems.append(
            f"{int((r_sq <= 0).sum())} spheres with non-positive radius")
    for field, c in zip("xyz", scene.spheres.center):
        if not np.isfinite(c.cpu().numpy()).all():
            problems.append(f"non-finite sphere centers ({field})")
    em = np.stack([c.cpu().numpy() for c in scene.materials.emission], axis=1)
    if (em < 0).any():
        problems.append("negative emission")
    mat_ids = scene.spheres.material_id.cpu().numpy()
    if (mat_ids < 0).any() or (mat_ids >= scene.materials.count).any():
        problems.append("sphere material id out of range")
    if scene.triangles is not None:
        t_ids = scene.triangles.material_id.cpu().numpy()
        if (t_ids < 0).any() or (t_ids >= scene.materials.count).any():
            problems.append("triangle material id out of range")
        if (scene.triangles.area.cpu().numpy() <= 0).any():
            problems.append("degenerate (zero-area) triangles")
    if scene.num_lights == 0 and not bool(scene.sky.has_ambient()):
        problems.append("no lights and black sky: the render will be black")
    return problems
