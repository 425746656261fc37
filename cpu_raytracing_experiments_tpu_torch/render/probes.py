"""Interactive probes and first-bounce AOVs, the port of the JAX package's
``render/probes.py``.

* ``probe_depth`` / ``autofocus``: the reference's right-click depth probe
  (Application.cpp:271-304): one centred ray through the clicked pixel; the
  camera's focus distance becomes the hit distance (infinity on a miss).
* ``render_aovs``: first-bounce depth, normal, albedo and prim id (the
  reference keeps this behind ``#if false``, Renderer.hpp:218-231), the
  guides of the denoiser (``render/denoise.py``).

Both run on the device of the scene they are given.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from ..core import fp
from ..core.vec import Vec3
from ..ops import intersect
from ..scene.scene import Scene, _f32
from ..utils.config import RendererPolicy
from . import renderer as _renderer


def probe_depth(scene: Scene, x: int, y: int, width: int, height: int):
    """Depth of the closest hit through the centre of pixel (x, y) (y up,
    as the reference's flipped mouse coordinates); +inf on a miss. The
    ray is made and traced with the contractions of the render path; the
    JAX package's probe runs eagerly, without XLA's contractions, so the
    two depths can lie a few ulps apart."""
    camera = scene.camera
    if (float(camera.half_width) * 2 != width
            or float(camera.half_height) * 2 != height):
        camera = camera.resized(width, height)
    dev = scene.device
    vx = torch.tensor([x + 0.5], dtype=torch.float32, device=dev) \
        - camera.half_width
    vy = torch.tensor([y + 0.5], dtype=torch.float32, device=dev) \
        - camera.half_height
    # normalized as generate_camera_rays normalizes: the view depth is one
    # scalar, which XLA squares once outside the contraction
    inv = fp.rsqrt(torch.clamp_min(
        fp.fma(vx, vx, vy * vy) + camera.z * camera.z, 1e-30))
    d = camera.orient.rotate(Vec3(vx * inv, vy * inv, camera.z * inv))
    p = Vec3(*(c.expand(1).contiguous() for c in camera.pos))
    tfar, prim_id, _ = intersect.intersect_scene(scene, p, d)
    return float(tfar[0]) if int(prim_id[0]) >= 0 else float("inf")


def autofocus(scene: Scene, x: int, y: int, width: int, height: int) -> Scene:
    """The scene with camera.focus_distance set from ``probe_depth``
    (Application.cpp:298). The caller resets the accumulator, as the
    reference does (:299)."""
    dist = probe_depth(scene, x, y, width, height)
    camera = dataclasses.replace(scene.camera,
                                 focus_distance=_f32(dist, scene.device))
    return dataclasses.replace(scene, camera=camera)


def first_hits(scene: Scene, policy: RendererPolicy, width: int, height: int,
               accumulation: int, enable_dof: bool):
    """The camera rays of every pixel at `accumulation` (raster order, in
    ``rays_per_chunk`` chunks; the JAX package traces all pixels at once,
    and a lane's bits do not depend on the chunk) and their closest hits
    under the policy's backend: yields (pixel seeds, the closest-hit frame
    of ``renderer._closest_hit_frame``, tfar, prim_id) a chunk. Shared by
    the AOVs and ambient occlusion, which trace no further."""
    npix = width * height
    dev = scene.device
    i = torch.arange(npix, dtype=torch.int64, device=dev)
    seeds = _renderer.pixel_seeds_from_index(i, width, policy)
    for start in range(0, npix, policy.rays_per_chunk):
        sl = slice(start, start + policy.rays_per_chunk)
        p0, d0 = _renderer.generate_camera_rays(
            scene.camera, i[sl] % width, i[sl] // width, accumulation,
            seeds[sl], enable_dof, policy)
        tfar, prim_id, is_tri = intersect.intersect_scene(
            scene, p0, d0, accel=policy.effective_accel)
        state = _renderer.initial_state(p0, d0)
        frame = _renderer._closest_hit_frame(scene, state, tfar, prim_id,
                                             is_tri)
        yield seeds[sl], frame, tfar, prim_id


def _aov_pass(scene: Scene, policy: RendererPolicy, width: int, height: int,
              accumulation: int):
    """One sample of the AOVs as host arrays: depth [npix] (inf on a miss),
    normal and albedo [npix, 3] (0 on a miss), prim_id [npix] int32."""
    parts = []
    for _, frame, tfar, prim_id in first_hits(scene, policy, width, height,
                                              accumulation,
                                              policy.enable_dof):
        n, mat_id = frame[1], frame[4]
        albedo = scene.materials.albedo
        mid = mat_id.to(torch.int64)
        hit = prim_id >= 0
        parts.append((
            torch.where(hit, tfar, torch.inf),
            torch.stack([n.x, n.y, n.z], -1) * hit[:, None],
            torch.stack([albedo.x[mid], albedo.y[mid], albedo.z[mid]], -1)
            * hit[:, None],
            prim_id))
    return tuple(torch.cat([p[k] for p in parts]).cpu().numpy()
                 for k in range(4))


def render_aovs(scene: Scene, policy: RendererPolicy, width: int,
                height: int, accumulation: int = 1,
                samples: int = 1) -> Dict[str, np.ndarray]:
    """First-bounce AOVs: depth [H, W], normal [H, W, 3], albedo [H, W, 3],
    prim_id [H, W]; row 0 = top. With samples > 1 depth, normal and albedo
    are averaged over the camera samples of accumulations accumulation ..
    accumulation + samples - 1 on the host in float64, as in the JAX package
    (normals renormalized; prim_id from the first sample)."""
    depth, normal, albedo, prim_id = _aov_pass(scene, policy, width, height,
                                               accumulation)
    if samples > 1:
        d_sum = np.where(np.isfinite(depth), depth, 0.0)
        d_cnt = np.isfinite(depth).astype(np.float32)
        n_sum = normal.astype(np.float64)
        a_sum = albedo.astype(np.float64)
        for k in range(1, samples):
            dk, nk, ak, _ = _aov_pass(scene, policy, width, height,
                                      accumulation + k)
            fin = np.isfinite(dk)
            d_sum += np.where(fin, dk, 0.0)
            d_cnt += fin
            n_sum += nk
            a_sum += ak
        depth = np.where(d_cnt > 0, d_sum / np.maximum(d_cnt, 1), np.inf)
        norm = np.linalg.norm(n_sum, axis=-1, keepdims=True)
        normal = np.where(norm > 1e-6, n_sum / np.maximum(norm, 1e-6), 0.0)
        albedo = a_sum / samples

    def flip(a):
        return a.reshape(height, width, *a.shape[1:])[::-1]

    return {"depth": flip(depth), "normal": flip(normal),
            "albedo": flip(albedo), "prim_id": flip(prim_id)}
