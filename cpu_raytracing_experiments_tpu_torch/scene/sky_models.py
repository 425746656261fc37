"""Procedural environment maps, a copy of the JAX package's
``scene/sky_models.py`` (numpy only), so that both packages light a scene
with the same map, bit for bit.

The reference *requires* an HDRI file on disk and terminates without it
(Application.cpp:225-229). These procedural models generate equirect maps
in-process for ``scene.Sky.from_image``: a physically-plausible clear-sky
gradient with a sun disc, and a simple studio gradient, enough to light
scenes with no assets at all (the JAX CLI's ``--sky clear|studio``).
"""
from __future__ import annotations

import numpy as np


def clear_sky(
    width: int = 512,
    height: int = 256,
    sun_direction=(0.35, 0.65, 0.4),
    sun_intensity: float = 500.0,
    sun_angular_radius: float = 0.02,
    zenith_color=(0.22, 0.45, 0.95),
    horizon_color=(0.85, 0.88, 0.95),
    ground_color=(0.25, 0.22, 0.20),
) -> np.ndarray:
    """[H, W, 3] float32 equirect radiance map: Rayleigh-ish zenith->horizon
    gradient, dim ground hemisphere, gaussian-edged sun disc."""
    sun = np.asarray(sun_direction, np.float64)
    sun = sun / np.linalg.norm(sun)
    # equirect direction grid matching Sky.sample's mapping
    # (u = 0.5 + atan2(z, x)/2pi, v = 0.5 - asin(y)/pi)
    u = (np.arange(width) + 0.5) / width
    v = (np.arange(height) + 0.5) / height
    phi = (u - 0.5) * 2 * np.pi
    theta = (0.5 - v) * np.pi  # elevation: +pi/2 at top row
    sin_el = np.sin(theta)[:, None]
    cos_el = np.cos(theta)[:, None]
    dx = cos_el * np.cos(phi)[None, :]
    dy = np.broadcast_to(sin_el, (height, width))
    dz = cos_el * np.sin(phi)[None, :]

    up = np.clip(dy, 0.0, 1.0)
    t = up ** 0.55  # horizon-heavy falloff
    sky = (
        np.asarray(horizon_color)[None, None, :] * (1 - t[..., None])
        + np.asarray(zenith_color)[None, None, :] * t[..., None]
    )
    below = dy < 0
    ground = np.asarray(ground_color)[None, None, :] * (
        0.4 + 0.6 * np.clip(-dy, 0, 1)[..., None]
    )
    img = np.where(below[..., None], ground, sky)
    # sun disc with gaussian edge; clamp the radius to ~a texel so the sun
    # never falls between samples at low map resolutions (energy preserved
    # approximately by radius^2 compensation)
    texel = 2 * np.pi / width
    eff_radius = max(sun_angular_radius, texel)
    scale = (sun_angular_radius / eff_radius) ** 2
    cos_sun = dx * sun[0] + dy * sun[1] + dz * sun[2]
    ang = np.arccos(np.clip(cos_sun, -1, 1))
    disc = np.exp(-((ang / eff_radius) ** 2) * 2.0) * scale
    img = img + (disc[..., None] * np.asarray([1.0, 0.96, 0.9]) * sun_intensity)
    return img.astype(np.float32)


def studio_gradient(
    width: int = 256, height: int = 128, top=(1.2, 1.2, 1.25), bottom=(0.05, 0.05, 0.06)
) -> np.ndarray:
    """Soft vertical studio gradient."""
    v = (np.arange(height) + 0.5) / height
    t = (1 - v)[:, None, None]
    img = np.asarray(top)[None, None, :] * t + np.asarray(bottom)[None, None, :] * (1 - t)
    return np.broadcast_to(img, (height, width, 3)).astype(np.float32)
