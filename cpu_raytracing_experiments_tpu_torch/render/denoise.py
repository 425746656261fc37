"""AOV-guided a-trous wavelet denoiser (SVGF-lite), the port of the JAX
package's ``render/denoise.py``. No reference equivalent: the reference's
only noise control is the median-of-means estimator.

The albedo is divided out, the irradiance is filtered by an edge-stopping
a-trous wavelet (normal, depth and luminance weights, dilated 5x5 B3-spline
taps), and the albedo is multiplied back in. The first-bounce AOVs
(``render/probes.py``) are the guides.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import color

# 5-tap B3-spline kernel (outer product applied separably via offsets)
_B3 = np.asarray([1 / 16, 1 / 4, 3 / 8, 1 / 4, 1 / 16], np.float32)


def _gather(img: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """[H, W, ...] sampled at (y + dy, x + dx), clamped at the edges."""
    h, w = img.shape[:2]
    ys = torch.clamp(torch.arange(h, device=img.device) + dy, 0, h - 1)
    xs = torch.clamp(torch.arange(w, device=img.device) + dx, 0, w - 1)
    return img[ys][:, xs]


def _luminance(c: torch.Tensor) -> torch.Tensor:
    return c[..., 0] * 0.2126 + c[..., 1] * 0.7152 + c[..., 2] * 0.0722


def atrous_denoise(radiance, albedo, normal, depth, iterations: int = 4,
                   sigma_n: float = 0.2, sigma_z: float = 0.5,
                   sigma_l: float = 4.0, variance=None) -> torch.Tensor:
    """Edge-aware smoothing of the demodulated irradiance: radiance,
    albedo, normal [H, W, 3] (linear), depth [H, W] (inf = miss), and
    optionally variance [H, W], the per-pixel variance of the mean (the
    bucket spread, ``Renderer.variance_map``), which makes the luminance
    edge-stop variance-guided (noisy pixels smooth more; without it the fixed
    sigma_l applies). Tensors are filtered on their device; numpy arrays
    are taken as float32 on the host. Returns [H, W, 3] float32."""
    def t(a):
        return (torch.from_numpy(np.ascontiguousarray(a, np.float32))
                if isinstance(a, np.ndarray) else a)

    radiance, albedo, normal, depth = map(t, (radiance, albedo, normal,
                                              depth))
    safe_albedo = torch.clamp_min(albedo, 1e-3)
    hit = torch.isfinite(depth)
    irradiance = torch.where(albedo.amax(-1, keepdim=True) > 1e-3,
                             radiance / safe_albedo, radiance)
    z = torch.where(hit, depth, 0.0)
    zrange = torch.clamp_min(z.max() - z.min(), 1e-3)
    zn = z / zrange

    sdev = None
    if variance is not None:
        # 3x3-smoothed std-dev guide (SVGF filters its variance estimate),
        # demodulated like the colour so the scales match
        v = t(variance) / torch.clamp_min(_luminance(safe_albedo) ** 2, 1e-6)
        acc = _gather(v, -1, -1)
        for dy, dx in [(dy, dx) for dy in (-1, 0, 1)
                       for dx in (-1, 0, 1)][1:]:
            acc = acc + _gather(v, dy, dx)
        sdev = torch.sqrt(torch.clamp_min(acc / 9.0, 0.0))

    out = irradiance
    for it in range(iterations):
        stride = 1 << it
        acc = torch.zeros_like(out)
        wsum = torch.zeros(out.shape[:2] + (1,), dtype=out.dtype,
                           device=out.device)
        lum_c = _luminance(out)
        # each a-trous pass roughly halves the residual noise; the variance
        # guide shrinks with it so later passes stop over-smoothing
        l_denom = (sigma_l * sdev * (0.5 ** it) + 1e-3 if sdev is not None
                   else sigma_l)
        for oy in range(-2, 3):
            for ox in range(-2, 3):
                k = float(_B3[oy + 2] * _B3[ox + 2])
                dy, dx = oy * stride, ox * stride
                n_s = _gather(normal, dy, dx)
                z_s = _gather(zn, dy, dx)
                c_s = _gather(out, dy, dx)
                hit_s = _gather(hit, dy, dx)
                w_n = torch.exp(-torch.clamp_min(
                    1.0 - (n_s * normal).sum(-1), 0.0) / sigma_n)
                w_z = torch.exp(-torch.abs(z_s - zn)
                                / (sigma_z * stride / 64.0 + 1e-4))
                w_l = torch.exp(-torch.abs(_luminance(c_s) - lum_c)
                                / l_denom)
                # hit and miss pixels do not mix
                w = k * w_n * w_z * w_l * (hit_s == hit)
                acc = acc + c_s * w[..., None]
                wsum = wsum + w[..., None]
        out = acc / torch.clamp_min(wsum, 1e-8)
    return out * safe_albedo


def denoise_render(renderer, iterations: int = 4,
                   variance_guided: bool = False,
                   sigma_l: float = 4.0) -> np.ndarray:
    """Denoise the current accumulator of a ``render.api.Renderer`` on its
    device: a tonemapped [H, W, 3] image, row 0 = top. The guides are the
    AOVs averaged over 4 camera samples; ``variance_guided`` scales the
    luminance edge-stop by the accumulator's per-pixel std-dev
    (``Renderer.variance_map``, SVGF-style; the JAX package's docstring
    gives its measured trade-off by scene)."""
    from . import probes

    dev = renderer.device
    hdr = renderer.render(tonemap=False)  # [H, W, 3], already flipped
    aovs = probes.render_aovs(renderer.scene, renderer.policy,
                              renderer.width, renderer.height, samples=4)
    variance = None
    if variance_guided and renderer.state.accumulations >= 2:
        variance = renderer.variance_map()  # the same flip as hdr

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)

    out = atrous_denoise(t(hdr), t(aovs["albedo"]), t(aovs["normal"]),
                         t(aovs["depth"]), iterations=iterations,
                         sigma_l=sigma_l,
                         variance=None if variance is None else t(variance))
    r, g, b = color.tonemap_aces(out[..., 0], out[..., 1], out[..., 2])
    return torch.stack([r, g, b], -1).cpu().numpy()
