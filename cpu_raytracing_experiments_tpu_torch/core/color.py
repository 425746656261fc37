"""ACES tonemap of the resolve (the JAX package's ``core/color.py``,
Color.hpp:39-73), channelwise on same-shape float32 tensors."""
from __future__ import annotations

import torch


def aces_rtt_odt_fit(x):
    """(Color.hpp:39-49)."""
    return (x * (x + 0.0245786) - 0.000090537) / (
        x * (0.983729 * x + 0.4329510) + 0.238081
    )


def tonemap_aces(r, g, b):
    """Input matrix -> rtt_odt fit -> output matrix -> clamp to [0, 1]."""
    x = aces_rtt_odt_fit(r * 0.59719 + g * 0.35458 + b * 0.04823)
    y = aces_rtt_odt_fit(r * 0.07600 + g * 0.90834 + b * 0.01566)
    z = aces_rtt_odt_fit(r * 0.02840 + g * 0.13383 + b * 0.83777)
    out_r = torch.clamp(x * 1.604750 + y * -0.53108 + z * -0.07367, 0.0, 1.0)
    out_g = torch.clamp(x * -0.10208 + y * 1.10813 + z * -0.00605, 0.0, 1.0)
    out_b = torch.clamp(x * -0.00327 + y * -0.07276 + z * 1.07602, 0.0, 1.0)
    return out_r, out_g, out_b
