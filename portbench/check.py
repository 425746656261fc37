"""How ``correct`` is decided: the port's buckets and resolved image at
pixels drawn from the seed, against the reference's (``reference/``) for
the same passes.

Each compared number is a relative L1 gap over all compared values,
sum |port - reference| / sum |reference|, or a relative bias, |sum
(port - reference)| / sum |reference|: a path whose decision lies within
rounding of its threshold ends otherwise on the two sides, which moves a
bucket by a whole path's radiance, so a per-value tolerance would fail on
more values the more passes a window holds; these sums do not grow with
it. The limits (``checks/<cell>.json``) were set from the program's
readings on a dozen seeds and more and from the control's (the reference
in bfloat16, ``portbench/control.py``)."""
from __future__ import annotations

import numpy as np
import torch

NAMES = ("bucket_rel_l1", "bucket_rel_bias", "image_rel_l1")


def sample_pixels(seed: int, npix: int, count: int) -> np.ndarray:
    """`count` distinct pixels drawn from the seed, in increasing order."""
    rng = np.random.default_rng(seed)
    return np.sort(rng.choice(npix, size=min(count, npix), replace=False))


def _rel_l1(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).abs().sum() / torch.clamp_min(b.abs().sum(), 1e-30))


def _rel_bias(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).sum().abs() / torch.clamp_min(b.abs().sum(), 1e-30))


def compare(port_buckets, ref_buckets, port_image, ref_image) -> dict:
    """The compared numbers; NaN where the port's values are not finite."""
    pb, rb = port_buckets.double().cpu(), ref_buckets.double().cpu()
    pi, ri = port_image.double().cpu(), ref_image.double().cpu()
    if not (torch.isfinite(pb).all() and torch.isfinite(pi).all()):
        return {k: float("nan") for k in NAMES}
    return {"bucket_rel_l1": _rel_l1(pb, rb),
            "bucket_rel_bias": _rel_bias(pb, rb),
            "image_rel_l1": _rel_l1(pi, ri)}


def judge(numbers: dict, limits: dict) -> bool:
    """Correct where every number is at or under its limit (NaN is not)."""
    return all(numbers[k] <= limits[k] for k in NAMES)
