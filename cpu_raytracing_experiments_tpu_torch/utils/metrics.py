"""The bucket-spread variance estimates of the JAX package's
``utils/metrics.py`` (host numpy), kept here so that the port imports nothing
of that package: the B independent bucket means of the median-of-means
accumulator spread as sigma^2 / per_bucket, a free estimate of each pixel's
variance (SURVEY.md section 5)."""
from __future__ import annotations

import numpy as np


def bucket_variance_estimate(buckets: np.ndarray, accumulations: int) -> float:
    """Mean per-pixel variance of the sample mean, from the spread of the
    B independent bucket means. buckets: [B, 3, npix] sums."""
    b = buckets.shape[0]
    per_bucket = max(accumulations // b, 1)
    means = buckets / per_bucket
    # var of bucket means ~ sigma^2 / per_bucket; var of total mean = that / B
    var_of_bucket_means = means.var(axis=0, ddof=1) if b > 1 else np.zeros(1)
    return float(var_of_bucket_means.mean() / b)


def pixel_variance_map(buckets: np.ndarray, accumulations: int) -> np.ndarray:
    """Per-pixel variance of the running mean (channel-averaged), [npix]:
    ``bucket_variance_estimate`` without the spatial reduction, the basis
    of adaptive stopping."""
    b = buckets.shape[0]
    per_bucket = max(accumulations // b, 1)
    means = buckets / per_bucket
    if b <= 1:
        return np.zeros(buckets.shape[-1], np.float32)
    return (means.var(axis=0, ddof=1).mean(axis=0) / b).astype(np.float32)
