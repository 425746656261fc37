"""Multi-attribute table gathers of the shading path, the counterpart of the
JAX package's ``ops/gather.py`` as plain index gathers.

The JAX package gathers small tables with a one-hot matmul, exact on a TPU
only at ``Precision.HIGHEST``; a TF32 matmul would perturb every attribute,
so the port indexes instead. Indexing raises or wraps on an out-of-range id
where the one-hot form returned a zero row, so callers clamp ids first, as
the JAX call sites do (``renderer._closest_hit_frame``)."""
from __future__ import annotations

import torch


def pack_table(*cols) -> torch.Tensor:
    """Stack [P] columns (float or int) into one [P, F] float32 table. Int
    columns ride as float32, exact for |v| < 2^24."""
    return torch.stack([c.to(torch.float32) for c in cols], dim=1)


def gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """All F columns of `table` at rows `idx`: [R, F]."""
    return table[idx.to(torch.int64)]


def gather_cols(idx: torch.Tensor, *cols):
    """Each [P] column of `cols` at `idx`, as a tuple of [R] tensors."""
    idx = idx.to(torch.int64)
    return tuple(c[idx] for c in cols)
