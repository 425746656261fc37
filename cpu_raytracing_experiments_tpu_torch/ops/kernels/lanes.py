"""The host half of the lane kernels' form (``csrc/lanes.cuh``): a thread
takes four consecutive lanes by 16-byte loads and stores where every column
it steps through is aligned, one lane otherwise.

``groups`` picks how many 16-byte groups a launch takes, ``rows`` makes the
output rows that keep the groups aligned, and ``columns`` checks the lane
columns a wrapper passes to its kernel. The fma kernels' flat form
(``csrc/fma.cu``) keeps its own schedule but takes the same groups and rows.
``Derived`` keeps what a kernel reads of a scene (a packed table, checked
column addresses) for the tensors it was made from.
"""
from __future__ import annotations

import torch

VECTOR = 4  # lanes of one 16-byte group


def groups(r: int, word_ptrs, byte_ptrs=()) -> int:
    """16-byte groups of r lanes: r // 4 where every pointer of 4- or
    8-byte elements (`word_ptrs`) is 16-byte aligned and every uint8
    pointer (`byte_ptrs`) 4-byte aligned, else 0; the remaining r - 4 *
    groups lanes go one a thread. A null pointer (0) is aligned."""
    if any(p % 16 for p in word_ptrs) or any(p % 4 for p in byte_ptrs):
        return 0
    return r // VECTOR


def rows(n: int, r: int, device) -> torch.Tensor:
    """An [n, r] float32 view whose row stride is r rounded up to a 16-byte
    group, so that every row of its 16-byte-aligned buffer starts 16-byte
    aligned."""
    stride = -(-r // VECTOR) * VECTOR
    return torch.empty_strided((n, r), (stride, 1), dtype=torch.float32,
                               device=device)


def _why_not(x, dtype, r) -> str:
    """Why `x` is no column of `dtype` and length `r` (None: any), or ''."""
    if not isinstance(x, torch.Tensor):
        return f"not a tensor but {type(x).__name__}"
    if x.dim() != 1:
        return f"{x.dim()}-d, not 1-D"
    if x.dtype != dtype:
        return f"{x.dtype}, not {dtype}"
    if not x.is_contiguous():
        return "not contiguous"
    if r is not None and x.shape[0] != r:
        return f"{x.shape[0]} lanes, not {r}"
    return ""


def columns(name: str, cols, dtypes):
    """The data pointers of the [R] `cols`, each a contiguous 1-D tensor of
    its dtype in `dtypes`, all of one length and on one CUDA device; raises
    ValueError naming the first column that is not. Returns (pointers, R,
    device)."""
    r = None
    for k, (x, dtype) in enumerate(zip(cols, dtypes)):
        why = _why_not(x, dtype, r)
        if why:
            raise ValueError(f"{name}: column {k} is {why}")
        r = x.shape[0]
    device = cols[0].device
    for k, x in enumerate(cols):
        if not x.is_cuda or x.device != device:
            raise ValueError(
                f"{name}: column {k} is on {x.device}, not on "
                f"{device if device.type == 'cuda' else 'a CUDA card'} (the "
                "renderer takes the plain path off the card)")
    return [x.data_ptr() for x in cols], r, device


class Derived:
    """Values made from a scene's tensors, each made once for the tensors
    it is made from (by identity and version: a tensor changed in place
    gives a new value), the newest `kept` kept, first in first out. The
    tensors are kept with their value, so their ids stay theirs."""

    def __init__(self, kept: int = 4):
        self.kept = kept
        self._values = {}

    def get(self, src, make):
        """The value made by `make()` from the tensors `src`."""
        key = tuple((id(a), a._version) for a in src)
        entry = self._values.get(key)
        if entry is None:
            value = make()
            if len(self._values) >= self.kept:
                self._values.pop(next(iter(self._values)))
            entry = self._values[key] = (tuple(src), value)
        return entry[1]
