"""The light-row reductions of ``light_sampling='power'``: for each row of
the [R, L] selection weights, the row total and the light that the unit
draw selects through the running sum, both rounded in the order XLA's CPU
compiler gives the JAX package's ``jnp.sum`` / ``jnp.cumsum`` over the
lights (``core/fp.py``'s ``row_sum`` / ``row_cumsum``). Two forms:

* the plain PyTorch version (``rows_plain``), which the CPU takes and
  ``chip_smoke.py`` holds the kernel to on the card;
* a hand-written CUDA kernel (``csrc/light_rows.cu``), one thread a row,
  which forms the running sum as it compares it with the target, so the
  [R, L] cdf is never written. A warp's 32 rows reach it through shared
  memory: staged whole with ``cp.async`` up to 380 lights, streamed in
  double-buffered column tiles above. It replaces no Pallas kernel: the
  JAX package leaves these reductions to XLA.

``light_rows`` launches the kernel for CUDA tensors or raises; nothing falls
back. Its launches are counted in ``LIGHT_ROWS.launches``.
"""
from __future__ import annotations

import ctypes

import torch

from ...core import fp
from . import build
from .build import LaunchCounter

LIGHT_ROWS = LaunchCounter("light_rows")


def rows_plain(w: torch.Tensor, f: torch.Tensor = None, fused=False):
    """(total [R], sel [R] int32, p_sel [R]) of the weights `w` [R, L]:
    total = ``fp.row_sum(w, fused)``; with the unit draws `f` [R], sel = the
    count of ``fp.row_cumsum(w) <= f * total`` clipped to [0, L - 1] and
    p_sel = w[sel] / max(total, 1e-30) (``_select_light``'s power branch in
    the JAX package). Without `f`, sel and p_sel are None."""
    total = fp.row_sum(w, fused)
    if f is None:
        return total, None, None
    target = f * total
    count = (fp.row_cumsum(w) <= target[:, None]).sum(dim=1)
    sel = torch.clamp(count, 0, w.shape[1] - 1)
    p_sel = torch.div(w.gather(1, sel[:, None])[:, 0],
                      torch.clamp_min(total, 1e-30))
    return total, sel.to(torch.int32), p_sel


def _bind(lib: ctypes.CDLL):
    ptr, i64 = ctypes.c_void_p, ctypes.c_longlong
    lib.light_rows.argtypes = [ptr, ptr, i64, i64, ctypes.c_int, ptr, ptr,
                               ptr, ptr]
    lib.light_rows.restype = ctypes.c_int


LIBRARY = build.Library("light_rows.cu", build.nvcc, build.NVCC_FLAGS, _bind)


def light_rows(w: torch.Tensor, f: torch.Tensor = None, fused=False):
    """``rows_plain``'s (total, sel, p_sel): the plain version for CPU
    tensors, the ``light_rows`` kernel for CUDA tensors."""
    if w.device.type == "cpu":
        return rows_plain(w, f, fused)
    r, n = w.shape
    operands = [w] if f is None else [w, f]
    for a in operands:
        if (a.device != w.device or a.dtype != torch.float32
                or not a.is_contiguous()):
            raise ValueError(
                f"light_rows: operands must be contiguous float32 on one "
                f"CUDA device; got {a.dtype} {tuple(a.shape)} {a.device}")
    if not 1 <= n < 2 ** 31 or (f is not None and f.shape != (r,)):
        raise ValueError(f"light_rows: weights {tuple(w.shape)}, draws "
                         f"{None if f is None else tuple(f.shape)}")
    lib = LIBRARY.load()
    total = torch.empty(r, dtype=torch.float32, device=w.device)
    sel = p_sel = None
    if f is not None:
        sel = torch.empty(r, dtype=torch.int32, device=w.device)
        p_sel = torch.empty(r, dtype=torch.float32, device=w.device)
    build.launch(LIGHT_ROWS, lib.light_rows, w.device,
                 [w.data_ptr(), None if f is None else f.data_ptr(), r, n,
                  int(bool(fused)), total.data_ptr(),
                  None if sel is None else sel.data_ptr(),
                  None if p_sel is None else p_sel.data_ptr()])
    return total, sel, p_sel
