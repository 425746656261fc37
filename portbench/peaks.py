"""Published peaks of the card and the operation and byte counts of the
kernels whose roofline the benchmark reports.

Peaks: NVIDIA's H100 SXM data sheet, dense rates at the full 700 W power
limit; a run prints the card's limit beside a roofline share."""
from __future__ import annotations

H100_SXM = {
    "fp32_flops": 67e12,  # FLOP/s outside the tensor cores
    "hbm_bytes_per_s": 3.35e12,
}

# operations of one ray-box slab test (csrc/cluster_traverse.cu's planner):
# 6 sub, 6 mul, 11 min/max, 2 compares and the running min
SLAB_OPS = 26


def plan_call(rays: int, valid: int, clusters: int, tile: int,
              in_kernel: bool) -> tuple:
    """(operations, bytes) of one 'ray' planner call: a slab test of every
    valid ray against every cluster box; each ray (origin, direction, tfar
    and its valid byte: 29 bytes) and each box (24 bytes) read once, and a
    (tile, cluster) entry written once: 8 bytes (id and distance) and a
    count a tile where the kernel sorts, 4 where it writes the entry matrix
    for a sort outside it."""
    tiles = -(-rays // tile)
    nbytes = rays * 29 + clusters * 24 + tiles * clusters * (8 if in_kernel
                                                              else 4)
    if in_kernel:
        nbytes += tiles * 4
    return valid * clusters * SLAB_OPS, nbytes


def least_seconds(ops: float, nbytes: float, peaks: dict = H100_SXM) -> float:
    """The least time the card could take: the larger of operations over
    peak FLOP/s and bytes over peak bandwidth."""
    return max(ops / peaks["fp32_flops"], nbytes / peaks["hbm_bytes_per_s"])
