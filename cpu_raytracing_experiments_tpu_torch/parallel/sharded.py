"""Multi-device rendering over a ('dp', 'sp') ``DeviceMesh``, the port of the
JAX package's ``parallel/sharded.py``.

The reference's only parallelism is a shared-memory parallel_for over tiles
(Renderer.hpp:75, SURVEY.md section 2.3). Here the same decomposition is
lifted onto a 2-axis mesh of processes, one process per mesh coordinate
(the PyTorch form of JAX's SPMD ``shard_map``):

  * ``dp``: pixels. Each rank renders a contiguous slice of the flat pixel
    grid into its own accumulator slice, with no communication while it
    accumulates; the frame is assembled by an all_gather over 'dp' at
    resolve time.
  * ``sp``: samples. sp rank i runs the passes ``acc0 + 1 + i + k * n_sp``;
    because the RNG is counter-based, the union of all ranks' passes is the
    single-device render's, and the sp partial buckets are merged at resolve
    time: gathered and summed in rank order, as the JAX package sums them,
    so the merge has the same bits on every backend and device.

Every rank holds a ``RenderState`` of its own block: buckets [B, 3,
local_pix] (its sp partial), and, where present, counts [local_pix] and the
ReSTIR reservoirs [3, local_pix]. Every method of ``ShardedRenderer`` is
collective: each rank of the mesh calls it.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..core.rng import MASK
from ..render import estimator
from ..render import renderer as _renderer
from ..render.api import _tol32, resolve_device
from ..render.estimator import RenderState
from ..scene.scene import Scene
from ..utils.config import RendererPolicy
from . import distributed


def make_mesh(dp: Optional[int] = None, sp: int = 1,
              device_type: str = "cuda"):
    """A ('dp', 'sp') mesh over the process group that
    ``distributed.initialize`` made (all on dp by default); a group of one
    process is the 1 x 1 mesh."""
    if dp is None:
        dp = distributed.group_size() // sp
    return distributed.mesh_2d(dp, sp, device_type)


def _shape(mesh):
    """(n_dp, n_sp)."""
    n_dp, n_sp = mesh.mesh.shape
    return int(n_dp), int(n_sp)


def _gather(t: torch.Tensor, mesh, axis: str) -> list:
    """Every rank's `t` along the mesh `axis`, in rank order: an
    all_gather, on a 1-wide axis too."""
    group = mesh.get_group(axis)
    world = dist.get_world_size(group)
    # gloo gathers host tensors: a partial on the card crosses through the
    # host, explicitly, and comes back to the card; the render stays there
    host = t.is_cuda and dist.get_backend(group) == "gloo"
    src = t.detach().cpu() if host else t.detach().contiguous()
    out = [torch.empty_like(src) for _ in range(world)]
    dist.all_gather(out, src, group=group)
    return [o.to(t.device) for o in out] if host else out


def _merge_sp(t: torch.Tensor, mesh) -> torch.Tensor:
    """The sp partials of `t` summed in sp rank order (JAX
    ``jnp.sum(..., axis=0)``)."""
    parts = _gather(t, mesh, "sp")
    total = parts[0]
    for p in parts[1:]:
        total = total + p
    return total


def _frame(t: torch.Tensor, mesh) -> torch.Tensor:
    """The dp blocks of `t` (pixels last) joined into the full frame."""
    return torch.cat(_gather(t, mesh, "dp"), dim=-1)


def create_sharded_state(width: int, height: int, policy: RendererPolicy,
                         mesh, device=None) -> RenderState:
    """This rank's state: buckets [B, 3, local_pix] of zeros (its sp
    partial of its dp block) and, under light_sampling='restir', its
    [3, local_pix] reservoirs (sp must be 1: ReSTIR chains passes)."""
    n_dp, n_sp = _shape(mesh)
    npix = width * height
    if npix % n_dp:
        raise ValueError("the pixel count must divide the dp axis")
    device = torch.device(device or mesh.device_type)
    local = npix // n_dp
    reservoir = None
    if policy.light_sampling == "restir":
        if n_sp != 1:
            raise ValueError("ReSTIR chains passes sequentially; use sp=1")
        reservoir = RenderState._empty_reservoir(local, device)
    return RenderState(
        buckets=torch.zeros((policy.accumulation_buckets, 3, local),
                            dtype=torch.float32, device=device),
        accumulations=0,
        rays_traced=torch.zeros((), dtype=torch.int64, device=device),
        reservoir=reservoir)


def accumulate_n_sharded(scene: Scene, policy: RendererPolicy,
                         state: RenderState, width: int, height: int, n: int,
                         mesh) -> RenderState:
    """n accumulation passes distributed over the mesh (n a multiple of the
    sp size): rank (dp_i, sp_i) traces passes acc0 + 1 + sp_i + n_sp * k of
    its pixel block into bucket acc % B, with no collective. The union is
    n sequential single-device passes (same counters, same seeds)."""
    n_dp, n_sp = _shape(mesh)
    dp_i, sp_i = mesh.get_coordinate()
    if n % n_sp:
        raise ValueError("the pass count must divide the sp axis")
    local = width * height // n_dp
    b = policy.accumulation_buckets
    res = state.reservoir
    use_restir = policy.light_sampling == "restir" and res is not None
    count = state.rays_traced
    for k in range(n // n_sp):
        acc = (state.accumulations + 1 + sp_i + n_sp * k) & MASK
        if use_restir:
            rad, cnt, res = _renderer.render_pass(
                scene, policy, acc, width, height, pixel_start=dp_i * local,
                npix=local, restir_in=res)
        else:
            rad, cnt = _renderer.render_pass(
                scene, policy, acc, width, height, pixel_start=dp_i * local,
                npix=local)
        state.buckets[acc % b] += torch.stack(list(rad))
        count = count + cnt
    return RenderState(state.buckets, (state.accumulations + n) & MASK, count,
                       res, state.counts)


def _initial_counts(state: RenderState) -> torch.Tensor:
    if state.counts is not None:
        return state.counts
    return torch.full((state.buckets.shape[-1],), float(state.accumulations),
                      dtype=torch.float32, device=state.buckets.device)


def _add_subset(buckets, bucket: int, pos, rad, vf):
    """buckets[bucket] + a zero frame with the subset's radiance added at
    `pos` (JAX ``zeros.at[:, pos].add`` then the bucket add)."""
    frame = torch.zeros(buckets.shape[1:], dtype=torch.float32,
                        device=buckets.device)
    frame.index_add_(1, pos, torch.stack([rad.x * vf, rad.y * vf,
                                          rad.z * vf]))
    buckets[bucket] = buckets[bucket] + frame


def accumulate_pixels_sharded(scene: Scene, policy: RendererPolicy,
                              state: RenderState, width: int, height: int,
                              pixel_ids: torch.Tensor, valid: torch.Tensor,
                              mesh) -> RenderState:
    """One adaptive subset sample over the mesh: `pixel_ids` [dp, N] global
    pixel ids split by owning shard (every valid id of row s lies in shard
    s's block), `valid` [dp, N] masks padding. Each rank traces its own row
    into its bucket and count blocks, with no collective (sp must be 1)."""
    n_dp, n_sp = _shape(mesh)
    if n_sp != 1:
        raise ValueError("adaptive subsets chain pass counts; use sp=1")
    dp_i = mesh.get_coordinate()[0]
    local = width * height // n_dp
    device = state.buckets.device
    ids = pixel_ids[dp_i].to(device=device, dtype=torch.int64)
    val = valid[dp_i].to(device=device, dtype=torch.bool)
    acc = (state.accumulations + 1) & MASK
    rad, cnt = _renderer.render_pass_pixels(scene, policy, acc, width, ids,
                                            val)
    pos = torch.clamp(ids - dp_i * local, 0, local - 1)
    vf = val.to(torch.float32)
    _add_subset(state.buckets, acc % policy.accumulation_buckets, pos, rad,
                vf)
    counts = _initial_counts(state).index_add(0, pos, vf)
    return RenderState(state.buckets, acc, state.rays_traced + cnt,
                       state.reservoir, counts)


def _adaptive_round_sharded(scene: Scene, policy: RendererPolicy,
                            state: RenderState, width: int, height: int, tol,
                            tier: int, mesh):
    """One adaptive round on every rank (JAX ``_adaptive_round_sharded``):
    each dp shard takes the stderr of its own pixel block from its buckets
    and counts, picks its `tier` worst pixels (a stable sort, worst first)
    and traces B subset passes, with no collective. Returns (state,
    n_traced, n_next), the two counts 0-d tensors of this shard."""
    n_dp, n_sp = _shape(mesh)
    if n_sp != 1:
        raise ValueError("adaptive subsets chain pass counts; use sp=1")
    dp_i = mesh.get_coordinate()[0]
    local = width * height // n_dp
    b = policy.accumulation_buckets
    tol = _tol32(tol)
    counts = _initial_counts(state)
    acc0 = state.accumulations
    se = estimator.stderr_arrays(state.buckets, acc0, counts)
    pos = torch.argsort(-se, stable=True)[:tier]
    val = se[pos] > tol
    ids = pos + dp_i * local
    vf = val.to(torch.float32)
    n_traced = val.sum()
    rays = state.rays_traced
    for k in range(b):
        acc = (acc0 + k + 1) & MASK
        rad, cnt = _renderer.render_pass_pixels(scene, policy, acc, width,
                                                ids, val)
        _add_subset(state.buckets, acc % b, pos, rad, vf)
        rays = rays + cnt
    counts = counts.index_add(0, pos, vf * b)
    acc = (acc0 + b) & MASK
    n_next = (estimator.stderr_arrays(state.buckets, acc, counts)
              > tol).sum()
    return (RenderState(state.buckets, acc, rays, state.reservoir, counts),
            n_traced, n_next)


def resolve_sharded(state: RenderState, policy: RendererPolicy, exposure,
                    width: int, height: int, mesh,
                    tonemap: bool = True) -> torch.Tensor:
    """The sp partials merged (gathered and summed in rank order), the
    single-device ``estimator.resolve`` on this rank's block (same median
    branches, same exposure / (rounds * spp) scale), then the blocks
    gathered over 'dp': the full [H, W, 3] frame on every rank, row 0 = the
    bottom scanline."""
    merged = _merge_sp(state.buckets, mesh)
    local = estimator.resolve(
        RenderState(merged, state.accumulations, state.rays_traced,
                    counts=state.counts),
        policy, exposure, merged.shape[-1], 1, tonemap)  # [1, local, 3]
    return _frame(local[0].T, mesh).T.reshape(height, width, 3)


class ShardedRenderer:
    """Mesh-parallel progressive renderer with the API of
    ``render.api.Renderer`` (JAX ``ShardedRenderer``). Every rank builds one
    over the same scene and calls each method; ``render`` returns the full
    frame on every rank. The device is the card unless `device` names
    another (``device="cpu"`` for a CPU mesh). Without a `mesh` it takes
    ``make_mesh()`` over the group of ``distributed.initialize``."""

    def __init__(self, scene: Scene, policy: Optional[RendererPolicy] = None,
                 width: int = 256, height: int = 256, mesh=None,
                 device=None):
        from ..ops import intersect

        self.policy = policy or RendererPolicy()
        _renderer.check_policy(self.policy)
        self.device = resolve_device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.mesh = (mesh if mesh is not None
                     else make_mesh(device_type=self.device.type))
        self.width, self.height = width, height
        cam = scene.camera
        if (float(cam.half_width) * 2 != width
                or float(cam.half_height) * 2 != height):
            scene = dataclasses.replace(scene,
                                        camera=cam.resized(width, height))
        self.scene = scene.to(self.device)
        if "pallas" in (self.policy.effective_accel,
                        self.policy.primary_accel):
            intersect.prepare_stream(self.policy, self.scene)
        self.reset_accumulator()

    def reset_accumulator(self):
        self.state = create_sharded_state(self.width, self.height,
                                          self.policy, self.mesh, self.device)

    def accumulate(self, n: int):
        self.state = accumulate_n_sharded(self.scene, self.policy, self.state,
                                          self.width, self.height, n,
                                          self.mesh)

    def render(self, tonemap: bool = True) -> np.ndarray:
        """The resolved frame [H, W, 3], row 0 = the top scanline."""
        img = resolve_sharded(self.state, self.policy,
                              self.scene.camera.exposure, self.width,
                              self.height, self.mesh, tonemap)
        return img.cpu().numpy()[::-1]

    def variance_map(self) -> np.ndarray:
        """[H, W] per-pixel variance of the running mean from the merged
        bucket spread: the statistic of ``Renderer.variance_map``, so the
        denoiser and the adaptive tooling take a ShardedRenderer. Row 0 =
        the top scanline."""
        from ..utils.metrics import pixel_variance_map

        merged = _merge_sp(self.state.buckets, self.mesh)
        v = pixel_variance_map(merged.cpu().numpy(), self.state.accumulations)
        v = _frame(torch.from_numpy(v).to(self.device), self.mesh)
        return v.cpu().numpy().reshape(self.height, self.width)[::-1]

    def save_checkpoint(self, path):
        """Topology-independent checkpoint: the sp partials merged and the dp
        blocks joined into the single-device layout [B, 3, npix], written by
        rank 0, so a render checkpointed on one mesh resumes on any other or
        on one device (the RNG is counter-based and the pass counter global).
        """
        from ..render import checkpoint

        st = self.state
        full = RenderState(
            _frame(_merge_sp(st.buckets, self.mesh), self.mesh),
            st.accumulations, st.rays_traced,
            None if st.reservoir is None else _frame(st.reservoir, self.mesh),
            None if st.counts is None else _frame(st.counts, self.mesh))
        if dist.get_rank() == 0:
            checkpoint.save(path, full, self.policy, self.width, self.height)
        dist.barrier()

    def load_checkpoint(self, path):
        """Resume from any checkpoint (single-device or sharded origin): the
        merged buckets land in sp rank 0's partial (zeros in the others: the
        resolve sums over sp, so this is exact) and the pixel-indexed arrays
        are cut to this rank's dp block."""
        from ..render import checkpoint

        st = checkpoint.load(path, self.policy, self.width, self.height,
                             device=self.device)
        dp_i, sp_i = self.mesh.get_coordinate()
        local = self.width * self.height // _shape(self.mesh)[0]
        blk = slice(dp_i * local, (dp_i + 1) * local)
        buckets = st.buckets[..., blk].contiguous()
        if sp_i != 0:
            buckets = torch.zeros_like(buckets)
        self.state = RenderState(
            buckets, st.accumulations, st.rays_traced,
            None if st.reservoir is None
            else st.reservoir[:, blk].contiguous(),
            None if st.counts is None else st.counts[blk].contiguous())

    def render_adaptive(self, tol: float, max_spp: int = 10000,
                        warmup=None, tonemap: bool = True):
        """Per-pixel adaptive allocation over the mesh (sp must be 1): each
        dp shard takes the stderr of its own block, picks its `tier` worst
        pixels and traces the round's subset passes with no collective; the
        host reads the shards' two counts through one small all_gather a
        round to size the next round and stop. The selection is per shard
        (global on one device), so the images agree with one device in
        distribution, not bit for bit. Returns (image, stats)."""
        n_dp, n_sp = _shape(self.mesh)
        if n_sp != 1:
            raise ValueError("adaptive sampling needs sp=1")
        b = self.policy.accumulation_buckets
        npix = self.width * self.height
        local = npix // n_dp
        warmup = -(-(warmup or 4 * b) // b) * b
        self.accumulate(warmup)
        traced = warmup * npix
        tiers = []
        t = local
        while t >= max(local // 64, 32):
            tiers.append(t)
            t //= 2
        n_max = local
        while self.state.accumulations < max_spp:
            if n_max == 0:
                break
            tier = next((t for t in reversed(tiers) if t >= n_max), local)
            self.state, n_traced, n_next = _adaptive_round_sharded(
                self.scene, self.policy, self.state, self.width, self.height,
                tol, tier, self.mesh)
            counts = torch.stack(_gather(torch.stack([n_traced, n_next]),
                                         self.mesh, "dp")).tolist()
            traced += b * sum(c[0] for c in counts)
            n_max = max(c[1] for c in counts)
        img = self.render(tonemap=tonemap)
        uniform_equiv = self.state.accumulations * npix
        counts = (_frame(self.state.counts, self.mesh).cpu().numpy()
                  if self.state.counts is not None
                  else np.full(npix, float(self.state.accumulations)))
        stats = {
            "samples_traced": int(traced),
            "uniform_equivalent": int(uniform_equiv),
            "saved_fraction": 1.0 - traced / max(uniform_equiv, 1),
            "max_spp_pixel": float(counts.max()),
        }
        return img, stats

    def render_spp(self, spp: int, tonemap: bool = True) -> np.ndarray:
        """Accumulate until at least `spp` samples a pixel have been traced
        (each pass traces policy.samples_per_pixel of them), rounded up so
        the passes divide both the bucket count and the sp axis."""
        b = self.policy.accumulation_buckets
        n_sp = _shape(self.mesh)[1]
        unit = b * n_sp // math.gcd(b, n_sp)
        passes = -(-spp // self.policy.samples_per_pixel)
        self.accumulate(-(-passes // unit) * unit)
        return self.render(tonemap=tonemap)
