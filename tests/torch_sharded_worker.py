"""One rank of a (dp, sp) mesh: the port's ``parallel/sharded.py`` over
gloo, the processes meeting at a ``file://`` store. tests/test_torch_sharded.py
spawns it on the CPU, and chip_smoke.py's phase 20 on the card (every rank on
the one card). It imports the port only (no JAX).

    python tests/torch_sharded_worker.py STORE WORLD RANK DP SP OUT DEVICE \
        WIDTH [CASE ...]

DEVICE is the renderers' ("cpu" or "cuda"); the collectives run on the host
either way. WIDTH is the hero's square frame. The CASEs (all by default) are
"buckets", "checkpoint", "spp" and "dp" (the 2 x 1 mesh's own cases); rank 0
writes what the mesh rendered to OUT/results.npz (the frames and buckets
joined over the mesh), and, where the test put one there, resumes
OUT/jax4.npz. Every case is collective: each rank runs all of them.
"""
import dataclasses
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from cpu_raytracing_experiments_tpu_torch.parallel import (  # noqa: E402
    distributed, sharded)
from cpu_raytracing_experiments_tpu_torch.scene import builders  # noqa: E402
from cpu_raytracing_experiments_tpu_torch.utils.config import \
    RendererPolicy  # noqa: E402

CASES = ("buckets", "checkpoint", "spp", "dp")
POL = RendererPolicy(max_bounces=6, rays_per_chunk=2048)
SMALL = RendererPolicy(max_bounces=3, rays_per_chunk=1024)
RESTIR = RendererPolicy(max_bounces=3, rays_per_chunk=1024,
                        light_sampling="restir")
ADAPTIVE = {"tol": 0.05, "max_spp": 20, "warmup": 10}


def field(w):
    """The 16-light field of tests/test_torch_checkpoint.py."""
    return builders.random_spheres_scene(w, w, num_spheres=60,
                                         emissive_fraction=0.3, seed=5)


def subset_ids():
    """[2, 40] global pixel ids of a 16x16 frame split by owning shard of a
    2 x 1 mesh (every third pixel of each half), the last 8 of each row
    padding (`valid` False)."""
    ids = torch.zeros((2, 40), dtype=torch.int64)
    valid = torch.zeros((2, 40), dtype=torch.bool)
    for s in range(2):
        own = torch.arange(s * 128, (s + 1) * 128, 3)[:32]
        ids[s, :32], valid[s, :32] = own, True
    return ids, valid


def merged(r):
    """The renderer's buckets merged over the whole mesh: [B, 3, npix]."""
    return sharded._frame(sharded._merge_sp(r.state.buckets, r.mesh),
                          r.mesh).cpu().numpy()


def main():
    store, world, rank, dp, sp, out, device, w = sys.argv[1:9]
    cases = sys.argv[9:] or CASES
    world, rank, dp, sp, w = int(world), int(rank), int(dp), int(sp), int(w)
    out = Path(out)
    torch.set_num_threads(1)
    distributed.initialize(f"file://{store}", world, rank, backend="gloo")
    if device == "cuda":
        torch.cuda.set_device(0)  # every rank on the one card
    mesh = sharded.make_mesh(dp, sp, device_type="cpu")
    res = {}

    def renderer(scene=None, pol=POL, w=w):
        return sharded.ShardedRenderer(
            scene if scene is not None else builders.default_scene(w, w),
            pol, w, w, mesh, device=device)

    if "buckets" in cases:
        r = renderer()
        r.accumulate(10)
        res["buckets"] = merged(r)
        res["image"] = r.render(tonemap=True)
        res["linear"] = r.render(tonemap=False)
        res["variance"] = r.variance_map()

    if "checkpoint" in cases:
        r = renderer()
        r.accumulate(4)
        r.save_checkpoint(out / "port4.npz")
        if (out / "jax4.npz").exists():
            r = renderer()
            r.load_checkpoint(out / "jax4.npz")
            r.accumulate(6)
            res["resumed"] = merged(r)

    if "spp" in cases:
        r = renderer(pol=dataclasses.replace(POL, samples_per_pixel=2))
        res["spp_image"] = r.render_spp(10)
        res["spp_passes"] = r.state.accumulations

    if "dp" in cases and sp == 1 and dp > 1:
        r = renderer(field(16), RESTIR, 16)
        r.accumulate(4)
        res["restir_buckets"] = merged(r)
        res["restir_reservoir"] = sharded._frame(r.state.reservoir,
                                                 mesh).cpu().numpy()
        r = renderer(pol=SMALL, w=16)
        img, stats = r.render_adaptive(**ADAPTIVE)
        res["adaptive_image"] = img
        res["adaptive_buckets"] = merged(r)
        res["adaptive_counts"] = sharded._frame(r.state.counts,
                                                mesh).cpu().numpy()
        res["adaptive_stats"] = json.dumps(stats)
        r = renderer(pol=SMALL, w=16)
        r.accumulate(5)
        ids, valid = subset_ids()
        r.state = sharded.accumulate_pixels_sharded(
            r.scene, r.policy, r.state, 16, 16, ids, valid, mesh)
        res["subset_buckets"] = merged(r)
        res["subset_counts"] = sharded._frame(r.state.counts,
                                              mesh).cpu().numpy()
        # the topology of the mesh builders (after test_two_process_initialize)
        pod = distributed.pod_mesh(1, "cpu")
        slices = distributed.multi_slice_mesh(world, "cpu")
        topo = {name: [list(m.mesh.shape), [int(c) for c in
                                            m.get_coordinate()]]
                for name, m in (("pod", pod), ("multi_slice", slices))}
        topo.update(rank=dist.get_rank(), world=dist.get_world_size(),
                    backend=dist.get_backend())
        every = [None] * world
        dist.all_gather_object(every, topo)
        res["topology"] = json.dumps(every)

    if rank == 0:
        np.savez(out / "results.npz", **res)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
