"""The port's benchmark: the measurement of the repository's
``bench.py`` (the JAX package's) on the CUDA card. It renders the hero scene
at 1080p and reports Mrays/s.

    python -m cpu_raytracing_experiments_tpu_torch.bench
    python -m cpu_raytracing_experiments_tpu_torch.cli bench

Prints ONE JSON line: {"metric", "value", "unit", "rays_per_pass",
"useful_rays_per_sample", "Msamples_per_s", "wall_s", "config", "device",
...}. "Rays" counts useful work, as ``bench.py`` does: closest-hit rays per
live bounce plus valid NEE shadow rays, from the renderer's own counter
(``PathState.ray_count``). The frame, passes, bounces and chunk come from the
same ``BENCH_*`` environment variables with the same defaults. It runs on
the card only: without one it exits with a message. It carries no
``vs_baseline``: ``bench.py``'s baseline is a JAX number on a CPU.
"""
from __future__ import annotations

import json
import os
import sys
import time

WIDTH = int(os.environ.get("BENCH_WIDTH", 1920))
HEIGHT = int(os.environ.get("BENCH_HEIGHT", 1088))  # 1080 padded to tile=16
PASSES = int(os.environ.get("BENCH_PASSES", 240))
BOUNCES = int(os.environ.get("BENCH_BOUNCES", 8))
CHUNK = int(os.environ.get("BENCH_CHUNK", 1 << 19))


def main():
    import torch

    if not torch.cuda.is_available():
        sys.exit("bench: no CUDA device is available; the benchmark runs on "
                 "the card only")
    from .render import estimator, renderer
    from .scene import builders
    from .utils.config import RendererPolicy

    device = torch.device("cuda")
    policy = RendererPolicy(max_bounces=BOUNCES, rays_per_chunk=CHUNK)
    scene = builders.default_scene(WIDTH, HEIGHT).to(device)

    # rays per pass from the renderer's counter (pass 1; representative since
    # the path-length distribution is stationary across accumulations)
    _, count = renderer.render_pass(scene, policy, 1, WIDTH, HEIGHT)
    rays_per_pass = int(count)

    def run():
        state = estimator.RenderState.create(WIDTH, HEIGHT, policy, device)
        state = estimator.accumulate_n(scene, policy, state, WIDTH, HEIGHT,
                                       PASSES)
        torch.cuda.synchronize()
        return state

    run()  # warm-up
    # best of 3 timed repetitions
    dt = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        run()
        dt = min(dt, time.perf_counter() - t0)

    mrays = rays_per_pass * PASSES / dt / 1e6
    msamples = WIDTH * HEIGHT * PASSES / dt / 1e6
    print(json.dumps({
        "metric": "Mrays/s/chip",
        "value": round(mrays, 2),
        "unit": "Mrays/s",
        "platform": "gpu",
        "device": torch.cuda.get_device_name(device),
        "config": f"default scene {WIDTH}x{HEIGHT}, {PASSES} spp, "
                  f"{BOUNCES} bounces",
        "rays_per_pass": rays_per_pass,
        "rays_definition": "closest-hit rays per live bounce + valid NEE "
                           "shadow rays (the renderer's counter)",
        "useful_rays_per_sample": round(rays_per_pass / (WIDTH * HEIGHT), 3),
        "Msamples_per_s": round(msamples, 3),
        "spp_per_s": round(PASSES / dt, 3),
        "wall_s": round(dt, 3),
    }))


if __name__ == "__main__":
    main()
