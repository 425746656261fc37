"""The PyTorch port against the JAX package on bvh_test (255 spheres), on the
CPU, with and without XLA's CPU rsqrt.

XLA's CPU rsqrt is not correctly rounded; the port's is. The witness is the
JAX renderer with ``core/vec.py::jax_rsqrt`` replaced, in this process only,
by a correctly rounded rsqrt (float64 on the host). The script prints:

* the 64x64, 10-spp renders of the port, JAX and the witness against the
  golden and against each other (share of values close at the bar of
  ``tests/test_goldens.py::_check``, and the relative difference of means);
* a paired comparison over ``--passes`` passes, both renderers from their
  own camera rays: the mean and standard error of the port's per-pass
  radiance sum relative to the reference's, and the lanes that differ.

    JAX_PLATFORMS=cpu python benchmarks/torch_bvh_witness.py [--passes 120]
        [--reference xla|witness]
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "tests")]

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from cpu_raytracing_experiments_tpu.core import vec as jvec  # noqa: E402
from cpu_raytracing_experiments_tpu.render import renderer as jr  # noqa: E402
from cpu_raytracing_experiments_tpu.render.api import Renderer as JRenderer  # noqa: E402
from cpu_raytracing_experiments_tpu.scene import builders as jb  # noqa: E402
from cpu_raytracing_experiments_tpu.utils.config import RendererPolicy as JPolicy  # noqa: E402
from cpu_raytracing_experiments_tpu_torch import Renderer, builders  # noqa: E402
from cpu_raytracing_experiments_tpu_torch.render import renderer as tr  # noqa: E402
from cpu_raytracing_experiments_tpu_torch.scene.scene import Scene  # noqa: E402
from cpu_raytracing_experiments_tpu_torch.utils.config import RendererPolicy  # noqa: E402
from test_torch_scene import jax_scene_to_numpy  # noqa: E402

SIZE, SPP = 64, 10
XLA_RSQRT = jvec.jax_rsqrt


def exact_rsqrt(x):
    return jax.pure_callback(
        lambda a: (1.0 / np.sqrt(np.asarray(a, np.float64))).astype(np.float32),
        jax.ShapeDtypeStruct(x.shape, jnp.float32), x,
        vmap_method="expand_dims")


def use_rsqrt(fn):
    """Switch the JAX package's rsqrt; cleared caches force a new trace."""
    jax.clear_caches()
    jvec.jax_rsqrt = fn


def policies():
    kw = dict(max_bounces=6, rays_per_chunk=4096, narrow_wavefront=False)
    return JPolicy(**kw), RendererPolicy(**kw)


def renders():
    jpol, tpol = policies()
    r = Renderer(builders.bvh_test_scene(SIZE, SIZE), tpol, SIZE, SIZE,
                 device="cpu")
    r.accumulate(SPP)
    out = {"port": r.render(tonemap=False)}
    for name, fn in (("jax", XLA_RSQRT), ("witness", exact_rsqrt)):
        use_rsqrt(fn)
        j = JRenderer(jb.bvh_test_scene(SIZE, SIZE), jpol, SIZE, SIZE)
        j.accumulate(SPP)
        out[name] = np.asarray(j.render(tonemap=False))
    out["golden"] = np.load(ROOT / "tests" / "goldens"
                            / f"bvh_test_{SIZE}x{SIZE}_{SPP}spp.npy")
    for a, b in (("port", "golden"), ("jax", "golden"),
                 ("witness", "golden"), ("port", "witness"), ("port", "jax")):
        close = np.isclose(out[a], out[b], rtol=1e-3, atol=1e-4).mean()
        rel = out[a].mean() / out[b].mean() - 1
        print(f"{a} vs {b}: close {close:.6f}, mean {out[a].mean():.6f} vs "
              f"{out[b].mean():.6f} (relative {rel:+.6f})")


def paired(passes: int, reference: str):
    jpol, tpol = policies()
    use_rsqrt(exact_rsqrt if reference == "witness" else XLA_RSQRT)
    w = h = SIZE
    js = jb.bvh_test_scene(w, h)
    ts = Scene.from_numpy(jax_scene_to_numpy(js), device="cpu")
    i = np.arange(w * h)
    jseeds, tseeds = jr.pixel_seeds(w, h, jpol), tr.pixel_seeds(w, h, tpol)
    camera = jax.jit(lambda s, a: jr.generate_camera_rays(
        s.camera, jnp.asarray(i % w, jnp.int32), jnp.asarray(i // w, jnp.int32),
        a, jseeds, False, jpol))
    trace = jax.jit(lambda s, a, p, d: jr.trace_rays(s, jpol, a, jseeds, p, d))
    stack = lambda v: np.stack([np.asarray(c) for c in v], 1)
    want, got, dirs_differ = [], [], []
    for acc in range(1, passes + 1):
        p0, d0 = camera(js, jnp.uint32(acc))
        want.append(stack(trace(js, jnp.uint32(acc), p0, d0)[0]))
        tp0, td0 = tr.generate_camera_rays(
            ts.camera, torch.from_numpy(i % w), torch.from_numpy(i // w), acc,
            tseeds, False, tpol)
        got.append(stack(tr.trace_rays(ts, tpol, acc, tseeds, tp0, td0)[0]))
        dirs_differ.append((stack(d0) != stack(td0)).any(1).mean())
    want, got = np.array(want), np.array(got)
    rel = got.sum((1, 2)) / want.sum((1, 2)) - 1
    differ = ~np.isclose(got, want, rtol=1e-4, atol=1e-5).all(2)
    delta = (got - want).sum(2)[differ]
    print(f"paired vs {reference}, {passes} passes: camera directions "
          f"differing {np.mean(dirs_differ):.4f}; port/reference - 1 per "
          f"pass {rel.mean():+.3e} +- {rel.std() / np.sqrt(passes):.3e} "
          f"(mean +- standard error); lanes differing {differ.mean():.5f}, "
          f"{int((delta > 0).sum())} brighter, {int((delta < 0).sum())} "
          f"darker")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--passes", type=int, default=120)
    ap.add_argument("--reference", choices=("xla", "witness"), default="xla")
    args = ap.parse_args()
    renders()
    paired(args.passes, args.reference)


if __name__ == "__main__":
    main()
