"""The command line, the port of the JAX package's ``cli.py``: the same
subcommands, flags and defaults.

Replaces the reference's interactive application shell (Application.cpp)
for headless and production use: render, resume, bench, and a live
progressive viewer. The reference's `main` ignores argv
(Application.cpp:538-542) and is configured by recompiling; here every
policy knob is a flag. Every subcommand runs on the CUDA card, and exits
with a message when there is none; ``--cpu`` renders on the CPU instead.

  python -m cpu_raytracing_experiments_tpu_torch.cli render --scene default \\
      --width 512 --height 512 --spp 125 --out out.png --hdr-out out.hdr
  python -m cpu_raytracing_experiments_tpu_torch.cli render ... \\
      --checkpoint state.npz --checkpoint-every 50    # resumable
  python -m cpu_raytracing_experiments_tpu_torch.cli bench
  python -m cpu_raytracing_experiments_tpu_torch.cli view --scene cornell \\
      --port 8000
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
import time


def _device(args) -> str:
    """'cpu' under --cpu, else the card; exits when there is none."""
    import torch

    if getattr(args, "cpu", False):
        return "cpu"
    if not torch.cuda.is_available():
        sys.exit("no CUDA device is available; pass --cpu to run on the CPU")
    return "cuda"


def _sync(device: str):
    import torch

    if device != "cpu":
        torch.cuda.synchronize()


def _policy_from_args(args):
    from .utils.config import RendererPolicy

    if getattr(args, "preset", None):
        from .models import presets

        policy = presets.get(args.preset)
        # explicit flags still override the preset
        over = {}
        if args.bounces != 8:
            over["max_bounces"] = args.bounces
        if args.chunk != 1 << 19:
            over["rays_per_chunk"] = args.chunk
        if over:
            policy = dataclasses.replace(policy, **over)
        return policy
    return RendererPolicy(
        max_bounces=args.bounces,
        brdf=args.brdf if args.brdf else ("ggx" if args.ggx else "lambertian"),
        mis=not args.no_mis,
        light_sampling=args.light_sampling,
        use_bvh=args.bvh,
        accel=("pallas" if getattr(args, "pallas", False) else
               "clustered" if args.clustered else
               "grid" if args.grid else "bvh" if args.bvh else "brute"),
        median=not args.average,
        rays_per_chunk=args.chunk,
        enable_dof=args.dof,
        sky_bug_compat=args.sky_bug_compat,
        russian_roulette=not args.no_rr,
        stratify_camera=args.stratify,
        clamp_radiance=args.clamp is not None,
        max_radiance=args.clamp if args.clamp is not None else 1e2,
    )


def _build_scene(args):
    import torch

    from .scene import accel, builders

    if args.scene not in builders.SCENES:
        sys.exit(f"unknown scene {args.scene!r}; available: "
                 f"{list(builders.SCENES)}")
    kwargs = {}
    if args.scene in ("bvh_test", "random_spheres") and args.spheres:
        kwargs["num_spheres"] = args.spheres
    if args.scene == "mesh" and args.subdiv:
        kwargs["subdivisions"] = args.subdiv
    if args.scene == "brdf_test" and args.prop:
        kwargs["prop"] = args.prop
    scene = builders.SCENES[args.scene](args.width, args.height, **kwargs)
    if args.hdri or args.sky:
        from .scene.scene import Sky

        if args.hdri:
            from .utils import image as image_io

            img = image_io.read_hdr(args.hdri)
        else:
            from .scene import sky_models

            img = (sky_models.clear_sky() if args.sky == "clear"
                   else sky_models.studio_gradient())
        scene = dataclasses.replace(
            scene, sky=Sky.from_image(img, ambient=(1.0, 1.0, 1.0)))
    if getattr(args, "exposure", 1.0) != 1.0:
        cam = scene.camera
        scene = dataclasses.replace(scene, camera=dataclasses.replace(
            cam, exposure=torch.tensor(args.exposure, dtype=torch.float32,
                                       device=cam.exposure.device)))
    if args.bvh:
        scene = accel.with_bvh(scene)
    if args.grid:
        scene = accel.with_grid(scene, res=args.grid_res)
    if args.clustered:
        scene = accel.with_clusters(scene, num_clusters=args.clusters)
    if getattr(args, "pallas", False):
        scene = accel.with_pallas_clusters(scene)
    return scene


def _add_common(p: argparse.ArgumentParser):
    p.add_argument("--scene", default="default")
    p.add_argument("--width", type=int, default=512)
    p.add_argument("--height", type=int, default=512)
    p.add_argument("--spp", type=int, default=25)
    p.add_argument("--bounces", type=int, default=8)
    p.add_argument("--preset", choices=["reference_compat", "reference_fixed",
                                        "preview", "production",
                                        "ground_truth", "large_scene",
                                        "throughput"],
                   help="named render model (models/presets.py); explicit "
                        "--bounces/--chunk still override")
    p.add_argument("--chunk", type=int, default=1 << 19,
                   help="rays per microbatch")
    p.add_argument("--bvh", action="store_true",
                   help="BVH traversal (default: brute force, as the "
                        "reference ships)")
    p.add_argument("--grid", action="store_true",
                   help="uniform-grid DDA traversal")
    p.add_argument("--grid-res", type=int, default=32)
    p.add_argument("--clustered", action="store_true",
                   help="morton-clustered culled batteries (large scenes)")
    p.add_argument("--clusters", type=int, default=64)
    p.add_argument("--pallas", action="store_true",
                   help="clustered-traversal kernels (accel='pallas', large "
                        "scenes)")
    p.add_argument("--ggx", action="store_true",
                   help="GGX closure instead of lambertian")
    p.add_argument("--brdf", choices=["lambertian", "ggx", "principled"],
                   help="closure model (overrides --ggx)")
    p.add_argument("--no-mis", action="store_true")
    p.add_argument("--light-sampling",
                   choices=["uniform", "power", "ris", "restir"],
                   default="uniform",
                   help="NEE light selection: uniform (reference) or "
                        "power-proportional")
    p.add_argument("--no-rr", action="store_true",
                   help="disable Russian roulette")
    p.add_argument("--stratify", action="store_true",
                   help="low-discrepancy camera jitter (van der Corput + CP "
                        "rotation)")
    p.add_argument("--clamp", type=float, default=None, metavar="MAX",
                   help="clamp per-sample radiance (firefly control)")
    p.add_argument("--average", action="store_true",
                   help="average-of-buckets instead of median-of-means")
    p.add_argument("--dof", action="store_true",
                   help="thin-lens depth of field")
    p.add_argument("--sky-bug-compat", action="store_true",
                   help="reproduce the reference's throughput.r sky bug")
    p.add_argument("--hdri", help="equirect .hdr environment map for the sky")
    p.add_argument("--sky", choices=["clear", "studio"],
                   help="procedural sky model")
    p.add_argument("--spheres", type=int,
                   help="sphere count for bvh_test/random_spheres scenes")
    p.add_argument("--subdiv", type=int,
                   help="icosphere subdivisions for the mesh scene")
    p.add_argument("--prop", help="brdf_test property sweep (roughness, "
                                  "roughness_glass, ...)")
    p.add_argument("--exposure", type=float, default=1.0,
                   help="linear exposure applied at resolve "
                        "(Renderer.hpp:439)")
    p.add_argument("--adaptive-tol", type=float, default=None, metavar="SE",
                   help="per-pixel adaptive sample allocation: trace only "
                        "pixels whose standard error exceeds SE, up to --spp "
                        "(render_adaptive; incompatible with --checkpoint)")
    p.add_argument("--cpu", action="store_true",
                   help="render on the CPU (default: the CUDA card)")
    p.add_argument("--metrics", help="JSONL metrics output path")
    p.add_argument("--quiet", action="store_true")


def cmd_render(args):
    from .render import checkpoint as ckpt
    from .render.api import Renderer
    from .utils import image as image_io
    from .utils.metrics import MetricsLogger

    device = _device(args)
    policy = _policy_from_args(args)
    scene = _build_scene(args)
    r = Renderer(scene, policy, args.width, args.height, device=device)
    log = MetricsLogger(args.metrics, quiet=args.quiet)

    if args.checkpoint and ckpt.exists(args.checkpoint):
        r.state = ckpt.load(args.checkpoint, policy, args.width, args.height,
                            device=device)
        log.log(event="resume", path=args.checkpoint,
                spp=int(r.state.accumulations))

    if args.adaptive_tol is not None:
        t0 = time.perf_counter()
        img, stats = r.render_adaptive(args.adaptive_tol, max_spp=args.spp)
        log.log(event="adaptive", wall=round(time.perf_counter() - t0, 2),
                **stats)
        if args.checkpoint:
            # per-pixel counts serialize (render/checkpoint.py), so an
            # adaptive render resumes with an exact count-aware resolve
            ckpt.save(args.checkpoint, r.state, policy, args.width,
                      args.height)
            log.log(event="checkpoint", path=args.checkpoint,
                    spp=int(r.state.accumulations))
        if args.out:
            image_io.store(args.out, img)
            log.log(event="wrote", path=args.out)
        if args.hdr_out:
            image_io.store(args.hdr_out, r.render(tonemap=False))
            log.log(event="wrote", path=args.hdr_out)
        return

    b = policy.accumulation_buckets
    target = -(-args.spp // b) * b
    step = args.checkpoint_every or target
    step = -(-step // b) * b
    while int(r.state.accumulations) < target:
        n = min(step, target - int(r.state.accumulations))
        t0 = time.perf_counter()
        r.accumulate(n)
        _sync(device)
        dt = time.perf_counter() - t0
        log.log_step(spp=int(r.state.accumulations), step_wall=dt,
                     width=args.width, height=args.height,
                     buckets=r.state.buckets.cpu().numpy())
        if args.checkpoint:
            ckpt.save(args.checkpoint, r.state, policy, args.width,
                      args.height)

    if args.out:
        if args.denoise:
            from .render import denoise as denoise_mod

            img = denoise_mod.denoise_render(r)
        else:
            img = r.render(tonemap=True)
        image_io.store(args.out, img)
        log.log(event="wrote", path=args.out, denoised=bool(args.denoise))
    if args.hdr_out:
        image_io.store(args.hdr_out, r.render(tonemap=False))
        log.log(event="wrote", path=args.hdr_out)
    if not (args.out or args.hdr_out):
        img = r.render(tonemap=True)
        log.log(event="done", spp=int(r.state.accumulations),
                mean=float(img.mean()))


def cmd_aov(args):
    """First-bounce AOV renders (depth/normal/albedo/prim_id)."""
    import numpy as np

    from .render import probes
    from .utils import image as image_io

    device = _device(args)
    policy = _policy_from_args(args)
    scene = _build_scene(args).to(device)
    aovs = probes.render_aovs(scene, policy, args.width, args.height)
    prefix = args.out_prefix
    depth = aovs["depth"]
    finite = np.isfinite(depth)
    dmax = depth[finite].max() if finite.any() else 1.0
    image_io.write_png(f"{prefix}_depth.png", np.repeat(
        (np.where(finite, depth / max(dmax, 1e-6), 1.0))[..., None], 3, -1))
    image_io.write_png(f"{prefix}_normal.png", aovs["normal"] * 0.5 + 0.5)
    image_io.write_png(f"{prefix}_albedo.png", aovs["albedo"])
    np.save(f"{prefix}_prim_id.npy", aovs["prim_id"])
    if args.exr_out:
        n, a = aovs["normal"], aovs["albedo"]
        image_io.write_exr(args.exr_out, channels={
            "albedo.R": a[..., 0], "albedo.G": a[..., 1],
            "albedo.B": a[..., 2],
            "N.X": n[..., 0], "N.Y": n[..., 1], "N.Z": n[..., 2],
            "depth.Z": np.where(finite, depth, 0.0),
            "id": aovs["prim_id"].astype(np.float32),
        })
        print(f"wrote {args.exr_out}")
    print(f"wrote {prefix}_{{depth,normal,albedo}}.png + _prim_id.npy")


def cmd_ao(args):
    """Ambient-occlusion render."""
    from .render import ao
    from .utils import image as image_io

    device = _device(args)
    policy = _policy_from_args(args)
    scene = _build_scene(args).to(device)
    img = ao.render_ao(scene, policy, args.width, args.height,
                       samples=args.ao_samples, radius=args.ao_radius)
    image_io.store(args.out or "ao.png", img)
    print(f"wrote {args.out or 'ao.png'}")


def cmd_bench(args):
    from . import bench

    bench.main()


def cmd_scenes(args):
    from .scene import builders

    for name in builders.SCENES:
        print(name)


def cmd_view(args):
    from .viewer import serve

    device = _device(args)
    policy = _policy_from_args(args)
    scene = _build_scene(args)
    serve(scene, policy, args.width, args.height, port=args.port,
          device=device)


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="cpu_raytracing_experiments_tpu_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("render", help="headless render to image file")
    _add_common(p)
    p.add_argument("--out", help="tonemapped output (.png)")
    p.add_argument("--hdr-out", help="linear radiance output (.hdr/.npy)")
    p.add_argument("--checkpoint",
                   help="checkpoint path (resumes if it exists)")
    p.add_argument("--checkpoint-every", type=int, default=0,
                   help="spp between checkpoint writes")
    p.add_argument("--denoise", action="store_true",
                   help="AOV-guided a-trous denoise of the tonemapped output")
    p.set_defaults(fn=cmd_render)

    p = sub.add_parser("aov", help="first-bounce AOVs (depth/normal/albedo)")
    _add_common(p)
    p.add_argument("--out-prefix", default="aov")
    p.add_argument("--exr-out",
                   help="also write all AOVs as one multi-channel EXR")
    p.set_defaults(fn=cmd_aov)

    p = sub.add_parser("ao", help="ambient-occlusion render")
    _add_common(p)
    p.add_argument("--out", default="ao.png")
    p.add_argument("--ao-samples", type=int, default=32)
    p.add_argument("--ao-radius", type=float, default=1e3)
    p.set_defaults(fn=cmd_ao)

    p = sub.add_parser("bench", help="run the standard benchmark (the card)")
    p.set_defaults(fn=cmd_bench)

    p = sub.add_parser("scenes", help="list built-in scenes")
    p.set_defaults(fn=cmd_scenes)

    p = sub.add_parser("view", help="live progressive viewer (HTTP)")
    _add_common(p)
    p.add_argument("--port", type=int, default=8000)
    p.set_defaults(fn=cmd_view)

    args = parser.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
