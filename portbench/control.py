"""The control of the check: the reference that the cell's configuration
names computed in bfloat16, the precision below the float32 that the
configurations state, put in the program's place and judged as a run
judges the program.

    python3 -m portbench.control --workload <cell> --seeds 11,12 --passes 200

For each seed it draws the run's pixels, computes the reference's buckets
and resolved image over `--passes` passes from the seed in float32 and in
bfloat16, and prints one JSON line with the compared numbers of the
bfloat16 side against the float32 side and the cell's limits. The limits
have to fail it: its smallest readings set the upper end of each limit.
The benchmark's own runs do not run it.
"""
from __future__ import annotations

import argparse
import json
import sys

from . import check, manifest, scenes
from .run import MASK, port_policy, reference


def readings(cell: str, seed: int, passes: int, device: str = "cuda",
             frame=None, pixels=None, mf=None) -> dict:
    """The compared numbers of the bfloat16 reference against the float32
    one for `cell` over `passes` passes from `seed`."""
    import torch

    mf = mf or manifest.Manifest()
    wl = mf.workload(cell)
    config, traffic = mf.config(wl["config"]), mf.traffic(wl["traffic"])
    width, height = frame or (traffic["width"], traffic["height"])
    ref = reference(config)
    pol = ref.policy(port_policy(config, traffic))
    inputs = scenes.build(config, width, height)
    count = pixels or int(mf.check(cell)["pixels"])
    pix = torch.from_numpy(check.sample_pixels(seed, width * height,
                                               count)).to(device)
    exposure = float(inputs["camera"]["exposure"])
    out = {}
    for name, dtype in (("float32", torch.float32),
                        ("bfloat16", torch.bfloat16)):
        sc = ref.make_scene(inputs, device, dtype)
        b = ref.buckets(sc, pol, pix, seed & MASK, passes, width)
        out[name] = (b, ref.resolve(b, passes, pol.spp, exposure))
    (bb, bi), (fb, fi) = out["bfloat16"], out["float32"]
    return check.compare(bb, fb, bi, fi)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--passes", type=int, required=True)
    args = ap.parse_args(argv)
    mf = manifest.Manifest()
    limits = mf.check(args.workload)["limits"]
    for seed in (int(s) for s in args.seeds.split(",")):
        nums = readings(args.workload, seed, args.passes, mf=mf)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "passes": args.passes, "control": nums,
                          "limits": limits,
                          "fails": not check.judge(nums, limits)}))
        sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
