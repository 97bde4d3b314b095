"""Frame ms of the PyTorch/CUDA port's sample loops on one GPU, to hold two
trees of the repo against each other in one call.

    python3 scripts/torch_loop_ms.py [--repo DIR] [--reps N] [--out FILE.json]

Imports ``polaris_tpu_torch`` from ``--repo`` (default: the checkout this
script is in; another tree, say an older commit unpacked with
``git archive``, builds its own kernels into its own ``build/``), and renders
the flagship frame (sphere.obj, 512x512, 16 spp, 5 bounces, RR after 3, mode
'auto', one launch) with ``render_accum`` through the sequential sample loop
and through path regeneration: one frame each to capture the graphs, then
``--reps`` frames each, alternating, each timed from a device
synchronisation to the next. Prints one JSON object: the card's name and
power limit, the tree, and each loop's frame ms (best and all). Needs a CUDA
device and nvcc; without a CUDA device it exits non-zero.

Run parent, change, change, parent in one call to compare two trees.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    return out.splitlines()[0]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--repo", default=HERE, help="the tree to import the port from")
    ap.add_argument("--reps", type=int, default=5, help="timed frames per loop")
    ap.add_argument("--out", help="also write the JSON object to this file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_loop_ms: no CUDA device available", file=sys.stderr)
        return 1
    repo = os.path.abspath(args.repo)
    sys.path.insert(0, repo)
    from polaris_tpu_torch.asset.compiler.compiler import compile_scene
    from polaris_tpu_torch.asset.wavefront import read_scene
    from polaris_tpu_torch.render.integrator import TorchRenderer
    from polaris_tpu_torch.render.options import RenderOptions

    scene = compile_scene(read_scene(os.path.join(repo, "scenes", "sphere.obj")))
    opt = RenderOptions(width=512, height=512, spp=16, num_bounces=5, min_bounces_for_rr=3)
    renderers = {}
    for loop in ("sequential", "regen"):
        r = TorchRenderer(scene, mode="auto", regen=loop == "regen")
        r.spp_per_launch = opt.spp
        r.render_accum(opt)  # captures the loop's graphs
        renderers[loop] = r
    ms = {loop: [] for loop in renderers}
    for _ in range(args.reps):
        for loop, r in renderers.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r.render_accum(opt)
            torch.cuda.synchronize()
            ms[loop].append((time.perf_counter() - t0) * 1e3)
    out = {
        "card": _card(),
        "repo": repo,
        "frame": "sphere 512x512x16spp, 5 bounces, RR after 3, mode auto",
        **{f"{loop}_ms": min(v) for loop, v in ms.items()},
        **{f"{loop}_ms_all": v for loop, v in ms.items()},
    }
    line = json.dumps(out)
    print(line, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
