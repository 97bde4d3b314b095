"""The traversal kernels timed at the shapes the benchmark, big-scene and
cornell frames give them (one GPU).

    python3 scripts/torch_k1_timing.py [--scenes sphere,dispersive]
                                       [--kernels K1,K1hh] [--check]
                                       [--ptxas] [--tree DIR] [--out FILE.json]
    python3 scripts/torch_k1_timing.py --kernels K2,K3 \
                                       --scenes instanced,terrain819k
    python3 scripts/torch_k1_timing.py --kernels K4,K5 --scenes cornell256 \
                                       [--staging global]

For each scene (default: the five benchmark configurations at their frame
sizes, sphere, cornell, mitsuba, instanced 512x512 and dispersive 1024x1024,
and terrain320k 512x512; also terrain20k, terrain80k and terrain819k, the
big-scene frame's scene, at 512x512; cornell256 and instanced256, the frames
of chip_smoke.py's cornell and instanced checks) it makes the real rays of one frame as
``chip_smoke.py`` does (primary rays of sample 0, the bounce-1 and NEE shadow
rays that ``shade`` emits from their hits) and times each kernel of
``--kernels`` (any family of ``chip_smoke.FAMILIES``: ``K1`` det^2-scaled
Moller-Trumbore, ``K1hh`` Havel-Herout, ``K2``, ``K3``, ``K4``, ``K5``):
closest hit on the primary and bounce-1 rays, any hit on the shadow rays,
and closest hit on the primary rays with every lane inactive (``inactive``:
what a launch costs that traverses nothing).
``ms`` is the device time of one launch, the least of three CUDA-graph
replays of 20 launches (the most is kept beside it); ``call_ms`` is 20
wrapper calls back to back, the host's part included. Each row names the
kernel's staging branch where it has one. ``--check`` also holds every
result against the kernel's plain version, field for field, bit for bit,
gives each ray set the least time the card could take for it
(``chip_smoke.bound_ms``, from the plain version's counts) and, where the
plain version counts work per lane, its SIMT ceilings
(``ops/intersect.py::simt_ceilings``). ``--ptxas`` builds the
kernels' sources once more with ``-Xptxas -v`` and prints what the assembler
reports per entry point (registers, stack frame, spills, shared memory).

``--tree DIR`` times the package and ``chip_smoke.py`` of another checkout
(the parent commit, or a variant of a kernel, unpacked under an ignored
directory) with this script, so two trees are timed in one call on one card;
``--scene-cache DIR`` keeps each compiled scene there as ``.npz`` and reads
it back in the next run (the 819k-triangle terrain takes about 25 s to
compile). ``--staging global`` runs every kernel that has a staging branch
with its buffer in global memory. Needs a CUDA
device and nvcc; exits non-zero without a CUDA device. Prints one JSON
object with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCENES = {
    "sphere": 512, "cornell": 512, "mitsuba": 512, "instanced": 512,
    "dispersive": 1024, "terrain320k": 512,
}
# more scenes that --scenes may name: the terrains of the mode-by-scene grid
# and the big-scene frame's, by the grid of make_terrain_scene
TERRAINS = {"terrain20k": 100, "terrain80k": 200, "terrain320k": 400, "terrain819k": 640}
FRAMES = {**SCENES, "terrain20k": 512, "terrain80k": 512, "terrain819k": 512}
# a scene at another frame size than its configuration's: name -> (scene, frame)
AT_FRAME = {"cornell256": ("cornell", 256), "instanced256": ("instanced", 256)}
# what a row reports of the packed scene, where the kernel has it
LAYOUT_KEYS = ("staging", "stack_cap", "smem_bytes")
SETS = (("primary", False), ("bounce1", False), ("shadow", True), ("inactive", False))


def ptxas_report(kernels) -> dict:
    """``nvcc -Xptxas -v`` on the sources of ``kernels`` with the package's
    own flags: the assembler's lines per entry point, by source."""
    import chip_smoke
    from polaris_tpu_torch.ops import _build, _launch

    out = {}
    for fam in kernels:
        source = chip_smoke.module_of(fam).SOURCE
        if source in out:
            continue
        probe = os.path.join(_build.BUILD_DIR, f"ptxas_probe_{fam}.so")
        os.makedirs(_build.BUILD_DIR, exist_ok=True)
        cmd = [
            _build._find_nvcc(), *_build.NVCC_FLAGS, *_launch.EXTRA_FLAGS,
            "-Xptxas", "-v", "-o", probe, os.path.join(_build.CSRC_DIR, source),
        ]
        res = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
        if res.returncode != 0:
            raise RuntimeError(res.stderr)
        out[source] = [
            ln.strip() for ln in (res.stdout + res.stderr).splitlines()
            if re.search(r"Compiling entry|Used \d+ registers|stack frame|spill", ln)
        ]
    return out


def load_scene(name: str, cache=None):
    """The compiled scene ``name``; with ``cache`` (a directory) read from and
    kept in ``cache/name.npz``."""
    import dataclasses

    import numpy as np

    import chip_smoke
    from polaris_tpu_torch.asset.compiler.compiler import compile_scene
    from polaris_tpu_torch.asset.procedural import make_terrain_scene
    from polaris_tpu_torch.asset.scene_data import SceneData

    path = os.path.join(cache, f"{name}.npz") if cache else None
    if path and os.path.exists(path):
        with np.load(path) as z:
            return SceneData(**{
                k: (z[k].item() if z[k].ndim == 0 else z[k]) for k in z.files
            })
    if name in TERRAINS:
        scene = compile_scene(make_terrain_scene(grid=TERRAINS[name]))
    else:
        scene = chip_smoke.load_scene(name)
    if path:
        os.makedirs(cache, exist_ok=True)
        np.savez(path, **{f.name: getattr(scene, f.name) for f in dataclasses.fields(scene)})
    return scene


def equal_hits(a, b) -> bool:
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    return all(torch.equal(getattr(a, f), getattr(b, f)) for f in a._fields)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scenes", default=",".join(SCENES))
    ap.add_argument("--kernels", default="K1,K1hh")
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--ptxas", action="store_true")
    ap.add_argument("--tree", default=REPO,
                    help="the checkout whose package and chip_smoke.py are timed")
    ap.add_argument("--scene-cache", default=None)
    ap.add_argument("--staging", choices=("global",), default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_k1_timing: no CUDA device available", file=sys.stderr)
        return 1
    root = os.path.abspath(args.tree)
    sys.path.insert(0, root)
    import chip_smoke
    from polaris_tpu_torch.ops import intersect as tix

    kernels = args.kernels.split(",")
    card = chip_smoke.nvidia_smi_line()
    report = {"card": card, "torch": torch.__version__, "root": root,
              "staging": args.staging, "sets": []}
    if args.ptxas:
        report["ptxas"] = ptxas_report(kernels)
    ceilings = getattr(tix, "simt_ceilings", None)
    t_start = time.perf_counter()
    with torch.no_grad():
        for name in args.scenes.split(","):
            scene_name, frame = AT_FRAME.get(name, (name, FRAMES.get(name)))
            sr = chip_smoke.SceneRays(
                scene_name, load_scene(scene_name, args.scene_cache), frame
            )
            o, d, maxt, alive = sr.rays["primary"]
            sr.rays["inactive"] = (o, d, maxt, torch.zeros_like(alive))
            for fam in kernels:
                kern = sr.bound(fam, args.staging) if args.staging else sr.bound(fam)
                for key, any_hit in SETS:
                    rays = sr.rays[key]
                    row = {
                        "scene": name, "frame": sr.frame, "kernel": fam, "rays": key,
                        "any_hit": any_hit, "n_rays": int(rays[0].shape[0]),
                        "n_active": int(rays[3].sum()),
                        **{k: kern.P[k] for k in LAYOUT_KEYS if k in kern.P},
                    }
                    times = [
                        chip_smoke.time_ms(lambda: kern.run(rays, any_hit), reps=20)
                        for _ in range(3)
                    ]
                    row["ms"], row["ms_max"] = min(times), max(times)
                    row["call_ms"] = chip_smoke.call_ms(lambda: kern.run(rays, any_hit), reps=20)
                    if args.check:
                        stats = {"per_lane": True} if ceilings is not None else None
                        ref = kern.plain(rays, any_hit, stats)
                        got = kern.run(rays, any_hit)
                        row["equal_to_plain"] = equal_hits(got, ref.mask if any_hit else ref)
                        if stats is not None and "lane_inner" in stats:
                            row["simt_ceilings"] = ceilings(
                                stats["lane_inner"] + stats["lane_tris"], rays[3]
                            )
                            row["stack_peak"] = stats["stack_peak"]
                        if stats is not None and "slabs" in stats:
                            b_ms, b_by, _ = chip_smoke.bound_ms(kern, rays, any_hit, stats)
                            row.update(bound_ms=b_ms, bound_by=b_by,
                                       share_of_bound=b_ms / row["ms"])
                        if not row["equal_to_plain"]:
                            print(f"torch_k1_timing: {name}/{fam}/{key} differs "
                                  "from the plain version", file=sys.stderr)
                    report["sets"].append(row)
                    print(json.dumps(row), flush=True)
            del sr
            torch.cuda.empty_cache()
    report["seconds"] = time.perf_counter() - t_start
    text = json.dumps(report)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text)
    print(card)
    print(text)
    return 0 if all(r.get("equal_to_plain", True) for r in report["sets"]) else 1


if __name__ == "__main__":
    sys.exit(main())
