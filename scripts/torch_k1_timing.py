"""K1, the binary traversal kernel, timed at the shapes the benchmark frames
give it (one GPU).

    python3 scripts/torch_k1_timing.py [--scenes sphere,dispersive]
                                       [--kernels K1,K1hh] [--check]
                                       [--ptxas] [--out FILE.json]

For each scene (default: the five benchmark configurations at their frame
sizes, sphere, cornell, mitsuba, instanced 512x512 and dispersive 1024x1024,
and terrain320k 512x512) it makes the real rays of one frame as
``chip_smoke.py`` does (primary rays of sample 0, the bounce-1 and NEE shadow
rays that ``shade`` emits from their hits) and times K1 with both of its
triangle tests (``K1``: det^2-scaled Moller-Trumbore, ``K1hh``: Havel-Herout):
closest hit on the primary and bounce-1 rays, any hit on the shadow rays,
and closest hit on the primary rays with every lane inactive (``inactive``:
what a launch costs that traverses nothing).
``ms`` is the device time of one launch, the least of three CUDA-graph
replays of 20 launches (the most is kept beside it); ``call_ms`` is 20
wrapper calls back to back, the host's part included. ``--check`` also holds
every result against the kernel's plain version, field for field, bit for
bit, and, where the plain version counts work per lane, gives each ray set
its SIMT ceilings (``ops/intersect.py::simt_ceilings``). ``--ptxas`` builds
``csrc/intersect.cu`` once more with ``-Xptxas -v`` and prints what the
assembler reports per entry point (registers, stack frame, spills, shared
memory).

Runs from any checkout of the repository that has ``chip_smoke.py`` (it uses
that script's ray generation and kernel binding), so two trees can be timed
in one call on one card. Needs a CUDA device and nvcc; exits non-zero
without a CUDA device. Prints one JSON object with the card's name and power
limit.
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
sys.path.insert(0, REPO)

SCENES = {
    "sphere": 512, "cornell": 512, "mitsuba": 512, "instanced": 512,
    "dispersive": 1024, "terrain320k": 512,
}
SETS = (("primary", False), ("bounce1", False), ("shadow", True), ("inactive", False))


def ptxas_report() -> list:
    """``nvcc -Xptxas -v`` on intersect.cu with the package's own flags: the
    assembler's lines per entry point."""
    from polaris_tpu_torch.ops import _build, _launch

    src = os.path.join(_build.CSRC_DIR, "intersect.cu")
    out = os.path.join(_build.BUILD_DIR, "ptxas_probe.so")
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    cmd = [
        _build._find_nvcc(), *_build.NVCC_FLAGS, *_launch.EXTRA_FLAGS,
        "-Xptxas", "-v", "-o", out, src,
    ]
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    if res.returncode != 0:
        raise RuntimeError(res.stderr)
    lines = [
        ln.strip() for ln in (res.stdout + res.stderr).splitlines()
        if re.search(r"Compiling entry|Used \d+ registers|stack frame|spill", ln)
    ]
    return lines


def load_scene(name: str):
    import chip_smoke
    from polaris_tpu_torch.asset.compiler.compiler import compile_scene
    from polaris_tpu_torch.asset.procedural import make_terrain_scene

    if name == "terrain320k":
        return compile_scene(make_terrain_scene(grid=chip_smoke.STREAM_GRID))
    return chip_smoke.load_scene(name)


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
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_k1_timing: no CUDA device available", file=sys.stderr)
        return 1
    import chip_smoke
    from polaris_tpu_torch.ops import intersect as tix

    card = chip_smoke.nvidia_smi_line()
    report = {"card": card, "torch": torch.__version__, "root": REPO, "sets": []}
    if args.ptxas:
        report["ptxas"] = ptxas_report()
    ceilings = getattr(tix, "simt_ceilings", None)
    t_start = time.perf_counter()
    with torch.no_grad():
        for name in args.scenes.split(","):
            sr = chip_smoke.SceneRays(name, load_scene(name), SCENES[name])
            o, d, maxt, alive = sr.rays["primary"]
            sr.rays["inactive"] = (o, d, maxt, torch.zeros_like(alive))
            for fam in args.kernels.split(","):
                kern = sr.bound(fam)
                for key, any_hit in SETS:
                    rays = sr.rays[key]
                    row = {
                        "scene": name, "frame": sr.frame, "kernel": fam, "rays": key,
                        "any_hit": any_hit, "n_rays": int(rays[0].shape[0]),
                        "n_active": int(rays[3].sum()),
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
                        if stats is not None:
                            row["simt_ceilings"] = ceilings(
                                stats["lane_inner"] + stats["lane_tris"], rays[3]
                            )
                            row["stack_peak"] = stats["stack_peak"]
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
