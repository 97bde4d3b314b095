"""Where a frame's time goes in the PyTorch/CUDA port (one GPU).

    python3 scripts/torch_frame_breakdown.py [--out FILE.json]
    python3 scripts/torch_frame_breakdown.py --scene terrain819k --mode pallas8_nodes
    python3 scripts/torch_frame_breakdown.py --scene dispersive --spp 16

Without arguments renders the flagship frame (sphere.obj, 512x512, 16 spp,
5 bounces, RR after bounce 3, path regeneration, one launch, ``render_u8``).
``--scene cornell | instanced | mitsuba | dispersive`` renders that scene at
the size of its benchmark configuration (512x512 at 64, 16, 16 spp;
dispersive 1024x1024 at 256 spp) with the same loop; ``--spp`` cuts the
samples (a frame of 256 spp under the profiler is over a million device
kernels). ``--scene terrain819k`` renders the big-scene frame instead (the
procedural terrain at grid 640, 512x512, 4 spp, 3 bounces, RR after 4,
sequential sample loop, ``spp_per_launch=1``) through the traversal mode given
by ``--mode`` (``pallas8_nodes`` or ``pallas_nodes``). The renderer replays
each step of its loop from a CUDA graph; the eager baseline is the same frame
through the eager loop functions (``render_blocked_eager``). Prints one JSON
object:

  frame       best-of-3 frame ms through the graphs and through the eager
              loops, the trips of the sample loop (with a live lane, and
              run: overshoot included), graph replays and host syncs a
              frame, seconds spent capturing the graphs
  profile     one graph frame under torch.profiler: wall ms, summed
              device-kernel ms, kernels run, device busy share, the heaviest
              kernels
  profile_eager  the same for one eager frame
  layers      one eager frame with a device synchronisation around every
              layer (raygen, closest hit, shade, any hit): serialised ms per
              layer, calls, and what is left for RNG and loop bookkeeping;
              and, in a second such frame, the atlas fetches inside shade
              (``texture_fetch``: every call of the sampler's corner gather)
  loop_sync   latency of the stop test ``bool(alive.any())`` on an idle
              device, and that latency times the graph frame's host syncs

Needs a CUDA device and nvcc (a traversal kernel is built at first use);
without a CUDA device it exits non-zero. Every number is measured on the card
this runs on; its name and power limit are part of the output.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

# scene -> frame, spp, bounces, RR after, regen, spp per launch, default mode
WORKLOADS = {
    "sphere": (512, 16, 5, 3, True, 16, "auto"),
    "cornell": (512, 64, 5, 3, True, 16, "auto"),
    "instanced": (512, 16, 5, 3, True, 16, "auto"),
    "mitsuba": (512, 16, 5, 3, True, 16, "auto"),
    "dispersive": (1024, 256, 5, 3, True, 16, "auto"),
    "terrain819k": (512, 4, 3, 4, False, 1, "pallas8_nodes"),
}


def _card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    return out.splitlines()[0]


def _timed_frame(renderer, opt) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    renderer.render_u8(opt)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def _eager_frame(renderer, opt):
    """The same frame through the eager loop functions; returns its trips."""
    from polaris_tpu_torch.render.integrator import render_blocked_eager

    accum, trips = render_blocked_eager(renderer, opt)
    renderer.finalize(accum, opt, "u8").cpu()
    return trips


def _timed_eager_frame(renderer, opt) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _eager_frame(renderer, opt)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def measure_profile(frame, trips: int) -> dict:
    """One call of ``frame`` under torch.profiler (a graph replay's kernels
    are traced one by one, as the eager ones)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        frame()
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events() if str(e.device_type).endswith("CUDA")]
    if not kernels:
        return {"wall_ms": wall_ms, "device_ms": "not measured"}
    by_name: dict = {}
    for e in kernels:
        rec = by_name.setdefault(e.name, [0.0, 0])
        us = getattr(e, "device_time_total", None)
        if us is None:  # older PyTorch spells it cuda_time_total
            us = e.cuda_time_total
        rec[0] += us / 1e3
        rec[1] += 1
    device_ms = sum(v[0] for v in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
    return {
        "wall_ms": wall_ms,  # with the profiler's own overhead
        "device_ms": device_ms,
        "device_busy_share": device_ms / wall_ms,
        "kernels_launched": len(kernels),
        "kernels_per_trip": len(kernels) / max(trips, 1),
        "top_kernels": [
            {"name": k[:80], "ms": v[0], "launches": v[1]} for k, v in top
        ],
    }


def measure_layers(renderer, opt) -> dict:
    """One eager frame with every layer fenced by device synchronisations."""
    from polaris_tpu_torch.render import integrator

    spent = {"raygen": [0.0, 0], "closest_hit": [0.0, 0], "shade": [0.0, 0],
             "any_hit": [0.0, 0]}

    def fenced(name, fn):
        def run(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            spent[name][0] += (time.perf_counter() - t0) * 1e3
            spent[name][1] += 1
            return out

        return run

    saved = (integrator.gen_rays, integrator.shade, renderer.closest, renderer.any_hit)
    integrator.gen_rays = fenced("raygen", saved[0])
    integrator.shade = fenced("shade", saved[1])
    renderer.closest = fenced("closest_hit", saved[2])
    renderer.any_hit = fenced("any_hit", saved[3])
    try:
        total = _timed_eager_frame(renderer, opt)
    finally:
        integrator.gen_rays, integrator.shade, renderer.closest, renderer.any_hit = saved
    layers = {k: {"ms": v[0], "calls": v[1]} for k, v in spent.items()}
    layers["rng_and_bookkeeping"] = {"ms": total - sum(v[0] for v in spent.values())}
    layers["serialised_frame_ms"] = total

    # the atlas fetches, which happen inside shade: a frame of their own, so
    # that their fences do not count into the layers above
    from polaris_tpu_torch.ops import texture

    spent["texture_fetch"] = [0.0, 0]
    saved_fetch = texture._corners
    texture._corners = fenced("texture_fetch", saved_fetch)
    try:
        fetch_frame = _timed_eager_frame(renderer, opt)
    finally:
        texture._corners = saved_fetch
    layers["texture_fetch"] = {
        "ms": spent["texture_fetch"][0], "calls": spent["texture_fetch"][1],
        "frame_ms_with_these_fences": fetch_frame,
    }
    return layers


def measure_loop_sync(n: int, syncs: int, reps: int = 200) -> dict:
    alive = torch.ones(n, dtype=torch.bool, device="cuda")
    bool(alive.any())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        bool(alive.any())
    per_sync = (time.perf_counter() - t0) * 1e3 / reps
    return {"ms_per_sync_idle_device": per_sync, "host_syncs_per_frame": syncs,
            "ms_per_frame": per_sync * syncs}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", help="also write the JSON object to this file")
    ap.add_argument("--scene", choices=sorted(WORKLOADS), default="sphere")
    ap.add_argument("--mode", help="traversal mode (default: the workload's own)")
    ap.add_argument("--spp", type=int, help="samples per pixel (default: the workload's own)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_frame_breakdown: no CUDA device available", file=sys.stderr)
        return 1

    from polaris_tpu_torch.asset.compiler.compiler import compile_scene
    from polaris_tpu_torch.asset.procedural import make_terrain_scene
    from polaris_tpu_torch.asset.wavefront import read_scene
    from polaris_tpu_torch.render.integrator import TorchRenderer
    from polaris_tpu_torch.render.options import RenderOptions

    frame, spp, bounces, rr_after, regen, per_launch, mode = WORKLOADS[args.scene]
    mode = args.mode or mode
    spp = args.spp or spp
    if args.scene == "terrain819k":
        scene = compile_scene(make_terrain_scene(grid=640))
    else:
        scene = compile_scene(
            read_scene(os.path.join(REPO, "scenes", f"{args.scene}.obj"))
        )
    renderer = TorchRenderer(scene, mode=mode, regen=regen)
    renderer.spp_per_launch = per_launch
    opt = RenderOptions(
        width=frame, height=frame, spp=spp, num_bounces=bounces,
        min_bounces_for_rr=rr_after,
    )
    renderer.render_u8(opt)  # warm-up: builds the kernel, captures the graphs
    frames = [_timed_frame(renderer, opt) for _ in range(3)]
    frame_ms = min(frames)
    trips, trips_run = renderer.last_trips, renderer.last_trips_run
    syncs = renderer.last_host_syncs
    # regeneration: one replay a trip and one a chunk (its start); the
    # sequential loop: one a sample
    replays = trips_run + -(-spp // per_launch) if renderer.regen else spp
    eager = [_timed_eager_frame(renderer, opt) for _ in range(3)]
    eager_trips = _eager_frame(renderer, opt)
    profile = measure_profile(lambda: renderer.render_u8(opt), trips_run)
    profile_eager = measure_profile(lambda: _eager_frame(renderer, opt), eager_trips)
    for prof, best in ((profile, frame_ms), (profile_eager, min(eager))):
        if isinstance(prof.get("device_ms"), float):
            # the profiler inflates the wall time: the busy share that
            # means something is device time over the unprofiled frame
            prof["device_busy_share_of_unprofiled_frame"] = prof["device_ms"] / best
    result = {
        "card": _card(),
        "torch": torch.__version__,
        "workload": {
            "scene": args.scene, "mode": mode, "triangles": int(scene.tri_v0.shape[0]),
            "frame": frame, "spp": spp, "bounces": bounces, "regen": regen,
        },
        "frame": {
            "frame_ms": frame_ms, "frame_ms_all": frames,
            "eager_frame_ms": min(eager), "eager_frame_ms_all": eager,
            "trips": trips, "trips_run": trips_run, "overshoot_trips": trips_run - trips,
            "graph_replays": replays, "host_syncs": syncs,
            "capture_s": renderer.capture_seconds,
            "mrays_per_s": frame * frame * spp * bounces * 2 / frame_ms / 1e3,
        },
        "profile": profile,
        "profile_eager": profile_eager,
        "layers": measure_layers(renderer, opt),
        "loop_sync": measure_loop_sync(frame * frame, syncs),
    }
    text = json.dumps(result, indent=1)
    print(text)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
