"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA traversal kernel from ``polaris_tpu_torch/csrc`` with nvcc,
then runs five phases, each printing one JSON line:

  device    card name and power limit (nvidia-smi), torch / CUDA versions
  build     seconds to build and load the kernel library
  kernels   closest_hit and any_hit against their plain PyTorch version on
            real rays of the flagship frame (sphere, 512x512, blocked order:
            primary, bounce-1 and NEE shadow rays) and of the instanced
            scene (TLAS + transforms), plus an all-inactive batch and a ray
            count that is no multiple of the block size; times each with
            CUDA events and works out the least time the card could take
  golden    sphere 32x32, 2 spp, 2 bounces through the kernel against the
            accumulator the JAX package rendered (tests/fixtures)
  flagship  sphere 512x512, 16 spp, 5 bounces, RR after 3, path
            regeneration, one launch, ``render_u8``: one warm-up, best of 3,
            launch counts of both kernel entry points read around one frame

The last three lines of the output are: the card's name and power limit as
nvidia-smi prints them, one JSON object ``{"kernels": [...]}``, and
``{"ok": true, "device": {...}}``. Any failure ends the run with a non-zero
exit code and no result line; without a CUDA device nothing runs.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

# published peaks of one H100 SXM (NVIDIA data sheet): the yardsticks of bound_ms
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOPS = 67e12
# float operations per unit of traversal work, counted from csrc/intersect.cu
SLAB_FLOPS = 25  # 6 sub, 6 mul, 10 min/max, 3 compares
TRI_FLOPS = 53  # 2 cross (18), 4 dot (20), 3 sub, 3 mul, 1 div, 8 compares
XFORM_FLOPS = 36  # 3x4 matrix on o and d, 3 reciprocals

# the flagship frame (the JAX package's bench.py workload) and the check sizes
FRAME = 512
SPP = 16
BOUNCES = 5
RR_AFTER = 3
INSTANCED_FRAME = 256
RAGGED = 100_003  # a ray count that is no multiple of the block size

T_RTOL, T_ATOL = 1e-5, 1e-6  # t, u, v on lanes where both versions hit
MAX_MISMATCH_SHARE = 1e-4  # lanes whose found/tri/inst may differ (ties)
REPLACES = "polaris_tpu/ops/intersect_pallas.py:93"


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    return out.splitlines()[0]


def load_scene(name: str):
    from polaris_tpu_torch.asset.compiler.compiler import compile_scene
    from polaris_tpu_torch.asset.wavefront import read_scene

    obj = os.path.join(HERE, "scenes", f"{name}.obj")
    if not os.path.exists(obj):
        fail(f"missing scene file {obj}")
    return compile_scene(read_scene(obj))


def time_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` launches (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def frame_rays(renderer, width: int, height: int, seed: int = 0):
    """Real rays of one frame in blocked lane order: the primary rays of
    sample 0, and the bounce-1 and NEE shadow rays that ``shade`` emits from
    their closest hits (found with the kernel)."""
    from polaris_tpu_torch.ops import rng
    from polaris_tpu_torch.ops import vec as V
    from polaris_tpu_torch.render.options import RenderOptions
    from polaris_tpu_torch.render.raygen import gen_rays
    from polaris_tpu_torch.render.shade import shade

    opt = RenderOptions(width=width, height=height)
    S = renderer.S
    xs, ys, pix, _ = renderer._pixel_order(width, height)
    frustum, eye = renderer._camera_tensors(opt, None)
    n = width * height
    U = rng.make_uniform(seed, pix, 0, 0)
    o, d = gen_rays(frustum, eye, width, height, xs, ys, U)
    maxt = torch.full((n,), V.FLT_MAX, dtype=torch.float32, device=o.device)
    alive = torch.ones(n, dtype=torch.bool, device=o.device)
    hit = renderer.closest(S, o, d, maxt, alive)
    out = shade(
        S, U, bounce=0, min_bounces_for_rr=RR_AFTER,
        num_emissives=renderer.num_emissives,
        material_depth=renderer.material_depth,
        ray_o=o, ray_d=d, t=torch.where(hit.mask, hit.t, 0.0),
        inst=hit.inst, tri=hit.tri, bary_u=hit.u, bary_v=hit.v,
        hit_mask=hit.mask,
        throughput=torch.ones((n, 3), dtype=torch.float32, device=o.device),
        flags=torch.zeros(n, dtype=torch.int32, device=o.device),
    )
    return {
        "primary": (o, d, maxt, alive),
        "bounce1": (
            out["next_o"].contiguous(), out["next_d"].contiguous(), maxt,
            out["next_mask"],
        ),
        "shadow": (
            out["occl_o"].contiguous(), out["occl_d"].contiguous(),
            out["occl_maxt"], out["occl_mask"],
        ),
    }


def compare(S, rays, any_hit: bool, label: str, stats=None):
    """Kernel vs plain version on one ray set; returns a record, fails the
    run on disagreement."""
    from polaris_tpu_torch.ops import intersect_cuda
    from polaris_tpu_torch.ops.intersect import intersect_bvh

    o, d, maxt, active = rays
    n = int(o.shape[0])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref = intersect_bvh(S, o, d, maxt, active, any_hit=any_hit, stats=stats)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    if any_hit:
        got_mask = intersect_cuda.any_hit(S, o, d, maxt, active)
        torch.cuda.synchronize()
        mism = int((got_mask != ref.mask).sum())
        max_err = float(mism > 0)
    else:
        got = intersect_cuda.closest_hit(S, o, d, maxt, active)
        torch.cuda.synchronize()
        differ = (got.mask != ref.mask) | (
            ref.mask & ((got.tri != ref.tri) | (got.inst != ref.inst))
        )
        mism = int(differ.sum())
        both = got.mask & ref.mask
        max_err = 0.0
        for a, b, nm in ((got.t, ref.t, "t"), (got.u, ref.u, "u"), (got.v, ref.v, "v")):
            if not torch.isfinite(a).all():
                fail(f"{label}: kernel returned non-finite {nm}")
            if bool(both.any()):
                err = (a[both] - b[both]).abs()
                tol = T_ATOL + T_RTOL * b[both].abs()
                if bool((err > tol).any()):
                    fail(
                        f"{label}: {nm} disagrees with the plain version "
                        f"(max abs err {float(err.max()):.3e}, rtol {T_RTOL}, atol {T_ATOL})"
                    )
                max_err = max(max_err, float(err.max()))
        if bool((~got.mask & (got.t != 0)).any()):
            fail(f"{label}: a lane without a hit has t != 0")
    if mism > MAX_MISMATCH_SHARE * max(n, 1):
        fail(
            f"{label}: {mism} of {n} lanes disagree on found/tri/inst "
            f"(allowed share {MAX_MISMATCH_SHARE})"
        )
    return {
        "check": label, "any_hit": any_hit, "n_rays": n,
        "n_active": int(active.sum()), "mismatched_lanes": mism,
        "max_abs_err": max_err, "plain_ms": plain_ms,
    }


def bound_ms(S, rays, any_hit: bool, stats: dict):
    """Least time the card could take for this call: the larger of bytes
    moved once over the memory rate and float operations over the fp32
    rate. Operation counts are what THIS data needed (node visits, triangle
    tests and instance entries counted by the plain version)."""
    o, d, maxt, active = rays
    n = int(o.shape[0])
    nbytes = sum(int(x.numel() * x.element_size()) for x in (o, d, maxt, active))
    nbytes += n * (1 if any_hit else 3 * 4 + 2 * 4 + 1)  # outputs
    scene_keys = (
        "bvh_min", "bvh_max", "bvh_ldata", "bvh_rdata", "tri_v0", "tri_e1",
        "tri_e2", "inst_w2o", "inst_bvh_root",
    )
    nbytes += sum(int(S[k].numel() * S[k].element_size()) for k in scene_keys)
    flops = (
        stats["inner"] * 2 * SLAB_FLOPS
        + stats["tris"] * TRI_FLOPS
        + stats["inst"] * XFORM_FLOPS
    )
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_flops = flops / PEAK_FP32_FLOPS * 1e3
    return max(t_bytes, t_flops), ("bytes" if t_bytes >= t_flops else "operations"), {
        "bytes": nbytes, "flops": flops, "bytes_ms": t_bytes, "flops_ms": t_flops,
        "inner_visits_per_ray": stats["inner"] / max(n, 1),
        "tri_tests_per_ray": stats["tris"] / max(n, 1),
    }


def phase_kernels(sphere, instanced):
    from polaris_tpu_torch.ops import intersect_cuda
    from polaris_tpu_torch.render.integrator import TorchRenderer

    checks = []
    entries = {}
    r_sphere = TorchRenderer(sphere, mode="kernel", regen=True)
    S = r_sphere.S
    rays = frame_rays(r_sphere, FRAME, FRAME)
    # the two launches the main path makes per trip, at its shapes: closest
    # hit on a frame of primary rays, any hit on the shadow rays they spawn
    for name, key, any_hit in (
        ("closest_hit", "primary", False),
        ("any_hit", "shadow", True),
    ):
        stats = {}
        rec = compare(S, rays[key], any_hit, f"sphere{FRAME}/{key}", stats)
        fn = getattr(intersect_cuda, name)
        ms = time_ms(lambda: fn(S, *rays[key]), reps=20)
        b_ms, b_by, detail = bound_ms(S, rays[key], any_hit, stats)
        checks.append(rec)
        entries[name] = {
            "name": name, "route": "cuda",
            "source": "polaris_tpu_torch/csrc/intersect.cu",
            "replaces": REPLACES, "launches": 0,
            "n_rays": rec["n_rays"], "rays": f"sphere {FRAME}x{FRAME} {key}",
            "max_abs_err": rec["max_abs_err"],
            "mismatched_lanes": rec["mismatched_lanes"],
            "ms": ms, "plain_ms": rec["plain_ms"], "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": None, "bound_detail": detail,
        }
    # incoherent rays: bounce 1 through closest hit (checked and timed)
    rec = compare(S, rays["bounce1"], False, f"sphere{FRAME}/bounce1")
    rec["ms"] = time_ms(lambda: intersect_cuda.closest_hit(S, *rays["bounce1"]), reps=20)
    checks.append(rec)
    entries["closest_hit"]["ms_bounce1"] = rec["ms"]

    # instanced scene: TLAS leaves, world->object transforms, restore on exit
    r_inst = TorchRenderer(instanced, mode="kernel")
    rays_i = frame_rays(r_inst, INSTANCED_FRAME, INSTANCED_FRAME)
    for key, any_hit in (("primary", False), ("bounce1", False), ("shadow", True)):
        checks.append(compare(r_inst.S, rays_i[key], any_hit, f"instanced{INSTANCED_FRAME}/{key}"))

    # all lanes inactive, and a ray count that is no multiple of the block
    o, d, maxt, alive = rays["primary"]
    dead = torch.zeros_like(alive)
    for any_hit in (False, True):
        rec = compare(S, (o, d, maxt, dead), any_hit, f"sphere{FRAME}/all-inactive")
        checks.append(rec)
    got = intersect_cuda.closest_hit(S, o, d, maxt, dead)
    if bool(got.mask.any()) or bool((got.t != 0).any()):
        fail("all-inactive batch: a lane reports a hit")
    m = RAGGED
    ragged = (o[:m].contiguous(), d[:m].contiguous(), maxt[:m], alive[:m])
    ragged_s = tuple(x[:m].contiguous() for x in rays["shadow"])
    checks.append(compare(S, ragged, False, f"sphere{FRAME}/ragged-{RAGGED}"))
    checks.append(compare(S, ragged_s, True, f"sphere{FRAME}/ragged-{RAGGED}-shadow"))

    for name, e in entries.items():
        own = [c for c in checks if c["any_hit"] == (name == "any_hit")]
        e["max_abs_err"] = max(c["max_abs_err"] for c in own)
        e["mismatched_lanes"] = sum(c["mismatched_lanes"] for c in own)
    emit("kernels", checks=checks)
    return entries


def phase_golden(sphere):
    from polaris_tpu_torch.render.integrator import TorchRenderer
    from polaris_tpu_torch.render.options import RenderOptions

    path = os.path.join(HERE, "tests", "fixtures", "torch_golden_sphere_32.npz")
    fx = np.load(path)
    opt = RenderOptions(
        width=int(fx["width"]), height=int(fx["height"]), spp=int(fx["spp"]),
        num_bounces=int(fx["num_bounces"]),
        min_bounces_for_rr=int(fx["min_bounces_for_rr"]), seed=int(fx["seed"]),
    )
    got = TorchRenderer(sphere, mode="kernel").render_accum(opt).cpu().numpy()
    ref = fx["accum"]
    if got.shape != ref.shape or not np.isfinite(got).all():
        fail("golden: wrong shape or non-finite accumulator")
    # a lane whose RR / branch decision flips on an ulp changes its pixel by
    # far more than any tolerance: such pixels are counted, at most 0.5%
    bad = (~np.isclose(got, ref, atol=1e-4, rtol=1e-3)).any(axis=-1)
    allowed = int(0.005 * bad.size)
    emit(
        "golden", pixels=int(bad.size), outside_tolerance=int(bad.sum()),
        allowed=allowed, max_abs_diff=float(np.abs(got - ref).max()),
        atol=1e-4, rtol=1e-3,
    )
    if int(bad.sum()) > allowed:
        fail(f"golden: {int(bad.sum())} pixels outside tolerance (> {allowed})")


def phase_flagship(sphere, smi: str):
    from polaris_tpu_torch.ops import intersect_cuda
    from polaris_tpu_torch.render.integrator import TorchRenderer
    from polaris_tpu_torch.render.options import RenderOptions

    # the flagship flow: one launch for the frame, render + tonemap on the
    # device, fetch the u8 image
    renderer = TorchRenderer(sphere, mode="auto", regen=True)
    renderer.spp_per_launch = SPP
    opt = RenderOptions(
        width=FRAME, height=FRAME, spp=SPP, num_bounces=BOUNCES,
        min_bounces_for_rr=RR_AFTER,
    )
    renderer.render_u8(opt)  # warm-up
    times = []
    img = None
    launches = {}
    for _ in range(3):
        intersect_cuda.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        img = renderer.render_u8(opt)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        launches = dict(intersect_cuda.LAUNCHES)
    best = min(times)
    if img.shape != (FRAME, FRAME, 3) or img.dtype != np.uint8:
        fail(f"flagship: unexpected image {img.shape} {img.dtype}")
    if img.min() == img.max():
        fail("flagship: constant image")
    for name, count in launches.items():
        if count <= 0:
            fail(f"flagship: kernel entry point {name} was never launched")
    if launches["closest_hit"] != renderer.last_trips:
        fail("flagship: closest-hit launches differ from the loop's trip count")

    # the same estimator through the plain traversal, on a smaller frame
    small = RenderOptions(
        width=128, height=128, spp=4, num_bounces=BOUNCES,
        min_bounces_for_rr=RR_AFTER,
    )
    images = []
    for mode in ("kernel", "bvh"):
        r = TorchRenderer(sphere, mode=mode, regen=True)
        r.spp_per_launch = 16
        images.append(r.render_u8(small).astype(np.int16))
    diff = np.abs(images[0] - images[1])
    off = int((diff > 0).any(axis=-1).sum())
    if int(diff.max()) > 1 or off > 0.001 * 128 * 128:
        fail(
            f"flagship: kernel and plain traversal images differ "
            f"(max {int(diff.max())} levels, {off} pixels)"
        )

    rays = opt.width * opt.height * opt.spp * opt.num_bounces * 2
    emit(
        "flagship", frame_ms=best * 1e3, frame_ms_all=[t * 1e3 for t in times],
        trips=renderer.last_trips,
        launches=launches, mrays_per_s=rays / best / 1e6, card=smi,
        plain_check={"frame": "128x128x4spp", "max_level_diff": int(diff.max()),
                     "pixels_differing": off},
    )
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    # before anything is printed: without the package beside this script the
    # run ends here, non-zero, with an empty standard output
    from polaris_tpu_torch.ops import intersect_cuda

    torch.backends.cuda.matmul.allow_tf32 = False
    smi = nvidia_smi_line()
    emit(
        "device", card=smi, torch=torch.__version__, cuda=torch.version.cuda,
        kind=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
    )

    t0 = time.perf_counter()
    intersect_cuda.load()
    emit("build", seconds=time.perf_counter() - t0, source=intersect_cuda.SOURCE,
         flags=list(intersect_cuda.EXTRA_FLAGS))

    sphere = load_scene("sphere")
    instanced = load_scene("instanced")
    with torch.no_grad():
        entries = phase_kernels(sphere, instanced)
        phase_golden(sphere)
        launches = phase_flagship(sphere, smi)
    for name, e in entries.items():
        e["launches"] = launches[name]

    print(smi, flush=True)
    print(json.dumps({"kernels": list(entries.values())}), flush=True)
    print(
        json.dumps(
            {
                "ok": True,
                "device": {
                    "platform": "gpu",
                    "kind": torch.cuda.get_device_name(0),
                    "count": torch.cuda.device_count(),
                },
            }
        ),
        flush=True,
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
