"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds every CUDA traversal kernel from ``polaris_tpu_torch/csrc`` with nvcc
(one process per source, all started together), then runs these phases, each
printing one JSON line:

  device    card name and power limit (nvidia-smi), torch / CUDA versions
  build     seconds to build each kernel library
  scenes    seconds to compile each scene on the host (sphere, instanced,
            cornell, and the procedural terrains of 320k and 819k triangles)
            and to pack the big one for each kernel; fails if the native BVH
            library did not load
  kernels   every kernel entry point, closest hit and any hit, against its
            plain PyTorch version on real rays (primary, bounce-1 and NEE
            shadow rays of a frame in blocked order): K1 on the flagship
            sphere frame, the instanced scene and terrain320k (the scene the
            JAX package streams triangles for: 'pallas_stream'); K2 and K3
            on instanced and terrain819k; K4 on sphere, instanced and
            cornell; K5 on cornell; for each an all-inactive batch and a ray
            count that is no multiple of the block size. Each kernel's hits
            are also held against K1's on the same rays. Times each on the
            device (launches replayed from a CUDA graph, ``ms``) and as the
            caller sees it (``call_ms``), and works out the least time the
            card could take from the records and operations that the plain
            version counts these rays to need
  grid      kernel ms of every mode on primary and bounce-1 rays of sphere,
            instanced and four terrains of 20k to 819k triangles (the table
            behind the 'auto' rule), each cell timed three times, and which
            kernel 'auto' picks for each scene
  golden    sphere 32x32, 2 spp, 2 bounces through the kernel against the
            accumulator the JAX package rendered (tests/fixtures)
  flagship  sphere 512x512, 16 spp, 5 bounces, RR after 3, path
            regeneration, one launch, ``render_u8``: one warm-up, best of 3,
            launch counts of both K1 entry points read around one frame
  bigscene  terrain819k 512x512, 4 spp, 3 bounces, RR after 4,
            ``spp_per_launch=1``, ``render_u8`` through K2
            (mode 'pallas8_nodes') and through K3 ('pallas_nodes'): one
            warm-up, best of 2, launch counts read around one frame, image
            non-black, the two u8 images equal; then 'hybrid' (K1 + K5) and
            'pallas8' (K4) on cornell 256x256, 4 spp against mode 'kernel'

The last three lines of the output are: the card's name and power limit as
nvidia-smi prints them, one JSON object ``{"kernels": [...]}`` with the ten
kernel entry points, and ``{"ok": true, "device": {...}}``. Any failure ends
the run with a non-zero exit code and no result line; without a CUDA device
nothing runs.
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
TRI_BYTES, XFORM_BYTES = 36, 48  # a [v0, e1, e2] row; a 3x4 matrix
# float operations per unit of traversal work, counted from csrc/traverse_common.cuh
SLAB_FLOPS = 25  # 6 sub, 6 mul, 10 min/max, 3 compares
TRI_FLOPS = 53  # 2 cross (18), 4 dot (20), 3 sub, 3 mul, 1 div, 8 compares
XFORM_FLOPS = 36  # 3x4 matrix on o and d, 3 reciprocals

# the flagship frame (the JAX package's bench.py workload) and the check sizes
FRAME = 512
SPP = 16
BOUNCES = 5
RR_AFTER = 3
SMALL_FRAME = 256  # instanced and cornell
RAGGED = 100_003  # a ray count that is no multiple of the block size
# the big-scene frame (the JAX package's bench_big.py workload)
BIG_GRID, BIG_SPP, BIG_BOUNCES, BIG_RR_AFTER = 640, 4, 3, 4
STREAM_GRID = 400  # terrain320k: the scene the JAX package streams triangles for
# the scenes of the mode-by-scene grid; the two mid-size terrains (grids 100
# and 200) are there to place the 'auto' rule's threshold
GRID_SCENES = (
    "sphere", "instanced", "terrain20k", "terrain80k", "terrain320k", "terrain819k",
)

T_RTOL, T_ATOL = 1e-5, 1e-6  # t, u, v on lanes where both versions hit
MAX_MISMATCH_SHARE = 1e-4  # lanes whose found/tri/inst may differ (ties)

# every kernel: its wrapper module (which names its source), the traversal
# mode that selects it, the TPU kernel it replaces, the prefix of its two
# entries in the ``kernels`` line, its plain version, and the bytes of one
# node record as the kernel reads it (K1: two data words and a box; K3: a
# 16-float record; K4: 8 boxes and 8 entries; K2: a 64-float record) and of
# what it reads once per instance besides the 3x4 matrix
FAMILIES = {
    "K1": dict(
        module="intersect_cuda", mode="kernel",
        replaces="polaris_tpu/ops/intersect_pallas.py:93", prefix="",
        plain=None, node_bytes=32, inst_bytes=4,
    ),
    "K2": dict(
        module="intersect_wide8_nodes", mode="pallas8_nodes",
        replaces="polaris_tpu/ops/intersect_pallas8_nodes.py:246",
        prefix="wide8_nodes_", plain="wide8_nodes_plain",
        node_bytes=256, inst_bytes=4,
    ),
    "K3": dict(
        module="intersect_nodes", mode="pallas_nodes",
        replaces="polaris_tpu/ops/intersect_pallas_nodes.py:61",
        prefix="nodes_", plain="nodes_plain", node_bytes=64, inst_bytes=4,
    ),
    "K4": dict(
        module="intersect_wide8", mode="pallas8",
        replaces="polaris_tpu/ops/intersect_pallas8.py:154",
        prefix="wide8_", plain="wide8_plain", node_bytes=224, inst_bytes=4,
    ),
    "K5": dict(
        module="intersect_dense", mode="pallas_dense",
        replaces="polaris_tpu/ops/intersect_pallas_dense.py:40",
        prefix="dense_", plain="dense_plain", node_bytes=0, inst_bytes=8,
    ),
}


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
    """Mean device time of one launch of ``fn``: ``reps`` launches are
    captured into one CUDA graph, and the graph's replay is timed with CUDA
    events, so the host's part of a launch (allocating the outputs, the
    ctypes call) is not in the number."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def call_ms(fn, reps: int) -> float:
    """Mean time of ``reps`` wrapper calls made back to back (CUDA events):
    what a caller sees, the host's part of a launch included when the
    kernel is shorter than it."""
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


def module_of(fam: str):
    import importlib

    return importlib.import_module(f"polaris_tpu_torch.ops.{FAMILIES[fam]['module']}")


class Bound:
    """One kernel bound to one uploaded scene: the kernel's two wrappers and
    its plain version on the scene as that kernel reads it (the uploaded
    scene itself for K1, the packed arrays for the others)."""

    def __init__(self, fam: str, S):
        from polaris_tpu_torch.ops.intersect import intersect_bvh, make_intersectors

        self.fam = fam
        self.module = module_of(fam)
        if fam == "K1":
            self.P = S
            self._plain = intersect_bvh
            self.pack_seconds = 0.0
        else:
            t0 = time.perf_counter()
            closest, _ = make_intersectors(S, FAMILIES[fam]["mode"])
            torch.cuda.synchronize()
            self.pack_seconds = time.perf_counter() - t0
            self.P = closest.packed
            self._plain = getattr(self.module, FAMILIES[fam]["plain"])

    def closest(self, rays):
        return self.module.closest_hit(self.P, *rays)

    def any(self, rays):
        return self.module.any_hit(self.P, *rays)

    def run(self, rays, any_hit: bool):
        return self.any(rays) if any_hit else self.closest(rays)

    def plain(self, rays, any_hit: bool, stats=None):
        return self._plain(self.P, *rays, any_hit=any_hit, stats=stats)


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


def compare(kern: Bound, rays, any_hit: bool, label: str, stats=None):
    """Kernel vs its plain version on one ray set; returns (record, kernel
    result), fails the run on disagreement. ``stats``, when given, receives
    the plain version's counts of the work these rays need."""
    o, d, maxt, active = rays
    n = int(o.shape[0])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref = kern.plain(rays, any_hit)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    if stats is not None:  # the instrumented run is not the one that is timed
        kern.plain(rays, any_hit, stats)
    got = kern.run(rays, any_hit)
    torch.cuda.synchronize()
    if any_hit:
        mism = int((got != ref.mask).sum())
        max_err = float(mism > 0)
    else:
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
    # the triangle test and the visit order are shared, so the limit is 0
    # lanes in practice; MAX_MISMATCH_SHARE is the stated bound
    if mism > MAX_MISMATCH_SHARE * max(n, 1):
        fail(
            f"{label}: {mism} of {n} lanes disagree on found/tri/inst "
            f"(allowed share {MAX_MISMATCH_SHARE})"
        )
    rec = {
        "check": label, "kernel": kern.fam, "any_hit": any_hit, "n_rays": n,
        "n_active": int(active.sum()), "mismatched_lanes": mism,
        "max_abs_err": max_err, "plain_ms": plain_ms,
    }
    return rec, got


def cross_check(got, base, any_hit: bool, n: int, label: str) -> dict:
    """One kernel's result against K1's on the same rays. Every kernel calls
    the same triangle test, so a triangle's t, u, v are the same bits in all
    of them. Which triangle survives can still differ on a near-tie: a box's
    slab entry distance may round above a hit distance inside it, and which
    box is then culled depends on the visit order (coplanar overlapping
    geometry, e.g. cornell's light in the ceiling plane). Such lanes are
    counted as ties; their t must agree within T_RTOL / T_ATOL."""
    if any_hit:
        off = int((got != base).sum())
        ties = 0
    else:
        off = int((got.mask != base.mask).sum())
        both = got.mask & base.mask
        err = (got.t - base.t).abs()[both]
        tol = (T_ATOL + T_RTOL * base.t.abs())[both]
        if bool((err > tol).any()):
            fail(f"{label}: t differs from K1's by {float(err.max()):.3e}")
        ties = int((both & ((got.tri != base.tri) | (got.inst != base.inst))).sum())
        same = both & (got.tri == base.tri) & (got.inst == base.inst)
        for f in ("t", "u", "v"):
            if not torch.equal(getattr(got, f)[same], getattr(base, f)[same]):
                fail(f"{label}: {f} of the same triangle differs from K1's")
    if off > MAX_MISMATCH_SHARE * max(n, 1):
        fail(f"{label}: found differs from K1's on {off} of {n} lanes")
    return {"check": label, "found_differs": off, "tie_lanes": ties}


def bound_ms(kern: Bound, rays, any_hit: bool, stats: dict):
    """Least time the card could take for this call: the larger of the bytes
    it cannot do without over the memory rate and its float operations over
    the fp32 rate, both counted by the plain version on THIS data as one
    thread per ray works (an any-hit ray stops at its first hit).

    Bytes: the ``active`` flag of every lane, origin, direction and ``maxt``
    of the active lanes only, every output once, and each DISTINCT node
    record, triangle and instance that some ray read, once (not the whole
    scene: the rays of a frame reach a part of it). Operations: slab tests
    of non-empty children, triangle tests, instance transforms."""
    o, d, maxt, active = rays
    n = int(o.shape[0])
    spec = FAMILIES[kern.fam]
    ray_bytes = n + int(active.sum()) * (12 + 12 + 4)
    out_bytes = n * (1 if any_hit else 3 * 4 + 2 * 4 + 1)
    scene_bytes = (
        stats["nodes_touched"] * spec["node_bytes"]
        + stats["tris_touched"] * TRI_BYTES
        + stats["inst_touched"] * (XFORM_BYTES + spec["inst_bytes"])
    )
    nbytes = ray_bytes + out_bytes + scene_bytes
    flops = (
        stats["slabs"] * SLAB_FLOPS
        + stats["tris"] * TRI_FLOPS
        + stats["inst"] * XFORM_FLOPS
    )
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_flops = flops / PEAK_FP32_FLOPS * 1e3
    return max(t_bytes, t_flops), ("bytes" if t_bytes >= t_flops else "operations"), {
        "bytes": nbytes, "ray_bytes": ray_bytes, "out_bytes": out_bytes,
        "scene_bytes": scene_bytes, "nodes_touched": stats["nodes_touched"],
        "tris_touched": stats["tris_touched"], "flops": flops,
        "bytes_ms": t_bytes, "flops_ms": t_flops,
        "visits_per_ray": stats["inner"] / max(n, 1),
        "slab_tests_per_ray": stats["slabs"] / max(n, 1),
        "tri_tests_per_ray": stats["tris"] / max(n, 1),
    }


class SceneRays:
    """A scene on the card with the real rays of one of its frames."""

    def __init__(self, name: str, scene, frame: int):
        from polaris_tpu_torch.render.integrator import TorchRenderer

        self.name = name
        self.frame = frame
        self.renderer = TorchRenderer(scene, mode="kernel")
        self.S = self.renderer.S
        self.rays = frame_rays(self.renderer, frame, frame)
        self._bound = {}
        self._k1 = {}

    def bound(self, fam: str) -> Bound:
        if fam not in self._bound:
            self._bound[fam] = Bound(fam, self.S)
        return self._bound[fam]

    def k1(self, key: str, any_hit: bool):
        """K1's result on one ray set (the base of the cross checks)."""
        if (key, any_hit) not in self._k1:
            self._k1[key, any_hit] = self.bound("K1").run(self.rays[key], any_hit)
        return self._k1[key, any_hit]


SETS = (("primary", False), ("bounce1", False), ("shadow", True))


def phase_kernels(ctx):
    """``ctx``: name -> SceneRays. Returns the ten entries of the kernels line."""
    checks, crosses, entries = [], [], {}

    def check_sets(fam, scene_name):
        sr = ctx[scene_name]
        kern = sr.bound(fam)
        out = {}
        for key, any_hit in SETS:
            stats = {}
            label = f"{fam}/{scene_name}{sr.frame}/{key}"
            rec, got = compare(kern, sr.rays[key], any_hit, label, stats)
            rec["ms"] = time_ms(lambda: kern.run(sr.rays[key], any_hit), reps=20)
            rec["call_ms"] = call_ms(lambda: kern.run(sr.rays[key], any_hit), reps=20)
            checks.append(rec)
            if fam != "K1":
                crosses.append(
                    cross_check(got, sr.k1(key, any_hit), any_hit, rec["n_rays"], label)
                )
            out[key] = (rec, stats)
        return out

    def check_edges(fam, scene_name):
        """All lanes inactive, and a ray count that is no multiple of the
        block size, through both entry points."""
        sr = ctx[scene_name]
        kern = sr.bound(fam)
        o, d, maxt, alive = sr.rays["primary"]
        dead = torch.zeros_like(alive)
        for any_hit in (False, True):
            rec, _ = compare(
                kern, (o, d, maxt, dead), any_hit, f"{fam}/{scene_name}{sr.frame}/all-inactive"
            )
            checks.append(rec)
        got = kern.closest((o, d, maxt, dead))
        if bool(got.mask.any()) or bool((got.t != 0).any()):
            fail(f"{fam}: all-inactive batch: a lane reports a hit")
        m = min(RAGGED, int(o.shape[0]) - 29)
        for key, any_hit in (("primary", False), ("shadow", True)):
            ragged = tuple(x[:m].contiguous() for x in sr.rays[key])
            rec, _ = compare(kern, ragged, any_hit, f"{fam}/{scene_name}{sr.frame}/ragged-{m}-{key}")
            checks.append(rec)

    def entry(fam, scene_name, results):
        """The two entry points' lines, timed on the rays of the path that
        launches them: closest hit on primary rays, any hit on shadow rays."""
        sr = ctx[scene_name]
        kern = sr.bound(fam)
        spec = FAMILIES[fam]
        for name, key, any_hit in (("closest_hit", "primary", False), ("any_hit", "shadow", True)):
            rec, stats = results[key]
            b_ms, b_by, detail = bound_ms(kern, sr.rays[key], any_hit, stats)
            entries[spec["prefix"] + name] = {
                "name": spec["prefix"] + name, "kernel": fam, "route": "cuda",
                "source": f"polaris_tpu_torch/csrc/{kern.module.SOURCE}",
                "replaces": spec["replaces"], "launches": 0,
                "n_rays": rec["n_rays"],
                "rays": f"{scene_name} {sr.frame}x{sr.frame} {key}",
                "max_abs_err": rec["max_abs_err"],
                "mismatched_lanes": rec["mismatched_lanes"],
                "ms": rec["ms"], "call_ms": rec["call_ms"],
                "plain_ms": rec["plain_ms"], "bound_ms": b_ms,
                "bound_by": b_by, "library_ms": None, "bound_detail": detail,
            }
        entries[spec["prefix"] + "closest_hit"]["ms_bounce1"] = results["bounce1"][0]["ms"]

    # K1: the flagship frame, the instanced scene (TLAS leaves, transforms,
    # restore on exit), and terrain320k, for which the JAX package leaves the
    # triangles in device memory ('pallas_stream'): here that is this kernel
    entry("K1", "sphere", check_sets("K1", "sphere"))
    check_sets("K1", "instanced")
    check_edges("K1", "sphere")
    check_sets("K1", "terrain320k")
    # K2 and K3, the big-scene kernels: instances inside wide nodes, then the
    # 819k-triangle terrain at the big-scene frame's own shapes
    for fam in ("K2", "K3"):
        check_sets(fam, "instanced")
        check_edges(fam, "instanced")
        entry(fam, "terrain819k", check_sets(fam, "terrain819k"))
    # K4 and K5 at the shapes of the cornell frames that launch them
    check_sets("K4", "sphere")
    check_sets("K4", "instanced")
    entry("K4", "cornell", check_sets("K4", "cornell"))
    check_edges("K4", "cornell")
    entry("K5", "cornell", check_sets("K5", "cornell"))
    check_edges("K5", "cornell")

    for e in entries.values():
        own = [
            c for c in checks
            if c["kernel"] == e["kernel"] and c["any_hit"] == e["name"].endswith("any_hit")
        ]
        e["max_abs_err"] = max(c["max_abs_err"] for c in own)
        e["mismatched_lanes"] = sum(c["mismatched_lanes"] for c in own)
    emit(
        "kernels", checks=checks, against_k1=crosses,
        limits={"t_rtol": T_RTOL, "t_atol": T_ATOL, "max_mismatch_share": MAX_MISMATCH_SHARE},
    )
    return entries


def phase_grid(ctx):
    """Kernel ms of every mode on primary and bounce-1 rays of six scenes,
    1.3k to 819k triangles: three timings of ten launches per cell, least and
    most. Also checks which kernel mode 'auto' picks for each scene."""
    from polaris_tpu_torch.ops import intersect_cuda
    from polaris_tpu_torch.ops.intersect import AUTO_WIDE_MIN_TRIS, make_intersectors

    cells = []
    auto = {}
    for scene_name in GRID_SCENES:
        sr = ctx[scene_name]
        # what 'auto' picks for this scene: K2's closures carry their packed
        # scene, K1's wrapper is the module's own function
        closest, _ = make_intersectors(sr.S, "auto")
        auto[scene_name] = "K2" if "p8n_nodes" in getattr(closest, "packed", ()) else "K1"
        want = "K2" if sr.S["tri_v0"].shape[0] >= AUTO_WIDE_MIN_TRIS else "K1"
        if auto[scene_name] != want or (want == "K1" and closest is not intersect_cuda.closest_hit):
            fail(f"grid: mode 'auto' picked {auto[scene_name]} for {scene_name}, expected {want}")
        for fam in FAMILIES:
            if fam == "K5" and sr.S["tri_v0"].shape[0] > module_of("K5").DENSE_MAX_TRIS:
                continue
            kern = sr.bound(fam)
            for key in ("primary", "bounce1"):
                rays = sr.rays[key]
                times = [time_ms(lambda: kern.closest(rays), reps=10) for _ in range(3)]
                cells.append({
                    "scene": scene_name, "frame": sr.frame, "kernel": fam,
                    "mode": FAMILIES[fam]["mode"], "rays": key,
                    "ms_min": min(times), "ms_max": max(times),
                })
    emit("grid", cells=cells, auto=auto)


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


def timed_frames(renderer, opt, module, reps: int):
    """One warm-up, then ``reps`` frames with the module's launch counts set
    to 0 just before each and read just after. Returns (best seconds, all
    seconds, last image, launch counts of the last frame)."""
    renderer.render_u8(opt)
    times, img, launches = [], None, {}
    for _ in range(reps):
        module.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        img = renderer.render_u8(opt)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        launches = dict(module.LAUNCHES)
    return min(times), times, img, launches


def phase_bigscene(terrain, cornell, smi: str):
    """The big-scene path at full width: the 819k-triangle terrain through the
    8-wide record kernel and the binary record kernel, then the two modes
    that hang off the same switch on cornell."""
    from polaris_tpu_torch.render.integrator import TorchRenderer
    from polaris_tpu_torch.render.options import RenderOptions

    opt = RenderOptions(
        width=FRAME, height=FRAME, spp=BIG_SPP, num_bounces=BIG_BOUNCES,
        min_bounces_for_rr=BIG_RR_AFTER,
    )
    rays = opt.width * opt.height * opt.spp * opt.num_bounces * 2
    launches, frames, images = {}, {}, {}
    for fam in ("K2", "K3"):
        module = module_of(fam)
        renderer = TorchRenderer(terrain, mode=FAMILIES[fam]["mode"])
        renderer.spp_per_launch = 1  # as bench_big.py: keep launches short
        best, times, img, counts = timed_frames(renderer, opt, module, reps=2)
        if img.shape != (FRAME, FRAME, 3) or img.dtype != np.uint8:
            fail(f"bigscene/{fam}: unexpected image {img.shape} {img.dtype}")
        if not img.mean() > 1.0:
            fail(f"bigscene/{fam}: black image (mean {img.mean():.3f})")
        for name, count in counts.items():
            if count != opt.spp * opt.num_bounces:
                fail(
                    f"bigscene/{fam}: {name} launched {count} times in one frame, "
                    f"expected {opt.spp * opt.num_bounces}"
                )
        launches[fam] = counts
        images[fam] = img
        frames[fam] = {
            "mode": FAMILIES[fam]["mode"], "frame_ms": best * 1e3,
            "frame_ms_all": [t * 1e3 for t in times],
            "mrays_per_s": rays / best / 1e6, "launches": counts,
            "image_mean": float(img.mean()),
        }
        del renderer
    differing = int((images["K2"] != images["K3"]).any(axis=-1).sum())
    if differing:
        fail(f"bigscene: the K2 and K3 u8 images differ in {differing} pixels")

    # the other two modes of the switch, on cornell: 'hybrid' sends primary
    # rays to K1 and bounce and shadow rays to K5; 'pallas8' is K4
    small = RenderOptions(
        width=SMALL_FRAME, height=SMALL_FRAME, spp=4, num_bounces=BIG_BOUNCES,
        min_bounces_for_rr=BIG_RR_AFTER,
    )
    base = TorchRenderer(cornell, mode="kernel").render_u8(small).astype(np.int16)
    cornell_checks = {}
    for mode, fam in (("hybrid", "K5"), ("pallas8", "K4")):
        module = module_of(fam)
        renderer = TorchRenderer(cornell, mode=mode)
        best, times, img, counts = timed_frames(renderer, small, module, reps=1)
        for name, count in counts.items():
            if count <= 0:
                fail(f"bigscene/{mode}: {fam} {name} was never launched")
        diff = np.abs(img.astype(np.int16) - base)
        if int(diff.max()) > 1:
            fail(f"bigscene/{mode}: image differs from mode 'kernel' by {int(diff.max())} levels")
        launches[fam] = counts
        cornell_checks[mode] = {
            "kernel": fam, "frame_ms": best * 1e3, "launches": counts,
            "max_level_diff": int(diff.max()),
            "pixels_differing": int((diff > 0).any(axis=-1).sum()),
        }
    emit(
        "bigscene", card=smi, scene=f"terrain grid {BIG_GRID}",
        frame=f"{FRAME}x{FRAME}x{BIG_SPP}spp, {BIG_BOUNCES} bounces",
        frames=frames, k2_k3_pixels_differing=differing,
        cornell=f"{SMALL_FRAME}x{SMALL_FRAME}x4spp", cornell_checks=cornell_checks,
    )
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    # before anything is printed: without the package beside this script the
    # run ends here, non-zero, with an empty standard output
    from polaris_tpu_torch import native
    from polaris_tpu_torch.asset.compiler.compiler import compile_scene
    from polaris_tpu_torch.asset.procedural import make_terrain_scene
    from polaris_tpu_torch.ops import _build, _launch

    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = nvidia_smi_line()
    emit(
        "device", card=smi, torch=torch.__version__, cuda=torch.version.cuda,
        kind=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
    )

    sources = [module_of(fam).SOURCE for fam in FAMILIES]
    t0 = time.perf_counter()
    seconds = _build.build_libraries(sources, _launch.EXTRA_FLAGS)
    for fam in FAMILIES:
        module_of(fam).load()
    emit("build", seconds=time.perf_counter() - t0, seconds_each=seconds,
         flags=list(_launch.EXTRA_FLAGS))

    if native.get_lib() is None:
        fail("the native BVH library did not load (g++ missing?): the big "
             "scenes would take minutes to compile")
    compile_s, scenes = {}, {}
    for name, make in (
        ("sphere", lambda: load_scene("sphere")),
        ("instanced", lambda: load_scene("instanced")),
        ("cornell", lambda: load_scene("cornell")),
        ("terrain20k", lambda: compile_scene(make_terrain_scene(grid=100))),
        ("terrain80k", lambda: compile_scene(make_terrain_scene(grid=200))),
        ("terrain320k", lambda: compile_scene(make_terrain_scene(grid=STREAM_GRID))),
        ("terrain819k", lambda: compile_scene(make_terrain_scene(grid=BIG_GRID))),
    ):
        t0 = time.perf_counter()
        scenes[name] = make()
        compile_s[name] = time.perf_counter() - t0

    with torch.no_grad():
        ctx = {
            name: SceneRays(
                name, scenes[name],
                SMALL_FRAME if name in ("instanced", "cornell") else FRAME,
            )
            for name in scenes
        }
        big = ctx["terrain819k"]
        emit(
            "scenes", compile_seconds=compile_s,
            triangles={n: int(s.tri_v0.shape[0]) for n, s in scenes.items()},
            nodes={n: int(s.bvh_ldata.shape[0]) for n, s in scenes.items()},
            pack_seconds_terrain819k={
                fam: big.bound(fam).pack_seconds for fam in ("K2", "K3", "K4")
            },
            stack_need_terrain819k={
                fam: int(big.bound(fam).P["stack_need"]) for fam in ("K2", "K4")
            },
        )
        entries = phase_kernels(ctx)
        phase_grid(ctx)
        del ctx, big
        torch.cuda.empty_cache()
        phase_golden(scenes["sphere"])
        launches = {"K1": phase_flagship(scenes["sphere"], smi)}
        launches.update(phase_bigscene(scenes["terrain819k"], scenes["cornell"], smi))
    for e in entries.values():
        e["launches"] = launches[e["kernel"]][
            "any_hit" if e["name"].endswith("any_hit") else "closest_hit"
        ]
        if e["launches"] <= 0:
            fail(f"kernel entry point {e['name']} was never launched by a render path")
    emit("total", seconds=time.perf_counter() - t_start)

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
