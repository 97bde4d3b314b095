"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds every CUDA traversal kernel from ``polaris_tpu_torch/csrc`` with nvcc
(one process per source, all started together), then runs these phases, each
printing one JSON line:

  device    card name and power limit (nvidia-smi), torch / CUDA versions
  build     seconds to build each kernel library
  scenes    seconds to compile each scene on the host (sphere, instanced,
            cornell, mitsuba, dispersive, and the procedural terrains of 320k
            and 819k triangles) and to pack the big one for each kernel; fails
            if the native BVH library did not load
  kernels   every kernel entry point, closest hit and any hit, against its
            plain PyTorch version on real rays (primary, bounce-1 and NEE
            shadow rays of a frame in blocked order): K1 with both of its
            triangle tests (det^2-scaled Moller-Trumbore, and Havel-Herout as
            'K1hh') on the frame of each of the five benchmark configurations
            at its full size (sphere, mitsuba, cornell, instanced 512x512,
            dispersive 1024x1024), on instanced 256x256 and on terrain320k
            (the scene the JAX package streams triangles for:
            'pallas_stream'); K2 and K3 on instanced and terrain819k; K4 and
            K5 on sphere, instanced and cornell; for each an all-inactive
            batch and a ray count that is no multiple of the block size.
            Every kernel also on 1, 31 and 33 rays and on a frame with one
            active lane (the edges of the window fetch and compaction; K3
            there also bit for bit against K1), every set launched twice
            with equal outputs, and in each of its staging branches (K1: the
            scene in shared memory, the five benchmark scenes, or in global
            memory, terrain320k; K2, K3: in shared memory, instanced, or in
            global memory, terrain819k; K4, K5, on the block-local schedule:
            in shared memory, instanced and cornell, or in global memory,
            sphere by the byte rule and cornell with the branch forced); K4
            and K5 also on a frame whose first windows hold no active lane
            and through CUDA graph replays, each replay's outputs against
            the plain version.
            Each check names its branch; the bound on every ray set, the SIMT
            ceilings where the plain version counts work per lane (K1, K2,
            K3, K4). Every entry point's line also times a
            launch with every lane inactive (``empty_ms``). Each kernel's hits
            are also held against K1's on the same rays, as far as the two
            share an arithmetic (``cross_check``). Times each on the
            device (launches replayed from a CUDA graph, ``ms``) and as the
            caller sees it (``call_ms``), and works out the least time the
            card could take from the records and operations that the plain
            version counts these rays to need
  grid      kernel ms of every mode on primary and bounce-1 rays of sphere,
            instanced and four terrains of 20k to 819k triangles (the table
            behind the 'auto' rule), each cell timed three times, and that
            'auto' picks K1 for each scene
  golden    sphere and mitsuba 32x32, 2 spp, 2 bounces through the kernel,
            with each of its triangle tests, against the accumulators the JAX
            package rendered (tests/fixtures)
  flagship  sphere 128x128, 4 spp, 5 bounces, RR after 3, path regeneration
            through K1 (the renderer's CUDA graphs) and through K1's plain
            version (the eager loop functions: the plain traversal cannot be
            captured): no pixel of the two u8 images more than one level
            apart. The flagship frame at full size is the first row of
            ``configs``
  bigscene  terrain819k 512x512, 4 spp, 3 bounces, RR after 4,
            ``spp_per_launch=1``, through K2 (mode 'pallas8_nodes') and K3
            ('pallas_nodes'); then 'hybrid' (K1 + K5) and 'pallas8' (K4) on
            cornell 256x256, 4 spp, against mode 'kernel': no pixel more
            than one u8 level apart; the K2 and K3 u8 images equal. Every
            frame as in ``configs``: graphs against the eager loops
  configs   the five benchmark configurations of the JAX package's
            bench_configs.py at their full sizes (sphere, mitsuba, instanced
            512x512 16 spp; cornell 512x512 64 spp; dispersive 1024x1024
            256 spp; 5 bounces, RR after 3, mode 'auto', path regeneration,
            ``spp_per_launch=16``), each through ``TorchRenderer`` (one step
            of the loop replayed from a CUDA graph; ``render_accum`` once,
            which captures the graphs, then ``render_u8`` best of 2, of 3
            for sphere, of 1 from 128 spp on) and through the eager loop
            functions (best of 1, of 2 for sphere), in this process: the f32
            accumulators and the u8 images equal bit for bit, the same
            trips; frame ms both ways, Mrays/s, trips and overshoot trips
            (run after the last lane died, before the stop test was read),
            host syncs a frame, capture seconds, peak memory, launch counts
            (closest-hit launches = trips run). Then sphere and mitsuba once
            more through the Havel-Herout test, with the u8 level difference
            to the default
  shade     the shading kernel (ops/shade_cuda.py) against its plain
            version: every result of the first 3 bounces of 256x256 frames
            of the five scenes and ``coverage_scene`` (every material
            operator, BxDF, light kind and texture storage), and of
            1024x1024 frames of sphere and terrain819k (the frame cells'
            lanes), with Python-int and per-lane counters, bit for bit;
            whole frames of sphere, mitsuba and dispersive through both in
            the sequential, regen, compact and batch_samples loops (equal
            accumulators); a regen frame's graphs against the eager loops;
            80 + 80 launches a 1024x1024x16 frame and none in a loss step;
            ms against the byte bound and the plain version's at 1024x1024
            on sphere, terrain819k and mitsuba, the timed results bit for
            bit too; registers and spills (``-Xptxas -v``)
  adaptive  cornell 512x512, a cap of 64 spp, chunks of 16, tol 0.08,
            through the sequential loop's graphs: frame ms, mean spp, the
            share of blocks stopped, MSE of the tonemapped image against a
            256-spp uniform render; each stopped block bit-equal to
            ``render_accum_offset`` at its count, ``tol=0`` bit-equal to it
            at 64 spp
  grad      the differentiable path (the JAX package's bench_grad.py): sphere
            512x512, 8 spp, 5 bounces, RR after 3, zero target, through K1;
            ``loss_only`` and ``loss_and_grad`` (each replayed from one CUDA
            graph) best of 3, the backward/forward ratio, Mrays/s, capture
            seconds, peak memory, K1's launches a step (40 closest, 40 any);
            the captured step against the eager step (loss bit-equal, each
            gradient field within 1e-5 of its largest |gradient|); K1
            against its plain version under the gradient (128x128, 2 spp,
            eager: the same); the step against the JAX-made fixture
            tests/fixtures/torch_golden_grad_cornell_24.npz (loss rtol 1e-4,
            each field within 1e-3); ``render_from_params`` through the
            graphs bit-equal to the eager loop, the scene's storage kept;
            5 Adam steps of ``Trainer`` (the loss falls; a checkpoint
            restores into a fresh trainer); the 128-spp headline frame
  table_grad the parameter tables' gradient kernel (ops/table_grad_cuda.py)
            against its plain version bit for bit, and two launches
            bit-equal, on tables of 1 to 1,024 rows and 1 to 300,000 lanes,
            with its gap to ``index_add_``; ms a call against
            ``index_add_`` and the byte bound at 262,144 lanes on sphere's
            table shapes; registers and spills (``-Xptxas -v``); then
            phase grad's loss step: the kernel's calls a step and no
            fallback, whether two steps at one seed give every leaf's
            gradient bit for bit, and the kernels that still scatter
  denoise   cornell 512x512, 16 spp, 4 levels: the replayed guide pass and
            filter (one graph each) against the guides through K1's plain
            version and the filter run op by op, bit for bit, at two cameras
            with two accumulators; guide-pass and filter ms; the MSE of the
            tonemapped image against a 256-spp render before and after the
            filter (it must drop)
  viewer    sphere 512x512, passes of 16 spp, path regeneration, through K1:
            ``ProgressiveRenderer.run`` with its server and snapshots, after
            each of 4 passes equal to the sum of ``render_accum_offset``
            partials bit for bit, and near one 64-spp partial; a second
            ``run`` whose server answers (``/frame.png`` decodes to the last
            image, ``/stats``, ``/``) and takes a ``/move``, whose next pass
            equals a fresh render at the new camera bit for bit; the eight
            debug channels through K1 against K1's plain version at 128x128
            bit for bit, each timed at 512x512; ``default_pipeline`` equal to
            ``render``, a denoise -> tonemap -> PNG chain; ``profiling.trace``
            names K1's entry points; pass ms and PNG encode ms
  parallel  sphere 512x512x16spp, the sequential loop, through K1 on the one
            card (times are each code path's cost, not scaling): four
            128-row bands equal to ``render_accum`` bit for bit; a pool of
            two workers on the card (a renderer and a stream each), 4 frames
            each equal to the single renderer's, K1's launches = the trips
            the workers' graphs report, the heights feedback settles on;
            meshes 4x1 (bit for bit) and 2x2; the 2x2 mesh's train step at
            128x128x4spp against ``DifferentiableRenderer``'s loss and SGD
            step; ``spawn_local_processes``: two ``gloo`` ranks on the card
            (render 2x1 bit for bit, the train step 2x1 and 1x2 against the
            one-process mesh's), one ``nccl`` rank; frame ms of each
  modes     the integrator's opt-in modes on sphere and cornell 512x512, 16
            spp, 5 bounces, RR after 3, mode 'auto' (K1):
            ``TorchRenderer(compact=True)``, ``(sort_rays=True)`` and
            ``(batch_samples=True)``, each f32 accumulator and u8 image bit
            for bit the default sequential loop's; frame ms (best of 3 after
            the capture, the four renderers of a scene in turns), K1's
            launches a frame and peak memory (the first
            frame, which captures) of each beside the default's; K1 alone
            on the frame's primary, bounce-1 and shadow rays in lane order,
            grouped by octant as ``sort_rays`` groups them and with the
            live rays first as ``compact`` packs them (ms a launch, graph
            replays). Then the traversal modes: 'brute' on
            cornell's 256x256 primary and shadow rays replayed from a CUDA
            graph against K5's hits, and 'packet' on cornell's primary rays
            against K1's: the same mask, triangle and instance, t within
            T_RTOL / T_ATOL
  cli       the command line: the flagship frame (sphere 512x512, 16 spp,
            5 bounces, RR after 3, --regen) through ``python -m
            polaris_tpu_torch.cli render frame`` in a subprocess, its PNG
            equal bit for bit to ``TorchRenderer(regen=True).render``
            quantized as the CLI quantizes, with the stats table's total ms
            and the subprocess's wall seconds; then in this process through
            ``cli.main``: ``render progressive`` (two passes, a snapshot),
            ``scene compile`` / ``scene info``, ``devices`` (the card named),
            and cornell 256x256, 4 spp frames with ``--mode pallas8_nodes``
            and ``--mode brute``, each equal to ``TorchRenderer`` of the same
            mode bit for bit
  readback  the traversals that read their loop test back to the host, whose
            steps a renderer runs uncaptured: sphere 512x512, 1 spp, 5
            bounces, RR after 3, through 'bvh' and 'packet', each frame
            against K1's of the same options (atol 1e-4, rtol 1e-3, at most
            0.5% of pixels outside, as ``golden`` counts them), no step
            captured, no kernel launched, frame ms; a loss-and-gradient step
            of ``DifferentiableRenderer(mode="bvh")`` on cornell 64x64, 2 spp
            (finite gradients, the loss within 1e-3 of K1's step); a pool of
            two 'bvh' workers on the card equal to one 'bvh' renderer; the
            command line's ``render frame scenes/cornell.obj --width 64
            --height 64 --mode bvh`` in a subprocess on the default device
            and ``--mode packet`` through ``cli.main``, each PNG equal to the
            in-process render
  oracle    the NumPy oracle ``CpuRenderer`` on the host against the card's
            K1 frame (mode 'auto') of cornell and sphere at 64x64, 2 spp, 3
            bounces, with the tolerance of ``readback``; the oracle's host
            seconds

The last three lines of the output are: the card's name and power limit as
nvidia-smi prints them, one JSON object ``{"kernels": [...]}`` with the twelve
traversal entry points and the shading kernel's two, and ``{"ok": true,
"device": {...}}``. Any failure ends the run with a non-zero exit code and no
result line; without a CUDA device nothing runs.
"""

from __future__ import annotations

import json
import os
import re
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
XFORM_BYTES = 48  # a 3x4 matrix
# float operations per unit of traversal work, counted from csrc/traverse_common.cuh
SLAB_FLOPS = 25  # 6 sub, 6 mul, 10 min/max, 3 compares
# per triangle test of a closest-hit query, by leaf form:
#   quot  2 cross (18), 4 dot (20), 3 sub, 3 mul by 1/det, 1 div, 1 add, 7 compares
#   det2  2 cross (18), 4 dot (20), 3 sub, 3 mul by det, det*det, EPS*det^2,
#         1 add, 2 mul of the cross-multiplied compare, 7 compares
#   hh    det and t_raw (11), det*det, scaled hit point (9), two plane
#         equations times det (16), 1 add, t_raw*det, EPS*det^2, 2 mul of the
#         cross-multiplied compare, 6 compares
# an any-hit query of a scaled form needs one multiply less (maxt*det^2 only).
# The one divide and three multiplies that close a leaf of a scaled form are
# left out: the plain versions do not count leaf visits, and a bound that
# leaves work out is still a bound
TRI_FLOPS = {"quot": 53, "det2": 56, "hh": 48}
XFORM_FLOPS = 36  # 3x4 matrix on o and d, 3 reciprocals

# the flagship frame (the JAX package's bench.py workload: the first of
# CONFIGS) and the check sizes
FRAME = 512
BOUNCES = 5
RR_AFTER = 3
SMALL_FRAME = 256  # instanced and cornell
RAGGED = 100_003  # a ray count that is no multiple of the block size
# the big-scene frame (the JAX package's bench_big.py workload)
BIG_GRID, BIG_SPP, BIG_BOUNCES, BIG_RR_AFTER = 640, 4, 3, 4
STREAM_GRID = 400  # terrain320k: the scene the JAX package streams triangles for
# adaptive sampling on cornell: a cap, a chunk and a tolerance of the JAX
# package's scripts/bench_adaptive.py; its 1024-spp reference cut to 256
ADAPT_SPP, ADAPT_CHUNK, ADAPT_TOL, ADAPT_REF_SPP = 64, 16, 0.08, 256
# the differentiable path: the JAX package's bench_grad.py (sphere 512x512,
# 8 spp, 5 bounces, RR after 3; its third row 128 spp in launches of 32);
# K1 against its plain version under the gradient on a 128x128 2-spp frame
GRAD_SPP, GRAD_CHECK, GRAD_CHECK_SPP = 8, 128, 2
HEADLINE_SPP, HEADLINE_CHUNK = 128, 32
GRAD_TOL = 1e-5  # of each field's largest |gradient|: graph or plain vs eager K1
FIXTURE_LOSS_RTOL, FIXTURE_FIELD_TOL = 1e-4, 1e-3  # against the JAX-made fixture
TRAIN_STEPS, TRAIN_LR, TRAIN_FACTOR = 5, 3e-2, 0.55
# the denoiser on cornell 512x512: 16 spp, 4 levels, a 256-spp reference
DENOISE_SPP, DENOISE_ITERS, DENOISE_REF_SPP = 16, 4, 256
DENOISE_YAW = 0.05  # radians: the second camera of the denoiser's replay check
# the viewer and the parallel layer at the flagship's full width: passes of
# 16 spp (4 of them, then a 64-spp partial), the debug channels held against
# K1's plain version at 128x128; the 64-spp check adds rtol 1e-6 to atol 1e-4:
# sphere's accumulator reaches about 260 on the light, where one float32 ulp
# is 3.05e-5, and a 64-term sum in another association moves it by a few
VIEW_SPP, VIEW_PASSES, DEBUG_CHECK = 16, 4, 128
PROG_ATOL, PROG_RTOL = 1e-4, 1e-6
POOL_FRAMES, POOL_QUANTUM = 4, 32
MESH_RTOL = 1e-5  # a split of the samples: like tests/test_sharding.py
# the distributed train step: 128x128, 4 spp, zero target, SGD at MESH_LR
TRAIN_FRAME, TRAIN_SPP, MESH_LR = 128, 4, 0.1
# the integrator's opt-in modes (phase modes), at the flagship's full width
MODES_SPP = 16
OPT_MODES = ("compact", "sort_rays", "batch_samples")
HTTP_TIMEOUT, SPAWN_TIMEOUT = 30, 300
SMOKE_DIR = os.path.join(HERE, "build", "smoke")  # files the phases write
# the scenes of the mode-by-scene grid; the two mid-size terrains (grids 100
# and 200) are there to show whether 'auto' should leave K1 at some size
GRID_SCENES = (
    "sphere", "instanced", "terrain20k", "terrain80k", "terrain320k", "terrain819k",
)

T_RTOL, T_ATOL = 1e-5, 1e-6  # t, u, v on lanes where both versions hit
MAX_MISMATCH_SHARE = 1e-4  # lanes whose found/tri/inst may differ (ties)
# t of the Havel-Herout test against Moller-Trumbore's on the same triangle:
# its numerator is a plane offset, d0 - o.N, which cancels for an origin that
# lies far from the world's origin compared with t (a bounce ray leaving a
# surface), so the error does not shrink with t: the bound is
# HH_T_TOL * (1 + |t|). Read on an H100 over the five benchmark frames: at
# most 8.2e-5 (dispersive 1024x1024, bounce rays)
HH_T_TOL = 3e-4
# the five benchmark configurations: scene, width, height, spp (5 bounces, RR
# after 3 each)
CONFIGS = (
    ("sphere", 512, 512, 16),
    ("cornell", 512, 512, 64),
    ("mitsuba", 512, 512, 16),
    ("instanced", 512, 512, 16),
    ("dispersive", 1024, 1024, 256),
)
# the two triangle tests of K1 accept other lanes on a triangle's very edge,
# and a path that parts there changes its pixel outright: pixels of an `hh`
# frame more than one u8 level from the default test's, at most this share
MAX_HH_LEVEL_SHARE = 1e-4

# every kernel: its wrapper module (which names its source), the traversal
# mode that selects it, the TPU kernel it replaces, the names of its two
# entries in the ``kernels`` line (closest hit, any hit), which are also its
# keys in the module's LAUNCHES, its plain version, its leaf form, and the
# bytes of one node record as the kernel reads it (K1 and K3: a 64-byte
# record of two data words and two child boxes; K2 and K4: their own
# 224-byte records of 8 boxes and 8 ready entries), of one triangle (a
# [v0, e1, e2] row; K1, K2 and K3 keep it as three 16-byte words, and K1's
# Havel-Herout row [N d0 N1 d1 N2 d2] is 48 bytes too) and of what it reads
# once per instance besides the 3x4 matrix (K1, K2, K3: the rest of a
# 64-byte row). K4 and K5 count what the function needs, 36 bytes a
# triangle and K4's entry or K5's first triangle and count an instance, not
# the padding of their own rows. K1hh is K1 with its Havel-Herout triangle test: the same
# kernel body and library, two entry points of its own. K1 and K1hh read
# entry functions of the same names as their LAUNCHES keys
FAMILIES = {
    "K1": dict(
        module="intersect_cuda", mode="kernel",
        replaces="polaris_tpu/ops/intersect_pallas.py:93",
        names=("closest_hit", "any_hit"), keys=("closest_hit", "any_hit"),
        plain="k1_plain", leaf="det2", node_bytes=64, tri_bytes=48, inst_bytes=16,
    ),
    "K1hh": dict(
        module="intersect_cuda", mode="kernel",
        replaces="polaris_tpu/ops/intersect_pallas.py:271",
        names=("closest_hit_hh", "any_hit_hh"),
        keys=("closest_hit_hh", "any_hit_hh"),
        plain="k1_plain", leaf="hh", node_bytes=64, tri_bytes=48, inst_bytes=16,
    ),
    "K2": dict(
        module="intersect_wide8_nodes", mode="pallas8_nodes",
        replaces="polaris_tpu/ops/intersect_pallas8_nodes.py:246",
        names=("wide8_nodes_closest_hit", "wide8_nodes_any_hit"),
        keys=("closest_hit", "any_hit"), plain="wide8_nodes_plain",
        leaf="det2", node_bytes=224, tri_bytes=48, inst_bytes=16,
    ),
    "K3": dict(
        module="intersect_nodes", mode="pallas_nodes",
        replaces="polaris_tpu/ops/intersect_pallas_nodes.py:61",
        names=("nodes_closest_hit", "nodes_any_hit"),
        keys=("closest_hit", "any_hit"), plain="nodes_plain", leaf="det2",
        node_bytes=64, tri_bytes=48, inst_bytes=16,
    ),
    "K4": dict(
        module="intersect_wide8", mode="pallas8",
        replaces="polaris_tpu/ops/intersect_pallas8.py:154",
        names=("wide8_closest_hit", "wide8_any_hit"),
        keys=("closest_hit", "any_hit"), plain="wide8_plain", leaf="quot",
        node_bytes=224, tri_bytes=36, inst_bytes=4,
    ),
    "K5": dict(
        module="intersect_dense", mode="pallas_dense",
        replaces="polaris_tpu/ops/intersect_pallas_dense.py:40",
        names=("dense_closest_hit", "dense_any_hit"),
        keys=("closest_hit", "any_hit"), plain="dense_plain", leaf="det2",
        node_bytes=0, tri_bytes=36, inst_bytes=8,
    ),
}
K1_FAMILIES = ("K1", "K1hh")
# the kernels on the persistent schedule of csrc/traverse_common.cuh, and
# those on the block-local schedule of csrc/traverse_block.cuh
PERSISTENT = K1_FAMILIES + ("K2", "K3")
BLOCK_LOCAL = ("K4", "K5")
# the kernels whose plain versions count work per lane, for the SIMT ceilings
PER_LANE = PERSISTENT + ("K4",)
# rays of a frame that an inactive-window check turns off from its start:
# whole windows of either schedule (32 rays; BLOCK_THREADS)
DEAD_WINDOWS = 2048
# how far a kernel's hits must agree with K1's on the same rays
#   "bits"  every field of every lane equal (K3: the TPU kernels' contract)
#   "same"  t, u, v equal bit for bit wherever both keep the same triangle;
#           near-ties counted, their t within T_RTOL / T_ATOL (K2, K5: K1's
#           arithmetic, another visit order or another place for the divide)
#   "tol"   t within T_RTOL / T_ATOL wherever both keep the same triangle;
#           lanes that differ in found / tri / inst counted, at most
#           MAX_MISMATCH_SHARE (K4: quotient form)
#   "hh"    as "tol" with t within HH_T_TOL * (1 + |t|) (K1hh: another
#           test, which may also accept other lanes on a triangle's edge)
AGAINST_K1 = {"K1hh": "hh", "K2": "same", "K3": "bits", "K4": "tol", "K5": "same"}


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
    from polaris_tpu_torch.render.graph import gc_paused

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with gc_paused(), torch.cuda.graph(graph):
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
    its plain version on the scene as that kernel reads it, packed once by
    ``make_intersectors`` (K1 and K1hh: K1's buffer of 16-byte words, in the
    leaf form of its triangle test). ``staging`` forces a staging branch
    (``"global"``: the buffer read from global memory though it fits in
    shared memory)."""

    def __init__(self, fam: str, S, staging=None):
        from polaris_tpu_torch.ops.intersect import make_intersectors

        spec = FAMILIES[fam]
        self.fam = fam
        self.module = module_of(fam)
        self._closest = getattr(self.module, spec["keys"][0])
        self._any = getattr(self.module, spec["keys"][1])
        t0 = time.perf_counter()
        closest, _ = make_intersectors(
            S, spec["mode"], tri_test="hh" if spec["leaf"] == "hh" else "mt"
        )
        torch.cuda.synchronize()
        self.pack_seconds = time.perf_counter() - t0
        self.P = closest.packed
        if staging is not None:
            self.P = dict(self.P, staging=staging)
        self._plain = getattr(self.module, spec["plain"])
        # the staging branch: the scene in shared or in global memory
        self.staging = self.P.get("staging")

    def closest(self, rays):
        return self._closest(self.P, *rays)

    def any(self, rays):
        return self._any(self.P, *rays)

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
    # kernel and plain version share leaf arithmetic and visit order, so the
    # limit is 0 lanes in practice; MAX_MISMATCH_SHARE is the stated bound
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
    if kern.staging is not None:
        rec["staging"] = kern.staging
    return rec, got


def cross_check(got, base, any_hit: bool, n: int, label: str, how: str) -> dict:
    """One kernel's result against K1's on the same rays, held to ``how``
    (see AGAINST_K1). Kernels that share K1's leaf arithmetic return a
    triangle's t, u, v in the same bits. Which triangle survives can still
    differ on a near-tie: a box's slab entry distance may round above a hit
    distance inside it, and which box is then culled depends on the visit
    order (coplanar overlapping geometry, e.g. cornell's light in the ceiling
    plane); the dense kernel divides once per ray instead of once per leaf, so
    its acceptance compare rounds differently. Such lanes are counted as
    ties; their t must agree within T_RTOL / T_ATOL. Another arithmetic
    (quotient form, Havel-Herout) agrees on t by tolerance only, and may
    accept another lane on a triangle's very edge."""
    if any_hit:
        off = int((got != base).sum())
        ties = 0
        if how == "bits" and off:
            fail(f"{label}: occlusion differs from K1's on {off} lanes")
    else:
        off = int((got.mask != base.mask).sum())
        both = got.mask & base.mask
        same = both & (got.tri == base.tri) & (got.inst == base.inst)
        ties = int((both & ~same).sum())
        check_t = same if how in ("tol", "hh") else both
        rtol, atol = (HH_T_TOL, HH_T_TOL) if how == "hh" else (T_RTOL, T_ATOL)
        err = (got.t - base.t).abs()[check_t]
        tol = (atol + rtol * base.t.abs())[check_t]
        t_err = float(err.max()) if err.numel() else 0.0
        # the same error in the unit of the `hh` bound: over 1 + |t|
        t_scaled = float((err / (1.0 + base.t.abs()[check_t])).max()) if err.numel() else 0.0
        if bool((err > tol).any()):
            fail(f"{label}: t differs from K1's by {float(err.max()):.3e}")
        if how == "bits":
            for f in ("t", "u", "v", "tri", "inst", "mask"):
                if not torch.equal(getattr(got, f), getattr(base, f)):
                    fail(f"{label}: {f} differs from K1's (must be equal bit for bit)")
        elif how == "same":
            for f in ("t", "u", "v"):
                if not torch.equal(getattr(got, f)[same], getattr(base, f)[same]):
                    fail(f"{label}: {f} of the same triangle differs from K1's")
        else:
            off += ties
    if off > MAX_MISMATCH_SHARE * max(n, 1):
        fail(f"{label}: hits differ from K1's on {off} of {n} lanes")
    rec = {"check": label, "how": how, "found_differs": off, "tie_lanes": ties}
    if not any_hit:
        rec["t_max_abs_diff"] = t_err
        rec["t_max_diff_over_one_plus_t"] = t_scaled
    return rec


def bound_ms(kern: Bound, rays, any_hit: bool, stats: dict):
    """Least time the card could take for this call: the larger of the bytes
    it cannot do without over the memory rate and its float operations over
    the fp32 rate, both counted by the plain version on THIS data as one
    thread per ray works (an any-hit ray stops at its first hit).

    Bytes: the ``active`` flag of every lane, origin, direction and ``maxt``
    of the active lanes only, every output once, and each DISTINCT node
    record, triangle and instance that some ray read, once (not the whole
    scene: the rays of a frame reach a part of it). Operations: slab tests
    of non-empty children, triangle tests, instance transforms. Where the
    plain version counted work per lane (K1), ``bound_detail`` also carries
    the two SIMT ceilings of these rays (``simt_ceilings``): the share of a
    warp's lanes that can do work when every warp lasts as long as its
    busiest lane, for warps of 32 lanes in launch order and of 32 active
    lanes."""
    from polaris_tpu_torch.ops.intersect import simt_ceilings

    o, d, maxt, active = rays
    n = int(o.shape[0])
    spec = FAMILIES[kern.fam]
    leaf = spec["leaf"]
    tri_flops = TRI_FLOPS[leaf] - (1 if any_hit and leaf != "quot" else 0)
    ray_bytes = n + int(active.sum()) * (12 + 12 + 4)
    out_bytes = n * (1 if any_hit else 3 * 4 + 2 * 4 + 1)
    scene_bytes = (
        stats["nodes_touched"] * spec["node_bytes"]
        + stats["tris_touched"] * spec["tri_bytes"]
        + stats["inst_touched"] * (XFORM_BYTES + spec["inst_bytes"])
    )
    nbytes = ray_bytes + out_bytes + scene_bytes
    flops = (
        stats["slabs"] * SLAB_FLOPS
        + stats["tris"] * tri_flops
        + stats["inst"] * XFORM_FLOPS
    )
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_flops = flops / PEAK_FP32_FLOPS * 1e3
    detail = {
        "bytes": nbytes, "ray_bytes": ray_bytes, "out_bytes": out_bytes,
        "scene_bytes": scene_bytes, "nodes_touched": stats["nodes_touched"],
        "tris_touched": stats["tris_touched"], "flops": flops,
        "bytes_ms": t_bytes, "flops_ms": t_flops,
        "visits_per_ray": stats["inner"] / max(n, 1),
        "slab_tests_per_ray": stats["slabs"] / max(n, 1),
        "tri_tests_per_ray": stats["tris"] / max(n, 1),
    }
    if "lane_inner" in stats:
        detail["simt_ceilings"] = simt_ceilings(
            stats["lane_inner"] + stats["lane_tris"], active
        )
        detail["stack_peak"] = stats["stack_peak"]
    return max(t_bytes, t_flops), ("bytes" if t_bytes >= t_flops else "operations"), detail


def graph_replays(kern: Bound, rays, any_hit: bool, where: str, times: int = 3) -> dict:
    """One launch captured into a CUDA graph and replayed ``times``
    times, its outputs spoiled before each replay: every replay writes
    the plain version's result, bit for bit."""
    from polaris_tpu_torch.ops.intersect import Hit
    from polaris_tpu_torch.render.graph import gc_paused

    ref = kern.plain(rays, any_hit)
    kern.run(rays, any_hit)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with gc_paused(), torch.cuda.graph(graph):
        out = kern.run(rays, any_hit)
    fields_ = ("mask",) if any_hit else Hit._fields
    for _ in range(times):
        for f in fields_:
            x = out if any_hit else getattr(out, f)
            if x.dtype == torch.bool:
                x.logical_not_()
            else:
                x.fill_(-7)
        graph.replay()
        torch.cuda.synchronize()
        for f in fields_:
            a = out if any_hit else getattr(out, f)
            b = ref.mask if any_hit else getattr(ref, f)
            if not torch.equal(a, b):
                fail(f"{where}: a graph replay's {f} differs from the plain version")
    return {"check": f"{where}/graph-replays", "staging": kern.staging,
            "replays": times, "equal": True}


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

    def bound(self, fam: str, staging=None) -> Bound:
        key = fam if staging is None else f"{fam}/{staging}"
        if key not in self._bound:
            self._bound[key] = Bound(fam, self.S, staging)
        return self._bound[key]

    def k1(self, key: str, any_hit: bool):
        """K1's result on one ray set (the base of the cross checks)."""
        if (key, any_hit) not in self._k1:
            self._k1[key, any_hit] = self.bound("K1").run(self.rays[key], any_hit)
        return self._k1[key, any_hit]


SETS = (("primary", False), ("bounce1", False), ("shadow", True))


def config_rays(ctx, name: str, width: int) -> str:
    """The key in ``ctx`` of the rays of scene ``name`` at a configuration's
    frame width: the scene's own entry where that has this width."""
    return name if name in ctx and ctx[name].frame == width else f"{name}{width}"


def phase_kernels(ctx):
    """``ctx``: name -> SceneRays. Returns the twelve entries of the kernels line."""
    from polaris_tpu_torch.ops.intersect import Hit

    checks, crosses, entries, repeats, replays = [], [], {}, [], []
    dead_sets = {}

    def where_of(fam, sr, staging):
        return f"{fam}/{sr.name}{sr.frame}" + (f"/{staging}" if staging else "")

    def check_sets(fam, scene_name, staging=None):
        sr = ctx[scene_name]
        kern = sr.bound(fam, staging)
        out = {}
        for key, any_hit in SETS:
            stats = {"per_lane": True} if fam in PER_LANE else {}
            label = f"{where_of(fam, sr, staging)}/{key}"
            rec, got = compare(kern, sr.rays[key], any_hit, label, stats)
            rec["ms"] = time_ms(lambda: kern.run(sr.rays[key], any_hit), reps=20)
            rec["call_ms"] = call_ms(lambda: kern.run(sr.rays[key], any_hit), reps=20)
            # the bound on every set; the SIMT ceilings where the plain
            # version counted work per lane
            b_ms, b_by, detail = bound_ms(kern, sr.rays[key], any_hit, stats)
            rec.update(bound_ms=b_ms, bound_by=b_by, share_of_bound=b_ms / rec["ms"])
            if "simt_ceilings" in detail:
                rec.update(simt_ceilings=detail["simt_ceilings"],
                           stack_peak=detail["stack_peak"])
            checks.append(rec)
            if fam != "K1":
                crosses.append(
                    cross_check(
                        got, sr.k1(key, any_hit), any_hit, rec["n_rays"], label,
                        AGAINST_K1[fam],
                    )
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
                kern, (o, d, maxt, dead), any_hit, f"{where_of(fam, sr, None)}/all-inactive"
            )
            checks.append(rec)
        got = kern.closest((o, d, maxt, dead))
        if bool(got.mask.any()) or bool((got.t != 0).any()):
            fail(f"{fam}: all-inactive batch: a lane reports a hit")
        m = min(RAGGED, int(o.shape[0]) - 29)
        for key, any_hit in (("primary", False), ("shadow", True)):
            ragged = tuple(x[:m].contiguous() for x in sr.rays[key])
            rec, _ = compare(kern, ragged, any_hit, f"{where_of(fam, sr, None)}/ragged-{m}-{key}")
            checks.append(rec)

    def check_schedule(fam, scene_name, staging=None):
        """The edges of the schedules' window fetch and compaction: 1, 31
        and 33 rays and a frame's rays with one active lane, through both
        entry points (K3 also against K1, bit for bit), and for the
        block-local schedule (K4, K5) a frame whose first DEAD_WINDOWS rays
        are inactive; then every ray set launched twice, every output equal
        bit for bit (the schedule must not leak into the result), and for
        K4 and K5 replayed from a CUDA graph, each replay's outputs against
        the plain version."""
        sr = ctx[scene_name]
        kern = sr.bound(fam, staging)
        where = where_of(fam, sr, staging)
        for key, any_hit in (("primary", False), ("shadow", True)):
            rays = sr.rays[key]
            live = rays[3].nonzero()[:, 0]
            one = torch.zeros_like(rays[3])
            one[live[live.numel() // 2]] = True
            cuts = [(f"{m}-rays-{key}", tuple(x[:m].contiguous() for x in rays))
                    for m in (1, 31, 33)]
            cuts.append((f"one-active-{key}", (*rays[:3], one)))
            if fam in BLOCK_LOCAL:
                late = rays[3].clone()
                late[:DEAD_WINDOWS] = False
                cuts.append((f"inactive-windows-{key}", (*rays[:3], late)))
            for name, cut in cuts:
                rec, got = compare(kern, cut, any_hit, f"{where}/{name}")
                checks.append(rec)
                if fam == "K3":
                    base = sr.bound("K1").run(cut, any_hit)
                    crosses.append(cross_check(got, base, any_hit, rec["n_rays"],
                                               f"{where}/{name}", "bits"))
        for key, any_hit in SETS:
            first = kern.run(sr.rays[key], any_hit)
            again = kern.run(sr.rays[key], any_hit)
            torch.cuda.synchronize()
            fields_ = ("mask",) if any_hit else Hit._fields
            for f in fields_:
                a = first if any_hit else getattr(first, f)
                b = again if any_hit else getattr(again, f)
                if not torch.equal(a, b):
                    fail(f"{where}/{key}: a second launch changed {f}")
            repeats.append({"check": f"{where}/{key}/twice", "staging": kern.staging,
                            "equal": True})
        if fam in BLOCK_LOCAL:
            for key, any_hit in SETS:
                replays.append(graph_replays(kern, sr.rays[key], any_hit, f"{where}/{key}"))

    def empty_ms(fam, scene_name):
        """A launch with every lane inactive, on the primary rays the
        kernel's line is timed on: what it costs to trace nothing."""
        sr = ctx[scene_name]
        kern = sr.bound(fam)
        o, d, maxt, alive = sr.rays["primary"]
        dead = dead_sets.setdefault(scene_name, (o, d, maxt, torch.zeros_like(alive)))
        return [time_ms(lambda: kern.run(dead, any_hit), reps=20) for any_hit in (False, True)]

    def entry(fam, scene_name, results):
        """The two entry points' lines, timed on the rays of the path that
        launches them: closest hit on primary rays, any hit on shadow rays."""
        sr = ctx[scene_name]
        kern = sr.bound(fam)
        spec = FAMILIES[fam]
        for name, key, any_hit in (
            (spec["names"][0], "primary", False), (spec["names"][1], "shadow", True),
        ):
            rec, stats = results[key]
            b_ms, b_by, detail = bound_ms(kern, sr.rays[key], any_hit, stats)
            entries[name] = {
                "name": name, "kernel": fam, "any_hit": any_hit, "route": "cuda",
                "source": f"polaris_tpu_torch/csrc/{kern.module.SOURCE}",
                "replaces": spec["replaces"], "launches": 0,
                "n_rays": rec["n_rays"],
                "rays": f"{sr.name} {sr.frame}x{sr.frame} {key}",
                "max_abs_err": rec["max_abs_err"],
                "mismatched_lanes": rec["mismatched_lanes"],
                "ms": rec["ms"], "call_ms": rec["call_ms"],
                "plain_ms": rec["plain_ms"], "bound_ms": b_ms,
                "bound_by": b_by, "share_of_bound": b_ms / rec["ms"],
                "library_ms": None, "bound_detail": detail,
            }
        entries[spec["names"][0]]["ms_bounce1"] = results["bounce1"][0]["ms"]
        for name, ms in zip(spec["names"], empty_ms(fam, scene_name)):
            entries[name]["empty_ms"] = ms
            entries[name]["staging"] = kern.staging

    # K1, with each of its two triangle tests, at the shapes the five
    # configurations launch it: the flagship frame, the textured mitsuba
    # scene (2,564 triangles, curved meshes), cornell, the instanced scene
    # (TLAS leaves, transforms, restore on exit) and dispersive's 1,048,576
    # lanes; the instanced scene also at the smaller frame of K2 to K4
    for fam in K1_FAMILIES:
        entry(fam, "sphere", check_sets(fam, "sphere"))
        check_sets(fam, "instanced")
        for name, width, _, _ in CONFIGS[1:]:
            check_sets(fam, config_rays(ctx, name, width))
        check_edges(fam, "sphere")
        # terrain320k, for which the JAX package leaves the triangles in
        # device memory ('pallas_stream'): too big for shared memory, so K1
        # reads it from global memory there, the other staging branch
        check_sets(fam, "terrain320k")
        for scene_name in ("sphere", "terrain320k"):
            check_schedule(fam, scene_name)
    # K2 and K3, the big-scene kernels: instances inside wide nodes, then the
    # 819k-triangle terrain at the big-scene frame's own shapes; the
    # schedule's edges on both, the one scene staged whole, the other in
    # part or not at all
    for fam in ("K2", "K3"):
        check_sets(fam, "instanced")
        check_edges(fam, "instanced")
        entry(fam, "terrain819k", check_sets(fam, "terrain819k"))
        for scene_name in ("instanced", "terrain819k"):
            check_schedule(fam, scene_name)
    # K4 and K5, on the block-local schedule, at the shapes of the cornell
    # frames that launch them; the buffer staged in shared memory on
    # instanced and cornell, read from global memory on sphere (by the byte
    # rule) and on cornell with that branch forced; the schedule's edges in
    # both branches
    for fam in BLOCK_LOCAL:
        for scene_name in ("sphere", "instanced"):
            check_sets(fam, scene_name)
        entry(fam, "cornell", check_sets(fam, "cornell"))
        check_sets(fam, "cornell", "global")
        check_edges(fam, "cornell")
        for scene_name, staging in (("cornell", None), ("cornell", "global"), ("instanced", None)):
            check_schedule(fam, scene_name, staging)

    for e in entries.values():
        own = [
            c for c in checks
            if c["kernel"] == e["kernel"] and c["any_hit"] == e["any_hit"]
        ]
        e["max_abs_err"] = max(c["max_abs_err"] for c in own)
        e["mismatched_lanes"] = sum(c["mismatched_lanes"] for c in own)
    staged = {c["staging"] for c in checks if c["kernel"] in K1_FAMILIES}
    if staged != {"shared", "global"}:
        fail(f"K1 ran in the staging branches {sorted(staged)}, expected both")
    for fam in ("K2", "K3") + BLOCK_LOCAL:
        staged = {c["staging"] for c in checks if c["kernel"] == fam}
        if staged != {"shared", "global"}:
            fail(f"{fam} ran in the staging branches {sorted(staged)}, expected both")
    emit(
        "kernels", checks=checks, against_k1=crosses, schedule_repeats=repeats,
        graph_replays=replays,
        k1_layout={
            name: {k: sr.bound("K1").P[k] for k in ("staging", "smem_bytes", "stack_need")}
            for name, sr in ctx.items()
            if "K1" in sr._bound
        },
        k23_layout={
            f"{fam}/{name}": {
                k: sr.bound(fam).P[k]
                for k in ("staging", "stack_cap", "smem_bytes")
            }
            for name, sr in ctx.items()
            for fam in ("K2", "K3")
            if fam in sr._bound
        },
        k45_layout={
            f"{fam}/{name}": {
                k: sr.bound(fam).P[k] for k in ("staging", "stack_cap", "smem_bytes")
                if k in sr.bound(fam).P
            }
            for name, sr in ctx.items()
            for fam in BLOCK_LOCAL
            if fam in sr._bound
        },
        limits={"t_rtol": T_RTOL, "t_atol": T_ATOL, "max_mismatch_share": MAX_MISMATCH_SHARE,
                "hh_t_tol": HH_T_TOL},
        against_k1_rules=AGAINST_K1,
    )
    return entries


def phase_grid(ctx):
    """Kernel ms of every mode on primary and bounce-1 rays of six scenes,
    1.3k to 819k triangles: three timings of ten launches per cell, least and
    most. Also checks which kernel mode 'auto' picks for each scene."""
    from polaris_tpu_torch.ops.intersect import make_intersectors

    cells = []
    auto = {}
    for scene_name in GRID_SCENES:
        sr = ctx[scene_name]
        # what 'auto' picks for this scene, by the packed scene its closures
        # carry: K1 at every size on a GPU
        closest, _ = make_intersectors(sr.S, "auto", tri_test="mt")
        auto[scene_name] = "K1" if "k1_words" in closest.packed else "other"
        if auto[scene_name] != "K1":
            fail(f"grid: mode 'auto' did not pick K1 for {scene_name}")
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


# a frame against another's: the tolerance of tests/test_parity.py::_compare,
# and the share of pixels that may lie outside it
FRAME_ATOL, FRAME_RTOL, MAX_OFF_SHARE = 1e-4, 1e-3, 0.005


def pixels_outside(got, want, label: str) -> dict:
    """Pixels of two f32 accumulators outside FRAME_ATOL / FRAME_RTOL. A lane
    whose RR or branch decision flips on an ulp changes its pixel by far
    more than any tolerance, so such pixels are counted, and the check
    fails past MAX_OFF_SHARE of the frame, or on a non-finite or
    wrong-shaped frame."""
    got, want = np.asarray(got), np.asarray(want)
    if got.shape != want.shape or not np.isfinite(got).all():
        fail(f"{label}: wrong shape or non-finite accumulator")
    bad = (~np.isclose(got, want, atol=FRAME_ATOL, rtol=FRAME_RTOL)).any(axis=-1)
    allowed = int(MAX_OFF_SHARE * bad.size)
    if int(bad.sum()) > allowed:
        fail(f"{label}: {int(bad.sum())} pixels outside tolerance (> {allowed})")
    return {"pixels": int(bad.size), "outside_tolerance": int(bad.sum()), "allowed": allowed,
            "max_abs_diff": float(np.abs(got - want).max())}


def phase_golden(scenes):
    """32x32 renders through K1, with each of its triangle tests, against the
    accumulators the JAX package rendered: the untextured sphere and the
    textured mitsuba scene."""
    from polaris_tpu_torch.render.integrator import TorchRenderer
    from polaris_tpu_torch.render.options import RenderOptions

    rows = []
    for name in ("sphere", "mitsuba"):
        path = os.path.join(HERE, "tests", "fixtures", f"torch_golden_{name}_32.npz")
        fx = np.load(path)
        opt = RenderOptions(
            width=int(fx["width"]), height=int(fx["height"]), spp=int(fx["spp"]),
            num_bounces=int(fx["num_bounces"]),
            min_bounces_for_rr=int(fx["min_bounces_for_rr"]), seed=int(fx["seed"]),
        )
        ref = fx["accum"]
        for tri_test in ("mt", "hh"):
            renderer = TorchRenderer(scenes[name], mode="kernel", tri_test=tri_test)
            got = renderer.render_accum(opt).cpu().numpy()
            rows.append({"scene": name, "tri_test": tri_test,
                         **pixels_outside(got, ref, f"golden/{name}/{tri_test}")})
    emit("golden", renders=rows, atol=FRAME_ATOL, rtol=FRAME_RTOL)


def phase_flagship(sphere):
    """The flagship estimator (path regeneration, RR after 3) through K1 and
    through K1's plain version on a small frame: no pixel of the two u8
    images more than one level apart, at most 0.1% of them apart at all. The
    kernel's frame runs from the renderer's CUDA graphs; the plain
    traversal, which reads its loop condition back to the host and cannot be
    captured, runs through the eager loop functions. The frame at its full
    size is timed as the first configuration."""
    from polaris_tpu_torch.ops.intersect import intersect_bvh
    from polaris_tpu_torch.render.integrator import TorchRenderer, render_blocked_eager
    from polaris_tpu_torch.render.options import RenderOptions

    small = RenderOptions(
        width=128, height=128, spp=4, num_bounces=BOUNCES,
        min_bounces_for_rr=RR_AFTER,
    )
    images = []
    for plain in (False, True):
        r = TorchRenderer(sphere, mode="kernel", regen=True)
        r.spp_per_launch = 16
        if not plain:
            images.append(r.render_u8(small).astype(np.int16))
            continue
        r.closest = lambda S, *rays: intersect_bvh(S, *rays, any_hit=False, leaf="det2")
        r.any_hit = lambda S, *rays: intersect_bvh(S, *rays, any_hit=True, leaf="det2").mask
        acc, _ = render_blocked_eager(r, small)
        images.append(r.finalize(acc, small, "u8").cpu().numpy().astype(np.int16))
    kernel_img, plain_img = images
    diff = np.abs(kernel_img - plain_img)
    off = int((diff > 0).any(axis=-1).sum())
    if int(diff.max()) > 1 or off > 0.001 * 128 * 128:
        fail(
            f"flagship: kernel and plain traversal images differ "
            f"(max {int(diff.max())} levels, {off} pixels)"
        )
    emit(
        "flagship",
        plain_check={"frame": "128x128x4spp", "max_level_diff": int(diff.max()),
                     "pixels_differing": off},
    )


# the kernel modules whose launch counts a frame reads, K1hh counted as K1
COUNTED = ("K1", "K2", "K3", "K4", "K5")


def reset_launches() -> None:
    for fam in COUNTED:
        module_of(fam).reset_launches()


def read_launches() -> dict:
    """Every entry point launched since the last reset, by family."""
    out = {}
    for fam in COUNTED:
        counts = {k: v for k, v in module_of(fam).LAUNCHES.items() if v}
        if counts:
            out[fam] = counts
    return out


def graph_against_eager(renderer, opt, label: str, graph_reps: int, eager_reps: int):
    """One configuration's frames through the renderer (its CUDA graphs) and
    through the eager loop functions, in this process. First a
    ``render_accum`` frame, which captures the graphs (its seconds and the
    capture's are reported apart, outside the timed frames); then
    ``graph_reps`` timed ``render_u8`` frames and ``eager_reps`` timed eager
    frames, the launch counts set to 0 just before each and read just after.
    Fails unless the f32 accumulators and the u8 images of the two are equal
    bit for bit, the two loops count the same trips, and every frame's
    closest-hit launches equal the trips it ran (overshoot included). Returns
    (row, graph u8 image, graph launch counts)."""
    from polaris_tpu_torch.render.integrator import render_blocked_eager

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    acc_graph = renderer.render_accum(opt)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    times, img, counts = [], None, {}
    for _ in range(graph_reps):
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        img = renderer.render_u8(opt)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        counts = read_launches()
    graph_peak = torch.cuda.max_memory_allocated()
    trips, trips_run = renderer.last_trips, renderer.last_trips_run
    closest = sum(c.get("closest_hit", 0) + c.get("closest_hit_hh", 0) for c in counts.values())
    if closest != trips_run:
        fail(f"{label}: {closest} closest-hit launches in a graph frame that ran "
             f"{trips_run} trips ({trips} with a live lane)")

    torch.cuda.reset_peak_memory_stats()
    eager_times, eager_counts = [], {}
    for _ in range(eager_reps):
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        acc, eager_trips = render_blocked_eager(renderer, opt)
        eager_img = renderer.finalize(acc, opt, "u8").cpu().numpy()
        torch.cuda.synchronize()
        eager_times.append(time.perf_counter() - t0)
        eager_counts = read_launches()
    eager_closest = sum(
        c.get("closest_hit", 0) + c.get("closest_hit_hh", 0) for c in eager_counts.values()
    )
    if eager_closest != eager_trips:
        fail(f"{label}: {eager_closest} closest-hit launches in an eager frame of "
             f"{eager_trips} trips")
    if eager_trips != trips:
        fail(f"{label}: the graphs counted {trips} trips, the eager loop {eager_trips}")
    if not torch.equal(acc_graph, renderer.finalize(acc, opt)):
        fail(f"{label}: the graph and eager f32 accumulators differ")
    if img.shape != (opt.height, opt.width, 3) or img.dtype != np.uint8:
        fail(f"{label}: unexpected image {img.shape} {img.dtype}")
    if not np.array_equal(img, eager_img):
        fail(f"{label}: the graph and eager u8 images differ in "
             f"{int((img != eager_img).any(axis=-1).sum())} pixels")
    if not img.mean() > 1.0:
        fail(f"{label}: black image (mean {img.mean():.3f})")
    rays = opt.width * opt.height * opt.spp * opt.num_bounces * 2
    best, eager_best = min(times), min(eager_times)
    row = {
        "frame": f"{opt.width}x{opt.height}x{opt.spp}spp",
        "frame_ms": best * 1e3, "frame_ms_all": [t * 1e3 for t in times],
        "mrays_per_s": rays / best / 1e6,
        "eager_frame_ms": eager_best * 1e3,
        "eager_frame_ms_all": [t * 1e3 for t in eager_times],
        "trips": trips, "trips_run": trips_run, "overshoot_trips": trips_run - trips,
        "host_syncs_per_frame": renderer.last_host_syncs,
        "first_frame_s": first_s, "capture_s": renderer.capture_seconds,
        "graphs": sum(len(p.steps) for p in renderer._programs.values()),
        "peak_mem_bytes": graph_peak, "eager_peak_mem_bytes": torch.cuda.max_memory_allocated(),
        "launches": counts, "eager_launches": eager_counts,
        "accum_equal": True, "u8_equal": True, "image_mean": float(img.mean()),
    }
    return row, img, counts


def level_diff(img, base, label: str, max_share: float) -> dict:
    """u8 level difference of two frames of one scene; fails when more than
    ``max_share`` of the pixels are more than one level apart."""
    diff = np.abs(img.astype(np.int16) - base.astype(np.int16))
    far = int((diff > 1).any(axis=-1).sum())
    pixels = diff.shape[0] * diff.shape[1]
    if far > max_share * pixels:
        fail(
            f"{label}: {far} of {pixels} pixels differ by more than one level "
            f"(allowed share {max_share})"
        )
    return {
        "max_level_diff": int(diff.max()),
        "pixels_differing": int((diff > 0).any(axis=-1).sum()),
        "pixels_over_one_level": far,
        "mean_level_diff": float(diff.mean()),
    }


def phase_configs(scenes, smi: str):
    """This slice's path at full width: the five benchmark configurations
    (the first is the flagship frame, best of 3), each through
    ``TorchRenderer(mode="auto", regen=True)`` (CUDA graphs, ``render_u8``)
    and through the eager loop functions, then sphere and mitsuba once more
    through the Havel-Herout test, with the u8 level difference to the
    default. Returns K1's launch counts: the default test's from the last
    graph frame of the flagship configuration, the Havel-Herout test's from
    its sphere frame."""
    from polaris_tpu_torch.render.integrator import TorchRenderer
    from polaris_tpu_torch.render.options import RenderOptions

    def run(name, w, h, spp, tri_test, reps, eager_reps):
        renderer = TorchRenderer(scenes[name], mode="auto", regen=True, tri_test=tri_test)
        renderer.spp_per_launch = 16
        opt = RenderOptions(
            width=w, height=h, spp=spp, num_bounces=BOUNCES,
            min_bounces_for_rr=RR_AFTER,
        )
        label = f"configs/{name}/{tri_test}"
        row, img, counts = graph_against_eager(renderer, opt, label, reps, eager_reps)
        fam = "K1hh" if tri_test == "hh" else "K1"
        keys = FAMILIES[fam]["keys"]
        k1 = counts.get("K1", {})
        if set(counts) != {"K1"} or set(k1) != set(keys):
            fail(f"{label}: launched {counts}, expected {keys} of K1 only")
        row = {"scene": name, "tri_test": tri_test,
               "triangles": int(scenes[name].tri_v0.shape[0]), **row,
               "launches": {k: k1[k] for k in keys}}
        del renderer
        torch.cuda.empty_cache()
        return row, img, k1

    rows, images, launches = [], {}, {}
    for name, w, h, spp in CONFIGS:
        reps = 1 if spp >= 128 else 3 if name == "sphere" else 2
        row, images[name], counts = run(name, w, h, spp, "mt", reps, 2 if name == "sphere" else 1)
        rows.append(row)
        if name == "sphere":
            launches.update({k: counts[k] for k in FAMILIES["K1"]["keys"]})
    for name, w, h, spp in CONFIGS:
        if name not in ("sphere", "mitsuba"):
            continue
        row, img, counts = run(name, w, h, spp, "hh", 1, 1)
        row["against_mt"] = level_diff(
            img, images[name], f"configs/{name}: hh against mt", MAX_HH_LEVEL_SHARE
        )
        rows.append(row)
        if name == "sphere":
            launches.update({k: counts[k] for k in FAMILIES["K1hh"]["keys"]})
    emit("configs", card=smi, bounces=BOUNCES, rr_after=RR_AFTER, rows=rows)
    return launches


def phase_bigscene(terrain, cornell, smi: str):
    """The big-scene path at full width: the 819k-triangle terrain through the
    8-wide record kernel and the binary record kernel, then the two modes
    that hang off the same switch on cornell; every frame through the
    renderer's CUDA graphs and through the eager loop functions, equal bit
    for bit."""
    from polaris_tpu_torch.render.integrator import TorchRenderer
    from polaris_tpu_torch.render.options import RenderOptions

    opt = RenderOptions(
        width=FRAME, height=FRAME, spp=BIG_SPP, num_bounces=BIG_BOUNCES,
        min_bounces_for_rr=BIG_RR_AFTER,
    )
    launches, frames, images = {}, {}, {}
    for fam in ("K2", "K3"):
        renderer = TorchRenderer(terrain, mode=FAMILIES[fam]["mode"])
        renderer.spp_per_launch = 1  # as bench_big.py: keep launches short
        row, img, counts = graph_against_eager(renderer, opt, f"bigscene/{fam}", 2, 1)
        if set(counts) != {fam}:
            fail(f"bigscene/{fam}: launched {counts}")
        for name, count in counts[fam].items():
            if count != opt.spp * opt.num_bounces:
                fail(
                    f"bigscene/{fam}: {name} launched {count} times in one frame, "
                    f"expected {opt.spp * opt.num_bounces}"
                )
        launches[fam] = counts[fam]
        images[fam] = img
        frames[fam] = {"mode": FAMILIES[fam]["mode"], **row, "launches": counts[fam]}
        del renderer
        torch.cuda.empty_cache()
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
        renderer = TorchRenderer(cornell, mode=mode)
        row, img, counts = graph_against_eager(renderer, small, f"bigscene/{mode}", 1, 1)
        for name in FAMILIES[fam]["keys"]:
            if counts.get(fam, {}).get(name, 0) <= 0:
                fail(f"bigscene/{mode}: {fam} {name} was never launched")
        # K4 divides per triangle and K5 once per ray where K1 divides once
        # per leaf: a hit may move by an ulp, a pixel by a level, no more
        levels = level_diff(img, base, f"bigscene/{mode} against mode 'kernel'", 0.0)
        launches[fam] = counts[fam]
        cornell_checks[mode] = {"kernel": fam, **row, **levels}
    emit(
        "bigscene", card=smi, scene=f"terrain grid {BIG_GRID}",
        frame=f"{FRAME}x{FRAME}x{BIG_SPP}spp, {BIG_BOUNCES} bounces",
        frames=frames, k2_k3_pixels_differing=differing,
        cornell=f"{SMALL_FRAME}x{SMALL_FRAME}x4spp", cornell_checks=cornell_checks,
    )
    return launches


def phase_adaptive(cornell, smi: str):
    """Adaptive per-block sampling on cornell 512x512 (a cap of ADAPT_SPP
    samples, chunks of ADAPT_CHUNK, ``tol`` ADAPT_TOL: a tolerance, the chunk
    and the scene of the JAX package's scripts/bench_adaptive.py), through
    the sequential loop's graphs. One warm-up, best of 2; frame ms, mean
    spp, the share of blocks stopped, the MSE of the tonemapped image
    against a uniform ADAPT_REF_SPP render (and the uniform ADAPT_SPP
    frame's). Fails unless each stopped block's pixels equal
    ``render_accum_offset`` at that block's count bit for bit, and ``tol=0``
    equals ``render_accum_offset`` at ADAPT_SPP."""
    from dataclasses import replace

    from polaris_tpu_torch.render.integrator import TorchRenderer
    from polaris_tpu_torch.render.options import RenderOptions
    from polaris_tpu_torch.render.shade import tonemap_reinhard

    opt = RenderOptions(
        width=FRAME, height=FRAME, spp=ADAPT_SPP, num_bounces=BOUNCES,
        min_bounces_for_rr=RR_AFTER,
    )
    r = TorchRenderer(cornell, mode="auto")
    r.spp_per_launch = ADAPT_CHUNK
    kw = dict(tol=ADAPT_TOL, chunk=ADAPT_CHUNK)
    r.render_adaptive(opt, **kw)  # warm-up: captures the chunk's graph
    capture_s = r.capture_seconds
    times = []
    for _ in range(2):
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        accum, spp_map = r.render_adaptive(opt, **kw)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        counts = read_launches()
    closest = counts.get("K1", {}).get("closest_hit", 0)
    if closest != r.last_trips_run:
        fail(f"adaptive: {closest} closest-hit launches for {r.last_trips_run} passes")
    blocks = r.last_spp_blocks

    def tone(acc, weight):
        return tonemap_reinhard(acc, weight, opt.exposure)

    ref = tone(r.render_accum(replace(opt, spp=ADAPT_REF_SPP)), 1.0 / ADAPT_REF_SPP)
    mse = float(((tone(accum, 1.0 / spp_map[..., None].float()) - ref) ** 2).mean())
    fixed = {}
    for c in sorted(int(c) for c in torch.unique(spp_map).cpu()):
        fixed[c] = r.render_accum_offset(replace(opt, spp=c))
        sel = spp_map == c
        if not torch.equal(accum[sel], fixed[c][sel]):
            fail(f"adaptive: the blocks stopped at {c} spp differ from a {c}-spp render")
    uniform = fixed.get(ADAPT_SPP)
    if uniform is None:
        uniform = r.render_accum_offset(opt)
    never, never_map = r.render_adaptive(opt, tol=0.0, chunk=ADAPT_CHUNK)
    if not bool((never_map == ADAPT_SPP).all()) or not torch.equal(never, uniform):
        fail(f"adaptive: tol=0 differs from a {ADAPT_SPP}-spp render_accum_offset")
    emit(
        "adaptive", card=smi, scene="cornell", frame=f"{FRAME}x{FRAME}",
        cap_spp=ADAPT_SPP, chunk=ADAPT_CHUNK, tol=ADAPT_TOL,
        frame_ms=min(times) * 1e3, frame_ms_all=[t * 1e3 for t in times],
        capture_s=capture_s, mean_spp=float(spp_map.float().mean()),
        blocks=int(blocks.size), blocks_stopped_share=float((blocks < ADAPT_SPP).mean()),
        spp_counts={str(c): int((blocks == c).sum()) for c in np.unique(blocks)},
        host_syncs_per_frame=r.last_host_syncs, launches=counts,
        ref_spp=ADAPT_REF_SPP, mse_vs_ref=mse,
        uniform_mse_vs_ref=float(((tone(uniform, 1.0 / ADAPT_SPP) - ref) ** 2).mean()),
        stopped_blocks_equal=True, tol0_equal=True,
    )


def field_diffs(got: dict, want: dict, label: str, tol: float) -> dict:
    """Each gradient field's largest |difference| over the field's largest
    |value| in ``want``; fails above ``tol``, or where ``want`` is all zeros
    and ``got`` is not."""
    out = {}
    for k, w in want.items():
        w = torch.as_tensor(w, device=got[k].device)
        if got[k].shape != w.shape or not bool(torch.isfinite(got[k]).all()):
            fail(f"{label}: field {k} has shape {tuple(got[k].shape)} or is not finite")
        scale, diff = float(w.abs().max()), float((got[k] - w).abs().max())
        out[k] = diff / scale if scale > 0 else diff
        if out[k] > (tol if scale > 0 else 0.0):
            fail(f"{label}: field {k} differs by {out[k]} of its largest |gradient| (> {tol})")
    return out


def timed_runs(fn, reps: int):
    """``reps`` calls of ``fn``, each timed on the host clock around work that
    ends in a synchronise, the launch counts set to 0 just before and read
    just after. Returns (last result, times in ms, last call's counts)."""
    times, counts, out = [], {}, None
    for _ in range(reps):
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        counts = read_launches()
    return out, times, counts


def phase_grad(scenes, smi: str):
    """The differentiable path (the JAX package's bench_grad.py) on sphere
    512x512, 8 spp, 5 bounces, RR after 3, zero target, through K1:
    ``loss_only`` and ``loss_and_grad`` (each one CUDA graph), best of 3,
    with K1's launches a step; the captured step against the eager step
    (loss bit-equal, each field within GRAD_TOL of its largest |gradient|);
    the eager step through K1 against the eager step through K1's plain
    version on a 128x128 2-spp frame (the same); the step against the
    JAX-made fixture (cornell 24x24); ``render_from_params`` through the
    graphs against the eager loop with the same parameters (bit for bit, the
    scene's storage kept); 5 Adam steps of ``Trainer`` toward a target with
    darker diffuse colors (the loss falls; a checkpoint restores into a
    fresh trainer); and the 128-spp headline frame."""
    from dataclasses import replace

    from polaris_tpu_torch.ops import intersect_cuda
    from polaris_tpu_torch.render.grad import DifferentiableRenderer, loss_and_grad_eager
    from polaris_tpu_torch.render.integrator import TorchRenderer, render_blocked_eager
    from polaris_tpu_torch.render.options import RenderOptions
    from polaris_tpu_torch.render.shade import tonemap_reinhard
    from polaris_tpu_torch.render.trainer import TrainConfig, Trainer

    sphere = scenes["sphere"]
    opt = RenderOptions(width=FRAME, height=FRAME, spp=GRAD_SPP, num_bounces=BOUNCES,
                        min_bounces_for_rr=RR_AFTER)
    target = np.zeros((FRAME, FRAME, 3), np.float32)
    r = DifferentiableRenderer(sphere, mode="auto")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    r.loss_only(opt, target)
    r.loss_and_grad(opt, target)
    torch.cuda.synchronize()
    first_s, capture_s = time.perf_counter() - t0, r.capture_seconds
    peak = torch.cuda.max_memory_allocated()
    fwd_loss, fwd_ms, fwd_counts = timed_runs(lambda: r.loss_only(opt, target), 3)
    (loss, grads, cam), step_ms, step_counts = timed_runs(
        lambda: r.loss_and_grad(opt, target), 3
    )
    per_step = {"closest_hit": GRAD_SPP * BOUNCES, "any_hit": GRAD_SPP * BOUNCES}
    for label, counts in (("loss_only", fwd_counts), ("loss_and_grad", step_counts)):
        if counts != {"K1": per_step}:
            fail(f"grad: a {label} step launched {counts}, expected K1 {per_step}")
    if not np.isfinite(loss) or loss <= 0:
        fail(f"grad: loss {loss}")

    # the captured step against the eager one, in this process
    (e_loss, e_grads, e_cam), eager_ms, _ = timed_runs(
        lambda: loss_and_grad_eager(r, opt, target), 1
    )
    if e_loss != loss:
        fail(f"grad: the captured step's loss {loss!r} differs from the eager {e_loss!r}")
    graph_diffs = field_diffs({**grads, **cam}, {**e_grads, **e_cam}, "grad/eager", GRAD_TOL)
    del e_grads, e_cam

    # K1 against its plain version under the gradient (eager: the plain
    # traversal reads its loop condition back to the host)
    small = replace(opt, width=GRAD_CHECK, height=GRAD_CHECK, spp=GRAD_CHECK_SPP)
    zeros = np.zeros((GRAD_CHECK, GRAD_CHECK, 3), np.float32)
    P = r.closest.packed
    k_loss, k_g, k_c = loss_and_grad_eager(r, small, zeros)
    p_loss, p_g, p_c = loss_and_grad_eager(
        r, small, zeros,
        closest=lambda S, *rays: intersect_cuda.k1_plain(P, *rays, any_hit=False),
        any_hit=lambda S, *rays: intersect_cuda.k1_plain(P, *rays, any_hit=True).mask,
    )
    if k_loss != p_loss:
        fail(f"grad: K1's loss {k_loss!r} differs from its plain version's {p_loss!r}")
    plain_diffs = field_diffs({**k_g, **k_c}, {**p_g, **p_c}, "grad/plain", GRAD_TOL)

    # against the gradients the JAX package computed
    fx = np.load(os.path.join(HERE, "tests", "fixtures", "torch_golden_grad_cornell_24.npz"))
    fopt = RenderOptions(**{k: int(fx[k]) for k in (
        "width", "height", "spp", "num_bounces", "min_bounces_for_rr")})
    rc = DifferentiableRenderer(scenes["cornell"], mode="auto")
    c_loss, c_g, c_c = rc.loss_and_grad(
        fopt, np.zeros((fopt.height, fopt.width, 3), np.float32)
    )
    fx_loss_rel = abs(c_loss - float(fx["loss"])) / float(fx["loss"])
    if fx_loss_rel > FIXTURE_LOSS_RTOL:
        fail(f"grad: loss {c_loss} against the JAX fixture's {float(fx['loss'])}")
    fixture_diffs = field_diffs(
        {**c_g, **c_c}, {k[2:]: fx[k] for k in fx.files if k.startswith("g.")},
        "grad/fixture", FIXTURE_FIELD_TOL,
    )
    del rc

    # render_from_params through the graphs against the eager loop
    ptrs = {k: v.data_ptr() for k, v in r.S.items() if torch.is_tensor(v)}
    before = {k: v.detach().clone() for k, v in r.params.items()}
    dark = r.params["mat_reflectance"].detach() * TRAIN_FACTOR
    got = r.render_from_params(opt, {"mat_reflectance": dark})
    with torch.no_grad():
        r.params["mat_reflectance"].copy_(dark)
        ref = r.finalize(render_blocked_eager(r, opt)[0], opt)
        r.params["mat_reflectance"].copy_(before["mat_reflectance"])
    if not torch.equal(got, ref):
        fail("grad: render_from_params differs from the eager render with its params")
    if {k: v.data_ptr() for k, v in r.S.items() if torch.is_tensor(v)} != ptrs:
        fail("grad: render_from_params moved a tensor of the scene")
    if any(not torch.equal(r.params[k], v) for k, v in before.items()):
        fail("grad: render_from_params did not restore the parameters")
    train_target = tonemap_reinhard(got + 1e-6, 1.0 / opt.spp, opt.exposure)
    del r, got, ref
    torch.cuda.empty_cache()

    # the trainer at full size, then a checkpoint into a fresh trainer
    ckpt_dir = os.path.join(HERE, "build", "chip_smoke_checkpoints")
    cfg = TrainConfig(learning_rate=TRAIN_LR, num_steps=TRAIN_STEPS, reseed_each_step=False,
                      checkpoint_dir=ckpt_dir)
    tr = Trainer(sphere, opt, cfg)
    _, train_ms, train_counts = timed_runs(lambda: tr.step(train_target), TRAIN_STEPS)
    history = [float(x) for x in tr.history]
    if not history[-1] < history[0]:
        fail(f"grad: the trainer's loss did not fall: {history}")
    path = tr.save_checkpoint()
    tr2 = Trainer(sphere, opt, cfg)
    tr2.restore_checkpoint(path)
    os.remove(path)
    os.rmdir(ckpt_dir)
    if tr2.step_idx != tr.step_idx or any(
        not torch.equal(tr2.renderer.params[k], v) for k, v in tr.renderer.params.items()
    ) or not all(np.array_equal(a, b) for a, b in zip(tr2._opt_leaves(), tr._opt_leaves())):
        fail("grad: the restored trainer differs from the one that wrote the checkpoint")
    del tr, tr2
    torch.cuda.empty_cache()

    # the headline frame (bench_grad.py's third row)
    hr = TorchRenderer(sphere, mode="auto", regen=True)
    hr.spp_per_launch = HEADLINE_CHUNK
    hopt = replace(opt, spp=HEADLINE_SPP)
    hr.render_u8(hopt)
    img, frame_ms, _ = timed_runs(lambda: hr.render_u8(hopt), 2)
    if not img.mean() > 1.0:
        fail("grad: black headline frame")
    del hr
    torch.cuda.empty_cache()

    rays = FRAME * FRAME * GRAD_SPP * BOUNCES * 2
    emit(
        "grad", card=smi, scene="sphere", frame=f"{FRAME}x{FRAME}x{GRAD_SPP}spp",
        bounces=BOUNCES, rr_after=RR_AFTER, loss=loss,
        loss_only_ms=min(fwd_ms), loss_only_ms_all=fwd_ms,
        loss_and_grad_ms=min(step_ms), loss_and_grad_ms_all=step_ms,
        backward_forward_ratio=min(step_ms) / min(fwd_ms),
        mrays_per_s_forward=rays / min(fwd_ms) / 1e3,
        mrays_per_s_step=rays / min(step_ms) / 1e3,
        eager_step_ms=eager_ms[0], first_calls_s=first_s, capture_s=capture_s,
        peak_mem_bytes=peak, k1_launches_per_step=step_counts["K1"],
        loss_only_equal=fwd_loss == loss,
        against_eager={"loss_equal": True, "field_rel_diff": graph_diffs},
        against_plain={"frame": f"{GRAD_CHECK}x{GRAD_CHECK}x{GRAD_CHECK_SPP}spp",
                       "loss_equal": True, "field_rel_diff": plain_diffs},
        against_jax_fixture={"frame": f"{fopt.width}x{fopt.height}x{fopt.spp}spp",
                             "scene": "cornell", "loss_rel_diff": fx_loss_rel,
                             "field_rel_diff": fixture_diffs},
        render_from_params_equal=True,
        trainer={"steps": TRAIN_STEPS, "lr": TRAIN_LR, "history": history,
                 "step_ms": train_ms, "launches_last_step": train_counts,
                 "checkpoint_restored": True},
        headline={"frame": f"{FRAME}x{FRAME}x{HEADLINE_SPP}spp", "regen": True,
                  "spp_per_launch": HEADLINE_CHUNK, "frame_ms": min(frame_ms),
                  "frame_ms_all": frame_ms,
                  "mrays_per_s": FRAME * FRAME * HEADLINE_SPP * BOUNCES * 2
                  / min(frame_ms) / 1e3},
    )


def phase_denoise(cornell, smi: str):
    """The à-trous denoiser on cornell 512x512, DENOISE_SPP samples,
    DENOISE_ITERS levels, through K1. The guide pass (one closest-hit
    launch) and the filter each run from one CUDA graph. Two calls, at the
    scene's camera and at one turned by DENOISE_YAW, each with an
    accumulator, a sample count and bandwidths of its own: the replayed
    guides against ``guide_images`` through K1's plain version, and the
    replayed filter against ``filter_accum`` op by op on the same
    accumulator and guides, both bit for bit (a replay that read a stale
    input would differ). Then guide ms and filter ms, best of 3, and the MSE
    of the tonemapped image against a DENOISE_REF_SPP render before and
    after the filter, which must drop."""
    from dataclasses import replace

    from polaris_tpu_torch.asset.camera import Camera
    from polaris_tpu_torch.ops import intersect_cuda
    from polaris_tpu_torch.render.denoise import (
        denoise_accum, filter_accum, filter_program, guide_images, render_guides,
    )
    from polaris_tpu_torch.render.integrator import TorchRenderer
    from polaris_tpu_torch.render.options import RenderOptions
    from polaris_tpu_torch.render.shade import tonemap_reinhard

    opt = RenderOptions(width=FRAME, height=FRAME, spp=DENOISE_SPP, num_bounces=BOUNCES,
                        min_bounces_for_rr=RR_AFTER)
    r = TorchRenderer(cornell, mode="auto")
    P = r.closest.packed
    turned = Camera.from_scene(cornell, FRAME, FRAME)
    turned.yaw = DENOISE_YAW
    turned.update()
    runs = []
    for camera, spp, bw in (
        (None, DENOISE_SPP, dict(c_phi=0.4, n_phi=0.25, d_phi=0.05)),
        (turned, DENOISE_SPP // 2, dict(c_phi=0.3, n_phi=0.2, d_phi=0.1)),
    ):
        runs.append((camera, spp, bw, r.render_accum(replace(opt, spp=spp), camera)))
    # the first calls capture (their results come from the warm-up step)
    camera, spp, bw, accum = runs[-1]
    denoise_accum(r, opt, accum, spp, camera, iterations=DENOISE_ITERS, **bw)
    capture_s = r.capture_seconds
    checks, images = [], []
    for camera, spp, bw, accum in runs:
        nrm, z = render_guides(r, opt, camera)
        p_nrm, p_z = guide_images(
            r, *r._camera_tensors(opt, camera), FRAME, FRAME,
            closest=lambda S, *rays: intersect_cuda.k1_plain(P, *rays, any_hit=False),
        )
        den = denoise_accum(r, opt, accum, spp, camera, iterations=DENOISE_ITERS, **bw)
        # the program reads the count and the bandwidths from 0-d tensors
        want = filter_accum(
            accum, nrm, z, torch.tensor(float(spp), device=r.device),
            iterations=DENOISE_ITERS, fireflies=True,
            **{k: torch.tensor(v, device=r.device) for k, v in bw.items()},
        )
        label = "turned" if camera is not None else "scene"
        check = {
            "camera": label, "spp": spp, **bw,
            "guide_pixels_differ": int(((nrm != p_nrm).any(-1) | (z != p_z)).sum()),
            "filter_max_abs_diff": float((den - want).abs().max()),
        }
        checks.append(check)
        if check["guide_pixels_differ"]:
            fail(f"denoise: the replayed guides ({label} camera) differ from K1's plain "
                 f"version's at {check['guide_pixels_differ']} pixels")
        if not torch.equal(den, want):
            fail(f"denoise: the replayed filter ({label} camera) differs from the eager "
                 f"filter by {check['filter_max_abs_diff']}")
        images.append((nrm, den))
    if torch.equal(images[0][0], images[1][0]) or torch.equal(images[0][1], images[1][1]):
        fail("denoise: two calls with different inputs gave the same guides or output")
    del runs, images, nrm, z, p_nrm, p_z, want

    accum = r.render_accum(opt)
    _, guide_ms, guide_counts = timed_runs(lambda: render_guides(r, opt), 3)
    if guide_counts != {"K1": {"closest_hit": 1}}:
        fail(f"denoise: a guide pass launched {guide_counts}, expected one K1 closest hit")
    filt = filter_program(r, FRAME, FRAME, DENOISE_ITERS)
    _, filter_ms, _ = timed_runs(filt.step, 3)
    den, denoise_ms, _ = timed_runs(
        lambda: denoise_accum(r, opt, accum, opt.spp, iterations=DENOISE_ITERS), 3
    )
    if den.shape != accum.shape or not bool(torch.isfinite(den).all()):
        fail("denoise: wrong shape or non-finite output")
    ref = r.render_accum(replace(opt, spp=DENOISE_REF_SPP))

    def tone(acc, spp):
        return tonemap_reinhard(acc, 1.0 / spp, opt.exposure)

    target = tone(ref, DENOISE_REF_SPP)
    before = float(((tone(accum, opt.spp) - target) ** 2).mean())
    after = float(((tone(den, opt.spp) - target) ** 2).mean())
    if not after < before:
        fail(f"denoise: the MSE did not drop ({before} -> {after})")
    emit(
        "denoise", card=smi, scene="cornell", frame=f"{FRAME}x{FRAME}x{DENOISE_SPP}spp",
        iterations=DENOISE_ITERS, guide_ms=min(guide_ms), guide_ms_all=guide_ms,
        filter_ms=min(filter_ms), filter_ms_all=filter_ms, denoise_ms=min(denoise_ms),
        capture_s=capture_s, guide_launches=guide_counts, replays_against_eager=checks,
        ref_spp=DENOISE_REF_SPP, mse_before=before, mse_after=after,
    )


def decode_png(data: bytes) -> np.ndarray:
    """The pixels of an 8-bit RGB PNG whose rows all use filter 0, which is
    what ``utils/png.py`` writes, every chunk's CRC checked: a decoder of the
    script's own, as the card's machine has no PIL. Fails on anything else."""
    import struct
    import zlib

    if data[:8] != b"\x89PNG\r\n\x1a\n":
        fail("png: no PNG signature")
    pos, header, idat = 8, None, b""
    while pos < len(data):
        n, tag = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        if zlib.crc32(tag + body) & 0xFFFFFFFF != crc:
            fail(f"png: bad CRC in chunk {tag!r}")
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat += body
        elif tag == b"IEND":
            break
        pos += 12 + n
    if header is None or header[2:] != (8, 2, 0, 0, 0):
        fail(f"png: not 8-bit RGB without interlace: {header}")
    w, h = header[:2]
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + 3 * w)
    if rows[:, 0].any():
        fail("png: a row uses a filter other than 0")
    return rows[:, 1:].reshape(h, w, 3)


def k1_launches(counts: dict, label: str) -> dict:
    """K1's launches in ``counts`` (``read_launches``); fails if the path ran
    another kernel or never ran K1's closest hit."""
    if set(counts) - {"K1"} or not counts.get("K1", {}).get("closest_hit"):
        fail(f"{label}: launched {counts}, expected K1 only, its closest hit at least once")
    return counts["K1"]


def phase_viewer(scenes, smi: str):
    """The viewer and tooling at the flagship's full width (sphere 512x512,
    VIEW_SPP spp a pass, 5 bounces, RR after 3, mode 'auto', path
    regeneration), through K1:

    * ``ProgressiveRenderer.run`` to VIEW_PASSES passes, with its server
      on a free port and a snapshot after every pass; after each pass the
      accumulator equals the sum of ``render_accum_offset`` partials at
      offsets 0, 16, 32, ... bit for bit, and after all of them it is within
      PROG_ATOL + PROG_RTOL * |value| of one 64-spp partial; the pass ms
      that run records; K1's launches over the passes = the trips they
      ran; the snapshot decodes to the image run returns; the server is
      shut down when run ends. PNG encode ms, timed on its own.
    * A second ``run`` with its server: before its first pass
      ``/frame.png`` decodes to the first run's last image, ``/stats``
      carries its pass history and block rows, ``/`` serves the page, and a
      ``/move`` resets the accumulation at that pass, whose accumulator
      equals a fresh ``render_accum_offset`` at the new camera bit for bit.
    * Every debug channel through K1 against the same channel through K1's
      plain version at DEBUG_CHECK x DEBUG_CHECK, bit for bit; each timed at
      512x512.
    * ``default_pipeline().run`` equal to ``render`` bit for bit; the chain
      denoise -> tonemap -> save PNG writes a file that decodes to the
      chain's image.
    * ``profiling.trace`` around a debug channel writes a trace that names
      K1's two entry points and holds device time."""
    import urllib.request
    from dataclasses import replace

    from polaris_tpu_torch.ops import intersect_cuda
    from polaris_tpu_torch.parallel.multihost import free_port
    from polaris_tpu_torch.render.debug import DEBUG_CHANNELS, render_debug
    from polaris_tpu_torch.render.options import RenderOptions
    from polaris_tpu_torch.render.pipeline import (
        Pipeline, default_pipeline, denoise_stage, save_png_stage, tonemap_stage,
    )
    from polaris_tpu_torch.render.progressive import ProgressiveRenderer
    from polaris_tpu_torch.utils.png import encode_png
    from polaris_tpu_torch.utils.profiling import TRACE_FILE, trace

    os.makedirs(SMOKE_DIR, exist_ok=True)
    sphere = scenes["sphere"]
    opt = RenderOptions(width=FRAME, height=FRAME, spp=VIEW_SPP, num_bounces=BOUNCES,
                        min_bounces_for_rr=RR_AFTER)
    prog = ProgressiveRenderer(sphere, opt, mode="auto", regen=True)
    r = prog.renderer
    snapshot = os.path.join(SMOKE_DIR, "progressive.png")
    port = free_port()
    # run's own loop calls prog.step; this wrapper runs the checks due
    # before a pass, then the pass, and keeps what the pass left:
    # (samples accumulated, the accumulator, the image, the camera)
    seen, before_pass, trips = [], {}, [0]
    step = prog.step

    def traced_step():
        check = before_pass.pop(len(seen), None)
        if check is not None:
            check()
        img = step()
        trips[0] += r.last_trips_run
        seen.append((prog.accumulated_samples, prog.accum.clone(), img, prog.camera))
        return img

    prog.step = traced_step

    def get(path):
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=HTTP_TIMEOUT) as resp:
            return resp.status, resp.read()

    def closed(label):
        try:
            get("/stats")
        except OSError:
            return
        fail(f"viewer: the server still answers after {label}")

    def read_snapshot(want, label):
        with open(snapshot, "rb") as f:
            if not np.array_equal(decode_png(f.read()), want):
                fail(f"viewer: the snapshot {label} does not decode to the last image")

    target = VIEW_PASSES * VIEW_SPP
    reset_launches()
    img = prog.run(target_samples=target, snapshot_every=VIEW_SPP, out=snapshot,
                   serve_port=port)
    passes_k1 = k1_launches(read_launches(), "viewer passes")
    if passes_k1["closest_hit"] != trips[0]:
        fail(f"viewer: {passes_k1} K1 launches over passes that ran {trips[0]} trips")
    if ([s for s, _ in prog.pass_history] != [VIEW_SPP * (k + 1) for k in range(VIEW_PASSES)]
            or len(prog.block_history) != VIEW_PASSES or len(seen) != VIEW_PASSES):
        fail(f"viewer: run kept the passes {prog.pass_history}")
    pass_ms = [ms for _, ms in prog.pass_history]
    if img is not seen[-1][2]:
        fail("viewer: run did not return its last pass's image")
    if img.shape != (FRAME, FRAME, 3) or img.dtype != np.uint8 or not img.mean() > 1.0:
        fail(f"viewer: unexpected image {img.shape} {img.dtype} mean {img.mean()}")
    read_snapshot(img, "after the run")
    closed("the run")
    want = torch.zeros_like(prog.accum)
    for k, (_, got, _, _) in enumerate(seen):
        want = want + r.render_accum_offset(opt, sample_offset=k * VIEW_SPP)
        if not torch.equal(got, want):
            fail(f"viewer: the accumulator after pass {k + 1} is not the sum of its partials")
    one = r.render_accum_offset(replace(opt, spp=target))
    diff = (prog.accum - one).abs()
    if not bool((diff <= PROG_ATOL + PROG_RTOL * one.abs()).all()):
        fail(f"viewer: {VIEW_PASSES} passes differ from one {target}-spp "
             f"partial by up to {float(diff.max())}")

    def serve_and_move():
        """The second run's server, before its first pass: the first run's
        last image and passes, then a camera change."""
        status, data = get("/frame.png")
        if status != 200 or not np.array_equal(decode_png(data), img):
            fail("viewer: /frame.png does not decode to the last image")
        stats = json.loads(get("/stats")[1])
        if (len(stats["passes"]) != VIEW_PASSES or stats["blocks"][0]["height"] != FRAME
                or stats["accumulated_samples"] != target):
            fail(f"viewer: /stats is {stats}")
        if b"/frame.png" not in get("/")[1]:
            fail("viewer: / does not serve the viewer page")
        if get("/move?dir=forward&step=0.25")[0] != 204:
            fail("viewer: /move refused")
        served["png_bytes"] = len(data)

    served = {}
    before_pass[VIEW_PASSES] = serve_and_move
    moved_img = prog.run(target_samples=target + VIEW_SPP, snapshot_every=VIEW_SPP,
                         out=snapshot, serve_port=port)
    if before_pass or not served:
        fail("viewer: the second run made no pass")
    samples, accum, _, moved = seen[VIEW_PASSES]
    if samples != VIEW_SPP or np.array_equal(moved.position, seen[0][3].position):
        fail("viewer: the camera change did not reset the accumulation at a new camera")
    if not torch.equal(accum, r.render_accum_offset(opt, moved)):
        fail("viewer: the pass after /move is not a fresh render at the new camera")
    if prog.accumulated_samples != target + VIEW_SPP:
        fail(f"viewer: the second run ended at {prog.accumulated_samples} samples")
    read_snapshot(moved_img, "after the camera change")
    closed("the second run")
    encode_ms = []
    for _ in range(VIEW_PASSES):
        t0 = time.perf_counter()
        encode_png(img)
        encode_ms.append((time.perf_counter() - t0) * 1e3)

    small = replace(opt, width=DEBUG_CHECK, height=DEBUG_CHECK)
    P = r.closest.packed

    def plain_closest(S, *rays):
        return intersect_cuda.k1_plain(P, *rays, any_hit=False)

    def plain_any(S, *rays):
        return intersect_cuda.k1_plain(P, *rays, any_hit=True).mask

    debug = {}
    for ch in DEBUG_CHANNELS:
        got = render_debug(r, small, ch)
        plain = render_debug(r, small, ch, closest=plain_closest, any_hit=plain_any)
        if not torch.equal(got, plain):
            fail(f"viewer: debug channel {ch} through K1 differs from K1's plain version at "
                 f"{int((got != plain).any(-1).sum())} pixels")
        out, ms, counts = timed_runs(lambda: render_debug(r, opt, ch), 3)
        if out.shape != (FRAME, FRAME, 3) or not bool(torch.isfinite(out).all()):
            fail(f"viewer: debug channel {ch}: shape {tuple(out.shape)} or not finite")
        debug[ch] = {"ms": min(ms), "ms_all": ms, "launches": k1_launches(counts, f"debug {ch}"),
                     "mean": float(out.mean())}

    piped = default_pipeline().run(r, opt)
    if not np.array_equal(piped, r.render(opt)):
        fail("viewer: default_pipeline().run differs from render")
    png_path = os.path.join(SMOKE_DIR, "pipeline.png")
    chain = Pipeline(post_process=[denoise_stage(), tonemap_stage(), save_png_stage(png_path)])
    chained, chain_ms, _ = timed_runs(lambda: chain.run(r, opt), 1)
    with open(png_path, "rb") as f:
        if not np.array_equal(decode_png(f.read()),
                              (np.clip(chained, 0, 1) * 255).astype(np.uint8)):
            fail("viewer: the pipeline's PNG does not decode to its image")

    logdir = os.path.join(SMOKE_DIR, "trace")
    with trace(logdir) as prof:
        render_debug(r, opt, "emissive_vis")
        torch.cuda.synchronize()
    with open(os.path.join(logdir, TRACE_FILE)) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    named = sorted(n for n in names if n in ("polaris_closest_hit", "polaris_any_hit"))
    device_us = sum(getattr(a, "device_time_total", 0.0) for a in prof.key_averages())
    if named != ["polaris_any_hit", "polaris_closest_hit"] or not device_us > 0:
        fail(f"viewer: the trace names {named} and holds {device_us} us of device time")
    emit(
        "viewer", card=smi, scene="sphere", frame=f"{FRAME}x{FRAME}x{VIEW_SPP}spp a pass",
        passes=VIEW_PASSES, pass_ms=pass_ms, png_encode_ms=encode_ms,
        png_bytes=served["png_bytes"], pass_launches=passes_k1, pass_trips=trips[0],
        partials_equal=True, vs_one_partial_max_abs=float(diff.max()),
        server_port=port, move_reset_equal=True,
        moved_run_pass_ms=[ms for _, ms in prog.pass_history[VIEW_PASSES:]],
        debug_check=f"{DEBUG_CHECK}x{DEBUG_CHECK}",
        debug=debug, pipeline_equal=True, pipeline_chain_ms=chain_ms[0],
        trace_names=named, trace_device_ms=device_us / 1e3,
    )


def phase_parallel(scenes, smi: str):
    """The parallel layer at the flagship's full width (sphere 512x512,
    VIEW_SPP spp, 5 bounces, RR after 3, mode 'auto', the sequential sample
    loop, which bands run), through K1, on the one card: these times measure
    what each code path costs, not scaling.

    * Four bands of 128 rows, stacked, equal ``render_accum`` bit for bit.
    * A pool of two ``BandWorker``s on the card (``make_device_pool`` with the
      card named twice: a renderer and a stream each), POOL_FRAMES frames,
      each equal to the single renderer's bit for bit, every worker's time
      measured, K1's closest-hit launches = the trips the workers' graphs
      report; the heights feedback settles on.
    * ``make_mesh(4, 1)`` on the card four times equal to the single
      renderer bit for bit, ``make_mesh(2, 2)`` within MESH_RTOL.
    * The mesh's train step (2x2, TRAIN_FRAME^2, TRAIN_SPP spp, zero target,
      SGD at MESH_LR): the loss and the parameters against
      ``DifferentiableRenderer``'s loss and gradient with the same step.
    * ``spawn_local_processes``: two ``gloo`` ranks on the card (NCCL puts
      no two ranks on one card), render 2x1 equal to the single renderer bit
      for bit, and the train step 2x1 and 1x2 (the sample axis across the
      processes: a differentiable all-reduce) against the one-process mesh's
      of the same shape and the single device's; then one ``nccl`` rank.
    * Frame ms of the single renderer, the bands, the pool, the mesh and the
      processes; train step ms."""
    from dataclasses import replace

    from polaris_tpu_torch.asset.scene_data import PARAM_FIELDS
    from polaris_tpu_torch.parallel.mesh import DistributedRenderer, make_mesh
    from polaris_tpu_torch.parallel.multihost import spawn_local_processes
    from polaris_tpu_torch.parallel.workers import make_device_pool
    from polaris_tpu_torch.render.grad import DifferentiableRenderer
    from polaris_tpu_torch.render.integrator import TorchRenderer
    from polaris_tpu_torch.render.options import RenderOptions

    os.makedirs(SMOKE_DIR, exist_ok=True)
    sphere = scenes["sphere"]
    frame = dict(width=FRAME, height=FRAME, spp=VIEW_SPP, num_bounces=BOUNCES,
                 min_bounces_for_rr=RR_AFTER)
    opt = RenderOptions(**frame)
    single = TorchRenderer(sphere, mode="auto")
    card = single.device
    want = single.render_accum(opt)
    _, single_ms, single_counts = timed_runs(lambda: single.render_accum(opt), 3)
    per_frame = VIEW_SPP * BOUNCES

    rows = FRAME // 4

    def bands():
        return torch.cat([single.render_band_accum(opt, i * rows, rows) for i in range(4)])

    bands()  # captures the band program
    stacked, band_ms, band_counts = timed_runs(bands, 3)
    if not torch.equal(stacked, want):
        fail("parallel: four stacked bands differ from render_accum")
    band_k1 = k1_launches(band_counts, "bands")
    if band_k1["closest_hit"] != 4 * per_frame:
        fail(f"parallel: bands launched {band_counts}, expected {4 * per_frame} closest hits")

    pool = make_device_pool(sphere, mode="auto", devices=[card, card],
                            height_quantum=POOL_QUANTUM)
    pool_frames = []
    for k in range(POOL_FRAMES):
        got, ms, counts = timed_runs(lambda: pool.render_accum(opt), 1)
        stats = pool.frame_stats
        if not torch.equal(got.to(card), want):
            fail(f"parallel: pool frame {k} differs from the single renderer")
        if not all(w.render_time_ms > 0 for w in stats.workers if w.block_h):
            fail(f"parallel: pool frame {k} has a worker without a measured time")
        graph_trips = sum(w.renderer.last_trips_run
                          for w, s in zip(pool.workers, stats.workers) if s.block_h)
        launched = k1_launches(counts, f"pool frame {k}")
        if launched["closest_hit"] != graph_trips:
            fail(f"parallel: pool frame {k} launched {launched}, its workers' graphs "
                 f"ran {graph_trips} trips")
        pool_frames.append({
            "frame_ms": ms[0], "total_ms": stats.total_ms,
            "heights": [w.block_h for w in stats.workers],
            "worker_ms": [w.render_time_ms for w in stats.workers],
            "launches": launched, "graph_trips": graph_trips,
        })

    meshes = {}
    for tile, sample in ((4, 1), (2, 2)):
        dist = DistributedRenderer(sphere, make_mesh(tile, sample, [card] * (tile * sample)))
        dist.render_accum(opt)  # captures
        got, ms, counts = timed_runs(lambda: dist.render_accum(opt), 3)
        if tile == 4 and not torch.equal(got, want):
            fail("parallel: the 4x1 mesh differs from the single renderer")
        if not torch.allclose(got, want, rtol=MESH_RTOL, atol=0.0):
            fail(f"parallel: the {tile}x{sample} mesh differs from the single renderer by "
                 f"{float((got - want).abs().max())}")
        meshes[f"{tile}x{sample}"] = {
            "frame_ms": min(ms), "frame_ms_all": ms, "equal": bool(torch.equal(got, want)),
            "max_abs_diff": float((got - want).abs().max()),
            "launches": k1_launches(counts, f"mesh {tile}x{sample}"),
        }

    small = RenderOptions(**dict(frame, width=TRAIN_FRAME, height=TRAIN_FRAME, spp=TRAIN_SPP))
    target = np.zeros((TRAIN_FRAME, TRAIN_FRAME, 3), np.float32)
    ref = DifferentiableRenderer(sphere, mode="auto")
    ref_loss, grads, _ = ref.loss_and_grad(small, target)
    before = {k: ref.params[k].detach().clone() for k in PARAM_FIELDS}

    def against_ref(loss, params, label):
        """``loss`` and ``params`` after a step against the single-device
        loss and SGD step: loss within 1e-5 relative; each field within
        MESH_LR * GRAD_TOL of its largest |gradient| (atomics order the
        gradient's sums anew on every run), plus two float32 ulps of its
        largest value."""
        if abs(loss - ref_loss) > 1e-5 * abs(ref_loss):
            fail(f"{label}: loss {loss} against the single device's {ref_loss}")
        worst = 0.0
        for k in PARAM_FIELDS:
            step = before[k] - MESH_LR * grads[k]
            tol = (MESH_LR * GRAD_TOL * float(grads[k].abs().max())
                   + 2.0 ** -22 * float(before[k].abs().max()))
            d = float((torch.as_tensor(params[k], device=card) - step).abs().max())
            if d > tol:
                fail(f"{label}: {k} is {d} from the single device's step (> {tol})")
            worst = max(worst, d / tol if tol else 0.0)
        return worst

    mesh_train = DistributedRenderer(sphere, make_mesh(2, 2, [card] * 4))

    def train_step():
        return mesh_train.train_step(small, target, lr=MESH_LR)

    train_loss, train_ms, train_counts = timed_runs(train_step, 1)
    train_worst = against_ref(train_loss, mesh_train.params, "parallel: mesh train step")
    step_k1 = k1_launches(train_counts, "mesh train step")
    train_ms += timed_runs(train_step, 2)[1]  # two steps more, timed only

    scene_zip = os.path.join(SMOKE_DIR, "sphere.zip")
    sphere.save(scene_zip)
    spawned = {}
    train_frame = dict(frame, width=TRAIN_FRAME, height=TRAIN_FRAME, spp=TRAIN_SPP)
    gloo2 = dict(backend="gloo", devices=[str(card)] * 2)
    for label, tile, sample, kw in (
        ("gloo 2x1 render", 2, 1, dict(gloo2, opt_kwargs=frame, frames=3)),
        ("gloo 2x1 train", 2, 1, dict(gloo2, opt_kwargs=train_frame, job="train", frames=2)),
        ("gloo 1x2 train", 1, 2, dict(gloo2, opt_kwargs=train_frame, job="train", frames=2)),
        ("nccl 1x1 render", 1, 1, dict(backend="nccl", devices=[str(card)], opt_kwargs=frame,
                                       frames=3)),
    ):
        t0 = time.perf_counter()
        got = spawn_local_processes(
            scene_zip, num_processes=tile * sample, tile=tile, sample=sample,
            out_path=os.path.join(SMOKE_DIR, label.replace(" ", "_")), mode="auto",
            timeout=SPAWN_TIMEOUT, **kw,
        )
        wall_s = time.perf_counter() - t0
        row = {"frame_ms": float(min(got["ms"][1:])), "ms_all": got["ms"].tolist(),
               "wall_s": wall_s}
        if "train" in label:
            # against the one-process mesh's step of the same shape, and so
            # against the single device's
            ref_mesh = DistributedRenderer(sphere, make_mesh(tile, sample, [card] * 2))
            ref_mesh_loss = ref_mesh.train_step(small, target, lr=MESH_LR)
            row.update(loss=float(got["loss"]), one_process_loss=ref_mesh_loss,
                       one_process_worst_share_of_tol=against_ref(
                           ref_mesh_loss, ref_mesh.params,
                           f"parallel: {tile}x{sample} mesh train step"),
                       worst_share_of_tol=against_ref(
                           float(got["loss"]),
                           dict(ref_mesh.params, mat_reflectance=got["refl"]),
                           f"parallel: {label}"))
        elif not np.array_equal(got["accum"], want.cpu().numpy()):
            fail(f"parallel: {label} differs from the single renderer")
        spawned[label] = row

    emit(
        "parallel", card=smi, scene="sphere", frame=f"{FRAME}x{FRAME}x{VIEW_SPP}spp",
        note="one card: each time is the cost of its code path, not scaling",
        single_ms=min(single_ms), single_ms_all=single_ms,
        single_launches=k1_launches(single_counts, "single"),
        bands={"rows": rows, "frame_ms": min(band_ms), "frame_ms_all": band_ms,
               "launches": band_k1, "equal": True},
        pool={"workers": [w.name for w in pool.workers], "quantum": POOL_QUANTUM,
              "frames": pool_frames, "equal": True},
        mesh=meshes,
        train={"frame": f"{TRAIN_FRAME}x{TRAIN_FRAME}x{TRAIN_SPP}spp", "mesh": "2x2",
               "loss": train_loss, "single_loss": ref_loss, "step_ms": min(train_ms),
               "step_ms_all": train_ms, "worst_share_of_tol": train_worst,
               "launches": step_k1},
        processes=spawned,
    )


def phase_modes(scenes, smi: str):
    """The opt-in modes of the integrator and the traversal modes 'brute'
    and 'packet' (see the module docstring). The default renderer is the
    sequential loop (``regen=False``), which the three modes turn into."""
    from polaris_tpu_torch.ops.intersect import make_intersectors
    from polaris_tpu_torch.render.integrator import (
        TorchRenderer, _bucket_positions, _compact_pos, _inv_perm, _octant_key,
    )
    from polaris_tpu_torch.render.options import RenderOptions

    opt = RenderOptions(width=FRAME, height=FRAME, spp=MODES_SPP, num_bounces=BOUNCES,
                        min_bounces_for_rr=RR_AFTER)
    rows, k1_ms = {}, {}
    for name in ("sphere", "cornell"):
        renderers, want_accum, want_u8 = {}, None, None
        for flag in ("default",) + OPT_MODES:
            r = TorchRenderer(scenes[name], mode="auto",
                              **({} if flag == "default" else {flag: True}))
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            accum = r.render_accum(opt)  # a warm-up step, then the capture
            torch.cuda.synchronize()
            rows[f"{name}/{flag}"] = {
                "all_ms": [], "peak_mem_bytes": torch.cuda.max_memory_allocated(),
                "capture_s": r.capture_seconds,
            }
            if flag == "default":
                want_accum = accum
            elif not torch.equal(accum, want_accum):
                fail(f"modes: {name} with {flag}=True: the accumulator differs from the "
                     "sequential loop's")
            renderers[flag] = r
        # the modes' frames in turns, so that a change of the card's clock
        # reaches them all alike
        for _ in range(3):
            for flag, r in renderers.items():
                u8, ms, counts = timed_runs(lambda: r.render_u8(opt), 1)
                row = rows[f"{name}/{flag}"]
                row["all_ms"] += ms
                row["frame_ms"] = min(row["all_ms"])
                row["k1"] = k1_launches(counts, f"modes {name}/{flag}")
                if want_u8 is None:
                    want_u8 = u8
                elif not np.array_equal(u8, want_u8):
                    fail(f"modes: {name} with {flag}=True: the u8 image differs from the "
                         "sequential loop's")
        del renderers
        # K1 alone on this frame's rays in lane order, grouped by octant
        # (sort_rays) and with the live rays first (compact): ms a launch
        r = TorchRenderer(scenes[name], mode="auto")
        rays = frame_rays(r, FRAME, FRAME)
        for key, any_hit in SETS:
            o, d, maxt, active = rays[key]
            fn = r.any_hit if any_hit else r.closest
            orders = {
                "lane": None,
                "sort_rays": _inv_perm(_bucket_positions(_octant_key(d, active), 9)),
                "compact": _inv_perm(_compact_pos(active)),
            }
            for order, perm in orders.items():
                args = rays[key] if perm is None else tuple(
                    torch.index_select(x, 0, perm).contiguous() for x in rays[key]
                )
                k1_ms[f"{name}/{key}/{order}"] = time_ms(lambda: fn(r.S, *args), 20)

    # the traversal modes on cornell's frame of SMALL_FRAME^2
    base = TorchRenderer(scenes["cornell"], mode="auto")
    S = base.S
    rays = frame_rays(base, SMALL_FRAME, SMALL_FRAME)
    checks, steps = {}, []  # a graph frees its memory pool when it dies
    brute, brute_any = make_intersectors(S, "brute")
    dense, dense_any = make_intersectors(S, "pallas_dense")
    packet, _ = make_intersectors(S, "packet")
    for key, any_hit in (("primary", False), ("shadow", True)):
        o, d, maxt, active = rays[key]
        fn = brute_any if any_hit else brute
        res = {}
        step = base.step(lambda: res.update(out=fn(S, o, d, maxt, active)))
        steps.append(step)
        step()  # a warm-up, then the capture
        for x in (res["out"],) if any_hit else res["out"]:
            x.fill_(7)  # spoiled: the replay must rewrite it
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        replay_ms = (time.perf_counter() - t0) * 1e3
        ref = (dense_any if any_hit else dense)(S, o, d, maxt, active)
        checks[f"brute/{key}"] = dict(
            cross_check(res["out"], ref, any_hit, int(o.shape[0]),
                        f"modes: brute {key} against K5", "tol"),
            replay_ms=replay_ms,
        )
    o, d, maxt, active = rays["primary"]
    t0 = time.perf_counter()
    got = packet(S, o, d, maxt, active)
    torch.cuda.synchronize()
    packet_ms = (time.perf_counter() - t0) * 1e3
    ref = base.closest(S, o, d, maxt, active)
    checks["packet/primary"] = dict(
        cross_check(got, ref, False, int(o.shape[0]), "modes: packet primary against K1",
                    "tol"),
        host_ms=packet_ms,
    )
    emit("modes", card=smi, frame=f"{FRAME}x{FRAME}x{MODES_SPP}", frames=rows,
         k1_ms_by_order=k1_ms, traversal=checks)


def phase_cli(scenes, smi: str):
    """The command line (see the module docstring)."""
    import contextlib
    import io

    from polaris_tpu_torch import cli
    from polaris_tpu_torch.render.integrator import TorchRenderer
    from polaris_tpu_torch.render.options import RenderOptions

    os.makedirs(SMOKE_DIR, exist_ok=True)
    sphere_obj = os.path.join(HERE, "scenes", "sphere.obj")
    cornell_obj = os.path.join(HERE, "scenes", "cornell.obj")
    out = os.path.join(SMOKE_DIR, "cli_flagship.png")
    argv = ["render", "frame", sphere_obj, "--width", str(FRAME), "--height", str(FRAME),
            "--spp", str(VIEW_SPP), "--num-bounces", str(BOUNCES), "--rr-bounces",
            str(RR_AFTER), "--regen", "--out", out]
    t0 = time.perf_counter()
    run = subprocess.run([sys.executable, "-m", "polaris_tpu_torch.cli", *argv],
                         capture_output=True, text=True, cwd=HERE, timeout=600)
    wall_s = time.perf_counter() - t0
    if run.returncode != 0:
        fail(f"cli: render frame exited {run.returncode}: {run.stderr[-2000:]}")
    total = [line for line in run.stdout.splitlines() if line.startswith("TOTAL")]
    if not total:
        fail(f"cli: no stats table in {run.stdout[-2000:]}")
    opt = RenderOptions(width=FRAME, height=FRAME, spp=VIEW_SPP, num_bounces=BOUNCES,
                        min_bounces_for_rr=RR_AFTER)
    want = cli.quantize(TorchRenderer(scenes["sphere"], regen=True).render(opt))
    with open(out, "rb") as f:
        if not np.array_equal(decode_png(f.read()), want):
            fail("cli: the flagship PNG differs from the in-process render")
    flagship = {"table_total_ms": float(total[-1].split()[-2]), "subprocess_s": wall_s}

    def main(args):
        """``cli.main(args)`` in this process: (exit code, standard output,
        seconds, launch counts)."""
        buf = io.StringIO()
        reset_launches()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(args)
        seconds = time.perf_counter() - t0
        if rc != 0:
            fail(f"cli: {' '.join(args[:2])} exited {rc}")
        return buf.getvalue(), seconds, read_launches()

    snap = os.path.join(SMOKE_DIR, "cli_progressive.png")
    _, prog_s, prog_counts = main(
        ["render", "progressive", sphere_obj, "--width", str(FRAME), "--height", str(FRAME),
         "--spp", str(VIEW_SPP), "--target-spp", str(2 * VIEW_SPP), "--snapshot-every",
         str(VIEW_SPP), "--out", snap])
    with open(snap, "rb") as f:
        if decode_png(f.read()).shape != (FRAME, FRAME, 3):
            fail("cli: the progressive snapshot has the wrong shape")
    zip_path = os.path.join(SMOKE_DIR, "cornell.zip")
    text, _, _ = main(["scene", "compile", cornell_obj, "--out", zip_path])
    info, _, _ = main(["scene", "info", zip_path])
    devices, _, _ = main(["devices"])
    if "BVH nodes" not in text or "Triangles" not in info:
        fail("cli: scene compile / info printed no stats table")
    if torch.cuda.get_device_name(0) not in devices:
        fail(f"cli: devices does not name the card: {devices}")

    small = RenderOptions(width=SMALL_FRAME, height=SMALL_FRAME, spp=4, num_bounces=BOUNCES,
                          min_bounces_for_rr=RR_AFTER)
    modes = {}
    for mode in ("pallas8_nodes", "brute"):
        png = os.path.join(SMOKE_DIR, f"cli_{mode}.png")
        _, seconds, counts = main(
            ["render", "frame", zip_path, "--width", str(SMALL_FRAME), "--height",
             str(SMALL_FRAME), "--spp", "4", "--mode", mode, "--out", png])
        want = cli.quantize(TorchRenderer(scenes["cornell"], mode=mode).render(small))
        with open(png, "rb") as f:
            if not np.array_equal(decode_png(f.read()), want):
                fail(f"cli: the --mode {mode} PNG differs from TorchRenderer(mode={mode!r})")
        modes[mode] = {"seconds": seconds, "launches": counts}
    if "K2" not in modes["pallas8_nodes"]["launches"] or modes["brute"]["launches"]:
        fail(f"cli: --mode launches {modes}")
    emit("cli", card=smi, flagship=flagship, progressive_s=prog_s,
         progressive_k1=k1_launches(prog_counts, "cli progressive"), modes=modes)


# the traversals that read back to the host (phase readback): the frame, the
# loss step and the command line's frames, and the oracle's (phase oracle)
READBACK_MODES = ("bvh", "packet")
READBACK_LOSS_FRAME, READBACK_CLI_FRAME = 64, 64
ORACLE_FRAME, ORACLE_SPP, ORACLE_BOUNCES = 64, 2, 3
LOSS_RTOL = 1e-3


def phase_readback(scenes, smi: str):
    """The traversals 'bvh' and 'packet', whose loops read their test back to
    the host, on the card: a renderer runs their steps uncaptured, op by op,
    and launches no kernel.

    * Sphere at full width (512x512, 1 spp, 5 bounces, RR after 3), the
      sequential loop, through ``TorchRenderer(mode=m)`` on the card: each
      frame against K1's frame of the same options (``pixels_outside``), no
      step captured, no kernel launched; frame ms of the second frame.
    * ``DifferentiableRenderer(mode="bvh")``: one loss-and-gradient step on
      cornell 64x64, 2 spp, zero target: finite gradients, the loss within
      LOSS_RTOL of K1's step.
    * A pool of two workers on the card with mode 'bvh' (cornell 64x64, 2
      spp): equal to the single 'bvh' renderer bit for bit.
    * ``python -m polaris_tpu_torch.cli render frame scenes/cornell.obj
      --width 64 --height 64 --mode bvh`` on the default device, in a
      subprocess, and ``--mode packet`` through ``cli.main``: exit 0, each
      PNG equal to the in-process render of its mode."""
    import contextlib
    import io

    from polaris_tpu_torch import cli
    from polaris_tpu_torch.parallel.workers import make_device_pool
    from polaris_tpu_torch.render.grad import DifferentiableRenderer
    from polaris_tpu_torch.render.integrator import TorchRenderer
    from polaris_tpu_torch.render.options import RenderOptions

    os.makedirs(SMOKE_DIR, exist_ok=True)
    opt = RenderOptions(width=FRAME, height=FRAME, spp=1, num_bounces=BOUNCES,
                        min_bounces_for_rr=RR_AFTER)
    k1 = TorchRenderer(scenes["sphere"], mode="auto")
    want = k1.render_accum(opt)
    _, k1_ms, k1_counts = timed_runs(lambda: k1.render_accum(opt), 2)
    k1_launches(k1_counts, "readback K1 frame")
    frames = {"K1": {"frame_ms": k1_ms[-1], "all_ms": k1_ms}}
    for mode in READBACK_MODES:
        r = TorchRenderer(scenes["sphere"], mode=mode)
        if not r.reads_back:
            fail(f"readback: mode {mode!r} does not declare that it reads back")
        got, ms, counts = timed_runs(lambda: r.render_accum(opt), 2)
        if counts:
            fail(f"readback: mode {mode!r} launched {counts}")
        if any(s.graph is not None for p in r._programs.values() for s in p.steps):
            fail(f"readback: mode {mode!r} captured a step")
        frames[mode] = dict(pixels_outside(got.cpu(), want.cpu(), f"readback: {mode} frame"),
                            frame_ms=ms[-1], all_ms=ms)

    small = RenderOptions(width=READBACK_LOSS_FRAME, height=READBACK_LOSS_FRAME, spp=2,
                          num_bounces=BOUNCES, min_bounces_for_rr=RR_AFTER)
    loss = {}
    for mode in ("auto", "bvh"):
        d = DifferentiableRenderer(scenes["cornell"], mode=mode)
        target = torch.zeros((small.height, small.width, 3), device=d.device)
        (value, grads, cam), ms, counts = timed_runs(lambda: d.loss_and_grad(small, target), 1)
        if not all(torch.isfinite(g).all() for g in list(grads.values()) + list(cam.values())):
            fail(f"readback: the {mode} loss step's gradients are not finite")
        if mode == "bvh" and counts:
            fail(f"readback: the bvh loss step launched {counts}")
        loss[mode] = {"loss": value, "step_ms": ms[0]}
    rel = abs(loss["bvh"]["loss"] - loss["auto"]["loss"]) / abs(loss["auto"]["loss"])
    if not rel <= LOSS_RTOL:
        fail(f"readback: the bvh loss is {rel:.3g} off K1's (> {LOSS_RTOL})")

    single = TorchRenderer(scenes["cornell"], mode="bvh")
    alone = single.render_accum(small)
    pool = make_device_pool(scenes["cornell"], mode="bvh", devices=[single.device] * 2)
    got, pool_ms, _ = timed_runs(lambda: pool.render_accum(small), 1)
    if not torch.equal(got.to(single.device), alone):
        fail("readback: the bvh pool's frame differs from the single bvh renderer's")

    cornell_obj = os.path.join(HERE, "scenes", "cornell.obj")
    cli_opt = RenderOptions(width=READBACK_CLI_FRAME, height=READBACK_CLI_FRAME)
    out = os.path.join(SMOKE_DIR, "readback_bvh.png")
    t0 = time.perf_counter()
    run = subprocess.run(
        [sys.executable, "-m", "polaris_tpu_torch.cli", "render", "frame", cornell_obj,
         "--width", str(READBACK_CLI_FRAME), "--height", str(READBACK_CLI_FRAME),
         "--mode", "bvh", "--out", out],
        capture_output=True, text=True, cwd=HERE, timeout=600)
    cli_s = {"bvh": time.perf_counter() - t0}
    if run.returncode != 0:
        fail(f"readback: render frame --mode bvh exited {run.returncode}: {run.stderr[-2000:]}")
    out_packet = os.path.join(SMOKE_DIR, "readback_packet.png")
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        rc = cli.main(["render", "frame", cornell_obj, "--width", str(READBACK_CLI_FRAME),
                       "--height", str(READBACK_CLI_FRAME), "--mode", "packet",
                       "--out", out_packet])
    cli_s["packet"] = time.perf_counter() - t0
    if rc != 0:
        fail(f"readback: render frame --mode packet exited {rc}")
    for mode, png in (("bvh", out), ("packet", out_packet)):
        want_png = cli.quantize(TorchRenderer(scenes["cornell"], mode=mode).render(cli_opt))
        with open(png, "rb") as f:
            if not np.array_equal(decode_png(f.read()), want_png):
                fail(f"readback: the --mode {mode} PNG differs from the in-process render")
    emit("readback", card=smi, frame=f"{FRAME}x{FRAME}x1", frames=frames,
         loss_step={"frame": f"{READBACK_LOSS_FRAME}x{READBACK_LOSS_FRAME}x2", **loss,
                    "relative_diff": rel},
         pool_bvh_ms=pool_ms[0], cli_seconds=cli_s)


def phase_oracle(scenes, smi: str):
    """The NumPy oracle (``CpuRenderer``, on the host) against the card's K1
    frame (``mode="auto"``) of cornell and sphere at ORACLE_FRAME^2,
    ORACLE_SPP spp, ORACLE_BOUNCES bounces (``pixels_outside``); the
    oracle's host seconds."""
    from polaris_tpu_torch import CpuRenderer
    from polaris_tpu_torch.render.integrator import TorchRenderer
    from polaris_tpu_torch.render.options import RenderOptions

    opt = RenderOptions(width=ORACLE_FRAME, height=ORACLE_FRAME, spp=ORACLE_SPP,
                        num_bounces=ORACLE_BOUNCES)
    rows = {}
    for name in ("cornell", "sphere"):
        card = TorchRenderer(scenes[name], mode="auto").render_accum(opt).cpu()
        t0 = time.perf_counter()
        golden = CpuRenderer(scenes[name]).render_accum(opt)
        seconds = time.perf_counter() - t0
        rows[name] = dict(pixels_outside(card, golden, f"oracle: {name}"),
                          oracle_host_s=seconds)
    emit("oracle", card=smi, frame=f"{ORACLE_FRAME}x{ORACLE_FRAME}x{ORACLE_SPP}",
         bounces=ORACLE_BOUNCES, renders=rows)


# phase shade: the shading kernel (ops/shade_cuda.py) against its plain version
SHADE_FRAME = 256  # the bounce checks' frames of the small scenes
SHADE_BOUNCES = 3  # bounces held field by field
SHADE_ULPS = 0  # the tolerance: every field a later stage reads, bit for bit
SHADE_LOOP_SPP = 8
SHADE_TIME_FRAME = 1024  # the frame cells' lanes
SHADE_SCENES = ("sphere", "cornell", "instanced", "mitsuba", "dispersive", "coverage")
# the frame cells' scenes, checked at SHADE_TIME_FRAME^2 as well
SHADE_CELL_SCENES = ("sphere", "terrain819k")
SHADE_TIME_SCENES = ("sphere", "terrain819k", "mitsuba")
# bytes a lane reads and writes in one launch (csrc/shade_args.cuh's lane
# fields, int64 pixel), a hit's triangle rows (normals, material; the uvs
# where a surface samples a texture), and nee_add's lane
SHADE_LANE_BYTES = 94 + 94
SHADE_TRI_BYTES = 36 + 4
SHADE_UV_BYTES = 24
NEE_LANE_BYTES = 12 + 1 + 1 + 12 + 12


def ulp_gap(a, b):
    """|a - b| in units in the last place, lane by lane (float32)."""
    def ordered(x):
        i = x.contiguous().view(torch.int32).to(torch.int64)
        return torch.where(i < 0, -(i & 0x7FFFFFFF), i)

    return (ordered(a) - ordered(b)).abs()


def shade_field_gaps(got: dict, want: dict, label: str) -> dict:
    """Lanes whose field differs where a later stage reads it, and the
    largest gap in ulps, for every result; fails above SHADE_ULPS."""
    from polaris_tpu_torch.render.shade_check import MASKED_BY

    gaps = {}
    for k, g in got.items():
        w = want[k]
        if g.dtype == torch.float32:
            gap = ulp_gap(g, w)
        else:
            gap = (g != w).to(torch.int64)
        if gap.dim() > 1:
            gap = gap.max(dim=-1).values
        if k in MASKED_BY:
            gap = torch.where(want[MASKED_BY[k]], gap, 0)
        gaps[k] = {"lanes": int((gap > 0).sum()), "max_ulps": int(gap.max())}
    off = {k: v for k, v in gaps.items() if v["lanes"]}
    if any(v["max_ulps"] > SHADE_ULPS for v in off.values()):
        fail(f"{label}: the kernel's results differ from the plain version's: {off}")
    return off


def shade_compare(r, hit, kw, label: str) -> dict:
    """``shade_bounce`` and ``nee_add`` against their plain versions on one
    bounce's inputs, every result (``shade_field_gaps``)."""
    from polaris_tpu_torch.ops import shade_cuda
    from polaris_tpu_torch.render.shade import nee_add_plain, shade_bounce_plain

    rad_p, out_p = shade_bounce_plain(r.S, hit, **kw)
    rad_k, out_k = shade_cuda.shade_bounce(r.S, hit, **kw)
    got = dict(out_k, radiance=rad_k)
    want = dict({k: out_p[k] for k in out_k}, radiance=rad_p)
    row = {"hits": int(hit.mask.sum()), "shadow_rays": int(out_p["occl_mask"].sum()),
           "differing": shade_field_gaps(got, want, label)}
    if r.num_emissives > 0:
        occluded = r.any_hit(r.S, out_p["occl_o"], out_p["occl_d"], out_p["occl_maxt"],
                             out_p["occl_mask"])
        args = (out_p["occl_mask"], occluded, out_p["occl_value"])
        want_nee = nee_add_plain(rad_p, *args)
        got_nee = shade_cuda.nee_add(rad_p.clone(), *args)
        row["nee_add"] = shade_field_gaps({"radiance": got_nee}, {"radiance": want_nee},
                                          label + "/nee_add")
    return row


def shade_check(name, r, width: int, per_lane: bool) -> list:
    """The kernel against its plain version on the first SHADE_BOUNCES
    bounces of a ``width``^2 frame (``shade_check.shade_bounces``)."""
    from polaris_tpu_torch.render.shade_check import shade_bounces

    rows = []
    for b, hit, kw in shade_bounces(r, width, seed=7, per_lane=per_lane, bounces=SHADE_BOUNCES):
        label = f"shade/{name}/{width}/{'per_lane' if per_lane else 'scalar'}/bounce {b}"
        rows.append({"scene": name, "width": width, "per_lane": per_lane, "bounce": b,
                     **shade_compare(r, hit, kw, label)})
    return rows


class plain_shading:
    """Within it ``_trace_bounce`` shades through the plain version on the
    card too (``shade_cuda.takes_kernel`` answers no)."""

    def __enter__(self):
        from polaris_tpu_torch.ops import shade_cuda

        self.saved = shade_cuda.takes_kernel
        shade_cuda.takes_kernel = lambda S, *tensors: False

    def __exit__(self, *exc):
        from polaris_tpu_torch.ops import shade_cuda

        shade_cuda.takes_kernel = self.saved


def shade_loops(scenes) -> list:
    """Whole frames through the kernel against frames through the plain
    version, in the sequential, regeneration, compact and batch_samples
    loops (each a renderer of its own, from its CUDA graphs): equal
    accumulators, and so no pixel apart."""
    from polaris_tpu_torch.render.integrator import TorchRenderer
    from polaris_tpu_torch.render.options import RenderOptions

    opt = RenderOptions(width=SHADE_FRAME, height=SHADE_FRAME, spp=SHADE_LOOP_SPP,
                        num_bounces=BOUNCES, min_bounces_for_rr=RR_AFTER, seed=11)
    rows = []
    for name in ("sphere", "mitsuba", "dispersive"):
        for loop in ("sequential", "regen", "compact", "batch_samples"):
            flags = {} if loop == "sequential" else {loop: True}
            acc_k = TorchRenderer(scenes[name], **flags).render_accum(opt)
            with plain_shading():
                acc_p = TorchRenderer(scenes[name], **flags).render_accum(opt)
            label = f"shade loops/{name}/{loop}"
            img_k, img_p = (TorchRenderer.tonemap_u8(a, 1.0 / opt.spp, opt.exposure).cpu().numpy()
                            for a in (acc_k, acc_p))
            row = {"scene": name, "loop": loop, "accum_equal": bool(torch.equal(acc_k, acc_p)),
                   "accum_max_abs_diff": float((acc_k - acc_p).abs().max()),
                   **level_diff(img_k, img_p, label, 0.0)}
            if not row["accum_equal"]:
                fail(f"{label}: the kernel's accumulator differs from the plain version's: {row}")
            rows.append(row)
    return rows


def shade_launch_counts(scenes) -> dict:
    """``shade_bounce`` and ``nee_add`` launches of a frame cell's frame
    (sphere 1024^2 x 16 spp, 5 bounces, the sequential loop's graphs): spp x
    bounces each; and of a loss-and-gradient step: none (autograd records
    it, so it shades through the plain version)."""
    from polaris_tpu_torch.ops import shade_cuda
    from polaris_tpu_torch.render.grad import DifferentiableRenderer
    from polaris_tpu_torch.render.integrator import TorchRenderer
    from polaris_tpu_torch.render.options import RenderOptions

    opt = RenderOptions(width=SHADE_TIME_FRAME, height=SHADE_TIME_FRAME, spp=16,
                        num_bounces=BOUNCES, min_bounces_for_rr=RR_AFTER)
    r = TorchRenderer(scenes["sphere"])
    r.render_u8(opt)  # captures
    for k in shade_cuda.LAUNCHES:
        shade_cuda.LAUNCHES[k] = 0
    r.render_u8(opt)
    frame = dict(shade_cuda.LAUNCHES)
    want = opt.spp * opt.num_bounces
    if frame != {"shade_bounce": want, "nee_add": want}:
        fail(f"shade: a frame launched {frame}, expected {want} of each")
    small = RenderOptions(width=64, height=64, spp=2, num_bounces=BOUNCES,
                          min_bounces_for_rr=RR_AFTER)
    dr = DifferentiableRenderer(scenes["sphere"])
    target = np.zeros((64, 64, 3), np.float32)
    dr.loss_and_grad(small, target)  # captures
    for k in shade_cuda.LAUNCHES:
        shade_cuda.LAUNCHES[k] = 0
    dr.loss_and_grad(small, target)
    step = dict(shade_cuda.LAUNCHES)
    if any(step.values()):
        fail(f"shade: a loss-and-gradient step launched {step}, expected none")
    return {"frame": frame, "frame_expected": want, "loss_step": step}


def shade_timing(scenes) -> list:
    """The kernel's device ms on the first two bounces of a
    SHADE_TIME_FRAME^2 frame of the frame cells' scenes and of mitsuba
    (textured, every BxDF type but the conductors), against its byte bound
    and the plain version's ms (each ``time_ms``: launches replayed from a
    CUDA graph), with the results of the timed inputs held against the
    plain version's (``shade_compare``); ``nee_add`` too."""
    from polaris_tpu_torch.ops import shade_cuda
    from polaris_tpu_torch.render.integrator import TorchRenderer
    from polaris_tpu_torch.render.shade import nee_add_plain, shade_bounce_plain
    from polaris_tpu_torch.render.shade_check import shade_bounces

    rows = []
    for name in SHADE_TIME_SCENES:
        r = TorchRenderer(scenes[name])
        uv = bool(shade_cuda.statics_bits(r.S) & shade_cuda.STATIC_UV)
        for b, hit, kw in shade_bounces(r, SHADE_TIME_FRAME, seed=3, per_lane=False, bounces=2):
            n = hit.mask.shape[0]
            tris = int(torch.unique(hit.tri[hit.mask]).numel())
            nbytes = n * SHADE_LANE_BYTES + tris * (SHADE_TRI_BYTES + SHADE_UV_BYTES * uv)
            ms = time_ms(lambda: shade_cuda.shade_bounce(r.S, hit, **kw), 20)
            plain_ms = time_ms(lambda: shade_bounce_plain(r.S, hit, **kw), 2)
            checked = shade_compare(r, hit, kw, f"shade/timing/{name}/bounce {b}")
            _, out = shade_cuda.shade_bounce(r.S, hit, **kw)
            args = (out["occl_mask"], torch.zeros_like(out["occl_mask"]), out["occl_value"])
            rad = kw["radiance"].clone()
            nee_ms = time_ms(lambda: shade_cuda.nee_add(rad, *args), 20)
            nee_plain_ms = time_ms(lambda: nee_add_plain(rad, *args), 20)
            bound = nbytes / PEAK_BYTES_PER_S * 1e3
            nee_bound = n * NEE_LANE_BYTES / PEAK_BYTES_PER_S * 1e3
            rows.append({
                "scene": name, "reads_uv": uv, "bounce": b, "lanes": n,
                "distinct_triangles": tris, **checked,
                "ms": ms, "bound_ms": bound, "share_of_bound": bound / ms,
                "plain_ms": plain_ms, "speedup": plain_ms / ms,
                "nee_add_ms": nee_ms, "nee_add_bound_ms": nee_bound,
                "nee_add_share_of_bound": nee_bound / nee_ms, "nee_add_plain_ms": nee_plain_ms,
            })
    return rows


def shade_ptxas() -> list:
    """What the assembler reports for ``csrc/shade.cu`` built once more with
    ``-Xptxas -v`` and the package's flags: registers, stack frame and
    spills per entry point."""
    from polaris_tpu_torch.ops import _build, _launch, shade_cuda

    probe = os.path.join(_build.BUILD_DIR, "ptxas_probe_shade.so")
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    cmd = [_build._find_nvcc(), *_build.NVCC_FLAGS, *_launch.EXTRA_FLAGS, "-Xptxas", "-v",
           "-o", probe, os.path.join(_build.CSRC_DIR, shade_cuda.SOURCE)]
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    if res.returncode != 0:
        fail(f"shade: nvcc -Xptxas -v failed: {res.stderr}")
    return [ln.strip() for ln in (res.stdout + res.stderr).splitlines()
            if re.search(r"Compiling entry|Used \d+ registers|stack frame|spill", ln)]


def phase_shade(scenes, smi: str) -> list:
    """The shading kernel: registers and spills; every result of
    ``shade_bounce`` and ``nee_add`` against the plain version on the first
    SHADE_BOUNCES bounces of SHADE_FRAME^2 frames of the five benchmark
    scenes and ``coverage_scene``, and of SHADE_TIME_FRAME^2 frames of the
    frame cells' scenes (bit for bit, SHADE_ULPS), with Python-int counters
    and with per-lane ones; whole frames of the kernel against the plain
    version in four loops (equal accumulators); a frame's graphs against
    the eager loops (``graph_against_eager``, bit for bit); the launches of
    a frame and of a loss step; ms against the byte bound and the plain
    version at SHADE_TIME_FRAME^2. Returns the kernels line's entries of
    ``shade_bounce`` and ``nee_add``."""
    from polaris_tpu_torch.ops import shade_cuda
    from polaris_tpu_torch.render.integrator import TorchRenderer
    from polaris_tpu_torch.render.options import RenderOptions

    attrs = shade_cuda.attributes()
    checks = []
    for name in SHADE_SCENES:
        r = TorchRenderer(scenes[name])
        for per_lane in (False, True):
            checks += shade_check(name, r, SHADE_FRAME, per_lane)
    for name in SHADE_CELL_SCENES:
        r = TorchRenderer(scenes[name])
        for per_lane in (False, True):
            checks += shade_check(name, r, SHADE_TIME_FRAME, per_lane)
        del r
        torch.cuda.empty_cache()
    loops = shade_loops(scenes)
    graph_row, _, _ = graph_against_eager(
        TorchRenderer(scenes["mitsuba"], regen=True),
        RenderOptions(width=SHADE_FRAME, height=SHADE_FRAME, spp=SHADE_LOOP_SPP,
                      num_bounces=BOUNCES, min_bounces_for_rr=RR_AFTER),
        "shade/graph_against_eager", 1, 1,
    )
    counts = shade_launch_counts(scenes)
    timing = shade_timing(scenes)
    ptxas = shade_ptxas()
    emit("shade", card=smi, attributes=attrs, ptxas=ptxas, tolerance_ulps=SHADE_ULPS,
         bounces=checks, loops=loops,
         graph_against_eager={k: graph_row[k] for k in ("accum_equal", "u8_equal", "frame_ms",
                                                        "eager_frame_ms", "launches")},
         launches=counts, timing=timing)
    spills = [ln for ln in ptxas if re.search(r"[1-9]\d* bytes spill", ln)]
    if spills:
        fail(f"shade: the kernel spills: {spills}")
    # the kernels line: the frame cell's scene, bounce 0
    t = next(row for row in timing if row["scene"] == "sphere" and row["bounce"] == 0)
    common = dict(route="cuda", source="polaris_tpu_torch/csrc/shade.cu", replaces=None,
                  n_rays=t["lanes"], rays=f"sphere {SHADE_TIME_FRAME}x{SHADE_TIME_FRAME} bounce 0",
                  mismatched_lanes=0, bound_by="bytes")
    return [
        dict(common, name="shade_bounce", kernel="S", launches=counts["frame"]["shade_bounce"],
             ms=t["ms"], plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
             share_of_bound=t["share_of_bound"], **attrs),
        dict(common, name="nee_add", kernel="S", launches=counts["frame"]["nee_add"],
             ms=t["nee_add_ms"], plain_ms=t["nee_add_plain_ms"], bound_ms=t["nee_add_bound_ms"],
             share_of_bound=t["nee_add_share_of_bound"]),
    ]


# phase table_grad: the parameter tables' gradient kernel (ops/table_grad_cuda.py)
TG_LANES = FRAME * FRAME  # one sample's lanes at the loss step's frame
TG_REPS = 200  # launches a timing: about a loss step's
# (lanes, rows, width) held against the plain version: the loss step's tables
# at its lanes, ragged ends, and the largest tables the kernel takes
TG_CHECKS = ((1, 1, 1), (33, 2, 3), (4097, 17, 1), (TG_LANES, 3, 3), (TG_LANES, 3, 1),
             (TG_LANES, 2, 3), (TG_LANES, 2, 1), (300_000, 64, 3), (300_000, 1024, 1),
             (100_003, 1, 1024))
TG_TIMED = ((3, 3), (3, 1), (2, 3), (2, 1))  # the shapes of sphere's recorded gathers
TG_LANE_BYTES = 8  # an int64 index; and 4 B a column of gradient
# a kernel of a backward that adds with atomics, or scatters where it might
SCATTER_KERNELS = re.compile(r"indexFunc|scatter|index_put|indexing_backward|embedding|atomic",
                             re.I)


def as_bits(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().view(torch.int32).cpu()


def table_grad_ptxas() -> list:
    """What the assembler reports for ``csrc/table_grad.cu`` built once more
    with ``-Xptxas -v``: registers, stack frame and spills per kernel."""
    from polaris_tpu_torch.ops import _build, table_grad_cuda

    probe = os.path.join(_build.BUILD_DIR, "ptxas_probe_table_grad.so")
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    cmd = [_build._find_nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o", probe,
           os.path.join(_build.CSRC_DIR, table_grad_cuda.SOURCE)]
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    if res.returncode != 0:
        fail(f"table_grad: nvcc -Xptxas -v failed: {res.stderr}")
    return [ln.strip() for ln in (res.stdout + res.stderr).splitlines()
            if re.search(r"Compiling entry|Used \d+ registers|stack frame|spill", ln)]


def table_grad_timing(gen) -> list:
    """Device ms a call of the kernel and of ``index_add_`` (into zeros, as
    autograd adds) at TG_LANES lanes, on sphere's table shapes, with lanes on
    random rows and every lane on one; the byte bound (TG_LANE_BYTES and the
    gradient a lane, over PEAK_BYTES_PER_S)."""
    from polaris_tpu_torch.ops import table_grad_cuda as TG

    dev = torch.device("cuda")
    rows_out = []
    for rows, width in TG_TIMED:
        g = torch.randn((TG_LANES, width), generator=gen).to(dev)
        for pattern in ("random", "one_row"):
            if pattern == "random":
                idx = torch.randint(0, rows, (TG_LANES,), generator=gen).to(dev)
            else:
                idx = torch.zeros(TG_LANES, dtype=torch.long, device=dev)
            kernel_ms = time_ms(lambda: TG.table_grad(g, idx, rows), TG_REPS)
            index_add_ms = time_ms(
                lambda: torch.zeros((rows, width), device=dev).index_add_(0, idx, g), TG_REPS
            )
            bound_ms = TG_LANES * (TG_LANE_BYTES + 4 * width) / PEAK_BYTES_PER_S * 1e3
            rows_out.append({
                "rows": rows, "width": width, "lanes": TG_LANES, "pattern": pattern,
                "kernel_ms": kernel_ms, "index_add_ms": index_add_ms,
                "speedup": index_add_ms / kernel_ms, "bound_ms": bound_ms,
                "share_of_bound": bound_ms / kernel_ms,
                "call_ms": call_ms(lambda: TG.table_grad(g, idx, rows), TG_REPS),
            })
    TG.reset_launches()
    return rows_out


def phase_table_grad(sphere, smi: str) -> None:
    """The parameter tables' gradient kernel: registers and spills; the
    kernel against its plain version bit for bit, and two launches bit-equal,
    on TG_CHECKS, with its gap to ``index_add_``; ms a call against
    ``index_add_`` and the byte bound (``table_grad_timing``); then the loss
    step of phase grad (sphere FRAME^2, GRAD_SPP spp, through its graph): the
    kernel's calls a step and the fallbacks (none), whether two steps at one
    seed give every leaf's gradient bit for bit, and the kernels of a traced
    step that still scatter or add with atomics."""
    from collections import defaultdict

    from torch.autograd import DeviceType

    from polaris_tpu_torch.ops import table_grad_cuda as TG
    from polaris_tpu_torch.render.grad import DifferentiableRenderer
    from polaris_tpu_torch.render.options import RenderOptions

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(19)
    attrs = TG.attributes()
    checks = []
    for n, rows, width in TG_CHECKS:
        g = torch.randn((n, width), generator=gen)
        idx = torch.randint(0, rows, (n,), generator=gen)
        want = TG.table_grad_plain(g, idx, rows)
        gd, xd = g.to(dev), idx.to(dev)
        a, b = TG.table_grad(gd, xd, rows), TG.table_grad(gd, xd, rows)
        ref = torch.zeros((rows, width), device=dev).index_add_(0, xd, gd)
        scale = torch.zeros((rows, width), device=dev).index_add_(0, xd, gd.abs())
        row = {"lanes": n, "rows": rows, "width": width,
               "plain_equal": torch.equal(as_bits(a), as_bits(want)),
               "runs_equal": torch.equal(as_bits(a), as_bits(b)),
               "index_add_gap": float(((a - ref).abs() / scale.clamp(min=1e-30)).max())}
        if not (row["plain_equal"] and row["runs_equal"]):
            fail(f"table_grad: the kernel differs from its plain version or itself: {row}")
        checks.append(row)
    timing = table_grad_timing(gen)

    opt = RenderOptions(width=FRAME, height=FRAME, spp=GRAD_SPP, num_bounces=BOUNCES,
                        min_bounces_for_rr=RR_AFTER)
    target = np.zeros((FRAME, FRAME, 3), np.float32)
    r = DifferentiableRenderer(sphere, mode="auto")
    r.loss_and_grad(opt, target)  # captures
    TG.reset_launches()
    loss_a, grads_a, cam_a = r.loss_and_grad(opt, target)
    torch.cuda.synchronize()
    per_step = dict(TG.LAUNCHES)
    if per_step["table_grad_fallback"] or not per_step["table_grad"]:
        fail(f"table_grad: a loss step launched {per_step}")
    loss_b, grads_b, cam_b = r.loss_and_grad(opt, target)
    a, b = {**grads_a, **cam_a}, {**grads_b, **cam_b}
    leaves_equal = {k: torch.equal(as_bits(a[k]), as_bits(b[k])) for k in a}
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        r.loss_and_grad(opt, target)
        torch.cuda.synchronize()
    scatter = defaultdict(lambda: [0, 0.0])
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and SCATTER_KERNELS.search(e.name):
            scatter[e.name[:160]][0] += 1
            scatter[e.name[:160]][1] += (e.time_range.end - e.time_range.start) * 1e-3
    del r
    torch.cuda.empty_cache()
    emit("table_grad", card=smi, attributes=attrs, ptxas=table_grad_ptxas(), checks=checks,
         timing=timing, step={
             "scene": "sphere", "frame": f"{FRAME}x{FRAME}x{GRAD_SPP}spp",
             "launches": per_step, "losses_equal": loss_a == loss_b,
             "leaves_equal": leaves_equal,
             "scatter_kernels": {k: {"launches": n, "ms": ms} for k, (n, ms) in scatter.items()},
         })
    TG.reset_launches()


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    # before anything is printed: without the package beside this script the
    # run ends here, non-zero, with an empty standard output
    from polaris_tpu_torch import native
    from polaris_tpu_torch.asset.compiler.compiler import compile_scene
    from polaris_tpu_torch.asset.procedural import make_terrain_scene
    from polaris_tpu_torch.ops import _build, _launch, shade_cuda, table_grad_cuda
    from polaris_tpu_torch.render.shade_check import coverage_scene

    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    # every renderer below names its triangle test or means the default one
    os.environ.pop("POLARIS_TRI_TEST", None)
    smi = nvidia_smi_line()
    emit(
        "device", card=smi, torch=torch.__version__, cuda=torch.version.cuda,
        kind=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
    )

    sources = [module_of(fam).SOURCE for fam in FAMILIES] + [shade_cuda.SOURCE]
    t0 = time.perf_counter()
    seconds = _build.build_libraries(sources, _launch.EXTRA_FLAGS)
    for fam in FAMILIES:
        module_of(fam).load()
    shade_cuda.load()
    seconds.update(_build.build_libraries([table_grad_cuda.SOURCE]))
    table_grad_cuda.load()
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
        ("mitsuba", lambda: load_scene("mitsuba")),
        ("dispersive", lambda: load_scene("dispersive")),
        ("coverage", lambda: coverage_scene(os.path.join(HERE, "scenes"))),
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
            for name in scenes if name not in ("dispersive", "coverage")
        }
        # and the frames of the configurations that are not among these
        for name, width, _, _ in CONFIGS:
            key = config_rays(ctx, name, width)
            if key not in ctx:
                ctx[key] = SceneRays(name, scenes[name], width)
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
        phase_golden(scenes)
        phase_flagship(scenes["sphere"])
        launches = phase_bigscene(scenes["terrain819k"], scenes["cornell"], smi)
        # this slice's path; K1's counts in the kernels line are read here,
        # around one frame of the flagship configuration per triangle test
        k1 = phase_configs(scenes, smi)
        launches["K1"] = launches["K1hh"] = k1
        shade_entries = phase_shade(scenes, smi)
        phase_adaptive(scenes["cornell"], smi)
        phase_grad(scenes, smi)
        phase_table_grad(scenes["sphere"], smi)
        phase_denoise(scenes["cornell"], smi)
        phase_viewer(scenes, smi)
        phase_parallel(scenes, smi)
        phase_modes(scenes, smi)
        phase_cli(scenes, smi)
        phase_readback(scenes, smi)
        phase_oracle(scenes, smi)
    for e in entries.values():
        e["launches"] = launches[e["kernel"]][
            FAMILIES[e["kernel"]]["keys"][1 if e["any_hit"] else 0]
        ]
        if e["launches"] <= 0:
            fail(f"kernel entry point {e['name']} was never launched by a render path")
    entries.update((e["name"], e) for e in shade_entries)
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
