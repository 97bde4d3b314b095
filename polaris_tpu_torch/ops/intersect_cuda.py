"""K1, the binary traversal kernel (``csrc/intersect.cu``): its packed scene,
its plain PyTorch version and its PyTorch wrappers.

``pack_scene_k1`` lays the scene out once, on the host, as the kernel reads
it: ONE buffer of 16-byte words (int32 here, float bits where a float is
stored):

  * a 64-byte record per node, in the scene's own node order (the plain
    version's): ``[ld, rd, left box min, left box max, right box min, right
    box max, 0, 0]``, ``ld`` and ``rd`` as int bits, the boxes those of the
    node's two children (zero in a leaf's record), so one record serves both
    slab tests of an inner node
  * a 48-byte row per triangle in the leaf form's own layout: ``[v0, 0, e1,
    0, e2, 0]`` for det²-scaled Möller–Trumbore (``"det2"``), the Havel–Herout
    row ``[N, d0, N1, d1, N2, d2]`` of ``pack_tris_hh`` for ``"hh"``
  * a 64-byte row per instance: rows 0-2 of the world->object matrix, then
    the instance's BLAS root as int bits, ``0, 0, 0``

with ``stack_need``, the most entries a ray's stack can hold in this tree,
and ``staging``: ``"shared"`` when the buffer and the blocks' stacks fit in
the shared memory of one block (``SMEM_BUDGET``), so every block of the
kernel copies the scene there first, else ``"global"``. The roots' own boxes
(node 0, the BLAS roots) are read by no traversal and are not packed.

The kernel runs the persistent schedule of ``csrc/traverse_common.cuh``,
which K2 and K3 share; they read buffers of their own in the same 16-byte words
(``intersect_wide8_nodes.pack_scene_k2``, ``intersect_nodes.pack_scene_k3``,
built from ``det2_rows`` and ``instance_rows`` here), staged by the same rule
(``staging_words``). The kernels of one stream share their two counters
(``_launch.persistent_counters``).

``k1_plain`` is the PLAIN VERSION: the binary lock-step traversal of
``ops/intersect.py`` (``traverse_binary``) reading the packed buffer; it
equals ``intersect_bvh(S, ..., leaf=...)`` bit for bit, since the buffer
holds the scene's own bits.

Four entry points, with the signature ``(P, o, d, maxt, active)`` of a packed
scene ``P`` (``o, d`` [N,3] f32, ``maxt`` [N] f32, ``active`` [N] bool):
``closest_hit`` / ``any_hit`` on a scene packed for ``"det2"``,
``closest_hit_hh`` / ``any_hit_hh`` on one packed for ``"hh"``.
``intersectors(S, tri_test)`` packs an uploaded scene once and returns the
pair with the integrator's signature ``(S, o, d, maxt, active)``.

On CUDA tensors a wrapper launches the kernel on PyTorch's current stream —
outputs allocated with ``torch.empty``, no synchronisation — or raises. On
CPU tensors (and only then) it runs the plain version, which the CPU tests
use. ``LAUNCHES`` counts kernel launches per entry point, and nothing else.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from . import _launch
from .intersect import (
    STACK_SIZE,
    BinaryLayout,
    HHRows,
    Hit,
    TriArrays,
    host_geometry,
    pack_tris_hh,
    traverse_binary,
)

SOURCE = "intersect.cu"

LAUNCHES = {"closest_hit": 0, "any_hit": 0, "closest_hit_hh": 0, "any_hit_hh": 0}

# 32-bit words per node record, triangle row and instance row
NODE_WORDS, TRI_WORDS, INST_WORDS = 16, 12, 16
# threads per block of the kernel (K1_THREADS in csrc/intersect.cu)
THREADS = 512
# the shared memory one block may use on an H100 (227 KB, after opting in),
# less 1 KB kept for the kernel's static shared memory
SMEM_BUDGET = 232_448 - 1_024
# threads per block, and rays per window, of K4's and K5's block-local
# schedule (BLOCK_RAYS in csrc/traverse_block.cuh)
BLOCK_THREADS = 256
# the most shared memory a block of that schedule takes to stage its buffer
# beside its stacks: on the H100 buffers of 62-143 KB (sphere, mitsuba) read
# faster from L1 than copied by every block, at most three blocks per SM,
# while cornell's and instanced's (3-47 KB) read faster staged (PERF.md)
BLOCK_STAGE_BYTES = 48 * 1024

LEAVES = {"mt": "det2", "hh": "hh"}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def stack_need(scene) -> int:
    """The most entries a ray's stack can hold: the most inner nodes on one
    path from the TLAS root down to a BLAS leaf (an inner node pushes at most
    one entry, its far child, and a pop takes the stack back to a node's
    ancestors). The plain version and the kernel clamp at ``STACK_SIZE``."""
    ld = scene.bvh_ldata.astype(np.int64).tolist()
    rd = scene.bvh_rdata.astype(np.int64).tolist()
    roots = scene.inst_bvh_root.astype(np.int64).tolist()
    n, last_inst = len(ld), len(roots) - 1

    def children(v):
        if ld[v] > 0:
            return ld[v], rd[v]
        if rd[v] == 0:  # TLAS leaf -> the instance's BLAS root
            return (roots[min(max(-ld[v], 0), last_inst)],)
        return ()

    height = [-1] * n  # inner nodes on the deepest path below a node, inclusive
    todo, steps = [0], 0
    while todo:
        steps += 1
        if steps > 4 * n + 8:
            raise ValueError("the BVH has a cycle")
        v = todo[-1]
        kids = children(v)
        if any(k < 0 or k >= n for k in kids):
            raise ValueError(f"node {v} points outside the {n} nodes")
        pending = [k for k in kids if height[k] < 0]
        if pending:
            todo.extend(pending)
            continue
        todo.pop()
        height[v] = (1 if ld[v] > 0 else 0) + max((height[k] for k in kids), default=0)
    return height[0]


def staging(num_nodes: int, num_tris: int, num_inst: int, stack_cap: int):
    """``("shared" | "global", bytes)``: the shared memory a block needs for
    the packed scene and its threads' stacks, and whether that fits in
    ``SMEM_BUDGET`` so the scene is staged there. The stacks alone always
    live in shared memory."""
    scene = 4 * (NODE_WORDS * num_nodes + TRI_WORDS * num_tris + INST_WORDS * num_inst)
    return staging_words(scene // 16, stack_cap)


def staging_words(num_words: int, stack_cap: int):
    """The same rule for any buffer of ``num_words`` 16-byte words (K1's,
    and K2's and K3's own buffers, which run the same schedule)."""
    need = 16 * num_words + 4 * stack_cap * THREADS
    return ("shared" if need <= SMEM_BUDGET else "global"), need


def block_staging(num_words: int, stack_cap: int):
    """K4's and K5's rule (the block-local schedule of
    ``csrc/traverse_block.cuh``): ``("shared" | "global", bytes)``, the
    shared memory a block needs for a buffer of ``num_words`` words and
    ``BLOCK_THREADS`` stacks of ``stack_cap`` entries, and whether that is at
    most ``BLOCK_STAGE_BYTES``, so the buffer is staged there."""
    need = 16 * num_words + 4 * stack_cap * BLOCK_THREADS
    return ("shared" if need <= BLOCK_STAGE_BYTES else "global"), need


def det2_rows(v0, e1, e2) -> np.ndarray:
    """48-byte triangle rows ``[v0, 0, e1, 0, e2, 0]`` (f32 [T,12]) of the
    det²-scaled leaf form, read as three 16-byte words."""
    rows = np.zeros((v0.shape[0], TRI_WORDS), np.float32)
    rows[:, 0:3], rows[:, 4:7], rows[:, 8:11] = v0, e1, e2
    return rows


def instance_rows(w2o12, head) -> np.ndarray:
    """64-byte instance rows (int32 [I,16]): the 12 floats of the 3x4
    world->object matrix as bits, then the ints of ``head`` ([I] or [I,k]: a
    BLAS root node, K2's or K4's instance entry, K5's first triangle and
    count), zeros after them."""
    rows = np.zeros((w2o12.shape[0], INST_WORDS), np.int32)
    rows.view(np.float32)[:, :12] = np.asarray(w2o12, np.float32)
    head = np.asarray(head).astype(np.int32).reshape(w2o12.shape[0], -1)
    rows[:, 12:12 + head.shape[1]] = head
    return rows


def pack_scene_k1(scene, leaf: str) -> Dict:
    """K1's packed scene (see the module docstring) from the host arrays of
    a compiled scene, for the leaf form ``leaf`` (``"det2"`` or ``"hh"``)."""
    if leaf not in ("det2", "hh"):
        raise ValueError(f"K1 runs leaf='det2' or 'hh', not {leaf!r}")
    ld = scene.bvh_ldata.astype(np.int32)
    rd = scene.bvh_rdata.astype(np.int32)
    n, t, i = ld.shape[0], scene.tri_v0.shape[0], scene.inst_w2o.shape[0]
    if n == 0 or t == 0 or i == 0 or rd.shape[0] != n or scene.inst_bvh_root.shape[0] != i:
        raise ValueError("scene needs nodes, triangles and instances of matching lengths")
    need = stack_need(scene)
    nodes = np.zeros((n, NODE_WORDS), np.int32)
    boxes = nodes.view(np.float32)
    nodes[:, 0], nodes[:, 1] = ld, rd
    inner = ld > 0
    lc, rc = ld[inner], rd[inner]
    bmin = scene.bvh_min.astype(np.float32)
    bmax = scene.bvh_max.astype(np.float32)
    boxes[inner, 2:5], boxes[inner, 5:8] = bmin[lc], bmax[lc]
    boxes[inner, 8:11], boxes[inner, 11:14] = bmin[rc], bmax[rc]
    if leaf == "hh":
        tris = pack_tris_hh(scene).reshape(t, TRI_WORDS)
    else:
        tris = det2_rows(scene.tri_v0, scene.tri_e1, scene.tri_e2)
    inst = instance_rows(scene.inst_w2o[:, :3, :].reshape(i, 12), scene.inst_bvh_root)
    cap = max(1, min(need, STACK_SIZE))
    where, smem = staging(n, t, i, cap)
    return {
        "k1_words": np.concatenate([nodes.ravel(), tris.view(np.int32).ravel(), inst.ravel()]),
        "leaf": leaf, "num_nodes": n, "num_tris": t, "num_inst": i,
        "tri_at": n * NODE_WORDS // 4, "inst_at": (n * NODE_WORDS + t * TRI_WORDS) // 4,
        "stack_need": need, "stack_cap": cap, "staging": where, "smem_bytes": smem,
    }


def upload_k1(packed: Dict, device) -> Dict:
    """The packed scene on ``device``, its buffer checked once here: the
    wrappers then check only the rays."""
    P = _launch.upload_packed(packed, device)
    words = P["k1_words"]
    _launch.check("k1_words", words, torch.int32, 1, torch.device(device))
    n_words = NODE_WORDS * P["num_nodes"] + TRI_WORDS * P["num_tris"] + INST_WORDS * P["num_inst"]
    if words.numel() != n_words:
        raise ValueError(f"k1_words: {words.numel()} words, expected {n_words}")
    return P


def _views(P):
    """(node records [N,16] int32, triangle rows [T,12] f32, instance rows
    [I,16] int32) of a packed scene."""
    words = P["k1_words"]
    a, b = 4 * P["tri_at"], 4 * P["inst_at"]
    return (
        words[:a].view(-1, NODE_WORDS),
        words[a:b].view(torch.float32).view(-1, TRI_WORDS),
        words[b:].view(-1, INST_WORDS),
    )


def k1_layout(P) -> BinaryLayout:
    """The packed buffer as the binary traversal reads it."""
    rec, rows, inst = _views(P)
    box = rec.view(torch.float32)

    def fetch(node):
        r, b = rec[node], box[node]
        return (
            r[:, 0].to(torch.int64), r[:, 1].to(torch.int64),
            b[:, 2:5], b[:, 5:8], b[:, 8:11], b[:, 11:14],
        )

    if P["leaf"] == "hh":
        tris = HHRows(rows)
    else:
        tris = TriArrays(rows[:, 0:3], rows[:, 4:7], rows[:, 8:11])
    w2o = inst.view(torch.float32)[:, :12].reshape(-1, 3, 4)
    return BinaryLayout(fetch, tris, w2o, inst[:, 12], int(rec.shape[0]))


def k1_plain(
    P, o, d, maxt, active, *, any_hit: bool, stats: Optional[dict] = None
) -> Hit:
    """The plain version of K1 on the packed scene ``P``, in its leaf form."""
    return traverse_binary(
        k1_layout(P), o, d, maxt, active, any_hit=any_hit, stats=stats, leaf=P["leaf"]
    )


_LIB = None


def load():
    """Build (first use) and bind the kernel library; cached per process.
    Returns ``(closest_hit, any_hit, closest_hit_hh, any_hit_hh)``."""
    global _LIB
    if _LIB is None:
        scene = "p" + "i" * 7 + "p"
        _LIB = _launch.bind(
            SOURCE, "polaris_closest_hit", "polaris_any_hit", scene
        ) + _launch.bind(
            SOURCE, "polaris_closest_hit_hh", "polaris_any_hit_hh", scene
        )
    return _LIB


def _check_leaf(P, leaf: str) -> None:
    if P["leaf"] != leaf:
        raise ValueError(f"scene packed for leaf={P['leaf']!r}, this entry runs {leaf!r}")


def _scene_args(P, device):
    """The kernel's scene arguments for rays on ``device``, with the counters
    of the stream it launches on."""
    words = P["k1_words"]
    if words.device != device:
        raise ValueError(f"k1_words: on {words.device}, the rays on {device}")
    return [
        words.data_ptr(), words.numel() // 4, P["num_tris"], P["num_inst"],
        P["tri_at"], P["inst_at"], P["stack_cap"], int(P["staging"] == "shared"),
        _launch.persistent_counters(device).data_ptr(),
    ]


def _closest(entry: int, key: str, leaf: str, P, o, d, maxt, active) -> Hit:
    _check_leaf(P, leaf)
    if o.device.type != "cuda":
        return k1_plain(P, o, d, maxt, active, any_hit=False)
    hit = _launch.run_closest(load()[entry], _scene_args(P, o.device), o, d, maxt, active)
    _launch.count(LAUNCHES, key)
    return hit


def _any(entry: int, key: str, leaf: str, P, o, d, maxt, active) -> torch.Tensor:
    _check_leaf(P, leaf)
    if o.device.type != "cuda":
        return k1_plain(P, o, d, maxt, active, any_hit=True).mask
    found = _launch.run_any(load()[entry], _scene_args(P, o.device), o, d, maxt, active)
    _launch.count(LAUNCHES, key)
    return found


def closest_hit(P, o, d, maxt, active) -> Hit:
    """Closest hit per ray, det²-scaled Möller–Trumbore (plain version on CPU)."""
    return _closest(0, "closest_hit", "det2", P, o, d, maxt, active)


def any_hit(P, o, d, maxt, active) -> torch.Tensor:
    """Occlusion mask per ray, det²-scaled Möller–Trumbore (plain version on CPU)."""
    return _any(1, "any_hit", "det2", P, o, d, maxt, active)


def closest_hit_hh(P, o, d, maxt, active) -> Hit:
    """Closest hit per ray, Havel–Herout test (plain version on CPU)."""
    return _closest(2, "closest_hit_hh", "hh", P, o, d, maxt, active)


def any_hit_hh(P, o, d, maxt, active) -> torch.Tensor:
    """Occlusion mask per ray, Havel–Herout test (plain version on CPU)."""
    return _any(3, "any_hit_hh", "hh", P, o, d, maxt, active)


def intersectors(S, tri_test: str):
    """``(closest_hit, any_hit)`` with the integrator's signature for the
    uploaded scene ``S``, packed here once for ``tri_test`` (``"mt"`` or
    ``"hh"``), on the host, and uploaded to the scene's device
    (``closest.packed``; with ``"hh"`` also ``closest.tris_hh``, the flat
    Havel–Herout rows)."""
    leaf = LEAVES[tri_test]
    P = upload_k1(pack_scene_k1(host_geometry(S), leaf), S["tri_v0"].device)
    c_fn, a_fn = (closest_hit_hh, any_hit_hh) if leaf == "hh" else (closest_hit, any_hit)

    def closest(S, o, d, maxt, active):
        return c_fn(P, o, d, maxt, active)

    def occluded(S, o, d, maxt, active):
        return a_fn(P, o, d, maxt, active)

    closest.packed = P
    if leaf == "hh":
        closest.tris_hh = _views(P)[1].reshape(-1)
    return closest, occluded
