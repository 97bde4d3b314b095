"""K2, 8-wide BVH traversal over 64-float node records, the kernel of the
big-scene path: packer, plain PyTorch version and the wrappers of the CUDA
kernel ``csrc/intersect_wide8_nodes.cu``.

Counterpart of the JAX package's ``ops/intersect_pallas8_nodes.py``
(``_collapse_wide``, ``_wide_depth``, ``pack_scene8_nodes``,
``intersect_pallas8_nodes``, TPU kernel ``_kernel``). What is kept is the
node layout, the entry encoding and the child order:

  * the same SAH-greedy 8-wide collapse as ``ops/intersect_wide8.py``, with
    instances that share a BLAS sharing its wide subtree
  * ``entry = typ<<30 | count<<24 | index`` (typ 0 empty, 1 wide node,
    2 triangle leaf, 3 instance): 24-bit indices, counts below 64; typ 2 and
    3 set bit 31, so an entry is a NEGATIVE int32 and is decoded unsigned
  * wide nodes renumbered by BFS depth (an instance's subtree inherits its
    depth from the entry that enters it)
  * one 64-float record per node: ``boxes(48)`` then ``(lo, hi) x 8``, each
    entry split into two exact small floats, ``lo = index``,
    ``hi = typ*64 + count``

The traversal's plain version is ``ops/intersect_wide8.py::traverse_wide``
with this layout's fetch and decoder. The leaf test is the TPU kernel's own:
det²-scaled Möller–Trumbore (``leaf="det2"``,
``ops/intersect.py::mt_block_det2``), where the 8-wide kernel with resident
nodes divides per triangle.

``pack_scene8_nodes`` equals the JAX packer array for array, but for the keys
it DROPS because they only stage data for the TPU's memories:
``p8n_res_entry``, ``p8n_res_boxes`` and ``p8n_resident`` (the node prefix
kept resident in SMEM) and the ``STREAM_ALIGN`` padding at the end of
``p8n_nodes`` and ``p8n_tris`` (DMA windows). Kept, bit for bit:
``p8n_nodes`` (unpadded), ``p8n_tris`` (unpadded), ``p8n_w2o``, ``p8n_root``,
``p8n_inst_entry``. Added: the plain ints ``root_entry`` and ``stack_need``
(see ``ops/intersect_wide8.py``).

``pack_scene_k2`` builds, beside those arrays, the buffer the kernel reads
(``csrc/intersect_wide8_nodes.cu``), one buffer of 16-byte words:

  * a 224-byte record per wide node, in the same depth order: the 48 box
    floats as twelve words (children ``2p`` and ``2p+1`` in words
    ``3p .. 3p+2``), then the 8 entries as two words of ready
    ``typ<<30 | count<<24 | index`` ints in place of the float pairs
    ``(lo, hi)``
  * 48-byte triangle rows ``[v0, 0, e1, 0, e2, 0]`` and 64-byte instance
    rows ``[3x4 matrix, the instance's entry, 0, 0, 0]``

with the stack the kernel gives each thread (``stack_need``, clamped at
``STACK_SIZE`` as the plain version clamps) and K1's staging rule
(``intersect_cuda.staging_words``): the whole buffer in shared memory when
it fits beside the stacks, else read through L1 and L2. The kernel runs K1's
persistent schedule (``csrc/traverse_common.cuh``) over that buffer. The TPU
kernel's resident prefix has no counterpart: kept in shared memory it read
slower than L1 does (PERF.md).

On CUDA tensors the wrappers launch the kernel on ``P["k2_words"]`` or raise;
they take the plain version only for CPU tensors. ``LAUNCHES`` counts kernel
launches.
"""

from __future__ import annotations

from collections import deque
from typing import Dict, Optional

import numpy as np
import torch

from . import _launch
from .intersect import Hit, packed_tris
from .intersect_cuda import det2_rows, instance_rows, staging_words
from .intersect_wide8 import (
    STACK_SIZE,
    T_TOP,
    T_WIDE,
    WIDTH,
    WideLayout,
    check_stack,
    collapse_wide,
    packed_common,
    traverse_wide,
    wide_stack_need,
)

SOURCE = "intersect_wide8_nodes.cu"
REC = 64  # f32 slots per wide-node record

# 16-byte words of one of the kernel's own records: 12 of boxes, 2 of entries
REC_WORDS = 14

LAUNCHES = {"closest_hit": 0, "any_hit": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def entry24(typ: int, index: int, count: int = 0) -> int:
    """The entry's UNSIGNED 32-bit value (``_as_i32`` gives the stored one)."""
    if not (0 <= index < (1 << 24) and 0 <= count < (1 << 6) and 0 <= typ < 4):
        raise ValueError(f"entry out of range: typ {typ}, index {index}, count {count}")
    return (typ << 30) | (count << 24) | index


def unpack24(e):
    """(typ, cnt, idx) of 30/24-bit entries given as unsigned values or as
    int32 (the masks undo the sign extension); ints, arrays or tensors."""
    return (e >> 30) & 0x3, (e >> 24) & 0x3F, e & 0xFFFFFF


def _as_i32(e: np.ndarray) -> np.ndarray:
    """Unsigned 32-bit values in int64 -> the int32 that holds those bits."""
    return e.astype(np.uint32).view(np.int32)


def wide_depth(entries, root_entry, inst_entry) -> np.ndarray:
    """BFS depth of every wide node; instance subtrees inherit depth from
    the entry that enters them."""
    typ, _, idx = (a.tolist() for a in unpack24(entries))
    i_typ, _, i_idx = (a.tolist() for a in unpack24(inst_entry))
    unseen = int(np.iinfo(np.int32).max)
    depth = [unseen] * entries.shape[0]
    q = deque()

    def push(t, i, dep):
        if t == T_WIDE:
            q.append((i, dep))
        elif t == T_TOP and i_typ[i] == T_WIDE:
            q.append((i_idx[i], dep + 1))

    push(*unpack24(int(root_entry))[::2], 0)
    while q:
        i, dep = q.popleft()
        if depth[i] <= dep:
            continue
        depth[i] = dep
        for sl in range(WIDTH):
            push(typ[i][sl], idx[i][sl], dep + 1)
    return np.asarray(depth, np.int64)


def pack_scene8_nodes(scene) -> Dict:
    """Host-side packing: 8-wide collapse, BFS-depth renumbering, one
    64-float record per wide node."""
    if int(scene.tri_v0.shape[0]) >= (1 << 24):
        raise ValueError("triangle indices are stored in 24 bits")
    boxes, entries, root_entry, inst_entry = collapse_wide(
        scene, entry24, share_blas=True
    )
    n = boxes.shape[0]
    if n >= (1 << 24):
        raise ValueError("more than 2^24 wide nodes")
    depth = wide_depth(entries, root_entry, inst_entry)
    perm = np.argsort(depth, kind="stable")
    inv = np.empty(n, np.int64)
    inv[perm] = np.arange(n)

    def remap(e):
        typ, _, idx = unpack24(e)
        return np.where(typ == T_WIDE, (e & ~0xFFFFFF) | inv[np.clip(idx, 0, n - 1)], e)

    boxes = boxes[perm]
    entries = remap(entries[perm])
    root_entry = int(remap(np.array([root_entry], np.int64))[0])
    inst_entry = remap(inst_entry)
    need = wide_stack_need(entries, root_entry, inst_entry, unpack24)
    check_stack(need)

    rec = np.zeros((n, REC), np.float32)
    rec[:, :48] = boxes
    rec[:, 48::2] = (entries & 0xFFFFFF).astype(np.float32)
    rec[:, 49::2] = ((entries >> 24) & 0xFF).astype(np.float32)
    common = packed_common(scene)
    root_i32 = _as_i32(np.array([root_entry], np.int64))
    return {
        "p8n_nodes": rec.reshape(-1),
        "p8n_tris": common["pk_tris"],
        "p8n_w2o": common["pk_w2o"],
        "p8n_root": root_i32,
        "p8n_inst_entry": _as_i32(inst_entry),
        "root_entry": int(root_i32[0]),
        "stack_need": need,
    }


def wide8_nodes_layout(P) -> WideLayout:
    rec = P["p8n_nodes"].reshape(-1, REC)

    def fetch(node):
        r = rec[node]
        lo = r[:, 48::2].to(torch.int64)
        hi = r[:, 49::2].to(torch.int64)
        return r[:, :48].reshape(-1, WIDTH, 6), (hi << 24) | lo

    return WideLayout(
        fetch, unpack24, int(P["root_entry"]) & 0xFFFFFFFF,
        P["p8n_inst_entry"].to(torch.int64) & 0xFFFFFFFF,
        packed_tris(P["p8n_tris"]), P["p8n_w2o"].reshape(-1, 3, 4),
        int(rec.shape[0]),
    )


def wide8_nodes_plain(
    P, o, d, maxt, active, *, any_hit: bool, stats: Optional[dict] = None
) -> Hit:
    """The lock-step 8-wide traversal over the record array, with the
    det²-scaled leaf test."""
    return traverse_wide(
        wide8_nodes_layout(P), o, d, maxt, active, any_hit=any_hit, stats=stats,
        leaf="det2",
    )


def pack_scene_k2(p8n) -> Dict:
    """K2's own buffer from the host arrays of ``pack_scene8_nodes`` (see the
    module docstring): ``k2_words`` (int32, 16-byte words), the counts the
    kernel takes and the staging branch."""
    rec = np.asarray(p8n["p8n_nodes"], np.float32).reshape(-1, REC)
    tris = np.asarray(p8n["p8n_tris"], np.float32).reshape(-1, 9)
    w2o = np.asarray(p8n["p8n_w2o"], np.float32).reshape(-1, 12)
    n, t, i = rec.shape[0], tris.shape[0], w2o.shape[0]
    records = np.zeros((n, 4 * REC_WORDS), np.int32)
    records[:, :48] = rec[:, :48].view(np.int32)
    lo = rec[:, 48::2].astype(np.int64)
    hi = rec[:, 49::2].astype(np.int64)
    records[:, 48:] = _as_i32((hi << 24) | lo)
    need = int(p8n["stack_need"])
    check_stack(need)
    cap = max(1, min(need, STACK_SIZE))
    words = np.concatenate([
        records.ravel(), det2_rows(tris[:, 0:3], tris[:, 3:6], tris[:, 6:9]).view(np.int32).ravel(),
        instance_rows(w2o, p8n["p8n_inst_entry"]).ravel(),
    ])
    where, smem = staging_words(words.size // 4, cap)
    return {
        "k2_words": words, "num_wide": n, "num_tris": t, "num_inst": i,
        "stack_cap": cap, "staging": where, "smem_bytes": smem,
    }


_LIB = None


def load():
    """Build (first use) and bind the kernel library; cached per process."""
    global _LIB
    if _LIB is None:
        _LIB = _launch.bind(
            SOURCE, "polaris_wide8_nodes_closest_hit",
            "polaris_wide8_nodes_any_hit", "p" + "i" * 7 + "p",
        )
    return _LIB


# the arrays of pack_scene8_nodes, from which K2's own buffer is built
_ARRAYS = (
    ("p8n_nodes", torch.float32),
    ("p8n_inst_entry", torch.int32),
    ("p8n_tris", torch.float32),
    ("p8n_w2o", torch.float32),
)


def _scene_args(P, device):
    """The kernel's scene arguments but the counters: its own buffer, once
    the packed arrays and the buffer built from them are checked to agree."""
    _launch.packed_pointers(P, _ARRAYS, device)
    num_wide = P["p8n_nodes"].numel() // REC
    num_tris = P["p8n_tris"].numel() // 9
    num_inst = P["p8n_w2o"].numel() // 12
    if P["p8n_nodes"].numel() % REC or P["p8n_inst_entry"].numel() != num_inst:
        raise ValueError("packed node records or instance entries have the wrong length")
    check_stack(int(P["stack_need"]))
    if "k2_words" not in P:
        raise ValueError("K2 reads its own buffer: pack the scene with pack_scene_k2 "
                         "(make_intersectors does)")
    words = P["k2_words"]
    _launch.check("k2_words", words, torch.int32, 1, device)
    n_words = REC_WORDS * num_wide + 3 * num_tris + 4 * num_inst
    if (P["num_wide"], P["num_tris"], P["num_inst"]) != (num_wide, num_tris, num_inst) \
            or words.numel() != 4 * n_words:
        raise ValueError("k2_words: not the buffer of these packed arrays (wrong length)")
    return [
        words.data_ptr(), n_words, int(P["root_entry"]), num_wide, num_tris, num_inst,
        P["stack_cap"], int(P["staging"] == "shared"),
    ]


def _args(P, device):
    return _scene_args(P, device) + [_launch.persistent_counters(device).data_ptr()]


def closest_hit(P, o, d, maxt, active) -> Hit:
    """Closest hit per ray through the CUDA kernel (plain version on CPU)."""
    if o.device.type != "cuda":
        return wide8_nodes_plain(P, o, d, maxt, active, any_hit=False)
    hit = _launch.run_closest(load()[0], _args(P, o.device), o, d, maxt, active)
    _launch.count(LAUNCHES, "closest_hit")
    return hit


def any_hit(P, o, d, maxt, active) -> torch.Tensor:
    """Occlusion mask per ray through the CUDA kernel (plain version on CPU)."""
    if o.device.type != "cuda":
        return wide8_nodes_plain(P, o, d, maxt, active, any_hit=True).mask
    found = _launch.run_any(load()[1], _args(P, o.device), o, d, maxt, active)
    _launch.count(LAUNCHES, "any_hit")
    return found
