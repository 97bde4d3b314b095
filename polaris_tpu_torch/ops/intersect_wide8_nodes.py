"""8-wide BVH traversal over 64-float node records, the kernel of the
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

The traversal itself is ``ops/intersect_wide8.py::traverse_wide`` with this
layout's fetch and decoder; the CUDA kernel is a second layout of the same
device traversal body (``csrc/traverse_wide.cuh``) in a library of its own.
The leaf test is the TPU kernel's own: det²-scaled Möller–Trumbore
(``leaf="det2"``, ``ops/intersect.py::mt_block_det2``), where the 8-wide
kernel with resident nodes divides per triangle.

Keys of the JAX packer that are DROPPED, because they only stage data for the
TPU's memories: ``p8n_res_entry``, ``p8n_res_boxes`` and ``p8n_resident``
(the node prefix kept resident in SMEM) and the ``STREAM_ALIGN`` padding at
the end of ``p8n_nodes`` and ``p8n_tris`` (DMA windows). Kept, bit for bit:
``p8n_nodes`` (unpadded), ``p8n_tris`` (unpadded), ``p8n_w2o``, ``p8n_root``,
``p8n_inst_entry``. Added: the plain ints ``root_entry`` and ``stack_need``
(see ``ops/intersect_wide8.py``).

On CUDA tensors the wrappers launch the kernel or raise; they take the plain
version only for CPU tensors. ``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

from collections import deque
from typing import Dict, Optional

import numpy as np
import torch

from . import _launch
from .intersect import Hit, packed_tris
from .intersect_wide8 import (
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

LAUNCHES = {"closest_hit": 0, "any_hit": 0}

_POINTERS = (
    ("p8n_nodes", torch.float32),
    ("p8n_inst_entry", torch.int32),
    ("p8n_tris", torch.float32),
    ("p8n_w2o", torch.float32),
)


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


_LIB = None


def load():
    """Build (first use) and bind the kernel library; cached per process."""
    global _LIB
    if _LIB is None:
        _LIB = _launch.bind(
            SOURCE, "polaris_wide8_nodes_closest_hit",
            "polaris_wide8_nodes_any_hit", "pppp" + "iiii",
        )
    return _LIB


def _scene_args(P, device):
    ptrs = _launch.packed_pointers(P, _POINTERS, device)
    num_wide = P["p8n_nodes"].numel() // REC
    num_tris = P["p8n_tris"].numel() // 9
    num_inst = P["p8n_w2o"].numel() // 12
    if P["p8n_nodes"].numel() % REC or P["p8n_inst_entry"].numel() != num_inst:
        raise ValueError("packed node records or instance entries have the wrong length")
    check_stack(int(P["stack_need"]))
    return ptrs + [int(P["root_entry"]), num_wide, num_tris, num_inst]


def closest_hit(P, o, d, maxt, active) -> Hit:
    """Closest hit per ray through the CUDA kernel (plain version on CPU)."""
    if o.device.type != "cuda":
        return wide8_nodes_plain(P, o, d, maxt, active, any_hit=False)
    hit = _launch.run_closest(load()[0], _scene_args(P, o.device), o, d, maxt, active)
    LAUNCHES["closest_hit"] += 1
    return hit


def any_hit(P, o, d, maxt, active) -> torch.Tensor:
    """Occlusion mask per ray through the CUDA kernel (plain version on CPU)."""
    if o.device.type != "cuda":
        return wide8_nodes_plain(P, o, d, maxt, active, any_hit=True).mask
    found = _launch.run_any(load()[1], _scene_args(P, o.device), o, d, maxt, active)
    LAUNCHES["any_hit"] += 1
    return found
