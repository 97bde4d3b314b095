"""K3, binary BVH traversal over depth-ordered 16-float node records: packer,
plain PyTorch version and the wrappers of the CUDA kernel
``csrc/intersect_nodes.cu``.

Counterpart of the JAX package's ``ops/intersect_pallas_nodes.py``
(``_depth_order``, ``pack_scene_nodes``, ``intersect_pallas_nodes``, TPU
kernel ``_kernel``), the streamed-nodes kernel of its big-scene path. What is
kept is the node layout and the traversal order:

  * every node is one record ``[ld, rd, leftChildBox(6), rightChildBox(6),
    pad2]`` of 16 floats, so one 64-byte fetch serves both children's slab
    tests; ``ld`` and ``rd`` are exact small floats (``|v| < 2^24``)
  * nodes are renumbered by BFS depth over the TLAS + BLAS forest (a BLAS
    root inherits its depth from the TLAS leaf that enters it), so the top
    of the forest, which every ray visits, is contiguous
  * traversal order, leaf test (det²-scaled Möller–Trumbore, ``leaf="det2"``)
    and so the results are those of the binary kernel
    (``ops/intersect_cuda.py``): near child first by the ray's own entry
    distances; the two agree bit for bit, as the TPU kernels do by contract

``pack_scene_nodes`` equals the JAX packer array for array, but for the keys
it DROPS because they only stage data for the TPU's memories: ``pn_res_ld``,
``pn_res_rd``, ``pn_res_cbox`` and ``pn_resident`` (the prefix kept resident
in SMEM), and the ``STREAM_ALIGN`` padding at the end of ``pn_nodes`` and
``pn_tris`` (DMA windows). Kept, bit for bit: ``pn_nodes`` (unpadded),
``pn_tris`` (unpadded), ``pn_w2o``, ``pn_roots``.

``pack_scene_k3`` builds, beside those arrays, the buffer the kernel reads:
K1's layout (``intersect_cuda.pack_scene_k1``) over the depth-ordered
records, ``ld``/``rd`` as int bits, 48-byte triangle rows, 64-byte instance
rows with the BLAS root, with K1's staging rule (``intersect_cuda.
staging_words``): the whole buffer in shared memory when it fits beside the
stacks, else read through L1 and L2. The kernel runs K1's persistent
schedule over that buffer. The TPU kernel's resident prefix has no
counterpart: kept in shared memory it read slower than L1 does (PERF.md).

``nodes_plain`` is the PLAIN VERSION of the kernel: the binary lock-step
traversal of ``ops/intersect.py`` reading the record array. On CUDA tensors
the wrappers launch the kernel on ``P["k3_words"]`` or raise; they take the
plain version only for CPU tensors. ``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

from collections import deque
from types import SimpleNamespace
from typing import Dict, Optional

import numpy as np
import torch

from . import _launch
from .intersect_cuda import (
    det2_rows,
    instance_rows,
    stack_need,
    staging_words,
)
from .intersect import (
    STACK_SIZE,
    BinaryLayout,
    Hit,
    packed_tris,
    traverse_binary,
)

SOURCE = "intersect_nodes.cu"
REC = 16  # f32 slots per node record

LAUNCHES = {"closest_hit": 0, "any_hit": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def depth_order(scene) -> np.ndarray:
    """BFS depth of every node over the TLAS + per-instance BLAS forest.
    BLAS roots inherit depth from the TLAS leaf that enters them."""
    ld = scene.bvh_ldata.astype(np.int64).tolist()
    rd = scene.bvh_rdata.astype(np.int64).tolist()
    roots = scene.inst_bvh_root.astype(np.int64).tolist()
    unseen = int(np.iinfo(np.int32).max)
    depth = [unseen] * len(ld)
    q = deque([(0, 0)])
    while q:
        i, dep = q.popleft()
        if depth[i] <= dep:
            continue
        depth[i] = dep
        if ld[i] > 0:  # inner
            q.append((ld[i], dep + 1))
            q.append((rd[i], dep + 1))
        elif rd[i] == 0:  # top leaf -> BLAS root
            q.append((roots[-ld[i]], dep + 1))
    return np.asarray(depth, np.int64)


def pack_scene_nodes(scene) -> Dict[str, np.ndarray]:
    """Host-side packing: nodes renumbered by BFS depth into 16-float
    records that carry both children's boxes."""
    ld = scene.bvh_ldata.astype(np.int64)
    rd = scene.bvh_rdata.astype(np.int64)
    n = ld.shape[0]
    if n >= (1 << 24) or int(scene.tri_v0.shape[0]) >= (1 << 24):
        raise ValueError("node and triangle indices are stored as exact f32: below 2^24")

    depth = depth_order(scene)
    reached = depth < np.iinfo(np.int32).max
    if int(depth[reached].max()) >= STACK_SIZE:
        raise ValueError(
            f"the BVH is {int(depth[reached].max()) + 1} levels deep; the "
            f"traversal stack holds {STACK_SIZE} entries"
        )
    perm = np.argsort(depth, kind="stable")  # old index per new slot
    inv = np.empty(n, np.int64)
    inv[perm] = np.arange(n)

    inner = (ld > 0)[perm]
    oldl = np.clip(ld[perm], 0, n - 1)
    oldr = np.clip(rd[perm], 0, n - 1)
    new_ld = np.where(inner, inv[oldl], ld[perm])
    new_rd = np.where(inner, inv[oldr], rd[perm])
    roots = inv[scene.inst_bvh_root.astype(np.int64)]

    bmin = scene.bvh_min.astype(np.float32)
    bmax = scene.bvh_max.astype(np.float32)
    rec = np.zeros((n, REC), np.float32)
    rec[:, 0] = new_ld.astype(np.float32)
    rec[:, 1] = new_rd.astype(np.float32)
    rec[inner, 2:5] = bmin[oldl[inner]]
    rec[inner, 5:8] = bmax[oldl[inner]]
    rec[inner, 8:11] = bmin[oldr[inner]]
    rec[inner, 11:14] = bmax[oldr[inner]]
    tris = (
        np.concatenate([scene.tri_v0, scene.tri_e1, scene.tri_e2], axis=1)
        .astype(np.float32)
        .reshape(-1)
    )
    return {
        "pn_nodes": rec.reshape(-1),
        "pn_tris": tris,
        "pn_w2o": scene.inst_w2o[:, :3, :].astype(np.float32).reshape(-1),
        "pn_roots": roots.astype(np.int32),
    }


def nodes_layout(P) -> BinaryLayout:
    rec = P["pn_nodes"].reshape(-1, REC)

    def fetch(node):
        r = rec[node]
        return (
            r[:, 0].to(torch.int64), r[:, 1].to(torch.int64),
            r[:, 2:5], r[:, 5:8], r[:, 8:11], r[:, 11:14],
        )

    return BinaryLayout(
        fetch, packed_tris(P["pn_tris"]), P["pn_w2o"].reshape(-1, 3, 4),
        P["pn_roots"], int(rec.shape[0]),
    )


def nodes_plain(
    P, o, d, maxt, active, *, any_hit: bool, stats: Optional[dict] = None
) -> Hit:
    """The binary lock-step traversal over the record array, with the
    det²-scaled leaf test."""
    return traverse_binary(
        nodes_layout(P), o, d, maxt, active, any_hit=any_hit, stats=stats,
        leaf="det2",
    )


def pack_scene_k3(pn) -> Dict:
    """K3's own buffer from the host arrays of ``pack_scene_nodes`` (see the
    module docstring): ``k3_words`` (int32, 16-byte words), the counts the
    kernel takes, ``stack_need`` of the depth-ordered tree and the staging
    branch."""
    rec = np.asarray(pn["pn_nodes"], np.float32).reshape(-1, REC)
    tris = np.asarray(pn["pn_tris"], np.float32).reshape(-1, 9)
    w2o = np.asarray(pn["pn_w2o"], np.float32).reshape(-1, 12)
    roots = np.asarray(pn["pn_roots"], np.int32)
    n, t, i = rec.shape[0], tris.shape[0], w2o.shape[0]
    nodes = rec.view(np.int32).copy()
    nodes[:, 0], nodes[:, 1] = rec[:, 0].astype(np.int32), rec[:, 1].astype(np.int32)
    need = stack_need(
        SimpleNamespace(bvh_ldata=nodes[:, 0], bvh_rdata=nodes[:, 1], inst_bvh_root=roots)
    )
    cap = max(1, min(need, STACK_SIZE))
    words = np.concatenate([
        nodes.ravel(), det2_rows(tris[:, 0:3], tris[:, 3:6], tris[:, 6:9]).view(np.int32).ravel(),
        instance_rows(w2o, roots).ravel(),
    ])
    where, smem = staging_words(words.size // 4, cap)
    return {
        "k3_words": words, "num_nodes": n, "num_tris": t, "num_inst": i,
        "stack_need": need, "stack_cap": cap, "staging": where, "smem_bytes": smem,
    }


_LIB = None


def load():
    """Build (first use) and bind the kernel library; cached per process."""
    global _LIB
    if _LIB is None:
        _LIB = _launch.bind(
            SOURCE, "polaris_nodes_closest_hit", "polaris_nodes_any_hit", "p" + "i" * 6 + "p"
        )
    return _LIB


# the arrays of pack_scene_nodes, from which K3's own buffer is built
_ARRAYS = (
    ("pn_nodes", torch.float32),
    ("pn_tris", torch.float32),
    ("pn_w2o", torch.float32),
    ("pn_roots", torch.int32),
)


def _scene_args(P, device):
    """The kernel's scene arguments but the counters: its own buffer, once
    the packed arrays and the buffer built from them are checked to agree."""
    _launch.packed_pointers(P, _ARRAYS, device)
    num_nodes = P["pn_nodes"].numel() // REC
    num_tris = P["pn_tris"].numel() // 9
    num_inst = P["pn_w2o"].numel() // 12
    if P["pn_nodes"].numel() % REC or P["pn_roots"].numel() != num_inst:
        raise ValueError("packed node records or roots have the wrong length")
    if "k3_words" not in P:
        raise ValueError("K3 reads its own buffer: pack the scene with pack_scene_k3 "
                         "(make_intersectors does)")
    words = P["k3_words"]
    _launch.check("k3_words", words, torch.int32, 1, device)
    n_words = 4 * num_nodes + 3 * num_tris + 4 * num_inst
    if (P["num_nodes"], P["num_tris"], P["num_inst"]) != (num_nodes, num_tris, num_inst) \
            or words.numel() != 4 * n_words:
        raise ValueError("k3_words: not the buffer of these packed arrays (wrong length)")
    return [
        words.data_ptr(), n_words, num_nodes, num_tris, num_inst, P["stack_cap"],
        int(P["staging"] == "shared"),
    ]


def _args(P, device):
    return _scene_args(P, device) + [_launch.persistent_counters(device).data_ptr()]


def closest_hit(P, o, d, maxt, active) -> Hit:
    """Closest hit per ray through the CUDA kernel (plain version on CPU)."""
    if o.device.type != "cuda":
        return nodes_plain(P, o, d, maxt, active, any_hit=False)
    hit = _launch.run_closest(load()[0], _args(P, o.device), o, d, maxt, active)
    _launch.count(LAUNCHES, "closest_hit")
    return hit


def any_hit(P, o, d, maxt, active) -> torch.Tensor:
    """Occlusion mask per ray through the CUDA kernel (plain version on CPU)."""
    if o.device.type != "cuda":
        return nodes_plain(P, o, d, maxt, active, any_hit=True).mask
    found = _launch.run_any(load()[1], _args(P, o.device), o, d, maxt, active)
    _launch.count(LAUNCHES, "any_hit")
    return found
