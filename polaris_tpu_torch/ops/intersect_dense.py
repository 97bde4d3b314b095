"""Dense (traversal-free) intersection for small scenes: packer, plain
PyTorch version and the wrappers of the CUDA kernel ``csrc/intersect_dense.cu``.

Counterpart of the JAX package's ``ops/intersect_pallas_dense.py``
(``pack_scene_dense``, ``intersect_pallas_dense``, TPU kernel ``_kernel``):
no BVH at all. Every ray visits every instance in order, is moved into the
instance's space once, and tests every triangle of the instance's contiguous
range in order, with a strict best-hit update. ``hybrid`` traversal uses
it for bounce and shadow rays (ops/intersect.py::make_intersectors).

The packer keeps every key of the JAX packer (``pk_ranges``, ``pk_tris``,
``pk_w2o``) bit for bit; none is dropped.

The triangle test is the TPU kernel's: det²-scaled Möller–Trumbore
(``ops/intersect.py::_mt_tests_det2`` / ``scan_scaled``) with the best hit
kept as numerators over ONE denominator across every triangle of every
instance and divided once per ray at the end. The BVH kernels divide at
every leaf, so an acceptance compare rounds differently here: on a near-tie
this kernel may keep another triangle than they do; on the same triangle
``t, u, v`` are the same bits.

``pack_scene_k5`` builds, beside those arrays, the buffer the kernel reads
(``csrc/intersect_dense.cu``), one buffer of 16-byte words: a 64-byte row per
instance ``[3x4 world->object matrix, first, count, 0, 0]``, then a 48-byte
row per triangle ``[v0, 0, e1, 0, e2, 0]``, with the staging branch
(``intersect_cuda.block_staging``: the whole buffer in shared memory when it
is small, cornell's and instanced's, else read through L1 and L2). The
kernel runs the block-local schedule of ``csrc/traverse_block.cuh``.

``dense_plain`` is the PLAIN VERSION of the kernel: the same loops with all
rays advanced together and the triangles taken in chunks; it reads the
JAX-equal arrays. On CUDA tensors the wrappers launch the kernel on
``P["k5_words"]`` or raise; they take the plain version only for CPU tensors.
``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from . import _launch
from .intersect_cuda import block_staging, det2_rows, instance_rows
from .intersect import (
    Hit,
    _mt_tests_det2,
    _xform,
    packed_tris,
    scan_scaled,
)

SOURCE = "intersect_dense.cu"

# dense testing is sensible only up to a few thousand triangles
DENSE_MAX_TRIS = 4096
# ray-triangle pairs the plain version tests per step (bounds its memory)
_PAIRS_PER_STEP = 1 << 22

LAUNCHES = {"closest_hit": 0, "any_hit": 0}

_POINTERS = (
    ("pk_ranges", torch.int32),
    ("pk_tris", torch.float32),
    ("pk_w2o", torch.float32),
)


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def pack_scene_dense(scene) -> Dict[str, np.ndarray]:
    """Host-side packing: ``pk_ranges`` (I*2,) i32 ``(first, count)`` per
    instance, ``pk_tris`` (T*9,) f32 rows ``[v0, e1, e2]``, ``pk_w2o``
    (I*12,) f32 rows of the 3x4 world->object matrices. Raises for a scene
    over ``DENSE_MAX_TRIS`` triangles. Each instance's range comes from the
    NumPy oracle's BLAS walk, as in the JAX packer."""
    from ..cpu_ref.renderer import _collect_blas_triangles

    num_tris = int(scene.tri_v0.shape[0])
    if num_tris > DENSE_MAX_TRIS:
        raise ValueError(
            f"dense intersection takes at most {DENSE_MAX_TRIS} triangles, "
            f"the scene has {num_tris}; use a BVH traversal mode"
        )
    tris = (
        np.concatenate([scene.tri_v0, scene.tri_e1, scene.tri_e2], axis=1)
        .astype(np.float32)
        .reshape(-1)
    )
    w2o = scene.inst_w2o[:, :3, :].astype(np.float32).reshape(-1)
    ranges = []
    for root in scene.inst_bvh_root:
        t = _collect_blas_triangles(scene, int(root))
        first, count = int(t.min()), int(t.size)
        if t.max() - first + 1 != count:
            raise ValueError("an instance's triangles are not one contiguous range")
        ranges.append((first, count))
    return {
        "pk_ranges": np.asarray(ranges, np.int32).reshape(-1),
        "pk_tris": tris,
        "pk_w2o": w2o,
    }


def pack_scene_k5(pd) -> Dict:
    """K5's own buffer from the host arrays of ``pack_scene_dense`` (see the
    module docstring): ``k5_words`` (int32, 16-byte words), the counts the
    kernel takes and the staging branch."""
    ranges = np.asarray(pd["pk_ranges"], np.int32).reshape(-1, 2)
    tris = np.asarray(pd["pk_tris"], np.float32).reshape(-1, 9)
    w2o = np.asarray(pd["pk_w2o"], np.float32).reshape(-1, 12)
    words = np.concatenate([
        instance_rows(w2o, ranges).ravel(),
        det2_rows(tris[:, 0:3], tris[:, 3:6], tris[:, 6:9]).view(np.int32).ravel(),
    ])
    where, smem = block_staging(words.size // 4, 0)
    return {
        "k5_words": words, "num_inst": w2o.shape[0], "num_tris": tris.shape[0],
        "staging": where, "smem_bytes": smem,
    }


def dense_plain(
    P, o, d, maxt, active, *, any_hit: bool, stats: Optional[dict] = None
) -> Hit:
    """Every triangle of every instance against every ray, in the kernel's
    order and arithmetic (the denominator carried across all triangles, one
    divide at the end). ``stats`` receives the work as one thread per ray
    would do it:
    ``tris`` (triangle tests; an any-hit ray stops at its first accepted
    triangle), ``inst`` (instance transforms of the rays still at work), no
    ``inner`` and no ``slabs``, and the distinct records read:
    ``tris_touched``, ``inst_touched``."""
    n = o.shape[0]
    dev = o.device
    T = packed_tris(P["pk_tris"])
    w2o = P["pk_w2o"].reshape(-1, 3, 4)
    ranges = P["pk_ranges"].reshape(-1, 2).tolist()
    best_t = torch.where(active, maxt, 0.0).to(torch.float32)
    best_den = torch.ones(n, dtype=torch.float32, device=dev)
    best_u = torch.zeros(n, dtype=torch.float32, device=dev)
    best_v = torch.zeros(n, dtype=torch.float32, device=dev)
    best_tri = torch.zeros(n, dtype=torch.int32, device=dev)
    best_inst = torch.zeros(n, dtype=torch.int32, device=dev)
    found = torch.zeros(n, dtype=torch.bool, device=dev)
    step = max(1, min(256, _PAIRS_PER_STEP // max(n, 1)))
    n_tris = torch.zeros((), dtype=torch.int64, device=dev)
    n_inst = torch.zeros((), dtype=torch.int64, device=dev)
    tris_touched = inst_touched = 0
    for ii, (first, count) in enumerate(ranges):
        at_work = active & ~found if any_hit else active
        n_inst += at_work.sum()
        if stats is not None:
            inst_touched += int(at_work.any())
        m = w2o[ii : ii + 1].expand(n, 3, 4)
        io = _xform(m, o, 1)
        idr = _xform(m, d, 0)
        for c0 in range(first, first + count, step):
            width = min(step, first + count - c0)
            tri = torch.arange(c0, c0 + width, device=dev)[None, :].expand(n, width)
            valid = torch.ones((n, width), dtype=torch.bool, device=dev)
            if any_hit:
                hit, btri = scan_scaled(
                    _mt_tests_det2(T, tri, io, idr), tri, valid, best_t,
                    closest=False,
                )
            else:
                # numerators and denominator carry on; where nothing was
                # accepted the scan hands the old best back
                hit, (bt, best_den, bu, bv, btri) = scan_scaled(
                    _mt_tests_det2(T, tri, io, idr), tri, valid,
                    (best_t, best_den, best_u, best_v, best_tri.to(torch.int64)),
                    closest=True,
                )
            if stats is not None:
                # an any-hit ray stops at its first accepted triangle; the
                # furthest any ray gets is how much of the block is read
                at_work = active & ~found if any_hit else active
                tested = torch.full((n,), width, device=dev)
                if any_hit:
                    tested = torch.where(hit, btri - c0 + 1, tested)
                tested = torch.where(at_work, tested, 0)
                n_tris += tested.sum()
                tris_touched += int(tested.max()) if n else 0
            found |= hit
            if not any_hit:
                best_t = torch.where(hit, bt, best_t)
                best_u = torch.where(hit, bu, best_u)
                best_v = torch.where(hit, bv, best_v)
                best_tri = torch.where(hit, btri.to(torch.int32), best_tri)
                best_inst = torch.where(hit, ii, best_inst)
    if stats is not None:
        stats["tris"] = stats.get("tris", 0) + int(n_tris)
        stats["inst"] = stats.get("inst", 0) + int(n_inst)
        stats["inner"] = stats.get("inner", 0)
        stats["slabs"] = stats.get("slabs", 0)
        stats["nodes_touched"] = stats.get("nodes_touched", 0)
        stats["tris_touched"] = stats.get("tris_touched", 0) + tris_touched
        stats["inst_touched"] = stats.get("inst_touched", 0) + inst_touched
    inv = 1.0 / best_den
    t = torch.where(found, best_t * inv, 0.0)
    return Hit(t, best_inst, best_tri, best_u * inv, best_v * inv, active & found)


_LIB = None


def load():
    """Build (first use) and bind the kernel library; cached per process."""
    global _LIB
    if _LIB is None:
        _LIB = _launch.bind(
            SOURCE, "polaris_dense_closest_hit", "polaris_dense_any_hit", "piiii"
        )
    return _LIB


def _scene_args(P, device):
    """The kernel's scene arguments: its own buffer, once the packed arrays
    and the buffer built from them are checked to agree."""
    _launch.packed_pointers(P, _POINTERS, device)
    num_tris = P["pk_tris"].numel() // 9
    num_inst = P["pk_w2o"].numel() // 12
    if num_tris > DENSE_MAX_TRIS:
        raise ValueError(f"dense intersection takes at most {DENSE_MAX_TRIS} triangles")
    if P["pk_ranges"].numel() != 2 * num_inst:
        raise ValueError("pk_ranges and pk_w2o disagree on the instance count")
    if "k5_words" not in P:
        raise ValueError("K5 reads its own buffer: pack the scene with pack_scene_k5 "
                         "(make_intersectors does)")
    words = P["k5_words"]
    _launch.check("k5_words", words, torch.int32, 1, device)
    n_words = 4 * num_inst + 3 * num_tris
    if (P["num_inst"], P["num_tris"]) != (num_inst, num_tris) or words.numel() != 4 * n_words:
        raise ValueError("k5_words: not the buffer of these packed arrays (wrong length)")
    return [words.data_ptr(), n_words, num_inst, num_tris, int(P["staging"] == "shared")]


def closest_hit(P, o, d, maxt, active) -> Hit:
    """Closest hit per ray through the CUDA kernel (plain version on CPU)."""
    if o.device.type != "cuda":
        return dense_plain(P, o, d, maxt, active, any_hit=False)
    hit = _launch.run_closest(load()[0], _scene_args(P, o.device), o, d, maxt, active)
    _launch.count(LAUNCHES, "closest_hit")
    return hit


def any_hit(P, o, d, maxt, active) -> torch.Tensor:
    """Occlusion mask per ray through the CUDA kernel (plain version on CPU)."""
    if o.device.type != "cuda":
        return dense_plain(P, o, d, maxt, active, any_hit=True).mask
    found = _launch.run_any(load()[1], _scene_args(P, o.device), o, d, maxt, active)
    _launch.count(LAUNCHES, "any_hit")
    return found
