"""Ray/scene intersection: two-level BVH traversal in plain PyTorch, and the
dispatch that picks between it and the hand-written CUDA kernels.

Counterpart of the JAX package's ``ops/intersect.py`` (``Hit``,
``intersect_bvh``, ``make_intersectors``), itself the counterpart of the
reference's traversal kernels (``CL/kernels/intersect.cl``):

  * closest hit (``rayIntersectionQuery``) and any hit / occlusion
    (``rayIntersectionTest``)
  * two-level scheme: a TLAS leaf loads a mesh instance, transforms the ray
    by the instance's world->object matrix and continues into the mesh BLAS;
    on BLAS exit the ray is restored (stack watermark ``msbi``)

``intersect_bvh`` is the PLAIN VERSION of the CUDA traversal kernel
(``ops/intersect_cuda.py`` / ``csrc/intersect.cu``): the same per-ray
algorithm — private stack, near-child-first by the ray's own slab entry
distances, strict best-hit updates — with every lane advanced in lock step
by a host loop. Its float operations are written in the same association as
the kernel's, so the two agree bit for bit wherever the device rounds each
multiply and add separately.

Three LEAF TESTS, each mirrored operation for operation by a device helper
of ``csrc/traverse_common.cuh`` and taken by every plain traversal through a
``leaf=`` argument:

  ``"quot"``  ``mt_block``: quotient-form Möller–Trumbore, one divide per
              triangle. The form of the 8-wide TPU kernel with resident
              nodes (K4) and of the JAX package's non-Pallas traversals;
              ``mode="bvh"`` runs it
  ``"det2"``  ``mt_block_det2``: det²-scaled Möller–Trumbore, the form of
              the TPU kernels K1, K2, K3 and K5: numerators over ``det²``,
              the best hit compared by cross-multiplication, one divide per
              leaf
  ``"hh"``    ``hh_block``: Havel–Herout precomputed planes on the 12-float
              rows of ``pack_tris_hh``, det²-scaled alike; K1's second test

Each trip of the host loop advances every live lane by one node: an inner
node slab-tests both children, a TLAS leaf enters an instance, a BLAS leaf
tests ALL of its triangles at once (dense ``[lanes, leaf]`` arithmetic
instead of one triangle per trip; first-minimum selection keeps the
sequential strict-``<`` result).

The JAX package's two XLA traversals are here in plain PyTorch too:
``intersect_brute`` (mode 'brute': every triangle of every instance, no
BVH) and, in ``intersect_packet.py``, mode 'packet'.
"""

from __future__ import annotations

import os
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from . import vec as V

STACK_SIZE = 64  # covers TLAS + BLAS depth

PHASE_NODE = 0
PHASE_POP = 1
PHASE_DONE = 2


class Hit(NamedTuple):
    t: torch.Tensor  # [N] f32, 0 where no hit
    inst: torch.Tensor  # [N] i32
    tri: torch.Tensor  # [N] i32
    u: torch.Tensor  # [N] f32
    v: torch.Tensor  # [N] f32
    mask: torch.Tensor  # [N] bool


def _slab_test(o, inv, bmin, bmax, best_t):
    """AABB slab test -> entry distance, FLT_MAX on miss
    (intersect.cl:135-155)."""
    t0 = (bmin - o) * inv
    t1 = (bmax - o) * inv
    tmin = torch.minimum(t0, t1)
    tmax = torch.maximum(t0, t1)
    tn = torch.maximum(torch.maximum(tmin[:, 0], tmin[:, 1]), tmin[:, 2])
    tf = torch.minimum(torch.minimum(tmax[:, 0], tmax[:, 1]), tmax[:, 2])
    miss = (tf < 0.0) | (tn > tf) | (tn >= best_t)
    return torch.where(miss, V.FLT_MAX, tn)


def _inv_dir(d):
    """1/d with the 1e-30 direction floor."""
    floor = torch.where(d < 0, -1e-30, 1e-30)
    return 1.0 / torch.where(torch.abs(d) < 1e-30, floor, d)


def _xform(w2o, p, w: float):
    """Rows 0..2 of [M,4,4] matrices applied to [M,3] vectors (w = 0 or 1),
    in the kernel's association: ((m0*x + m1*y) + m2*z) [+ m3]."""
    r = V.dot3(w2o[:, :3, :3], p[:, None, :])
    return r + w2o[:, :3, 3] if w else r


class TriArrays(NamedTuple):
    """Triangles as three [T,3] tensors (or views into one packed [T,9]
    array): vertex 0 and the two edges."""

    v0: torch.Tensor
    e1: torch.Tensor
    e2: torch.Tensor


def packed_tris(tris: torch.Tensor) -> TriArrays:
    """Views into a flat ``[T*9]`` array of ``[v0, e1, e2]`` rows."""
    rows = tris.reshape(-1, 9)
    return TriArrays(rows[:, 0:3], rows[:, 3:6], rows[:, 6:9])


def mt_block(T: TriArrays, tri, valid, o, d, best_t, *, closest: bool):
    """Quotient-form Möller–Trumbore (intersect.cl:90-125) of ``M`` rays
    against a block of triangles each: ``tri`` [M,W] indices, ``valid`` [M,W],
    ``o, d`` [M,3], ``best_t`` [M]. A triangle is accepted when
    ``|det| >= EPS``, ``0 <= u <= 1``, ``v >= 0``, ``u + v <= 1`` and
    ``EPS < t < best_t``.

    Returns ``(hit, t, u, v, tri)`` per ray: whether any triangle was
    accepted and, with ``closest``, the FIRST one of minimal ``t`` in block
    order — what sequential strict-``<`` updates would keep. Without
    ``closest`` (any hit) ``t, u, v`` are ``None`` and ``tri`` is the first
    accepted triangle in block order, where a sequential test would stop.
    The device helper ``leaf_rows_quot`` of csrc/traverse_common.cuh repeats
    it in the same association.
    """
    v0 = T.v0[tri]
    e1 = T.e1[tri]
    e2 = T.e2[tri]
    co = o[:, None, :]
    cd = d[:, None, :].expand_as(v0)
    pvec = V.cross3(cd, e2)
    det = V.dot3(e1, pvec)
    ok = torch.abs(det) >= V.INTERSECTION_EPSILON
    inv_det = 1.0 / torch.where(ok, det, 1.0)
    tvec = co - v0
    uu = V.dot3(tvec, pvec) * inv_det
    ok &= (uu >= 0.0) & (uu <= 1.0)
    qvec = V.cross3(tvec, e1)
    vv = V.dot3(cd, qvec) * inv_det
    ok &= (vv >= 0.0) & (uu + vv <= 1.0)
    tt = V.dot3(e2, qvec) * inv_det
    ok &= (tt > V.INTERSECTION_EPSILON) & (tt < best_t[:, None])
    ok &= valid
    hit = ok.any(dim=1)
    width = tri.shape[1]
    j = torch.arange(width, device=tri.device)
    if not closest:
        bj = torch.where(ok, j[None, :], width).min(dim=1).values
        bj = torch.clamp(bj, max=width - 1)[:, None]
        return hit, None, None, None, tri.gather(1, bj)[:, 0]
    tt_m = torch.where(ok, tt, float("inf"))
    bt = tt_m.min(dim=1).values
    bj = torch.where(tt_m == bt[:, None], j[None, :], width).min(dim=1).values
    bj = torch.clamp(bj, max=width - 1)[:, None]
    return (
        hit, bt, uu.gather(1, bj)[:, 0], vv.gather(1, bj)[:, 0],
        tri.gather(1, bj)[:, 0],
    )


class HHRows(NamedTuple):
    """Triangles as ``[T,12]`` Havel–Herout rows ``[N, d0, N1, d1, N2, d2]``
    (``pack_tris_hh``)."""

    rows: torch.Tensor


def pack_tris_hh(scene) -> np.ndarray:
    """Havel–Herout per-triangle constants, 12 f32 each, flat: the
    unnormalized normal ``N`` with plane offset ``d0 = N·v0``, and the two
    barycentric plane equations ``N1 = (e2×N)/|N|²``, ``d1 = −N1·v0`` and
    ``N2 = (N×e1)/|N|²``, ``d2 = −N2·v0``, computed in f64 and rounded once.
    ``|N|²`` of a degenerate triangle is floored so the rows stay finite; the
    test's ``det² >= EPS²`` rejects it. ``scene`` holds ``tri_v0``,
    ``tri_e1``, ``tri_e2`` as arrays. Equal, array for array, to the JAX
    package's ``intersect_pallas._pack_tris_hh``."""
    v0 = np.asarray(scene.tri_v0).astype(np.float64)
    e1 = np.asarray(scene.tri_e1).astype(np.float64)
    e2 = np.asarray(scene.tri_e2).astype(np.float64)
    n = np.cross(e1, e2)
    nn = np.maximum((n * n).sum(axis=1, keepdims=True), 1e-300)
    n1 = np.cross(e2, n) / nn
    n2 = np.cross(n, e1) / nn
    d0 = (n * v0).sum(axis=1, keepdims=True)
    d1 = -(n1 * v0).sum(axis=1, keepdims=True)
    d2 = -(n2 * v0).sum(axis=1, keepdims=True)
    return (
        np.concatenate([n, d0, n1, d1, n2, d2], axis=1)
        .astype(np.float32)
        .reshape(-1)
    )


_EPS2 = V.INTERSECTION_EPSILON * V.INTERSECTION_EPSILON


def _mt_tests_det2(T: TriArrays, tri, o, d):
    """The geometry half of the det²-scaled Möller–Trumbore test: ``(ok,
    u_num, v_num, t_num, det_a)`` per ray and triangle, numerators scaled by
    ``det`` over the positive denominator ``det_a = det²`` (no divide, no
    sign)."""
    v0 = T.v0[tri]
    e1 = T.e1[tri]
    e2 = T.e2[tri]
    co = o[:, None, :]
    cd = d[:, None, :].expand_as(v0)
    pvec = V.cross3(cd, e2)
    det = V.dot3(e1, pvec)
    det_a = det * det
    ok = det_a >= _EPS2
    tvec = co - v0
    u_num = V.dot3(tvec, pvec) * det
    ok &= (u_num >= 0.0) & (u_num <= det_a)
    qvec = V.cross3(tvec, e1)
    v_num = V.dot3(cd, qvec) * det
    ok &= (v_num >= 0.0) & (u_num + v_num <= det_a)
    t_num = V.dot3(e2, qvec) * det
    ok &= t_num > V.INTERSECTION_EPSILON * det_a
    return ok, u_num, v_num, t_num, det_a


def _hh_tests(T: HHRows, tri, o, d):
    """The Havel–Herout test on precomputed planes, det²-scaled: the same
    ``(ok, u_num, v_num, t_num, det_a)`` as ``_mt_tests_det2``, with the hit
    point scaled by ``det``: ``P' = det*o + t_raw*d``."""
    row = T.rows[tri]
    n, d0 = row[..., 0:3], row[..., 3]
    n1, d1 = row[..., 4:7], row[..., 7]
    n2, d2 = row[..., 8:11], row[..., 11]
    co = o[:, None, :].expand_as(n)
    cd = d[:, None, :].expand_as(n)
    det = V.dot3(cd, n)
    t_raw = d0 - V.dot3(co, n)
    det_a = det * det
    ok = det_a >= _EPS2
    h = det[..., None] * co + t_raw[..., None] * cd
    u_num = (V.dot3(n1, h) + det * d1) * det
    v_num = (V.dot3(n2, h) + det * d2) * det
    ok &= (u_num >= 0.0) & (v_num >= 0.0) & (u_num + v_num <= det_a)
    t_num = t_raw * det
    ok &= t_num > V.INTERSECTION_EPSILON * det_a
    return ok, u_num, v_num, t_num, det_a


def scan_scaled(tests, tri, valid, best, *, closest: bool):
    """The acceptance half of a det²-scaled leaf: the block's columns taken
    IN ORDER, as the kernels' triangle loop takes them.

    ``tests`` is ``(ok, u_num, v_num, t_num, det_a)`` [M,W]. Any hit
    (``closest=False``): ``best`` is ``maxt`` [M]; a triangle is accepted when
    ``t_num < maxt * det_a``; returns ``(hit, first accepted tri)``. Closest
    hit: ``best`` is ``(t_num, den, u_num, v_num, tri)``, numerators over one
    denominator; a triangle is accepted when ``t_num * den < best_t_num *
    det_a`` and then takes their place. The compare is not transitive once it
    rounds, so the columns are walked one after the other rather than reduced.
    Returns ``(hit, best)`` without the closing divide. A best ``t`` of
    ``FLT_MAX`` overflows the right side to ``+inf`` and the compare still
    holds."""
    ok, u_num, v_num, t_num, det_a = tests
    ok = ok & valid
    width = tri.shape[1]
    if not closest:
        ok &= t_num < best[:, None] * det_a
        j = torch.arange(width, device=tri.device)
        bj = torch.where(ok, j[None, :], width).min(dim=1).values
        bj = torch.clamp(bj, max=width - 1)[:, None]
        return ok.any(dim=1), tri.gather(1, bj)[:, 0]
    bt, den, bu, bv, btri = best
    hit = torch.zeros_like(ok[:, 0])
    for j in range(width):
        okj = ok[:, j] & (t_num[:, j] * den < bt * det_a[:, j])
        bt = torch.where(okj, t_num[:, j], bt)
        den = torch.where(okj, det_a[:, j], den)
        bu = torch.where(okj, u_num[:, j], bu)
        bv = torch.where(okj, v_num[:, j], bv)
        btri = torch.where(okj, tri[:, j], btri)
        hit = hit | okj
    return hit, (bt, den, bu, bv, btri)


def _scaled_block(tests, tri, valid, best_t, closest: bool):
    """One leaf visit in a det²-scaled form: the denominator starts at 1 and
    ONE divide at the end turns the numerators back into ``t, u, v``."""
    if not closest:
        hit, first = scan_scaled(tests, tri, valid, best_t, closest=False)
        return hit, None, None, None, first
    zero = torch.zeros_like(best_t)
    start = (best_t, torch.ones_like(best_t), zero, zero, tri[:, 0])
    hit, (bt, den, bu, bv, btri) = scan_scaled(
        tests, tri, valid, start, closest=True
    )
    inv = 1.0 / den
    return hit, bt * inv, bu * inv, bv * inv, btri


def mt_block_det2(T: TriArrays, tri, valid, o, d, best_t, *, closest: bool):
    """det²-scaled Möller–Trumbore of ``M`` rays against a block of triangles
    each, the leaf arithmetic of the TPU kernels K1, K2, K3 (and, with the
    denominator carried on, K5); arguments and results as ``mt_block``. A
    triangle passes when ``det² >= EPS²``, ``0 <= u_num <= det²``,
    ``v_num >= 0``, ``u_num + v_num <= det²`` and ``t_num > EPS*det²``; see
    ``scan_scaled`` for the acceptance. The device helpers
    ``scaled_math<LEAF_DET2>`` / ``scan_rows`` of csrc/traverse_common.cuh
    repeat it in the same association."""
    return _scaled_block(_mt_tests_det2(T, tri, o, d), tri, valid, best_t, closest)


def hh_block(T: HHRows, tri, valid, o, d, best_t, *, closest: bool):
    """Havel–Herout test of ``M`` rays against a block of 12-float rows each,
    det²-scaled with the bookkeeping of ``mt_block_det2``; the device helper
    is ``scaled_math<LEAF_HH>``."""
    return _scaled_block(_hh_tests(T, tri, o, d), tri, valid, best_t, closest)


# leaf form -> its block test (see the module docstring)
LEAF_TESTS = {"quot": mt_block, "det2": mt_block_det2, "hh": hh_block}


def num_tris(T) -> int:
    """Triangles in a ``TriArrays`` or ``HHRows``."""
    return int(T[0].shape[0])


def mt_leaves(T, first, cnt, o, d, best_t, *, closest: bool, leaf: str):
    """The ``leaf`` form's block test on each ray's own run
    ``[first, first + cnt)``."""
    width = max(int(cnt.max()), 1)
    j = torch.arange(width, device=first.device)
    tri = torch.clamp(first[:, None] + j[None, :], max=num_tris(T) - 1)
    valid = j[None, :] < cnt[:, None]
    return LEAF_TESTS[leaf](T, tri, valid, o, d, best_t, closest=closest)


class Touched:
    """The distinct scene records a traversal reads, kept while it is being
    instrumented: one bool per node record, triangle and instance. From these
    a caller works out the bytes the call could not have done without."""

    def __init__(self, device, num_nodes: int, num_tris: int, num_inst: int):
        def flags(n):
            return torch.zeros(max(int(n), 1), dtype=torch.bool, device=device)

        self.nodes, self.tris, self.inst = flags(num_nodes), flags(num_tris), flags(num_inst)

    def runs(self, first, count):
        """Mark the triangles ``[first, first + count)`` of each ray."""
        if first.numel() == 0:
            return
        j = torch.arange(max(int(count.max()), 1), device=first.device)
        at = first[:, None] + j[None, :]
        self.tris[at[j[None, :] < count[:, None]]] = True

    def add_to(self, stats: dict) -> None:
        for key, flags in (
            ("nodes_touched", self.nodes), ("tris_touched", self.tris),
            ("inst_touched", self.inst),
        ):
            stats[key] = stats.get(key, 0) + int(flags.sum())


def tested_in_leaf(hit, first_hit, first, cnt, *, any_hit: bool):
    """Triangle tests a sequential leaf loop makes per ray: all ``cnt`` for
    closest hit; for any hit up to and including the first accepted
    triangle ``first_hit``."""
    if not any_hit:
        return cnt
    return torch.where(hit, first_hit - first + 1, cnt)


def simt_ceilings(work: torch.Tensor, active: torch.Tensor, warp: int = 32) -> dict:
    """The share of a warp's lanes that do useful work when every warp runs
    as long as its busiest lane: ``sum(work) / (warp * sum over warps of the
    warp's largest work)``, for the lanes taken ``warp`` at a time in launch
    order (``launch_order``) and for the active lanes only, in their order
    (``compacted``, what a kernel that hands out only live rays starts
    from). ``work`` [N] is each lane's count of units (inner visits plus
    triangle tests, ``traverse_binary``'s per-lane stats); a partial last
    warp counts as a whole one. ``None`` where there is no work."""

    def ceiling(w):
        total = int(w.sum())
        if total == 0:
            return None
        w = torch.nn.functional.pad(w, (0, (-w.numel()) % warp))
        return total / (warp * int(w.view(-1, warp).max(dim=1).values.sum()))

    return {"launch_order": ceiling(work), "compacted": ceiling(work[active])}


class BinaryLayout(NamedTuple):
    """What the binary traversal reads of a scene. ``fetch(node)`` maps node
    indices [n] to ``(ld, rd, lmin, lmax, rmin, rmax)``: the node's two data
    words (int64) and both children's boxes ([n,3] each, arbitrary on a
    leaf). ``w2o`` holds the rows of the 3x4 world->object matrices as
    ``[I, >=3, 4]``; ``roots`` the BLAS root node per instance;
    ``num_nodes`` the length of the node array. ``tris`` is a ``TriArrays``,
    or ``HHRows`` for the ``"hh"`` leaf form."""

    fetch: Callable
    tris: NamedTuple
    w2o: torch.Tensor
    roots: torch.Tensor
    num_nodes: int


def scene_layout(S, tris_hh: Optional[torch.Tensor] = None) -> BinaryLayout:
    """The uploaded scene's own arrays (separate ldata/rdata/min/max); with
    ``tris_hh`` the triangles are those flat Havel–Herout rows instead of
    ``tri_v0/e1/e2``. The kernel ``csrc/intersect.cu`` reads the same bits
    from its own packed copy (``intersect_cuda.k1_layout``)."""

    last = int(S["bvh_ldata"].shape[0]) - 1

    def fetch(node):
        ld = S["bvh_ldata"][node].to(torch.int64)
        rd = S["bvh_rdata"][node].to(torch.int64)
        # a leaf's words are no child indices (a BLAS leaf's rd is its
        # triangle count, which may pass the last node): clamp into the node
        # array as XLA's gather does; a leaf's child boxes are never read
        lc = torch.clamp(ld, 0, last)
        rc = torch.clamp(rd, 0, last)
        return (
            ld, rd, S["bvh_min"][lc], S["bvh_max"][lc],
            S["bvh_min"][rc], S["bvh_max"][rc],
        )

    if tris_hh is None:
        tris = TriArrays(S["tri_v0"], S["tri_e1"], S["tri_e2"])
    else:
        tris = HHRows(tris_hh.reshape(-1, 12))
    return BinaryLayout(
        fetch, tris, S["inst_w2o"], S["inst_bvh_root"],
        int(S["bvh_ldata"].shape[0]),
    )


def intersect_bvh(
    S, o, d, maxt, active, *, any_hit: bool, leaf: str,
    stats: Optional[dict] = None, tris_hh: Optional[torch.Tensor] = None,
) -> Hit:
    """Two-level BVH traversal of the uploaded scene ``S`` for all lanes:
    ``traverse_binary`` over ``scene_layout(S)``. ``leaf`` has no default:
    ``"det2"`` is K1's plain version, ``"hh"`` its Havel–Herout variant's
    (it needs the rows of ``pack_tris_hh`` as ``tris_hh``), ``"quot"`` the
    traversal of ``mode="bvh"``."""
    if (leaf == "hh") != (tris_hh is not None):
        raise ValueError("leaf='hh' and the rows of pack_tris_hh go together")
    return traverse_binary(
        scene_layout(S, tris_hh), o, d, maxt, active, any_hit=any_hit,
        stats=stats, leaf=leaf,
    )


def traverse_binary(
    L: BinaryLayout, o, d, maxt, active, *, any_hit: bool, leaf: str,
    stats: Optional[dict] = None,
) -> Hit:
    """Two-level binary BVH traversal for all lanes, advanced in lock step.

    ``o, d`` [N,3] f32, ``maxt`` [N] f32, ``active`` [N] bool. Returns the
    closest hit per lane; with ``any_hit`` a lane stops at its first hit
    with ``EPS < t < maxt`` and only ``mask`` is meaningful. ``leaf`` names
    the leaf test (``LEAF_TESTS``).

    ``stats``, when given, receives per-call totals of the work the
    traversal did on these rays, counted as one thread per ray would do it:
    ``inner`` (inner-node visits), ``slabs`` (slab tests, two per visit),
    ``tris`` (triangle tests; an any-hit ray stops at its first accepted
    triangle), ``inst`` (instance entries), ``trips`` (host-loop trips), and
    the numbers of distinct records read: ``nodes_touched``,
    ``tris_touched``, ``inst_touched``. When ``stats`` holds ``per_lane``
    set true it also receives each lane's own counts, ``lane_inner`` and
    ``lane_tris`` ([N] int64, summing to ``inner`` and ``tris`` of this
    call), and ``stack_peak``, the most entries any lane's stack held.
    """
    n = o.shape[0]
    dev = o.device
    i32 = torch.int32
    num_inst = L.w2o.shape[0]
    rows = torch.arange(n, device=dev)

    phase = torch.where(active, PHASE_NODE, PHASE_DONE).to(i32)
    node = torch.zeros(n, dtype=torch.int64, device=dev)
    stack = torch.zeros((n, STACK_SIZE), dtype=torch.int64, device=dev)
    sp = torch.zeros(n, dtype=torch.int64, device=dev)
    msbi = torch.full((n,), -1, dtype=torch.int64, device=dev)
    cur_o, cur_d = o, d
    inv = _inv_dir(d)
    inv0 = inv
    inst = torch.zeros(n, dtype=i32, device=dev)
    best_t = torch.where(active, maxt, 0.0).to(torch.float32)
    best_tri = torch.zeros(n, dtype=i32, device=dev)
    best_inst = torch.zeros(n, dtype=i32, device=dev)
    best_u = torch.zeros(n, dtype=torch.float32, device=dev)
    best_v = torch.zeros(n, dtype=torch.float32, device=dev)
    found = torch.zeros(n, dtype=torch.bool, device=dev)
    n_inner = torch.zeros((), dtype=torch.int64, device=dev)
    n_tris = torch.zeros((), dtype=torch.int64, device=dev)
    n_inst = torch.zeros((), dtype=torch.int64, device=dev)
    trips = 0
    touched = None
    per_lane = stats is not None and bool(stats.get("per_lane"))
    if stats is not None:
        touched = Touched(dev, L.num_nodes, num_tris(L.tris), num_inst)
    if per_lane:
        lane_inner = torch.zeros(n, dtype=torch.int64, device=dev)
        lane_tris = torch.zeros(n, dtype=torch.int64, device=dev)
        stack_peak = torch.zeros((), dtype=torch.int64, device=dev)

    while bool((phase != PHASE_DONE).any()):
        trips += 1
        in_node = phase == PHASE_NODE
        node_in = node  # the node each lane holds at the start of this trip
        ld, rd, lmin, lmax, rmin, rmax = L.fetch(node)
        is_leaf = ld <= 0
        is_top = in_node & is_leaf & (rd == 0)
        is_bot = in_node & is_leaf & (rd != 0)
        is_inner = in_node & (~is_leaf)

        # ---------- TLAS leaf: enter the instance BLAS with a transformed ray
        inst_id = torch.clamp(-ld, 0, num_inst - 1)
        w2o = L.w2o[inst_id]
        to = _xform(w2o, cur_o, 1)
        td = _xform(w2o, cur_d, 0)
        top3 = is_top[:, None]
        cur_o = torch.where(top3, to, cur_o)
        cur_d = torch.where(top3, td, cur_d)
        inv = torch.where(top3, _inv_dir(td), inv)
        inst = torch.where(is_top, inst_id.to(i32), inst)
        msbi = torch.where(is_top, sp, msbi)
        node = torch.where(is_top, L.roots[inst_id].to(torch.int64), node)

        # ---------- BLAS leaf: all of its triangles at once, on the lanes
        # that sit at a leaf
        idx = is_bot.nonzero().squeeze(1)
        if idx.numel():
            cnt = rd[idx]
            hit, bt, bu, bv, btri = mt_leaves(
                L.tris, -ld[idx], cnt, cur_o[idx], cur_d[idx], best_t[idx],
                closest=not any_hit, leaf=leaf,
            )
            if any_hit:
                found[idx] = found[idx] | hit
                phase[idx] = torch.where(hit, PHASE_DONE, PHASE_POP).to(i32)
            else:
                hi = idx[hit]
                best_t[hi] = bt[hit]
                best_u[hi] = bu[hit]
                best_v[hi] = bv[hit]
                best_tri[hi] = btri[hit].to(i32)
                best_inst[hi] = inst[hi]
                found[hi] = True
                phase[idx] = PHASE_POP
            if touched is not None:
                tested = tested_in_leaf(hit, btri, -ld[idx], cnt, any_hit=any_hit)
                touched.runs(-ld[idx], tested)
                n_tris += tested.sum()
                if per_lane:
                    lane_tris[idx] += tested

        # ---------- inner node: slab-test both children, near first
        l_dist = _slab_test(cur_o, inv, lmin, lmax, best_t)
        r_dist = _slab_test(cur_o, inv, rmin, rmax, best_t)
        want_l = l_dist < V.FLT_MAX
        want_r = r_dist < V.FLT_MAX
        both = is_inner & want_l & want_r
        near_is_l = l_dist <= r_dist
        near = torch.where(near_is_l, ld, rd)
        far = torch.where(near_is_l, rd, ld)
        one = is_inner & (want_l ^ want_r)
        none = is_inner & (~want_l) & (~want_r)

        sp_c = torch.clamp(sp, 0, STACK_SIZE - 1)
        old = stack[rows, sp_c]
        stack[rows, sp_c] = torch.where(both, far, old)
        sp = torch.where(both, sp + 1, sp)
        if per_lane:
            stack_peak = torch.maximum(stack_peak, sp.max())
        node = torch.where(both, near, node)
        node = torch.where(one, torch.where(want_l, ld, rd), node)
        phase = torch.where(none, PHASE_POP, phase)

        # ---------- pop (restore the ray when leaving a BLAS)
        in_pop = phase == PHASE_POP
        restore = (in_pop & (sp == msbi))[:, None]
        cur_o = torch.where(restore, o, cur_o)
        cur_d = torch.where(restore, d, cur_d)
        inv = torch.where(restore, inv0, inv)
        msbi = torch.where(restore[:, 0], -1, msbi)
        sp = torch.where(in_pop, sp - 1, sp)
        popped = stack[rows, torch.clamp(sp, 0, STACK_SIZE - 1)]
        node = torch.where(in_pop & (sp >= 0), popped, node)
        phase = torch.where(
            in_pop, torch.where(sp >= 0, PHASE_NODE, PHASE_DONE), phase
        ).to(i32)

        if touched is not None:
            touched.nodes[node_in[in_node]] = True
            touched.inst[inst_id[is_top]] = True
            n_inner += is_inner.sum()
            n_inst += is_top.sum()
            if per_lane:
                lane_inner += is_inner

    if stats is not None:
        stats["inner"] = stats.get("inner", 0) + int(n_inner)
        stats["slabs"] = stats.get("slabs", 0) + 2 * int(n_inner)
        stats["tris"] = stats.get("tris", 0) + int(n_tris)
        stats["inst"] = stats.get("inst", 0) + int(n_inst)
        stats["trips"] = stats.get("trips", 0) + trips
        touched.add_to(stats)
    if per_lane:
        stats["lane_inner"], stats["lane_tris"] = lane_inner, lane_tris
        stats["stack_peak"] = int(stack_peak)

    t = torch.where(found, best_t, 0.0)
    return Hit(t, best_inst, best_tri, best_u, best_v, active & found)


# ----------------------------------------------------------------- brute mode


def instance_tri_ranges(scene) -> tuple:
    """``(first_tri, num_tris)`` of each instance's BLAS, which must be one
    contiguous run of triangles. The BLAS walk is the NumPy oracle's, as in
    the JAX package's ``brute`` mode."""
    from ..cpu_ref.renderer import _collect_blas_triangles

    ranges = []
    for root in scene.inst_bvh_root:
        tris = _collect_blas_triangles(scene, int(root))
        first, count = int(tris.min()), int(tris.size)
        if tris.max() - first + 1 != count:
            raise ValueError("BLAS triangle range is not contiguous")
        ranges.append((first, count))
    return tuple(ranges)


def intersect_brute(S, o, d, maxt, active, *, inst_tri_ranges, chunk: int = 8192) -> Hit:
    """Closest hit over every triangle of every instance, without a BVH: the
    JAX package's ``intersect_brute``. Rays go ``chunk`` at a time, and each
    chunk tests each instance's run of triangles densely (``mt_block``, the
    quotient-form test of its ``_mt_dense``), the best ``t`` so far the
    upper bound of the next instance. Fixed shapes and no host read, so it
    can be captured into a CUDA graph."""
    T = TriArrays(S["tri_v0"], S["tri_e1"], S["tri_e2"])
    w2o = S["inst_w2o"]
    best_t = torch.where(active, maxt, 0.0).to(torch.float32)
    n = o.shape[0]
    dev = o.device
    best_tri = torch.zeros(n, dtype=torch.int32, device=dev)
    best_inst = torch.zeros(n, dtype=torch.int32, device=dev)
    best_u = torch.zeros(n, dtype=torch.float32, device=dev)
    best_v = torch.zeros(n, dtype=torch.float32, device=dev)
    found = torch.zeros(n, dtype=torch.bool, device=dev)
    for c0 in range(0, n, chunk):
        rows = slice(c0, min(c0 + chunk, n))
        co, cd = o[rows], d[rows]
        m = co.shape[0]
        for ii, (first, count) in enumerate(inst_tri_ranges):
            mat = w2o[ii:ii + 1].expand(m, -1, -1)
            oo = _xform(mat, co, 1)
            dd = _xform(mat, cd, 0)
            tri = torch.arange(first, first + count, device=dev).expand(m, count)
            valid = torch.ones((1, 1), dtype=torch.bool, device=dev)
            upd, t, u, v, btri = mt_block(T, tri, valid, oo, dd, best_t[rows], closest=True)
            best_t[rows] = torch.where(upd, t, best_t[rows])
            best_tri[rows] = torch.where(upd, btri.to(torch.int32), best_tri[rows])
            best_inst[rows] = torch.where(upd, ii, best_inst[rows])
            best_u[rows] = torch.where(upd, u, best_u[rows])
            best_v[rows] = torch.where(upd, v, best_v[rows])
            found[rows] |= upd
    t = torch.where(found, best_t, 0.0)
    return Hit(t, best_inst, best_tri, best_u, best_v, active & found)


# the fields of a compiled scene the traversal packers read
_GEOMETRY = (
    "bvh_ldata", "bvh_rdata", "bvh_min", "bvh_max", "tri_v0", "tri_e1",
    "tri_e2", "inst_w2o", "inst_bvh_root",
)

# 'auto' on a CUDA scene takes the binary kernel K1 at every size: on the
# H100 it leads the 8-wide record kernel K2 on primary and on bounce rays of
# every scene of the mode-by-scene grid (PERF.md, chip_smoke.py phase 'grid':
# sphere, instanced and procedural terrains of 20k to 819k triangles), also
# after K2 took K1's schedule. The grid holds terrains of one generator only,
# and while the frame is bound by the host the choice moves no end-to-end
# time: place it again, on other kinds of scene too, once it is not

MODES = (
    "auto", "kernel", "pallas", "bvh", "pallas_stream", "pallas_nodes", "pallas8",
    "pallas8_nodes", "pallas_dense", "hybrid", "packet", "brute",
)

# the modes that run the binary kernel K1, the only kernel with two triangle
# tests ('auto' resolves to one of them)
K1_MODES = ("kernel", "pallas_stream")

TRI_TESTS = ("mt", "hh")


def resolve_tri_test(tri_test: Optional[str]) -> str:
    """``tri_test`` or, when it is ``None``, the environment variable
    ``POLARIS_TRI_TEST`` (default ``mt``), read when K1's scene is packed as
    the JAX package reads it."""
    if tri_test is None:
        tri_test = os.environ.get("POLARIS_TRI_TEST", "mt")
    if tri_test not in TRI_TESTS:
        raise ValueError(f"unknown triangle test {tri_test!r} ({' | '.join(TRI_TESTS)})")
    return tri_test


def make_intersectors(S, mode: str = "auto", tri_test: Optional[str] = None):
    """Build ``(closest_hit, any_hit)`` callables for an uploaded scene.

    ``tri_test`` picks the binary kernel's triangle test: ``"mt"`` (det²-scaled
    Möller–Trumbore over ``tri_v0/e1/e2``) or ``"hh"`` (Havel–Herout planes,
    packed here into 12-float rows). It applies where K1 runs: the modes
    'kernel', 'pallas' and 'pallas_stream', 'auto' (which resolves to K1 or
    its plain version) and the primary rays of 'hybrid'. ``None`` reads
    ``POLARIS_TRI_TEST`` for those modes and, as the JAX package, ignores it
    for every other; an explicit ``"hh"`` with a mode that does not run K1
    raises.

    mode (the names of the JAX package's ``make_intersectors`` where there
    is a counterpart):
      'kernel'        the binary CUDA traversal kernel K1 over its own
                      packed copy of the scene (``intersect_cuda``). CUDA
                      tensors only.
      'pallas'        the JAX package's name of 'kernel'; the same
      'pallas_stream' the same kernel: on a GPU every scene array already
                      lies in global memory behind L2, so the kernel that
                      leaves the triangles in device memory is 'kernel'
      'pallas_nodes'  binary BVH as 16-float records in depth order
                      (``intersect_nodes``)
      'pallas8'       8-wide BVH, boxes and entries apart (``intersect_wide8``)
      'pallas8_nodes' 8-wide BVH as 64-float records in depth order, the
                      big-scene kernel (``intersect_wide8_nodes``)
      'pallas_dense'  no BVH, every triangle, at most 4096 of them
                      (``intersect_dense``)
      'hybrid'        'pallas_stream' for primary rays; 'pallas_dense' for
                      bounce rays (``closest.closest_bounce``) and shadow rays
      'bvh'           the plain PyTorch binary traversal above with the
                      quotient-form triangle test, as the JAX package's
                      'bvh' (any device). It reads its loop test back to
                      the host
      'auto'          on a CUDA device 'kernel' at every size (K1 leads
                      K2 on every scene the grid times); on the CPU the
                      binary kernel's wrappers, which run its plain version
                      there
      'packet'        the JAX package's XLA twin of its binary kernel in
                      plain PyTorch (``intersect_packet``): tiles of 64
                      rays sharing one stack. It reads its
                      loop test back to the host, as 'bvh' does
      'brute'         no BVH: every triangle of every instance, quotient
                      form, rays in chunks of 8192
                      (``intersect_brute``; fixed shapes, any device, and
                      capturable into a CUDA graph)

    The scene is packed once here, on the host, and the packed arrays are
    uploaded to the scene's device. A mode with a CUDA kernel runs that
    kernel's plain PyTorch version when the scene lives on the CPU; only
    'kernel' insists on a card and raises without one.

    Both callables take ``(S, o, d, maxt, active)``; ``closest_hit`` returns
    a ``Hit``, ``any_hit`` the occlusion mask. The callables of a traversal
    that reads its loop test back to the host ('bvh', 'packet') carry
    ``reads_back = True``: a CUDA graph cannot capture them, so a renderer
    runs their steps uncaptured (``render/graph.py::Step``).
    """
    device = S["bvh_ldata"].device
    if mode not in MODES:
        raise ValueError(f"unknown traversal mode {mode!r} ({' | '.join(MODES)})")
    if mode == "auto":
        mode = "kernel" if device.type == "cuda" else "pallas_stream"
    elif mode == "pallas":
        mode = "kernel"
    if mode in K1_MODES or mode == "hybrid":
        tri_test = resolve_tri_test(tri_test)
    elif tri_test is not None:
        resolve_tri_test(tri_test)  # an unknown name raises as such
        if tri_test == "hh":
            raise ValueError(
                f"tri_test='hh' is a test of the binary kernel; mode {mode!r} "
                "has none (use 'kernel', 'pallas_stream', 'hybrid' or 'auto')"
            )

    if mode in K1_MODES:
        from . import intersect_cuda

        if mode == "kernel" and device.type != "cuda":
            raise ValueError(
                "mode='kernel' needs the scene on a CUDA device, got "
                f"{device}; use mode='bvh' for the plain PyTorch traversal"
            )
        return intersect_cuda.intersectors(S, tri_test)

    if mode == "bvh":

        def closest(S, o, d, maxt, active):
            return intersect_bvh(S, o, d, maxt, active, any_hit=False, leaf="quot")

        def any_hit(S, o, d, maxt, active):
            return intersect_bvh(S, o, d, maxt, active, any_hit=True, leaf="quot").mask

        closest.reads_back = any_hit.reads_back = True
        return closest, any_hit

    if mode == "packet":
        from .intersect_packet import intersect_packet

        def closest(S, o, d, maxt, active):
            return intersect_packet(S, o, d, maxt, active, any_hit=False)

        def any_hit(S, o, d, maxt, active):
            return intersect_packet(S, o, d, maxt, active, any_hit=True).mask

        closest.reads_back = any_hit.reads_back = True
        return closest, any_hit

    if mode == "brute":
        ranges = instance_tri_ranges(host_geometry(S))

        def closest(S, o, d, maxt, active):
            return intersect_brute(S, o, d, maxt, active, inst_tri_ranges=ranges)

        def any_hit(S, o, d, maxt, active):
            return closest(S, o, d, maxt, active).mask

        return closest, any_hit

    if mode == "hybrid":
        # K1 (with its packed scene and triangle test) for primary rays, the
        # dense kernel for bounce and shadow rays
        closest, _ = make_intersectors(S, "pallas_stream", tri_test)
        closest.closest_bounce, any_hit_dense = make_intersectors(S, "pallas_dense")
        return closest, any_hit_dense

    import importlib

    from ._launch import upload_packed

    # the module, its packer (equal to the JAX packer's arrays) and the
    # packer of the buffer the kernel reads
    module_name, packer, own = {
        "pallas_nodes": ("intersect_nodes", "pack_scene_nodes", "pack_scene_k3"),
        "pallas8": ("intersect_wide8", "pack_scene8", "pack_scene_k4"),
        "pallas8_nodes": ("intersect_wide8_nodes", "pack_scene8_nodes", "pack_scene_k2"),
        "pallas_dense": ("intersect_dense", "pack_scene_dense", "pack_scene_k5"),
    }[mode]
    module = importlib.import_module(f"{__package__}.{module_name}")
    host = getattr(module, packer)(host_geometry(S))
    host.update(getattr(module, own)(host))
    P = upload_packed(host, device)

    def closest(S, o, d, maxt, active):
        return module.closest_hit(P, o, d, maxt, active)

    def any_hit(S, o, d, maxt, active):
        return module.any_hit(P, o, d, maxt, active)

    closest.packed = P
    return closest, any_hit


def host_geometry(S):
    """The geometry fields of an uploaded scene back on the host, as the
    attribute bag the packers read."""
    from types import SimpleNamespace

    return SimpleNamespace(**{k: S[k].cpu().numpy() for k in _GEOMETRY})
