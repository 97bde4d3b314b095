"""Ray/scene intersection: two-level BVH traversal in plain PyTorch, and the
dispatch that picks between it and the hand-written CUDA kernel.

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
distances, quotient-form Möller–Trumbore, strict ``<`` best-hit updates —
with every lane advanced in lock step by a host loop. Its float operations
are written in the same association as the kernel's, so the two agree bit
for bit wherever the device rounds each multiply and add separately.

Each trip of the host loop advances every live lane by one node: an inner
node slab-tests both children, a TLAS leaf enters an instance, a BLAS leaf
tests ALL of its triangles at once (dense ``[lanes, leaf]`` arithmetic
instead of one triangle per trip; first-minimum selection keeps the
sequential strict-``<`` result).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

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


def intersect_bvh(
    S, o, d, maxt, active, *, any_hit: bool, stats: Optional[dict] = None
) -> Hit:
    """Two-level BVH traversal for all lanes, advanced in lock step.

    ``o, d`` [N,3] f32, ``maxt`` [N] f32, ``active`` [N] bool. Returns the
    closest hit per lane; with ``any_hit`` a lane stops at its first hit
    with ``EPS < t < maxt`` and only ``mask`` is meaningful.

    ``stats``, when given, receives per-call totals of the work the
    traversal did on these rays: ``inner`` (inner-node visits, two slab
    tests each), ``tris`` (triangle tests), ``inst`` (instance entries),
    ``trips`` (host-loop trips).
    """
    n = o.shape[0]
    dev = o.device
    i32 = torch.int32
    num_tris = S["tri_v0"].shape[0]
    num_inst = S["inst_w2o"].shape[0]
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

    while bool((phase != PHASE_DONE).any()):
        trips += 1
        in_node = phase == PHASE_NODE
        ld = S["bvh_ldata"][node].to(torch.int64)
        rd = S["bvh_rdata"][node].to(torch.int64)
        is_leaf = ld <= 0
        is_top = in_node & is_leaf & (rd == 0)
        is_bot = in_node & is_leaf & (rd != 0)
        is_inner = in_node & (~is_leaf)

        # ---------- TLAS leaf: enter the instance BLAS with a transformed ray
        inst_id = torch.clamp(-ld, 0, num_inst - 1)
        w2o = S["inst_w2o"][inst_id]
        to = _xform(w2o, cur_o, 1)
        td = _xform(w2o, cur_d, 0)
        top3 = is_top[:, None]
        cur_o = torch.where(top3, to, cur_o)
        cur_d = torch.where(top3, td, cur_d)
        inv = torch.where(top3, _inv_dir(td), inv)
        inst = torch.where(is_top, inst_id.to(i32), inst)
        msbi = torch.where(is_top, sp, msbi)
        node = torch.where(
            is_top, S["inst_bvh_root"][inst_id].to(torch.int64), node
        )

        # ---------- BLAS leaf: all of its triangles at once, on the lanes
        # that sit at a leaf (Möller–Trumbore, intersect.cl:90-125)
        idx = is_bot.nonzero().squeeze(1)
        if idx.numel():
            first = -ld[idx]
            cnt = rd[idx]
            width = max(int(cnt.max()), 1)
            j = torch.arange(width, device=dev)
            tri = torch.clamp(first[:, None] + j[None, :], max=num_tris - 1)
            valid = j[None, :] < cnt[:, None]
            v0 = S["tri_v0"][tri]
            e1 = S["tri_e1"][tri]
            e2 = S["tri_e2"][tri]
            co = cur_o[idx][:, None, :]
            cd = cur_d[idx][:, None, :].expand_as(v0)
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
            ok &= (tt > V.INTERSECTION_EPSILON) & (tt < best_t[idx][:, None])
            ok &= valid
            hit = ok.any(dim=1)
            if any_hit:
                found[idx] = found[idx] | hit
                phase[idx] = torch.where(hit, PHASE_DONE, PHASE_POP).to(i32)
            else:
                # sequential strict-< updates == the FIRST minimal t
                tt_m = torch.where(ok, tt, float("inf"))
                bt = tt_m.min(dim=1).values
                bj = torch.where(
                    tt_m == bt[:, None], j[None, :], width
                ).min(dim=1).values
                bj = torch.clamp(bj, max=width - 1)[:, None]
                hi = idx[hit]
                best_t[hi] = bt[hit]
                best_u[hi] = uu.gather(1, bj)[:, 0][hit]
                best_v[hi] = vv.gather(1, bj)[:, 0][hit]
                best_tri[hi] = tri.gather(1, bj)[:, 0][hit].to(i32)
                best_inst[hi] = inst[hi]
                found[hi] = True
                phase[idx] = PHASE_POP
            n_tris += cnt.sum()

        # ---------- inner node: slab-test both children, near first
        lc = torch.clamp(ld, min=0)
        rc = torch.clamp(rd, min=0)
        l_dist = _slab_test(cur_o, inv, S["bvh_min"][lc], S["bvh_max"][lc], best_t)
        r_dist = _slab_test(cur_o, inv, S["bvh_min"][rc], S["bvh_max"][rc], best_t)
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

        n_inner += is_inner.sum()
        n_inst += is_top.sum()

    if stats is not None:
        stats["inner"] = stats.get("inner", 0) + int(n_inner)
        stats["tris"] = stats.get("tris", 0) + int(n_tris)
        stats["inst"] = stats.get("inst", 0) + int(n_inst)
        stats["trips"] = stats.get("trips", 0) + trips

    t = torch.where(found, best_t, 0.0)
    return Hit(t, best_inst, best_tri, best_u, best_v, active & found)


def make_intersectors(S, mode: str = "auto"):
    """Build ``(closest_hit, any_hit)`` callables for an uploaded scene.

    mode:
      'kernel' — the hand-written CUDA traversal kernel (CUDA tensors only)
      'bvh'    — the plain PyTorch traversal above (any device)
      'auto'   — 'kernel' when the scene lives on a CUDA device, else 'bvh'

    Both callables take ``(S, o, d, maxt, active)``; ``closest_hit`` returns
    a ``Hit``, ``any_hit`` the occlusion mask.
    """
    device = S["bvh_ldata"].device
    if mode == "auto":
        mode = "kernel" if device.type == "cuda" else "bvh"

    if mode == "kernel":
        from . import intersect_cuda

        if device.type != "cuda":
            raise ValueError(
                "mode='kernel' needs the scene on a CUDA device, got "
                f"{device}; use mode='bvh' for the plain PyTorch traversal"
            )
        return intersect_cuda.closest_hit, intersect_cuda.any_hit

    if mode == "bvh":

        def closest(S, o, d, maxt, active):
            return intersect_bvh(S, o, d, maxt, active, any_hit=False)

        def any_hit(S, o, d, maxt, active):
            return intersect_bvh(S, o, d, maxt, active, any_hit=True).mask

        return closest, any_hit

    raise ValueError(f"unknown traversal mode {mode!r} (auto | kernel | bvh)")
