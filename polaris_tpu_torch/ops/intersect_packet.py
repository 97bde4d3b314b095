"""Tile-coherent ("packet") two-level BVH traversal in plain PyTorch.

Counterpart of the JAX package's ``ops/intersect_packet.py``, the XLA twin
of its binary Pallas kernel and its ``auto`` traversal off the TPU, itself
after the reference's packet kernel (``rayPacketIntersectionQuery``,
CL/kernels/intersect.cl:353-575):

  * rays are grouped into tiles of ``rays_per_tile`` rays; each tile keeps
    ONE stack and ONE cursor, so the per-step state updates are [T]-sized
  * a tile descends into a child if ANY of its live rays' slab test passes,
    nearest child first by the tile's minimum slab distance
  * a leaf's triangles are gathered once per tile and every ray of the tile
    tests all of them densely, a masked [T, R, MAX_LEAF] operation in the
    quotient form of Möller–Trumbore

The JAX loop is a ``lax.while_loop``; here a host loop that reads its test
back every trip, as ``intersect.py::traverse_binary`` does, so it cannot be
captured into a CUDA graph. The hits equal those of the per-ray traversals
but on exact ties (a ray through a shared edge), where the order in which
the tile visits leaves picks the triangle.
"""

from __future__ import annotations

import torch

from ..asset.compiler.compiler import MIN_PRIMITIVES_PER_LEAF as MAX_LEAF
from . import vec as V
from .intersect import Hit

STACK_SIZE = 64

PHASE_NODE = 0
PHASE_POP = 1
PHASE_DONE = 2


def _slab(o, d, bmin, bmax, best_t):
    """Per-ray slab test against a per-tile box: o, d [T,R,3]; bmin, bmax
    [T,3]. Returns the entry distance, FLT_MAX for a miss
    (intersect.cl:135-155)."""
    floor = torch.where(d < 0, -1e-30, 1e-30)
    inv = 1.0 / torch.where(torch.abs(d) < 1e-30, floor, d)
    t0 = (bmin[:, None, :] - o) * inv
    t1 = (bmax[:, None, :] - o) * inv
    tmin = torch.minimum(t0, t1)
    tmax = torch.maximum(t0, t1)
    minmax = tmax.min(dim=-1).values
    maxmin = tmin.max(dim=-1).values
    miss = (minmax < 0.0) | (maxmin > minmax) | (maxmin >= best_t)
    return torch.where(miss, V.FLT_MAX, maxmin)


def intersect_packet(S, o, d, maxt, active, *, any_hit: bool, rays_per_tile: int = 64) -> Hit:
    """Closest hit (or any hit) over tiles of rays with shared stacks.

    ``o, d`` [N,3] f32, ``maxt`` [N] f32, ``active`` [N] bool; ``N`` is
    padded to a multiple of ``rays_per_tile`` with inactive rays."""
    n = o.shape[0]
    R = rays_per_tile
    pad = (-n) % R
    if pad:
        o = torch.nn.functional.pad(o, (0, 0, 0, pad))
        d = torch.nn.functional.pad(d, (0, 0, 0, pad), value=1.0)
        maxt = torch.nn.functional.pad(maxt, (0, pad))
        active = torch.nn.functional.pad(active, (0, pad))
    dev = o.device
    T = o.shape[0] // R
    o3 = o.reshape(T, R, 3)
    d3 = d.reshape(T, R, 3)
    act = active.reshape(T, R)
    rows = torch.arange(T, device=dev)
    i32, f32 = torch.int32, torch.float32

    phase = torch.where(act.any(dim=1), PHASE_NODE, PHASE_DONE).to(i32)
    node = torch.zeros(T, dtype=torch.int64, device=dev)
    stack = torch.zeros((T, STACK_SIZE), dtype=torch.int64, device=dev)
    sp = torch.zeros(T, dtype=torch.int64, device=dev)
    msbi = torch.full((T,), -1, dtype=torch.int64, device=dev)
    inst = torch.zeros(T, dtype=torch.int64, device=dev)
    cur_o, cur_d = o3, d3
    best_t = torch.where(act, maxt.reshape(T, R), 0.0).to(f32)
    best_tri = torch.zeros((T, R), dtype=i32, device=dev)
    best_inst = torch.zeros((T, R), dtype=i32, device=dev)
    best_u = torch.zeros((T, R), dtype=f32, device=dev)
    best_v = torch.zeros((T, R), dtype=f32, device=dev)
    found = torch.zeros((T, R), dtype=torch.bool, device=dev)

    num_tris = S["tri_v0"].shape[0]
    num_inst = S["inst_w2o"].shape[0]
    num_nodes = S["bvh_ldata"].shape[0]
    leaf_js = torch.arange(MAX_LEAF, device=dev)

    while bool((phase != PHASE_DONE).any()):
        in_node = phase == PHASE_NODE
        ld = S["bvh_ldata"][node].to(torch.int64)
        rd = S["bvh_rdata"][node].to(torch.int64)
        is_leaf = ld <= 0
        is_top = in_node & is_leaf & (rd == 0)
        is_bot = in_node & is_leaf & (rd > 0)
        is_inner = in_node & (~is_leaf)

        # per-ray participation: any-hit rays retire once occluded
        ray_live = act & ~found if any_hit else act

        # ---- TLAS leaf: enter the instance's BLAS (intersect.cl:74-88)
        inst_id = torch.clamp(-ld, 0, num_inst - 1)
        w2o = S["inst_w2o"][inst_id]  # [T,4,4]
        rot = w2o[:, :3, :3]
        to = V.dot3(rot[:, None], cur_o[:, :, None, :]) + w2o[:, None, :3, 3]
        td = V.dot3(rot[:, None], cur_d[:, :, None, :])
        sel = is_top[:, None, None]
        cur_o = torch.where(sel, to, cur_o)
        cur_d = torch.where(sel, td, cur_d)
        inst = torch.where(is_top, inst_id, inst)
        msbi = torch.where(is_top, sp, msbi)
        node = torch.where(is_top, S["inst_bvh_root"][inst_id].to(torch.int64), node)

        # ---- BLAS leaf: dense Möller–Trumbore over MAX_LEAF triangles
        first = torch.clamp(-ld, min=0)
        tri_idx = torch.clamp(first[:, None] + leaf_js[None, :], 0, num_tris - 1)
        jmask = leaf_js[None, :] < rd[:, None]  # [T, L]
        v0 = S["tri_v0"][tri_idx][:, None]  # [T, 1, L, 3]
        e1 = S["tri_e1"][tri_idx][:, None]
        e2 = S["tri_e2"][tri_idx][:, None]
        co = cur_o[:, :, None, :]  # [T, R, 1, 3]
        cd = cur_d[:, :, None, :]
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
        ok &= (tt > V.INTERSECTION_EPSILON) & (tt < best_t[:, :, None])
        ok &= jmask[:, None, :] & is_bot[:, None, None] & ray_live[:, :, None]
        tt = torch.where(ok, tt, float("inf"))  # [T, R, L]
        t_best, j_best = tt.min(dim=-1)
        # min's index on a tie is not promised to be the first: take the
        # first minimum, as jnp.argmin does
        j_best = torch.where(tt == t_best[..., None], leaf_js, MAX_LEAF).min(dim=-1).values
        j_best = torch.clamp(j_best, max=MAX_LEAF - 1)
        upd = torch.isfinite(t_best)
        best_t = torch.where(upd, t_best, best_t)
        best_tri = torch.where(upd, (first[:, None] + j_best).to(i32), best_tri)
        best_inst = torch.where(upd, inst[:, None].to(i32), best_inst)
        ru = uu.gather(-1, j_best[..., None])[..., 0]
        rv = vv.gather(-1, j_best[..., None])[..., 0]
        best_u = torch.where(upd, ru, best_u)
        best_v = torch.where(upd, rv, best_v)
        found = found | upd
        phase = torch.where(is_bot, PHASE_POP, phase)
        if any_hit:
            ray_live = ray_live & ~found

        # ---- inner node: the tile's slab vote (intersect.cl:510-540)
        # a leaf's words are no child indices (a BLAS leaf's rd counts its
        # triangles): clamp into the node array as XLA's gather does
        lc = torch.clamp(ld, 0, num_nodes - 1)
        rc = torch.clamp(rd, 0, num_nodes - 1)
        lmin, lmax = S["bvh_min"][lc], S["bvh_max"][lc]
        rmin, rmax = S["bvh_min"][rc], S["bvh_max"][rc]
        l_dist = torch.where(ray_live, _slab(cur_o, cur_d, lmin, lmax, best_t), V.FLT_MAX)
        r_dist = torch.where(ray_live, _slab(cur_o, cur_d, rmin, rmax, best_t), V.FLT_MAX)
        l_min = l_dist.min(dim=1).values
        r_min = r_dist.min(dim=1).values
        want_l = is_inner & (l_min < V.FLT_MAX)
        want_r = is_inner & (r_min < V.FLT_MAX)
        both = want_l & want_r
        near_is_l = l_min <= r_min
        near = torch.where(near_is_l, ld, rd)
        far = torch.where(near_is_l, rd, ld)

        sp_c = torch.clamp(sp, 0, STACK_SIZE - 1)
        stack[rows, sp_c] = torch.where(both, far, stack[rows, sp_c])
        sp = torch.where(both, sp + 1, sp)
        node = torch.where(both, near, node)
        node = torch.where(want_l ^ want_r, torch.where(want_l, ld, rd), node)
        phase = torch.where(is_inner & ~(want_l | want_r), PHASE_POP, phase)
        if any_hit:
            # every ray of the tile is occluded
            phase = torch.where(in_node & ~ray_live.any(dim=1), PHASE_DONE, phase)

        # ---- pop (intersect.cl:163-176)
        in_pop = phase == PHASE_POP
        restore = (in_pop & (sp == msbi))[:, None, None]
        cur_o = torch.where(restore, o3, cur_o)
        cur_d = torch.where(restore, d3, cur_d)
        msbi = torch.where(restore[:, 0, 0], -1, msbi)
        sp = torch.where(in_pop, sp - 1, sp)
        popped = stack[rows, torch.clamp(sp, 0, STACK_SIZE - 1)]
        node = torch.where(in_pop & (sp >= 0), popped, node)
        phase = torch.where(
            in_pop, torch.where(sp >= 0, PHASE_NODE, PHASE_DONE), phase
        ).to(i32)

    found = found.reshape(-1)[:n]
    t = torch.where(found, best_t.reshape(-1)[:n], 0.0)
    return Hit(
        t,
        best_inst.reshape(-1)[:n],
        best_tri.reshape(-1)[:n],
        best_u.reshape(-1)[:n],
        best_v.reshape(-1)[:n],
        active[:n] & found,
    )
