"""A plain PyTorch walk of the benchmark's BVH (`roofline/bvh.py`) that
counts its work: the counting traversal of the traversal roofline, and the
intersector of the reference renderer.

Frozen from `traverse_binary` and `mt_block` of
polaris_tpu_torch/ops/intersect.py at commit 70823ee, cut to one level (the
benchmark's scenes have identity instances, so its BVH holds world-space
triangles): one stack per ray, an inner visit slab-tests both children
against the ray's best distance and pushes the far one under the near one,
a leaf tests its triangles with the quotient Moller-Trumbore test and keeps
the first of least distance; an any-hit ray stops at its first accepted
triangle. The counts are those of the one-thread-per-ray walk: inner visits
(two slab tests each), triangle tests (an any-hit ray up to and including
the one it stops at) and the distinct node records and triangles read.

Each trip of the host loop works on the rays whose stack is not empty,
gathered by index, and reads one flag back to the host.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from .bvh import LEAF_TRIS, Bvh

EPS = 1e-5
FLT_MAX = 3.4028234663852886e38
STACK = 64


class Hit(NamedTuple):
    t: torch.Tensor  # 0 where there is no hit
    tri: torch.Tensor  # int64 triangle index into the scene's arrays
    u: torch.Tensor
    v: torch.Tensor
    mask: torch.Tensor


def dot3(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def cross3(a, b):
    return torch.stack(
        [
            a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
            a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
            a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0],
        ],
        dim=-1,
    )


def inv_dir(d):
    """1/d with the 1e-30 direction floor."""
    floor = torch.where(d < 0, -1e-30, 1e-30).to(d.dtype)
    return 1.0 / torch.where(torch.abs(d) < 1e-30, floor, d)


def slab(o, inv, lo, hi, best_t):
    """Entry distance of each ray into its box, infinity on a miss."""
    t0 = (lo - o) * inv
    t1 = (hi - o) * inv
    tmin = torch.minimum(t0, t1)
    tmax = torch.maximum(t0, t1)
    tn = torch.maximum(torch.maximum(tmin[:, 0], tmin[:, 1]), tmin[:, 2])
    tf = torch.minimum(torch.minimum(tmax[:, 0], tmax[:, 1]), tmax[:, 2])
    miss = (tf < 0.0) | (tn > tf) | (tn >= best_t)
    return torch.where(miss, torch.full_like(tn, float("inf")), tn)


def moller_trumbore(v0, e1, e2, o, d, best_t):
    """Rays [M,3] against [M,W,3] triangles: (accepted [M,W], t, u, v)."""
    co = o[:, None, :]
    cd = d[:, None, :].expand_as(v0)
    pvec = cross3(cd, e2)
    det = dot3(e1, pvec)
    ok = torch.abs(det) >= EPS
    inv_det = 1.0 / torch.where(ok, det, torch.ones_like(det))
    tvec = co - v0
    u = dot3(tvec, pvec) * inv_det
    ok &= (u >= 0.0) & (u <= 1.0)
    qvec = cross3(tvec, e1)
    v = dot3(cd, qvec) * inv_det
    ok &= (v >= 0.0) & (u + v <= 1.0)
    t = dot3(e2, qvec) * inv_det
    ok &= (t > EPS) & (t < best_t[:, None])
    return ok, t, u, v


class Traverser:
    """The BVH and its triangles on a device, in ``dtype``."""

    def __init__(self, bvh: Bvh, v0: np.ndarray, e1: np.ndarray, e2: np.ndarray,
                 device, dtype=torch.float32):
        def f(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(device=device, dtype=dtype)

        def i(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(device=device, dtype=torch.int64)

        self.bmin, self.bmax = f(bvh.bmin), f(bvh.bmax)
        self.left, self.first, self.count = i(bvh.left), i(bvh.first), i(bvh.count)
        self.order = i(bvh.order)
        self.v0, self.e1, self.e2 = f(v0[bvh.order]), f(e1[bvh.order]), f(e2[bvh.order])
        self.num_nodes = bvh.num_nodes
        self.num_tris = int(v0.shape[0])
        self.device, self.dtype = torch.device(device), dtype

    def closest(self, o, d, maxt, active, stats: Optional[dict] = None) -> Hit:
        return self._walk(o, d, maxt, active, False, stats)

    def any_hit(self, o, d, maxt, active, stats: Optional[dict] = None) -> torch.Tensor:
        return self._walk(o, d, maxt, active, True, stats).mask

    def _walk(self, o, d, maxt, active, any_hit: bool, stats: Optional[dict]) -> Hit:
        n, dev = o.shape[0], o.device
        o, d = o.to(self.dtype), d.to(self.dtype)
        best_t = torch.where(active, maxt.to(self.dtype), torch.zeros_like(maxt, dtype=self.dtype))
        best_slot = torch.zeros(n, dtype=torch.int64, device=dev)
        best_u = torch.zeros(n, dtype=self.dtype, device=dev)
        best_v = torch.zeros(n, dtype=self.dtype, device=dev)
        found = torch.zeros(n, dtype=torch.bool, device=dev)
        stack = torch.zeros((n, STACK), dtype=torch.int64, device=dev)
        sp = active.to(torch.int64)
        inv = inv_dir(d)
        k = torch.arange(LEAF_TRIS, device=dev)
        if stats is not None:
            nodes_seen = torch.zeros(self.num_nodes, dtype=torch.bool, device=dev)
            tris_seen = torch.zeros(self.num_tris, dtype=torch.bool, device=dev)
            n_inner = torch.zeros((), dtype=torch.int64, device=dev)
            n_tris = torch.zeros((), dtype=torch.int64, device=dev)
            trips = 0
        while True:
            live = (sp > 0).nonzero().squeeze(1)
            if live.numel() == 0:
                break
            sp[live] -= 1
            node = stack[live, sp[live]]
            cnt = self.count[node]
            leaf = cnt > 0
            if stats is not None:
                nodes_seen[node] = True
                trips += 1

            lr, ln = live[leaf], node[leaf]
            if lr.numel():
                c = cnt[leaf]
                slot = torch.clamp(self.first[ln][:, None] + k[None, :], max=self.num_tris - 1)
                valid = k[None, :] < c[:, None]
                ok, t, u, v = moller_trumbore(
                    self.v0[slot], self.e1[slot], self.e2[slot], o[lr], d[lr], best_t[lr]
                )
                ok &= valid
                hit = ok.any(dim=1)
                if any_hit:
                    j = torch.where(ok, k[None, :], LEAF_TRIS).min(dim=1).values
                    tested = torch.where(hit, j + 1, c)
                    found[lr] |= hit
                    sp[lr[hit]] = 0
                else:
                    tested = c
                    tm = torch.where(ok, t, torch.full_like(t, float("inf")))
                    j = tm.argmin(dim=1)
                    rows = torch.arange(lr.numel(), device=dev)
                    h = lr[hit]
                    best_t[h] = tm[rows, j][hit]
                    best_u[h] = u[rows, j][hit]
                    best_v[h] = v[rows, j][hit]
                    best_slot[h] = slot[rows, j][hit]
                    found[h] = True
                if stats is not None:
                    n_tris += tested.sum()
                    tris_seen[slot[k[None, :] < tested[:, None]]] = True

            ir, inn = live[~leaf], node[~leaf]
            if ir.numel():
                lc = self.left[inn]
                rc = lc + 1
                oi, vi, bt = o[ir], inv[ir], best_t[ir]
                tl = slab(oi, vi, self.bmin[lc], self.bmax[lc], bt)
                tr = slab(oi, vi, self.bmin[rc], self.bmax[rc], bt)
                want_l, want_r = tl < float("inf"), tr < float("inf")
                near_l = tl <= tr
                near = torch.where(near_l, lc, rc)
                far = torch.where(near_l, rc, lc)
                both = want_l & want_r
                one = want_l ^ want_r
                pos = sp[ir]
                b, s = ir[both], pos[both]
                stack[b, s] = far[both]
                stack[b, s + 1] = near[both]
                a, s1 = ir[one], pos[one]
                stack[a, s1] = torch.where(want_l, lc, rc)[one]
                sp[ir] = pos + 2 * both.to(torch.int64) + one.to(torch.int64)
                if stats is not None:
                    n_inner += ir.numel()
        if stats is not None:
            stats["inner"] = stats.get("inner", 0) + int(n_inner)
            stats["slabs"] = stats.get("slabs", 0) + 2 * int(n_inner)
            stats["tris"] = stats.get("tris", 0) + int(n_tris)
            stats["nodes_touched"] = stats.get("nodes_touched", 0) + int(nodes_seen.sum())
            stats["tris_touched"] = stats.get("tris_touched", 0) + int(tris_seen.sum())
            stats["trips"] = stats.get("trips", 0) + trips
        t = torch.where(found, best_t, torch.zeros_like(best_t))
        return Hit(t, self.order[best_slot], best_u, best_v, active & found)
