"""The benchmark's own binary BVH over a triangle soup: the structure the
traversal roofline counts its work on and the reference renderer walks.

It is part of the yardstick, so it never changes with the renderer under
test. The node encoding follows polaris_tpu_torch/asset/compiler/bvh.py at
commit 70823ee (flat arrays, two children per inner node, a leaf holds a
run of triangles); the split rule is simpler: every node is split at the
median of its triangles' centers along the longest axis of their bounds,
one level of the tree at a time over all nodes at once, so 819,202
triangles build in a few seconds of NumPy. Leaves hold at most
``LEAF_TRIS`` triangles.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

LEAF_TRIS = 4


@dataclass
class Bvh:
    bmin: np.ndarray  # (N, 3) float32 node bounds
    bmax: np.ndarray  # (N, 3) float32
    left: np.ndarray  # (N,) int64 first child, -1 on a leaf (right = left + 1)
    first: np.ndarray  # (N,) int64 first slot of a leaf's triangles
    count: np.ndarray  # (N,) int64 triangles of a leaf, 0 on an inner node
    order: np.ndarray  # (T,) int64 triangle index of each slot

    @property
    def num_nodes(self) -> int:
        return int(self.left.shape[0])


def _segment_bounds(lo, hi, starts):
    return np.minimum.reduceat(lo, starts, axis=0), np.maximum.reduceat(hi, starts, axis=0)


def build(v0: np.ndarray, e1: np.ndarray, e2: np.ndarray) -> Bvh:
    """A BVH over triangles given as a vertex and two edges, float32 (T, 3)."""
    p0 = v0.astype(np.float32)
    p1 = (v0 + e1).astype(np.float32)
    p2 = (v0 + e2).astype(np.float32)
    lo = np.minimum(np.minimum(p0, p1), p2)
    hi = np.maximum(np.maximum(p0, p1), p2)
    ctr = (lo + hi) * np.float32(0.5)
    n = v0.shape[0]
    order = np.arange(n, dtype=np.int64)

    # nodes of the current level: [start, end) slots, and their node ids
    starts = np.array([0], np.int64)
    ends = np.array([n], np.int64)
    ids = np.array([0], np.int64)
    bmin, bmax, left, first, count = [], [], [], [], []
    next_id = 1
    while starts.size:
        b_lo, b_hi = _segment_bounds(lo[order], hi[order], starts)
        size = ends - starts
        split = size > LEAF_TRIS
        bmin.append((ids, b_lo))
        bmax.append((ids, b_hi))
        n_split = int(split.sum())
        kids = next_id + 2 * np.arange(n_split, dtype=np.int64)
        next_id += 2 * n_split
        lft = np.full(ids.shape, -1, np.int64)
        lft[split] = kids
        left.append((ids, lft))
        first.append((ids, np.where(split, 0, starts)))
        count.append((ids, np.where(split, 0, size)))
        if not n_split:
            break
        s, e = starts[split], ends[split]
        # sort each splitting node's slots by its center on its longest axis
        c_lo, c_hi = _segment_bounds(ctr[order], ctr[order], starts)
        axis = np.argmax((c_hi - c_lo)[split], axis=1)
        run = e - s
        seg = np.repeat(np.arange(n_split), run)
        slots = np.arange(int(run.sum()), dtype=np.int64) + np.repeat(s - (np.cumsum(run) - run), run)
        key = ctr[order[slots], axis[seg]]
        perm = np.lexsort((order[slots], key, seg))
        order[slots] = order[slots][perm]
        mid = s + (e - s) // 2
        starts = np.stack([s, mid], axis=1).reshape(-1)
        ends = np.stack([mid, e], axis=1).reshape(-1)
        ids = np.stack([kids, kids + 1], axis=1).reshape(-1)

    def gather(parts, shape, dtype):
        out = np.zeros((next_id,) + shape, dtype)
        for i, v in parts:
            out[i] = v
        return out

    return Bvh(
        bmin=gather(bmin, (3,), np.float32), bmax=gather(bmax, (3,), np.float32),
        left=gather(left, (), np.int64), first=gather(first, (), np.int64),
        count=gather(count, (), np.int64), order=order,
    )
