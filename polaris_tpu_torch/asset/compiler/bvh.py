"""Top-down SAH BVH builder over axis-aligned bounded volumes.

Counterpart of the reference's ``asset/compiler/bvh/bvh_builder.go:100-308``.
Semantics match the reference:

  * candidate splits along x/y/z at step ``side/(1024/(depth+1))``
    (bvh_builder.go:154-181), skipping axes with side < 1e-3 or step < 1e-5
  * SAH score = leftCount*leftArea + rightCount*rightArea with empty-side
    candidates scored +inf (bvh_builder.go:252-285)
  * leaf when <= min_leaf_items or no split improves the parent score
    (bvh_builder.go:141-144,192-195)
  * node encoding shared with the device arrays: leaf <=> ldata <= 0; a TLAS
    leaf stores -instance_index, a BLAS leaf stores -first_item with rdata =
    item count, an inner node stores child indices
    (asset/scene/optimized_scene.go:14-75)

Where the reference scores each candidate split in its own goroutine
(bvh_builder.go:168-190), we score *all* candidates of a node in one
vectorized NumPy pass: item centers are binned against every split point at
once, producing per-candidate left/right counts and bounds via cumulative
min/max over the sorted axis — an O(C*N) -> O(N log N + C) restructuring that
suits a vector machine rather than a thread pool.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional, Tuple

import numpy as np

from ...utils.log import Timer, get_logger

MIN_SIDE_LENGTH = 1e-3
MIN_SPLIT_STEP = 1e-5

_log = get_logger("bvh builder")


@dataclass
class BvhArrays:
    """Flat SoA BVH node arrays (TPU-friendly layout)."""

    bmin: np.ndarray  # (N, 3) float32
    bmax: np.ndarray  # (N, 3) float32
    ldata: np.ndarray  # (N,) int32: child / -instance / -first_item
    rdata: np.ndarray  # (N,) int32: child / item count

    def __len__(self) -> int:
        return int(self.ldata.shape[0])

    def offset_children(self, offset: int) -> None:
        """Shift child indices of inner nodes (optimized_scene.go:67-75)."""
        inner = self.ldata > 0
        self.ldata[inner] += offset
        self.rdata[inner] += offset


# LeafCallback(first_slot, ordered_item_indices) -> (ldata, rdata)
LeafCallback = Callable[[np.ndarray], Tuple[int, int]]


def build(
    bboxes_min: np.ndarray,
    bboxes_max: np.ndarray,
    centers: np.ndarray,
    min_leaf_items: int,
    leaf_cb: LeafCallback,
    use_native: bool = True,
) -> BvhArrays:
    """Build a BVH over items described by their AABBs and centers.

    ``leaf_cb(item_indices)`` is invoked for every created leaf with the
    original indices of the contained items (in partition order) and must
    return the packed ``(ldata, rdata)`` pair for the leaf node — mirroring
    the reference's LeafCallback contract (bvh_builder.go:90-98).
    """
    n = bboxes_min.shape[0]
    if n == 0:
        raise ValueError("cannot build a BVH over zero items")

    if use_native:
        from ...native import build_bvh_native

        arrays = build_bvh_native(
            bboxes_min, bboxes_max, centers, min_leaf_items, leaf_cb
        )
        if arrays is not None:
            return arrays

    bmins: List[np.ndarray] = []
    bmaxs: List[np.ndarray] = []
    ldata: List[int] = []
    rdata: List[int] = []

    def new_node(bmin, bmax) -> int:
        idx = len(ldata)
        bmins.append(bmin)
        bmaxs.append(bmax)
        ldata.append(0)
        rdata.append(0)
        return idx

    def partition(items: np.ndarray, depth: int) -> int:
        ib_min = bboxes_min[items]
        ib_max = bboxes_max[items]
        node_min = ib_min.min(axis=0)
        node_max = ib_max.max(axis=0)

        if items.shape[0] <= min_leaf_items:
            return make_leaf(node_min, node_max, items)

        side = node_max - node_min
        best = _best_split(items, ib_min, ib_max, centers[items], node_min, side, depth)
        if best is None:
            return make_leaf(node_min, node_max, items)

        axis, split_point = best
        c = centers[items][:, axis]
        left_items = items[c < split_point]
        right_items = items[c >= split_point]

        idx = new_node(node_min, node_max)
        left = partition(left_items, depth + 1)
        right = partition(right_items, depth + 1)
        ldata[idx] = left
        rdata[idx] = right
        return idx

    def make_leaf(node_min, node_max, items: np.ndarray) -> int:
        idx = new_node(node_min, node_max)
        l, r = leaf_cb(items)
        ldata[idx] = l
        rdata[idx] = r
        return idx

    with Timer() as t:
        partition(np.arange(n, dtype=np.int64), 0)
    _log.debug("BVH build: %d items -> %d nodes in %.1f ms", n, len(ldata), t.ms)

    return BvhArrays(
        bmin=np.asarray(bmins, np.float32).reshape(-1, 3),
        bmax=np.asarray(bmaxs, np.float32).reshape(-1, 3),
        ldata=np.asarray(ldata, np.int32),
        rdata=np.asarray(rdata, np.int32),
    )


def _sah_area(side: np.ndarray) -> np.ndarray:
    return side[..., 0] * side[..., 1] + side[..., 1] * side[..., 2] + side[..., 0] * side[..., 2]


def _best_split(
    items: np.ndarray,
    ib_min: np.ndarray,
    ib_max: np.ndarray,
    ctr: np.ndarray,
    node_min: np.ndarray,
    side: np.ndarray,
    depth: int,
) -> Optional[Tuple[int, float]]:
    """Vectorized scan of all reference split candidates; returns the best
    (axis, split_point) if it improves on the unsplit SAH score, else None."""
    parent_score = items.shape[0] * float(_sah_area(side))
    best_score = parent_score
    best: Optional[Tuple[int, float]] = None

    for axis in range(3):
        if side[axis] < MIN_SIDE_LENGTH:
            continue
        step = side[axis] / (1024.0 / (depth + 1))
        if step < MIN_SPLIT_STEP:
            continue
        splits = np.arange(node_min[axis], node_min[axis] + side[axis], step, dtype=np.float64)
        splits = splits[splits < node_min[axis] + side[axis]]
        if splits.size == 0:
            continue

        order = np.argsort(ctr[:, axis], kind="stable")
        c_sorted = ctr[order, axis]
        mn_sorted = ib_min[order]
        mx_sorted = ib_max[order]

        # prefix (left side) and suffix (right side) cumulative bounds
        pre_min = np.minimum.accumulate(mn_sorted, axis=0)
        pre_max = np.maximum.accumulate(mx_sorted, axis=0)
        suf_min = np.minimum.accumulate(mn_sorted[::-1], axis=0)[::-1]
        suf_max = np.maximum.accumulate(mx_sorted[::-1], axis=0)[::-1]

        # number of items with center < split, per candidate
        counts = np.searchsorted(c_sorted, splits, side="left")
        valid = (counts > 0) & (counts < items.shape[0])
        if not np.any(valid):
            continue
        cv = counts[valid]
        l_side = pre_max[cv - 1] - pre_min[cv - 1]
        r_side = suf_max[cv] - suf_min[cv]
        scores = cv * _sah_area(l_side) + (items.shape[0] - cv) * _sah_area(r_side)

        i = int(np.argmin(scores))
        if scores[i] < best_score:
            best_score = float(scores[i])
            best = (axis, float(splits[valid][i]))

    return best
