"""The frozen roofline counter on a scene small enough to count by hand."""

import numpy as np
import pytest
import torch

from roofline import bound, bvh, traverse
from roofline.peaks import PEAK_BYTES_PER_S, PEAK_FP32_FLOPS


def scene():
    """Six unit triangles in the plane z = 0: three near x = 0, three near
    x = 10. The first of each three covers (0.2, 0.2) of its square."""
    tris = []
    for x0 in (0.0, 10.0):
        for k in range(3):
            dz = 0.0 if k == 0 else -5.0 - k  # the other two lie further down
            tris.append([[x0, 0, dz], [x0 + 1, 0, dz], [x0, 1, dz]])
    t = np.asarray(tris, np.float32)
    return t[:, 0], t[:, 1] - t[:, 0], t[:, 2] - t[:, 0]


def walk(any_hit, o, d):
    v0, e1, e2 = scene()
    b = bvh.build(v0, e1, e2)
    assert b.num_nodes == 3 and list(b.count) == [0, 3, 3]
    tr = traverse.Traverser(b, v0, e1, e2, "cpu")
    o = torch.tensor([o], dtype=torch.float32)
    d = torch.tensor([d], dtype=torch.float32)
    maxt = torch.full((1,), traverse.FLT_MAX)
    stats = {}
    fn = tr.any_hit if any_hit else tr.closest
    return fn(o, d, maxt, torch.ones(1, dtype=torch.bool), stats), stats


def test_closest_hit_counts_by_hand():
    hit, stats = walk(False, (0.2, 0.2, 1.0), (0.0, 0.0, -1.0))
    assert bool(hit.mask[0]) and int(hit.tri[0]) == 0
    assert float(hit.t[0]) == pytest.approx(1.0)
    # the root (two slab tests: the left box is hit, the right one missed),
    # then the left leaf's three triangles, all tested for the closest
    assert stats["inner"] == 1 and stats["slabs"] == 2
    assert stats["tris"] == 3 and stats["tris_touched"] == 3 and stats["nodes_touched"] == 2
    b = bound.closest_bound_s(1, 1, stats)
    nbytes = 1 + (12 + 12 + 4) + (3 * 4 + 2 * 4 + 1) + 2 * 64 + 3 * 48
    flops = 2 * 25 + 3 * 56
    assert (b["bytes"], b["flops"]) == (nbytes, flops)
    assert b["bound_s"] == pytest.approx(max(nbytes / PEAK_BYTES_PER_S, flops / PEAK_FP32_FLOPS))
    assert b["by"] == "bytes"


def test_any_hit_stops_at_its_first_triangle():
    hit, stats = walk(True, (10.2, 0.2, 1.0), (0.0, 0.0, -1.0))
    assert bool(hit[0])
    # the right leaf's slots in order; the ray stops at the first accepted
    assert stats["tris"] == stats["tris_touched"] <= 3 and stats["nodes_touched"] == 2


def test_a_miss_reads_only_the_root():
    hit, stats = walk(False, (5.0, 0.5, 1.0), (0.0, 0.0, -1.0))
    assert not bool(hit.mask[0])
    assert (stats["inner"], stats["tris"], stats["nodes_touched"]) == (1, 0, 1)


def test_bvh_covers_every_triangle_once():
    rng = np.random.default_rng(0)
    v0 = rng.random((1001, 3), dtype=np.float32)
    e1 = rng.random((1001, 3), dtype=np.float32) * 0.1
    e2 = rng.random((1001, 3), dtype=np.float32) * 0.1
    b = bvh.build(v0, e1, e2)
    assert sorted(b.order.tolist()) == list(range(1001))
    leaves = b.count > 0
    assert b.count[leaves].sum() == 1001 and b.count.max() <= bvh.LEAF_TRIS
    slots = np.concatenate([np.arange(f, f + c) for f, c in zip(b.first[leaves], b.count[leaves])])
    assert sorted(slots.tolist()) == list(range(1001))
    for i in np.nonzero(leaves)[0]:
        t = b.order[b.first[i]: b.first[i] + b.count[i]]
        for p in (v0[t], v0[t] + e1[t], v0[t] + e2[t]):
            assert (p >= b.bmin[i] - 1e-6).all() and (p <= b.bmax[i] + 1e-6).all()


def test_two_triangles_in_one_leaf():
    t = np.asarray([[[0, 0, 0], [1, 0, 0], [0, 1, 0]], [[0, 0, -1], [1, 0, -1], [0, 1, -1]]], np.float32)
    v0, e1, e2 = t[:, 0], t[:, 1] - t[:, 0], t[:, 2] - t[:, 0]
    b = bvh.build(v0, e1, e2)
    assert b.num_nodes == 1 and int(b.count[0]) == 2
    tr = traverse.Traverser(b, v0, e1, e2, "cpu")
    stats = {}
    hit = tr.closest(torch.tensor([[0.2, 0.2, 1.0]]), torch.tensor([[0.0, 0.0, -1.0]]),
                     torch.full((1,), traverse.FLT_MAX), torch.ones(1, dtype=torch.bool), stats)
    assert int(hit.tri[0]) == 0 and float(hit.t[0]) == pytest.approx(1.0)
    # the root is the one leaf: no slab test, both triangles tested and read
    assert (stats["inner"], stats["slabs"], stats["tris"]) == (0, 0, 2)
    assert (stats["nodes_touched"], stats["tris_touched"]) == (1, 2)
    b = bound.closest_bound_s(1, 1, stats)
    assert b["bytes"] == 1 + 28 + 21 + 64 + 2 * 48 and b["flops"] == 2 * 56
