"""The least time a closest-hit traversal call could take on the card:
a frozen copy of `chip_smoke.py::bound_ms` (commit 70823ee) for K1's
closest-hit query (det^2 leaf test, K1's record sizes), over the counts of
the benchmark's own walk (`traverse.py`) of its own BVH (`bvh.py`).

Bytes: the `active` flag of every lane, origin, direction and `maxt` of the
active lanes, every output once, and each distinct node record and triangle
some ray read, once. Operations: two slab tests per inner visit and the
triangle tests, at the float operation counts of csrc/traverse_common.cuh.
The bound is the larger of bytes over the memory rate and operations over
the float32 rate.
"""

from __future__ import annotations

from .peaks import PEAK_BYTES_PER_S, PEAK_FP32_FLOPS

NODE_BYTES = 64  # K1's node record
TRI_BYTES = 48  # K1's triangle record
SLAB_FLOPS = 25  # 6 sub, 6 mul, 10 min/max, 3 compares
TRI_FLOPS = 56  # det^2 closest-hit test: 2 cross, 4 dot, 3 sub, 3 mul, 2 scale, 1 add, 2 mul, 7 compares


def closest_bound_s(n: int, n_active: int, stats: dict) -> dict:
    ray_bytes = n + n_active * (12 + 12 + 4)
    out_bytes = n * (3 * 4 + 2 * 4 + 1)
    scene_bytes = stats["nodes_touched"] * NODE_BYTES + stats["tris_touched"] * TRI_BYTES
    nbytes = ray_bytes + out_bytes + scene_bytes
    flops = stats["slabs"] * SLAB_FLOPS + stats["tris"] * TRI_FLOPS
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_flops = flops / PEAK_FP32_FLOPS
    return {
        "bound_s": max(t_bytes, t_flops), "by": "bytes" if t_bytes >= t_flops else "operations",
        "bytes": nbytes, "flops": flops,
    }
