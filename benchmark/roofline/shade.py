"""The least time a bounce's shading could take on the card: a lower bound
on the work, whatever the kernel's layout, reckoned from the lane census
of a frame (`polaris_tpu_torch/utils/profiling.py::shade_census`).

A bounce's shading takes each lane's hit record, ray and path state and
gives its next ray, its shadow ray and NEE value, and its new path state.
For each lane that enters the bounce alive, any implementation reads and
writes that interface once, at least; it is counted field by field below.
Nothing is counted for a dead lane, which an implementation that compacts
its lanes never touches, nor for the triangle rows, materials and texels,
which lanes share through the caches. So no implementation reads over
100%, a compacting one included. Bytes over the memory rate
(`peaks.py`); the arithmetic is left out, as the kernel is bound by bytes.
"""

from __future__ import annotations

from typing import Dict, List

from .peaks import PEAK_BYTES_PER_S

# (field, bytes) a live lane reads
LANE_READS = (
    ("hit distance t", 4), ("hit barycentric u", 4), ("hit barycentric v", 4),
    ("hit triangle", 4), ("hit instance", 4), ("hit mask", 1),
    ("ray origin", 12), ("ray direction", 12),
    ("alive", 1), ("throughput", 12), ("path flags", 4), ("radiance", 12),
)
# (field, bytes) a live lane writes
LANE_WRITES = (
    ("next ray origin", 12), ("next ray direction", 12), ("next ray mask", 1),
    ("shadow ray origin", 12), ("shadow ray direction", 12), ("shadow ray length", 4),
    ("NEE value", 12), ("NEE mask", 1),
    ("throughput", 12), ("path flags", 4), ("radiance", 12),
)
LANE_BYTES = sum(b for _, b in LANE_READS) + sum(b for _, b in LANE_WRITES)


def bound(census: List[Dict[str, int]]) -> Dict[str, float]:
    """The bound of the bounces of ``census`` (one dict a bounce, with the
    lanes that entered it alive under ``alive``): bytes and seconds."""
    nbytes = LANE_BYTES * sum(int(row["alive"]) for row in census)
    return {"bytes": nbytes, "bound_s": nbytes / PEAK_BYTES_PER_S}


def roofline_pct(census: List[Dict[str, int]], kernel_s: float) -> float:
    """The share (%) of the bound in ``kernel_s``, the shading kernel's time
    over the same bounces."""
    return 100.0 * bound(census)["bound_s"] / kernel_s
