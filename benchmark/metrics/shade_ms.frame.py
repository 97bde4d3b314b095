"""Device milliseconds per frame of every kernel that is not traversal:
raygen, shading (materials, BxDF, NEE, RR), accumulation and the finalize
(gather, tonemap, u8), summed over their launches in the trace."""

from harness import cells

traversal = cells.module("metrics", "traversal_ms.frame")


def read(r):
    return 1e3 * r.trace.seconds_where(lambda n: not traversal.is_traversal(n)) / r.trace.units
