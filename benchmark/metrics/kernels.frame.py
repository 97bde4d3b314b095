"""Device kernels per frame, counted in the trace of whole frames (copies
and memsets left out): inside `render/graph.py::Step` replays."""


def read(r):
    return r.trace.kernel_count() / r.trace.units
