"""Device kernels per loss step (`Trainer.step`: the captured loss and
gradient, the optimizer and the projection), counted in the trace of whole
steps (copies and memsets left out)."""


def read(r):
    return r.trace.kernel_count() / r.trace.units
