"""Device milliseconds per frame of the shading kernel alone, `shade_bounce`
(csrc/shade.cu, one launch a bounce), known by its symbol
`shade_bounce_kernel`, summed over its launches in the trace. It is one of
the kernels `shade_ms.frame` sums, so it never reads more. A trace without
the kernel (the plain shading path, on the CPU or under autograd) gives
nothing."""

SYMBOL = "shade_bounce_kernel"


def is_shade_bounce(name: str) -> bool:
    return SYMBOL in name


def read(r):
    if not any(is_shade_bounce(n) for n in r.trace.kernels):
        return None
    return 1e3 * r.trace.seconds_where(is_shade_bounce) / r.trace.units
