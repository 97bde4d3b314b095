"""Device milliseconds per frame of the traversal kernels (ops/intersect*.py
-> csrc/*.cu), summed over their launches in the trace. They are known by
their symbols: `persistent_kernel` (K1, K2, K3: csrc/traverse_common.cuh),
`traverse` (K4) and `dense` (K5)."""

import re

SYMBOLS = re.compile(r"persistent_kernel|(?<![A-Za-z_])(traverse|dense)(?![A-Za-z_])")


def is_traversal(name: str) -> bool:
    return SYMBOLS.search(name) is not None


def read(r):
    return 1e3 * r.trace.seconds_where(is_traversal) / r.trace.units
