"""Device milliseconds per loss step of the parameter tables' gradient
scatter: the backward of every gather from a small table in the shading path
(`ops/vec.py::take_small`). Known by its symbols: `indexFunc` (PyTorch's
`index_add_`, the backward of `index_select`) and `table_grad_` (the
kernels of csrc/table_grad.cu that sum it per block), summed over their
launches in the trace of whole steps. A trace with neither gives nothing."""

import re

SYMBOLS = re.compile(r"indexFunc|table_grad_")


def is_scatter(name: str) -> bool:
    return SYMBOLS.search(name) is not None


def read(r):
    if not any(is_scatter(n) for n in r.trace.kernels):
        return None
    return 1e3 * r.trace.seconds_where(is_scatter) / r.trace.units
