"""The gradient of a small parameter table's gather (``csrc/table_grad.cu``):
its autograd wrapper, its plain version and the rule that sends a gather to
it.

Every read of a parameter table in the shading path (a material field, an
emitter's row, a texel) goes through ``vec.take_small``, which gathers with
``torch.index_select``. Autograd's backward of that gather is ``index_add_``:
one float ``atomicAdd`` a lane and column into the table. Where a table has a
few rows that every lane of a bounce reads, as a scene's material fields do,
the atomics land on a few addresses and serialise. ``gather`` keeps the
forward, ``torch.index_select`` itself, and takes its backward to the kernel,
which sums each block's lanes in shared memory and the blocks in a second
pass, with no global atomics and in an order that depends on the shapes
alone, so the gradient is the same bit for bit from run to run.
``table_grad_plain`` takes the same sums in the same order in PyTorch: the
CPU's path through ``table_grad``, and what the card tests and
``chip_smoke.py``'s ``table_grad`` phase hold the kernel against.

**Which path a gather takes** (``route``, from what the call shows): the
kernel where autograd records it (gradients on and a table that requires
one), on a card, for a float32 table of at most ``MAX_TABLE`` floats, which a
warp's slab of shared memory holds. A larger table on a card, a float
texture atlas say, keeps ``index_select`` and autograd's ``index_add_``,
whose scattered indices do not contend; its backward calls are counted as
``table_grad_fallback``. Every call that autograd does not record (a frame,
a table without a gradient) and every call on the CPU is plain
``index_select``.

``LAUNCHES`` counts the kernel's calls (``table_grad``, one launch of each of
its two kernels) and the fallbacks; ``_launch.launch_tables`` lists it, so
graph replays count too. Both are counted in the backward, which autograd
runs on a thread of its own (one a card), under ``_launch.LOCK`` but on a
stream that a capture records: a step's capture (``render/graph.py``)
holds the lock while it waits for that backward, and so keeps every other
count out meanwhile.
"""

from __future__ import annotations

import ctypes
import math
from typing import Sequence

import torch
from torch.autograd.function import once_differentiable

from ._build import load_library

SOURCE = "table_grad.cu"

LAUNCHES = {"table_grad": 0, "table_grad_fallback": 0}

# the kernel's layout (csrc/table_grad.cu's constants): a block's lanes, its
# warps, the rounds of 32 lanes a warp takes, and the floats of the largest
# table
WARPS, ROUNDS = 8, 4
LANES_PER_BLOCK = WARPS * ROUNDS * 32
MAX_TABLE = 1024

KERNEL, INDEX_ADD, PLAIN = "kernel", "index_add", "plain"


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def route(device_type: str, records: bool, shape: Sequence[int], dtype: torch.dtype) -> str:
    """The path of a gather from a table of ``shape`` and ``dtype`` on a
    device of ``device_type``, where ``records`` says whether autograd
    records it: ``KERNEL``, ``INDEX_ADD`` (``index_select``, its backward
    counted as a fallback) or ``PLAIN`` (``index_select``)."""
    if not records or device_type != "cuda":
        return PLAIN
    if dtype == torch.float32 and len(shape) >= 1 and 0 < math.prod(shape) <= MAX_TABLE:
        return KERNEL
    return INDEX_ADD


def route_of(table: torch.Tensor) -> str:
    """``route`` of a gather from ``table`` now."""
    records = torch.is_grad_enabled() and table.requires_grad
    return route(table.device.type, records, tuple(table.shape), table.dtype)


# ----------------------------------------------------------------- the sums


def table_grad_plain(grad_rows: torch.Tensor, idx: torch.Tensor, rows: int) -> torch.Tensor:
    """The kernel's sums in PyTorch, in its order: ``[rows, width]``, row r
    the sum of the rows of ``grad_rows`` [n, width] whose ``idx`` [n] is r.
    Lanes are padded to whole blocks with lanes on no row; each add starts
    from 0.0, so a padded lane or an absent row adds an exact zero."""
    n, width = grad_rows.shape
    dev, f32 = grad_rows.device, torch.float32
    blocks = -(-n // LANES_PER_BLOCK)
    pad = blocks * LANES_PER_BLOCK - n
    g = torch.cat([grad_rows, grad_rows.new_zeros(pad, width)])
    r = torch.cat([idx.long(), idx.new_full((pad,), -1, dtype=torch.long)])
    g = g.view(blocks, WARPS, ROUNDS, 32, 1, width)
    hot = (r.view(blocks, WARPS, ROUNDS, 32, 1) == torch.arange(rows, device=dev))[..., None]
    # a round's sum of each row, lane by lane
    acc = torch.zeros((blocks, WARPS, ROUNDS, rows, width), dtype=f32, device=dev)
    for t in range(32):
        acc = acc + torch.where(hot[:, :, :, t], g[:, :, :, t], 0.0)
    # each warp's slab, round by round; the block's partial, warp by warp
    slab = torch.zeros((blocks, WARPS, rows, width), dtype=f32, device=dev)
    for k in range(ROUNDS):
        slab = slab + acc[:, :, k]
    part = torch.zeros((blocks, rows, width), dtype=f32, device=dev)
    for w in range(WARPS):
        part = part + slab[:, w]
    # the reduce: lane l adds the blocks l, l + 32, ...; then the shuffle tree
    size = rows * width
    chunks = -(-blocks // 32)
    part = torch.cat([part.reshape(blocks, size), part.new_zeros(chunks * 32 - blocks, size)])
    part = part.view(chunks, 32, size)
    s = torch.zeros((32, size), dtype=f32, device=dev)
    for k in range(chunks):
        s = s + part[k]
    for off in (16, 8, 4, 2, 1):
        s = s[:off] + s[off:2 * off]
    return s[0].view(rows, width)


# ----------------------------------------------------------------- launches

_LIB = None


def load():
    """Build (first use) and bind the kernel library; cached per process.
    Returns ``(table_grad, attributes)``."""
    global _LIB
    if _LIB is None:
        lib = load_library(SOURCE)
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn = lib.polaris_table_grad
        fn.argtypes = [P, P, L, I, I, I, P, P, P]
        fn.restype = I
        attrs = lib.polaris_table_grad_attributes
        attrs.argtypes = [ctypes.POINTER(I), ctypes.POINTER(I)]
        attrs.restype = I
        _LIB = (fn, attrs)
    return _LIB


def attributes() -> dict:
    """Registers a thread and local-memory bytes (spills land there) of the
    two kernels, from the loaded binary."""
    from . import _launch

    regs, local = (ctypes.c_int * 2)(), (ctypes.c_int * 2)()
    _launch.raise_on(load()[1](regs, local), "polaris_table_grad_attributes")
    return {name: {"registers": regs[k], "local_bytes": local[k]}
            for k, name in enumerate(("table_grad_partials", "table_grad_reduce"))}


def table_grad(grad_rows: torch.Tensor, idx: torch.Tensor, rows: int) -> torch.Tensor:
    """``[rows, width]``, row r the sum of the rows of ``grad_rows`` [n,
    width] whose ``idx`` [n] (int64) is r: the kernel on a card, the plain
    version on the CPU. Raises on a tensor the kernel does not take."""
    from . import _launch

    device = grad_rows.device
    if device.type != "cuda":
        return table_grad_plain(grad_rows, idx, rows)
    _launch.check("grad_rows", grad_rows, torch.float32, 2, device)
    _launch.check("idx", idx, torch.int64, 1, device)
    n, width = grad_rows.shape
    if idx.shape[0] != n:
        raise ValueError(f"idx: {idx.shape[0]} lanes, grad_rows {n}")
    if not (rows >= 1 and width >= 1 and rows * width <= MAX_TABLE):
        raise ValueError(f"a table of {rows} x {width} floats: the kernel takes 1 to {MAX_TABLE}")
    blocks = -(-n // LANES_PER_BLOCK)
    partials = torch.empty(blocks * rows * width, dtype=torch.float32, device=device)
    out = torch.empty((rows, width), dtype=torch.float32, device=device)
    fn = load()[0]
    with torch.cuda.device(device), torch.profiler.record_function(fn.__name__):
        err = fn(grad_rows.data_ptr(), idx.data_ptr(), n, rows, width, blocks,
                 partials.data_ptr(), out.data_ptr(), torch.cuda.current_stream().cuda_stream)
    _launch.raise_on(err, fn.__name__)
    _count("table_grad", device)
    return out


def _count(key: str, device: torch.device) -> None:
    """One call into ``LAUNCHES``, from a backward (the module's docstring)."""
    from . import _launch

    if device.type == "cuda" and torch.cuda.is_current_stream_capturing():
        LAUNCHES[key] += 1  # the capture holds _launch.LOCK
    else:
        _launch.count(LAUNCHES, key)


# ----------------------------------------------------------------- autograd


class _Gather(torch.autograd.Function):
    """``torch.index_select(table, 0, idx)``, its gradient by ``table_grad``."""

    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.shape = table.shape
        return torch.index_select(table, 0, idx)

    @staticmethod
    @once_differentiable
    def backward(ctx, grad):
        (idx,) = ctx.saved_tensors
        width = math.prod(ctx.shape[1:])
        g = table_grad(grad.reshape(idx.shape[0], width).contiguous(), idx, ctx.shape[0])
        return g.view(ctx.shape), None


def gather(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``torch.index_select(table, 0, idx)`` (``idx`` int64, one dimension),
    whose gradient the kernel sums."""
    return _Gather.apply(table, idx.contiguous())


def _count_fallback(grad: torch.Tensor) -> None:
    _count("table_grad_fallback", grad.device)


def take(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``torch.index_select(table, 0, idx)`` (``idx`` int64, one dimension)
    on the path ``route_of(table)`` names."""
    way = route_of(table)
    if way == KERNEL:
        return gather(table, idx)
    rows = torch.index_select(table, 0, idx)
    if way == INDEX_ADD:
        rows.register_hook(_count_fallback)
    return rows
