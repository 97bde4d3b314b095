"""What every traversal kernel's PyTorch wrapper does around its launch.

All kernel libraries under ``csrc/`` share one C interface (the macros at the
end of ``csrc/traverse_common.cuh``): the scene's pointers and counts, then
``n, o, d, maxt, active``, then the outputs (``t, u, v, tri, inst, found`` for
closest hit, ``found`` for any hit), then the stream. This module binds such
a pair of entry points with ``ctypes``, validates the ray tensors, allocates
the outputs with ``torch.empty``, launches on PyTorch's current stream
without synchronising, and raises when the launch was refused. Each launch is
a ``torch.profiler`` span named after its C entry point, so a trace names
the kernels a frame ran.

Launches are counted per entry point in each kernel module's ``LAUNCHES``
table, under ``LOCK``: renderers of a worker pool launch from threads of their
own, and a CUDA graph's capture (``render/graph.py``) takes its launches back
out of the tables, which must not take another thread's with them.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Dict, Sequence

import numpy as np
import torch

from ._build import load_library
from .intersect import Hit

# each multiply and add rounds on its own, as in the plain PyTorch versions,
# so kernel and plain version take identical hit/miss decisions (see the note
# in csrc/traverse_common.cuh)
EXTRA_FLAGS = ("-fmad=false",)

_P, _I = ctypes.c_void_p, ctypes.c_int

# guards every kernel module's LAUNCHES table; reentrant, because a thread
# that captures a graph holds it while the step's wrappers count
LOCK = threading.RLock()


def count(table: Dict[str, int], key: str) -> None:
    """One launch of entry point ``key`` into ``table`` (a ``LAUNCHES``)."""
    with LOCK:
        table[key] += 1


def bind(source: str, closest_name: str, any_name: str, scene_argtypes: str):
    """Build (first use) and load ``csrc/<source>`` and declare its two entry
    points. ``scene_argtypes`` spells the scene arguments, one letter each:
    ``p`` a device pointer, ``i`` an int."""
    lib = load_library(source, EXTRA_FLAGS)
    scene = [{"p": _P, "i": _I}[c] for c in scene_argtypes]
    closest = getattr(lib, closest_name)
    closest.argtypes = scene + [_I] + [_P] * 4 + [_P] * 6 + [_P]
    closest.restype = _I
    any_hit = getattr(lib, any_name)
    any_hit.argtypes = scene + [_I] + [_P] * 4 + [_P] + [_P]
    any_hit.restype = _I
    return closest, any_hit


def check(name, x, dtype, ndim, device):
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(x).__name__}")
    if x.device != device:
        raise ValueError(f"{name}: on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise TypeError(f"{name}: dtype {x.dtype}, expected {dtype}")
    if x.dim() != ndim:
        raise ValueError(f"{name}: {x.dim()} dims, expected {ndim}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _ray_pointers(o, d, maxt, active):
    device = o.device
    n = o.shape[0]
    check("o", o, torch.float32, 2, device)
    check("d", d, torch.float32, 2, device)
    check("maxt", maxt, torch.float32, 1, device)
    if active.dtype not in (torch.bool, torch.uint8):
        raise TypeError(f"active: dtype {active.dtype}, expected bool or uint8")
    check("active", active, active.dtype, 1, device)
    if o.shape[1] != 3 or tuple(d.shape) != (n, 3) or maxt.shape[0] != n or active.shape[0] != n:
        raise ValueError(
            f"ray shapes disagree: o {tuple(o.shape)}, d {tuple(d.shape)}, "
            f"maxt {tuple(maxt.shape)}, active {tuple(active.shape)}"
        )
    return n, [o.data_ptr(), d.data_ptr(), maxt.data_ptr(), active.data_ptr()]


def raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: kernel launch failed with CUDA error {err}")


def run_closest(fn, scene_args: Sequence, o, d, maxt, active) -> Hit:
    """Launch a closest-hit entry point on CUDA ray tensors; returns ``Hit``."""
    n, rays = _ray_pointers(o, d, maxt, active)
    f32 = dict(dtype=torch.float32, device=o.device)
    t = torch.empty(n, **f32)
    u = torch.empty(n, **f32)
    v = torch.empty(n, **f32)
    tri = torch.empty(n, dtype=torch.int32, device=o.device)
    inst = torch.empty(n, dtype=torch.int32, device=o.device)
    found = torch.empty(n, dtype=torch.bool, device=o.device)
    with torch.cuda.device(o.device), torch.profiler.record_function(fn.__name__):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(
            *scene_args, n, *rays,
            t.data_ptr(), u.data_ptr(), v.data_ptr(), tri.data_ptr(),
            inst.data_ptr(), found.data_ptr(), stream,
        )
    raise_on(err, fn.__name__)
    return Hit(t, inst, tri, u, v, found)


def run_any(fn, scene_args: Sequence, o, d, maxt, active) -> torch.Tensor:
    """Launch an any-hit entry point on CUDA ray tensors; returns the mask."""
    n, rays = _ray_pointers(o, d, maxt, active)
    found = torch.empty(n, dtype=torch.bool, device=o.device)
    with torch.cuda.device(o.device), torch.profiler.record_function(fn.__name__):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(*scene_args, n, *rays, found.data_ptr(), stream)
    raise_on(err, fn.__name__)
    return found


# two counters per (device, stream) for the persistent kernels of
# csrc/traverse_common.cuh (K1, K2, K3): the next ray to fetch, and the blocks
# done; each launch's last block sets both back to 0, so launches that follow
# each other on one stream share them. A CUDA graph keeps the counters of the
# stream it was captured on (made by a warm-up before the capture, outside the
# graph's memory pool: render/graph.py), so graphs captured on one stream are
# never replayed at the same time
_COUNTERS: Dict = {}


def persistent_counters(device) -> torch.Tensor:
    """The counters of a persistent launch on the current stream of
    ``device``, made (zeroed) on first use."""
    stream = torch.cuda.current_stream(device).cuda_stream
    with LOCK:  # made once: a graph keeps the address it captured
        counters = _COUNTERS.get((device, stream))
        if counters is None:
            counters = _COUNTERS[device, stream] = torch.zeros(2, dtype=torch.int32, device=device)
    return counters


def upload_packed(packed: Dict, device) -> Dict:
    """A packer's host arrays as contiguous tensors on ``device``; plain
    ints (counts, limits) pass through."""
    return {
        k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
        if isinstance(v, np.ndarray) else v
        for k, v in packed.items()
    }


def packed_pointers(P: Dict, spec, device):
    """``data_ptr`` of each ``(key, dtype)`` of ``spec`` in the packed scene
    ``P``, after checking that it is a flat contiguous tensor of that type on
    the rays' device."""
    ptrs = []
    for key, dtype in spec:
        check(key, P[key], dtype, 1, device)
        if P[key].numel() == 0:
            raise ValueError(f"{key}: empty")
        ptrs.append(P[key].data_ptr())
    return ptrs


def launch_tables():
    """The ``LAUNCHES`` table of every kernel module (K1, K5, K3, K4, K2, the
    shading kernel), in one fixed order: what a CUDA graph's capture reads to
    learn the launches one replay makes."""
    from . import (
        intersect_cuda,
        intersect_dense,
        intersect_nodes,
        intersect_wide8,
        intersect_wide8_nodes,
        shade_cuda,
    )

    return [
        m.LAUNCHES
        for m in (intersect_cuda, intersect_dense, intersect_nodes, intersect_wide8,
                  intersect_wide8_nodes, shade_cuda)
    ]
