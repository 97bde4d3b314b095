"""PyTorch wrappers of the CUDA traversal kernel (``csrc/intersect.cu``).

Two entry points, ``closest_hit`` and ``any_hit``, with the signature the
integrator uses for every traversal backend: ``(S, o, d, maxt, active)``
with ``o, d`` [N,3] f32, ``maxt`` [N] f32, ``active`` [N] bool. The kernel
reads the uploaded scene's own tensors (``bvh_min/max/ldata/rdata``,
``tri_v0/e1/e2``, ``inst_w2o``, ``inst_bvh_root``); nothing is packed or
copied per call.

On CUDA tensors a wrapper launches the kernel on PyTorch's current stream —
outputs allocated with ``torch.empty``, no synchronisation — or raises. On
CPU tensors (and only then) it runs the plain PyTorch version,
``ops/intersect.py::intersect_bvh``, which the CPU tests use. ``LAUNCHES``
counts kernel launches per entry point, and nothing else.
"""

from __future__ import annotations

import torch

from . import _launch
from ._launch import check as _check
from .intersect import Hit, intersect_bvh

SOURCE = "intersect.cu"

LAUNCHES = {"closest_hit": 0, "any_hit": 0}

_SCENE_ARGS = (
    ("bvh_min", torch.float32, 2),
    ("bvh_max", torch.float32, 2),
    ("bvh_ldata", torch.int32, 1),
    ("bvh_rdata", torch.int32, 1),
    ("tri_v0", torch.float32, 2),
    ("tri_e1", torch.float32, 2),
    ("tri_e2", torch.float32, 2),
    ("inst_w2o", torch.float32, 3),
    ("inst_bvh_root", torch.int32, 1),
)


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


_LIB = None


def load():
    """Build (first use) and bind the kernel library; cached per process."""
    global _LIB
    if _LIB is None:
        _LIB = _launch.bind(
            SOURCE, "polaris_closest_hit", "polaris_any_hit", "p" * 9 + "ii"
        )
    return _LIB


def _scene_pointers(S, device):
    ptrs = []
    for name, dtype, ndim in _SCENE_ARGS:
        x = S[name]
        _check(name, x, dtype, ndim, device)
        ptrs.append(x.data_ptr())
    for name in ("bvh_min", "bvh_max", "tri_v0", "tri_e1", "tri_e2"):
        if S[name].shape[1] != 3:
            raise ValueError(f"{name}: expected shape (*, 3), got {tuple(S[name].shape)}")
    if tuple(S["inst_w2o"].shape[1:]) != (4, 4):
        raise ValueError("inst_w2o: expected shape (I, 4, 4)")
    n_nodes = S["bvh_ldata"].shape[0]
    if n_nodes == 0 or S["bvh_rdata"].shape[0] != n_nodes or S["bvh_min"].shape[0] != n_nodes:
        raise ValueError("BVH arrays are empty or disagree in length")
    num_tris = S["tri_v0"].shape[0]
    num_inst = S["inst_w2o"].shape[0]
    if num_tris == 0 or num_inst == 0 or S["inst_bvh_root"].shape[0] != num_inst:
        raise ValueError("scene needs at least one triangle and one instance")
    return ptrs + [num_tris, num_inst]


def closest_hit(S, o, d, maxt, active) -> Hit:
    """Closest hit per ray through the CUDA kernel (plain version on CPU)."""
    if o.device.type != "cuda":
        return intersect_bvh(S, o, d, maxt, active, any_hit=False)
    hit = _launch.run_closest(
        load()[0], _scene_pointers(S, o.device), o, d, maxt, active
    )
    LAUNCHES["closest_hit"] += 1
    return hit


def any_hit(S, o, d, maxt, active) -> torch.Tensor:
    """Occlusion mask per ray through the CUDA kernel (plain version on CPU)."""
    if o.device.type != "cuda":
        return intersect_bvh(S, o, d, maxt, active, any_hit=True).mask
    found = _launch.run_any(
        load()[1], _scene_pointers(S, o.device), o, d, maxt, active
    )
    LAUNCHES["any_hit"] += 1
    return found
