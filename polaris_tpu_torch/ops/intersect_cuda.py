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

import ctypes

import torch

from ._build import load_library
from .intersect import Hit, intersect_bvh

SOURCE = "intersect.cu"
# each multiply and add rounds on its own, as in the plain PyTorch version,
# so both take identical hit/miss decisions (see the note in the source)
EXTRA_FLAGS = ("-fmad=false",)

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
    if _LIB is not None:
        return _LIB
    lib = load_library(SOURCE, EXTRA_FLAGS)
    p, i = ctypes.c_void_p, ctypes.c_int
    scene = [p] * 9 + [i, i]
    # scene, n, (o, d, maxt, active), outputs, stream
    lib.polaris_closest_hit.argtypes = scene + [i] + [p] * 4 + [p] * 6 + [p]
    lib.polaris_closest_hit.restype = i
    lib.polaris_any_hit.argtypes = scene + [i] + [p] * 4 + [p] + [p]
    lib.polaris_any_hit.restype = i
    _LIB = lib
    return lib


def _check(name, x, dtype, ndim, device):
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


def _ray_pointers(o, d, maxt, active):
    device = o.device
    n = o.shape[0]
    _check("o", o, torch.float32, 2, device)
    _check("d", d, torch.float32, 2, device)
    _check("maxt", maxt, torch.float32, 1, device)
    if active.dtype not in (torch.bool, torch.uint8):
        raise TypeError(f"active: dtype {active.dtype}, expected bool or uint8")
    _check("active", active, active.dtype, 1, device)
    if o.shape[1] != 3 or tuple(d.shape) != (n, 3) or maxt.shape[0] != n or active.shape[0] != n:
        raise ValueError(
            f"ray shapes disagree: o {tuple(o.shape)}, d {tuple(d.shape)}, "
            f"maxt {tuple(maxt.shape)}, active {tuple(active.shape)}"
        )
    return n, [o.data_ptr(), d.data_ptr(), maxt.data_ptr(), active.data_ptr()]


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: kernel launch failed with CUDA error {err}")


def closest_hit(S, o, d, maxt, active) -> Hit:
    """Closest hit per ray through the CUDA kernel (plain version on CPU)."""
    if o.device.type != "cuda":
        return intersect_bvh(S, o, d, maxt, active, any_hit=False)
    n, rays = _ray_pointers(o, d, maxt, active)
    scene = _scene_pointers(S, o.device)
    lib = load()
    f32 = dict(dtype=torch.float32, device=o.device)
    t = torch.empty(n, **f32)
    u = torch.empty(n, **f32)
    v = torch.empty(n, **f32)
    tri = torch.empty(n, dtype=torch.int32, device=o.device)
    inst = torch.empty(n, dtype=torch.int32, device=o.device)
    found = torch.empty(n, dtype=torch.bool, device=o.device)
    with torch.cuda.device(o.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.polaris_closest_hit(
            *scene, n, *rays,
            t.data_ptr(), u.data_ptr(), v.data_ptr(), tri.data_ptr(),
            inst.data_ptr(), found.data_ptr(), stream,
        )
    _raise_on(err, "polaris_closest_hit")
    LAUNCHES["closest_hit"] += 1
    return Hit(t, inst, tri, u, v, found)


def any_hit(S, o, d, maxt, active) -> torch.Tensor:
    """Occlusion mask per ray through the CUDA kernel (plain version on CPU)."""
    if o.device.type != "cuda":
        return intersect_bvh(S, o, d, maxt, active, any_hit=True).mask
    n, rays = _ray_pointers(o, d, maxt, active)
    scene = _scene_pointers(S, o.device)
    lib = load()
    found = torch.empty(n, dtype=torch.bool, device=o.device)
    with torch.cuda.device(o.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.polaris_any_hit(*scene, n, *rays, found.data_ptr(), stream)
    _raise_on(err, "polaris_any_hit")
    LAUNCHES["any_hit"] += 1
    return found
