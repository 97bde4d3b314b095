"""PyTorch wrappers of the CUDA traversal kernel (``csrc/intersect.cu``).

Four entry points. ``closest_hit`` and ``any_hit`` run the kernel's default
triangle test, det²-scaled Möller–Trumbore, with the signature the
integrator uses for every traversal backend: ``(S, o, d, maxt, active)``
with ``o, d`` [N,3] f32, ``maxt`` [N] f32, ``active`` [N] bool. The kernel
reads the uploaded scene's own tensors (``bvh_min/max/ldata/rdata``,
``tri_v0/e1/e2``, ``inst_w2o``, ``inst_bvh_root``); nothing is packed or
copied per call. ``closest_hit_hh`` and ``any_hit_hh`` run the kernel's
Havel–Herout test and take the flat 12-float rows of
``ops/intersect.py::pack_tris_hh`` as one more argument;
``hh_intersectors(S)`` packs them once and returns the pair bound to them.

On CUDA tensors a wrapper launches the kernel on PyTorch's current stream —
outputs allocated with ``torch.empty``, no synchronisation — or raises. On
CPU tensors (and only then) it runs the plain PyTorch version,
``ops/intersect.py::intersect_bvh`` with ``leaf="det2"`` or ``leaf="hh"``,
which the CPU tests use. ``LAUNCHES`` counts kernel launches per entry
point, and nothing else.
"""

from __future__ import annotations

import torch

from . import _launch
from ._launch import check as _check
from .intersect import Hit, host_geometry, intersect_bvh, pack_tris_hh

SOURCE = "intersect.cu"

LAUNCHES = {"closest_hit": 0, "any_hit": 0, "closest_hit_hh": 0, "any_hit_hh": 0}

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
    """Build (first use) and bind the kernel library; cached per process.
    Returns ``(closest_hit, any_hit, closest_hit_hh, any_hit_hh)``."""
    global _LIB
    if _LIB is None:
        _LIB = _launch.bind(
            SOURCE, "polaris_closest_hit", "polaris_any_hit", "p" * 9 + "ii"
        ) + _launch.bind(
            SOURCE, "polaris_closest_hit_hh", "polaris_any_hit_hh", "p" * 7 + "ii"
        )
    return _LIB


def _scene_pointers(S, device, tris_hh=None):
    """The kernel's scene arguments; with ``tris_hh`` the one pointer to the
    Havel–Herout rows takes the place of ``tri_v0/e1/e2``."""
    ptrs = []
    for name, dtype, ndim in _SCENE_ARGS:
        x = S[name]
        _check(name, x, dtype, ndim, device)
        if tris_hh is None or not name.startswith("tri_"):
            ptrs.append(x.data_ptr())
        elif name == "tri_v0":
            _check("tris_hh", tris_hh, torch.float32, 1, device)
            if tris_hh.numel() != 12 * x.shape[0]:
                raise ValueError(
                    f"tris_hh: {tris_hh.numel()} floats, expected 12 per "
                    f"triangle of {x.shape[0]}"
                )
            ptrs.append(tris_hh.data_ptr())
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
        return intersect_bvh(S, o, d, maxt, active, any_hit=False, leaf="det2")
    hit = _launch.run_closest(
        load()[0], _scene_pointers(S, o.device), o, d, maxt, active
    )
    LAUNCHES["closest_hit"] += 1
    return hit


def any_hit(S, o, d, maxt, active) -> torch.Tensor:
    """Occlusion mask per ray through the CUDA kernel (plain version on CPU)."""
    if o.device.type != "cuda":
        return intersect_bvh(S, o, d, maxt, active, any_hit=True, leaf="det2").mask
    found = _launch.run_any(
        load()[1], _scene_pointers(S, o.device), o, d, maxt, active
    )
    LAUNCHES["any_hit"] += 1
    return found


def closest_hit_hh(S, tris_hh, o, d, maxt, active) -> Hit:
    """Closest hit per ray through the kernel's Havel–Herout test over the
    rows ``tris_hh`` (plain version on CPU)."""
    if o.device.type != "cuda":
        return intersect_bvh(
            S, o, d, maxt, active, any_hit=False, leaf="hh", tris_hh=tris_hh
        )
    hit = _launch.run_closest(
        load()[2], _scene_pointers(S, o.device, tris_hh), o, d, maxt, active
    )
    LAUNCHES["closest_hit_hh"] += 1
    return hit


def any_hit_hh(S, tris_hh, o, d, maxt, active) -> torch.Tensor:
    """Occlusion mask per ray through the kernel's Havel–Herout test
    (plain version on CPU)."""
    if o.device.type != "cuda":
        return intersect_bvh(
            S, o, d, maxt, active, any_hit=True, leaf="hh", tris_hh=tris_hh
        ).mask
    found = _launch.run_any(
        load()[3], _scene_pointers(S, o.device, tris_hh), o, d, maxt, active
    )
    LAUNCHES["any_hit_hh"] += 1
    return found


def hh_intersectors(S):
    """``(closest_hit, any_hit)`` with the integrator's signature, bound to
    the scene's Havel–Herout rows: packed here once, on the host, and
    uploaded to the scene's device (``closest.tris_hh``)."""
    tris_hh = torch.from_numpy(pack_tris_hh(host_geometry(S))).to(S["tri_v0"].device)

    def closest(S, o, d, maxt, active):
        return closest_hit_hh(S, tris_hh, o, d, maxt, active)

    def any_hit(S, o, d, maxt, active):
        return any_hit_hh(S, tris_hh, o, d, maxt, active)

    closest.tris_hh = tris_hh
    return closest, any_hit
