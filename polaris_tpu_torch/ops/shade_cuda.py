"""The shading kernel (``csrc/shade.cu``): its PyTorch wrappers and the rule
that sends a bounce to it.

``shade_bounce`` shades one bounce of every lane in one launch: the miss
background, the surface, the layered material, texture samples, emission,
Russian roulette, the BxDF sample and next-event estimation with MIS, and
the radiance adds. Its PLAIN VERSION is ``render/shade.py::shade`` and
``shade_miss`` with the adds of ``render/integrator.py::_trace_bounce``:
some 740 PyTorch kernels a bounce on a card. ``nee_add`` adds the NEE value
of every shadow ray that reached its light, after the any-hit pass. A bounce
thus takes two shading kernels around the two traversal launches.

The kernel replaces no TPU kernel (the JAX package's shading is jnp code that
XLA fuses); its upstream counterpart is the reference's ``shadeHits``
mega-kernel (``CL/kernels/pt_integrator.cl:17-211``). It is bound by bytes,
not arithmetic: every intermediate of a lane stays in registers, and a lane
reads its state and its triangle's rows and writes its results once. Every
output a later stage reads equals the plain version's bit for bit (the same
operations in the same association, the same draws; ``chip_smoke.py``'s
``shade`` phase holds it there on a card). A lane that does not shade gets
its incoming ray as its next and shadow ray, whose masks are false, where
the plain version leaves unused arithmetic.

**Which path a bounce takes** (``takes_kernel``): on CUDA tensors the kernel,
unless autograd would record the call (``torch.is_grad_enabled()`` and a ray
or path tensor, or a tensor of the scene, requires a gradient): the kernel
has no backward, and the plain version is the differentiable path, which
the loss step (``render/grad.py``) takes. On the CPU the plain version runs.
A call the kernel refuses (a wrong dtype, shape, device or layout) raises;
nothing falls back.

**One kernel for every scene.** A lane takes the branch of its own material
operator, BxDF type and light kind, so on a scene of one type the branches
are warp-uniform. What the scene holds reaches the kernel as bits of
``ShadeArgs::statics`` (``statics_bits``, from ``ops/statics.py``): a
disperse node, the texture storage kinds, and whether a surface samples a
texture at its uv (only then are the triangle's uv rows read).

**Counters.** The draws are keyed as ``ops/rng.py::make_uniform`` keys them,
from the counters its closure carries (``U.counters``): the seed, the
pixel, the sample, the bounce and the tile-coherent RR key. A Python int is
passed by value, as the plain version takes it as a scalar argument; a
tensor is read through its pointer, one value (the 0-d seed and sample index
a captured graph reads from device memory, so one graph serves every frame)
or one per lane (path regeneration, ``batch_samples``, ``compact``).

``LAUNCHES`` counts launches per entry point (``_launch.launch_tables``
lists it, so graph replays count too). Where the shading census is on
(``utils/profiling.py::shade_census``), ``shade_bounce`` counts the lanes
with PyTorch operations on its inputs and results after the launch
(``render/shade.py::take_census``); the kernel itself is the same.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from . import _launch
from ._build import load_library
from .statics import TEXTURE_FIELDS, has_op, tex_on
from .texture import STORE_F32, STORE_LUM8

SOURCE = "shade.cu"

LAUNCHES = {"shade_bounce": 0, "nee_add": 0}

# ShadeArgs::statics (csrc/shade_args.cuh)
STATIC_DISPERSE, STATIC_TEX_F32, STATIC_TEX_U8, STATIC_TEX_LUM8, STATIC_UV = 1, 2, 4, 8, 16

_F32, _I32, _I64, _U8 = torch.float32, torch.int32, torch.int64, torch.uint8

# the scene tensors the kernel reads: (key of S, dtype, dims)
SCENE_TENSORS = (
    ("tri_normals", _F32, 2), ("tri_uvs", _F32, 2), ("tri_material", _I32, 1),
    ("inst_w2o", _F32, 3), ("mat_type", _I32, 1), ("mat_left", _I32, 1),
    ("mat_right", _I32, 1), ("mat_mix_weight", _F32, 1), ("mat_bump_tex", _I32, 1),
    ("mat_reflectance", _F32, 2), ("mat_specularity", _F32, 2),
    ("mat_transmittance", _F32, 2), ("mat_radiance", _F32, 2), ("mat_int_ior", _F32, 1),
    ("mat_ext_ior", _F32, 1), ("mat_scale", _F32, 1), ("mat_roughness", _F32, 1),
    ("mat_reflectance_tex", _I32, 1), ("mat_specularity_tex", _I32, 1),
    ("mat_transmittance_tex", _I32, 1), ("mat_radiance_tex", _I32, 1),
    ("mat_roughness_tex", _I32, 1), ("mat_int_disp_ior", _F32, 2),
    ("mat_ext_disp_ior", _F32, 2), ("_tex_table", _I64, 2), ("tex_data", _F32, 1),
    ("tex_data_u8", _U8, 1),
)
LIGHT_TENSORS = (
    ("emis_tri", _I32, 1), ("emis_o2w", _F32, 3), ("emis_nmat", _F32, 3),
    ("emis_area", _F32, 1), ("emis_type", _I32, 1), ("emis_mat", _I32, 1),
    ("tri_v0", _F32, 2), ("tri_e1", _F32, 2), ("tri_e2", _F32, 2),
)
# the lanes' inputs: (name, dtype, shape after N)
LANE_INPUTS = (
    ("ray_o", _F32, (3,)), ("ray_d", _F32, (3,)), ("alive", torch.bool, ()),
    ("hit_t", _F32, ()), ("hit_u", _F32, ()), ("hit_v", _F32, ()), ("hit_tri", _I32, ()),
    ("hit_inst", _I32, ()), ("hit_mask", torch.bool, ()), ("throughput", _F32, (3,)),
    ("flags", _I32, ()), ("radiance", _F32, (3,)),
)
COUNTERS = ("seed", "pixel", "sample", "bounce", "rr_key", "is_primary")
# the results, in the order of ShadeArgs: (name, dtype, shape after N)
OUTPUTS = (
    ("radiance", _F32, (3,)), ("next_o", _F32, (3,)), ("next_d", _F32, (3,)),
    ("next_mask", torch.bool, ()), ("throughput", _F32, (3,)), ("flags", _I32, ()),
    ("occl_o", _F32, (3,)), ("occl_d", _F32, (3,)), ("occl_maxt", _F32, ()),
    ("occl_mask", torch.bool, ()), ("occl_value", _F32, (3,)),
)
CONSTANTS = ("statics", "num_emissives", "scene_diffuse_mat", "min_bounces_for_rr",
             "material_depth")


class Counter(ctypes.Structure):
    _fields_ = [(k, ctypes.c_longlong) for k in ("ptr", "per_lane", "is64", "imm")]


def _struct_fields():
    P, L = ctypes.c_void_p, ctypes.c_longlong
    fields = [(k.lstrip("_"), P) for k, _, _ in SCENE_TENSORS]
    fields += [("tex_f32_len", L), ("tex_u8_len", L)]
    fields += [(k, P) for k, _, _ in LIGHT_TENSORS]
    fields += [(k, L) for k in CONSTANTS] + [("n", L)]
    fields += [(k, P) for k, _, _ in LANE_INPUTS]
    fields += [(k, Counter) for k in COUNTERS]
    fields += [("out_" + k if k in ("radiance", "throughput", "flags") else k, P)
               for k, _, _ in OUTPUTS]
    return fields


class ShadeArgs(ctypes.Structure):
    """``struct ShadeArgs`` of ``csrc/shade_args.cuh``, field for field."""

    _fields_ = _struct_fields()


# ----------------------------------------------------------------- the rule


def records_autograd(S: Dict, *tensors: torch.Tensor) -> bool:
    """Whether autograd would record a shading call over ``tensors`` and the
    scene ``S``: gradients are on and one of them, or a tensor of ``S``,
    requires one."""
    if not torch.is_grad_enabled():
        return False
    return any(t.requires_grad for t in tensors) or any(
        isinstance(v, torch.Tensor) and v.requires_grad for v in S.values()
    )


def takes_kernel(S: Dict, *tensors: torch.Tensor) -> bool:
    """Whether a bounce over ``tensors`` (its rays and path state) and the
    scene ``S`` runs the kernel: on a card, unless autograd would record it."""
    return tensors[0].device.type == "cuda" and not records_autograd(S, *tensors)


def statics_bits(S: Dict) -> int:
    """``ShadeArgs::statics``: a disperse node, the texture storage kinds, and
    a surface that samples a texture at its uv (a texture-backed material
    field, or a mixMap, bumpMap or normalMap node)."""
    kinds = frozenset(r[3] for r in S["_tex_meta"].tex)
    bits = STATIC_DISPERSE if has_op(S, "disperse") else 0
    if any(tex_on(S, f) for f in TEXTURE_FIELDS) or any(
        has_op(S, op) for op in ("mixmap", "bump", "normal")
    ):
        bits |= STATIC_UV
    if STORE_F32 in kinds:
        bits |= STATIC_TEX_F32
    if kinds - {STORE_F32}:
        bits |= STATIC_TEX_U8
    if STORE_LUM8 in kinds:
        bits |= STATIC_TEX_LUM8
    return bits


# ----------------------------------------------------------------- arguments


def _counter(name: str, x, n: int, device) -> Counter:
    """A counter of the draws: absent, a Python int by value, or a tensor
    (0-d, or one value per lane) by pointer."""
    if x is None:
        return Counter(0, 0, 0, 0)
    if not isinstance(x, torch.Tensor):
        v = int(x)
        return Counter(0, 0, 0, v if -(2**63) <= v < 2**63 else v & 0xFFFFFFFF)
    kinds = {_I32: 0, _I64: 1, torch.bool: 2}
    if x.dtype not in kinds:
        raise TypeError(f"{name}: dtype {x.dtype}, expected int32, int64 or bool")
    if x.device != device:
        raise ValueError(f"{name}: on {x.device}, expected {device}")
    if x.dim() == 0:
        per_lane = 0
    elif x.numel() == n and x.shape[0] == n and x.is_contiguous():
        per_lane = 1
    else:
        raise ValueError(f"{name}: shape {tuple(x.shape)}, expected () or ({n},), contiguous")
    return Counter(x.data_ptr(), per_lane, kinds[x.dtype], 0)


def _check_lane(name, x, dtype, tail, n, device):
    _launch.check(name, x, dtype, 1 + len(tail), device)
    if tuple(x.shape) != (n, *tail):
        raise ValueError(f"{name}: shape {tuple(x.shape)}, expected {(n, *tail)}")


def _scene_pointers(S: Dict, spec, device):
    ptrs = []
    for key, dtype, ndim in spec:
        _launch.check(key, S[key], dtype, ndim, device)
        ptrs.append(S[key].data_ptr())
    return ptrs


def pack_args(S: Dict, hit, *, ray_o, ray_d, alive, throughput, flags, radiance, U, bounce,
              is_primary, min_bounces_for_rr: int, num_emissives: int,
              scene_diffuse_mat: int, material_depth) -> Tuple[ShadeArgs, Dict]:
    """Check every tensor and fill the kernel's arguments, with the result
    tensors (``torch.empty``). Raises on a wrong dtype, shape, device or
    layout; needs no card."""
    device = ray_o.device
    n = ray_o.shape[0] if ray_o.dim() else 0
    lanes = dict(
        ray_o=ray_o, ray_d=ray_d, alive=alive, hit_t=hit.t, hit_u=hit.u, hit_v=hit.v,
        hit_tri=hit.tri, hit_inst=hit.inst, hit_mask=hit.mask, throughput=throughput,
        flags=flags, radiance=radiance,
    )
    for name, dtype, tail in LANE_INPUTS:
        _check_lane(name, lanes[name], dtype, tail, n, device)
    counters = getattr(U, "counters", None)
    if counters is None:
        raise TypeError("U: a draw closure of ops/rng.py::make_uniform (it carries .counters)")
    seed, pixel, sample, rr_key = (counters[k] for k in ("seed", "pixel", "sample", "rr_key"))
    if isinstance(is_primary, torch.Tensor) and is_primary.dim() == 2:
        is_primary = is_primary.reshape(-1)  # the [N, 1] mask of regeneration
    count = dict(seed=seed, pixel=pixel, sample=sample, bounce=bounce, rr_key=rr_key,
                 is_primary=is_primary)
    packed = {k: _counter(k, count[k], n, device) for k in COUNTERS}
    out = {
        name: torch.empty((n, *tail), dtype=dtype, device=device)
        for name, dtype, tail in OUTPUTS
    }
    args = ShadeArgs()
    ptrs = _scene_pointers(S, SCENE_TENSORS, device) + [
        S["tex_data"].numel(), S["tex_data_u8"].numel()
    ] + _scene_pointers(S, LIGHT_TENSORS, device)
    consts = [statics_bits(S), int(num_emissives), int(scene_diffuse_mat),
              int(min_bounces_for_rr), 8 if material_depth is None else int(material_depth)]
    values = ptrs + consts + [n] + [lanes[k].data_ptr() for k, _, _ in LANE_INPUTS]
    values += [packed[k] for k in COUNTERS] + [out[k].data_ptr() for k, _, _ in OUTPUTS]
    for (field, _), value in zip(ShadeArgs._fields_, values, strict=True):
        setattr(args, field, value)
    return args, out


# ----------------------------------------------------------------- launches

_LIB = None


def load():
    """Build (first use) and bind the kernel library; cached per process.
    Returns ``(shade_bounce, nee_add, attributes)``."""
    global _LIB
    if _LIB is None:
        lib = load_library(SOURCE, _launch.EXTRA_FLAGS)
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        shade = lib.polaris_shade_bounce
        shade.argtypes = [ctypes.POINTER(ShadeArgs), P]
        shade.restype = I
        nee = lib.polaris_nee_add
        nee.argtypes = [L, P, P, P, P, P]
        nee.restype = I
        attrs = lib.polaris_shade_attributes
        attrs.argtypes = [ctypes.POINTER(I), ctypes.POINTER(I)]
        attrs.restype = I
        _LIB = (shade, nee, attrs)
    return _LIB


def attributes() -> Dict[str, int]:
    """Registers a thread and local-memory bytes (spills land there) of the
    shading kernel, from the loaded binary."""
    regs, local = ctypes.c_int(), ctypes.c_int()
    err = load()[2](ctypes.byref(regs), ctypes.byref(local))
    _launch.raise_on(err, "polaris_shade_attributes")
    return {"registers": regs.value, "local_bytes": local.value}


def _require_cuda(device) -> None:
    if device.type != "cuda":
        raise ValueError(
            f"the shading kernel runs on a CUDA device, got {device}: on the CPU "
            "render/shade.py::shade runs (takes_kernel)"
        )


def shade_bounce(S: Dict, hit, **kw) -> Tuple[torch.Tensor, Dict]:
    """One bounce's shading in one launch: returns ``(radiance, out)``, the
    radiance with the background of misses and the emission of hits added,
    and ``out`` with the keys of ``shade``'s dict less ``emit_add``. The
    arguments are ``_trace_bounce``'s (``pack_args``)."""
    args, out = pack_args(S, hit, **kw)
    device = kw["ray_o"].device
    _require_cuda(device)
    fn = load()[0]
    with torch.cuda.device(device), torch.profiler.record_function(fn.__name__):
        err = fn(ctypes.byref(args), torch.cuda.current_stream().cuda_stream)
    _launch.raise_on(err, fn.__name__)
    _launch.count(LAUNCHES, "shade_bounce")
    radiance = out.pop("radiance")
    # the census, where it is on, from the kernel's inputs and results
    from ..render.shade import take_census

    take_census(S, hit, out, **kw)
    return radiance, out


def nee_add(radiance, occl_mask, occluded, occl_value) -> torch.Tensor:
    """``radiance + where(occl_mask & ~occluded, occl_value, 0)``, written
    into ``radiance`` (the kernel's own result) and returned."""
    device = radiance.device
    n = radiance.shape[0] if radiance.dim() else 0
    _check_lane("radiance", radiance, _F32, (3,), n, device)
    _check_lane("occl_mask", occl_mask, torch.bool, (), n, device)
    _check_lane("occluded", occluded, torch.bool, (), n, device)
    _check_lane("occl_value", occl_value, _F32, (3,), n, device)
    _require_cuda(device)
    fn = load()[1]
    with torch.cuda.device(device), torch.profiler.record_function(fn.__name__):
        err = fn(n, radiance.data_ptr(), occl_mask.data_ptr(), occluded.data_ptr(),
                 occl_value.data_ptr(), torch.cuda.current_stream().cuda_stream)
    _launch.raise_on(err, fn.__name__)
    _launch.count(LAUNCHES, "nee_add")
    return radiance
