"""The shading kernel (``csrc/shade.cu``, ``ops/shade_cuda.py``) on the CPU.

The kernel itself runs only on a card, where ``chip_smoke.py``'s ``shade``
phase holds it against its plain version (``render/shade.py::
shade_bounce_plain`` and ``nee_add_plain``) bit for bit. Here, without one:

  * the rule that sends a bounce to the kernel: CPU tensors and calls that
    autograd records take the plain version
  * the bits of what each scene holds (``statics_bits``): a triangle's uv
    rows are read only where a surface samples a texture
  * the wrapper's checks (dtype, shape, device, layout, the draw closure)
    raise before anything is launched, and the argument struct it fills is
    ``struct ShadeArgs`` of ``csrc/shade_args.cuh`` field for field
  * ``LAUNCHES`` is one of ``_launch.launch_tables()``, so graph replays
    count its launches
  * no ``__global__`` function of the library would be booked as traversal
    by the benchmark's metric (``benchmark/metrics/traversal_ms.frame.py``)
  * the kernel's device code, compiled for the host with ``g++`` (stub
    CUDA declarations, each multiply and add rounded on its own, the
    transcendentals and square roots those of PyTorch's CPU functions, a
    division by a Python number as the CPU's PyTorch takes it), gives the
    plain version's results bit for bit, bounce by bounce and in whole
    frames of every sample loop
"""

import ctypes
import importlib.util
import os
import re
import subprocess

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from polaris_tpu_torch.asset.compiler.compiler import compile_scene  # noqa: E402
from polaris_tpu_torch.asset.wavefront import read_scene  # noqa: E402
from polaris_tpu_torch.ops import _launch, rng, shade_cuda  # noqa: E402
from polaris_tpu_torch.ops.intersect import Hit  # noqa: E402
from polaris_tpu_torch.render import integrator  # noqa: E402
from polaris_tpu_torch.render.integrator import TorchRenderer  # noqa: E402
from polaris_tpu_torch.render.options import RenderOptions  # noqa: E402
from polaris_tpu_torch.render.shade import nee_add_plain, shade_bounce_plain  # noqa: E402
from polaris_tpu_torch.render.shade_check import (  # noqa: E402
    MASKED_BY,
    coverage_scene,
    shade_bounces,
)
from polaris_tpu_torch.scene import upload_scene  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(REPO, "polaris_tpu_torch", "csrc")
SCENES = ["sphere", "instanced", "cornell", "mitsuba", "dispersive"]
# whether a surface of the scene samples a texture at its uv
SAMPLES_UV = {"sphere": False, "instanced": False, "cornell": False, "mitsuba": True,
              "dispersive": True, "coverage": True}


@pytest.fixture(scope="module")
def compiled(scenes_dir):
    return {
        name: compile_scene(read_scene(os.path.join(scenes_dir, f"{name}.obj")))
        for name in SCENES
    }


def _lanes(n=8):
    """Valid arguments of one bounce over ``n`` CPU lanes."""
    f32 = dict(dtype=torch.float32)
    hit = Hit(torch.ones(n, **f32), torch.zeros(n, dtype=torch.int32),
              torch.zeros(n, dtype=torch.int32), torch.zeros(n, **f32),
              torch.zeros(n, **f32), torch.ones(n, dtype=torch.bool))
    pix = torch.arange(n, dtype=torch.int64)
    kw = dict(
        ray_o=torch.zeros((n, 3), **f32), ray_d=torch.ones((n, 3), **f32),
        alive=torch.ones(n, dtype=torch.bool), throughput=torch.ones((n, 3), **f32),
        flags=torch.zeros(n, dtype=torch.int32), radiance=torch.zeros((n, 3), **f32),
        U=rng.make_uniform(3, pix, 0, 1), bounce=1, is_primary=False,
        min_bounces_for_rr=3, num_emissives=2, scene_diffuse_mat=-1, material_depth=0,
    )
    return hit, kw


# ----------------------------------------------------------------- the rule


def test_cpu_tensors_take_the_plain_version(compiled, monkeypatch):
    """A frame on the CPU never calls the kernel's wrapper."""
    def refuse(*a, **kw):
        raise AssertionError("the kernel's wrapper was called for CPU tensors")

    monkeypatch.setattr(shade_cuda, "shade_bounce", refuse)
    monkeypatch.setattr(shade_cuda, "nee_add", refuse)
    r = TorchRenderer(compiled["cornell"], device="cpu", mode="bvh")
    acc = r.render_accum(RenderOptions(width=8, height=8, spp=1, num_bounces=2))
    assert torch.isfinite(acc).all() and float(acc.sum()) > 0
    hit, kw = _lanes()
    assert not shade_cuda.takes_kernel(r.S, kw["ray_o"], kw["ray_d"])


def test_calls_autograd_records_take_the_plain_version():
    S = {"mat_scale": torch.ones(3), "_stx": None}
    x = torch.zeros((4, 3))
    with torch.no_grad():
        assert not shade_cuda.records_autograd(S, x)
        S["mat_scale"].requires_grad_(True)
        assert not shade_cuda.records_autograd(S, x)
    # a scene leaf that takes a gradient, or a ray that carries one
    assert shade_cuda.records_autograd(S, x)
    S["mat_scale"] = torch.ones(3)
    assert not shade_cuda.records_autograd(S, x)
    assert shade_cuda.records_autograd(S, x, torch.zeros(4, requires_grad=True))


def test_the_loss_records_autograd(compiled, monkeypatch):
    """Every bounce of the loss's forward is one that autograd records (so
    on a card the rule keeps it off the kernel, which has no backward)."""
    from polaris_tpu_torch.render.grad import DifferentiableRenderer, loss_and_grad_eager

    seen = []
    rule = shade_cuda.takes_kernel
    monkeypatch.setattr(shade_cuda, "takes_kernel", lambda S, *t: seen.append(
        shade_cuda.records_autograd(S, *t)) or rule(S, *t))
    r = DifferentiableRenderer(compiled["cornell"], device="cpu", mode="bvh")
    opt = RenderOptions(width=4, height=4, spp=1, num_bounces=2)
    loss, _, _ = loss_and_grad_eager(r, opt, np.zeros((4, 4, 3), np.float32))
    assert np.isfinite(loss) and seen and all(seen)


# ----------------------------------------------------------------- statics


@pytest.mark.parametrize("name", SCENES + ["coverage"])
def test_uv_bit_of_each_scene(compiled, scenes_dir, name):
    """The uv rows are read where a surface samples a texture, and always
    where the scene carries no statics."""
    scene = coverage_scene(scenes_dir) if name == "coverage" else compiled[name]
    S = upload_scene(scene, "cpu")
    assert bool(shade_cuda.statics_bits(S) & shade_cuda.STATIC_UV) == SAMPLES_UV[name]
    assert shade_cuda.statics_bits({**S, "_stx": None}) & shade_cuda.STATIC_UV


def test_statics_bits(compiled):
    bits = {n: shade_cuda.statics_bits(upload_scene(compiled[n], "cpu")) for n in SCENES}
    assert bits["sphere"] == shade_cuda.STATIC_TEX_F32  # the compiler's 1x1 default texture
    assert bits["mitsuba"] == shade_cuda.STATIC_TEX_U8 | shade_cuda.STATIC_UV
    assert bits["dispersive"] == (shade_cuda.STATIC_DISPERSE | shade_cuda.STATIC_TEX_F32
                                  | shade_cuda.STATIC_UV)


# ----------------------------------------------------------------- the wrapper


def test_args_struct_matches_the_c_struct():
    with open(os.path.join(CSRC, "shade_args.cuh")) as f:
        body = re.search(r"struct ShadeArgs \{(.*?)\n\};", f.read(), re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    names = []
    for decl in body.split(";"):
        decl = decl.strip()
        if decl:
            names += [re.sub(r"[^A-Za-z0-9_]", "", v.split()[-1]) for v in decl.split(",")]
    assert names == [f for f, _ in shade_cuda.ShadeArgs._fields_]
    assert ctypes.sizeof(shade_cuda.ShadeArgs) == 8 * (len(names) + 3 * len(shade_cuda.COUNTERS))


def test_pack_args_points_at_the_tensors(compiled):
    S = upload_scene(compiled["mitsuba"], "cpu")
    hit, kw = _lanes()
    args, out = shade_cuda.pack_args(S, hit, **kw)
    assert args.n == 8 and args.ray_d == kw["ray_d"].data_ptr()
    assert args.hit_tri == hit.tri.data_ptr() and args.tex_table == S["_tex_table"].data_ptr()
    assert args.tex_u8_len == S["tex_data_u8"].numel()
    assert args.statics == shade_cuda.statics_bits(S) and args.material_depth == 0
    # counters: a Python int by value, a tensor by pointer, one a lane
    assert (args.seed.ptr, args.seed.imm) == (0, 3)
    assert (args.pixel.ptr, args.pixel.per_lane, args.pixel.is64) == (
        kw["U"].counters["pixel"].data_ptr(), 1, 1)
    assert args.rr_key.ptr == 0 and args.bounce.imm == 1 and args.is_primary.imm == 0
    assert args.out_radiance == out["radiance"].data_ptr()
    assert out["next_mask"].dtype == torch.bool and out["flags"].dtype == torch.int32


def _bad(kw, hit):
    n = 8
    yield "throughput", dict(kw, throughput=kw["throughput"].double()), hit, TypeError
    yield "flags", dict(kw, flags=kw["flags"].long()), hit, TypeError
    yield "ray_o shape", dict(kw, ray_o=torch.zeros((n, 4))), hit, ValueError
    yield "radiance layout", dict(kw, radiance=torch.zeros((3, n)).t()), hit, ValueError
    yield "alive", dict(kw, alive=torch.ones(n - 1, dtype=torch.bool)), hit, ValueError
    yield "hit_tri", kw, hit._replace(tri=hit.tri.long()), TypeError
    yield "sample", dict(kw, U=rng.make_uniform(0, torch.arange(n), torch.zeros(3).long(), 0)), \
        hit, ValueError
    yield "seed dtype", dict(kw, U=rng.make_uniform(torch.tensor(1.0), torch.arange(n), 0, 0)), \
        hit, TypeError
    yield "closure", dict(kw, U=lambda stream: None), hit, TypeError


@pytest.mark.parametrize("case", range(9))
def test_wrapper_checks_raise(compiled, case):
    S = upload_scene(compiled["sphere"], "cpu")
    hit, kw = _lanes()
    name, bad_kw, bad_hit, err = list(_bad(kw, hit))[case]
    with pytest.raises(err):
        shade_cuda.shade_bounce(S, bad_hit, **bad_kw)


def test_wrapper_refuses_cpu_tensors(compiled):
    S = upload_scene(compiled["sphere"], "cpu")
    hit, kw = _lanes()
    with pytest.raises(ValueError, match="CUDA device"):
        shade_cuda.shade_bounce(S, hit, **kw)
    r, m = kw["radiance"], hit.mask
    with pytest.raises(ValueError, match="CUDA device"):
        shade_cuda.nee_add(r, m, m, r)
    with pytest.raises(TypeError):
        shade_cuda.nee_add(r, m, m.to(torch.uint8), r)


def test_launches_are_a_launch_table():
    assert any(t is shade_cuda.LAUNCHES for t in _launch.launch_tables())
    assert set(shade_cuda.LAUNCHES) == {"shade_bounce", "nee_add"}


def test_draw_closure_carries_its_counters():
    pix = torch.arange(4)
    key = rng.rr_block_key(pix, 64)
    U = rng.make_uniform(5, pix, 2, 3, rr_key=key)
    assert U.counters == dict(seed=5, pixel=pix, sample=2, bounce=3, rr_key=key)


# ----------------------------------------------------------------- symbols


def _traversal_symbols():
    path = os.path.join(REPO, "benchmark", "metrics", "traversal_ms.frame.py")
    spec = importlib.util.spec_from_file_location("traversal_ms_frame", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.SYMBOLS


def test_no_kernel_symbol_reads_as_traversal():
    """Every ``__global__`` function, with its namespace and every template
    argument and parameter type it can be demangled with."""
    symbols = _traversal_symbols()
    names = []
    for f in sorted(os.listdir(CSRC)):
        if f.startswith("shade") and f.endswith((".cu", ".cuh")):
            with open(os.path.join(CSRC, f)) as fh:
                text = re.sub(r"__launch_bounds__\(\w+\)", "", fh.read())
            names += re.findall(r"__global__[^(]*?(\w+)\s*\(", text)
            names += re.findall(r"namespace\s+(\w+)", text)
    assert {"shade_bounce_kernel", "nee_add_kernel", "polaris_shade"} <= set(names)
    demangled = ["void polaris_shade::shade_bounce_kernel(polaris_shade::ShadeArgs)"]
    demangled.append("polaris_shade::nee_add_kernel(long long, float*, unsigned char const*, "
                     "unsigned char const*, float const*)")
    for name in names + demangled:
        assert symbols.search(name) is None, name


# ----------------------------------------------------------------- host build

STUB = r"""
#pragma once
#include <algorithm>
#include <cmath>
#include <cstddef>
#include <cstdint>
#define __device__
#define __global__
#define __forceinline__ inline
#define __launch_bounds__(x)
struct HostDim { unsigned x = 0, y = 0, z = 0; };
static HostDim blockIdx, threadIdx;
template <class T> T __ldg(const T* p) { return *p; }
using std::max;
using std::min;
typedef void* cudaStream_t;
typedef int cudaError_t;
const int cudaSuccess = 0;
struct cudaFuncAttributes { int numRegs; size_t localSizeBytes; };
inline cudaError_t cudaGetLastError() { return 0; }
template <class F> cudaError_t cudaFuncGetAttributes(cudaFuncAttributes*, F) { return 0; }
extern "C" {
typedef float (*host_f1)(float);
typedef float (*host_f2)(float, float);
host_f1 host_sqrtf, host_cosf, host_sinf, host_atanf, host_acosf;
host_f2 host_atan2f;
void host_math(host_f1 a, host_f1 b, host_f1 c, host_f1 d, host_f1 e, host_f2 f) {
    host_sqrtf = a; host_cosf = b; host_sinf = c; host_atanf = d; host_acosf = e; host_atan2f = f;
}
}
#define sqrtf(x) host_sqrtf(x)
#define cosf(x) host_cosf(x)
#define sinf(x) host_sinf(x)
#define atanf(x) host_atanf(x)
#define acosf(x) host_acosf(x)
#define atan2f(x, y) host_atan2f(x, y)
"""

DRIVER = r"""
extern "C" void host_shade(const polaris_shade::ShadeArgs* a) {
    for (long long i = 0; i < a->n; ++i) {
        blockIdx.x = i / polaris_shade::THREADS;
        threadIdx.x = i % polaris_shade::THREADS;
        polaris_shade::shade_bounce_kernel(*a);
    }
}
extern "C" void host_nee(long long n, float* r, const uint8_t* m, const uint8_t* o,
                         const float* v) {
    for (long long i = 0; i < n; ++i) {
        blockIdx.x = i / polaris_shade::THREADS;
        threadIdx.x = i % polaris_shade::THREADS;
        polaris_shade::nee_add_kernel(n, r, m, o, v);
    }
}
"""

# a card's PyTorch divides by a Python number as a multiply by its float
# reciprocal (the kernel does the same); the CPU's divides
CPU_DIVISIONS = (("acosf(c) * (1.0f / F32(PI))", "acosf(c) / F32(PI)"),
                 ("at2 * (1.0f / F32(TWO_PI))", "at2 / F32(TWO_PI)"))


def _torch_f1(fn):
    return lambda x: float(fn(torch.tensor([x], dtype=torch.float32))[0])


@pytest.fixture(scope="module")
def host_kernel(tmp_path_factory):
    d = tmp_path_factory.mktemp("shade_host")
    with open(d / "cuda_runtime.h", "w") as f:
        f.write(STUB)
    for name in os.listdir(CSRC):
        if not name.startswith("shade"):
            continue
        with open(os.path.join(CSRC, name)) as f:
            text = f.read()
        if name == "shade_vec.cuh":
            for old, new in CPU_DIVISIONS:
                assert old in text
                text = text.replace(old, new)
            text = '#include "cuda_runtime.h"\n' + text
        if name == "shade.cu":
            text = text.replace("#include <cuda_runtime.h>", '#include "cuda_runtime.h"')
            text = re.sub(r"<<<.*?>>>", "", text, flags=re.S) + DRIVER
            name = "shade_host.cpp"
        with open(d / name, "w") as f:
            f.write(text)
    lib_path = str(d / "libshade_host.so")
    subprocess.run(
        ["g++", "-std=c++17", "-O1", "-ffp-contract=off", "-fno-fast-math", "-shared",
         "-fPIC", "-w", "-I", str(d), str(d / "shade_host.cpp"), "-o", lib_path],
        check=True, capture_output=True, timeout=300,
    )
    lib = ctypes.CDLL(lib_path)
    f1 = ctypes.CFUNCTYPE(ctypes.c_float, ctypes.c_float)
    f2 = ctypes.CFUNCTYPE(ctypes.c_float, ctypes.c_float, ctypes.c_float)
    keep = [f1(_torch_f1(fn)) for fn in (torch.sqrt, torch.cos, torch.sin, torch.atan, torch.acos)]
    keep.append(f2(lambda y, x: float(torch.atan2(torch.tensor([y]), torch.tensor([x]))[0])))
    lib.host_math(*keep)
    lib.host_shade.argtypes = [ctypes.POINTER(shade_cuda.ShadeArgs)]
    lib.host_nee.argtypes = [ctypes.c_longlong] + [ctypes.c_void_p] * 4

    def shade_bounce(S, hit, **kw):
        args, out = shade_cuda.pack_args(S, hit, **kw)
        lib.host_shade(ctypes.byref(args))
        return out.pop("radiance"), out

    def nee_add(radiance, occl_mask, occluded, value):
        lib.host_nee(radiance.shape[0], radiance.data_ptr(), occl_mask.data_ptr(),
                     occluded.data_ptr(), value.data_ptr())
        return radiance

    yield shade_bounce, nee_add, keep


def _same(got, want, where=None):
    g = got.contiguous().view(torch.int32) if got.dtype == torch.float32 else got
    w = want.contiguous().view(torch.int32) if want.dtype == torch.float32 else want
    diff = g != w
    if diff.dim() > 1:
        diff = diff.any(dim=-1)
    if where is not None:
        diff = diff & where
    return int(diff.sum())


def _scene(compiled, scenes_dir, name):
    return coverage_scene(scenes_dir) if name == "coverage" else compiled[name]


@pytest.mark.parametrize("per_lane", [False, True])
@pytest.mark.parametrize("name", ["sphere", "dispersive", "coverage"])
def test_host_build_equals_the_plain_version(compiled, scenes_dir, host_kernel, name, per_lane):
    """Every result of the first bounces of a 32x32 frame, as chip_smoke's
    ``shade`` phase holds the kernel on a card (``coverage``: every material
    operator, BxDF, light kind and texture storage)."""
    shade_bounce, nee_add, _ = host_kernel
    r = TorchRenderer(_scene(compiled, scenes_dir, name), device="cpu", mode="bvh")
    rows = 0
    with torch.no_grad():
        for b, hit, kw in shade_bounces(r, 32, seed=7, per_lane=per_lane):
            rad_p, out_p = shade_bounce_plain(r.S, hit, **kw)
            rad_k, out_k = shade_bounce(r.S, hit, **kw)
            assert _same(rad_k, rad_p) == 0, (b, "radiance")
            for k, got in out_k.items():
                where = out_p.get(MASKED_BY.get(k, ""))
                assert _same(got, out_p[k], where) == 0, (b, k)
            occluded = r.any_hit(r.S, out_p["occl_o"], out_p["occl_d"], out_p["occl_maxt"],
                                 out_p["occl_mask"])
            args = (out_p["occl_mask"], occluded, out_p["occl_value"])
            assert _same(nee_add(rad_p.clone(), *args), nee_add_plain(rad_p, *args)) == 0
            rows += int(hit.mask.sum())
    assert rows > 0


@pytest.mark.parametrize("loop", ["sequential", "regen", "compact", "batch_samples"])
def test_host_build_frames_equal_the_plain_frames(compiled, scenes_dir, host_kernel, monkeypatch,
                                                  loop):
    """Whole frames of every sample loop with the kernel's device code
    against the plain version: equal accumulators."""
    shade_bounce, nee_add, _ = host_kernel
    scene = _scene(compiled, scenes_dir, "coverage")
    flags = {} if loop == "sequential" else {loop: True}
    opt = RenderOptions(width=16, height=16, spp=2, num_bounces=5, min_bounces_for_rr=2,
                        seed=9, rr_tile_coherent=loop == "compact")
    with torch.no_grad():
        want = TorchRenderer(scene, device="cpu", mode="bvh", **flags).render_accum(opt)
        calls = []
        monkeypatch.setattr(shade_cuda, "takes_kernel", lambda S, *t: True)
        monkeypatch.setattr(shade_cuda, "shade_bounce",
                            lambda *a, **kw: calls.append(1) or shade_bounce(*a, **kw))
        monkeypatch.setattr(shade_cuda, "nee_add", nee_add)
        got = TorchRenderer(scene, device="cpu", mode="bvh", **flags).render_accum(opt)
    assert calls and torch.equal(got, want)
    assert integrator.shade_cuda is shade_cuda
