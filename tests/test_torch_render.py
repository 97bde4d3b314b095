"""The PyTorch port as a whole against the JAX package, on the CPU.

The same compiled scene (the JAX package's ``SceneData`` fields, handed over
as a dict of NumPy arrays through ``upload_scene``) is rendered by
``TpuRenderer(mode="packet")`` and by ``TorchRenderer(device="cpu")``, with the
sequential sample loop and with path regeneration on both sides.

Tolerance: the accumulators must agree within ``atol=1e-4, rtol=1e-3`` (the
gate of tests/test_parity.py). A lane whose Russian-roulette survival, BxDF
branch pick or ``> 0`` mask flips on a one-ulp difference between the two
frameworks changes its pixel by far more than any tolerance; such pixels
are COUNTED and may make up at most 0.5% of the frame. The textured scenes
(mitsuba: a byte-stored checker texture; dispersive: float-stored radiance
textures on an area light and on the lat-long environment) are held to
``atol=2e-4, rtol=1e-3``, the bound of tests/test_parity.py::_compare.

``python tests/test_torch_render.py --write-fixture`` regenerates
``tests/fixtures/torch_golden_sphere_32.npz`` and
``tests/fixtures/torch_golden_mitsuba_32.npz``, the JAX-made accumulators
that ``chip_smoke.py`` holds the CUDA path against on a machine without JAX.
"""

import os
import subprocess
import sys
from dataclasses import fields

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = {
    name: os.path.join(REPO, "tests", "fixtures", f"torch_golden_{name}_32.npz")
    for name in ("sphere", "mitsuba")
}
FIXTURE = FIXTURES["sphere"]
GOLDEN_OPT = dict(
    width=32, height=32, spp=2, num_bounces=2, min_bounces_for_rr=3, seed=0
)

ATOL, RTOL = 1e-4, 1e-3
TEXTURED_ATOL = 2e-4  # mitsuba, dispersive (tests/test_parity.py::_compare)
MAX_FLIPPED_SHARE = 0.005

# (scene, bounces, rr threshold): cornell/3/2 is the Russian-roulette case
CASES = [
    ("sphere", 2, 3),
    ("sphere", 3, 2),
    ("cornell", 2, 3),
    ("cornell", 3, 2),
]


def _scene_dict(scene):
    """State crosses as plain NumPy: every field of the JAX SceneData."""
    return {f.name: getattr(scene, f.name) for f in fields(scene)}


def _jax_scene(name):
    from polaris_tpu.asset.compiler.compiler import compile_scene
    from polaris_tpu.asset.wavefront import read_scene

    return compile_scene(read_scene(os.path.join(REPO, "scenes", f"{name}.obj")))


def _golden_accum(name="sphere"):
    from polaris_tpu.render.integrator import TpuRenderer
    from polaris_tpu.render.options import RenderOptions

    scene = _jax_scene(name)
    return np.asarray(
        TpuRenderer(scene, mode="packet").render_accum(RenderOptions(**GOLDEN_OPT))
    )


@pytest.fixture(scope="module")
def scenes(sphere_scene, cornell_scene):
    return {"sphere": sphere_scene, "cornell": cornell_scene}


@pytest.fixture(scope="module")
def jax_accum(scenes):
    """JAX reference accumulators, rendered once per (case, regen)."""
    from polaris_tpu.render.integrator import TpuRenderer
    from polaris_tpu.render.options import RenderOptions

    cache = {}

    def get(name, bounces, rr, regen, spp=2):
        key = (name, bounces, rr, regen, spp)
        if key not in cache:
            opt = RenderOptions(
                width=32, height=32, spp=spp, num_bounces=bounces,
                min_bounces_for_rr=rr,
            )
            r = TpuRenderer(scenes[name], mode="packet", regen=regen)
            cache[key] = np.asarray(r.render_accum(opt))
        return cache[key]

    return get


def _torch_renderer(scene, **kw):
    from polaris_tpu_torch.render.integrator import TorchRenderer

    return TorchRenderer(_scene_dict(scene), device="cpu", **kw)


def _torch_opt(**kw):
    from polaris_tpu_torch.render.options import RenderOptions

    base = dict(width=32, height=32, spp=2)
    base.update(kw)
    return RenderOptions(**base)


def _assert_close_counting_flips(got, ref, label, atol=ATOL):
    assert got.shape == ref.shape
    assert np.isfinite(got).all()
    bad = (~np.isclose(got, ref, atol=atol, rtol=RTOL)).any(axis=-1)
    n_bad = int(bad.sum())
    allowed = int(MAX_FLIPPED_SHARE * bad.size)
    print(f"{label}: {n_bad} of {bad.size} pixels outside tolerance (allowed {allowed})")
    assert n_bad <= allowed, (label, n_bad, float(np.abs(got - ref).max()))


@pytest.mark.parametrize("regen", [False, True], ids=["sequential", "regen"])
@pytest.mark.parametrize("name,bounces,rr", CASES)
def test_render_accum_matches_jax(scenes, jax_accum, name, bounces, rr, regen):
    ref = jax_accum(name, bounces, rr, regen)
    r = _torch_renderer(scenes[name], regen=regen)
    got = r.render_accum(_torch_opt(num_bounces=bounces, min_bounces_for_rr=rr))
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    _assert_close_counting_flips(got.numpy(), ref, f"{name}/{bounces}/{rr}/{regen}")
    assert ref.mean() > 1e-3  # the frame actually holds light


@pytest.mark.parametrize("regen", [False, True], ids=["sequential", "regen"])
def test_tile_coherent_rr_matches_jax(scenes, regen):
    """``rr_tile_coherent`` keys the Russian-roulette draw by 32x32 block on
    both sides; a 64x32 frame holds two blocks."""
    from polaris_tpu.render.integrator import TpuRenderer
    from polaris_tpu.render.options import RenderOptions

    kw = dict(width=64, height=32, spp=2, num_bounces=3, min_bounces_for_rr=1,
              rr_tile_coherent=True)
    ref = np.asarray(
        TpuRenderer(scenes["sphere"], mode="packet", regen=regen).render_accum(
            RenderOptions(**kw)
        )
    )
    got = _torch_renderer(scenes["sphere"], regen=regen).render_accum(_torch_opt(**kw))
    _assert_close_counting_flips(got.numpy(), ref, f"tile-coherent-rr/{regen}")
    plain = _torch_renderer(scenes["sphere"], regen=regen).render_accum(
        _torch_opt(**{**kw, "rr_tile_coherent": False})
    )
    assert not np.array_equal(got.numpy(), plain.numpy())  # the option bites


@pytest.mark.parametrize("regen", [False, True], ids=["sequential", "regen"])
def test_chunked_equals_one_launch(scenes, regen):
    """spp_per_launch=1 walks the same samples through the same estimator;
    only the float association of the partial sums may differ."""
    opt = _torch_opt(spp=3, num_bounces=3, min_bounces_for_rr=2)
    one = _torch_renderer(scenes["cornell"], regen=regen)
    one.spp_per_launch = 8
    chunked = _torch_renderer(scenes["cornell"], regen=regen)
    chunked.spp_per_launch = 1
    a = one.render_accum(opt).numpy()
    b = chunked.render_accum(opt).numpy()
    np.testing.assert_allclose(b, a, atol=1e-6, rtol=0)


def test_render_accum_offset_continues_the_sample_sequence(scenes):
    """Samples [0,2) + samples [2,4) == samples [0,4) (progressive use)."""
    r = _torch_renderer(scenes["sphere"])
    r.spp_per_launch = 2
    whole = r.render_accum(_torch_opt(spp=4, num_bounces=2)).numpy()
    first = r.render_accum_offset(_torch_opt(num_bounces=2), sample_offset=0)
    second = r.render_accum_offset(_torch_opt(num_bounces=2), sample_offset=2)
    np.testing.assert_array_equal((first + second).numpy(), whole)
    assert r.last_render_ms > 0.0


def test_render_u8_within_one_level_of_jax(scenes):
    from polaris_tpu.render.integrator import TpuRenderer
    from polaris_tpu.render.options import RenderOptions

    kw = dict(width=32, height=32, spp=2, num_bounces=2, min_bounces_for_rr=3)
    ref = TpuRenderer(scenes["sphere"], mode="packet").render_u8(RenderOptions(**kw))
    r = _torch_renderer(scenes["sphere"])
    got = r.render_u8(_torch_opt(num_bounces=2, min_bounces_for_rr=3))
    assert got.dtype == np.uint8 and got.shape == ref.shape
    diff = np.abs(got.astype(np.int16) - ref.astype(np.int16))
    flipped = int((diff > 1).any(axis=-1).sum())
    assert flipped <= int(MAX_FLIPPED_SHARE * 32 * 32), flipped
    img = r.render(_torch_opt(num_bounces=2, min_bounces_for_rr=3))
    assert img.shape == (32, 32, 3) and 0.0 <= img.min() and img.max() <= 1.0
    assert img.mean() > 0.01


@pytest.mark.parametrize("name", ["sphere", "cornell", "instanced"])
def test_compile_scene_copy_did_not_drift(scenes_dir, name):
    """The port's verbatim copy of the asset pipeline compiles every scene
    to field-by-field identical arrays."""
    from polaris_tpu_torch.asset.compiler.compiler import compile_scene
    from polaris_tpu_torch.asset.wavefront import read_scene

    ours = compile_scene(read_scene(os.path.join(scenes_dir, f"{name}.obj")))
    theirs = _jax_scene(name)
    assert [f.name for f in fields(ours)] == [f.name for f in fields(theirs)]
    for f in fields(theirs):
        a, b = getattr(ours, f.name), getattr(theirs, f.name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype, f.name
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b, f.name


def test_upload_scene_layout(scenes):
    from polaris_tpu_torch.scene import upload_scene

    S = upload_scene(_scene_dict(scenes["cornell"]), "cpu")
    t = scenes["cornell"].tri_v0.shape[0]
    assert S["tri_normals"].shape == (t, 9) and S["tri_uvs"].shape == (t, 6)
    assert S["bvh_ldata"].dtype == torch.int32 and S["tri_v0"].dtype == torch.float32
    assert S["_stx"].tex_fields == frozenset() and S["_stx"].bg_tex is False
    with pytest.raises(KeyError):
        upload_scene({"not_a_field": np.zeros(1)}, "cpu")


@pytest.fixture(scope="module")
def textured():
    """mitsuba and dispersive, compiled once, with the JAX package's 32x32
    accumulators (2 spp, 3 bounces, RR after 3)."""
    from polaris_tpu.render.integrator import TpuRenderer
    from polaris_tpu.render.options import RenderOptions

    out = {}
    for name in ("mitsuba", "dispersive"):
        scene = _jax_scene(name)
        opt = RenderOptions(
            width=32, height=32, spp=2, num_bounces=3, min_bounces_for_rr=3
        )
        ref = np.asarray(TpuRenderer(scene, mode="packet").render_accum(opt))
        out[name] = (scene, ref)
    return out


@pytest.mark.parametrize("name", ["mitsuba", "dispersive"])
def test_textured_scenes_render_like_jax(textured, name):
    """The scenes that used to raise for their textures: the atlas sampler is
    ported, so they upload, say which texture features they hold, and render
    the JAX package's image."""
    scene, ref = textured[name]
    r = _torch_renderer(scene)
    stx = r.S["_stx"]
    if name == "mitsuba":
        assert "reflectance" in stx.tex_fields and r.S["tex_data_u8"].dtype == torch.uint8
    else:
        assert "radiance" in stx.tex_fields and stx.bg_tex
        assert r.S["tex_data"].dtype == torch.float32 and r.S["tex_data_u8"].numel() == 0
    got = r.render_accum(_torch_opt(num_bounces=3, min_bounces_for_rr=3))
    _assert_close_counting_flips(got.numpy(), ref, name, atol=TEXTURED_ATOL)
    assert ref.mean() > 1e-3


def test_slice_as_a_whole_through_havel_herout(textured, monkeypatch):
    """The textured path and the kernel's second triangle test together:
    mitsuba through ``tri_test="hh"`` (the plain version of K1's Havel-Herout
    entry points), chosen by argument and by ``POLARIS_TRI_TEST``."""
    from polaris_tpu_torch.ops import intersect_cuda

    scene, ref = textured["mitsuba"]
    opt = _torch_opt(num_bounces=3, min_bounces_for_rr=3)
    r = _torch_renderer(scene, tri_test="hh")
    assert r.closest.tris_hh.shape == (12 * scene.tri_v0.shape[0],)
    before = dict(intersect_cuda.LAUNCHES)
    got = r.render_accum(opt).numpy()
    assert intersect_cuda.LAUNCHES == before  # the plain version, no launch
    _assert_close_counting_flips(got, ref, "mitsuba/hh", atol=TEXTURED_ATOL)
    monkeypatch.setenv("POLARIS_TRI_TEST", "hh")
    by_env = _torch_renderer(scene)
    assert hasattr(by_env.closest, "tris_hh")
    np.testing.assert_array_equal(by_env.render_accum(opt).numpy(), got)
    monkeypatch.setenv("POLARIS_TRI_TEST", "mt")
    assert not hasattr(_torch_renderer(scene).closest, "tris_hh")
    with pytest.raises(ValueError, match="binary kernel"):
        _torch_renderer(scene, mode="pallas8", tri_test="hh")
    with pytest.raises(ValueError, match="unknown triangle test"):
        _torch_renderer(scene, tri_test="woop")


def test_kernel_mode_on_cpu_raises(scenes):
    from polaris_tpu_torch.ops.intersect import make_intersectors
    from polaris_tpu_torch.scene import upload_scene

    S = upload_scene(_scene_dict(scenes["sphere"]), "cpu")
    with pytest.raises(ValueError, match="CUDA"):
        make_intersectors(S, mode="kernel")
    # the JAX package's name of the same mode
    with pytest.raises(ValueError, match="CUDA"):
        make_intersectors(S, mode="pallas")
    with pytest.raises(ValueError, match="unknown traversal mode"):
        make_intersectors(S, mode="pallas_wide")


def test_default_device_without_cuda_raises(scenes, monkeypatch):
    """device=None means the card: without one the renderer raises, it does
    not carry on on the CPU."""
    from polaris_tpu_torch.render.integrator import TorchRenderer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TorchRenderer(_scene_dict(scenes["sphere"]))


def test_port_imports_neither_jax_nor_the_jax_package():
    """Run in a fresh interpreter: every module of the port and chip_smoke."""
    code = (
        "import sys, pkgutil, importlib\n"
        f"sys.path.insert(0, {REPO!r})\n"
        "import polaris_tpu_torch, chip_smoke\n"
        "for m in pkgutil.walk_packages(polaris_tpu_torch.__path__, 'polaris_tpu_torch.'):\n"
        "    if not m.name.rsplit('.', 1)[-1].startswith('_lib'):  # ctypes libraries\n"
        "        importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'jaxlib' or m == 'polaris_tpu' or m.startswith('polaris_tpu.')]\n"
        "assert not bad, bad\n"
        "assert 'polaris_tpu_torch.render.integrator' in sys.modules\n"
        "print('clean')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, env=env,
        timeout=300, cwd=REPO,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    assert "clean" in out.stdout


def test_chip_smoke_fails_without_a_gpu():
    """No CUDA device: non-zero exit code and no result line."""
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "chip_smoke.py")],
        capture_output=True, text=True, timeout=300, cwd=REPO,
    )
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_golden_fixture_is_current():
    _assert_fixture_is_current("sphere")


def test_mitsuba_golden_fixture_is_current():
    _assert_fixture_is_current("mitsuba")


def _assert_fixture_is_current(name):
    """The committed fixture still equals what the JAX package renders."""
    fx = np.load(FIXTURES[name])
    for k, v in GOLDEN_OPT.items():
        assert int(fx[k]) == v, k
    # tight, not bitwise: XLA's CPU code generation follows the host's vector
    # units, so the last bit may move between machines
    bad = ~np.isclose(fx["accum"], _golden_accum(name), atol=1e-6, rtol=1e-5)
    assert int(bad.any(axis=-1).sum()) <= int(MAX_FLIPPED_SHARE * 32 * 32)


def test_torch_cpu_matches_golden_fixture(scenes):
    """The check chip_smoke makes on the card, made here on the CPU path."""
    _assert_matches_sphere_fixture(scenes, "mt")


def test_torch_cpu_matches_golden_fixture_through_havel_herout(scenes):
    _assert_matches_sphere_fixture(scenes, "hh")


def _assert_matches_sphere_fixture(scenes, tri_test):
    fx = np.load(FIXTURE)
    got = _torch_renderer(scenes["sphere"], tri_test=tri_test).render_accum(
        _torch_opt(**{k: v for k, v in GOLDEN_OPT.items()})
    )
    _assert_close_counting_flips(got.numpy(), fx["accum"], f"golden/{tri_test}")


def test_torch_cpu_matches_mitsuba_golden_fixture(textured):
    fx = np.load(FIXTURES["mitsuba"])
    got = _torch_renderer(textured["mitsuba"][0]).render_accum(
        _torch_opt(**{k: v for k, v in GOLDEN_OPT.items()})
    )
    _assert_close_counting_flips(got.numpy(), fx["accum"], "golden/mitsuba")


def _write_fixture():
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    for name, path in FIXTURES.items():
        accum = _golden_accum(name)
        np.savez_compressed(
            path, accum=accum, **{k: np.int64(v) for k, v in GOLDEN_OPT.items()}
        )
        print(f"wrote {path}: accum {accum.shape} mean {accum.mean():.6f}")


if __name__ == "__main__":
    if sys.argv[1:] == ["--write-fixture"]:
        sys.path.insert(0, REPO)
        _write_fixture()
    else:
        sys.exit("usage: python tests/test_torch_render.py --write-fixture")
