"""The port's NumPy oracle (``polaris_tpu_torch/cpu_ref/``) against the JAX
package's, on the CPU.

* The copies: ``cpu_ref/xp/ops/rng.py`` is the JAX ``ops/rng.py`` without
  its three ``jnp_*`` functions; ``cpu_ref/renderer.py`` is the JAX
  ``cpu_ref/renderer.py`` but for its import lines, which point the formula
  modules at the copies under ``cpu_ref/xp/``; ``cpu_ref/xp/ops/statics.py``
  re-exports the port's predicates, which are the JAX ones line for line.
  (The plain copies are byte-compared in ``tests/test_torch_port_faults.py``.)
* Importing the oracle pulls in neither JAX nor torch, and no module of the
  port imports JAX or the JAX package.
* ``CpuRenderer.render_accum`` equals the JAX oracle's bit for bit, with
  and without its decision-stability probing.
* ``TorchRenderer(device="cpu")`` through 'bvh' and 'brute' holds against
  the port's oracle at ``tests/test_parity.py::_compare``'s tolerance, on
  its six configurations.
* 'brute' and K5's packer take each instance's triangle range from the
  oracle's BLAS walk: the same ranges as the JAX package's, on every scene.
"""

import os
import re
import subprocess
import sys
from dataclasses import fields

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from polaris_tpu_torch.asset.compiler.compiler import compile_scene  # noqa: E402
from polaris_tpu_torch.asset.scene_data import SceneData  # noqa: E402
from polaris_tpu_torch.asset.wavefront import read_scene  # noqa: E402
from polaris_tpu_torch.cpu_ref.renderer import CpuRenderer  # noqa: E402
from polaris_tpu_torch.render.options import RenderOptions  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_PKG = os.path.join(REPO, "polaris_tpu")
PORT_PKG = os.path.join(REPO, "polaris_tpu_torch")
SCENES = ("cornell", "sphere", "mitsuba", "instanced", "dispersive")

# tests/test_parity.py's configurations and tolerances
PARITY = {
    "cornell": ("cornell", dict(width=48, height=48, spp=2, num_bounces=3, min_bounces_for_rr=4),
                1e-4),
    "cornell_rr": ("cornell", dict(width=32, height=32, spp=2, num_bounces=4,
                                   min_bounces_for_rr=2), 1e-4),
    "sphere": ("sphere", dict(width=32, height=32, spp=2, num_bounces=2, min_bounces_for_rr=3),
               1e-4),
    "mitsuba": ("mitsuba", dict(width=24, height=24, spp=2, num_bounces=3, min_bounces_for_rr=4),
                2e-4),
    "instanced": ("instanced", dict(width=24, height=24, spp=2, num_bounces=2,
                                    min_bounces_for_rr=3), 1e-4),
    "dispersive": ("dispersive", dict(width=24, height=24, spp=2, num_bounces=3,
                                      min_bounces_for_rr=4), 2e-4),
}
ORACLE_FRAME = dict(width=32, height=32, spp=2, num_bounces=3)


def _read(root, path):
    with open(os.path.join(root, path)) as f:
        return f.read()


@pytest.fixture(scope="module")
def jax_scenes():
    from polaris_tpu.asset.compiler.compiler import compile_scene as jax_compile
    from polaris_tpu.asset.wavefront import read_scene as jax_read

    return {n: jax_compile(jax_read(os.path.join(REPO, "scenes", f"{n}.obj"))) for n in SCENES}


@pytest.fixture(scope="module")
def port_scenes():
    return {n: compile_scene(read_scene(os.path.join(REPO, "scenes", f"{n}.obj")))
            for n in SCENES}


@pytest.fixture(scope="module")
def jax_oracle(jax_scenes):
    """The JAX oracle's accumulators (and unstable-lane maps), once each."""
    from polaris_tpu.cpu_ref.renderer import CpuRenderer as JaxCpuRenderer
    from polaris_tpu.render.options import RenderOptions as JaxOptions

    cache = {}

    def get(name, stability):
        if (name, stability) not in cache:
            r = JaxCpuRenderer(jax_scenes[name])
            acc = r.render_accum(JaxOptions(**ORACLE_FRAME), stability=stability)
            cache[name, stability] = acc, getattr(r, "last_unstable", None)
        return cache[name, stability]

    return get


def test_rng_copy_is_the_original_without_its_jnp_functions():
    """The three functions that import ``jax.numpy`` in their bodies go;
    every other line stays."""
    original = _read(JAX_PKG, "ops/rng.py")
    start = original.index("def jnp_hash_u32(")
    end = original.index("def make_uniform(")
    assert all(f"def {f}(" in original[start:end]
               for f in ("jnp_hash_u32", "jnp_combine", "jnp_uniform"))
    assert _read(PORT_PKG, "cpu_ref/xp/ops/rng.py") == original[:start] + original[end:]


def test_renderer_copy_differs_only_in_its_imports():
    """Line for line the JAX oracle, but for the lines that import the
    formula modules, which now name their copies under ``cpu_ref/xp/``."""
    want = {
        "from ..ops import rng": "from .xp.ops import rng",
        "from ..ops import vec as V": "from .xp.ops import vec as V",
        "from ..render.raygen import gen_rays": "from .xp.render.raygen import gen_rays",
        "from ..render.shade import shade, shade_miss, tonemap_reinhard":
            "from .xp.render.shade import shade, shade_miss, tonemap_reinhard",
        "        from ..ops.material import material_tree_depth":
            "        from .xp.ops.material import material_tree_depth",
    }
    a = _read(JAX_PKG, "cpu_ref/renderer.py").splitlines()
    b = _read(PORT_PKG, "cpu_ref/renderer.py").splitlines()
    assert len(a) == len(b)
    changed = {x: y for x, y in zip(a, b) if x != y}
    assert changed == want


def test_statics_are_the_jax_predicates():
    """The formula copies reach ``ops/statics.py`` for five predicates. The
    JAX file registers a pytree, so the mirror re-exports the port's
    NumPy-only ones, whose source is the JAX source line for line."""
    import inspect

    import polaris_tpu.ops.statics as jax_statics
    from polaris_tpu_torch.cpu_ref.xp.ops import statics as mirror
    from polaris_tpu_torch.ops import statics as port

    for name in ("tex_on", "has_bxdf", "has_op", "has_light", "bg_has_tex"):
        assert getattr(mirror, name) is getattr(port, name)
        assert inspect.getsource(getattr(port, name)) == inspect.getsource(
            getattr(jax_statics, name)), name


def test_oracle_imports_neither_jax_nor_torch():
    """In a fresh interpreter: the oracle and the package's lazy name bring
    in no JAX, no JAX package and no torch (so none of the port's
    traversals)."""
    code = (
        "import sys\n"
        "import polaris_tpu_torch.cpu_ref.renderer\n"
        "from polaris_tpu_torch import CpuRenderer\n"
        "assert CpuRenderer is polaris_tpu_torch.cpu_ref.renderer.CpuRenderer\n"
        "bad = [m for m in sys.modules\n"
        "       if m.split('.')[0] in ('jax', 'jaxlib', 'polaris_tpu', 'torch')]\n"
        "assert not bad, bad\n"
    )
    run = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert run.returncode == 0, run.stderr[-2000:]


def test_no_module_of_the_port_imports_jax():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|polaris_tpu)\b", re.M)
    for d, dirs, files in os.walk(PORT_PKG):
        dirs[:] = [x for x in dirs if x != "__pycache__"]
        for f in files:
            if f.endswith(".py"):
                text = _read(d, f)
                assert not pattern.search(text) and "import jax" not in text, \
                    os.path.join(d, f)


@pytest.mark.parametrize("name", ["cornell", "sphere"])
def test_oracle_equals_jax_bit_for_bit(jax_scenes, jax_oracle, name):
    scene = SceneData(**{f.name: getattr(jax_scenes[name], f.name)
                         for f in fields(jax_scenes[name])})
    got = CpuRenderer(scene).render_accum(RenderOptions(**ORACLE_FRAME))
    want, _ = jax_oracle(name, False)
    assert got.dtype == want.dtype == np.float32
    assert np.array_equal(got, want)


def test_oracle_stability_equals_jax(jax_scenes, jax_oracle):
    """The decision-stability probing too: the same accumulator and the
    same unstable lanes."""
    scene = SceneData(**{f.name: getattr(jax_scenes["cornell"], f.name)
                         for f in fields(jax_scenes["cornell"])})
    r = CpuRenderer(scene)
    got = r.render_accum(RenderOptions(**ORACLE_FRAME), stability=True)
    want, unstable = jax_oracle("cornell", True)
    assert np.array_equal(got, want)
    assert np.array_equal(r.last_unstable, unstable)


@pytest.fixture(scope="module")
def port_oracle(port_scenes):
    cache = {}

    def get(config):
        if config not in cache:
            name, frame, _ = PARITY[config]
            cache[config] = CpuRenderer(port_scenes[name]).render_accum(RenderOptions(**frame))
        return cache[config]

    return get


@pytest.mark.parametrize("mode", ["bvh", "brute"])
@pytest.mark.parametrize("config", list(PARITY))
def test_torch_renderer_holds_against_the_oracle(port_scenes, port_oracle, config, mode):
    from polaris_tpu_torch.render.integrator import TorchRenderer

    name, frame, atol = PARITY[config]
    golden = port_oracle(config)
    assert np.isfinite(golden).all() and golden.mean() > 1e-3
    got = TorchRenderer(port_scenes[name], device="cpu", mode=mode).render_accum(
        RenderOptions(**frame)).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, golden, atol=atol, rtol=1e-3, err_msg=f"{config}/{mode}")


@pytest.mark.parametrize("name", SCENES)
def test_brute_and_dense_ranges_are_the_jax_ones(jax_scenes, name):
    """Each instance's (first triangle, count) as the JAX package's BLAS
    walk gives it: through ``instance_tri_ranges`` ('brute') and through
    K5's packer, whose arrays equal the JAX packer's where the scene fits
    K5 (at most ``DENSE_MAX_TRIS`` triangles; past that it still raises)."""
    from polaris_tpu.cpu_ref.renderer import _collect_blas_triangles
    from polaris_tpu.ops.intersect_pallas_dense import pack_scene_dense as jax_pack_dense
    from polaris_tpu_torch.ops import intersect as tix
    from polaris_tpu_torch.ops import intersect_dense
    from polaris_tpu_torch.scene import upload_scene

    js = jax_scenes[name]
    want = []
    for root in js.inst_bvh_root:
        tris = _collect_blas_triangles(js, int(root))
        want.append((int(tris.min()), int(tris.size)))
    S = upload_scene({f.name: getattr(js, f.name) for f in fields(js)}, "cpu")
    host = tix.host_geometry(S)
    assert tix.instance_tri_ranges(host) == tuple(want)
    tix.make_intersectors(S, "brute")
    if js.tri_v0.shape[0] > intersect_dense.DENSE_MAX_TRIS:
        with pytest.raises(ValueError, match="dense intersection takes at most"):
            intersect_dense.pack_scene_dense(host)
        return
    got, ref = intersect_dense.pack_scene_dense(host), jax_pack_dense(js)
    assert np.asarray(got["pk_ranges"]).reshape(-1, 2).tolist() == [list(w) for w in want]
    for k in ("pk_ranges", "pk_tris", "pk_w2o"):
        assert np.array_equal(got[k], ref[k]), k
