"""Three faults of the port against the JAX package, repaired, on the CPU.

1. ``POLARIS_TRI_TEST`` reaches only K1: in the JAX package the variable is
   read by K1's packer alone (``polaris_tpu/ops/intersect_pallas.py``), so
   every mode builds with it set to ``hh`` and only the modes that run K1
   (``auto`` and ``pallas_stream`` here, the primary rays of ``hybrid``)
   take the Havel-Herout test. An explicit ``tri_test="hh"`` with a mode
   that has no such test still raises.
2. The JAX package's mode names: ``pallas`` is the port's ``kernel``;
   ``packet`` and ``brute``, its XLA traversals, which the port once refused
   naming a substitute, build intersectors whose hits equal ``bvh``'s.
3. Every file the port copies verbatim from the JAX package is byte for
   byte the original: ``asset/**``, ``native/__init__.py``, the native
   sources, ``types.py``, ``utils/log.py``, ``render/options.py``, and
   the NumPy oracle's plain copies: ``cpu_ref/__init__.py``,
   ``cpu_ref/shading_ref.py`` and the formula modules under
   ``cpu_ref/xp/``, which mirror the JAX tree (``cpu_ref/xp/ops/vec.py``
   is ``ops/vec.py``). ``tests/test_torch_cpu_ref.py`` holds the two
   copies that differ (``rng.py``, ``renderer.py``).
4. ``mode="bvh"`` renders a scene whose BVH is one TLAS leaf over one BLAS
   leaf: the plain binary traversal fetched a leaf's child boxes at its
   data words, and a BLAS leaf's triangle count (6) passed the last of the
   2 nodes. The fetch clamps into the node array, as XLA's gather does.
5. A renderer on a card refused 'packet' (and 'bvh'), whose loops read back
   to the host. Their steps now run uncaptured on the card.
6. The port kept two copies of the oracle's BLAS walk; 'brute' and K5's
   packer now read the oracle's own, with the same ranges as before.
"""

import os
import re
from dataclasses import fields
from types import SimpleNamespace

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from polaris_tpu_torch.asset.compiler.compiler import compile_scene  # noqa: E402
from polaris_tpu_torch.asset.wavefront import read_scene  # noqa: E402
from polaris_tpu_torch.ops import intersect as tix  # noqa: E402
from polaris_tpu_torch.scene import upload_scene  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_PKG = os.path.join(REPO, "polaris_tpu")
PORT_PKG = os.path.join(REPO, "polaris_tpu_torch")
FLT_MAX = float(np.finfo(np.float32).max)

# every mode that builds on a CPU scene ('kernel' and its alias 'pallas'
# need a card)
CPU_MODES = (
    "auto", "pallas_stream", "hybrid", "bvh", "pallas_nodes", "pallas8",
    "pallas8_nodes", "pallas_dense", "packet", "brute",
)
# of those, the modes whose closest hit runs K1 (its plain version here)
RUNS_K1 = ("auto", "pallas_stream", "hybrid")


def _asset_files(root):
    out = []
    for d, dirs, files in os.walk(os.path.join(root, "asset")):
        dirs[:] = sorted(x for x in dirs if x != "__pycache__")
        out += [os.path.relpath(os.path.join(d, f), root) for f in files if not f.endswith(".pyc")]
    return sorted(out)


# the NumPy oracle's copies of the JAX package's formula modules, in the
# JAX package's own layout under this directory of the port
XP = "cpu_ref/xp/"

VERBATIM = _asset_files(JAX_PKG) + [
    "native/__init__.py", "native/bvh_builder.cpp", "native/exr_piz.cpp",
    "types.py", "utils/log.py", "render/options.py",
    "cpu_ref/__init__.py", "cpu_ref/shading_ref.py",
] + [XP + f for f in (
    "ops/__init__.py", "ops/vec.py", "ops/bxdf.py", "ops/emissive.py", "ops/material.py",
    "ops/texture.py", "render/__init__.py", "render/shade.py", "render/raygen.py",
)]


def original(path):
    """The JAX package's file that the port's ``path`` copies."""
    return path[len(XP):] if path.startswith(XP) else path


@pytest.fixture(scope="module")
def cornell(scenes_dir):
    scene = compile_scene(read_scene(os.path.join(scenes_dir, "cornell.obj")))
    return upload_scene({f.name: getattr(scene, f.name) for f in fields(scene)}, "cpu")


def _rays(S, n=96):
    g = np.random.default_rng(5)
    lo = S["bvh_min"][0].numpy()
    hi = S["bvh_max"][0].numpy()
    o = (lo + g.uniform(0.1, 0.9, (n, 3)) * (hi - lo)).astype(np.float32)
    d = g.normal(size=(n, 3)).astype(np.float32)
    return (torch.from_numpy(o), torch.from_numpy(d), torch.full((n,), FLT_MAX),
            torch.ones(n, dtype=torch.bool))


def _leaf(closest):
    """K1's leaf form where the closest hit runs K1, else None."""
    P = getattr(closest, "packed", {})
    return P.get("leaf") if "k1_words" in P else None


@pytest.mark.parametrize("mode", CPU_MODES)
def test_env_hh_reaches_only_the_modes_that_run_k1(cornell, monkeypatch, mode):
    S = cornell
    monkeypatch.setenv("POLARIS_TRI_TEST", "mt")
    closest_mt, any_mt = tix.make_intersectors(S, mode)
    monkeypatch.setenv("POLARIS_TRI_TEST", "hh")
    closest, any_hit = tix.make_intersectors(S, mode)
    assert _leaf(closest) == ("hh" if mode in RUNS_K1 else None)
    assert _leaf(closest_mt) == ("det2" if mode in RUNS_K1 else None)
    rays = _rays(S)
    hit = closest(S, *rays)
    assert hit.mask.any()
    if mode not in RUNS_K1:  # the variable is ignored: the same hits
        ref = closest_mt(S, *rays)
        for f in tix.Hit._fields:
            assert torch.equal(getattr(hit, f), getattr(ref, f)), f
    assert torch.equal(any_hit(S, *rays), any_mt(S, *rays))


@pytest.mark.parametrize("how", ["env", "argument"])
def test_hybrid_runs_hh_on_its_primary_rays(cornell, monkeypatch, how):
    S = cornell
    if how == "env":
        monkeypatch.setenv("POLARIS_TRI_TEST", "hh")
        closest, any_hit = tix.make_intersectors(S, "hybrid")
    else:
        monkeypatch.delenv("POLARIS_TRI_TEST", raising=False)
        closest, any_hit = tix.make_intersectors(S, "hybrid", tri_test="hh")
    assert _leaf(closest) == "hh"
    assert closest.tris_hh.shape == (12 * S["tri_v0"].shape[0],)
    # bounce and shadow rays: the dense kernel, which has one test only
    assert "k5_words" in closest.closest_bounce.packed
    rays = _rays(S)
    ref = tix.intersect_bvh(S, *rays, any_hit=False, leaf="hh", tris_hh=closest.tris_hh)
    hit = closest(S, *rays)
    for f in tix.Hit._fields:
        assert torch.equal(getattr(hit, f), getattr(ref, f)), f


@pytest.mark.parametrize("mode", [m for m in CPU_MODES if m not in RUNS_K1])
def test_explicit_hh_raises_where_k1_does_not_run(cornell, monkeypatch, mode):
    monkeypatch.delenv("POLARIS_TRI_TEST", raising=False)
    with pytest.raises(ValueError, match="binary kernel"):
        tix.make_intersectors(cornell, mode, tri_test="hh")


@pytest.mark.parametrize("mode", ["kernel", "pallas"])
def test_pallas_is_kernel(cornell, monkeypatch, mode):
    """The JAX package's 'pallas' (its CLI's ``--mode``, ``parallel/
    multihost.py``) is the port's 'kernel': on a CPU scene both refuse with
    the same message, on a card both give K1's wrappers."""
    from polaris_tpu_torch.ops import intersect_cuda

    assert mode in tix.MODES
    with pytest.raises(ValueError, match="mode='kernel' needs the scene on a CUDA device"):
        tix.make_intersectors(cornell, mode)
    calls = []
    monkeypatch.setattr(intersect_cuda, "intersectors", lambda S, t: calls.append(t) or "K1")
    card = dict(cornell, bvh_ldata=SimpleNamespace(device=torch.device("cuda")))
    assert tix.make_intersectors(card, mode, tri_test="hh") == "K1"
    assert calls == ["hh"]


@pytest.mark.parametrize("mode", ["packet", "brute"])
def test_xla_modes_raise_naming_the_substitute(cornell, mode):
    """The JAX package's XLA traversals, which this test once found refused
    with the port's substitute named, now build; on cornell's rays their
    hits equal the quotient-form ``bvh``'s field for field (``packet`` and
    ``brute`` run the same triangle test; cornell has no exact tie on these
    rays). An unknown mode still raises and lists the modes."""
    assert mode in tix.MODES
    rays = _rays(cornell)
    closest, any_hit = tix.make_intersectors(cornell, mode)
    ref_closest, ref_any = tix.make_intersectors(cornell, "bvh")
    hit, ref = closest(cornell, *rays), ref_closest(cornell, *rays)
    assert hit.mask.any()
    for f in tix.Hit._fields:
        assert torch.equal(getattr(hit, f), getattr(ref, f)), f
    assert torch.equal(any_hit(cornell, *rays), ref_any(cornell, *rays))
    with pytest.raises(ValueError, match=re.escape("| hybrid | packet | brute)")):
        tix.make_intersectors(cornell, "pallas_wide")


@pytest.mark.parametrize("path", VERBATIM)
def test_verbatim_copy_is_the_original_byte_for_byte(path):
    with open(os.path.join(JAX_PKG, original(path)), "rb") as a, \
            open(os.path.join(PORT_PKG, path), "rb") as b:
        assert a.read() == b.read(), path


def test_verbatim_asset_tree_has_the_same_files():
    assert _asset_files(PORT_PKG) == _asset_files(JAX_PKG)


def test_bvh_mode_renders_a_single_leaf_mesh(textured_scene):
    """``tests/conftest.py``'s textured scene through the port's
    ``mode="bvh"`` against ``TpuRenderer(mode="bvh")`` at
    ``tests/test_parity.py::_compare``'s tolerance (textured: atol 2e-4,
    rtol 1e-3), and every other CPU mode against it at the same tolerance
    (``pallas8`` shares the quotient leaf test, so it is equal bit for
    bit)."""
    from polaris_tpu.render.integrator import TpuRenderer
    from polaris_tpu.render.options import RenderOptions as JaxOptions
    from polaris_tpu_torch.render.integrator import TorchRenderer
    from polaris_tpu_torch.render.options import RenderOptions

    frame = dict(width=16, height=16, spp=2, num_bounces=2, min_bounces_for_rr=3)
    scene = {f.name: getattr(textured_scene, f.name) for f in fields(textured_scene)}
    assert scene["bvh_ldata"].shape[0] < scene["tri_v0"].shape[0]
    got = TorchRenderer(scene, device="cpu", mode="bvh").render_accum(RenderOptions(**frame))
    want = np.asarray(TpuRenderer(textured_scene, mode="bvh").render_accum(JaxOptions(**frame)))
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want, atol=2e-4, rtol=1e-3)
    for mode in CPU_MODES:
        other = TorchRenderer(scene, device="cpu", mode=mode).render_accum(RenderOptions(**frame))
        if mode == "pallas8":
            assert torch.equal(other, got), mode
        np.testing.assert_allclose(other.numpy(), got.numpy(), atol=2e-4, rtol=1e-3, err_msg=mode)


def test_packet_mode_refuses_a_card(scenes_dir, monkeypatch):
    """The fault this test once pinned, repaired: a renderer on a card
    refused 'packet', whose traversal reads its loop test back to the host,
    as 'bvh' does. Now it builds, and its steps run uncaptured: with CUDA's
    calls stood in for (``test_torch_compiled.on_a_faked_card``), a frame
    and a loss-and-gradient step of ``DifferentiableRenderer`` enter no
    ``torch.cuda.graph`` and switch no stream, and equal the CPU's bit for
    bit. A kernel mode on the same stand-ins still captures."""
    from test_torch_compiled import on_a_faked_card

    from polaris_tpu_torch.render.grad import DifferentiableRenderer
    from polaris_tpu_torch.render.integrator import TorchRenderer
    from polaris_tpu_torch.render.options import RenderOptions

    scene = compile_scene(read_scene(os.path.join(scenes_dir, "cornell.obj")))
    opt = RenderOptions(width=16, height=16, spp=1, num_bounces=2, min_bounces_for_rr=2)
    target = torch.zeros((16, 16, 3))
    want = TorchRenderer(scene, device="cpu", mode="packet", regen=True).render_accum(opt)
    want_loss, want_grads, _ = DifferentiableRenderer(
        scene, device="cpu", mode="packet").loss_and_grad(opt, target)

    r, events = on_a_faked_card(monkeypatch, scene, "packet", regen=True)
    assert r.reads_back
    assert torch.equal(r.render_accum(opt), want)
    d, events_d = on_a_faked_card(monkeypatch, scene, "packet", cls=DifferentiableRenderer)
    loss, grads, _ = d.loss_and_grad(opt, target)
    assert events == events_d == []
    assert loss == want_loss
    for k, g in grads.items():
        assert torch.equal(g, want_grads[k]), k
    monkeypatch.undo()
    r, events = on_a_faked_card(monkeypatch, scene, "pallas8")
    assert not r.reads_back
    r.render_accum(opt)
    assert events[:2] == ["stream", "capture"], events
