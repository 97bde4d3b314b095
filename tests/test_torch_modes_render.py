"""The port's traversal modes through the whole renderer, on the CPU, and
the edges of the mode switch.

``TorchRenderer(device="cpu", mode=m)`` runs each mode's plain PyTorch
version (the CUDA kernels run only on a card; ``chip_smoke.py`` drives them
there). For each new mode the 24x24, 1 spp, 2-bounce accumulator is held
against ``TpuRenderer(mode="bvh")`` within ``atol=1e-4, rtol=1e-3`` (the gate
of tests/test_parity.py; a lane whose decision flips on an ulp is counted, at
most 0.5% of the frame, as in tests/test_torch_render.py). Among themselves
the port's modes are held as far as they share a leaf arithmetic
(``SAME_IMAGE_AS``): the modes of the det²-scaled kernels (K1
``pallas_stream``, K2 ``pallas8_nodes``, K3 ``pallas_nodes``, K5
``pallas_dense``, ``hybrid`` = K1 + K5) must EQUAL the image of K1's plain
version, which is what ``mode="auto"`` renders on a CPU scene; ``pallas8``
(K4, quotient form) must EQUAL the port's own ``mode="bvh"`` image. Across
the two arithmetics a hit moves by an ulp, so those pairs are held by the
tolerance above only. The big-scene modes (K2, K3) render the procedural
terrain at grid 32; ``pallas8``, ``pallas_dense`` and ``hybrid`` render
cornell.
"""

import logging
import os
from dataclasses import fields

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from polaris_tpu_torch.ops import (  # noqa: E402
    intersect as tix,
    intersect_cuda,
    intersect_dense,
    intersect_nodes,
    intersect_wide8,
    intersect_wide8_nodes,
)
from polaris_tpu_torch.render.integrator import TorchRenderer  # noqa: E402
from polaris_tpu_torch.render.options import RenderOptions  # noqa: E402
from polaris_tpu_torch.scene import upload_scene  # noqa: E402

FLT_MAX = float(np.finfo(np.float32).max)
ATOL, RTOL = 1e-4, 1e-3
MAX_FLIPPED_SHARE = 0.005
OPT = dict(width=24, height=24, spp=1, num_bounces=2, min_bounces_for_rr=3)

# mode -> the scene it renders here
RENDER_MODES = {
    "pallas8_nodes": "terrain32",
    "pallas_nodes": "terrain32",
    "pallas_stream": "terrain32",
    "pallas8": "cornell",
    "pallas_dense": "cornell",
    "hybrid": "cornell",
}
# mode -> the mode of the port whose image it must equal bit for bit
SAME_IMAGE_AS = {
    "pallas8_nodes": "auto",
    "pallas_nodes": "auto",
    "pallas_stream": "auto",
    "pallas8": "bvh",
    "pallas_dense": "auto",
    "hybrid": "auto",
}
PACKED_MODES = {
    "pallas8_nodes": intersect_wide8_nodes,
    "pallas_nodes": intersect_nodes,
    "pallas8": intersect_wide8,
    "pallas_dense": intersect_dense,
}


def _scene_dict(scene):
    return {f.name: getattr(scene, f.name) for f in fields(scene)}


@pytest.fixture(scope="module")
def scenes(scenes_dir):
    from polaris_tpu.asset.compiler.compiler import compile_scene
    from polaris_tpu.asset.procedural import make_terrain_scene
    from polaris_tpu.asset.wavefront import read_scene

    return {
        "cornell": compile_scene(read_scene(os.path.join(scenes_dir, "cornell.obj"))),
        "terrain32": compile_scene(make_terrain_scene(grid=32)),
        "terrain64": compile_scene(make_terrain_scene(grid=64)),
    }


@pytest.fixture(scope="module")
def references(scenes):
    """Per scene: the JAX package's ``mode="bvh"`` accumulator, and the
    port's through ``mode="bvh"`` (quotient form) and ``mode="auto"`` (K1's
    plain version, det²-scaled)."""
    from polaris_tpu.render.integrator import TpuRenderer
    from polaris_tpu.render.options import RenderOptions as JaxOptions

    out = {}
    for name in ("cornell", "terrain32"):
        jax_accum = np.asarray(
            TpuRenderer(scenes[name], mode="bvh").render_accum(JaxOptions(**OPT))
        )
        port = {
            mode: TorchRenderer(
                _scene_dict(scenes[name]), device="cpu", mode=mode, tri_test="mt"
            ).render_accum(RenderOptions(**OPT)).numpy()
            for mode in ("bvh", "auto")
        }
        out[name] = (jax_accum, port)
    return out


@pytest.mark.parametrize("mode", sorted(RENDER_MODES))
def test_mode_renders_the_reference_image(scenes, references, mode):
    name = RENDER_MODES[mode]
    jax_accum, port = references[name]
    r = TorchRenderer(_scene_dict(scenes[name]), device="cpu", mode=mode)
    got = r.render_accum(RenderOptions(**OPT)).numpy()
    assert got.shape == (24, 24, 3) and np.isfinite(got).all()
    assert jax_accum.mean() > 1e-3  # the frame holds light
    bad = (~np.isclose(got, jax_accum, atol=ATOL, rtol=RTOL)).any(axis=-1)
    print(f"{mode}/{name}: {int(bad.sum())} of {bad.size} pixels outside tolerance")
    assert int(bad.sum()) <= int(MAX_FLIPPED_SHARE * bad.size)
    np.testing.assert_array_equal(got, port[SAME_IMAGE_AS[mode]])
    # the other arithmetic: by tolerance, counting the lanes that flip
    other = port["bvh" if SAME_IMAGE_AS[mode] == "auto" else "auto"]
    far = (~np.isclose(got, other, atol=ATOL, rtol=RTOL)).any(axis=-1)
    assert int(far.sum()) <= int(MAX_FLIPPED_SHARE * far.size)
    assert (r.closest_bounce is not None) == (mode == "hybrid")


def test_hybrid_peels_the_bounces_onto_the_dense_kernel(scenes):
    """Primary rays go to ``closest``, every later bounce to
    ``closest.closest_bounce``, shadow rays to the dense any-hit."""
    r = TorchRenderer(_scene_dict(scenes["cornell"]), device="cpu", mode="hybrid")
    calls = {"primary": 0, "bounce": 0, "shadow": 0}

    def counting(key, fn):
        def run(*a):
            calls[key] += 1
            return fn(*a)

        return run

    r.closest = counting("primary", r.closest)
    r.closest_bounce = counting("bounce", r.closest_bounce)
    r.any_hit = counting("shadow", r.any_hit)
    r.render_accum(RenderOptions(**{**OPT, "spp": 2, "num_bounces": 3}))
    assert calls == {"primary": 2, "bounce": 4, "shadow": 6}


def test_hybrid_with_regen_warns_and_takes_the_sequential_loop(scenes):
    class Catch(logging.Handler):
        def __init__(self):
            super().__init__()
            self.records = []

        def emit(self, record):
            self.records.append(record.getMessage())

    catch = Catch()
    log = logging.getLogger("polaris.integrator")
    log.addHandler(catch)
    try:
        r = TorchRenderer(
            _scene_dict(scenes["cornell"]), device="cpu", mode="hybrid", regen=True
        )
    finally:
        log.removeHandler(catch)
    assert r.regen is False
    assert any("sequential sample loop" in m for m in catch.records)
    plain = TorchRenderer(_scene_dict(scenes["cornell"]), device="cpu", mode="hybrid")
    opt = RenderOptions(**OPT)
    np.testing.assert_array_equal(
        r.render_accum(opt).numpy(), plain.render_accum(opt).numpy()
    )
    # a mode without a peeled bounce kernel keeps regeneration
    assert TorchRenderer(
        _scene_dict(scenes["cornell"]), device="cpu", mode="pallas8", regen=True
    ).regen is True


@pytest.mark.parametrize("mode", sorted(PACKED_MODES))
def test_all_inactive_and_empty_batches(scenes, mode):
    name = RENDER_MODES[mode]
    S = upload_scene(_scene_dict(scenes[name]), "cpu")
    closest, any_hit = tix.make_intersectors(S, mode)
    r = np.random.default_rng(3)
    o = torch.from_numpy(r.uniform(-1, 1, (257, 3)).astype(np.float32))
    d = torch.from_numpy(r.normal(size=(257, 3)).astype(np.float32))
    maxt = torch.full((257,), FLT_MAX)
    dead = torch.zeros(257, dtype=torch.bool)
    hit = closest(S, o, d, maxt, dead)
    assert not hit.mask.any() and (hit.t == 0).all()
    assert not any_hit(S, o, d, maxt, dead).any()
    none = closest(S, o[:0], d[:0], maxt[:0], dead[:0])
    assert none.mask.shape == (0,) and none.t.shape == (0,)
    assert any_hit(S, o[:0], d[:0], maxt[:0], dead[:0]).shape == (0,)


@pytest.mark.parametrize("mode", sorted(PACKED_MODES))
def test_mode_with_a_kernel_takes_the_plain_version_on_a_cpu_scene(scenes, mode):
    """No card: the wrappers run the plain version, count no launch, and the
    packed arrays live on the scene's device."""
    module = PACKED_MODES[mode]
    name = RENDER_MODES[mode]
    S = upload_scene(_scene_dict(scenes[name]), "cpu")
    closest, any_hit = tix.make_intersectors(S, mode)
    assert all(
        v.device.type == "cpu" for v in closest.packed.values() if torch.is_tensor(v)
    )
    r = np.random.default_rng(4)
    lo, hi = scenes[name].bvh_min[0], scenes[name].bvh_max[0]
    o = torch.from_numpy((lo + r.uniform(0.1, 0.9, (300, 3)) * (hi - lo)).astype(np.float32))
    d = torch.from_numpy(r.normal(size=(300, 3)).astype(np.float32))
    maxt = torch.full((300,), FLT_MAX)
    active = torch.ones(300, dtype=torch.bool)
    before = dict(module.LAUNCHES)
    hit = closest(S, o, d, maxt, active)
    occluded = any_hit(S, o, d, maxt, active)
    assert module.LAUNCHES == before
    assert hit.mask.any()
    assert torch.equal(occluded, hit.mask)  # same EPS < t < maxt window
    module.reset_launches()
    assert module.LAUNCHES == {"closest_hit": 0, "any_hit": 0}


def test_mode_switch_edges(scenes, monkeypatch):
    S = upload_scene(_scene_dict(scenes["cornell"]), "cpu")
    # 'auto' gives the binary kernel at every size: on a CPU scene its plain
    # version, never a packed mode
    assert "k1_words" in tix.make_intersectors(S, mode="auto", tri_test="mt")[0].packed
    with pytest.raises(ValueError, match="CUDA"):
        tix.make_intersectors(S, mode="kernel")
    with pytest.raises(ValueError, match="unknown traversal mode"):
        tix.make_intersectors(S, mode="pallas_wide")
    # the streamed variant of K1 is K1: on a CPU scene its wrapper's plain version
    closest, any_hit = tix.make_intersectors(S, mode="pallas_stream", tri_test="mt")
    assert closest.packed["leaf"] == "det2" and "k1_words" in closest.packed
    # its second triangle test: Havel-Herout rows packed once, for K1 only
    # (and K1 runs the primary rays of 'hybrid')
    for mode in ("pallas_stream", "hybrid"):
        closest, _ = tix.make_intersectors(S, mode=mode, tri_test="hh")
        assert closest.tris_hh.shape == (12 * S["tri_v0"].shape[0],)
    for mode in ("bvh", "pallas8", "pallas8_nodes", "pallas_nodes", "pallas_dense"):
        with pytest.raises(ValueError, match="binary kernel"):
            tix.make_intersectors(S, mode=mode, tri_test="hh")
    assert set(tix.MODES) >= set(RENDER_MODES) | {"auto", "kernel", "bvh"}


def test_dense_mode_refuses_a_large_scene(scenes):
    big = scenes["terrain64"]
    assert big.tri_v0.shape[0] > intersect_dense.DENSE_MAX_TRIS
    S = upload_scene(_scene_dict(big), "cpu")
    with pytest.raises(ValueError, match="at most 4096 triangles"):
        tix.make_intersectors(S, mode="pallas_dense")
    with pytest.raises(ValueError, match="at most 4096 triangles"):
        tix.make_intersectors(S, mode="hybrid")


def test_wrappers_refuse_what_the_kernels_do_not_take(scenes):
    """The checks a wrapper makes before a launch, reached without a card:
    packed arrays of the wrong type or length raise."""
    S = upload_scene(_scene_dict(scenes["cornell"]), "cpu")
    P = dict(tix.make_intersectors(S, "pallas8_nodes")[0].packed)
    dev = torch.device("cpu")
    assert len(intersect_wide8_nodes._scene_args(P, dev)) == 8
    with pytest.raises(TypeError, match="p8n_nodes"):
        intersect_wide8_nodes._scene_args({**P, "p8n_nodes": P["p8n_nodes"].double()}, dev)
    with pytest.raises(ValueError, match="wrong length"):
        intersect_wide8_nodes._scene_args({**P, "p8n_nodes": P["p8n_nodes"][:-1]}, dev)
    with pytest.raises(ValueError, match="traversal stack"):
        intersect_wide8_nodes._scene_args({**P, "stack_need": 97}, dev)
    Pn = dict(tix.make_intersectors(S, "pallas_nodes")[0].packed)
    with pytest.raises(ValueError, match="wrong length"):
        intersect_nodes._scene_args({**Pn, "pn_roots": Pn["pn_roots"][:-1]}, dev)
    Pd = dict(tix.make_intersectors(S, "pallas_dense")[0].packed)
    assert len(intersect_dense._scene_args(Pd, dev)) == 5
    with pytest.raises(ValueError, match="instance count"):
        intersect_dense._scene_args({**Pd, "pk_ranges": Pd["pk_ranges"][:-2]}, dev)
    with pytest.raises(ValueError, match="k5_words.*wrong length"):
        intersect_dense._scene_args({**Pd, "k5_words": Pd["k5_words"][:-4]}, dev)
    P8 = dict(tix.make_intersectors(S, "pallas8")[0].packed)
    assert len(intersect_wide8._scene_args(P8, dev)) == 8
    with pytest.raises(ValueError, match="disagree in length"):
        intersect_wide8._scene_args({**P8, "pk_boxes": P8["pk_boxes"][:-48]}, dev)
    with pytest.raises(ValueError, match="k4_words.*wrong length"):
        intersect_wide8._scene_args({**P8, "k4_words": P8["k4_words"][:-4]}, dev)
    with pytest.raises(ValueError, match="traversal stack"):
        intersect_wide8._scene_args({**P8, "stack_need": 97}, dev)


def test_a_shared_header_edit_changes_every_build_key(tmp_path, monkeypatch):
    """A library's build is keyed by its source AND every header it includes,
    directly or through another header."""
    import shutil

    from polaris_tpu_torch.ops import _build

    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC_DIR, csrc)
    monkeypatch.setattr(_build, "CSRC_DIR", str(csrc))
    assert _build._source_closure("intersect_wide8_nodes.cu") == [
        "intersect_wide8_nodes.cu", "traverse_common.cuh", "traverse_wide.cuh",
    ]
    assert _build._source_closure("intersect_wide8.cu") == [
        "intersect_wide8.cu", "traverse_block.cuh", "traverse_common.cuh",
        "traverse_wide.cuh",
    ]
    sources = [
        "intersect.cu", "intersect_nodes.cu", "intersect_wide8.cu",
        "intersect_wide8_nodes.cu", "intersect_dense.cu",
    ]
    before = {s: _build._plan(s, ("-fmad=false",))[0] for s in sources}
    assert len(set(before.values())) == len(sources)
    with open(csrc / "traverse_common.cuh", "a") as f:
        f.write("// edited\n")
    after = {s: _build._plan(s, ("-fmad=false",))[0] for s in sources}
    assert all(before[s] != after[s] for s in sources)
    with open(csrc / "traverse_wide.cuh", "a") as f:
        f.write("// edited\n")
    last = {s: _build._plan(s, ("-fmad=false",))[0] for s in sources}
    changed = {s for s in sources if last[s] != after[s]}
    assert changed == {"intersect_wide8.cu", "intersect_wide8_nodes.cu"}
    # the block-local schedule: K4's and K5's libraries alone
    with open(csrc / "traverse_block.cuh", "a") as f:
        f.write("// edited\n")
    block = {s: _build._plan(s, ("-fmad=false",))[0] for s in sources}
    assert {s for s in sources if block[s] != last[s]} == {
        "intersect_wide8.cu", "intersect_dense.cu",
    }
    assert _build._plan("intersect.cu", ())[0] != last["intersect.cu"]  # flags count
