"""The port's compiled launch on the CPU: the driver that runs one step of a
loop over static tensors (replayed from a CUDA graph on a card, called
directly here) against the eager loop functions, and the port against the
JAX package.

* ``render_accum_offset`` runs ``opt.spp`` samples as ONE partial, as the
  JAX package's does (``polaris_tpu/render/integrator.py:871-892``); only
  ``render_accum`` and ``render_u8`` split a frame into ``spp_per_launch``
  chunks. Bit for bit: one call of ``render_block_regen``, or one pass of
  the sequential loop, over all samples.
* The driver equals the eager loops bit for bit, in both loops and across
  chunks, and counts the eager loop's trips.
* One trip on an all-dead carry leaves ``radiance``, ``alive``, ``s``, ``b``
  and the trip counter bit-unchanged (the trips the driver runs after the
  last lane died, between two reads of its stop test).
* Against ``TpuRenderer(mode="bvh")``: the tolerance of
  ``tests/test_parity.py::_compare`` (atol 1e-4, rtol 1e-3; atol 2e-4 for
  mitsuba, which is textured). A lane whose Russian-roulette or BxDF
  decision flips on an ulp between the two frameworks changes its pixel by
  far more; such pixels are counted, at most 0.5% of the frame, as in
  ``tests/test_torch_render.py``.
* ``render/graph.py::Step`` counts the launches its replays make, with
  CUDA's graph calls stood in for by fakes; with the same fakes, a renderer
  on a card whose traversal reads back to the host ('bvh') runs its steps
  uncaptured, and a kernel mode captures them.
"""

import os
from dataclasses import fields, replace

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from polaris_tpu_torch.render.integrator import (  # noqa: E402
    TorchRenderer,
    render_block_regen,
    render_blocked_eager,
    render_sample_block,
)
from polaris_tpu_torch.render.options import RenderOptions  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL, RTOL = 1e-4, 1e-3
TEXTURED_ATOL = 2e-4
MAX_FLIPPED_SHARE = 0.005
PER_LAUNCH = 2
# more samples than one launch takes, so that render_accum chunks them
FRAME = dict(width=32, height=32, spp=PER_LAUNCH + 2, num_bounces=3, min_bounces_for_rr=2)
LOOPS = [False, True]
LOOP_IDS = ["sequential", "regen"]


def _jax_scene(name):
    from polaris_tpu.asset.compiler.compiler import compile_scene
    from polaris_tpu.asset.wavefront import read_scene

    return compile_scene(read_scene(os.path.join(REPO, "scenes", f"{name}.obj")))


@pytest.fixture(scope="module")
def scenes():
    return {name: _jax_scene(name) for name in ("sphere", "mitsuba")}


@pytest.fixture(scope="module")
def jax_accum(scenes):
    """The JAX package's accumulators, rendered once per (scene, loop, call)."""
    from polaris_tpu.render.integrator import TpuRenderer
    from polaris_tpu.render.options import RenderOptions as JaxOptions

    cache = {}

    def get(name, regen, call):
        key = (name, regen, call)
        if key not in cache:
            r = TpuRenderer(scenes[name], mode="bvh", regen=regen)
            r.spp_per_launch = PER_LAUNCH
            cache[key] = np.asarray(getattr(r, call)(JaxOptions(**FRAME)))
        return cache[key]

    return get


def _renderer(scene, regen, **kw):
    r = TorchRenderer(
        {f.name: getattr(scene, f.name) for f in fields(scene)}, device="cpu",
        mode="bvh", regen=regen, **kw,
    )
    r.spp_per_launch = PER_LAUNCH
    return r


def _assert_close(got, ref, label, atol=ATOL):
    assert got.shape == ref.shape and np.isfinite(got).all()
    bad = (~np.isclose(got, ref, atol=atol, rtol=RTOL)).any(axis=-1)
    allowed = int(MAX_FLIPPED_SHARE * bad.size)
    assert int(bad.sum()) <= allowed, (label, int(bad.sum()), float(np.abs(got - ref).max()))
    assert ref.mean() > 1e-3


def _eager_one_partial(r, opt):
    """``opt.spp`` samples from 0 through ONE call of the eager loop
    functions, unblocked: (accumulator [H, W, 3], trips)."""
    frustum, eye = r._camera_tensors(opt, None)
    xs, ys, pix, _ = r._pixel_order(opt.width, opt.height)
    common = dict(
        frustum=frustum, eye=eye, width=opt.width, height=opt.height, pixel_x=xs,
        pixel_y=ys, pixel_idx=pix, seed=opt.seed, num_bounces=opt.num_bounces,
        min_bounces_for_rr=opt.min_bounces_for_rr, num_emissives=r.num_emissives,
        scene_diffuse_mat=r.scene_diffuse_mat, material_depth=r.material_depth,
    )
    with torch.no_grad():
        if r.regen:
            part, trips = render_block_regen(
                r.S, r.closest, r.any_hit, sample_offset=0, spp=opt.spp, **common
            )
        else:
            part = torch.zeros((opt.width * opt.height, 3))
            for s in range(opt.spp):
                part = part + render_sample_block(
                    r.S, r.closest, r.any_hit, sample_idx=s, **common
                )
            trips = opt.spp * opt.num_bounces
    return r.finalize(part, opt), trips


@pytest.mark.parametrize("regen", LOOPS, ids=LOOP_IDS)
def test_render_accum_offset_is_one_partial(scenes, jax_accum, regen):
    """The fault: the port used to split render_accum_offset into
    spp_per_launch chunks, which sums (s0+s1)+(s2+s3) where the JAX package
    sums s0+s1+s2+s3, and takes other trips with regeneration."""
    opt = RenderOptions(**FRAME)
    r = _renderer(scenes["sphere"], regen)
    got = r.render_accum_offset(opt)
    want, trips = _eager_one_partial(r, opt)
    assert torch.equal(got, want)
    assert r.last_trips == trips
    _assert_close(got.numpy(), jax_accum("sphere", regen, "render_accum_offset"),
                  f"offset/{regen}")


@pytest.mark.parametrize("regen", LOOPS, ids=LOOP_IDS)
def test_driver_equals_the_eager_loops_across_chunks(scenes, regen):
    """render_accum / render_u8 (two chunks: 2 + 2 samples) against the same
    chunks through the eager loop functions, bit for bit; and a frame whose
    last chunk is shorter (3 = 2 + 1), with another graph for its shape."""
    r = _renderer(scenes["sphere"], regen)
    for spp in (FRAME["spp"], PER_LAUNCH + 1):
        opt = RenderOptions(**{**FRAME, "spp": spp})
        got = r.render_accum(opt)
        eager, trips = render_blocked_eager(r, opt)
        assert torch.equal(got, r.finalize(eager, opt)), spp
        assert r.last_trips == trips
        np.testing.assert_array_equal(r.render_u8(opt), r.finalize(eager, opt, "u8").numpy())
    # chunk shapes 2 and 1: one program each
    assert len(r._programs) == 2


@pytest.mark.parametrize("name", ["sphere", "mitsuba"])
def test_trip_on_an_all_dead_carry_changes_nothing(scenes, name):
    """mitsuba's background is textured: its miss shading runs on every
    lane and must still add exact zeros on dead ones."""
    opt = RenderOptions(**{**FRAME, "spp": 2})
    r = _renderer(scenes[name], True)
    r.render_accum_offset(opt)
    prog = r._program(opt, opt.spp, "regen")
    assert not bool(prog.carry["alive"].any())
    kept = ("radiance", "alive", "s", "b")
    before = {k: prog.carry[k].clone() for k in kept}
    trips = prog.trips.clone()
    assert int(trips) == r.last_trips > 0
    prog.trip()
    for k in kept:
        assert torch.equal(prog.carry[k], before[k]), k
    assert torch.equal(prog.trips, trips)


@pytest.mark.parametrize("regen", LOOPS, ids=LOOP_IDS)
def test_trip_counts(scenes, regen):
    """last_trips is the eager loop's count; the regeneration loop reads its
    stop test once every num_bounces trips, so it runs at most
    num_bounces - 1 trips past the end of each chunk; the sequential loop
    reads nothing back."""
    opt = RenderOptions(**FRAME)
    r = _renderer(scenes["sphere"], regen)
    r.render_accum(opt)
    _, trips = render_blocked_eager(r, opt)
    assert r.last_trips == trips
    chunks = -(-opt.spp // PER_LAUNCH)
    if regen:
        k = opt.num_bounces
        assert trips <= r.last_trips_run <= trips + chunks * (k - 1)
        assert r.last_trips_run % k == 0
        assert r.last_host_syncs == r.last_trips_run // k + 1
    else:
        assert r.last_trips_run == trips == opt.spp * opt.num_bounces
        assert r.last_host_syncs == 0


@pytest.mark.parametrize(
    "name,regen", [("sphere", False), ("sphere", True), ("mitsuba", True)],
    ids=["sphere-sequential", "sphere-regen", "mitsuba-regen"],
)
def test_port_matches_jax_bvh(scenes, jax_accum, name, regen):
    opt = RenderOptions(**FRAME)
    got = _renderer(scenes[name], regen).render_accum(opt).numpy()
    atol = TEXTURED_ATOL if name == "mitsuba" else ATOL
    _assert_close(got, jax_accum(name, regen, "render_accum"), f"{name}/{regen}", atol)


def on_a_faked_card(monkeypatch, scene, mode, cls=None, **kw):
    """``cls(scene, mode=mode)`` (default ``TorchRenderer``) built as on a card, with CUDA's
    calls stood in for: the device resolves to ``cuda:0`` (the scene is
    uploaded to the CPU all the same), and every ``Step`` the renderer then
    makes believes it runs on the card. ``torch.cuda.graph`` and
    ``torch.cuda.stream`` record that they were entered and capture
    nothing. Returns (renderer, events); the renderer's own tensors stay on
    the CPU, so its frames run."""
    import contextlib

    import polaris_tpu_torch.render.integrator as integrator
    from polaris_tpu_torch.render import graph

    events = []
    card = torch.device("cuda", 0)

    class FakeStream:
        def wait_stream(self, other):
            pass

    class FakeGraph:
        def replay(self):
            events.append("replay")

    @contextlib.contextmanager
    def capturing(g, pool=None, stream=None):
        events.append("capture")
        yield

    @contextlib.contextmanager
    def on_stream(s):
        events.append("stream")
        yield

    upload = integrator.upload_scene
    monkeypatch.setattr(integrator, "resolve_device", lambda d: card)
    monkeypatch.setattr(integrator, "upload_scene", lambda sc, d: upload(sc, "cpu"))
    monkeypatch.setattr(graph.torch.cuda, "Stream", lambda device=None: FakeStream())
    monkeypatch.setattr(graph.torch.cuda, "graph_pool_handle", lambda: None)
    monkeypatch.setattr(graph.torch.cuda, "CUDAGraph", FakeGraph)
    monkeypatch.setattr(graph.torch.cuda, "graph", capturing)
    monkeypatch.setattr(graph.torch.cuda, "stream", on_stream)
    monkeypatch.setattr(graph.torch.cuda, "current_stream", lambda device=None: FakeStream())
    r = (cls or integrator.TorchRenderer)(
        {f.name: getattr(scene, f.name) for f in fields(scene)}, mode=mode, **kw
    )
    assert r.device == card
    r.device = torch.device("cpu")  # where its tensors are
    step = integrator.Step
    monkeypatch.setattr(
        integrator, "Step", lambda fn, device, *a, **k: step(fn, card, *a, **k)
    )
    return r, events


def test_bvh_mode_refuses_a_card(scenes, monkeypatch):
    """The fault this test once pinned, repaired: a renderer on a card
    refused 'bvh', whose traversal reads its loop test back to the host and
    cannot be captured into a CUDA graph. Now it builds, and its steps run
    uncaptured, op by op, on the caller's stream: a frame of either loop
    enters no ``torch.cuda.graph`` and switches no stream, and equals the
    CPU renderer's bit for bit. A kernel mode on the same stand-ins still
    captures its steps."""
    opt = RenderOptions(width=16, height=16, spp=2, num_bounces=2, min_bounces_for_rr=2)
    for regen in LOOPS:
        want = _renderer(scenes["sphere"], regen).render_accum(opt)
        r, events = on_a_faked_card(monkeypatch, scenes["sphere"], "bvh", regen=regen)
        assert r.reads_back and r.regen == regen
        got = r.render_accum(opt)
        assert events == [], events
        assert all(not s.capture and s.graph is None
                   for p in r._programs.values() for s in p.steps)
        assert torch.equal(got, want)
        monkeypatch.undo()
    r, events = on_a_faked_card(monkeypatch, scenes["sphere"], "auto")
    assert not r.reads_back
    r.render_accum(replace(opt, spp=1))
    assert events[:2] == ["stream", "capture"], events


def test_step_counts_the_launches_its_replays_make(monkeypatch):
    """A capture runs a wrapper's Python once and launches nothing: its
    counts are taken back out of LAUNCHES and kept as the graph's, and each
    replay adds them. The first call also runs the step once for real (the
    warm-up), on the capture stream, and the capture runs with the cyclic
    garbage collector paused (a collection could free another graph while
    the stream captures). CUDA's graph calls are stood in for by fakes here;
    the card's own run is chip_smoke.py's launch check."""
    import contextlib
    import gc

    from polaris_tpu_torch.ops import intersect_cuda, intersect_dense
    from polaris_tpu_torch.render import graph

    events = []

    class FakeGraph:
        def replay(self):
            events.append("replay")

    class FakeStream:
        def wait_stream(self, other):
            pass

    @contextlib.contextmanager
    def capturing(g, pool=None, stream=None):
        events.append("capture" if gc.isenabled() else "capture, gc paused")
        yield

    monkeypatch.setattr(graph.torch.cuda, "CUDAGraph", FakeGraph)
    monkeypatch.setattr(graph.torch.cuda, "graph", capturing)
    monkeypatch.setattr(graph.torch.cuda, "stream", lambda s: contextlib.nullcontext())
    monkeypatch.setattr(graph.torch.cuda, "current_stream", lambda device=None: FakeStream())
    for mod in (intersect_cuda, intersect_dense):
        monkeypatch.setattr(mod, "LAUNCHES", {k: 0 for k in mod.LAUNCHES})

    def fn():  # what a trip's wrappers do: one closest hit on K1, two any hits on K5
        events.append("run")
        intersect_cuda.LAUNCHES["closest_hit"] += 1
        intersect_dense.LAUNCHES["any_hit"] += 2

    step = graph.Step(fn, torch.device("cuda", 0), FakeStream(), None)
    step()
    assert events == ["run", "capture, gc paused", "run"]
    assert gc.isenabled()
    assert intersect_cuda.LAUNCHES["closest_hit"] == 1  # the warm-up's, not the capture's
    assert intersect_dense.LAUNCHES["any_hit"] == 2
    for _ in range(3):
        step()
    assert events[3:] == ["replay"] * 3
    assert intersect_cuda.LAUNCHES == {"closest_hit": 4, "any_hit": 0, "closest_hit_hh": 0,
                                       "any_hit_hh": 0}
    assert intersect_dense.LAUNCHES == {"closest_hit": 0, "any_hit": 8}
    cpu = graph.Step(fn, torch.device("cpu"))
    cpu()
    assert events[-1] == "run" and intersect_cuda.LAUNCHES["closest_hit"] == 5
