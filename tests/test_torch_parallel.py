"""The port's parallel layer on the CPU: the schedulers, row-band renders,
the feedback worker pool, the tile x sample mesh with its train step, and
multi-process rendering over ``torch.distributed`` (``gloo``).

* Against the JAX package on the same scene (cornell, 16-32 px, 2 spp, 2
  bounces, ``mode="bvh"`` both sides), at the tolerance of
  ``tests/test_parity.py::_compare`` (atol 1e-4, rtol 1e-3):
  ``render_band_accum``; ``DistributedRenderer.render_accum`` on
  ``make_mesh(2, 2, devices=["cpu"] * 4)`` against the JAX one on a 2x2
  virtual mesh; one distributed ``train_step`` (the loss, then
  ``mat_reflectance`` after the step) against the JAX one, whose gradient is
  the sample count times the frame's (a fault of the JAX step the port does
  not copy: its step equals ``DifferentiableRenderer``'s on one device).
* The JAX package's own cases, run against the port:
  ``tests/test_scheduler_cli.py`` (the five scheduler tests),
  ``tests/test_workers.py`` (all eight), ``tests/test_sharding.py`` (tile,
  sample and 2D against a single device) and ``tests/test_multihost.py``
  (the two-process render, tile 2x1, and the two-process train step, 2x1
  and 1x2), at their tolerances, or exactly where the port's result is
  exact; ``spawn_local_processes`` needs a card unless ``devices`` names
  the CPU.
* ``ValueError`` when rows or spp do not divide the mesh.
* The verbatim copies (``render/stats.py``, ``render/scheduler.py``) are the
  originals byte for byte, and the worker snippet of
  ``spawn_local_processes`` imports nothing of JAX.
* ``render/graph.py``'s capture from two threads: one capture at a time, in
  ``thread_local`` mode, and launch counts that no capture takes from
  another thread (CUDA's graph calls stood in for by fakes).

Every subprocess here has a timeout of its own.
"""

import contextlib
import os
import subprocess
import sys
import threading
from dataclasses import fields

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from polaris_tpu_torch.render.integrator import TorchRenderer  # noqa: E402
from polaris_tpu_torch.render.options import RenderOptions  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL, RTOL = 1e-4, 1e-3
FRAME = dict(width=16, height=32, spp=2, num_bounces=2, min_bounces_for_rr=3)
SUBPROCESS_TIMEOUT = 300


def _fields(scene):
    return {f.name: getattr(scene, f.name) for f in fields(scene)}


@pytest.fixture(scope="module")
def cornell(cornell_scene):
    return _fields(cornell_scene)


@pytest.fixture(scope="module")
def single(cornell):
    """The single renderer's accumulator at FRAME."""
    return TorchRenderer(cornell, device="cpu", mode="bvh").render_accum(RenderOptions(**FRAME))


@pytest.mark.parametrize("path", ["render/stats.py", "render/scheduler.py"])
def test_verbatim_copy_is_the_original_byte_for_byte(path):
    with open(os.path.join(REPO, "polaris_tpu", path), "rb") as a, \
            open(os.path.join(REPO, "polaris_tpu_torch", path), "rb") as b:
        assert a.read() == b.read(), path


# ----- render/scheduler.py (tests/test_scheduler_cli.py, ported) -----


def test_naive_split_proportional():
    from polaris_tpu_torch.render.scheduler import NaiveScheduler

    # floor(10/3)=3, floor(20/3)=6, remainder 1 to worker 0 -> [4, 6]
    assert NaiveScheduler([1.0, 2.0]).schedule(10) == [4, 6]


def test_naive_equal():
    from polaris_tpu_torch.render.scheduler import NaiveScheduler

    assert NaiveScheduler([1.0, 1.0, 1.0, 1.0]).schedule(100) == [25, 25, 25, 25]


def test_perfect_first_frame_equal():
    from polaris_tpu_torch.render.scheduler import PerfectScheduler

    assert PerfectScheduler(2).schedule(10) == [5, 5]


def test_perfect_feedback():
    from polaris_tpu_torch.render.scheduler import PerfectScheduler

    # worker 0 renders 2x faster -> next frame gets ~2/3 of the rows
    s = PerfectScheduler(2)
    s.report(0, block_h=5, render_time_ms=50.0)
    s.report(1, block_h=5, render_time_ms=100.0)
    heights = s.schedule(12)
    assert heights == [8, 4]
    assert sum(heights) == 12


def test_blocks_walking_y():
    from polaris_tpu_torch.render.scheduler import blocks_from_heights

    blocks = blocks_from_heights([4, 6], 16, 10, samples_per_pixel=8)
    assert blocks[0].block_y == 0 and blocks[0].block_h == 4
    assert blocks[1].block_y == 4 and blocks[1].block_h == 6
    assert blocks[1].samples_per_pixel == 8


# ----- TorchRenderer.render_band_accum -----


def test_band_render_matches_jax(cornell, cornell_scene):
    from polaris_tpu.render.integrator import TpuRenderer
    from polaris_tpu.render.options import RenderOptions as JaxOptions

    want = np.asarray(
        TpuRenderer(cornell_scene, mode="bvh").render_band_accum(JaxOptions(**FRAME), 8, 16)
    )
    r = TorchRenderer(cornell, device="cpu", mode="bvh")
    got = r.render_band_accum(RenderOptions(**FRAME), 8, 16)
    assert got.shape == (16, 16, 3)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)
    assert r.last_render_ms > 0 and r.last_trips_run == 2 * 2


def test_band_program_is_the_eager_band(cornell):
    """The band program (one step a sample, ``row0`` a device input) against
    ``render_band_eager``, bit for bit, at two bands of one program."""
    from polaris_tpu_torch.render.integrator import render_band_eager

    opt = RenderOptions(**FRAME)
    r = TorchRenderer(cornell, device="cpu", mode="bvh")
    frustum, eye = r._camera_tensors(opt, None)
    for y0 in (0, 16):
        got = r.render_band_accum(opt, y0, 16, sample_offset=3)
        want = render_band_eager(r, opt, frustum=frustum, eye=eye, y0=y0, band_h=16,
                                 sample_offset=3)
        assert torch.equal(got, r.finalize(want, RenderOptions(**dict(FRAME, height=16))))
    assert list(r._programs) == [(16, 32, 2, 2, 3, False, "sequential", 16)]


def test_band_outside_the_frame_raises(cornell):
    r = TorchRenderer(cornell, device="cpu", mode="bvh")
    with pytest.raises(ValueError, match="not inside a frame"):
        r.render_band_accum(RenderOptions(**FRAME), 24, 16)


# ----- parallel/workers.py (tests/test_workers.py, ported) -----


class FakeRenderer:
    """Mock-tracer pattern: render time proportional to rows / speed."""

    def __init__(self, speed: float):
        self.speed = speed
        self.last_render_ms = 0.0

    def render_band_accum(self, opt, y0, band_h, camera=None, sample_offset=0):
        self.last_render_ms = band_h / self.speed
        return torch.full((band_h, opt.width, 3), float(y0))


def _fake_worker(name, renderer, speed=1.0):
    from polaris_tpu_torch.parallel.workers import BandWorker

    class FakeWorker(BandWorker):
        """BandWorker whose reported time is the fake renderer's synthetic
        time (wall time of a fill would be meaningless)."""

        def render_band(self, opt, y0, band_h, camera=None, sample_offset=0):
            accum = self.renderer.render_band_accum(opt, y0, band_h)
            return accum, self.renderer.last_render_ms

    return FakeWorker(name, renderer, speed=speed)


def test_feedback_converges_to_throughput():
    from polaris_tpu_torch.parallel.workers import WorkerPoolRenderer

    # worker 1 is 3x faster; after feedback it should get ~3x the rows
    workers = [_fake_worker("slow", FakeRenderer(1.0)), _fake_worker("fast", FakeRenderer(3.0))]
    pool = WorkerPoolRenderer(workers, height_quantum=16)
    opt = RenderOptions(width=32, height=256, spp=1, num_bounces=1)
    for _ in range(4):
        pool.render_accum(opt)
    heights = pool.schedule(opt.height)
    assert sum(heights) == 256
    assert heights[1] > 2.0 * heights[0], heights


def test_naive_first_frame_uses_speed_estimates():
    from polaris_tpu_torch.parallel.workers import WorkerPoolRenderer

    workers = [_fake_worker("a", FakeRenderer(1.0), speed=1.0),
               _fake_worker("b", FakeRenderer(1.0), speed=2.0)]
    pool = WorkerPoolRenderer(workers, height_quantum=16)
    # naive split 1:2 (scheduler.go:83-106), quantized to 16 rows
    assert pool.schedule(96) == [32, 64]


def test_band_render_matches_full_frame_rows(cornell):
    opt = RenderOptions(width=32, height=32, spp=2, num_bounces=2)
    r = TorchRenderer(cornell, device="cpu", mode="bvh")
    full = r.render_accum(opt)
    band = r.render_band_accum(opt, y0=8, band_h=16)
    assert torch.equal(band, full[8:24])


def test_pool_image_bit_identical_and_stats_real(cornell, single):
    from polaris_tpu_torch.parallel.workers import BandWorker, WorkerPoolRenderer

    workers = [
        BandWorker("w0", TorchRenderer(cornell, device="cpu", mode="bvh")),
        BandWorker("w1", TorchRenderer(cornell, device="cpu", mode="bvh")),
    ]
    pool = WorkerPoolRenderer(workers, height_quantum=16)
    accum = pool.render_accum(RenderOptions(**FRAME))
    assert torch.equal(accum, single)

    stats = pool.frame_stats
    assert len(stats.workers) == 2
    assert sum(w.block_h for w in stats.workers) == 32
    # measured, not fabricated: every worker reports its own wall time
    assert all(w.render_time_ms > 0 for w in stats.workers)
    assert abs(sum(w.frame_percent for w in stats.workers) - 100.0) < 1e-6


def test_device_pool_runs_on_repeated_devices(cornell):
    from polaris_tpu_torch.parallel.workers import make_device_pool

    opt = RenderOptions(width=32, height=32, spp=1, num_bounces=1)
    pool = make_device_pool(cornell, mode="bvh", devices=["cpu", "cpu"], height_quantum=16)
    assert [w.name for w in pool.workers] == ["cpu#0", "cpu#1"]
    assert all(w.speed == 1.0 and w.stream is None for w in pool.workers)
    img = pool.render(opt)
    assert img.shape == (32, 32, 3)
    assert np.isfinite(img).all()


def test_zero_height_worker_is_not_starved():
    """A worker whose quantized share rounds to 0 rows must keep its last
    measured rate (reporting 0/0 would peg it at rate 0.0 forever)."""
    from polaris_tpu_torch.parallel.workers import WorkerPoolRenderer

    workers = [_fake_worker("fast", FakeRenderer(50.0)), _fake_worker("slow", FakeRenderer(1.0))]
    pool = WorkerPoolRenderer(workers, height_quantum=32)
    opt = RenderOptions(width=16, height=128, spp=1, num_bounces=1)
    for _ in range(5):
        pool.render_accum(opt)
    st = pool.perfect.last[1]
    assert st.block_h > 0 and st.render_time_ms > 0, st
    workers[0].renderer.speed = 0.5  # fast worker degrades 100x
    for _ in range(3):
        pool.render_accum(opt)
    assert pool.schedule(opt.height)[1] > 0  # recovered rows


def test_band_program_keys_frame_height(cornell):
    """Same (width, band_h) at two frame heights must not share a program
    (frame height is in raygen's interpolation and the RNG pixel ids)."""
    r = TorchRenderer(cornell, device="cpu", mode="bvh")
    opt64 = RenderOptions(width=16, height=64, spp=1, num_bounces=2, min_bounces_for_rr=3)
    opt32 = RenderOptions(width=16, height=32, spp=1, num_bounces=2, min_bounces_for_rr=3)
    band64 = r.render_band_accum(opt64, 16, 16)
    band32 = r.render_band_accum(opt32, 16, 16)
    full64 = TorchRenderer(cornell, device="cpu", mode="bvh").render_accum(opt64)
    full32 = TorchRenderer(cornell, device="cpu", mode="bvh").render_accum(opt32)
    assert torch.equal(band64, full64[16:32])
    assert torch.equal(band32, full32[16:32])


def test_band_spp_chunking_matches_single_launch(cornell):
    """Band renders chunk spp by spp_per_launch and stay within f32 rounding
    of an unchunked band."""
    opt = RenderOptions(width=16, height=32, spp=6, num_bounces=2, min_bounces_for_rr=3)
    r1 = TorchRenderer(cornell, device="cpu", mode="bvh")
    r1.spp_per_launch = 2
    chunked = r1.render_band_accum(opt, 8, 16)
    r2 = TorchRenderer(cornell, device="cpu", mode="bvh")
    r2.spp_per_launch = 99
    whole = r2.render_band_accum(opt, 8, 16)
    np.testing.assert_allclose(chunked.numpy(), whole.numpy(), atol=1e-5)


def test_device_pool_needs_a_card_unless_devices_are_named(cornell, monkeypatch):
    from polaris_tpu_torch.parallel.mesh import make_mesh
    from polaris_tpu_torch.parallel.workers import make_device_pool

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_device_pool(cornell)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh(2, 1)


# ----- parallel/mesh.py (tests/test_sharding.py, ported) -----


def _mesh(cornell, tile, sample):
    from polaris_tpu_torch.parallel.mesh import DistributedRenderer, make_mesh

    return DistributedRenderer(cornell, make_mesh(tile, sample, ["cpu"] * 8), mode="bvh")


@pytest.mark.parametrize("tile,sample", [(4, 1), (1, 2), (4, 2)], ids=["tile", "sample", "2d"])
def test_mesh_matches_single_device(cornell, single, tile, sample):
    dist = _mesh(cornell, tile, sample).render_accum(RenderOptions(**FRAME))
    np.testing.assert_allclose(dist.numpy(), single.numpy(), atol=1e-5)
    if sample == 1:  # rows only: the same additions
        assert torch.equal(dist, single)


@pytest.fixture(scope="module")
def jax_mesh(cornell_scene):
    """The JAX DistributedRenderer on a 2x2 virtual mesh: its accumulator,
    then one train step (lr 0.05, zero target): the loss and
    ``mat_reflectance`` after the step."""
    from polaris_tpu.parallel.mesh import DistributedRenderer, make_mesh
    from polaris_tpu.render.options import RenderOptions as JaxOptions

    opt = JaxOptions(**FRAME)
    r = DistributedRenderer(cornell_scene, make_mesh(2, 2), mode="bvh")
    accum = np.asarray(r.render_accum(opt))
    loss = r.train_step(opt, np.zeros((32, 16, 3), np.float32), lr=0.05)
    return accum, loss, np.asarray(r.params["mat_reflectance"])


def test_mesh_2x2_matches_jax(cornell, jax_mesh):
    got = _mesh(cornell, 2, 2).render_accum(RenderOptions(**FRAME))
    np.testing.assert_allclose(got.numpy(), jax_mesh[0], atol=ATOL, rtol=RTOL)


def test_mesh_train_step_matches_jax(cornell, cornell_scene, jax_mesh):
    """The loss, and the parameters after the step, against the JAX step on
    the same 2x2 mesh, with one deliberate divergence. The JAX step's
    gradient is ``sample`` times the frame's: under ``shard_map`` with
    ``check_vma=False`` its ``psum`` over 'sample' transposes to another
    ``psum``, not to the broadcast its comment assumes, so each sample
    shard's gradient already holds its whole tile's before the ``psum``
    over both axes adds the shards again (the JAX package steps twice as
    far on a 1x2 or 2x2 mesh as on a 2x1 mesh or one device). The port
    takes the frame's gradient, as one device does (the next test): its
    step is the JAX step with the gradient divided by the sample count."""
    _, jax_loss, jax_refl = jax_mesh
    m = _mesh(cornell, 2, 2)
    before = m.params["mat_reflectance"].clone()
    loss = m.train_step(RenderOptions(**FRAME), np.zeros((32, 16, 3), np.float32), lr=0.05)
    assert np.isfinite(loss) and loss > 0
    np.testing.assert_allclose(loss, jax_loss, rtol=RTOL)
    refl = m.params["mat_reflectance"]
    assert not torch.equal(refl, before)
    samples = m.mesh.shape["sample"]
    want = before.numpy() - (before.numpy() - jax_refl) / samples
    np.testing.assert_allclose(refl.numpy(), want, atol=ATOL, rtol=RTOL)
    # the step reached every renderer and left the scene's arrays alone
    for r in m.renderers.values():
        assert torch.equal(r.S["mat_reflectance"], refl)
    np.testing.assert_array_equal(cornell["mat_reflectance"], cornell_scene.mat_reflectance)


def test_mesh_train_step_is_the_single_device_step(cornell):
    """The mesh's loss and SGD step against ``DifferentiableRenderer``'s
    loss and gradient on one device."""
    from polaris_tpu_torch.render.grad import DifferentiableRenderer

    opt = RenderOptions(**FRAME)
    target = np.zeros((32, 16, 3), np.float32)
    ref = DifferentiableRenderer(cornell, device="cpu", mode="bvh")
    ref_loss, grads, _ = ref.loss_and_grad(opt, target)
    m = _mesh(cornell, 2, 2)
    before = {k: v.clone() for k, v in m.params.items()}
    loss = m.train_step(opt, target, lr=0.05)
    np.testing.assert_allclose(loss, ref_loss, rtol=1e-5)
    for k, g in grads.items():
        want = before[k] - 0.05 * g
        scale = float(want.abs().max()) or 1.0
        np.testing.assert_allclose(m.params[k].numpy(), want.detach().numpy(), rtol=0,
                                   atol=1e-6 * scale, err_msg=k)


@pytest.mark.parametrize("tile,sample,frame,what", [
    (3, 1, FRAME, "rows must divide"),
    (2, 3, FRAME, "spp must divide"),
])
def test_mesh_that_does_not_divide_raises(cornell, tile, sample, frame, what):
    m = _mesh(cornell, tile, sample)
    opt = RenderOptions(**frame)
    with pytest.raises(ValueError, match=what):
        m.render_accum(opt)
    with pytest.raises(ValueError, match=what):
        m.train_step(opt, np.zeros((32, 16, 3), np.float32))


def test_mesh_needs_enough_devices():
    from polaris_tpu_torch.parallel.mesh import make_mesh

    with pytest.raises(ValueError, match="need 4 devices, have 3"):
        make_mesh(2, 2, ["cpu"] * 3)
    mesh = make_mesh(2, 2, ["cpu"] * 5)
    assert mesh.shape == {"tile": 2, "sample": 2}
    assert mesh.devices == [[torch.device("cpu")] * 2] * 2


# ----- parallel/multihost.py (tests/test_multihost.py, ported) -----

MULTI = dict(width=16, height=16, spp=2, num_bounces=2, min_bounces_for_rr=3)


@pytest.fixture(scope="module")
def scene_zip(cornell_scene, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("multihost") / "scene.zip")
    cornell_scene.save(path)
    return path


def test_two_process_render_matches(cornell, scene_zip, tmp_path):
    from polaris_tpu_torch.parallel.multihost import spawn_local_processes

    single = TorchRenderer(cornell, device="cpu", mode="bvh").render_accum(RenderOptions(**MULTI))
    got = spawn_local_processes(
        scene_zip, MULTI, num_processes=2, tile=2, sample=1, out_path=str(tmp_path / "accum"),
        backend="gloo", devices=["cpu"] * 2, mode="bvh", timeout=SUBPROCESS_TIMEOUT,
    )
    assert got["accum"].shape == (16, 16, 3) and got["ms"].shape == (1,)
    np.testing.assert_array_equal(got["accum"], single.numpy())


def test_two_process_train_step(cornell, scene_zip, tmp_path):
    """A distributed train step across 2 processes: the loss and the updated
    parameters against the same step on a one-process (2, 1) mesh."""
    from polaris_tpu_torch.parallel.multihost import spawn_local_processes

    opt = RenderOptions(**MULTI)
    ref = _mesh(cornell, 2, 1)
    ref_loss = ref.train_step(opt, np.zeros((16, 16, 3), np.float32), lr=0.1)
    got = spawn_local_processes(
        scene_zip, MULTI, num_processes=2, tile=2, sample=1, out_path=str(tmp_path / "train"),
        backend="gloo", devices=["cpu"] * 2, mode="bvh", job="train",
        timeout=SUBPROCESS_TIMEOUT,
    )
    np.testing.assert_allclose(float(got["loss"]), ref_loss, rtol=1e-5)
    np.testing.assert_allclose(got["refl"], ref.params["mat_reflectance"].numpy(),
                               rtol=1e-4, atol=1e-7)
    assert not np.array_equal(got["refl"], cornell["mat_reflectance"])


def test_two_process_train_step_over_samples(cornell, scene_zip, tmp_path):
    """The train step with the sample axis across 2 processes (1x2): the
    tile's accumulator is a differentiable all-reduce and each rank
    backpropagates half of the tile's loss. The loss and the updated
    parameters against the one-process (1, 2) mesh's step and against
    ``DifferentiableRenderer``'s loss and gradient with the same SGD step,
    so a step ``sample`` times too long or too short fails."""
    from polaris_tpu_torch.parallel.multihost import spawn_local_processes
    from polaris_tpu_torch.render.grad import DifferentiableRenderer

    opt = RenderOptions(**MULTI)
    target = np.zeros((16, 16, 3), np.float32)
    ref = _mesh(cornell, 1, 2)
    ref_loss = ref.train_step(opt, target, lr=0.1)
    one = DifferentiableRenderer(cornell, device="cpu", mode="bvh")
    one_loss, grads, _ = one.loss_and_grad(opt, target)
    one_refl = (torch.as_tensor(cornell["mat_reflectance"])
                - 0.1 * grads["mat_reflectance"]).detach().numpy()
    got = spawn_local_processes(
        scene_zip, MULTI, num_processes=2, tile=1, sample=2, out_path=str(tmp_path / "train"),
        backend="gloo", devices=["cpu"] * 2, mode="bvh", job="train",
        timeout=SUBPROCESS_TIMEOUT,
    )
    for loss, refl in ((ref_loss, ref.params["mat_reflectance"].numpy()), (one_loss, one_refl)):
        np.testing.assert_allclose(float(got["loss"]), loss, rtol=1e-5)
        np.testing.assert_allclose(got["refl"], refl, rtol=1e-4, atol=1e-7)
    assert not np.array_equal(got["refl"], cornell["mat_reflectance"])


def test_spawn_needs_a_card_unless_devices_are_named(scene_zip, tmp_path, monkeypatch):
    from polaris_tpu_torch.parallel.multihost import spawn_local_processes

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match=r"no CUDA device.*devices=\['cpu'"):
        spawn_local_processes(scene_zip, MULTI, 2, 2, 1, str(tmp_path / "x"), backend="gloo")


def test_worker_snippet_imports_nothing_of_jax():
    from polaris_tpu_torch.parallel import multihost

    snippet = multihost._WORKER_SNIPPET
    assert "jax" not in snippet
    imports = "\n".join(
        line for line in snippet.splitlines() if line.startswith(("import ", "from "))
    )
    code = (
        f"import sys\nsys.path.insert(0, {REPO!r})\n{imports}\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'polaris_tpu')]\n"
        "assert not bad, bad\n"
        "print('clean')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, timeout=SUBPROCESS_TIMEOUT, cwd=REPO)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "clean" in out.stdout


def test_spawn_refuses_a_wrong_job_or_device_count(scene_zip, tmp_path):
    from polaris_tpu_torch.parallel.multihost import spawn_local_processes

    with pytest.raises(ValueError, match="job"):
        spawn_local_processes(scene_zip, MULTI, 2, 2, 1, str(tmp_path / "x"), backend="gloo",
                              job="serve")
    with pytest.raises(ValueError, match="1 devices for 2 processes"):
        spawn_local_processes(scene_zip, MULTI, 2, 2, 1, str(tmp_path / "x"), backend="gloo",
                              devices=["cpu"])


# ----- render/graph.py from two threads -----


def test_capture_is_thread_local_and_keeps_other_threads_launches(monkeypatch):
    """While one thread captures, another thread's launch is counted only
    after the capture has taken its own counts back out, so it is neither
    charged to the graph nor erased; the capture runs in ``thread_local``
    mode. CUDA's graph calls are stood in for by fakes."""
    from polaris_tpu_torch.ops import _launch, intersect_cuda
    from polaris_tpu_torch.render import graph

    modes = []
    other = {}

    class FakeGraph:
        def replay(self):
            pass

    class FakeStream:
        def wait_stream(self, s):
            pass

    class Capture:
        capture_error_mode = "global"

        def __enter__(self):
            modes.append(self.capture_error_mode)

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(graph.torch.cuda, "CUDAGraph", FakeGraph)
    monkeypatch.setattr(graph.torch.cuda, "graph", lambda g, pool=None, stream=None: Capture())
    monkeypatch.setattr(graph.torch.cuda, "stream", lambda s: contextlib.nullcontext())
    monkeypatch.setattr(graph.torch.cuda, "current_stream", lambda device=None: FakeStream())
    monkeypatch.setattr(intersect_cuda, "LAUNCHES", {k: 0 for k in intersect_cuda.LAUNCHES})
    capturing = threading.Event()

    def launch_elsewhere():  # another worker's launch, made during the capture
        _launch.count(intersect_cuda.LAUNCHES, "any_hit")

    def fn():
        _launch.count(intersect_cuda.LAUNCHES, "closest_hit")
        if modes and not capturing.is_set():  # inside the capture
            capturing.set()
            other["thread"] = threading.Thread(target=launch_elsewhere)
            other["thread"].start()
            other["thread"].join(timeout=0.2)
            other["blocked"] = other["thread"].is_alive()

    step = graph.Step(fn, torch.device("cuda", 0), FakeStream(), None)
    step()  # warm-up, then the capture
    other["thread"].join(timeout=10)
    assert not other["thread"].is_alive()
    assert modes == ["thread_local"]
    assert other["blocked"]  # the other thread waited for the capture
    assert step.launches == [(0, "closest_hit", 1)]
    assert intersect_cuda.LAUNCHES["closest_hit"] == 1  # the warm-up's
    assert intersect_cuda.LAUNCHES["any_hit"] == 1  # the other thread's, kept
    step()
    assert intersect_cuda.LAUNCHES["closest_hit"] == 2


def test_launch_counts_are_exact_under_many_threads(monkeypatch):
    """Threads counting and replaying at once lose no launch."""
    from polaris_tpu_torch.ops import _launch, intersect_cuda
    from polaris_tpu_torch.render import graph

    monkeypatch.setattr(intersect_cuda, "LAUNCHES", {k: 0 for k in intersect_cuda.LAUNCHES})

    class Replayed(graph.Step):
        def __init__(self):
            self.device = torch.device("cuda", 0)
            self.graph = type("G", (), {"replay": lambda self: None})()
            self.launches = [(0, "closest_hit", 2)]

    step = Replayed()
    n_threads, n = 16, 2000

    def work():
        for _ in range(n):
            _launch.count(intersect_cuda.LAUNCHES, "closest_hit")
            step()

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert intersect_cuda.LAUNCHES["closest_hit"] == 3 * n_threads * n
