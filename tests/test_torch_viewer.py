"""The port's viewer and tooling on the CPU: profiling, the PNG encoder, the
debug channels, the post-process pipeline and the progressive renderer with
its HTTP viewer.

* Against the JAX package on the same scene (cornell, 16x16, 1-2 spp, 2
  bounces), at the tolerance of ``tests/test_parity.py::_compare`` (atol
  1e-4, rtol 1e-3): ``ProgressiveRenderer`` after two passes against the
  JAX one (``mode="bvh"`` both sides: the same quotient-form leaf test);
  every debug channel against the JAX ``render_debug``, ``hitmask`` and
  ``instance`` exactly.
* The JAX package's own cases, run against the port:
  ``tests/test_progressive.py`` (one-shot equality, camera reset, spp
  chunking, the HTTP endpoints, orbit and ``/stats``, the overlay data, pool
  mode, a remote scene) and ``tests/test_pipeline.py`` (all three), at
  their tolerances, or exactly where the port's result is exact.
* The PNG encoder: PIL decodes its files to the same pixels.

Every server here is shut down in a ``finally`` and every request has a
timeout of its own.
"""

import json
import os
import urllib.request
from dataclasses import fields

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from polaris_tpu_torch.render.integrator import TorchRenderer  # noqa: E402
from polaris_tpu_torch.render.options import RenderOptions  # noqa: E402

ATOL, RTOL = 1e-4, 1e-3
FRAME = dict(width=16, height=16, spp=2, num_bounces=2, min_bounces_for_rr=3)
HTTP_TIMEOUT = 30


def _fields(scene):
    return {f.name: getattr(scene, f.name) for f in fields(scene)}


def _get(port, path):
    return urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=HTTP_TIMEOUT)


@pytest.fixture(scope="module")
def cornell(cornell_scene):
    return _fields(cornell_scene)


@pytest.fixture(scope="module")
def renderer(cornell):
    return TorchRenderer(cornell, device="cpu", mode="bvh")


# ----- utils/profiling.py -----


def test_trace_writes_a_chrome_trace(tmp_path, renderer):
    from polaris_tpu_torch.utils.profiling import TRACE_FILE, trace

    with trace(str(tmp_path)) as prof:
        with torch.profiler.record_function("frame"):
            renderer.render_accum(RenderOptions(**FRAME))
    with open(tmp_path / TRACE_FILE) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name") for e in events}
    assert "frame" in names
    assert any(n and n.startswith("aten::") for n in names)
    assert any(a.key == "frame" for a in prof.key_averages())


def test_stage_timer_table():
    from polaris_tpu_torch.utils.profiling import StageTimer

    timer = StageTimer()
    for _ in range(2):
        with timer.stage("scene", fence=torch.zeros(3)):
            pass
    with timer.stage("render"):
        pass
    assert list(timer.stages) == ["scene", "render"]
    assert all(ms >= 0.0 for ms in timer.stages.values())
    table = timer.table()
    assert "scene" in table and "render" in table and "TOTAL" in table


# ----- utils/png.py -----


@pytest.mark.parametrize("shape", [(1, 1), (5, 7), (16, 32)])
def test_png_decodes_with_pil_to_the_same_pixels(tmp_path, shape):
    from PIL import Image

    from polaris_tpu_torch.utils.png import encode_png, write_png

    img = np.random.default_rng(sum(shape)).integers(0, 256, shape + (3,), dtype=np.uint8)
    path = tmp_path / "x.png"
    write_png(str(path), img)
    with Image.open(path) as im:
        assert im.mode == "RGB" and im.size == (shape[1], shape[0])
        np.testing.assert_array_equal(np.asarray(im), img)
    assert path.read_bytes() == encode_png(img)


def test_png_refuses_what_it_cannot_write():
    from polaris_tpu_torch.utils.png import encode_png

    with pytest.raises(ValueError):
        encode_png(np.zeros((4, 4, 3), np.float32))
    with pytest.raises(ValueError):
        encode_png(np.zeros((4, 4), np.uint8))


# ----- render/debug.py -----


@pytest.fixture(scope="module")
def jax_debug(cornell_scene):
    from polaris_tpu.render.debug import DEBUG_CHANNELS, render_debug
    from polaris_tpu.render.integrator import TpuRenderer
    from polaris_tpu.render.options import RenderOptions as JaxOptions

    r = TpuRenderer(cornell_scene, mode="bvh")
    return {ch: render_debug(r, JaxOptions(**FRAME), ch) for ch in DEBUG_CHANNELS}


@pytest.mark.parametrize(
    "channel",
    ["depth", "normals", "uv", "hitmask", "instance", "emissive_vis", "throughput",
     "accumulator"],
)
def test_debug_channel_matches_jax(renderer, jax_debug, channel):
    from polaris_tpu_torch.render.debug import DEBUG_CHANNELS, render_debug

    assert channel in DEBUG_CHANNELS and len(DEBUG_CHANNELS) == len(jax_debug)
    got = render_debug(renderer, RenderOptions(**FRAME), channel)
    assert got.shape == (16, 16, 3) and got.dtype == torch.float32
    want = jax_debug[channel]
    if channel in ("hitmask", "instance"):
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)


def test_debug_unknown_channel_raises(renderer):
    from polaris_tpu_torch.render.debug import render_debug

    with pytest.raises(ValueError, match="unknown debug channel"):
        render_debug(renderer, RenderOptions(**FRAME), "albedo")


def test_debug_accumulator_through_a_given_traversal_is_the_eager_loop(renderer):
    """With ``closest`` / ``any_hit`` given, the accumulator channel runs
    the eager loops; with the renderer's own traversal that is the graphs'
    frame bit for bit."""
    from polaris_tpu_torch.render.debug import render_debug

    opt = RenderOptions(**FRAME)
    given = render_debug(renderer, opt, "accumulator", closest=renderer.closest,
                         any_hit=renderer.any_hit)
    assert torch.equal(given, render_debug(renderer, opt, "accumulator"))


# ----- render/pipeline.py (tests/test_pipeline.py, ported) -----


def test_default_pipeline_matches_renderer_render(sphere_scene):
    from polaris_tpu_torch.render.pipeline import default_pipeline

    opt = RenderOptions(width=32, height=32, spp=2, num_bounces=3, min_bounces_for_rr=99)
    r = TorchRenderer(_fields(sphere_scene), device="cpu", mode="bvh")
    img_pipe = default_pipeline().run(r, opt)
    img_direct = r.render(opt)
    assert isinstance(img_pipe, np.ndarray)
    np.testing.assert_array_equal(img_pipe, img_direct)


def test_stage_chain_order_and_outputs(sphere_scene, tmp_path):
    from PIL import Image

    from polaris_tpu_torch.asset.texture import _load_hdr
    from polaris_tpu_torch.render.pipeline import (
        Pipeline, save_hdr_stage, save_png_stage, tonemap_stage,
    )

    opt = RenderOptions(width=32, height=32, spp=2, num_bounces=3, min_bounces_for_rr=99)
    r = TorchRenderer(_fields(sphere_scene), device="cpu", mode="bvh")
    hdr_path = str(tmp_path / "frame.hdr")
    png_path = str(tmp_path / "frame.png")
    pipe = Pipeline(post_process=[
        save_hdr_stage(hdr_path),   # raw accumulator, pre-tonemap
        tonemap_stage(),
        save_png_stage(png_path),
    ])
    img = pipe.run(r, opt)
    assert os.path.exists(hdr_path) and os.path.exists(png_path)
    assert img.shape == (32, 32, 3) and img.min() >= 0 and img.max() <= 1

    # the .hdr round-trips the raw accumulator (RGBE has ~1% mantissa error)
    accum = r.render_accum(opt).numpy()
    back = _load_hdr(hdr_path).data[..., :3]
    np.testing.assert_allclose(back, accum, rtol=0.05, atol=1e-3)
    with Image.open(png_path) as im:
        np.testing.assert_array_equal(np.asarray(im), (np.clip(img, 0, 1) * 255).astype(np.uint8))


def test_pipeline_accum_passthrough():
    """Supplying a precomputed accumulator skips rendering."""
    from polaris_tpu.render.shade import tonemap_reinhard as jax_tonemap
    from polaris_tpu_torch.render.pipeline import Pipeline, tonemap_stage

    opt = RenderOptions(width=4, height=4, spp=8, num_bounces=2)
    acc = np.full((4, 4, 3), 2.0, np.float32)
    pipe = Pipeline(post_process=[tonemap_stage()])
    img = pipe.run(renderer=None, opt=opt, accum=acc, accumulated_samples=8)
    expect = np.asarray(jax_tonemap(np, acc, 1 / 8, opt.exposure))
    np.testing.assert_allclose(img, expect, atol=1e-6)


def test_denoise_and_debug_stages_write_files_that_decode(renderer, tmp_path):
    """``denoise_stage`` is the port's ``denoise_accum`` on the accumulator;
    ``debug_dump_stage`` writes one PNG a channel."""
    from PIL import Image

    from polaris_tpu_torch.render.debug import render_debug
    from polaris_tpu_torch.render.denoise import denoise_accum
    from polaris_tpu_torch.render.pipeline import (
        Pipeline, debug_dump_stage, denoise_stage, save_png_stage, tonemap_stage,
    )

    opt = RenderOptions(**FRAME)
    png_path = str(tmp_path / "den.png")
    img = Pipeline(post_process=[
        denoise_stage(iterations=2), debug_dump_stage(["normals"], str(tmp_path)),
        tonemap_stage(), save_png_stage(png_path),
    ]).run(renderer, opt)
    den = denoise_accum(renderer, opt, renderer.render_accum(opt), opt.spp, iterations=2)
    want = Pipeline(post_process=[tonemap_stage()]).run(renderer, opt, accum=den)
    np.testing.assert_array_equal(img, want)
    with Image.open(png_path) as im:
        np.testing.assert_array_equal(np.asarray(im), (np.clip(img, 0, 1) * 255).astype(np.uint8))
    with Image.open(tmp_path / "debug_normals.png") as im:
        normals = render_debug(renderer, opt, "normals").numpy()
        np.testing.assert_array_equal(np.asarray(im), (normals * 255).astype(np.uint8))


# ----- render/progressive.py (tests/test_progressive.py, ported) -----


def _progressive(cornell, opt, **kw):
    from polaris_tpu_torch.render.progressive import ProgressiveRenderer

    return ProgressiveRenderer(cornell, opt, mode="bvh", device="cpu", **kw)


@pytest.mark.parametrize("regen", [False, True], ids=["sequential", "regen"])
def test_progressive_matches_jax_after_two_passes(cornell, cornell_scene, regen):
    from polaris_tpu.render.options import RenderOptions as JaxOptions
    from polaris_tpu.render.progressive import ProgressiveRenderer as JaxProgressive

    opt = RenderOptions(**FRAME)
    prog = _progressive(cornell, opt, regen=regen)
    jprog = JaxProgressive(cornell_scene, JaxOptions(**FRAME), mode="bvh", regen=regen)
    for _ in range(2):
        img = prog.step()
        jimg = jprog.step()
    assert prog.accumulated_samples == jprog.accumulated_samples == 4
    np.testing.assert_allclose(prog.accum.numpy(), np.asarray(jprog.accum), atol=ATOL, rtol=RTOL)
    assert img.dtype == np.uint8 and img.shape == jimg.shape
    assert np.abs(img.astype(int) - jimg.astype(int)).max() <= 1


def test_progressive_passes_are_render_accum_offset_partials(cornell):
    """After each pass the accumulator is the sum of the passes'
    ``render_accum_offset`` partials, bit for bit, and its u8 image is
    ``tonemap_u8`` of it."""
    opt = RenderOptions(**FRAME)
    prog = _progressive(cornell, opt)
    r = TorchRenderer(cornell, device="cpu", mode="bvh")
    want = torch.zeros(16, 16, 3)
    for k in range(3):
        img = prog.step()
        want = want + r.render_accum_offset(opt, sample_offset=2 * k)
        assert torch.equal(prog.accum, want)
        u8 = TorchRenderer.tonemap_u8(want, 1.0 / (2 * k + 2), opt.exposure)
        np.testing.assert_array_equal(img, u8.numpy())


def test_progressive_equals_oneshot(cornell):
    """k passes of spp each == one render at k*spp samples (absolute sample
    indices in the RNG counters)."""
    opt2 = RenderOptions(width=16, height=16, spp=2, num_bounces=2, min_bounces_for_rr=3)
    prog = _progressive(cornell, opt2)
    prog.step()
    prog.step()
    assert prog.accumulated_samples == 4

    opt4 = RenderOptions(width=16, height=16, spp=4, num_bounces=2, min_bounces_for_rr=3)
    oneshot = TorchRenderer(cornell, device="cpu", mode="bvh").render_accum(opt4)
    np.testing.assert_allclose(prog.accum.numpy(), oneshot.numpy(), atol=1e-4)


def test_camera_change_resets_accumulation(cornell):
    opt = RenderOptions(width=16, height=16, spp=1, num_bounces=2, min_bounces_for_rr=3)
    prog = _progressive(cornell, opt)
    prog.step()
    assert prog.accumulated_samples == 1
    prog.move_camera("forward", 0.2)
    # buffered async: applied (and accumulator reset) at the next pass
    assert prog.accumulated_samples == 1
    cam = prog._pending_camera
    prog.step()
    assert prog.accumulated_samples == 1  # reset + one new pass
    fresh = TorchRenderer(cornell, device="cpu", mode="bvh").render_accum_offset(opt, cam)
    assert torch.equal(prog.accum, fresh)


def test_spp_chunking_equals_single_launch(cornell):
    r = TorchRenderer(cornell, device="cpu", mode="bvh")
    r.spp_per_launch = 2
    opt = RenderOptions(width=16, height=16, spp=6, num_bounces=2, min_bounces_for_rr=3)
    chunked = r.render_accum(opt)
    r2 = TorchRenderer(cornell, device="cpu", mode="bvh")
    r2.spp_per_launch = 99
    whole = r2.render_accum(opt)
    np.testing.assert_allclose(chunked.numpy(), whole.numpy(), atol=1e-4)


def test_http_viewer_and_camera_endpoint(cornell):
    from PIL import Image

    from polaris_tpu_torch.render.progressive import _start_server

    opt = RenderOptions(width=16, height=16, spp=1, num_bounces=2, min_bounces_for_rr=3)
    prog = _progressive(cornell, opt)
    img = prog.step()
    prog._publish(img)
    server = _start_server(prog, 0)
    port = server.server_address[1]
    try:
        with _get(port, "/frame.png") as r:
            assert r.status == 200
            data = r.read()
        assert data[:8] == b"\x89PNG\r\n\x1a\n"
        import io

        with Image.open(io.BytesIO(data)) as im:
            np.testing.assert_array_equal(np.asarray(im), img)
        with _get(port, "/move?dir=forward&step=0.1") as r:
            assert r.status == 204
        assert prog._pending_camera is not None
        # the root page is the interactive drag-orbit client (reference
        # mouse-look, opengl.go:273-291): pointer events wired to /orbit,
        # keys to /move, wheel to /fov, JS image refresh (no page reload)
        with _get(port, "/") as r:
            assert r.status == 200
            page = r.read().decode()
        assert "pointermove" in page and "/orbit?pitch=" in page
        assert "keydown" in page and "/move?dir=" in page
        assert "wheel" in page and "/fov?deg=" in page
        assert "http-equiv" not in page  # drags must survive refreshes
        # cache-busted frame fetches (the JS refresh path) still serve PNG
        with _get(port, "/frame.png?t=123") as r:
            assert r.status == 200
            assert r.read()[:8] == b"\x89PNG\r\n\x1a\n"
        with pytest.raises(urllib.error.HTTPError) as err:
            _get(port, "/move?dir=sideways&step=0.1")
        assert err.value.code == 400
    finally:
        server.shutdown()
        server.server_close()


def test_orbit_endpoint_and_stats_blocks(cornell):
    """/orbit rotates the look direction about the eye (reference mouse
    drag, opengl.go:273-291); /stats carries the block-assignment rows (the
    TAB overlay counterpart) and camera state."""
    from polaris_tpu_torch.render.progressive import _start_server

    opt = RenderOptions(width=16, height=16, spp=1, num_bounces=2, min_bounces_for_rr=3)
    prog = _progressive(cornell, opt)
    prog.step()
    server = _start_server(prog, 0)
    port = server.server_address[1]
    try:
        eye0 = prog.camera.position.copy()
        look0 = prog.camera.look_at.copy()
        with _get(port, "/orbit?pitch=0.0&yaw=0.5") as r:
            assert r.status == 204
        assert prog._pending_camera is not None
        cam = prog._pending_camera
        np.testing.assert_allclose(cam.position, eye0)  # orbit, not move
        d0 = look0 - eye0
        d1 = cam.look_at - cam.position
        # rotation preserves length but changes direction by the yaw angle
        np.testing.assert_allclose(np.linalg.norm(d1), np.linalg.norm(d0), rtol=1e-5)
        cosang = np.dot(d0, d1) / (np.linalg.norm(d0) * np.linalg.norm(d1))
        np.testing.assert_allclose(cosang, np.cos(0.5), atol=1e-5)
        # applied (and accumulation reset) at the next pass
        prog.step()
        assert prog.accumulated_samples == 1
        # deltas were consumed: a later move must not re-apply the rotation
        look_after = prog.camera.look_at.copy()
        prog.move_camera("up", 0.1)
        cam2 = prog._pending_camera
        np.testing.assert_allclose(
            cam2.look_at - cam2.position, look_after - prog.camera.position, atol=1e-6,
        )

        with _get(port, "/fov?deg=60") as r:
            assert r.status == 204
        assert prog._pending_camera.fov == 60.0

        with _get(port, "/stats") as r:
            stats = json.loads(r.read())
        # pending fov is buffered, not committed yet
        assert prog.camera.fov != 60.0
        assert stats["camera"]["fov"] == prog.camera.fov
        assert stats["accumulated_samples"] == 1
        assert len(stats["blocks"]) == 1
        assert stats["blocks"][0]["height"] == 16
        assert stats["blocks"][0]["device"] == "cpu"
    finally:
        server.shutdown()
        server.server_close()


def test_viewer_overlay_embeds_assignment_data(cornell):
    """The viewer page draws the TAB overlay (block-assignment boxes over
    the image + stacked per-pass distribution chart, ≙ the reference's
    in-window UI, opengl.go:193-213,305-361) and /stats feeds it the block
    history + frame dimensions."""
    from polaris_tpu_torch.render.progressive import _start_server

    opt = RenderOptions(width=16, height=16, spp=1, num_bounces=2, min_bounces_for_rr=3)
    prog = _progressive(cornell, opt)
    prog.step()
    prog.pass_history.append((1, 1.0))
    prog.block_history.append(prog.block_assignment())
    server = _start_server(prog, 0)
    port = server.server_address[1]
    try:
        with _get(port, "/") as r:
            page = r.read().decode()
        # overlay canvas stacked on the image, toggled by TAB
        assert "canvas id=ov" in page and "'Tab'" in page
        # block boxes: strokeRect per device row with its render time
        assert "stats.blocks.forEach" in page and "strokeRect" in page
        assert "render_ms" in page
        # stacked distribution chart from the per-pass history
        assert "block_history" in page and "block distribution" in page
        with _get(port, "/stats") as r:
            stats = json.loads(r.read())
        assert stats["frame"] == {"width": 16, "height": 16}
        assert len(stats["block_history"]) == 1
        assert stats["block_history"][0][0]["height"] == 16
        assert stats["passes"] == [{"samples": 1, "ms": 1.0}]
    finally:
        server.shutdown()
        server.server_close()


def test_viewer_page_is_the_jax_page():
    from polaris_tpu.render.progressive import _VIEWER_HTML as jax_page
    from polaris_tpu_torch.render.progressive import _VIEWER_HTML

    assert _VIEWER_HTML == jax_page


def test_progressive_pool_mode_blocks(cornell):
    """Progressive rendering through the feedback worker pool: image equals
    the single-renderer result and /stats blocks are the measured bands."""
    from polaris_tpu_torch.parallel.workers import BandWorker, WorkerPoolRenderer

    opt = RenderOptions(width=16, height=64, spp=1, num_bounces=2, min_bounces_for_rr=3)
    pool = WorkerPoolRenderer(
        [
            BandWorker("w0", TorchRenderer(cornell, device="cpu", mode="bvh")),
            BandWorker("w1", TorchRenderer(cornell, device="cpu", mode="bvh")),
        ],
        height_quantum=16,
    )
    prog = _progressive(cornell, opt, pool=pool)
    prog.step()
    single = _progressive(cornell, opt)
    single.step()
    assert torch.equal(prog.accum, single.accum)
    blocks = prog.block_assignment()
    assert [b["device"] for b in blocks] == ["w0", "w1"]
    assert sum(b["height"] for b in blocks) == 64
    assert all(b["render_ms"] >= 0 for b in blocks)


def test_run_writes_snapshots_and_history(cornell, tmp_path):
    from PIL import Image

    opt = RenderOptions(width=16, height=16, spp=1, num_bounces=2, min_bounces_for_rr=3)
    prog = _progressive(cornell, opt)
    out = str(tmp_path / "frame.png")
    img = prog.run(target_samples=3, snapshot_every=2, out=out)
    assert prog.accumulated_samples == 3
    assert [s for s, _ in prog.pass_history] == [1, 2, 3]
    assert len(prog.block_history) == 3
    with Image.open(out) as im:
        np.testing.assert_array_equal(np.asarray(im), img)


def test_remote_scene_resource(tmp_path):
    """HTTP-served scene assets (≙ wavefront_test.go httptest servers)."""
    import functools
    import threading
    from http.server import SimpleHTTPRequestHandler, ThreadingHTTPServer

    (tmp_path / "r.obj").write_text(
        "mtllib r.mtl\nv 0 0 0\nv 1 0 0\nv 0 1 0\nusemtl m\nf 1 2 3\n"
    )
    (tmp_path / "r.mtl").write_text("newmtl m\nKd 0.5 0.5 0.5\n")
    handler = functools.partial(SimpleHTTPRequestHandler, directory=str(tmp_path))
    server = ThreadingHTTPServer(("127.0.0.1", 0), handler)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    port = server.server_address[1]
    try:
        from polaris_tpu_torch.asset.wavefront import read_scene

        sc = read_scene(f"http://127.0.0.1:{port}/r.obj")
        assert sc.meshes[0].num_triangles == 1
        assert sc.materials[0].name == "m"
    finally:
        server.shutdown()
        server.server_close()
