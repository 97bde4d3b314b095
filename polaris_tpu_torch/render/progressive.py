"""Progressive rendering with accumulation + optional live HTTP preview.

Counterpart of the JAX package's ``render/progressive.py``, itself the
counterpart of the reference's interactive renderer
(``renderer/opengl.go:57-361``): progressive accumulation adds spp samples
per pass until a target (opengl.go:136-171), camera changes reset the
accumulator via asynchronously-buffered state updates applied at the next
trace (opengl.go:294-303, tracer.go:150-191). The GL window + FBO blit is
replaced by PNG snapshots (``utils/png.py``) and a minimal HTTP viewer (an
image refreshed from JavaScript).

Because the RNG is keyed by absolute sample index, a progressive render of
k passes x spp equals a one-shot render at k*spp samples up to the order of
the float additions; each pass is one ``render_accum_offset`` partial, added
to an accumulator on the device.
"""

from __future__ import annotations

import threading
import time
from typing import Optional

import numpy as np
import torch

from ..asset.camera import Camera
from ..scene import as_scene_data, resolve_device
from ..utils.log import get_logger
from ..utils.png import encode_png, write_png
from .integrator import TorchRenderer
from .options import RenderOptions


def _to_u8(img: np.ndarray) -> np.ndarray:
    if img.dtype == np.uint8:
        return img
    return (np.clip(img, 0, 1) * 255).astype(np.uint8)

_log = get_logger("progressive renderer")


class ProgressiveRenderer:
    def __init__(
        self,
        scene,
        opt: RenderOptions,
        mode: str = "auto",
        pool=None,
        regen: bool = False,
        device=None,
    ):
        """``pool``: optional WorkerPoolRenderer: passes render through the
        feedback-scheduled band workers instead of the single renderer, and
        /stats then reports the measured per-worker block assignment (the
        counterpart of the reference's TAB overlay boxes,
        opengl.go:193-213). ``regen``: wavefront path regeneration for the
        per-pass renders (estimator-exact; single-renderer mode only).
        ``device``: the single renderer's, which holds the accumulator; in
        pool mode the accumulator's. ``None`` means the CUDA device and
        raises without one; the CPU only on request."""
        self.scene = as_scene_data(scene)
        self.opt = opt
        self.pool = pool
        self.renderer = (
            None if pool is not None
            else TorchRenderer(self.scene, device=device, mode=mode, regen=regen)
        )
        self.device = self.renderer.device if pool is None else resolve_device(device)
        self.camera = Camera.from_scene(self.scene, opt.width, opt.height)
        # the accumulator stays on the device: a pass fetches only the
        # tonemapped u8 image
        self.accum = torch.zeros(
            (opt.height, opt.width, 3), dtype=torch.float32, device=self.device
        )
        self.accumulated_samples = 0
        self._pending_camera: Optional[Camera] = None
        self._lock = threading.Lock()
        self._latest_png: bytes = b""
        self.pass_history: list = []  # (accumulated_samples, ms) per pass
        self.block_history: list = []  # block_assignment() per pass (the
        # overlay chart's data, ≙ opengl.go:305-361 blockAssignmentHistory)

    # --- async state updates (≙ tracer.go UpdateState(Asynchronous)) ---

    def update_camera(self, camera: Camera) -> None:
        """Buffer a camera change; applied at the next pass, resetting
        accumulation (opengl.go:294-303)."""
        with self._lock:
            self._pending_camera = camera

    def move_camera(self, direction: str, offset: float) -> None:
        cam = self.camera.clone()
        cam.move(direction, offset)
        self.update_camera(cam)

    def orbit_camera(self, pitch: float, yaw: float) -> None:
        """Rotate the look direction about the eye by (pitch, yaw) radians:
        the reference's left-mouse drag (opengl.go:285-291 sets the deltas,
        camera.go:98-112 consumes them in Update). Unlike the reference the
        deltas are zeroed after applying, so a later move() doesn't silently
        re-apply the last rotation (docs/parity.md)."""
        cam = self.camera.clone()
        cam.pitch = pitch
        cam.yaw = yaw
        cam.update()
        cam.pitch = 0.0
        cam.yaw = 0.0
        self.update_camera(cam)

    def set_fov(self, fov_deg: float) -> None:
        cam = self.camera.clone()
        cam.fov = float(fov_deg)
        cam.setup_projection(self.opt.width / self.opt.height)
        self.update_camera(cam)

    def block_assignment(self) -> list:
        """Current frame's device/block rows (≙ the TAB overlay's block
        boxes): measured per-worker bands in pool mode, one full-frame block
        otherwise."""
        if self.pool is not None and self.pool.frame_stats is not None:
            y0 = 0
            rows = []
            for w in self.pool.frame_stats.workers:
                rows.append(
                    {
                        "device": w.device_id,
                        "y0": y0,
                        "height": w.block_h,
                        "width": w.block_w,
                        "render_ms": round(w.render_time_ms, 2),
                    }
                )
                y0 += w.block_h
            return rows
        dev = "pool(unscheduled)" if self.pool is not None else str(
            getattr(self.renderer, "last_device", "device0")
        )
        ms = self.pass_history[-1][1] if self.pass_history else 0.0
        return [
            {
                "device": dev,
                "y0": 0,
                "height": self.opt.height,
                "width": self.opt.width,
                "render_ms": round(ms, 2),
            }
        ]

    def _commit_changes(self) -> None:
        with self._lock:
            if self._pending_camera is not None:
                self.camera = self._pending_camera
                self._pending_camera = None
                self.accum.zero_()
                self.accumulated_samples = 0

    # --- rendering ---

    def step(self) -> np.ndarray:
        """Render one pass of opt.spp samples, from the next absolute sample
        index, and add it to the accumulator. Returns the current tonemapped
        u8 image [H, W, 3] on the host."""
        self._commit_changes()
        opt = self.opt
        if self.pool is not None:
            part = self.pool.render_accum(
                opt, camera=self.camera, sample_offset=self.accumulated_samples
            ).to(self.device)
        else:
            part = self.renderer.render_accum_offset(
                opt, self.camera, sample_offset=self.accumulated_samples
            )
        self.accum.add_(part)
        self.accumulated_samples += opt.spp
        img = TorchRenderer.tonemap_u8(
            self.accum, 1.0 / self.accumulated_samples, opt.exposure
        )
        return img.cpu().numpy()

    def run(
        self,
        target_samples: int = 256,
        snapshot_every: int = 16,
        out: str = "frame.png",
        serve_port: int = 0,
    ) -> np.ndarray:
        server = _start_server(self, serve_port) if serve_port else None
        img = None
        last_snap = 0
        try:
            while self.accumulated_samples < target_samples:
                t0 = time.perf_counter()
                img = self.step()
                dt = (time.perf_counter() - t0) * 1e3
                _log.info(
                    "pass done: %d/%d samples (%.0f ms)",
                    self.accumulated_samples, target_samples, dt,
                )
                self.pass_history.append((self.accumulated_samples, dt))
                self.block_history.append(self.block_assignment())
                self._publish(img)
                if (
                    self.accumulated_samples - last_snap >= snapshot_every
                    or self.accumulated_samples >= target_samples
                ):
                    write_png(out, _to_u8(img))
                    last_snap = self.accumulated_samples
        finally:
            if server:
                server.shutdown()
                server.server_close()
        return img

    def _publish(self, img: np.ndarray) -> None:
        self._latest_png = encode_png(_to_u8(img))


# the interactive viewer page: mouse drag on the image orbits the camera
# (pointer deltas -> GET /orbit, the reference's left-mouse drag,
# opengl.go:273-291), WASD/RF keys move (opengl.go:215-271), the wheel zooms
# via /fov. The image refreshes from JS so an in-flight drag is never
# interrupted by a page reload.
_VIEWER_HTML = b"""<!doctype html><html><head><title>polaris-tpu</title>
<style>body{background:#111;color:#ccc;font-family:monospace}
#wrap{position:relative;display:inline-block}
#v{cursor:grab;user-select:none;-webkit-user-drag:none;display:block}
#ov{position:absolute;left:0;top:0;pointer-events:none}</style></head>
<body><div id=wrap><img id=v src=/frame.png draggable=false>
<canvas id=ov></canvas></div>
<p id=s>drag: orbit &middot; WASD/RF: move &middot; wheel: fov &middot;
TAB: overlay</p>
<script>
const img = document.getElementById('v');
const sens = 0.005;            // radians per pixel, like the GL window
let dragging = false, lx = 0, ly = 0, fov = 45;
img.addEventListener('pointerdown', e => {
  dragging = true; lx = e.clientX; ly = e.clientY;
  img.setPointerCapture(e.pointerId);
});
img.addEventListener('pointerup', () => dragging = false);
img.addEventListener('pointermove', e => {
  if (!dragging) return;
  const dx = e.clientX - lx, dy = e.clientY - ly;
  lx = e.clientX; ly = e.clientY;
  if (dx || dy)
    fetch(`/orbit?pitch=${(-dy * sens).toFixed(5)}&yaw=${(-dx * sens).toFixed(5)}`);
});
img.addEventListener('wheel', e => {
  e.preventDefault();
  fov = Math.min(160, Math.max(5, fov + Math.sign(e.deltaY) * 2));
  fetch(`/fov?deg=${fov}`);
});
const keymap = {w:'forward', s:'backward', a:'left', d:'right',
                r:'up', f:'down'};
// TAB toggles the block-assignment overlay + stacked pass chart, like the
// reference's interactive UI (opengl.go:193-213, 305-361)
let overlay = false, stats = null;
document.addEventListener('keydown', e => {
  if (e.key === 'Tab') { e.preventDefault(); overlay = !overlay; draw(); return; }
  const dir = keymap[e.key.toLowerCase()];
  if (dir) fetch(`/move?dir=${dir}&step=0.25`);
});
const cv = document.getElementById('ov'), cx = cv.getContext('2d');
const palette = ['#e6194b','#3cb44b','#ffe119','#4363d8','#f58231','#911eb4'];
function draw() {
  cv.width = img.clientWidth; cv.height = img.clientHeight;
  cx.clearRect(0, 0, cv.width, cv.height);
  if (!overlay || !stats) return;
  const fw = stats.frame.width, fh = stats.frame.height;
  const sx = cv.width / fw, sy = cv.height / fh;
  cx.font = '12px monospace'; cx.lineWidth = 2;
  stats.blocks.forEach((b, i) => {           // per-device block boxes
    const c = palette[i % palette.length];
    cx.strokeStyle = c; cx.fillStyle = c;
    cx.strokeRect(1, b.y0 * sy + 1, b.width * sx - 2, b.height * sy - 2);
    cx.fillText(`${b.device} ${b.render_ms} ms`, 6, b.y0 * sy + 14);
  });
  const hist = stats.block_history || [];    // stacked assignment chart
  if (hist.length > 1) {
    const ch = Math.min(80, cv.height / 4), cw = Math.min(240, cv.width / 2);
    const x0 = 4, y1 = cv.height - 4, dx = cw / (hist.length - 1);
    const nrows = Math.max(...hist.map(p => p.length));
    cx.globalAlpha = 0.75;
    for (let r = 0; r < nrows; r++) {        // one band per device row
      cx.fillStyle = palette[r % palette.length];
      cx.beginPath(); cx.moveTo(x0, y1 - base(hist[0], r) * ch);
      hist.forEach((p, i) =>
        cx.lineTo(x0 + i * dx, y1 - (base(p, r) + frac(p, r)) * ch));
      for (let i = hist.length - 1; i >= 0; i--)
        cx.lineTo(x0 + i * dx, y1 - base(hist[i], r) * ch);
      cx.closePath(); cx.fill();
    }
    cx.globalAlpha = 1.0;
    cx.strokeStyle = '#ccc'; cx.lineWidth = 1;
    cx.strokeRect(x0, y1 - ch, cw, ch);
    cx.fillStyle = '#ccc';
    cx.fillText('block distribution / pass', x0 + 4, y1 - ch - 4);
  }
  function frac(p, r) { return r < p.length ? p[r].height / fh : 0; }
  function base(p, r) {
    let b = 0; for (let k = 0; k < r; k++) b += frac(p, k); return b;
  }
}
setInterval(() => {                       // refresh without reloading
  const probe = new Image();
  probe.onload = () => { img.src = probe.src; draw(); };
  probe.src = '/frame.png?t=' + Date.now();
}, 1000);
setInterval(async () => {
  stats = await (await fetch('/stats')).json();
  document.getElementById('s').textContent =
    `${stats.accumulated_samples} spp accumulated | drag: orbit | ` +
    `WASD/RF: move | wheel: fov | TAB: overlay`;
  if (overlay) draw();
}, 1000);
</script></body></html>"""


def _start_server(prog: ProgressiveRenderer, port: int):
    """Live viewer: / serves the drag-orbit page, /frame.png the latest image
    (≙ the interactive GL window, opengl.go:57-361)."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class Handler(BaseHTTPRequestHandler):
        def do_GET(self):  # noqa: N802
            if self.path.startswith("/frame.png"):
                data = prog._latest_png or b""
                self.send_response(200)
                self.send_header("Content-Type", "image/png")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)
            elif self.path == "/stats":
                # per-pass timing history (≙ the interactive TAB overlay's
                # stacked chart, opengl.go:305-361)
                import json

                body = json.dumps(
                    {
                        "accumulated_samples": prog.accumulated_samples,
                        "passes": [
                            {"samples": s_, "ms": ms}
                            for s_, ms in prog.pass_history[-100:]
                        ],
                        # ≙ the TAB overlay's block-assignment boxes
                        # (opengl.go:193-213)
                        "blocks": prog.block_assignment(),
                        # per-pass assignment history for the overlay's
                        # stacked chart (opengl.go:305-361)
                        "block_history": prog.block_history[-100:],
                        "frame": {
                            "width": prog.opt.width,
                            "height": prog.opt.height,
                        },
                        "camera": {
                            "eye": [float(v) for v in prog.camera.position],
                            "look_at": [float(v) for v in prog.camera.look_at],
                            "fov": float(prog.camera.fov),
                        },
                    }
                ).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.end_headers()
                self.wfile.write(body)
            elif self.path.startswith("/move"):
                # camera input (≙ the GL window's key handlers,
                # opengl.go:215-292): /move?dir=forward&step=0.25
                from urllib.parse import parse_qs, urlparse

                q = parse_qs(urlparse(self.path).query)
                direction = q.get("dir", ["forward"])[0]
                step = float(q.get("step", ["0.25"])[0])
                try:
                    prog.move_camera(direction, step)
                    self.send_response(204)
                    self.end_headers()
                except KeyError:
                    self.send_response(400)
                    self.end_headers()
            elif self.path.startswith("/orbit"):
                # look rotation (≙ the GL window's left-mouse drag,
                # opengl.go:273-291): /orbit?pitch=0.05&yaw=-0.1 (radians)
                from urllib.parse import parse_qs, urlparse

                q = parse_qs(urlparse(self.path).query)
                try:
                    pitch = float(q.get("pitch", ["0"])[0])
                    yaw = float(q.get("yaw", ["0"])[0])
                    prog.orbit_camera(pitch, yaw)
                    self.send_response(204)
                    self.end_headers()
                except ValueError:
                    self.send_response(400)
                    self.end_headers()
            elif self.path.startswith("/fov"):
                from urllib.parse import parse_qs, urlparse

                q = parse_qs(urlparse(self.path).query)
                try:
                    prog.set_fov(float(q.get("deg", ["45"])[0]))
                    self.send_response(204)
                    self.end_headers()
                except ValueError:
                    self.send_response(400)
                    self.end_headers()
            else:
                self.send_response(200)
                self.send_header("Content-Type", "text/html")
                self.end_headers()
                self.wfile.write(_VIEWER_HTML)

        def log_message(self, *a):
            pass

    server = ThreadingHTTPServer(("0.0.0.0", port), Handler)
    port = server.server_address[1]  # the one the OS picked for port 0
    threading.Thread(target=server.serve_forever, daemon=True).start()
    _log.info("live preview at http://localhost:%d/", port)
    return server
