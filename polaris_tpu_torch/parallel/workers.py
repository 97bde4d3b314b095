"""Worker-per-device renderer driven by the feedback block scheduler.

Counterpart of the JAX package's ``parallel/workers.py``, itself the
counterpart of the reference's *default renderer*
(renderer/default.go:62-196): one worker thread per backend, a job hand-off
per frame, a walking-BlockY row-band split computed by the scheduler, and
per-worker timing fed back so the PerfectScheduler
(tracer/scheduler.go:50-80) rebalances the next frame.

Each worker owns a ``TorchRenderer`` made on its own device and a CUDA
stream of its own, so two workers may share one card: their band renders
(replayed CUDA graphs) then overlap on it. Band renders are bit-identical to
the same rows of a full-frame render because the RNG keys by full-frame
pixel id (ops/rng.py), so rebalancing never changes the image.
"""

from __future__ import annotations

import contextlib
import time
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..render.options import RenderOptions
from ..render.scheduler import NaiveScheduler, PerfectScheduler, blocks_from_heights
from ..render.stats import FrameStats, WorkerFrameStats


class BandWorker:
    """One render backend: a name plus a renderer able to draw row bands.

    ``renderer`` must expose ``render_band_accum(opt, y0, band_h, camera=,
    sample_offset=)`` and ``last_render_ms`` (TorchRenderer does). ``speed``
    seeds the naive first-frame split (≙ the reference's GFlops estimate,
    device.go:209-222). A renderer on a CUDA device gets a stream of the
    worker's own, on which its bands are rendered and fetched.
    """

    def __init__(self, name: str, renderer, speed: float = 1.0):
        self.name = name
        self.renderer = renderer
        self.speed = speed
        device = getattr(renderer, "device", None)
        self.stream = (
            torch.cuda.Stream(device) if device is not None and device.type == "cuda" else None
        )

    def render_band(self, opt: RenderOptions, y0: int, band_h: int,
                    camera=None, sample_offset: int = 0):
        """The band on the host and the milliseconds it took, its fetch
        included."""
        t0 = time.perf_counter()
        on_stream = (
            torch.cuda.stream(self.stream) if self.stream is not None else contextlib.nullcontext()
        )
        with on_stream:
            accum = self.renderer.render_band_accum(
                opt, y0, band_h, camera=camera, sample_offset=sample_offset
            ).cpu()
        return accum, (time.perf_counter() - t0) * 1e3


def _quantize_heights(heights: Sequence[int], frame_h: int, q: int) -> List[int]:
    """Round band heights to multiples of q (keeps each worker's program
    count small: every distinct height is a program of its own, captured on
    its first band, unlike the reference's dynamically-sized NDRange
    launches) while preserving the total. Remainder goes to worker 0
    (scheduler.go:74-77)."""
    out = [max(0, int(round(h / q)) * q) for h in heights]
    out[0] += frame_h - sum(out)
    if out[0] < 0:
        # pathological estimate: fall back to an equal quantized split
        n = len(heights)
        out = [(frame_h // (n * q)) * q] * n
        out[0] += frame_h - sum(out)
    return out


class WorkerPoolRenderer:
    """Renders frames by fanning row bands out to worker threads.

    Per frame: schedule → parallel band renders → assemble → feed measured
    times back (``renderer/default.go:100-171`` renderFrame). ``frame_stats``
    holds *measured* per-worker telemetry for the CLI table."""

    def __init__(
        self,
        workers: Sequence[BandWorker],
        height_quantum: int = 32,
        use_feedback: bool = True,
    ):
        if not workers:
            raise ValueError("need at least one worker")
        self.workers = list(workers)
        self.quantum = height_quantum
        self.use_feedback = use_feedback
        self.naive = NaiveScheduler([w.speed for w in self.workers])
        self.perfect = PerfectScheduler(len(self.workers))
        self._frames = 0
        self.frame_stats: Optional[FrameStats] = None

    def schedule(self, frame_h: int) -> List[int]:
        if self.use_feedback and self._frames > 0:
            raw = self.perfect.schedule(frame_h)
        else:
            raw = self.naive.schedule(frame_h)
        return _quantize_heights(raw, frame_h, self.quantum)

    def render_accum(self, opt: RenderOptions, camera=None,
                     sample_offset: int = 0) -> torch.Tensor:
        """The frame's accumulator [H, W, 3], assembled on the host."""
        heights = self.schedule(opt.height)
        blocks = blocks_from_heights(heights, opt.width, opt.height,
                                     samples_per_pixel=opt.spp)
        t0 = time.perf_counter()

        def run(i):
            blk = blocks[i]
            if blk.block_h == 0:
                return torch.zeros((0, opt.width, 3), dtype=torch.float32), 0.0
            return self.workers[i].render_band(
                opt, blk.block_y, blk.block_h, camera=camera,
                sample_offset=sample_offset,
            )

        with ThreadPoolExecutor(max_workers=len(self.workers)) as pool:
            results = list(pool.map(run, range(len(self.workers))))
        total_ms = (time.perf_counter() - t0) * 1e3

        stats = FrameStats(total_ms=total_ms)
        for i, (w, blk, (_, ms)) in enumerate(zip(self.workers, blocks, results)):
            stats.workers.append(
                WorkerFrameStats(
                    device_id=w.name,
                    block_w=opt.width,
                    block_h=blk.block_h,
                    render_time_ms=ms,
                )
            )
            # a worker whose quantized share rounded to 0 rows keeps its
            # previous measured rate: reporting (0, 0) would peg its rate
            # at 0.0 and starve it forever (it could only recover through
            # worker 0's remainder)
            if blk.block_h > 0:
                self.perfect.report(i, blk.block_h, ms)
        self.frame_stats = stats.finalize()
        self._frames += 1
        return torch.cat([band for band, _ in results], dim=0)

    def render(self, opt: RenderOptions, camera=None) -> np.ndarray:
        from ..render.shade import tonemap_reinhard

        accum = self.render_accum(opt, camera)
        return tonemap_reinhard(accum, 1.0 / opt.spp, opt.exposure).numpy()


def make_device_pool(scene, mode: str = "auto", devices=None,
                     height_quantum: int = 32) -> WorkerPoolRenderer:
    """One BandWorker per device, each with a ``TorchRenderer`` made on that
    device: the pool analog of initTracers (default.go:199-292). ``devices``
    defaults to every CUDA device and raises without one; a list may name a
    device more than once (two workers on one card). Every worker starts at
    speed 1.0, an equal first split; the feedback scheduler balances from
    the second frame on."""
    from ..render.integrator import TorchRenderer

    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available; pass devices=['cpu', ...] explicitly "
                "to run the pool on the CPU"
            )
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    workers = []
    for i, d in enumerate(devices):
        name = str(d) if devices.count(d) == 1 else f"{d}#{i}"
        workers.append(BandWorker(name, TorchRenderer(scene, device=d, mode=mode)))
    return WorkerPoolRenderer(workers, height_quantum=height_quantum)
