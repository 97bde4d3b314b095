"""Block schedulers: split a frame into per-worker row bands.

Counterpart of the reference's ``tracer/scheduler.go:6-106``:

  * ``NaiveScheduler``   — static split proportional to a per-worker speed
    estimate (scheduler.go:83-106)
  * ``PerfectScheduler`` — feedback split using each worker's last-frame
    throughput w_i = (h_i/t_i) / Σ(h_j/t_j) (scheduler.go:50-80); remainder
    rows go to worker 0 (scheduler.go:74-77)

On a homogeneous TPU slice the SPMD mesh shards rows statically
(parallel/mesh.py) and these schedulers degenerate to an equal split; they
remain the mechanism for *host-level* balancing across heterogeneous DCN
hosts or mixed CPU/TPU fallbacks, exactly as SURVEY.md §2.3 prescribes.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Sequence


@dataclass
class BlockRequest:
    """One worker's slice of the frame (ref: tracer/tracer.go:6-34)."""

    frame_w: int
    frame_h: int
    block_x: int
    block_y: int
    block_w: int
    block_h: int
    samples_per_pixel: int = 16
    num_bounces: int = 5
    min_bounces_for_rr: int = 3
    exposure: float = 1.2
    seed: int = 0
    accumulated_samples: int = 0


@dataclass
class WorkerStats:
    """Per-worker feedback (ref: tracer/tracer.go:37-47 Stats)."""

    block_h: int = 0
    render_time_ms: float = 0.0


class NaiveScheduler:
    """Static split proportional to speed estimates (GFlops-like units)."""

    def __init__(self, speeds: Sequence[float]):
        self.speeds = list(speeds)

    def schedule(self, frame_h: int) -> List[int]:
        total = sum(self.speeds)
        if total <= 0:
            raise ValueError("all worker speeds are zero")
        heights = [int(frame_h * s / total) for s in self.speeds]
        heights[0] += frame_h - sum(heights)
        return heights


class PerfectScheduler:
    """Feedback split from last-frame throughput (scheduler.go:50-80)."""

    def __init__(self, num_workers: int):
        self.num_workers = num_workers
        self.last: List[WorkerStats] = [WorkerStats() for _ in range(num_workers)]

    def report(self, worker: int, block_h: int, render_time_ms: float) -> None:
        self.last[worker] = WorkerStats(block_h, render_time_ms)

    def schedule(self, frame_h: int) -> List[int]:
        rates = []
        for st in self.last:
            if st.render_time_ms > 0 and st.block_h > 0:
                rates.append(st.block_h / st.render_time_ms)
            else:
                rates.append(0.0)
        if not any(rates):
            # first frame: equal split
            rates = [1.0] * self.num_workers
        total = sum(rates)
        heights = [int(frame_h * r / total) for r in rates]
        heights[0] += frame_h - sum(heights)
        return heights


def blocks_from_heights(
    heights: Sequence[int], frame_w: int, frame_h: int, **kw
) -> List[BlockRequest]:
    """Assemble BlockRequests with a walking block_y (default.go:127-136)."""
    out = []
    y = 0
    for h in heights:
        out.append(
            BlockRequest(
                frame_w=frame_w, frame_h=frame_h, block_x=0, block_y=y,
                block_w=frame_w, block_h=h, **kw,
            )
        )
        y += h
    return out
