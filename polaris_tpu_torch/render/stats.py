"""Frame statistics (ref: renderer/stats.go:5-26 + cmd/render.go:82-101)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List


@dataclass
class WorkerFrameStats:
    """Per-device timing rollup (ref: tracer Stats).

    ``render_time_ms`` is None when no per-worker time exists — a single
    SPMD program spans all shards, so per-device wall time is not separately
    observable and the table must not fabricate one (the program time lives
    in FrameStats.total_ms)."""

    device_id: str
    block_w: int
    block_h: int
    render_time_ms: float = None
    frame_percent: float = 0.0


@dataclass
class FrameStats:
    workers: List[WorkerFrameStats] = field(default_factory=list)
    total_ms: float = 0.0

    def finalize(self) -> "FrameStats":
        total_rows = sum(w.block_h for w in self.workers) or 1
        for w in self.workers:
            w.frame_percent = 100.0 * w.block_h / total_rows
        return self

    def table(self) -> str:
        lines = [
            f"{'Device':<28} {'Block':>12} {'% of frame':>10} {'Render time':>12}",
            "-" * 66,
        ]
        for w in self.workers:
            t = (
                f"{w.render_time_ms:>9.1f} ms"
                if w.render_time_ms is not None
                else f"{'(spmd)':>12}"
            )
            lines.append(
                f"{w.device_id:<28} {f'{w.block_w}x{w.block_h}':>12} "
                f"{w.frame_percent:>9.1f}% {t}"
            )
        lines.append("-" * 66)
        lines.append(f"{'TOTAL':<28} {'':>12} {'':>10} {self.total_ms:>9.1f} ms")
        return "\n".join(lines)
