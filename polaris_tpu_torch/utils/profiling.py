"""Profiling hooks: device traces + per-stage wall timing.

Counterpart of the JAX package's ``utils/profiling.py``. The reference
threads wall-clock durations through every layer and renders them as
tables/charts (device/kernel.go:107-129, renderer/stats.go,
opengl.go:305-361) but has no profiler integration. Here:

  * ``trace(logdir)`` wraps ``torch.profiler`` (the CPU, and the card when
    there is one) and writes a Chrome/Perfetto trace into ``logdir``; every
    traversal launch is a span named after its kernel's C entry point
    (``ops/_launch.py``)
  * ``StageTimer`` collects named stage durations (fenced by synchronising
    the fence tensor's device) and prints the same style of table
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import OrderedDict

import torch

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a trace of the enclosed work into ``logdir/trace.json``,
    viewable in Perfetto or chrome://tracing. Yields the profiler, whose
    ``key_averages()`` sums the time by operator and kernel."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, TRACE_FILE))


class StageTimer:
    def __init__(self) -> None:
        self.stages: "OrderedDict[str, float]" = OrderedDict()

    @contextlib.contextmanager
    def stage(self, name: str, fence=None):
        """Time a stage; ``fence`` is an optional tensor whose device is
        synchronised before the clock stops (a CUDA tensor's card; nothing
        to wait for on the CPU)."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if isinstance(fence, torch.Tensor) and fence.device.type == "cuda":
                torch.cuda.synchronize(fence.device)
            self.stages[name] = (
                self.stages.get(name, 0.0) + (time.perf_counter() - t0) * 1e3
            )

    def table(self) -> str:
        total = sum(self.stages.values()) or 1.0
        lines = [f"{'Stage':<32} {'Time':>10} {'%':>6}", "-" * 50]
        for name, ms in self.stages.items():
            lines.append(f"{name:<32} {ms:>8.1f}ms {100 * ms / total:>5.1f}%")
        lines.append("-" * 50)
        lines.append(f"{'TOTAL':<32} {total:>8.1f}ms")
        return "\n".join(lines)
