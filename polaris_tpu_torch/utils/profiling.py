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
  * ``shade_census(device)`` counts, while it is on, the lanes of every
    shading step by what they did (``CENSUS_KINDS``), on the device, in a
    span ``shade_census`` of its own; it is read once, at the end
"""

from __future__ import annotations

import contextlib
import contextvars
import os
import time
from collections import OrderedDict
from typing import Dict, List, Optional

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


# what the census counts per bounce, in the order of its rows' columns: the
# lanes that enter alive; of them, those that hit a shading surface, an
# emitter or nothing; the surface lanes by the BxDF they take (the rough
# dielectric's two by the lobe it picks), which add up to ``surface``; the
# lanes that hit a surface or emitter whose material walk samples a texture;
# the surface lanes that Russian roulette ends; the shadow rays cast
CENSUS_KINDS = (
    "alive", "surface", "emitter", "miss",
    "diffuse", "conductor", "dielectric", "rough_conductor",
    "rough_dielectric_reflect", "rough_dielectric_refract",
    "textured", "rr_ended", "shadow_rays",
)


class ShadeCensus:
    """Lane counts of the shading step, one row a bounce, kept on
    ``device`` (int64 ``[bounces, len(CENSUS_KINDS)]``) and added to by
    device operations alone, so a CUDA graph captured while the census is on
    adds to the same rows on every replay."""

    def __init__(self, device=None, bounces: int = 64) -> None:
        self.rows = torch.zeros((bounces, len(CENSUS_KINDS)), dtype=torch.int64,
                                device=torch.device(device or "cpu"))

    def add(self, bounce, lanes: torch.Tensor) -> None:
        """Count ``lanes`` (bool ``[N, len(CENSUS_KINDS)]``) under their
        bounce: a Python int, or an integer tensor, one value or one per lane
        (path regeneration mixes depths)."""
        if lanes.device != self.rows.device:
            raise ValueError(f"census on {self.rows.device}, lanes on {lanes.device}")
        if isinstance(bounce, torch.Tensor):
            b = bounce.reshape(-1).long().expand(lanes.shape[0])
            self.rows.index_add_(0, b, lanes.long())
        else:
            self.rows[int(bounce)] += lanes.sum(dim=0)

    def zero(self) -> None:
        self.rows.zero_()

    def read(self) -> List[Dict[str, int]]:
        """The counts, one dict a bounce up to the last bounce any lane
        entered: one read from the device."""
        rows = self.rows.cpu().tolist()
        last = max((i for i, r in enumerate(rows) if any(r)), default=-1)
        return [dict(zip(CENSUS_KINDS, r)) for r in rows[: last + 1]]


_CENSUS: contextvars.ContextVar = contextvars.ContextVar("shade_census", default=None)


@contextlib.contextmanager
def shade_census(device=None, bounces: int = 64):
    """Turn the shading census on for the block (off by default) and yield
    it. The shading wrappers (``ops/shade_cuda.py::shade_bounce``,
    ``render/shade.py::shade_bounce_plain``) count where it is on, as their
    Python runs: a renderer whose graphs were captured while it was off
    replays no census operation, and one captured while it was on keeps
    counting into its rows on every replay."""
    census = ShadeCensus(device, bounces)
    token = _CENSUS.set(census)
    try:
        yield census
    finally:
        _CENSUS.reset(token)


def active_census() -> Optional[ShadeCensus]:
    """The census that is on in this context, or None."""
    return _CENSUS.get()
