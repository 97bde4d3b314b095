"""One run of one cell: set-up, the measured window, the metrics, the check.

`run` is what `run.py` calls once it has found the cards; tests call it on
the CPU at small sizes. It prints nothing but what the result needs: the
numbers compared (each with its limit) as the last lines of standard error,
and the result as one JSON line, returned to the caller.
"""

from __future__ import annotations

import math
import os
import sys
import time
from dataclasses import dataclass
from typing import Optional

import torch

from . import cells, device as dev_info, trace as tr


@dataclass
class Context:
    cell: cells.Cell
    seed: int
    device: torch.device


def process_age() -> float:
    """Seconds since this process started, on the boot clock."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    return time.clock_gettime(time.CLOCK_BOOTTIME) - start_ticks / os.sysconf("SC_CLK_TCK")


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(workload: str, seed: int, seconds: float, traced: bool, device="cuda",
        bench_dir: str = cells.BENCH_DIR, man: Optional[dict] = None) -> dict:
    cell = cells.cell(workload, man, bench_dir)
    device = torch.device(device)
    ctx = Context(cell=cell, seed=seed, device=device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    driver = cells.module("drivers", cell.traffic["driver"], bench_dir).Driver(ctx)
    _sync(device)
    setup_s = process_age()

    n_traced = int(cell.traffic.get("traced_units", 2)) if traced else 0
    prof = span = None
    units = 0
    t0 = time.perf_counter()
    t_end = t0
    while units < max(n_traced, 1) or time.perf_counter() - t0 < seconds:
        if units == 0 and n_traced:
            prof = torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
            )
            prof.__enter__()
            span = torch.profiler.record_function(tr.SPAN)
            span.__enter__()
        driver.run(units)
        units += 1
        t_end = time.perf_counter()
        if units == n_traced:
            _sync(device)
            span.__exit__(None, None, None)
            prof.__exit__(None, None, None)
    window_s = t_end - t0
    _sync(device)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    _refuse_forbidden()

    metrics = {}
    info = dev_info.describe(device, cell.entry["chips"], peak)
    breakdown = None
    if traced:
        summary = tr.summarize(prof.events(), n_traced)
        reading = Reading(ctx=ctx, driver=driver, trace=summary)
        for m in cell.per_layer:
            value = cells.module("metrics", m["name"], bench_dir).read(reading)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        info["busy_s"] = summary.busy_s
        info["window_s"] = summary.span_s
        breakdown = summary.breakdown()
    else:
        for m in cell.end_to_end:
            if m["name"] == "setup_s":
                metrics["setup_s"] = {"value": setup_s, "unit": m["unit"]}
            elif m["name"] == driver.metric:
                metrics[m["name"]] = {"value": 1e3 * window_s / units, "unit": m["unit"]}

    driver.close()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    numbers, compared = driver.check()
    correct = all(math.isfinite(v) and v <= limit for _, v, limit in numbers)
    _refuse_forbidden()
    for name, v, limit in numbers:
        print(f"check {name} = {v!r} (limit {limit!r})", file=sys.stderr)
    result = {
        "correct": correct, "attempted": units, "failed": 0 if correct else compared,
        "metrics": metrics, "device": info,
    }
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = {name: {"value": v, "limit": limit} for name, v, limit in numbers}
    return result


@dataclass
class Reading:
    """What a per-layer metric's reader gets: the run's context, the driver
    (its renderer still alive) and the trace's summary."""

    ctx: Context
    driver: object
    trace: tr.Summary


def _refuse_forbidden() -> None:
    found = dev_info.forbidden_loaded()
    if found:
        print(f"forbidden modules loaded in the measured process: {found}", file=sys.stderr)
        sys.exit(1)
