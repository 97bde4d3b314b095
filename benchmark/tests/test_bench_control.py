"""The control, the reference computed in bfloat16 put in the renderer's
place, comes out not correct by the cells' own limits, while the renderer
comes out correct: here on the CPU at the small sizes of `small_bench`
(`benchmark/control.py` reads both on the card at the cells' sizes)."""

import torch

import control
from harness import cells, runner


def limits(bd, name):
    return cells.cell(name, bench_dir=bd).spec["check"]["limits"]


def over(readings, lim):
    return [k for k, v in readings.items() if not v <= lim[k]]


def test_frame_control_fails_and_the_renderer_passes(small_bench):
    torch.set_num_threads(2)
    cell = cells.cell("sphere-frame", bench_dir=small_bench)
    ctx = runner.Context(cell=cell, seed=2**31 + 5, device=torch.device("cpu"))
    frame = cells.module("drivers", "frame", small_bench)
    out = control.frame_readings(frame, frame.Driver(ctx), 2**31 + 5, True, True)
    lim = limits(small_bench, "sphere-frame")
    assert over(out["program"], lim) == []
    assert over(out["control"], lim), out


def test_step_control_fails_and_the_renderer_passes(small_bench):
    torch.set_num_threads(2)
    cell = cells.cell("sphere-grad", bench_dir=small_bench)
    ctx = runner.Context(cell=cell, seed=2**31 + 6, device=torch.device("cpu"))
    out = control.step_readings(cells.module("drivers", "step", small_bench), ctx, 2**31 + 6, True, True)
    lim = limits(small_bench, "sphere-grad")
    assert over(out["program"], lim) == []
    assert over(out["control"], lim), out
