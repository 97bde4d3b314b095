"""Readings that the cells' limits are set from: for each seed, the numbers
the check compares for the renderer under test (as a run computes them) and
for the control, the reference computed in bfloat16 put in the renderer's
place, each against the float32 reference. The reference is the
configuration's (`harness/scenes.py::reference`), read through the drivers'
`reference_u8` and `reference_steps`, as a run's check reads it.

    python benchmark/control.py --workload <cell> --seeds 11,12,13 [--program 0|1] [--control 0|1]
                                [--fault 0|1] [--window <steps>]

One JSON line per seed on standard output. A frame cell renders frames 0
and 1 of each seed's window at the cell's size (its set-up once, for every
seed); the loss-step cell builds a trainer per seed and takes it through the
check's steps, ``--window`` more, and the step after them. Runs on the
card; `--device cpu` rehearses at the sizes of the traffic files.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))


def frame_readings(frame, drv, seed: int, program: bool, control: bool, fault: bool = False,
                   frames: int = 2) -> dict:
    """``frame``: the module `drivers/frame.py`; ``drv`` its driver.
    ``fault``: also read the reference in the renderer's place with half of
    each frame's samples left out (the mean over the rest), and with every
    frame the first one (frames 1 and 2 read as frame 0)."""
    from dataclasses import replace

    import numpy as np
    import torch

    drv.reset(seed)
    fs = [drv.frame_seed(i) for i in range(frames + 1 if fault else frames)]
    limits = drv.ctx.cell.spec["check"]["limits"]
    ref = frame.reference_u8(drv.ctx, drv.opt, fs, drv.pixels, torch.float32)
    want = ref[:frames]
    out = {"seed": seed}
    if program:
        for i in range(frames):
            drv.run(i)
        got = np.stack(drv.kept).astype(np.int64)
        out["program"] = {n: v for n, v, _ in frame.compare(got, want, limits)}
    if control:
        ctl = frame.reference_u8(drv.ctx, drv.opt, fs[:frames], drv.pixels, torch.bfloat16)
        out["control"] = {n: v for n, v, _ in frame.compare(ctl, want, limits)}
    if fault:
        half = replace(drv.opt, spp=drv.opt.spp // 2)
        got = frame.reference_u8(drv.ctx, half, fs[:frames], drv.pixels, torch.float32)
        out["half_batch"] = {n: v for n, v, _ in frame.compare(got, want, limits)}
        first = np.repeat(ref[:1], frames, axis=0)
        out["state_unchanged"] = {n: v for n, v, _ in frame.compare(first, ref[1:], limits)}
    return out


def step_readings(mod, ctx, seed: int, program: bool, control: bool, fault: bool = False,
                  window: int = 0) -> dict:
    """``mod``: the module `drivers/step.py`. The trainer takes the check's
    steps, ``window`` steps as a run's window would, and the step after it.
    ``fault``: also read the reference with half of each step's samples
    left out in the renderer's place, and with its loss altered by 1%."""
    from dataclasses import replace

    import torch

    ctx = replace(ctx, seed=seed)
    limits = ctx.cell.spec["check"]["limits"]
    steps = ctx.cell.spec["check"]["steps"]
    drv = mod.Driver(ctx)
    for i in range(window):
        drv.run(i)
    drv.close()
    taken = drv.taken()

    def numbers(got, got1, scale=1.0):
        got = dict(got, losses=[x * scale for x in got["losses"]])
        after = {"loss": got1["losses"][0] * scale, "counts": [taken + 1], "nonfinite": 0}
        compared = mod.compare(got, want, limits) + mod.compare_after(after, [], want1, taken, limits)
        return {n: v for n, v, _ in compared}

    def reference(dtype, opt=drv.opt):
        return (mod.reference_steps(ctx, opt, drv.target, steps, dtype),
                mod.reference_after(ctx, opt, drv.target, drv.after, taken, dtype))

    want, want1 = reference(torch.float32)
    out = {"seed": seed, "window": window}
    if program:
        prog = {"losses": drv.losses, "first_grad": drv.first_grad, "change": drv.change}
        got = mod.compare(prog, want, limits) + mod.compare_after(drv.after, drv.window_losses, want1,
                                                                    taken, limits)
        out["program"] = {n: v for n, v, _ in got}
    if control:
        out["control"] = numbers(*reference(torch.bfloat16))
    if fault:
        out["half_batch"] = numbers(*reference(torch.float32, replace(drv.opt, spp=drv.opt.spp // 2)))
        out["answer_altered"] = numbers(want, want1, scale=1.01)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--program", type=int, default=1)
    ap.add_argument("--control", type=int, default=1)
    ap.add_argument("--fault", type=int, default=0)
    ap.add_argument("--window", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    for path in (HERE, os.path.dirname(HERE)):
        if path not in sys.path:
            sys.path.insert(0, path)
    import torch

    from harness import cells, device, runner

    cell = cells.cell(args.workload)
    if args.device == "cuda":
        device.require_cards(int(cell.entry["chips"]))
    seed_list = [int(s) for s in args.seeds.split(",")]
    ctx = runner.Context(cell=cell, seed=seed_list[0], device=torch.device(args.device))
    mod = cells.module("drivers", cell.traffic["driver"])
    drv = mod.Driver(ctx) if cell.traffic["driver"] == "frame" else None
    for seed in seed_list:
        t = time.time()
        if drv is not None:
            out = frame_readings(mod, drv, seed, bool(args.program), bool(args.control), bool(args.fault))
        else:
            out = step_readings(mod, ctx, seed, bool(args.program), bool(args.control), bool(args.fault),
                                args.window)
        out["seconds"] = time.time() - t
        print(json.dumps(out), flush=True)
    print(json.dumps({"device": device.describe(ctx.device, 1, 0)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
