"""Where the port's loss-and-gradient step spends its device time, on one GPU.

    python3 scripts/torch_grad_breakdown.py

The gradient counterpart of ``torch_frame_breakdown.py``, at the shape of
``chip_smoke.py``'s phase ``grad`` (sphere 512x512, 8 spp, 5 bounces, RR
after 3, zero target; that phase times the captured steps). Builds
``DifferentiableRenderer(mode="auto")`` (K1) and profiles one eager forward
(no gradient) and one eager forward and backward with ``torch.profiler``:
the kernels' device time of each, so the backward's share is their
difference, and the operators of the second ranked by the device time of
the kernels they launched (``key_averages``), with K1's launches and its
kernels' device time.

Prints one JSON object for the totals, one per ranked operator and the
card's name and power limit (nvidia-smi); writes the ranked table to
``chiprun_out/torch_grad_breakdown.json``. Without a CUDA device it exits 1.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np
import torch
from torch.autograd import DeviceType

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

TOP = 25  # operators in the ranked table


def _device_us(prof) -> float:
    """Summed device time of every kernel the profile saw, microseconds."""
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA)


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_grad_breakdown: no CUDA device", file=sys.stderr)
        return 1

    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from polaris_tpu_torch.ops import intersect_cuda
    from polaris_tpu_torch.render.grad import (
        DifferentiableRenderer, loss_and_grad_eager, render_loss,
    )
    from polaris_tpu_torch.render.options import RenderOptions

    smi = cs.nvidia_smi_line()
    opt = RenderOptions(width=cs.FRAME, height=cs.FRAME, spp=cs.GRAD_SPP,
                        num_bounces=cs.BOUNCES, min_bounces_for_rr=cs.RR_AFTER)
    r = DifferentiableRenderer(cs.load_scene("sphere"), mode="auto")
    target = np.zeros((opt.height, opt.width, 3), np.float32)
    frustum, eye = r._camera_tensors(opt, None)
    tgt = r._target(target)

    def forward():
        with torch.no_grad():
            render_loss(r, opt, seed=opt.seed, target=tgt, frustum=frustum, eye=eye)

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    forward()  # the warm-ups load the kernels
    loss_and_grad_eager(r, opt, target)
    torch.cuda.synchronize()
    with profile(activities=acts) as p_fwd:
        forward()
        torch.cuda.synchronize()
    intersect_cuda.reset_launches()
    with profile(activities=acts) as p_step:
        loss_and_grad_eager(r, opt, target)
        torch.cuda.synchronize()
    k1 = {k: v for k, v in intersect_cuda.LAUNCHES.items() if v}
    fwd_us, step_us = _device_us(p_fwd), _device_us(p_step)
    # operators (the host events that launched the kernels), not kernels
    rows = sorted((e for e in p_step.key_averages() if e.device_type == DeviceType.CPU),
                  key=lambda e: -e.self_device_time_total)
    table = [
        {"op": e.key, "self_device_ms": e.self_device_time_total / 1e3,
         "share": e.self_device_time_total / step_us if step_us else None,
         "calls": e.count}
        for e in rows[:TOP] if e.self_device_time_total > 0
    ]
    # K1 is launched through ctypes, under no operator: its kernels by name
    k1_us = sum(e.self_device_time_total for e in p_step.key_averages()
                if e.device_type == DeviceType.CUDA and "persistent_kernel" in e.key)
    print(json.dumps({
        "section": "profile", "card": smi, "scene": "sphere",
        "frame": f"{opt.width}x{opt.height}x{opt.spp}spp", "bounces": opt.num_bounces,
        "forward_device_ms": fwd_us / 1e3, "step_device_ms": step_us / 1e3,
        "backward_device_ms": (step_us - fwd_us) / 1e3,
        "k1_device_ms": k1_us / 1e3, "k1_launches": k1,
    }), flush=True)
    for row in table:
        print(json.dumps(row), flush=True)
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", "torch_grad_breakdown.json"), "w") as f:
        json.dump({"card": smi, "table": table}, f, indent=1)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
