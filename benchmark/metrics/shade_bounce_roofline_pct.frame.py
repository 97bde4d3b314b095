"""The shading kernel's share of its roofline (%): the bound of
`roofline/shade.py` over a frame's lane census, divided by the device time
of `shade_bounce` per frame (`shade_bounce_ms.frame`, from the trace).

The census frame is rendered after the window by a renderer of its own,
whose graphs are captured while the program's shading census is on
(`polaris_tpu_torch/utils/profiling.py::shade_census`), with the seed of
the window's first frame; the timed renderer captured its graphs with the
census off and replays none of it. Where the trace holds no shading kernel
(the CPU), or the program has no census, there is nothing to read. The
census's split is printed to standard error."""

import json
import sys
from dataclasses import replace

from harness import cells
from roofline.shade import bound, roofline_pct

bounce_ms = cells.module("metrics", "shade_bounce_ms.frame")


def census_of(r):
    """The lane census of one frame of the cell, one dict a bounce, or None
    where the program has no census."""
    try:
        from polaris_tpu_torch.utils.profiling import shade_census
    except ImportError:
        return None
    import polaris_tpu_torch as P

    drv = r.driver
    renderer = P.TorchRenderer(
        drv.renderer.scene, device=r.ctx.device, mode=r.ctx.cell.config["mode"],
        regen=r.ctx.cell.config["regen"],
    )
    opt = replace(drv.opt, seed=drv.frame_seed(0))
    with shade_census(r.ctx.device, opt.num_bounces) as census:
        renderer.render_u8(opt)  # builds the kernels and captures the graphs
        census.zero()
        renderer.render_u8(opt)
        return census.read()


def read(r):
    ms = bounce_ms.read(r)
    if ms is None:
        return None
    census = census_of(r)
    if census is None:
        return None
    b = bound(census)
    total = {k: sum(row[k] for row in census) for k in census[0]}
    print("shade census " + json.dumps({"bytes": b["bytes"], "bound_ms": 1e3 * b["bound_s"],
                                         "kernel_ms": ms, "total": total, "bounces": census}),
          file=sys.stderr)
    return roofline_pct(census, 1e-3 * ms)
