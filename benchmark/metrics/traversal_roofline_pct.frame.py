"""Traversal's share of its roofline (%): the bound of `roofline/bound.py`
over the benchmark's own BVH, divided by the time of the renderer's
closest-hit intersector for the cell's mode (`ops/intersect.py::
make_intersectors` on the renderer's uploaded scene), on the frame's primary rays
and on as many bounce rays from the scene's surfaces (`roofline/probe.py`).
Measured after the window, on the card only."""

import sys


def read(r):
    if r.ctx.device.type != "cuda":
        return None
    from polaris_tpu_torch.ops.intersect import make_intersectors

    from harness import scenes
    from roofline.probe import traversal_roofline

    cfg, trf = r.ctx.cell.config, r.ctx.cell.traffic
    S = r.driver.renderer.S
    closest, _ = make_intersectors(S, cfg["mode"], None)
    out = traversal_roofline(
        scenes.reference_scene(cfg), closest, S, trf["width"], trf["height"], r.ctx.seed,
        r.ctx.device,
    )
    print(f"traversal roofline {out}", file=sys.stderr)
    return out["pct"]
