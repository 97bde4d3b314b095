"""Frames rendered back to back by one user: `TorchRenderer.render_u8`, each
call a whole frame (render, tonemap, u8 image on the host).

Traffic keys: `width`, `height`, `spp`. Frame i of a run renders with the
seed `derive(seed, FRAME, i)`; the camera is the scene's. Set-up compiles or
loads the scene, builds the renderer and renders one frame of another seed,
which builds the kernels and captures the graphs of this shape.

The check: a sample of frames of the window and of pixels, both drawn from
the seed (the cell's `check.frames` and `check.pixels`), rendered again by
the reference (`reference/pathtracer.py`) from the same scene files and
seeds, and compared as u8 images.
"""

from __future__ import annotations

from dataclasses import replace

import numpy as np
import torch

from harness import scenes, seeds


class Driver:
    metric = "frame_ms"

    def __init__(self, ctx):
        import polaris_tpu_torch as P

        self.ctx = ctx
        cfg, trf = ctx.cell.config, ctx.cell.traffic
        self.renderer = P.TorchRenderer(
            scenes.program_scene(cfg), device=ctx.device, mode=cfg["mode"], regen=cfg["regen"]
        )
        self.opt = P.RenderOptions(
            width=trf["width"], height=trf["height"], spp=trf["spp"],
            num_bounces=cfg["num_bounces"], min_bounces_for_rr=cfg["min_bounces_for_rr"],
            exposure=cfg["exposure"],
        )
        self.reset(ctx.seed)
        self.renderer.render_u8(replace(self.opt, seed=seeds.derive(ctx.seed, seeds.WARM)))

    def reset(self, seed: int) -> None:
        """Start a run of ``seed``: its pixel sample, no frames kept."""
        self.ctx = replace(self.ctx, seed=seed)
        n = self.opt.width * self.opt.height
        k = min(self.ctx.cell.spec["check"]["pixels"], n)
        self.pixels = np.sort(seeds.generator(seed, seeds.PIXELS).choice(n, size=k, replace=False))
        self.kept = []  # the sampled pixels of every frame, in frame order

    def frame_seed(self, i: int) -> int:
        return seeds.derive(self.ctx.seed, seeds.FRAME, i)

    def run(self, i: int) -> None:
        img = self.renderer.render_u8(replace(self.opt, seed=self.frame_seed(i)))
        self.kept.append(img.reshape(-1, 3)[self.pixels])

    def close(self) -> None:
        """Drop the renderer and its graphs: what the check needs is kept."""
        self.renderer = None

    def picked(self):
        """The frames of the window that the check compares."""
        n = len(self.kept)
        k = min(self.ctx.cell.spec["check"]["frames"], n)
        return np.sort(seeds.generator(self.ctx.seed, seeds.PICK).choice(n, size=k, replace=False))

    def check(self):
        """([(name, value, limit)], answers compared): the sampled pixels of
        the picked frames against the reference's."""
        picked = self.picked()
        want = reference_u8(self.ctx, self.opt, [self.frame_seed(int(f)) for f in picked],
                            self.pixels, torch.float32)
        got = np.stack([self.kept[f] for f in picked]).astype(np.int64)
        return compare(got, want, self.ctx.cell.spec["check"]["limits"]), len(picked)


def reference_u8(ctx, opt, frame_seeds, pixels, dtype) -> np.ndarray:
    """[F, n, 3] u8 levels (int64) of ``pixels`` in the frames of
    ``frame_seeds``, from the reference computed in ``dtype``."""
    from reference.pathtracer import Integrator, RefRenderer, to_u8
    from roofline.bvh import build

    cfg = ctx.cell.config
    rs = scenes.reference_scene(cfg)
    ref = RefRenderer(rs, build(rs.v0, rs.e1, rs.e2), ctx.device, dtype)
    integ = Integrator(cfg["num_bounces"], cfg["min_bounces_for_rr"], cfg["exposure"])
    pix = torch.from_numpy(pixels).to(ctx.device)
    # every frame as one batch of lanes: a walk of the BVH lasts as long as
    # its deepest ray, so more lanes cost little more time
    acc = ref.render_frames(frame_seeds, pix, opt.width, opt.height, opt.spp, integ)
    return to_u8(acc.float(), opt.spp, opt.exposure).cpu().numpy().astype(np.int64)


def compare(got: np.ndarray, want: np.ndarray, limits: dict):
    """The numbers compared, each with its limit: the share of compared
    pixels with a channel more than one level off, and the mean distance in
    levels over every compared channel."""
    d = np.abs(got - want)
    return [
        ("pixels_off_pct", float(100.0 * (d.max(axis=-1) > 1).mean()), limits["pixels_off_pct"]),
        ("mean_abs_levels", float(d.mean()), limits["mean_abs_levels"]),
    ]
