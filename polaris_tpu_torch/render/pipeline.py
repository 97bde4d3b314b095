"""Composable render pipeline (≙ tracer/opencl/pipeline.go:33-70).

Counterpart of the JAX package's ``render/pipeline.py``. The reference wires
four pluggable stage slots, ``Pipeline{Reset, PrimaryRayGenerator,
Integrator, PostProcess[]}``, each a ``PipelineStage func(*Tracer,
*BlockRequest)``. Here the first three are the renderer's own loop
(accumulator clear, raygen and the bounce loop, replayed from CUDA graphs on
a card), so the plug-board that remains is the **post-process chain** over
the HDR accumulator:

    pipe = Pipeline(post_process=[tonemap_stage(), save_png_stage("out.png")])
    img = pipe.run(renderer, opt)

Stages take and return [H, W, 3] float32 tensors on the renderer's device;
the writers fetch to the host. Extra stages mirror the reference's optional
ones: ``SaveFrameBuffer`` (pipeline.go:216-234) -> :func:`save_png_stage`,
the 8 debug-flag dumps (pipeline.go:20-30,116-200) ->
:func:`debug_dump_stage`.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..utils.log import get_logger
from ..utils.png import write_png
from .options import RenderOptions
from .shade import tonemap_reinhard

_log = get_logger("pipeline")

# a stage maps (image, opt, ctx) -> image; ctx carries renderer/camera and
# whatever earlier stages stash (≙ the *Tracer state handed to Go stages)
Stage = Callable[[torch.Tensor, RenderOptions, Dict], torch.Tensor]


def _u8(img: torch.Tensor) -> np.ndarray:
    return (np.clip(img.cpu().numpy(), 0, 1) * 255).astype(np.uint8)


def tonemap_stage(exposure: Optional[float] = None) -> Stage:
    """Reinhard + gamma LDR conversion (≙ TonemapSimpleReinhard, hdr.cl:5-28)."""

    def run(img, opt, ctx):
        exp = opt.exposure if exposure is None else exposure
        weight = 1.0 / max(ctx.get("accumulated_samples", opt.spp), 1)
        return tonemap_reinhard(img, weight, exp)

    return run


def save_png_stage(path: str) -> Stage:
    """Write the current image as PNG (≙ SaveFrameBuffer, pipeline.go:216-234)."""

    def run(img, opt, ctx):
        write_png(path, _u8(img))
        _log.info("wrote %s", path)
        return img

    return run


def save_hdr_stage(path: str) -> Stage:
    """Write the raw accumulator as Radiance RGBE .hdr (no reference analogue;
    useful before the tonemap stage)."""

    def run(img, opt, ctx):
        from ..asset.texture import write_hdr

        write_hdr(path, img.cpu().numpy().astype(np.float32))
        _log.info("wrote %s", path)
        return img

    return run


def denoise_stage(
    iterations: int = 4,
    c_phi: float = 0.4,
    n_phi: float = 0.25,
    d_phi: float = 0.05,
) -> Stage:
    """Edge-avoiding à-trous wavelet denoise of the HDR accumulator (no
    reference analogue: render/denoise.py). Place BEFORE ``tonemap_stage``;
    the output keeps the accumulator's sum-of-samples scale so the tonemap's
    sample-count division is unchanged."""

    def run(img, opt, ctx):
        from .denoise import denoise_accum

        return denoise_accum(
            ctx["renderer"], opt, img,
            ctx.get("accumulated_samples", opt.spp),
            camera=ctx.get("camera"),
            iterations=iterations, c_phi=c_phi, n_phi=n_phi, d_phi=d_phi,
        )

    return run


def debug_dump_stage(channels: Sequence[str], out_dir: str = ".") -> Stage:
    """Dump diagnostic PNGs for the named channels (≙ the reference's
    DebugFlags gating per-frame debug images, pipeline.go:116-200)."""

    def run(img, opt, ctx):
        from .debug import render_debug

        renderer = ctx["renderer"]
        for ch in channels:
            dbg = render_debug(renderer, opt, ch, camera=ctx.get("camera"))
            p = os.path.join(out_dir, f"debug_{ch}.png")
            write_png(p, _u8(dbg))
            _log.info("wrote %s", p)
        return img

    return run


@dataclass
class Pipeline:
    """Post-process chain over a renderer's HDR accumulator."""

    post_process: List[Stage] = field(default_factory=list)

    def run(
        self,
        renderer,
        opt: RenderOptions,
        camera=None,
        accum=None,
        accumulated_samples: Optional[int] = None,
    ) -> np.ndarray:
        """Render (unless ``accum``, a tensor or an array, is supplied) and
        fold the image through every post-process stage in order; returns the
        last stage's image on the host."""
        if accum is None:
            accum = renderer.render_accum(opt, camera)
        elif not torch.is_tensor(accum):
            accum = torch.from_numpy(np.array(accum, np.float32))
            if renderer is not None:
                accum = accum.to(renderer.device)
        ctx = {
            "renderer": renderer,
            "camera": camera,
            "accumulated_samples": accumulated_samples or opt.spp,
        }
        img = accum
        for stage in self.post_process:
            img = stage(img, opt, ctx)
        return img.cpu().numpy()


def default_pipeline() -> Pipeline:
    """≙ DefaultPipeline (pipeline.go:55-70): clear + raygen + integrator are
    the renderer's loop; tonemap is the surviving explicit stage."""
    return Pipeline(post_process=[tonemap_stage()])
