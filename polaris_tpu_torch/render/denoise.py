"""Edge-avoiding à-trous wavelet denoiser (a post-process).

Counterpart of the JAX package's ``render/denoise.py``: ``iterations``
passes of a 5x5 B3-spline kernel with power-of-two tap dilation (Dammertz
et al., HPG 2010), each tap weighted by color, normal and depth affinity, so
the filter smooths Monte-Carlo noise but does not cross geometric edges;
before it, ``despeckle`` clamps fireflies. The functions take [H, W, C]
tensors and stay differentiable (the weights are ``exp`` of squared
differences), so gradients flow through the filter to the radiance.

The guide pass (``guide_images``) runs the renderer's closest-hit
traversal (K1 on a card) on pixel-centre primary rays and fetches the
vertex normals as flat rows. It and the filter (``filter_accum``: despeckle
and every level) each run as one step over static tensors
(``render/graph.py``), kept among the renderer's programs per frame shape:
replayed from a CUDA graph on a card, called directly on the CPU. Called op
by op, the two functions are the reference the steps are held against.

One deliberate divergence: the JAX ``despeckle`` scales a pixel with fewer
than two real neighbours (every pixel of a 1x1 frame, the ends of a frame
one pixel wide) by -inf; here such a pixel keeps its value.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..ops import vec as V
from .options import RenderOptions
from .raygen import gen_rays

# 1D B3-spline coefficients; the 2D 5x5 kernel is the separable outer product
# (Dammertz et al. 2010, §3).
_B3 = (1.0 / 16.0, 1.0 / 4.0, 3.0 / 8.0, 1.0 / 4.0, 1.0 / 16.0)


def despeckle(color: torch.Tensor) -> torch.Tensor:
    """Clamp each pixel's luminance to the SECOND-brightest of its 8
    neighbours (out-of-frame taps never count).

    The à-trous color edge-stop preserves fireflies, so they are clamped
    first: a 1-2 pixel speckle has at most one bright neighbour and drops to
    the background, while a genuine feature gives each of its pixels at
    least two neighbours as bright and passes through untouched.
    """
    lum = 0.2126 * color[..., 0] + 0.7152 * color[..., 1] + 0.0722 * color[..., 2]
    H, W = lum.shape
    lp = torch.nn.functional.pad(lum, (1, 1, 1, 1), value=-float("inf"))
    max1 = max2 = None
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy == 0 and dx == 0:
                continue
            s = lp[1 + dy:1 + dy + H, 1 + dx:1 + dx + W]
            if max1 is None:
                max1, max2 = s, torch.full_like(s, -float("inf"))
            else:
                max2 = torch.maximum(max2, torch.minimum(max1, s))
                max1 = torch.maximum(max1, s)
    # fewer than two real neighbours: keep the pixel (max2 is -inf there)
    max2 = torch.where(torch.isfinite(max2), max2, lum)
    scale = torch.where(lum > max2, max2 / torch.clamp(lum, min=1e-20), 1.0)
    return color * scale[..., None]


def _edge_pad(x: torch.Tensor, r: int) -> torch.Tensor:
    """``x`` [H, W, ...] padded by ``r`` on both image axes with copies of
    its edge pixels."""
    H, W = x.shape[0], x.shape[1]
    rows = torch.clamp(torch.arange(-r, H + r, device=x.device), 0, H - 1)
    cols = torch.clamp(torch.arange(-r, W + r, device=x.device), 0, W - 1)
    return x[rows][:, cols]


def atrous_denoise(color, normal, depth, *, iterations: int = 4, c_phi=0.4,
                   n_phi=0.25, d_phi=0.05) -> torch.Tensor:
    """Filter a radiance image (H, W, 3) guided by per-pixel normals
    (H, W, 3; 0 where no hit) and normalized depth (H, W; 1 where no hit).
    Level ``i`` spaces its taps ``2**i`` apart and halves ``c_phi``
    ``i`` times; the bandwidths may be floats or 0-d tensors. Flat regions
    pass through unchanged (to rounding)."""
    out = color
    for it in range(iterations):
        out = _atrous_level(
            out, normal, depth, step=1 << it, c_phi=c_phi * (0.5 ** it),
            n_phi=n_phi, d_phi=d_phi,
        )
    return out


def _atrous_level(color, normal, depth, *, step, c_phi, n_phi, d_phi):
    H, W = color.shape[0], color.shape[1]
    R = 2 * step
    cp = _edge_pad(color, R)
    np_ = _edge_pad(normal, R)
    dp = _edge_pad(depth, R)

    inv_c2 = 1.0 / (c_phi * c_phi)
    inv_n2 = 1.0 / (n_phi * n_phi)
    inv_d2 = 1.0 / (d_phi * d_phi)

    acc = torch.zeros_like(color)
    wsum = torch.zeros(color.shape[:2], dtype=color.dtype, device=color.device)
    for j in range(5):
        dy = (j - 2) * step
        for i in range(5):
            dx = (i - 2) * step
            h = _B3[j] * _B3[i]
            cq = cp[R + dy:R + dy + H, R + dx:R + dx + W, :]
            nq = np_[R + dy:R + dy + H, R + dx:R + dx + W, :]
            dq = dp[R + dy:R + dy + H, R + dx:R + dx + W]
            dc = color - cq
            dn = normal - nq
            dd = depth - dq
            w = h * torch.exp(
                -(torch.sum(dc * dc, dim=-1) * inv_c2
                  + torch.sum(dn * dn, dim=-1) * inv_n2
                  + dd * dd * inv_d2)
            )
            acc = acc + w[..., None] * cq
            wsum = wsum + w
    # wsum >= the centre tap's (3/8)^2 (all three distances are 0 there)
    return acc / wsum[..., None]


def guide_images(r, frustum, eye, width: int, height: int, closest=None):
    """Normals (H, W, 3) and normalized depth (H, W) of the closest hits of
    ``r``'s scene on pixel-centre primary rays, in pixel order; lanes that
    miss get normal 0 and depth 1. ``closest`` defaults to the renderer's
    traversal (its plain version, say). The guide pass runs this as a step;
    called op by op it is the reference that step is held against."""
    dev, n = r.device, width * height
    pix = torch.arange(n, device=dev)
    xs, ys = (pix % width).to(torch.int32), (pix // width).to(torch.int32)
    centre = torch.full((n,), 0.5, dtype=torch.float32, device=dev)  # the tent filter keeps 0.5
    maxt = torch.full((n,), V.FLT_MAX, dtype=torch.float32, device=dev)
    alive = torch.ones(n, dtype=torch.bool, device=dev)
    o, d = gen_rays(frustum, eye, width, height, xs, ys, lambda _: centre)
    hit = (closest or r.closest)(r.S, o, d, maxt, alive)
    tn = r.S["tri_normals"].reshape(-1, 9)[hit.tri.long()]  # flat rows
    w = 1.0 - hit.u - hit.v
    n_obj = (
        w[..., None] * tn[..., 0:3]
        + hit.u[..., None] * tn[..., 3:6]
        + hit.v[..., None] * tn[..., 6:9]
    )
    w2o = V.take_small(r.S["inst_w2o"], hit.inst)
    nw = V.normalize3(V.transform_normal(w2o, n_obj))
    t = torch.where(hit.mask, hit.t, 0.0)
    tmax = torch.clamp(torch.max(t), min=1e-6)
    normal = torch.where(hit.mask[..., None], nw, 0.0).reshape(height, width, 3)
    depth = torch.where(hit.mask, t / tmax, 1.0).reshape(height, width)
    return normal, depth


def filter_accum(accum, normal, depth, samples, *, iterations: int, fireflies: bool,
                 c_phi, n_phi, d_phi) -> torch.Tensor:
    """Despeckle (when ``fireflies``) and ``iterations`` à-trous levels of the
    mean of an accumulator of ``samples`` samples, returned at the
    accumulator's scale. The filter program runs this as a step; called op by
    op it is the reference that step is held against."""
    mean = accum / samples
    if fireflies:
        mean = despeckle(mean)
    return atrous_denoise(
        mean, normal, depth, iterations=iterations, c_phi=c_phi, n_phi=n_phi, d_phi=d_phi,
    ) * samples


class _GuidePass:
    """``guide_images`` of one frame shape as one step over static tensors."""

    def __init__(self, r, width: int, height: int):
        f32 = dict(dtype=torch.float32, device=r.device)
        self.frustum = torch.zeros((4, 3), **f32)
        self.eye = torch.zeros(3, **f32)
        self.normal = torch.zeros((height, width, 3), **f32)
        self.depth = torch.zeros((height, width), **f32)

        def run():
            normal, depth = guide_images(r, self.frustum, self.eye, width, height)
            self.normal.copy_(normal)
            self.depth.copy_(depth)

        self.step = r.step(run)
        self.steps = [self.step]


class FilterProgram:
    """``filter_accum`` of one (H, W, iterations, fireflies) as one step over
    static tensors: the JAX package's ``_get_filter_fn``. Calling it fills
    the inputs and runs ``step``; ``out`` holds the result until the next
    call."""

    def __init__(self, r, height: int, width: int, iterations: int, fireflies: bool):
        f32 = dict(dtype=torch.float32, device=r.device)
        self.accum = torch.zeros((height, width, 3), **f32)
        self.normal = torch.zeros((height, width, 3), **f32)
        self.depth = torch.zeros((height, width), **f32)
        self.samples, self.c_phi, self.n_phi, self.d_phi = (torch.zeros((), **f32) for _ in range(4))
        self.out = torch.zeros((height, width, 3), **f32)

        def run():
            self.out.copy_(filter_accum(
                self.accum, self.normal, self.depth, self.samples, iterations=iterations,
                fireflies=fireflies, c_phi=self.c_phi, n_phi=self.n_phi, d_phi=self.d_phi,
            ))

        self.step = r.step(run)
        self.steps = [self.step]

    @torch.no_grad()
    def __call__(self, accum, normal, depth, samples: int, c_phi: float, n_phi: float,
                 d_phi: float) -> torch.Tensor:
        self.accum.copy_(accum)
        self.normal.copy_(normal)
        self.depth.copy_(depth)
        self.samples.fill_(float(max(int(samples), 1)))
        self.c_phi.fill_(c_phi)
        self.n_phi.fill_(n_phi)
        self.d_phi.fill_(d_phi)
        self.step()
        return self.out


def filter_program(r, height: int, width: int, iterations: int = 4,
                   suppress_fireflies: bool = True) -> FilterProgram:
    """The renderer's filter program of this shape (kept among its programs)."""
    fireflies = bool(suppress_fireflies)
    return r.program(("filter", height, width, iterations, fireflies),
                     lambda: FilterProgram(r, height, width, iterations, fireflies))


@torch.no_grad()
def _guides(r, opt: RenderOptions, camera=None) -> _GuidePass:
    W, H = opt.width, opt.height
    prog = r.program(("guides", W, H), lambda: _GuidePass(r, W, H))
    frustum, eye = r._camera_tensors(opt, camera)
    prog.frustum.copy_(frustum)
    prog.eye.copy_(eye)
    prog.step()
    return prog


def render_guides(r, opt: RenderOptions, camera=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """One primary-ray pass through pixel centres, so the guides are
    deterministic and seed-independent. Returns ``(normal (H, W, 3),
    depth (H, W))`` on the renderer's device; lanes that miss get normal 0
    and depth 1."""
    prog = _guides(r, opt, camera)
    return prog.normal.clone(), prog.depth.clone()


@torch.no_grad()
def denoise_accum(
    r,
    opt: RenderOptions,
    accum,
    accumulated_samples: int,
    camera=None,
    *,
    iterations: int = 4,
    c_phi: float = 0.4,
    n_phi: float = 0.25,
    d_phi: float = 0.05,
    suppress_fireflies: bool = True,
) -> torch.Tensor:
    """Denoise an HDR accumulator [H, W, 3] (a tensor or an array), returning
    it at the SAME scale (a sum of samples, not a mean) on the renderer's
    device, so a tonemap downstream keeps dividing by the sample count."""
    guides = _guides(r, opt, camera)
    if not torch.is_tensor(accum):
        accum = torch.from_numpy(np.array(accum, np.float32))
    f = filter_program(r, accum.shape[0], accum.shape[1], iterations, suppress_fireflies)
    return f(accum, guides.normal, guides.depth, accumulated_samples, c_phi, n_phi,
             d_phi).clone()
